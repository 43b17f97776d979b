"""The sweep's share of the card's peak: the model's FLOPs a dense voxel x
the voxels written in the traced window, over the window at 495 TFLOP/s
(TF32 tensor cores)."""

from perfbench.metrics._device import mfu_pct as read  # noqa: F401
