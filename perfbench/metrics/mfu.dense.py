"""The whole request's share of the card's peak: 2 x the model's
multiply-adds a dense voxel (each layer at its own density, halos left out)
x the voxels of the requests done in the traced window, over the window at
495 TFLOP/s (TF32 tensor cores)."""

from perfbench.metrics._device import mfu_pct as read  # noqa: F401
