"""The whole step's share of the card's peak: 3 x the forward pass's FLOPs
a step (2 x multiply-adds from the patch's shapes; backward counted as
twice the forward) x the steps in the traced window, over the window at
495 TFLOP/s (TF32 tensor cores)."""

from perfbench.metrics._device import mfu_pct as read  # noqa: F401
