"""The whole rollout's share of the card's peak: 2 x the tracing model's
multiply-adds an agent-step (the encoder, the GRU's two fused gate
matmuls and the step head; the patch cut left out) x the agent-steps in
the traced window, over the window at 495 TFLOP/s (TF32 tensor cores)."""

from perfbench.metrics._device import mfu_pct as read  # noqa: F401
