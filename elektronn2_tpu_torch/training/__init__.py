"""training — the fused K-step training loop (``fused_loop``)."""
