"""What the device readers share."""

from perfbench.peaks import TF32_FLOPS


def idle_pct(w):
    """1 - the union of device activity over the traced window, in %."""
    if w.trace is None or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s() / w.trace.window_s)


def mfu_pct(w):
    """The model FLOPs done in the traced window over the window at the
    TF32 tensor-core peak, in %."""
    if w.trace is None or not w.model_flops:
        return None
    return 100.0 * w.model_flops / (w.trace.window_s * TF32_FLOPS)
