"""K1's share of its roofline in the traced window: the sum over its
launches of the larger of their FLOPs at the TF32 peak and their bytes at
HBM speed (from the shapes of the dense computation), over K1's device
time. Nothing when no K1 kernel ran."""

from perfbench import trace


def read(w):
    if w.trace is None or not w.k1_bound_s:
        return None
    t = w.trace.kernel_s(lambda k: trace.K1_KERNEL in k)
    return 100.0 * w.k1_bound_s / t if t > 0 else None
