"""K2's share of its roofline in the traced window: each launch's bound
(the larger of its FLOPs at the TF32 peak and its bytes at HBM speed,
``extract_work.trilinear_patches_work``: the union of the launch's (p + 1)^3
windows read once, each patch written once; the union taken at every step
of the compared requests and averaged, ``drivers/tracer.py``) times K2's
launches in the trace, over K2's device time. Nothing when no K2 kernel
ran."""

#: K2's kernel, ``csrc/extract.cu``
K2_KERNEL = "trilinear_patches_kernel"


def read(w):
    if w.trace is None or not getattr(w, "k2_launch_bound_s", 0):
        return None
    n = w.trace.count(lambda k: K2_KERNEL in k)
    t = w.trace.kernel_s(lambda k: K2_KERNEL in k)
    return 100.0 * n * w.k2_launch_bound_s / t if n and t > 0 else None
