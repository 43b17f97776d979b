"""The traced window: ``torch.profiler`` over the window in a fresh
process, read into plain lists, and the reductions every per-layer reader
shares (the union of device intervals, kernel times by name, kernels
launched under a host op, idle gaps by what the host was doing).

The window is the host span ``perfbench.window`` that the harness opens
around its loop; device activity is clipped to it. Busy time is the union
of the intervals of every device activity (kernels, copies, sets), not
their sum, so overlapping streams are not counted twice.
"""

import contextlib

WINDOW_SPAN = "perfbench.window"
K1_KERNEL = "tailconv_tc_kernel"


def _union(intervals):
    """Merged, sorted intervals of ``[(start, end)]``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Trace:
    """What a profiled window holds, in nanoseconds of the profiler's
    clock: ``device`` ``[(name, start, end, kind, linked)]`` (kind
    ``kernel``, ``memcpy`` or ``memset``; ``linked``: the correlation id of
    the host op that launched it),
    ``host`` ``[(name, start, end, thread, corr)]`` and the window."""

    def __init__(self, device, host, window):
        self.window = window
        lo, hi = window
        self.device = [(n, max(a, lo), min(b, hi), k, c)
                       for n, a, b, k, c in device if b > lo and a < hi]
        self.host = host

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e9

    def kernels(self):
        return [e for e in self.device if e[3] == "kernel"]

    def busy_s(self):
        return sum(b - a for a, b in _union(
            (e[1], e[2]) for e in self.device)) / 1e9

    def kernel_s(self, pred=lambda name: True):
        """Summed device seconds of the kernels whose name passes
        ``pred``."""
        return sum(e[2] - e[1] for e in self.kernels() if pred(e[0])) / 1e9

    def count(self, pred):
        return sum(1 for e in self.kernels() if pred(e[0]))

    def under_host_op(self, pred):
        """Kernels launched under a host op whose name passes ``pred``: the
        host op that launched a kernel (the profiler links the two by its
        correlation id) lies inside such an op's interval, on the same
        thread."""
        ops, by_corr = {}, {}
        for n, a, b, t, c in self.host:
            if pred(n):
                ops.setdefault(t, []).append((a, b))
            if c and not n.startswith("cu"):   # the runtime's own ids differ
                by_corr[c] = (a, t)
        out = []
        for e in self.kernels():
            at = by_corr.get(e[4])
            if at and any(a <= at[0] <= b for a, b in ops.get(at[1], ())):
                out.append(e)
        return out

    def top_ops(self, n=10):
        """The device activities that took most time, summed by name:
        ``[[name, seconds]]``."""
        tot = {}
        for e in self.device:
            tot[e[0]] = tot.get(e[0], 0) + e[2] - e[1]
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:120], v / 1e9] for k, v in top]

    def idle_gaps(self, n=10):
        """The longest gaps in device activity inside the window, each
        named by the innermost host op that covered its middle:
        ``[[name, seconds]]``."""
        busy = _union((e[1], e[2]) for e in self.device)
        lo, hi = self.window
        gaps, t = [], lo
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        host = [h for h in self.host if h[0] != WINDOW_SPAN]
        out = []
        for a, b in gaps:
            mid = (a + b) // 2
            cover = [h for h in host if h[1] <= mid <= h[2]]
            name = (min(cover, key=lambda h: h[2] - h[1])[0] if cover
                    else "host: no op")
            out.append([name[:120], (b - a) / 1e9])
        return out


@contextlib.contextmanager
def traced(enabled):
    """Profile the block (CPU and CUDA activity) when ``enabled``; yields a
    one-element list that holds the ``Trace`` after the block, else
    ``None``. The block runs inside the span ``perfbench.window``."""
    box = [None]
    if not enabled:
        yield box
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            yield box
    box[0] = read(prof)


def read(prof):
    """A ``Trace`` from a finished ``torch.profiler.profile``. The device
    copies of host annotations (``record_function`` spans mirrored onto the
    device's timeline) are left out: they are no device activity."""
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        act = (str(e.activity_type()).lower()
               if hasattr(e, "activity_type") else "")
        if str(e.device_type()).endswith("CUDA"):
            if "annotation" in act or (hasattr(e, "is_user_annotation")
                                       and e.is_user_annotation()):
                continue
            k = ("memcpy" if "memcpy" in act or name.startswith("Memcpy")
                 else "memset" if "memset" in act or name.startswith("Memset")
                 else "kernel")
            device.append((name, a, b, k, e.linked_correlation_id()))
        else:
            host.append((name, a, b, e.start_thread_id(), e.correlation_id()))
            if name == WINDOW_SPAN:
                window = (a, b)
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW_SPAN!r} span")
    names = {h[0] for h in host}
    return Trace([d for d in device if d[0] not in names], host, window)
