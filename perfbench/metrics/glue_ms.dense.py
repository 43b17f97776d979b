"""Device ms a request of the traced window's kernels launched under no
``dense/<node>`` span: the dense path's own pads, trims, casts, phase
merges and copies outside every node (and anything else the entry
launches), by the profiler's correlation of each kernel to its launch. K1
is placed like any kernel: the port opens the host op ``tailconv.launch``
around its launch. Nothing where the program opens no node span."""


def read(w):
    if w.trace is None or not w.requests:
        return None
    if not any(h[0].startswith("dense/") for h in w.trace.host):
        return None
    placed = set(w.trace.under_host_op(lambda n: n.startswith("dense/")))
    glue = [e for e in w.trace.kernels() if e not in placed]
    return 1e3 * sum(e[2] - e[1] for e in glue) / 1e9 / w.requests
