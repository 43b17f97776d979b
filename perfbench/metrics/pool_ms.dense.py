"""Device ms a request of the kernels launched under the dense paths'
``dense.pool`` spans (every pool of a node: the dilated path's pools,
``Conv._pool``, ``Pool._compute``), matched by the profiler's correlation
of each kernel to its launch. Nothing where the program opens no such
span."""


def read(w):
    if w.trace is None or not w.requests:
        return None
    if not any(h[0] == "dense.pool" for h in w.trace.host):
        return None
    ks = w.trace.under_host_op(lambda n: n == "dense.pool")
    return 1e3 * sum(e[2] - e[1] for e in ks) / 1e9 / w.requests
