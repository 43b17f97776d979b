"""Device ms a request of the kernels launched under the transposed conv's
aten op (``ops/conv.py::upconv``), matched by the profiler's correlation of
each kernel to its launch. Nothing in a graph without an UpConv."""


def read(w):
    if w.trace is None or not w.requests:
        return None
    ks = w.trace.under_host_op(lambda n: "conv_transpose" in n)
    if not ks:
        return None
    return 1e3 * sum(e[2] - e[1] for e in ks) / 1e9 / w.requests
