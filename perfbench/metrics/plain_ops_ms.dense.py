"""Device ms a request of every kernel other than K1 (cuDNN's convs, pools,
softmax, pads and copies of ops/conv.py and the dense paths)."""

from perfbench import trace


def read(w):
    if w.trace is None or not w.requests:
        return None
    t = w.trace.kernel_s(lambda k: trace.K1_KERNEL not in k)
    return 1e3 * t / w.requests
