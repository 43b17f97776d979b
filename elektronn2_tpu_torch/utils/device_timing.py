"""Device timing for the probes and ``chip_smoke.py``: CUDA-event windows
(around eager calls, or around replays of a CUDA graph of many calls) and
the H100's published peaks for the bounds they report.

Peaks: NVIDIA's H100 SXM data sheet (dense rates, 700 W): HBM at 3.35 TB/s,
67 TFLOP/s float32 outside the tensor cores, 989 TFLOP/s bf16 and 495 TFLOP/s
TF32 on them.
"""

from __future__ import annotations

import torch

HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
TF32_FLOP_S = 495e12


def time_ms(fn, n=3):
    """Mean device time of ``fn`` over ``n`` back-to-back calls, from one
    pair of CUDA events around them."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def best_ms(fn, n):
    """The best of three windows of ``n`` calls (mean ms per call)."""
    return min(time_ms(fn, n) for _ in range(3))


def palindrome_ms(fns, n=3):
    """Mean ms per call of each of ``fns``, timed in turns: in order, then
    in reverse order, the two windows of each averaged."""
    t = [time_ms(f, n) for f in list(fns) + list(fns)[::-1]]
    k = len(fns)
    return [(t[i] + t[2 * k - 1 - i]) / 2 for i in range(k)]


def in_turns(kern, plain, n=3):
    """(kernel ms, plain ms) per call, timed in turns: plain, kernel,
    kernel, plain."""
    plain_ms, kern_ms = palindrome_ms([plain, kern], n)
    return kern_ms, plain_ms


def graph_ms(fns, n=20):
    """Mean device ms per call of each of ``fns``, each captured ``n`` times
    into one CUDA graph whose replays are timed in turns (in order, then in
    reverse order) with CUDA events: the host's launch cost stays out of
    the window, the gaps between a graph's kernels stay in."""
    graphs = []
    for fn in fns:
        fn()                                  # warm, outside the capture
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.graph(g, stream=side):
            for _ in range(n):
                fn()
        graphs.append(g)
    return [ms / n for ms in palindrome_ms([g.replay for g in graphs], 1)]


def bound_ms(nbytes, flop, flop_s=FP32_FLOP_S):
    """(least ms on an H100, 'bytes' or 'operations'): the larger of
    ``nbytes`` over the memory rate and ``flop`` over ``flop_s``."""
    t_b, t_f = nbytes / HBM_BYTES_S, flop / flop_s
    return max(t_b, t_f) * 1e3, ("bytes" if t_b > t_f else "operations")


def conv3x3_bound(cin, cout, x_numel, out_numel):
    """(bound ms, 'bytes' or 'operations (3xTF32)') of K1, a valid (3,3,3)
    conv with bias, on an H100: each input read once and the output
    (``out_numel`` elements, channels included) written once over the
    memory rate, against three times its FLOPs (three TF32 products per
    multiply-add) over the TF32 tensor-core peak."""
    bound, by = bound_ms(4.0 * (x_numel + out_numel + cout * (cin * 27 + 1)),
                         3 * 2.0 * cin * 27 * out_numel, TF32_FLOP_S)
    return bound, by if by == "bytes" else "operations (3xTF32)"
