"""Probe: the two choices in K4's bodies (``csrc/headconv.cu``), on the card.

1. Occupancy of the tensor-core body: the committed ``TcShape`` (two blocks
   an SM and a 4-stage ring up to N = 64, else one block of 5 stages)
   against the body's first form, one block of a 5-stage ring at every N,
   built from the same source with ``TcShape`` replaced; the FFMA body and
   the plain version beside them. At the flagship's conv1 unit (20->30, d 2,
   pool 2), the U-Net decoder layer dec (24->16), the wide U-Net's d0
   (128->64) and a 40->48 layer (N = 48); each body held against the plain
   version (rtol=atol=1e-4: float32 sums of 9*Cin products in another
   order).
2. The Cin crossover of the two bodies, which ``ops/tailconv.py::
   head_body`` follows: both at Cin 1 to 20 on a conv1-like unit (Cout 30,
   d 2, pool 2) and a dec-like one (Cout 16, pool 1), 32 z-planes.

Times: CUDA events, in turns (``palindrome_ms``). Usage, on the card:
``python -m elektronn2_tpu_torch.scripts.exp_headconv_tc`` (one JSON line per
row); :func:`main` returns the rows. Without a CUDA device it raises.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

import torch

from ..ops import tailconv
from ..utils.cuda_build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc
from ..utils.device_timing import palindrome_ms

TOL = dict(rtol=1e-4, atol=1e-4)
#: ``TcShape`` of the body's first form: one block of 5 stages at every N
ONE_BLOCK = (("BLOCKS = NP <= 64 ? 2 : 1;", "BLOCKS = 1;"),
             ("STAGES = NP <= 64 ? 4 : 5;", "STAGES = 5;"))
#: (name, Cin, Cout, (Z, X, Y), d, pool) of the occupancy rows
SHAPES = [("conv1", 20, 30, (124, 518, 518), 2, 2),
          ("dec-128x512", 24, 16, (128, 512, 512), 1, 1),
          ("wide-d0", 128, 64, (128, 456, 456), 1, 1),
          ("n48", 40, 48, (64, 300, 300), 1, 1)]
CROSS_CIN = (1, 2, 4, 6, 8, 12, 16, 20)
#: (name, Cout, (Z, X, Y), d, pool) of the crossover rows
CROSS = [("conv1-like", 30, (32, 518, 518), 2, 2),
         ("dec-like", 16, (32, 512, 512), 1, 1)]


def build_variant(name, subs):
    """Compile ``csrc/headconv.cu`` with the text substitutions ``subs``
    into the build directory; returns its tensor-core entry point."""
    with open(os.path.join(CSRC_DIR, "headconv.cu")) as f:
        text = f.read()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} not in headconv.cu")
        text = text.replace(old, new)
    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(BUILD_DIR, f"headconv_{name}.cu")
    so = os.path.join(BUILD_DIR, f"libheadconv_{name}.so")
    with open(src, "w") as f:
        f.write(text)
    res = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", so,
                          src], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed building {src}:\n"
                           f"{res.stdout + res.stderr}")
    fn = ctypes.CDLL(so).e2t_headconv_tc
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def run_tc(fn, x, w, b, d, pool):
    """One launch of a tensor-core entry point ``fn`` on the wrapper's
    operands (packed weights, N tile)."""
    N, Cin, Z, X, Y = x.shape
    Cout = w.shape[0]
    NP = tailconv.head_n_tile(Cout, pool)
    dp = d * (pool - 1)
    y = torch.empty((N, Cout, Z, X - 2 * d - dp, Y - 2 * d - dp),
                    device=x.device)
    err = fn(x.data_ptr(), tailconv.packed_weights(w, NP).data_ptr(),
             b.data_ptr(), y.data_ptr(), N, Cin, Z, X, Y, Cout, NP, d, pool,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"head kernel variant: CUDA error {err}")
    return y


def _inputs(g, cin, cout, sp):
    x = torch.rand((1, cin) + tuple(sp), device="cuda", generator=g) - 0.5
    w = (torch.rand(cout, cin, 1, 3, 3, device="cuda", generator=g)
         - 0.5) * (2.0 / (9 * cin)) ** 0.5
    b = torch.rand(cout, device="cuda", generator=g) * 0.2 - 0.1
    return x, w, b


def main(seed=0):
    """Run both measurements on the card; returns one dict per row."""
    if not torch.cuda.is_available():
        raise RuntimeError("exp_headconv_tc runs on the card only "
                           "(torch.cuda.is_available() is false)")
    tailconv.build_head()
    first = build_variant("one_block", ONE_BLOCK)
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for name, cin, cout, sp, d, pool in SHAPES:
        x, w, b = _inputs(g, cin, cout, sp)
        dil = (d, d)
        fns = [lambda: tailconv.conv1x3x3_pool_reference(x, w, b, dil, pool),
               lambda: tailconv.head_tc(x, w, b, dil, pool),
               lambda: run_tc(first, x, w, b, d, pool),
               lambda: tailconv.head_ffma(x, w, b, dil, pool)]
        ref = fns[0]()
        err = 0.0
        for fn in fns[1:]:
            got = fn()
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, **TOL)
            err = max(err, (got - ref).abs().max().item())
            del got
        del ref
        pms, tms, oms, fms = palindrome_ms(fns)
        rows.append(dict(probe="occupancy", case=name, x=[1, cin, *sp],
                         cout=cout, d=d, pool=pool,
                         n_tile=tailconv.head_n_tile(cout, pool), tc_ms=tms,
                         one_block_ms=oms, ffma_ms=fms, plain_ms=pms,
                         max_abs_err=err))
        del x, w, b
        torch.cuda.empty_cache()
    for name, cout, sp, d, pool in CROSS:
        for cin in CROSS_CIN:
            x, w, b = _inputs(g, cin, cout, sp)
            dil = (d, d)
            tms, fms = palindrome_ms([
                lambda: tailconv.head_tc(x, w, b, dil, pool),
                lambda: tailconv.head_ffma(x, w, b, dil, pool)])
            runs = tailconv.head_body(cin, cout, pool)
            rows.append(dict(probe="crossover", case=name, cin=cin,
                             cout=cout, d=d, pool=pool, tc_ms=tms,
                             ffma_ms=fms, faster="tc" if tms < fms else "ffma",
                             wrapper_runs=runs))
    return rows


if __name__ == "__main__":
    for row in main():
        print(json.dumps(row), flush=True)
