"""Probe: the host's time for one call of the patch-kernel wrappers, K2
(``ops/extract.py::trilinear_patches``) and K3 (``ops/extract_rot.py::
rotated_patches``), as the eager tracing loop makes them.

One agent and a 4^3 patch keep each launch's device time under the host's,
so the wall of back-to-back calls, divided by their number, is the host's
cost of a call: the argument checks, the output's allocation, the wrapper's
own bookkeeping and the launch. The script imports ``elektronn2_tpu_torch``
from wherever Python finds it first, so one copy of it times two checkouts
of the package in turns: ``PYTHONPATH=<checkout> python3 <this file>``.

Usage, on the card: ``python -m elektronn2_tpu_torch.scripts.exp_wrapper_host``
(prints one JSON line per wrapper); :func:`main` returns the rows.
"""

from __future__ import annotations

import json
import statistics
import time

import torch

import elektronn2_tpu_torch
from elektronn2_tpu_torch.ops import extract, extract_rot

CALLS = 2000
REPEATS = 7
PATCH = (4, 4, 4)


def host_us(fn):
    """Host microseconds per call of ``fn``, one figure per repeat of
    ``CALLS`` back-to-back calls (synchronised between repeats only)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        runs.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
    return runs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("exp_wrapper_host: needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    vol = torch.rand((1, 32, 32, 32), device="cuda", generator=g)
    pos = torch.full((1, 3), 15.3, device="cuda")
    frames = torch.eye(3, device="cuda")[None].contiguous()
    rows = []
    for name, fn in (
            ("trilinear_patches",
             lambda: extract.trilinear_patches(vol, pos, PATCH)),
            ("rotated_patches",
             lambda: extract_rot.rotated_patches(vol, pos, frames, PATCH))):
        runs = host_us(fn)
        rows.append(dict(probe="wrapper_host", wrapper=name,
                         package=elektronn2_tpu_torch.__file__,
                         host_us_median=statistics.median(runs),
                         host_us=runs, calls=CALLS, patch=list(PATCH)))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
