"""P1: the dot-rate probe at the tail conv's dot shapes, on the card.

Port of ``scripts/exp_ptail_dot.py``: each of ``n_cells`` grid cells runs
``zb`` independent dots (M, K) @ (K, N) from operands that stay on chip (in
L2 and shared memory) and writes row 0 of each into one shared (zb, N)
block. The six configs are the JAX script's: float32 (120, 360, 512),
(120, 360, 640), (128, 360, 512) and bfloat16 (120, 432, 512), (120, 432,
640), (128, 432, 512). float32 runs on the FP32 pipe (FFMA), the pipe K1
uses; bfloat16 on the tensor cores with float32 accumulation. Kernel:
``csrc/ptail_dot.cu``.

Each row has the JAX keys ``dtype, M, K, N, ms, us_per_dot, tflops`` (the
best of three windows of ``k_disp`` calls, CUDA events), then ``bound_ms``
(the FLOPs at 67 TFLOP/s FP32 or 989 TFLOP/s dense BF16, H100 SXM data
sheet), ``plain_ms`` and ``max_abs_err`` of the plain version
(:func:`dot_rows_reference`, which computes the zb products once), and
``library_ms`` / ``library_tflops`` of one ``torch.matmul(w, x.view(zb, K,
N))`` (the same zb products once, in full float32 for float32). The kernel
must equal the plain version within rtol=atol=1e-3 for float32 (sums of 360
products of unit normals, about 19 in magnitude, in another order) and
within rtol=atol=1e-2 for bfloat16 (against the plain version on the same
bf16-rounded operands; the tensor cores' float32 accumulation is not
IEEE-exact, and atol covers sums near 0).

Usage, on the card: ``python -m elektronn2_tpu_torch.scripts.exp_ptail_dot``
(``BENCH_K``, ``CELLS``, ``ZB`` as in the JAX script); :func:`main` returns
the rows. Dispatch: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel or raises; ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import json
import os

import numpy as np
import torch

from ..ops.conv import f32_matmuls
from ..utils.cuda_build import load_cuda_library
from ..utils.device_timing import BF16_FLOP_S, FP32_FLOP_S, best_ms, bound_ms

#: kernel launches made by :func:`dot_rows` in this process
launches = 0

_fn = None

TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}


def build():
    """Build (on first use) and load the kernel library; returns the
    ``CudaLibrary``."""
    global _fn
    lib = load_cuda_library("ptail_dot")
    if _fn is None:
        fn = lib.cdll.e2t_ptail_dot
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return lib


def configs():
    """The JAX script's six (dtype, M, K, N): K = 9 * C with the tail's 40
    channels rounded up to the type's alignment (8, or 16 for bf16)."""
    out = []
    for dt in ("float32", "bfloat16"):
        align = 16 if dt == "bfloat16" else 8
        C = ((40 + align - 1) // align) * align
        out += [(dt, 120, 9 * C, 512), (dt, 120, 9 * C, 640),
                (dt, 128, 9 * C, 512)]
    return out


def _check_args(w, x, zb):
    if not (isinstance(w, torch.Tensor) and isinstance(x, torch.Tensor)):
        raise TypeError("dot probe: w and x must be torch.Tensors")
    if w.dtype not in (torch.float32, torch.bfloat16) or x.dtype != w.dtype:
        raise TypeError("dot probe: w and x must both be float32 or both "
                        f"bfloat16, got {w.dtype} and {x.dtype}")
    if w.device != x.device:
        raise ValueError(f"dot probe: w is on {w.device}, x on {x.device}")
    if w.ndim != 2 or x.ndim != 2 or x.shape[0] != zb * w.shape[1]:
        raise ValueError(f"dot probe: w must be (M, K) and x (zb*K, N), got "
                         f"{tuple(w.shape)}, {tuple(x.shape)}, zb={zb}")
    if not (w.is_contiguous() and x.is_contiguous()):
        raise ValueError("dot probe: w and x must be contiguous")


def dot_rows(w, x, zb, n_cells=1):
    """Row 0 of w @ x[zz*K:(zz+1)*K] for each zz < zb, as (zb, N) float32.

    w: (M, K), x: (zb*K, N), both float32 or both bfloat16. On the card the
    kernel computes every product in full ``n_cells`` times (every cell
    writes the same block); on the CPU the plain version computes them
    once. The kernel needs N % 128 == 0 and K % 8 (float32) or K % 16
    (bfloat16) == 0.
    """
    global launches
    _check_args(w, x, zb)
    if w.device.type == "cpu":
        return dot_rows_reference(w, x, zb)
    if w.device.type != "cuda":
        raise ValueError(f"dot probe: no kernel for device {w.device}")
    M, K = w.shape
    N = x.shape[1]
    bf16 = w.dtype == torch.bfloat16
    if N % 128 or K % (16 if bf16 else 8):
        raise ValueError(f"dot probe: the kernel needs N % 128 == 0 and K % "
                         f"{16 if bf16 else 8} == 0, got K={K}, N={N}")
    build()
    out = torch.empty((zb, N), dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(w.data_ptr(), x.data_ptr(), out.data_ptr(), M, K, N, zb,
                  n_cells, 0, int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"dot probe kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def dot_rows_reference(w, x, zb):
    """The plain PyTorch version: ``torch.stack([(w @ x[zz*K:(zz+1)*K])[0]
    for zz in range(zb)])`` in float32 (bf16 operands widened exactly), in
    full float32 on the card."""
    K = w.shape[1]
    w32, x32 = w.float(), x.float()
    with f32_matmuls():
        return torch.stack([(w32 @ x32[zz * K:(zz + 1) * K])[0]
                            for zz in range(zb)])


def main(k_disp=8, n_cells=1024, zb=8, seed=0):
    """Run the probe's six configs on the card; returns one dict per config.
    Without a CUDA device it raises: the probe measures the card only."""
    if not torch.cuda.is_available():
        raise RuntimeError("exp_ptail_dot runs on the card only "
                           "(torch.cuda.is_available() is false)")
    rows = []
    for dt, M, K, N in configs():
        rng = np.random.RandomState(seed)
        # rounded to bf16 once, here; the plain version widens it exactly
        w = torch.from_numpy(rng.randn(M, K).astype(np.float32)).cuda().to(
            getattr(torch, dt))
        x = torch.from_numpy(rng.randn(zb * K, N).astype(
            np.float32)).cuda().to(getattr(torch, dt))
        got = dot_rows(w, x, zb, n_cells)
        ref = dot_rows_reference(w, x, zb)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, **TOL[dt])
        err = (got - ref).abs().max().item()
        ms = best_ms(lambda: dot_rows(w, x, zb, n_cells), k_disp)
        pms = best_ms(lambda: dot_rows_reference(w, x, zb), k_disp)
        xv = x.view(zb, K, N)
        with f32_matmuls():
            lms = best_ms(lambda: torch.matmul(w, xv), k_disp)
        flop = 2.0 * M * K * N * zb * n_cells
        # w and x read once, the (zb, N) block written once
        bound, by = bound_ms(w.element_size() * (w.numel() + x.numel())
                             + 4.0 * zb * N, flop,
                             BF16_FLOP_S if dt == "bfloat16" else FP32_FLOP_S)
        rows.append(dict(dtype=dt, M=M, K=K, N=N, ms=ms,
                         us_per_dot=ms * 1e3 / (zb * n_cells),
                         tflops=flop / ms / 1e9, bound_ms=bound, bound_by=by,
                         plain_ms=pms, library_ms=lms,
                         library_tflops=2.0 * M * K * N * zb / lms / 1e9,
                         max_abs_err=err, cells=n_cells, zb=zb))
        del w, x, xv, got, ref
    return rows


if __name__ == "__main__":
    for row in main(k_disp=int(os.environ.get("BENCH_K", "8")),
                    n_cells=int(os.environ.get("CELLS", "1024")),
                    zb=int(os.environ.get("ZB", "8"))):
        print(json.dumps(row), flush=True)
