"""P1: the dot-rate probe at the tail conv's dot shapes, on the card.

Port of ``scripts/exp_ptail_dot.py``: each of ``n_cells`` grid cells runs
``zb`` independent dots (M, K) @ (K, N) from operands that stay on chip (in
L2 and shared memory) and writes one row of each into one shared (zb, N)
block. The six configs are the JAX script's: float32 (120, 360, 512),
(120, 360, 640), (128, 360, 512) and bfloat16 (120, 432, 512), (120, 432,
640), (128, 432, 512). Both run on the tensor cores (``wgmma``), their
operands staged from L2 through a ``cp.async`` ring: float32 in K1's own
arithmetic and layout, 3xTF32 with the partials promoted into float32
totals every 72 TF32 products (:data:`PROMOTE` k chunks of 8), w split and
packed on the host (:func:`pack_weights`, cached per tensor); bfloat16 as
bf16 products with float32 accumulation. Kernel: ``csrc/ptail_dot.cu``.

Each row has the JAX keys ``dtype, M, K, N, ms, us_per_dot, tflops`` (the
best of three windows of ``k_disp`` calls, CUDA events), then ``bound_ms``
and ``bound_by`` (float32: 3 x the FLOPs at 495 TFLOP/s, "operations
(3xTF32)"; bf16: the FLOPs at 989 TFLOP/s; H100 SXM data sheet),
``plain_ms`` and ``max_abs_err`` of the plain version
(:func:`dot_rows_reference`, which computes the zb products once), and
``library_ms`` / ``library_tflops`` of one batched ``torch.matmul`` over
the same ``n_cells`` x ``zb`` dots in the row's type (x's zb blocks
repeated ``n_cells`` times outside the timed window; float32 in full
float32), and ``dot_only_ms``: the kernel's dot-only instance, whose
steps all reuse one stage filled once, so the ``wgmma``s alone (timing
only). The kernel must equal the plain version within rtol=atol=1e-3
for float32 (sums of 360 products of unit normals, about 19 in magnitude,
in another order) and within rtol=atol=1e-2 for bfloat16 (against the
plain version on the same bf16-rounded operands; the tensor cores' float32
accumulation is not IEEE-exact, and atol covers sums near 0). The float32
rows are also held against float64, as K1 is: ``f64_max_abs`` at most
2 x the plain float32 version's (``plain_f64_max_abs``) + 1e-6.

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
import torch.nn.functional as F

from ..ops import tailconv
from ..ops.conv import f32_matmuls
from ..utils.cuda_build import load_cuda_library
from ..utils.device_timing import (BF16_FLOP_S, TF32_FLOP_S, best_ms,
                                   bound_ms)

#: kernel launches made by :func:`dot_rows` in this process
launches = 0

_fn = None

TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}
#: the kernel's wgmma N: w's rows, zero-padded (at most this many)
NT = 128
#: k chunks of 8 summed into one set of partials before they are added
#: into the float32 totals: one stage of the kernel, 72 TF32 products (24
#: multiply-adds x 3 terms)
PROMOTE = 3
#: bfloat16 keeps w in shared memory: K at most this
BF16_KMAX = 512


def build():
    """Build (on first use) and load the kernel library; returns the
    ``CudaLibrary``."""
    global _fn
    lib = load_cuda_library("ptail_dot")
    if _fn is None:
        fn = lib.cdll.e2t_ptail_dot
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
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


def pack_weights(w, NP=NT):
    """(M, K) float32 weights -> the float32 kernel's packed TF32 hi/lo,
    shape (K'/8, 2, NP/8, 2, 8, 4), K' = K rounded up to a multiple of 24
    (a stage of 3 chunks), rows and k zero-padded to NP and K'.

    Dims: 8-k chunk, hi/lo, 8-row group of w, k half, row, 4 k. A stage's
    3 chunks are copied linearly; each chunk's hi and lo is the K-major,
    unswizzled tile a ``wgmma`` B descriptor reads, as
    :func:`tailconv.pack_weights` packs K1's weights: core matrices of 8
    rows x 4 k (128 bytes), the two k halves 128 bytes apart, the 8-row
    groups 256 bytes apart."""
    M, K = w.shape
    KP = -(-K // 24) * 24
    parts = torch.stack(tailconv.split_tf32(
        F.pad(w, (0, KP - K, 0, NP - M))))
    parts = parts.reshape(2, NP // 8, 8, KP // 8, 2, 4)
    return parts.permute(3, 0, 1, 4, 2, 5).contiguous()


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


def dot_rows(w, x, zb, n_cells=1, dot_only=False):
    """Row 0 of w @ x[zz*K:(zz+1)*K] for each zz < zb, as (zb, N) float32.

    w: (M, K), x: (zb*K, N), both float32 or both bfloat16. On the card the
    kernel computes every product in full ``n_cells`` times (every cell
    writes the same block); on the CPU the plain version computes them
    once. The kernel needs M <= 128, N % 128 == 0, K % 8 == 0 (float32) or
    K % 16 == 0 and K <= 512 (bfloat16), and 16-byte aligned operands.
    ``dot_only`` launches the dot-only instance instead (on the card only;
    its values are wrong by design, for timing).
    """
    global launches
    _check_args(w, x, zb)
    if w.device.type == "cpu":
        if dot_only:
            raise ValueError("dot probe: dot_only is timing only and runs "
                             "on the card only")
        return dot_rows_reference(w, x, zb)
    if w.device.type != "cuda":
        raise ValueError(f"dot probe: no kernel for device {w.device}")
    M, K = w.shape
    N = x.shape[1]
    bf16 = w.dtype == torch.bfloat16
    if (M > NT or N % NT or K % (16 if bf16 else 8)
            or (bf16 and K > BF16_KMAX)):
        raise ValueError(
            f"dot probe: the kernel needs M <= {NT}, N % {NT} == 0 and "
            + ("K % 16 == 0, K <= 512" if bf16 else "K % 8 == 0")
            + f", got M={M}, K={K}, N={N}")
    if w.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("dot probe: w and x must be 16-byte aligned")
    build()
    wk = w if bf16 else tailconv.packed_weights(w, NT, pack_weights)
    out = torch.empty((zb, N), dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(wk.data_ptr(), x.data_ptr(), out.data_ptr(), M, K, N, zb,
                  n_cells, 0, int(bf16), int(dot_only), stream)
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


def batched_library_ms(w, x, zb, n_cells, k_disp):
    """The library call, like for like: one batched ``torch.matmul`` over
    the same ``n_cells`` x ``zb`` dots the kernel computes, in w's type
    (float32 in full float32); x's zb blocks are repeated ``n_cells`` times
    outside the timed window."""
    K, N = w.shape[1], x.shape[1]
    xb = x.view(zb, K, N).repeat(n_cells, 1, 1)
    with f32_matmuls():
        ms = best_ms(lambda: torch.matmul(w, xb), k_disp)
    del xb
    torch.cuda.empty_cache()
    return ms


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
        row = dict(dtype=dt, M=M, K=K, N=N,
                   max_abs_err=(got - ref).abs().max().item())
        flop = 2.0 * M * K * N * zb * n_cells
        # w and x read once, the (zb, N) block written once
        nbytes = w.element_size() * (w.numel() + x.numel()) + 4.0 * zb * N
        if dt == "float32":
            ref64 = torch.stack([(w.double() @ x[zz * K:(zz + 1) * K]
                                  .double())[0] for zz in range(zb)])
            k64 = (got.double() - ref64).abs().max().item()
            p64 = (ref.double() - ref64).abs().max().item()
            row.update(f64_max_abs=k64, plain_f64_max_abs=p64)
            if k64 > 2 * p64 + 1e-6:
                raise AssertionError(f"dot probe {row}: {k64} from float64, "
                                     f"over 2x the plain float32's {p64} "
                                     "+ 1e-6")
            bound, by = bound_ms(nbytes, 3 * flop, TF32_FLOP_S)
            by = by if by == "bytes" else "operations (3xTF32)"
        else:
            bound, by = bound_ms(nbytes, flop, BF16_FLOP_S)
        ms = best_ms(lambda: dot_rows(w, x, zb, n_cells), k_disp)
        dms = best_ms(lambda: dot_rows(w, x, zb, n_cells, dot_only=True),
                      k_disp)
        pms = best_ms(lambda: dot_rows_reference(w, x, zb), k_disp)
        lms = batched_library_ms(w, x, zb, n_cells, k_disp)
        row.update(ms=ms, us_per_dot=ms * 1e3 / (zb * n_cells),
                   tflops=flop / ms / 1e9, bound_ms=bound, bound_by=by,
                   plain_ms=pms, library_ms=lms,
                   library_tflops=flop / lms / 1e9, dot_only_ms=dms,
                   cells=n_cells, zb=zb)
        rows.append(row)
        del w, x, got, ref
    return rows


if __name__ == "__main__":
    for row in main(k_disp=int(os.environ.get("BENCH_K", "8")),
                    n_cells=int(os.environ.get("CELLS", "1024")),
                    zb=int(os.environ.get("ZB", "8"))):
        print(json.dumps(row), flush=True)
