"""P2: ablation probes of K1's per-row cost, on the card.

Port of ``scripts/exp_ptail_ablate.py``. ``csrc/ptail_ablate.cu`` is a
standalone copy of the FFMA body K1 had until its redesign as a 3xTF32
tensor-core GEMM, with legs removed, the probe a template parameter (WRONG
VALUES except for ``full`` and ``noepi``: timing only). It probes that FFMA
design and is not rewritten for the tensor-core K1. The body's legs on the
card are its global input loads (dma), its shared-memory weight staging
(stage), its FFMA loop (dot), bias + ReLU (epi) and its stores (out); the
probes, named as in the JAX script:

  full     the FFMA body unchanged
  nodot    loads, staging, epilogue; one add per loaded value, no FFMAs
  nostage  the dot reads its weights from global memory, no staging
  noepi    raw accumulators stored (no bias, no ReLU)
  dotonly  the FFMA loop on register values, no loads, weights staged once
  none     loads and stores only
  dmaonly  loads; every block writes one shared tiny block
  outonly  stores only

Each row has the JAX keys ``probe, ms, us_per_row, tflops_padded`` (the best
of three windows of ``k_disp`` calls, CUDA events; a row is one (n, z, x)
output row, K1's block; the port pads nothing, so ``tflops_padded`` is the
plain FLOP count over the time) and ``k1_ms``, the redesigned K1 at the
same shape beside the FFMA body's ``full``: their gap is the redesign's
gain, not a drift of the copy. ``full`` and ``noepi`` are held
against their plain versions (:func:`probe_reference`: K1's plain version,
and the same conv without bias and ReLU) within rtol=atol=1e-4 (float32
sums of 27*Cin products in another order); their rows carry
``max_abs_err``, and ``full``'s also K1's plain time, one ``F.conv3d`` with
the bias (``library_ms``) and the bound on an H100. The other six are
checked for shape and finite values only. The z-block (``ZB``) of the JAX
script has no counterpart: K1 on the card has none.

Usage, on the card: ``python -m elektronn2_tpu_torch.scripts.exp_ptail_ablate``
(``SHAPE``, ``DIL``, ``COUT``, ``BENCH_K``, ``PROBES`` as in the JAX
script); :func:`main` returns the rows. Dispatch: a CPU tensor runs the
probe's plain version, which only ``full`` and ``noepi`` have; a CUDA tensor
launches the kernel or raises. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import json
import os

import torch
import torch.nn.functional as F

from ..ops import tailconv
from ..ops.conv import f32_convs
from ..utils.cuda_build import load_cuda_library
from ..utils.device_timing import best_ms, bound_ms

PROBES = ("full", "nodot", "nostage", "noepi", "dotonly", "none", "dmaonly",
          "outonly")
TOL = dict(rtol=1e-4, atol=1e-4)
#: a run-time value for dotonly's registers and outonly's stores (the
#: compiler must not see a constant)
FILL = 0.5

#: kernel launches made by :func:`ablate` in this process
launches = 0

_fn = None
_cout_tile = None
_tiny = None


def build():
    """Build (on first use) and load the kernel library; returns the
    ``CudaLibrary``."""
    global _fn, _cout_tile, _tiny
    lib = load_cuda_library("ptail_ablate")
    if _fn is None:
        fn = lib.cdll.e2t_ptail_ablate_f32
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 8 + [ctypes.c_float,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
        for name in ("e2t_ptail_ablate_cout_tile", "e2t_ptail_ablate_tiny"):
            getattr(lib.cdll, name).argtypes = []
            getattr(lib.cdll, name).restype = ctypes.c_int
        _cout_tile = int(lib.cdll.e2t_ptail_ablate_cout_tile())
        _tiny = int(lib.cdll.e2t_ptail_ablate_tiny())
        _fn = fn
    return lib


def _noepi_reference(x, w, b, dil):
    with f32_convs():
        return F.conv3d(x, w, dilation=tuple(int(d) for d in dil))


#: the probes whose values mean something, and their plain versions
_PLAIN = {"full": tailconv.conv3x3_dilated_reference,
          "noepi": _noepi_reference}


def probe_reference(probe, x, w, b, dil=(1, 1, 1)):
    """The plain PyTorch version of ``full`` (K1's: conv3d + bias, ReLU) or
    ``noepi`` (conv3d alone), in full float32 on the card. The other probes
    compute nothing anyone reads and have none: ValueError."""
    if probe not in _PLAIN:
        raise ValueError(f"probe {probe!r} is timing only (its values are "
                         "wrong by design): it has no plain version")
    return _PLAIN[probe](x, w, b, dil)


def ablate(probe, x, w, b, dil=(1, 1, 1)):
    """Run probe ``probe`` of K1's body on K1's arguments (x (N, Cin, Z, X,
    Y), w (Cout, Cin, 3, 3, 3), b (Cout,) float32, dilation (1, dx, dy)).
    Returns K1's output shape, except ``dmaonly``: one shared block of a
    few hundred floats."""
    global launches
    if probe not in PROBES:
        raise ValueError(f"unknown probe {probe!r}; the probes are {PROBES}")
    dx, dy = tailconv._check_args(x, w, b, dil, True)
    if x.device.type == "cpu":
        return probe_reference(probe, x, w, b, dil)
    if x.device.type != "cuda":
        raise ValueError(f"ablation probe: no kernel for device {x.device}")
    build()
    N, Cin, Z, X, Y = x.shape
    Cout = w.shape[0]
    wt, bp = tailconv.regroup_weights(w, _cout_tile, b)
    if probe == "dmaonly":  # a block of fewer threads writes part of it
        y = torch.zeros((_tiny,), dtype=torch.float32, device=x.device)
    else:
        y = torch.empty((N, Cout, Z - 2, X - 2 * dx, Y - 2 * dy),
                        dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(PROBES.index(probe), x.data_ptr(), wt.data_ptr(),
                  bp.data_ptr(), y.data_ptr(), N, Cin, Z, X, Y, Cout, dx, dy,
                  FILL, stream)
    if err != 0:
        raise RuntimeError(f"ablation probe {probe} launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return y


def main(shape=(1, 40, 34, 320, 531), dil=(1, 4, 4), cout=40, k_disp=8,
         probes=PROBES, seed=0):
    """Run the probes on the card at K1's arguments for ``shape`` (N, Cin,
    Z, X, Y); returns one dict per probe. Without a CUDA device it raises:
    the probe measures the card only."""
    if not torch.cuda.is_available():
        raise RuntimeError("exp_ptail_ablate runs on the card only "
                           "(torch.cuda.is_available() is false)")
    N, Cin, Z, X, Y = shape
    _, dx, dy = dil
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, device="cuda", generator=g)
    w = torch.randn((cout, Cin, 3, 3, 3), device="cuda", generator=g) / 30
    b = torch.randn((cout,), device="cuda", generator=g)
    zo, xo, yo = Z - 2, X - 2 * dx, Y - 2 * dy
    n_rows = N * zo * xo
    flop = 2.0 * N * zo * xo * yo * cout * Cin * 27
    tailconv.conv3x3_dilated(x, w, b, dil)       # built and warm
    # the redesigned (3xTF32) K1, beside the FFMA body's probes
    k1_ms = best_ms(lambda: tailconv.conv3x3_dilated(x, w, b, dil), k_disp)
    rows = []
    for probe in probes:
        out = ablate(probe, x, w, b, dil)
        torch.cuda.synchronize()
        want = (N, cout, zo, xo, yo) if probe != "dmaonly" else out.shape
        if tuple(out.shape) != tuple(want) or not bool(
                torch.isfinite(out).all()):
            raise AssertionError(f"probe {probe}: shape {tuple(out.shape)}, "
                                 f"finite {bool(torch.isfinite(out).all())}")
        row = dict(probe=probe)
        if probe in _PLAIN:
            ref = probe_reference(probe, x, w, b, dil)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref, **TOL)
            row["max_abs_err"] = (out - ref).abs().max().item()
            del ref
        del out
        ms = best_ms(lambda: ablate(probe, x, w, b, dil), k_disp)
        row.update(ms=ms, us_per_row=ms * 1e3 / n_rows,
                   tflops_padded=flop / ms / 1e9, k1_ms=k1_ms)
        if probe == "full":
            with f32_convs():
                lms = best_ms(lambda: F.conv3d(x, w, b, dilation=dil),
                               k_disp)
            bound, by = bound_ms(
                4.0 * (x.numel() + w.numel() + b.numel()
                       + N * cout * zo * xo * yo), flop)
            row.update(plain_ms=best_ms(
                lambda: tailconv.conv3x3_dilated_reference(x, w, b, dil),
                k_disp), library_ms=lms, bound_ms=bound, bound_by=by)
        rows.append(dict(row, shape=list(shape), dil=list(dil), cout=cout))
    return rows


if __name__ == "__main__":
    def _ints(name, default):
        return tuple(int(v) for v in os.environ.get(name, default).split(","))

    for r in main(shape=_ints("SHAPE", "1,40,34,320,531"),
                  dil=_ints("DIL", "1,4,4"),
                  cout=int(os.environ.get("COUT", "40")),
                  k_disp=int(os.environ.get("BENCH_K", "8")),
                  probes=tuple(os.environ.get(
                      "PROBES", ",".join(PROBES)).split(","))):
        print(json.dumps(r), flush=True)
