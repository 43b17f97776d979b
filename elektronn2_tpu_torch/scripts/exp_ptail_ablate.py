"""P2: ablation probes of K1, the tensor-core tail conv, on the card.

Port of ``scripts/exp_ptail_ablate.py``, which is the production tail body
with legs removed. So is this: ``csrc/ptail_ablate.cu`` builds K1's own
kernel body (``csrc/tailconv_tc_body.cuh``, the one ``csrc/tailconv.cu``
builds) once per probe, the probe a template parameter (WRONG VALUES except
for ``full`` and ``noepi``: timing only). The body is a producer
warpgroup feeding a ring of (8-channel chunk, kz) stages to two consumer
warpgroups; its legs on the card are the producer's copies into the ring
(TMA boxes or ``cp.async`` rows of input, a bulk copy of the stage's packed
weights) with its waits for free slots (dma), and the consumers' A
fragment ``ld.shared`` and TF32 split (stage), 27 ``wgmma``s a (tile,
stage) (dot), promotion of the partials once a (tile, stage) then bias and
ReLU (epi) and the stores (out); the probes, named as in the JAX script:

  full     every leg: K1 itself (equal to K1 bit for bit)
  nodot    dma, stage, epi, out; each split fragment folded into the
           partials by one add, no wgmma
  nostage  dma, dot, epi, out; the A fragments loaded and split once,
           before the loop
  noepi    dma, stage, dot, out; one accumulator a tile over all stages,
           no promotion, no bias and no ReLU (the bare conv)
  dotonly  dot only, from a stage filled once; raw stores
  none     dma and out
  dmaonly  dma; every block writes one shared tiny block
  outonly  out only

Each row has the JAX keys ``probe, ms, us_per_row, tflops_padded`` (the best
of three windows of ``k_disp`` calls, CUDA events; a row is one (n, z, x)
output row; ``tflops_padded`` is the plain FLOP count over the time, the
port pads nothing the JAX kernel pads) and ``k1_ms``, K1 through its
wrapper at the same shape, which ``full`` should match within noise.
``full`` is held to K1's output with ``torch.equal`` and to K1's plain
version within rtol=atol=1e-4 (float32 sums of 27*Cin products in another
order); ``noepi`` to the conv without bias and ReLU within
:func:`noepi_tol` (its sum of 27*Cin*3 TF32 products in one truncating
float32 accumulator). Their rows carry ``max_abs_err`` (``noepi``'s also
its ``atol``), and ``full``'s also K1's plain time, one ``F.conv3d`` with
the bias (``library_ms``), K1's bound on an H100 (3 x the FLOPs at 495
TFLOP/s, "operations (3xTF32)") and the bytes K1's producer stages
(:func:`k1_staged_bytes`: ``staged_weight_bytes``,
``staged_input_bytes``), which ``dmaonly`` copies too. The other six are
checked for shape and finite values only.
The z-block (``ZB``) of the JAX script has no counterpart: K1 on the card
has none.

The kernel is built at the N tiles of :data:`N_TILES` only (Cout 33-40,
41-48, and over 64); another Cout raises ``ValueError``.

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
from ..utils.device_timing import best_ms, conv3x3_bound

PROBES = ("full", "nodot", "nostage", "noepi", "dotonly", "none", "dmaonly",
          "outonly")
#: the N tiles (``tailconv.n_tile``) the probe kernel is built for
N_TILES = (40, 48, 128)
TOL = dict(rtol=1e-4, atol=1e-4)


def noepi_tol(cin, ref):
    """The tolerance ``noepi`` is held to against the bare conv ``ref``.
    Its 27*Cin*3 TF32 products go into one float32 accumulator, whose
    truncation K1's promotion keeps in check; without it the error grows
    with the products summed and the size of the sums, about 2^-24 x
    27*Cin x rms(ref) on an H100 (6.2e-5 at the canonical shape: 1080
    products, rms 1.09; 8.1e-4 at the U-Net's d1 conv: 6912 products, rms
    2.77). So atol = 1e-4 x max(1, 27*Cin/1080 x rms(ref)), rtol 1e-4."""
    rms = ref.float().square().mean().sqrt().item()
    return dict(rtol=1e-4, atol=1e-4 * max(1.0, 27 * cin / 1080 * rms))

#: kernel launches made by :func:`ablate` in this process
launches = 0

_fn = None
_tiny = None


def build():
    """Build (on first use) and load the kernel library; returns the
    ``CudaLibrary``."""
    global _fn, _tiny
    lib = load_cuda_library("ptail_ablate")
    if _fn is None:
        fn = lib.cdll.e2t_ptail_ablate
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        tiny = lib.cdll.e2t_ptail_ablate_tiny
        tiny.argtypes = []
        tiny.restype = ctypes.c_int
        _tiny = int(tiny())
        _fn = fn
    return lib


def k1_staged_bytes(shape, cout, dil):
    """(packed-weight bytes, input-row bytes) that K1's producer copies
    into shared memory in one call at ``shape`` (N, Cin, Z, X, Y), ``cout``
    and ``dil``: K1's plan (``tailconv.tc_plan``), each tile staging every
    (8-channel chunk, kz) stage once: the stage's 9 taps of packed weights
    of its channel group and its R + 2 input rows."""
    N, Cin, Z, X, Y = shape
    _, dx, dy = dil
    plan = tailconv.tc_plan(N, Cin, cout, Z, X, Y, dx, dy)
    stages = plan["ntiles"] * -(-Cin // tailconv.K_CHUNK) * 3
    return (stages * 9 * 2 * plan["NP"] * tailconv.K_CHUNK * 4,
            stages * (plan["R"] + 2) * plan["rowb"])


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
    few hundred floats. Cout's N tile must be one of :data:`N_TILES`."""
    global launches
    if probe not in PROBES:
        raise ValueError(f"unknown probe {probe!r}; the probes are {PROBES}")
    dx, dy = tailconv._check_args(x, w, b, dil, True)
    NP = tailconv.n_tile(w.shape[0])
    if NP not in N_TILES:
        raise ValueError(f"ablation probe: Cout {w.shape[0]} needs N tile "
                         f"{NP}; the probe kernel is built for N tiles "
                         f"{N_TILES}")
    if x.device.type == "cpu":
        return probe_reference(probe, x, w, b, dil)
    if x.device.type != "cuda":
        raise ValueError(f"ablation probe: no kernel for device {x.device}")
    build()
    N, Cin, Z, X, Y = x.shape
    Cout = w.shape[0]
    wp = tailconv.packed_weights(w, NP)
    if probe == "dmaonly":
        y = torch.zeros((_tiny,), dtype=torch.float32, device=x.device)
    else:
        y = torch.empty((N, Cout, Z - 2, X - 2 * dx, Y - 2 * dy),
                        dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(PROBES.index(probe), x.data_ptr(), wp.data_ptr(),
                  b.data_ptr(), y.data_ptr(), N, Cin, Z, X, Y, Cout, NP, dx,
                  dy, stream)
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
    k1 = tailconv.conv3x3_dilated(x, w, b, dil)       # built and warm
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
        if probe == "full":
            if not torch.equal(out, k1):
                raise AssertionError("probe full: not equal to K1 bit for bit "
                                     f"(max {(out - k1).abs().max().item()})")
            row["equals_k1"] = True
        if probe in _PLAIN:
            ref = probe_reference(probe, x, w, b, dil)
            torch.cuda.synchronize()
            tol = TOL if probe == "full" else noepi_tol(Cin, ref)
            torch.testing.assert_close(out, ref, **tol)
            row["max_abs_err"] = (out - ref).abs().max().item()
            if probe == "noepi":
                row["atol"] = tol["atol"]
            del ref
        del out
        ms = best_ms(lambda: ablate(probe, x, w, b, dil), k_disp)
        row.update(ms=ms, us_per_row=ms * 1e3 / n_rows,
                   tflops_padded=flop / ms / 1e9, k1_ms=k1_ms)
        if probe == "full":
            with f32_convs():
                lms = best_ms(lambda: F.conv3d(x, w, b, dilation=dil),
                              k_disp)
            bound, by = conv3x3_bound(Cin, cout, x.numel(),
                                      N * cout * zo * xo * yo)
            wbytes, xbytes = k1_staged_bytes(shape, cout, dil)
            row.update(plain_ms=best_ms(
                lambda: tailconv.conv3x3_dilated_reference(x, w, b, dil),
                k_disp), library_ms=lms, bound_ms=bound, bound_by=by,
                staged_weight_bytes=wbytes, staged_input_bytes=xbytes)
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
