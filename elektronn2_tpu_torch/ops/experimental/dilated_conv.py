"""K5: the im2col dilated conv, a CUDA kernel for Hopper.

Port of the Pallas TPU kernel ``elektronn2_tpu/ops/experimental/
pallas_dilated_conv.py::dilated_conv_pallas``: a valid (3,3,3) convolution
with isotropic dilation d, no bias and no ReLU, summed in float32 over one
K = 27*Cin contraction. As in the JAX package no route of the system calls
it; its entry point is this module's benchmark, ``python -m
elektronn2_tpu_torch.ops.experimental.dilated_conv`` (:func:`main`), on the
card. Kernel: ``csrc/dilated_conv.cu`` (its head note says what bounds it on
the card and how).

The contract is the JAX function's: activations (Z, X, Cin, Y), ``Yo``
defaults to Y - 2d and the input may be over-padded in Y; the output is
(Z-2d, X-2d, Cout_pad, Yo) with Cout_pad = ceil(Cout/8)*8 and channels
Cout..Cout_pad-1 exactly 0. The TPU tiling rules (``TY``, ``Yo % TY``, the
over-padding for the ``TYA`` row copies, Cin padded to 8) have no
counterpart here.

Dispatch: a CPU tensor runs the plain PyTorch version
(:func:`dilated_conv_reference`); a CUDA tensor launches the kernel or
raises. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import json

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.cuda_build import load_cuda_library
from ...utils.device_timing import bound_ms, in_turns, time_ms
from ..conv import f32_convs
from ..tailconv import regroup_weights

#: kernel launches made by :func:`dilated_conv` in this process
launches = 0

_fn = None
_cout_tile = None


def build():
    """Build (on first use) and load the kernel library; returns the
    ``CudaLibrary``."""
    global _fn, _cout_tile
    lib = load_cuda_library("dilated_conv")
    if _fn is None:
        fn = lib.cdll.e2t_dilated_conv_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        tile = lib.cdll.e2t_dilated_conv_cout_tile
        tile.argtypes = []
        tile.restype = ctypes.c_int
        _cout_tile = int(tile())
        _fn = fn
    return lib


def cout_pad(cout):
    """The output's channel count: Cout rounded up to a multiple of 8."""
    return -(-int(cout) // 8) * 8


def _check_args(x, w, d, Yo):
    """Validate a call; returns (d, Yo)."""
    for name, t in (("x", x), ("w", w)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"dilated conv: {name} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"dilated conv: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"dilated conv: {name} must be contiguous")
    if w.device != x.device:
        raise ValueError(f"dilated conv: w is on {w.device}, x on {x.device}")
    if x.ndim != 4:
        raise ValueError("dilated conv: x must be (Z, X, Cin, Y), got shape "
                         f"{tuple(x.shape)}")
    Z, X, Cin, Y = x.shape
    if w.ndim != 5 or tuple(w.shape[1:]) != (Cin, 3, 3, 3):
        raise ValueError(f"dilated conv: w must be (Cout, {Cin}, 3, 3, 3), "
                         f"got {tuple(w.shape)}")
    d = int(d)
    if d < 1:
        raise ValueError(f"dilated conv: dilation must be positive, got {d}")
    Yo = Y - 2 * d if Yo is None else int(Yo)
    if min(Z - 2 * d, X - 2 * d) < 1:
        raise ValueError(f"volume too small for fov: {(Z, X, Y)} dil {d}")
    if Yo < 1 or Yo > Y - 2 * d:
        raise ValueError(f"dilated conv: Yo={Yo} needs 1 <= Yo <= Y - 2d = "
                         f"{Y - 2 * d}")
    return d, Yo


def dilated_conv(x_zxcy, w, d, Yo=None):
    """Valid (3,3,3) conv with isotropic dilation ``d``, no bias.

    x_zxcy: (Z, X, Cin, Y) float32, contiguous, Y possibly over-padded;
    w: (Cout, Cin, 3, 3, 3) float32. Yo: the output's y extent (default
    Y - 2d). Returns (Z-2d, X-2d, Cout_pad, Yo) float32 with channels
    Cout..Cout_pad-1 zero.
    """
    global launches
    d, Yo = _check_args(x_zxcy, w, d, Yo)
    if x_zxcy.device.type == "cpu":
        return dilated_conv_reference(x_zxcy, w, d, Yo)
    if x_zxcy.device.type != "cuda":
        raise ValueError(f"dilated conv: no kernel for device {x_zxcy.device}")
    build()
    Z, X, Cin, Y = x_zxcy.shape
    Cout = w.shape[0]
    Cp = cout_pad(Cout)
    # K1's grouping; ceil(Cout/40) groups also cover Cout_pad (40 = 5 * 8)
    wt, _ = regroup_weights(w, _cout_tile)
    y = torch.empty((Z - 2 * d, X - 2 * d, Cp, Yo), dtype=torch.float32,
                    device=x_zxcy.device)
    with torch.cuda.device(x_zxcy.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(x_zxcy.data_ptr(), wt.data_ptr(), y.data_ptr(), Z, X, Cin,
                  Y, Cout, Cp, Yo, d, stream)
    if err != 0:
        raise RuntimeError(f"dilated conv kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return y


def dilated_conv_reference(x_zxcy, w, d, Yo=None):
    """The plain PyTorch version: the input cropped to the Yo + 2d rows the
    output reads, transposed to NCDHW, ``F.conv3d(dilation=(d, d, d))`` in
    full float32 (cuDNN's TF32 off) on the card, transposed back to (Zo, Xo,
    Cout, Yo) and zero-padded to Cout_pad channels."""
    d, Yo = _check_args(x_zxcy, w, d, Yo)
    xn = x_zxcy[..., :Yo + 2 * d].permute(2, 0, 1, 3)[None]
    with f32_convs():
        y = F.conv3d(xn, w, dilation=(d, d, d))[0]
    y = y.permute(1, 2, 0, 3)
    return F.pad(y, (0, 0, 0, cout_pad(w.shape[0]) - w.shape[0])).contiguous()


def conv_flop(zo, xo, yo, cin, cout):
    """Multiply-adds of the conv, counted as 2 FLOP each (real channels)."""
    return 2.0 * zo * xo * yo * cin * cout * 27


def conv_bound(x, w, out):
    """(bound ms, 'bytes' or 'operations') of K5 on an H100 for these
    tensors: x, w read once and the output written once over the memory
    rate, against the real channels' FLOPs over the FP32 rate."""
    zo, xo, _, yo = out.shape
    cout, cin = w.shape[:2]
    nbytes = 4.0 * (x.numel() + w.numel() + out.numel())
    return bound_ms(nbytes, conv_flop(zo, xo, yo, cin, cout))


TOL = dict(rtol=1e-4, atol=1e-4)


def check(got, ref, cout):
    """Hold the kernel's output against the plain version's: within
    rtol=atol=1e-4 (float32 sums of 27*Cin products in another order), and
    the pad channels exactly 0. Returns the largest difference."""
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, **TOL)
    if not bool((got[:, :, cout:] == 0).all()):
        raise AssertionError("dilated conv: pad channels are not 0")
    return (got - ref).abs().max().item()


#: the benchmark's cases, the JAX ``__main__``'s (:110-164):
#: (name, Z, X, Cin, Y, Cout, d, Yo)
CORRECT_CASE = ("correct", 12, 12, 5, 136, 7, 4, 128)
PERF_CASE = ("perf", 44, 307, 30, 640, 40, 4, 512)


def main(k=3, seed=0):
    """Port of the JAX module's ``__main__``: the correctness case (held
    against the plain version by :func:`check`), then the perf case timed with
    CUDA events in turns (plain, kernel, kernel, plain) beside one
    ``F.conv3d`` on the same input in NCDHW (the transpose outside the
    timed window), with TFLOP/s for each. Returns one dict per case.
    Without a CUDA device it raises: the benchmark measures the card only."""
    if not torch.cuda.is_available():
        raise RuntimeError("dilated_conv's benchmark runs on the card only "
                           "(torch.cuda.is_available() is false)")
    rng = np.random.RandomState(seed)
    name, Z, X, Cin, Y, Cout, d, Yo = CORRECT_CASE
    xs = torch.from_numpy(rng.rand(Z, X, Cin, Y).astype(np.float32)).cuda()
    ws = torch.from_numpy(rng.rand(Cout, Cin, 3, 3, 3).astype(
        np.float32)).cuda()
    got = dilated_conv(xs, ws, d, Yo)
    ref = dilated_conv_reference(xs, ws, d, Yo)
    rows = [dict(case=name, x=[Z, X, Cin, Y], cout=Cout, d=d, Yo=Yo,
                 out=list(got.shape), max_abs_err=check(got, ref, Cout))]

    name, Z, X, Cin, Y, Cout, d, Yo = PERF_CASE
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((Z, X, Cin, Y), device="cuda", generator=g)
    w = torch.rand((Cout, Cin, 3, 3, 3), device="cuda", generator=g)
    got = dilated_conv(x, w, d, Yo)
    err = check(got, dilated_conv_reference(x, w, d, Yo), Cout)
    ms, pms = in_turns(lambda: dilated_conv(x, w, d, Yo),
                       lambda: dilated_conv_reference(x, w, d, Yo), k)
    xn = x[..., :Yo + 2 * d].permute(2, 0, 1, 3)[None].contiguous()
    with f32_convs():
        lms = time_ms(lambda: F.conv3d(xn, w, dilation=(d, d, d)), k)
    flop = conv_flop(Z - 2 * d, X - 2 * d, Yo, Cin, Cout)
    bound, by = conv_bound(x, w, got)
    rows.append(dict(case=name, x=[Z, X, Cin, Y], cout=Cout, d=d, Yo=Yo,
                     out=list(got.shape), max_abs_err=err, ms=ms,
                     plain_ms=pms, library_ms=lms, bound_ms=bound,
                     bound_by=by, kernel_tflop_s=flop / ms / 1e9,
                     plain_tflop_s=flop / pms / 1e9,
                     library_tflop_s=flop / lms / 1e9))
    return rows


if __name__ == "__main__":
    for row in main():
        print(json.dumps(row), flush=True)
