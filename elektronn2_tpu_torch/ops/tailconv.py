"""K1: the dense-sweep tail conv, a CUDA kernel for Hopper.

Port of the Pallas TPU kernel ``elektronn2_tpu/ops/pallas_tailconv.py::
conv3x3_dilated``: a valid-mode (3,3,3) convolution with z-dilation 1 and
xy-dilation (dx, dy), bias and ReLU fused, summed in float32. On the dense
MFP path (``neuromancer/inference.py``) it runs the flagship's conv2 and
conv3, which hold 93% of the multiply-adds per output voxel.

The kernel is ``csrc/tailconv.cu`` (exact float32 FFMA; its head note says
what bounds it and how). It reads and writes NCDHW with a batch dimension,
so the TPU kernel's chained ``xzcy`` layout and its per-slab loop have no
counterpart here, and neither do its TPU variants and knobs.

Dispatch: a CPU tensor runs :func:`conv3x3_dilated_reference`, the plain
PyTorch version; a CUDA tensor launches the kernel or raises. ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils.cuda_build import load_cuda_library
from .conv import f32_convs

#: kernel launches made by :func:`conv3x3_dilated` in this process
launches = 0

_fn = None
_cout_tile = None


def build():
    """Build (on first use) and load the kernel library; returns the
    ``CudaLibrary`` (build time and nvcc's report included)."""
    global _fn, _cout_tile
    lib = load_cuda_library("tailconv")
    if _fn is None:
        fn = lib.cdll.e2t_tailconv_f32
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        tile = lib.cdll.e2t_tailconv_cout_tile
        tile.argtypes = []
        tile.restype = ctypes.c_int
        _cout_tile = int(tile())
        _fn = fn
    return lib


def _check_args(x, w, b, dil, relu):
    """Validate the call; returns (dx, dy). The messages for z-dilation,
    ReLU and a too-small volume are the JAX kernel's."""
    dz, dx, dy = (int(d) for d in dil)
    if dz != 1:
        raise ValueError("tail conv: z-dilation must be 1")
    if not relu:
        raise ValueError("tail conv: relu=False not supported (the kernel "
                         "fuses bias + ReLU)")
    if dx < 1 or dy < 1:
        raise ValueError(f"tail conv: dilation must be positive, got {dil}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"tail conv: {name} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"tail conv: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"tail conv: {name} is on {t.device}, "
                             f"x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"tail conv: {name} must be contiguous")
    if x.ndim != 5:
        raise ValueError(f"tail conv: x must be (N, Cin, Z, X, Y), "
                         f"got shape {tuple(x.shape)}")
    cin = x.shape[1]
    if w.ndim != 5 or tuple(w.shape[1:]) != (cin, 3, 3, 3):
        raise ValueError(f"tail conv: w must be (Cout, {cin}, 3, 3, 3), "
                         f"got {tuple(w.shape)}")
    if tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"tail conv: b must be ({w.shape[0]},), "
                         f"got {tuple(b.shape)}")
    Z, X, Y = x.shape[2:]
    if min(Z - 2, X - 2 * dx, Y - 2 * dy) < 1:
        raise ValueError(f"volume too small for fov: {(Z, X, Y)} dil {dil}")
    return dx, dy


def conv3x3_dilated(x, w, b, dil=(1, 1, 1), relu=True):
    """Valid (3,3,3) conv, z-dilation 1, xy-dilation (dx, dy), fused bias
    and ReLU.

    x: (N, Cin, Z, X, Y) float32, contiguous; w: (Cout, Cin, 3, 3, 3);
    b: (Cout,). Returns (N, Cout, Z-2, X-2dx, Y-2dy) float32.
    """
    global launches
    dx, dy = _check_args(x, w, b, dil, relu)
    if x.device.type == "cpu":
        return conv3x3_dilated_reference(x, w, b, dil)
    if x.device.type != "cuda":
        raise ValueError(f"tail conv: no kernel for device {x.device}")
    build()
    N, Cin, Z, X, Y = x.shape
    Cout = w.shape[0]
    T = _cout_tile
    G = -(-Cout // T)
    # (Cout, Cin, 3,3,3) -> (G, Cin, 27, T): per channel group, per input
    # channel, the 27 taps with the group's T output channels innermost
    wt = F.pad(w.permute(1, 2, 3, 4, 0).reshape(Cin, 27, Cout),
               (0, G * T - Cout))
    wt = wt.reshape(Cin, 27, G, T).permute(2, 0, 1, 3).contiguous()
    bp = F.pad(b, (0, G * T - Cout)).contiguous()
    y = torch.empty((N, Cout, Z - 2, X - 2 * dx, Y - 2 * dy),
                    dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(x.data_ptr(), wt.data_ptr(), bp.data_ptr(), y.data_ptr(),
                  N, Cin, Z, X, Y, Cout, dx, dy, stream)
    if err != 0:
        raise RuntimeError(f"tail conv kernel launch failed: CUDA error {err}")
    launches += 1
    return y


def conv3x3_dilated_reference(x, w, b, dil=(1, 1, 1)):
    """The plain PyTorch version: ``relu(conv3d(x, w, b, dilation=dil))``,
    in full float32 (cuDNN's TF32 off) on the card."""
    with f32_convs():
        return torch.relu(F.conv3d(x, w, b, dilation=tuple(int(d) for d in dil)))
