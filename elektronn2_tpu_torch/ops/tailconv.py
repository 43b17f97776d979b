"""K1 and K4: the dense sweep's tail conv and head unit, CUDA kernels for
Hopper.

K1 ports the Pallas TPU kernel ``elektronn2_tpu/ops/pallas_tailconv.py::
conv3x3_dilated``: a valid-mode (3,3,3) convolution with z-dilation 1 and
xy-dilation (dx, dy), bias and ReLU fused, at float32 accuracy. On the dense
MFP path (``neuromancer/inference.py``) it runs the flagship's conv2 and
conv3, which hold 93% of the multiply-adds per output voxel; on the
conv-dense path, the U-Net's (3,3,3) ReLU convs. Kernel:
``csrc/tailconv.cu``, a 3xTF32 implicit GEMM on the tensor cores
(``wgmma``): the weights are split into TF32 hi and lo parts and packed
for it by :func:`pack_weights` (once per weight tensor:
:func:`packed_weights`), the input is split inside the kernel.

K4 ports ``conv1x3x3_pool_dilated`` of the same module: a valid (1,3,3)
conv with isotropic xy-dilation d, bias, an optional stride-1 (2,2) max
window dilated by d, and ReLU, fused; the flagship's head units conv0+pool0
and conv1+pool1. As in the JAX package no entry point's default route calls
it. Kernel: ``csrc/headconv.cu``, two bodies: K1's 3xTF32 ``wgmma``
implicit GEMM with kz = 1 and the pool in its epilogue (:func:`head_tc`,
weights packed by :func:`pack_weights` too), and exact float32 FFMA
(:func:`head_ffma`); the wrapper picks one by Cin (:func:`head_body`).

Both read and write NCDHW with a batch dimension, so a K4 output chains into
K1 as it is; the TPU kernels' ``xzcy`` layout, ``z_block``, ``valid_y`` and
per-slab loop have no counterpart here, and neither do their TPU variants.
Each source's head note says what bounds it on the card and how.

Dispatch: a CPU tensor runs the plain PyTorch version
(:func:`conv3x3_dilated_reference`, :func:`conv1x3x3_pool_reference`); a
CUDA tensor launches the kernel or raises. ``launches`` counts K1's kernel
launches, ``head_launches`` K4's (both bodies) and ``head_tc_launches``
those of K4's tensor-core body.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils.cuda_build import load_cuda_library
from .conv import f32_convs

#: kernel launches made by :func:`conv3x3_dilated` in this process
launches = 0
#: kernel launches made by :func:`conv1x3x3_pool_dilated` in this process
head_launches = 0
#: of those, launches of the tensor-core body (:func:`head_tc`)
head_tc_launches = 0

_fn = None
_head_fns = None
_head_cout_tile = None


def build():
    """Build (on first use) and load the kernel library; returns the
    ``CudaLibrary`` (build time and nvcc's report included)."""
    global _fn
    lib = load_cuda_library("tailconv")
    if _fn is None:
        fn = lib.cdll.e2t_tailconv_tc
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return lib


def build_head():
    """Build (on first use) and load K4's library (both bodies); returns
    the ``CudaLibrary``."""
    global _head_fns, _head_cout_tile
    lib = load_cuda_library("headconv")
    if _head_fns is None:
        ffma = lib.cdll.e2t_headconv_f32
        ffma.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                         + [ctypes.c_void_p])
        tc = lib.cdll.e2t_headconv_tc
        tc.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        ffma.restype = tc.restype = ctypes.c_int
        tile = lib.cdll.e2t_headconv_cout_tile
        tile.argtypes = []
        tile.restype = ctypes.c_int
        _head_cout_tile = int(tile())
        _head_fns = {"ffma": ffma, "tc": tc}
    return lib


def _check_tensors(what, x, w, b):
    for name, t in (("x", x), ("w", w), ("b", b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: {name} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, "
                             f"x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if x.ndim != 5:
        raise ValueError(f"{what}: x must be (N, Cin, Z, X, Y), "
                         f"got shape {tuple(x.shape)}")
    if tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"{what}: b must be ({w.shape[0]},), "
                         f"got {tuple(b.shape)}")


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
    _check_tensors("tail conv", x, w, b)
    cin = x.shape[1]
    if w.ndim != 5 or tuple(w.shape[1:]) != (cin, 3, 3, 3):
        raise ValueError(f"tail conv: w must be (Cout, {cin}, 3, 3, 3), "
                         f"got {tuple(w.shape)}")
    Z, X, Y = x.shape[2:]
    if min(Z - 2, X - 2 * dx, Y - 2 * dy) < 1:
        raise ValueError(f"volume too small for fov: {(Z, X, Y)} dil {dil}")
    return dx, dy


#: input channels per k step of the kernel (one TF32 ``wgmma`` k)
K_CHUNK = 8


def n_tile(cout):
    """The kernel's N tile (output channels of one block, one ``wgmma`` N)
    for ``cout``: Cout rounded up to a multiple of 8 up to 64, else 128
    (wider Cout runs as more 128-channel groups in the grid)."""
    return -(-cout // 8) * 8 if cout <= 64 else 128


def tf32_round(t):
    """float32 -> float32 rounded to TF32 (10 explicit mantissa bits), half
    away from zero, as ``cvt.rna.tf32.f32``: an integer op on the bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t):
    """(hi, lo): ``hi`` = t rounded to TF32, ``lo`` = (t - hi) rounded to
    TF32; hi + lo is within 2^-21 |t| of t."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def pack_weights(w, NP):
    """(Cout, Cin, kz, 3, 3) float32 weights, kz = 3 (K1) or 1 (K4, which
    also takes (Cout, Cin, 3, 3)) -> the kernels' packed TF32 hi/lo weights
    for N tile ``NP`` (:func:`n_tile`, :func:`head_n_tile`), shape (G, CC,
    kz, 3, 3, 2, NP/8, 2, 8, 4) with G = ceil(Cout/NP), CC = ceil(Cin/8),
    Cout and Cin zero-padded.

    Dims: channel group, 8-channel chunk of Cin, kz, kx, ky, hi/lo, 8-row
    group of output channels, k half, row (output channel), 4 input
    channels. One (group, chunk, kz, kx) is the kernel's stage, copied
    linearly; each (ky, hi/lo) slice in it is the K-major, unswizzled tile a
    ``wgmma`` descriptor reads: core matrices of 8 output channels x 4
    input channels (128 bytes), the two k halves 128 bytes apart, the
    8-channel groups 256 bytes apart."""
    if w.ndim == 4:
        w = w[:, :, None]
    Cout, Cin, kz = w.shape[:3]
    G, CC = -(-Cout // NP), -(-Cin // K_CHUNK)
    wp = F.pad(w, (0, 0, 0, 0, 0, 0, 0, CC * K_CHUNK - Cin, 0, G * NP - Cout))
    parts = torch.stack(split_tf32(wp))  # (2, G*NP, CC*8, kz, kx, ky)
    parts = parts.reshape(2, G, NP // 8, 8, CC, 2, 4, kz, 3, 3)
    return parts.permute(1, 4, 7, 8, 9, 0, 2, 5, 3, 6).contiguous()


#: :func:`packed_weights`' cache: (address of w, NP, packer) -> (w, w's
#: version, packed); an entry holds w, so no other tensor takes its address
_packed = {}
#: entries kept (one per conv of a model; the oldest goes first)
PACKED_CACHE = 16


def packed_weights(w, NP, pack=None):
    """``pack(w, NP)`` (by default :func:`pack_weights`), cached, so that a
    model's constant weights are split and packed once and not on every
    call. An in-place update of ``w`` bumps its version and repacks; a
    write through ``w.data`` is not seen."""
    pack = pack or pack_weights
    key = (w.data_ptr(), NP, pack)
    hit = _packed.get(key)
    if hit is not None and hit[0] is w and hit[1] == w._version:
        return hit[2]
    wp = pack(w, NP)
    _packed.pop(key, None)
    if len(_packed) >= PACKED_CACHE:
        del _packed[next(iter(_packed))]
    _packed[key] = (w, w._version, wp)
    return wp


def regroup_weights(w, T, b=None):
    """(Cout, Cin, 3,3,3) weights and (Cout,) bias -> (G, Cin, 27, T) and
    (G*T,), G = ceil(Cout/T): per channel group, per input channel, the 27
    taps with the group's T output channels innermost, zero-padded. The bias
    comes back as None when none is given. The layout of the FFMA kernel
    K5; K1 and its probe P2 take :func:`pack_weights`."""
    Cout, Cin = w.shape[:2]
    G = -(-Cout // T)
    wt = F.pad(w.permute(1, 2, 3, 4, 0).reshape(Cin, 27, Cout),
               (0, G * T - Cout))
    wt = wt.reshape(Cin, 27, G, T).permute(2, 0, 1, 3).contiguous()
    return wt, None if b is None else F.pad(b, (0, G * T - Cout)).contiguous()


def conv3x3_dilated(x, w, b, dil=(1, 1, 1), relu=True):
    """Valid (3,3,3) conv, z-dilation 1, xy-dilation (dx, dy), fused bias
    and ReLU.

    x: (N, Cin, Z, X, Y) float32, contiguous; w: (Cout, Cin, 3, 3, 3);
    b: (Cout,). Returns (N, Cout, Z-2, X-2dx, Y-2dy) float32. On the card
    the sums are 3xTF32 products accumulated in float32 (float32-grade).
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
    NP = n_tile(Cout)
    wp = packed_weights(w, NP)
    y = torch.empty((N, Cout, Z - 2, X - 2 * dx, Y - 2 * dy),
                    dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(x.data_ptr(), wp.data_ptr(), b.data_ptr(), y.data_ptr(),
                  N, Cin, Z, X, Y, Cout, NP, dx, dy, stream)
    if err != 0:
        raise RuntimeError(f"tail conv kernel launch failed: CUDA error {err}")
    launches += 1
    return y


def conv3x3_dilated_reference(x, w, b, dil=(1, 1, 1)):
    """The plain PyTorch version: ``relu(conv3d(x, w, b, dilation=dil))``,
    in full float32 (cuDNN's TF32 off) on the card."""
    with f32_convs():
        return torch.relu(F.conv3d(x, w, b, dilation=tuple(int(d) for d in dil)))


def _check_head_args(x, w, b, dil, pool, relu):
    """Validate a head-unit call; returns (d, w as (Cout, Cin, 3, 3)). The
    messages are the JAX kernel's."""
    if len(dil) == 3:
        if int(dil[0]) != 1:
            raise ValueError("head kernel: z-dilation must be 1")
        dil = dil[1:]
    dxy = tuple(int(v) for v in dil)
    if len(dxy) != 2 or dxy[0] != dxy[1]:
        raise ValueError(f"head kernel: anisotropic xy dilation {dxy}")
    d = dxy[0]
    if d < 1:
        raise ValueError(f"head kernel: dilation must be positive, got {d}")
    if pool not in (1, 2):
        raise ValueError(f"head kernel: pool must be 1 or 2, got {pool}")
    if not relu:
        raise ValueError("head kernel: relu=False not supported")
    _check_tensors("head kernel", x, w, b)
    cin = x.shape[1]
    if w.ndim == 5:
        if tuple(w.shape[2:]) != (1, 3, 3):
            raise ValueError(f"head kernel needs (1,3,3), got {tuple(w.shape)}")
        w = w[:, :, 0]
    if w.ndim != 4 or tuple(w.shape[1:]) != (cin, 3, 3):
        raise ValueError(f"head kernel needs (1,3,3), got {tuple(w.shape)}")
    Z, X, Y = x.shape[2:]
    dp = d * (pool - 1)
    if min(Z, X - 2 * d - dp, Y - 2 * d - dp) < 1:
        raise ValueError(f"volume too small: {(Z, X, Y)} dil {d} "
                         f"pool {pool}")
    return d, w


#: K4 runs its tensor-core body (:func:`head_tc`) from this many input
#: channels on, below it the FFMA body (:func:`head_ffma`); with an N tile
#: of at most 16 (short ``wgmma`` k steps) from ``HEAD_TC_MIN_CIN_N16`` on.
#: A tensor-core k step takes 8 input channels (at Cin 1, the flagship's
#: conv0, 7/8 of its products are padding). Measured crossovers on an H100
#: (``scripts/exp_headconv_tc.py``, 32 z-planes): Cin 2-4 at Cout 30 (N 32,
#: d 2, pool 2); Cin 20-24 at Cout 16 (N 16, pool 1), where the FFMA body is
#: faster up to Cin 12 and by 3-5% at Cin 20, the tensor-core body by 1-4%
#: at Cin 16 and by 15% at the U-Net's dec layer (Cin 24, full size).
HEAD_TC_MIN_CIN = 4
HEAD_TC_MIN_CIN_N16 = 24


def head_body(cin, cout, pool):
    """The K4 body the wrapper runs for ``cin`` -> ``cout`` channels with
    ``pool``: ``"tc"`` or ``"ffma"``."""
    low = HEAD_TC_MIN_CIN_N16 if head_n_tile(cout, pool) <= 16 \
        else HEAD_TC_MIN_CIN
    return "tc" if cin >= low else "ffma"


def head_n_tile(cout, pool):
    """N tile of K4's tensor-core body: :func:`n_tile`, but at most 64
    with ``pool=2`` (its two-row pool ring must fit beside the stage
    ring)."""
    return min(n_tile(cout), 64) if pool == 2 else n_tile(cout)


def conv1x3x3_pool_dilated(x, w, b, dil=(1, 1), pool=2, relu=True):
    """Head unit: valid (1,3,3) conv with xy-dilation ``dil`` (isotropic),
    + bias, then with ``pool=2`` a stride-1 (2,2) max window dilated by d,
    then ReLU.

    x: (N, Cin, Z, X, Y) float32, contiguous; w: (Cout, Cin, 1, 3, 3) or
    (Cout, Cin, 3, 3), contiguous; b: (Cout,). Returns (N, Cout, Z,
    X-2d-d(pool-1), Y-2d-d(pool-1)) float32. On the card :func:`head_body`
    picks the body by Cin and the N tile.
    """
    d, w4 = _check_head_args(x, w, b, dil, pool, relu)
    if x.device.type == "cpu":
        return conv1x3x3_pool_reference(x, w, b, (d, d), pool)
    return _launch_head(head_body(x.shape[1], w4.shape[0], pool), x, w, w4, b,
                        d, pool)


def _launch_head(body, x, w, w4, b, d, pool):
    """Launch ``body``'s kernel on a validated head-unit call (``w4``, ``d``
    from :func:`_check_head_args`); returns the output."""
    global head_launches, head_tc_launches
    if x.device.type != "cuda":
        raise ValueError(f"head kernel: no kernel for device {x.device}")
    build_head()
    N, Cin, Z, X, Y = x.shape
    Cout = w4.shape[0]
    if body == "tc":
        NP = head_n_tile(Cout, pool)
        wt, bp, extra = packed_weights(w, NP), b, (NP,)
    else:
        T = _head_cout_tile
        G = -(-Cout // T)
        # (Cout, Cin, 3, 3) -> (G, Cin, 9, T): per channel group, per input
        # channel, the 9 taps with the group's T output channels innermost
        wt = F.pad(w4.permute(1, 2, 3, 0).reshape(Cin, 9, Cout),
                   (0, G * T - Cout))
        wt = wt.reshape(Cin, 9, G, T).permute(2, 0, 1, 3).contiguous()
        bp, extra = F.pad(b, (0, G * T - Cout)).contiguous(), ()
    dp = d * (pool - 1)
    y = torch.empty((N, Cout, Z, X - 2 * d - dp, Y - 2 * d - dp),
                    dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _head_fns[body](x.data_ptr(), wt.data_ptr(), bp.data_ptr(),
                              y.data_ptr(), N, Cin, Z, X, Y, Cout, *extra, d,
                              pool, stream)
    if err != 0:
        raise RuntimeError(f"head kernel ({body}) launch failed: CUDA error "
                           f"{err}")
    head_launches += 1
    if body == "tc":
        head_tc_launches += 1
    return y


def head_tc(x, w, b, dil=(1, 1), pool=2):
    """K4's tensor-core body on the card (3xTF32 ``wgmma``, float32-grade
    sums), whatever Cin; :func:`conv1x3x3_pool_dilated`'s arguments."""
    d, w4 = _check_head_args(x, w, b, dil, pool, True)
    return _launch_head("tc", x, w, w4, b, d, pool)


def head_ffma(x, w, b, dil=(1, 1), pool=2):
    """K4's FFMA body on the card (exact float32 products), whatever Cin;
    :func:`conv1x3x3_pool_dilated`'s arguments."""
    d, w4 = _check_head_args(x, w, b, dil, pool, True)
    return _launch_head("ffma", x, w, w4, b, d, pool)


def conv1x3x3_pool_reference(x, w, b, dil=(1, 1), pool=2):
    """The plain PyTorch version: ``conv3d`` (dilation (1, d, d)) + bias,
    then with ``pool=2`` ``max_pool3d`` over a (1,2,2) window of stride 1
    dilated by (1, d, d), then ReLU, in full float32 on the card."""
    d = int(dil[-1])
    w5 = w if w.ndim == 5 else w[:, :, None]
    with f32_convs():
        y = F.conv3d(x, w5, b, dilation=(1, d, d))
    if pool == 2:
        y = F.max_pool3d(y, (1, 2, 2), stride=1, dilation=(1, d, d))
    return torch.relu(y)
