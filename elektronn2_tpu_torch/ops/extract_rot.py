"""K3: frame-aligned (rotated) trilinear patch extraction, a CUDA kernel for
Hopper, in a float32 and a bf16 mode.

Port of the Pallas TPU kernel ``elektronn2_tpu/ops/pallas_extract_rot.py::
rotated_patches_pallas`` in both its modes, the patch cut of every step of
the rotated tracing rollout (``DeviceTracer(rotate_to_heading=True)``;
``rot_compute_dtype="bfloat16"`` takes the bf16 mode).
Semantics are those of the JAX package's XLA oracle
``DeviceTracer._extract_rot_batch``: the sample of output voxel i lies at
``pos + F^T (i - (p-1)/2)``, where F holds the agent's flight-frame rows;
``c0 = floor(coord)``, ``frac`` taken before ``c0`` is clipped to
``[0, dims-2]``; the 8-corner sum; and ``ok``, true when every sample has
``0 <= coord <= dims-2`` (the host ``WarpingOOBError`` criterion).

The kernel is ``csrc/extract_rot.cu`` (its head note says what bounds it and
how). It computes the coordinates in the plain version's order without FMA
contraction, so both agree bit for bit. The TPU kernel's hat-weight MXU
contraction, its window geometry, eligibility and call split have no
counterpart; its ``precision="high"`` (bf16x3) rung is an MXU workaround and
maps to float32 here. :func:`rotated_ok` is the TPU kernel's 8-box-corner
form of the ``ok`` test, kept in plain PyTorch.

The bf16 mode (:func:`rotated_patches_bf16`) is the TPU kernel's
``compute_dtype="bfloat16"`` arithmetic (``pallas_extract_rot.py:284-301``,
``:370-377``): of its hat weights only the two neighbouring corners of each
axis are non-zero, so a sample is ``sum_y wy[y] * sum_{z,x} bf16(wz*wx) *
v[z,x,y]`` with bf16 volume values, products exact in float32 and float32
sums. It reads a bf16 copy of the volume (the caller makes it once) and
stages half-width values; its coordinates, weights and ``ok`` are the
float32 mode's. :func:`rotated_patches_bf16_reference` is its plain
version, bit for bit the kernel's arithmetic.

Dispatch: a CPU tensor runs the plain PyTorch version; a CUDA tensor
launches the kernel or raises. ``launches`` and ``launches_bf16`` count
kernel launches of each mode.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils.cuda_build import load_cuda_library
from .extract import check_patch, check_tensor, shared_optin

#: kernel launches made by :func:`rotated_patches` (float32 mode) and by
#: :func:`rotated_patches_bf16` in this process (a replayed CUDA graph adds
#: the launches it captured, see ``data/tracing_utils.py``)
launches = 0
launches_bf16 = 0

_fns = None
_WHAT = "rotated patch extraction"
_caps = {}           # (device, patch, volume, dtype) -> window values
_stats = {}          # (device, dtype) -> staging_stats(device, dtype)


def build():
    """Build (on first use) and load the kernel library; returns the
    ``CudaLibrary`` (build time and nvcc's report included)."""
    global _fns
    lib = load_cuda_library("extract_rot")
    if _fns is None:
        c = lib.cdll
        P, I = ctypes.c_void_p, ctypes.c_int
        c.e2t_rotated_patches_init.argtypes = [P]
        for fn in (c.e2t_rotated_patches_f32, c.e2t_rotated_patches_bf16):
            fn.argtypes = [P] * 6 + [I] * 9 + [P]
        for fn in (c.e2t_rotated_patches_init, c.e2t_rotated_patches_f32,
                   c.e2t_rotated_patches_bf16):
            fn.restype = I
        _fns = c
    return lib


def box_edge(patch):
    """The longest edge, in voxels, of an agent's staged box for ``patch``
    under an orthonormal frame: along each axis the samples span at most
    L = |p - 1| (the lattice's diagonal), the floors of the two ends add
    one voxel, the corners one more, the rounding pad at most one."""
    return math.floor(math.sqrt(sum((p - 1) ** 2 for p in patch))) + 3


def row_values(n, elem_bytes=4):
    """Values a staged row of ``n`` voxels takes in shared memory: the
    16-byte pieces (4 floats or 8 bf16 values) that cover n values from any
    offset within 16 bytes (``stage_rows16`` in ``csrc/cp_async.cuh``)."""
    per = 16 // elem_bytes
    return per * ((n + 2 * per - 2) // per)


def staging_stats(device, dtype=torch.float32):
    """K3's running counts on ``device`` for the mode of ``dtype`` (float32
    or bfloat16), an int64 tensor of two, added to by every launch of that
    mode: the items whose box outgrew the window, so their corners were read
    from device memory (right, but slow; none for an orthonormal frame), and
    the values staged into shared memory (4 bytes each in float32, 2 in
    bf16). ``zero_()`` it to start a count. Made on the first call for the
    pair: keep that outside a CUDA graph capture (the first launch makes
    it)."""
    key = (torch.device(device), dtype)
    got = _stats.get(key)
    if got is None:
        got = _stats[key] = torch.zeros(2, dtype=torch.int64, device=key[0])
    return got


def window_values(device, patch, vol_shape, dtype=torch.float32):
    """Values of the kernel's window for ``patch`` in a volume of
    ``vol_shape`` (f, Z, X, Y) on ``device``, in the mode of ``dtype``: the
    largest box of an orthonormal frame (``box_edge``, rows of
    ``row_values``), or what the opt-in allows. Queries the card on the
    first call for its key: keep that call outside a CUDA graph capture."""
    key = (device, patch, tuple(vol_shape[1:]), dtype)
    got = _caps.get(key)
    if got is None:
        elem = 2 if dtype == torch.bfloat16 else 4
        per = 16 // elem
        optin = shared_optin(_fns.e2t_rotated_patches_init, device)
        ez, ex, ey = (min(box_edge(patch), d) for d in vol_shape[1:])
        staging_stats(device, dtype)
        got = _caps[key] = min(ez * ex * row_values(ey, elem),
                               optin // elem) // per * per
    return got


def _check_args(vol, pos, frames, patch, dtype=torch.float32):
    patch = check_patch(patch, _WHAT)
    check_tensor(vol, "vol", 4, what=_WHAT, dtype=dtype)
    check_tensor(pos, "pos", 2, like=vol, what=_WHAT)
    check_tensor(frames, "frames", 3, like=vol, what=_WHAT)
    B = pos.shape[0]
    if pos.shape[1] != 3 or tuple(frames.shape) != (B, 3, 3):
        raise ValueError(f"{_WHAT}: pos must be (B, 3) and frames (B, 3, 3), "
                         f"got {tuple(pos.shape)} and {tuple(frames.shape)}")
    if min(vol.shape[1:]) < 2:
        raise ValueError(f"{_WHAT}: volume {tuple(vol.shape[1:])} needs "
                         "every edge >= 2 (one interpolation cell)")
    return patch


def rotated_patches(vol, pos, frames, patch):
    """Frame-aligned trilinear patches and their in-bounds flags.

    vol: (f, Z, X, Y) float32, contiguous; pos: (B, 3) and frames (B, 3, 3)
    float32 on the same device. Returns ``(patches (B, f, pz, px, py)
    float32, ok (B,) bool)``; the patch values of an agent with ``ok``
    false are clipped samples, to be masked by the caller.
    """
    global launches
    patch = _check_args(vol, pos, frames, patch)
    if vol.device.type == "cpu":
        return rotated_patches_reference(vol, pos, frames, patch)
    out, ok = _launch(_fns_entry("e2t_rotated_patches_f32"), vol, pos, frames,
                      patch, torch.float32)
    launches += 1
    return out, ok


def rotated_patches_bf16(vol, pos, frames, patch):
    """:func:`rotated_patches` in the bf16 mode: ``vol`` is the (f, Z, X,
    Y) bfloat16 copy of the volume, contiguous; pos and frames float32 as
    there. Returns float32 patches (bf16 operands, float32 sums) and the
    float32 mode's ``ok``."""
    global launches_bf16
    patch = _check_args(vol, pos, frames, patch, dtype=torch.bfloat16)
    if vol.device.type == "cpu":
        return rotated_patches_bf16_reference(vol, pos, frames, patch)
    out, ok = _launch(_fns_entry("e2t_rotated_patches_bf16"), vol, pos,
                      frames, patch, torch.bfloat16)
    launches_bf16 += 1
    return out, ok


def _fns_entry(name):
    build()
    return getattr(_fns, name)


def _launch(fn, vol, pos, frames, patch, dtype):
    """Launch one mode's entry point ``fn`` on the current stream; returns
    ``(out, ok)``. A failed launch raises."""
    if vol.device.type != "cuda":
        raise ValueError(f"{_WHAT}: no kernel for device {vol.device}")
    B = pos.shape[0]
    f, Z, X, Y = vol.shape
    out = torch.empty((B, f, *patch), dtype=torch.float32, device=vol.device)
    ok = torch.empty((B,), dtype=torch.bool, device=vol.device)
    if B == 0:
        return out, ok
    if vol.data_ptr() % 16:
        # the kernel copies 16-byte pieces from 16-byte aligned addresses
        # of the volume: a view that starts mid-piece is copied first
        vol = vol.clone()
    cap = window_values(vol.device, patch, vol.shape, dtype)
    with torch.cuda.device(vol.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(vol.data_ptr(), pos.data_ptr(), frames.data_ptr(),
                 out.data_ptr(), ok.data_ptr(),
                 _stats[(vol.device, dtype)].data_ptr(), B, f, Z, X, Y,
                 *patch, cap, stream)
    if err != 0:
        raise RuntimeError(f"rotated patch kernel launch failed: CUDA error "
                           f"{err}")
    return out, ok


def _offsets(patch, device):
    """(3, P) sample offsets ``i - (p-1)/2`` of the patch lattice, z slowest."""
    grids = torch.meshgrid(
        *[torch.arange(n, dtype=torch.float32, device=device) - (n - 1) / 2.0
          for n in patch], indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids])


def rotated_coords(pos, frames, patch):
    """(B, 3, P) world coordinates of every sample: ``pos + F^T o``, summed
    as ``(F0i*o0 + F1i*o1) + F2i*o2`` (the kernel's order)."""
    o = _offsets(patch, pos.device)
    t = frames[:, 0, :, None] * o[0] + frames[:, 1, :, None] * o[1]
    t = t + frames[:, 2, :, None] * o[2]
    return pos[:, :, None] + t


def _corners(vol, pos, frames, patch):
    """The plain versions' shared part: ``ok``, and per axis the clipped
    corner index and the fraction (taken before the clip) of every
    sample."""
    f, Z, X, Y = vol.shape
    coords = rotated_coords(pos, frames, patch)
    ok = None
    c0, fr = [], []
    for d, dim in enumerate((Z, X, Y)):
        c = coords[:, d]
        inside = torch.all((c >= 0.0) & (c <= dim - 2.0), dim=1)
        ok = inside if ok is None else ok & inside
        fl = torch.floor(c)
        fr.append(c - fl)
        c0.append(torch.clamp(fl, 0.0, float(dim - 2)).long())
    return ok, c0, fr


def _gather(flat_vol, c0, X, Y, dz, dx, dy):
    """(f, B, P) volume values at corner (dz, dx, dy) of every sample."""
    return flat_vol[:, ((c0[0] + dz) * X + (c0[1] + dx)) * Y + (c0[2] + dy)]


def rotated_patches_reference(vol, pos, frames, patch):
    """The plain PyTorch version of :func:`rotated_patches`: the 8-corner
    sum as gathers from the flattened volume, vectorised over the agents.
    Constants stay Python scalars, so nothing is copied from the host."""
    f, Z, X, Y = vol.shape
    B = pos.shape[0]
    ok, c0, fr = _corners(vol, pos, frames, patch)
    flat_vol = vol.reshape(f, -1)
    acc = torch.zeros((f, B, fr[0].shape[1]), dtype=vol.dtype,
                      device=vol.device)
    for dz in (0, 1):
        wz = fr[0] if dz else 1.0 - fr[0]
        for dx in (0, 1):
            wx = fr[1] if dx else 1.0 - fr[1]
            for dy in (0, 1):
                wy = fr[2] if dy else 1.0 - fr[2]
                acc = acc + (wz * wx * wy)[None] * _gather(flat_vol, c0, X, Y,
                                                           dz, dx, dy)
    return acc.transpose(0, 1).reshape(B, f, *patch), ok


def rotated_patches_bf16_reference(vol, pos, frames, patch):
    """The plain PyTorch version of :func:`rotated_patches_bf16`, in the
    kernel's order: ``t[dy] = sum over (dz, dx) of bf16(wz*wx) * v`` from 0,
    then ``out = wy0*t[0] + wy1*t[1]`` from 0, every sum in float32; ``vol``
    is bfloat16, rounding by ``.to(torch.bfloat16).float()`` (to nearest
    even, as the kernel's ``__float2bfloat16_rn``)."""
    f, Z, X, Y = vol.shape
    B = pos.shape[0]
    ok, c0, fr = _corners(vol, pos, frames, patch)
    flat_vol = vol.reshape(f, -1)
    out = torch.zeros((f, B, fr[0].shape[1]), dtype=torch.float32,
                      device=vol.device)
    for dy in (0, 1):
        t = torch.zeros_like(out)
        for dz in (0, 1):
            wz = fr[0] if dz else 1.0 - fr[0]
            for dx in (0, 1):
                wx = fr[1] if dx else 1.0 - fr[1]
                w = (wz * wx).to(torch.bfloat16).float()
                t = t + w[None] * _gather(flat_vol, c0, X, Y, dz, dx,
                                          dy).float()
        out = out + (fr[2] if dy else 1.0 - fr[2])[None] * t
    return out.transpose(0, 1).reshape(B, f, *patch), ok


def rotated_ok(vol_shape, pos, frames, patch):
    """(B,) in-bounds flags by the 8-box-corner test: the extreme sample
    coordinates of the rotated lattice lie at the 8 corners of the patch
    box (a linear map of a box), so checking them equals checking every
    sample, up to rounding at a bound. Reference:
    ``pallas_extract_rot.py::rotated_ok``."""
    half = torch.tensor([(p - 1) / 2.0 for p in patch], dtype=torch.float32,
                        device=pos.device)
    signs = torch.tensor([[sz, sx, sy] for sz in (-1, 1) for sx in (-1, 1)
                          for sy in (-1, 1)], dtype=torch.float32,
                         device=pos.device)
    corners = signs * half                                       # (8, 3)
    c = pos[:, None, :] + torch.einsum("bji,kj->bki", frames, corners)
    hi = torch.tensor([d - 2.0 for d in vol_shape[1:]], dtype=torch.float32,
                      device=pos.device)
    return torch.all((c >= 0.0) & (c <= hi), dim=2).all(dim=1)
