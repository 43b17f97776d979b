"""K2: batched trilinear patch extraction, a CUDA kernel for Hopper.

Port of the Pallas TPU kernel ``elektronn2_tpu/ops/pallas_extract.py::
trilinear_patches_pallas``, the patch cut of every step of the translation
tracing rollout (``data/tracing_utils.py::DeviceTracer``). Semantics are
those of the JAX package's ``DeviceTracer._extract``: per agent, ``corner =
pos - (p-1)/2``, ``base = floor(corner)``, ``frac = corner - base`` taken
before ``base`` is clipped to ``[0, dim-(p+1)]``, and the 8-corner weighted
sum in the order dz, dx, dy with weight ``(wz*wx)*wy``.

The kernel is ``csrc/extract.cu`` (its head note says what bounds it and
how). It takes every geometry the plain version takes, or raises: the TPU
kernel's eligibility rules (Y % 128, X % 8) and its 512-agent call split
have no counterpart here.

Dispatch: a CPU tensor runs :func:`trilinear_patches_reference`, the plain
PyTorch version; a CUDA tensor launches the kernel or raises. ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import load_cuda_library

#: kernel launches made by :func:`trilinear_patches` in this process
launches = 0

_fn = None


def build():
    """Build (on first use) and load the kernel library; returns the
    ``CudaLibrary`` (build time and nvcc's report included)."""
    global _fn
    lib = load_cuda_library("extract")
    if _fn is None:
        fn = lib.cdll.e2t_trilinear_patches_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return lib


def check_tensor(t, name, ndim, like=None, what="patch extraction"):
    """Raise unless ``t`` is a contiguous float32 tensor of rank ``ndim``
    (on ``like``'s device, when given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: {name} must be a torch.Tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
    if like is not None and t.device != like.device:
        raise ValueError(f"{what}: {name} is on {t.device}, vol on "
                         f"{like.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")
    if t.ndim != ndim:
        raise ValueError(f"{what}: {name} must have rank {ndim}, got shape "
                         f"{tuple(t.shape)}")


def check_patch(patch, what="patch extraction"):
    patch = tuple(int(p) for p in patch)
    if len(patch) != 3 or min(patch) < 1:
        raise ValueError(f"{what}: patch must be three positive sizes, "
                         f"got {patch}")
    return patch


def _check_args(vol, pos, patch):
    patch = check_patch(patch)
    check_tensor(vol, "vol", 4)
    check_tensor(pos, "pos", 2, like=vol)
    if pos.shape[1] != 3:
        raise ValueError(f"patch extraction: pos must be (B, 3), got "
                         f"{tuple(pos.shape)}")
    if any(d < p + 1 for d, p in zip(vol.shape[1:], patch)):
        raise ValueError(f"volume {tuple(vol.shape[1:])} too small for patch "
                         f"{patch} (+1 interpolation slab)")
    return patch


def trilinear_patches(vol, pos, patch):
    """Trilinear patches at float positions (translation only).

    vol: (f, Z, X, Y) float32, contiguous; pos: (B, 3) float32 on the same
    device. Returns (B, f, pz, px, py) float32.
    """
    global launches
    patch = _check_args(vol, pos, patch)
    if vol.device.type == "cpu":
        return trilinear_patches_reference(vol, pos, patch)
    if vol.device.type != "cuda":
        raise ValueError(f"patch extraction: no kernel for device "
                         f"{vol.device}")
    build()
    B = pos.shape[0]
    f, Z, X, Y = vol.shape
    out = torch.empty((B, f, *patch), dtype=torch.float32, device=vol.device)
    if B == 0:
        return out
    with torch.cuda.device(vol.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(vol.data_ptr(), pos.data_ptr(), out.data_ptr(), B, f, Z, X,
                  Y, *patch, stream)
    if err != 0:
        raise RuntimeError(
            f"trilinear patch kernel launch failed: CUDA error {err} "
            f"(patch {patch}: a (p+1)^3 window of "
            f"{4 * (patch[0] + 1) * (patch[1] + 1) * (patch[2] + 1)} bytes "
            "must fit the card's shared memory per block)")
    launches += 1
    return out


def trilinear_patches_reference(vol, pos, patch):
    """The plain PyTorch version, vectorised over the agents: the 8-corner
    sum of :func:`trilinear_patches` as gathers from the flattened volume.
    Constants stay Python scalars, so nothing is copied from the host."""
    f, Z, X, Y = vol.shape
    dev = vol.device
    base, frac = [], []
    for d, (dim, p) in enumerate(zip((Z, X, Y), patch)):
        corner = pos[:, d] - (p - 1) / 2.0
        fl = torch.floor(corner)
        frac.append(corner - fl)
        base.append(torch.clamp(fl, 0.0, float(dim - (p + 1))).long())
    iz, ix, iy = (torch.arange(n, device=dev) for n in patch)
    zi = base[0][:, None, None, None] + iz[None, :, None, None]
    xi = base[1][:, None, None, None] + ix[None, None, :, None]
    yi = base[2][:, None, None, None] + iy[None, None, None, :]
    flat_vol = vol.reshape(f, -1)
    out = torch.zeros((f, pos.shape[0], *patch), dtype=vol.dtype, device=dev)
    for dz in (0, 1):
        wz = frac[0] if dz else 1.0 - frac[0]
        for dx in (0, 1):
            wx = frac[1] if dx else 1.0 - frac[1]
            for dy in (0, 1):
                wy = frac[2] if dy else 1.0 - frac[2]
                idx = ((zi + dz) * X + (xi + dx)) * Y + (yi + dy)
                w = (wz * wx * wy)[None, :, None, None, None]
                out = out + w * flat_vol[:, idx]
    return out.transpose(0, 1).contiguous()
