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

#: kernel launches made by :func:`trilinear_patches` in this process (a
#: replayed CUDA graph adds the launches it captured, see
#: ``data/tracing_utils.py``)
launches = 0

_fns = None
_optins = {}         # (init, device index) -> opt-in bytes
_windows = set()     # (device, patch) whose window fits the device


def build():
    """Build (on first use) and load the kernel library; returns the
    ``CudaLibrary`` (build time and nvcc's report included)."""
    global _fns
    lib = load_cuda_library("extract")
    if _fns is None:
        c = lib.cdll
        P, I = ctypes.c_void_p, ctypes.c_int
        c.e2t_trilinear_patches_init.argtypes = [P]
        c.e2t_trilinear_patches_window_bytes.argtypes = [I] * 3
        c.e2t_trilinear_patches_f32.argtypes = [P] * 3 + [I] * 8 + [P]
        for fn in (c.e2t_trilinear_patches_init,
                   c.e2t_trilinear_patches_window_bytes,
                   c.e2t_trilinear_patches_f32):
            fn.restype = I
        _fns = c
    return lib


def row_floats(n):
    """Floats a staged row of ``n`` voxels takes in shared memory: the
    16-byte pieces that cover n floats from any offset within 16 bytes
    (``stage_rows16`` in ``csrc/cp_async.cuh``)."""
    return 4 * ((n + 6) // 4)


def staged_floats(patch):
    """Floats K2 copies per (agent, channel): the (p+1)^3 window in rows of
    16-byte pieces."""
    return (patch[0] + 1) * (patch[1] + 1) * row_floats(patch[2] + 1)


def shared_optin(init, device):
    """The opt-in shared bytes per block of ``device``, from the library's
    ``init`` entry point, which also lifts the kernel's dynamic
    shared-memory limit to that opt-in. Runs once per device: keep the first
    call outside a CUDA graph capture (``DeviceTracer`` warms up first)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    got = _optins.get((init.__name__, idx))
    if got is None:
        optin = ctypes.c_int(0)
        with torch.cuda.device(idx):
            err = init(ctypes.byref(optin))
        if err != 0:
            raise RuntimeError(f"patch kernel init failed: CUDA error {err}")
        got = _optins[(init.__name__, idx)] = optin.value
    return got


def _check_window(device, patch):
    """Raise unless the kernel's window for ``patch`` fits a block on
    ``device`` (checked once per pair, outside a capture as
    :func:`shared_optin`)."""
    if (device, patch) in _windows:
        return
    optin = shared_optin(_fns.e2t_trilinear_patches_init, device)
    window = _fns.e2t_trilinear_patches_window_bytes(*patch)
    if window > optin:
        raise ValueError(
            f"trilinear patch kernel: patch {patch} needs a window of "
            f"{window} bytes, over the card's {optin} bytes of shared "
            "memory per block")
    _windows.add((device, patch))


def check_tensor(t, name, ndim, like=None, what="patch extraction",
                 dtype=torch.float32):
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` (float32) and
    rank ``ndim`` (on ``like``'s device, when given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: {name} must be a torch.Tensor")
    if t.dtype != dtype:
        raise TypeError(f"{what}: {name} must be {str(dtype)[6:]}, got "
                        f"{t.dtype}")
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
    if vol.data_ptr() % 16:
        # the kernel copies 16-byte pieces from 16-byte aligned addresses
        # of the volume: a view that starts mid-piece is copied first
        vol = vol.clone()
    _check_window(vol.device, patch)
    with torch.cuda.device(vol.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fns.e2t_trilinear_patches_f32(
            vol.data_ptr(), pos.data_ptr(), out.data_ptr(), B, f, Z, X, Y,
            *patch, stream)
    if err != 0:
        raise RuntimeError(f"trilinear patch kernel launch failed: CUDA error "
                           f"{err}")
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
