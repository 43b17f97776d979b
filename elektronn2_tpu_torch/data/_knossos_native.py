"""ctypes loader/builder for the C++ KNOSSOS cube core.

Jax-free copy of ``elektronn2_tpu/data/_knossos_native.py``: compile
``knossos_core.cpp`` (a copy of the JAX package's) with g++ on first use
into ``elektronn2_tpu_torch/_build/`` (``utils/native_build.py``), and
degrade gracefully to the numpy path when no compiler is available.
The numpy path in ``knossos_array.py::KnossosArray._load_cube`` remains
the semantics oracle (tests assert exact agreement, including the
missing-cube zero-fill).

The core loads a BATCH of cubes (parallel pread + cache-blocked
(z,y,x)->(z,x,y) transpose, GIL-free); all cache/LRU/placement logic
stays in Python.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "knossos_core.cpp")

_lib = None

_FUNCS = {
    np.dtype(np.uint8): "knossos_load_cubes_u8",
    np.dtype(np.uint16): "knossos_load_cubes_u16",
    np.dtype(np.float32): "knossos_load_cubes_f32",
}

_ASSEMBLE = {
    np.dtype(np.uint8): "knossos_assemble_u8",
    np.dtype(np.uint16): "knossos_assemble_u16",
    np.dtype(np.float32): "knossos_assemble_f32",
}


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    from ..utils.native_build import build_shared, shared_path
    so = shared_path(_SRC)
    if not os.path.exists(so):
        build_shared(_SRC, so, extra_flags=("-pthread",))
    lib = ctypes.CDLL(so)
    i64 = ctypes.c_int64
    pi32 = ctypes.POINTER(ctypes.c_int32)
    pi64 = ctypes.POINTER(ctypes.c_int64)
    for name in _FUNCS.values():
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), i64, i64,
                       ctypes.c_void_p, pi32, i64]
    for name in _ASSEMBLE.values():
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), i64, i64,
                       ctypes.c_void_p, i64, i64, i64, pi64, pi32, i64]
    _lib = lib
    return lib


def supports(dtype) -> bool:
    return np.dtype(dtype) in _FUNCS


def load_cubes(paths, edge, dtype, n_threads=None):
    """Load ``len(paths)`` raw cubes as a list of independent (e, e, e)
    arrays in (z, x, y) axis order. Missing files zero-fill (same as the
    Python path); short / oversized files raise IOError naming the cube.

    Each cube gets its own allocation so callers (the LRU cube cache) can
    drop cubes independently.
    """
    lib = get_lib()
    dtype = np.dtype(dtype)
    n = len(paths)
    e = int(edge)
    cubes = [np.empty((e, e, e), dtype) for _ in range(n)]
    if n == 0:
        return cubes
    status = np.zeros(n, np.int32)
    cpaths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    couts = (ctypes.c_void_p * n)(*[c.ctypes.data for c in cubes])
    if n_threads is None:
        n_threads = min(n, os.cpu_count() or 1)
    getattr(lib, _FUNCS[dtype])(
        cpaths, n, e, couts,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(n_threads))
    _raise_bad(status, paths, e, dtype)
    return cubes


def _raise_bad(status, paths, e, dtype):
    bad = np.nonzero(status < 0)[0]
    if bad.size:
        i = int(bad[0])
        reason = ("size mismatch (expected exactly %d %s items)"
                  % (e ** 3, dtype) if status[i] == -1 else "read error")
        raise IOError(f"cube {paths[i]}: {reason}")


def assemble(paths, offsets, edge, out, n_threads=None):
    """Assemble raw cubes directly into the (Z, X, Y) ``out`` volume.

    ``offsets[i]`` = (dz, dx, dy) placement of cube i's origin relative to
    ``out``'s origin (may be negative / overhang -- clipped). Every written
    voxel comes from exactly one cube; missing cubes zero-fill their
    clipped region. One read + one transposed write per cube, GIL-free,
    parallel across cubes.
    """
    lib = get_lib()
    dtype = out.dtype
    if not out.flags.c_contiguous:
        raise ValueError("assemble requires a C-contiguous output volume")
    n = len(paths)
    e = int(edge)
    if n == 0:
        return out
    status = np.zeros(n, np.int32)
    offs = np.ascontiguousarray(offsets, np.int64)
    if offs.shape != (n, 3):
        raise ValueError(f"offsets must be (n, 3), got {offs.shape}")
    cpaths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    if n_threads is None:
        n_threads = min(n, os.cpu_count() or 1)
    Zo, Xo, Yo = out.shape
    getattr(lib, _ASSEMBLE[dtype])(
        cpaths, n, e, out.ctypes.data_as(ctypes.c_void_p),
        int(Zo), int(Xo), int(Yo),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(n_threads))
    _raise_bad(status, paths, e, dtype)
    return out
