"""ctypes loader of the C++ warp gather core, compiled on first use.

Jax-free copy of ``elektronn2_tpu/data/_warp_native.py``: compile
``warp_core.cpp`` (a copy of the JAX package's) with g++ on first use into
``elektronn2_tpu_torch/_build/`` (``utils/native_build.py``), as
``_knossos_native`` does. ``transformations._native`` falls back to the
vectorised numpy path, the semantics oracle, when the build fails (no
compiler); the tests assert exact agreement of the two.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "warp_core.cpp")

_lib = None


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
    lib.warp_map_linear_f32.restype = None
    lib.warp_map_linear_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), i64, i64, i64, i64,
        ctypes.POINTER(ctypes.c_double), i64,
        ctypes.POINTER(ctypes.c_float)]
    lib.warp_map_nearest_i32.restype = None
    lib.warp_map_nearest_i32.argtypes = [
        ctypes.POINTER(ctypes.c_int32), i64, i64, i64, i64,
        ctypes.POINTER(ctypes.c_double), i64,
        ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return lib


def map_linear_f32(src, coords):
    """src (F, Z, X, Y) float32, coords (3, N) -> (F, N) float32."""
    lib = get_lib()
    src = np.ascontiguousarray(src, np.float32)
    coords = np.ascontiguousarray(coords, np.float64)
    F, Z, X, Y = src.shape
    N = coords.shape[1]
    out = np.empty((F, N), np.float32)
    lib.warp_map_linear_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        F, Z, X, Y,
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), N,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def map_nearest_i32(src, coords):
    """src (F, Z, X, Y) int32, coords (3, N) -> (F, N) int32."""
    lib = get_lib()
    src = np.ascontiguousarray(src, np.int32)
    coords = np.ascontiguousarray(coords, np.float64)
    F, Z, X, Y = src.shape
    N = coords.shape[1]
    out = np.empty((F, N), np.int32)
    lib.warp_map_nearest_i32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        F, Z, X, Y,
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), N,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
