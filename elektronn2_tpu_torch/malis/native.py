"""ctypes loader/builder for the C++ MALIS core.

Jax-free copy of ``elektronn2_tpu/malis/native.py``: compile
``malis_core.cpp`` (a copy of the JAX package's) with g++ on first use into
``elektronn2_tpu_torch/_build/`` (``utils/native_build.py``), never next to
the source. Without a compiler the package falls back to the numpy
implementation (``malis._malis_pass_np``), as the JAX package does.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "malis_core.cpp")

_lib = None


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    from ..utils.native_build import build_shared, shared_path
    so = shared_path(_SRC)
    if not os.path.exists(so):
        build_shared(_SRC, so)
    lib = ctypes.CDLL(so)
    lib.malis_pass.restype = None
    lib.malis_pass.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float)]
    _lib = lib
    return lib


def malis_pass(aff, seg, nhood, count_pos):
    """Native maximin pass: aff (E, Z, X, Y) float32, seg (Z, X, Y) int32,
    nhood (E, 3) int32 -> per-edge pair-count weights, same shape as aff."""
    lib = get_lib()
    aff = np.ascontiguousarray(aff, np.float32)
    seg = np.ascontiguousarray(seg, np.int32)
    nhood = np.ascontiguousarray(nhood, np.int32)
    E = aff.shape[0]
    Z, X, Y = seg.shape
    if aff.shape != (E, Z, X, Y) or nhood.shape != (E, 3):
        raise ValueError(f"malis_pass: aff {aff.shape}, seg {seg.shape} and "
                         f"nhood {nhood.shape} do not match")
    out = np.zeros_like(aff)
    lib.malis_pass(
        aff.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        seg.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nhood.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        E, Z, X, Y, int(bool(count_pos)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
