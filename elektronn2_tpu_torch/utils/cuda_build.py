"""First-use ``nvcc`` build of the port's CUDA sources, loaded with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
first use, for Hopper only (``sm_90a``), into ``elektronn2_tpu_torch/_build/``
(git-ignored) under a name that carries a hash of the source, of every
header it includes with ``#include "..."`` (``csrc/*.cuh``, followed
recursively) and of the flags, so an edited source or header is rebuilt. As in ``elektronn2_tpu/utils/native_build.py``
the library is written to a per-process temp name and renamed into place
atomically, so concurrent first users never load a half-written file.

Unlike that helper there is no fallback: a missing ``nvcc`` or a failed
build raises, with the compiler's output in the message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass

from ..log import logger

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

#: ``-Xptxas -v`` makes ptxas report registers, shared memory and spills of
#: every kernel; the report is kept in ``CudaLibrary.build_log``.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class CudaLibrary:
    """A loaded kernel library and how it was obtained."""
    cdll: ctypes.CDLL
    path: str
    build_seconds: float     # 0.0 when an existing build was loaded
    build_log: str           # nvcc's output ('' when not built here)


_loaded: dict[str, CudaLibrary] = {}


def find_nvcc():
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the CUDA
    home PyTorch itself found. Raises ``RuntimeError`` when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(h, "bin", "nvcc")
             for h in (os.environ.get("CUDA_HOME"), CUDA_HOME) if h]
    cands.insert(1, shutil.which("nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source on "
                       "first use")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def source_key(src):
    """Hash of the source file ``src``, of the text of every header it
    includes with ``#include "..."`` (resolved beside the including file,
    followed recursively, each once) and of ``NVCC_FLAGS``: an edit to any
    of them gives a new key, so a stale library is never loaded."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    todo, seen = [os.path.abspath(src)], set()
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        h.update(text)
        todo += [os.path.join(os.path.dirname(path), inc.decode())
                 for inc in _INCLUDE.findall(text)]
    return h.hexdigest()[:16]


def load_cuda_library(name):
    """Build ``csrc/<name>.cu`` on first use and load it; cached per process."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    key = source_key(src)
    so = os.path.join(BUILD_DIR, f"lib{name}-{key}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp.{os.getpid()}"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        logger.info("building CUDA kernels: " + " ".join(cmd))
        t0 = time.perf_counter()
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
            log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed (exit {res.returncode}) "
                                   f"building {src}:\n{log}")
            os.rename(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        seconds = time.perf_counter() - t0
    lib = CudaLibrary(ctypes.CDLL(so), so, seconds, log)
    _loaded[name] = lib
    return lib
