"""First-use ``g++`` build of the port's host C++ cores.

Jax-free copy of ``build_shared`` in ``elektronn2_tpu/utils/native_build.py``:
compile a source into a shared library at first use, writing a per-process
temp name that is renamed into place atomically, so concurrent first users
(worker threads, test processes) never load a half-written file. The
callers build into ``elektronn2_tpu_torch/_build/`` (git-ignored) under a
name that carries a hash of the source (:func:`shared_path`), so an edited
source is rebuilt.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

from ..log import logger

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")


def shared_path(src):
    """Where the library of ``src`` is built: ``_build/lib<name>-<hash of
    the source>.so``."""
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{name}-{key}.so")


def build_shared(src, so, extra_flags=()):
    """Compile ``src`` into shared library ``so`` (atomic replace)."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    cmd = (["g++", "-O3", "-std=c++17", "-shared", "-fPIC"]
           + list(extra_flags) + [src, "-o", tmp])
    logger.info("building native core: " + " ".join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.rename(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
