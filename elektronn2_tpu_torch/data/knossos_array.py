"""KNOSSOS-backed lazy volume access.

Jax-free copy of ``elektronn2_tpu/data/knossos_array.py`` (reference:
``elektronn2/data/knossos_array.py::KnossosArray, KnossosArrayMulti``).
A KNOSSOS dataset is a directory tree of small raw
cubes (classically 128³ uint8) at
``mag{M}/x{X:04d}/y{Y:04d}/z{Z:04d}/{exp}_mag{M}_x{X:04d}_y{Y:04d}_z{Z:04d}.raw``.
This class presents it as an ndarray-like object: ``__getitem__`` assembles
arbitrary sub-volumes, loading only the needed cubes, with an LRU cube cache
and background prefetch.

As in the JAX package, prefetch uses *threads* (IO-bound reads
release the GIL) feeding a plain cache, instead of forked worker processes
with shared ctypes memory (SURVEY.md do-not-mirror list). The per-cube hot
path (pread + the (z,y,x)->(z,x,y) transpose) runs in a native C++ core
(``knossos_core.cpp``, built on first use, numpy fallback) so cache misses
in ``__getitem__`` are filled by one GIL-free multi-threaded batch call.

Axis convention: this class exposes (z, x, y) indexing to match the rest of
the framework; KNOSSOS files are laid out x-fastest (z, y, x within a cube).
"""

from __future__ import annotations

import os
import re
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..log import logger


class KnossosArray:
    """Lazily-loaded KNOSSOS dataset with cube cache + thread prefetch."""

    def __init__(self, path, max_ram=512, n_preload=2, fixed_mag=1,
                 cube_edge=128, exp_name=None, dtype=np.uint8,
                 native="auto"):
        self.path = os.path.abspath(path)
        self.mag = int(fixed_mag)
        self.cube_edge = int(cube_edge)
        self.dtype = np.dtype(dtype)
        self._exp_name = exp_name
        self._read_conf()
        cube_bytes = self.cube_edge ** 3 * self.dtype.itemsize
        self._max_cubes = max(8, int(max_ram * 2 ** 20 / cube_bytes))
        self._cache = OrderedDict()
        self._lock = threading.Lock()
        self._pool = (ThreadPoolExecutor(max_workers=n_preload)
                      if n_preload else None)
        self._pending = {}
        # native C++ cube core: "auto" = use if it builds (numpy fallback),
        # True = require, False = numpy path only. Resolved lazily so
        # importing this module never triggers a g++ build.
        if native not in ("auto", True, False):
            raise ValueError(f"native must be 'auto'/True/False: {native!r}")
        self._native_pref = native
        self._native = False if native is False else None

    def _native_ok(self):
        if self._native is None:
            from . import _knossos_native
            if not _knossos_native.supports(self.dtype):
                if self._native_pref is True:
                    raise TypeError(
                        f"native KNOSSOS core does not support dtype "
                        f"{self.dtype} (u8/u16/f32 only)")
                self._native = False
            else:
                try:
                    _knossos_native.get_lib()
                    self._native = True
                except Exception as e:
                    if self._native_pref is True:
                        raise
                    logger.warning(
                        f"native KNOSSOS core unavailable ({e}); "
                        f"using the numpy cube path")
                    self._native = False
        return self._native

    def _read_conf(self):
        """Parse knossos.conf for extents/experiment name if present."""
        self.shape = None
        conf = os.path.join(self.path, "knossos.conf")
        boundary = {}
        if os.path.exists(conf):
            txt = open(conf).read()
            for ax in "xyz":
                m = re.search(rf"boundary\s+{ax}\s+(\d+)", txt)
                if m:
                    boundary[ax] = int(m.group(1))
            m = re.search(r'experiment name\s+"([^"]+)"', txt)
            if m and self._exp_name is None:
                self._exp_name = m.group(1)
            m = re.search(r"edge length\s+(\d+)", txt)
            if m:
                self.cube_edge = int(m.group(1))
        if len(boundary) == 3:
            self.shape = (boundary["z"], boundary["x"], boundary["y"])
        else:
            # infer from directory structure of magnification 1 — only
            # x*/y*/z* DIRECTORIES count (knossos.conf itself, .DS_Store
            # and other stray files live alongside the cube tree and
            # crashed the scan; review r2 s5)
            magdir = self._magdir()

            def _leveldirs(parent, prefix):
                out = []
                for d in os.listdir(parent):
                    if d.startswith(prefix) and d[1:].isdigit() \
                            and os.path.isdir(os.path.join(parent, d)):
                        out.append(d)
                return out

            xds = _leveldirs(magdir, "x")
            if not xds:
                raise FileNotFoundError(
                    f"cannot infer dataset shape: no boundary in "
                    f"knossos.conf and no x*/ cube dirs under {magdir}")
            ymax = zmax = 0
            for xd in xds:
                for yd in _leveldirs(os.path.join(magdir, xd), "y"):
                    ymax = max(ymax, int(yd[1:]))
                    for zd in _leveldirs(os.path.join(magdir, xd, yd),
                                         "z"):
                        zmax = max(zmax, int(zd[1:]))
            self.shape = ((zmax + 1) * self.cube_edge,
                          (max(int(d[1:]) for d in xds) + 1)
                          * self.cube_edge,
                          (ymax + 1) * self.cube_edge)
        if self._exp_name is None:
            self._exp_name = os.path.basename(self.path.rstrip("/"))

    def _magdir(self):
        for cand in (os.path.join(self.path, f"mag{self.mag}"), self.path):
            if os.path.isdir(cand):
                return cand
        raise FileNotFoundError(f"no magnification dir under {self.path}")

    @property
    def ndim(self):
        return 3

    def __len__(self):
        return self.shape[0]

    # ----------------------------------------------------------- cube access
    def _cube_path(self, cx, cy, cz):
        return os.path.join(
            self._magdir(), f"x{cx:04d}", f"y{cy:04d}", f"z{cz:04d}",
            f"{self._exp_name}_mag{self.mag}_x{cx:04d}_y{cy:04d}_z{cz:04d}.raw")

    def _load_cube(self, key):
        cx, cy, cz = key
        p = self._cube_path(cx, cy, cz)
        e = self.cube_edge
        if self._native_ok():
            from . import _knossos_native
            return _knossos_native.load_cubes([p], e, self.dtype,
                                              n_threads=1)[0]
        if not os.path.exists(p):
            return np.zeros((e, e, e), self.dtype)  # missing cube → zeros
        buf = np.fromfile(p, dtype=self.dtype)
        if buf.size != e ** 3:
            raise IOError(f"cube {p} has {buf.size} voxels, expected {e**3}")
        # KNOSSOS stores x-fastest: (z, y, x) → transpose to (z, x, y)
        return np.ascontiguousarray(buf.reshape(e, e, e).transpose(0, 2, 1))

    def _get_cube(self, key):
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]
            fut = self._pending.pop(key, None)
        cube = fut.result() if fut is not None else self._load_cube(key)
        with self._lock:
            self._cache[key] = cube
            while len(self._cache) > self._max_cubes:
                self._cache.popitem(last=False)
        return cube

    def preload(self, keys):
        """Asynchronously prefetch cubes (background threads)."""
        if self._pool is None:
            return
        with self._lock:
            # fold completed-but-never-read prefetches into the LRU cache
            # first — only _get_cube pops _pending, so skipped positions
            # would otherwise accumulate there unboundedly past max_ram
            for key in [k for k, f in self._pending.items() if f.done()]:
                fut = self._pending.pop(key)
                try:
                    self._cache[key] = fut.result()
                except Exception as e:   # surface IO errors, don't swallow
                    logger.warning(f"prefetch of cube {key} failed: {e}")
            while len(self._cache) > self._max_cubes:
                self._cache.popitem(last=False)
            for key in keys:
                if key not in self._cache and key not in self._pending:
                    self._pending[key] = self._pool.submit(self._load_cube,
                                                           key)

    # ------------------------------------------------------------- slicing
    def __getitem__(self, idx):
        """Assemble a sub-volume for a (z, x, y) basic-slice tuple.
        Supports Ellipsis (warp_slice indexes ``img[..., z, x, y]``)."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        if Ellipsis in idx:
            pos = idx.index(Ellipsis)
            fill = (slice(None),) * (3 - (len(idx) - 1))
            idx = idx[:pos] + fill + idx[pos + 1:]
        idx = idx + (slice(None),) * (3 - len(idx))
        bounds = []
        for d, s in enumerate(idx):
            if isinstance(s, slice):
                lo, hi, step = s.indices(self.shape[d])
                if step != 1:
                    raise IndexError("KnossosArray supports step-1 slices")
            else:
                # normalise negative integers like ndarray (an
                # unnormalised -1 silently read the missing-cube zeros
                # fallback; review r2 s5)
                lo = int(s)
                if lo < 0:
                    lo += self.shape[d]
                if not 0 <= lo < self.shape[d]:
                    raise IndexError(
                        f"index {int(s)} out of bounds for dim {d} "
                        f"(size {self.shape[d]})")
                hi = lo + 1
            bounds.append((lo, hi))
        (z0, z1), (x0, x1), (y0, y1) = bounds
        e = self.cube_edge
        # np.empty, not zeros: every voxel is covered by exactly one cube
        # region below (missing cubes contribute explicit zeros)
        out = np.empty((z1 - z0, x1 - x0, y1 - y0), self.dtype)
        keys = [(cx, cy, cz)
                for cz in range(z0 // e, max(z0 // e + 1, -(-z1 // e)))
                for cx in range(x0 // e, max(x0 // e + 1, -(-x1 // e)))
                for cy in range(y0 // e, max(y0 // e + 1, -(-y1 // e)))]
        # fill all cache misses with ONE native batch call (parallel
        # GIL-free reads + cache-blocked transposes); cubes with an
        # in-flight prefetch future are left to _get_cube below.
        loaded = {}
        direct = frozenset()
        if self._native_ok():
            with self._lock:
                missing = [k for k in keys
                           if k not in self._cache and k not in self._pending]
            from . import _knossos_native
            if len(missing) > self._max_cubes:
                # streaming read larger than the cache could ever hold:
                # assemble straight into `out` (one read + one transposed
                # write per cube, no per-cube buffers, no cache thrash)
                _knossos_native.assemble(
                    [self._cube_path(*k) for k in missing],
                    [(k[2] * e - z0, k[0] * e - x0, k[1] * e - y0)
                     for k in missing],
                    e, out)
                direct = frozenset(missing)
            elif missing:
                cubes = _knossos_native.load_cubes(
                    [self._cube_path(*k) for k in missing], e, self.dtype)
                with self._lock:
                    for k, c in zip(missing, cubes):
                        # a racing thread may have inserted it meanwhile;
                        # first insertion wins so both scatter one object
                        loaded[k] = self._cache.setdefault(k, c)
                        self._cache.move_to_end(k)
                    while len(self._cache) > self._max_cubes:
                        self._cache.popitem(last=False)
        for (cx, cy, cz) in keys:
            if (cx, cy, cz) in direct:
                continue
            cube = loaded.get((cx, cy, cz))
            if cube is None:
                cube = self._get_cube((cx, cy, cz))
            gz0, gz1 = max(z0, cz * e), min(z1, (cz + 1) * e)
            gx0, gx1 = max(x0, cx * e), min(x1, (cx + 1) * e)
            gy0, gy1 = max(y0, cy * e), min(y1, (cy + 1) * e)
            if gz0 >= gz1 or gx0 >= gx1 or gy0 >= gy1:
                continue
            out[gz0 - z0:gz1 - z0, gx0 - x0:gx1 - x0, gy0 - y0:gy1 - y0] = \
                cube[gz0 - cz * e:gz1 - cz * e, gx0 - cx * e:gx1 - cx * e,
                     gy0 - cy * e:gy1 - cy * e]
        # squeeze integer-indexed axes
        squeeze = tuple(d for d, s in enumerate(idx)
                        if not isinstance(s, slice))
        return out.squeeze(axis=squeeze) if squeeze else out

    def __repr__(self):
        return (f"<KnossosArray {self._exp_name!r} shape={self.shape} "
                f"cube={self.cube_edge} cached={len(self._cache)}>")


def save_knossos(volume, path, exp_name="prediction", cube_edge=128,
                 mag=1):
    """Write a (z, x, y) uint8 volume as a KNOSSOS cube tree (+ conf).

    Completes the deployment loop: segmentations predicted with
    ``sweep_knossos`` go back into KNOSSOS for viewing/annotation.
    """
    volume = np.asarray(volume)
    if volume.dtype != np.uint8:
        raise ValueError("KNOSSOS raw cubes are uint8; convert first "
                         "(e.g. np.clip(p*255, 0, 255).astype(np.uint8))")
    if volume.ndim == 2:     # 2D map → single-slice volume
        volume = volume[None]
    Z, X, Y = volume.shape
    e = int(cube_edge)
    root = os.path.join(path, f"mag{mag}")
    for cz in range(-(-Z // e)):
        for cx in range(-(-X // e)):
            for cy in range(-(-Y // e)):
                cube = np.zeros((e, e, e), np.uint8)
                part = volume[cz * e:min(Z, (cz + 1) * e),
                              cx * e:min(X, (cx + 1) * e),
                              cy * e:min(Y, (cy + 1) * e)]
                cube[:part.shape[0], :part.shape[1], :part.shape[2]] = part
                d = os.path.join(root, f"x{cx:04d}", f"y{cy:04d}",
                                 f"z{cz:04d}")
                os.makedirs(d, exist_ok=True)
                cube.transpose(0, 2, 1).tofile(os.path.join(
                    d, f"{exp_name}_mag{mag}_x{cx:04d}_y{cy:04d}"
                       f"_z{cz:04d}.raw"))
    with open(os.path.join(path, "knossos.conf"), "w") as f:
        f.write(f'experiment name "{exp_name}";\nboundary x {X};\n'
                f'boundary y {Y};\nboundary z {Z};\nedge length {e};\n'
                f'magnification {mag};\n')
    logger.info(f"wrote KNOSSOS dataset {exp_name!r} ({Z}x{X}x{Y}) to {path}")
    return path


class KnossosArrayMulti:
    """Stack of KnossosArrays presented as a (f, z, x, y) volume.

    Reference: ``knossos_array.py::KnossosArrayMulti``.
    """

    def __init__(self, path_prefix, feature_paths, **kwargs):
        self.arrays = [KnossosArray(os.path.join(path_prefix or "", p),
                                    **kwargs) for p in feature_paths]
        shapes = {a.shape for a in self.arrays}
        if len(shapes) != 1:
            raise ValueError(f"inconsistent shapes: {shapes}")
        self.shape = (len(self.arrays),) + self.arrays[0].shape

    @property
    def ndim(self):
        return 4

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        if Ellipsis in idx:
            pos = idx.index(Ellipsis)
            fill = (slice(None),) * (4 - (len(idx) - 1))
            idx = idx[:pos] + fill + idx[pos + 1:]
        f_idx = idx[0] if idx else slice(None)
        rest = idx[1:]
        if isinstance(f_idx, slice):
            sel = range(*f_idx.indices(len(self.arrays)))
            return np.stack([self.arrays[i][rest] for i in sel])
        return self.arrays[int(f_idx)][rest]

    def preload(self, keys):
        for a in self.arrays:
            a.preload(keys)

    def __repr__(self):
        return f"<KnossosArrayMulti {self.shape}>"
