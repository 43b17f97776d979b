"""Host-side helpers: HDF5 and pickle save and load, timing and caching
decorators, a growing array buffer, a KD-tree over a growing point set, a
ring buffer and small helpers.

Jax-free copy of ``elektronn2_tpu/utils/basic.py`` (reference:
``elektronn2/utils`` and ``utils_basic.py``); the predict CLI and
``HistoryTracker`` write through
``h5save``, ``data/cnndata.py`` reads through ``h5load`` and ``as_list``,
``data/skeleton.py::Trace`` and ``data/tracing_utils.py::ShotgunRegistry``
need the other two. ``AccumulationArray.extend`` copies a block at once
instead of appending row by row; the contents are the same. ``h5py`` is
imported when a file is read or written, not with this module.
"""

from __future__ import annotations

import functools
import pickle
import time

import numpy as np

from ..log import logger


def as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def h5save(data, path, keys=None, compress=True):
    """Save array(s) to HDF5. ``data`` may be an array, list of arrays
    (with ``keys``), or a dict. Reference: ``utils::h5save``."""
    import h5py
    kw = {"compression": "gzip"} if compress else {}
    with h5py.File(path, "w") as f:
        if isinstance(data, dict):
            for k, v in data.items():
                f.create_dataset(str(k), data=np.asarray(v), **kw)
        elif isinstance(data, (list, tuple)):
            keys = keys or [f"data{i}" for i in range(len(data))]
            for k, v in zip(keys, data):
                f.create_dataset(str(k), data=np.asarray(v), **kw)
        else:
            f.create_dataset(keys or "data", data=np.asarray(data), **kw)


def h5load(path, keys=None):
    """Load dataset(s) from HDF5; ``keys`` may be a str, list, or None
    (→ all datasets; single array if only one). Reference:
    ``utils::h5load``."""
    import h5py
    with h5py.File(path, "r") as f:
        if isinstance(keys, str):
            return f[keys][()]
        names = keys or list(f.keys())
        out = [f[k][()] for k in names]
        if keys is None and len(out) == 1:
            return out[0]
        return out


def picklesave(obj, path):
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def pickleload(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def timeit(fn):
    """Decorator logging call duration. Reference: ``utils::timeit``."""
    @functools.wraps(fn)
    def wrap(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        logger.debug(f"{fn.__name__}: {time.perf_counter() - t0:.4f}s")
        return out
    return wrap


def cache(fn):
    """Unbounded memoisation decorator. Reference: ``utils::cache``."""
    return functools.lru_cache(maxsize=None)(fn)


class AccumulationArray:
    """Growing array buffer (amortised append). Reference:
    ``utils::AccumulationArray``."""

    def __init__(self, right_shape=(), dtype=np.float32, n_init=128):
        right_shape = (right_shape,) if np.isscalar(right_shape) \
            else tuple(right_shape)
        self._buf = np.zeros((n_init,) + right_shape, dtype=dtype)
        self.length = 0

    def _reserve(self, n):
        if n > len(self._buf):
            cap = max(n, 2 * len(self._buf))
            buf = np.zeros((cap,) + self._buf.shape[1:], self._buf.dtype)
            buf[:self.length] = self._buf[:self.length]
            self._buf = buf

    def append(self, value):
        self._reserve(self.length + 1)
        self._buf[self.length] = value
        self.length += 1

    def extend(self, values):
        values = np.asarray(values, self._buf.dtype).reshape(
            (-1,) + self._buf.shape[1:])
        self._reserve(self.length + len(values))
        self._buf[self.length:self.length + len(values)] = values
        self.length += len(values)

    @property
    def data(self):
        return self._buf[:self.length]

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        return self.data[i]

    def __array__(self, dtype=None, copy=None):
        d = self.data
        return d.astype(dtype) if dtype else d


class DynamicKDT:
    """KD-tree over a growing point set. Reference: ``utils::DynamicKDT``,
    the nearest-neighbour queries of the tracing agent.

    The tree is rebuilt lazily: points appended since the last build are
    scanned by brute force at query time until ``rebuild_thresh`` of them
    accumulate, so interleaved append/query stays O(log n + thresh).
    """

    def __init__(self, points=None, k=1, rebuild_thresh=100):
        self._points = AccumulationArray(right_shape=(3,), dtype=np.float64)
        self._tree = None
        self._pending = 0
        self._thresh = int(rebuild_thresh)
        self.k = k
        if points is not None:
            self._points.extend(np.asarray(points, np.float64).reshape(-1, 3))

    def append(self, point):
        self._points.append(np.asarray(point, np.float64))
        self._pending += 1

    def extend(self, points):
        """``append`` of every row of ``points`` (n, 3), in one copy."""
        points = np.asarray(points, np.float64).reshape(-1, 3)
        self._points.extend(points)
        self._pending += len(points)

    def _ensure_tree(self):
        from scipy.spatial import cKDTree
        if self._tree is None or self._pending >= self._thresh:
            if len(self._points) == 0:
                raise ValueError("empty KD-tree")
            self._tree = cKDTree(self._points.data)
            self._pending = 0

    def get_knn(self, query, k=None):
        """(distances, points, indices) of the k nearest neighbours; ``k``
        is clamped to the number of stored points."""
        k = k or self.k
        q = np.asarray(query, np.float64)
        if q.ndim > 1 and self._pending:
            self._pending = self._thresh      # batch query: fold pending in
        self._ensure_tree()
        k_tree = min(k, int(self._tree.n))
        dist, idx = self._tree.query(q, k=k_tree)
        if self._pending and q.ndim == 1:
            # merge the not-yet-indexed tail by brute force (scalar query)
            n_tree = int(self._tree.n)
            tail = self._points.data[n_tree:]
            td = np.linalg.norm(tail - q.reshape(1, -1), axis=1)
            all_d = np.concatenate([np.atleast_1d(np.asarray(
                dist, np.float64)), td])
            all_i = np.concatenate([np.atleast_1d(np.asarray(idx)),
                                    np.arange(n_tree, len(self._points))])
            real = np.isfinite(all_d)
            all_d, all_i = all_d[real], all_i[real]
            k_eff = min(k, len(self._points), len(all_d))
            order = np.argsort(all_d)[:k_eff]
            dist, idx = all_d[order], all_i[order]
            if k == 1:
                dist, idx = dist[0], idx[0]
        return dist, self._points.data[idx], idx

    def __len__(self):
        return len(self._points)


def unique_rows(a):
    """Unique rows of a 2D array (order of first occurrence preserved).
    Reference: ``utils_basic.py::unique_rows``."""
    a = np.ascontiguousarray(a)
    if a.ndim != 2:
        raise ValueError(f"unique_rows expects a 2D array, got {a.shape}")
    view = a.view([("", a.dtype)] * a.shape[1]).reshape(-1)
    _, first = np.unique(view, return_index=True)
    return a[np.sort(first)]


def makeversiondir(path, dir_name=None):
    """Create a directory; if it already exists, create a versioned
    sibling (``...-v2``, ``-v3``, …) instead and return the path actually
    created. Reference: ``utils_basic.py::makeversiondir`` (guards the
    trainer save root against clobbering an earlier run)."""
    import os
    base = os.path.join(path, dir_name) if dir_name else path
    candidate = base
    v = 1
    while os.path.exists(candidate):
        v += 1
        candidate = f"{base}-v{v}"
    os.makedirs(candidate)
    return candidate


def import_variable_from_file(file_path, class_name):
    """Exec a Python source file and return one symbol from its namespace.
    Reference: ``utils_basic.py::import_variable_from_file`` (how the
    reference pulled ``create_model``-style callables out of standalone
    files)."""
    ns = {"__file__": str(file_path), "__name__": "__elektronn2_import__"}
    with open(file_path) as f:
        code = compile(f.read(), str(file_path), "exec")
    exec(code, ns)
    try:
        return ns[class_name]
    except KeyError:
        raise AttributeError(
            f"{file_path} defines no symbol {class_name!r}") from None


def pretty_string_ops(n):
    """Format an op count: ``1234567890 → '1.23 GOp'``. Reference:
    ``utils_basic.py::pretty_string_ops``."""
    n = float(n)
    for unit in ("", "k", "M", "G", "T", "P"):
        if abs(n) < 1000.0 or unit == "P":
            return f"{n:.2f} {unit}Op".replace(".00 ", " ")
        n /= 1000.0


def get_free_cpu_count(safety=1):
    """CPUs not currently busy (cpu_count minus 1-min load average, at
    least 1). Reference: ``utils_basic.py::get_free_cpu_count`` — sizes
    the background data-worker pool."""
    import os
    total = os.cpu_count() or 1
    try:
        load = os.getloadavg()[0]
    except OSError:
        load = 0.0
    return max(1, int(total - load - safety))


class CircularBuffer:
    """Fixed-capacity ring buffer over scalars/arrays with ``data`` /
    ``mean`` views in insertion order. Reference:
    ``utils_basic.py::CircularBuffer`` (the HistoryTracker's smoothing
    window there)."""

    def __init__(self, buffer_len):
        self.buffer_len = int(buffer_len)
        self._buf = None
        self._n = 0          # total appends
        self._i = 0          # next write slot

    def append(self, value):
        value = np.asarray(value)
        if self._buf is None:
            self._buf = np.zeros((self.buffer_len,) + value.shape,
                                 value.dtype if value.dtype.kind == "f"
                                 else np.float64)
        self._buf[self._i] = value
        self._i = (self._i + 1) % self.buffer_len
        self._n += 1

    @property
    def data(self):
        if self._buf is None:
            return np.zeros((0,))
        if self._n < self.buffer_len:
            return self._buf[:self._n].copy()
        # oldest → newest
        return np.concatenate([self._buf[self._i:], self._buf[:self._i]])

    def mean(self):
        d = self.data
        return d.mean(axis=0) if len(d) else 0.0

    def __len__(self):
        return min(self._n, self.buffer_len)
