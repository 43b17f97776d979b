"""Host-side helpers: HDF5 save and load, a growing array buffer, a
KD-tree over a growing point set and ``as_list``.

Jax-free copy of ``as_list``, ``h5save``, ``h5load``, ``AccumulationArray``
and ``DynamicKDT`` in ``elektronn2_tpu/utils/basic.py`` (reference:
``elektronn2/utils``); the predict CLI and ``HistoryTracker`` write through
``h5save``, ``data/cnndata.py`` reads through ``h5load`` and ``as_list``,
``data/skeleton.py::Trace`` and ``data/tracing_utils.py::ShotgunRegistry``
need the other two. ``AccumulationArray.extend`` copies a block at once
instead of appending row by row; the contents are the same. ``h5py`` is
imported when a file is read or written, not with this module.
"""

from __future__ import annotations

import numpy as np


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
