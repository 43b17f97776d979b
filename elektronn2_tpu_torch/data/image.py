"""Intensity augmentation and label-space helpers.

Jax-free copy of ``elektronn2_tpu/data/image.py`` (reference:
``elektronn2/data/image.py::greyAugment, ids2barriers, smearbarriers,
center_cubes, make_affinities``).
"""

from __future__ import annotations

import numpy as np


def greyAugment(d, channels=None, rng=None):
    """Random per-channel brightness/contrast/gamma distortion.

    Reference: ``image.py::greyAugment`` — applied to raw EM patches in
    ``BatchCreatorImage.getbatch``. ``d``: (f, z, x, y) or (f, x, y) float
    array in roughly [0, 1]; ``channels``: which feature channels to
    distort (default: all).
    """
    rng = rng or np.random
    d = np.ascontiguousarray(d, dtype=np.float32)
    channels = range(d.shape[0]) if channels is None else channels
    for c in channels:
        alpha = 1.0 + rng.uniform(-0.3, 0.3)          # contrast
        beta = rng.uniform(-0.15, 0.15)               # brightness
        gamma = 2.0 ** rng.uniform(-1.0, 1.0)         # nonlinear
        x = d[c] * alpha + beta
        x = np.clip(x, 0.0, 1.0) ** gamma
        d[c] = x
    return d


def ids2barriers(ids, dilute=(0, 0, 0), connectivity=(1, 1, 1)):
    """Segmentation IDs → binary barrier (boundary) map.

    Reference: ``image.py::ids2barriers``. A voxel is a barrier if any
    neighbour within ``connectivity`` (per-axis 0/1 flags... the reference
    used small ints; here: number of voxels looked ahead per axis) has a
    different id, or if its id is 0 (background/unlabeled treated as
    boundary). ``dilute`` thickens barriers by a per-axis number of extra
    dilation steps.
    """
    ids = np.asarray(ids)
    barriers = (ids == 0)
    for ax, conn in enumerate(connectivity):
        for step in range(1, int(conn) + 1):
            a = np.swapaxes(ids, 0, ax)
            diff = a[step:] != a[:-step]
            d = np.zeros_like(barriers)
            ds = np.swapaxes(d, 0, ax)
            ds[step:] |= diff
            ds[:-step] |= diff
            barriers |= d
    out = barriers
    for ax, dil in enumerate(dilute):
        for _ in range(int(dil)):
            a = np.swapaxes(out, 0, ax).copy()
            a[1:] |= np.swapaxes(out, 0, ax)[:-1]
            a[:-1] |= np.swapaxes(out, 0, ax)[1:]
            out = np.swapaxes(a, 0, ax)
    return out.astype(np.int16)


def smearbarriers(barriers, kernel=(3, 3, 3)):
    """Soften binary barriers into a smoothed map via a box max/mean filter.

    Reference: ``image.py::smearbarriers``.
    """
    from scipy import ndimage
    b = np.asarray(barriers, dtype=np.float32)
    return ndimage.uniform_filter(b, size=kernel, mode="nearest")


def center_cubes(cube1, cube2, crop=True):
    """Align two cubes on their centres, cropping (or padding) the larger
    to match. Reference: ``image.py::center_cubes``. Operates on the last
    3 axes; returns views/copies with equal spatial shapes.
    """
    s1 = np.array(cube1.shape[-3:])
    s2 = np.array(cube2.shape[-3:])
    target = np.minimum(s1, s2) if crop else np.maximum(s1, s2)

    def fit(c, s):
        out = c
        for ax in range(3):
            full_ax = c.ndim - 3 + ax
            diff = c.shape[full_ax] - target[ax]
            if diff > 0:
                lo = diff // 2
                sl = [slice(None)] * c.ndim
                sl[full_ax] = slice(lo, lo + target[ax])
                out = out[tuple(sl)]
                c = out
            elif diff < 0:
                pad = [(0, 0)] * c.ndim
                lo = (-diff) // 2
                pad[full_ax] = (lo, -diff - lo)
                out = np.pad(c, pad)
                c = out
        return out

    return fit(np.asarray(cube1), s1), fit(np.asarray(cube2), s2)


def make_affinities(labels, nhood=None, size_thresh=1):
    """Segmentation labels -> affinity graphs + component-relabelled segs.

    Reference: ``image.py::make_affinities`` — the label encoding MALIS /
    affinity nets train on. For each label cube: build the ground-truth
    affinity graph (:func:`elektronn2_tpu_torch.malis.seg_to_affgraph`,
    nearest-neighbour ``nhood`` by default), re-derive the segmentation as
    the affinity graph's connected components (splits accidentally-touching
    same-id objects exactly like the reference), and zero out components
    smaller than ``size_thresh`` voxels in both the seg and its affinities.

    ``labels``: (z, x, y) or (n, z, x, y) int array. Returns
    ``(affinities, segs)`` with the leading n axis matching the input.
    """
    from .. import malis as _malis
    labels = np.asarray(labels)
    single = labels.ndim == 3
    if single:
        labels = labels[None]
    if nhood is None:
        nhood = _malis.mknhood3d(1)
    affs, segs = [], []
    for lab in labels:
        aff = np.asarray(_malis.seg_to_affgraph(lab, nhood), np.float32)
        seg, sizes = _malis.connected_components(aff, nhood, threshold=0.5)
        seg = seg * (lab != 0)            # background stays background
        small = np.flatnonzero(sizes < int(size_thresh)) + 1
        if small.size:
            seg[np.isin(seg, small)] = 0
            aff = np.asarray(_malis.seg_to_affgraph(seg, nhood), np.float32)
        affs.append(aff)
        segs.append(seg.astype(np.int32))
    affs, segs = np.stack(affs), np.stack(segs)
    return (affs[0], segs[0]) if single else (affs, segs)


def downsample_xy(d, l, factor=2):
    """Downsample a (raw, label) pair in x/y: mean-pool the raw, stride the
    labels. Reference: ``image.py::downsample_xy``.

    ``d``: (f, z, x, y) float raw; ``l``: (z, x, y) int labels (or None).
    Trailing rows/columns that don't fill a ``factor`` block are cropped.
    """
    f = int(factor)
    d = np.asarray(d)
    cx = (d.shape[-2] // f) * f
    cy = (d.shape[-1] // f) * f
    dc = d[..., :cx, :cy]
    d2 = dc.reshape(dc.shape[:-2] + (cx // f, f, cy // f, f)) \
           .mean(axis=(-3, -1)).astype(d.dtype)
    l2 = None
    if l is not None:
        l = np.asarray(l)
        l2 = l[..., :cx:f, :cy:f]
    return d2, l2
