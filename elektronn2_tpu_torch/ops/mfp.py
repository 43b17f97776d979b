"""Max-fragment-pooling (MFP) — fragment pooling + dense restitching.

Port of ``elektronn2_tpu/ops/mfp.py`` (reference:
``elektronn2/neuromancer/computations.py::fragmentpool`` and
``fragments2dense``). MFP evaluates every pooling offset and stacks the
fragments into the batch axis; after the network, the fragments are
interleaved back into a full-resolution map. This is the oracle of the
dilated dense path (``neuromancer/inference.py``).

Conventions (the same as the JAX package's):
  * batch axis layout is fragment-major: ``x.reshape(n_frag, b, f, *sp)``
  * a new pooling with offsets ``d`` (itertools.product order over spatial
    dims) concatenates d-major: new fragment index = d_idx * n_frag_in + old
  * ``mfp_offsets[k]`` is the input-space voxel shift of fragment ``k``;
    output voxel ``i`` of fragment ``k`` sits at input coordinate
    ``offset_base + mfp_offsets[k] + i * stride``.
"""

from __future__ import annotations

import itertools
from functools import reduce
from math import gcd

import numpy as np
import torch

from .conv import pooling


def mfp_offsets_product(pool_shape):
    """All pooling-offset combinations, C-order over spatial dims."""
    return list(itertools.product(*[range(int(p)) for p in pool_shape]))


def fragmentpool(x, pool_shape, offsets_in, strides_in, mode="max"):
    """Pool every offset-fragment, stacking fragments into the batch axis.

    x: (n_frag_in * b, f, *sp) tensor, with sp_i ≡ p_i - 1 (mod p_i).
    Returns (y, offsets_out): y is ((n_frag_in * prod(p)) * b, f, *k) with
    k_i = (sp_i+1)/p_i - 1; offsets_out is the updated offset table.
    """
    nsp = x.ndim - 2
    pool_shape = tuple(int(p) for p in pool_shape)
    sp = x.shape[2:]
    k = []
    for s, p in zip(sp, pool_shape):
        if (s + 1) % p != 0:
            raise ValueError(
                f"MFP pooling {pool_shape} needs spatial size ≡ p-1 (mod p); "
                f"got {tuple(sp)}")
        k.append((s + 1) // p - 1)
    offsets_in = np.asarray(offsets_in, dtype=np.int64).reshape(-1, nsp)
    strides_in = np.asarray(strides_in, dtype=np.int64)

    frags, offsets_out = [], []
    for d in mfp_offsets_product(pool_shape):
        sl = (slice(None), slice(None)) + tuple(
            slice(di, di + ki * pi) for di, ki, pi in zip(d, k, pool_shape))
        frags.append(pooling(x[sl], pool_shape, mode=mode))
        offsets_out.append(offsets_in + np.asarray(d) * strides_in)
    y = torch.cat(frags, dim=0)
    return y, np.concatenate(offsets_out, axis=0)


def _interleave_geometry(mfp_offsets):
    """Per-dim offset step ``g`` and rank table for restitching.

    Offsets per dim form an arithmetic progression with step ``g_d``
    (= product of *non*-MFP pool factors accumulated before, 1 if all pools
    were MFP). Returns (g, n_off, ranks) with ranks[k,d] = offset/g in dim d.
    """
    off = np.asarray(mfp_offsets, dtype=np.int64)
    n_frag, nsp = off.shape
    g, n_off = [], []
    for d in range(nsp):
        vals = np.unique(off[:, d])
        if len(vals) == 1:
            g.append(1)
            n_off.append(1)
        else:
            step = reduce(gcd, np.diff(vals).tolist())
            if not np.array_equal(vals, np.arange(0, step * len(vals), step)):
                raise ValueError(f"irregular MFP offsets in dim {d}: {vals}")
            g.append(int(step))
            n_off.append(len(vals))
    ranks = off // np.asarray(g)
    if n_frag != int(np.prod(n_off)):
        raise ValueError(
            f"fragment count {n_frag} != product of per-dim offsets {n_off}")
    return g, n_off, ranks


def fragments2dense(y, mfp_offsets, strides=None):
    """Interleave MFP fragments back into a dense full-resolution map.

    y: (n_frag * b, f, *k) fragment-major. Returns (b, f, *dense) with
    dense_d = k_d * n_off_d; element ``(k, i)`` lands at dense position
    ``rank_d(k) + i * n_off_d``. ``strides`` is accepted for API parity and
    unused.
    """
    off = np.asarray(mfp_offsets, dtype=np.int64)
    n_frag, nsp = off.shape
    if y.ndim - 2 != nsp:
        raise ValueError("offsets rank does not match array rank")
    if n_frag == 1:
        return y
    b = y.shape[0] // n_frag
    if y.shape[0] != n_frag * b:
        raise ValueError("batch axis not divisible by fragment count")
    _, n_off, ranks = _interleave_geometry(off)
    k = tuple(y.shape[2:])
    dense_sp = tuple(ki * ni for ki, ni in zip(k, n_off))
    # the offsets form the full product grid (checked above), so the
    # fragments reorder into a (n_off_0, …, b, f, k_0, …) lattice whose axis
    # interleave IS the stitch: dense position = k·n_off + rank per dim
    perm = np.argsort(np.ravel_multi_index(
        tuple(ranks[:, d] for d in range(nsp)), tuple(n_off)))
    yf = y.reshape((n_frag, b) + tuple(y.shape[1:]))[
        torch.as_tensor(perm, device=y.device)]
    arr = yf.reshape(tuple(n_off) + (b, y.shape[1]) + k)
    axes = (nsp, nsp + 1)
    for d in range(nsp):
        axes += (nsp + 2 + d, d)
    return arr.permute(axes).reshape((b, y.shape[1]) + dense_sp)
