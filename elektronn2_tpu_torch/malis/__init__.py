"""MALIS — maximin-affinity structured loss for segmentation.

Jax-free port of ``elektronn2_tpu/malis/__init__.py`` (reference:
``elektronn2/malis/`` — ``malis_core.cpp``, ``malis_utils.py`` and
``malisop.py::malis_weights``; Turaga et al. 2009). The pair counting over
the maximin spanning forest is sequential host work, in the JAX package as
in the reference: there a ``jax.pure_callback`` inside jit, here a copy of
the prediction to the host once a step. The counting core is the same C++
source (``malis_core.cpp``, built with g++ on first use by ``native.py``),
with the same numpy fallback when no compiler is there (``HAVE_NATIVE``).
The weighted NLL and its gradient run on the prediction's device
(:func:`malis_weighted_nll`).

Affinity-map conventions: volumes are (Z, X, Y) like everywhere else in
this package — ``aff[e, z, x, y]`` is the affinity of voxel v to voxel
``v + nhood[e]`` with ``nhood`` offsets in (z, x, y) column order (the
same order the C core and ``native.py`` document); ground-truth affinity
is 1 iff both voxels carry the same nonzero segment id. (The counting
itself is convention-agnostic: offset column d steps axis d of the
volume.)
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

try:
    from . import native as _malis_cpp
    _malis_cpp.get_lib()        # builds with g++ on first use (cached .so)
    HAVE_NATIVE = True
except (OSError, subprocess.CalledProcessError):
    _malis_cpp = None           # no compiler -> numpy fallback (ref policy)
    HAVE_NATIVE = False


def default_nhood(ndim=3):
    return mknhood3d(1) if ndim == 3 else mknhood2d(1)


def mknhood3d(radius=1):
    """Nearest-neighbour 3D edge neighbourhood.

    Reference: ``malis_utils.py::mknhood3d``. radius 1 → the 3 backward
    unit edges; offset columns are (z, x, y), matching this package's
    (Z, X, Y) volume layout.
    """
    if radius == 1:
        return np.array([[-1, 0, 0], [0, -1, 0], [0, 0, -1]], dtype=np.int32)
    ceil = int(np.ceil(radius))
    offs = []
    for dz in range(-ceil, ceil + 1):
        for dy in range(-ceil, ceil + 1):
            for dx in range(-ceil, ceil + 1):
                if (dz, dy, dx) == (0, 0, 0):
                    continue
                if dz ** 2 + dy ** 2 + dx ** 2 <= radius ** 2:
                    # keep one representative of each ± pair
                    if (dz, dy, dx) < (0, 0, 0):
                        offs.append((dz, dy, dx))
    return np.array(offs, dtype=np.int32)


def mknhood2d(radius=1):
    """Nearest-neighbour 2D edge neighbourhood; ``radius > 1`` keeps one
    representative of each ± offset pair within the disc (same policy as
    :func:`mknhood3d`). Reference: ``malis_utils.py::mknhood2d``."""
    if radius == 1:
        return np.array([[-1, 0], [0, -1]], dtype=np.int32)
    ceil = int(np.ceil(radius))
    offs = []
    for dx in range(-ceil, ceil + 1):
        for dy in range(-ceil, ceil + 1):
            if (dx, dy) == (0, 0) or (dx, dy) > (0, 0):
                continue
            if dx ** 2 + dy ** 2 <= radius ** 2:
                offs.append((dx, dy))
    return np.array(offs, dtype=np.int32)


def mknhood3d_aniso(radiusxy=1, radiusxy_zminus1=1.8):
    """Anisotropic 3D neighbourhood for thick-z EM stacks.

    Reference: ``malis_utils.py::mknhood3d_aniso`` — full-resolution
    in-plane edges (``mknhood2d(radiusxy)``), ONE direct z edge, plus
    *both signed* in-plane offsets at z−1 within ``radiusxy_zminus1``
    (diagonal inter-slice edges compensate the coarse z sampling).
    Offset columns are (z, x, y) like :func:`mknhood3d`.
    """
    xy = mknhood2d(radiusxy)
    xy_z = mknhood2d(radiusxy_zminus1)
    rows = [np.concatenate([[0], o]) for o in xy]
    rows.append(np.array([-1, 0, 0]))
    for o in xy_z:
        rows.append(np.concatenate([[-1], o]))
        rows.append(np.concatenate([[-1], -o]))
    return np.asarray(rows, dtype=np.int32)


def seg_to_affgraph(seg, nhood):
    """Ground-truth affinity graph from a segmentation.

    Reference: ``malis_utils.py::seg_to_affgraph``. ``seg`` a numpy array
    (numpy out) or a ``torch.Tensor`` (a float32 tensor out, on its device):
    aff[e, pos] = 1 iff seg[pos] == seg[pos + nhood[e]] != 0.
    """
    is_t = isinstance(seg, torch.Tensor)
    seg = seg.to(torch.int32) if is_t else np.asarray(seg).astype(np.int32)
    nsp = seg.ndim
    nhood = np.asarray(nhood, dtype=np.int32)
    affs = []
    for e in range(len(nhood)):
        a = (torch.zeros(seg.shape, dtype=torch.float32, device=seg.device)
             if is_t else np.zeros(seg.shape, np.float32))
        sl_v, sl_u = [], []
        ok = True
        for d in range(nsp):
            o = int(nhood[e, d])
            if abs(o) >= seg.shape[d]:
                ok = False
                break
            if o <= 0:
                sl_v.append(slice(-o, seg.shape[d]))
                sl_u.append(slice(0, seg.shape[d] + o))
            else:
                sl_v.append(slice(0, seg.shape[d] - o))
                sl_u.append(slice(o, seg.shape[d]))
        if ok:
            v = seg[tuple(sl_v)]
            u = seg[tuple(sl_u)]
            same = (v == u) & (v != 0)
            a[tuple(sl_v)] = same.float() if is_t else same
        affs.append(a)
    return torch.stack(affs) if is_t else np.stack(affs, axis=0)


def bmap_to_affgraph(bmap, nhood):
    """Affinity graph from a boundary map (1=boundary): voxels connected
    iff neither is boundary. Reference: ``malis_utils.py::bmap_to_affgraph``
    (unverified name)."""
    seg = (np.asarray(bmap) == 0).astype(np.int32)
    # treat all non-boundary as one segment for affinity purposes
    return seg_to_affgraph(seg, nhood)


class _UnionFind:
    __slots__ = ("parent", "rank", "counts")

    def __init__(self, n_vox, labels):
        self.parent = np.arange(n_vox, dtype=np.int64)
        self.rank = np.zeros(n_vox, dtype=np.int8)
        # per-root histogram of nonzero gt labels (unlabeled voxels join
        # components but never count as pairs — no total is needed)
        self.counts = [{int(l): 1} if l != 0 else {} for l in labels]

    def find(self, x):
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a, b):
        """Merge roots a, b; return (pos_pairs, neg_pairs) created."""
        ca, cb = self.counts[a], self.counts[b]
        pos = 0
        for l, n in (ca.items() if len(ca) <= len(cb) else cb.items()):
            other = cb if len(ca) <= len(cb) else ca
            pos += n * other.get(l, 0)
        # pairs between labeled voxels with different labels
        la = sum(ca.values())
        lb = sum(cb.values())
        neg = la * lb - pos
        if self.rank[a] < self.rank[b]:
            a, b = b, a
        self.parent[b] = a
        if self.rank[a] == self.rank[b]:
            self.rank[a] += 1
        big, small = self.counts[a], self.counts[b]
        for l, n in small.items():
            big[l] = big.get(l, 0) + n
        self.counts[b] = {}
        return pos, neg


def _malis_pass_np(aff, seg, nhood, count_pos):
    """One maximin pass: per-edge pair counts (numpy fallback).

    Edges sorted by affinity descending = Kruskal maximin forest; when an
    edge merges two components, every cross pair's maximin edge is this
    edge — add the pos (same nonzero label) or neg (different labels)
    pair count to its weight.
    """
    nhood = np.asarray(nhood, dtype=np.int32)
    sp = seg.shape
    n_vox = int(np.prod(sp))
    flat_seg = seg.reshape(-1)
    strides = np.array([int(np.prod(sp[d + 1:])) for d in range(len(sp))],
                       dtype=np.int64)

    # enumerate valid edges: (affinity, v_idx, u_idx); masks are kept for
    # the scatter below (rebuilding them doubled the O(E·n_vox) mask work)
    edge_aff, edge_v, edge_u, edge_valid = [], [], [], []
    for e in range(len(nhood)):
        grids = np.meshgrid(*[np.arange(s) for s in sp], indexing="ij")
        valid = np.ones(sp, dtype=bool)
        for d in range(len(sp)):
            o = int(nhood[e, d])
            if o < 0:
                valid &= grids[d] >= -o
            elif o > 0:
                valid &= grids[d] < sp[d] - o
        vidx = np.ravel_multi_index([g[valid] for g in grids], sp)
        uidx = vidx + (nhood[e] * strides).sum()
        edge_aff.append(aff[e][valid])
        edge_v.append(vidx)
        edge_u.append(uidx)
        edge_valid.append(valid)
    edge_aff = np.concatenate(edge_aff)
    edge_v = np.concatenate(edge_v)
    edge_u = np.concatenate(edge_u)
    order = np.argsort(-edge_aff, kind="stable")
    uf = _UnionFind(n_vox, flat_seg)
    weights = np.zeros(edge_aff.shape[0], dtype=np.float64)
    for i in order:
        ra, rb = uf.find(edge_v[i]), uf.find(edge_u[i])
        if ra == rb:
            continue
        pos, neg = uf.union(ra, rb)
        weights[i] = pos if count_pos else neg

    # scatter back into (E, *sp) layout (masks cached from enumeration)
    out = np.zeros((len(nhood),) + sp, dtype=np.float32)
    start = 0
    for e, valid in enumerate(edge_valid):
        cnt = int(valid.sum())
        out[e][valid] = weights[start:start + cnt]
        start += cnt
    return out


def malis_weights(affinity_pred, seg_gt, nhood=None, unrestrict_neg=True,
                  aff_gt=None):
    """Per-edge positive and negative MALIS pair weights (host numpy).

    Reference: ``malisop.py::malis_weights``. Positive pass runs on
    ``min(pred, gt_aff)`` (constrained — only intra-object paths); negative
    pass on raw predictions if ``unrestrict_neg`` else ``max(pred, gt_aff)``.
    ``aff_gt`` overrides the segmentation-derived ground-truth affinities
    (e.g. with masked/ignore edges).
    """
    affinity_pred = np.asarray(affinity_pred, dtype=np.float32)
    seg_gt = np.asarray(seg_gt, dtype=np.int32)
    if nhood is None:
        nhood = default_nhood(seg_gt.ndim)
    nhood = np.asarray(nhood, dtype=np.int32)
    aff_gt = (np.asarray(aff_gt, dtype=np.float32) if aff_gt is not None
              else np.asarray(seg_to_affgraph(seg_gt, nhood),
                              dtype=np.float32))
    # the C core is written for 3D volumes with (E, 3) neighbourhoods; any
    # other rank routes to the N-D numpy implementation (same results)
    if _malis_cpp is not None and seg_gt.ndim == 3 and nhood.shape[1] == 3:
        pos = _malis_cpp.malis_pass(np.minimum(affinity_pred, aff_gt),
                                    seg_gt, nhood, True)
        neg_aff = (affinity_pred if unrestrict_neg
                   else np.maximum(affinity_pred, aff_gt))
        neg = _malis_cpp.malis_pass(neg_aff, seg_gt, nhood, False)
        return pos, neg
    pos = _malis_pass_np(np.minimum(affinity_pred, aff_gt), seg_gt, nhood,
                         True)
    neg_aff = (affinity_pred if unrestrict_neg
               else np.maximum(affinity_pred, aff_gt))
    neg = _malis_pass_np(neg_aff, seg_gt, nhood, False)
    return pos, neg


def batch_weights(pred, seg_gt, nhood, unrestrict_neg=True, aff_gt=None):
    """The MALIS weights of a batch on the host: :func:`malis_weights` per
    item, each item's pair counts divided by ``max(pos.sum() + neg.sum(),
    1)`` so the loss's scale does not depend on the batch size. ``pred``
    (b, E, \\*sp) float32, ``seg_gt`` (b, \\*sp), ``aff_gt`` None or like
    ``pred``. Returns (2, b, E, \\*sp) float32: the positive weights, then
    the negative ones."""
    out = np.empty((2,) + pred.shape, np.float32)
    for b in range(pred.shape[0]):
        p, n = malis_weights(
            pred[b], seg_gt[b], nhood, unrestrict_neg,
            aff_gt=None if aff_gt is None else aff_gt[b])
        tot = max(p.sum() + n.sum(), 1.0)
        out[0, b], out[1, b] = p / tot, n / tot
    return out


def _to_host(tensors):
    """numpy copies of ``tensors``: the ones on the card are copied into
    pinned memory without blocking and waited for once."""
    out, dev = [], None
    for t in tensors:
        t = t.detach()
        if t.is_cuda:
            dev = t.device
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t = h
        out.append(t)
    if dev is not None:
        torch.cuda.current_stream(dev).synchronize()
    return [t.numpy() for t in out]


def _to_device(weights, like):
    """The host weights as a tensor on ``like``'s device (one copy)."""
    return torch.from_numpy(weights).to(like.device)


def malis_weighted_nll(pred, aff_gt, seg_gt, nhood, unrestrict_neg=True,
                       dp=None):
    """MALIS-weighted binary NLL on affinity predictions.

    ``pred``: (b, E, \\*sp) affinity probabilities; ``seg_gt``: (b, \\*sp)
    int labels; ``aff_gt``: None (derived from ``seg_gt``) or (b, E,
    \\*sp) ground-truth affinities. The pair weights are computed on the
    host from ``pred.detach()`` and the labels, copied there once a step
    (:func:`batch_weights`), and brought back to ``pred``'s device; they are
    constants for the gradient, as in the reference: autograd differentiates
    only the log terms. Returns the (b, \\*sp) loss map, summed over E.

    ``torch.maximum`` against eps splits the gradient at a tie as
    ``jnp.maximum`` does, and gives none below eps, so a saturated
    prediction (0 or 1) gets the JAX package's gradient.

    ``dp``: the data-parallel group of a step under a mesh
    (``parallel.DataGroup``): the arguments hold this rank's rows, the
    host pass runs on the global batch's rows (gathered over the group)
    and this rank keeps its rows of the weights.
    """
    nhood = np.asarray(nhood, dtype=np.int32)
    rows = [pred.detach().float(), seg_gt] \
        + ([] if aff_gt is None else [aff_gt.float()])
    if dp is not None:
        rows = [dp.gather(t, 0) for t in rows]
    host = _to_host(rows)
    w = _to_device(batch_weights(host[0], host[1], nhood, unrestrict_neg,
                                 host[2] if aff_gt is not None else None),
                   pred)
    if dp is not None:
        w = dp.rows(w, 1)
    eps = pred.new_full((), 1e-10)
    nll = -(w[0] * torch.log(torch.maximum(pred, eps))
            + w[1] * torch.log(torch.maximum(1.0 - pred, eps)))
    return torch.sum(nll, dim=1)


def affgraph_to_edgelist(aff, nhood):
    """Flatten an affinity graph to ``(node1, node2, weight)`` arrays.

    Reference: ``malis_utils.py::affgraph_to_edgelist`` (Turaga's malis
    utility surface). Only in-bounds edges are emitted (the reference
    emitted every lattice position and bounds-checked in the C core;
    the valid-edge set and weights are identical). Node ids are flat
    C-order voxel indices into ``aff.shape[1:]``.
    """
    aff = np.asarray(aff, dtype=np.float32)
    nhood = np.asarray(nhood, dtype=np.int32)
    sp = aff.shape[1:]
    strides = np.array([int(np.prod(sp[d + 1:])) for d in range(len(sp))],
                       dtype=np.int64)
    node1, node2, weight = [], [], []
    grids = np.meshgrid(*[np.arange(s) for s in sp], indexing="ij")
    for e in range(len(nhood)):
        valid = np.ones(sp, dtype=bool)
        for d in range(len(sp)):
            o = int(nhood[e, d])
            if o < 0:
                valid &= grids[d] >= -o
            elif o > 0:
                valid &= grids[d] < sp[d] - o
        vidx = np.ravel_multi_index([g[valid] for g in grids], sp)
        node1.append(vidx)
        node2.append(vidx + int((nhood[e] * strides).sum()))
        weight.append(aff[e][valid])
    return (np.concatenate(node1), np.concatenate(node2),
            np.concatenate(weight))


def connected_components(aff, nhood, threshold=0.5):
    """Segment an affinity graph: union voxels over every edge with
    affinity ≥ ``threshold``; labels are 1..K (every voxel gets a label,
    singletons included). Returns ``(seg, sizes)`` with ``sizes[k-1]`` the
    voxel count of component k.

    Reference: ``malis_utils.py::connected_components`` (the
    edgelist-based core there; this takes the (E, \\*sp) affinity layout
    directly).
    """
    aff = np.asarray(aff, dtype=np.float32)
    sp = aff.shape[1:]
    n_vox = int(np.prod(sp))
    node1, node2, weight = affgraph_to_edgelist(aff, nhood)
    parent = np.arange(n_vox, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for v, u in zip(node1[weight >= threshold], node2[weight >= threshold]):
        ra, rb = find(v), find(u)
        if ra != rb:
            parent[rb] = ra
    roots = np.array([find(i) for i in range(n_vox)])
    uniq, seg_flat = np.unique(roots, return_inverse=True)
    seg = (seg_flat + 1).astype(np.int32).reshape(sp)
    sizes = np.bincount(seg_flat, minlength=len(uniq)).astype(np.int64)
    return seg, sizes


def compute_V_rand_N2(seg_gt, seg_pred):
    """Foreground-restricted Rand F-score between two segmentations.

    Reference: ``malis_utils.py::compute_V_rand_N2`` (the SNEMI3D metric).
    Voxels with ``seg_gt == 0`` are ignored. Returns
    ``(V_rand, V_rand_split, V_rand_merge)`` where split/merge are the
    recall/precision-like components and
    ``V_rand = 2·Σp²/(Σa² + Σb²)`` is their harmonic mean.
    """
    seg_gt = np.asarray(seg_gt).reshape(-1)
    seg_pred = np.asarray(seg_pred).reshape(-1)
    mask = seg_gt != 0
    gt = seg_gt[mask]
    pr = seg_pred[mask]
    n = gt.size
    if n == 0:
        return 1.0, 1.0, 1.0
    # joint histogram p_ij over (gt, pred) label pairs, normalised
    pairs = gt.astype(np.int64) * (pr.max() + 1) + pr.astype(np.int64)
    p = np.bincount(np.unique(pairs, return_inverse=True)[1]) / n
    a = np.bincount(np.unique(gt, return_inverse=True)[1]) / n   # gt marginal
    b = np.bincount(np.unique(pr, return_inverse=True)[1]) / n   # pred marginal
    sp2 = float((p ** 2).sum())
    sa2 = float((a ** 2).sum())
    sb2 = float((b ** 2).sum())
    v_split = sp2 / sa2     # high when gt segments are not split in pred
    v_merge = sp2 / sb2     # high when pred segments do not merge gt ones
    return 2.0 * sp2 / (sa2 + sb2), v_split, v_merge
