"""Dense inference: the dilated form of MFP, the whole-volume
convolutional path of decoder (U-Net) graphs, the overlap-tiled sweep, and
the whole-dataset KNOSSOS sweep.

Port of ``dilated_dense_forward``, ``convolutional_dense_forward``,
``check_conv_dense_supported``, ``predict_dense_device``,
``predict_dense`` and ``sweep_knossos`` in
``elektronn2_tpu/neuromancer/inference.py``.

*Dilated path* (``direct`` lowering only). MFP (fragment pooling +
restitch) computes the network at every pooling offset; the identical dense
form runs each conv dilated by the cumulative pool stride and each pool as a
stride-1 dilated max window, over the whole volume, with no fragments and no
stitching. Batch norm with running statistics is a per-channel affine there
(after the dilated pool), prelu's slope applies per channel, and dropout is
the identity. Under ``Model.set_dilated_impl(pallas_tail=True)`` every conv
that passes ``_ptail_node_ok`` (kernel (3,3,3), ReLU, no pooling, no batch
norm, no prelu) and sits at z-dilation 1 runs through the CUDA kernel
``ops.tailconv.conv3x3_dilated`` (K1).

*Convolutional path*. A valid-mode encoder/decoder graph whose UpConvs bring
the output stride back to 1 is dense by construction on a larger input:
pad the volume to the next valid size, run the graph once over it, trim.
``Model.set_convdense_impl`` picks its lowerings (zfold, d2s, poolslice,
skipsum, and K1 on the eligible (3,3,3) ReLU convs, pooled ones included).
The walk frees every value after its last consumer: at full width the
values of a wide U-Net slab add up to far more than the card holds.

*Tiled sweep*. Patch-sized tiles through the network and
``ops.mfp.fragments2dense``, stitched: the host-tiled ``predict_dense``
(the oracle of the two paths above) and the fallback of
``predict_dense_device``.

``predict_dense_device`` chooses the path from the graph's structure: a
graph of Input, Conv, Pool, BatchNorm, Dropout, Softmax and
FragmentsToDense nodes, whose batch norms all have running statistics,
takes the dilated path; otherwise a graph that passes ``check_conv_dense_supported``
takes the convolutional one, unless the volume's shape makes that path
refuse it; anything else takes the tiled fallback. All paths read and write
NCDHW, so the prediction is always (f, Z, X, Y).

``sweep_knossos`` stages slabs of a KNOSSOS dataset on a host thread,
runs them through those paths one or ``slab_batch`` at a time, and reads
each chunk back while the next one computes.

Not in this slice (``NotImplementedError``): the s2b/s2bg/ztap/zmajor/
poolslice lowerings of the dilated path, reduced precision, sharded
serving (ROADMAP.md §1 items 7 and 8).
"""

from __future__ import annotations

import itertools
import math
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..log import logger

_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}

_TILED = "predict_dense_device serves such graphs through its tiled fallback"


class ConvDenseShapeError(ValueError):
    """The convolutional dense path refuses a volume for its shape alone:
    too small for the graph, or an output that the graph's merge crops
    under-produce. Raised from the geometry, before any work.
    ``predict_dense_device`` serves such a volume through its tiled
    fallback, and only such a volume: any other error of the walk, K1's
    included, reaches the caller."""


def _check_dense_geometry(pred):
    """Nodes whose alignment TaggedShape cannot express (padding makes the
    centred-fov model lie) are rejected for dense sweeps."""
    for node in pred.all_parents():
        if type(node).__name__ == "Pad":
            raise ValueError(
                f"dense prediction over a graph containing Pad node "
                f"{node.name!r} is unsupported: padding breaks the "
                "valid-mode fov/offset bookkeeping that tile alignment "
                "relies on")


def _dense_geometry(pred_shape):
    """(g, n_off, dense_sp) for a prediction TaggedShape: per-dim dense
    stride after stitching, fragment-offset counts, and per-tile dense size."""
    from ..ops.mfp import _interleave_geometry
    nsp = len(pred_shape.spatial_axes)
    if pred_shape.n_frag > 1:
        g, n_off, _ = _interleave_geometry(pred_shape.mfp_offsets)
    else:
        g = [int(s) for s in pred_shape.strides]
        n_off = [1] * nsp
    dense_sp = [k * n for k, n in zip(pred_shape.spatial_shape, n_off)]
    return g, n_off, dense_sp


def _valid_period(pred, nsp):
    """Valid-size period per spatial dim: the largest cumulative stride in
    ``pred``'s graph. Input extents are shift-equivariantly valid in steps
    of it, so pads must keep to its multiples."""
    M = [1] * nsp
    for node in pred.all_parents():
        st = getattr(node.shape, "strides", None)
        if st is not None and len(st) == nsp:
            M = [max(m, int(s)) for m, s in zip(M, st)]
    return M


def _tile_geometry(V, tile_in, g, dense_sp, fov, nsp, L=None):
    """Overlap-tiling arithmetic of the tiled sweeps (the host-tiled
    :func:`predict_dense` and the tiled fallback of
    :func:`predict_dense_device`), copied from the JAX package's
    ``inference.py::_tile_geometry``.

    ``L`` is the tile-origin alignment period (default ``g``): decoder
    (UpConv) graphs are shift-equivariant only modulo the valid-size period
    M, so their tile origins stay on the lcm(g, M) grid
    (:func:`_origin_period`).

    Returns ``(pad_r, out_total, origins, cov)``: right-alignment padding
    per dim (so the last, clamped tile lands on the L grid), total dense
    output extents, the volume-clamped tile input origins, and ``cov``: how
    many leading output rows of each tile the stitch may use (FaithlessMerge
    graphs can over-produce rows from merge-cropped context that the
    whole-volume program does not see; those are never written)."""
    L = list(g) if L is None else L
    # output extent required from the volume as given
    R_req = [(V[d] - fov[d]) // g[d] + 1 for d in range(nsp)]
    cov = [max(1, min(dense_sp[d], (tile_in[d] - fov[d]) // g[d] + 1))
           for d in range(nsp)]
    span = []
    single = [False] * nsp   # dims served by one origin-0 tile
    for d in range(nsp):
        s = cov[d] * g[d]               # usable input extent per tile
        if s >= L[d]:
            # step on the L grid, never past the tile's own coverage
            s = (s // L[d]) * L[d]
        elif R_req[d] > cov[d]:
            # less than one phase period of outputs per tile: L-aligned
            # origins cannot cover the volume, and off-grid origins would
            # compute another pooling phase than the whole-volume program
            raise ValueError(
                f"tiled dense sweep: dim {d} produces only {cov[d]} "
                f"usable output row(s) per tile, less than the graph's "
                f"phase period {L[d]} — a decoder patch this small "
                f"cannot tile phase-consistently; use a patch whose "
                f"per-tile output covers >= {L[d]} rows (or serve the "
                f"volume whole)")
        else:
            # one origin-0 tile covers everything required in this dim
            L[d] = g[d]
            single[d] = True
        span.append(s)
    pad_r = [(L[d] - (V[d] - tile_in[d]) % L[d]) % L[d] for d in range(nsp)]
    Vp = [v + p for v, p in zip(V, pad_r)]
    # the farthest tile must reach R_req: graphs whose per-tile output is
    # smaller than the per-tile valid extent need more (L-aligned) padding
    for d in range(nsp):
        if single[d]:
            continue
        lack = (R_req[d] - cov[d]) * g[d] - (Vp[d] - tile_in[d])
        if lack > 0:
            extra = -(-lack // L[d]) * L[d]
            pad_r[d] += extra
            Vp[d] += extra
    out_total = [(Vp[d] - fov[d]) // g[d] + 1 for d in range(nsp)]
    n_tiles = [1 if single[d] or not span[d]
               else 1 + max(0, -(-(Vp[d] - tile_in[d]) // span[d]))
               for d in range(nsp)]
    origins = []
    for idx in itertools.product(*[range(n) for n in n_tiles]):
        # the clamp lands on the L grid because pad_r aligned it
        origins.append(tuple(
            (min(idx[d] * span[d], Vp[d] - tile_in[d]) // g[d]) * g[d]
            for d in range(nsp)))
    uniq = list(dict.fromkeys(origins))   # clamping can repeat the last
    return pad_r, out_total, uniq, cov


def _origin_period(pred, g, nsp):
    """Per-dim tile-origin alignment period of the tiled sweeps: ``g`` for
    pure MFP graphs (the restitch covers every pooling phase), else
    lcm(g, M) with M the valid-size period (:func:`_valid_period`), which
    decoder and hybrid graphs need to keep the whole-volume pooling
    phase."""
    from .neural import UpConv
    if pred.shape.n_frag > 1 and not any(isinstance(n, UpConv)
                                         for n in pred.all_parents()):
        return list(g)
    M = _valid_period(pred, nsp)
    return [math.lcm(int(gd), int(md)) for gd, md in zip(g, M)]


def _pad_raw_front(pred, g, fov, nsp):
    """Front and back reflect pads of the tiled ``pad_raw`` legs, and the
    front trim after the stitch: the centre offset ``(fov-1)//2``, rounded
    up to the origin period where that exceeds the output stride (decoder
    graphs are phase-sensitive); ``delta`` is the surplus trimmed off."""
    off = [(f - 1) // 2 for f in fov]
    hi = [f - 1 - o for f, o in zip(fov, off)]
    L = _origin_period(pred, g, nsp)
    lo = [-(-o // l) * l if l > gd else o
          for o, l, gd in zip(off, L, g)]
    delta = [l - o for l, o in zip(lo, off)]
    return lo, hi, delta


def dilated_pool(y, pool, dil, mode="max"):
    """Stride-1 pooling with window dilation ``dil`` over the spatial axes
    of ``y`` (b, f, *sp); VALID extent ``s - d*(p-1)`` per dim."""
    nsp = y.ndim - 2
    pool = tuple(int(p) for p in pool)
    dil = tuple(int(d) for d in dil)
    if mode == "max":
        return _MAXPOOL[nsp](y, pool, stride=1, dilation=dil)
    if mode not in ("sum", "avg", "mean"):
        raise ValueError(f"unknown pooling mode {mode!r}")
    # no dilated average pool in torch: sum the window's shifted slices
    outs = [s - d * (p - 1) for s, d, p in zip(y.shape[2:], dil, pool)]
    acc = None
    for offs in itertools.product(*(range(p) for p in pool)):
        idx = (slice(None), slice(None)) + tuple(
            slice(o * d, o * d + e) for o, d, e in zip(offs, dil, outs))
        acc = y[idx] if acc is None else acc + y[idx]
    return acc / float(np.prod(pool)) if mode in ("avg", "mean") else acc


def _dilated_unsupported(pred, state):
    """The first node of ``pred``'s graph the dilated path does not take,
    or None. A batch-normed node without running statistics in ``state``
    is not taken (its evaluation normalises by the batch's statistics,
    which the tiled path computes per tile, as the JAX package does)."""
    from . import loss as loss_mod, neural
    from .node_basic import Input
    supported = (Input, neural.Conv, neural.Pool, neural.BatchNorm,
                 neural.Dropout, loss_mod.Softmax, neural.FragmentsToDense)
    for node in pred.all_parents():
        if not isinstance(node, supported):
            return node
        if getattr(node, "_bn_nf", None) is not None \
                and node.name not in state:
            return node
    return None


def _bn_affine(params, state, node, y):
    """Evaluation-mode batch norm of the (b, f, ...) map ``y`` from the
    node's running statistics: a per-channel affine, so it commutes with
    the dilated form. Reference: ``inference.py::_bn_affine``."""
    shape = (1, -1) + (1,) * (y.ndim - 2)
    st = state[node.name]
    gamma = params[node.name]["bn_gamma"].reshape(shape)
    beta = params[node.name]["bn_beta"].reshape(shape)
    return (gamma * (y - st["mean"].reshape(shape))
            * torch.rsqrt(st["var"].reshape(shape) + 1e-5) + beta)


def dilated_dense_forward(model, vol, batch=False):
    """Dense prediction via the à-trous (dilated convolution) identity.

    Output voxel j == MFP dense output voxel j (held by the tests against
    ``predict`` + ``fragments2dense``). Supports graphs of Input, Conv, Pool,
    BatchNorm (with running statistics), Dropout, Softmax and
    FragmentsToDense nodes; others raise ``NotImplementedError`` before any
    work. ``vol``: (f, Z, X, Y) or, with ``batch=True``,
    (b, f, Z, X, Y). Call under ``torch.no_grad()`` and
    ``ops.conv.f32_convs()`` (``predict_dense_device`` does).
    """
    from . import loss as loss_mod, neural
    from .node_basic import Input
    from ..ops.conv import apply_activation, conv as ops_conv
    from ..ops.tailconv import conv3x3_dilated

    nsp = len(model.input_node.shape.spatial_axes)
    want = nsp + (2 if batch else 1)
    if vol.ndim != want:
        raise ValueError(
            f"dilated_dense_forward(batch={batch}) expects a "
            f"{want}-d volume ({'(b, f' if batch else '(f'}"
            f"{', Z' if nsp == 3 else ''}, X, Y) for this "
            f"{nsp}-d model), got shape {tuple(vol.shape)}")
    pred = model.prediction_node
    params, state = model.params, model.state
    use_ptail = model._dilated_ptail and nsp == 3
    bad = _dilated_unsupported(pred, state)
    if bad is not None:
        raise NotImplementedError(
            f"dilated dense path: node type {type(bad).__name__} is not "
            "taken; decoder graphs take convolutional_dense_forward, and "
            + _TILED)
    order = pred.all_parents()           # parents before children

    def _ptail_node_ok(node):
        """Graph-level eligibility of one Conv for the tail kernel: K1 fuses
        bias + ReLU, so batch norm (between the pool and the activation)
        and prelu's slope keep a conv on cuDNN."""
        if not isinstance(node, neural.Conv):
            return False
        w_ = params[node.name]["w"]
        return (w_.ndim == 5 and tuple(w_.shape[2:]) == (3, 3, 3)
                and all(p == 1 for p in node.pool_shape)
                and node.activation_func == "relu"
                and not node.batch_normalisation
                and "alpha" not in node.params)

    x = vol if batch else vol[None]
    values = {}    # node name -> (tensor, dilation tuple)

    def evaluate(node):
        if isinstance(node, Input):
            return x, (1,) * nsp
        xin, dil = values[node.parents[0].name]
        if isinstance(node, neural.Conv):
            w = params[node.name]["w"]
            b = params[node.name]["b"]
            if use_ptail and dil[0] == 1 and _ptail_node_ok(node):
                # bias + ReLU fused in the kernel; eligible convs never pool;
                # the input may be the caller's strided view
                return conv3x3_dilated(xin.contiguous(), w, b,
                                       dil=(1, dil[1], dil[2])), dil
            y = ops_conv(xin, w, b, dilation=dil)
            if any(p > 1 for p in node.pool_shape):
                y = dilated_pool(y, node.pool_shape, dil)
                dil = tuple(d * p for d, p in zip(dil, node.pool_shape))
            if node.batch_normalisation:
                y = _bn_affine(params, state, node, y)
            return apply_activation(y, node.activation_func,
                                    alpha=params[node.name].get("alpha")), dil
        if isinstance(node, neural.Pool):
            y = dilated_pool(xin, node.pool_shape, dil, mode=node.mode)
            return y, tuple(d * p for d, p in zip(dil, node.pool_shape))
        if isinstance(node, loss_mod.Softmax):
            return loss_mod.grouped_softmax(xin, node.n_indep, 1), dil
        if isinstance(node, neural.BatchNorm):
            return _bn_affine(params, state, node, xin), dil
        return xin, dil      # FragmentsToDense: already dense; Dropout

    # drop each value after its last consumer: eager PyTorch keeps every
    # live intermediate in device memory (several GB each at 120x496x496)
    uses = {n.name: 0 for n in order}
    for n in order:
        for p in n.parents:
            uses[p.name] += 1
    for node in order:
        values[node.name] = evaluate(node)
        for p in node.parents:
            uses[p.name] -= 1
            if uses[p.name] == 0:
                del values[p.name]
    y, _ = values.pop(pred.name)
    return y if batch else y[0]


# ----------------------------------------------------- convolutional path

# node types whose _compute takes any input size (reference:
# ``inference.py::_CONV_DENSE_OK``), split into the ported ones and those
# whose port is still to come, with the ROADMAP.md item that brings them
_CONV_DENSE_OK = {"Input", "Conv", "UpConv", "Crop", "Pool", "Concat",
                  "FaithlessMerge", "Softmax", "BatchNorm", "Dropout"}
_CONV_DENSE_NOT_PORTED = {
    "MultMerge": "§1 item 7", "ApplyFunc": "§1 item 7",
    "LRN": "§1 item 7", "FromTensor": "§1 item 7"}


def _conv_dense_rejection(pred):
    """Why ``pred``'s graph cannot take the convolutional dense path, as a
    string, or None when it can. A node type that path takes in the JAX
    package but that is not ported raises ``NotImplementedError``."""
    has_upconv = False
    for node in pred.all_parents():
        tname = type(node).__name__
        if tname in _CONV_DENSE_NOT_PORTED:
            raise NotImplementedError(
                f"convolutional dense path: node type {tname} is not ported "
                f"yet (ROADMAP.md {_CONV_DENSE_NOT_PORTED[tname]})")
        if tname not in _CONV_DENSE_OK:
            return f"unsupported node type {tname}"
        if getattr(node, "mfp", False):
            return "MFP nodes belong to the dilated path"
        has_upconv = has_upconv or tname == "UpConv"
    if not has_upconv:
        return "no UpConv in graph: use the dilated path"
    if pred.shape.n_frag > 1 or any(int(s) != 1 for s in pred.shape.strides):
        return "it requires output stride 1"
    return None


def check_conv_dense_supported(pred):
    """Raise ``ValueError`` unless ``pred``'s graph qualifies for the
    whole-volume convolutional dense path: input-size-polymorphic nodes
    only, no MFP fragments, and output stride 1 (a full decoder)."""
    reason = _conv_dense_rejection(pred)
    if reason is not None:
        raise ValueError(f"convolutional dense path: {reason}")


def conv_dense_shapes(pred, sp):
    """``{node name: spatial shape}`` of every node of ``pred``'s graph
    (conv-dense node types) when it runs on an input of spatial shape
    ``sp``, from the shapes alone."""
    shapes = {}
    for node in pred.all_parents():
        tname = type(node).__name__
        if tname == "Input":
            s = [int(v) for v in sp]
        else:
            s = shapes[node.parents[0].name]
            if tname == "Conv":
                s = [(v - f + 1) // p for v, f, p in
                     zip(s, node.filter_shape, node.pool_shape)]
            elif tname == "Pool":
                s = [v // p for v, p in zip(s, node.pool_shape)]
            elif tname == "UpConv":
                s = [v * p for v, p in zip(s, node.pool_shape)]
            elif tname == "Crop":
                s = [v - lo - hi for v, (lo, hi) in zip(s, node.crop)]
            elif tname == "FaithlessMerge":
                s = [min(a, b) for a, b in
                     zip(s, shapes[node.parents[1].name])]
        if min(s) < 1:
            raise ConvDenseShapeError(
                f"volume {tuple(sp)} is too small for the graph: node "
                f"{node.name!r} would be {s}")
        shapes[node.name] = s
    return shapes


def conv_dense_extent(model, V, pad_raw=False):
    """The spatial extent the convolutional dense path runs the graph on
    for a volume of spatial shape ``V``: the ``pad_raw`` reflect pad, then
    the pad to the next valid size. Returns (extent, ``pad_raw`` front pads
    and centre offsets or None, the output extent before trimming is
    checked)."""
    pred = model.prediction_node
    nsp = len(V)
    fov = [int(f) for f in pred.shape.fov]
    M = _valid_period(pred, nsp)
    front = None
    if pad_raw:
        off = [(f - 1) // 2 for f in fov]
        lo = [-(-o // m) * m for o, m in zip(off, M)]
        hi = [f - 1 - o for f, o in zip(fov, off)]
        if any(a + b > v - 1 for a, b, v in zip(lo, hi, V)):
            raise ConvDenseShapeError(
                f"volume {V} too small for pad_raw reflect pad")
        front = (lo, hi, off)
        V = [v + a + b for v, a, b in zip(V, lo, hi)]
    patch0 = [int(s) for s in model.input_node.shape.spatial_shape]
    out0 = [int(s) for s in pred.shape.spatial_shape]
    want_out = [v - f + 1 for v, f in zip(V, fov)]
    if any(w < 1 for w in want_out):
        raise ConvDenseShapeError(
            f"volume {V} smaller than model fov {fov}")
    # FaithlessMerge under-reports fov, so out0 may be less than
    # patch0 - fov + 1: pad the deficit too
    delta = [max(0, (p - f + 1) - o) for p, f, o in zip(patch0, fov, out0)]
    N = [p + max(0, -(-(v + d - p) // m)) * m
         for p, v, d, m in zip(patch0, V, delta, M)]
    if any(n - v > v - 1 for n, v in zip(N, V)):
        raise ConvDenseShapeError(
            f"volume {V} too small to pad to valid size {N}")
    return N, front, want_out


def _walk_freeing(ctx, pred):
    """Evaluate ``pred`` in graph order, freeing each value after its last
    consumer. A FaithlessMerge whose every consumer fuses it (``skipsum``)
    is never built: its consumers read its parents instead."""
    from .neural import Conv
    order = pred.all_parents()

    def fuses(node):
        return isinstance(node, Conv) and node._fuses_merge(ctx)

    def consumed(node):
        """The nodes whose values ``node`` reads."""
        return node.parents[0].parents if fuses(node) else node.parents

    uses = {n.name: 0 for n in order}
    for n in order:
        for p in consumed(n):
            uses[p.name] += 1
    for node in order:
        if uses[node.name] == 0 and node is not pred:
            continue                     # a merge that every consumer fuses
        ctx.get(node)
        for p in consumed(node):
            uses[p.name] -= 1
            if uses[p.name] == 0:
                del ctx.values[p.name]
    return ctx.values.pop(pred.name)


def convolutional_dense_forward(model, vol, pad_raw=False, batch=False):
    """Dense prediction of a decoder (U-Net) graph by running it once over
    the whole volume.

    Reference: ``inference.py::convolutional_dense_forward``. The volume is
    reflect-padded to the next valid size ``patch + k*M`` (M: the largest
    stride in the graph, so the crops at the skip merges stay aligned), the
    graph runs once, and the output is trimmed to the ``V - fov + 1``
    convention of the other dense paths; with ``pad_raw`` the front is
    padded by the fov's centre offset rounded up to a multiple of M and the
    output has the volume's own spatial shape.

    ``vol``: (f, *spatial), or (B, f, *spatial) with ``batch=True``
    (returns (B, f_out, *out)). A volume too small for the graph, or one
    whose output the graph's merge crops under-produce (they lose more
    voxels the larger the input), raises :class:`ConvDenseShapeError`
    before any work.
    """
    from .node_basic import TraceCtx
    from ..ops.conv import f32_convs

    inp, pred = model.input_node, model.prediction_node
    nsp = len(inp.shape.spatial_axes)
    if batch and vol.ndim != nsp + 2:
        raise ValueError(
            f"batch=True expects a (B, f, *spatial) volume of rank "
            f"{nsp + 2} for this {nsp}-D graph; got rank {vol.ndim}")
    if not batch and vol.ndim != nsp + 1:
        raise ValueError(
            f"expected a (f, *spatial) volume of rank {nsp + 1} for this "
            f"{nsp}-D graph (batch=True for a slab batch); got rank "
            f"{vol.ndim}")
    x = vol if batch else vol[None]
    V = [int(s) for s in x.shape[2:]]
    N, front, want_out = conv_dense_extent(model, V, pad_raw)
    if front is not None:
        lo, hi, off = front
        pads = [p for a, b in zip(reversed(lo), reversed(hi)) for p in (a, b)]
        y = convolutional_dense_forward(
            model, F.pad(x, pads, mode="reflect"), batch=True)
        y = y[(slice(None), slice(None)) + tuple(
            slice(a - o, a - o + v) for a, o, v in zip(lo, off, V))]
        y = y.contiguous()
        return y if batch else y[0]
    pad = [n - v for n, v in zip(N, V)]
    if any(pad):
        x = F.pad(x, [q for p in reversed(pad) for q in (0, p)],
                  mode="reflect")
    got = conv_dense_shapes(pred, N)[pred.name]
    if any(g < w for g, w in zip(got, want_out)):
        raise ConvDenseShapeError(
            f"convolutional dense path under-produces {tuple(got)} vs the "
            f"required {want_out}: this graph's merge-crop deficit grows "
            f"with the input size (predict_dense_device serves it through "
            f"the tiled fallback)")
    ctx = TraceCtx(model.params, {inp.name: x})
    ctx.convdense_upconv_d2s = model._convdense_upconv == "d2s"
    ctx.convdense_zfold = model._convdense_zfold
    ctx.convdense_poolslice = model._convdense_poolslice
    ctx.convdense_skipsum = model._convdense_skipsum
    ctx.convdense_ptail = model._convdense_ptail
    with torch.no_grad(), f32_convs():
        y = _walk_freeing(ctx, pred)
    y = y[(slice(None), slice(None)) + tuple(slice(0, w)
                                             for w in want_out)].contiguous()
    return y if batch else y[0]


def predict_dense_device(model, vol, pad_raw=False, tile_batch=1):
    """Dense sweep of a volume on the model's device: (f, Z, X, Y) float32
    tensor in, dense map (f_out, *out_spatial) out.

    ``pad_raw`` reflect-pads the volume by the fov first, so the output has
    the volume's own spatial shape. Without it a volume smaller than the fov
    raises. The path is chosen from the graph (module docstring); a graph
    neither whole-volume path takes, or a volume the convolutional path
    refuses for its shape (:class:`ConvDenseShapeError`), takes the
    overlap-tiled fallback (:func:`_tiled_sweep`, ``tile_batch`` tiles per
    forward). Any other error, a kernel's included, reaches the caller.
    """
    from ..ops.conv import f32_convs

    inp, pred = model.input_node, model.prediction_node
    _check_dense_geometry(pred)
    _dense_geometry(pred.shape)          # rejects irregular MFP offsets
    nsp = len(inp.shape.spatial_axes)
    fov = list(pred.shape.fov)
    if not isinstance(vol, torch.Tensor):
        raise TypeError(f"predict_dense_device takes a torch.Tensor, got "
                        f"{type(vol).__name__}")
    if vol.dtype != torch.float32:
        raise TypeError(f"predict_dense_device: volume must be float32, "
                        f"got {vol.dtype}")
    if vol.ndim != nsp + 1:
        raise ValueError(f"predict_dense_device: expected a {nsp + 1}-d "
                         f"(f, *spatial) volume, got shape {tuple(vol.shape)}")
    model._check_device(vol, "volume")

    # a volume smaller than the fov would flow through the valid-mode
    # convs into a silent 0-size output — reject it up front
    if not pad_raw and any(int(vol.shape[1 + d]) < fov[d]
                           for d in range(nsp)):
        raise ValueError(
            f"volume spatial shape {tuple(vol.shape[1:])} smaller than "
            f"the model fov {tuple(fov)}; pad_raw=True may help")

    if _dilated_unsupported(pred, model.state) is not None:
        if _conv_dense_rejection(pred) is None:
            try:
                return convolutional_dense_forward(model, vol,
                                                   pad_raw=pad_raw)
            except ConvDenseShapeError:
                pass    # refused for the volume's shape: the tiled fallback
        return _tiled_sweep(model, vol, pad_raw, tile_batch)

    with torch.no_grad(), f32_convs():
        if pad_raw:
            # F.pad lists (lo, hi) pairs from the LAST axis backwards
            pads = []
            for f in reversed(fov):
                pads += [(f - 1) // 2, f - 1 - (f - 1) // 2]
            vol = F.pad(vol[None], pads, mode="reflect")[0]
        return dilated_dense_forward(model, vol)


def _tiled_sweep(model, vol, pad_raw, tile_batch, verbose=False):
    """Overlap-tiled dense sweep: patch-sized tiles through
    ``Model._apply`` and ``ops.mfp.fragments2dense``, stitched.

    Port of the host sweep of ``inference.py::predict_dense`` and of the
    tiled fallback of ``predict_dense_device`` in the JAX package, which
    share this arithmetic. ``vol`` is a (f, *spatial) float32 numpy array
    (host tiling: each group of ``tile_batch`` tiles goes to the model's
    device and its dense output comes back; returns numpy) or a tensor on
    the model's device (everything stays there; returns a tensor). A
    residual (non-MFP) output stride g is upsampled by repetition, as the
    JAX package does.
    """
    from ..ops.mfp import fragments2dense
    inp, pred = model.input_node, model.prediction_node
    host = isinstance(vol, np.ndarray)
    nsp = len(inp.shape.spatial_axes)
    tile_in = list(inp.shape.spatial_shape)
    g, _, dense_sp = _dense_geometry(pred.shape)
    fov = list(pred.shape.fov)
    f_out = pred.shape["f"]

    def pad(a, lo, hi):
        if host:
            return np.pad(a, [(0, 0)] + list(zip(lo, hi)), mode="reflect")
        p = [q for a_, b_ in zip(reversed(lo), reversed(hi))
             for q in (a_, b_)]
        return F.pad(a[None], p, mode="reflect")[0]

    V_orig = list(vol.shape[1:])
    delta_lo = [0] * nsp
    if pad_raw:
        lo, hi, delta_lo = _pad_raw_front(pred, g, fov, nsp)
        vol = pad(vol, lo, hi)
    V = list(vol.shape[1:])
    for d in range(nsp):
        if V[d] < tile_in[d]:
            raise ValueError(
                f"volume dim {d} ({V[d]}) smaller than model patch "
                f"{tile_in[d]}; pad_raw=True may help")
    pad_r, out_total, origins, cov = _tile_geometry(
        V, tile_in, g, dense_sp, fov, nsp, L=_origin_period(pred, g, nsp))
    if any(pad_r):
        vol = pad(vol, [0] * nsp, pad_r)
    out = (np.empty([f_out] + out_total, np.float32) if host else
           torch.empty([f_out] + out_total, dtype=torch.float32,
                       device=vol.device))
    dev = model.device
    tb = max(1, int(tile_batch))
    for start in range(0, len(origins), tb):
        group = origins[start:start + tb]
        # a short last group repeats its last tile: one batch shape
        group_in = group + [group[-1]] * (tb - len(group))
        tiles = [vol[(slice(None),) + tuple(slice(o[d], o[d] + tile_in[d])
                                            for d in range(nsp))]
                 for o in group_in]
        tiles = (torch.from_numpy(np.stack(tiles)).to(dev) if host
                 else torch.stack(tiles))
        y = model._apply([pred], model.params, model.state,
                         {inp.name: tiles}, None, train=False)[0][0]
        dense = fragments2dense(y, pred.shape.mfp_offsets)
        if host:
            dense = dense.cpu().numpy()
        for bi, o in enumerate(group):
            o_out = [o[d] // g[d] for d in range(nsp)]
            sl_out, sl_src = [slice(None)], [slice(None)]
            for d in range(nsp):
                # only cov rows per tile: over-produced rows never land
                n = min(cov[d], out_total[d] - o_out[d])
                sl_out.append(slice(o_out[d], o_out[d] + n))
                sl_src.append(slice(0, n))
            out[tuple(sl_out)] = dense[bi][tuple(sl_src)]
        if verbose:
            logger.info(f"predict_dense: {min(start + tb, len(origins))}/"
                        f"{len(origins)} tiles")
    for d in range(nsp):
        if g[d] > 1:   # residual stride: repeat-upsample to full resolution
            out = (np.repeat(out, g[d], axis=1 + d) if host
                   else torch.repeat_interleave(out, g[d], dim=1 + d))
    # crop the alignment padding back off; delta_lo trims the phase
    # rounding of the pad_raw front pad
    keep = [V_orig[d] if pad_raw else V_orig[d] - fov[d] + 1
            for d in range(nsp)]
    return out[(slice(None),) + tuple(slice(dl, dl + k)
                                      for dl, k in zip(delta_lo, keep))]


def predict_dense(model, raw_img, pad_raw=False, as_uint8=False,
                  tile_batch=1, verbose=False, prefer_device=True,
                  device_budget=4 << 30):
    """Dense prediction over a volume given on the host; returns numpy.

    Port of ``inference.py::predict_dense``. ``raw_img`` is (f, *spatial)
    or (*spatial,) numpy; uint8 is normalised to [0, 1] (``/ 255``);
    ``pad_raw`` mirror-pads so the output covers the whole volume;
    ``as_uint8`` rescales the probabilities to uint8 (clipped, truncated).
    With ``prefer_device`` a volume whose estimated footprint (voxels x
    widest feature map x 4 bytes x 2) fits ``device_budget`` bytes goes
    whole to :func:`predict_dense_device` on the model's device; otherwise
    (and with ``prefer_device=False``, the oracle the fused paths are held
    against) ``tile_batch`` patch-sized tiles at a time go through the
    network and are stitched on the host (:func:`_tiled_sweep`).
    """
    inp, pred = model.input_node, model.prediction_node
    if pred is None:
        raise RuntimeError("designate a prediction_node first")
    _check_dense_geometry(pred)
    in_ts = inp.shape
    nsp = len(in_ts.spatial_axes)
    n_ch = in_ts["f"]

    # rank/channel validation + normalisation happens BEFORE any routing
    raw = np.asarray(raw_img)
    if raw.ndim == nsp:
        raw = raw[None]
    if raw.ndim != nsp + 1:
        raise ValueError(f"raw has rank {raw.ndim}, expected {nsp} or "
                         f"{nsp + 1} (f, *spatial)")
    if raw.shape[0] != n_ch:
        raise ValueError(f"raw channels {raw.shape[0]} != model input "
                         f"channels {n_ch}")
    if raw.dtype == np.uint8:
        raw = raw.astype(np.float32) / 255.0
    else:
        raw = raw.astype(np.float32, copy=False)

    out = None
    if prefer_device:
        max_f = max([int(n.shape["f"]) for n in pred.all_parents()
                     if n.shape is not None and "f" in n.shape.tags] + [1])
        if int(np.prod(raw.shape[1:])) * max_f * 4 * 2 <= device_budget:
            out = predict_dense_device(
                model, torch.from_numpy(raw).to(model.device),
                pad_raw=pad_raw, tile_batch=tile_batch).cpu().numpy()
    if out is None:
        out = _tiled_sweep(model, raw, pad_raw, tile_batch, verbose=verbose)
    if as_uint8:
        out = np.clip(out * 255.0, 0, 255).astype(np.uint8)
    return out


# ------------------------------------------------------ whole-dataset sweep

#: sweeps that fell back to per-slab forwards after a batched chunk ran out
#: of device memory, in this process
sweep_oom_fallbacks = 0

#: chunks whose write-back into ``out`` may still be running while the next
#: chunk is enqueued
WRITE_DEPTH = 2

#: uint8 -> float32 normalisation table: entry v is ``np.float32(v) / 255.0``
#: as numpy computes it, so a staged slab cast by lookup on the device has
#: the bits of the JAX package's host cast
_U8_SCALE = np.arange(256, dtype=np.float32) / 255.0


def _sweep_forward(model, batched):
    """The forward of one chunk of staged slabs, (B, f, *slab) float32 ->
    (B, f_out, *out), or None when ``batched`` and neither whole-volume
    path takes the graph. Per slab (``batched=False``) it is
    :func:`predict_dense_device`, which serves every graph."""
    from ..ops.conv import f32_convs
    pred = model.prediction_node
    if not batched:
        return lambda x: predict_dense_device(model, x[0])[None]
    if _dilated_unsupported(pred, model.state) is None:
        def dilated(x):
            with torch.no_grad(), f32_convs():
                return dilated_dense_forward(model, x, batch=True)
        return dilated
    if _conv_dense_rejection(pred) is None:
        return lambda x: convolutional_dense_forward(model, x, batch=True)
    return None


def sweep_knossos(model, karr, region=None, step=None, out=None,
                  verbose=False, mesh=None, slab_batch=1, timings=None):
    """Dense-predict a whole KNOSSOS dataset (or a region of it), slab by
    staged slab, on the model's device.

    Port of ``inference.py::sweep_knossos``. ``karr`` is a ``KnossosArray``
    (or ``KnossosArrayMulti``, or any (z, x, y) / (f, z, x, y) array).
    Slabs of ``step`` voxels (default: (112, 496, 496) under
    ``set_dilated_impl(pallas_tail=True)``, (128, 448, 448) for a
    conv-dense graph under ``set_convdense_impl(ptail=True)``, else
    (64, 384, 384)), rounded up to the valid-size period M, start on the
    M-grid; each is read with an M-aligned front halo and the fov's back
    halo, reflect-padded where it passes the dataset's edge, and written
    into ``out`` (a (f_out, *region_shape) float32 array, allocated if
    None; a memory-mapped array works) after the ``delta`` trim.

    The pipeline on the card: one staging thread reads and pads the next
    chunk into pinned host memory while the card works; the chunk goes to
    the card as it is stored (uint8 is cast there by a table lookup with
    numpy's bits, other integers are cast to float32 on the host); each
    chunk's trimmed result is read back through a non-blocking copy into
    pinned memory on a side stream with an event, and one writer thread
    waits on that event and writes the slabs into ``out`` while the next
    chunks compute (up to :data:`WRITE_DEPTH` behind). No host sync
    otherwise. Under ``torch.profiler`` the main thread's part shows as
    the span ``sweep_knossos.enqueue``; the worker threads' parts are
    timed by ``timings`` (the profiler's trace holds no span of theirs).

    ``slab_batch`` > 1 runs that many slabs per forward through
    ``dilated_dense_forward(batch=True)`` (``convolutional_dense_forward``
    for decoder graphs); the last partial chunk repeats its final slab. A
    batched chunk that runs out of device memory makes the sweep start over
    per slab, with a warning, counted in :data:`sweep_oom_fallbacks`. A
    graph neither batched path takes is swept per slab.

    ``timings``, when a dict, gets per chunk the host seconds of staging
    (``stage_s``, on the staging thread) and of writing into ``out``
    (``write_s``), and the chunk's slab count (``slabs``). ``mesh`` (slabs
    sharded over devices) is not ported.
    """
    global sweep_oom_fallbacks
    if mesh is not None:
        raise NotImplementedError(
            "sweep_knossos(mesh=...): sharded serving is not ported "
            "(ROADMAP.md §1 item 8)")
    pred = model.prediction_node
    if region is None:
        region = tuple((0, s) for s in karr.shape[-3:])
    region = [(int(a), int(b)) for a, b in region]
    rshape = [b - a for a, b in region]
    fov = list(pred.shape.fov)
    f_out = pred.shape["f"]
    # decoder graphs are shift-equivariant only modulo M: slab origins and
    # the front halo stay on the M grid, write-back trims the surplus
    M = _valid_period(pred, 3)
    if step is None:
        if model._convdense_ptail and _conv_dense_rejection(pred) is None:
            # not the JAX package's (128, 512, 512): there the wide
            # U-Net's 64-channel maps pass 2^31 elements and cuDNN's
            # transposed conv leaves its int32 kernels, 4.5x slower a
            # voxel on the H100 (PERF.md section 5)
            default = (128, 448, 448)
        elif model._dilated_ptail:
            default = (112, 496, 496)
        else:
            default = (64, 384, 384)
        step = [min(r, s) for r, s in zip(rshape, default)]
    if any(int(s) % m for s, m in zip(step, M)):
        step = [min(r, -(-int(s) // m) * m)
                for s, m, r in zip(step, M, rshape)]
        logger.info(f"sweep_knossos: step rounded to the valid-size "
                    f"period {M} -> {step} (slab phase consistency)")
    step = [int(s) for s in step]
    if out is None:
        out = np.zeros([f_out] + rshape, np.float32)

    halo_lo = [-(-((f - 1) // 2) // m) * m for f, m in zip(fov, M)]
    delta = [h - (f - 1) // 2 for h, f in zip(halo_lo, fov)]
    halo_hi = [f - 1 - (f - 1) // 2 for f in fov]
    want = [step[d] + halo_lo[d] + halo_hi[d] for d in range(3)]
    origins = [(z0, x0, y0)
               for z0 in range(0, rshape[0], step[0])
               for x0 in range(0, rshape[1], step[1])
               for y0 in range(0, rshape[2], step[2])]
    if not origins:     # degenerate region (a zero-size dimension)
        return out
    dev = model.device
    cuda = dev.type == "cuda"
    lut = torch.from_numpy(_U8_SCALE)
    side = None
    if cuda:    # copied from pinned memory: no host sync
        lut = lut.pin_memory().to(dev, non_blocking=True)
        side = torch.cuda.Stream(dev)
    if timings is not None:
        for k in ("stage_s", "write_s", "slabs"):
            timings.setdefault(k, [])

    def read(o):
        """Slab + halo from the backing store, clamped to the dataset and
        reflect-padded where the halo passes its edge; uint8 stays uint8,
        other dtypes become float32."""
        lo_cut = [max(0, -(region[d][0] + o[d] - halo_lo[d]))
                  for d in range(3)]
        sub = tuple(slice(max(0, region[d][0] + o[d] - halo_lo[d]),
                          min(region[d][0] + o[d] + step[d] + halo_hi[d],
                              karr.shape[-3:][d])) for d in range(3))
        slab = np.asarray(karr[sub] if karr.ndim == 3
                          else karr[(slice(None),) + sub])
        if slab.ndim == 3:
            slab = slab[None]
        if slab.dtype != np.uint8:
            slab = slab.astype(np.float32, copy=False)
        pads = [(0, 0)] + [
            (lo_cut[d], max(0, want[d] - slab.shape[1 + d] - lo_cut[d]))
            for d in range(3)]
        if any(p != (0, 0) for p in pads):
            slab = np.pad(slab, pads, mode="reflect")
        return slab

    def stage(chunk, B):
        """The chunk's slabs stacked into one (pinned, on the card) host
        tensor; a short chunk repeats its final slab."""
        t0 = time.perf_counter()
        slabs = [read(o) for o in chunk]
        slabs += [slabs[-1]] * (B - len(slabs))
        buf = torch.empty((B,) + slabs[0].shape, pin_memory=cuda,
                          dtype=torch.uint8 if slabs[0].dtype == np.uint8
                          else torch.float32)
        np.stack(slabs, out=buf.numpy())
        if timings is not None:
            timings["stage_s"].append(time.perf_counter() - t0)
        return buf

    def readback(dense, chunk):
        """Enqueue the copy of the chunk's trimmed output to the host;
        returns what :func:`write_back` needs."""
        dense = dense[(slice(None), slice(None)) + tuple(
            slice(dl, dl + s) for dl, s in zip(delta, step))].contiguous()
        if not cuda:
            return dense.numpy(), None, chunk
        host = torch.empty(dense.shape, dtype=dense.dtype, pin_memory=True)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            host.copy_(dense, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        dense.record_stream(side)       # its memory waits for the copy
        return host.numpy(), done, chunk

    def write_back(pending):
        arr, done, chunk = pending
        if done is not None:
            done.synchronize()
        t0 = time.perf_counter()
        for j, o in enumerate(chunk):
            n = [min(step[d], rshape[d] - o[d]) for d in range(3)]
            out[:, o[0]:o[0] + n[0], o[1]:o[1] + n[1],
                o[2]:o[2] + n[2]] = arr[j, :, :n[0], :n[1], :n[2]]
        if timings is not None:
            timings["write_s"].append(time.perf_counter() - t0)
            timings["slabs"].append(len(chunk))
        if verbose:
            logger.info(f"sweep_knossos: slab {chunk[-1]} done "
                        f"({len(chunk)} in the chunk)")

    def run(B, forward):
        chunks = [origins[i:i + B] for i in range(0, len(origins), B)]
        writes = []      # write-backs in flight, oldest first
        with ThreadPoolExecutor(max_workers=1) as stager, \
                ThreadPoolExecutor(max_workers=1) as writer:
            fut = stager.submit(stage, chunks[0], B)
            for ci, chunk in enumerate(chunks):
                buf = fut.result()
                if ci + 1 < len(chunks):
                    fut = stager.submit(stage, chunks[ci + 1], B)
                with record_function("sweep_knossos.enqueue"):
                    x = buf.to(dev, non_blocking=True)
                    x = lut[x.int()] if x.dtype == torch.uint8 else x
                    pending = readback(forward(x), chunk)
                    del x
                # the card may run WRITE_DEPTH chunks ahead of the writer: a
                # write-back that first touches the pages of ``out`` takes
                # longer than a slab computes
                if len(writes) >= WRITE_DEPTH:
                    writes.pop(0).result()
                writes.append(writer.submit(write_back, pending))
            for w in writes:
                w.result()

    forward = _sweep_forward(model, slab_batch > 1)
    if slab_batch > 1 and forward is None:
        logger.warning("sweep_knossos: neither batched path takes this "
                       "graph — sweeping per slab")
    if slab_batch > 1 and forward is not None:
        try:
            run(int(slab_batch), forward)
            return out
        except torch.cuda.OutOfMemoryError:
            # slab_batch multiplies activation memory; writes are
            # idempotent, so sweep everything again per slab
            sweep_oom_fallbacks += 1
            torch.cuda.empty_cache()
            logger.warning(
                f"sweep_knossos: slab_batch={slab_batch} exhausted device "
                f"memory — falling back to per-slab sweeps (use a smaller "
                f"step= or slab_batch for batched serving)")
    run(1, _sweep_forward(model, False))
    return out
