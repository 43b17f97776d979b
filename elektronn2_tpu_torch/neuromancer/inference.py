"""Dense (whole-volume) inference: the dilated form of MFP, and the
whole-volume convolutional path of decoder (U-Net) graphs.

Port of ``dilated_dense_forward``, ``convolutional_dense_forward``,
``check_conv_dense_supported`` and ``predict_dense_device`` in
``elektronn2_tpu/neuromancer/inference.py``.

*Dilated path* (``direct`` lowering only). MFP (fragment pooling +
restitch) computes the network at every pooling offset; the identical dense
form runs each conv dilated by the cumulative pool stride and each pool as a
stride-1 dilated max window, over the whole volume, with no fragments and no
stitching. Under ``Model.set_dilated_impl(pallas_tail=True)`` every conv
that passes ``_ptail_node_ok`` (kernel (3,3,3), ReLU, no pooling) and sits
at z-dilation 1 runs through the CUDA kernel ``ops.tailconv.conv3x3_dilated``
(K1).

*Convolutional path*. A valid-mode encoder/decoder graph whose UpConvs bring
the output stride back to 1 is dense by construction on a larger input:
pad the volume to the next valid size, run the graph once over it, trim.
``Model.set_convdense_impl`` picks its lowerings (zfold, d2s, poolslice,
skipsum, and K1 on the eligible (3,3,3) ReLU convs, pooled ones included).
The walk frees every value after its last consumer: at full width the
values of a wide U-Net slab add up to far more than the card holds.

``predict_dense_device`` chooses the path from the graph's structure: a
graph of Input, Conv, Pool, Softmax and FragmentsToDense nodes takes the
dilated path; otherwise a graph that passes ``check_conv_dense_supported``
takes the convolutional one; anything else raises ``NotImplementedError``
naming the tiled fallback, which is not ported. Both paths read and write
NCDHW, so the prediction is always (f, Z, X, Y).

Not in this slice (``NotImplementedError``): the tiled fallback, the
s2b/s2bg/ztap/zmajor/poolslice lowerings of the dilated path, reduced
precision, halo sharding (ROADMAP.md §1, 'Left out of the dense slice' and
item 8b).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}

_TILED = ("the JAX package serves such graphs through its tiled fallback, "
          "which is not ported (ROADMAP.md §1, 'Left out of the dense "
          "slice')")


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


def _dilated_unsupported(pred):
    """The first node of ``pred``'s graph the dilated path does not take,
    or None."""
    from . import loss as loss_mod, neural
    from .node_basic import Input
    supported = (Input, neural.Conv, neural.Pool, loss_mod.Softmax,
                 neural.FragmentsToDense)
    for node in pred.all_parents():
        if not isinstance(node, supported):
            return node
    return None


def dilated_dense_forward(model, vol, batch=False):
    """Dense prediction via the à-trous (dilated convolution) identity.

    Output voxel j == MFP dense output voxel j (held by the tests against
    ``predict`` + ``fragments2dense``). Supports graphs of Input, Conv, Pool,
    Softmax and FragmentsToDense nodes; others raise ``NotImplementedError``
    before any work. ``vol``: (f, Z, X, Y) or, with ``batch=True``,
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
    params = model.params
    use_ptail = model._dilated_ptail and nsp == 3
    bad = _dilated_unsupported(pred)
    if bad is not None:
        raise NotImplementedError(
            f"dilated dense path: node type {type(bad).__name__} is not "
            "taken; decoder graphs take convolutional_dense_forward, and "
            + _TILED)
    order = pred.all_parents()           # parents before children

    def _ptail_node_ok(node):
        """Graph-level eligibility of one Conv for the tail kernel."""
        if not isinstance(node, neural.Conv):
            return False
        w_ = params[node.name]["w"]
        return (w_.ndim == 5 and tuple(w_.shape[2:]) == (3, 3, 3)
                and all(p == 1 for p in node.pool_shape)
                and node.activation_func == "relu")

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
            return apply_activation(y, node.activation_func), dil
        if isinstance(node, neural.Pool):
            y = dilated_pool(xin, node.pool_shape, dil, mode=node.mode)
            return y, tuple(d * p for d, p in zip(dil, node.pool_shape))
        if isinstance(node, loss_mod.Softmax):
            return loss_mod.grouped_softmax(xin, node.n_indep, 1), dil
        return xin, dil                  # FragmentsToDense: already dense

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
                  "FaithlessMerge", "Softmax"}
_CONV_DENSE_NOT_PORTED = {
    "BatchNorm": "§1 item 6, training path", "Dropout": "§1 item 6",
    "MultMerge": "§1 item 8b", "ApplyFunc": "§1 item 8b",
    "LRN": "§1 item 8b", "FromTensor": "§1 item 8b"}


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
            raise ValueError(f"volume {tuple(sp)} is too small for the "
                             f"graph: node {node.name!r} would be {s}")
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
            raise ValueError(f"volume {V} too small for pad_raw reflect pad")
        front = (lo, hi, off)
        V = [v + a + b for v, a, b in zip(V, lo, hi)]
    patch0 = [int(s) for s in model.input_node.shape.spatial_shape]
    out0 = [int(s) for s in pred.shape.spatial_shape]
    want_out = [v - f + 1 for v, f in zip(V, fov)]
    if any(w < 1 for w in want_out):
        raise ValueError(f"volume {V} smaller than model fov {fov}")
    # FaithlessMerge under-reports fov, so out0 may be less than
    # patch0 - fov + 1: pad the deficit too
    delta = [max(0, (p - f + 1) - o) for p, f, o in zip(patch0, fov, out0)]
    N = [p + max(0, -(-(v + d - p) // m)) * m
         for p, v, d, m in zip(patch0, V, delta, M)]
    if any(n - v > v - 1 for n, v in zip(N, V)):
        raise ValueError(f"volume {V} too small to pad to valid size {N}")
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
    (returns (B, f_out, *out)). A graph whose merge crops lose more voxels
    the larger the input, so that one run cannot cover the output, raises
    ``NotImplementedError`` before any work.
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
        raise NotImplementedError(
            f"convolutional dense path under-produces {tuple(got)} vs the "
            f"required {want_out}: this graph's merge-crop deficit grows "
            f"with the input size; " + _TILED)
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
    raises. The path is chosen from the graph (module docstring);
    ``tile_batch`` belongs to the tiled fallback, which is not ported.
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

    bad = _dilated_unsupported(pred)
    if bad is not None:
        reason = _conv_dense_rejection(pred)
        if reason is not None:
            raise NotImplementedError(
                f"dense path: the dilated path does not take node "
                f"{bad.name!r} of type {type(bad).__name__}, and the "
                f"convolutional dense path rejects the graph ({reason}); "
                + _TILED)
        return convolutional_dense_forward(model, vol, pad_raw=pad_raw)

    with torch.no_grad(), f32_convs():
        if pad_raw:
            # F.pad lists (lo, hi) pairs from the LAST axis backwards
            pads = []
            for f in reversed(fov):
                pads += [(f - 1) // 2, f - 1 - (f - 1) // 2]
            vol = F.pad(vol[None], pads, mode="reflect")[0]
        return dilated_dense_forward(model, vol)
