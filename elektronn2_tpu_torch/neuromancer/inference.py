"""Dense (whole-volume) inference: the dilated (à-trous) form of MFP.

Port of ``dilated_dense_forward`` and the dilated fast path of
``predict_dense_device`` in ``elektronn2_tpu/neuromancer/inference.py``,
``direct`` lowering only. MFP (fragment pooling + restitch) computes the
network at every pooling offset; the identical dense form runs each conv
dilated by the cumulative pool stride and each pool as a stride-1 dilated
max window, over the whole volume, with no fragments and no stitching.

Under ``Model.set_dilated_impl(pallas_tail=True)`` every conv that passes
``_ptail_node_ok`` (kernel (3,3,3), ReLU, no pooling) and sits at z-dilation
1 runs through the CUDA kernel ``ops.tailconv.conv3x3_dilated`` (K1), which
reads and writes NCDHW with a batch dimension: the TPU path's chained
``xzcy`` layout, its 1x1 head einsum and its per-slab loop have no
counterpart here, and the prediction is always (f, Z, X, Y).

Not in this slice (``NotImplementedError``): graphs with nodes other than
Input, Conv, Pool, Softmax and FragmentsToDense, which the JAX package
hands to its conv-dense and tiled fallbacks (ROADMAP.md §1 item 8 and 'Left
out of the dense slice'); the s2b/s2bg/ztap/zmajor/poolslice lowerings,
reduced precision, halo sharding.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


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
    order = pred.all_parents()           # parents before children
    supported = (Input, neural.Conv, neural.Pool, loss_mod.Softmax,
                 neural.FragmentsToDense)
    for node in order:
        if not isinstance(node, supported):
            raise NotImplementedError(
                f"dilated dense path: node type {type(node).__name__} is not "
                "ported; the JAX package serves such graphs through its "
                "conv-dense and tiled fallbacks, which are not ported yet "
                "(ROADMAP.md §1 item 8 and 'Left out of the dense slice')")

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
                # bias + ReLU fused in the kernel; eligible convs never pool
                return conv3x3_dilated(xin, w, b, dil=(1, dil[1], dil[2])), dil
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


def predict_dense_device(model, vol, pad_raw=False, tile_batch=1):
    """Dense MFP sweep of a volume on the model's device: (f, Z, X, Y)
    float32 tensor in, dense map (f_out, *out_spatial) out.

    ``pad_raw`` reflect-pads the volume by the fov first, so the output has
    the volume's own spatial shape. Without it a volume smaller than the fov
    raises. ``tile_batch`` belongs to the tiled fallback, which is not
    ported; graphs the dilated path does not take raise
    ``NotImplementedError``.
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
    # dilated convs into a silent 0-size output — reject it up front
    if not pad_raw and any(int(vol.shape[1 + d]) < fov[d]
                           for d in range(nsp)):
        raise ValueError(
            f"volume spatial shape {tuple(vol.shape[1:])} smaller than "
            f"the model fov {tuple(fov)}; pad_raw=True may help")

    with torch.no_grad(), f32_convs():
        if pad_raw:
            # F.pad lists (lo, hi) pairs from the LAST axis backwards
            pads = []
            for f in reversed(fov):
                pads += [(f - 1) // 2, f - 1 - (f - 1) // 2]
            vol = F.pad(vol[None], pads, mode="reflect")[0]
        return dilated_dense_forward(model, vol)
