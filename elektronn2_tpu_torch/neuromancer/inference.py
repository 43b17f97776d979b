"""Dense inference: the dilated form of MFP, the whole-volume
convolutional path of decoder (U-Net) graphs, the overlap-tiled sweep, and
the whole-dataset KNOSSOS sweep.

Port of ``dilated_dense_forward``, ``convolutional_dense_forward``,
``check_conv_dense_supported``, ``predict_dense_device``,
``predict_dense`` and ``sweep_knossos`` in
``elektronn2_tpu/neuromancer/inference.py``.

*Dilated path*. MFP (fragment pooling +
restitch) computes the network at every pooling offset; the identical dense
form runs each conv dilated by the cumulative pool stride and each pool as a
stride-1 dilated max window, over the whole volume, with no fragments and no
stitching. Batch norm with running statistics is a per-channel affine there
(after the dilated pool), prelu's slope applies per channel, and dropout is
the identity. Under ``Model.set_dilated_impl(pallas_tail=True)`` every conv
that passes ``_ptail_node_ok`` (kernel (3,3,3), ReLU, no pooling, no batch
norm, no prelu) and sits at z-dilation 1 runs through the CUDA kernel
``ops.tailconv.conv3x3_dilated`` (K1). ``Model.set_dilated_impl`` picks
the lowering, each the same function up to the order of float sums:
``direct`` (cuDNN's dilated convs and pools), ``s2b`` and ``s2bg``
(space-to-batch around each op, or once at the dilation plateau with one
merge at the output), ``zfold`` (kz=1 convs as 2-D convs), ``ztap`` (kz>1
convs as z-shifted 2-D convs), ``zmajor`` (the (B, Z, C, X, Y) layout) and
``poolslice`` (pools as maxima of shifted slices).

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

Under a profiler the paths open host spans (``utils/profiling.py``):
``predict_dense_device`` over the call, ``dense/<node name>`` over each
node's evaluation, ``dense.pool`` over each pool, and the sweep's own.

Every path serves the model's precision (``Model.set_compute_dtype``):
float32, bf16 or float16 Conv operands, or int8 convs on the whole-volume
paths (``ops.conv.quantized_conv``), with narrow inter-layer storage under
``activations=True``; K1 at float32 only. ``tune_sweep`` (``Model.
tune_serving``) times the serving contenders as ``sweep_knossos``
dispatches them and applies the fastest.

*Sharded serving* (``predict_dense_sharded``, ``predict_dense_sharded_batch``,
``sweep_knossos(mesh=...)``): each slab's z extent split over a ``space``
mesh axis, with halo exchange before every conv and pool
(``parallel/halo.py``), and a slab batch over a ``data`` axis; decoder graphs
take one input-level halo and the whole conv-dense program per rank. Every
rank is given the whole input and returns the whole result, equal to the
unsharded call (int8 bit for bit); the dilated path's lowerings fall back
to ``direct`` there, as in the JAX package.
"""

from __future__ import annotations

import itertools
import math
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..log import logger
from ..ops.conv import INT32_ELEMENTS
from ..utils.profiling import NODE_SPAN, POOL_SPAN, span

_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}

_TILED = "predict_dense_device serves such graphs through its tiled fallback"


class UnsupportedGraphError(ValueError):
    """A graph a dense path can never take, whatever the volume (the
    sharded conv-dense leg's z-pooled or z-undercovering decoders).
    Reference: ``inference.py::UnsupportedGraphError``."""


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


def _pool_slices(y, pool, dil, axes, op=torch.maximum):
    """``op`` (max, or add for a sum) over a stride-1 pool window dilated
    by ``dil`` along ``axes`` of ``y``, folded over the window's shifted
    slices; VALID extent ``s - d*(p-1)`` per axis. Reference:
    ``inference.py::dilated_dense_forward._pool_slices``."""
    outs = [y.shape[a] - d * (p - 1) for a, d, p in zip(axes, dil, pool)]
    acc = None
    for offs in itertools.product(*(range(p) for p in pool)):
        idx = [slice(None)] * y.ndim
        for a, o, d, e in zip(axes, offs, dil, outs):
            idx[a] = slice(o * d, o * d + e)
        s = y[tuple(idx)]
        acc = s if acc is None else op(acc, s)
    return acc


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
    acc = _pool_slices(y, pool, dil, range(2, y.ndim), torch.add)
    return acc / float(np.prod(pool)) if mode in ("avg", "mean") else acc


def _functor_spatially_elementwise(node, n_ch):
    """Whether an ApplyFunc's functor is pointwise across space (channel
    mixing, e.g. a per-voxel softmax, is fine): only then does its
    evaluation on the dilated path's full-resolution maps equal the
    fragment semantics. Probe: ``f(cat(x, y)) == cat(f(x), f(y))`` along
    each spatial axis, on small random blocks at the node's rank (distinct
    extents catch transposes); a functor that changes the spatial or batch
    shape, or raises, is not. Cached on the node. Reference:
    ``inference.py::_functor_spatially_elementwise``."""
    cached = getattr(node, "_spatially_elementwise", None)
    if cached is not None:
        return cached
    rng = np.random.RandomState(0)
    nsp = len(node.parents[0].shape.spatial_axes)
    shape = (1, int(n_ch)) + (3, 4, 5)[3 - nsp:]
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    y = torch.from_numpy(rng.rand(*shape).astype(np.float32))

    def f(a):
        return node.functor(a, *node.args, **node.kwargs)
    ok = True
    try:
        fx, fy = f(x), f(y)
        if fx.shape[0] != 1 or tuple(fx.shape[2:]) != tuple(x.shape[2:]):
            ok = False                   # a spatial or batch shape change
        else:
            for ax in range(2, 2 + nsp):
                got = f(torch.cat([x, y], dim=ax))
                want = torch.cat([fx, fy], dim=ax)
                if got.shape != want.shape or not torch.allclose(
                        got, want, rtol=1e-5, atol=1e-6):
                    ok = False
                    break
    except Exception:        # noqa: BLE001 — a functor that fails the probe
        ok = False           # is not taken; the tiled path evaluates it
    node._spatially_elementwise = ok
    return ok


def _dilated_unsupported(pred, state):
    """The first node of ``pred``'s graph the dilated path does not take,
    or None. A batch-normed node without running statistics in ``state``
    is not taken (its evaluation normalises by the batch's statistics,
    which the tiled path computes per tile, as the JAX package does); nor
    is a Concat off the feature axis or of parents at other dilations, nor
    an ApplyFunc that is not spatially pointwise
    (:func:`_functor_spatially_elementwise`)."""
    from . import loss as loss_mod, neural
    from .node_basic import ApplyFunc, Concat, Input
    supported = (Input, neural.Conv, neural.Pool, neural.BatchNorm,
                 neural.Dropout, loss_mod.Softmax, neural.FragmentsToDense,
                 Concat, ApplyFunc)
    dil = {}
    for node in pred.all_parents():
        if not isinstance(node, supported):
            return node
        if getattr(node, "_bn_nf", None) is not None \
                and node.name not in state:
            return node
        if isinstance(node, Input):
            d = (1,) * len(node.shape.spatial_axes)
        else:
            d = dil[node.parents[0].name]
        if isinstance(node, (neural.Conv, neural.Pool)):
            d = tuple(a * p for a, p in zip(d, node.pool_shape))
        if isinstance(node, Concat) and (
                node.axis not in (1, node.parents[0].shape.tag2index("f"))
                or len({dil[p.name] for p in node.parents}) != 1):
            return node
        if isinstance(node, ApplyFunc) and not _functor_spatially_elementwise(
                node, node.parents[0].shape["f"]):
            return node
        dil[node.name] = d
    return None


def _bn_affine(params, state, node, y, ch_ax=1):
    """Evaluation-mode batch norm of the map ``y`` (channels on axis
    ``ch_ax``) from the node's running statistics: a per-channel affine, so
    it commutes with the dilated form. Reference: ``inference.py::
    _bn_affine``."""
    shape = [1] * y.ndim
    shape[ch_ax] = -1
    shape = tuple(shape)
    st = state[node.name]
    gamma = params[node.name]["bn_gamma"].reshape(shape)
    beta = params[node.name]["bn_beta"].reshape(shape)
    return (gamma * (y - st["mean"].reshape(shape))
            * torch.rsqrt(st["var"].reshape(shape) + 1e-5) + beta)




def _zmajor_conv(xi, wc, dil, mode):
    """The conv of ``wc`` (Cout, C, kz, kx, ky) over z-major activations
    ``xi`` (B, Z, C, X, Y) at dilation ``dil``, without the bias, as
    (B, Zo, Cout, X', Y'). kz = 1 folds z into the batch of one 2-D conv; a
    kz > 1 conv takes ``mode``: ``'fatn'`` (one 2-D conv to Cout*kz
    channels, the taps added by shifted slices), ``'conv3d'`` (one 3-D
    conv of the channel-major view), or ``ops.conv.conv_ztap``'s
    ``'native'``, ``'f32'`` and ``'concat'`` on the channel-major view,
    whose z fold is then a free reshape. fatn's output z rows run in
    chunks wherever its conv would pass 2^31 elements (``ops.conv.
    z_chunks``). Reference: ``inference.py::dilated_dense_forward``'s
    z-major branch."""
    from ..ops.conv import (conv as ops_conv, conv_zfold2d, conv_ztap,
                            z_chunks)
    B, Z, C, X, Y = xi.shape
    Cout, kz = wc.shape[0], wc.shape[2]
    dz, dxy = dil[0], tuple(dil[1:])
    Xo = X - dxy[0] * (wc.shape[3] - 1)
    Yo = Y - dxy[1] * (wc.shape[4] - 1)
    if kz == 1:                      # the fold of the z-major layout is free
        return conv_zfold2d(xi.transpose(1, 2), wc,
                            dilation=dxy).transpose(1, 2)
    if mode == "conv3d":
        return ops_conv(xi.transpose(1, 2), wc, dilation=dil).transpose(1, 2)
    if mode != "fatn":
        return conv_ztap(xi.transpose(1, 2), wc, dil,
                         accum=mode).transpose(1, 2)
    zo = Z - dz * (kz - 1)
    halo = dz * (kz - 1)
    w2 = wc.permute(2, 0, 1, 3, 4).reshape(kz * Cout, C, *wc.shape[3:])
    parts = []
    for z0, z1 in z_chunks(zo, B * max(C * X * Y, kz * Cout * Xo * Yo),
                           halo=halo):
        zc, n = z1 - z0, z1 - z0 + halo
        c = ops_conv(xi[:, z0:z0 + n].reshape(B * n, C, X, Y), w2,
                     dilation=dxy).reshape(B, n, kz, Cout, Xo, Yo)
        y = c[:, 0:zc, 0]
        for t in range(1, kz):
            y = y + c[:, t * dz:t * dz + zc, t]
        del c
        parts.append(y)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _dilation_plateau(pred, nsp):
    """The dilation of ``pred``'s output along its first parents, the
    product of every pool shape on the way: the last value the dilation
    takes (it only grows along the graph, so every value's divides it)."""
    from . import neural
    from .node_basic import Input
    dil = {}
    for node in pred.all_parents():
        d = ((1,) * nsp if isinstance(node, Input)
             else dil[node.parents[0].name])
        if isinstance(node, (neural.Conv, neural.Pool)):
            d = tuple(a * p for a, p in zip(d, node.pool_shape))
        dil[node.name] = d
    return dil[pred.name]


_PLATEAU = ("dilated dense path (s2bg): pooling past the dilation plateau "
            "— dilation schedule is inconsistent")


def dilated_dense_forward(model, vol, batch=False, quant_calibrate=None,
                          halo_axis=None, mesh=None, quant_scale_axes=None,
                          quant_shard=None):
    """Dense prediction via the à-trous (dilated convolution) identity.

    Output voxel j == MFP dense output voxel j (held by the tests against
    ``predict`` + ``fragments2dense``). Supports graphs of Input, Conv, Pool,
    BatchNorm (with running statistics), Dropout, Softmax, FragmentsToDense,
    feature-axis Concat and spatially pointwise ApplyFunc nodes; others
    raise ``NotImplementedError`` before any work. ``vol``: (f, Z, X, Y) or,
    with ``batch=True``, (b, f, Z, X, Y). Call under ``torch.no_grad()`` and
    ``ops.conv.f32_convs()`` (``predict_dense_device`` does).

    The lowering is the model's (``Model.set_dilated_impl``): ``'direct'``,
    ``'s2b'`` (space-to-batch around every dilated conv and pool),
    ``'s2bg'`` (one split at the dilation plateau, the tail undilated on
    the batch of phases, one merge at the output; a pool past the plateau
    raises ``UnsupportedGraphError``), with ``zfold``, ``ztap``, ``zmajor``
    and ``poolslice``: each the same function up to the order of float
    sums.

    The model's serving precision (``Model.set_compute_dtype``): bf16 or
    float16 Conv operands; int8 through ``ops.conv.quantized_conv``, with
    the calibrated scales where there are some; with ``activations=True``
    the values between layers stored in the compute type (bf16 under int8),
    epilogues and the softmax in float32. The result is float32. K1 runs
    at float32 outside phase space, and not under s2b or zmajor, where the
    JAX package ignores its kernel too. ``quant_calibrate``, a dict, gets
    each Conv's input max-abs from a float32 evaluation
    (``Model.calibrate_int8``).

    With ``halo_axis`` (a z-sharded volume: ``vol`` is this rank's shard of
    ``mesh``'s ``halo_axis``) every lowering is ``'direct'``, as in the JAX
    package, and every conv and pool first fetches its ``dilation·(k-1)`` z
    rows from the next ranks (``parallel.halo.halo_gather``), K1 included,
    which then runs per shard on the gathered input; each rank keeps
    z_local output rows, and the global trailing ``fov_z - 1`` rows are
    invalid (the caller trims them). int8 scales are reduced over
    ``quant_scale_axes`` (default ``halo_axis``); a dynamic scale leaves out
    the rows past the global valid extent and the z pad rows
    (``quant_shard``: ``{"n_z": axis size, "pad_z": pad rows}``), so the
    result is the unsharded int8 program's bit for bit.
    """
    from . import loss as loss_mod, neural
    from .node_basic import ApplyFunc, Concat, Input
    from ..ops.conv import (_s2b_merge, _s2b_split, _s2b_split_zmajor,
                            absmax, apply_activation, conv as ops_conv,
                            conv_s2b, conv_ztap, conv_zfold2d, pool_s2b,
                            quantized_conv)
    from ..ops.tailconv import conv3x3_dilated
    from ..parallel.halo import axis_group, halo_gather

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
    sharded = halo_axis is not None
    use_s2b = model._dilated_impl == "s2b" and not sharded
    use_s2bg = model._dilated_impl == "s2bg" and not sharded
    use_zfold = model._dilated_zfold and not sharded and not use_s2b
    ztap_mode = "native" if model._dilated_ztap is True \
        else model._dilated_ztap
    use_ztap = (bool(ztap_mode) and not sharded and not use_s2b
                and nsp == 3)
    use_zmajor = (model._dilated_zmajor and not sharded and not use_s2b
                  and nsp == 3)
    if use_zmajor and not ztap_mode:
        ztap_mode = "native"
    quant = model._compute_dtype == "int8" and quant_calibrate is None
    if (quant or quant_calibrate is not None) and (use_ztap or use_zmajor):
        raise ValueError("int8 serving: ztap/zmajor unsupported")
    scales = (model._quant_scales or {}) if quant else {}
    cdtype = (None if quant or quant_calibrate is not None
              else model._trace_dtype())
    sdtype = None                       # narrow inter-layer storage
    if model._compute_act:
        sdtype = torch.bfloat16 if quant else cdtype
    use_ptail = (bool(model._dilated_ptail) and not use_s2b
                 and not use_zmajor and nsp == 3 and not quant
                 and quant_calibrate is None and cdtype is None
                 and sdtype is None)
    use_poolslice = model._dilated_poolslice and not sharded and not use_s2b
    ch_ax = 2 if use_zmajor else 1       # (B, Z, C, X, Y) under zmajor
    bad = _dilated_unsupported(pred, state)
    if bad is not None:
        raise NotImplementedError(
            f"dilated dense path: node type {type(bad).__name__} is not "
            "taken; decoder graphs take convolutional_dense_forward, and "
            + _TILED)
    d_max = _dilation_plateau(pred, nsp) if use_s2bg else None
    if use_s2bg and all(v == 1 for v in d_max):
        use_s2bg = False                 # no pooling: nothing to split
    order = pred.all_parents()           # parents before children
    group = axis_group(mesh, halo_axis) if sharded and nsp == 3 else None
    q_axes = quant_scale_axes if quant_scale_axes is not None else halo_axis
    # z rows consumed before each node's output: under the halo the last
    # ranks' trailing rows past the global valid extent hold what the zero
    # halo made, which a dynamic int8 scale must leave out
    zcons = {}

    def halo(y, n_rows):
        return y if group is None or n_rows == 0 else \
            halo_gather(y, n_rows, group)

    def maybe_split(y, dil, ph):
        """Enter phase space at the dilation plateau (s2bg only)."""
        if use_s2bg and ph is None and dil == d_max:
            split = _s2b_split_zmajor if use_zmajor else _s2b_split
            return split(y, d_max), d_max
        return y, ph

    def pool(y, pool_shape, dil, mode="max"):
        with span(POOL_SPAN):
            return pool_op(y, pool_shape, dil, mode)

    def pool_op(y, pool_shape, dil, mode):
        if use_poolslice and mode == "max":
            axes = ((1,) + tuple(range(3, y.ndim))
                    if use_zmajor and y.ndim == nsp + 2
                    else tuple(range(y.ndim - len(pool_shape), y.ndim)))
            return _pool_slices(y, pool_shape, dil, axes)
        if use_zmajor:
            return dilated_pool(y.transpose(1, 2), pool_shape, dil,
                                mode=mode).transpose(1, 2)
        if y.ndim == nsp + 2:
            y = halo(y, dil[0] * (pool_shape[0] - 1))
        if use_s2b:
            return pool_s2b(y, pool_shape, dil, mode=mode)
        return dilated_pool(y, pool_shape, dil, mode=mode)

    def masked_absmax(y, zl, consumed):
        """max |y| over the rows of this rank's (halo-extended) input that
        lie inside the global valid extent: a prefix of its rows."""
        qi = quant_shard or {}
        r = dist.get_rank(group)
        valid = (zl * int(qi.get("n_z", 1)) - int(qi.get("pad_z", 0))
                 - consumed - r * zl)
        valid = max(0, min(int(y.shape[2]), valid))
        if valid == 0:
            return torch.zeros((), device=y.device)
        return absmax(y[:, :, :valid]).float()

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

    def store(y):
        return y if sdtype is None else y.to(sdtype)

    def conv_bias(xin, w, b, dil, cfn=ops_conv):
        """``cfn``'s conv of xin in the serving precision, plus the bias
        (float32)."""
        bias = b.reshape((1, -1) + (1,) * (w.ndim - 2))
        if cdtype is not None:
            return cfn(xin.to(cdtype), w.to(cdtype), dilation=dil).float() \
                + bias
        if cfn is ops_conv:
            return ops_conv(xin, w, b, dilation=dil)
        return cfn(xin, w, dilation=dil) + bias

    def conv_node(node, xin, dil, ph, vin):
        """A Conv's output, dilation, phase state and dense-space valid
        extent."""
        w = params[node.name]["w"]
        b = params[node.name]["b"]
        pool_shape = node.pool_shape
        pooled = any(p > 1 for p in pool_shape)
        kz = w.shape[2]
        if quant_calibrate is not None:
            quant_calibrate[node.name] = float(absmax(xin))
        xin, ph = maybe_split(xin, dil, ph)
        if ph is not None and pooled:
            raise UnsupportedGraphError(_PLATEAU)
        eff = (1,) * nsp if ph is not None else dil
        v = tuple(s - d * (k - 1) for s, d, k in zip(vin, dil, w.shape[2:]))
        if use_zmajor:
            # every conv folded: kz=1 a free reshape, kz>1 by z-slices
            if cdtype is not None:
                y = _zmajor_conv(xin.to(cdtype), w.to(cdtype), eff,
                                 ztap_mode).float()
            else:
                y = _zmajor_conv(xin, w, eff, ztap_mode)
            y = y + b.reshape(1, 1, -1, 1, 1)
            if pooled:
                y = pool(y, pool_shape, dil)
        elif use_zfold and nsp == 3 and kz == 1 and pool_shape[0] == 1:
            # z never mixes (kz=1, pz=1): z folded into the batch, conv +
            # bias + pool as 2-D ops, unfolded after
            def fold(x2, w2, dilation):
                if quant:
                    y2 = quantized_conv(x2, w2, dilation=dilation,
                                        x_absmax=scales.get(node.name)) \
                        + b.reshape(1, -1, 1, 1)
                else:
                    y2 = conv_bias(x2, w2, b, dilation)
                del x2                   # the folded copy, before the pool
                return pool(y2, pool_shape[1:], dilation) if pooled else y2
            y = conv_zfold2d(xin, w, dilation=eff[1:], conv_fn=fold)
        elif (use_ptail and ph is None and eff[0] == 1
                and _ptail_node_ok(node)):
            # bias + ReLU fused in the kernel; eligible convs never pool;
            # the input may be the caller's strided view
            xin = halo(xin, kz - 1)
            return (conv3x3_dilated(xin.contiguous(), w, b,
                                    dil=(1, eff[1], eff[2])), dil, ph, v)
        else:
            zl = int(xin.shape[2])
            if nsp == 3:
                xin = halo(xin, eff[0] * (kz - 1))
            if quant:
                sx = scales.get(node.name)
                if sx is None and group is not None:
                    sx = masked_absmax(xin, zl, zcons[node.parents[0].name])
                y = quantized_conv(
                    xin, w, conv_fn=conv_s2b if use_s2b else ops_conv,
                    dilation=eff, x_absmax=sx,
                    axis_name=q_axes if group is not None else None,
                    mesh=mesh) + b.reshape((1, -1) + (1,) * nsp)
            elif use_ztap and kz > 1:
                y = conv_bias(xin, w, b, eff, lambda a, w_, dilation:
                              conv_ztap(a, w_, dilation, accum=ztap_mode))
            else:
                y = conv_bias(xin, w, b, eff,
                              conv_s2b if use_s2b else ops_conv)
            if pooled:
                y = pool(y, pool_shape, dil)
        if pooled:
            v = tuple(s - d * (p - 1) for s, d, p in zip(v, dil, pool_shape))
            dil = tuple(d * p for d, p in zip(dil, pool_shape))
        if node.batch_normalisation:
            y = _bn_affine(params, state, node, y, ch_ax)
        y = store(apply_activation(y, node.activation_func,
                                   alpha=params[node.name].get("alpha"),
                                   axis=ch_ax))
        return y, dil, ph, v

    x = vol if batch else vol[None]
    if use_zmajor:
        x = x.transpose(1, 2)
    values = {}    # node name -> (tensor, dilation, phase tuple or None)
    vext = {}      # node name -> dense-space valid spatial extent

    def evaluate(node):
        if isinstance(node, Input):
            zcons[node.name] = 0
            vext[node.name] = (((x.shape[1],) + tuple(x.shape[3:]))
                               if use_zmajor else tuple(x.shape[2:]))
            return x, (1,) * nsp, None
        xin, dil, ph = values[node.parents[0].name]
        vin = vext[node.parents[0].name]
        vext[node.name] = vin
        zcons[node.name] = zcons[node.parents[0].name]
        if isinstance(node, (neural.Conv, neural.Pool)):
            zcons[node.name] += dil[0] * (node.pool_shape[0] - 1)
        if isinstance(node, neural.Conv):
            zcons[node.name] += dil[0] * (params[node.name]["w"].shape[2]
                                          - 1)
            y, dil, ph, vext[node.name] = conv_node(node, xin, dil, ph, vin)
            return y, dil, ph
        if isinstance(node, neural.Pool):
            if ph is not None:
                raise UnsupportedGraphError(_PLATEAU)
            vext[node.name] = tuple(s - d * (p - 1) for s, d, p in
                                    zip(vin, dil, node.pool_shape))
            return (pool(xin, node.pool_shape, dil, mode=node.mode),
                    tuple(d * p for d, p in zip(dil, node.pool_shape)), ph)
        if isinstance(node, loss_mod.Softmax):
            return (loss_mod.grouped_softmax(xin.float(), node.n_indep,
                                             ch_ax), dil, ph)
        if isinstance(node, neural.BatchNorm):
            return store(_bn_affine(params, state, node, xin, ch_ax)), dil, ph
        if isinstance(node, Concat):
            parts = [values[p.name] for p in node.parents]
            if any(p[2] is not None for p in parts):
                # mixed phase states (one branch split, another not yet):
                # every parent into phase space before the concat
                arrs = []
                for a, d, p_ph in parts:
                    a, p_ph = maybe_split(a, d, p_ph)
                    if p_ph is None:
                        raise UnsupportedGraphError(
                            "dilated dense path (s2bg): Concat parents at "
                            "mismatched phase states")
                    arrs.append(a)
                return torch.cat(arrs, dim=ch_ax), dil, d_max
            return torch.cat([p[0] for p in parts], dim=ch_ax), dil, ph
        if isinstance(node, ApplyFunc):
            if use_zmajor:     # functors take the (B, C, *sp) layout
                return (node.functor(xin.transpose(1, 2), *node.args,
                                     **node.kwargs).transpose(1, 2),
                        dil, ph)
            return node.functor(xin, *node.args, **node.kwargs), dil, ph
        return xin, dil, ph  # FragmentsToDense: already dense; Dropout

    # drop each value after its last consumer: eager PyTorch keeps every
    # live intermediate in device memory (several GB each at 120x496x496)
    uses = {n.name: 0 for n in order}
    for n in order:
        for p in n.parents:
            uses[p.name] += 1
    for node in order:
        with span(NODE_SPAN + node.name):
            values[node.name] = evaluate(node)
        for p in node.parents:
            uses[p.name] -= 1
            if uses[p.name] == 0:
                del values[p.name]
    y, _, ph = values.pop(pred.name)
    y = y.float()                        # callers get float32 maps
    if use_zmajor:
        y = y.transpose(1, 2)            # channel-major for the merge
    if ph is not None:
        y = _s2b_merge(y, ph, x.shape[0], vext[pred.name])
    y = y.contiguous()
    return y if batch else y[0]


# ----------------------------------------------------- convolutional path

# node types whose _compute takes any input size (reference:
# ``inference.py::_CONV_DENSE_OK``)
_CONV_DENSE_OK = {"Input", "Conv", "UpConv", "Crop", "Pool", "Concat",
                  "FaithlessMerge", "MultMerge", "Softmax", "BatchNorm",
                  "Dropout", "ApplyFunc", "LRN", "FromTensor"}


def _conv_dense_rejection(pred):
    """Why ``pred``'s graph cannot take the convolutional dense path, as a
    string, or None when it can."""
    has_upconv = False
    for node in pred.all_parents():
        tname = type(node).__name__
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
        elif tname == "FromTensor":     # a constant: its own extent
            s = [int(v) for v in node.shape.spatial_shape]
            s = s if len(s) == len(sp) else [1] * len(sp)
        elif tname == "MultMerge":      # broadcasting
            s = [max(a, b) for a, b in zip(shapes[node.parents[0].name],
                                           shapes[node.parents[1].name])]
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
        with span(NODE_SPAN + node.name):
            ctx.get(node)
        for p in consumed(node):
            uses[p.name] -= 1
            if uses[p.name] == 0:
                del ctx.values[p.name]
    return ctx.values.pop(pred.name)


def _convdense_ctx(model, feed, quant_calibrate=None):
    """The ``TraceCtx`` of a conv-dense evaluation: the model's parameters,
    aux state, serving precision and ``set_convdense_impl`` lowerings (K1
    at float32 only)."""
    from .node_basic import TraceCtx
    ctx = TraceCtx(model.params, feed, state_in=model.state)
    ctx.compute_dtype = model._trace_dtype()
    ctx.quant_serving = (model._compute_dtype == "int8"
                         and quant_calibrate is None)
    ctx.quant_calibrate = quant_calibrate
    ctx.quant_scales = model._quant_scales
    ctx.convdense_upconv_d2s = model._convdense_upconv == "d2s"
    ctx.convdense_zfold = model._convdense_zfold
    ctx.convdense_poolslice = model._convdense_poolslice
    ctx.convdense_skipsum = model._convdense_skipsum
    ctx.convdense_ptail = (model._convdense_ptail
                           and len(model.input_node.shape.spatial_axes) == 3
                           and model._compute_dtype is None
                           and quant_calibrate is None)
    return ctx


def convolutional_dense_forward(model, vol, pad_raw=False, batch=False,
                                quant_calibrate=None):
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

    The serving precision: bf16/float16 Conv operands, or int8 Conv and
    UpConv through ``ops.conv.quantized_conv`` (one scale per volume, or
    the calibrated ones); K1 (``ptail``) at float32 only.
    ``quant_calibrate``, a dict, gets each Conv's and UpConv's input
    max-abs from a float32 evaluation instead (``Model.calibrate_int8``).
    """
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
            model, F.pad(x, pads, mode="reflect"), batch=True,
            quant_calibrate=quant_calibrate)
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
    ctx = _convdense_ctx(model, {inp.name: x}, quant_calibrate)
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
    Under a profiler the call is the span ``predict_dense_device``.
    """
    with span("predict_dense_device"):
        return _predict_dense_device(model, vol, pad_raw, tile_batch)


def _predict_dense_device(model, vol, pad_raw, tile_batch):
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

    if _dilated_unsupported(pred, model.state) is None:
        try:
            with torch.no_grad(), f32_convs():
                vol_p = vol
                if pad_raw:
                    # F.pad lists (lo, hi) pairs from the LAST axis
                    # backwards
                    pads = []
                    for f in reversed(fov):
                        pads += [(f - 1) // 2, f - 1 - (f - 1) // 2]
                    vol_p = F.pad(vol[None], pads, mode="reflect")[0]
                return dilated_dense_forward(model, vol_p)
        except UnsupportedGraphError:
            # a lowering that cannot take this graph (s2bg's plateau
            # checks): the tiled path serves it, as in the JAX package
            pass
    elif _conv_dense_rejection(pred) is None:
        try:
            return convolutional_dense_forward(model, vol, pad_raw=pad_raw)
        except ConvDenseShapeError:
            pass    # refused for the volume's shape: the tiled fallback
    if model._compute_dtype == "int8" and not getattr(
            model, "_warned_int8_tiled", False):
        # int8 covers the whole-volume paths only: say so rather than
        # let the user believe the tiled map is quantised
        model._warned_int8_tiled = True
        logger.warning(
            "int8 serving requested, but this graph/volume routes to "
            "the overlap-tiled fallback, which runs float32 (per-tile "
            "scales would seam the stitched output)")
    return _tiled_sweep(model, vol, pad_raw, tile_batch)


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


# ----------------------------------------------------------- sharded serving

def _sharded_input(model, vols, mesh, axis_name, batch_axis):
    """Check a sharded call's (B, f, Z, X, Y) float32 volumes on the model's
    device; returns the ``space`` group, its size and the ``data`` group
    (None without ``batch_axis``). A slab batch the ``data`` axis does not
    divide raises ``ValueError``."""
    from ..parallel.halo import axis_group
    if len(model.input_node.shape.spatial_axes) != 3 or vols.ndim != 5:
        raise ValueError("sharded dense serving expects a 3D model and "
                         f"(B, f, Z, X, Y) volumes; got rank {vols.ndim}")
    if not isinstance(vols, torch.Tensor) or vols.dtype != torch.float32:
        raise TypeError("sharded dense serving takes a float32 tensor")
    model._check_device(vols, "volume")
    space = axis_group(mesh, axis_name)
    data = None
    if batch_axis is not None:
        data = axis_group(mesh, batch_axis)
        b = dist.get_world_size(data)
        if vols.shape[0] % b:
            raise ValueError(f"slab batch {vols.shape[0]} not divisible by "
                             f"mesh axis {batch_axis!r}={b}")
    return space, dist.get_world_size(space), data


def _pad_z(vols, n):
    """``vols`` reflect-padded in z to a multiple of ``n``; the pad."""
    pad_z = (n - vols.shape[2] % n) % n
    if pad_z:
        vols = F.pad(vols, (0, 0, 0, 0, 0, pad_z), mode="reflect")
    return vols, pad_z


def _sharded_run(vols, space, data, forward):
    """This rank's block of ``vols`` (its slabs of ``data``, its z rows of
    ``space``) through ``forward``, the results gathered over both axes."""
    from ..parallel.halo import gather, shard
    x = shard(vols, space, 2)
    if data is not None:
        x = shard(x, data, 0)
    y = gather(forward(x), space, 2)
    return y if data is None else gather(y, data, 0)


def _sharded_batch_convdense(model, vols, mesh, axis_name, batch_axis):
    """``predict_dense_sharded_batch``'s decoder-graph leg: one input-level
    halo of ``fov_z - 1`` rows from the next ranks, then the whole local
    conv-dense program per rank (valid in z). Decoders that pool only in
    x/y have a z receptive field of exactly ``fov_z``, so this equals the
    unsharded batched run. Graphs that pool or stride in z (``M_z > 1``) or
    whose FaithlessMerge under-covers z (``delta_z > 0``: per-rank reflect
    pads would change interior voxels) raise ``UnsupportedGraphError``;
    int8 without calibrated scales, and a local shard plus halo smaller
    than the z patch, raise ``ValueError``. Reference:
    ``inference.py::_sharded_batch_convdense``."""
    from ..parallel.halo import halo_gather
    inp, pred = model.input_node, model.prediction_node
    space, n, data = _sharded_input(model, vols, mesh, axis_name, batch_axis)
    fov = [int(f) for f in pred.shape.fov]
    patch0 = [int(s) for s in inp.shape.spatial_shape]
    out0 = [int(s) for s in pred.shape.spatial_shape]
    M_z = _valid_period(pred, 3)[0]
    delta_z = max(0, (patch0[0] - fov[0] + 1) - out0[0])
    if M_z != 1 or delta_z:
        raise UnsupportedGraphError(
            f"z-sharded conv-dense serving requires an unpooled z axis "
            f"(M_z={M_z}) and full z fov coverage (delta_z={delta_z}); "
            "this graph needs per-rank z padding that would decohere "
            "voxels from the unsharded run — use per-slab unsharded "
            "sweeps")
    if model._compute_dtype == "int8" and not model._quant_scales:
        raise ValueError(
            "z-sharded int8 conv-dense serving needs calibrated static "
            "activation scales (Model.calibrate_int8) — dynamic per-rank "
            "scales would seam values at shard boundaries "
            "(sweep_knossos calibrates on its first slab)")
    Z = int(vols.shape[2])
    vols, pad_z = _pad_z(vols, n)
    z_loc = (Z + pad_z) // n
    if z_loc + fov[0] - 1 < patch0[0]:
        raise ValueError(
            f"local z shard {z_loc} (+{fov[0] - 1} halo) is smaller than "
            f"the model's z patch {patch0[0]}: per-rank padding would "
            f"decohere the output — use fewer z shards or taller slabs")
    y = _sharded_run(vols, space, data, lambda x: convolutional_dense_forward(
        model, halo_gather(x, fov[0] - 1, space), batch=True))
    return y[:, :, :Z - fov[0] + 1]


def predict_dense_sharded_batch(model, vols, mesh, axis_name="space",
                                batch_axis="data"):
    """DP x SP dense serving: a batch of slabs split over ``batch_axis``
    while each slab's z extent is split over ``axis_name`` (halo exchange).

    ``vols``: (B, f, Z, X, Y) float32 on the model's device, the whole
    batch on every rank; B must be divisible by the ``batch_axis`` size, and
    z is reflect-padded to a multiple of the ``axis_name`` size.
    ``batch_axis=None`` leaves the batch unsplit (``predict_dense_sharded``
    is its B=1 case). Every rank returns the whole (B, f_out, Z - fov_z + 1,
    X', Y') result, equal to the unsharded batched forward (int8 bit for
    bit: the scales are reduced over both axes). Decoder (UpConv) graphs
    take :func:`_sharded_batch_convdense`; the dilated path serves the
    others, K1 per shard under ``set_dilated_impl(pallas_tail=True)``. 3D
    models only. Reference: ``inference.py::predict_dense_sharded_batch``.
    """
    from ..ops.conv import f32_convs
    pred = model.prediction_node
    if _conv_dense_rejection(pred) is None:
        return _sharded_batch_convdense(model, vols, mesh, axis_name,
                                        batch_axis)
    _check_dense_geometry(pred)
    space, n, data = _sharded_input(model, vols, mesh, axis_name, batch_axis)
    fov = list(pred.shape.fov)
    Z = int(vols.shape[2])
    vols, pad_z = _pad_z(vols, n)
    qaxes = (batch_axis, axis_name) if batch_axis is not None else axis_name
    with torch.no_grad(), f32_convs():
        y = _sharded_run(vols, space, data, lambda x: dilated_dense_forward(
            model, x, batch=True, halo_axis=axis_name, mesh=mesh,
            quant_scale_axes=qaxes, quant_shard={"n_z": n, "pad_z": pad_z}))
    return y[:, :, :Z - fov[0] + 1]


def predict_dense_sharded(model, vol, mesh, axis_name="space",
                          pad_raw=False):
    """Dense sweep of one (f, Z, X, Y) volume with its z axis split over
    the mesh axis ``axis_name`` (halo exchange over the axis's group):
    :func:`predict_dense_sharded_batch` of a batch of one. ``pad_raw``
    reflect-pads by the fov first (decoder graphs: the front pad rounded up
    to their valid-size period and the surplus trimmed after), so the output
    has the volume's own spatial shape. Equal to ``predict_dense_device``'s
    output. Reference: ``inference.py::predict_dense_sharded``."""
    if not pad_raw:
        return predict_dense_sharded_batch(model, vol[None], mesh,
                                           axis_name=axis_name,
                                           batch_axis=None)[0]
    pred = model.prediction_node
    fov = [int(f) for f in pred.shape.fov]
    off = [(f - 1) // 2 for f in fov]
    lo = list(off)
    if _conv_dense_rejection(pred) is None:
        # decoders are shift-equivariant only modulo M: an unrounded front
        # pad would shift every slab's pooling grid
        lo = [-(-o // m) * m for o, m in zip(off, _valid_period(pred, 3))]
    V = [int(s) for s in vol.shape[1:]]
    pads = [p for l, o, f in zip(reversed(lo), reversed(off), reversed(fov))
            for p in (l, f - 1 - o)]
    y = predict_dense_sharded_batch(
        model, F.pad(vol[None], pads, mode="reflect"), mesh,
        axis_name=axis_name, batch_axis=None)[0]
    return y[(slice(None),) + tuple(slice(l - o, l - o + v)
                                    for l, o, v in zip(lo, off, V))]


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


def _sweep_forward(model, batched, mesh=None, axis_name="space",
                   batch_axis="data"):
    """The forward of one chunk of staged slabs, (B, f, *slab) float32 ->
    (B, f_out, *out), or None when ``batched`` and neither whole-volume
    path takes the graph. Per slab (``batched=False``) it is
    :func:`predict_dense_device`, which serves every graph. Under ``mesh``
    the chunk goes through the sharded program instead
    (:func:`predict_dense_sharded_batch`, or per slab
    :func:`predict_dense_sharded`)."""
    from ..ops.conv import f32_convs
    pred = model.prediction_node
    if mesh is not None:
        if batched:
            return lambda x: predict_dense_sharded_batch(
                model, x, mesh, axis_name=axis_name, batch_axis=batch_axis)
        return lambda x: predict_dense_sharded(model, x[0], mesh,
                                               axis_name=axis_name)[None]
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
                  verbose=False, mesh=None, axis_name="space", slab_batch=1,
                  batch_axis="data", timings=None):
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
    otherwise.

    Under a profiler the call is the span ``sweep_knossos``; on the main
    thread ``sweep_knossos.wait_stage`` waits for a chunk's staging,
    ``sweep_knossos.enqueue`` copies it to the card and enqueues its
    forward and read-back, ``sweep_knossos.wait_write`` waits for the
    writer (more than ``WRITE_DEPTH`` chunks behind) and
    ``sweep_knossos.drain`` for the last write-backs; the staging thread's
    ``sweep_knossos.stage`` and the writer's ``sweep_knossos.write`` (after
    the read-back's event) cover what ``timings`` times. Each worker is
    one thread taking chunks in order, so the n-th ``stage`` or ``write``
    span on its thread is chunk n's. The worker threads' spans are
    recorded by a profiler that records every thread
    (``utils.profiling.trace`` does).

    ``slab_batch`` > 1 runs that many slabs per forward through
    ``dilated_dense_forward(batch=True)`` (``convolutional_dense_forward``
    for decoder graphs); the last partial chunk repeats its final slab. A
    batched chunk that runs out of device memory makes the sweep start over
    per slab, with a warning, counted in :data:`sweep_oom_fallbacks`. A
    graph neither batched path takes is swept per slab.

    ``timings``, when a dict, gets per chunk the host seconds of staging
    (``stage_s``, on the staging thread) and of writing into ``out``
    (``write_s``), and the chunk's slab count (``slabs``).

    With ``mesh``, each slab's z extent is split over the mesh axis
    ``axis_name`` (:func:`predict_dense_sharded`: halo exchange); with
    ``slab_batch`` > 1 too, the chunk's slabs are split over ``batch_axis``
    (:func:`predict_dense_sharded_batch`), which must then divide
    ``slab_batch`` (else ``ValueError``); a mesh without that axis sweeps
    slab by slab, with a warning. Every rank stages and writes the whole
    dataset into its own ``out``, which is filled on every rank. Under a
    mesh a chunk that runs out of device memory raises (a rank that went on
    per slab alone would leave the others waiting in a collective).

    Under ``set_compute_dtype('int8')`` without calibrated scales, the
    sweep calibrates them on its first slab (``Model.calibrate_int8``), so
    every slab quantises alike and the sweep equals the whole-volume int8
    output; if that pass runs out of device memory the sweep goes on with
    per-dispatch scales and a warning (any other error reaches the caller).
    """
    with span("sweep_knossos"):
        return _sweep_knossos(model, karr, region, step, out, verbose, mesh,
                              axis_name, slab_batch, batch_axis, timings)


def _sweep_knossos(model, karr, region, step, out, verbose, mesh, axis_name,
                   slab_batch, batch_axis, timings):
    global sweep_oom_fallbacks
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
        with span("sweep_knossos.stage"):
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
        with span("sweep_knossos.write"):
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

    if (model._compute_dtype == "int8" and not model._quant_scales
            and (_dilated_unsupported(pred, model.state) is None
                 or _conv_dense_rejection(pred) is None)):
        logger.info("sweep_knossos: calibrating int8 activation scales on "
                    "the first slab (static scales: no seams)")
        slab = read(origins[0])
        slab = _U8_SCALE[slab] if slab.dtype == np.uint8 else slab
        try:
            model.calibrate_int8(torch.from_numpy(slab).to(dev))
        except torch.cuda.OutOfMemoryError as e:
            msg = f"{type(e).__name__}: {e}"
        else:
            msg = None
        del slab
        if msg is not None:
            torch.cuda.empty_cache()
            logger.warning(f"sweep_knossos: int8 calibration ran out of "
                           f"device memory ({msg[:200]}); sweeping with "
                           "per-dispatch scales")

    def run(B, forward):
        chunks = [origins[i:i + B] for i in range(0, len(origins), B)]
        writes = []      # write-backs in flight, oldest first
        with ThreadPoolExecutor(max_workers=1) as stager, \
                ThreadPoolExecutor(max_workers=1) as writer:
            fut = stager.submit(stage, chunks[0], B)
            for ci, chunk in enumerate(chunks):
                with span("sweep_knossos.wait_stage"):
                    buf = fut.result()
                if ci + 1 < len(chunks):
                    fut = stager.submit(stage, chunks[ci + 1], B)
                with span("sweep_knossos.enqueue"):
                    x = buf.to(dev, non_blocking=True)
                    x = lut[x.int()] if x.dtype == torch.uint8 else x
                    pending = readback(forward(x), chunk)
                    del x
                # the card may run WRITE_DEPTH chunks ahead of the writer: a
                # write-back that first touches the pages of ``out`` takes
                # longer than a slab computes
                if len(writes) >= WRITE_DEPTH:
                    with span("sweep_knossos.wait_write"):
                        writes.pop(0).result()
                writes.append(writer.submit(write_back, pending))
            with span("sweep_knossos.drain"):
                for w in writes:
                    w.result()

    use_batch = slab_batch > 1
    if use_batch and mesh is not None:
        names = tuple(mesh.mesh_dim_names or ())
        if batch_axis not in names:
            logger.warning(
                f"sweep_knossos: slab_batch under a mesh needs a "
                f"{batch_axis!r} mesh axis (have {names}) — falling back to "
                f"per-slab z-sharded sweeps")
            use_batch = False
        elif slab_batch % mesh.size(names.index(batch_axis)):
            raise ValueError(
                f"slab_batch={slab_batch} must be a multiple of mesh axis "
                f"{batch_axis!r}={mesh.size(names.index(batch_axis))}")
    forward = _sweep_forward(model, use_batch, mesh, axis_name, batch_axis)
    if use_batch and forward is None:
        logger.warning("sweep_knossos: neither batched path takes this "
                       "graph — sweeping per slab")
    if use_batch and forward is not None:
        try:
            run(int(slab_batch), forward)
            return out
        except torch.cuda.OutOfMemoryError:
            if mesh is not None:
                raise
            # slab_batch multiplies activation memory; writes are
            # idempotent, so sweep everything again per slab
            sweep_oom_fallbacks += 1
            torch.cuda.empty_cache()
            logger.warning(
                f"sweep_knossos: slab_batch={slab_batch} exhausted device "
                f"memory — falling back to per-slab sweeps (use a smaller "
                f"step= or slab_batch for batched serving)")
        except UnsupportedGraphError:
            logger.warning("sweep_knossos: graph unsupported by the "
                           "dilated batch path — falling back to per-slab")
    run(1, _sweep_forward(model, False, mesh, axis_name))
    return out


# ------------------------------------------------------------ serving tune

#: default slab sizes of :func:`tune_sweep` for 3-D graphs, the JAX
#: package's list: the sweep's defaults and larger slabs
DEFAULT_TUNE_STEPS_3D = ((64, 384, 384), (96, 512, 512), (112, 496, 496),
                         (128, 512, 512))


def _largest_map(model, path, ext, sb):
    """Elements of the largest activation map (a Conv's output before its
    pool included) of one forward over ``sb`` staged slabs of spatial
    extent ``ext`` on ``path`` ('dilated' or 'convdense'), from the shapes
    alone; a skip merge that ``skipsum`` never builds is not counted. On
    the dilated path under ``ztap='concat'`` or ``'fatn'`` the map a kz>1
    conv builds (its taps concatenated into channels, or its Cout*kz
    channels before the taps are added) counts too, whole, though the
    port runs it in z-chunks under 2^31 elements."""
    from .neural import Conv, Pool
    from .node_basic import Concat, Input
    pred = model.prediction_node
    big = 0
    if path == "convdense":
        N = conv_dense_extent(model, list(ext))[0]
        shapes = conv_dense_shapes(pred, N)
        ctx = _convdense_ctx(model, {})
        for node in pred.all_parents():
            if node.children and all(isinstance(c, Conv) and
                                     c._fuses_merge(ctx)
                                     for c in node.children):
                continue
            f = node.shape["f"] if "f" in node.shape.tags else 1
            big = max(big, f * math.prod(shapes[node.name]))
            if isinstance(node, Conv):
                pre = [v - k + 1 for v, k in zip(shapes[node.parents[0].name],
                                                 node.filter_shape)]
                big = max(big, node.n_f * math.prod(pre))
        return sb * big
    ext_of, dil_of, ch_of = {}, {}, {}
    for node in pred.all_parents():
        if isinstance(node, Input):
            e, d = list(ext), [1] * len(ext)
            c = node.shape["f"]
        else:
            p = node.parents[0].name
            e, d, c = list(ext_of[p]), list(dil_of[p]), ch_of[p]
            if isinstance(node, Conv):
                kz = node.filter_shape[0] if len(ext) == 3 else 1
                ein = e
                e = [v - a * (k - 1) for v, a, k in zip(e, d,
                                                         node.filter_shape)]
                big = max(big, node.n_f * math.prod(e))
                if kz > 1 and model._dilated_ztap == "concat":
                    big = max(big, kz * c * e[0] * ein[1] * ein[2])
                elif kz > 1 and model._dilated_ztap == "fatn":
                    big = max(big, kz * node.n_f * ein[0] * e[1] * e[2])
            if isinstance(node, (Conv, Pool)):
                e = [v - a * (q - 1) for v, a, q in zip(e, d,
                                                         node.pool_shape)]
                d = [a * q for a, q in zip(d, node.pool_shape)]
            if isinstance(node, Concat):
                c = sum(ch_of[q.name] for q in node.parents)
            elif "f" in node.shape.tags:
                c = node.shape["f"]
        ext_of[node.name], dil_of[node.name], ch_of[node.name] = e, d, c
        big = max(big, c * math.prod(e))
    return sb * big


def _free_device(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _timed_dispatches(fn, vol, K):
    """Two warm-ups, then ``K`` dispatches of ``fn(vol)`` whose sums add up
    on the device, closed by one sync (reading the checksum). Returns
    (checksum, seconds of the K dispatches)."""
    for _ in range(2):               # the first dispatch after a change of
        float(fn(vol).sum())         # mode carries one-off costs
    t0 = time.perf_counter()
    acc = None
    for _ in range(K):
        s = fn(vol).float().sum()
        acc = s if acc is None else acc + s
    checksum = float(acc)
    return checksum, time.perf_counter() - t0


def _tune_measure_grid(model, steps, halo, slab_batches, K, configs,
                       apply_cfg, make_fn, row_tag, log_prefix, verbose,
                       path):
    """The protocol of both :func:`tune_sweep` legs. Per step and slab
    batch: a staging volume of uniform values from a seeded generator on
    the model's device (``sb`` slabs of the step plus its halo), then per
    contender: its settings applied, two warm-ups, ``K`` dispatches of the
    forward ``sweep_knossos`` runs at that slab batch, one sync. Each row
    carries the largest activation map in elements (``largest_map``) and
    whether it passes 2^31 (``past_2_31``: cuDNN leaves its int32 kernels
    there).

    Only two failures become a row (``failed``): the device running out of
    memory, and a non-finite checksum from a bf16, float16 or int8
    contender. A contender whose lowering cannot take the graph
    (``UnsupportedGraphError``) ends the grid, as in the JAX package: the
    second value returned is then True. Anything else, a K1 launch error
    or a non-finite float32 result included, reaches the caller.
    Returns (rows, stopped). Reference: ``inference.py::
    _tune_measure_grid``, which makes a row of every other exception."""
    dev = model.device
    f_in = int(model.input_node.shape["f"])
    table = []
    for step in steps:
        ext = tuple(s + h for s, h in zip(step, halo))
        for sb in slab_batches:
            sb = max(1, int(sb))
            big = _largest_map(model, path, ext, sb)
            where = dict(slab_batch=sb, step=step, largest_map=big,
                         past_2_31=big > INT32_ELEMENTS)
            failed = None
            try:
                gen = torch.Generator(dev).manual_seed(0)
                vol = torch.rand((sb, f_in) + ext, generator=gen, device=dev)
            except torch.cuda.OutOfMemoryError as e:
                failed = f"staging: out of memory: {e}"[:200]
            if failed is not None:
                _free_device(dev)
                table.append(dict(where, failed=failed))
                continue
            for cfg in configs:
                row = dict(cfg, **where)
                failed = oom = None
                try:
                    apply_cfg(cfg)
                    checksum, dt = _timed_dispatches(make_fn(cfg, sb), vol,
                                                     K)
                    if not math.isfinite(checksum):
                        if cfg["dtype"] is None:
                            raise FloatingPointError(
                                f"{log_prefix}: non-finite checksum "
                                f"({checksum}) from the float32 contender "
                                f"{row_tag(cfg)} at {where}")
                        failed = f"non-finite checksum ({checksum})"
                except torch.cuda.OutOfMemoryError as e:
                    failed = oom = f"out of memory: {e}"[:200]
                except UnsupportedGraphError:
                    return table, True
                if oom is not None:       # the traceback's tensors are gone
                    _free_device(dev)
                if failed is not None:
                    row["failed"] = failed
                    table.append(row)
                    continue
                row["mvox_s"] = math.prod(step) * sb * K / dt / 1e6
                table.append(row)
                if verbose:
                    logger.info(f"{log_prefix}: {row_tag(cfg)} slab_batch="
                                f"{sb} step={step}: {row['mvox_s']:.2f} "
                                "Mvox/s")
            del vol
            _free_device(dev)
    return table, False


def _tune_sweep_convdense(model, steps, halo, slab_batches=(1, 2), K=4,
                          include_bf16=True, include_int8=True,
                          lowerings=None, apply=False, verbose=True):
    """:func:`tune_sweep`'s leg for decoder graphs: the conv-dense
    contenders (``Model.set_convdense_impl`` upconv, zfold and K1 x
    precision), the JAX package's grid whole: dilate, dilate+zfold,
    d2s+zfold, d2s+zfold+ptail, d2s+zfold bf16, dilate int8 (act).
    ``lowerings``: (upconv, zfold, dtype[, act[, ptail]]) tuples. Every
    contender keeps the model's ``poolslice`` and ``skipsum``. Reference:
    ``inference.py::_tune_sweep_convdense``."""
    keep = dict(poolslice=model._convdense_poolslice,
                skipsum=model._convdense_skipsum)

    def _cfg(upconv, zfold, dtype, act=False, ptail=False):
        return {"path": "convdense", "upconv": upconv, "zfold": bool(zfold),
                "dtype": dtype, "act": bool(act), "ptail": ptail, **keep}

    if lowerings is None:
        configs = [_cfg("dilate", False, None), _cfg("dilate", True, None),
                   _cfg("d2s", True, None), _cfg("d2s", True, None,
                                                 ptail=True)]
        if include_bf16:
            configs += [_cfg("d2s", True, "bfloat16")]
        if include_int8:
            configs += [_cfg("dilate", False, "int8", act=True)]
    else:
        configs = [_cfg(*low) for low in lowerings]
    saved = _cfg(model._convdense_upconv, model._convdense_zfold,
                 model._compute_dtype, act=model._compute_act,
                 ptail=model._convdense_ptail)
    saved_scales = model._quant_scales
    if saved not in configs:
        configs.insert(0, saved)

    def _apply_cfg(cfg, with_scales=False):
        # contenders measure int8 with per-dispatch scales; restore and
        # apply put the user's calibration back (same weights, same graph)
        model.set_compute_dtype(None)
        model.set_convdense_impl(cfg["upconv"], zfold=cfg["zfold"],
                                 ptail=cfg["ptail"],
                                 poolslice=cfg["poolslice"],
                                 skipsum=cfg["skipsum"])
        model.set_compute_dtype(cfg["dtype"], activations=cfg["act"])
        if with_scales and cfg["dtype"] == "int8":
            model._quant_scales = saved_scales

    def _tag(cfg):
        return (f"upconv={cfg['upconv']}"
                f"{'+zfold' if cfg['zfold'] else ''}"
                f"{'+ptail' if cfg['ptail'] else ''}"
                f"{'+' + cfg['dtype'] if cfg['dtype'] else ''}"
                f"{'+act' if cfg['act'] else ''}")

    try:
        table, stopped = _tune_measure_grid(
            model, steps, halo, slab_batches, K, configs, _apply_cfg,
            lambda cfg, sb: _sweep_forward(model, sb > 1), _tag,
            "tune_sweep[convdense]", verbose, "convdense")
    finally:
        _apply_cfg(saved, with_scales=True)
    return _tune_result(table, stopped, apply, _apply_cfg,
                        "tune_sweep[convdense]", verbose)


def _tune_result(table, stopped, apply, apply_cfg, log_prefix, verbose):
    if stopped:
        if verbose:
            logger.info(f"{log_prefix}: graph unsupported by a contender's "
                        "lowering — nothing to tune (the tiled fallback "
                        "has no lowering knobs)")
        return {"best": None, "table": table}
    ok = [r for r in table if "mvox_s" in r]
    if not ok:
        return {"best": None, "table": table}
    best = max(ok, key=lambda r: r["mvox_s"])
    if apply:
        apply_cfg(best, with_scales=True)
    if verbose:
        logger.info(f"{log_prefix}: best {best}")
    return {"best": best, "table": table}


def tune_sweep(model, steps=None, slab_batches=(1, 2), K=4,
               include_bf16=True, include_int8=True, lowerings=None,
               apply=False, verbose=True):
    """Autotune the serving configuration of KNOSSOS sweeps on this device.

    Measures every contender with the sustained-dispatch protocol of
    :func:`_tune_measure_grid` (``K`` back-to-back forwards as
    ``sweep_knossos`` dispatches them at each slab batch, one sync) over
    each slab size of ``steps``, and returns the fastest. ``steps``
    (default :data:`DEFAULT_TUNE_STEPS_3D` for 3-D graphs) are rounded up
    to the valid-size period M and staged with the M-aligned halo, as the
    sweep stages them. The model's own serving configuration always
    competes, so ``apply=True`` (leave the winner applied; otherwise the
    settings are restored, the int8 calibration kept) never leaves the
    model slower than it was, as measured.

    The dilated grid is the JAX package's, six contenders in its order:
    direct, s2bg, direct + zfold + K1 (``pallas_tail``), s2bg bf16, s2bg +
    zfold bf16, and s2bg + zfold int8 with ``activations=True``; every
    contender carries the whole knob set (``ztap``, ``zmajor``,
    ``poolslice`` at their defaults), and the incumbent competes with its
    own. ``lowerings`` gives others as (impl, zfold, dtype[, ztap, zmajor,
    poolslice, act, ptail]) tuples. ``include_bf16`` / ``include_int8``
    drop the lossy contenders. A contender whose lowering cannot take the
    graph (``UnsupportedGraphError``) ends the tune with ``best`` None, as
    in the JAX package.

    Decoder (UpConv) graphs take the conv-dense leg
    (:func:`_tune_sweep_convdense`; ``best["path"] == "convdense"``). A
    graph that only the tiled fallback serves has no lowering to tune:
    ``best`` is None. Returns ``{"best": row, "table": [rows]}``; a row
    holds the contender's settings, ``slab_batch``, ``step``,
    ``largest_map``, ``past_2_31`` and ``mvox_s`` (output voxels a second)
    or ``failed``. Reference: ``inference.py::tune_sweep``.
    """
    pred = model.prediction_node
    fov = [int(f) for f in pred.shape.fov]
    if steps is None:
        steps = (list(DEFAULT_TUNE_STEPS_3D) if len(fov) == 3
                 else [(256,) * len(fov), (512,) * len(fov)])
    steps = [tuple(int(v) for v in s) for s in steps]
    for s in steps:
        if len(s) != len(fov):
            raise ValueError(f"step {s} has {len(s)} dims; the model "
                             f"graph has {len(fov)} spatial dims")
    M = _valid_period(pred, len(fov))
    steps = list(dict.fromkeys(
        tuple(-(-v // m) * m for v, m in zip(s, M)) for s in steps))
    halo = [-(-((f - 1) // 2) // m) * m + (f - 1 - (f - 1) // 2)
            for f, m in zip(fov, M)]
    if _dilated_unsupported(pred, model.state) is not None:
        if _conv_dense_rejection(pred) is None:
            return _tune_sweep_convdense(
                model, steps, halo, slab_batches=slab_batches, K=K,
                include_bf16=include_bf16, include_int8=include_int8,
                lowerings=lowerings, apply=apply, verbose=verbose)
        if verbose:
            logger.info("tune_sweep: only the tiled fallback serves this "
                        "graph; it has no lowering to tune")
        return {"best": None, "table": []}

    def _cfg(impl, zfold, dtype, ztap=False, zmajor=False, poolslice=False,
             act=False, ptail=False):
        return {"impl": impl, "zfold": bool(zfold), "dtype": dtype,
                "ztap": ztap, "zmajor": bool(zmajor),
                "poolslice": bool(poolslice), "act": bool(act),
                "ptail": (dict(ptail) if isinstance(ptail, dict)
                          else bool(ptail))}

    if lowerings is None:
        configs = [_cfg("direct", False, None), _cfg("s2bg", False, None),
                   _cfg("direct", True, None, ptail=True)]
        if include_bf16:
            configs += [_cfg("s2bg", False, "bfloat16"),
                        _cfg("s2bg", True, "bfloat16")]
        if include_int8:
            configs += [_cfg("s2bg", True, "int8", act=True)]
    else:
        configs = [_cfg(*low) for low in lowerings]
    saved = _cfg(model._dilated_impl, model._dilated_zfold,
                 model._compute_dtype, ztap=model._dilated_ztap,
                 zmajor=model._dilated_zmajor,
                 poolslice=model._dilated_poolslice, act=model._compute_act,
                 ptail=model._dilated_ptail)
    saved_scales = model._quant_scales
    if saved not in configs:
        configs.insert(0, saved)

    def _apply_cfg(cfg, with_scales=False):
        # contenders measure int8 with per-dispatch scales; restore and
        # apply put the user's calibration back (same weights, same graph)
        model.set_compute_dtype(None)
        model.set_dilated_impl(cfg["impl"], zfold=cfg["zfold"],
                               ztap=cfg["ztap"], zmajor=cfg["zmajor"],
                               poolslice=cfg["poolslice"],
                               pallas_tail=cfg["ptail"])
        model.set_compute_dtype(cfg["dtype"], activations=cfg["act"])
        if with_scales and cfg["dtype"] == "int8":
            model._quant_scales = saved_scales

    def _tag(cfg):
        extras = "".join(f"+{k}" for k in ("zfold", "ztap", "zmajor",
                                           "poolslice", "act", "ptail")
                         if cfg[k])
        return (f"{cfg['impl']}{extras}"
                f"{'+' + cfg['dtype'] if cfg['dtype'] else ''}")

    try:
        # the batched dilated forward at every slab batch: at one slab it
        # is what predict_dense_device runs, and a lowering's
        # UnsupportedGraphError reaches the grid instead of the tiled path
        table, stopped = _tune_measure_grid(
            model, steps, halo, slab_batches, K, configs, _apply_cfg,
            lambda cfg, sb: _sweep_forward(model, True), _tag,
            "tune_sweep", verbose, "dilated")
    finally:
        _apply_cfg(saved, with_scales=True)
    return _tune_result(table, stopped, apply, _apply_cfg, "tune_sweep",
                        verbose)
