"""Neural layer nodes: dense, convolution, pooling, decoder nodes, fragment
restitching, recurrent cells.

Port of ``Perceptron``, ``Conv``, ``Pool``, ``UpConv``, ``Crop``, ``Pad``,
``Dropout``, ``BatchNorm``, ``LRN``, ``FaithlessMerge``,
``FragmentsToDense``, ``GRU`` and ``LSTM`` in
``elektronn2_tpu/neuromancer/neural.py``
(reference: ``elektronn2/neuromancer/neural.py``). Semantics are the JAX
package's: valid-mode convs, conv -> +b -> pool/MFP -> batch norm ->
activation -> dropout, MFP valid-size arithmetic (see ops/mfp.py and
utils/cnncalculator.py).

Batch norm's running statistics are the model's aux state
(``Model.state``): a training step normalises by the batch's statistics
and writes their moving average back in place (``Model._train_step``), an
evaluation uses the running statistics, or the batch's where the node has
none yet. Dropout is split into a draw (the mask, from the step's
generator, :func:`dropout_mask`) and a map (:func:`dropout_map`), so a
caller can feed the mask (``TraceCtx.noise_in``).

The conv-dense serving lowerings of ``Model.set_convdense_impl`` (zfold,
d2s, poolslice, skipsum and K1 on eligible convs) are chosen per node from
the flags of the ``TraceCtx``; every other evaluation leaves them off. So
are the serving precisions: Conv operands in ``ctx.compute_dtype`` (bf16 or
float16, the sums' result cast back to float32 before the bias and the
epilogue; UpConv stays float32, as in the JAX package), and int8 through
``ops.conv.quantized_conv`` for Conv and UpConv under
``ctx.quant_serving``.

The dense and recurrent matmuls are ``torch.matmul`` (cuBLAS on the card),
as the JAX package leaves them to XLA. Under ``ctx.compute_dtype`` their
operands and product are in that type, cast to float32 before the bias;
the recurrent state stays float32.
"""

from __future__ import annotations

import numpy as np
import torch

from .graphmanager import register_node_class
from .graphutils import TaggedShape
from .node_basic import Node
from .variables import init_bias, init_weight
from ..ops.activations import get_activation, validate_activation
from ..ops.conv import (absmax, apply_activation, conv as ops_conv,
                        conv_zfold2d, dot as ops_dot, pooling as ops_pooling,
                        pooling_slices, quantized_conv, upconv, upconv_d2s)
from ..ops.mfp import fragmentpool, fragments2dense, mfp_offsets_product
from ..ops.tailconv import conv3x3_dilated
from ..utils.profiling import POOL_SPAN, span


def _maxout_factor(activation_func):
    if isinstance(activation_func, str) and activation_func.startswith("maxout"):
        return int(activation_func.split(":")[1]) if ":" in activation_func else 2
    return 1


def dropout_mask(gen, shape, keep, device):
    """The draw of inverted dropout: a boolean mask, True with probability
    ``keep``, from the generator ``gen``."""
    return torch.rand(shape, generator=gen, device=device) < keep


def dropout_map(x, mask, keep):
    """The map of inverted dropout: ``x / keep`` where ``mask``, else 0."""
    return torch.where(mask, x / keep, 0.0)


def _apply_dropout(x, rate, ctx, node):
    """Inverted elementwise dropout, active only in training mode and with
    a random stream (or a fed mask). Reference: ``neural.py::
    _apply_dropout``."""
    if not rate or not ctx.train:
        return x
    keep = 1.0 - rate
    mask = ctx.draw(node, lambda g, shape: dropout_mask(g, shape, keep,
                                                        x.device), x.shape)
    return x if mask is None else dropout_map(x, mask, keep)


class _BNMixin:
    """Batch norm shared by ``Perceptron``, ``Conv`` and ``BatchNorm``.

    Training: the batch's mean and biased variance over every axis but the
    features, and the running statistics move to ``0.99 * old + 0.01 *
    batch`` (from zeros and ones where the node has none yet). Evaluation:
    the running statistics, or the batch's where there are none. eps 1e-5.
    Under a data-parallel step (``ctx.dp``) the moments are the global
    batch's: the sum and then the sum of squared deviations are summed over
    the group by a differentiable all-reduce, so forward and backward are
    the unsharded step's, as GSPMD takes them in the JAX package.
    Reference: ``neural.py::_BNMixin``."""

    BN_MOMENTUM = 0.99

    def _init_bn(self, n_f):
        self.register_param("bn_gamma", torch.ones(n_f))
        self.register_param("bn_beta", torch.zeros(n_f))
        self._bn_nf = n_f

    def _fresh_bn_state(self, device):
        return {"mean": torch.zeros(self._bn_nf, device=device),
                "var": torch.ones(self._bn_nf, device=device)}

    def _apply_bn(self, x, ctx, f_axis=1):
        shape = [1] * x.ndim
        shape[f_axis] = self._bn_nf
        gamma = ctx.param(self, "bn_gamma").reshape(shape)
        beta = ctx.param(self, "bn_beta").reshape(shape)
        st = ctx.state(self)
        if ctx.train or st is None:
            red = tuple(i for i in range(x.ndim) if i != f_axis)
            if ctx.dp is not None and ctx.train:
                n = x.numel() // self._bn_nf * ctx.dp.world
                mean = ctx.dp.sum_(torch.sum(x, dim=red)) / n
                dev = x - mean.reshape(shape)
                var = ctx.dp.sum_(torch.sum(dev * dev, dim=red)) / n
            else:
                mean = torch.mean(x, dim=red)
                var = torch.var(x, dim=red, correction=0)
            if st is None:
                st = self._fresh_bn_state(x.device)
            m = self.BN_MOMENTUM
            ctx.set_state(self, {
                "mean": m * st["mean"] + (1 - m) * mean.detach(),
                "var": m * st["var"] + (1 - m) * var.detach()})
        else:
            mean, var = st["mean"], st["var"]
            ctx.set_state(self, st)
        xn = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                     + 1e-5)
        return gamma * xn + beta


def _validate_cell_activation(name):
    """Recurrent cells need plain elementwise activations."""
    validate_activation(name)
    if isinstance(name, str) and (name.startswith("maxout")
                                  or name == "prelu"):
        raise ValueError(f"{name!r} is not usable inside GRU/LSTM cells")
    return name


def _alpha(node, ctx):
    """prelu's per-channel slope, or None for another activation."""
    return ctx.param(node, "alpha") if "alpha" in node.params else None


def _record_absmax(ctx, node, x):
    """The int8 calibration pass (``ctx.quant_calibrate``): record the max-abs
    of the node's input, a host sync by design."""
    if ctx.quant_calibrate is not None:
        ctx.quant_calibrate[node.name] = float(absmax(x))


def _scale(ctx, node):
    """The node's calibrated activation max-abs, or None (dynamic)."""
    return (ctx.quant_scales or {}).get(node.name)


def _tp_join(node, ctx, y, tp, f_axis, post):
    """Tensor parallelism (``ctx.tp_of``): ``y`` is this rank's slice of
    ``node``'s output channels along ``f_axis``, bias and pool applied. A
    channel-local activation runs on the slice before the channels are
    joined over the group; batch norm, prelu, maxout and dropout run after
    it (``post``), on the whole channels."""
    local = (not getattr(node, "batch_normalisation", False)
             and "alpha" not in node.params
             and _maxout_factor(node.activation_func) == 1
             and not getattr(node, "dropout_rate", 0))
    if local:
        return tp.gather(apply_activation(y, node.activation_func,
                                          axis=f_axis), f_axis)
    return post(ctx, tp.gather(y, f_axis))


def _norm_spatial(v, nsp, what):
    if np.isscalar(v):
        return (int(v),) * nsp
    v = tuple(int(x) for x in v)
    if len(v) != nsp:
        raise ValueError(f"{what} {v} does not match spatial rank {nsp}")
    return v


@register_node_class
class Perceptron(Node, _BNMixin):
    """Fully-connected layer over the feature axis.

    Reference: ``neural.py::Perceptron`` (alias ``Dot``). With
    ``flatten=True`` every axis but the batch is folded into the features
    first (the classic MLP head); otherwise the transform applies at each
    position along the other axes. ``w`` is ``(f_in, n_f)``.
    """

    def __init__(self, parent, n_f, activation_func="relu", flatten=False,
                 batch_normalisation=False, dropout_rate=0, w=None, b=None,
                 name="dot", print_repr=True):
        super().__init__(parent, name, print_repr)
        self.n_f = int(n_f)
        self.activation_func = validate_activation(activation_func)
        self.flatten = bool(flatten)
        self.batch_normalisation = bool(batch_normalisation)
        self.dropout_rate = float(dropout_rate)

        ps = parent.shape
        if self.flatten:
            f_in = int(np.prod([s for t, s in zip(ps.tags, ps.shape)
                                if t != "b"]))
            self.shape = TaggedShape((ps["b"], self.n_f), ("b", "f"))
        else:
            f_in = ps["f"]
            self.shape = ps.updateshape("f", self.n_f)
        self._f_ax = None if self.flatten else ps.tag2index("f")
        k = _maxout_factor(activation_func)
        if k > 1:
            self.shape = self.shape.updateshape("f", self.n_f // k)
        rng = self._gm.init_rng()
        w = w if w is not None else init_weight(rng, (f_in, self.n_f),
                                                activation_func)
        b = b if b is not None else init_bias(self.n_f, activation_func)
        self.register_param("w", w)
        self.register_param("b", b, wd_mult=0.0)
        if activation_func == "prelu":
            self.register_param("alpha", torch.full((self.n_f,), 0.25),
                                wd_mult=0.0)
        if self.batch_normalisation:
            self._init_bn(self.n_f)          # before the activation

    def _compute(self, ctx, x):
        if self.flatten:
            x = x.reshape(x.shape[0], -1)
        w = ctx.param(self, "w")
        b = ctx.param(self, "b")
        tp = ctx.tp_of(self)
        if tp is not None:            # w (f_in, n_f / world): column slice
            x = tp.enter(x)
        # mixed precision: the operands and the product in ``cd`` (as
        # ``preferred_element_type=xm.dtype`` in the JAX package), cast to
        # float32 before the bias, batch norm and the activation
        cd = ctx.compute_dtype
        xm = x.to(cd) if cd is not None else x
        if x.ndim == 2 or self._f_ax == x.ndim - 1:
            y = torch.matmul(xm, w.to(xm.dtype))
        else:
            ax = 1 if self._f_ax is None else self._f_ax
            y = ops_dot(xm, w, axis=ax)
            b = b.reshape((1,) * ax + (-1,) + (1,) * (x.ndim - ax - 1))
        y = (y.float() if cd is not None else y) + b
        f_ax = 1 if self.flatten else self._f_ax
        if tp is not None:
            return _tp_join(self, ctx, y, tp, f_ax,
                            lambda c, v: self._post(c, v, f_ax))
        return self._post(ctx, y, f_ax)

    def _post(self, ctx, y, f_ax):
        """Batch norm, the activation and dropout."""
        if self.batch_normalisation:
            y = self._apply_bn(y, ctx, f_axis=f_ax)
        y = apply_activation(y, self.activation_func,
                             alpha=_alpha(self, ctx), axis=f_ax)
        return _apply_dropout(y, self.dropout_rate, ctx, self)


Dot = Perceptron  # reference alias


@register_node_class
class Conv(Node, _BNMixin):
    """Valid-mode N-D convolution with optional fused pooling / MFP.

    Reference: ``neural.py::Conv`` — conv (+bias) → max-pool (plain or MFP)
    → batch norm → activation (maxout, prelu included) → dropout. With
    ``mfp=True`` the pooling evaluates all pool-offset fragments and stacks
    them into the batch axis (see ops/mfp.py); the TaggedShape tracks
    fragment offsets so ``FragmentsToDense`` and the dense path can stitch a
    full-resolution map.
    """

    def __init__(self, parent, n_f, filter_shape, pool_shape=None,
                 activation_func="relu", mfp=False,
                 batch_normalisation=False, dropout_rate=0, w=None, b=None,
                 name="conv", print_repr=True):
        super().__init__(parent, name, print_repr)
        ps = parent.shape
        nsp = len(ps.spatial_axes)
        if nsp == 0:
            raise ValueError("Conv requires spatial axes")
        self.n_f = int(n_f)
        self.filter_shape = _norm_spatial(filter_shape, nsp, "filter_shape")
        self.pool_shape = _norm_spatial(pool_shape if pool_shape is not None
                                        else 1, nsp, "pool_shape")
        self.activation_func = validate_activation(activation_func)
        self.mfp = bool(mfp)
        self.batch_normalisation = bool(batch_normalisation)
        self.dropout_rate = float(dropout_rate)

        # ---- shape propagation (the cnncalculator arithmetic) ----
        sp = list(ps.spatial_shape)
        strides = list(ps.strides)
        fov = list(ps.fov)
        offsets = ps.mfp_offsets
        batch = ps["b"]
        for d, (f, p) in enumerate(zip(self.filter_shape, self.pool_shape)):
            o = sp[d] - f + 1
            if o < 1:
                raise ValueError(
                    f"{self.name}: spatial dim {d} too small for filter "
                    f"{f} (size {sp[d]})")
            fov[d] += (f - 1) * strides[d]
            if p > 1:
                if self.mfp:
                    if (o + 1) % p:
                        raise ValueError(
                            f"{self.name}: MFP pool {p} needs size ≡ p-1 "
                            f"(mod p) in dim {d}, got {o}; use "
                            "utils.cnncalculator to pick a valid patch size")
                    o = (o + 1) // p - 1
                else:
                    if o % p:
                        raise ValueError(
                            f"{self.name}: pool {p} does not divide size {o} "
                            f"in dim {d}; use utils.cnncalculator")
                    o //= p
                fov[d] += (p - 1) * strides[d]
            sp[d] = o
        self._pre_pool_strides = tuple(strides)
        if self.mfp and any(p > 1 for p in self.pool_shape):
            offsets = np.concatenate(
                [offsets + np.asarray(dvec) * np.asarray(strides)
                 for dvec in mfp_offsets_product(self.pool_shape)], axis=0)
            batch = batch * int(np.prod(self.pool_shape))
        strides = [s * p for s, p in zip(strides, self.pool_shape)]

        out_f = self.n_f // _maxout_factor(activation_func)
        shape = list(ps.shape)
        shape[ps.tag2index("b")] = batch
        shape[ps.tag2index("f")] = out_f
        for ax, s in zip(ps.spatial_axes, sp):
            shape[ax] = s
        self.shape = TaggedShape(shape, ps.tags, strides, fov, offsets)

        rng = self._gm.init_rng()
        wshape = (self.n_f, ps["f"]) + self.filter_shape
        w = w if w is not None else init_weight(rng, wshape, activation_func)
        b = b if b is not None else init_bias(self.n_f, activation_func)
        self.register_param("w", w)
        self.register_param("b", b, wd_mult=0.0)
        if activation_func == "prelu":
            self.register_param("alpha", torch.full((out_f,), 0.25),
                                wd_mult=0.0)
        if self.batch_normalisation:
            self._init_bn(self.n_f)          # before the activation
        self._parent_offsets = np.asarray(ps.mfp_offsets)

    def _serving_conv_fn(self, ctx):
        """The conv lowering of this evaluation: ``conv_zfold2d`` for a kz=1
        3D conv under ``Model.set_convdense_impl(zfold=True)`` (the same
        contraction), else the plain conv. Both add the bias."""
        if (ctx.convdense_zfold and len(self.filter_shape) == 3
                and self.filter_shape[0] == 1):
            return conv_zfold2d
        return ops_conv

    def _ptail_eligible(self, ctx):
        """Whether the conv-dense path runs this Conv through K1
        (``Model.set_convdense_impl(ptail=True)``): a (3,3,3) ReLU conv
        without MFP, batch norm or prelu's slope. Max pooling is allowed:
        K1's fused ReLU commutes with a max, ``max(relu(z)) ==
        relu(max(z))``; batch norm sits between the pool and the ReLU, so K1
        would compute another function."""
        return (ctx.convdense_ptail and tuple(self.filter_shape) == (3, 3, 3)
                and self.activation_func == "relu" and not self.mfp
                and not self.batch_normalisation
                and "alpha" not in self.params)

    def _compute(self, ctx, x):
        w, b = ctx.param(self, "w"), ctx.param(self, "b")
        if self._ptail_eligible(ctx):
            y = conv3x3_dilated(x.contiguous(), w, b)    # bias + ReLU fused
            if any(p > 1 for p in self.pool_shape):
                y = self._pool(ctx, y)
            return y
        sp = ctx.halo_axis
        if sp is not None and len(self.filter_shape) == 3 \
                and self.filter_shape[0] > 1:
            # z-sharded training (parallel/spatial_train.py): the filter's
            # z halo from the next ranks; the output keeps z_local rows
            x = sp.halo(x, self.filter_shape[0] - 1)
        tp = ctx.tp_of(self)
        if tp is not None:
            x = tp.enter(x)
        _record_absmax(ctx, self, x)
        cd = ctx.compute_dtype
        if ctx.quant_serving:
            # int8 whole-volume serving: one scale per volume, or the
            # calibrated one (the tiled path never sets the flag: per-tile
            # scales would seam the stitched map)
            y = quantized_conv(x, w, x_absmax=_scale(ctx, self))
            y = y + b.reshape((1, -1) + (1,) * (x.ndim - 2))
        elif cd is not None:
            # mixed precision: operands in ``cd``, float32 accumulation,
            # the bias and the epilogue in float32 (as the JAX package)
            y = self._serving_conv_fn(ctx)(x.to(cd), w.to(cd)).float()
            y = y + b.reshape((1, -1) + (1,) * (x.ndim - 2))
        else:
            y = self._serving_conv_fn(ctx)(x, w, b)
        if tp is not None:
            # tensor parallelism: ``w`` and ``b`` are this rank's shards of
            # the output channels, pooled, then joined over the group
            return _tp_join(self, ctx, self._pool_stage(ctx, y), tp, 1,
                            self._post_pool)
        return self._conv_epilogue(ctx, y)

    def _pool(self, ctx, y):
        with span(POOL_SPAN):
            if ctx.convdense_poolslice:
                return pooling_slices(y, self.pool_shape)
            return ops_pooling(y, self.pool_shape)

    def _pool_stage(self, ctx, y):
        """The pool, plain or MFP's fragment pool (channel by channel)."""
        if any(p > 1 for p in self.pool_shape):
            if self.mfp:
                y, _ = fragmentpool(y, self.pool_shape, self._parent_offsets,
                                    self._pre_pool_strides)
            else:
                y = self._pool(ctx, y)
        return y

    def _conv_epilogue(self, ctx, y):
        """Pool (plain or MFP fragment pool), batch norm, the activation and
        dropout: the tail shared by every conv lowering."""
        return self._post_pool(ctx, self._pool_stage(ctx, y))

    def _post_pool(self, ctx, y):
        """Batch norm, the activation and dropout."""
        if self.batch_normalisation:
            y = self._apply_bn(y, ctx)
        y = apply_activation(y, self.activation_func, alpha=_alpha(self, ctx))
        return _apply_dropout(y, self.dropout_rate, ctx, self)

    def _fuses_merge(self, ctx):
        """Whether this Conv consumes its FaithlessMerge parent's pieces
        (``set_convdense_impl(skipsum=True)``) instead of their concat."""
        return (ctx.convdense_skipsum and not self.mfp
                and ctx.halo_axis is None and ctx.tp_of(self) is None
                and not self.batch_normalisation and not ctx.quant_serving
                and ctx.quant_calibrate is None
                and isinstance(self.parents[0], FaithlessMerge)
                and not self._ptail_eligible(ctx))

    def _compute_fused(self, ctx):
        """Fused-evaluation hook (``TraceCtx.get``): under ``skipsum``,
        ``conv(concat(a, b)) == conv(a, w[:, :Ca]) + conv(b, w[:, Ca:])``
        (a conv is linear in its channels) on the merge's cropped pieces,
        so the skip concat is never built. Returns None to decline.

        Reference: ``neural.py::Conv._compute_fused``.
        """
        if not self._fuses_merge(ctx):
            return None
        p = self.parents[0]
        a, bb = p._cropped_pieces(ctx.get(p.parents[0]),
                                  ctx.get(p.parents[1]))
        w, bias = ctx.param(self, "w"), ctx.param(self, "b")
        ca = int(p.parents[0].shape["f"])
        cfn = self._serving_conv_fn(ctx)
        cd = ctx.compute_dtype
        if cd is not None:
            y = (cfn(a.to(cd), w[:, :ca].to(cd))
                 + cfn(bb.to(cd), w[:, ca:].to(cd))).float()
            y += bias.reshape((1, -1) + (1,) * (a.ndim - 2))
            return self._conv_epilogue(ctx, y)
        y = cfn(a, w[:, :ca], bias)
        y += cfn(bb, w[:, ca:])             # in place: one full map less
        return self._conv_epilogue(ctx, y)


@register_node_class
class Pool(Node):
    """Standalone pooling node (max/avg), optionally MFP.

    Reference: ``neural.py::Pool``.
    """

    def __init__(self, parent, pool_shape, mfp=False, mode="max",
                 name="pool", print_repr=True):
        super().__init__(parent, name, print_repr)
        ps = parent.shape
        nsp = len(ps.spatial_axes)
        self.pool_shape = _norm_spatial(pool_shape, nsp, "pool_shape")
        self.mfp = bool(mfp)
        self.mode = mode

        sp = list(ps.spatial_shape)
        strides = list(ps.strides)
        fov = list(ps.fov)
        offsets = ps.mfp_offsets
        batch = ps["b"]
        for d, p in enumerate(self.pool_shape):
            if p > 1:
                o = sp[d]
                if self.mfp:
                    if (o + 1) % p:
                        raise ValueError(f"{self.name}: invalid MFP size {o} "
                                         f"for pool {p} in dim {d}")
                    sp[d] = (o + 1) // p - 1
                else:
                    if o % p:
                        raise ValueError(f"{self.name}: pool {p} does not "
                                         f"divide {o} in dim {d}")
                    sp[d] = o // p
                fov[d] += (p - 1) * strides[d]
        self._pre_pool_strides = tuple(strides)
        if self.mfp and any(p > 1 for p in self.pool_shape):
            offsets = np.concatenate(
                [offsets + np.asarray(d) * np.asarray(strides)
                 for d in mfp_offsets_product(self.pool_shape)], axis=0)
            batch *= int(np.prod(self.pool_shape))
        strides = [s * p for s, p in zip(strides, self.pool_shape)]
        shape = list(ps.shape)
        shape[ps.tag2index("b")] = batch
        for ax, s in zip(ps.spatial_axes, sp):
            shape[ax] = s
        self.shape = TaggedShape(shape, ps.tags, strides, fov, offsets)
        self._parent_offsets = np.asarray(ps.mfp_offsets)

    def _compute(self, ctx, x):
        if all(p == 1 for p in self.pool_shape):
            return x
        with span(POOL_SPAN):
            if self.mfp:
                y, _ = fragmentpool(x, self.pool_shape, self._parent_offsets,
                                    self._pre_pool_strides, mode=self.mode)
                return y
            return ops_pooling(x, self.pool_shape, mode=self.mode)


@register_node_class
class UpConv(Node):
    """Transposed convolution with kernel = stride = pool_shape.

    Reference: ``neural.py::UpConv``; it inverts a pooling in decoder paths
    (U-Net style). The spatial size multiplies by the pool, the output
    stride divides by it (it must divide).
    """

    def __init__(self, parent, n_f, pool_shape, activation_func="lin",
                 w=None, b=None, name="upconv", print_repr=True):
        super().__init__(parent, name, print_repr)
        ps = parent.shape
        if ps.n_frag > 1:
            raise ValueError("UpConv after MFP pooling is unsupported; "
                             "restitch with FragmentsToDense first")
        self.n_f = int(n_f)
        self.pool_shape = _norm_spatial(pool_shape, len(ps.spatial_axes),
                                        "pool_shape")
        self.activation_func = validate_activation(activation_func)
        strides = []
        for s, p in zip(ps.strides, self.pool_shape):
            if s % p:
                raise ValueError(f"{self.name}: upconv pool {p} does not "
                                 f"divide stride {s}")
            strides.append(s // p)
        shape = list(ps.shape)
        shape[ps.tag2index("f")] = self.n_f
        for ax, s, p in zip(ps.spatial_axes, ps.spatial_shape,
                            self.pool_shape):
            shape[ax] = s * p
        self.shape = TaggedShape(shape, ps.tags, strides, ps.fov,
                                 ps.mfp_offsets)
        rng = self._gm.init_rng()
        wshape = (self.n_f, ps["f"]) + self.pool_shape
        w = w if w is not None else init_weight(rng, wshape, activation_func)
        b = b if b is not None else init_bias(self.n_f, activation_func)
        self.register_param("w", w)
        self.register_param("b", b, wd_mult=0.0)

    def _compute(self, ctx, x):
        w = ctx.param(self, "w")
        _record_absmax(ctx, self, x)
        tp = ctx.tp_of(self)
        if tp is not None:            # w (n_f / world, f_in, *pool)
            x = tp.enter(x)
        if ctx.quant_serving:        # int8 serving (see Conv._compute)
            y = quantized_conv(x, w, conv_fn=upconv,
                               pool_shape=self.pool_shape,
                               x_absmax=_scale(ctx, self))
        else:
            fn = upconv_d2s if ctx.convdense_upconv_d2s else upconv
            y = fn(x, w, self.pool_shape)
        y += ctx.param(self, "b").reshape((1, -1) + (1,) * (x.ndim - 2))
        if tp is not None:
            return _tp_join(self, ctx, y, tp, 1, lambda c, v:
                            apply_activation(v, self.activation_func))
        return apply_activation(y, self.activation_func)


@register_node_class
class Crop(Node):
    """Crop spatial borders: ``crop`` per spatial dim, an int (both sides)
    or a (lo, hi) pair. The amounts are fixed, so it crops any input size.

    Reference: ``neural.py::Crop``.
    """

    def __init__(self, parent, crop, name="crop", print_repr=True):
        super().__init__(parent, name, print_repr)
        ps = parent.shape
        nsp = len(ps.spatial_axes)
        if np.isscalar(crop):
            crop = [(int(crop), int(crop))] * nsp
        else:
            crop = [(int(c), int(c)) if np.isscalar(c)
                    else (int(c[0]), int(c[1])) for c in crop]
        if len(crop) != nsp:
            raise ValueError("crop spec rank mismatch")
        self.crop = crop
        sp = [s - lo - hi for s, (lo, hi) in zip(ps.spatial_shape, crop)]
        if any(s < 1 for s in sp):
            raise ValueError(f"crop {crop} exceeds spatial shape "
                             f"{ps.spatial_shape}")
        # symmetric crops keep the centred-fov bookkeeping exact
        fov = [f + (lo + hi) * st
               for f, (lo, hi), st in zip(ps.fov, crop, ps.strides)]
        shape = list(ps.shape)
        for ax, s in zip(ps.spatial_axes, sp):
            shape[ax] = s
        self.shape = TaggedShape(shape, ps.tags, ps.strides, fov,
                                 ps.mfp_offsets)

    def _compute(self, ctx, x):
        idx = [slice(None)] * x.ndim
        for ax, (lo, hi) in zip(self.parents[0].shape.spatial_axes, self.crop):
            idx[ax] = slice(lo, x.shape[ax] - hi)
        return x[tuple(idx)]


@register_node_class
class Pad(Node):
    """Pad the spatial borders: ``pad`` per spatial dim, an int (both sides)
    or a (lo, hi) pair; ``mode`` is any mode of ``numpy.pad``, with its
    rules, also for pads wider than the extent.

    - ``constant`` (zeros) and ``empty`` (any values; zeros here):
      ``F.pad``.
    - ``edge``, ``reflect``, ``symmetric``, ``wrap``: a gather along each
      spatial axis in turn, with the index vector ``numpy.pad`` makes of
      ``arange(n)`` (so a pad past the extent repeats the reflection or the
      wrap as numpy does). Each index vector is made once per axis, extent
      and device and kept, so a step inside a CUDA graph copies nothing
      from the host.
    - ``maximum``, ``minimum``, ``mean``, ``median`` and ``linear_ramp``
      (to 0): axis by axis in increasing order, each axis's statistic or
      ramp taken over the array padded so far, as numpy and ``jnp.pad`` do.

    Any axis order: the spatial axes need not be last.

    Reference: ``neural.py::Pad`` (``jnp.pad``).
    """

    _INDEX_MODES = ("edge", "reflect", "symmetric", "wrap")
    _STAT_MODES = ("maximum", "minimum", "mean", "median")
    _MODES = ("constant", "empty") + _INDEX_MODES + _STAT_MODES \
        + ("linear_ramp",)

    def __init__(self, parent, pad, mode="constant", name="pad",
                 print_repr=True):
        super().__init__(parent, name, print_repr)
        ps = parent.shape
        nsp = len(ps.spatial_axes)
        if np.isscalar(pad):
            pad = [(int(pad), int(pad))] * nsp
        else:
            pad = [(int(p), int(p)) if np.isscalar(p)
                   else (int(p[0]), int(p[1])) for p in pad]
        self.pad = pad
        self.mode = mode
        self._index = {}          # (axis, extent, pad, device) -> index
        shape = list(ps.shape)
        for ax, s, (lo, hi) in zip(ps.spatial_axes, ps.spatial_shape, pad):
            shape[ax] = s + lo + hi
        self.shape = TaggedShape(shape, ps.tags, ps.strides, ps.fov,
                                 ps.mfp_offsets)

    def _pads(self):
        """(axis, lo, hi) of each padded spatial axis, in increasing axis
        order (numpy's)."""
        return sorted((ax, lo, hi) for ax, (lo, hi) in
                      zip(self.parents[0].shape.spatial_axes, self.pad)
                      if lo or hi)

    def _gather_index(self, ax, n, lo, hi, device):
        key = (ax, n, lo, hi, str(device))
        idx = self._index.get(key)
        if idx is None:
            idx = self._index[key] = torch.as_tensor(
                np.pad(np.arange(n), (lo, hi), mode=self.mode),
                dtype=torch.long, device=device)
        return idx

    def _compute(self, ctx, x):
        mode = self.mode
        if mode not in self._MODES:
            raise ValueError(f"Pad mode {mode!r}: expected one of "
                             f"{sorted(self._MODES)} (numpy.pad's)")
        pads = self._pads()
        if not pads:
            return x
        if mode in ("constant", "empty"):
            first = pads[0][0]
            widths = [0] * (2 * (x.ndim - first))   # F.pad: last axis first
            for ax, lo, hi in pads:
                widths[2 * (x.ndim - 1 - ax)] = lo
                widths[2 * (x.ndim - 1 - ax) + 1] = hi
            return torch.nn.functional.pad(x, widths)
        for ax, lo, hi in pads:
            n = x.shape[ax]
            if mode in self._INDEX_MODES:
                x = x.index_select(ax, self._gather_index(ax, n, lo, hi,
                                                          x.device))
                continue
            if mode == "linear_ramp":
                before = _ramp(x.narrow(ax, 0, 1), lo, ax)
                after = _ramp(x.narrow(ax, n - 1, 1), hi, ax).flip(ax)
            else:
                s = _pad_stat(x, ax, mode)
                before = s.expand(*[lo if i == ax else -1
                                    for i in range(x.ndim)])
                after = s.expand(*[hi if i == ax else -1
                                   for i in range(x.ndim)])
            x = torch.cat([before, x, after], dim=ax)
        return x


def _pad_stat(x, ax, mode):
    """``numpy.pad``'s statistic of ``x`` along ``ax`` (keepdim)."""
    if mode == "maximum":
        return torch.amax(x, dim=ax, keepdim=True)
    if mode == "minimum":
        return torch.amin(x, dim=ax, keepdim=True)
    if mode == "mean":
        return torch.mean(x, dim=ax, keepdim=True)
    # median: at an even extent, the mean of the two middle values
    n = x.shape[ax]
    srt = torch.sort(x, dim=ax).values
    if n % 2:
        return srt.narrow(ax, n // 2, 1)
    return (srt.narrow(ax, n // 2 - 1, 1) + srt.narrow(ax, n // 2, 1)) / 2


def _ramp(edge, num, ax):
    """``jnp.linspace(0, edge, num, endpoint=False, axis=ax)``: the linear
    ramp from 0 to the edge slice ``edge`` (size 1 on ``ax``), computed as
    ``start * (1 - t) + stop * t`` with ``t = i / num``, as there."""
    shape = [1] * edge.ndim
    shape[ax] = num
    t = (torch.arange(num, dtype=edge.dtype, device=edge.device)
         / num).reshape(shape)
    return 0.0 * (1 - t) + edge * t


@register_node_class
class Dropout(Node):
    """Standalone inverted dropout (training mode only).

    Reference: ``neural.py::Dropout``.
    """

    def __init__(self, parent, rate=0.5, name="dropout", print_repr=True):
        super().__init__(parent, name, print_repr)
        self.rate = float(rate)
        self.shape = parent.shape.copy()

    def _compute(self, ctx, x):
        return _apply_dropout(x, self.rate, ctx, self)


@register_node_class
class BatchNorm(Node, _BNMixin):
    """Standalone batch normalisation over the feature axis.

    Reference: ``neural.py::BatchNorm``.
    """

    def __init__(self, parent, name="batchnorm", print_repr=True):
        super().__init__(parent, name, print_repr)
        self.shape = parent.shape.copy()
        self._init_bn(parent.shape["f"])

    def _compute(self, ctx, x):
        return self._apply_bn(x, ctx, f_axis=self.shape.tag2index("f"))


@register_node_class
class LRN(Node):
    """Local response normalisation across the features:
    ``x / (k + alpha * s)**beta``, ``s`` the sum of ``x**2`` over a window of
    ``size`` channels centred on each (zero outside).

    Reference: ``neural.py::LRN``.
    """

    def __init__(self, parent, size=5, alpha=1e-4, beta=0.75, k=2.0,
                 name="lrn", print_repr=True):
        super().__init__(parent, name, print_repr)
        self.size, self.alpha, self.beta, self.k = int(size), alpha, beta, k
        self.shape = parent.shape.copy()

    def _compute(self, ctx, x):
        half = self.size // 2
        sq = torch.nn.functional.pad(
            (x * x).transpose(1, -1), (half, half)).transpose(1, -1)
        s = sq.unfold(1, self.size, 1).sum(-1)
        return x / torch.pow(self.k + self.alpha * s, self.beta)


@register_node_class
class FaithlessMerge(Node):
    """Concat features after centre-cropping both parents to their common
    spatial shape ("faithless" about alignment).

    Reference: ``neural.py::FaithlessMerge``. The crop is taken from the
    shapes of the values at run time, never from the construction-time
    patch: the conv-dense path runs the graph on whole volumes.
    """

    def __init__(self, hard_features, soft_features, name="faithless_merge",
                 print_repr=True):
        super().__init__([hard_features, soft_features], name, print_repr)
        s1, s2 = hard_features.shape, soft_features.shape
        if s1.tags != s2.tags:
            raise ValueError("FaithlessMerge parents must share tags")
        shape = list(s1.shape)
        shape[s1.tag2index("f")] = s1["f"] + s2["f"]
        for ax, a, b in zip(s1.spatial_axes, s1.spatial_shape,
                            s2.spatial_shape):
            shape[ax] = min(a, b)
        self.shape = TaggedShape(shape, s1.tags, s1.strides, s1.fov,
                                 s1.mfp_offsets)

    def _cropped_pieces(self, a, b):
        """Both parents' values centre-cropped to their common run-time
        spatial shape (views). Shared by ``_compute`` and the ``skipsum``
        lowering (``Conv._compute_fused``)."""
        ax_a = self.parents[0].shape.spatial_axes
        ax_b = self.parents[1].shape.spatial_axes
        common = [min(a.shape[i], b.shape[j]) for i, j in zip(ax_a, ax_b)]

        def crop_to(x, sp_axes):
            idx = [slice(None)] * x.ndim
            for ax, c in zip(sp_axes, common):
                lo = (x.shape[ax] - c) // 2
                idx[ax] = slice(lo, lo + c)
            return x[tuple(idx)]
        return crop_to(a, ax_a), crop_to(b, ax_b)

    def _compute(self, ctx, a, b):
        return torch.cat(self._cropped_pieces(a, b),
                         dim=self.shape.tag2index("f"))


@register_node_class
class FragmentsToDense(Node):
    """Restitch MFP fragments into a dense full-resolution map.

    Reference: ``neural.py::FragmentsToDense`` (via
    ``computations.fragments2dense``).
    """

    def __init__(self, parent, name="fragments_to_dense", print_repr=True):
        super().__init__(parent, name, print_repr)
        ps = parent.shape
        if ps.n_frag == 1:
            self.shape = ps.copy()
            self._n_off = (1,) * len(ps.spatial_axes)
            return
        from ..ops.mfp import _interleave_geometry
        g, n_off, _ = _interleave_geometry(ps.mfp_offsets)
        self._n_off = tuple(n_off)
        shape = list(ps.shape)
        shape[ps.tag2index("b")] = ps["b"] // ps.n_frag
        for ax, s, n in zip(ps.spatial_axes, ps.spatial_shape, n_off):
            shape[ax] = s * n
        strides = [st // n for st, n in zip(ps.strides, n_off)]
        self.shape = TaggedShape(shape, ps.tags, strides, ps.fov)

    def _compute(self, ctx, x):
        return fragments2dense(x, self.parents[0].shape.mfp_offsets)


# --------------------------------------------------------------- recurrent

def _cell_matmul(ctx, a, w):
    """A recurrent cell's fused-gate matmul: under ``ctx.compute_dtype`` the
    operands and the product in that type, the result cast to float32, so
    the gates and the state stay float32 (``neural.py::GRU._compute``'s
    ``mm`` in the JAX package)."""
    cd = ctx.compute_dtype
    if cd is None:
        return torch.matmul(a, w)
    return torch.matmul(a.to(cd), w.to(cd)).float()


@register_node_class
class GRU(Node):
    """Gated recurrent unit cell: one step, (b, f) in, (b, n_f) out.

    Reference: ``neural.py::GRU``, the recurrent node of the tracing models,
    iterated by ``various.ScanN``. Fused weights: ``w_gates`` maps
    ``[x, h]`` to the (z, r) gates, ``w_cand`` maps ``[x, r*h]`` to the
    candidate.
    """

    def __init__(self, parent, memory_state, n_f, activation_func="tanh",
                 w=None, name="gru", print_repr=True):
        super().__init__([parent, memory_state], name, print_repr)
        self.n_f = int(n_f)
        self.activation_func = _validate_cell_activation(activation_func)
        f_in = parent.shape["f"]
        if memory_state.shape["f"] != self.n_f:
            raise ValueError(f"memory_state features "
                             f"{memory_state.shape['f']} != n_f {self.n_f}")
        self.shape = memory_state.shape.copy()
        rng = self._gm.init_rng()
        self.register_param("w_gates", init_weight(
            rng, (f_in + self.n_f, 2 * self.n_f), "sig"))
        self.register_param("b_gates", torch.zeros(2 * self.n_f), wd_mult=0.0)
        self.register_param("w_cand", init_weight(
            rng, (f_in + self.n_f, self.n_f), activation_func))
        self.register_param("b_cand", torch.zeros(self.n_f), wd_mult=0.0)

    def _compute(self, ctx, x, h):
        gates = torch.sigmoid(
            _cell_matmul(ctx, torch.cat([x, h], dim=-1),
                         ctx.param(self, "w_gates"))
            + ctx.param(self, "b_gates"))
        z, r = torch.chunk(gates, 2, dim=-1)
        cand = get_activation(self.activation_func)(
            _cell_matmul(ctx, torch.cat([x, r * h], dim=-1),
                         ctx.param(self, "w_cand"))
            + ctx.param(self, "b_cand"))
        return (1.0 - z) * h + z * cand


@register_node_class
class LSTM(Node):
    """LSTM cell: one step. ``memory_state`` carries ``[h, c]`` concatenated
    (2*n_f features), and so does the output; split it with
    ``node_basic.split`` to use h alone.

    Reference: ``neural.py::LSTM``.
    """

    def __init__(self, parent, memory_state, n_f, activation_func="tanh",
                 name="lstm", print_repr=True):
        super().__init__([parent, memory_state], name, print_repr)
        self.n_f = int(n_f)
        self.activation_func = _validate_cell_activation(activation_func)
        f_in = parent.shape["f"]
        if memory_state.shape["f"] != 2 * self.n_f:
            raise ValueError("LSTM memory_state must carry 2*n_f features "
                             "([h, c] concatenated)")
        self.shape = memory_state.shape.copy()
        rng = self._gm.init_rng()
        self.register_param("w", init_weight(
            rng, (f_in + self.n_f, 4 * self.n_f), "sig"))
        b = torch.zeros(4 * self.n_f)
        b[self.n_f:2 * self.n_f] = 1.0  # forget-gate bias
        self.register_param("b", b)

    def _compute(self, ctx, x, hc):
        h, c = torch.chunk(hc, 2, dim=-1)
        z = (_cell_matmul(ctx, torch.cat([x, h], dim=-1),
                          ctx.param(self, "w"))
             + ctx.param(self, "b"))
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        act = get_activation(self.activation_func)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * act(g)
        h_new = torch.sigmoid(o) * act(c_new)
        return torch.cat([h_new, c_new], dim=-1)
