"""Neural layer nodes: dense, convolution, pooling, decoder nodes, fragment
restitching, recurrent cells.

Port of ``Perceptron``, ``Conv``, ``Pool``, ``UpConv``, ``Crop``,
``FaithlessMerge``, ``FragmentsToDense``, ``GRU`` and ``LSTM`` in
``elektronn2_tpu/neuromancer/neural.py`` (reference:
``elektronn2/neuromancer/neural.py``). Semantics are the JAX
package's: valid-mode convs, pooling applied *before* the activation, MFP
valid-size arithmetic (see ops/mfp.py and utils/cnncalculator.py).

The conv-dense serving lowerings of ``Model.set_convdense_impl`` (zfold,
d2s, poolslice, skipsum and K1 on eligible convs) are chosen per node from
the flags of the ``TraceCtx``; every other evaluation leaves them off.

The dense and recurrent matmuls are ``torch.matmul`` (cuBLAS on the card),
as the JAX package leaves them to XLA. Not in this slice, raising
``NotImplementedError``: batch normalisation, dropout and prelu (ROADMAP.md
§1 item 2, which was item 6).
"""

from __future__ import annotations

import numpy as np
import torch

from .graphmanager import register_node_class
from .graphutils import TaggedShape
from .node_basic import Node
from .variables import init_bias, init_weight
from ..ops.activations import get_activation, validate_activation
from ..ops.conv import (apply_activation, conv as ops_conv, conv_zfold2d,
                        dot as ops_dot, pooling as ops_pooling,
                        pooling_slices, upconv, upconv_d2s)
from ..ops.mfp import fragmentpool, fragments2dense, mfp_offsets_product
from ..ops.tailconv import conv3x3_dilated


def _maxout_factor(activation_func):
    if isinstance(activation_func, str) and activation_func.startswith("maxout"):
        return int(activation_func.split(":")[1]) if ":" in activation_func else 2
    return 1


def _validate_cell_activation(name):
    """Recurrent cells need plain elementwise activations."""
    validate_activation(name)
    if isinstance(name, str) and (name.startswith("maxout")
                                  or name == "prelu"):
        raise ValueError(f"{name!r} is not usable inside GRU/LSTM cells")
    return name


def _norm_spatial(v, nsp, what):
    if np.isscalar(v):
        return (int(v),) * nsp
    v = tuple(int(x) for x in v)
    if len(v) != nsp:
        raise ValueError(f"{what} {v} does not match spatial rank {nsp}")
    return v


@register_node_class
class Perceptron(Node):
    """Fully-connected layer over the feature axis.

    Reference: ``neural.py::Perceptron`` (alias ``Dot``). With
    ``flatten=True`` every axis but the batch is folded into the features
    first (the classic MLP head); otherwise the transform applies at each
    position along the other axes. ``w`` is ``(f_in, n_f)``.
    """

    def __init__(self, parent, n_f, activation_func="relu", flatten=False,
                 batch_normalisation=False, dropout_rate=0, w=None, b=None,
                 name="dot", print_repr=True):
        if batch_normalisation or dropout_rate:
            raise NotImplementedError(
                "Perceptron: batch_normalisation and dropout are not ported "
                "yet (ROADMAP.md §1 item 6, training path)")
        if activation_func == "prelu":
            raise NotImplementedError(
                "Perceptron: activation 'prelu' is not ported yet "
                "(ROADMAP.md §1 item 6)")
        super().__init__(parent, name, print_repr)
        self.n_f = int(n_f)
        self.activation_func = validate_activation(activation_func)
        self.flatten = bool(flatten)
        self.batch_normalisation = False
        self.dropout_rate = 0.0

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
        self.register_param("b", b)

    def _compute(self, ctx, x):
        if self.flatten:
            x = x.reshape(x.shape[0], -1)
        w = ctx.param(self, "w")
        b = ctx.param(self, "b")
        if x.ndim == 2 or self._f_ax == x.ndim - 1:
            y = torch.matmul(x, w) + b
        else:
            ax = 1 if self._f_ax is None else self._f_ax
            y = ops_dot(x, w, axis=ax) + b.reshape(
                (1,) * ax + (-1,) + (1,) * (x.ndim - ax - 1))
        f_ax = 1 if self.flatten else self._f_ax
        return apply_activation(y, self.activation_func, axis=f_ax)


Dot = Perceptron  # reference alias


@register_node_class
class Conv(Node):
    """Valid-mode N-D convolution with optional fused pooling / MFP.

    Reference: ``neural.py::Conv`` — conv (+bias) → max-pool (plain or MFP)
    → activation. With ``mfp=True`` the pooling evaluates all pool-offset
    fragments and stacks them into the batch axis (see ops/mfp.py); the
    TaggedShape tracks fragment offsets so ``FragmentsToDense`` and the dense
    path can stitch a full-resolution map.

    ``batch_normalisation`` and ``dropout_rate`` are accepted for spec
    compatibility and raise ``NotImplementedError`` unless off.
    """

    def __init__(self, parent, n_f, filter_shape, pool_shape=None,
                 activation_func="relu", mfp=False,
                 batch_normalisation=False, dropout_rate=0, w=None, b=None,
                 name="conv", print_repr=True):
        if batch_normalisation or dropout_rate:
            raise NotImplementedError(
                "Conv: batch_normalisation and dropout are not ported yet "
                "(ROADMAP.md §1 item 6, training path)")
        if activation_func == "prelu" or _maxout_factor(activation_func) > 1:
            raise NotImplementedError(
                f"Conv: activation {activation_func!r} is not ported yet "
                "(ROADMAP.md §1 item 6)")
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
        self.batch_normalisation = False
        self.dropout_rate = 0.0

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

        shape = list(ps.shape)
        shape[ps.tag2index("b")] = batch
        shape[ps.tag2index("f")] = self.n_f
        for ax, s in zip(ps.spatial_axes, sp):
            shape[ax] = s
        self.shape = TaggedShape(shape, ps.tags, strides, fov, offsets)

        rng = self._gm.init_rng()
        wshape = (self.n_f, ps["f"]) + self.filter_shape
        w = w if w is not None else init_weight(rng, wshape, activation_func)
        b = b if b is not None else init_bias(self.n_f, activation_func)
        self.register_param("w", w)
        self.register_param("b", b)
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
        without MFP. Max pooling is allowed: K1's fused ReLU commutes with a
        max, ``max(relu(z)) == relu(max(z))``."""
        return (ctx.convdense_ptail and tuple(self.filter_shape) == (3, 3, 3)
                and self.activation_func == "relu" and not self.mfp)

    def _compute(self, ctx, x):
        w, b = ctx.param(self, "w"), ctx.param(self, "b")
        if self._ptail_eligible(ctx):
            y = conv3x3_dilated(x.contiguous(), w, b)    # bias + ReLU fused
            if any(p > 1 for p in self.pool_shape):
                y = self._pool(ctx, y)
            return y
        cd = ctx.compute_dtype
        if cd is not None:
            # mixed precision: operands in ``cd``, float32 accumulation,
            # the bias and the epilogue in float32 (as the JAX package)
            y = self._serving_conv_fn(ctx)(x.to(cd), w.to(cd)).float()
            y = y + b.reshape((1, -1) + (1,) * (x.ndim - 2))
            return self._conv_epilogue(ctx, y)
        return self._conv_epilogue(ctx, self._serving_conv_fn(ctx)(x, w, b))

    def _pool(self, ctx, y):
        if ctx.convdense_poolslice:
            return pooling_slices(y, self.pool_shape)
        return ops_pooling(y, self.pool_shape)

    def _conv_epilogue(self, ctx, y):
        """Pool (plain or MFP fragment pool), then the activation: the tail
        shared by every conv lowering."""
        if any(p > 1 for p in self.pool_shape):
            if self.mfp:
                y, _ = fragmentpool(y, self.pool_shape, self._parent_offsets,
                                    self._pre_pool_strides)
            else:
                y = self._pool(ctx, y)
        return apply_activation(y, self.activation_func)

    def _fuses_merge(self, ctx):
        """Whether this Conv consumes its FaithlessMerge parent's pieces
        (``set_convdense_impl(skipsum=True)``) instead of their concat."""
        return (ctx.convdense_skipsum and not self.mfp
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
        self.register_param("b", b)

    def _compute(self, ctx, x):
        fn = upconv_d2s if ctx.convdense_upconv_d2s else upconv
        y = fn(x, ctx.param(self, "w"), self.pool_shape)
        y += ctx.param(self, "b").reshape((1, -1) + (1,) * (x.ndim - 2))
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
        self.register_param("b_gates", torch.zeros(2 * self.n_f))
        self.register_param("w_cand", init_weight(
            rng, (f_in + self.n_f, self.n_f), activation_func))
        self.register_param("b_cand", torch.zeros(self.n_f))

    def _compute(self, ctx, x, h):
        gates = torch.sigmoid(
            torch.matmul(torch.cat([x, h], dim=-1), ctx.param(self, "w_gates"))
            + ctx.param(self, "b_gates"))
        z, r = torch.chunk(gates, 2, dim=-1)
        cand = get_activation(self.activation_func)(
            torch.matmul(torch.cat([x, r * h], dim=-1),
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
        z = (torch.matmul(torch.cat([x, h], dim=-1), ctx.param(self, "w"))
             + ctx.param(self, "b"))
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        act = get_activation(self.activation_func)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * act(g)
        h_new = torch.sigmoid(o) * act(c_new)
        return torch.cat([h_new, c_new], dim=-1)
