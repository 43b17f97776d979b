"""Neural layer nodes: dense, convolution, pooling, fragment restitching,
recurrent cells.

Port of ``Perceptron``, ``Conv``, ``Pool``, ``FragmentsToDense``, ``GRU``
and ``LSTM`` in ``elektronn2_tpu/neuromancer/neural.py`` (reference:
``elektronn2/neuromancer/neural.py``), forward only. Semantics are the JAX
package's: valid-mode convs, pooling applied *before* the activation, MFP
valid-size arithmetic (see ops/mfp.py and utils/cnncalculator.py).

The dense and recurrent matmuls are ``torch.matmul`` (cuBLAS on the card),
as the JAX package leaves them to XLA. Not in this slice, raising
``NotImplementedError``: batch normalisation, dropout and prelu (ROADMAP.md
§1 item 6, training path), the conv-dense serving lowerings (item 8).
"""

from __future__ import annotations

import numpy as np
import torch

from .graphmanager import register_node_class
from .graphutils import TaggedShape
from .node_basic import Node
from .variables import init_bias, init_weight
from ..ops.activations import get_activation, validate_activation
from ..ops.conv import (apply_activation, conv as ops_conv, dot as ops_dot,
                        pooling as ops_pooling)
from ..ops.mfp import fragmentpool, fragments2dense, mfp_offsets_product


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

    def _compute(self, ctx, x):
        y = ops_conv(x, ctx.param(self, "w"), ctx.param(self, "b"))
        if any(p > 1 for p in self.pool_shape):
            if self.mfp:
                y, _ = fragmentpool(y, self.pool_shape, self._parent_offsets,
                                    self._pre_pool_strides)
            else:
                y = ops_pooling(y, self.pool_shape)
        return apply_activation(y, self.activation_func)


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
