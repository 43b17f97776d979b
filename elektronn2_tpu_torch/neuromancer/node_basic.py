"""Node base class and basic graph nodes.

Port of ``Node``, ``Input``, ``GenericInput``, ``ValueNode``, ``Concat``,
``InitialState_like``, ``Split``, ``Reshape``, ``Transpose`` and ``split`` in
``elektronn2_tpu/neuromancer/node_basic.py`` and its module-global
``model_manager``. A Node eagerly computes only static things (TaggedShape,
initial parameter values) and defines ``_compute(ctx, *parent_values)`` on
torch tensors; ``Model`` walks the graph eagerly. Construction args are
captured so graphs are replayable (the GraphManager contract).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import graphmanager
from .graphmanager import register_node_class
from .graphutils import TaggedShape


class TraceCtx:
    """Per-evaluation context threaded through ``Node._compute``.

    Fields:
      params : {node_name: {param_name: tensor}} — current parameters
      feed   : {input_node_name: tensor}
      values : memoised node outputs of this evaluation
      rng    : the step's ``torch.Generator`` or None (stochastic nodes)
      train  : training mode (``Model.trainingstep``)
      state_in/state_out : {node_name: value} aux state read and written
      noise_in/noise_out : {node_name: tensor} random draws fed in and the
               draws of this evaluation (:meth:`draw`)
      remat  : recompute each parameterised node's output in the backward
               pass (``Model.set_remat``)

    The ``convdense_*`` flags select the conv-dense serving lowerings
    (``Model.set_convdense_impl``); ``inference.convolutional_dense_forward``
    sets them on its own context, every other evaluation leaves them off.
    ``compute_dtype`` (``Model.set_compute_dtype``) is the dtype of the
    Conv operands, or None for float32. ``Model.set_train_lowering`` sets
    ``convdense_zfold`` and ``convdense_skipsum`` on the node trace too.
    """

    compute_dtype = None
    remat = False
    convdense_zfold = False
    convdense_upconv_d2s = False
    convdense_poolslice = False
    convdense_skipsum = False
    convdense_ptail = False

    def __init__(self, params, feed, rng=None, train=False, state_in=None,
                 noise_in=None):
        self.params = params or {}
        self.feed = feed or {}
        self.values = {}
        self.rng = rng
        self.train = train
        self.state_in = state_in or {}
        self.state_out = {}
        self.noise_in = noise_in or {}
        self.noise_out = {}

    def get(self, node):
        """Memoised evaluation of ``node`` (and, recursively, its parents).
        A lazy node (``ScanN``, ``InitialState_like``) evaluates its own
        parents, if any, through ``_compute_lazy``. A node with a
        ``_compute_fused`` hook may claim the evaluation of its parents
        (the conv-dense ``skipsum`` lowering, where a Conv consumes its
        FaithlessMerge parent's pieces); the hook returns None to decline.

        Under ``remat`` a parameterised node runs inside
        ``torch.utils.checkpoint`` (non-reentrant), so its activations are
        recomputed in the backward pass instead of kept; the fused hook
        steps aside there, so the checkpoint stays whole-node. The
        recomputation reads the node's random draws from ``noise_out``
        (:meth:`draw`), so it sees the same masks and advances no
        generator."""
        v = self.values.get(node.name)
        if v is None:
            remat = self.remat and bool(node.params)
            if node._lazy:
                v = node._compute_lazy(self)
            else:
                fused = getattr(node, "_compute_fused", None)
                v = fused(self) if fused is not None and not remat else None
                if v is None:
                    pv = [self.get(p) for p in node.parents]
                    if remat:
                        v = checkpoint(lambda *a: node._compute(self, *a),
                                       *pv, use_reentrant=False,
                                       preserve_rng_state=False)
                    else:
                        v = node._compute(self, *pv)
            self.values[node.name] = v
        return v

    def param(self, node, pname):
        try:
            return self.params[node.name][pname]
        except KeyError:
            raise KeyError(f"missing param {node.name}/{pname}; model params "
                           "out of sync with graph") from None

    def draw(self, node, fn):
        """The random draw of a stochastic node in this evaluation: the
        value fed under the node's name in ``noise_in`` if any, else
        ``fn(rng)`` from the step's generator (None without one, and then
        the node acts as the identity). A node draws once per evaluation:
        the draw is kept in ``noise_out``, which a recomputation under
        remat and the caller read.

        The JAX package folds the node's index into the step's key
        (``TraceCtx.rng_for``); here every stochastic node takes the next
        values of the step's one generator, in the graph's evaluation
        order, which is fixed for a graph."""
        v = self.noise_out.get(node.name)
        if v is None:
            v = self.noise_in.get(node.name)
            if v is None:
                if self.rng is None:
                    return None
                v = fn(self.rng)
            self.noise_out[node.name] = v
        return v

    def state(self, node, default=None):
        """The aux state (e.g. batch norm's running statistics) of ``node``
        this evaluation reads."""
        return self.state_in.get(node.name, default)

    def set_state(self, node, value):
        self.state_out[node.name] = value


class Node:
    """Base class of all graph nodes.

    Subclasses must set ``self.shape`` (a TaggedShape) in ``__init__`` and
    implement ``_compute(ctx, *parent_values) -> tensor``.
    """

    _lazy = False  # lazy nodes implement _compute_lazy(ctx) instead

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        # capture the OUTERMOST constructor call for replayable specs
        obj._init_args = (args, dict(kwargs))
        return obj

    def __init__(self, parent, name="node", print_repr=True):
        if parent is None:
            parents = []
        elif isinstance(parent, (list, tuple)):
            parents = list(parent)
        else:
            parents = [parent]
        for p in parents:
            if not isinstance(p, Node):
                raise TypeError(f"parent {p!r} is not a Node")
        self.parents = parents
        self.children = []
        gm = graphmanager.current_manager()
        self.name = gm.unique_name(name)
        self.params = {}       # pname -> float32 CPU tensor (initial value)
        self.param_flags = {}  # pname -> {"trainable","lr_mult","wd_mult"}
        self.shape = None
        for p in parents:
            p.children.append(self)
        gm.register(self)
        self._gm = gm

    # -- params ----------------------------------------------------------------
    def register_param(self, pname, value, trainable=True, lr_mult=1.0,
                       wd_mult=1.0):
        """Register a parameter's initial value (ndarray or tensor), stored
        as a float32 CPU tensor, with its training flags (the optimiser
        skips a parameter that is not ``trainable``)."""
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(np.array(value, dtype=np.float32))
        self.params[pname] = torch.as_tensor(value, dtype=torch.float32)
        self.param_flags[pname] = {"trainable": bool(trainable),
                                   "lr_mult": float(lr_mult),
                                   "wd_mult": float(wd_mult)}

    @property
    def param_count(self):
        return sum(math.prod(v.shape) for v in self.params.values())

    # -- graph traversal ---------------------------------------------------------
    def all_parents(self):
        """Ancestors (including self), parents-before-children order."""
        seen, order = set(), []

        def visit(n):
            if n.name in seen:
                return
            seen.add(n.name)
            for p in n.parents:
                visit(p)
            order.append(n)

        visit(self)
        return order

    # -- compute -------------------------------------------------------------
    def _compute(self, ctx, *parent_values):
        raise NotImplementedError

    def __repr__(self):
        sh = tuple(self.shape) if self.shape is not None else "?"
        return (f"<{type(self).__name__} {self.name!r} shape={sh} "
                f"n_params={self.param_count}>")


_DTYPES = {"float32": torch.float32, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8}


@register_node_class
class Input(Node):
    """Graph input placeholder with a TaggedShape.

    Reference: ``node_basic.py::Input``.
    """

    def __init__(self, shape, tags, dtype=None, name="input",
                 print_repr=True):
        super().__init__(None, name, print_repr)
        self.shape = shape if isinstance(shape, TaggedShape) \
            else TaggedShape(shape, tags)
        self.dtype = dtype or "float32"
        if self.dtype not in _DTYPES:
            raise ValueError(f"input dtype {self.dtype!r}: expected one of "
                             f"{sorted(_DTYPES)}")

    def _compute(self, ctx):
        try:
            v = ctx.feed[self.name]
        except KeyError:
            raise KeyError(f"no value fed for input {self.name!r}; "
                           f"fed: {list(ctx.feed)}") from None
        if v.ndim != self.shape.ndim:
            raise ValueError(
                f"input {self.name!r}: fed rank {v.ndim} != declared "
                f"{self.shape.ndim}")
        return v.to(_DTYPES[self.dtype])


@register_node_class
class GenericInput(Node):
    """Input without shape checking, for auxiliary feeds (e.g. the skeleton
    rows of the skeleton losses).

    Reference: ``node_basic.py::GenericInput``.
    """

    def __init__(self, name="generic_input", print_repr=False):
        super().__init__(None, name, print_repr)
        self.shape = TaggedShape((1,), ("b",))

    def _compute(self, ctx):
        return ctx.feed[self.name]


@register_node_class
class ValueNode(Node):
    """A named value (trainable or not) of a fixed tagged shape, e.g. a
    learnable initial state.

    Reference: ``node_basic.py::ValueNode``.
    """

    def __init__(self, shape, tags, value=0.0, trainable=False, name="value",
                 print_repr=True):
        super().__init__(None, name, print_repr)
        self.shape = TaggedShape(shape, tags)
        init = np.broadcast_to(np.asarray(value, dtype=np.float32),
                               tuple(self.shape)).copy()
        self.register_param("value", init, trainable=trainable)

    def _compute(self, ctx):
        return ctx.param(self, "value")


@register_node_class
class Concat(Node):
    """Concatenate along a tagged axis (default features).

    Reference: ``node_basic.py::Concat``.
    """

    def __init__(self, parent_nodes, axis="f", name="concat",
                 print_repr=True):
        super().__init__(parent_nodes, name, print_repr)
        shapes = [p.shape for p in self.parents]
        ax = shapes[0].tag2index(axis) if isinstance(axis, str) else axis
        self.axis = ax
        for s in shapes[1:]:
            if s.tags != shapes[0].tags:
                raise ValueError("Concat parents must share tags")
            for i, (a, b) in enumerate(zip(s.shape, shapes[0].shape)):
                if i != ax and a != b:
                    raise ValueError(
                        f"Concat shape mismatch off-axis: {s} vs {shapes[0]}")
        total = sum(s.shape[ax] for s in shapes)
        self.shape = shapes[0].updateshape(shapes[0].tags[ax], total)

    def _compute(self, ctx, *parent_values):
        return torch.cat(parent_values, dim=self.axis)


@register_node_class
class InitialState_like(Node):
    """Learnable initial recurrent state, broadcast to the parent's batch.

    Reference: ``node_basic.py::InitialState_like``, the seed of the GRU/LSTM
    hidden state in the tracing models. Lazy: it never evaluates its parent
    (often a per-step placeholder inside a ``ScanN`` sub-graph). A value fed
    under the node's name overrides ``state0`` (state carried across calls).
    """

    _lazy = True

    def __init__(self, parent, override_f, init_kwargs=None,
                 name="initial_state", print_repr=True):
        super().__init__(parent, name, print_repr)
        init_kwargs = init_kwargs or {}
        self.shape = parent.shape.updateshape("f", override_f)
        scale = float(init_kwargs.get("scale", 0.0))
        mode = init_kwargs.get("mode", "const")
        per_f = [1] * self.shape.ndim
        per_f[self.shape.tag2index("f")] = override_f
        if mode == "const":
            val = torch.full(per_f, scale)
        else:
            val = torch.randn(per_f, generator=self._gm.init_rng()) * scale
        self.register_param("state0", val)

    def _compute_lazy(self, ctx):
        if self.name in ctx.feed:
            return torch.as_tensor(ctx.feed[self.name])
        return ctx.param(self, "state0").expand(tuple(self.shape))


@register_node_class
class Split(Node):
    """One output slice of :func:`split`. With ``strip_singleton_dims``, a
    size-1 slice drops its axis.

    Reference: ``node_basic.py::Split``.
    """

    def __init__(self, parent, axis, start, stop, name="split",
                 print_repr=True, strip_singleton_dims=False):
        super().__init__(parent, name, print_repr)
        ax = parent.shape.tag2index(axis) if isinstance(axis, str) else axis
        self.axis, self.start, self.stop = ax, int(start), int(stop)
        self.strip_singleton_dims = bool(strip_singleton_dims)
        self._strip = (self.strip_singleton_dims
                       and self.stop - self.start == 1)
        if self._strip:
            self.shape = parent.shape.delaxis(ax)
        else:
            self.shape = parent.shape.updateshape(parent.shape.tags[ax],
                                                  self.stop - self.start)

    def _compute(self, ctx, x):
        y = x.narrow(self.axis, self.start, self.stop - self.start)
        return y.squeeze(self.axis) if self._strip else y


@register_node_class
class Reshape(Node):
    """Reshape to a new tagged shape of the same element count.

    Reference: ``node_basic.py::Reshape``.
    """

    def __init__(self, parent, shape, tags, name="reshape", print_repr=True):
        super().__init__(parent, name, print_repr)
        self.shape = TaggedShape(shape, tags)
        if math.prod(tuple(self.shape)) != math.prod(tuple(parent.shape)):
            raise ValueError(f"cannot reshape {tuple(parent.shape)} "
                             f"to {tuple(self.shape)}")

    def _compute(self, ctx, x):
        return x.reshape(tuple(self.shape))


@register_node_class
class Transpose(Node):
    """Permute axes (given as tags or indices); the tags follow.

    Reference: ``node_basic.py::Transpose``.
    """

    def __init__(self, parent, perm, name="transpose", print_repr=True):
        super().__init__(parent, name, print_repr)
        self.perm = [parent.shape.tag2index(p) if isinstance(p, str) else
                     int(p) for p in perm]
        self.shape = TaggedShape([parent.shape.shape[i] for i in self.perm],
                                 [parent.shape.tags[i] for i in self.perm])

    def _compute(self, ctx, x):
        return x.permute(self.perm)


def split(node, axis="f", index=None, n_out=None, strip_singleton_dims=False,
          name="split"):
    """Split a node along a tagged axis into several nodes: ``n_out`` equal
    parts, or at the boundaries in ``index``.

    Reference: ``node_basic.py::split``.
    """
    ax = node.shape.tag2index(axis) if isinstance(axis, str) else axis
    size = node.shape.shape[ax]
    if index is None:
        if n_out is None or size % n_out:
            raise ValueError(f"cannot split axis of size {size} into "
                             f"{n_out} parts")
        step = size // n_out
        bounds = [(i * step, (i + 1) * step) for i in range(n_out)]
    else:
        edges = [0] + list(index) + [size]
        bounds = list(zip(edges[:-1], edges[1:]))
    return [Split(node, axis, a, b, name=f"{name}{i}",
                  strip_singleton_dims=strip_singleton_dims)
            for i, (a, b) in enumerate(bounds)]


# make the module-global manager importable from here, as in the reference
model_manager = graphmanager.model_manager
