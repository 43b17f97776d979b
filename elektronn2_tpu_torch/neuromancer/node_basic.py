"""Node base class and basic graph nodes (forward only).

Port of ``Node``, ``Input`` and ``Concat`` in
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

from . import graphmanager
from .graphmanager import register_node_class
from .graphutils import TaggedShape


class TraceCtx:
    """Per-evaluation context threaded through ``Node._compute``.

    Fields:
      params : {node_name: {param_name: tensor}} — current parameters
      feed   : {input_node_name: tensor}
      values : memoised node outputs of this evaluation
    """

    def __init__(self, params, feed):
        self.params = params or {}
        self.feed = feed or {}
        self.values = {}

    def get(self, node):
        """Memoised evaluation of ``node`` (and, recursively, its parents)."""
        v = self.values.get(node.name)
        if v is None:
            v = node._compute(self, *[self.get(p) for p in node.parents])
            self.values[node.name] = v
        return v

    def param(self, node, pname):
        try:
            return self.params[node.name][pname]
        except KeyError:
            raise KeyError(f"missing param {node.name}/{pname}; model params "
                           "out of sync with graph") from None


class Node:
    """Base class of all graph nodes.

    Subclasses must set ``self.shape`` (a TaggedShape) in ``__init__`` and
    implement ``_compute(ctx, *parent_values) -> tensor``.
    """

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
        self.shape = None
        for p in parents:
            p.children.append(self)
        gm.register(self)
        self._gm = gm

    # -- params ----------------------------------------------------------------
    def register_param(self, pname, value):
        """Register a parameter's initial value (ndarray or tensor), stored
        as a float32 CPU tensor. The training flags (trainable, lr_mult,
        wd_mult) come with the training path."""
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(np.array(value, dtype=np.float32))
        self.params[pname] = torch.as_tensor(value, dtype=torch.float32)

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


# make the module-global manager importable from here, as in the reference
model_manager = graphmanager.model_manager
