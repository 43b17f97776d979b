"""Tensor parallelism: weight channels split over a ``model`` mesh axis
(``Model.use_mesh(model_axis=...)``, the spatial step's ``model_axis``).

Port of what the JAX package leaves to GSPMD when ``Model.use_mesh`` shards
the weights over a ``model`` axis (``Model._param_shardings``,
``Model._opt_shardings``): a step under it computes what the unsharded step
computes.

- **The rule** (:func:`tp_dims`, JAX ``model.py::_param_shardings``):
  ``Conv`` and ``UpConv`` ``w`` on dim 0 (the output feature; UpConv's
  ``w`` is ``(n_f, f_in, *pool)``), ``Perceptron`` ``w`` on dim 1 (it is
  ``(f_in, n_f)``), their biases on dim 0, each only where the axis divides
  that dim; every other parameter is replicated. An optimiser slot follows
  its parameter.
- **Each rank keeps only its shards** (:func:`shard_tree`), so the memory
  for weights and slots falls by the axis size; the whole tensors exist
  only gathered for a checkpoint or for dense serving
  (:func:`gather_tree`).
- **The forward is column-parallel.** A node with sharded weights computes
  its slice of the output channels, bias, pool and a channel-local
  activation included, then :meth:`ModelGroup.gather` joins the channels
  over the group (its backward keeps this rank's slice of the gradient:
  everything downstream is replicated within the group). Batch norm, prelu,
  maxout and dropout run on the joined channels: they read per-channel
  parameters that are not sharded, mix channels, or draw at the whole
  shape. The node's input goes through :meth:`ModelGroup.enter`, the
  identity whose backward sums the input's gradient over the group (each
  rank's slice of output channels gives a part of it).
- **The gradient norm** (``clip``) sums the squares of the sharded
  gradients over the group and counts each replicated one once
  (:meth:`ModelGroup.sumsq`).

Collectives are ``all_gather`` and ``all_reduce`` (NCCL on the card, gloo on
CPU tensors); every rank of the group runs the same ones in the same order,
forward and backward. A failed collective raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .data_parallel import AxisGroup

#: the dim of ``w`` that holds the output features, by node class
TP_W_DIM = {"Conv": 0, "UpConv": 0, "Perceptron": 1}


def tp_dims(nodes, world):
    """``{node: {param: dim}}`` of the parameters of ``nodes`` (a graph's
    ``{name: Node}``, their whole shapes) sharded over an axis of ``world``
    ranks (the rule above); a parameter not listed is replicated."""
    out = {}
    for nname, node in nodes.items():
        wdim = TP_W_DIM.get(type(node).__name__)
        if wdim is None:
            continue
        for pname, v in node.params.items():
            shape = tuple(v.shape)
            dim = None
            if pname == "w" and len(shape) >= 2:
                dim = wdim
            elif pname == "b" and len(shape) == 1:
                dim = 0
            if dim is not None and shape[dim] % world == 0:
                out.setdefault(nname, {})[pname] = dim
    return out


class _Gather(torch.autograd.Function):
    """Every rank's slice joined along ``dim``; backward keeps this rank's
    slice of the gradient."""

    @staticmethod
    def forward(ctx, t, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return tp.whole(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.shard(g, ctx.dim), None, None


class _Enter(torch.autograd.Function):
    """The identity; backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class ModelGroup(AxisGroup):
    """One ``model`` axis of a mesh and the collectives of column
    parallelism."""

    AXIS = "model"

    def shard(self, t, dim):
        """This rank's slice of ``t`` along ``dim`` (a contiguous copy)."""
        return self.block(t, dim).contiguous()

    def whole(self, t, dim):
        """Every rank's ``t`` joined along ``dim`` in rank order (new
        tensors; outside autograd)."""
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return parts[0] if self.world == 1 else torch.cat(parts, dim=dim)

    def gather(self, t, dim):
        """:meth:`whole`, differentiable (see the module)."""
        return _Gather.apply(t, dim, self)

    def enter(self, x):
        """The input of a sharded node (see the module)."""
        return _Enter.apply(x, self.group) if x.requires_grad else x

    def sumsq(self, grads, dims):
        """The sum of the squares of the whole gradients of ``grads``
        (``{node: {param: tensor}}``, shards where ``dims`` says so): the
        sharded leaves' squares summed over the group, each replicated one
        counted once. A 0-d tensor, no host sync."""
        sh, rep = [], []
        for n in sorted(grads):
            for p in sorted(grads[n]):
                s = torch.sum(torch.square(grads[n][p]))
                (sh if p in dims.get(n, {}) else rep).append(s)
        total = torch.stack(sh).sum() if sh else None
        if total is not None:
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=self.group)
        if rep:
            r = torch.stack(rep).sum()
            total = r if total is None else total + r
        return total


def shard_tree(tree, dims, tp):
    """``tree`` (``{node: {param: tensor}}``, whole) with the leaves of
    ``dims`` replaced by this rank's slice; the others kept."""
    return {n: {p: (tp.shard(v, dims[n][p]) if p in dims.get(n, {}) else v)
                for p, v in d.items()} for n, d in tree.items()}


def gather_tree(tree, dims, tp):
    """``tree`` with the sharded leaves of ``dims`` joined into whole
    tensors over the group (a collective: every rank of the group calls
    it); the others kept."""
    return {n: {p: (tp.whole(v.detach(), dims[n][p])
                    if p in dims.get(n, {}) else v)
                for p, v in d.items()} for n, d in tree.items()}
