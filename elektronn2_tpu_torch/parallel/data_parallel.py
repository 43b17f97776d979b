"""The data-parallel group a model trains under (``Model.use_mesh``).

Port of what the JAX package leaves to GSPMD when the batch is sharded
over a ``data`` mesh axis (``Model.use_mesh``, ``_shard_batch``): a step
under the mesh computes what the unsharded step computes on the same
global batch.

- Every rank is fed the global batch and keeps its rows (:meth:`rows`).
- Random draws with a batch axis (dropout's masks, ``GaussianRV``'s noise)
  are drawn at the global batch's shape from the step's generator, seeded
  alike on every rank, and each rank keeps its rows, so the masks are the
  unsharded step's.
- Statistics over the batch (batch norm's moments) are summed over the
  group with a differentiable all-reduce (:meth:`sum_`), whose backward
  all-reduces the gradients, so forward and backward match the global
  batch.
- The gradients are averaged over the group with one all-reduce on a flat
  buffer (:meth:`mean_`), before the gradient norm and the update, which
  then run alike on every rank. The losses and errors are averaged too,
  and the outputs with a batch axis gathered (:meth:`gather`).

On the card (NCCL) the averages are ``ReduceOp.AVG`` all-reduces, so even
a group of one runs its collective (a kernel that scales by 1); ``gloo``
has no AVG and sums, then divides. Every collective is issued on the
current stream's order and syncs nothing with the host, so a CUDA graph
can hold it once the communicator exists (a fused loop's eager warm-up
step makes it).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _SumAllReduce(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the incoming gradient:
    every rank's loss depends on every rank's rows through the sum."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return _SumAllReduce.apply(g, ctx.group), None


class DataGroup:
    """One ``data`` axis of a mesh: its process group, size and this
    process's rank in it."""

    def __init__(self, mesh, axis="data"):
        self.axis = axis
        self.group = mesh.get_group(axis)
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.backend = dist.get_backend(self.group)
        self.src = dist.get_global_rank(self.group, 0)

    def key(self):
        """What a captured step depends on: the group, its size, the rank."""
        return (id(self.group), self.world, self.rank)

    def rows(self, v, axis):
        """This rank's rows of ``v`` along ``axis`` (a view); a batch the
        group does not divide raises."""
        n = v.shape[axis]
        if n % self.world:
            raise ValueError(
                f"a batch of {n} does not divide over the {self.world} "
                f"ranks of the mesh's {self.axis!r} axis")
        k = n // self.world
        return v.narrow(axis, self.rank * k, k)

    def mean_(self, t):
        """Average ``t`` over the group, in place; returns ``t``."""
        if self.backend == "nccl":
            dist.all_reduce(t, op=dist.ReduceOp.AVG, group=self.group)
        else:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
            t.div_(self.world)
        return t

    def sum_(self, t):
        """The group's sum of ``t``, differentiable (see module)."""
        return _SumAllReduce.apply(t, self.group)

    def gather(self, t, axis):
        """Every rank's ``t`` concatenated along ``axis``, rank order."""
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim=axis)

    def broadcast_(self, tensors):
        """Rank 0's values of ``tensors`` on every rank, in place."""
        for t in tensors:
            dist.broadcast(t, src=self.src, group=self.group)
