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


def gather(x, group, dim):
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


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


def axis_group(mesh, axis_name):
    """The process group of ``mesh``'s axis ``axis_name`` that holds this
    rank; a name the mesh lacks raises ``ValueError``."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError(f"mesh has no axis {axis_name!r} (axes {names})")
    return mesh.get_group(axis_name)


class AxisGroup:
    """One axis of a mesh: its process group, size and this process's rank
    in it. A subclass adds the collectives of its kind of parallelism and
    names its default axis (``AXIS``)."""

    AXIS = None

    def __init__(self, mesh, axis=None):
        self.axis = axis or self.AXIS
        self.group = axis_group(mesh, self.axis)
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def key(self):
        """What a captured step depends on: the group, its size, the rank."""
        return (id(self.group), self.world, self.rank)

    def block(self, v, axis, what="an extent of"):
        """This rank's block of ``v`` along ``axis`` (a view); an extent
        the group does not divide raises."""
        n = v.shape[axis]
        if n % self.world:
            raise ValueError(
                f"{what} {n} does not divide over the {self.world} "
                f"ranks of the mesh's {self.axis!r} axis")
        k = n // self.world
        return v.narrow(axis, self.rank * k, k)


class DataGroup(AxisGroup):
    """One ``data`` axis of a mesh and the collectives of data
    parallelism."""

    AXIS = "data"

    def __init__(self, mesh, axis=None):
        super().__init__(mesh, axis)
        self.backend = dist.get_backend(self.group)

    def rows(self, v, axis):
        """This rank's rows of ``v`` along ``axis`` (a view); a batch the
        group does not divide raises."""
        return self.block(v, axis, "a batch of")

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
        return gather(t, self.group, axis)
