"""Spatial context parallelism: halo exchange for valid-mode convs.

Port of ``elektronn2_tpu/parallel/halo.py`` on ``torch.distributed``. The z
axis of a volume is split over a ``space`` mesh axis; a valid conv with
``kz`` taps at z-dilation ``d`` needs ``d·(kz-1)`` more rows than a rank
holds, and fetches them from the ranks after it. After a stack of valid
convs the trailing rows of the global result are invalid (they would need
rows past the volume's end, which come as zeros) and are trimmed.

Contract (every sharded entry point of the port): every rank is given the
caller's whole input, takes its own shard (:func:`shard`), exchanges halos
with its neighbours over the axis's process group, and returns the whole
gathered result (:func:`gather`), equal to the unsharded call.

The exchange is one ``all_gather`` of each rank's head rows over the axis's
group, of which a rank keeps the heads of the ranks after it. It is the one
collective every backend in use takes: NCCL on the card, gloo on CPU
tensors in the tests, and gloo on CUDA tensors (where gloo's ``send`` and
``recv`` take CPU tensors only and abort the process on a CUDA one, checked
on an H100). A failed collective raises; nothing computes the unsharded
result instead.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.activations import get_activation
from ..ops.conv import apply_layer, conv as ops_conv
from .data_parallel import AxisGroup, axis_group, gather


def shard(x, group, dim):
    """This rank's equal share of ``x`` along ``dim`` (a contiguous copy);
    an extent the group does not divide raises ``ValueError``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"extent {x.shape[dim]} along dim {dim} is not "
                         f"divisible by the {n} ranks of the axis")
    k = x.shape[dim] // n
    return x.narrow(dim, r * k, k).contiguous()


def halo_gather(x_loc, halo, group):
    """Append ``halo`` z rows (axis 2) from the following rank(s), zeros
    past the global end.

    ``x_loc``: this rank's (b, f, z_local, x, y) shard. A halo up to one
    shard takes the next rank's head rows; a wider one (deep dilated stacks
    on many ranks) takes whole shards of the next ``ceil(halo / z_local)``
    ranks (multi-hop), trimmed to ``halo``. The collective runs outside
    autograd (serving); a training step takes :func:`halo_gather_grad`.
    Reference: ``parallel/halo.py::halo_gather``.
    """
    if halo == 0:
        return x_loc
    return _gather_rows(x_loc, halo, group)


class _HaloGather(torch.autograd.Function):
    """:func:`halo_gather` with a backward: every halo row's gradient goes
    back to the rank that owns the row.

    Forward is the multi-hop gather (one ``all_gather`` of the head rows).
    Backward pads this rank's halo gradient to ``hops`` whole pieces, takes
    one ``all_gather`` of every rank's, and adds to its own head rows the
    piece that hop ``h`` of rank ``r - h`` took from them (gloo has no
    ``reduce_scatter``, hence the gather). The last ranks' zero rows go
    through the op too, so every rank calls the same collectives in its
    backward; their gradients have no owner and are dropped."""

    @staticmethod
    def forward(ctx, x_loc, halo, group):
        ctx.halo, ctx.group, ctx.z_loc = halo, group, x_loc.shape[2]
        return _gather_rows(x_loc, halo, group)

    @staticmethod
    def backward(ctx, g):
        halo, group, z_loc = ctx.halo, ctx.group, ctx.z_loc
        n, r = dist.get_world_size(group), dist.get_rank(group)
        hz = min(halo, z_loc)
        hops = -(-halo // z_loc)
        gh = g[:, :, z_loc:]
        if gh.shape[2] < hops * hz:
            gh = torch.cat([gh, gh.new_zeros(gh.shape[:2]
                                             + (hops * hz - gh.shape[2],)
                                             + gh.shape[3:])], dim=2)
        parts = [torch.empty_like(gh) for _ in range(n)]
        dist.all_gather(parts, gh.contiguous(), group=group)
        gx = g[:, :, :z_loc].clone(memory_format=torch.contiguous_format)
        for h in range(1, hops + 1):
            if r - h >= 0:
                gx[:, :, :hz] += parts[r - h][:, :, (h - 1) * hz:h * hz]
        return gx, None, None


def _gather_rows(x_loc, halo, group):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    z_loc = x_loc.shape[2]
    hops = -(-halo // z_loc)
    heads = [torch.empty_like(x_loc[:, :, :min(halo, z_loc)])
             for _ in range(n)]
    dist.all_gather(heads, x_loc[:, :, :min(halo, z_loc)].contiguous(),
                    group=group)
    got = [heads[r + h] if r + h < n else torch.zeros_like(heads[0])
           for h in range(1, hops + 1)]
    return torch.cat([x_loc] + got, dim=2)[:, :, :z_loc + halo]


def halo_gather_grad(x_loc, halo, group):
    """:func:`halo_gather` for training: differentiable, the halo rows'
    gradients summed into the rows they came from (z-sharded training,
    ``parallel/spatial_train.py``). Every rank of ``group`` must call it,
    and must then run the backward of its result."""
    if halo == 0:
        return x_loc
    return _HaloGather.apply(x_loc, halo, group)


class SpaceGroup(AxisGroup):
    """One ``space`` axis of a mesh, the z axis of a volume split over
    it (``TraceCtx.halo_axis`` of a z-sharded training step)."""

    AXIS = "space"

    def halo(self, x_loc, rows):
        """``rows`` z rows from the next ranks, differentiable
        (:func:`halo_gather_grad`)."""
        return halo_gather_grad(x_loc, rows, self.group)


def cp_conv_z(x_loc, w, b=None, group=None, activation=None):
    """One halo-exchanged valid conv layer on a z-sharded volume: keeps
    z_local output rows per rank (the global tail is invalid; trim after
    the stack). The filter may span x and y, which are not sharded.
    ``group`` is the ``space`` axis's group (None: the default group).
    Reference: ``parallel/halo.py::cp_conv_z``."""
    y = ops_conv(halo_gather(x_loc, w.shape[2] - 1, group), w)
    if b is not None:
        y = y + b.reshape((1, -1) + (1,) * (y.ndim - 2))
    if activation is not None:
        y = get_activation(activation)(y)
    return y


def spatial_cp_stack(layers, mesh, axis_name="space"):
    """A z-sharded forward pass of a conv stack.

    ``layers``: dicts ``{w, b, activation, pool}`` in the canonical order
    conv + bias -> pool -> activation (``ops.conv.apply_layer``); pooling in
    z raises ``ValueError``. Returns ``fn(x)``: ``x`` is the whole
    (b, f, Z, X, Y) volume, given to every rank, with Z divisible by the
    axis (else ``ValueError``); every rank gets the whole valid result,
    equal to the unsharded stack's. Reference:
    ``parallel/halo.py::spatial_cp_stack``.
    """
    group = axis_group(mesh, axis_name)
    n = dist.get_world_size(group)
    for layer in layers:
        pool = layer.get("pool")
        if pool is not None and any(p > 1 for p in pool) and pool[0] != 1:
            raise ValueError("z-pooling under z-sharding is unsupported; "
                             "pool in x/y or restructure the mesh")
    total_shrink = sum(int(l["w"].shape[2]) - 1 for l in layers)

    def fn(x):
        if x.shape[2] % n:
            raise ValueError(f"z extent {x.shape[2]} not divisible by "
                             f"mesh axis {axis_name}={n}")
        h = shard(x, group, 2)
        for layer in layers:
            w = layer["w"]
            h = apply_layer(halo_gather(h, w.shape[2] - 1, group), w,
                            layer.get("b"), layer.get("activation"),
                            layer.get("pool"))
        return gather(h, group, 2)[:, :, :x.shape[2] - total_shrink]

    return fn
