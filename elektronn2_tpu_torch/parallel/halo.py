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
from .data_parallel import gather


def axis_group(mesh, axis_name):
    """The process group of ``mesh``'s axis ``axis_name`` that holds this
    rank; a name the mesh lacks raises ``ValueError``."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError(f"mesh has no axis {axis_name!r} (axes {names})")
    return mesh.get_group(axis_name)


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
    ranks (multi-hop), trimmed to ``halo``. Reference:
    ``parallel/halo.py::halo_gather``.
    """
    if halo == 0:
        return x_loc
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
