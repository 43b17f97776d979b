"""Device-mesh construction.

Port of ``elektronn2_tpu/parallel/mesh.py``: ``make_mesh`` returns a
``torch.distributed.device_mesh.DeviceMesh`` with named dims over the
ranks of the process group, one device each. Where no process group is up,
it starts one for a world of 1 on a free local port (``nccl`` on the card,
``gloo`` on the CPU), so a single process trains under a mesh of one as
the JAX package does on one chip.
"""

from __future__ import annotations

import math
import socket

import torch
import torch.distributed as dist

from ..log import logger


def free_port():
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def device_type_of(devices):
    """``"cuda"`` or ``"cpu"`` for a ``make_mesh`` ``devices`` argument:
    None (the card), a device type or a device, or a list of devices."""
    if devices is None:
        return "cuda"
    if isinstance(devices, (list, tuple)):
        types = {torch.device(d).type for d in devices}
        if len(types) != 1:
            raise ValueError(f"devices of several types: {sorted(types)}")
        return types.pop()
    return torch.device(devices).type


def ensure_process_group(device_type):
    """Start a process group for a world of 1 where none is up: ``nccl``
    bound to the current card for ``"cuda"``, ``gloo`` for ``"cpu"``."""
    if dist.is_initialized():
        return
    if device_type == "cuda":
        from ..neuromancer.model import target_device
        dev = target_device(f"cuda:{torch.cuda.current_device()}"
                            if torch.cuda.is_available() else "cuda")
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                                f"{free_port()}", world_size=1, rank=0,
                                device_id=dev)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                                f"{free_port()}", world_size=1, rank=0)
    logger.info(f"started a process group of 1 ({dist.get_backend()})")


def make_mesh(axes=None, n_devices=None, devices=None):
    """Build a ``DeviceMesh`` over the process group's ranks.

    ``axes``: dict ``{axis_name: size}`` or a list of names (the first
    axis takes all ranks, the others 1). Defaults to one ``data`` axis over
    all ranks. ``n_devices``: the mesh spans the first ``n_devices`` ranks.
    ``devices``: the device type, ``"cuda"`` (the default: one card a
    rank) or ``"cpu"`` (the tests), or a list of devices of one type.
    Axes whose sizes do not multiply to the number of ranks raise
    ``ValueError``. Reference: ``parallel/mesh.py::make_mesh``.
    """
    from torch.distributed.device_mesh import DeviceMesh
    kind = device_type_of(devices)
    ensure_process_group(kind)
    n = dist.get_world_size()
    if n_devices is not None:
        if not 0 < int(n_devices) <= n:
            raise ValueError(f"n_devices={n_devices}: the process group has "
                             f"{n} ranks")
        n = int(n_devices)
    if axes is None:
        axes = {"data": n}
    if isinstance(axes, (list, tuple)):
        axes = {axes[0]: n, **{a: 1 for a in axes[1:]}}
    axes = {str(k): int(v) for k, v in axes.items()}
    sizes = list(axes.values())
    if math.prod(sizes) != n:
        raise ValueError(f"mesh axes {axes} do not multiply to {n} devices")
    ranks = torch.arange(n).reshape(sizes)
    mesh = DeviceMesh(kind, ranks, mesh_dim_names=tuple(axes))
    logger.info(f"mesh: {axes} over {n} {kind} ranks")
    return mesh


def mesh_info(mesh):
    """``{"axes": {name: size}, "n_devices": n, "platform": device type}``
    of a mesh. Reference: ``parallel/mesh.py::mesh_info``."""
    return {"axes": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
            "n_devices": mesh.mesh.numel(),
            "platform": mesh.device_type}
