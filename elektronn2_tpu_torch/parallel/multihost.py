"""Multi-process initialisation.

Port of ``elektronn2_tpu/parallel/multihost.py`` on ``torch.distributed``:
every process runs the same program, :func:`initialize` joins them into
one process group, and the mesh and data-parallel code work unchanged.
``torchrun --nproc_per_node=N -m elektronn2_tpu_torch.scripts.train
cfg.py`` sets the environment :func:`initialize` reads (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..log import logger

#: what torchrun sets for every process it starts
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def under_torchrun():
    return all(k in os.environ for k in TORCHRUN_ENV)


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               device="cuda"):
    """Start the process group (idempotent).

    ``coordinator_address`` (``host:port``, with ``num_processes`` and
    ``process_id``) asks for a group explicitly; without arguments the
    torchrun environment is read, and without that environment this is a
    single-process run and nothing is started (``make_mesh`` then starts a
    group of 1). On the card (``device="cuda"``) each process is bound to
    ``cuda:LOCAL_RANK`` (``LOCAL_RANK``, else the rank modulo the visible
    cards) and NCCL's communicator is made at once (``device_id``); on the
    CPU the backend is ``gloo``. A request that fails raises: going on
    alone would train N unsynchronised copies. Reference:
    ``parallel/multihost.py::initialize``.
    """
    if dist.is_initialized():
        logger.debug("torch.distributed already initialised")
        return
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address requires num_processes "
                             "and process_id")
        init, world, rank = (f"tcp://{coordinator_address}",
                             int(num_processes), int(process_id))
        local = int(os.environ.get("LOCAL_RANK", -1))
    elif under_torchrun():
        init, world, rank = ("env://", int(os.environ["WORLD_SIZE"]),
                             int(os.environ["RANK"]))
        local = int(os.environ.get("LOCAL_RANK", -1))
    else:
        logger.debug("no process group requested: single-process run")
        return
    if torch.device(device).type == "cuda":
        from ..neuromancer.model import target_device
        target_device("cuda")
        if local < 0:
            local = rank % torch.cuda.device_count()
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init, world_size=world,
                                rank=rank, device_id=dev)
    else:
        dist.init_process_group("gloo", init_method=init, world_size=world,
                                rank=rank)
    logger.info(f"process {rank}/{world} ({dist.get_backend()})")


def global_mesh(axes=None, device="cuda"):
    """A mesh over every process's device (one ``data`` axis by default).
    Reference: ``parallel/multihost.py::global_mesh``."""
    from .mesh import make_mesh
    return make_mesh(axes=axes, devices=device)


def is_main_process():
    """True on rank 0, and in a run without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0
