"""parallel — scale-out over a ``torch.distributed`` mesh.

Port of ``elektronn2_tpu/parallel``: the device mesh (``make_mesh``,
``mesh_info``), the multi-process start (``multihost``), the data-parallel
group a model trains under (``Model.use_mesh`` -> ``DataGroup``; slice 8a of
ROADMAP.md item 8) and spatial context parallelism (``halo``: the z axis of
a volume split over a ``space`` axis, valid convs exchanging halo rows with
the next ranks: sharded dense serving). Every rank is given the
caller's whole input and keeps its shard; every rank returns the whole
result.

Not ported yet (ROADMAP.md item 8): ``spatial_train`` (spatial and tensor
parallelism, 8d) and ``pipeline`` (GPipe, 8e).
"""

from .mesh import make_mesh, mesh_info
from .data_parallel import DataGroup
from .halo import halo_gather, cp_conv_z, spatial_cp_stack
from . import multihost

__all__ = ["make_mesh", "mesh_info", "DataGroup", "halo_gather", "cp_conv_z",
           "spatial_cp_stack", "multihost"]
