"""parallel — data-parallel training over a ``torch.distributed`` mesh.

Port of ``elektronn2_tpu/parallel`` (slice 8a of ROADMAP.md item 8): the
device mesh (``make_mesh``, ``mesh_info``), the multi-process start
(``multihost``) and the data-parallel group a model trains under
(``Model.use_mesh`` -> ``DataGroup``). The batch is sharded over a
``data`` mesh axis: every rank feeds the global batch and keeps its rows,
the gradients are averaged with one all-reduce a step, and the update runs
on every rank, so the parameters stay equal on every rank.

Not ported yet (ROADMAP.md item 8): ``halo`` (sharded dense serving, 8b),
``spatial_train`` (spatial and tensor parallelism, 8d) and ``pipeline``
(GPipe, 8e).
"""

from .mesh import make_mesh, mesh_info
from .data_parallel import DataGroup
from . import multihost

__all__ = ["make_mesh", "mesh_info", "DataGroup", "multihost"]
