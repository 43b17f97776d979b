"""parallel — scale-out over a ``torch.distributed`` mesh.

Port of ``elektronn2_tpu/parallel``: the device mesh (``make_mesh``,
``mesh_info``), the multi-process start (``multihost``), the data-parallel
group a model trains under (``Model.use_mesh`` -> ``DataGroup``), spatial
context parallelism (``halo``: the z axis of a volume split over a
``space`` axis, valid convs exchanging halo rows with the next ranks:
sharded dense serving, and with a differentiable exchange the DP x SP
training step of ``spatial_train``), tensor parallelism
(``tensor_parallel``: weight channels split over a ``model`` axis,
``Model.use_mesh(model_axis=...)``) and pipeline parallelism
(``pipeline``: a GPipe schedule over a ``pipe`` axis). Every rank is
given the caller's whole input and keeps its shard; every rank returns the
whole result, equal to the unsharded computation's.
"""

from .mesh import make_mesh, mesh_info
from .data_parallel import DataGroup
from .halo import halo_gather, cp_conv_z, spatial_cp_stack
from .spatial_train import (make_spatial_dp_trainstep,
                            make_fused_spatial_trainstep,
                            pad_target_for_spatial, spatial_tp_shardings)
from .pipeline import (gpipe_stack, microbatch, gpipe_reference_loss,
                       make_gpipe_trainstep, layers_from_model)
from . import multihost

__all__ = ["make_mesh", "mesh_info", "halo_gather", "cp_conv_z",
           "spatial_cp_stack", "make_spatial_dp_trainstep",
           "make_fused_spatial_trainstep",
           "pad_target_for_spatial", "spatial_tp_shardings",
           "gpipe_stack", "microbatch", "gpipe_reference_loss",
           "make_gpipe_trainstep", "layers_from_model",
           "DataGroup", "multihost"]
