"""data — volumetric pipeline: loading, augmentation, batch creation,
KNOSSOS datasets, tracing runtime and skeleton I/O.

Port of ``elektronn2_tpu/data`` with its exports: the host pipeline
(``transformations``, ``image``, ``cnndata``, ``traindata``; jax-free copies,
numpy only, with the C++ warp core behind ``_warp_native``), the KNOSSOS
datasets (``knossos_array``, with the cube core behind
``_knossos_native``), skeleton export (``skeleton``), the tracing runtime
(``tracing_utils``) and, from ``ops.warp``, the card-resident
``DeviceBatchAugmenter``. ``SkeletonMFK`` is not ported yet (ROADMAP.md item
3c), and ``AgentData``, which needs it, raises. The Trainer resolves a
string ``data_class`` here.
"""

from ..ops.warp import DeviceBatchAugmenter
from .cnndata import AgentData, BatchCreatorImage, GridData
from .image import greyAugment, ids2barriers, smearbarriers
from .knossos_array import KnossosArray, KnossosArrayMulti, save_knossos
from .skeleton import Trace, trace_to_kzip
from .traindata import Data, MNISTData, PianoData
from .transformations import (WarpingOOBError, get_random_warp_params,
                              make_warp_matrix, map_coordinates_linear,
                              map_coordinates_nearest, warp_slice)

__all__ = [
    "warp_slice", "WarpingOOBError", "make_warp_matrix",
    "get_random_warp_params", "map_coordinates_linear",
    "map_coordinates_nearest", "greyAugment", "ids2barriers", "smearbarriers",
    "BatchCreatorImage", "GridData", "AgentData",
    "Data", "MNISTData", "PianoData",
    "KnossosArray", "KnossosArrayMulti", "save_knossos",
    "Trace", "trace_to_kzip",
    "DeviceBatchAugmenter",
]
