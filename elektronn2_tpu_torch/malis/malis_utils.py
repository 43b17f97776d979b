"""Reference module path: ``elektronn2/malis/malis_utils.py``.

Counterpart of ``elektronn2_tpu/malis/malis_utils.py``: the affinity-graph
utilities (``mknhood3d``, ``seg_to_affgraph``, …) live in
``elektronn2_tpu_torch.malis`` (package root); this module re-exports them
under the reference path. Same objects, not copies.
"""

from . import (  # noqa: F401
    mknhood3d, mknhood2d, mknhood3d_aniso, default_nhood, seg_to_affgraph,
    bmap_to_affgraph, affgraph_to_edgelist, connected_components,
    compute_V_rand_N2,
)

__all__ = [
    "mknhood3d", "mknhood2d", "mknhood3d_aniso", "default_nhood",
    "seg_to_affgraph", "bmap_to_affgraph", "affgraph_to_edgelist",
    "connected_components", "compute_V_rand_N2",
]
