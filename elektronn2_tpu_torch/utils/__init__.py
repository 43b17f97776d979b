"""utils — shape calculator, IO helpers, CUDA build, bridges from the JAX
package. The re-exports follow ``elektronn2_tpu/utils/__init__.py``."""

from .cnncalculator import (
    cnncalculator, get_valid_patch_sizes, get_cloesest_valid_patch_size,
    get_closest_valid_patch_size,
)
from .basic import (
    h5save, h5load, picklesave, pickleload, timeit, cache,
    AccumulationArray, DynamicKDT, as_list,
)

__all__ = [
    "cnncalculator", "get_valid_patch_sizes", "get_cloesest_valid_patch_size",
    "get_closest_valid_patch_size",
    "h5save", "h5load", "picklesave", "pickleload", "timeit", "cache",
    "AccumulationArray", "DynamicKDT", "as_list",
]
