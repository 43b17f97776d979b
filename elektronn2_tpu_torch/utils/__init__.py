"""utils — shape calculator, CUDA build, bridges from the JAX package."""

from .cnncalculator import (
    cnncalculator, get_valid_patch_sizes, get_cloesest_valid_patch_size,
    get_closest_valid_patch_size,
)

__all__ = [
    "cnncalculator", "get_valid_patch_sizes", "get_cloesest_valid_patch_size",
    "get_closest_valid_patch_size",
]
