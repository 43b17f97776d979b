"""Reference module path: ``elektronn2/utils/utils_basic.py``.

Port of ``elektronn2_tpu/utils/utils_basic.py``: the basic helpers live in
``utils/basic.py`` (and ``pretty_string_time`` in
``training/trainutils.py``); this module re-exports them under the
reference's path. Same objects, not copies.
"""

from .basic import (  # noqa: F401
    as_list, h5save, h5load, picklesave, pickleload, timeit, cache,
    AccumulationArray, DynamicKDT, unique_rows, makeversiondir,
    import_variable_from_file, pretty_string_ops, get_free_cpu_count,
    CircularBuffer,
)
from ..training.trainutils import pretty_string_time  # noqa: F401

__all__ = [
    "as_list", "h5save", "h5load", "picklesave", "pickleload", "timeit",
    "cache", "AccumulationArray", "DynamicKDT", "unique_rows",
    "makeversiondir", "import_variable_from_file", "pretty_string_ops",
    "get_free_cpu_count", "CircularBuffer", "pretty_string_time",
]
