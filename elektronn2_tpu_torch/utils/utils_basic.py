"""Reference module path: ``elektronn2/utils/utils_basic.py``.

Port of ``elektronn2_tpu/utils/utils_basic.py``: the basic helpers live in
``utils/basic.py`` (and ``pretty_string_time`` in
``training/trainutils.py``); this module re-exports those the port has
under the reference's path. Same objects, not copies.
"""

from .basic import (  # noqa: F401
    AccumulationArray, DynamicKDT, as_list, h5load, h5save,
)
from ..training.trainutils import pretty_string_time  # noqa: F401

__all__ = ["as_list", "h5save", "h5load", "AccumulationArray",
           "DynamicKDT", "pretty_string_time"]
