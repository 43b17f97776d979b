"""Reference module path: ``elektronn2/neuromancer/computations.py``.

Port of ``elektronn2_tpu/neuromancer/computations.py``: the op functions
live in ``ops/conv.py`` and ``ops/mfp.py``; this module re-exports them
under the reference's path. Same objects, not copies.
"""

from ..ops.conv import (  # noqa: F401
    apply_activation, conv, conv_s2b, dot, maxout, pooling, quantized_conv,
    softmax, unpooling, upconv, upsampling,
)
from ..ops.mfp import (  # noqa: F401
    fragmentpool, fragments2dense, mfp_offsets_product,
)

__all__ = [
    "conv", "conv_s2b", "quantized_conv", "upconv", "dot", "pooling",
    "unpooling", "upsampling", "maxout", "softmax", "apply_activation",
    "fragmentpool", "fragments2dense", "mfp_offsets_product",
]
