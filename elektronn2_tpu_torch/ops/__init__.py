"""ops — compute primitives on torch tensors.

Port of ``elektronn2_tpu/ops``: the ops the JAX package leaves to XLA are
PyTorch's own here; the ones it wrote as Pallas TPU kernels are hand-written
CUDA kernels (``tailconv``, ``extract``, ``extract_rot`` so far).
"""

from .activations import get_activation, ACTIVATIONS
from .conv import conv, pooling, maxout, softmax, apply_activation
from .mfp import fragmentpool, fragments2dense, mfp_offsets_product

__all__ = [
    "get_activation", "ACTIVATIONS", "conv", "pooling", "maxout", "softmax",
    "apply_activation", "fragmentpool", "fragments2dense",
    "mfp_offsets_product",
]
