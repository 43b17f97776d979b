"""elektronn2_tpu_torch — the PyTorch and CUDA port of elektronn2_tpu.

The JAX package ``elektronn2_tpu`` is the reference and stays as it is; this
package mirrors its module paths and public names (``neuromancer.model.
modelload``, ``Model.predict_dense_device``, ``ops.mfp.fragments2dense``, …)
so a reader finds each counterpart. It imports ``torch`` and never ``jax``,
and never the JAX package: jax-free host code is copied.

Ported so far: the dense MFP inference slice of the flagship net, with the
tail-conv kernel K1 (``ops/tailconv.py`` + ``csrc/tailconv.cu``) hand-written
in CUDA for Hopper. ROADMAP.md lists what is still to come.
"""

__version__ = "0.1.0"

from .log import logger  # noqa: F401  (configures logging on import)
