"""elektronn2_tpu_torch — the PyTorch and CUDA port of elektronn2_tpu.

The JAX package ``elektronn2_tpu`` is the reference and stays as it is; this
package mirrors its module paths and public names (``neuromancer.model.
modelload``, ``Model.predict_dense_device``, ``ops.mfp.fragments2dense``, …)
so a reader finds each counterpart. It imports ``torch`` and never ``jax``,
and never the JAX package: jax-free host code is copied.

Ported so far, with their kernels hand-written in CUDA for Hopper: the dense
MFP inference slice of the flagship net, with the tail-conv kernel K1
(``ops/tailconv.py`` + ``csrc/tailconv.cu``), and fused agent tracing
(``data/tracing_utils.py``), with the patch kernels K2 (``ops/extract.py`` +
``csrc/extract.cu``) and K3 (``ops/extract_rot.py`` +
``csrc/extract_rot.cu``); U-Net conv-dense serving with K1 and the head-unit
kernel K4; training (``neuromancer/optimiser.py``, ``Model.trainingstep``,
on-device augmentation in ``ops/warp.py`` and ``training/fused_loop.py``,
one CUDA graph per chunk of K steps), whose convs stay cuDNN's as the JAX
package leaves them to XLA; the training entry point (``scripts/train.py``
on the example configs through ``config.py``, ``training/trainer.py``, the
host data pipeline in ``data/`` and ``HostFedFusedLoop``); data-parallel
training over a ``torch.distributed`` mesh (``parallel/``,
``Model.use_mesh``). ROADMAP.md lists what is still to come.
"""

__version__ = "0.1.0"

from .log import logger  # noqa: F401  (configures logging on import)
