"""elektronn2_tpu_torch — the PyTorch and CUDA port of elektronn2_tpu.

The JAX package ``elektronn2_tpu`` is the reference and stays as it is; this
package mirrors its module paths and public names (``neuromancer.model.
modelload``, ``Model.predict_dense_device``, ``ops.mfp.fragments2dense``, …)
so a reader finds each counterpart. It imports ``torch`` and never ``jax``,
and never the JAX package: jax-free host code is copied.

It does all that the JAX package does: neuromancer node graphs and the
``Model`` API; MFP dense inference, the dilated dense sweep and its
lowerings; U-Net conv-dense serving; bf16, float16 and int8 serving and the
serving tuner; training with on-device augmentation (``ops/warp.py``,
``training/fused_loop.py``, one CUDA graph per chunk of K steps) and the
training entry point (``scripts/train.py``, ``training/trainer.py``);
recurrent agent tracing (``data/tracing_utils.py``); KNOSSOS sweeps, MALIS
and the CLIs; data, tensor, spatial and pipeline parallelism over a
``torch.distributed`` mesh (``parallel/``, ``Model.use_mesh``). Every
Pallas kernel of the JAX package has a hand-written Hopper counterpart in
``csrc/`` behind a wrapper in ``ops/``: the tail conv K1 (float32 and bf16,
``ops/tailconv.py``), the head-unit conv K4, the patch kernels K2
(``ops/extract.py``) and K3 (float32 and bf16, ``ops/extract_rot.py``),
the dilated conv K5 and the probes P1 and P2. Work the JAX package leaves to
XLA runs as plain PyTorch (cuDNN, cuBLAS).
"""

__version__ = "0.1.0"

from .log import logger  # noqa: F401  (configures logging on import)
