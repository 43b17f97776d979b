"""Reference module path: ``elektronn2/malis/malisop.py``.

Counterpart of ``elektronn2_tpu/malis/malisop.py``. The reference
registered ``malis_weights`` as a custom Theano op here; the port's
equivalents (the host pair counting and the weighted NLL on the
prediction's device) live in ``elektronn2_tpu_torch.malis`` and are
re-exported under the reference path. Same objects, not copies.
"""

from . import malis_weights, malis_weighted_nll  # noqa: F401

__all__ = ["malis_weights", "malis_weighted_nll"]
