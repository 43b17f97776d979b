"""Legacy model import.

Jax-free copy of ``elektronn2_tpu/utils/legacy.py`` (reference:
``elektronn2/utils/legacy.py``) — loaders for ELEKTRONN v1 /
old-format pickled models (backward-compat weight import). The original
formats are Theano pickles; here we support:

  * ELEKTRONN2 (original) ``.mdl`` pickles, read *unsafely optional*: the
    pickled node-spec list cannot be replayed without Theano, but parameter
    arrays can be salvaged into a name→array dict.
  * plain pickled {name: ndarray} weight dicts.

The salvaged arrays are mapped onto a freshly-built model of this package
by name/shape matching (``import_params``), on the model's device.
"""

from __future__ import annotations

import pickle
import re

import numpy as np

from ..log import logger


def _extract_arrays(obj, prefix="", out=None):
    """Recursively harvest ndarrays from an arbitrary unpickled object."""
    if out is None:
        out = {}
    if isinstance(obj, np.ndarray):
        out[prefix or f"arr{len(out)}"] = obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _extract_arrays(v, f"{prefix}/{k}" if prefix else str(k), out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _extract_arrays(v, f"{prefix}[{i}]", out)
    return out


def load_legacy_params(fname):
    """Best-effort extraction of parameter arrays from a legacy pickle.

    WARNING: unpickling executes arbitrary code from the file — only load
    files you trust (same caveat as the reference's model format).
    """
    with open(fname, "rb") as f:
        try:
            obj = pickle.load(f, encoding="latin1")
        except Exception as e:
            raise IOError(f"cannot unpickle legacy model {fname}: {e}\n"
                          "(Theano class definitions may be required; "
                          "extract arrays on a machine with the legacy "
                          "stack and re-save as npz)") from e
    arrays = _extract_arrays(obj)
    logger.info(f"salvaged {len(arrays)} arrays from {fname}")
    return arrays


def import_params(model, arrays, strict=False):
    """Map name→array onto a model's params by name, then shape matching.

    Each legacy array is consumed at most once: shape-only fallback
    assigns arrays in file order, so several same-shaped layers get
    DISTINCT arrays (re-using the first match for all of them would
    silently duplicate one layer's weights across the net).
    """
    def _name_match(key, nname, pname):
        # whole-token match (split on non-alphanumerics, case-insensitive):
        # substring containment with 1-char param names ('w' inside
        # 'gamma_weights') mis-assigned same-shaped arrays and suppressed
        # the shape-only warning
        toks = {t.lower() for t in re.split(r"[^0-9a-zA-Z]+", key) if t}
        return nname.lower() in toks or pname.lower() in toks

    n_loaded = 0
    consumed = set()
    new = {n: dict(d) for n, d in model.params.items()}
    for nname, pdict in model.params.items():
        for pname, cur in pdict.items():
            want_shape = tuple(cur.shape)
            match_key = None
            for k, v in arrays.items():
                if k in consumed or v.shape != want_shape:
                    continue
                if _name_match(k, nname, pname):
                    match_key = k
                    break
                if match_key is None:
                    match_key = k     # shape-only candidate; keep looking
            if match_key is not None:
                if not _name_match(match_key, nname, pname):
                    logger.warning(
                        f"legacy import: {nname}/{pname} matched "
                        f"{match_key!r} by shape only — verify the mapping")
                consumed.add(match_key)
                new[nname][pname] = np.asarray(arrays[match_key],
                                               np.float32)
                n_loaded += 1
            elif strict:
                raise KeyError(f"no legacy array for {nname}/{pname} "
                               f"{want_shape}")
    model.set_params(new)
    logger.info(f"imported {n_loaded} legacy parameter arrays")
    return model
