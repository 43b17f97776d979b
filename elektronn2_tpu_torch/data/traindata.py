"""Generic (non-image) datasets from ELEKTRONN v1.

Jax-free copy of ``elektronn2_tpu/data/traindata.py``. Reference: ``elektronn2/data/traindata.py::Data`` base + MNIST/piano-roll
members — kept for generic MLP training through the same Trainer. The
downloadable datasets are unavailable offline; loaders accept local files
and a synthetic fallback is provided for tests/examples.
"""

from __future__ import annotations

import gzip
import os
import pickle

import numpy as np

from ..log import logger


class Data:
    """Base class: holds (train/valid/test) example matrices and serves
    shuffled minibatches. Reference: ``traindata.py::Data``."""

    def __init__(self, d, l, valid_fraction=0.1, rng=None):
        self.rng = rng or np.random.RandomState(0)
        d = np.asarray(d)
        l = np.asarray(l)
        n_valid = max(1, int(len(d) * valid_fraction))
        idx = self.rng.permutation(len(d))
        self.valid_d, self.valid_l = d[idx[:n_valid]], l[idx[:n_valid]]
        self.train_d, self.train_l = d[idx[n_valid:]], l[idx[n_valid:]]

    def getbatch(self, batch_size=64, source="train", **_ignored):
        d = self.train_d if source == "train" else self.valid_d
        l = self.train_l if source == "train" else self.valid_l
        idx = self.rng.randint(0, len(d), size=batch_size)
        return d[idx], l[idx]

    def link_model_geometry(self, model):  # API parity with image data
        return self

    @property
    def patch_size(self):
        return ()


class MNISTData(Data):
    """MNIST from a local ``mnist.pkl.gz`` (the classic Theano-era file).

    Reference: ``traindata.py::MNISTData``. Falls back to a synthetic
    digit-like dataset when the file is absent (offline environments).
    """

    def __init__(self, path=None, **kwargs):
        path = path or os.path.expanduser("~/mnist.pkl.gz")
        if os.path.exists(path):
            with gzip.open(path, "rb") as f:
                (tr_d, tr_l), (va_d, va_l), (te_d, te_l) = \
                    pickle.load(f, encoding="latin1")
            d = np.concatenate([tr_d, va_d])
            l = np.concatenate([tr_l, va_l]).astype(np.int32)
        else:
            logger.warning(f"{path} not found — using synthetic digits")
            rng = np.random.RandomState(0)
            n = 2000
            l = rng.randint(0, 10, n).astype(np.int32)
            d = rng.rand(n, 784).astype(np.float32) * 0.1
            for i, cls in enumerate(l):       # one bright row per class
                d[i, cls * 78:(cls + 1) * 78] += 0.8
        super().__init__(d.astype(np.float32), l, **kwargs)


class PianoData(Data):
    """Piano-roll sequence data (next-frame prediction).

    Reference: ``traindata.py::PianoData`` (Nottingham piano rolls).
    Loads a pickled list of (T, 88) binary rolls; synthetic fallback.
    """

    def __init__(self, path=None, n_tap=20, **kwargs):
        rolls = None
        if path and os.path.exists(path):
            with open(path, "rb") as f:
                rolls = pickle.load(f, encoding="latin1")
        if rolls is None:
            rng = np.random.RandomState(1)
            rolls = [((rng.rand(100, 88) < 0.05)
                      | (np.eye(100, 88, k=-i % 60) > 0)).astype(np.float32)
                     for i in range(30)]
        d, l = [], []
        for roll in rolls:
            roll = np.asarray(roll, np.float32)
            for t in range(n_tap, len(roll)):
                d.append(roll[t - n_tap:t].ravel())
                l.append(roll[t])
        super().__init__(np.asarray(d), np.asarray(l), **kwargs)
