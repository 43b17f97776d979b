"""Parameter initialisation helpers and parameter containers.

Port of ``elektronn2_tpu/neuromancer/variables.py``: ``init_weight`` and
``init_bias`` (the same He-normal / Glorot-uniform rule, drawn from an
explicit ``torch.Generator``, the graph's, see ``GraphManager.init_rng``),
and the containers ``VariableParam``, ``VariableWeight`` and
``ConstantParam``: an array with its training flags, which
``Node.register_param`` unwraps (so ``Conv(inp, ..., w=VariableWeight(...))``
trains with the flags the container carries).
"""

from __future__ import annotations

import math

import numpy as np
import torch

RELU_LIKE = ("relu", "lrelu", "leaky_relu", "elu", "gelu", "silu", "swish",
             "prelu")


def init_weight(gen, shape, activation_func="relu", fan_in=None):
    """He-normal for relu-family activations, Glorot-uniform otherwise.

    ``gen`` is a ``torch.Generator``; ``shape`` is (f_out, f_in, *filter) for
    convs or (f_in, f_out) for dense; ``fan_in`` overrides the inferred
    fan-in. Returns a float32 CPU tensor.
    """
    shape = tuple(int(s) for s in shape)
    if fan_in is None:
        if len(shape) == 2:      # dense (f_in, f_out)
            fan_in, fan_out = shape[0], shape[1]
        else:                    # conv (f_out, f_in, *filter)
            rf = math.prod(shape[2:])
            fan_in, fan_out = shape[1] * rf, shape[0] * rf
    else:
        fan_out = fan_in
    name = activation_func if isinstance(activation_func, str) else "relu"
    if name.startswith("maxout"):
        name = "lin"
    if name in RELU_LIKE:
        std = math.sqrt(2.0 / fan_in)
        return torch.randn(shape, generator=gen) * std
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit


def init_bias(shape, activation_func="relu", value=None):
    """Small positive bias for relu (reference habit), zero otherwise."""
    if value is None:
        value = 0.1 if (isinstance(activation_func, str)
                        and activation_func in RELU_LIKE) else 0.0
    return torch.full((shape,) if isinstance(shape, int) else tuple(shape),
                      float(value), dtype=torch.float32)


def _init_weight_np(rng, shape, activation_func="relu", fan_in=None):
    """:func:`init_weight`'s rule drawn from a ``numpy.random.RandomState``,
    as the JAX package draws it (``VariableWeight`` made from a shape)."""
    shape = tuple(int(s) for s in shape)
    if fan_in is not None:
        fan_out = fan_in
    elif len(shape) == 2:
        fan_in, fan_out = shape
    else:
        rf = math.prod(shape[2:])
        fan_in, fan_out = shape[1] * rf, shape[0] * rf
    name = activation_func if isinstance(activation_func, str) else "relu"
    if name.startswith("maxout"):
        name = "lin"
    if name in RELU_LIKE:
        w = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
    else:
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        w = rng.uniform(-limit, limit, size=shape)
    return w.astype(np.float32)


class VariableParam:
    """Parameter container with layerwise lr/weight-decay flags.

    Reference: ``variables.py::VariableParam`` (a Theano shared variable
    with ``apply_train``/``apply_reg`` flags there). Holds a float32 numpy
    array plus the flags; ``Node.register_param`` accepts one and unwraps
    it. The shared-variable surface (``get_value`` / ``set_value``) is kept
    for reference-style code.
    """

    trainable_default = True

    def __init__(self, value, name=None, trainable=None, lr_mult=1.0,
                 wd_mult=1.0, apply_train=None, apply_reg=None,
                 dtype=np.float32):
        if apply_train is not None and trainable is None:
            trainable = apply_train        # the reference's flag name
        if trainable is None:
            trainable = self.trainable_default
        if apply_reg is not None and not apply_reg:
            wd_mult = 0.0                  # the reference: no L2 on it
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        self.value = np.asarray(value, dtype=dtype)
        self.name = name
        self.trainable = bool(trainable)
        self.lr_mult = float(lr_mult)
        self.wd_mult = float(wd_mult)

    def get_value(self):
        return self.value

    def set_value(self, v):
        self.value = np.asarray(v, dtype=self.value.dtype)

    @property
    def shape(self):
        return self.value.shape

    def __repr__(self):
        flag = "trainable" if self.trainable else "frozen"
        return (f"<{type(self).__name__} {self.name or ''} "
                f"{self.value.shape} {flag}>")


class VariableWeight(VariableParam):
    """Weight parameter; drawn by the JAX package's rule (a numpy
    ``RandomState``, ``init_kwargs["rng"]`` or seed 0) when given a shape
    instead of values. Reference: ``variables.py::VariableWeight``."""

    def __init__(self, value=None, shape=None, init_kwargs=None, **kwargs):
        if value is None:
            if shape is None:
                raise ValueError("VariableWeight needs value or shape")
            ik = dict(init_kwargs or {})
            rng = ik.pop("rng", None) or np.random.RandomState(0)
            value = _init_weight_np(rng, shape, **ik)
        super().__init__(value, **kwargs)


class ConstantParam(VariableParam):
    """Non-trainable parameter (reference: ``variables.py::ConstantParam``)."""

    trainable_default = False

    def __init__(self, value, name=None, dtype=np.float32):
        super().__init__(value, name=name, trainable=False, wd_mult=0.0,
                         dtype=dtype)
