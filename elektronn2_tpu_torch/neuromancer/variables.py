"""Parameter initialisation helpers.

Port of ``init_weight`` and ``init_bias`` in
``elektronn2_tpu/neuromancer/variables.py``: the same He-normal / Glorot-
uniform rule, drawn from an explicit ``torch.Generator`` (the graph's, see
``GraphManager.init_rng``).
"""

from __future__ import annotations

import math

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
