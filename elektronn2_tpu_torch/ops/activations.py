"""Activation functions.

Port of ``elektronn2_tpu/ops/activations.py``: the same names (the
reference's lin, relu, tanh, sig, abs, plus the modern extras) on torch
tensors, with the same validation. ``maxout`` and ``prelu`` pass validation
as there, but no layer of this port takes them yet.
"""

import torch
import torch.nn.functional as F


def _softsign(x):
    return x / (1 + torch.abs(x))


ACTIVATIONS = {
    "lin": lambda x: x,
    "linear": lambda x: x,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sig": torch.sigmoid,
    "sigmoid": torch.sigmoid,
    "abs": torch.abs,
    "elu": F.elu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "swish": F.silu,
    "softplus": F.softplus,
    "softsign": _softsign,
    "lrelu": lambda x: F.leaky_relu(x, 0.01),
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
}


def validate_activation(name):
    """Eager name check for layer constructors (fail fast, not at run)."""
    if callable(name):
        return name
    if isinstance(name, str) and (name.startswith("maxout")
                                  or name == "prelu"):
        return name
    if name not in ACTIVATIONS:
        raise ValueError(
            f"unknown activation {name!r}; known: {sorted(ACTIVATIONS)} "
            "(+ 'maxout[:k]'/'prelu')")
    return name


def get_activation(name):
    """Look up an activation by its reference name.

    ``maxout`` and ``prelu`` are handled by the calling layer (they change
    shape / carry parameters) and are not returned here.
    """
    if callable(name):
        return name
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; known: {sorted(ACTIVATIONS)} "
            "(+ 'maxout'/'prelu' handled in layers)") from None
