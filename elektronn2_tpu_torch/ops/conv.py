"""Convolution / pooling / softmax primitives.

Port of ``conv``, ``pooling``, ``maxout``, ``softmax`` and
``apply_activation`` in ``elektronn2_tpu/ops/conv.py``. The JAX package
leaves these ops to XLA; here they are PyTorch's own (cuDNN on the card).
The array layout ``(b, f, *spatial)`` is torch's NCDHW / NCHW / NCL, so
``F.conv{1,2,3}d`` and ``F.max_pool{1,2,3}d`` take it as it is.

Float32 convolutions on the card go through cuDNN, which runs them in TF32
unless ``torch.backends.cudnn.allow_tf32`` is off; the dense path of
``neuromancer/inference.py`` and ``Model.predict`` switch it off, because
TF32 keeps about three decimal digits and breaks parity with the JAX
package at about 1e-3.
"""

from __future__ import annotations

import contextlib
import inspect
import math

import torch
import torch.nn.functional as F

from .activations import get_activation

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@contextlib.contextmanager
def f32_convs():
    """Run cuDNN convolutions in full float32 inside this context.

    ``torch.backends.cudnn.flags(enabled=True, allow_tf32=False)``; on
    PyTorch versions with the ``fp32_precision`` setting it is also set to
    ``'ieee'``, which the newer API reads instead of ``allow_tf32``. The
    benchmark and determinism flags keep their current values.
    """
    cudnn = torch.backends.cudnn
    kw = dict(enabled=True, benchmark=cudnn.benchmark,
              deterministic=cudnn.deterministic, allow_tf32=False)
    if "fp32_precision" in inspect.signature(cudnn.flags).parameters:
        kw["fp32_precision"] = "ieee"
    with cudnn.flags(**kw):
        yield
_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVGPOOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _nsp(x):
    nsp = x.ndim - 2
    if nsp not in _CONV:
        raise ValueError(f"unsupported spatial rank {nsp}")
    return nsp


def conv(x, w, b=None, border_mode="valid", stride=None, dilation=None):
    """N-D convolution (cross-correlation), valid mode by default.

    x: (b, f_in, *sp); w: (f_out, f_in, *filter); b: optional (f_out,) bias,
    added by the same cuDNN call. ``border_mode`` is 'valid', 'same' or
    'full' (Theano's full convolution: the output extends by the dilated
    kernel footprint minus one on each side).
    """
    nsp = _nsp(x)
    if w.ndim != nsp + 2:
        raise ValueError(f"weight rank {w.ndim} does not match input rank {x.ndim}")
    stride = (1,) * nsp if stride is None else tuple(stride)
    dilation = (1,) * nsp if dilation is None else tuple(int(d) for d in dilation)
    if border_mode == "valid":
        pad = 0
    elif border_mode == "same":
        pad = "same"
    elif border_mode == "full":
        pad = tuple(d * (k - 1) for d, k in zip(dilation, w.shape[2:]))
    else:
        raise ValueError(f"border_mode={border_mode!r}: expected 'valid', "
                         "'same' or 'full'")
    return _CONV[nsp](x, w, b, stride=stride, padding=pad, dilation=dilation)


def pooling(x, pool_shape, mode="max", stride=None):
    """Non-overlapping window pooling over the spatial axes.

    Reference: ``computations.py::pooling`` (ignore_border=True semantics:
    trailing elements that do not fill a window are dropped).
    """
    nsp = _nsp(x)
    pool_shape = tuple(int(p) for p in pool_shape)
    if len(pool_shape) != nsp:
        raise ValueError("pool_shape rank mismatch")
    stride = pool_shape if stride is None else tuple(int(s) for s in stride)
    if mode == "max":
        return _MAXPOOL[nsp](x, pool_shape, stride)
    if mode in ("avg", "mean"):
        return _AVGPOOL[nsp](x, pool_shape, stride)
    if mode == "sum":
        return _AVGPOOL[nsp](x, pool_shape, stride) * math.prod(pool_shape)
    raise ValueError(f"unknown pooling mode {mode!r}")


def maxout(x, factor, axis=1):
    """Maxout over groups of ``factor`` consecutive feature maps.

    Reference: ``computations.py::maxout``.
    """
    n_f = x.shape[axis]
    if n_f % factor:
        raise ValueError(f"feature count {n_f} not divisible by maxout {factor}")
    new_shape = x.shape[:axis] + (n_f // factor, factor) + x.shape[axis + 1:]
    return torch.amax(x.reshape(new_shape), dim=axis + 1)


def softmax(x, axis=1):
    """Numerically-stable softmax over the feature axis.

    Reference: ``computations.py::softmax``.
    """
    return F.softmax(x, dim=axis)


def apply_activation(x, activation_func, alpha=None, axis=1):
    """Apply an activation by reference name; see ops.activations.

    ``maxout:k`` reduces features by k; ``prelu`` uses learnable ``alpha``.
    ``axis``: the feature axis (for maxout grouping / prelu broadcasting).
    """
    if axis < 0:
        axis += x.ndim
    if isinstance(activation_func, str) and activation_func.startswith("maxout"):
        k = int(activation_func.split(":")[1]) if ":" in activation_func else 2
        return maxout(x, k, axis=axis)
    if activation_func == "prelu":
        if alpha is None:
            raise ValueError("prelu requires alpha parameter")
        shape = [1] * x.ndim
        shape[axis] = -1
        a = alpha.reshape(shape).to(x.dtype)
        return torch.where(x >= 0, x, a * x)
    return get_activation(activation_func)(x)
