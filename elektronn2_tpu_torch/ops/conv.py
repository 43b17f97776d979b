"""Convolution / pooling / dense / softmax primitives.

Port of ``conv``, ``upconv``, ``upconv_d2s``, ``conv_zfold2d``, ``dot``,
``pooling``, ``pooling_slices``, ``unpooling``, ``maxout``, ``softmax`` and
``apply_activation`` in ``elektronn2_tpu/ops/conv.py``. The JAX package
leaves these ops to XLA; here they are PyTorch's own (cuDNN on the card).
The array layout ``(b, f, *spatial)`` is torch's NCDHW / NCHW / NCL, so
``F.conv{1,2,3}d`` and ``F.max_pool{1,2,3}d`` take it as it is.

Float32 convolutions on the card go through cuDNN, which runs them in TF32
unless ``torch.backends.cudnn.allow_tf32`` is off; the dense path of
``neuromancer/inference.py`` and ``Model.predict`` switch it off, because
TF32 keeps about three decimal digits and breaks parity with the JAX
package at about 1e-3. Float32 matmuls go through cuBLAS, whose default is
full float32, but a process may have switched TF32 on
(``torch.backends.cuda.matmul``); the model paths pin it off with
:func:`f32_matmuls`.
"""

from __future__ import annotations

import contextlib
import inspect
import itertools
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


@contextlib.contextmanager
def f32_matmuls():
    """Run cuBLAS float32 matmuls in full float32 (no TF32) inside this
    context, restoring the previous setting after it.

    On PyTorch versions with the ``fp32_precision`` setting it is set to
    ``'ieee'``; older versions take ``allow_tf32=False``. Only one of the two
    APIs is touched: PyTorch refuses to read a precision set through both.
    """
    mm = torch.backends.cuda.matmul
    try:
        attr, full, prev = "fp32_precision", "ieee", mm.fp32_precision
    except AttributeError:
        attr, full, prev = "allow_tf32", False, mm.allow_tf32
    setattr(mm, attr, full)
    try:
        yield
    finally:
        setattr(mm, attr, prev)


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


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def upconv(x, w, pool_shape):
    """Transposed convolution ("upconv") with stride = kernel = pool_shape.

    Reference: ``ops/conv.py::upconv``; it inverts a pooling in decoder
    paths (output spatial size = input * pool). w: (f_out, f_in, *pool).
    The JAX package runs it as an input-dilated correlation with the kernel
    flipped; torch's transposed conv takes the weight as (f_in, f_out,
    *pool) unflipped, and the two are the same function.
    """
    nsp = _nsp(x)
    pool_shape = tuple(int(p) for p in pool_shape)
    return _CONV_T[nsp](x, w.transpose(0, 1), stride=pool_shape)


def upconv_d2s(x, w, pool_shape):
    """``upconv`` as a 1x1 conv to ``f_out * prod(pool)`` channels followed
    by depth-to-space: with kernel == stride every output position receives
    exactly one tap, so the two are the same function.

    Reference: ``ops/conv.py::upconv_d2s``.
    """
    nsp = _nsp(x)
    p = tuple(int(v) for v in pool_shape)
    co, ci = int(w.shape[0]), int(w.shape[1])
    P = math.prod(p)
    # tap (i1..in) of output channel o becomes channel o*P + row-major(i)
    wm = w.reshape(co, ci, P).transpose(1, 2).reshape((co * P, ci) + (1,) * nsp)
    y = conv(x, wm)
    b, sp = y.shape[0], y.shape[2:]
    y = y.reshape((b, co) + p + tuple(sp))
    perm = [0, 1]
    for i in range(nsp):                    # b co p1..pn s1..sn ->
        perm += [2 + nsp + i, 2 + i]        # b co s1 p1 s2 p2 ...
    return y.permute(perm).reshape((b, co) + tuple(s * v for s, v in zip(sp, p)))


def conv_zfold2d(x, w, b=None):
    """A kz=1 3D conv as a 2D conv with z folded into the batch axis: the
    same contraction. x (b, c, Z, X, Y); w (f_out, c, 1, kx, ky).

    Reference: ``ops/conv.py::conv_zfold2d``. Returns a (b, f_out, Z, X',
    Y') view of the 2D conv's (b*Z, f_out, X', Y') output.
    """
    n, c, z = x.shape[:3]
    x2 = x.transpose(1, 2).reshape(n * z, c, x.shape[3], x.shape[4])
    y = F.conv2d(x2, w[:, :, 0], b)
    return y.reshape(n, z, w.shape[0], y.shape[2], y.shape[3]).transpose(1, 2)


def dot(x, w, axis=1):
    """Feature-axis dense transform: ``(b, f_in, *sp) @ (f_in, f_out)``,
    applied at every remaining position (a 1x1 conv when spatial axes are
    present); ``axis`` is the feature axis of ``x``.

    Reference: ``computations.py::dot``.
    """
    y = torch.matmul(torch.movedim(x, axis, -1), w.to(x.dtype))
    return torch.movedim(y, -1, axis)


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


def pooling_slices(x, pool_shape, mode="max"):
    """``pooling`` as the elementwise max (or sum) of the window's strided
    slices: the same function for non-overlapping windows, trailing
    elements that fill no window dropped.

    Reference: ``ops/conv.py::pooling_slices``.
    """
    nsp = _nsp(x)
    pool_shape = tuple(int(p) for p in pool_shape)
    if len(pool_shape) != nsp:
        raise ValueError("pool_shape rank mismatch")
    if mode not in ("max", "sum", "avg", "mean"):
        raise ValueError(f"unknown pooling mode {mode!r}")
    out = None
    for offs in itertools.product(*(range(p) for p in pool_shape)):
        piece = x[(slice(None), slice(None)) + tuple(
            slice(o, (x.shape[2 + d] // p) * p, p)
            for d, (o, p) in enumerate(zip(offs, pool_shape)))]
        if out is None:
            out = piece
        elif mode == "max":
            out = torch.maximum(out, piece)
        else:
            out = out + piece
    if mode in ("avg", "mean"):
        out = out / math.prod(pool_shape)
    return out


def unpooling(x, pool_shape):
    """Nearest-neighbour unpooling (repeat each voxel pool times).

    Reference: ``ops/conv.py::unpooling``.
    """
    for i, p in enumerate(pool_shape):
        x = torch.repeat_interleave(x, int(p), dim=2 + i)
    return x


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
