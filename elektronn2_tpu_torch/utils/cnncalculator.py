"""Valid-shape arithmetic for conv/pool/MFP stacks.

Reference: ``elektronn2/utils/cnncalculator.py::cnncalculator``,
``get_valid_patch_sizes``, ``get_cloesest_valid_patch_size`` (the typo is part
of the public API and is preserved, with a correctly-spelled alias).

Port: a copy of ``elektronn2_tpu/utils/cnncalculator.py`` (numpy only), so
that the port needs no import of the JAX package.

Semantics (per spatial dimension, per layer):
  * valid conv with filter ``f``:   ``o = i - f + 1``          (requires o>=1)
  * plain pooling with pool ``p``:  requires ``o % p == 0``,   ``o -> o/p``
  * MFP pooling with pool ``p``:    requires ``(o+1) % p == 0``, fragments for
    all ``p`` offsets then have identical length ``(o+1)/p - 1``; the batch
    axis grows by ``p`` per MFP'd spatial dim.

Field of view / strides:
  * conv:  ``fov += (f-1) * stride``
  * pool:  ``fov += (p-1) * stride``; per-fragment ``stride *= p``; the
    *dense* (stitched) prediction stride multiplies only for non-MFP pools.
"""

from __future__ import annotations

import numpy as np

__all__ = ["cnncalculator", "get_valid_patch_sizes",
           "get_cloesest_valid_patch_size", "get_closest_valid_patch_size"]


def _normalize(filters, poolings, mfp, ndim):
    """Return per-dim lists: filters[dim][layer], poolings[dim][layer], mfp[layer]."""
    n_layers = len(filters)
    if len(poolings) != n_layers:
        raise ValueError("filters and poolings must have one entry per layer")

    def per_dim(seq):
        out = []
        for v in seq:
            if np.isscalar(v):
                out.append([int(v)] * ndim)
            else:
                v = list(v)
                if len(v) != ndim:
                    raise ValueError(f"per-layer spec {v} does not match ndim={ndim}")
                out.append([int(x) for x in v])
        # transpose to [dim][layer]
        return [[out[l][d] for l in range(n_layers)] for d in range(ndim)]

    if isinstance(mfp, bool) or np.isscalar(mfp):
        mfp = [bool(mfp)] * n_layers
    else:
        mfp = [bool(m) for m in mfp]
        if len(mfp) != n_layers:
            raise ValueError("mfp must be a bool or one flag per layer")
    return per_dim(filters), per_dim(poolings), mfp


def _forward_1d(i, filters, poolings, mfp):
    """Simulate the stack on input length ``i``. Return output length or None."""
    o = i
    for f, p, m in zip(filters, poolings, mfp):
        o = o - f + 1
        if o < 1:
            return None
        if p > 1:
            if m:
                if (o + 1) % p != 0:
                    return None
                o = (o + 1) // p - 1
            else:
                if o % p != 0:
                    return None
                o = o // p
        if o < 1:
            return None
    return o


def _geometry_1d(filters, poolings, mfp):
    """fov, per-fragment stride, dense stride, n_frag for one dimension."""
    fov, stride, dense_stride, n_frag = 1, 1, 1, 1
    for f, p, m in zip(filters, poolings, mfp):
        fov += (f - 1) * stride
        if p > 1:
            fov += (p - 1) * stride
            stride *= p
            if m:
                n_frag *= p
            else:
                dense_stride *= p
    return fov, stride, dense_stride, n_frag


class CNNCalculator:
    """Result object of :func:`cnncalculator`.

    Attributes (lists with one entry per spatial dim, or scalars if ndim==1):
      ``input``  valid input patch size (closest to the desired size)
      ``output`` output size for that input
      ``fov``    field of view
      ``stride`` per-fragment output stride
      ``pred_stride`` stride of the stitched dense prediction (1 if all pools MFP)
      ``offset`` left margin of the first output voxel centre ((fov-1)/2)
      ``valid_inputs`` sorted list of valid input sizes (per dim)
      ``n_frag`` total number of MFP fragments (product over dims)
    """

    def __init__(self, filters, poolings, desired_patch_size, mfp, ndim,
                 max_search=None):
        filters_d, poolings_d, mfp_l = _normalize(filters, poolings, mfp, ndim)
        self.ndim = ndim
        self.mfp = mfp_l
        if desired_patch_size is None:
            desired_patch_size = [100] * ndim
        elif np.isscalar(desired_patch_size):
            desired_patch_size = [int(desired_patch_size)] * ndim
        else:
            desired_patch_size = [int(x) for x in desired_patch_size]
            if len(desired_patch_size) != ndim:
                raise ValueError("desired_patch_size does not match ndim")

        self.input, self.output = [], []
        self.fov, self.stride, self.pred_stride, self.offset = [], [], [], []
        self.valid_inputs = []
        n_frag = 1
        for d in range(ndim):
            f, p, m = filters_d[d], poolings_d[d], mfp_l
            fov, stride, dense_stride, frag = _geometry_1d(f, p, m)
            self.fov.append(fov)
            self.stride.append(stride)
            self.pred_stride.append(dense_stride)
            self.offset.append((fov - 1) / 2 if fov % 2 == 0 else (fov - 1) // 2)
            n_frag *= frag
            hi = max_search or max(2 * desired_patch_size[d] + fov, fov + 4 * stride)
            valids = [i for i in range(1, hi + 1)
                      if _forward_1d(i, f, p, m) is not None]
            if not valids:
                raise ValueError(
                    f"no valid input size <= {hi} for dim {d} "
                    f"(filters={f}, poolings={p}, mfp={m})")
            self.valid_inputs.append(valids)
            chosen = min(valids, key=lambda v: (abs(v - desired_patch_size[d]), v))
            self.input.append(chosen)
            self.output.append(_forward_1d(chosen, f, p, m))
        self.n_frag = n_frag

        if ndim == 1:
            for attr in ("input", "output", "fov", "stride", "pred_stride",
                         "offset", "valid_inputs"):
                setattr(self, attr, getattr(self, attr)[0])

    def __repr__(self):
        return (f"<CNNCalculator input={self.input} output={self.output} "
                f"fov={self.fov} stride={self.stride} "
                f"pred_stride={self.pred_stride} offset={self.offset} "
                f"n_frag={self.n_frag}>")


def cnncalculator(filters, poolings, desired_patch_size=None, mfp=False,
                  force_center=False, desired_output=None, ndim=1):
    """Compute valid input sizes, fov, strides and offsets for a conv stack.

    Reference: ``elektronn2/utils/cnncalculator.py::cnncalculator``.
    ``force_center`` asks for an odd fov (warns otherwise). If
    ``desired_output`` is given it overrides ``desired_patch_size`` by
    searching for the input producing at least that output.
    """
    calc = CNNCalculator(filters, poolings, desired_patch_size, mfp, ndim)
    if desired_output is not None:
        if np.isscalar(desired_output):
            desired_output = [int(desired_output)] * ndim
        filters_d, poolings_d, mfp_l = _normalize(filters, poolings, mfp, ndim)
        inputs, outputs = [], []
        valid_lists = ([calc.valid_inputs] if ndim == 1 else calc.valid_inputs)
        for d in range(ndim):
            best = None
            for i in valid_lists[d]:
                o = _forward_1d(i, filters_d[d], poolings_d[d], mfp_l)
                if o is not None and o >= desired_output[d]:
                    best = (i, o)
                    break
            if best is None:
                raise ValueError(f"desired_output {desired_output[d]} "
                                 f"unreachable in dim {d}")
            inputs.append(best[0])
            outputs.append(best[1])
        calc.input = inputs[0] if ndim == 1 else inputs
        calc.output = outputs[0] if ndim == 1 else outputs
    if force_center:
        fovs = [calc.fov] if ndim == 1 else calc.fov
        for fv in fovs:
            if fv % 2 == 0:
                import warnings
                warnings.warn(f"fov {fv} is even; prediction is not centred "
                              "on a voxel", stacklevel=2)
    return calc


def get_valid_patch_sizes(filters, poolings, desired_patch_size=100,
                          mfp=False, ndim=1):
    """All valid input sizes up to ~2x the desired size (first spatial dim)."""
    calc = CNNCalculator(filters, poolings, desired_patch_size, mfp, ndim)
    return calc.valid_inputs if ndim == 1 else calc.valid_inputs[0]


def get_cloesest_valid_patch_size(filters, poolings, desired_patch_size=100,
                                  mfp=False, ndim=1):
    """Closest valid input size (sic — typo preserved from the reference API)."""
    calc = CNNCalculator(filters, poolings, desired_patch_size, mfp, ndim)
    return calc.input if ndim == 1 else calc.input[0]


# correctly-spelled alias (new)
get_closest_valid_patch_size = get_cloesest_valid_patch_size


# The package re-exports the *function* ``cnncalculator`` in
# ``elektronn2_tpu_torch.utils``; any later ``import elektronn2_tpu_torch.
# utils.cnncalculator`` rebinds
# that package attribute to this *module*, silently shadowing the function.
# Make the module itself callable so both import forms keep working
# regardless of import order.
def _make_module_callable():
    import sys
    import types

    class _CallableModule(types.ModuleType):
        def __call__(self, *args, **kwargs):
            return cnncalculator(*args, **kwargs)

    sys.modules[__name__].__class__ = _CallableModule


_make_module_callable()
del _make_module_callable
