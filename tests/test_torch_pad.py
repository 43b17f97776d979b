"""The port's ``Pad`` against the JAX package's (``jnp.pad``) in every mode
``jnp.pad`` takes: pads past the extent (reflect 3 on an extent of 3, wrap
5 on 3, symmetric 7 on 2), a features-last layout (``b,x,y,f``), and a
gradient through the gather modes.

Tolerance: exact for every mode but three. ``mean`` and ``linear_ramp``
are within 2.5e-7 absolute (about two float32 ulps at these magnitudes:
XLA and PyTorch sum and round the ramp's products in another order);
``empty`` leaves the values unspecified, so only its shape is held.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import elektronn2_tpu.neuromancer as jnm  # noqa: E402
import elektronn2_tpu_torch.neuromancer as tnm  # noqa: E402

MODES = ["constant", "edge", "reflect", "symmetric", "wrap", "maximum",
         "minimum", "mean", "median", "linear_ramp", "empty"]
LAYOUTS = {
    # shape, tags, pad per spatial axis
    "bfzxy": ((2, 3, 3, 4, 5), "b,f,z,x,y", [(1, 2), 3, (0, 5)]),
    "bxyf": ((2, 5, 6, 3), "b,x,y,f", [(3, 1), (7, 2)]),
    "past_extent": ((1, 2, 3, 3, 2), "b,f,z,x,y", [3, 5, 7]),
}
NEAR = {"mean": 2.5e-7, "linear_ramp": 2.5e-7}


def pad_pair(shape, tags, pad, mode):
    nodes = []
    for nm in (jnm, tnm):
        nm.model_manager.reset(seed=0)
        nodes.append(nm.Pad(nm.Input(list(shape), tags, name="raw"), pad,
                            mode=mode))
    return nodes


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("mode", MODES)
def test_pad_matches_jnp_pad(mode, layout):
    shape, tags, pad = LAYOUTS[layout]
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    jp, tp = pad_pair(shape, tags, pad, mode)
    want = np.asarray(jp._compute(None, jnp.asarray(x)))
    got = tp._compute(None, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == tuple(tp.shape)
    if mode == "empty":
        return
    if mode in NEAR:
        np.testing.assert_allclose(got, want, rtol=0, atol=NEAR[mode])
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["reflect", "symmetric", "wrap", "edge"])
def test_gather_modes_keep_one_index_per_shape(mode):
    # the index vectors are made once per axis and extent and reused
    shape, tags, pad = LAYOUTS["past_extent"]
    _, tp = pad_pair(shape, tags, pad, mode)
    x = torch.randn(*shape)
    y1 = tp._compute(None, x)
    kept = dict(tp._index)
    y2 = tp._compute(None, x)
    assert torch.equal(y1, y2)
    assert len(kept) == 3 and all(tp._index[k] is v for k, v in kept.items())


def test_reflect_gradient_matches_numpy_adjoint():
    # the gather's backward adds each padded value's gradient into the
    # value it copies, as the adjoint of numpy's index rule
    shape, tags, pad = LAYOUTS["past_extent"]
    _, tp = pad_pair(shape, tags, pad, "reflect")
    x = torch.randn(*shape, dtype=torch.float64, requires_grad=True)
    g = torch.randn(*tp.shape, dtype=torch.float64)
    (tp._compute(None, x) * g).sum().backward()
    idx = np.arange(x.numel()).reshape(shape)
    widths = [(0, 0), (0, 0)] + [(p, p) for p in pad]
    src = np.pad(idx, widths, mode="reflect")
    want = np.bincount(src.ravel(), weights=g.numpy().ravel(),
                       minlength=x.numel()).reshape(shape)
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-12)
