"""``Model.set_train_lowering`` and ``Model.set_remat`` of the port against
the default trace and against the JAX package, on the CPU: the counterpart
of tests/test_training.py::test_set_train_lowering_exact_losses on
``examples/unet3d_wide.py`` at widths (8, 12, 16) and its patch (16, 32, 32).

Each lowering computes the same function, so five SGD steps give the same
losses as the default trace within 1e-5 (atol, as the JAX test), and the
default trace's losses equal the JAX package's from the same weights
within 1e-5.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))
from unet3d_wide import create_model  # noqa: E402
from elektronn2_tpu_torch.utils.convert import (params_from_jax,  # noqa: E402
                                                wide_unet_model)

torch.set_num_threads(2)
LOSS_ATOL = 1e-5
WIDTHS = (8, 12, 16)
PATCH = (16, 32, 32)
LOWERINGS = [dict(zfold=True), dict(skipsum=True),
             dict(zfold=True, skipsum=True)]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model's weights and its five SGD losses, with the batch."""
    jm = create_model(batch=1, patch=PATCH, widths=WIDTHS)
    weights = {n: {k: np.asarray(v) for k, v in d.items()}
               for n, d in jm.params.items()}
    x = np.random.RandomState(0).rand(1, 1, *PATCH).astype(np.float32)
    zo, xo, yo = [int(s) for s in jm.prediction_node.shape.spatial_shape]
    y = (np.random.RandomState(1).rand(1, zo, xo, yo) * 2).astype(np.int32)
    jm.set_opt("SGD", lr=0.05, mom=0.9)
    losses = np.asarray([float(jm.trainingstep(x, y)[0]) for _ in range(5)])
    return weights, x, y, losses


def port_losses(jax_run, remat=False, steps=5, **lowering):
    weights, x, y, _ = jax_run
    tm = wide_unet_model(batch=1, patch=PATCH, widths=WIDTHS, device="cpu")
    tm.set_params(params_from_jax(weights, tm))
    tm.set_train_lowering(**lowering)
    tm.set_remat(remat)
    tm.set_opt("SGD", lr=0.05, mom=0.9)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    return np.asarray([float(tm.trainingstep(tx, ty)[0])
                       for _ in range(steps)])


def test_default_trace_matches_jax(jax_run):
    base = port_losses(jax_run)
    assert np.isfinite(base).all() and base[-1] < base[0]
    np.testing.assert_allclose(base, jax_run[3], atol=LOSS_ATOL, rtol=0)


@pytest.mark.parametrize("lowering", LOWERINGS, ids=str)
def test_lowering_same_losses(jax_run, lowering):
    got = port_losses(jax_run, **lowering)
    np.testing.assert_allclose(got, port_losses(jax_run), atol=LOSS_ATOL,
                               rtol=0, err_msg=str(lowering))
    np.testing.assert_allclose(got, jax_run[3], atol=LOSS_ATOL, rtol=0)


@pytest.mark.parametrize("lowering", [{}, dict(skipsum=True),
                                      dict(zfold=True, skipsum=True)],
                         ids=str)
def test_remat_same_losses(jax_run, lowering):
    """Remat composes with the lowerings (the skipsum hook steps aside
    under it): the same losses as the default trace."""
    got = port_losses(jax_run, remat=True, steps=3, **lowering)
    np.testing.assert_allclose(got, jax_run[3][:3], atol=LOSS_ATOL, rtol=0)


def test_lowerings_are_taken():
    """The flags reach the node trace: zfold runs the kz=1 convs as 2-D
    convs, skipsum never builds a merge's concat, and remat wraps each
    parameterised node in a checkpoint (and then skipsum steps aside)."""
    from elektronn2_tpu_torch.neuromancer import neural, node_basic
    tm = wide_unet_model(batch=1, patch=PATCH, widths=WIDTHS, device="cpu")
    x = torch.rand(1, 1, *PATCH)
    seen = {"zfold": 0, "concat": 0, "checkpoint": 0}
    real_zfold, real_cat = neural.conv_zfold2d, torch.cat
    real_ckpt = node_basic.checkpoint

    def zfold(*a, **kw):
        seen["zfold"] += 1
        return real_zfold(*a, **kw)

    def cat(*a, **kw):
        seen["concat"] += 1
        return real_cat(*a, **kw)

    def ckpt(*a, **kw):
        seen["checkpoint"] += 1
        return real_ckpt(*a, **kw)
    neural.conv_zfold2d, neural.torch.cat = zfold, cat
    node_basic.checkpoint = ckpt
    try:
        counts = []
        for kw, remat in ((dict(), False), (dict(zfold=True), False),
                          (dict(skipsum=True), False),
                          (dict(skipsum=True), True)):
            for k in seen:
                seen[k] = 0
            tm.set_train_lowering(**kw)
            tm.set_remat(remat)
            tm._apply([tm.prediction_node], tm.params, tm.state,
                      {"raw": x}, None, train=True)
            counts.append(dict(seen))
    finally:
        neural.conv_zfold2d, neural.torch.cat = real_zfold, real_cat
        node_basic.checkpoint = real_ckpt
    plain, zf, ss, ss_remat = counts
    assert plain["zfold"] == 0 and zf["zfold"] == 4    # e0a, e0b, d0, cls
    assert plain["concat"] == 2 and ss["concat"] == 0
    assert ss_remat["concat"] == 2
    assert ss_remat["checkpoint"] == len(tm.params)
    assert plain["checkpoint"] == 0
