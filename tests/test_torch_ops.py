"""The port's ops (``elektronn2_tpu_torch.ops``) against the JAX package's.

Same numpy inputs to both; float32 on the CPU. Tolerances: 1e-5 where the
two frameworks sum in another order (convolutions, softmax, smooth
activations), exact equality where nothing is summed (max pooling, MFP
slicing and restitching).
"""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax import lax

# (the ops packages re-export the function ``conv``, which shadows the
# submodule of the same name as a package attribute)
jax_act, jax_conv, jax_mfp = (importlib.import_module(f"elektronn2_tpu.ops.{m}")
                              for m in ("activations", "conv", "mfp"))
t_act, t_conv, t_mfp = (importlib.import_module(f"elektronn2_tpu_torch.ops.{m}")
                        for m in ("activations", "conv", "mfp"))

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(seed, *shape):
    return (np.random.RandomState(seed).rand(*shape) - 0.5).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("nsp", [1, 2, 3])
@pytest.mark.parametrize("border_mode", ["valid", "same", "full"])
@pytest.mark.parametrize("dil", [1, 2])
def test_conv(nsp, border_mode, dil):
    sp = (7, 9, 8)[:nsp]
    x = _rand(0, 2, 3, *sp)
    w = _rand(1, 4, 3, *((3, 2, 3)[:nsp]))
    dilation = (dil,) * nsp
    ref = np.asarray(jax_conv.conv(jnp.asarray(x), jnp.asarray(w),
                                   border_mode=border_mode, dilation=dilation,
                                   precision=lax.Precision.HIGHEST))
    got = t_conv.conv(_t(x), _t(w), border_mode=border_mode,
                      dilation=dilation).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


def test_conv_bias_and_rank_check():
    x, w, b = _rand(2, 1, 2, 5, 6, 7), _rand(3, 3, 2, 1, 3, 3), _rand(4, 3)
    ref = np.asarray(jax_conv.conv(jnp.asarray(x), jnp.asarray(w))) \
        + b.reshape(1, -1, 1, 1, 1)
    got = t_conv.conv(_t(x), _t(w), _t(b)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    with pytest.raises(ValueError, match="rank"):
        t_conv.conv(_t(x), _t(w[:, :, 0]))
    with pytest.raises(ValueError, match="border_mode"):
        t_conv.conv(_t(x), _t(w), border_mode="wrap")


@pytest.mark.parametrize("mode", ["max", "avg", "sum"])
@pytest.mark.parametrize("pool", [(2, 2), (1, 2, 2), (2, 3, 2)])
def test_pooling(mode, pool):
    x = _rand(5, 2, 3, *((6, 7, 9)[-len(pool):]))
    ref = np.asarray(jax_conv.pooling(jnp.asarray(x), pool, mode=mode))
    got = t_conv.pooling(_t(x), pool, mode=mode).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("pool, dil", [((1, 2, 2), (1, 1, 1)),
                                       ((1, 2, 2), (1, 2, 2)),
                                       ((2, 2, 2), (1, 4, 2)),
                                       ((2, 2), (3, 2))])
@pytest.mark.parametrize("mode", ["max", "avg"])
def test_dilated_pool(pool, dil, mode):
    # the dense path's stride-1 window-dilated pool vs lax.reduce_window
    from elektronn2_tpu_torch.neuromancer.inference import dilated_pool
    x = _rand(6, 1, 3, *((7, 15, 13)[-len(pool):]))
    nd = len(pool)
    window, wdil = (1, 1) + pool, (1, 1) + dil
    if mode == "max":
        ref = lax.reduce_window(jnp.asarray(x), -np.inf, lax.max, window,
                                (1,) * (nd + 2), "VALID",
                                window_dilation=wdil)
    else:
        ref = lax.reduce_window(jnp.asarray(x), 0.0, lax.add, window,
                                (1,) * (nd + 2), "VALID",
                                window_dilation=wdil) / np.prod(pool)
    got = dilated_pool(_t(x), pool, dil, mode=mode).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("pool", [(2, 2), (1, 2, 2), (2, 2, 3)])
def test_fragmentpool(pool):
    nsp = len(pool)
    sp = tuple(2 * p * 2 + p - 1 for p in pool)     # ≡ p-1 (mod p)
    x = _rand(7, 2, 3, *sp)
    off_in = np.zeros((1, nsp), np.int64)
    strides = (1,) * nsp
    ref, ref_off = jax_mfp.fragmentpool(jnp.asarray(x), pool, off_in, strides)
    got, got_off = t_mfp.fragmentpool(_t(x), pool, off_in, strides)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got_off, ref_off)
    with pytest.raises(ValueError, match="p-1"):
        t_mfp.fragmentpool(_t(x[..., :-1]), pool, off_in, strides)


@pytest.mark.parametrize("pools", [[(2, 2)], [(2, 2), (2, 2)],
                                   [(1, 2, 2), (1, 2, 2)], [(2, 1, 3)]])
def test_fragments2dense(pools):
    # chain fragment pools, then restitch: both packages, same values
    nsp = len(pools[0])
    sp = [int(s) for s in (23, 23, 23)[:nsp]]
    x = _rand(8, 1, 2, *sp)
    jx, tx = jnp.asarray(x), _t(x)
    off = np.zeros((1, nsp), np.int64)
    strides = np.ones(nsp, np.int64)
    for pool in pools:
        k = [(s + 1) // p * p - 1 for s, p in zip(jx.shape[2:], pool)]
        sl = (slice(None), slice(None)) + tuple(slice(0, kk) for kk in k)
        jx, joff = jax_mfp.fragmentpool(jx[sl], pool, off, strides)
        tx, off = t_mfp.fragmentpool(tx[sl], pool, off, strides)
        np.testing.assert_array_equal(off, joff)
        strides = strides * np.asarray(pool)
    ref = np.asarray(jax_mfp.fragments2dense(jx, off))
    got = t_mfp.fragments2dense(tx, off).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert t_mfp.mfp_offsets_product(pools[0]) == \
        jax_mfp.mfp_offsets_product(pools[0])


@pytest.mark.parametrize("axis", [1, -1])
def test_softmax(axis):
    x = _rand(9, 2, 3, 4, 5) * 10
    ref = np.asarray(jax_conv.softmax(jnp.asarray(x), axis=axis))
    got = t_conv.softmax(_t(x), axis=axis).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("name", sorted(jax_act.ACTIVATIONS))
def test_activations(name):
    assert set(t_act.ACTIVATIONS) == set(jax_act.ACTIVATIONS)
    x = _rand(10, 3, 4, 5) * 6
    ref = np.asarray(jax_conv.apply_activation(jnp.asarray(x), name))
    got = t_conv.apply_activation(_t(x), name).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("name", ["maxout", "maxout:3", "prelu"])
def test_shape_changing_activations(name):
    x = _rand(11, 2, 6, 4)
    alpha = _rand(12, 6)
    ref = np.asarray(jax_conv.apply_activation(
        jnp.asarray(x), name, alpha=jnp.asarray(alpha)))
    got = t_conv.apply_activation(_t(x), name, alpha=_t(alpha)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_activation_validation():
    for name in ("relu", "lin", "maxout:2", "prelu"):
        assert t_act.validate_activation(name) == name
    with pytest.raises(ValueError, match="unknown activation"):
        t_act.validate_activation("nope")
    with pytest.raises(ValueError, match="unknown activation"):
        t_act.get_activation("maxout")
