"""K4 (``elektronn2_tpu_torch.ops.tailconv.conv1x3x3_pool_dilated``)
against the JAX head-unit kernel.

On the CPU the port's head unit runs its plain PyTorch version; it is held
against the JAX package's Pallas kernel in interpret mode (whose output is
the xzcy layout, sliced back to NCDHW as tests/test_pallas_tailconv.py
does) and against its ``conv1x3x3_pool_reference``, on the same numpy
inputs. The CUDA kernel is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``. Tolerance 1e-4: sums of
up to 9*Cin products in another order.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from elektronn2_tpu.ops.pallas_tailconv import (
    conv1x3x3_pool_dilated as jax_head, conv1x3x3_pool_reference as jax_ref,
    conv3x3_dilated as jax_tail)
from elektronn2_tpu_torch.ops import tailconv

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(rng, *shape):
    return (rng.rand(*shape) - 0.5).astype(np.float32)


def _xzcy_to_ncdhw(y, z, cout, yo):
    """The JAX kernel's (Xo, Z_p, Co_p, Yp) output as (1, Cout, Z, Xo, Yo)."""
    return np.asarray(y)[:, :z, :cout, :yo].transpose(2, 1, 0, 3)[None]


@pytest.mark.parametrize("cfg", [(1, 20, 1, 2), (20, 30, 2, 2),
                                 (4, 6, 1, 1), (3, 5, 3, 2)])
def test_head_unit_matches_pallas_interpret(cfg):
    Cin, Cout, d, pool = cfg
    rng = np.random.RandomState(0)
    Z, X, Y = 5, 18, 26
    x, w, b = _rand(rng, 1, Cin, Z, X, Y), _rand(rng, Cout, Cin, 1, 3, 3), \
        _rand(rng, Cout)
    ref = jax_head(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), (d, d),
                   pool, interpret=True, z_block=4)
    dp = d * (pool - 1)
    ref = _xzcy_to_ncdhw(ref, Z, Cout, Y - 2 * d - dp)
    got = tailconv.conv1x3x3_pool_dilated(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        (d, d), pool)
    assert tuple(got.shape) == ref.shape == (1, Cout, Z, X - 2 * d - dp,
                                             Y - 2 * d - dp)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_head_head_tail_chain_matches_pallas_interpret():
    """conv0+pool0 -> conv1+pool1 -> conv2: the port chains NCDHW tensors,
    the JAX kernels their xzcy layout (tests/test_pallas_tailconv.py)."""
    rng = np.random.RandomState(1)
    Z, X, Y = 6, 30, 40
    x = rng.rand(1, 1, Z, X, Y).astype(np.float32)
    w0, b0 = _rand(rng, 8, 1, 1, 3, 3), np.zeros(8, np.float32)
    w1, b1 = _rand(rng, 8, 8, 1, 3, 3), np.zeros(8, np.float32)
    w2, b2 = _rand(rng, 8, 8, 3, 3, 3), np.zeros(8, np.float32)
    j = [jnp.asarray(a) for a in (x, w0, b0, w1, b1, w2, b2)]
    h = jax_head(j[0], j[1], j[2], (1, 1), 2, interpret=True, z_block=4)
    h = jax_head(h, j[3], j[4], (2, 2), 2, in_layout="xzcy", valid_y=Y - 3,
                 interpret=True, z_block=4)
    ref = jax_tail(h, j[5], j[6], (1, 4, 4), in_layout="xzcy",
                   valid_y=Y - 9, interpret=True, z_block=4)
    ref = np.asarray(ref)[:, :, :Z - 2]
    t = [torch.from_numpy(a) for a in (x, w0, b0, w1, b1, w2, b2)]
    g = tailconv.conv1x3x3_pool_dilated(t[0], t[1], t[2], (1, 1), 2)
    g = tailconv.conv1x3x3_pool_dilated(g, t[3], t[4], (2, 2), 2)
    g = tailconv.conv3x3_dilated(g, t[5], t[6], (1, 4, 4))
    assert tuple(g.shape) == ref.shape
    np.testing.assert_allclose(g.numpy(), ref, **TOL)


@pytest.mark.parametrize("n, cin, cout, sp, d, pool", [
    (2, 3, 17, (3, 11, 15), 1, 2),     # batch, Cout past one channel group
    (1, 20, 30, (2, 14, 37), 2, 2),    # the flagship's conv1 unit, ragged Y
    (1, 24, 16, (3, 9, 20), 1, 1),     # the probe's decoder layer
    (1, 2, 3, (2, 16, 19), 3, 2),
])
def test_plain_version_matches_jax_reference(n, cin, cout, sp, d, pool):
    rng = np.random.RandomState(cin + cout)
    x, w, b = _rand(rng, n, cin, *sp), _rand(rng, cout, cin, 1, 3, 3), \
        _rand(rng, cout)
    ref = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             (d, d), pool))
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    got = tailconv.conv1x3x3_pool_dilated(tx, tw, tb, (1, d, d), pool)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # a (Cout, Cin, 3, 3) filter is the same unit
    got4 = tailconv.conv1x3x3_pool_dilated(tx, tw[:, :, 0].contiguous(), tb,
                                           (d, d), pool)
    assert torch.equal(got, got4)


def test_cpu_runs_plain_version_without_launch():
    rng = np.random.RandomState(3)
    x, w, b = (torch.from_numpy(a) for a in (
        _rand(rng, 1, 4, 2, 10, 12), _rand(rng, 5, 4, 1, 3, 3),
        _rand(rng, 5)))
    before = tailconv.head_launches
    got = tailconv.conv1x3x3_pool_dilated(x, w, b)
    assert tailconv.head_launches == before
    assert torch.equal(got, tailconv.conv1x3x3_pool_reference(x, w, b))


@pytest.mark.parametrize("case, exc, match", [
    ("zdil", ValueError, "z-dilation"),
    ("aniso", ValueError, "anisotropic"),
    ("pool", ValueError, "pool must be 1 or 2"),
    ("relu", ValueError, "relu"),
    ("filter", ValueError, "needs \\(1,3,3\\)"),
    ("too_small", ValueError, "too small"),
    ("dtype", TypeError, "float32"),
    ("contiguous", ValueError, "contiguous"),
    ("bshape", ValueError, "b must be"),
    ("device", ValueError, "is on"),
])
def test_invalid_args_raise(case, exc, match):
    rng = np.random.RandomState(4)
    x, w, b = (torch.from_numpy(a) for a in (
        _rand(rng, 1, 4, 2, 10, 12), _rand(rng, 5, 4, 1, 3, 3),
        _rand(rng, 5)))
    kw = dict(dil=(1, 1), pool=2, relu=True)
    if case == "zdil":
        kw["dil"] = (2, 1, 1)
    elif case == "aniso":
        kw["dil"] = (1, 2)
    elif case == "pool":
        kw["pool"] = 3
    elif case == "relu":
        kw["relu"] = False
    elif case == "filter":
        w = torch.from_numpy(_rand(rng, 5, 4, 3, 3, 3))
    elif case == "too_small":
        x = x[..., :3].contiguous()
    elif case == "dtype":
        x = x.double()
    elif case == "contiguous":
        x = x.transpose(3, 4)
    elif case == "bshape":
        b = b[:3].contiguous()
    elif case == "device":
        w = w.to("meta")
    with pytest.raises(exc, match=match):
        tailconv.conv1x3x3_pool_dilated(x, w, b, **kw)


def test_probe_cases_and_bound():
    """The probe keeps the JAX probe's three cases and adds the wide
    U-Net's kz=1 layers at one 128x448x448 slab; it measures the card only."""
    from elektronn2_tpu_torch.scripts import exp_convdense_headk as probe
    cases = probe.cases()
    assert [c[0] for c in cases[:3]] == ["dec-96x512 24->16",
                                         "dec-128x512 24->16",
                                         "enc0-96x512 1->12"]
    assert cases[3][1:] == (1, 64, (136, 480, 480))
    assert cases[4][1:] == (128, 64, (128, 456, 456))
    # the flagship's conv1 unit: 3 x 354 GFLOP at 495 TFLOP/s (3xTF32)
    ms, by = probe.head_bound_ms(20, 30, (124, 518, 518), d=2, pool=2)
    assert by == "operations (3xTF32)" and abs(ms - 2.14) < 0.01
    ms, by = probe.head_bound_ms(1, 20, (124, 521, 521), d=1, pool=2)
    assert by == "bytes" and abs(ms - 0.84) < 0.01
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card only"):
            probe.main()
