"""K1 (``elektronn2_tpu_torch.ops.tailconv``) against the JAX tail conv.

On the CPU the port's ``conv3x3_dilated`` runs its plain PyTorch version;
it is held against the JAX package's ``conv3x3_dilated_reference`` (and, on
one tiny case, the Pallas kernel in interpret mode) on the same numpy inputs.
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
Tolerance 1e-4: float32 sums of up to 1080 products, in another order.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from elektronn2_tpu.ops.pallas_tailconv import (
    conv3x3_dilated as jax_conv3x3_dilated,
    conv3x3_dilated_reference as jax_conv3x3_dilated_reference)
from elektronn2_tpu_torch.ops import tailconv

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, n, cin, cout, sp):
    rng = np.random.RandomState(seed)
    x = (rng.rand(n, cin, *sp) - 0.5).astype(np.float32)
    w = (rng.rand(cout, cin, 3, 3, 3) - 0.5).astype(np.float32)
    b = (rng.rand(cout) - 0.5).astype(np.float32)
    return x, w, b


def _jax_ref(x, w, b, dil):
    return np.asarray(jax_conv3x3_dilated_reference(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dil))


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("cout", [5, 40])
@pytest.mark.parametrize("cin", [3, 30])
@pytest.mark.parametrize("dil", [(1, 1, 1), (1, 2, 2), (1, 4, 4), (1, 2, 3)])
def test_matches_jax_reference(dil, cin, cout, n):
    sp = (5, 2 * dil[1] + 5, 2 * dil[2] + 7)
    x, w, b = _inputs(cin * 100 + cout + n, n, cin, cout, sp)
    got = tailconv.conv3x3_dilated(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b), dil)
    ref = _jax_ref(x, w, b, dil)
    assert tuple(got.shape) == ref.shape == (
        n, cout, sp[0] - 2, sp[1] - 2 * dil[1], sp[2] - 2 * dil[2])
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_matches_pallas_kernel_interpret():
    x, w, b = _inputs(7, 1, 5, 7, (5, 12, 14))
    dil = (1, 2, 3)
    ref = np.asarray(jax_conv3x3_dilated(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dil, interpret=True,
        z_block=4))
    got = tailconv.conv3x3_dilated(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b), dil)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_cpu_runs_plain_version_without_launch():
    x, w, b = (torch.from_numpy(a) for a in _inputs(3, 1, 4, 4, (6, 10, 12)))
    before = tailconv.launches
    got = tailconv.conv3x3_dilated(x, w, b, (1, 1, 1))
    ref = tailconv.conv3x3_dilated_reference(x, w, b, (1, 1, 1))
    assert tailconv.launches == before
    assert torch.equal(got, ref)


def _small():
    return tuple(torch.from_numpy(a) for a in _inputs(3, 1, 4, 4, (6, 10, 12)))


@pytest.mark.parametrize("case, exc, match", [
    ("zdil", ValueError, "z-dilation"),
    ("relu", ValueError, "relu"),
    ("too_small", ValueError, "too small"),
    ("dtype", TypeError, "float32"),
    ("contiguous", ValueError, "contiguous"),
    ("wshape", ValueError, "w must be"),
    ("bshape", ValueError, "b must be"),
    ("device", ValueError, "is on"),
])
def test_invalid_args_raise(case, exc, match):
    x, w, b = _small()
    dil, relu = (1, 1, 1), True
    if case == "zdil":
        dil = (2, 1, 1)
    elif case == "relu":
        relu = False
    elif case == "too_small":
        x = x[:, :, :2].contiguous()
    elif case == "dtype":
        x = x.double()
    elif case == "contiguous":
        x = x.transpose(3, 4)
    elif case == "wshape":
        w = w[:, :3].contiguous()
    elif case == "bshape":
        b = b[:3].contiguous()
    elif case == "device":
        w = w.to("meta")
    with pytest.raises(exc, match=match):
        tailconv.conv3x3_dilated(x, w, b, dil, relu=relu)
