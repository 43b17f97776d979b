"""P1 and P2, the port's probes of K1 (``elektronn2_tpu_torch.scripts.
exp_ptail_dot`` and ``exp_ptail_ablate``), against the JAX package.

On the CPU each wrapper runs its plain version: P1's is held against
``jax.lax.dot_general`` on the same operands (float32: atol 1e-4, sums of
up to 432 products in another order; bf16-rounded operands: rtol 1e-2, both
sides accumulating in float32), P2's ``full`` against the JAX tail conv's
``conv3x3_dilated_reference`` and ``noepi`` against the bare
``lax.conv_general_dilated`` it wraps (atol 1e-4). The CUDA kernels are
held against these plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import os
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from elektronn2_tpu.ops.pallas_tailconv import conv3x3_dilated_reference
from elektronn2_tpu_torch.scripts import exp_ptail_ablate as P2
from elektronn2_tpu_torch.scripts import exp_ptail_dot as P1

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dot_configs_are_the_jax_scripts():
    assert P1.configs() == [
        ("float32", 120, 360, 512), ("float32", 120, 360, 640),
        ("float32", 128, 360, 512), ("bfloat16", 120, 432, 512),
        ("bfloat16", 120, 432, 640), ("bfloat16", 128, 432, 512)]


@pytest.mark.parametrize("dt, M, K, N", P1.configs())
def test_dot_plain_matches_jax(dt, M, K, N):
    zb = 2
    rng = np.random.RandomState(M + K + N)
    w = rng.randn(M, K).astype(np.float32)
    x = rng.randn(zb * K, N).astype(np.float32)
    tw = torch.from_numpy(w).to(getattr(torch, dt))
    tx = torch.from_numpy(x).to(getattr(torch, dt))
    before = P1.launches
    got = P1.dot_rows(tw, tx, zb, n_cells=3)
    assert P1.launches == before
    jw, jx = jnp.asarray(w).astype(dt), jnp.asarray(x).astype(dt)
    ref = np.stack([np.asarray(jax.lax.dot_general(
        jw, jx[zz * K:(zz + 1) * K], (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32))[0] for zz in range(zb)])
    assert got.dtype == torch.float32 and tuple(got.shape) == (zb, N)
    tol = dict(atol=1e-4) if dt == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.numpy(), ref, **tol)


@pytest.mark.parametrize("case, exc, match", [
    ("mixed", TypeError, "both"),
    ("dtype", TypeError, "both"),
    ("shape", ValueError, "zb\\*K"),
    ("contiguous", ValueError, "contiguous"),
])
def test_dot_invalid_args_raise(case, exc, match):
    w, x, zb = torch.rand(4, 8), torch.rand(16, 128), 2
    if case == "mixed":
        x = x.bfloat16()
    elif case == "dtype":
        w, x = w.double(), x.double()
    elif case == "shape":
        zb = 3
    elif case == "contiguous":
        w = torch.rand(8, 4).t()
    with pytest.raises(exc, match=match):
        P1.dot_rows(w, x, zb)


def test_probe_names_are_the_jax_scripts():
    with open(os.path.join(REPO, "scripts", "exp_ptail_ablate.py")) as f:
        src = f.read()
    m = re.search(r'"PROBES",\s*"([a-z,]+)"', src)
    assert tuple(m.group(1).split(",")) == P2.PROBES


def _conv_inputs(seed, cin, cout, sp):
    rng = np.random.RandomState(seed)
    return (rng.randn(1, cin, *sp).astype(np.float32),
            (rng.randn(cout, cin, 3, 3, 3) / 30).astype(np.float32),
            rng.randn(cout).astype(np.float32))


@pytest.mark.parametrize("probe", ["full", "noepi"])
@pytest.mark.parametrize("cin, cout, sp, dil", [
    (5, 7, (6, 14, 19), (1, 4, 4)),     # the canonical shape, scaled down
    (9, 45, (5, 7, 8), (1, 1, 1)),      # two channel groups, d1-like
])
def test_ablate_plain_matches_jax(probe, cin, cout, sp, dil):
    x, w, b = _conv_inputs(cin + cout, cin, cout, sp)
    before = P2.launches
    got = P2.ablate(probe, *(torch.from_numpy(a) for a in (x, w, b)), dil)
    assert P2.launches == before
    if probe == "full":
        ref = conv3x3_dilated_reference(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(b), dil)
    else:
        dn = jax.lax.conv_dimension_numbers(x.shape, w.shape,
                                            ("NCDHW", "OIDHW", "NCDHW"))
        ref = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (1, 1, 1), "VALID",
            rhs_dilation=dil, dimension_numbers=dn)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("probe", [p for p in P2.PROBES
                                   if p not in ("full", "noepi")])
def test_timing_only_probes_have_no_plain_version(probe):
    x, w, b = (torch.from_numpy(a) for a in _conv_inputs(1, 2, 3, (5, 7, 7)))
    with pytest.raises(ValueError, match="timing only"):
        P2.ablate(probe, x, w, b, (1, 1, 1))


def test_unknown_probe_raises():
    x, w, b = (torch.from_numpy(a) for a in _conv_inputs(1, 2, 3, (5, 7, 7)))
    with pytest.raises(ValueError, match="unknown probe"):
        P2.ablate("nodma", x, w, b)


@pytest.mark.parametrize("main", [P1.main, P2.main])
def test_mains_raise_without_card(monkeypatch, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="on the card only"):
        main()
