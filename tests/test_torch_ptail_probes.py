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

The parts of the kernels that run in Python or can be emulated here: P1's
float32 weight packing (round trip to the TF32 split of the padded
weights), a plain emulation of P1's float32 arithmetic (3xTF32 products,
partials promoted into float32 totals every ``PROMOTE`` k chunks of 8) held
against ``jax.lax.dot_general`` (atol 1e-4) and against float64 by the
card's rule (at most 2x the plain float32 version's error + 1e-6), and
P2's wrapper refusing a Cout whose N tile it was not built for.
"""

import os
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from elektronn2_tpu.ops.pallas_tailconv import conv3x3_dilated_reference
from elektronn2_tpu_torch.ops import tailconv
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


def emulate_p1_f32(w, x, zb):
    """P1's float32 arithmetic in plain PyTorch: each product hi*lo + lo*hi
    + hi*hi of TF32 parts (exact in float32), summed in float32 over
    ``PROMOTE`` k chunks of 8, each such partial added into float32 totals;
    row 0 of each of the zb products."""
    K = w.shape[1]
    step = 8 * P1.PROMOTE
    wh, wl = tailconv.split_tf32(w)
    rows = []
    for zz in range(zb):
        xh, xl = tailconv.split_tf32(x[zz * K:(zz + 1) * K].contiguous())
        acc = torch.zeros(w.shape[0], x.shape[1])
        for k0 in range(0, K, step):
            s = slice(k0, k0 + step)
            acc += wl[:, s] @ xh[s] + wh[:, s] @ xl[s] + wh[:, s] @ xh[s]
        rows.append(acc[0])
    return torch.stack(rows)


@pytest.mark.parametrize("dt, M, K, N", P1.configs())
def test_p1_3xtf32_emulation_matches_jax_and_float64(dt, M, K, N):
    # the float32 kernel's arithmetic at every config's shape (the bf16
    # configs' K = 432 too), on float32 operands
    zb = 2
    rng = np.random.RandomState(M + K + N)
    w = rng.randn(M, K).astype(np.float32)
    x = rng.randn(zb * K, N).astype(np.float32)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    got = emulate_p1_f32(tw, tx, zb)
    jw, jx = jnp.asarray(w), jnp.asarray(x)
    ref = np.stack([np.asarray(jax.lax.dot_general(
        jw, jx[zz * K:(zz + 1) * K], (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32))[0] for zz in range(zb)])
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    r64 = np.stack([(w.astype(np.float64)
                     @ x[zz * K:(zz + 1) * K].astype(np.float64))[0]
                    for zz in range(zb)])
    k64 = np.abs(got.double().numpy() - r64).max()
    p64 = np.abs(P1.dot_rows_reference(tw, tx, zb).double().numpy()
                 - r64).max()
    assert k64 <= 2 * p64 + 1e-6, (k64, p64)


@pytest.mark.parametrize("M, K", [(120, 360), (128, 360), (5, 16)])
def test_p1_pack_weights_round_trip(M, K):
    w = torch.from_numpy(np.random.RandomState(M + K).randn(M, K).astype(
        np.float32))
    wp = P1.pack_weights(w)
    KP = -(-K // 24) * 24                              # whole stages
    assert tuple(wp.shape) == (KP // 8, 2, P1.NT // 8, 2, 8, 4)
    assert wp.is_contiguous() and wp.dtype == torch.float32
    # (chunk, hi/lo, 8-row group, k half, row, 4 k) -> (hi/lo, row, k)
    full = wp.permute(1, 2, 4, 0, 3, 5).reshape(2, P1.NT, KP)
    hi, lo = tailconv.split_tf32(w)
    assert torch.equal(full[0, :M, :K], hi)
    assert torch.equal(full[1, :M, :K], lo)
    assert not bool(full[:, M:].any())                 # padded rows zero
    assert not bool(full[:, :, K:].any())              # padded k zero
    assert P1.pack_weights(w).equal(wp)
    assert tailconv.packed_weights(w, P1.NT, P1.pack_weights) is \
        tailconv.packed_weights(w, P1.NT, P1.pack_weights)


def test_dot_only_is_card_only():
    w, x = torch.rand(4, 16), torch.rand(32, 128)
    with pytest.raises(ValueError, match="timing only"):
        P1.dot_rows(w, x, 2, dot_only=True)


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
    (5, 40, (6, 14, 19), (1, 4, 4)),    # the canonical shape, scaled down
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
    x, w, b = (torch.from_numpy(a) for a in _conv_inputs(1, 2, 40, (5, 7, 7)))
    with pytest.raises(ValueError, match="timing only"):
        P2.ablate(probe, x, w, b, (1, 1, 1))


@pytest.mark.parametrize("cout, tile", [(7, 8), (20, 24), (64, 64),
                                        (32, 32)])
def test_ablate_refuses_unbuilt_n_tiles(cout, tile):
    # raised before the device branch: the same on the CPU as on the card
    assert tailconv.n_tile(cout) == tile and tile not in P2.N_TILES
    x, w, b = (torch.from_numpy(a)
               for a in _conv_inputs(1, 2, cout, (5, 7, 7)))
    with pytest.raises(ValueError, match=r"N tiles \(40, 48, 128\)"):
        P2.ablate("full", x, w, b)


@pytest.mark.parametrize("cout", [33, 40, 41, 45, 65, 128, 256])
def test_ablate_takes_built_n_tiles(cout):
    assert tailconv.n_tile(cout) in P2.N_TILES
    x, w, b = (torch.from_numpy(a)
               for a in _conv_inputs(2, 2, cout, (5, 7, 7)))
    out = P2.ablate("noepi", x, w, b)
    assert tuple(out.shape) == (1, cout, 3, 5, 5)


@pytest.mark.parametrize("shape, cout, dil, want", [
    # Yo 7 <= 64: one tile a row, two rows a block: Xo 5 -> 3 x blocks,
    # 2 z rows, 1 group; Cin 9 -> 2 chunks x 9 taps; rows of 64 + 2 wide
    ((1, 9, 4, 7, 9), 40, (1, 1, 1),
     (2 * 3 * 18 * 4 * 3 * 2 * 40 * 8, 2 * 3 * 18 * 4 * 2 * 8 * 66)),
    # Yo 92 > 64: two tiles a row, one row a block: one y block of 128,
    # rows 128 + 8 wide; Cout 128 at N tile 128, Cin 8 -> 1 chunk
    ((2, 8, 3, 10, 100), 128, (1, 2, 4),
     (2 * 1 * 6 * 1 * 9 * 4 * 3 * 2 * 128 * 8,
      2 * 1 * 6 * 1 * 9 * 4 * 1 * 8 * 136)),
])
def test_k1_staged_bytes(shape, cout, dil, want):
    assert P2.k1_staged_bytes(shape, cout, dil) == want


def test_unknown_probe_raises():
    x, w, b = (torch.from_numpy(a) for a in _conv_inputs(1, 2, 3, (5, 7, 7)))
    with pytest.raises(ValueError, match="unknown probe"):
        P2.ablate("nodma", x, w, b)


@pytest.mark.parametrize("main", [P1.main, P2.main])
def test_mains_raise_without_card(monkeypatch, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="on the card only"):
        main()
