"""K4's tensor-core body: its arithmetic, weight packing and dispatch, on
the CPU.

On the card K4 (``csrc/headconv.cu``) has two bodies: a 3xTF32 implicit
GEMM on ``wgmma`` (``tailconv.head_tc``), K1's with kz = 1 and the pool in
its epilogue, and exact FFMA (``tailconv.head_ffma``); the wrapper picks one
by Cin. These tests hold the parts that run in Python to their contract,
and a plain PyTorch emulation of the tensor-core body's arithmetic (in this
file only, not on any route) to the JAX package's
``conv1x3x3_pool_reference``:

- the kz=1 packing round-trips to (Cout, Cin, 1, 3, 3), its padding zero,
  the same from a (Cout, Cin, 3, 3) filter; ``packed_weights`` serves K4's
  packing until the weight's version changes;
- the emulation in float32 within 1e-4 of the JAX reference (sums of up to
  9*Cin products in another order), with pool 1 and 2, d 1 to 3 and Cout at
  three N tiles; summed in float64, so that only the split's error shows,
  within 1e-6 of a float64 conv at Cin 128 with He-scaled weights (the wide
  U-Net's d0: 1152 products, each off by at most ~2^-21 of itself);
- which body the wrapper runs for which Cin, and the N tile;
- the build cache: a library's key changes when a header it includes
  changes, so a stale library is never loaded.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax.numpy as jnp

from elektronn2_tpu.ops.pallas_tailconv import (
    conv1x3x3_pool_reference as jax_ref)
from elektronn2_tpu_torch.ops import tailconv
from elektronn2_tpu_torch.utils import cuda_build

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
F64_ATOL = 1e-6


def _inputs(seed, n, cin, cout, sp, he=False):
    rng = np.random.RandomState(seed)
    x = (rng.rand(n, cin, *sp) - 0.5).astype(np.float32)
    w = rng.rand(cout, cin, 1, 3, 3) - 0.5
    if he:
        w = w * (2.0 / (9 * cin)) ** 0.5
    b = (rng.rand(cout) * 0.2 - 0.1).astype(np.float32)
    return x, w.astype(np.float32), b


def emulate_head_3xtf32(x, w, b, d, pool, dtype=torch.float32):
    """The tensor-core body's arithmetic in plain PyTorch: the three TF32
    products summed in ``dtype``, + bias, the dilated (2,2) max with
    ``pool=2``, then ReLU."""
    xh, xl = (t.to(dtype) for t in tailconv.split_tf32(x))
    wh, wl = (t.to(dtype) for t in tailconv.split_tf32(w))
    dil = (1, d, d)
    y = (F.conv3d(xh, wh, dilation=dil) + F.conv3d(xh, wl, dilation=dil)
         + F.conv3d(xl, wh, dilation=dil)) + b.to(dtype).view(1, -1, 1, 1, 1)
    if pool == 2:
        y = F.max_pool3d(y, (1, 2, 2), stride=1, dilation=dil)
    return torch.relu(y)


def unpack_head_weights(wp, cout, cin):
    """Inverse of ``pack_weights`` at kz = 1: (G, CC, 1, kx, ky, hl, ng, kh,
    r, c) -> (hi, lo), each (Cout, Cin, 1, 3, 3), and the padded block."""
    G, CC, NP = wp.shape[0], wp.shape[1], wp.shape[6] * 8
    full = wp.permute(5, 0, 6, 8, 1, 7, 9, 2, 3, 4).reshape(
        2, G * NP, CC * tailconv.K_CHUNK, 1, 3, 3)
    return full[0, :cout, :cin], full[1, :cout, :cin], full


@pytest.mark.parametrize("cin", [1, 20, 128])
@pytest.mark.parametrize("cout, pool", [(5, 2), (30, 2), (64, 1), (72, 2),
                                        (128, 1)])
def test_pack_weights_kz1_round_trip(cout, pool, cin):
    w = torch.from_numpy(_inputs(cout + cin, 1, cin, cout, (1, 1, 1))[1])
    NP = tailconv.head_n_tile(cout, pool)
    wp = tailconv.pack_weights(w, NP)
    G, CC = -(-cout // NP), -(-cin // 8)
    assert tuple(wp.shape) == (G, CC, 1, 3, 3, 2, NP // 8, 2, 8, 4)
    assert wp.is_contiguous() and wp.dtype == torch.float32
    hi, lo, full = unpack_head_weights(wp, cout, cin)
    assert torch.equal(hi, tailconv.tf32_round(w))
    err = (w.double() - (hi.double() + lo.double())).abs()
    assert bool((err <= 2.0 ** -21 * w.double().abs()).all())
    mask = torch.ones_like(full, dtype=torch.bool)
    mask[:, :cout, :cin] = False
    assert not bool(full[mask].any())              # the padding is zero
    # a (Cout, Cin, 3, 3) filter is the same unit
    assert torch.equal(tailconv.pack_weights(w[:, :, 0].contiguous(), NP), wp)


def test_head_weights_packed_once_per_version():
    w = torch.from_numpy(_inputs(6, 1, 20, 30, (1, 1, 1))[1])
    NP = tailconv.head_n_tile(30, 2)
    first = tailconv.packed_weights(w, NP)
    assert tailconv.packed_weights(w, NP) is first
    assert torch.equal(first, tailconv.pack_weights(w, NP))
    with torch.no_grad():
        w.add_(1.0)                                  # bumps w's version
    again = tailconv.packed_weights(w, NP)
    assert again is not first
    assert torch.equal(again, tailconv.pack_weights(w, NP))


@pytest.mark.parametrize("cout", [5, 30, 64])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("pool", [1, 2])
def test_3xtf32_emulation_matches_jax_reference(pool, d, cout):
    cin = 20
    dp = d * (pool - 1)
    sp = (2, 2 * d + dp + 5, 2 * d + dp + 7)
    x, w, b = _inputs(cout * 10 + d, 2, cin, cout, sp)
    got = emulate_head_3xtf32(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), d, pool)
    ref = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             (d, d), pool))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("cout, d, pool", [(64, 1, 1), (30, 2, 2)])
def test_3xtf32_split_error_float64(cout, d, pool):
    cin = 128
    dp = d * (pool - 1)
    sp = (2, 2 * d + dp + 4, 2 * d + dp + 5)
    x, w, b = (torch.from_numpy(a)
               for a in _inputs(cout + d, 1, cin, cout, sp, he=True))
    got = emulate_head_3xtf32(x, w, b, d, pool, dtype=torch.float64)
    ref = tailconv.conv1x3x3_pool_reference(x.double(), w.double(),
                                            b.double(), (d, d), pool)
    err = (got - ref).abs().max().item()
    assert err <= F64_ATOL, err
    # the split is what keeps it: one TF32 product alone is far off
    one = tailconv.conv1x3x3_pool_reference(
        tailconv.tf32_round(x).double(), tailconv.tf32_round(w).double(),
        b.double(), (d, d), pool)
    assert (one - ref).abs().max().item() > 10 * err


def test_dispatch_by_cin():
    lo, lo16 = tailconv.HEAD_TC_MIN_CIN, tailconv.HEAD_TC_MIN_CIN_N16
    # N tile over 16 (the flagship's conv1: 20 -> 30 pool 2; the wide
    # U-Net's e0a and d0: -> 64 pool 1)
    assert [tailconv.head_body(c, 30, 2) for c in (1, lo - 1, lo, 20)] \
        == ["ffma", "ffma", "tc", "tc"]
    assert [tailconv.head_body(c, 64, 1) for c in (1, 128)] == ["ffma", "tc"]
    # N tile 16 or less (the U-Net's dec 24 -> 16, enc0 1 -> 12; Cout 72
    # with pool 2 runs N 64)
    assert [tailconv.head_body(c, 16, 1) for c in (1, lo, lo16 - 1, lo16, 24)] \
        == ["ffma", "ffma", "ffma", "tc", "tc"]
    assert tailconv.head_body(lo16 - 1, 12, 2) == "ffma"
    assert tailconv.head_body(lo, 72, 2) == "tc"
    # N tile: Cout padded to 8 up to 64; above, 128 with pool 1, 64 with
    # pool 2 (the pool ring beside the stage ring)
    assert [tailconv.head_n_tile(c, 1) for c in (5, 30, 64, 65, 200)] \
        == [8, 32, 64, 128, 128]
    assert [tailconv.head_n_tile(c, 2) for c in (5, 30, 64, 65, 200)] \
        == [8, 32, 64, 64, 64]


@pytest.mark.parametrize("body", [tailconv.head_tc, tailconv.head_ffma])
def test_bodies_launch_or_raise_never_fall_back(body):
    x, w, b = (torch.from_numpy(a)
               for a in _inputs(8, 1, 20, 30, (2, 12, 14)))
    before = (tailconv.head_launches, tailconv.head_tc_launches)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        body(x, w, b, (2, 2), 2)
    with pytest.raises(ValueError, match="contiguous"):
        body(x.transpose(3, 4), w, b, (1, 1), 2)
    assert (tailconv.head_launches, tailconv.head_tc_launches) == before


def test_build_key_follows_included_headers(tmp_path):
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <stdint.h>\n'
                                   "int f() { return g(); }\n")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("inline int g() { return 1; }\n")
    (tmp_path / "other.cuh").write_text("inline int h() { return 2; }\n")
    src = str(tmp_path / "k.cu")
    key = cuda_build.source_key(src)
    assert cuda_build.source_key(src) == key
    (tmp_path / "other.cuh").write_text("inline int h() { return 3; }\n")
    assert cuda_build.source_key(src) == key        # not included
    (tmp_path / "b.cuh").write_text("inline int g() { return 2; }\n")
    changed = cuda_build.source_key(src)
    assert changed != key                           # included, nested
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <stdint.h>\n'
                                   "int f() { return -g(); }\n")
    assert cuda_build.source_key(src) not in (key, changed)

