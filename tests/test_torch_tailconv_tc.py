"""K1's tensor-core arithmetic and weight packing, on the CPU.

On the card K1 (``csrc/tailconv.cu``) is a 3xTF32 implicit GEMM: each
float32 operand splits into TF32 hi and lo parts, and each product is
hi*hi + hi*lo + lo*hi, accumulated in float32. These tests hold the parts
that run in Python (the split, :func:`tailconv.pack_weights`) to their
contract, and a plain PyTorch emulation of the kernel's arithmetic (in this
file only, not on any route) to the JAX package's
``conv3x3_dilated_reference``:

- the split: ``hi`` has its low 13 mantissa bits zero and
  ``|w - (hi + lo)| <= 2^-21 |w|``; the packing round-trips to
  (Cout, Cin, 3, 3, 3), its padding zero; ``packed_weights`` serves the
  packing of the same tensor until its version changes;
- the emulation in float32 within 1e-4 of the JAX reference (the tolerance
  of ``test_torch_tailconv.py``: float32 sums of up to 1080 products in
  another order), and, summed in float64 so that only the split's error
  shows, within 1e-6 of a float64 conv at Cin 256 with He-scaled weights
  (``chip_smoke.py``'s scaling): 6912 products, each off by at most
  ~2^-21 of itself.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax.numpy as jnp

from elektronn2_tpu.ops.pallas_tailconv import (
    conv3x3_dilated_reference as jax_conv3x3_dilated_reference)
from elektronn2_tpu_torch.ops import tailconv

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
F64_ATOL = 1e-6


def unpack_weights(wp, cout, cin):
    """Inverse of ``pack_weights``: (G, CC, kz, kx, ky, hl, ng, kh, r, c)
    -> (hi, lo), each (Cout, Cin, 3, 3, 3), and the padded block."""
    G, CC, NP = wp.shape[0], wp.shape[1], wp.shape[6] * 8
    full = wp.permute(5, 0, 6, 8, 1, 7, 9, 2, 3, 4).reshape(
        2, G * NP, CC * tailconv.K_CHUNK, 3, 3, 3)
    return full[0, :cout, :cin], full[1, :cout, :cin], full


def emulate_3xtf32(x, w, b, dil, dtype=torch.float32):
    """The kernel's arithmetic in plain PyTorch: the three TF32 products,
    summed in ``dtype``, + bias, ReLU."""
    xh, xl = (t.to(dtype) for t in tailconv.split_tf32(x))
    wh, wl = (t.to(dtype) for t in tailconv.split_tf32(w))
    dil = tuple(int(d) for d in dil)
    y = (F.conv3d(xh, wh, dilation=dil) + F.conv3d(xh, wl, dilation=dil)
         + F.conv3d(xl, wh, dilation=dil))
    return torch.relu(y + b.to(dtype).view(1, -1, 1, 1, 1))


def _inputs(seed, n, cin, cout, sp, he=False):
    rng = np.random.RandomState(seed)
    x = (rng.rand(n, cin, *sp) - 0.5).astype(np.float32)
    w = rng.rand(cout, cin, 3, 3, 3) - 0.5
    if he:
        w = w * (2.0 / (27 * cin)) ** 0.5
    b = (rng.rand(cout) * 0.2 - 0.1).astype(np.float32)
    return x, w.astype(np.float32), b


@pytest.mark.parametrize("cin", [3, 30, 64])
@pytest.mark.parametrize("cout", [5, 40, 45, 128])
def test_pack_weights_split_and_round_trip(cout, cin):
    w = torch.from_numpy(_inputs(cout * 7 + cin, 1, cin, cout, (1, 1, 1))[1])
    NP = tailconv.n_tile(cout)
    wp = tailconv.pack_weights(w, NP)
    G, CC = -(-cout // NP), -(-cin // 8)
    assert tuple(wp.shape) == (G, CC, 3, 3, 3, 2, NP // 8, 2, 8, 4)
    assert wp.is_contiguous() and wp.dtype == torch.float32
    hi, lo, full = unpack_weights(wp, cout, cin)
    # hi is TF32: the low 13 of float32's 23 mantissa bits are zero
    assert int((hi.contiguous().view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert int((lo.contiguous().view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = (w.double() - (hi.double() + lo.double())).abs()
    assert bool((err <= 2.0 ** -21 * w.double().abs()).all())
    assert torch.equal(hi, tailconv.tf32_round(w))
    # the padding (Cout to G*NP, Cin to 8*CC) is zero
    mask = torch.ones_like(full, dtype=torch.bool)
    mask[:, :cout, :cin] = False
    assert not bool(full[mask].any())


def test_packed_weights_cached_until_w_changes():
    w = torch.from_numpy(_inputs(5, 1, 3, 5, (1, 1, 1))[1])
    first = tailconv.packed_weights(w, 8)
    assert tailconv.packed_weights(w, 8) is first
    assert torch.equal(first, tailconv.pack_weights(w, 8))
    assert tailconv.packed_weights(w, 16) is not first      # another N tile
    with torch.no_grad():
        w.mul_(2.0)                                          # bumps w's version
    again = tailconv.packed_weights(w, 8)
    assert again is not first
    assert torch.equal(again, tailconv.pack_weights(w, 8))


def test_packed_weights_cache_is_bounded_and_keyed_on_the_tensor():
    ws = [torch.from_numpy(_inputs(i, 1, 3, 5, (1, 1, 1))[1])
          for i in range(tailconv.PACKED_CACHE + 3)]
    packed = [tailconv.packed_weights(w, 8) for w in ws]
    assert len(tailconv._packed) <= tailconv.PACKED_CACHE
    # an equal tensor that is another object is packed anew, not served
    # another's entry
    twin = ws[-1].clone()
    assert tailconv.packed_weights(twin, 8) is not packed[-1]
    assert tailconv.packed_weights(ws[-1], 8) is packed[-1]


def test_n_tile():
    assert [tailconv.n_tile(c) for c in (1, 5, 8, 40, 45, 64, 65, 128, 256)] \
        == [8, 8, 8, 40, 48, 64, 128, 128, 128]


@pytest.mark.parametrize("v, want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),      # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),      # just under the tie: down
    (3.0, 3.0),
    (0.0, 0.0),
])
def test_tf32_round_half_away_from_zero(v, want):
    got = tailconv.tf32_round(torch.tensor([v], dtype=torch.float32))
    assert got.item() == want


@pytest.mark.parametrize("cin, cout", [(3, 5), (30, 40)])
@pytest.mark.parametrize("dil", [(1, 1, 1), (1, 2, 2), (1, 4, 4), (1, 2, 3)])
def test_3xtf32_emulation_matches_jax_reference(dil, cout, cin):
    sp = (5, 2 * dil[1] + 5, 2 * dil[2] + 7)
    x, w, b = _inputs(cin * 100 + cout, 2, cin, cout, sp)
    got = emulate_3xtf32(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), dil)
    ref = np.asarray(jax_conv3x3_dilated_reference(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dil))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("cout, dil", [(8, (1, 1, 1)), (16, (1, 2, 3))])
def test_3xtf32_split_error_float64(cout, dil):
    cin = 256
    sp = (4, 2 * dil[1] + 3, 2 * dil[2] + 4)
    x, w, b = (torch.from_numpy(a)
               for a in _inputs(cout + 3, 1, cin, cout, sp, he=True))
    got = emulate_3xtf32(x, w, b, dil, dtype=torch.float64)
    ref = torch.relu(F.conv3d(x.double(), w.double(), b.double(),
                              dilation=dil))
    err = (got - ref).abs().max().item()
    assert err <= F64_ATOL, err
    # the split is what keeps it (here ~3e-8): one TF32 product alone is
    # ~1e-4 off
    xh, wh = tailconv.tf32_round(x), tailconv.tf32_round(w)
    one = torch.relu(F.conv3d(xh.double(), wh.double(), b.double(),
                              dilation=dil))
    assert (one - ref).abs().max().item() > 10 * err
