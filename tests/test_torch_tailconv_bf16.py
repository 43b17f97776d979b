"""K1's bfloat16 mode on the CPU: its plain version against the JAX
package's Pallas kernel, and its weight packing.

On the card ``conv3x3_dilated(..., compute_dtype="bfloat16")`` launches
``csrc/tailconv_bf16.cu``: x and w rounded to bf16 (nearest even), their
products summed in float32 on the tensor cores (``wgmma`` m64nNk16), bias
and ReLU fused. These tests hold what runs here:

- the plain version (``conv3x3_dilated_bf16_reference``: a float32 conv of
  the bf16-rounded operands) against ``pallas_tailconv.conv3x3_dilated(
  compute_dtype="bfloat16", interpret=True)``, the JAX kernel run in its
  interpreter, at Cin not a multiple of 16 (the kernels pad Cin to 16):
  within 1e-5 of the output's largest magnitude (a bf16 product is exact in
  float32, so the two differ only by float32 sums in another order; both
  within 1e-6 of a float64 sum of the same rounded operands);
- ``pack_weights_bf16``: the bf16 values of w, zero-padded, at the places
  the kernel's descriptor reads, and a plain emulation of the kernel's
  stage loop over the packed tiles (16-channel chunks, 3 ky shifts a stage,
  partials added into the totals every 3 stages) within 1e-6 of float64;
- the dispatch: ``compute_dtype`` is checked, the CPU runs the plain
  version and counts no launch.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax.numpy as jnp

from elektronn2_tpu.ops.pallas_tailconv import conv3x3_dilated as jax_k1
from elektronn2_tpu_torch.ops import tailconv

torch.set_num_threads(1)
REL = 1e-5
F64_REL = 1e-6

CASES = [  # N, Cin, Cout, (Z, X, Y), dil
    (1, 20, 12, (6, 21, 26), (1, 2, 2)),     # Cin padded 20 -> 32
    (1, 30, 40, (5, 22, 24), (1, 4, 4)),     # the flagship's conv2 widths
    (1, 3, 5, (4, 11, 14), (1, 1, 1)),       # one ragged chunk
]


def _inputs(seed, n, cin, cout, sp):
    rng = np.random.RandomState(seed)
    x = (rng.rand(n, cin, *sp) - 0.5).astype(np.float32)
    w = ((rng.rand(cout, cin, 3, 3, 3) - 0.5)
         * (2.0 / (27 * cin)) ** 0.5).astype(np.float32)
    b = (rng.rand(cout) * 0.2 - 0.1).astype(np.float32)
    return x, w, b


def f64_of_rounded(x, w, b, dil):
    """relu(conv3d) in float64 of the bf16-rounded operands."""
    xr = torch.from_numpy(x).bfloat16().double()
    wr = torch.from_numpy(w).bfloat16().double()
    return torch.relu(F.conv3d(xr, wr, torch.from_numpy(b).double(),
                               dilation=dil))


@pytest.mark.parametrize("n, cin, cout, sp, dil", CASES)
def test_plain_version_matches_jax_interpret(n, cin, cout, sp, dil):
    x, w, b = _inputs(21, n, cin, cout, sp)
    want = np.asarray(jax_k1(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             dil=dil, compute_dtype="bfloat16",
                             interpret=True))
    got = tailconv.conv3x3_dilated(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b), dil,
                                   compute_dtype="bfloat16")
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REL * scale)
    ref = f64_of_rounded(x, w, b, dil).numpy()
    for y in (got.numpy(), want):
        assert float(np.abs(y - ref).max()) <= F64_REL * scale
    # bf16 operands: far from the float32 conv's values
    f32 = tailconv.conv3x3_dilated_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), dil)
    assert float((got - f32).abs().max()) > 10 * REL * scale


def unpack_bf16(wp, cout, cin):
    """Inverse of ``pack_weights_bf16``: (G, CC, kz, kx, ky, ng, kh, r, k8)
    -> (Cout, Cin, 3, 3, 3) bf16, and the padded block."""
    G, CC, NP = wp.shape[0], wp.shape[1], wp.shape[5] * 8
    full = wp.permute(0, 5, 7, 1, 6, 8, 2, 3, 4).reshape(
        G * NP, CC * tailconv.K_CHUNK_BF16, 3, 3, 3)
    return full[:cout, :cin], full


@pytest.mark.parametrize("cout, cin", [(40, 30), (12, 20), (200, 17),
                                       (5, 3)])
def test_pack_weights_bf16_layout(cout, cin):
    w = torch.from_numpy(_inputs(22, 1, cin, cout, (3, 3, 3))[1])
    NP = tailconv.n_tile(cout)
    wp = tailconv.pack_weights_bf16(w, NP)
    G, CC = -(-cout // NP), -(-cin // 16)
    assert wp.dtype == torch.bfloat16
    assert tuple(wp.shape) == (G, CC, 3, 3, 3, NP // 8, 2, 8, 8)
    assert wp.is_contiguous()
    got, full = unpack_bf16(wp, cout, cin)
    assert torch.equal(got, w.bfloat16())
    pad = full.clone()
    pad[:cout, :cin] = 0
    assert not pad.float().abs().sum()
    # the bytes of one ky tile: core matrices of 8 rows x 16 bytes, the two
    # k halves 128 bytes apart, the 8-row groups 256 bytes apart
    flat = wp.reshape(-1).view(torch.int16)
    g, cc, kz, kx, ky, co, ci = 0, CC - 1, 1, 2, 0, min(cout, NP) - 1, 3
    cc_ci = (CC - 1) * 16 + ci
    if cc_ci < cin:
        tile = (((g * CC + cc) * 3 + kz) * 3 + kx) * 3 + ky
        off = (tile * NP * 16 + (co // 8) * 128 + (ci // 8) * 64
               + (co % 8) * 8 + ci % 8)
        assert flat[off] == w[co, cc_ci, kz, kx, ky].bfloat16().view(
            torch.int16)
    # the packed copy is cached per weight tensor, apart from the TF32 one
    assert tailconv.packed_weights(w, NP, tailconv.pack_weights_bf16) is \
        tailconv.packed_weights(w, NP, tailconv.pack_weights_bf16)
    assert tailconv.packed_weights(w, NP).dtype == torch.float32


def emulate_kernel(x, wp, b, dil, cout):
    """The kernel's stage loop in plain PyTorch (float64 sums): per
    16-channel chunk, kz, kx (a stage) and ky, the bf16 input rows times the
    packed tile; the partials of 3 stages added into the totals; bias,
    ReLU."""
    n, cin, Z, X, Y = x.shape
    _, dx, dy = dil
    zo, xo, yo = Z - 2, X - 2 * dx, Y - 2 * dy
    G, CC = wp.shape[:2]
    NP = wp.shape[5] * 8
    xb = F.pad(x.bfloat16().double(), (0, 0, 0, 0, 0, 0, 0, CC * 16 - cin))
    tiles = wp.double().permute(0, 1, 2, 3, 4, 6, 8, 5, 7).reshape(
        G, CC, 3, 3, 3, 16, NP)                 # (..., k, n)
    out = torch.zeros(n, G * NP, zo, xo, yo, dtype=torch.float64)
    for g in range(G):
        acc = torch.zeros(n, NP, zo, xo, yo, dtype=torch.float64)
        part = torch.zeros_like(acc)
        steps = CC * 9
        for s in range(steps):
            cc, tap = divmod(s, 9)
            kz, kx = divmod(tap, 3)
            for ky in range(3):
                a = xb[:, cc * 16:(cc + 1) * 16, kz:kz + zo,
                       kx * dx:kx * dx + xo, ky * dy:ky * dy + yo]
                part += torch.einsum("bkzxy,kn->bnzxy", a,
                                     tiles[g, cc, kz, kx, ky])
            if s % 3 == 2 or s == steps - 1:
                acc += part
                part.zero_()
        out[:, g * NP:(g + 1) * NP] = acc
    return torch.relu(out[:, :cout] + b.double().view(1, -1, 1, 1, 1))


@pytest.mark.parametrize("n, cin, cout, sp, dil", CASES)
def test_kernel_emulation_matches_f64(n, cin, cout, sp, dil):
    x, w, b = (torch.from_numpy(a) for a in _inputs(23, n, cin, cout, sp))
    wp = tailconv.pack_weights_bf16(w, tailconv.n_tile(cout))
    got = emulate_kernel(x, wp, b, dil, cout)
    ref = f64_of_rounded(x.numpy(), w.numpy(), b.numpy(), dil)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= F64_REL * scale
    plain = tailconv.conv3x3_dilated_bf16_reference(x, w, b, dil)
    assert float((plain.double() - got).abs().max()) <= REL * scale


def test_dispatch_and_launch_count():
    x, w, b = (torch.from_numpy(a) for a in _inputs(24, 1, 4, 4,
                                                   (5, 10, 12)))
    before = tailconv.bf16_launches
    y = tailconv.conv3x3_dilated(x, w, b, (1, 2, 2),
                                 compute_dtype="bfloat16")
    assert torch.equal(y, tailconv.conv3x3_dilated_bf16_reference(
        x, w, b, (1, 2, 2)))
    assert tailconv.bf16_launches == before        # the CPU launches none
    with pytest.raises(ValueError, match="compute_dtype"):
        tailconv.conv3x3_dilated(x, w, b, compute_dtype="float16")
    with pytest.raises(ValueError, match="z-dilation must be 1"):
        tailconv.conv3x3_dilated(x, w, b, (2, 1, 1),
                                 compute_dtype="bfloat16")
    with pytest.raises(TypeError, match="float32"):
        tailconv.conv3x3_dilated(x.bfloat16(), w, b,
                                 compute_dtype="bfloat16")
