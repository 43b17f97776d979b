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
  the kernel's descriptor reads, each (chunk, kz) stage's 9 taps one
  contiguous run; and a plain emulation of the kernel's data flow (the
  bf16 copy of x in its (N, Z, X, CG, Y, 8) layout, the tile walk of
  ``bf16_plan``, R + 2 staged rows of one x phase a (tile, 16-channel
  chunk, kz) stage with zeros past every edge, the 9 (kx, ky) taps of a
  row read at row + kx and y start ky dy, the stage's partials added into
  float32-rounded totals) within 1e-6 of float64 and 1e-5 of the plain
  version;
- ``bf16_plan``: every output of every shape covered once by the tiles,
  the staged bytes the kernel counts, the tile choice, the segmented rows
  past dy = 96 (three TMA boxes of 64 values, one per ky; the emulation
  above runs them at dy 97 and 128), the refusal;
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
    # past dy = 96 a staged row is three segments of 64, one per ky: the
    # smallest Y that dy allows
    (1, 3, 5, (3, 4, 196), (1, 1, 97)),
    (1, 3, 5, (3, 4, 258), (1, 1, 128)),
]


def _inputs(seed, n, cin, cout, sp):
    rng = np.random.RandomState(seed)
    x = (rng.rand(n, cin, *sp) - 0.5).astype(np.float32)
    w = ((rng.rand(cout, cin, 3, 3, 3) - 0.5)
         * (2.0 / (27 * cin)) ** 0.5).astype(np.float32)
    b = (rng.rand(cout) * 0.2 - 0.1).astype(np.float32)
    return x, w, b


def n_tile(cout):
    """The bf16 kernel's N tile for ``cout`` (``bf16_plan``'s)."""
    return tailconv.bf16_plan(1, 16, cout, 4, 9, 70, 1, 1)["NP"]


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
    NP = n_tile(cout)
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
    # the bytes of one tap: core matrices of 8 rows x 16 bytes, the two k
    # halves 128 bytes apart, the 8-row groups 256 bytes apart; a (group,
    # chunk, kz) stage's 9 taps one run of 9 NP 32 bytes, (kx, ky) in order
    flat = wp.reshape(-1).view(torch.int16)
    g, cc, kz, kx, ky, co, ci = 0, CC - 1, 1, 2, 0, min(cout, NP) - 1, 3
    cc_ci = (CC - 1) * 16 + ci
    if cc_ci < cin:
        stage = (g * CC + cc) * 3 + kz
        off = (stage * 9 * NP * 16 + (kx * 3 + ky) * NP * 16
               + (co // 8) * 128 + (ci // 8) * 64 + (co % 8) * 8 + ci % 8)
        assert flat[off] == w[co, cc_ci, kz, kx, ky].bfloat16().view(
            torch.int16)
    # the packed copy is cached per weight tensor, apart from the TF32 one
    assert tailconv.packed_weights(w, NP, tailconv.pack_weights_bf16) is \
        tailconv.packed_weights(w, NP, tailconv.pack_weights_bf16)
    assert tailconv.packed_weights(w, NP).dtype == torch.float32


def stage_rows(xb, n, z, xs, starts, width, cc):
    """The TMA boxes of a stage as the kernel stages them: for each x in
    ``xs`` (the R + 2 rows) and each y start in ``starts`` (one box a row,
    or three segments, one per ky), channel groups 2cc, 2cc + 1, y start ..
    y start + width - 1 of plane z, zeros past X and Y; (rows, boxes, 2,
    width, 8) float64."""
    _, _, X, _, Y, _ = xb.shape
    out = torch.zeros(len(xs), len(starts), 2, width, 8, dtype=torch.float64)
    for j, x in enumerate(xs):
        for k, y0 in enumerate(starts):
            hi = min(Y, y0 + width)
            if x < X and hi > y0:
                out[j, k, :, :hi - y0] = xb[n, z, x, 2 * cc:2 * cc + 2,
                                            y0:hi].double()
    return out


def emulate_kernel(x, wp, b, dil, cout):
    """The kernel's data flow in plain PyTorch (float64 products, float32
    totals): the tiles of ``bf16_plan`` in its order, per tile and (chunk,
    kz) stage the R + 2 staged rows of the tile's x phase, per output row i
    the 9 taps (A = staged row i + kx from y ky dy, or its segment ky when
    the plan is ``segmented``: a 64 x 16 tile, K-major by channel group;
    B = the packed tap) summed into fresh partials, then added into the
    row's totals, rounded to float32 as the kernel's FADD does; bias, ReLU;
    only outputs inside the volume written."""
    n, cin, Z, X, Y = x.shape
    _, dx, dy = dil
    zo_n, xo_n, yo_n = Z - 2, X - 2 * dx, Y - 2 * dy
    plan = tailconv.bf16_plan(n, cin, cout, Z, X, Y, dx, dy)
    NP, R, G = plan["NP"], plan["R"], plan["G"]
    assert tuple(wp.shape[:2]) == (G, -(-cin // 16))
    CC = wp.shape[1]
    taps = wp.double().permute(0, 1, 2, 3, 4, 6, 8, 5, 7).reshape(
        G, CC, 3, 3, 3, 16, NP)                 # (..., k, n)
    xb = tailconv.bf16_layout(x)
    ys, seg = plan["ys"], plan["segmented"]
    assert ys == (192 if seg else 64 + 2 * dy) and seg == (dy > 96)
    xtp = -(-(-(-xo_n // dx)) // R)
    ytiles = -(-yo_n // 64)
    out = torch.full((n, cout, zo_n, xo_n, yo_n), float("nan"),
                     dtype=torch.float64)
    for t in range(plan["ntiles"]):
        zo, r = t % zo_n, t // zo_n
        g, r = r % G, r // G
        y0, r = (r % ytiles) * 64, r // ytiles
        xt, nn = r % (dx * xtp), r // (dx * xtp)
        px, i0 = xt % dx, (xt // dx) * R
        tot = torch.zeros(R, 64, NP, dtype=torch.float32)
        for s in range(CC * 3):
            cc, kz = divmod(s, 3)
            xs = [px + dx * (i0 + j) for j in range(R + 2)]
            if seg:
                rows = stage_rows(xb, nn, zo + kz, xs,
                                  [y0 + ky * dy for ky in range(3)], 64, cc)
            else:
                rows = stage_rows(xb, nn, zo + kz, xs, [y0], ys, cc)
            for i in range(R):
                part = torch.zeros(64, NP, dtype=torch.float64)
                for kx in range(3):
                    for ky in range(3):
                        a = (rows[i + kx, ky] if seg else
                             rows[i + kx, 0, :, ky * dy:ky * dy + 64])
                        a = a.permute(1, 0, 2).reshape(64, 16)
                        part += a @ taps[g, cc, kz, kx, ky]
                tot[i] += part.float()
        co = slice(g * NP, min(cout, (g + 1) * NP))
        nco = co.stop - co.start
        for i in range(R):
            xo = px + dx * (i0 + i)
            yv = min(64, yo_n - y0)
            if xo < xo_n:
                v = tot[i, :yv, :nco].double() + b[co].double()
                out[nn, co, zo, xo, y0:y0 + yv] = torch.relu(v).T
    assert not torch.isnan(out).any(), "an output no tile wrote"
    return out


@pytest.mark.parametrize("n, cin, cout, sp, dil", CASES)
def test_kernel_emulation_matches_f64(n, cin, cout, sp, dil):
    x, w, b = (torch.from_numpy(a) for a in _inputs(23, n, cin, cout, sp))
    wp = tailconv.pack_weights_bf16(w, n_tile(cout))
    got = emulate_kernel(x, wp, b, dil, cout)
    ref = f64_of_rounded(x.numpy(), w.numpy(), b.numpy(), dil)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= F64_REL * scale
    plain = tailconv.conv3x3_dilated_bf16_reference(x, w, b, dil)
    assert float((plain.double() - got).abs().max()) <= REL * scale


@pytest.mark.parametrize("cout, want", [(1, 8), (5, 8), (40, 40), (64, 64),
                                        (65, 128), (96, 128), (128, 128),
                                        (200, 128)])
def test_bf16_plan_tile_choice(cout, want):
    """The N tile: Cout rounded up to 8 up to 64, else 128-channel groups;
    4 m64 tiles a warpgroup up to N 64, 2 above (8 or 4 rows a block)."""
    plan = tailconv.bf16_plan(1, 16, cout, 4, 9, 70, 1, 1)
    assert plan["NP"] == want and plan["G"] == -(-cout // want)
    assert plan["T"] == (4 if want <= 64 else 2) and plan["R"] == 2 * plan["T"]


PLAN_SHAPES = [  # n, cin, cout, (Z, X, Y), (dx, dy)
    (1, 30, 40, (124, 512, 512), (4, 4)),      # the flagship's conv2
    (1, 40, 40, (122, 504, 504), (4, 4)),      # conv3
    (1, 256, 128, (130, 230, 230), (1, 1)),    # the wide U-Net's d1
    (2, 3, 5, (5, 20, 30), (2, 3)),
    (1, 30, 45, (5, 40, 300), (4, 4)),
    (1, 11, 200, (4, 9, 70), (1, 1)),
    (1, 20, 24, (6, 40, 301), (2, 3)),
    (1, 16, 24, (4, 10, 470), (1, 200)),       # segmented rows
]


@pytest.mark.parametrize("n, cin, cout, sp, dil", PLAN_SHAPES)
def test_bf16_plan_covers_every_output_once(n, cin, cout, sp, dil):
    Z, X, Y = sp
    dx, dy = dil
    plan = tailconv.bf16_plan(n, cin, cout, Z, X, Y, dx, dy)
    R, G = plan["R"], plan["G"]
    zo_n, xo_n, yo_n = Z - 2, X - 2 * dx, Y - 2 * dy
    xtp = -(-(-(-xo_n // dx)) // R)
    ytiles = -(-yo_n // 64)
    assert plan["ntiles"] == n * dx * xtp * ytiles * G * zo_n
    # a tile's rows: one x phase, R apart in the phase; counted per
    # (n, zo, xo, y tile, group)
    hits = np.zeros((n, zo_n, xo_n, ytiles, G), dtype=np.int64)
    for xt in range(dx * xtp):
        px, i0 = xt % dx, (xt // dx) * R
        for i in range(R):
            xo = px + dx * (i0 + i)
            if xo < xo_n:
                hits[:, :, xo] += 1
        # the staged rows: R + 2 of the same phase, the last one the kx = 2
        # tap of the last row
        assert px + dx * (i0 + R + 1) == px + dx * (i0 + R - 1) + 2 * dx
    assert (hits == 1).all()
    # shared memory within the card's opt-in, the ring at least 2 deep
    assert plan["smem"] <= tailconv.H100_SMEM_OPTIN and plan["stages"] >= 2
    assert plan["rsb"] % 128 == 0 and plan["rsb"] >= 32 * plan["ys"]


def test_bf16_plan_main_path_shapes():
    """The flagship's weights are held in shared memory for the launch and
    staged once a block; d1's (1.77 MB) are streamed a stage at a time, each
    stage shared by 4 m64 tiles; the staged bytes are what the kernel
    counts: R + 2 rows a (tile, chunk, kz) stage, plus the weights."""
    c2 = tailconv.bf16_plan(1, 30, 40, 124, 512, 512, 4, 4)
    assert c2["resident"] and c2["NP"] == 40 and c2["R"] == 8
    wres = 2 * 27 * 40 * 32
    box = 32 * c2["ys"]
    assert c2["staged_bytes"] == (c2["ntiles"] * 6 * (c2["R"] + 2) * box
                                  + c2["grid"] * wres)
    d1 = tailconv.bf16_plan(1, 256, 128, 130, 230, 230, 1, 1)
    assert not d1["resident"] and d1["R"] == 4 and d1["NP"] == 128
    assert d1["staged_bytes"] == d1["ntiles"] * 48 * (
        6 * 32 * 66 + 9 * 128 * 32)
    # the first design staged 52.6 GB at conv2 and 165.7 GB at d1 (its own
    # count on an H100); this one a sixth and under half of that
    assert c2["staged_bytes"] < 52.6e9 / 6
    assert d1["staged_bytes"] < 165.7e9 / 2


def test_bf16_plan_refusals_and_scratch():
    # a staged row is one TMA box up to dy = 96 (256 values, a box's most),
    # past it three boxes of 64, one per ky: 192 values, 6144 bytes
    p96 = tailconv.bf16_plan(1, 4, 4, 5, 10, 300, 1, 96)
    assert p96["ys"] == 256 and not p96["segmented"]
    for dy in (97, 128, 200):
        p = tailconv.bf16_plan(1, 4, 4, 5, 10, 2 * dy + 70, 1, dy)
        assert p["segmented"] and p["ys"] == 192 and p["rsb"] == 6144
        assert p["staged_bytes"] == (p["ntiles"] * 3 * (p["R"] + 2) * 6144
                                     + p["grid"] * 3 * 9 * 8 * 32)
    with pytest.raises(ValueError, match="does not fit"):
        tailconv.bf16_plan(1, 4, 4, 5, 10, 300, 1, 4, smem=20000)
    # the scratch: (n, Z, X, CG, Y, 8) bf16
    assert tailconv.bf16_scratch_bytes(2, 30, 5, 7, 9) == 2 * 5 * 7 * 4 * 9 * 16
    # the bf16 copy of x (the first kernel; on the CPU its plain version)
    x = torch.from_numpy(_inputs(25, 2, 20, 4, (3, 4, 5))[0])
    xb = tailconv.bf16_layout(x)
    assert xb.dtype == torch.bfloat16 and xb.is_contiguous()
    assert tuple(xb.shape) == (2, 3, 4, 4, 5, 8)
    assert xb.numel() * 2 == tailconv.bf16_scratch_bytes(2, 20, 3, 4, 5)
    assert torch.equal(xb, tailconv.bf16_layout_reference(x))
    assert torch.equal(xb[1, 2, 3, 1, 4], x[1, 8:16, 2, 3, 4].bfloat16())
    assert not xb[:, :, :, 2, :, 4:].float().abs().sum()   # channels 20-23
    with pytest.raises(ValueError, match="contiguous float32"):
        tailconv.bf16_layout(x.transpose(3, 4))


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
    # a y-dilation past one box a row (segmented on the card)
    xw = torch.from_numpy(_inputs(26, 1, 2, 2, (3, 4, 200))[0])
    wy = torch.from_numpy(_inputs(26, 1, 2, 2, (3, 4, 200))[1])
    bw = torch.zeros(2)
    assert tailconv.conv3x3_dilated(xw, wy, bw, (1, 1, 97),
                                    compute_dtype="bfloat16").shape[-1] == 6
