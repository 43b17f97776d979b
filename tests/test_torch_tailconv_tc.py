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


# ---------------------------------------------------------------------------
# The kernel's plan (tc_plan) and data flow


def stage_rows_tc(x, plan, nn, zr, xs, y0, cc, dy, route):
    """A stage's staged rows as the kernel's producer stages them: for each
    x in ``xs`` (the R + 2 rows) and each segment (one of W values from y0,
    or three of 72 from y0 + ky dy), channels 8cc .. 8cc + 7 of plane zr;
    (rows, segments, 8, W) float32. The TMA route reads x flattened as (Z X
    Y, Cin, N), each box from the multiple of 4 at or before its first
    value: past Y or X a row runs on into the next row or plane, past Z X Y
    and Cin it reads zeros; the cp.async route starts at the first value and
    reads zeros past X, Y and Cin."""
    n, cin, Z, X, Y = x.shape
    W, nseg = plan["W"], 3 if plan["segmented"] else 1
    flat = x.reshape(n, cin, Z * X * Y)
    out = torch.zeros(len(xs), nseg, 8, W, dtype=torch.float32)
    c1 = min(cin, 8 * cc + 8)
    for j, xr in enumerate(xs):
        for s in range(nseg):
            ys = y0 + s * dy
            if route == "tma":
                f0 = ((zr * X + xr) * Y + ys) & ~3
                hi = min(Z * X * Y, f0 + W)
                if hi > f0:
                    out[j, s, :c1 - 8 * cc, :hi - f0] = flat[nn, 8 * cc:c1,
                                                              f0:hi]
            elif xr < X and ys < Y:
                hi = min(Y, ys + W)
                out[j, s, :c1 - 8 * cc, :hi - ys] = x[nn, 8 * cc:c1, zr, xr,
                                                      ys:hi]
    return out


def emulate_tc_kernel(x, w, b, dil, route=None):
    """K1's float32 kernel's data flow in plain PyTorch: the tiles of
    ``tc_plan`` in its order (zo fastest, then group, y tile, x tile, n),
    per tile and (chunk, kz) stage the R + 2 staged rows of the tile's x
    phase (``stage_rows_tc``, by ``route``, the plan's by default), per
    output row i the 9 taps (A = staged row i + kx from y ky dy, or segment
    ky, past the box's start before the row's first value on the TMA route;
    B = the packed tap, hi and lo) as the three TF32 products summed in
    float64 into fresh partials, then added into the row's float32 totals;
    bias, ReLU; only outputs inside the volume written."""
    n, cin, Z, X, Y = x.shape
    cout = w.shape[0]
    _, dx, dy = dil
    zo_n, xo_n, yo_n = Z - 2, X - 2 * dx, Y - 2 * dy
    plan = tailconv.tc_plan(n, cin, cout, Z, X, Y, dx, dy)
    route = route or plan["route"]
    NP, R, G = plan["NP"], plan["R"], plan["G"]
    wp = tailconv.pack_weights(w, NP)
    CC = wp.shape[1]
    # (G, CC, kz, kx, ky, hi/lo, k, n)
    taps = wp.double().permute(0, 1, 2, 3, 4, 5, 7, 9, 6, 8).reshape(
        G, CC, 3, 3, 3, 2, 8, NP)
    seg = plan["segmented"]
    xtp = -(-(-(-xo_n // dx)) // R)
    ytiles = -(-yo_n // 64)
    assert plan["ntiles"] == n * dx * xtp * ytiles * G * zo_n
    out = torch.full((n, cout, zo_n, xo_n, yo_n), float("nan"),
                     dtype=torch.float64)
    for t in range(plan["ntiles"]):
        zo, r = t % zo_n, t // zo_n
        g, r = r % G, r // G
        y0, r = (r % ytiles) * 64, r // ytiles
        xt, nn = r % (dx * xtp), r // (dx * xtp)
        px, i0 = xt % dx, (xt // dx) * R
        tot = torch.zeros(R, 64, NP, dtype=torch.float32)
        xs = [px + dx * (i0 + j) for j in range(R + 2)]
        for s in range(CC * 3):
            cc, kz = divmod(s, 3)
            rows = stage_rows_tc(x, plan, nn, zo + kz, xs, y0, cc, dy, route)
            hi, lo = (v.double() for v in tailconv.split_tf32(rows))
            for i in range(R):
                part = torch.zeros(64, NP, dtype=torch.float64)
                for kx in range(3):
                    f = (zo + kz) * X * Y + xs[i + kx] * Y + y0
                    for ky in range(3):
                        sh = ((f + ky * dy * seg) % 4 if route == "tma"
                              else 0)

                        def a(v):
                            if seg:
                                return v[i + kx, ky, :, sh:sh + 64].T
                            o = sh + ky * dy
                            return v[i + kx, 0, :, o:o + 64].T
                        bh, bl = taps[g, cc, kz, kx, ky]
                        part += a(hi) @ bh + a(hi) @ bl + a(lo) @ bh
                tot[i] += part.float()
        co = slice(g * NP, min(cout, (g + 1) * NP))
        nco = co.stop - co.start
        for i in range(R):
            xo = px + dx * (i0 + i)
            yv = min(64, yo_n - y0)
            if xo < xo_n and nco > 0:
                v = tot[i, :yv, :nco].double() + b[co].double()
                out[nn, co, zo, xo, y0:y0 + yv] = torch.relu(v).T
    assert not torch.isnan(out).any(), "an output no tile wrote"
    return out


EMU_CASES = [  # N, Cin, Cout, (Z, X, Y), dil, route
    (1, 9, 12, (4, 11, 20), (1, 2, 3), None),     # Y % 4 == 0, two chunks
    (2, 3, 5, (5, 20, 30), (1, 2, 3), None),      # Y % 4 != 0, Z X Y % 4
    (2, 3, 5, (5, 20, 30), (1, 2, 3), "cp_async"),
    (1, 4, 5, (3, 7, 21), (1, 1, 1), None),       # Z X Y odd: cp.async
    (1, 5, 130, (3, 5, 12), (1, 1, 1), None),     # 2 groups of 128
    (1, 3, 8, (3, 5, 140), (1, 1, 1), None),      # 3 y tiles
    (1, 3, 5, (3, 4, 160), (1, 1, 77), None),     # segmented rows
    (1, 3, 5, (3, 4, 159), (1, 1, 77), "cp_async"),
    (1, 3, 5, (4, 3, 158), (1, 1, 75), None),     # segmented, Y % 4 != 0
    (1, 9, 12, (4, 9, 29), (1, 2, 3), "tma"),     # Y odd, box starts early
]


@pytest.mark.parametrize("n, cin, cout, sp, dil, route", EMU_CASES)
def test_tc_kernel_emulation_matches_f64(n, cin, cout, sp, dil, route):
    x, w, b = (torch.from_numpy(a)
               for a in _inputs(cin * 10 + cout, n, cin, cout, sp, he=True))
    plan = tailconv.tc_plan(n, cin, cout, *sp, dil[1], dil[2])
    if route is None:
        assert plan["route"] == ("tma" if (sp[0] * sp[1] * sp[2]) % 4 == 0
                                 else "cp_async")
    assert plan["segmented"] == (dil[2] >= 75)
    got = emulate_tc_kernel(x, w, b, dil, route)
    ref = torch.relu(F.conv3d(x.double(), w.double(), b.double(),
                              dilation=dil))
    assert (got - ref).abs().max().item() <= F64_ATOL
    plain = tailconv.conv3x3_dilated_reference(x, w, b, dil)
    torch.testing.assert_close(got.float(), plain, **TOL)


@pytest.mark.parametrize("cout, NP, G", [
    (1, 8, 1), (5, 8, 1), (40, 40, 1), (45, 48, 1), (64, 64, 1),
    (65, 128, 1), (96, 128, 1), (128, 128, 1), (130, 128, 2),
    (200, 128, 2), (256, 128, 2)])
def test_tc_plan_tile_and_registers(cout, NP, G):
    """The N tile (``n_tile``): Cout rounded up to 8 up to 64, else 128 in
    ceil(Cout / 128) groups. Up to N 64 a consumer warpgroup holds 4 m64
    tiles (8 rows a block tile), totals and partials 5 NP / 2 <= 160
    registers a thread; at N 128 one (2 rows), 128 registers."""
    plan = tailconv.tc_plan(1, 16, cout, 4, 9, 70, 1, 1)
    assert (plan["NP"], plan["G"]) == (NP, G) and NP == tailconv.n_tile(cout)
    assert G * NP >= cout > (G - 1) * NP
    T = 4 if NP <= 64 else 1
    assert (plan["T"], plan["R"]) == (T, 2 * T)
    assert plan["acc_regs"] == (T + 1) * NP // 2 <= 160


def test_tc_plan_main_path_staged_bytes():
    """The bytes the producer stages (the kernel's own count on the card):
    a (tile, chunk, kz) stage is 10 rows of 8 x 72 floats and its 9 taps of
    hi/lo weights. At the flagship's request, 34.5 + 42.5 = 77.0 GB (the
    body before staged about 235 GB); at the U-Net's d1 (N tile 128: 4 rows
    and 9 taps of 128 channels a stage), 464.8 GB (before: 483 GB)."""
    c2 = tailconv.tc_plan(1, 30, 40, 124, 512, 512, 4, 4)
    # 4 phases x 16 x tiles (126 rows) x 8 y tiles x 122 planes; 4 chunks
    assert c2["ntiles"] == 4 * 16 * 8 * 122
    assert c2["slot_bytes"] == 10 * 8 * 72 * 4 + 9 * 2 * 40 * 8 * 4 == 46080
    assert c2["staged_bytes"] == 62464 * 4 * 3 * 46080 == 34540093440
    c3 = tailconv.tc_plan(1, 40, 40, 122, 504, 504, 4, 4)
    assert c3["staged_bytes"] == 4 * 16 * 8 * 120 * 5 * 3 * 46080 \
        == 42467328000
    assert c2["staged_bytes"] + c3["staged_bytes"] <= 80e9
    d1 = tailconv.tc_plan(1, 256, 128, 130, 230, 230, 1, 1)
    # 114 x tiles (228 rows) x 4 y tiles x 1 group x 128 planes
    assert (d1["NP"], d1["G"], d1["ntiles"]) == (128, 1, 114 * 4 * 128)
    assert d1["slot_bytes"] == 4 * 8 * 72 * 4 + 9 * 2 * 128 * 8 * 4 == 82944
    assert d1["staged_bytes"] == 58368 * 32 * 3 * 82944 == 464762437632
    for p in (c2, c3):
        assert (p["stages"], p["smem"], p["route"]) == (5, 230784, "tma")
    assert (d1["stages"], d1["smem"], d1["route"]) == (2, 166272, "tma")


@pytest.mark.parametrize("cout", [1, 8, 16, 24, 32, 40, 48, 56, 64, 65, 128,
                                  200, 256])
def test_tc_plan_fits_at_every_n_tile_and_dy(cout):
    """Shared memory within the H100's 232,448 bytes and a ring of at least
    2 at every N tile and every y-dilation, segmented rows included (past
    216 values a row is three segments of 72, one per ky); the row stride 8
    mod 16 floats and at least 64 + 2dy (or 64 a segment), 3 more where a
    TMA box may start up to 3 values before its first (Y % 4 != 0, or a
    segment's y dy % 4 != 0)."""
    for dy in list(range(1, 130)) + [200, 500, 1000]:
        for Y in (2 * dy + 1, 2 * dy + 4 - 2 * dy % 4):
            p = tailconv.tc_plan(1, 8, cout, 3, 3, Y, 1, dy)
            assert p["smem"] <= tailconv.H100_SMEM_OPTIN
            assert p["stages"] >= 2
            assert p["W"] % 16 == 8 and p["rowb"] % 128 == 0
            pad = 3 if Y % 4 else 0
            assert p["segmented"] == (64 + 2 * dy + pad > 216)
            assert p["W"] >= (67 if p["segmented"] else 64 + 2 * dy + pad)
    with pytest.raises(ValueError, match="does not fit"):
        tailconv.tc_plan(1, 8, cout, 3, 3, 70, 1, 1, smem=40000)


@pytest.mark.parametrize("sp, aligned, route", [
    ((6, 64, 300), True, "tma"),        # Y % 4 == 0
    ((4, 23, 30), True, "tma"),         # Y % 4 != 0, Z X Y % 4 == 0
    ((5, 21, 30), True, "cp_async"),    # Z X Y % 4 == 2
    ((3, 7, 21), True, "cp_async"),     # Z X Y odd
    ((6, 64, 300), False, "cp_async"),  # x not 16-byte aligned
])
def test_tc_plan_route(sp, aligned, route):
    assert tailconv.tc_plan(1, 8, 40, *sp, 1, 1,
                            aligned=aligned)["route"] == route


@pytest.mark.parametrize("n, cin, cout, sp, dil", [
    (1, 30, 40, (124, 512, 512), (1, 4, 4)),
    (1, 256, 128, (130, 230, 230), (1, 1, 1)),
    (2, 3, 5, (5, 20, 30), (1, 2, 3)),
    (1, 11, 200, (4, 9, 70), (1, 1, 1)),
    (1, 16, 24, (4, 10, 470), (1, 1, 200)),
])
def test_tc_plan_covers_every_output_once(n, cin, cout, sp, dil):
    Z, X, Y = sp
    dx, dy = dil[1:]
    plan = tailconv.tc_plan(n, cin, cout, Z, X, Y, dx, dy)
    R, G = plan["R"], plan["G"]
    zo_n, xo_n, yo_n = Z - 2, X - 2 * dx, Y - 2 * dy
    xtp = -(-(-(-xo_n // dx)) // R)
    assert plan["ntiles"] == n * dx * xtp * -(-yo_n // 64) * G * zo_n
    hits = np.zeros(xo_n, dtype=np.int64)
    for xt in range(dx * xtp):
        px, i0 = xt % dx, (xt // dx) * R
        for i in range(R):
            if px + dx * (i0 + i) < xo_n:
                hits[px + dx * (i0 + i)] += 1
    assert (hits == 1).all()
    assert plan["G"] * plan["NP"] >= cout
    assert plan["grid"] == min(plan["ntiles"], tailconv.H100_SMS)


def test_tc_dispatch_counts_no_launch_on_the_cpu():
    x, w, b = (torch.from_numpy(a) for a in _inputs(3, 1, 4, 5, (5, 10, 12)))
    before = (tailconv.launches, tailconv.tc_cp_async_launches)
    y = tailconv.conv3x3_dilated(x, w, b, (1, 2, 2))
    assert torch.equal(y, tailconv.conv3x3_dilated_reference(x, w, b,
                                                             (1, 2, 2)))
    assert (tailconv.launches, tailconv.tc_cp_async_launches) == before
    with pytest.raises(ValueError, match="empty output"):
        tailconv.tc_plan(1, 4, 5, 2, 10, 12, 1, 1)
