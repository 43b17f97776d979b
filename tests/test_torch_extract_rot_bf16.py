"""K3's bf16 mode: the plain version against the JAX package's kernel.

``extract_rot.rotated_patches_bf16_reference`` (the arithmetic the CUDA
kernel runs: bf16 volume values, bf16-rounded (z, x) corner weights,
float32 sums) is held against the JAX package's
``rotated_patches_pallas(compute_dtype="bfloat16", interpret=True)`` on the
same volume, positions and frames: max abs <= 3e-2 over in-bounds agents
(the JAX kernel test's bound, ``tests/test_pallas_extract_rot.py``), ``ok``
equal, and the error against float64 truth at its 50th and 99th percentile
within 1.1x of the JAX mode's own. The kernel is held against this plain
version bit for bit on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from elektronn2_tpu.ops.pallas_extract_rot import rotated_patches_pallas
from elektronn2_tpu_torch.data.tracing_utils import flight_frame
from elektronn2_tpu_torch.ops import extract_rot

torch.set_num_threads(1)
BF16_ATOL = 3e-2
PCT_RATIO = 1.1


def _case(seed, B, shape=(1, 16, 32, 256), patch=(4, 4, 4), margin=7.0):
    """The JAX kernel test's geometry (``_rand_case``): positions a margin
    inside the volume, random headings."""
    rng = np.random.RandomState(seed)
    vol = rng.rand(*shape).astype(np.float32)
    dims = np.asarray(shape[1:], np.float32)
    pos = rng.uniform(margin, dims - margin, (B, 3)).astype(np.float32)
    F = flight_frame(torch.from_numpy(rng.randn(B, 3).astype(np.float32)))
    return vol, pos, F.numpy(), patch


def _truth(vol, pos, F, patch):
    """The float64 trilinear patches at the float64 coordinates."""
    got, _ = extract_rot.rotated_patches_reference(
        torch.from_numpy(vol).double(), torch.from_numpy(pos).double(),
        torch.from_numpy(F).double(), patch)
    return got.numpy()


@pytest.mark.parametrize("seed, B", [(6, 8), (21, 96)])
def test_bf16_plain_matches_jax_bf16_kernel(seed, B):
    vol, pos, F, patch = _case(seed, B)
    vb = torch.from_numpy(vol).to(torch.bfloat16)
    got, ok = extract_rot.rotated_patches_bf16(
        vb, torch.from_numpy(pos), torch.from_numpy(F), patch)
    ref, ok_ref = rotated_patches_pallas(
        jnp.asarray(vol), jnp.asarray(pos), jnp.asarray(F), patch,
        compute_dtype="bfloat16", interpret=True)
    ref, ok_ref = np.asarray(ref), np.asarray(ok_ref)
    np.testing.assert_array_equal(ok.numpy(), ok_ref)
    m = ok_ref
    assert m.all()
    got = got.numpy()
    assert np.abs(got[m] - ref[m]).max() <= BF16_ATOL
    truth = _truth(vol, pos, F, patch)
    mine = np.abs(got[m] - truth[m]).ravel()
    theirs = np.abs(ref[m] - truth[m]).ravel()
    for q in (50, 99):
        assert np.percentile(mine, q) <= PCT_RATIO * np.percentile(theirs, q), \
            (q, np.percentile(mine, q), np.percentile(theirs, q))
    # and bf16 is a real rounding: far from the float32 mode, near float64
    f32, _ = extract_rot.rotated_patches(
        torch.from_numpy(vol), torch.from_numpy(pos), torch.from_numpy(F),
        patch)
    assert np.abs(f32.numpy()[m] - truth[m]).max() < 1e-5 < mine.max()


def test_bf16_plain_rounds_as_specified():
    """One agent whose frame is the identity, at a position with known
    fractions: the value is the spec's sum, built here in numpy."""
    rng = np.random.RandomState(3)
    vol = rng.rand(1, 12, 12, 12).astype(np.float32)
    pos = np.asarray([[5.3, 6.7, 5.55]], np.float32)
    F = np.eye(3, dtype=np.float32)[None]
    patch = (1, 1, 1)
    got, ok = extract_rot.rotated_patches_bf16(
        torch.from_numpy(vol).to(torch.bfloat16), torch.from_numpy(pos),
        torch.from_numpy(F), patch)
    assert bool(ok[0])

    def bf(x):
        return torch.tensor(x, dtype=torch.float32).to(
            torch.bfloat16).float().item()

    c0 = np.floor(pos[0]).astype(int)
    fr = (pos[0] - np.floor(pos[0])).astype(np.float32)
    w = [(np.float32(1) - fr[d], fr[d]) for d in range(3)]
    out = np.float32(0)
    for dy in (0, 1):
        t = np.float32(0)
        for dz in (0, 1):
            for dx in (0, 1):
                v = bf(vol[0, c0[0] + dz, c0[1] + dx, c0[2] + dy])
                t = np.float32(t + np.float32(bf(w[0][dz] * w[1][dx]) * v))
        out = np.float32(out + np.float32(w[2][dy] * t))
    assert got.item() == out


def test_bf16_wrapper_checks_dtype_and_counts_no_cpu_launch():
    vol, pos, F, patch = _case(4, 3)
    before = extract_rot.launches_bf16
    with pytest.raises(TypeError, match="bfloat16"):
        extract_rot.rotated_patches_bf16(
            torch.from_numpy(vol), torch.from_numpy(pos),
            torch.from_numpy(F), patch)
    extract_rot.rotated_patches_bf16(
        torch.from_numpy(vol).to(torch.bfloat16), torch.from_numpy(pos),
        torch.from_numpy(F), patch)
    assert extract_rot.launches_bf16 == before


def test_window_rows_hold_any_shift():
    """A staged row of n values from any offset within 16 bytes fits the
    row ``row_values`` gives it: 4-byte values (the float32 mode's window)
    and 2-byte ones (the bf16 mode's window is the pair window, tested
    below)."""
    for elem, per in ((4, 4), (2, 8)):
        for n in range(1, 40):
            rv = extract_rot.row_values(n, elem)
            assert rv % per == 0
            assert all(s + n <= rv for s in range(per))
            assert rv - per < per - 1 + n       # no whole piece to spare


# ------------------------------------------------ the bf16 mode's pair window

def _stage_row(vals, s, ext_y, aligned):
    """The pair words ``stage_pairs`` (``csrc/extract_rot.cu``) writes for
    one staged row: ``vals`` holds the row's values from its 16-byte piece's
    start (``s`` values before the box's first y), the box is ``ext_y``
    values long. Returns {word: (value at y, value at y + 1)}, the words the
    kernel stores, the positions it loads, and par."""
    par = s & 1 if aligned else 0
    words, loaded = {}, set()
    for c in range((ext_y + 13) // 8):
        if 8 * c > s + ext_y - 2:
            continue
        piece = list(range(8 * c, 8 * c + 8))
        loaded.update(piece)
        if 8 * c + 7 <= s + ext_y - 2:
            loaded.add(8 * c + 8)
        pairs = [(vals[q], vals[q + 1]) for q in piece]
        if aligned:
            j0, jn = 8 * c - s + par, ext_y - 2 + par
            assert j0 % 2 == 0
            for q in range(0, 8, 2):
                if 0 <= j0 + q <= jn:
                    words[j0 + q], words[j0 + q + 1] = pairs[q], pairs[q + 1]
        else:
            for q in range(8):
                if 0 <= 8 * c - s + q <= ext_y - 2:
                    words[8 * c - s + q] = pairs[q]
    return words, loaded, par


@pytest.mark.parametrize("aligned", [True, False])
def test_pair_window_holds_every_corner_at_any_shift(aligned):
    """The bf16 mode's pair window, emulated: at every shift of a row's
    start within its 16-byte piece and every y edge, each word a sample can
    read (``ly + par``, ly in [0, ext_y - 2]) was written, with the values
    at y and y + 1 of the box; the words written are ``pair_words``' count
    and fit a row of ``pair_pitches``; every value a sample reads was
    loaded."""
    for s in range(8):
        for ext_y in range(2, 41):
            vals = np.arange(s + ext_y + 16) * 1.0   # position -> value
            words, loaded, par = _stage_row(vals, s, ext_y, aligned)
            for ly in range(ext_y - 1):
                y = s + ly                            # the corner's position
                assert words[ly + par] == (vals[y], vals[y + 1])
                assert {y, y + 1} <= loaded
            assert len(words) == extract_rot.pair_words(ext_y, par, aligned)
            row, plane, planes = extract_rot.pair_pitches(
                (32, 32, 32), (1, 40, 40, ext_y))
            assert max(words) < row and row % 2 == 0 and row % 4 == 2
            assert plane % 2 == 0 and plane >= 40 * row and planes == 40


def _bf16_round(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _kernel_emulation(vol, pos, F, patch):
    """The bf16 kernel's data flow in numpy float32: each item's box
    (``load_agent``), its rows staged into a pair window of
    ``pair_pitches`` (:func:`_stage_row` a row), the column walk of
    ``blend_pairs`` reading four pair words a staged sample (a corner
    outside the box, or an item not staged, read from the volume) and
    ``pair_sum``'s arithmetic in its order."""
    f32 = np.float32
    f, Z, X, Y = vol.shape
    dims = (Z, X, Y)
    aligned = Y % 8 == 0
    RX, RZ, planes = extract_rot.pair_pitches(patch, vol.shape)
    half = [f32(0.5) * f32(p - 1) for p in patch]
    B = pos.shape[0]
    out = np.zeros((B, f) + tuple(patch), np.float32)
    ok = np.ones(B, bool)
    flat = vol.reshape(f, -1)
    for b in range(B):
        fr, p0 = F[b].astype(f32), pos[b].astype(f32)
        lo, ext, interior = [], [], True
        for d in range(3):
            t = f32(abs(fr[0, d]) * half[0]) + f32(abs(fr[1, d]) * half[1])
            t = f32(t + f32(abs(fr[2, d]) * half[2]))
            e = f32(f32(abs(p0[d]) + t) * f32(2.0 ** -20))
            lo_f = np.floor(f32(f32(p0[d] - t) - e))
            hi_f = np.floor(f32(f32(p0[d] + t) + e)) + 1
            interior &= lo_f >= 0 and hi_f <= dims[d] - 2
            lo_c = min(max(lo_f, 0.0), dims[d] - 2)
            hi_c = min(max(hi_f, lo_c + 1.0), dims[d] - 1)
            lo.append(int(lo_c))
            ext.append(int(hi_c) - int(lo_c) + 1)
        staged = (ext[2] + 1 <= RX and ext[1] * RX <= RZ
                  and ext[0] <= planes)
        for c in range(f):
            win = {}
            s0 = lo[2] % 8 if aligned else None
            par = s0 & 1 if aligned else 0
            for z in range(ext[0]):
                for x in range(ext[1]):
                    base = ((lo[0] + z) * X + lo[1] + x) * Y + lo[2]
                    s = (c * Z * X * Y + base) % 8
                    vals = np.concatenate([flat[c], np.zeros(16, f32)])[
                        base - s:base - s + ext[2] + 16]
                    words, _, _ = _stage_row(vals, s, ext[2], aligned)
                    for j, v in words.items():
                        win[z * RZ + x * RX + j] = v
            for iz in range(patch[0]):
                for ix in range(patch[1]):
                    for iy in range(patch[2]):
                        o = [f32(iz - half[0]), f32(ix - half[1]),
                             f32(iy - half[2])]
                        c0, w0, w1 = [], [], []
                        for d in range(3):
                            t = f32(f32(fr[0, d] * o[0])
                                    + f32(fr[1, d] * o[1]))
                            t = f32(t + f32(fr[2, d] * o[2]))
                            cd = f32(p0[d] + t)
                            ok[b] &= bool(0 <= cd <= dims[d] - 2)
                            fl = np.floor(cd)
                            c0.append(int(min(max(fl, 0.0), dims[d] - 2)))
                            w1.append(f32(cd - fl))
                            w0.append(f32(f32(1) - w1[-1]))
                        l = [c0[d] - lo[d] for d in range(3)]
                        inside = staged and all(
                            0 <= l[d] <= ext[d] - 2 for d in range(3))
                        assert not interior or not staged or inside
                        q = []
                        for dz in (0, 1):
                            for dx in (0, 1):
                                if inside:
                                    q.append(win[(l[0] + dz) * RZ
                                                 + (l[1] + dx) * RX + l[2]
                                                 + par])
                                else:
                                    i0 = ((c0[0] + dz) * X + c0[1] + dx) * Y \
                                        + c0[2]
                                    q.append((flat[c, i0], flat[c, i0 + 1]))
                        wzx = _bf16_round([w0[0] * w0[1], w0[0] * w1[1],
                                           w1[0] * w0[1], w1[0] * w1[1]])
                        t0 = t1 = f32(0)
                        for k in range(4):
                            t0 = f32(t0 + f32(wzx[k] * q[k][0]))
                            t1 = f32(t1 + f32(wzx[k] * q[k][1]))
                        out[b, c, iz, ix, iy] = f32(
                            f32(f32(0) + f32(w0[2] * t0)) + f32(w1[2] * t1))
    return out, ok


@pytest.mark.parametrize("Y", [24, 21])
def test_pair_window_emulation_equals_plain_version(Y):
    """The kernel's bf16 data flow, emulated in numpy on its pair window
    (aligned and unaligned rows, two channels, agents inside, at and past
    the volume's bounds), equals ``rotated_patches_bf16_reference`` bit for
    bit, ``ok`` too."""
    rng = np.random.RandomState(41)
    shape, patch, B = (2, 14, 16, Y), (3, 5, 4), 12
    vol = _bf16_round(rng.rand(*shape) - 0.3)
    pos = rng.uniform(1.0, np.asarray(shape[1:]) - 2.0, (B, 3))
    pos[:3] = rng.uniform(-2.0, 3.0, (3, 3))         # clipped agents
    pos = pos.astype(np.float32)
    F = flight_frame(torch.from_numpy(rng.randn(B, 3).astype(np.float32)))
    got, ok = _kernel_emulation(vol, pos, F.numpy(), patch)
    ref, ok_ref = extract_rot.rotated_patches_bf16_reference(
        torch.from_numpy(vol).to(torch.bfloat16), torch.from_numpy(pos), F,
        patch)
    np.testing.assert_array_equal(ok, ok_ref.numpy())
    assert ok.any() and not ok.all()
    np.testing.assert_array_equal(got, ref.numpy())
