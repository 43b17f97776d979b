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
    row the window gives it, in both modes."""
    for elem, per in ((4, 4), (2, 8)):
        for n in range(1, 40):
            rv = extract_rot.row_values(n, elem)
            assert rv % per == 0
            assert all(s + n <= rv for s in range(per))
            assert rv - per < per - 1 + n       # no whole piece to spare
