"""The plain versions of K2 and K3 against the JAX package's XLA oracles.

K2 (``ops/extract.py``) is held against ``DeviceTracer._extract`` at atol
1e-6 (the same formula in the same order); K3 (``ops/extract_rot.py``)
against the XLA path of ``DeviceTracer._extract_rot_batch`` at atol 1e-5
with ``ok`` equal (coordinates near 32 carry an ulp of about 2e-6, and XLA
sums the frame product in its own order). The JAX package's own tests prove
those oracles equal to its Pallas kernels. On the CPU the port's wrappers
run their plain versions; the CUDA kernels are held against them on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from elektronn2_tpu.data.tracing_utils import DeviceTracer as JaxTracer
from elektronn2_tpu.data.tracing_utils import _flight_frame_jnp
from elektronn2_tpu.data.transformations import flight_frame as host_frame
from elektronn2_tpu.ops.pallas_extract_rot import rotated_ok as jax_rotated_ok
from elektronn2_tpu_torch.data.tracing_utils import flight_frame
from elektronn2_tpu_torch.ops import extract, extract_rot

torch.set_num_threads(1)


class _Stub:
    """A JAX DeviceTracer shell that reaches its plain patch cuts."""

    _rot_kernel = False
    _extract = JaxTracer._extract
    _extract_rot_batch = JaxTracer._extract_rot_batch

    def __init__(self, patch):
        self.patch_size = tuple(patch)


def _jax_patches(vol, pos, patch):
    st = _Stub(patch)
    v = jnp.asarray(vol)
    return np.asarray(jax.vmap(lambda q: st._extract(v, q))(jnp.asarray(pos)))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("f, shape, patch", [
    (1, (20, 22, 24), (5, 5, 5)),
    (2, (12, 16, 14), (4, 6, 3)),
    (1, (9, 10, 11), (7, 8, 9)),
])
def test_k2_plain_matches_jax(f, shape, patch):
    """Random positions inside, on every border and outside the volume: the
    clip of the base and the fraction taken before it are both hit."""
    rng = np.random.RandomState(sum(patch) + f)
    vol = rng.rand(f, *shape).astype(np.float32)
    dims = np.asarray(shape, np.float32)
    inside = rng.uniform(0, dims, (12, 3))
    borders = []
    for d in range(3):
        for v in (0.0, 0.3, (patch[d] - 1) / 2.0, dims[d] - 1 - 0.25,
                  dims[d] - (patch[d] + 1) / 2.0 + 0.5, dims[d] + 1.7, -2.4):
            p = dims / 2.0
            p[d] = v
            borders.append(p)
    pos = np.concatenate([inside, borders]).astype(np.float32)
    got = extract.trilinear_patches(_t(vol), _t(pos), patch).numpy()
    ref = _jax_patches(vol, pos, patch)
    assert got.shape == ref.shape == (len(pos), f, *patch)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_k2_cpu_runs_plain_version_without_launch():
    vol = torch.rand(1, 10, 10, 10)
    pos = torch.tensor([[5.0, 4.5, 5.2]])
    before = extract.launches
    got = extract.trilinear_patches(vol, pos, (3, 3, 3))
    assert extract.launches == before
    assert torch.equal(got, extract.trilinear_patches_reference(
        vol, pos, (3, 3, 3)))


def test_k2_integer_positions_are_exact_samples():
    vol = torch.arange(6 * 7 * 8, dtype=torch.float32).reshape(1, 6, 7, 8)
    pos = torch.tensor([[2.0, 3.0, 4.0]])          # patch 3: corner (1,2,3)
    got = extract.trilinear_patches(vol, pos, (3, 3, 3))
    torch.testing.assert_close(got[0, 0], vol[0, 1:4, 2:5, 3:6], atol=0,
                               rtol=0)


@pytest.mark.parametrize("case, exc, match", [
    ("dtype", TypeError, "float32"),
    ("rank", ValueError, "rank 4"),
    ("pos", ValueError, r"\(B, 3\)"),
    ("contiguous", ValueError, "contiguous"),
    ("device", ValueError, "is on"),
    ("small", ValueError, "too small"),
    ("patch", ValueError, "three positive"),
])
def test_k2_invalid_args_raise(case, exc, match):
    vol, pos, patch = torch.rand(1, 8, 9, 10), torch.rand(4, 3) * 4, (3, 3, 3)
    if case == "dtype":
        vol = vol.double()
    elif case == "rank":
        vol = vol[0]
    elif case == "pos":
        pos = pos[:, :2].contiguous()
    elif case == "contiguous":
        vol = vol.transpose(2, 3)
    elif case == "device":
        pos = pos.to("meta")
    elif case == "small":
        patch = (8, 3, 3)
    elif case == "patch":
        patch = (3, 0, 3)
    with pytest.raises(exc, match=match):
        extract.trilinear_patches(vol, pos, patch)


def _rot_case(seed, B, shape, margin, patch):
    rng = np.random.RandomState(seed)
    vol = rng.rand(*shape).astype(np.float32)
    dims = np.asarray(shape[1:], np.float32)
    pos = rng.uniform(margin, dims - margin, (B, 3)).astype(np.float32)
    heads = rng.randn(B, 3).astype(np.float32)
    return vol, pos, heads


def _rot_both(vol, pos, heads, patch):
    ref, ok_ref, F = _Stub(patch)._extract_rot_batch(
        jnp.asarray(vol), jnp.asarray(pos), jnp.asarray(heads))
    got, ok = extract_rot.rotated_patches(_t(vol), _t(pos),
                                          _t(np.asarray(F)), patch)
    return got.numpy(), ok.numpy(), np.asarray(ref), np.asarray(ok_ref)


@pytest.mark.parametrize("seed, B, shape, margin, patch", [
    (0, 24, (1, 16, 20, 24), 4.0, (4, 4, 4)),     # some agents out
    (1, 12, (1, 24, 28, 30), 8.0, (4, 8, 6)),     # anisotropic patch
    (2, 8, (2, 16, 18, 20), 5.0, (3, 5, 4)),      # two channels
    (3, 6, (1, 32, 32, 32), 11.0, (16, 16, 16)),  # the tracer's patch
])
def test_k3_plain_matches_jax(seed, B, shape, margin, patch):
    vol, pos, heads = _rot_case(seed, B, shape, margin, patch)
    got, ok, ref, ok_ref = _rot_both(vol, pos, heads, patch)
    assert got.shape == ref.shape == (B, shape[0], *patch)
    np.testing.assert_array_equal(ok, ok_ref)
    assert ok.any()
    np.testing.assert_allclose(got[ok], ref[ok], atol=1e-5, rtol=0)


def test_k3_ok_flags_at_the_boundary():
    """``ok`` flips at the host margin: positions straddling it along each
    axis, canonical and rotated headings."""
    vol = np.random.RandomState(3).rand(1, 16, 18, 20).astype(np.float32)
    patch = (4, 4, 4)
    for head in ([0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.5, 0.5, 0.7]):
        pos = []
        for axis in range(3):
            for v in (1.4, 1.5, 1.6, 3.4, 9.0, 14.5):
                p = [8.0, 9.0, 10.0]
                p[axis] = v
                pos.append(p)
        pos = np.asarray(pos, np.float32)
        heads = np.tile(np.asarray(head, np.float32), (len(pos), 1))
        got, ok, ref, ok_ref = _rot_both(vol, pos, heads, patch)
        np.testing.assert_array_equal(ok, ok_ref)
        assert ok.any() and not ok.all()
        np.testing.assert_allclose(got[ok], ref[ok], atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", [4, 5])
def test_rotated_ok_corner_criterion_equals_all_samples(seed):
    """The 8-box-corner test (``rotated_ok``, the TPU kernel's) equals the
    all-samples criterion of the plain version, and the JAX package's
    ``rotated_ok``."""
    vol, pos, heads = _rot_case(seed, 64, (1, 16, 20, 24), 3.0, None)
    patch = (4, 4, 4)
    F = flight_frame(_t(heads))
    ok = extract_rot.rotated_ok(vol.shape, _t(pos), F, patch).numpy()
    _, ok_all = extract_rot.rotated_patches_reference(_t(vol), _t(pos), F,
                                                      patch)
    ok_jax = np.asarray(jax_rotated_ok(vol.shape, jnp.asarray(pos),
                                       jnp.asarray(F.numpy()), patch))
    np.testing.assert_array_equal(ok, ok_all.numpy())
    np.testing.assert_array_equal(ok, ok_jax)
    assert ok.any() and not ok.all()


def test_flight_frame_matches_jax_and_degenerate_cases():
    """Orthonormal rows, tangent along the heading, (0,0,1) for a zero
    heading, the ŷ reference for |t·x̂| > 0.9; equal to the JAX frame."""
    heads = np.asarray([[1.0, 2.0, -0.5], [0.0, 1.0, 0.0], [3.0, 0.0, 0.0],
                        [0.0, 0.0, 0.0], [-0.95, 0.1, 0.2],
                        [1e-13, 0.0, 0.0]], np.float32)
    F = flight_frame(_t(heads)).numpy()
    ref = np.asarray(jax.vmap(_flight_frame_jnp)(jnp.asarray(heads)))
    np.testing.assert_allclose(F, ref, atol=1e-6)
    for h, f in zip(heads[:5], F):
        # the host frame falls back only at norm 0, the device one at 1e-12
        np.testing.assert_allclose(f @ f.T, np.eye(3), atol=1e-6)
        np.testing.assert_allclose(f, host_frame(h.astype(np.float64)),
                                   atol=1e-6)
    np.testing.assert_array_equal(F[3, 0], [0.0, 0.0, 1.0])
    np.testing.assert_array_equal(F[5, 0], [0.0, 0.0, 1.0])


def test_k3_cpu_runs_plain_version_without_launch():
    vol = torch.rand(1, 10, 10, 10)
    pos = torch.tensor([[5.0, 4.5, 5.2]])
    F = flight_frame(torch.tensor([[0.3, 0.4, 0.5]]))
    before = extract_rot.launches
    got, ok = extract_rot.rotated_patches(vol, pos, F, (3, 3, 3))
    ref, ok_ref = extract_rot.rotated_patches_reference(vol, pos, F,
                                                        (3, 3, 3))
    assert extract_rot.launches == before
    assert torch.equal(got, ref) and torch.equal(ok, ok_ref)


@pytest.mark.parametrize("case, exc, match", [
    ("dtype", TypeError, "float32"),
    ("frames", ValueError, r"frames \(B, 3, 3\)"),
    ("device", ValueError, "is on"),
    ("small", ValueError, "every edge"),
])
def test_k3_invalid_args_raise(case, exc, match):
    vol, pos = torch.rand(1, 8, 9, 10), torch.rand(4, 3) * 4
    F = flight_frame(torch.rand(4, 3))
    if case == "dtype":
        F = F.double()
    elif case == "frames":
        F = F[:3].contiguous()
    elif case == "device":
        F = F.to("meta")
    elif case == "small":
        vol = vol[:, :1].contiguous()
    with pytest.raises(exc, match=match):
        extract_rot.rotated_patches(vol, pos, F, (3, 3, 3))
