"""The port's warp augmentation (``ops/warp.py``) against the JAX package's.

Deterministic parts are held to JAX on the same inputs: both resampling
cores for the same M, position, elastic field, target and target strides
(identity, JAX-drawn matrices, flips, the fold boundary), atol 1e-5 on
intensities in [0, 1) or on linear ramps scaled to about 1 (float32 blends
summed in another order; labels must be equal). The random parameter maps
are fed JAX's own draws (the test repeats JAX's key splits) and held to
``random_warp_matrices``, ``grey_augment`` and the elastic resize (atol
1e-6 on the matrices and grey values, 1e-5 on fields of scale sigma). The
port's own draws are checked by their distribution, and the augmenter by
its invariants (unwarped train patches are exact flipped crops, validation
patches unflipped exact crops).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy import ndimage

from elektronn2_tpu.ops import warp as jw
from elektronn2_tpu_torch.ops import warp as tw

torch.set_num_threads(1)
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _smooth(rng, shape, s=2.5):
    return ndimage.gaussian_filter(rng.randn(*shape), s).astype(np.float32)


def _family(theta, dz=1.0, dx=1.0, dy=1.0, sh=0.0):
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    Sh = np.eye(3)
    Sh[1, 2] = sh
    M = np.eye(4)
    M[:3, :3] = np.diag([dz, dx, dy]) @ Sh @ R
    return M.astype(np.float32)


def _matrices():
    """Identity, JAX-drawn family matrices, flips and the fold boundary."""
    drawn = np.asarray(jw.random_warp_matrices(jax.random.PRNGKey(3), 4,
                                               amount=1.0))
    return ([("identity", np.eye(4, dtype=np.float32))]
            + [(f"jax{i}", drawn[i]) for i in range(4)]
            + [("fold+90", _family(np.pi / 2)),
               ("fold-90", _family(-np.pi / 2)),
               ("near180", _family(np.pi * 0.999)),
               ("xflip", _family(0.0, dx=-1.0)),
               ("yzflip", _family(0.0, dy=-1.0, dz=-1.0)),
               ("all", _family(2.2, dx=-1.1, dy=0.9, sh=0.2))])


MATS = _matrices()


@pytest.fixture(scope="module")
def volumes():
    rng = np.random.RandomState(8)
    src = rng.rand(2, 40, 48, 48).astype(np.float32)
    lab = (_smooth(rng, (40, 48, 48), 4) > 0).astype(np.int32)
    return src, lab


@pytest.mark.parametrize("core", ["gather", "separable"])
@pytest.mark.parametrize("mname, M", MATS, ids=[m for m, _ in MATS])
def test_cores_match_jax(volumes, core, mname, M):
    src, lab = volumes
    pos = np.asarray([20.3, 23.6, 24.2], np.float32)
    kw = dict(target_patch_size=(4, 6, 6), target_strides=(1, 2, 2))
    jf = jw.warp_patch if core == "gather" else jw.warp_patch_separable
    tf = tw.warp_patch if core == "gather" else tw.warp_patch_separable
    jd, jt = jf(jnp.asarray(src), jnp.asarray(M), jnp.asarray(pos),
                (8, 14, 14), target=jnp.asarray(lab), **kw)
    td, tt = tf(_t(src), _t(M), _t(pos), (8, 14, 14), target=_t(lab), **kw)
    assert tuple(td.shape) == (2, 8, 14, 14) and tt.dtype == torch.int32
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("core", ["gather", "separable"])
@pytest.mark.parametrize("mname, M", MATS[1:4], ids=[m for m, _ in MATS[1:4]])
def test_cores_with_elastic_match_jax(volumes, core, mname, M):
    """An elastic field (drawn by JAX) on top of the warp, with a target:
    labels follow the image's deformation in both packages."""
    src, lab = volumes
    patch = (8, 12, 12)
    f = np.asarray(jw.random_elastic_fields(jax.random.PRNGKey(4), 1, patch,
                                            grid=4, sigma=1.5)[0])
    pos = np.asarray([20.0, 24.5, 23.5], np.float32)
    kw = dict(target_patch_size=(4, 6, 6), target_strides=(1, 2, 2))
    if core == "gather":
        jd, jt = jw.warp_patch(jnp.asarray(src), jnp.asarray(M),
                               jnp.asarray(pos), patch,
                               target=jnp.asarray(lab), elastic=f, **kw)
        td, tt = tw.warp_patch(_t(src), _t(M), _t(pos), patch,
                               target=_t(lab), elastic=_t(f), **kw)
    else:
        jd, jt = jw.warp_patch_separable(
            jnp.asarray(src), jnp.asarray(M), jnp.asarray(pos), patch,
            target=jnp.asarray(lab), elastic=f, elastic_margin=4, **kw)
        td, tt = tw.warp_patch_separable(_t(src), _t(M), _t(pos), patch,
                                         target=_t(lab), elastic=_t(f),
                                         elastic_margin=4, **kw)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_gather_primitives_match_jax(volumes):
    src, lab = volumes
    rng = np.random.RandomState(2)
    coords = (rng.rand(3, 200) * np.array([[44], [52], [52]]) - 2
              ).astype(np.float32)        # some outside: border clamp
    np.testing.assert_allclose(
        tw.trilinear_gather(_t(src), _t(coords)).numpy(),
        np.asarray(jw.trilinear_gather(jnp.asarray(src), jnp.asarray(coords))),
        atol=ATOL, rtol=0)
    np.testing.assert_array_equal(
        tw.nearest_gather(_t(lab), _t(coords)).numpy(),
        np.asarray(jw.nearest_gather(jnp.asarray(lab), jnp.asarray(coords))))
    np.testing.assert_array_equal(tw.make_grid((3, 4, 5)).numpy(),
                                  np.asarray(jw.make_grid((3, 4, 5))))
    M = MATS[2][1]
    g = tw.make_grid((3, 4, 5))
    np.testing.assert_allclose(
        tw.transform_grid(g, _t(M), _t(np.float32([1, 2, 3]))).numpy(),
        np.asarray(jw.transform_grid(jnp.asarray(g.numpy()), jnp.asarray(M),
                                     jnp.float32([1, 2, 3]))), atol=1e-6)


def test_batched_separable_core_matches_jax_per_item(volumes):
    """The augmenter's batched core (one box cut per item from a stack of
    cubes, by index arithmetic) against JAX's single-item function."""
    src, lab = volumes
    rng = np.random.RandomState(6)
    stack = np.stack([src, rng.rand(*src.shape).astype(np.float32)])
    labs = np.stack([lab, 1 - lab])
    Ms = np.asarray(jw.random_warp_matrices(jax.random.PRNGKey(9), 3,
                                            amount=0.7))
    pos = np.asarray([[20, 24, 24], [18.5, 22.2, 25.9], [21, 26, 23]],
                     np.float32)
    idx = np.asarray([1, 0, 1])
    patch, kw = (8, 12, 12), dict(target_patch_size=(4, 6, 6),
                                  target_strides=(1, 2, 2))
    pads = tw._bbox_fit_pads(src.shape[1:], 0.7, patch, 0)
    td, tt = tw._warp_separable_b(
        tw._pad_trailing(_t(stack), pads), tw._pad_trailing(_t(labs), pads),
        _t(idx), _t(Ms), _t(pos), patch, amount_bound=0.7, **kw)
    for b in range(3):
        jd, jt = jw.warp_patch_separable(
            jnp.asarray(stack[idx[b]]), jnp.asarray(Ms[b]),
            jnp.asarray(pos[b]), patch, target=jnp.asarray(labs[idx[b]]),
            amount_bound=0.7, **kw)
        np.testing.assert_allclose(td[b].numpy(), np.asarray(jd), atol=ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(tt[b].numpy(), np.asarray(jt))


# ----------------------------------------------- the random maps, JAX's draws

@pytest.mark.parametrize("amount, lock_z, no_x_flip", [
    (1.0, True, False), (0.5, False, True), (0.0, True, False)])
def test_warp_matrices_from_jax_draws(amount, lock_z, no_x_flip):
    key, B = jax.random.PRNGKey(11), 16
    keys = jax.random.split(key, 6)       # random_warp_matrices' splits
    u = lambda k, shape: _t(jax.random.uniform(k, shape))  # noqa: E731
    draws = {"rot": u(keys[0], (B,)), "shear": u(keys[1], (B,)),
             "scale": u(keys[2], (B, 3)), "fx": u(keys[3], (B,)),
             "fy": u(keys[4], (B,)), "fz": u(keys[5], (B,))}
    want = jw.random_warp_matrices(key, B, amount=amount, lock_z=lock_z,
                                   no_x_flip=no_x_flip)
    got = tw.warp_matrices(draws, amount=amount, lock_z=lock_z,
                           no_x_flip=no_x_flip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("channels", [None, [0], [1, 2]])
def test_grey_map_from_jax_draws(channels):
    key = jax.random.PRNGKey(12)
    x = np.random.RandomState(1).rand(4, 3, 5, 6, 6).astype(np.float32)
    kc, kb, kg = jax.random.split(key, 3)  # grey_augment's splits
    draws = [_t(jax.random.uniform(k, (4, 3))) for k in (kc, kb, kg)]
    want = jw.grey_augment(key, jnp.asarray(x), channels)
    got = tw.grey_map(_t(x), draws, channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("patch", [(15, 54, 54), (8, 12, 12), (1, 9, 9),
                                   (3, 16, 5)])
def test_elastic_fields_from_jax_draws(patch):
    """The coarse normals resized to the patch: jax.image.resize's rule,
    borders included, up- and downsampling (a singleton z axis keeps no
    displacement along z)."""
    key, sigma = jax.random.PRNGKey(13), 2.0
    normals = jax.random.normal(key, (2, 3, 4, 4, 4))
    want = jw.random_elastic_fields(key, 2, patch, grid=4, sigma=sigma)
    got = tw.elastic_fields(_t(normals), patch, sigma=sigma)
    assert tuple(got.shape) == (2, 3) + patch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_resize_weights_equal_interpolate_when_upsampling():
    """For upsampling, jax.image.resize's rule is F.interpolate's
    (trilinear, align_corners=False, border clamped)."""
    x = torch.randn(2, 3, 4, 4, 4)
    w = [tw._resize_weights(4, n, "cpu") for n in (15, 54, 7)]
    got = torch.einsum("bcijk,zi,xj,yk->bczxy", x, *w)
    want = torch.nn.functional.interpolate(x, size=(15, 54, 7),
                                           mode="trilinear",
                                           align_corners=False)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# ---------------------------------------------------- the port's own draws

def test_own_warp_draws_distribution():
    gen = torch.Generator().manual_seed(0)
    B, amount = 4096, 0.8
    M = tw.random_warp_matrices(gen, B, amount=amount)
    a, b, c, d = M[:, 1, 1], M[:, 1, 2], M[:, 2, 1], M[:, 2, 2]
    det = a * d - b * c
    # flips of x and y: each with probability 1/2, so det < 0 about half
    assert abs(float((det < 0).float().mean()) - 0.5) < 0.04
    # z: locked (no flip), scale within 1 +- 0.1 amount (anisotropic)
    assert bool((M[:, 0, 0] > 0).all())
    assert float((M[:, 0, 0] - 1).abs().max()) <= 0.1 * amount + 1e-6
    assert bool((M[:, 0, 1:3] == 0).all() and (M[:, 1:3, 0] == 0).all())
    assert bool((M[:, 3, :3] == 0).all() and (M[:, 3, 3] == 1).all())
    # in-plane: |det| = sx sy within the scale range, and rotation angles
    # spread over (-pi amount, pi amount)
    assert float(det.abs().min()) >= (1 - 0.2 * amount) ** 2 - 1e-5
    assert float(det.abs().max()) <= (1 + 0.2 * amount) ** 2 + 1e-5
    I = tw.random_warp_matrices(gen, 64, amount=0.0)
    assert bool((I[:, :3, :3].abs().sum(2) == 1).all())   # flips only


def test_own_grey_and_elastic_draws_distribution():
    gen = torch.Generator().manual_seed(1)
    x = torch.full((2048, 1, 2, 2, 2), 0.5)
    y = tw.grey_augment(gen, x)
    assert float(y.min()) >= 0.0 and float(y.max()) <= 1.0
    assert float(y.std()) > 0.05
    f = tw.random_elastic_fields(gen, 256, (6, 6, 6), grid=4, sigma=3.0)
    assert abs(float(f.mean())) < 0.1
    assert 1.0 < float(f.std()) < 3.0     # smoothed normals of sigma 3


def test_own_sampler_distribution():
    rng = np.random.RandomState(0)
    raws = [rng.rand(1, 24, 40, 40).astype(np.float32) for _ in range(3)]
    labs = [np.zeros((24, 40, 40), np.int16) for _ in range(3)]
    aug = tw.DeviceBatchAugmenter(raws, labs, patch_size=(6, 10, 10),
                                  valid_cubes=[1], device="cpu")
    gen = torch.Generator().manual_seed(2)
    idx, pos, warp_on = aug._sample_device(gen, 4000, 0.3)
    assert set(idx.tolist()) == {0, 2}
    assert abs(float(warp_on.float().mean()) - 0.3) < 0.03
    lo = np.minimum(aug._safe_margin(), np.array([24, 40, 40]) / 2 - 1)
    p = pos.numpy()
    assert (p >= lo - 1).all() and (p <= np.array([24, 40, 40]) - lo).all()
    # unwarped items are integer-aligned (exact crops); warped ones are not
    half = (np.array([6, 10, 10]) - 1) / 2
    un = p[~warp_on.numpy()] - half
    np.testing.assert_array_equal(un, np.floor(un))


# ------------------------------------------------ the augmenter's invariants

def _find_crop(vol, patch, size):
    """The flips (fz, fx, fy) under which ``patch`` is an exact crop of
    ``vol``, or None."""
    lim = [s - size + 1 for s in vol.shape]
    for fz in (1, -1):
        for fx in (1, -1):
            for fy in (1, -1):
                cand = patch[::fz, ::fx, ::fy]
                hits = np.argwhere(np.isclose(vol[:lim[0], :lim[1], :lim[2]],
                                              cand[0, 0, 0], atol=1e-6))
                for z, x, y in hits:
                    if np.allclose(vol[z:z + size, x:x + size, y:y + size],
                                   cand, atol=1e-5):
                        return fz, fx, fy
    return None


@pytest.mark.parametrize("resample", ["gather", "separable"])
@pytest.mark.parametrize("route", ["host", "device"])
def test_unwarped_train_patches_are_exact_flipped_crops(resample, route):
    rng = np.random.RandomState(42)
    raws = [rng.rand(1, 24, 24, 24).astype(np.float32)]
    labs = [(raws[0][0] > 0.5).astype(np.int32)]
    aug = tw.DeviceBatchAugmenter(raws, labs, patch_size=(7, 7, 7),
                                  target_size=(3, 3, 3), resample=resample,
                                  device="cpu")
    gen = torch.Generator().manual_seed(3)
    flips = []
    for _ in range(6):
        d, _ = (aug.getbatch(batch_size=2, warp=0.0) if route == "host"
                else aug.device_batch(gen, 2, warp=0.0, grey=False))
        for b in range(2):
            found = _find_crop(raws[0][0], d[b, 0].numpy(), 7)
            assert found is not None, "patch not an exact (flipped) crop"
            flips.append(found != (1, 1, 1))
    assert any(flips)            # flips fire on unwarped draws


@pytest.mark.parametrize("resample", ["gather", "separable"])
def test_validation_batches_are_unflipped_exact_crops(resample):
    rng = np.random.RandomState(42)
    raws = [rng.rand(1, 24, 24, 24).astype(np.float32) for _ in range(2)]
    labs = [(r[0] > 0.5).astype(np.int32) for r in raws]
    aug = tw.DeviceBatchAugmenter(raws, labs, patch_size=(7, 7, 7),
                                  target_size=(3, 3, 3), grey_channels=[0],
                                  valid_cubes=[1], resample=resample,
                                  device="cpu")
    d, t = aug.getbatch(batch_size=4, source="valid")
    for b in range(4):
        assert _find_crop(raws[1][0], d[b, 0].numpy(), 7) == (1, 1, 1)
    assert t.dtype == torch.int32 and tuple(t.shape) == (4, 3, 3, 3)


def test_augmenter_2d_float_targets_and_errors():
    rng = np.random.RandomState(0)
    imgs = [rng.rand(1, 40, 40).astype(np.float32) for _ in range(2)]
    labs = [rng.rand(40, 40).astype(np.float32) for _ in range(2)]
    aug = tw.DeviceBatchAugmenter(imgs, labs, patch_size=(12, 12),
                                  target_size=(8, 8), grey_channels=[0],
                                  elastic_sigma=1.0, device="cpu")
    d, t = aug.getbatch(batch_size=3, warp=0.5)
    assert tuple(d.shape) == (3, 1, 12, 12) and tuple(t.shape) == (3, 8, 8)
    assert t.dtype == torch.float32          # regression targets stay float
    assert bool(torch.isfinite(d).all())
    gen = torch.Generator().manual_seed(0)
    d2, t2 = aug.device_batch(gen, 2)
    assert tuple(d2.shape) == (2, 1, 12, 12) and tuple(t2.shape) == (2, 8, 8)
    with pytest.raises(ValueError, match="valid split"):
        tw.DeviceBatchAugmenter(imgs, labs, patch_size=(12, 12),
                                valid_cubes=[0, 1], device="cpu")
    with pytest.raises(ValueError, match="resample"):
        tw.DeviceBatchAugmenter(imgs, labs, patch_size=(12, 12),
                                resample="bogus", device="cpu")
    with pytest.raises(ValueError, match="validation"):
        aug.getbatch(2, source="valid")


def test_reseed_gives_fresh_reproducible_draws():
    rng = np.random.RandomState(0)
    raws = [rng.rand(1, 20, 30, 30).astype(np.float32)]
    labs = [np.zeros((20, 30, 30), np.int16)]
    kw = dict(patch_size=(5, 8, 8), seed=4, device="cpu")
    a = tw.DeviceBatchAugmenter(raws, labs, **kw)
    b = tw.DeviceBatchAugmenter(raws, labs, **kw)
    d1, _ = a.getbatch(2, warp=1.0)
    torch.testing.assert_close(b.getbatch(2, warp=1.0)[0], d1, atol=0,
                               rtol=0)
    a.reseed(100)
    assert not torch.equal(a.getbatch(2, warp=1.0)[0], d1)
