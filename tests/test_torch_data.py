"""The port's host data pipeline against the JAX package's, on the CPU.

``elektronn2_tpu_torch/data/{transformations,image,cnndata,traindata}.py``
are jax-free copies of the JAX package's modules, so every case here feeds
both the same inputs and the same ``np.random.RandomState`` and asks for
equal results, bit for bit (``assert_array_equal``): the same numpy code
and the same C++ warp core (``warp_core.cpp``, built by each package from
its own copy) run on both sides. The gathers are compared both through the
native core and through the numpy path (``transformations._NATIVE``
forced to None in both packages). Mirrors tests/test_data.py (warping,
image augmentation, batch creation, GridData; not KNOSSOS, not AgentData)
and tests/test_warp_golden.py (the same golden file).
"""

import json
import os

import numpy as np
import pytest
import torch

import elektronn2_tpu.data as jdata
import elektronn2_tpu.neuromancer as jnm
from elektronn2_tpu.data import cnndata as jcnn
from elektronn2_tpu.data import image as jimage
from elektronn2_tpu.data import traindata as jtrain
from elektronn2_tpu.data import transformations as jT
import elektronn2_tpu_torch.data as tdata
import elektronn2_tpu_torch.neuromancer as tnm
from elektronn2_tpu_torch.data import cnndata as tcnn
from elektronn2_tpu_torch.data import image as timage
from elektronn2_tpu_torch.data import traindata as ttrain
from elektronn2_tpu_torch.data import transformations as tT

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "warp_lock.json")


@pytest.fixture(params=["native", "numpy"])
def core(request, monkeypatch):
    """Run the case through the C++ gather core or the numpy path, in both
    packages alike."""
    if request.param == "numpy":
        monkeypatch.setattr(jT, "_NATIVE", None)
        monkeypatch.setattr(tT, "_NATIVE", None)
    else:
        if tT._native() is None or jT._native() is None:
            pytest.skip("no g++: the native warp core cannot be built")
    return request.param


def both(fn, seed=0):
    """``fn(module, rng)`` for the JAX package's transformations and the
    port's, each with a fresh ``RandomState(seed)``."""
    return (fn(jT, np.random.RandomState(seed)),
            fn(tT, np.random.RandomState(seed)))


def assert_same(a, b):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif a is None:
        assert b is None
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                          a.shape, b.shape)
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------- warping

def _vol(seed=7, f=1, shape=(24, 26, 28)):
    r = np.random.RandomState(seed)
    return (r.rand(f, *shape).astype(np.float32),
            r.randint(0, 6, shape).astype(np.int16))


WARP_CASES = {
    "identity": lambda T, rng: T.warp_slice(_vol()[0], (8, 9, 10)),
    "random_matrix_and_target": lambda T, rng: T.warp_slice(
        _vol()[0], (8, 10, 10),
        M=T.make_warp_matrix(**T.get_random_warp_params(rng, amount=0.6)),
        position=(12.3, 13.1, 14.7), target=_vol()[1],
        target_patch_size=(6, 4, 4), target_strides=(1, 2, 2)),
    "aniso_and_offset": lambda T, rng: T.warp_slice(
        _vol(f=2)[0], (6, 8, 8),
        M=T.aniso_warp_matrix(T.make_warp_matrix(
            **T.get_random_warp_params(rng, amount=1.0)), 2.0),
        position=(12, 13, 14), target=_vol()[1], target_patch_size=(4, 4, 4),
        target_offset=(1, 0, 1)),
    "elastic": lambda T, rng: T.warp_slice(
        _vol()[0], (7, 8, 9), M=T.rotate_z(0.3), target=_vol()[1],
        target_patch_size=(5, 6, 7), rng=rng,
        elastic_params={"grid": 3, "sigma": 1.5}),
    "skip_img": lambda T, rng: T.warp_slice(
        _vol()[0], (8, 8, 8), M=T.shear(1, 0.2), target=_vol()[1],
        target_patch_size=(4, 4, 4), target_offset=(0, 1, 1), skip_img=True),
    "singleton_z": lambda T, rng: T.warp_slice(
        _vol(shape=(1, 30, 30))[0], (1, 12, 12), M=T.rotate_z(0.7),
        target=_vol(shape=(1, 30, 30))[1], target_patch_size=(1, 8, 8)),
    "label_stack": lambda T, rng: T.warp_slice(
        _vol()[0], (6, 6, 6), M=T.scale(1.1, 0.9), target=np.stack(
            [_vol()[1], _vol(8)[1]]).astype(np.int32),
        target_patch_size=(4, 4, 4)),
}


@pytest.mark.parametrize("case", sorted(WARP_CASES))
def test_warp_slice_equals_jax(core, case):
    j, t = both(WARP_CASES[case], seed=5)
    assert_same(j, t)


@pytest.mark.parametrize("src_dtype", [np.float32, np.float64, np.int32,
                                       np.int16])
def test_map_coordinates_equal_jax(core, src_dtype):
    rng = np.random.RandomState(3)
    src = (rng.rand(2, 14, 15, 16) * 9).astype(src_dtype)
    coords = np.concatenate([rng.uniform(-3, 18, size=(3, 500)),
                             rng.randint(0, 14, size=(3, 20)).astype(float)],
                            axis=1)
    for fn in ("map_coordinates_linear", "map_coordinates_nearest"):
        assert_same(getattr(jT, fn)(src, coords), getattr(tT, fn)(src, coords))
        assert_same(getattr(jT, fn)(src[0], coords),
                    getattr(tT, fn)(src[0], coords))


def test_native_core_matches_numpy_path(monkeypatch):
    # the port's own C++ core against its numpy path (the JAX package's
    # test_native_warp_core_matches_numpy), and the same bytes as the JAX
    # package's core
    from elektronn2_tpu.data import _warp_native as jnat
    from elektronn2_tpu_torch.data import _warp_native as tnat
    try:
        tnat.get_lib()
        jnat.get_lib()
    except Exception:
        pytest.skip("no g++ available")
    rng = np.random.RandomState(11)
    src = rng.rand(2, 14, 15, 16).astype(np.float32)
    lab = rng.randint(0, 9, size=(1, 14, 15, 16)).astype(np.int32)
    coords = np.concatenate([rng.uniform(-3, 18, size=(3, 4000)),
                             rng.randint(0, 14, size=(3, 50)).astype(float)],
                            axis=1)
    lin, nn = tnat.map_linear_f32(src, coords), tnat.map_nearest_i32(lab,
                                                                      coords)
    assert_same(lin, jnat.map_linear_f32(src, coords))
    assert_same(nn, jnat.map_nearest_i32(lab, coords))
    monkeypatch.setattr(tT, "_NATIVE", None)
    np.testing.assert_allclose(lin, tT.map_coordinates_linear(src, coords),
                               atol=2e-5)
    np.testing.assert_array_equal(nn, tT.map_coordinates_nearest(lab, coords))
    assert tnat._SRC.startswith(os.path.dirname(tT.__file__))
    with open(tnat._SRC, "rb") as a, open(jnat._SRC, "rb") as b:
        assert a.read() == b.read()          # a copy of the JAX core


MATRIX_CASES = {
    "random_params": lambda T, rng: sorted(
        (k, np.asarray(v).tolist()) for k, v in
        T.get_random_warp_params(rng, amount=0.8).items()),
    "random_params_flags": lambda T, rng: sorted(
        (k, np.asarray(v).tolist()) for k, v in T.get_random_warp_params(
            rng, amount=0.0, lock_z=False, no_x_flip=True).items()),
    "warp_matrix": lambda T, rng: T.make_warp_matrix(
        **T.get_random_warp_params(rng, amount=1.0)),
    "aniso": lambda T, rng: T.aniso_warp_matrix(
        T.chain(T.rotate_axis((0.2, 1.0, 0.3), 0.4),
                T.perspective(0.01, 0.0, 0.02), T.flip(True, False, True),
                T.translate(1, 2, 3)), 2.0),
    "elastic_field": lambda T, rng: T.make_elastic_field(rng, (6, 7, 8),
                                                         grid=3, sigma=2.0),
    "warp_coords": lambda T, rng: T.warp_coords(
        (4, 5, 6), T.rotate_z(0.2), position=(9, 9, 9),
        grid_strides=(1, 2, 2), grid_offset=(0, 1, 0))[0],
    "target_grid": lambda T, rng: T.target_grid_indices(
        (9, 11, 11), (5, 3, 3), (1, 3, 3), (0, 1, 0)),
}


@pytest.mark.parametrize("case", sorted(MATRIX_CASES))
def test_warp_matrices_equal_jax(case):
    j, t = both(MATRIX_CASES[case], seed=9)
    if case.startswith("random_params"):
        assert j == t
    else:
        assert_same(j, t)


def test_oob_and_lazy_slab_read():
    vol = np.random.RandomState(1).rand(1, 40, 40, 40).astype(np.float32)
    with pytest.raises(tT.WarpingOOBError):
        tT.warp_slice(vol[:, :10, :10, :10], (8, 8, 8),
                      position=(1.0, 5.0, 5.0))
    with pytest.raises(tT.WarpingOOBError):
        tT.warp_slice(vol[:, :10, :10, :10], (12, 4, 4))
    reads = []

    class Spy:
        def __init__(self, a):
            self.a, self.shape = a, a.shape

        def __getitem__(self, idx):
            reads.append(idx)
            return self.a[idx]

    tT.warp_slice(Spy(vol), (8, 8, 8))
    assert len(reads) == 1
    for s, p in zip(reads[0][-3:], (8, 8, 8)):
        assert (s.stop - s.start) <= p + 3


def test_warp_golden_file():
    # the JAX package's warp lock (tests/test_warp_golden.py), computed by
    # the port
    rng = np.random.RandomState(123)
    img = rng.rand(2, 28, 30, 30).astype(np.float32)
    lab = (rng.rand(28, 30, 30) * 4).astype(np.int16)
    M = tT.make_warp_matrix(**tT.get_random_warp_params(rng, amount=0.7))
    d, t = tT.warp_slice(img, (10, 12, 12), M=M, position=(14, 15, 15),
                         target=lab, target_patch_size=(8, 10, 10), rng=rng,
                         elastic_params={"grid": 4, "sigma": 1.5})
    d = np.asarray(d, np.float64)
    t = np.asarray(t, np.int64)
    with open(GOLDEN) as f:
        want = json.load(f)
    np.testing.assert_allclose(round(float(d.sum()), 4), want["img_sum"],
                               rtol=1e-6)
    np.testing.assert_allclose(d[0, 0, 0, :4], want["img_corner"], atol=1e-5)
    np.testing.assert_allclose(d[1, 5, 6, 4:8], want["img_center"], atol=1e-5)
    assert np.bincount(t.ravel(), minlength=4).tolist() == want["lab_hist"]
    assert int(t.sum()) == want["lab_sum"]


# ---------------------------------------------------------------- image aug

IMAGE_CASES = {
    "grey": lambda I, rng: I.greyAugment(
        np.random.RandomState(2).rand(2, 6, 7, 8).astype(np.float32),
        [0, 1], rng),
    "grey_one_channel": lambda I, rng: I.greyAugment(
        np.random.RandomState(2).rand(3, 5, 5).astype(np.float64), [1], rng),
    "ids2barriers": lambda I, rng: I.ids2barriers(
        np.random.RandomState(4).randint(0, 4, (5, 9, 9)), dilute=(0, 1, 1),
        connectivity=(1, 1, 2)),
    "smearbarriers": lambda I, rng: I.smearbarriers(
        (np.random.RandomState(4).rand(5, 9, 9) > 0.7), (1, 3, 3)),
    "center_cubes_crop": lambda I, rng: I.center_cubes(
        np.arange(10 * 12 * 14).reshape(10, 12, 14),
        np.arange(6 * 8 * 10).reshape(6, 8, 10)),
    "center_cubes_pad": lambda I, rng: I.center_cubes(
        np.ones((2, 5, 6, 7)), np.ones((3, 9, 8)), crop=False),
    "downsample_xy": lambda I, rng: I.downsample_xy(
        np.random.RandomState(5).rand(1, 3, 9, 11).astype(np.float32),
        np.random.RandomState(5).randint(0, 3, (3, 9, 11)), factor=2),
}


@pytest.mark.parametrize("case", sorted(IMAGE_CASES))
def test_image_helpers_equal_jax(case):
    assert_same(IMAGE_CASES[case](jimage, np.random.RandomState(3)),
                IMAGE_CASES[case](timage, np.random.RandomState(3)))


# ------------------------------------------------------------- batch creator

def make_dataset(n=2, size=32, seed=42):
    r = np.random.RandomState(seed)
    raws = [r.rand(1, size, size, size).astype(np.float32) for _ in range(n)]
    return raws, [(x[0] > 0.5).astype(np.int16) for x in raws]


def mfp_net(nm):
    nm.model_manager.reset()
    inp = nm.Input([1, 1, 1, 13, 13], "b,f,z,x,y", name="raw")
    c1 = nm.Conv(inp, 2, (1, 3, 3), (1, 2, 2), mfp=True, name="c1")
    probs = nm.Softmax(nm.Conv(c1, 2, 1, 1, activation_func="lin"))
    tgt = nm.Input([probs.shape["b"], *probs.shape.spatial_shape],
                   "b,z,x,y", dtype="int32", name="target")
    loss = nm.AggregateLoss(nm.MultinoulliNLL(probs, tgt,
                                              target_is_sparse=True))
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=probs)
    return m


def plain_net(nm):
    nm.model_manager.reset()
    inp = nm.Input([1, 1, 11, 12, 12], "b,f,z,x,y", name="raw")
    c1 = nm.Conv(inp, 4, 3, (1, 2, 2), name="c1")
    probs = nm.Softmax(nm.Conv(c1, 2, 1, 1, activation_func="lin"))
    tgt = nm.Input([1, *probs.shape.spatial_shape], "b,z,x,y",
                   dtype="int32", name="target")
    loss = nm.AggregateLoss(nm.MultinoulliNLL(probs, tgt,
                                              target_is_sparse=True))
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=probs)
    return m


def net_2d(nm):
    nm.model_manager.reset()
    inp = nm.Input([2, 1, 20, 20], "b,f,x,y", name="raw")
    probs = nm.Softmax(nm.Conv(nm.Conv(inp, 4, 3, 1, name="c1"), 2, 1, 1,
                               activation_func="lin"))
    tgt = nm.Input([2, *probs.shape.spatial_shape], "b,x,y", dtype="int32",
                   name="target")
    loss = nm.AggregateLoss(nm.MultinoulliNLL(probs, tgt,
                                              target_is_sparse=True))
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=probs)
    return m


def _images(seed=6):
    r = np.random.RandomState(seed)
    imgs = [r.rand(48, 48).astype(np.float32) for _ in range(2)]
    return imgs, [(im > 0.5).astype(np.int16) for im in imgs]


def _setup(cnn, case, nm):
    """A BatchCreatorImage of ``cnn`` for ``case`` and its getbatch kwargs;
    ``nm`` is the same package's neuromancer (for linked geometry)."""
    raws, labs = make_dataset()
    kw = {}
    if case == "images_2d":
        imgs, ilabs = _images()
        bc = cnn.BatchCreatorImage(input_data=imgs, target_data=ilabs)
        bc.link_model_geometry(net_2d(nm))
        return bc, dict(batch_size=2, warp=True)
    if case == "griddata":
        bc = cnn.GridData(input_data=raws, target_data=labs,
                          grid_points=[np.array([[12, 12, 12], [5, 5, 5]]),
                                       np.array([[20.5, 9, 9]])],
                          point_radius=2)
        bc.set_geometry((9, 9, 9), (9, 9, 9))
        return bc, dict(batch_size=2, warp=0.5)
    bc = cnn.BatchCreatorImage(input_data=raws, target_data=labs,
                               valid_cubes=[1] if case == "valid" else None,
                               aniso_factor=1 if case == "iso" else 2)
    if case == "mfp_fragments":
        bc.link_model_geometry(mfp_net(nm))
        return bc, dict(batch_size=2, warp=0.5)
    if case == "linked":
        bc.link_model_geometry(plain_net(nm))
        return bc, dict(batch_size=2, warp=0.5, grey_augment_channels=[0])
    bc.set_geometry((12, 12, 12), (6, 6, 6), (1, 1, 1))
    kw = {"no_warp": dict(batch_size=3, warp=False, flip=False),
          "flips": dict(batch_size=3, warp=False, flip=True),
          "warp": dict(batch_size=2, warp=0.5),
          "iso": dict(batch_size=2, warp=1.0,
                      warp_args={"amount": 0.5}),
          "grey": dict(batch_size=2, warp=0.5, grey_augment_channels=[0]),
          "ignore_thresh": dict(batch_size=2, warp=False,
                                ignore_thresh=0.3),
          "valid": dict(batch_size=2, source="valid")}[case]
    return bc, kw


BATCH_CASES = ["no_warp", "flips", "warp", "iso", "grey", "ignore_thresh",
               "valid", "linked", "mfp_fragments", "images_2d", "griddata"]


@pytest.mark.parametrize("case", BATCH_CASES)
def test_getbatch_equals_jax(core, case):
    jbc, kw = _setup(jcnn, case, jnm)
    tbc, _ = _setup(tcnn, case, tnm)
    for attr in ("patch_size", "target_size", "target_strides"):
        assert getattr(jbc, attr) == getattr(tbc, attr), attr
    assert_same(jbc.frag_offsets, tbc.frag_offsets)
    jbc.rng = np.random.RandomState(17)
    tbc.rng = np.random.RandomState(17)
    for _ in range(3):
        assert_same(jbc.getbatch(**kw), tbc.getbatch(**kw))
    assert jbc.rng.rand() == tbc.rng.rand()   # the same draws were taken
    assert (jbc._n_successful, jbc._n_failed) == \
        (tbc._n_successful, tbc._n_failed)


def test_batch_creator_from_h5_files(tmp_path):
    h5py = pytest.importorskip("h5py")
    raws, labs = make_dataset(n=2, size=24)
    raws[0] = (raws[0] * 255).astype(np.uint8)        # divide255 branch
    for i, (r, l) in enumerate(zip(raws, labs)):
        with h5py.File(tmp_path / f"raw{i}.h5", "w") as f:
            f["raw"] = r[0]
        with h5py.File(tmp_path / f"lab{i}.h5", "w") as f:
            f["lab"] = l
    kw = dict(d_path=str(tmp_path), l_path=str(tmp_path),
              d_files=[(f"raw{i}.h5", "raw") for i in range(2)],
              l_files=[(f"lab{i}.h5", "lab") for i in range(2)],
              valid_cubes=[1])
    jbc, tbc = jcnn.BatchCreatorImage(**kw), tcnn.BatchCreatorImage(**kw)
    assert_same(jbc.train_d, tbc.train_d)
    assert_same(jbc.valid_l, tbc.valid_l)
    assert_same(jbc.cube_prios, tbc.cube_prios)


def test_compute_class_weights_equals_jax():
    raws = [np.random.RandomState(0).rand(1, 16, 16, 16).astype(np.float32)]
    lab = np.zeros((16, 16, 16), np.int16)
    lab[:2] = 1
    lab[5, 5, :3] = 2
    lab[0, 0, 0] = -1                       # unlabelled: ignored
    for n, clip in ((None, (0.25, 4.0)), (4, (0.1, 10.0))):
        j = jcnn.BatchCreatorImage(input_data=raws, target_data=[lab])
        t = tcnn.BatchCreatorImage(input_data=raws, target_data=[lab])
        assert_same(j.compute_class_weights(n, clip),
                    t.compute_class_weights(n, clip))


def test_griddata_rasterisation_equals_jax():
    raw = np.random.RandomState(1).rand(1, 24, 24, 24).astype(np.float32)
    lab = (raw[0] > 0.5).astype(np.int16)
    before = lab.copy()
    pts = [np.array([[12.0, 12.0, 12.0], [3.2, 20.7, 1.0]])]
    kw = dict(input_data=[raw, raw], target_data=[lab, lab.copy()],
              grid_points=pts, point_radius=2.5, valid_cubes=[1])
    j, t = jcnn.GridData(**kw), tcnn.GridData(**kw)
    np.testing.assert_array_equal(lab, before)          # caller untouched
    assert_same(j._all_labels, t._all_labels)
    assert_same(j.train_l, t.train_l)
    assert_same(j.valid_l, t.valid_l)
    assert max(int(c.max()) for c in t._all_labels) == 2


def test_batch_creator_errors_match_jax():
    raws, labs = make_dataset(n=1, size=16)
    for cnn in (jcnn, tcnn):
        bc = cnn.BatchCreatorImage(input_data=raws, target_data=labs)
        with pytest.raises(RuntimeError, match="link_model_geometry"):
            bc.getbatch(1)
        with pytest.raises(ValueError, match="no validation cubes"):
            bc.set_geometry((8, 8, 8)).getbatch(1, source="valid")
        with pytest.raises(RuntimeError, match="could not sample"):
            bc.set_geometry((20, 8, 8)).getbatch(1, max_retries=3)
        with pytest.raises(ValueError, match="no training cubes"):
            cnn.BatchCreatorImage(input_data=raws, target_data=labs,
                                  valid_cubes=[0])
    assert repr(tcnn.BatchCreatorImage(input_data=raws, target_data=labs)
                ).startswith("<BatchCreatorImage 1 train cubes")


# ------------------------------------------------------------ generic data

TRAINDATA_CASES = {
    "mnist_synthetic": lambda D, p: D.MNISTData(
        path=os.path.join(p, "absent.pkl.gz")),
    "piano_synthetic": lambda D, p: D.PianoData(path=None, n_tap=5),
    "data_split": lambda D, p: D.Data(
        np.arange(60, dtype=np.float32).reshape(20, 3), np.arange(20),
        valid_fraction=0.25),
}


@pytest.mark.parametrize("case", sorted(TRAINDATA_CASES))
def test_traindata_equals_jax(case, tmp_path):
    j = TRAINDATA_CASES[case](jtrain, str(tmp_path))
    t = TRAINDATA_CASES[case](ttrain, str(tmp_path))
    for a in ("train_d", "train_l", "valid_d", "valid_l"):
        assert_same(getattr(j, a), getattr(t, a))
    for src in ("train", "valid"):
        assert_same(j.getbatch(7, source=src), t.getbatch(7, source=src))
    assert t.link_model_geometry(None) is t and t.patch_size == ()


def test_mnist_file_is_read(tmp_path):
    import gzip
    import pickle
    r = np.random.RandomState(0)
    sets = [(r.rand(n, 784).astype(np.float32), r.randint(0, 10, n))
            for n in (30, 10, 10)]
    p = str(tmp_path / "mnist.pkl.gz")
    with gzip.open(p, "wb") as f:
        pickle.dump(sets, f)
    j, t = jtrain.MNISTData(path=p), ttrain.MNISTData(path=p)
    assert_same(j.train_d, t.train_d)
    assert len(t.train_d) + len(t.valid_d) == 40


# ------------------------------------------------------------ the package

def test_package_exports():
    # every one of the JAX package's data exports; plus the generic datasets
    # the Trainer resolves by name
    missing = set(jdata.__all__) - set(tdata.__all__)
    assert missing == set(), missing
    for name in tdata.__all__:
        assert getattr(tdata, name) is not None
    for name in ("Data", "MNISTData", "PianoData"):
        assert getattr(tdata, name) is getattr(ttrain, name)


def test_unported_pieces_raise():
    raws, labs = make_dataset(n=1, size=16)
    # the skeleton registry is ported (it was item 2); item 6 still raises
    tdata.skeleton.clear_skeleton_registry()
    assert tdata.skeleton.register_skeleton(None) == 0
    tdata.skeleton.clear_skeleton_registry()
    with pytest.raises(NotImplementedError, match="item 6"):
        timage.make_affinities(labs[0])
