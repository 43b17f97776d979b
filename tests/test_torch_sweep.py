"""Whole-volume serving of the port against the JAX package: ``sweep_knossos``,
the host-tiled ``predict_dense``, the tiled fallback of
``predict_dense_device``, ``rebuild_model`` and ``modelload``'s overrides.

Each graph is built in the JAX package and saved with its ``Model.save``;
the port loads the same file (``modelload(device="cpu")``), so both hold
the same weights. Volumes come from a numpy seed. Tolerance atol 1e-5 on
probabilities (float32 sums in another order, the JAX package's own
tolerance for its sweep fuzz); uint8 maps within 1 (a truncation of values
that agree within 1e-5), and equal to the port's own float maps clipped.
The JAX side runs K1's XLA route (``pallas_tail`` off); the port's K1 route
runs its plain version on the CPU.
"""

import contextlib
import importlib
import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
from __graft_entry__ import _flagship_model  # noqa: E402
from test_data import write_knossos  # noqa: E402
import elektronn2_tpu.neuromancer as jnm  # noqa: E402
from elektronn2_tpu.data import KnossosArray as JaxKnossosArray  # noqa: E402
from elektronn2_tpu.neuromancer.model import (  # noqa: E402
    modelload as jax_modelload)
from elektronn2_tpu.utils.cnncalculator import cnncalculator  # noqa: E402
from elektronn2_tpu_torch.data.knossos_array import KnossosArray  # noqa: E402
from elektronn2_tpu_torch.neuromancer import inference as tinf  # noqa: E402
from elektronn2_tpu_torch.neuromancer.model import (  # noqa: E402
    modelload, rebuild_model)
from elektronn2_tpu_torch.neuromancer.optimiser import opt_leaves  # noqa: E402
from elektronn2_tpu_torch.ops import tailconv  # noqa: E402

torch.set_num_threads(2)
ATOL = 1e-5


@contextlib.contextmanager
def jax_graph():
    """Build JAX nodes on a fresh GraphManager."""
    gmod = importlib.import_module("elektronn2_tpu.neuromancer.graphmanager")
    gm = gmod.GraphManager()
    gmod.push_manager(gm)
    try:
        yield gm
    finally:
        gmod.pop_manager()


def saved_pair(tmp_path, builder, name="m"):
    """(JAX model, port model loaded from the JAX model's file)."""
    with jax_graph() as gm:
        inp, pred = builder(jnm)
        jm = gm.getmodel()
        jm.designate_nodes(input_node=inp, prediction_node=pred)
    fname = str(tmp_path / f"{name}.mdl")
    jm.save(fname)
    return jm, modelload(fname, device="cpu")


def sweep_graph(nm):
    """The graph of tests/test_integration_extra.py::
    test_knossos_whole_dataset_sweep."""
    inp = nm.Input([1, 1, 9, 17, 17], "b,f,z,x,y", name="raw")
    c1 = nm.Conv(inp, 4, 3, 2, mfp=True, name="c1")
    return inp, nm.Softmax(nm.Conv(c1, 2, 1, 1, activation_func="lin"))


def decoder_graph(nm):
    """FaithlessMerge 3D U-Net (tests/test_inference_device.py): valid-size
    period M = (1, 2, 2)."""
    inp = nm.Input([1, 1, 8, 16, 16], "b,f,z,x,y", name="raw")
    enc0 = nm.Conv(inp, 4, (1, 3, 3), (1, 1, 1), name="enc0")
    enc1 = nm.Conv(enc0, 8, (3, 3, 3), (1, 2, 2), name="enc1")
    enc2 = nm.Conv(enc1, 8, (3, 3, 3), (1, 1, 1), name="enc2")
    up = nm.UpConv(enc2, 4, (1, 2, 2), activation_func="relu", name="up")
    merged = nm.FaithlessMerge(up, enc0, name="merge")
    dec = nm.Conv(merged, 8, (1, 3, 3), (1, 1, 1), name="dec")
    return inp, nm.Softmax(nm.Conv(dec, 2, 1, 1, activation_func="lin",
                                   name="cls"))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A 24x32x32 uint8 KNOSSOS dataset in 8^3 cubes, with its volume."""
    vol = (np.random.RandomState(3).rand(24, 32, 32) * 255).astype(np.uint8)
    return vol, write_knossos(tmp_path_factory.mktemp("ds"), vol)


@pytest.fixture(scope="module")
def sweep_pair(tmp_path_factory):
    return saved_pair(tmp_path_factory.mktemp("m"), sweep_graph)


REGION = [(4, 20), (8, 24), (0, 32)]


@pytest.mark.parametrize("region, step, slab_batch", [
    (None, [12, 16, 16], 1),
    (None, [12, 16, 16], 3),          # 8 slabs: a partial last chunk
    (REGION, [8, 16, 16], 2),
    (REGION, [8, 16, 16], 4),
    ([(0, 24), (16, 32), (20, 32)], [10, 9, 7], 2),   # ends at the edges
])
def test_sweep_matches_jax(sweep_pair, dataset, region, step, slab_batch):
    jm, tm = sweep_pair
    vol, path = dataset
    want = jm.sweep_knossos(JaxKnossosArray(path), region=region, step=step,
                            slab_batch=slab_batch)
    got = tm.sweep_knossos(KnossosArray(path), region=region, step=step,
                           slab_batch=slab_batch)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the whole-volume dense path on the same normalised volume
    ref = tm.predict_dense_device(torch.from_numpy(
        vol[None].astype(np.float32) / 255.0), pad_raw=True).numpy()
    sl = (slice(None),) + tuple(slice(a, b) for a, b in
                                (region or [(0, s) for s in vol.shape]))
    np.testing.assert_allclose(got, ref[sl], atol=ATOL, rtol=0)


def test_uint8_cast_has_numpy_bits(sweep_pair, dataset):
    """A uint8 slab is cast on the device by a table lookup; it must give
    the bits of numpy's ``astype(np.float32) / 255.0`` (the JAX package's
    host cast): the sweep of the KNOSSOS dataset equals, bit for bit, the
    sweep of the volume cast on the host."""
    _, tm = sweep_pair
    vol, path = dataset
    np.testing.assert_array_equal(
        tinf._U8_SCALE.view(np.uint32),
        (np.arange(256).astype(np.uint8).astype(np.float32) / 255.0
         ).view(np.uint32))
    for sb in (1, 2):
        a = tm.sweep_knossos(KnossosArray(path), step=[12, 16, 16],
                             slab_batch=sb)
        b = tm.sweep_knossos(vol.astype(np.float32) / 255.0,
                             step=[12, 16, 16], slab_batch=sb)
        assert np.array_equal(a, b)
    # integer datasets are cast to float32 on the host
    c = tm.sweep_knossos(vol.astype(np.uint16), step=[12, 16, 16])
    d = tm.sweep_knossos(vol.astype(np.float32), step=[12, 16, 16])
    assert np.array_equal(c, d)


@pytest.mark.parametrize("draw", range(3))
def test_sweep_fuzz_matches_jax(tmp_path, draw):
    """The draws of tests/test_integration_extra.py::
    test_sweep_serving_equivalence_fuzz (random encoder geometry, region,
    step), with slab_batch from (1, 2, 4), against the JAX sweep."""
    r = np.random.RandomState(100 + draw)
    fz = int(r.choice([1, 3]))
    pool = (1, 2, 2) if r.rand() < 0.5 else (1, 1, 1)
    nf = int(r.choice([3, 5]))

    def build(nm):
        inp = nm.Input([1, 1, 9, 17, 17], "b,f,z,x,y", name="raw")
        c1 = nm.Conv(inp, nf, (fz, 3, 3), pool, mfp=pool != (1, 1, 1),
                     name="c1")
        return inp, nm.Softmax(nm.Conv(c1, 2, 1, 1, activation_func="lin"))

    jm, tm = saved_pair(tmp_path, build)
    Z, X, Y = 20 + int(r.randint(8)), 24 + int(r.randint(12)), 32
    vol = r.rand(Z, X, Y).astype(np.float32)
    step = [int(r.randint(8, 14)), int(r.randint(12, 20)), 16]
    sb = int(r.choice([1, 2, 4]))
    z0, x0 = int(r.randint(0, 6)), int(r.randint(0, 6))
    for reg in (None, [(z0, Z), (x0, X), (0, Y)]):
        want = jm.sweep_knossos(vol, region=reg, step=step, slab_batch=sb)
        got = tm.sweep_knossos(vol, region=reg, step=step, slab_batch=sb)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=f"step={step} slab_batch={sb} "
                                           f"region={reg}")


def test_flagship_sweep_through_k1_matches_jax(tmp_path, monkeypatch):
    """The flagship (widths 20/30/40/40) under ``set_dilated_impl(
    pallas_tail=True)``: the port sweeps through K1's wrapper (its plain
    version on the CPU), per slab and two slabs at a time (K1 at N = 2);
    the JAX package sweeps with ``pallas_tail`` off."""
    jm = _flagship_model(mfp=True, patch=[9, 41, 41])
    fname = str(tmp_path / "flagship.mdl")
    jm.save(fname)
    tm = modelload(fname, device="cpu")
    jm.set_dilated_impl("direct", zfold=True, pallas_tail=False)
    tm.set_dilated_impl("direct", zfold=True, pallas_tail=True)
    calls = []
    orig = tailconv.conv3x3_dilated

    def spy(x, w, b, dil=(1, 1, 1), relu=True):
        calls.append((x.shape[0], tuple(dil)))
        return orig(x, w, b, dil, relu)

    monkeypatch.setattr(tailconv, "conv3x3_dilated", spy)
    vol = (np.random.RandomState(7).rand(10, 44, 40) * 255).astype(np.uint8)
    path = write_knossos(tmp_path, vol, cube_edge=16)
    step = [5, 22, 21]                   # rounded to M = (1, 4, 4)
    want = jm.sweep_knossos(JaxKnossosArray(path, cube_edge=16), step=step)
    for sb in (1, 2):
        calls.clear()
        got = tm.sweep_knossos(KnossosArray(path, cube_edge=16), step=step,
                               slab_batch=sb)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        # 2 x 2 x 2 slabs of (5, 24, 24), two K1 calls per chunk
        assert len(calls) == 2 * 8 // sb
        assert {c[0] for c in calls} == {sb}
        assert {c[1] for c in calls} == {(1, 4, 4)}
    assert tm.sweep_knossos(KnossosArray(path, cube_edge=16)).shape == \
        (2, 10, 44, 40)                  # the default (112, 496, 496) step


def test_decoder_sweep_matches_jax(tmp_path):
    """A decoder (UpConv) graph, slab_batch=2 and an odd step: the step and
    the front halo are rounded to the valid-size period M = (1, 2, 2), so
    every slab keeps the whole-volume pooling phase."""
    jm, tm = saved_pair(tmp_path, decoder_graph)
    vol = np.random.RandomState(8).rand(12, 40, 36).astype(np.float32)
    for sb in (1, 2):
        want = jm.sweep_knossos(vol, step=[5, 13, 11], slab_batch=sb)
        got = tm.sweep_knossos(vol, step=[5, 13, 11], slab_batch=sb)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.array_equal(got, tm.sweep_knossos(vol, step=[5, 14, 12],
                                                slab_batch=2))
    whole = tm.predict_dense_device(torch.from_numpy(vol[None]),
                                    pad_raw=True).numpy()
    np.testing.assert_allclose(got, whole, atol=ATOL, rtol=0)


def test_sweep_oom_falls_back_per_slab(sweep_pair, dataset, monkeypatch):
    """A batched chunk that runs out of device memory: the sweep starts
    over per slab, with the same output, and counts the fallback."""
    _, tm = sweep_pair
    vol, path = dataset
    orig = tinf.dilated_dense_forward

    def oom(model, x, batch=False):
        if batch:
            raise torch.cuda.OutOfMemoryError("simulated")
        return orig(model, x, batch)

    want = tm.sweep_knossos(KnossosArray(path), step=[12, 16, 16])
    monkeypatch.setattr(tinf, "dilated_dense_forward", oom)
    before = tinf.sweep_oom_fallbacks
    got = tm.sweep_knossos(KnossosArray(path), step=[12, 16, 16],
                           slab_batch=2)
    assert tinf.sweep_oom_fallbacks == before + 1
    assert np.array_equal(got, want)


def test_sweep_into_memmap_with_timings(sweep_pair, dataset, tmp_path):
    _, tm = sweep_pair
    vol, path = dataset
    out = np.lib.format.open_memmap(str(tmp_path / "out.npy"), mode="w+",
                                    dtype=np.float32, shape=(2, 16, 16, 32))
    t = {}
    got = tm.sweep_knossos(KnossosArray(path), region=REGION,
                           step=[8, 16, 16], out=out, slab_batch=2,
                           timings=t, verbose=True)
    assert got is out
    out.flush()
    want = tm.sweep_knossos(KnossosArray(path), region=REGION,
                            step=[8, 16, 16], slab_batch=2)
    assert np.array_equal(np.load(str(tmp_path / "out.npy")), want)
    assert sum(t["slabs"]) == 4 and len(t["stage_s"]) == 2 \
        and len(t["write_s"]) == 2
    with pytest.raises(NotImplementedError, match="item 8"):
        tm.sweep_knossos(KnossosArray(path), mesh=object())
    empty = tm.sweep_knossos(vol, region=[(0, 0), (0, 32), (0, 32)],
                             step=[8, 16, 16])
    assert empty.shape == (2, 0, 32, 32)


# --------------------------------------------------- predict_dense, tiled

def mfp_graph(nm):
    """tests/test_inference_device.py::mfp_model (2D, MFP)."""
    n = cnncalculator([3, 3], [2, 2], desired_patch_size=21, mfp=True,
                      ndim=1).input
    inp = nm.Input([1, 1, n, n], "b,f,x,y", name="raw")
    c1 = nm.Conv(inp, 4, 3, 2, mfp=True, name="c1")
    c2 = nm.Conv(c1, 2, 3, 2, mfp=True, name="c2")
    return inp, nm.Softmax(c2)


def strided_graph(nm):
    """tests/test_inference_device.py::test_dilated_dense_strided_model
    (2D, pools without MFP: output stride 4)."""
    n = cnncalculator([3, 3], [2, 2], desired_patch_size=26, mfp=False,
                      ndim=1).input
    inp = nm.Input([1, 1, n, n], "b,f,x,y", name="raw")
    c1 = nm.Conv(inp, 4, 3, 2, name="c1")
    c2 = nm.Conv(c1, 2, 3, 2, name="c2")
    return inp, nm.Softmax(c2)


@pytest.mark.parametrize("builder", [mfp_graph, strided_graph])
@pytest.mark.parametrize("pad_raw", [False, True])
def test_predict_dense_tiled_matches_jax(tmp_path, builder, pad_raw):
    jm, tm = saved_pair(tmp_path, builder)
    rng = np.random.RandomState(9)
    raw = rng.randn(1, 33, 35).astype(np.float32)
    want = jm.predict_dense(raw, pad_raw=pad_raw, prefer_device=False)
    for tb in (1, 3):
        got = tm.predict_dense(raw, pad_raw=pad_raw, prefer_device=False,
                               tile_batch=tb)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        # the tiled fallback of predict_dense_device: the same sweep with
        # the volume on the model's device
        dev = tinf._tiled_sweep(tm, torch.from_numpy(raw), pad_raw, tb)
        np.testing.assert_allclose(dev.numpy(), got, atol=1e-6, rtol=0)
    # uint8 in and out
    r8 = (rng.rand(1, 33, 35) * 255).astype(np.uint8)
    w8 = jm.predict_dense(r8, pad_raw=pad_raw, as_uint8=True,
                          prefer_device=False)
    g8 = tm.predict_dense(r8, pad_raw=pad_raw, as_uint8=True,
                          prefer_device=False)
    assert g8.dtype == np.uint8 and g8.shape == w8.shape
    assert np.abs(g8.astype(int) - w8.astype(int)).max() <= 1
    gf = tm.predict_dense(r8, pad_raw=pad_raw, prefer_device=False)
    assert np.array_equal(g8, np.clip(gf * 255.0, 0, 255).astype(np.uint8))
    # routed to the device path (prefer_device): the MFP graph equals the
    # tiled oracle; the strided one at the strided positions
    fast = tm.predict_dense(raw, pad_raw=pad_raw)
    if builder is mfp_graph:
        np.testing.assert_allclose(fast, want, atol=ATOL, rtol=0)
    else:
        np.testing.assert_allclose(fast[:, ::4, ::4], want[:, ::4, ::4],
                                   atol=ATOL, rtol=0)


def test_predict_dense_device_budget_routes(tmp_path):
    jm, tm = saved_pair(tmp_path, mfp_graph)
    raw = np.random.RandomState(10).rand(29, 31).astype(np.float32)
    tiled = tm.predict_dense(raw, device_budget=0)     # too big: tiles
    routed = tm.predict_dense(raw)
    np.testing.assert_allclose(tiled, routed, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        tiled, jm.predict_dense(raw, device_budget=0), atol=ATOL, rtol=0)


# ---------------------------------------------- rebuild_model, modelload

def train_graph(nm):
    inp = nm.Input([2, 1, 5, 20, 20], "b,f,z,x,y", name="raw")
    c0 = nm.Conv(inp, 4, (1, 3, 3), (1, 2, 2), name="c0")
    c1 = nm.Conv(c0, 4, (3, 3, 3), 1, name="c1")
    probs = nm.Softmax(nm.Conv(c1, 2, 1, 1, activation_func="lin",
                               name="cls"), name="probs")
    tgt = nm.Input([2, *probs.shape.spatial_shape], "b,z,x,y",
                   dtype="int32", name="target")
    loss = nm.AggregateLoss(nm.MultinoulliNLL(probs, tgt,
                                              target_is_sparse=True),
                            name="loss")
    return inp, probs, tgt, loss


@pytest.fixture(scope="module")
def trained_file(tmp_path_factory):
    """A JAX model file with an Adam state after one training step."""
    with jax_graph() as gm:
        inp, probs, tgt, loss = train_graph(jnm)
        jm = gm.getmodel()
        jm.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                           prediction_node=probs)
    jm.set_opt("Adam", lr=1e-3)
    rng = np.random.RandomState(11)
    x = rng.rand(2, 1, 5, 20, 20).astype(np.float32)
    y = (rng.rand(2, *probs.shape.spatial_shape) > 0.5).astype(np.int32)
    jm.trainingstep(x, y)
    fname = str(tmp_path_factory.mktemp("t") / "trained.mdl")
    jm.save(fname)
    return fname


@pytest.mark.parametrize("mfp, patch", [(False, [7, 24, 24]),
                                        (True, [5, 21, 21]),
                                        (True, [7, 25, 25])])
def test_modelload_overrides_match_jax(trained_file, mfp, patch):
    jm = jax_modelload(trained_file, override_mfp_to_active=mfp,
                       imposed_patch_size=patch)
    tm = modelload(trained_file, override_mfp_to_active=mfp,
                   imposed_patch_size=patch, device="cpu")
    for name, node in jm.nodes.items():
        assert tuple(tm.nodes[name].shape) == tuple(node.shape), name
    assert tm.prediction_node.shape.n_frag == jm.prediction_node.shape.n_frag
    np.testing.assert_array_equal(tm.prediction_node.shape.mfp_offsets,
                                  jm.prediction_node.shape.mfp_offsets)
    assert tuple(tm.target_node.shape) == tuple(jm.target_node.shape)
    for n, d in jm.params.items():
        for k, v in d.items():
            np.testing.assert_array_equal(tm.params[n][k].numpy(),
                                          np.asarray(v))
    # the Adam state carried over, leaf for leaf
    assert tm._step_count == jm._step_count == 1
    import jax
    jl = jax.tree_util.tree_leaves(jm.opt_state)
    tl = opt_leaves(tm.opt_state)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    x = np.random.RandomState(12).rand(
        *tm.input_node.shape).astype(np.float32)
    np.testing.assert_allclose(tm.predict(x).numpy(),
                               np.asarray(jm.predict(x)), atol=ATOL, rtol=0)


def test_rebuild_model_carries_weights_and_lowerings(trained_file):
    tm = modelload(trained_file, device="cpu")
    tm.set_dilated_impl("direct", zfold=True, pallas_tail=True)
    tm.set_convdense_impl(upconv="d2s", zfold=True, skipsum=True)
    new = rebuild_model(tm, override_mfp_to_active=True,
                        imposed_patch_size=[5, 21, 21])
    assert new._dilated_ptail and new._convdense_upconv == "d2s"
    assert new._convdense_zfold and new._convdense_skipsum
    for n, d in tm.params.items():
        for k, v in d.items():
            assert torch.equal(new.params[n][k], v)
            assert new.params[n][k].data_ptr() != v.data_ptr()   # a clone
    vol = torch.rand(1, 9, 30, 30)
    np.testing.assert_allclose(new.predict_dense_device(vol).numpy(),
                               tm.predict_dense_device(vol).numpy(),
                               atol=ATOL, rtol=0)
    same = rebuild_model(tm)
    assert tuple(same.input_node.shape) == tuple(tm.input_node.shape)
