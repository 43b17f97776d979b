"""U-Net conv-dense serving of the port against the JAX package.

The decoder graphs (the conv-dense test fixtures of
tests/test_inference_device.py, ``examples/unet3d.py`` and
``examples/unet3d_wide.py`` at small widths) are built in both packages,
the JAX weights are copied across, and the same numpy volumes go through
``predict_dense_device`` of each. The JAX side runs its default lowering
(ptail off); the port runs every lowering knob, K1's route included (its
plain version on the CPU). Tolerance atol 2e-5, the JAX package's own for
these knobs: float32 sums reassociated by another conv algorithm.
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
sys.path.insert(0, os.path.join(REPO, "examples"))
import unet3d  # noqa: E402
import unet3d_wide  # noqa: E402
import elektronn2_tpu.neuromancer as jnm  # noqa: E402
from elektronn2_tpu.neuromancer.inference import (  # noqa: E402
    convolutional_dense_forward as jax_convolutional_dense_forward)
from elektronn2_tpu_torch import neuromancer as tnm  # noqa: E402
from elektronn2_tpu_torch.neuromancer import inference as tinf  # noqa: E402
from elektronn2_tpu_torch.neuromancer.neural import FaithlessMerge  # noqa: E402
from elektronn2_tpu_torch.ops import tailconv  # noqa: E402
from elektronn2_tpu_torch.utils.convert import (  # noqa: E402
    flagship_model, params_from_jax, tracer_model, unet3d_model,
    wide_unet_model)

jconv = importlib.import_module("elektronn2_tpu.ops.conv")
tconv = importlib.import_module("elektronn2_tpu_torch.ops.conv")
torch.set_num_threads(1)
ATOL = 2e-5
WIDTHS = (4, 8, 16)

KNOBS = [
    {}, {"upconv": "d2s"}, {"zfold": True}, {"skipsum": True},
    {"poolslice": True}, {"ptail": True},
    {"upconv": "d2s", "zfold": True, "skipsum": True, "poolslice": True,
     "ptail": True},
    {"zfold": True, "skipsum": True, "ptail": True},     # the bench's + K1
]


@contextlib.contextmanager
def fresh_graph(package):
    """Build nodes on a new GraphManager of ``package``'s graphmanager."""
    gmod = importlib.import_module(f"{package}.neuromancer.graphmanager")
    gm = gmod.GraphManager()
    gmod.push_manager(gm)
    try:
        yield gm
    finally:
        gmod.pop_manager()


def crop_concat_unet(nm):
    """Explicit Crop + Concat 2D U-Net (tests/test_inference_device.py)."""
    inp = nm.Input([1, 1, 16, 16], "b,f,x,y", name="raw")
    c0 = nm.Conv(inp, 4, 3, 1, name="c0")
    c1 = nm.Conv(c0, 8, 3, 2, name="c1")
    c2 = nm.Conv(c1, 8, 3, 1, name="c2")
    up = nm.UpConv(c2, 4, 2, name="up")
    skip = nm.Crop(c0, [(3, 3), (3, 3)], name="skip")
    merged = nm.Concat([up, skip], name="cat")
    dec = nm.Conv(merged, 8, 3, 1, name="dec")
    probs = nm.Softmax(nm.Conv(dec, 2, 1, 1, activation_func="lin",
                               name="cls"))
    return inp, probs


def faithless_unet3d(nm):
    """FaithlessMerge 3D U-Net (tests/test_inference_device.py)."""
    inp = nm.Input([1, 1, 8, 16, 16], "b,f,z,x,y", name="raw")
    enc0 = nm.Conv(inp, 4, (1, 3, 3), (1, 1, 1), name="enc0")
    enc1 = nm.Conv(enc0, 8, (3, 3, 3), (1, 2, 2), name="enc1")
    enc2 = nm.Conv(enc1, 8, (3, 3, 3), (1, 1, 1), name="enc2")
    up = nm.UpConv(enc2, 4, (1, 2, 2), activation_func="relu", name="up")
    merged = nm.FaithlessMerge(up, enc0, name="merge")
    dec = nm.Conv(merged, 8, (1, 3, 3), (1, 1, 1), name="dec")
    probs = nm.Softmax(nm.Conv(dec, 2, 1, 1, activation_func="lin",
                               name="cls"))
    return inp, probs


def underproducing_unet(nm):
    """Merges an UpConv output with a map still at stride 2: the merge crop
    loses more voxels the larger the input."""
    inp = nm.Input([1, 1, 16, 16], "b,f,x,y", name="raw")
    c0 = nm.Conv(inp, 4, 3, 2, name="c0")
    c1 = nm.Conv(c0, 4, 3, 1, name="c1")
    up = nm.UpConv(c1, 4, 2, name="up")
    merged = nm.FaithlessMerge(up, c0, name="merge")
    probs = nm.Softmax(nm.Conv(merged, 2, 1, 1, activation_func="lin",
                               name="cls"))
    return inp, probs


def _pair(builder):
    """(jax model, port model on the CPU with the JAX weights)."""
    models = []
    for pkg, nm in (("elektronn2_tpu", jnm), ("elektronn2_tpu_torch", tnm)):
        with fresh_graph(pkg) as gm:
            inp, probs = builder(nm)
            m = gm.getmodel()
            m.designate_nodes(input_node=inp, prediction_node=probs)
        models.append(m)
    jm, tm = models
    tm.set_params(params_from_jax(jm.params, tm))
    return jm, tm


def _example_pair(name):
    if name == "unet3d":
        jm, tm = unet3d.create_model(), unet3d_model(device="cpu")
    else:
        jm = unet3d_wide.create_model(widths=WIDTHS)
        tm = wide_unet_model(widths=WIDTHS, device="cpu")
    tm.set_params(params_from_jax(jm.params, tm))
    return jm, tm


MODELS = {
    "faithless_unet3d": (lambda: _pair(faithless_unet3d), (1, 11, 21, 23)),
    "crop_concat_unet": (lambda: _pair(crop_concat_unet), (1, 27, 29)),
    "unet3d": (lambda: _example_pair("unet3d"), (1, 18, 40, 42)),
    "unet3d_wide": (lambda: _example_pair("unet3d_wide"), (1, 18, 70, 74)),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request):
    """(name, jax model, port model, volume, {pad_raw: JAX output})."""
    build, shape = MODELS[request.param]
    jm, tm = build()
    vol = np.random.RandomState(len(shape) + shape[-1]).rand(
        *shape).astype(np.float32)
    ref = {pr: np.asarray(jm.predict_dense_device(jnp.asarray(vol),
                                                  pad_raw=pr))
           for pr in (False, True)}
    return request.param, jm, tm, vol, ref


# ------------------------------------------------------------------ ops

@pytest.mark.parametrize("nsp, pool, ci, co", [
    (2, (2, 2), 5, 3), (2, (3, 2), 4, 4), (3, (1, 2, 2), 6, 3),
    (3, (2, 2, 2), 3, 5), (3, (3, 1, 2), 4, 2)])
def test_upconv_ops_match_jax(nsp, pool, ci, co):
    rng = np.random.RandomState(ci * 10 + co)
    sp = tuple(rng.randint(4, 8) for _ in range(nsp))
    x = rng.randn(2, ci, *sp).astype(np.float32)
    w = rng.randn(co, ci, *pool).astype(np.float32)
    ref = np.asarray(jconv.upconv(jnp.asarray(x), jnp.asarray(w), pool))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = tconv.upconv(tx, tw, pool).numpy()
    d2s = tconv.upconv_d2s(tx, tw, pool).numpy()
    assert got.shape == d2s.shape == ref.shape
    # one tap per output voxel: the same product, so 1e-6 at most
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(d2s, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("ci, co, sp", [(1, 3, (4, 9, 11)),
                                        (5, 4, (3, 8, 7))])
def test_conv_zfold2d_matches_jax(ci, co, sp):
    rng = np.random.RandomState(ci + co)
    x = rng.randn(2, ci, *sp).astype(np.float32)
    w = rng.randn(co, ci, 1, 3, 3).astype(np.float32)
    ref = np.asarray(jconv.conv_zfold2d(jnp.asarray(x), jnp.asarray(w)))
    got = tconv.conv_zfold2d(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["max", "sum", "avg"])
@pytest.mark.parametrize("pool, sp", [((2, 2), (7, 9)),
                                      ((1, 2, 2), (3, 9, 8)),
                                      ((2, 3, 2), (5, 7, 9))])
def test_pooling_slices_matches_jax(pool, sp, mode):
    rng = np.random.RandomState(len(sp))
    x = rng.randn(2, 3, *sp).astype(np.float32)
    ref = np.asarray(jconv.pooling_slices(jnp.asarray(x), pool, mode))
    got = tconv.pooling_slices(torch.from_numpy(x), pool, mode)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)
    if mode == "max":      # the same function as the windowed pool
        np.testing.assert_array_equal(
            got.numpy(), tconv.pooling(torch.from_numpy(x), pool).numpy())


@pytest.mark.parametrize("pool", [(2, 3), (1, 2, 2), (3, 1, 2)])
def test_unpooling_matches_jax(pool):
    x = np.random.RandomState(5).randn(2, 3, *[4] * len(pool)).astype(
        np.float32)
    ref = np.asarray(jconv.unpooling(jnp.asarray(x), pool))
    got = tconv.unpooling(torch.from_numpy(x), pool)
    np.testing.assert_array_equal(got.numpy(), ref)


# ------------------------------------------------------ conv-dense path

@pytest.mark.parametrize("pad_raw", [False, True])
@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: ",".join(k) or "default")
def test_conv_dense_matches_jax(case, knobs, pad_raw):
    name, jm, tm, vol, ref = case
    tm.set_convdense_impl(**knobs)
    got = tm.predict_dense_device(torch.from_numpy(vol), pad_raw=pad_raw)
    assert tuple(got.shape) == ref[pad_raw].shape
    if pad_raw:
        assert tuple(got.shape[1:]) == vol.shape[1:]
    np.testing.assert_allclose(got.numpy(), ref[pad_raw], atol=ATOL, rtol=0)


@pytest.mark.parametrize("pad_raw", [False, True])
def test_batch_matches_jax_and_single(case, pad_raw):
    name, jm, tm, vol, _ = case
    tm.set_convdense_impl(zfold=True, skipsum=True, ptail=True)
    vols = np.stack([vol, vol[:, ::-1, ::-1].copy()])
    with torch.no_grad():
        got = tinf.convolutional_dense_forward(
            tm, torch.from_numpy(vols), pad_raw=pad_raw, batch=True)
        one = [tinf.convolutional_dense_forward(tm, torch.from_numpy(v),
                                                pad_raw=pad_raw)
               for v in vols]
    ref = np.asarray(jax_convolutional_dense_forward(
        jm, jnp.asarray(vols), pad_raw=pad_raw, batch=True))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    for i in range(2):
        np.testing.assert_allclose(got[i].numpy(), one[i].numpy(),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("knobs", [{}, KNOBS[-2]],
                         ids=["default", "all"])
def test_dense_matches_aligned_patches(case, knobs):
    """The conv-dense oracle: dense voxel tau+j == the patch-at-tau output
    j, for patch origins tau that are multiples of the largest stride."""
    name, jm, tm, vol, _ = case
    tm.set_convdense_impl(**knobs)
    dense = tm.predict_dense_device(torch.from_numpy(vol)).numpy()
    patch = list(tm.input_node.shape.spatial_shape)
    out0 = list(tm.prediction_node.shape.spatial_shape)
    M = tinf._valid_period(tm.prediction_node, len(patch))
    rng = np.random.RandomState(7)
    origins = [[0] * len(patch),
               [m * rng.randint(0, (v - p) // m + 1)
                for m, v, p in zip(M, vol.shape[1:], patch)]]
    for tau in origins:
        x = vol[(slice(None),) + tuple(slice(t, t + p)
                                       for t, p in zip(tau, patch))]
        p_out = tm.predict(torch.from_numpy(x[None]))[0].numpy()
        # a patch at the far edge may reach past the dense V - fov + 1
        n = [min(o, s - t) for o, s, t in zip(out0, dense.shape[1:], tau)]
        np.testing.assert_allclose(
            dense[(slice(None),) + tuple(slice(t, t + k)
                                         for t, k in zip(tau, n))],
            p_out[(slice(None),) + tuple(slice(0, k) for k in n)],
            atol=1e-5, rtol=0)


def test_output_layout_is_fzxy(case):
    name, jm, tm, vol, _ = case
    tm.set_convdense_impl(zfold=True, skipsum=True, ptail=True)
    for pad_raw in (False, True):
        out = tm.predict_dense_device(torch.from_numpy(vol), pad_raw=pad_raw)
        fov = tm.prediction_node.shape.fov
        want = vol.shape[1:] if pad_raw else tuple(
            s - f + 1 for s, f in zip(vol.shape[1:], fov))
        assert tuple(out.shape) == (2,) + tuple(want)
        assert out.is_contiguous()
        np.testing.assert_allclose(out.sum(0).numpy(), 1.0, atol=1e-6)


def test_ptail_routes_eligible_convs_through_k1(monkeypatch):
    """Under ptail, the wide U-Net's e1a, e1b (pooled), bott and d1 go
    through K1's wrapper (its plain version on the CPU: no launch); the
    skip concat m0 is never built under skipsum, m1 is (d1 reads it)."""
    from elektronn2_tpu_torch.neuromancer import neural
    jm, tm = _example_pair("unet3d_wide")
    calls, merges = [], []
    orig = tailconv.conv3x3_dilated
    orig_merge = FaithlessMerge._compute

    def spy(x, w, b, dil=(1, 1, 1), relu=True):
        calls.append((tuple(x.shape[:2]), tuple(w.shape[:2])))
        return orig(x, w, b, dil, relu)

    def merge_spy(self, ctx, a, b):
        merges.append(self.name)
        return orig_merge(self, ctx, a, b)

    monkeypatch.setattr(neural, "conv3x3_dilated", spy)
    monkeypatch.setattr(FaithlessMerge, "_compute", merge_spy)
    vol = torch.from_numpy(np.random.RandomState(3).rand(
        1, 18, 70, 74).astype(np.float32))
    tm.set_convdense_impl(zfold=True, skipsum=True, ptail=True)
    before = tailconv.launches
    a = tm.predict_dense_device(vol, pad_raw=True)
    assert tailconv.launches == before
    w0, w1, w2 = WIDTHS
    assert [c[1] for c in calls] == [(w1, w0), (w1, w1), (w2, w1),
                                     (w1, 2 * w1)]
    assert merges == ["m1"]
    tm.set_convdense_impl(zfold=True, skipsum=True)
    b = tm.predict_dense_device(vol, pad_raw=True)
    assert len(calls) == 4 and merges == ["m1"]
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)


def test_underproducing_graph_raises_naming_tiled_fallback():
    """The convolutional path refuses a graph whose merge-crop deficit
    grows with the input, in both packages; predict_dense_device then
    serves it through the tiled fallback, equal to the JAX package's."""
    jm, tm = _pair(underproducing_unet)
    vol = np.random.RandomState(4).rand(1, 40, 40).astype(np.float32)
    with pytest.raises(ValueError, match="under-produces"):
        jax_convolutional_dense_forward(jm, jnp.asarray(vol))
    with pytest.raises(tinf.ConvDenseShapeError, match="tiled fallback"):
        tinf.convolutional_dense_forward(tm, torch.from_numpy(vol))
    want = np.asarray(jm.predict_dense_device(jnp.asarray(vol)))
    got = tm.predict_dense_device(torch.from_numpy(vol)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_k1_error_in_the_walk_reaches_the_caller(monkeypatch):
    """Only a refusal for the volume's shape takes the tiled fallback: a
    ValueError raised by K1's wrapper inside the conv-dense walk reaches
    the caller of predict_dense_device, and no tile is run."""
    from elektronn2_tpu_torch.neuromancer import neural
    _, tm = _example_pair("unet3d_wide")
    orig = tailconv.conv3x3_dilated

    def wrong_bias(x, w, b, dil=(1, 1, 1), relu=True):
        return orig(x, w, b[:-1], dil, relu)

    def no_tiles(*args, **kwargs):
        raise AssertionError("the tiled fallback ran")

    monkeypatch.setattr(neural, "conv3x3_dilated", wrong_bias)
    monkeypatch.setattr(tinf, "_tiled_sweep", no_tiles)
    vol = torch.from_numpy(np.random.RandomState(6).rand(
        1, 18, 70, 74).astype(np.float32))
    tm.set_convdense_impl(zfold=True, skipsum=True, ptail=True)
    with pytest.raises(ValueError, match="tail conv: b must be") as err:
        tm.predict_dense_device(vol, pad_raw=True)
    assert not isinstance(err.value, tinf.ConvDenseShapeError)


def test_routing_and_errors():
    jm, tm = _pair(faithless_unet3d)
    vol = torch.rand(1, 11, 21, 23)
    tinf.check_conv_dense_supported(tm.prediction_node)
    with pytest.raises(NotImplementedError, match="ptail knobs"):
        tm.set_convdense_impl(ptail={"z_block": 4})
    with pytest.raises(ValueError, match="upconv"):
        tm.set_convdense_impl(upconv="bogus")
    with pytest.raises(ValueError, match="rank"):
        tinf.convolutional_dense_forward(tm, vol, batch=True)
    with pytest.raises(ValueError, match="fov"):
        tm.predict_dense_device(torch.rand(1, 3, 21, 23))
    # the dilated path never sees a decoder graph, and vice versa
    with pytest.raises(NotImplementedError, match="UpConv"):
        tinf.dilated_dense_forward(tm, vol)
    fm = flagship_model(mfp=True, patch=[9, 41, 41], device="cpu")
    with pytest.raises(ValueError, match="MFP"):
        tinf.check_conv_dense_supported(fm.prediction_node)
    # a graph neither whole-volume path takes is served by the tiled
    # fallback, equal to the JAX package's
    def crop_graph(nm):
        inp = nm.Input([1, 1, 9, 9], "b,f,x,y", name="raw")
        return inp, nm.Crop(nm.Conv(inp, 2, 3, name="a"), 1, name="crop")
    jc, tc = _pair(crop_graph)
    with pytest.raises(NotImplementedError, match="tiled fallback"):
        tinf.dilated_dense_forward(tc, torch.rand(1, 12, 12))
    v = np.random.RandomState(5).rand(1, 12, 12).astype(np.float32)
    np.testing.assert_allclose(
        tc.predict_dense_device(torch.from_numpy(v)).numpy(),
        np.asarray(jc.predict_dense_device(jnp.asarray(v))), atol=ATOL,
        rtol=0)


def test_faithless_merge_crops_at_run_time():
    """On an input larger than the design patch the merge crops by the
    values' shapes (tests/test_inference_device.py)."""
    jm, tm = _pair(faithless_unet3d)
    y = tm.predict(torch.rand(1, 1, 10, 20, 20))
    assert tuple(y.shape) == (1, 2, 6, 10, 10)


def test_wide_unet_model_matches_jax_builder():
    for kw in ({}, {"widths": WIDTHS, "patch": (16, 40, 40)}):
        jm = unet3d_wide.create_model(**kw)
        tm = wide_unet_model(device="cpu", **kw)
        assert list(tm.nodes) == list(jm.nodes)
        for n, node in jm.nodes.items():
            assert type(tm.nodes[n]).__name__ == type(node).__name__
            assert tuple(tm.nodes[n].shape) == tuple(node.shape)
            assert tuple(tm.nodes[n].shape.fov) == tuple(node.shape.fov)
        assert {n: {k: tuple(v.shape) for k, v in d.items()}
                for n, d in tm.params.items()} == \
            {n: {k: tuple(np.shape(v)) for k, v in d.items()}
             for n, d in jm.params.items()}
        assert tm.params["u1"]["w"].shape[2:] == (1, 2, 2)
    jm, tm = unet3d.create_model(), unet3d_model(device="cpu")
    assert list(tm.nodes) == list(jm.nodes)
    # the error-rate node evaluates as the JAX one does
    x = np.random.RandomState(8).rand(1, 1, 16, 32, 32).astype(np.float32)
    tm.set_params(params_from_jax(jm.params, tm))
    t = (np.random.RandomState(9).rand(
        *jm.target_node.shape) > 0.5).astype(np.int32)
    ref, _ = jm._apply([jm.error_node], jm.params, jm.state,
                       {"raw": x, "target": t}, None, train=False)
    got, _ = tm._apply([tm.error_node], tm.params, tm.state,
                       {"raw": torch.from_numpy(x),
                        "target": torch.from_numpy(t)}, None, train=False)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-6)


@pytest.mark.parametrize("entry", ["flagship_model", "tracer_model",
                                   "wide_unet_model", "unet3d_model",
                                   "modelload"])
def test_entry_points_default_to_the_card(entry, tmp_path, monkeypatch):
    """Without ``device`` the entry points put the model on the card; with
    no card they raise, naming ``device='cpu'``, and never fall back."""
    from elektronn2_tpu_torch.neuromancer.model import modelload
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "m.mdl")
    unet3d_model(device="cpu").save(path)
    call = {"flagship_model": lambda: flagship_model(patch=[9, 41, 41]),
            "tracer_model": lambda: tracer_model((4, 4, 4)),
            "wide_unet_model": lambda: wide_unet_model(widths=WIDTHS),
            "unet3d_model": unet3d_model,
            "modelload": lambda: modelload(path)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert modelload(path, device="cpu").device == torch.device("cpu")


def test_transposed_view_weight_takes_the_k1_route():
    """``set_params`` stores contiguous tensors: a weight given as a strided
    view reaches K1's wrapper (which refuses one) under ptail, and the K1
    route equals the cuDNN route."""
    jm, tm = _example_pair("unet3d_wide")
    params = {n: dict(d) for n, d in tm.params.items()}
    w = params["d1"]["w"]
    params["d1"]["w"] = w.transpose(0, 1).contiguous().transpose(0, 1)
    assert not params["d1"]["w"].is_contiguous()
    tm.set_params(params)
    vol = torch.from_numpy(np.random.RandomState(6).rand(
        1, 18, 70, 74).astype(np.float32))
    tm.set_convdense_impl(zfold=True, skipsum=True, ptail=True)
    a = tm.predict_dense_device(vol, pad_raw=True)
    assert tm.params["d1"]["w"].is_contiguous()
    assert torch.equal(tm.params["d1"]["w"], w)
    tm.set_convdense_impl(zfold=True, skipsum=True)
    b = tm.predict_dense_device(vol, pad_raw=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)
