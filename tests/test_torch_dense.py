"""The dense MFP slice of the port against the JAX package, end to end.

The flagship net at full widths (20/30/40/40), weights loaded from the JAX
model, inputs from a numpy seed. Tolerance atol 1e-5 on probabilities:
float32 sums taken in another order by XLA and by PyTorch.
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
from __graft_entry__ import _flagship_model, entry  # noqa: E402
from elektronn2_tpu.neuromancer.model import modelload as jax_modelload  # noqa: E402
from elektronn2_tpu_torch.neuromancer.model import modelload  # noqa: E402
from elektronn2_tpu_torch.ops import tailconv  # noqa: E402
from elektronn2_tpu_torch.ops.mfp import fragments2dense  # noqa: E402
from elektronn2_tpu_torch.utils.convert import (flagship_model,  # noqa: E402
                                                params_from_jax)

torch.set_num_threads(1)
ATOL = 1e-5
PATCH = [23, 103, 103]


@contextlib.contextmanager
def fresh_graph(package):
    """Build nodes on a new GraphManager of ``package``'s graphmanager module
    (the module-global one would be reset under the module-scoped models)."""
    gmod = importlib.import_module(f"{package}.neuromancer.graphmanager")
    gm = gmod.GraphManager()
    gmod.push_manager(gm)
    try:
        yield gm
    finally:
        gmod.pop_manager()


# The flagship builders reset their package's global model_manager, whose
# node dict every model built on it shares; so each test builds its own pair
# (cheap: no compilation), from the same seed, hence the same weights.
@pytest.fixture
def jax_model():
    return _flagship_model(mfp=True, patch=PATCH)


@pytest.fixture
def port_model(jax_model):
    m = flagship_model(mfp=True, patch=PATCH, device="cpu")
    m.set_params(params_from_jax(jax_model.params, m))
    return m


@pytest.fixture(scope="module")
def vol():
    return np.random.RandomState(0).rand(1, 12, 64, 64).astype(np.float32)


@pytest.fixture(scope="module")
def jax_dense(vol):
    m = _flagship_model(mfp=True, patch=PATCH)
    m.set_dilated_impl("direct", zfold=True, pallas_tail=False)
    return np.asarray(m.predict_dense_device(jnp.asarray(vol), pad_raw=True))


def test_modelload_reads_jax_save(jax_model, tmp_path):
    fname = str(tmp_path / "flagship.mdl")
    jax_model.save(fname)
    m = modelload(fname, device="cpu")
    assert list(m.nodes) == list(jax_model.nodes)
    for name, node in jax_model.nodes.items():
        assert type(m.nodes[name]).__name__ == type(node).__name__
        assert tuple(m.nodes[name].shape) == tuple(node.shape)
    assert set(m.params) == set(jax_model.params)
    for n, d in jax_model.params.items():
        assert set(m.params[n]) == set(d)
        for k, v in d.items():
            np.testing.assert_array_equal(m.params[n][k].numpy(),
                                          np.asarray(v))
    assert m.prediction_node.name == "probs"
    assert m.input_node.name == "raw"
    assert m.loss_node.name == "loss" and m.target_node.name == "target"


def test_params_from_jax_equals_modelload(jax_model, port_model, tmp_path):
    fname = str(tmp_path / "flagship.mdl")
    jax_model.save(fname)
    loaded = modelload(fname, device="cpu").params
    conv = params_from_jax(jax_model.params, port_model)
    assert set(conv) == set(loaded)
    for n in conv:
        for k in conv[n]:
            assert conv[n][k].dtype == torch.float32
            assert torch.equal(conv[n][k], loaded[n][k])


def test_params_from_jax_checks_shapes(jax_model, port_model):
    bad = {n: dict(d) for n, d in jax_model.params.items()}
    bad["conv2"]["w"] = np.zeros((40, 31, 3, 3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, port_model)
    missing = {n: d for n, d in jax_model.params.items() if n != "barrier"}
    with pytest.raises(ValueError, match="barrier"):
        params_from_jax(missing, port_model)
    ints = {n: {k: np.zeros(np.shape(v), np.int32) for k, v in d.items()}
            for n, d in jax_model.params.items()}
    with pytest.raises(TypeError, match="floating"):
        params_from_jax(ints)


def test_jax_modelload_reads_port_save(port_model, jax_model, tmp_path):
    fname = str(tmp_path / "port.mdl")
    port_model.save(fname)
    jm = jax_modelload(fname)
    assert list(jm.nodes) == list(port_model.nodes)
    for n, d in port_model.params.items():
        for k, v in d.items():
            np.testing.assert_array_equal(np.asarray(jm.params[n][k]),
                                          v.numpy())


@pytest.mark.parametrize("pallas_tail", [True, False])
def test_dense_matches_jax(port_model, vol, jax_dense, pallas_tail):
    port_model.set_dilated_impl("direct", zfold=True, pallas_tail=pallas_tail)
    got = port_model.predict_dense_device(torch.from_numpy(vol),
                                          pad_raw=True)
    assert tuple(got.shape) == jax_dense.shape == (2, 12, 64, 64)
    np.testing.assert_allclose(got.numpy(), jax_dense, atol=ATOL, rtol=0)


def test_pallas_tail_routes_agree_and_use_k1(port_model, vol, monkeypatch):
    calls = []
    orig = tailconv.conv3x3_dilated

    def spy(x, w, b, dil=(1, 1, 1), relu=True):
        calls.append((tuple(x.shape), tuple(dil)))
        return orig(x, w, b, dil, relu)

    monkeypatch.setattr(tailconv, "conv3x3_dilated", spy)
    v = torch.from_numpy(vol)
    port_model.set_dilated_impl("direct", zfold=True, pallas_tail=True)
    a = port_model.predict_dense_device(v, pad_raw=True)
    # conv2 and conv3, at the cumulative pool stride (1, 4, 4)
    assert [c[1] for c in calls] == [(1, 4, 4), (1, 4, 4)]
    assert calls[0][0][:2] == (1, 30) and calls[1][0][:2] == (1, 40)
    port_model.set_dilated_impl("direct", zfold=True, pallas_tail=False)
    b = port_model.predict_dense_device(v, pad_raw=True)
    assert len(calls) == 2
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)


def test_mfp_route_matches_entry():
    fn, (params, x) = entry()
    ref = np.asarray(fn(params, x))
    m = flagship_model(mfp=True, device="cpu")
    m.set_params(params_from_jax(params, m))
    outs, _ = m._apply([m.prediction_node], m.params, m.state,
                       {m.input_node.name: torch.from_numpy(x)}, None,
                       train=False)
    got = fragments2dense(outs[0], m.prediction_node.shape.mfp_offsets)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_mfp_route_matches_dense_path(port_model):
    # the oracle: fragments + restitch == the dilated dense path (K1 route)
    port_model.set_dilated_impl("direct", zfold=True, pallas_tail=True)
    patch = port_model.input_node.shape.spatial_shape
    v = torch.from_numpy(
        np.random.RandomState(1).rand(1, *patch).astype(np.float32))
    frag = port_model.predict(v[None])
    mfp = fragments2dense(frag, port_model.prediction_node.shape.mfp_offsets)
    dense = port_model.predict_dense_device(v)
    assert tuple(mfp.shape[1:]) == tuple(dense.shape)
    np.testing.assert_allclose(mfp[0].numpy(), dense.numpy(), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("pad_raw", [True, False])
def test_output_layout_is_fzxy(port_model, pad_raw):
    port_model.set_dilated_impl("direct", zfold=True, pallas_tail=True)
    v = torch.rand(1, 9, 40, 36)
    out = port_model.predict_dense_device(v, pad_raw=pad_raw)
    fov = port_model.prediction_node.shape.fov
    want = (2, 9, 40, 36) if pad_raw else \
        (2,) + tuple(s - f + 1 for s, f in zip(v.shape[1:], fov))
    assert tuple(out.shape) == want
    assert out.is_contiguous()
    np.testing.assert_allclose(out.sum(0).numpy(), 1.0, atol=1e-6)


def test_error_paths(port_model):
    with pytest.raises(ValueError, match="smaller than the model fov"):
        port_model.predict_dense_device(torch.rand(1, 4, 40, 40))
    with pytest.raises(TypeError, match="float32"):
        port_model.predict_dense_device(torch.rand(1, 9, 40, 40).double())
    with pytest.raises(ValueError, match="model's parameters are on"):
        port_model.predict_dense_device(torch.rand(1, 9, 40, 40,
                                                   device="meta"))
    for kw in (dict(impl="s2b"), dict(impl="s2bg"), dict(ztap=True),
               dict(zmajor=True), dict(poolslice=True),
               dict(pallas_tail={"variant": "mstack"})):
        with pytest.raises(NotImplementedError, match="not ported"):
            port_model.set_dilated_impl(**kw)
    with pytest.raises(ValueError, match="impl"):
        port_model.set_dilated_impl("nope")
    # bf16 Conv operands are ported for training, not for dense serving
    port_model.set_compute_dtype("bfloat16")
    try:
        with pytest.raises(NotImplementedError, match="bf16"):
            port_model.predict_dense_device(torch.rand(1, 9, 40, 40))
    finally:
        port_model.set_compute_dtype(None)
    for dt in ("float16", "int8"):
        with pytest.raises(NotImplementedError, match="item 7"):
            port_model.set_compute_dtype(dt)
    # training is ported: a training-mode evaluation without a feed names
    # the input it lacks
    with pytest.raises(KeyError, match="no value fed"):
        port_model._apply([port_model.loss_node], port_model.params, {}, {},
                          None, train=True)
    with pytest.raises(ValueError, match="channels"):
        port_model.predict_dense(np.zeros((2, 9, 40, 40), np.float32))
    with pytest.raises(ValueError, match="rank"):
        port_model.predict_dense(np.zeros((1, 1, 9, 40, 40), np.float32))


def test_unported_nodes_raise(tmp_path):
    import elektronn2_tpu.neuromancer as jnm
    from elektronn2_tpu_torch import neuromancer as tnm
    with fresh_graph("elektronn2_tpu") as gm:
        inp = jnm.Input([1, 1, 9, 9], "b,f,x,y", name="raw")
        bn = jnm.BatchNorm(jnm.Conv(inp, 3, 3, name="c"), name="bn")
        m = gm.getmodel()
        m.designate_nodes(input_node=inp, prediction_node=bn)
        fname = str(tmp_path / "bn.mdl")
        m.save(fname)
    with pytest.raises(NotImplementedError, match="BatchNorm"):
        modelload(fname, device="cpu")
    with fresh_graph("elektronn2_tpu_torch"):
        t_inp = tnm.Input([1, 1, 9, 9], "b,f,x,y", name="raw")
        with pytest.raises(NotImplementedError, match="batch_normalisation"):
            tnm.Conv(t_inp, 3, 3, batch_normalisation=True)


def test_batched_dense_forward_matches_single(port_model):
    # batch=True sends N=2 slabs through one K1 launch per conv
    from elektronn2_tpu_torch.neuromancer.inference import \
        dilated_dense_forward
    port_model.set_dilated_impl("direct", zfold=True, pallas_tail=True)
    rng = np.random.RandomState(2)
    vols = torch.from_numpy(rng.rand(2, 1, 9, 40, 36).astype(np.float32))
    before = tailconv.launches
    with torch.no_grad():
        both = dilated_dense_forward(port_model, vols, batch=True)
        one = [dilated_dense_forward(port_model, v) for v in vols]
    assert tailconv.launches == before        # CPU: the plain version
    assert tuple(both.shape) == (2,) + tuple(one[0].shape)
    for i in range(2):
        np.testing.assert_allclose(both[i].numpy(), one[i].numpy(),
                                   atol=ATOL, rtol=0)


def test_flagship_loss_matches_jax(jax_model, port_model):
    rng = np.random.RandomState(3)
    x = rng.rand(*jax_model.input_node.shape).astype(np.float32)
    t = (rng.rand(*jax_model.target_node.shape) > 0.5).astype(np.int32)
    feed = {"raw": x, "target": t}
    nodes = [jax_model.nodes["nll"], jax_model.loss_node]
    ref, _ = jax_model._apply(nodes, jax_model.params, jax_model.state,
                              feed, None, train=False)
    got, _ = port_model._apply(
        [port_model.nodes["nll"], port_model.loss_node], port_model.params,
        port_model.state, {k: torch.from_numpy(v) for k, v in feed.items()},
        None, train=False)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(np.shape(r))
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=1e-5)


@pytest.mark.parametrize("sparse", [True, False])
def test_weighted_nll_matches_jax(sparse):
    import elektronn2_tpu.neuromancer as jnm
    from elektronn2_tpu_torch import neuromancer as tnm
    rng = np.random.RandomState(4)
    x = rng.rand(3, 1, 9, 9).astype(np.float32)
    if sparse:
        t = rng.randint(0, 3, size=(3, 7, 7)).astype(np.int32)
        t_shape, t_tags, t_dtype = [3, 7, 7], "b,x,y", "int32"
    else:
        t = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (3, 7, 7))]
        t = t.transpose(0, 3, 1, 2).copy()
        t_shape, t_tags, t_dtype = [3, 3, 7, 7], "b,f,x,y", "float32"
    aux = dict(class_weights=[0.2, 0.3, 0.5],
               example_weights=[1.0, 0.5, 2.0],
               mask_class_labeled=[[1, 1, 0], [1, 0, 1], [1, 1, 1]])
    outs = []
    for pkg, nm in (("elektronn2_tpu", jnm), ("elektronn2_tpu_torch", tnm)):
        with fresh_graph(pkg) as gm:
            inp = nm.Input([3, 1, 9, 9], "b,f,x,y", name="raw")
            probs = nm.Softmax(nm.Conv(inp, 3, 3, activation_func="lin",
                                       name="c"), name="probs")
            tgt = nm.Input(t_shape, t_tags, dtype=t_dtype, name="target")
            nll = nm.MultinoulliNLL(probs, tgt, target_is_sparse=sparse,
                                    name="nll", **aux)
            loss = nm.AggregateLoss([nll, nll], mixing_weights=[0.25, 0.75],
                                    name="loss")
            m = gm.getmodel()
            m.designate_nodes(input_node=inp, target_node=tgt,
                              loss_node=loss, prediction_node=probs)
        outs.append((m, nll, loss))
    (jm, jnll, jloss), (tm, tnll, tloss) = outs
    tm.set_params(params_from_jax(jm.params, tm))
    ref, _ = jm._apply([jnll, jloss], jm.params, jm.state,
                       {"raw": x, "target": t}, None, train=False)
    got, _ = tm._apply([tnll, tloss], tm.params, tm.state,
                       {"raw": torch.from_numpy(x),
                        "target": torch.from_numpy(t)}, None, train=False)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=1e-5)


def test_dense_geometry_matches_jax(jax_model, port_model):
    from elektronn2_tpu.neuromancer.inference import \
        _dense_geometry as jax_geometry
    from elektronn2_tpu_torch.neuromancer.inference import _dense_geometry
    for name in ("conv1", "conv3", "probs"):
        assert _dense_geometry(port_model.nodes[name].shape) == \
            jax_geometry(jax_model.nodes[name].shape)


def test_dense_path_rejects_unported_nodes():
    """The port's dilated path takes no Concat (the JAX package's does):
    it raises naming the node, and predict_dense_device serves the graph
    through the tiled fallback, equal to the JAX package's dilated path."""
    import elektronn2_tpu.neuromancer as jnm
    from elektronn2_tpu_torch import neuromancer as tnm
    from elektronn2_tpu_torch.neuromancer.inference import \
        dilated_dense_forward
    models = []
    for pkg, nm in (("elektronn2_tpu", jnm), ("elektronn2_tpu_torch", tnm)):
        with fresh_graph(pkg) as gm:
            inp = nm.Input([1, 1, 9, 9], "b,f,x,y", name="raw")
            a = nm.Conv(inp, 2, 3, name="a")
            b = nm.Conv(inp, 2, 3, name="b")
            cat = nm.Concat([a, b], name="cat")
            m = gm.getmodel()
            m.designate_nodes(input_node=inp, prediction_node=cat)
        models.append(m)
    jm, m = models
    m.set_params(params_from_jax(jm.params, m))
    y = m.predict(torch.rand(1, 1, 9, 9))      # node path: Concat works
    assert tuple(y.shape) == (1, 4, 7, 7)
    with pytest.raises(NotImplementedError, match="Concat"):
        dilated_dense_forward(m, torch.rand(1, 12, 12))
    v = np.random.RandomState(6).rand(1, 12, 12).astype(np.float32)
    np.testing.assert_allclose(
        m.predict_dense_device(torch.from_numpy(v)).numpy(),
        np.asarray(jm.predict_dense_device(jnp.asarray(v))), atol=ATOL)


def test_permuted_view_volume_takes_the_k1_route(monkeypatch):
    """A strided view of the volume (pad_raw=False) reaches the graph's first
    conv as it is; under pallas_tail that conv is K1's and must get a
    contiguous input: the route equals the cuDNN route."""
    from elektronn2_tpu_torch import neuromancer as tnm
    with fresh_graph("elektronn2_tpu_torch") as gm:
        inp = tnm.Input([1, 1, 9, 11, 12], "b,f,z,x,y", name="raw")
        c = tnm.Conv(inp, 4, (3, 3, 3), activation_func="relu", name="c")
        probs = tnm.Softmax(tnm.Conv(c, 2, 1, 1, activation_func="lin",
                                     name="cls"), name="probs")
        m = gm.getmodel()
        m.designate_nodes(input_node=inp, prediction_node=probs)
    base = np.random.RandomState(5).rand(1, 11, 12, 9).astype(np.float32)
    vol = torch.from_numpy(base).permute(0, 3, 1, 2)      # (1, 9, 11, 12)
    assert not vol.is_contiguous()
    calls = []
    orig = tailconv.conv3x3_dilated

    def spy(x, w, b, dil=(1, 1, 1), relu=True):
        calls.append(tuple(x.shape))
        return orig(x, w, b, dil, relu)

    monkeypatch.setattr(tailconv, "conv3x3_dilated", spy)
    m.set_dilated_impl("direct", zfold=True, pallas_tail=True)
    a = m.predict_dense_device(vol, pad_raw=False)
    assert calls == [(1, 1, 9, 11, 12)]
    m.set_dilated_impl("direct", zfold=True, pallas_tail=False)
    b = m.predict_dense_device(vol, pad_raw=False)
    assert len(calls) == 1 and tuple(a.shape) == (2, 7, 9, 10)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)
