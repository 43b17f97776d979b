"""The reference import surface of the port (ROADMAP.md item 9) and the
config loader's reading of reference-style configs, against the JAX
package.

- Every path and name of ``tests/test_compat_shim.py::SURFACE`` resolves
  in the port, with ``elektronn2`` read as ``elektronn2_tpu_torch``.
- The helpers the port copied (``unique_rows``, ``AccumulationArray``,
  ``CircularBuffer``, ``DynamicKDT``, ``pretty_string_ops``,
  ``makeversiondir``, ``import_variable_from_file``, the pickle I/O) give
  the JAX package's results on the same input, exactly.
- ``VariableWeight`` / ``ConstantParam`` flags reach the optimiser: three
  SGD steps of a net built with them equal the JAX package's (rtol 1e-5,
  atol 1e-6 on the weights, as ``test_torch_train.py`` states), and a
  ``ConstantParam`` does not move.
- ``Input_like``, ``Node.input_nodes``, ``Node.predict_dense``,
  ``make_func`` and the package-level exports.
- ``config._port_import``: ``elektronn2.*`` is the port; a config's
  ``import jax`` gets the stand-in, whose other names raise ImportError.
"""

import importlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)
import elektronn2_tpu.neuromancer as jnm  # noqa: E402
import elektronn2_tpu.utils.basic as jb  # noqa: E402
import elektronn2_tpu_torch.neuromancer as tnm  # noqa: E402
import elektronn2_tpu_torch.utils.basic as tb  # noqa: E402
from elektronn2_tpu_torch.utils.convert import params_from_jax  # noqa: E402
from test_compat_shim import SURFACE  # noqa: E402

torch.set_num_threads(1)


def port_path(mod):
    return "elektronn2_tpu_torch" + mod[len("elektronn2"):]


@pytest.mark.parametrize("mod", sorted(SURFACE))
def test_port_public_surface_complete(mod):
    m = importlib.import_module(port_path(mod))
    missing = [s for s in SURFACE[mod] if not hasattr(m, s)]
    assert not missing, f"{port_path(mod)} lacks {missing}"


def test_utils_reexports_are_the_same_objects():
    import elektronn2_tpu_torch.utils as tu
    import elektronn2_tpu_torch.utils.utils_basic as ub
    for name in ("h5save", "h5load", "picklesave", "pickleload", "timeit",
                 "cache", "AccumulationArray", "DynamicKDT"):
        assert getattr(tu, name) is getattr(tb, name)
    for name in ub.__all__:
        if name != "pretty_string_time":
            assert getattr(ub, name) is getattr(tb, name), name


# ------------------------------------------------------- helpers vs JAX

def test_unique_rows_matches_jax():
    a = np.random.RandomState(0).randint(0, 3, (40, 3))
    np.testing.assert_array_equal(tb.unique_rows(a), jb.unique_rows(a))
    with pytest.raises(ValueError):
        tb.unique_rows(np.zeros(3))


def test_accumulation_array_matches_jax():
    rows = np.random.RandomState(1).rand(300, 2).astype(np.float32)
    arrs = [mod.AccumulationArray(right_shape=(2,), n_init=3)
            for mod in (jb, tb)]
    for a in arrs:
        for r in rows[:150]:
            a.append(r)
        a.extend(rows[150:])
    np.testing.assert_array_equal(arrs[1].data, arrs[0].data)
    assert len(arrs[1]) == len(arrs[0]) == 300
    np.testing.assert_array_equal(np.asarray(arrs[1]), np.asarray(arrs[0]))


def test_circular_buffer_matches_jax():
    bufs = [mod.CircularBuffer(5) for mod in (jb, tb)]
    for i in range(13):
        for b in bufs:
            b.append(float(i) * 1.5)
        np.testing.assert_array_equal(bufs[1].data, bufs[0].data)
        assert bufs[1].mean() == bufs[0].mean() and len(bufs[1]) == \
            len(bufs[0])


def test_dynamic_kdt_queries_match_jax():
    rng = np.random.RandomState(2)
    pts = rng.rand(50, 3) * 10
    trees = [mod.DynamicKDT(pts[:20], rebuild_thresh=7) for mod in (jb, tb)]
    for p in pts[20:]:
        for t in trees:
            t.append(p)
        q = rng.rand(3) * 10
        for k in (1, 4):
            (dj, pj, ij), (dt, pt, it) = (t.get_knn(q, k=k) for t in trees)
            np.testing.assert_array_equal(it, ij)
            np.testing.assert_array_equal(dt, dj)
            np.testing.assert_array_equal(pt, pj)
    qs = rng.rand(6, 3) * 10
    (dj, _, ij), (dt, _, it) = (t.get_knn(qs, k=3) for t in trees)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)


def test_small_helpers_match_jax(tmp_path):
    for n in (0, 7, 123, 4567, 1234567890, 3.2e16):
        assert tb.pretty_string_ops(n) == jb.pretty_string_ops(n)
    assert tb.makeversiondir(str(tmp_path), "r").endswith("r")
    assert tb.makeversiondir(str(tmp_path), "r").endswith("r-v2")
    f = tmp_path / "mod.py"
    f.write_text("x = 41\ndef create_model():\n    return x + 1\n")
    assert tb.import_variable_from_file(str(f), "create_model")() == 42
    with pytest.raises(AttributeError):
        tb.import_variable_from_file(str(f), "nope")
    tb.picklesave({"a": [1, 2]}, str(tmp_path / "p.pkl"))
    assert jb.pickleload(str(tmp_path / "p.pkl")) == {"a": [1, 2]}
    assert 1 <= tb.get_free_cpu_count() <= (os.cpu_count() or 1)
    calls = []

    @tb.cache
    def sq(v):
        calls.append(v)
        return v * v

    assert (sq(3), sq(3), calls) == (9, 9, [3])
    assert tb.timeit(lambda v: v + 1)(1) == 2


# ---------------------------------------------- parameter containers

def flagged_net(nm):
    """A conv whose weight is a VariableWeight (lr_mult 0.5, wd_mult 0)
    and whose bias is a ConstantParam, then a 1x1 head."""
    from importlib import import_module
    var = import_module(nm.__name__ + ".variables")
    nm.model_manager.reset(seed=5)
    inp = nm.Input([2, 1, 10, 10], "b,f,x,y", name="raw")
    w = var.VariableWeight(shape=(3, 1, 3, 3),
                           init_kwargs={"rng": np.random.RandomState(4)},
                           lr_mult=0.5, wd_mult=0.0)
    b = var.ConstantParam(np.full(3, 0.2, np.float32))
    c1 = nm.Conv(inp, 3, 3, 1, w=w, b=b, name="c1")
    probs = nm.Softmax(nm.Conv(c1, 2, 1, 1, activation_func="lin",
                               name="head"))
    tgt = nm.Input([2, 8, 8], "b,x,y", dtype="int32", name="target")
    loss = nm.AggregateLoss(nm.MultinoulliNLL(probs, tgt,
                                              target_is_sparse=True))
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=probs)
    return m


def test_variable_weight_flags_reach_the_optimiser():
    jm, tm = flagged_net(jnm), flagged_net(tnm)
    np.testing.assert_array_equal(tm.params["c1"]["w"].numpy(),
                                  np.asarray(jm.params["c1"]["w"]))
    tm.set_params(params_from_jax(jm.params, tm))
    node = tm.nodes["c1"]
    assert node.param_flags["w"] == {"trainable": True, "lr_mult": 0.5,
                                     "wd_mult": 0.0}
    assert node.param_flags["b"]["trainable"] is False
    rng = np.random.RandomState(0)
    x = rng.randn(2, 1, 10, 10).astype(np.float32)
    y = rng.randint(0, 2, (2, 8, 8)).astype(np.int32)
    jm.set_opt("SGD", lr=0.1, wd=1e-2)
    tm.set_opt("SGD", lr=0.1, wd=1e-2)
    for _ in range(3):
        jl = float(jm.trainingstep(x, y)[0])
        tl = float(tm.trainingstep(torch.from_numpy(x),
                                   torch.from_numpy(y))[0])
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for n in jm.params:
        for p in jm.params[n]:
            np.testing.assert_allclose(tm.params[n][p].numpy(),
                                       np.asarray(jm.params[n][p]),
                                       rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tm.params["c1"]["b"].numpy(),
                                  np.full(3, 0.2, np.float32))


# ----------------------------------------------- nodes and functions

def test_input_like_and_input_nodes():
    for nm in (jnm, tnm):
        nm.model_manager.reset(seed=0)
        a = nm.Input([2, 3, 6, 6], "b,f,x,y", name="a")
        b = nm.Input_like(a, name="b", override_f=5)
        c = nm.Concat([nm.Conv(a, 5, 1, 1), b])
        assert tuple(b.shape) == (2, 5, 6, 6) and b.shape.tags == \
            a.shape.tags
        assert [n.name for n in c.input_nodes] == ["a", "b"]


def test_node_predict_dense_and_make_func():
    from elektronn2_tpu_torch.neuromancer.graphutils import make_func
    tnm.model_manager.reset(seed=2)
    inp = tnm.Input([1, 1, 12, 12], "b,f,x,y", name="raw")
    c1 = tnm.Conv(inp, 3, 3, 1, name="c1")
    probs = tnm.Softmax(tnm.Conv(c1, 2, 1, 1, activation_func="lin"))
    m = tnm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, prediction_node=probs)
    vol = np.random.RandomState(0).rand(1, 20, 20).astype(np.float32)
    np.testing.assert_array_equal(probs.predict_dense(vol),
                                  m.predict_dense(vol))
    # another node serves as the map for the call, and the model's own
    # prediction node is back after it
    feat = c1.predict_dense(vol)
    assert feat.shape[0] == 3 and m.prediction_node is probs
    f = make_func(inp, probs, device="cpu", profile_execution=True)
    x = torch.rand(1, 1, 12, 12)
    torch.testing.assert_close(f(x), m.predict(x), rtol=0, atol=0)
    assert len(f.exec_times) == 1
    tnm.model_manager.reset(seed=2)
    lone = tnm.Input([1, 1, 4, 4], "b,f,x,y", name="lone")
    with pytest.raises(RuntimeError, match="no Model containing"):
        tnm.Conv(lone, 2, 1, 1).predict_dense(vol)


def test_package_level_exports():
    from elektronn2_tpu_torch import ops
    from elektronn2_tpu_torch.neuromancer import model
    conv = sys.modules["elektronn2_tpu_torch.ops.conv"]   # ops.conv: the op
    assert tnm.rebuild_model is model.rebuild_model
    for name in ("dot", "upconv", "unpooling", "upsampling"):
        assert getattr(ops, name) is getattr(conv, name)


# ------------------------------------------------------ config loader

def test_port_import_maps_reference_names():
    from elektronn2_tpu_torch import config
    nm = config._port_import("elektronn2.neuromancer", fromlist=("Conv",))
    assert nm is tnm
    top = config._port_import("elektronn2")
    assert top.__name__ == "elektronn2_tpu_torch"
    jax = config._port_import("jax")
    assert jax is config.JAX_STAND_IN and jax.device_count() == 1
    assert len(jax.devices()) == 1
    with pytest.raises(ImportError, match="stand-in"):
        jax.numpy
    with pytest.raises(ImportError, match="stand-in"):
        config._port_import("jax.numpy")
    # sys.modules keeps the real packages
    assert sys.modules["jax"] is not jax
    assert jnp.zeros(1).shape == (1,)
