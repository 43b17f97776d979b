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


# ------------------------------------------------------ sharded serving

#: the sharded-serving names (ROADMAP.md item 8b/8c): (JAX module, port
#: module, name, the port's names for the JAX parameters it renames)
SHARDED = [
    ("elektronn2_tpu.ops.conv", "elektronn2_tpu_torch.ops.conv",
     "apply_layer", {}),
    ("elektronn2_tpu.neuromancer.inference",
     "elektronn2_tpu_torch.neuromancer.inference", "predict_dense_sharded",
     {}),
    ("elektronn2_tpu.neuromancer.inference",
     "elektronn2_tpu_torch.neuromancer.inference",
     "predict_dense_sharded_batch", {}),
    ("elektronn2_tpu.parallel", "elektronn2_tpu_torch.parallel",
     "halo_gather", {"axis_name": "group"}),
    ("elektronn2_tpu.parallel", "elektronn2_tpu_torch.parallel",
     "cp_conv_z", {"axis_name": "group"}),
    ("elektronn2_tpu.parallel", "elektronn2_tpu_torch.parallel",
     "spatial_cp_stack", {}),
]


@pytest.mark.parametrize("jmod, tmod, name, renamed", SHARDED,
                         ids=[c[2] for c in SHARDED])
def test_sharded_serving_names_match_jax(jmod, tmod, name, renamed):
    # each name is exported where the JAX package exports it, with its
    # parameters (a mesh axis's process group where JAX names the axis)
    import inspect
    j = getattr(importlib.import_module(jmod), name)
    t = getattr(importlib.import_module(tmod), name)
    want = [renamed.get(p, p) for p in inspect.signature(j).parameters]
    assert list(inspect.signature(t).parameters) == want


@pytest.mark.parametrize("name", ["predict_dense_sharded",
                                  "predict_dense_sharded_batch",
                                  "sweep_knossos"])
def test_sharded_model_methods_take_the_jax_arguments(name):
    import inspect
    from elektronn2_tpu.neuromancer.model import Model as JM
    from elektronn2_tpu_torch.neuromancer.model import Model as TM
    want = list(inspect.signature(getattr(JM, name)).parameters)
    got = list(inspect.signature(getattr(TM, name)).parameters)
    assert got[:len(want)] == want, (got, want)


@pytest.mark.parametrize("pool, act", [(None, "relu"), ((1, 2, 2), "tanh"),
                                       ((2, 2, 2), None)])
def test_apply_layer_matches_jax(pool, act):
    from elektronn2_tpu.ops.conv import apply_layer as japply
    from elektronn2_tpu_torch.ops.conv import apply_layer
    r = np.random.RandomState(4)
    x = r.randn(1, 2, 8, 10, 10).astype(np.float32)
    w = r.randn(3, 2, 3, 3, 3).astype(np.float32) * 0.2
    b = r.randn(3).astype(np.float32)
    want = np.asarray(japply(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             act, pool))
    got = apply_layer(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), act, pool).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


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


# ------------------------------------------------ scale-out training

#: the scale-out training names (ROADMAP.md item 8d-8f): (JAX module, port
#: module, name)
SCALEOUT = [
    ("elektronn2_tpu.parallel.spatial_train",
     "elektronn2_tpu_torch.parallel.spatial_train", name)
    for name in ("make_spatial_dp_trainstep", "make_fused_spatial_trainstep",
                 "pad_target_for_spatial", "spatial_tp_shardings",
                 "conv_supports_halo")] + [
    ("elektronn2_tpu.parallel.pipeline",
     "elektronn2_tpu_torch.parallel.pipeline", name)
    for name in ("microbatch", "extract_params", "_stage_apply",
                 "gpipe_stack", "gpipe_reference_loss", "layers_from_model",
                 "_model_loss_fn", "make_gpipe_trainstep")]


def test_parallel_all_holds_the_jax_packages():
    import elektronn2_tpu.parallel as jp
    import elektronn2_tpu_torch.parallel as tp
    assert set(jp.__all__) <= set(tp.__all__), \
        sorted(set(jp.__all__) - set(tp.__all__))
    for name in tp.__all__:
        assert hasattr(tp, name), name


@pytest.mark.parametrize("jmod, tmod, name", SCALEOUT,
                         ids=[c[2] for c in SCALEOUT])
def test_scaleout_names_match_jax(jmod, tmod, name):
    # each function of spatial_train.py and pipeline.py under its JAX name
    # and module, with the JAX parameters
    import inspect
    j = getattr(importlib.import_module(jmod), name)
    t = getattr(importlib.import_module(tmod), name)
    assert list(inspect.signature(t).parameters) == \
        list(inspect.signature(j).parameters)


def test_use_mesh_takes_the_jax_arguments():
    import inspect
    from elektronn2_tpu.neuromancer.model import Model as JM
    from elektronn2_tpu_torch.neuromancer.model import Model as TM
    assert list(inspect.signature(TM.use_mesh).parameters) == \
        list(inspect.signature(JM.use_mesh).parameters)


LOWERINGS = [  # (JAX module, port module, name, JAX-only parameters)
    ("elektronn2_tpu.neuromancer.computations",
     "elektronn2_tpu_torch.neuromancer.computations", "conv_s2b",
     ("precision", "preferred_element_type")),
    ("elektronn2_tpu.ops.conv", "elektronn2_tpu_torch.ops.conv", "conv_s2b",
     ("precision", "preferred_element_type")),
    ("elektronn2_tpu.ops.conv", "elektronn2_tpu_torch.ops.conv", "conv_ztap",
     ("precision",)),
    ("elektronn2_tpu.ops.conv", "elektronn2_tpu_torch.ops.conv", "pool_s2b",
     ()),
    ("elektronn2_tpu.ops.conv", "elektronn2_tpu_torch.ops.conv",
     "_s2b_split", ()),
    ("elektronn2_tpu.ops.conv", "elektronn2_tpu_torch.ops.conv",
     "_s2b_split_zmajor", ()),
    ("elektronn2_tpu.ops.conv", "elektronn2_tpu_torch.ops.conv",
     "_s2b_merge", ()),
]


@pytest.mark.parametrize("jmod, tmod, name, jax_only", LOWERINGS,
                         ids=[f"{c[1].split('.')[-1]}.{c[2]}"
                              for c in LOWERINGS])
def test_lowering_names_match_jax(jmod, tmod, name, jax_only):
    # the dilated path's lowering ops are exported where the JAX package
    # exports them, with its parameters (XLA's precision knobs aside: the
    # port's convs are float32 under f32_convs)
    import inspect
    j = getattr(importlib.import_module(jmod), name)
    t = getattr(importlib.import_module(tmod), name)
    want = [p for p in inspect.signature(j).parameters if p not in jax_only]
    got = list(inspect.signature(t).parameters)
    assert got[:len(want)] == want, (got, want)


@pytest.mark.parametrize("name", ["set_dilated_impl", "set_convdense_impl"])
def test_lowering_setters_take_the_jax_arguments(name):
    import inspect
    from elektronn2_tpu.neuromancer.model import Model as JM
    from elektronn2_tpu_torch.neuromancer.model import Model as TM
    j = inspect.signature(getattr(JM, name)).parameters
    t = inspect.signature(getattr(TM, name)).parameters
    assert [(k, v.default) for k, v in t.items()] == \
        [(k, v.default) for k, v in j.items()]


def test_tail_conv_takes_compute_dtype():
    import inspect
    from elektronn2_tpu.ops.pallas_tailconv import conv3x3_dilated as jk1
    from elektronn2_tpu_torch.ops.tailconv import conv3x3_dilated
    want = inspect.signature(jk1).parameters["compute_dtype"].default
    got = inspect.signature(conv3x3_dilated).parameters
    assert list(got)[:5] == ["x", "w", "b", "dil", "relu"]
    assert got["compute_dtype"].default == want == "float32"



# ------------------------------------ every public function and method

#: the JAX package's Pallas modules and the port's modules that hold their
#: counterparts: a hand-written kernel's wrapper, plain version and plan
#: take the card's arguments, not the TPU kernel's tiling, layout and
#: interpret knobs (``xzcy``, ``variant``, ``z_block``, ``interpret``, ...),
#: so their names and parameters differ by design; each counterpart module
#: exists
PALLAS_COUNTERPARTS = {
    "elektronn2_tpu.ops.pallas_tailconv": "elektronn2_tpu_torch.ops.tailconv",
    "elektronn2_tpu.ops.pallas_extract": "elektronn2_tpu_torch.ops.extract",
    "elektronn2_tpu.ops.pallas_extract_rot":
        "elektronn2_tpu_torch.ops.extract_rot",
    "elektronn2_tpu.ops.experimental.pallas_dilated_conv":
        "elektronn2_tpu_torch.ops.experimental.dilated_conv",
}
#: the JAX package's compiled C++ cores: shared libraries loaded with
#: ctypes, not Python modules; the port builds its own from the same
#: sources on first use (``data/*.cpp``, ``malis/malis_core.cpp``)
COMPILED_CORES = {"elektronn2_tpu.data._knossos_core",
                  "elektronn2_tpu.data._warp_core",
                  "elektronn2_tpu.malis._malis_core"}
#: JAX parameter names the port renames everywhere, with the reason:
#: ``jax.random`` keys become a ``torch.Generator`` (the two draw different
#: streams from one seed)
RENAMED = {"key": "gen", "rng": "gen"}
#: JAX parameters the port drops everywhere: XLA's precision knobs; the
#: port's convs and matmuls run in float32 under ``f32_convs`` /
#: ``f32_matmuls`` and take their reduced precision from the model's
#: compute dtype
DROPPED = {"precision", "preferred_element_type"}
#: (JAX module, qualified name) -> (JAX parameters the port renames or
#: drops there, as {name: port name or None}, the reason); a qualified name
#: mapped to None is a method the port leaves out
BY_DESIGN = {
    ("elektronn2_tpu.neuromancer.inference", "dilated_dense_forward"): (
        {"params": None, "state": None, "impl": None},
        "the traced forwards read the model's own parameters and state (no "
        "functional jit); impl was removed in favour of set_dilated_impl"),
    ("elektronn2_tpu.neuromancer.inference", "convolutional_dense_forward"): (
        {"params": None, "state": None},
        "the traced forwards read the model's own parameters and state"),
    ("elektronn2_tpu.parallel.halo", "halo_gather"): (
        {"axis_name": "group"},
        "a mesh axis is a torch.distributed process group"),
    ("elektronn2_tpu.parallel.halo", "cp_conv_z"): (
        {"axis_name": "group"},
        "a mesh axis is a torch.distributed process group"),
    ("elektronn2_tpu.neuromancer.node_basic", "TraceCtx.__init__"): (
        {"node_index": None},
        "random streams: a trace draws from the step's one generator in "
        "evaluation order; JAX folds each node's index into its key"),
    ("elektronn2_tpu.neuromancer.node_basic", "TraceCtx.rng_for"): (
        None, "random streams: JAX's per-node key (fold_in of the node "
              "index); the port's nodes draw through TraceCtx.draw"),
}


def _port_of(jname):
    return "elektronn2_tpu_torch" + jname[len("elektronn2_tpu"):]


def _jax_modules():
    import pkgutil
    import elektronn2_tpu
    return sorted(m.name for m in pkgutil.walk_packages(
        elektronn2_tpu.__path__, "elektronn2_tpu."))


def _params(fn):
    import inspect
    try:
        return list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return None


def _surface_gaps(jname, jfn, pfn, qual):
    """The JAX parameters of ``jfn`` that ``pfn`` lacks, after the renames
    and drops by design."""
    if pfn is None:
        return [f"{qual} missing"]
    jp, pp = _params(jfn), _params(pfn)
    if jp is None or pp is None:
        return []
    local = BY_DESIGN.get((jname, qual), ({}, ""))[0] or {}
    gaps = []
    for p in jp:
        if p in DROPPED or (p in local and local[p] is None):
            continue
        want = local.get(p) or RENAMED.get(p, p)
        if want not in pp and p not in pp:
            gaps.append(f"{qual}({p})")
    return gaps


@pytest.mark.parametrize("jname", _jax_modules())
def test_port_surface_has_every_jax_function_and_method(jname):
    """Every public function and class method (``__init__`` too) that a JAX
    module defines exists in the port's module of the same path, with every
    JAX parameter name, the differences by design aside (``RENAMED``,
    ``DROPPED``, ``BY_DESIGN``, the Pallas modules' counterparts, the
    compiled cores), each listed above with its reason."""
    import inspect
    if jname in COMPILED_CORES:
        return
    if jname in PALLAS_COUNTERPARTS:
        importlib.import_module(PALLAS_COUNTERPARTS[jname])
        return
    jm = importlib.import_module(jname)
    pm = importlib.import_module(_port_of(jname))
    gaps = []
    for name, obj in vars(jm).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != jname:
            continue
        if inspect.isfunction(obj):
            gaps += _surface_gaps(jname, obj, getattr(pm, name, None), name)
        elif inspect.isclass(obj):
            pc = getattr(pm, name, None)
            if pc is None:
                gaps.append(f"class {name} missing")
                continue
            for mname, mobj in vars(obj).items():
                if mname.startswith("_") and mname != "__init__":
                    continue
                qual = f"{name}.{mname}"
                if (jname, qual) in BY_DESIGN and \
                        BY_DESIGN[(jname, qual)][0] is None:
                    assert not hasattr(pc, mname), f"{qual} is ported now"
                    continue
                if isinstance(mobj, property):
                    if not hasattr(pc, mname):
                        gaps.append(f"{qual} missing")
                    continue
                if isinstance(mobj, (staticmethod, classmethod)):
                    mobj = mobj.__func__
                if not callable(mobj):
                    continue
                pobj = inspect.getattr_static(pc, mname, None)
                if isinstance(pobj, (staticmethod, classmethod)):
                    pobj = pobj.__func__
                gaps += _surface_gaps(jname, mobj, pobj, qual)
    assert not gaps, f"{_port_of(jname)} lacks {gaps}"


def test_by_design_differences_still_differ():
    """Each difference listed by design is still one: a listed parameter
    is still absent from the port's function (a port that gains it should
    drop it from the list)."""
    for (jname, qual), (local, _) in BY_DESIGN.items():
        obj = importlib.import_module(_port_of(jname))
        for part in qual.split("."):
            obj = getattr(obj, part, None)
        if local is None:
            assert obj is None, qual
            continue
        got = _params(obj)
        for p in local:
            assert p not in got, (qual, p)


# ------------------------------------------------ the surface repairs

def _branching_graph(nm):
    nm.model_manager.reset(seed=0)
    a = nm.Input([2, 1, 10, 10], "b,f,x,y", name="a")
    c = nm.Conv(a, 4, 3, 1, name="c1")
    nm.Softmax(nm.Conv(c, 2, 1, 1, activation_func="lin", name="head"),
               name="probs")
    nm.Conv(c, 3, 1, 1, name="aux")
    return nm.model_manager


def test_graphmanager_sinks_match_jax():
    # the nodes nobody consumes, in registration order, a property in both
    want = [n.name for n in _branching_graph(jnm).sinks]
    got = [n.name for n in _branching_graph(tnm).sinks]
    assert got == want == ["probs", "aux"]
    assert all(isinstance(n, tnm.Node) for n in _branching_graph(tnm).sinks)


def test_graphmanager_replay_takes_batch_size_override():
    # accepted and ignored, as in the JAX package: the replayed graph is
    # the one the descriptors describe
    from elektronn2_tpu.neuromancer.graphmanager import GraphManager as JGM
    from elektronn2_tpu_torch.neuromancer.graphmanager import \
        GraphManager as TGM
    desc, arrays = _branching_graph(jnm).get_descriptors()
    j = JGM.replay(desc, arrays, batch_size_override=7)
    t = TGM.replay(desc, arrays, batch_size_override=7)
    assert [(n, tuple(v.shape)) for n, v in t.nodes.items()] == \
        [(n, tuple(v.shape)) for n, v in j.nodes.items()]
    assert [n.name for n in t.sinks] == [n.name for n in j.sinks]
    with pytest.raises(NotImplementedError, match="unknown node class"):
        TGM.replay([dict(desc[0], cls="NoSuchNode")], arrays)


def test_enable_compile_cache_takes_min_compile_secs(tmp_path):
    import inspect
    from elektronn2_tpu.utils import profiling as jp
    from elektronn2_tpu_torch.utils import cuda_build, native_build
    from elektronn2_tpu_torch.utils import profiling as tp
    want = inspect.signature(jp.enable_compile_cache).parameters
    got = inspect.signature(tp.enable_compile_cache).parameters
    assert [(k, v.default) for k, v in got.items()] == \
        [(k, v.default) for k, v in want.items()]
    saved = cuda_build.BUILD_DIR, native_build.BUILD_DIR
    try:
        d = str(tmp_path / "kernels")
        assert tp.enable_compile_cache(d, min_compile_secs=0.5) == d
        assert cuda_build.BUILD_DIR == native_build.BUILD_DIR == d
    finally:
        cuda_build.BUILD_DIR, native_build.BUILD_DIR = saved


def test_time_fn_matches_jax():
    # the same warm-up and mean: n_warmup + n_runs calls, the mean seconds
    # of the timed ones
    from elektronn2_tpu.scripts.profile import time_fn as jtime
    from elektronn2_tpu_torch.scripts.profile import time_fn as ttime
    counts = {}

    def fn_of(pkg, make):
        def fn():
            counts[pkg] = counts.get(pkg, 0) + 1
            return make()
        return fn
    for kw, calls in (({}, 7), (dict(n_warmup=1, n_runs=3), 4)):
        counts.clear()
        js = jtime(fn_of("jax", lambda: jnp.ones(4) * 2), **kw)
        ts = ttime(fn_of("torch", lambda: (torch.ones(4) * 2,
                                           {"x": torch.zeros(1)})), **kw)
        assert counts == {"jax": calls, "torch": calls}
        assert js > 0 and ts > 0


def _augmenters():
    import jax
    import elektronn2_tpu.ops.warp as jw
    import elektronn2_tpu_torch.ops.warp as tw
    rng = np.random.RandomState(8)
    raws = [rng.rand(1, 20, 30, 30).astype(np.float32) for _ in range(2)]
    labs = [(r[0] > 0.5).astype(np.int16) for r in raws]
    kw = dict(patch_size=(6, 10, 10), target_size=(4, 6, 6))
    return (jw.DeviceBatchAugmenter(raws, labs, **kw), jax.random.PRNGKey(3),
            tw.DeviceBatchAugmenter(raws, labs, device="cpu", **kw))


def test_device_batch_takes_given_stacks():
    """``device_batch(raws=, labels=)``: the given stacks replace the
    augmenter's for the call, in both packages: constant stacks give
    constant batches of the same shapes, and doubled raws (with the same
    draws) give doubled data and the same targets."""
    jaug, key, taug = _augmenters()
    jd, jt = jaug.device_batch(key, 3, warp=0.5, grey=False,
                               raws=jnp.full_like(jaug.raws, 7.0),
                               labels=jnp.ones_like(jaug.labels))
    gen = torch.Generator().manual_seed(3)
    td, tt = taug.device_batch(gen, 3, warp=0.5, grey=False,
                               raws=torch.full_like(taug.raws, 7.0),
                               labels=torch.ones_like(taug.labels))
    assert td.shape == jd.shape and tt.shape == jt.shape
    np.testing.assert_allclose(td.numpy(), 7.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jd), 7.0, rtol=1e-6)
    assert (tt.numpy() == 1).all() and (np.asarray(jt) == 1).all()
    # the given stacks are the ones sampled: doubled raws, doubled data
    d0, t0 = taug.device_batch(torch.Generator().manual_seed(5), 3,
                               warp=0.5, grey=False)
    d1, t1 = taug.device_batch(torch.Generator().manual_seed(5), 3,
                               warp=0.5, grey=False, raws=taug.raws * 2)
    assert torch.equal(d1, 2 * d0) and torch.equal(t1, t0)
    j0, jt0 = jaug.device_batch(key, 3, warp=0.5, grey=False)
    j1, jt1 = jaug.device_batch(key, 3, warp=0.5, grey=False,
                                raws=jaug.raws * 2)
    np.testing.assert_array_equal(np.asarray(j1), 2 * np.asarray(j0))
    np.testing.assert_array_equal(np.asarray(jt1), np.asarray(jt0))
    # stacks elsewhere than the augmenter's device are refused (nothing is
    # copied inside a call a graph may capture)
    with pytest.raises(ValueError, match="device"):
        taug.device_batch(gen, 3, raws=torch.empty(taug.raws.shape,
                                                   device="meta"))


def test_trace_ctx_takes_compute_dtype_by_name():
    # JAX's TraceCtx(compute_dtype=...) by name, int8 a serving-only mode
    # the node trace leaves float32
    from elektronn2_tpu.neuromancer.node_basic import TraceCtx as JCtx
    from elektronn2_tpu_torch.neuromancer.node_basic import TraceCtx as TCtx
    for name, want in (("bfloat16", torch.bfloat16),
                       ("float16", torch.float16), ("int8", None),
                       (None, None)):
        j = JCtx({}, {}, compute_dtype=name).compute_dtype
        assert (j is None) == (want is None)
        assert TCtx({}, {}, compute_dtype=name).compute_dtype is want
    assert TCtx({}, {}, compute_dtype=torch.bfloat16).compute_dtype is \
        torch.bfloat16
