"""Pipeline parallelism of the port (``parallel/pipeline.py``: the explicit
GPipe schedule, ``layers_from_model``, ``make_gpipe_trainstep``) on four
spawned CPU ranks, against the unpipelined stack and the model's
unsharded step, in the port and in the JAX package.

Mirrors ``tests/test_parallel.py`` :368 (2 and 4 stages), :411, :442,
:453, :491, :515, :582, :617, :701 and :951. One spawn of four ``gloo``
ranks (``torch_scaleout_workers.pipe_cases``, jax-free) runs every
pipelined case, on ``{pipe: 4}``, ``{rep: 2, pipe: 2}`` (two two-stage
pipelines side by side) and ``{data: 2, pipe: 2}`` (DP x PP); every rank
returns the loss and every parameter's gradient, so the ranks must agree
bit for bit.

Tolerances: the loss and gradients against the port's unpipelined stack
(the same ops on the same microbatches, summed in another order) rtol
1e-6 / atol 1e-7; against the JAX package's the JAX tests' rtol 1e-5 on the
loss and rtol 1e-4 / atol 1e-6 on gradients and parameters (2e-5 on a
model step's loss, as :582 states it); a model step against the port's
``trainingstep`` rtol 1e-6 on the loss, atol 1e-6 on the parameters.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
import elektronn2_tpu.neuromancer as jnm  # noqa: E402
import elektronn2_tpu_torch.neuromancer as tnm  # noqa: E402
import torch_dp_workers as W  # noqa: E402
import torch_scaleout_workers as S  # noqa: E402
from elektronn2_tpu.parallel import pipeline as jpipe  # noqa: E402
from elektronn2_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from elektronn2_tpu_torch.utils.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)
RTOL, ATOL = 1e-6, 1e-7
JAX_LOSS_RTOL, JAX_STEP_RTOL, JAX_RTOL, JAX_ATOL = 1e-5, 2e-5, 1e-4, 1e-6
STEP_LOSS_RTOL, STEP_W_ATOL = 1e-6, 1e-6
_cache = {}


def once(key, fn):
    if key not in _cache:
        _cache[key] = fn()
    return _cache[key]


@pytest.fixture(scope="module")
def spawn_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("pipe")


def pp_layers(rng):
    """``tests/test_parallel.py::_pp_layers``."""
    return [
        {"w": rng.randn(4, 1, 3, 3, 3).astype(np.float32) * 0.1,
         "b": np.zeros(4, np.float32), "activation": "relu"},
        {"w": rng.randn(6, 4, 1, 3, 3).astype(np.float32) * 0.1,
         "b": np.zeros(6, np.float32), "activation": "relu",
         "pool": (1, 2, 2)},
        {"w": rng.randn(6, 6, 3, 3, 3).astype(np.float32) * 0.1,
         "b": np.zeros(6, np.float32), "activation": "relu"},
        {"w": rng.randn(2, 6, 1, 1, 1).astype(np.float32) * 0.1,
         "b": np.zeros(2, np.float32), "activation": None},
    ]


def sq(pred, tgt):
    return torch.mean((pred - tgt) ** 2)


def port_reference(layers, xm, ym):
    """The port's unpipelined loss and its gradients (autograd)."""
    meta, params = tpipe.extract_params(layers)
    leaves = [{k: v.clone().requires_grad_() for k, v in p.items()}
              for p in params]
    loss = torch.mean(torch.stack([
        sq(tpipe._stage_apply(meta, leaves, range(len(layers)),
                              torch.from_numpy(xm[m])),
           torch.from_numpy(ym[m])) for m in range(xm.shape[0])]))
    gs = torch.autograd.grad(loss, [p[k] for p in leaves for k in sorted(p)])
    out, i = [], 0
    for p in leaves:
        d = {}
        for k in sorted(p):
            d[k] = gs[i].numpy()
            i += 1
        out.append(d)
    loss = loss.detach()
    np.testing.assert_allclose(
        float(loss), float(tpipe.gpipe_reference_loss(
            layers, sq, torch.from_numpy(xm), torch.from_numpy(ym))),
        rtol=1e-7)
    return float(loss), out


def jax_reference(layers, xm, ym):
    """The JAX package's unpipelined loss and gradients
    (``test_parallel.py:368``'s ``ref_loss``)."""
    meta, params = jpipe.extract_params(layers)

    def ref_loss(p):
        ls = [jnp.mean((jpipe._stage_apply(meta, p, range(len(layers)),
                                           jnp.asarray(xm[m]))
                        - jnp.asarray(ym[m])) ** 2)
              for m in range(xm.shape[0])]
        return jnp.mean(jnp.stack(ls))

    loss, g = jax.value_and_grad(ref_loss)(params)
    return float(loss), [{k: np.asarray(v) for k, v in gi.items()}
                         for gi in g]


def model_pair(**kw):
    """(JAX net, port net with its weights, the weights) of
    ``flagship_like``."""
    jnm.model_manager.reset(seed=11)
    jm = S.flagship_like(jnm, **kw)
    tnm.model_manager.reset(seed=11)
    tm = S.flagship_like(tnm, **kw)
    tm.set_params(params_from_jax(jm.params, tm))
    return jm, tm, W.params_np(tm)


def model_batches(m, B, n, n_cls, r):
    sp = m.prediction_node.shape.spatial_shape
    return [(r.rand(B, 1, 9, 16, 16).astype(np.float32),
             r.randint(0, n_cls, (B, *sp)).astype(np.int32))
            for _ in range(n)]


def _runs(spawn_dir):
    def run():
        rng = np.random.RandomState(42)
        layers = pp_layers(rng)
        x = rng.rand(8, 1, 12, 20, 20).astype(np.float32)
        meta, params = tpipe.extract_params(layers)
        y0 = tpipe._stage_apply(meta, params, range(4),
                                torch.from_numpy(x[:2]))
        ym = np.full((4,) + tuple(y0.shape), 0.5, np.float32)
        x_dp = rng.rand(8, 1, 12, 20, 20).astype(np.float32)
        ym_dp = np.full((2, 4) + tuple(y0.shape[1:]), 0.5, np.float32)
        ref = {"layers": layers, "x": x, "ym": ym, "x_dp": x_dp,
               "ym_dp": ym_dp}
        tnm.model_manager.reset(seed=4)
        cm = S.chain_net(tnm)
        chain_w = W.params_np(cm)
        x_chain = rng.rand(4, 1, 10, 16, 16).astype(np.float32)
        cl = tpipe.layers_from_model(cm)
        ref["chain"] = float(tpipe.gpipe_reference_loss(
            cl, sq, tpipe.microbatch(torch.from_numpy(x_chain), 2),
            torch.zeros((2, 2, 2, 6, 5, 5))))
        ref["chain_predict"] = np.abs(
            cm.predict(torch.from_numpy(x_chain[:2])).numpy()
            - tpipe._stage_apply(*tpipe.extract_params(cl), range(3),
                                 torch.from_numpy(x_chain[:2])).numpy()
        ).max()
        bf = [{"w": torch.from_numpy(rng.randn(4, 1, 3, 3, 3).astype(
                   np.float32) * 0.1).to(torch.bfloat16),
               "b": torch.zeros(4, dtype=torch.bfloat16),
               "activation": "relu"},
              {"w": torch.from_numpy(rng.randn(2, 4, 1, 1, 1).astype(
                  np.float32) * 0.1).to(torch.bfloat16),
               "b": torch.zeros(2, dtype=torch.bfloat16), "activation": None}]
        x_bf16 = rng.rand(2, 1, 8, 10, 10).astype(np.float32)
        models = {}
        specs = {"model_step": ({"B": 4}, 4, 4, 1, 3, 2, None),
                 "model_dp": ({"B": 4}, 2, 2, 2, 1, 2, "data"),
                 "grouped": ({"B": 4, "n_indep": 2, "n_cls": 4}, 4, 4, 1,
                             1, 4, None)}
        for draw in range(2):                         # test_parallel.py:951
            r = np.random.RandomState(50 + draw)
            depth = int(r.choice([2, 4]))
            b_mb = int(r.choice([1, 2]))
            specs[f"fuzz{draw}"] = ({"B": depth * b_mb, "depth": depth},
                                    depth, depth, b_mb, 1, 2, None, r)
        for name, spec in specs.items():
            kw, S_, M, b_mb, n, n_cls, data_axis = spec[:7]
            r = spec[7] if len(spec) > 7 else rng
            jm, tm, w = model_pair(**kw)
            bs = model_batches(tm, kw["B"], n, n_cls, r)
            ref[name] = {
                "jax": [float(jm.trainingstep(d, t)[0]) for d, t in bs],
                "port": [float(tm.trainingstep(torch.from_numpy(d),
                                               torch.from_numpy(t))[0])
                         for d, t in bs]}
            ref[name]["jax_params"] = {
                n: {p: np.asarray(v) for p, v in d.items()}
                for n, d in jm.params.items()}
            ref[name]["port_params"] = W.params_np(tm)
            models[name] = (kw, w, S_, M, b_mb, bs, data_axis)
        ranks = W.run_ranks(
            spawn_dir / "pipe", "torch_scaleout_workers:pipe_cases", world=4,
            layers=layers, x=x, ym=ym, x_dp=x_dp, ym_dp=ym_dp,
            chain_w=chain_w, x_chain=x_chain, bf16_layers=bf, x_bf16=x_bf16,
            models=models)
        return ranks, ref
    return once("pipe", run)


def assert_grads(got, want, rtol, atol):
    assert len(got) == len(want)        # zip must not truncate layers
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol)


def test_ranks_agree_bit_for_bit(spawn_dir):
    ranks, _ = _runs(spawn_dir)
    for r in ranks[1:]:
        for key in ("seq2", "seq4", "dp"):
            assert r[key][0] == ranks[0][key][0]
            for g, g0 in zip(r[key][1], ranks[0][key][1]):
                for k in g:
                    assert np.array_equal(g[k], g0[k]), (key, k)
        assert r["train"] == ranks[0]["train"]


@pytest.mark.parametrize("n_stages", [2, 4])
def test_gpipe_matches_sequential(spawn_dir, n_stages):
    # test_parallel.py:368: the loss AND every gradient (through every
    # hand-off) of 4 microbatches over 2 and 4 stages
    ranks, ref = _runs(spawn_dir)
    xm = ref["x"].reshape(4, 2, 1, 12, 20, 20)
    pl, pg = port_reference(ref["layers"], xm, ref["ym"])
    jl, jg = jax_reference(ref["layers"], xm, ref["ym"])
    np.testing.assert_allclose(pl, jl, rtol=JAX_LOSS_RTOL)
    for r in ranks:
        loss, grads = r[f"seq{n_stages}"]
        np.testing.assert_allclose(loss, pl, rtol=RTOL)
        np.testing.assert_allclose(loss, jl, rtol=JAX_LOSS_RTOL)
        assert_grads(grads, pg, RTOL, ATOL)
        assert_grads(grads, jg, JAX_RTOL, JAX_ATOL)


def test_gpipe_training_decreases_loss(spawn_dir):
    # test_parallel.py:411: eight SGD steps through the pipelined gradient
    ranks, _ = _runs(spawn_dir)
    for r in ranks:
        assert r["train"][-1] < r["train"][0] * 0.9


def test_gpipe_validation_errors(spawn_dir):
    # test_parallel.py:442
    ranks, _ = _runs(spawn_dir)
    for r in ranks:
        assert "stages" in r["too_many_stages"]
    with pytest.raises(ValueError, match="divisible"):
        tpipe.microbatch(torch.zeros((5, 1)), 2)
    with pytest.raises(ValueError, match="divisible"):
        jpipe.microbatch(jnp.zeros((5, 1)), 2)


def test_gpipe_from_neuromancer_model(spawn_dir):
    # test_parallel.py:453: layers_from_model's chain is the model's
    # forward, and its pipelined loss the unpipelined one
    ranks, ref = _runs(spawn_dir)
    assert ref["chain_predict"] <= 1e-6
    for r in ranks:
        n, loss = r["chain"]
        assert n == 3
        np.testing.assert_allclose(loss, ref["chain"], rtol=RTOL)


def test_layers_from_model_rejections():
    # the JAX package's rejections (pipeline.py:193-242): a branch, a BN
    # conv, an interrupted chain, a model without a Conv chain
    def chain(nm, **kw):
        nm.model_manager.reset(seed=1)
        inp = nm.Input([2, 1, 6, 10, 10], "b,f,z,x,y", name="raw")
        h = nm.Conv(inp, 4, (1, 3, 3), (1, 1, 1), name="c0", **kw)
        return nm, inp, h

    for nm, pk in ((tnm, tpipe), (jnm, jpipe)):
        _, inp, h = chain(nm)
        nm.Conv(h, 2, 1, 1, name="a")
        nm.Conv(h, 2, 1, 1, name="b")
        m = nm.model_manager.getmodel().designate_nodes(input_node=inp)
        with pytest.raises(ValueError, match="branches"):
            pk.layers_from_model(m)
        _, inp, h = chain(nm, batch_normalisation=True)
        m = nm.model_manager.getmodel().designate_nodes(input_node=inp)
        with pytest.raises(ValueError, match="mfp/BN/dropout"):
            pk.layers_from_model(m)
        _, inp, h = chain(nm)
        p = nm.Pool(h, (1, 2, 2))
        nm.Conv(p, 2, 1, 1, name="after")
        m = nm.model_manager.getmodel().designate_nodes(input_node=inp)
        with pytest.raises(ValueError, match="interrupted"):
            pk.layers_from_model(m)
        _, inp, h = chain(nm, activation_func="prelu")
        m = nm.model_manager.getmodel().designate_nodes(input_node=inp)
        with pytest.raises(ValueError, match="prelu"):
            pk.layers_from_model(m)


def test_model_loss_fn_heads_and_rejections():
    # _model_loss_fn: the sparse NLL head (grouped too), SquaredLoss and
    # AbsLoss as the JAX package's on the same logits; weighted heads raise
    r = np.random.RandomState(3)
    logits = r.randn(2, 4, 3, 5, 5).astype(np.float32)
    tgt = r.randint(0, 2, (2, 3, 5, 5)).astype(np.int32)
    for n_indep in (1, 2):
        jm, tm, _ = model_pair(B=2, n_indep=n_indep, n_cls=4)
        want = float(jpipe._model_loss_fn(jm)(jnp.asarray(logits),
                                              jnp.asarray(tgt)))
        got = float(tpipe._model_loss_fn(tm)(torch.from_numpy(logits),
                                             torch.from_numpy(tgt)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    for nm, pk in ((tnm, tpipe), (jnm, jpipe)):
        for cls, fn in (("SquaredLoss", np.square), ("AbsLoss", np.abs)):
            nm.model_manager.reset(seed=1)
            inp = nm.Input([2, 4], "b,f", name="raw")
            out = nm.Perceptron(inp, 3, activation_func="lin")
            tg = nm.Input([2, 3], "b,f", name="target")
            m = nm.model_manager.getmodel()
            m.designate_nodes(input_node=inp, target_node=tg,
                              loss_node=nm.AggregateLoss(
                                  getattr(nm, cls)(out, tg)),
                              prediction_node=out)
            a, b = r.randn(2, 3).astype(np.float32), r.randn(2, 3).astype(
                np.float32)
            conv = torch.from_numpy if pk is tpipe else jnp.asarray
            np.testing.assert_allclose(
                float(pk._model_loss_fn(m)(conv(a), conv(b))),
                float(np.mean(fn(a - b))), rtol=1e-6)
        nm.model_manager.reset(seed=1)
        inp = nm.Input([2, 1, 4, 6, 6], "b,f,z,x,y", name="raw")
        probs = nm.Softmax(nm.Conv(inp, 2, 1, 1, activation_func="lin"))
        tg = nm.Input([2, 4, 6, 6], "b,z,x,y", dtype="int32",
                      name="target")
        m = nm.model_manager.getmodel()
        m.designate_nodes(input_node=inp, target_node=tg,
                          loss_node=nm.AggregateLoss(nm.MultinoulliNLL(
                              probs, tg, target_is_sparse=True,
                              class_weights=np.array([1.0, 2.0],
                                                     np.float32))),
                          prediction_node=probs)
        with pytest.raises(ValueError, match="class/example weights"):
            pk._model_loss_fn(m)


def test_gpipe_bf16(spawn_dir):
    # test_parallel.py:491: the hand-off buffer's dtype follows the weights
    ranks, _ = _runs(spawn_dir)
    for r in ranks:
        loss, dtype = r["bf16"]
        assert np.isfinite(loss)
        assert dtype == "torch.bfloat16"


def test_gpipe_composes_with_dp(spawn_dir):
    # test_parallel.py:515: {data: 2, pipe: 2}, each microbatch's batch
    # split over data: loss and gradients equal the sequential stack's
    ranks, ref = _runs(spawn_dir)
    xm = ref["x_dp"].reshape(2, 4, 1, 12, 20, 20)
    pl, pg = port_reference(ref["layers"], xm, ref["ym_dp"])
    jl, jg = jax_reference(ref["layers"], xm, ref["ym_dp"])
    for r in ranks:
        loss, grads = r["dp"]
        np.testing.assert_allclose(loss, pl, rtol=RTOL)
        np.testing.assert_allclose(loss, jl, rtol=JAX_LOSS_RTOL)
        assert_grads(grads, pg, RTOL, ATOL)
        assert_grads(grads, jg, JAX_RTOL, JAX_ATOL)


@pytest.mark.parametrize("name", ["model_step", "model_dp", "grouped",
                                  "fuzz0", "fuzz1"])
def test_model_gpipe_trainstep_matches_trainingstep(spawn_dir, name):
    # test_parallel.py:582 (3 steps, {pipe: 4}), :617 ({data: 2, pipe:
    # 2}), :701 (the grouped softmax head) and :951's two fuzz draws:
    # make_gpipe_trainstep equals Model.trainingstep on the same batches
    ranks, ref = _runs(spawn_dir)
    want = ref[name]
    np.testing.assert_allclose(want["port"], want["jax"], rtol=JAX_STEP_RTOL)
    for r in ranks:
        losses, params = r[name]
        np.testing.assert_allclose(losses, want["port"], rtol=STEP_LOSS_RTOL)
        np.testing.assert_allclose(losses, want["jax"], rtol=JAX_STEP_RTOL)
        for n in want["port_params"]:
            for p in want["port_params"][n]:
                np.testing.assert_allclose(params[n][p],
                                           want["port_params"][n][p],
                                           rtol=0, atol=STEP_W_ATOL)
                np.testing.assert_allclose(params[n][p],
                                           want["jax_params"][n][p],
                                           rtol=JAX_RTOL, atol=JAX_ATOL)


def test_gpipe_trainstep_needs_an_optimiser_and_updates_in_place():
    # in-process, a {pipe: 1} mesh: a model without an optimiser is
    # refused; the step updates the model's tensors in place
    with W.mesh_of_one({"pipe": 1}) as mesh:
        tnm.model_manager.reset(seed=1)
        m = S.flagship_like(tnm, B=2)
        m.optimiser = None
        with pytest.raises(ValueError, match="optimiser"):
            tpipe.make_gpipe_trainstep(m, mesh, 2, 1)
        m.set_opt("SGD", lr=0.05)
        step = tpipe.make_gpipe_trainstep(m, mesh, 2, 1)
        r = np.random.RandomState(1)
        d = torch.from_numpy(r.rand(2, 1, 9, 16, 16).astype(np.float32))
        sp = m.prediction_node.shape.spatial_shape
        t = torch.from_numpy(r.randint(0, 2, (2, *sp)).astype(np.int32))
        before = m.params["c0"]["w"].clone()
        loss, p, _ = step(m.params, m.opt_state, tpipe.microbatch(d, 2),
                          tpipe.microbatch(t, 2),
                          m.optimiser.current_hyper("cpu"))
        assert p is m.params and np.isfinite(float(loss))
        assert not torch.equal(before, m.params["c0"]["w"])
