"""The port's training nodes and options against the JAX package's, on the
CPU: batch norm, dropout, prelu and maxout on Conv and Perceptron, the
standalone ``Pad``, ``Dropout`` and ``BatchNorm``, ``GenericInput``,
``ValueNode``, ``Reshape``, ``Transpose``, the losses ``BinaryNLL``,
``GaussianNLL`` and ``AbsLoss``, ``GaussianRV``, and the aux state's
plumbing (save/load both ways, devices, the fused chunk), batch-normed nets
on the dense paths and the K1 guards.

Each net is built in both packages; the port takes the JAX weights
(``params_from_jax``). Random draws: the JAX package draws from its step
key folded with the node's index; the port is fed those same masks and
noises (``TraceCtx.noise_in``), so both compute the same function.
Tolerances: forward values rtol 1e-5, atol 1e-6; gradients rtol 1e-5 with
an atol of 1e-5 times the step's largest gradient (the bias of a
batch-normed layer has an exact gradient of 0, so both packages give it
rounding noise only, ~1e-8 of the step's scale); losses and parameters
over three SGD steps rtol 1e-5 / atol 1e-5 (float32 reductions summed in
another order by XLA and by PyTorch).
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import elektronn2_tpu.neuromancer as jnm  # noqa: E402
from elektronn2_tpu.neuromancer.model import modelload as jax_modelload  # noqa: E402
import elektronn2_tpu_torch.neuromancer as tnm  # noqa: E402
from elektronn2_tpu_torch.neuromancer import inference, neural  # noqa: E402
from elektronn2_tpu_torch.neuromancer.model import modelload  # noqa: E402
from elektronn2_tpu_torch.ops import tailconv  # noqa: E402
from elektronn2_tpu_torch.training.fused_loop import HostFedFusedLoop  # noqa: E402
from elektronn2_tpu_torch.utils.convert import (  # noqa: E402
    neuro3d_bn_train_model, params_from_jax)

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-5
STEP_TOL = 1e-5


# ------------------------------------------------------------------ nets

def _nll_head(nm, h):
    probs = nm.Softmax(h, name="probs")
    tgt = nm.Input([probs.shape["b"], *probs.shape.spatial_shape],
                   "b,z,x,y", dtype="int32", name="target")
    loss = nm.AggregateLoss(nm.MultinoulliNLL(probs, tgt,
                                              target_is_sparse=True))
    return probs, tgt, loss


def conv_net(nm, **opts):
    """(2, 2, 5, 10, 10) -> (1,3,3) Conv with ``opts`` and pool (1,2,2) ->
    (3,3,3) Conv with dropout -> 1x1 -> softmax NLL."""
    nm.model_manager.reset(seed=3)
    inp = nm.Input([2, 2, 5, 10, 10], "b,f,z,x,y", name="raw")
    n_f = 6 if str(opts.get("activation_func", "")).startswith("maxout") \
        else 4
    c1 = nm.Conv(inp, n_f, (1, 3, 3), (1, 2, 2), name="c1", **opts)
    c2 = nm.Conv(c1, 3, (3, 3, 3), 1, dropout_rate=0.25, name="c2")
    out = nm.Conv(c2, 2, 1, 1, activation_func="lin", name="cls")
    probs, tgt, loss = _nll_head(nm, out)
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=probs)
    return m


def dot_net(nm, **opts):
    """(4, 6) -> Perceptron with ``opts`` -> Perceptron -> softmax NLL."""
    nm.model_manager.reset(seed=4)
    inp = nm.Input([4, 6], "b,f", name="raw")
    n_f = 8 if str(opts.get("activation_func", "")).startswith("maxout") \
        else 5
    h = nm.Perceptron(inp, n_f, name="h", **opts)
    out = nm.Perceptron(h, 3, activation_func="lin", name="out")
    probs = nm.Softmax(out, name="probs")
    tgt = nm.Input([4], "b", dtype="int32", name="target")
    loss = nm.AggregateLoss(nm.MultinoulliNLL(probs, tgt,
                                              target_is_sparse=True))
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=probs)
    return m


def flat_dot_net(nm, **opts):
    """(2, 3, 4, 4) -> Perceptron(flatten=True) with ``opts`` -> NLL."""
    nm.model_manager.reset(seed=5)
    inp = nm.Input([2, 3, 4, 4], "b,f,x,y", name="raw")
    h = nm.Perceptron(inp, 6, flatten=True, name="h", **opts)
    out = nm.Perceptron(h, 2, activation_func="lin", name="out")
    probs = nm.Softmax(out, name="probs")
    tgt = nm.Input([2], "b", dtype="int32", name="target")
    loss = nm.AggregateLoss(nm.MultinoulliNLL(probs, tgt,
                                              target_is_sparse=True))
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=probs)
    return m


def standalone_net(nm, mode="constant"):
    """2-D: Pad -> BatchNorm -> Dropout -> Conv -> softmax NLL."""
    nm.model_manager.reset(seed=6)
    inp = nm.Input([2, 3, 8, 8], "b,f,x,y", name="raw")
    p = nm.Pad(inp, [1, (2, 0)], mode=mode, name="pad")
    bn = nm.BatchNorm(p, name="bn")
    d = nm.Dropout(bn, 0.4, name="drop")
    out = nm.Conv(d, 2, 3, 1, activation_func="lin", name="cls")
    probs = nm.Softmax(out, name="probs")
    tgt = nm.Input([2, *probs.shape.spatial_shape], "b,x,y", dtype="int32",
                   name="target")
    loss = nm.AggregateLoss(nm.MultinoulliNLL(probs, tgt,
                                              target_is_sparse=True))
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=probs)
    return m


def basic_nodes_net(nm):
    """Reshape, Transpose, a trainable ValueNode and Concat, then a
    Perceptron under AbsLoss."""
    nm.model_manager.reset(seed=7)
    inp = nm.Input([2, 12], "b,f", name="raw")
    r = nm.Reshape(inp, [2, 3, 4], "b,f,x", name="reshape")
    t = nm.Transpose(r, ["b", "x", "f"], name="transpose")
    v = nm.ValueNode([2, 4, 2], "b,x,f", value=0.5, trainable=True,
                     name="value")
    c = nm.Concat([t, v], axis="f", name="cat")
    out = nm.Perceptron(c, 2, activation_func="tanh", name="out")
    tgt = nm.Input([2, 4, 2], "b,x,f", name="target")
    loss = nm.AggregateLoss(nm.AbsLoss(out, tgt, name="abs"))
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=out)
    return m


def binary_net(nm):
    nm.model_manager.reset(seed=8)
    inp = nm.Input([4, 5], "b,f", name="raw")
    out = nm.Perceptron(inp, 3, activation_func="sig", name="out")
    tgt = nm.Input([4, 3], "b,f", name="target")
    loss = nm.AggregateLoss(nm.BinaryNLL(out, tgt, name="bnll"))
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=out)
    return m


def gaussian_net(nm, sig_is_log=False, rv_samples=0):
    """mu and sig heads -> GaussianNLL; with ``rv_samples`` a GaussianRV
    sample of (mu, sig) feeds a third head under SquaredLoss too."""
    nm.model_manager.reset(seed=9)
    inp = nm.Input([4, 5], "b,f", name="raw")
    mu = nm.Perceptron(inp, 3, activation_func="lin", name="mu")
    sig = nm.Perceptron(inp, 3, activation_func="lin" if sig_is_log
                        else "softplus", name="sig")
    tgt = nm.Input([4, 3], "b,f", name="target")
    parts = [nm.GaussianNLL(mu, sig, tgt, sig_is_log=sig_is_log,
                            name="gnll")]
    pred = mu
    if rv_samples:
        z = nm.GaussianRV(mu, sig, n_samples=rv_samples, name="rv")
        pred = nm.Perceptron(z, 3, activation_func="lin", name="dec")
        parts.append(nm.SquaredLoss(pred, tgt, name="sq"))
    loss = nm.AggregateLoss(parts)
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=pred)
    return m


CASES = {
    "conv_bn": (conv_net, dict(batch_normalisation=True)),
    "conv_dropout": (conv_net, dict(dropout_rate=0.3)),
    "conv_prelu": (conv_net, dict(activation_func="prelu")),
    "conv_maxout": (conv_net, dict(activation_func="maxout:3")),
    "conv_all": (conv_net, dict(batch_normalisation=True, dropout_rate=0.2,
                                activation_func="prelu")),
    "dot_bn": (dot_net, dict(batch_normalisation=True)),
    "dot_dropout": (dot_net, dict(dropout_rate=0.5)),
    "dot_prelu": (dot_net, dict(activation_func="prelu")),
    "dot_maxout": (dot_net, dict(activation_func="maxout:2")),
    "dot_all": (dot_net, dict(batch_normalisation=True, dropout_rate=0.2,
                              activation_func="prelu")),
    "flat_dot_bn_dropout": (flat_dot_net, dict(batch_normalisation=True,
                                               dropout_rate=0.3)),
    "pad_bn_dropout": (standalone_net, {}),
    "pad_reflect": (standalone_net, dict(mode="reflect")),
    "pad_edge": (standalone_net, dict(mode="edge")),
    "pad_symmetric": (standalone_net, dict(mode="symmetric")),
    "pad_wrap": (standalone_net, dict(mode="wrap")),
    "pad_linear_ramp": (standalone_net, dict(mode="linear_ramp")),
    "basic_nodes": (basic_nodes_net, {}),
    "binary_nll": (binary_net, {}),
    "gaussian_nll": (gaussian_net, {}),
    "gaussian_nll_log": (gaussian_net, dict(sig_is_log=True)),
    "gaussian_rv": (gaussian_net, dict(rv_samples=1)),
    "gaussian_rv_3": (gaussian_net, dict(rv_samples=3)),
}


def build_pair(case):
    build, kw = CASES[case]
    jm = build(jnm, **kw)
    tm = build(tnm, **kw)
    tm.set_params(params_from_jax(jm.params, tm))
    return jm, tm


def make_feed(m, seed=0):
    """Seeded numpy inputs for the model's input and target nodes."""
    rng = np.random.RandomState(seed)
    feed = {}
    for node in (m.input_node, m.target_node):
        shape = tuple(node.shape)
        if node.dtype == "int32":
            n_cls = m.prediction_node.shape["f"]
            feed[node.name] = rng.randint(0, n_cls, shape).astype(np.int32)
        elif node is m.target_node:
            feed[node.name] = rng.rand(*shape).astype(np.float32)
        else:
            feed[node.name] = (rng.randn(*shape) * 1.5).astype(np.float32)
    return feed


def jax_draws(jm, key):
    """The JAX package's random draws of one training evaluation with step
    key ``key``, by node name: dropout masks and GaussianRV noise."""
    draws = {}
    for name, node in jm.nodes.items():
        k = jax.random.fold_in(key, jm._node_index[name])
        rate = getattr(node, "dropout_rate", 0) or getattr(node, "rate", 0)
        if rate and type(node).__name__ in ("Conv", "Perceptron",
                                             "Dropout"):
            draws[name] = jax.random.bernoulli(k, 1.0 - rate,
                                               tuple(node.shape))
        elif type(node).__name__ == "GaussianRV":
            shape = tuple(node.shape)
            if node.n_samples == 1:
                draws[name] = jax.random.normal(k, shape, jnp.float32)
            else:
                draws[name] = jax.random.normal(
                    k, (node.n_samples,) + shape, jnp.float32).mean(axis=0)
    return draws


def to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def assert_tree_close(got, want, what=""):
    assert set(got) == set(want), what
    for n in want:
        for k in want[n]:
            w = np.asarray(want[n][k])
            np.testing.assert_allclose(got[n][k].detach().numpy(), w,
                                       rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=f"{what} {n}/{k}")


# ----------------------------------------------------------------- tests

@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    """Evaluation mode (batch norm without running statistics normalises by
    the batch's) and training mode with JAX's draws fed: the prediction
    and the loss."""
    jm, tm = build_pair(case)
    feed = make_feed(jm)
    tfeed = to_torch(feed)
    nodes = [jm.prediction_node, jm.loss_node]
    tnodes = [tm.prediction_node, tm.loss_node]
    key = jax.random.PRNGKey(11)
    for train in (False, True):
        want, _ = jm._apply(nodes, jm.params, jm.state, feed,
                            key if train else None, train=train)
        noise = to_torch(jax_draws(jm, key)) if train else None
        got, _ = tm._apply(tnodes, tm.params, tm.state, tfeed, None,
                           train=train, noise=noise)
        for g, w, what in zip(got, want, ("prediction", "loss")):
            np.testing.assert_allclose(
                g.detach().numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                err_msg=f"{case} train={train} {what}")
    if jax_draws(jm, key):     # the draws change the function
        ev, _ = tm._apply([tm.loss_node], tm.params, tm.state, tfeed, None,
                          train=False)
        assert not torch.equal(ev[0], got[1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(case):
    """One training step's gradients, with JAX's draws fed to the port."""
    jm, tm = build_pair(case)
    feed = make_feed(jm, seed=1)
    key = jax.random.PRNGKey(5)

    def f(tp):
        merged = {n: {**jm.params[n], **tp.get(n, {})} for n in jm.params}
        outs, _ = jm._apply([jm.loss_node], merged, jm.state, feed, key,
                            train=True)
        return outs[0][0]
    jl, jg = jax.value_and_grad(f)(jm._trainable(jm.params))
    tl, _, tg, _ = tm._loss_and_grads(to_torch(feed), None,
                                      noise=to_torch(jax_draws(jm, key)))
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    assert set(tg) == set(jg)
    top = max(float(np.abs(np.asarray(v)).max()) for d in jg.values()
              for v in d.values())
    for n in jg:
        for k in jg[n]:
            w = np.asarray(jg[n][k])
            np.testing.assert_allclose(
                tg[n][k].numpy(), w, rtol=GRAD_RTOL, atol=GRAD_RTOL * top,
                err_msg=f"{case} {n}/{k}")


@pytest.mark.parametrize("case", ["conv_bn", "conv_all", "dot_all",
                                  "flat_dot_bn_dropout", "pad_bn_dropout",
                                  "gaussian_rv"])
def test_three_steps_match_jax(case):
    """Three SGD steps, the port fed each JAX step's draws: the losses,
    the parameters and batch norm's running statistics. (SGD: Adam divides
    the pre-batch-norm bias's rounding-noise gradient by its own size and
    steps it by the learning rate in a direction neither package fixes.)"""
    jm, tm = build_pair(case)
    jm.set_opt("SGD", lr=0.05, mom=0.9)
    tm.set_opt("SGD", lr=0.05, mom=0.9)
    jm.seed(3)
    key = jax.random.PRNGKey(3)
    for step in range(3):
        feed = make_feed(jm, seed=10 + step)
        key, sub = jax.random.split(key)       # JAX's Model._next_rng
        jl, _ = jm.trainingstep(feed)
        hyper = tm.optimiser.current_hyper(tm.device)
        tl, _, _ = tm._train_step(tm._feed(to_torch(feed)), None, hyper,
                                  noise=to_torch(jax_draws(jm, sub)))
        np.testing.assert_allclose(float(tl), float(jl), rtol=STEP_TOL,
                                   err_msg=f"{case} step {step}")
    assert_tree_close(tm.params, jm.params, f"{case} params")
    assert_tree_close(tm.state, jm.state, f"{case} state")
    bn = [n for n, node in tm.nodes.items()
          if getattr(node, "_bn_nf", None) is not None]
    assert sorted(tm.state) == sorted(bn)
    for n in bn:     # three EMA steps moved the statistics off 0 and 1
        assert tm.state[n]["mean"].abs().max() > 0
        assert (tm.state[n]["var"] - 1).abs().max() > 0


def test_eval_uses_running_statistics():
    """After training, evaluation normalises by the running statistics in
    both packages (and differs from the batch's normalisation)."""
    jm, tm = build_pair("conv_all")
    jm.set_opt("SGD", lr=1e-2)
    tm.set_opt("SGD", lr=1e-2)
    feed = make_feed(jm, seed=2)
    tm.seed(0)
    for _ in range(2):
        jm.trainingstep(feed)
    tm.state = {n: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
                for n, d in jm.state.items()}
    tm.set_params(params_from_jax(jm.params, tm))
    want = jm.predict(feed["raw"])
    got = tm.predict(torch.from_numpy(feed["raw"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    fresh, _ = tm._apply([tm.prediction_node], tm.params, {},
                         tm._feed(torch.from_numpy(feed["raw"])), None,
                         train=False)
    assert not torch.allclose(fresh[0], got)


def test_dropout_map_and_draw():
    """The map of a fed mask, and the port's own draws: a fresh mask each
    step, the expected keep rate, no draw in evaluation."""
    x = torch.rand(64, 64) + 1
    mask = torch.rand(64, 64) < 0.7
    y = neural.dropout_map(x, mask, 0.7)
    assert torch.equal(y[mask], x[mask] / 0.7) and (y[~mask] == 0).all()
    tm = dot_net(tnm, dropout_rate=0.4)
    tm.seed(1)
    feed = tm._feed(*[torch.from_numpy(v) for v in make_feed(tm).values()])
    d1, d2 = {}, {}
    tm._loss_and_grads(feed, tm._next_rng(), draws=d1)
    tm._loss_and_grads(feed, tm._next_rng(), draws=d2)
    m1, m2 = d1["h"], d2["h"]
    assert m1.dtype == torch.bool and not torch.equal(m1, m2)
    big = neural.dropout_mask(torch.Generator().manual_seed(0), (200, 200),
                              0.6, "cpu")
    assert abs(big.float().mean().item() - 0.6) < 0.01
    ev = [tm._apply([tm.loss_node], tm.params, tm.state, feed, rng,
                    train=False)[0][0] for rng in (tm._next_rng(), None)]
    assert torch.equal(ev[0], ev[1])        # evaluation draws nothing


def test_remat_same_step():
    """``set_remat``: the same losses, gradients and draws (the recomputed
    forward reuses the step's masks and advances no generator)."""
    outs = []
    for remat in (False, True):
        tm = neuro3d_bn_train_model(2, (7, 25, 25), widths=(3, 3, 4, 4),
                                    device="cpu")
        tm.set_remat(remat)
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.rand(*tm.input_node.shape).astype(
            np.float32))
        t = torch.from_numpy((rng.rand(*tm.target_node.shape) > 0.5)
                             .astype(np.int32))
        tm.seed(4)
        losses = [float(tm.trainingstep(x, t)[0]) for _ in range(3)]
        outs.append((losses, tm.params, tm.state,
                     tm._next_rng().get_state()))
    (l0, p0, s0, g0), (l1, p1, s1, g1) = outs
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for tree0, tree1 in ((p0, p1), (s0, s1)):
        for n in tree0:
            for k in tree0[n]:
                torch.testing.assert_close(tree1[n][k], tree0[n][k],
                                           rtol=1e-5, atol=1e-6)
    assert torch.equal(g0, g1)


def test_bn_model_save_load_both_ways(tmp_path):
    """A JAX-saved model with batch norm, dropout and prelu (running
    statistics after two steps) loads into the port with its state, serves
    the same, is saved by the port and loads back into the JAX package with
    the same statistics and weights."""
    jm = conv_net(jnm, batch_normalisation=True, dropout_rate=0.2,
                  activation_func="prelu")
    jm.set_opt("Adam", lr=1e-2)
    feed = make_feed(jm, seed=4)
    for _ in range(2):
        jm.trainingstep(feed)
    f1 = str(tmp_path / "jax.mdl")
    jm.save(f1)
    tm = modelload(f1, device="cpu")
    assert sorted(tm.state) == ["c1"]
    assert_tree_close(tm.state, jm.state, "loaded state")
    raw = feed["raw"]
    np.testing.assert_allclose(tm.predict(torch.from_numpy(raw)).numpy(),
                               np.asarray(jm.predict(raw)), rtol=RTOL,
                               atol=ATOL)
    tm.trainingstep(*[torch.from_numpy(v) for v in feed.values()])
    f2 = str(tmp_path / "port.mdl")
    tm.save(f2)
    back = jax_modelload(f2)
    assert_tree_close(tm.state, back.state, "state back in JAX")
    assert_tree_close(tm.params, back.params, "params back in JAX")
    np.testing.assert_allclose(np.asarray(back.predict(raw)),
                               tm.predict(torch.from_numpy(raw)).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_state_round_trip_and_devices(tmp_path):
    """The aux state survives the port's own save -> load, follows the
    model in ``to`` (the meta device here) and in ``rebuild_model``, and
    ``snapshot_good``/``repair_fuckup`` restore it in place."""
    tm = conv_net(tnm, batch_normalisation=True)
    tm.set_opt("SGD", lr=1e-2)
    feed = [torch.from_numpy(v) for v in make_feed(tm).values()]
    tm.trainingstep(*feed)
    f = str(tmp_path / "bn.mdl")
    tm.save(f)
    back = modelload(f, device="cpu")
    for k in ("mean", "var"):
        assert torch.equal(back.state["c1"][k], tm.state["c1"][k])
    live = tm.state["c1"]["mean"]
    tm.snapshot_good()
    kept = live.clone()
    tm.trainingstep(*feed)
    assert not torch.equal(live, kept)
    assert tm.repair_fuckup()
    assert tm.state["c1"]["mean"] is live and torch.equal(live, kept)
    rebuilt = tnm.model.rebuild_model(tm, imposed_patch_size=[5, 12, 12])
    assert torch.equal(rebuilt.state["c1"]["var"], tm.state["c1"]["var"])
    meta = back.to("meta")
    assert {v.device.type for d in meta.state.values()
            for v in d.values()} == {"meta"}


def test_state_made_once_and_written_in_place():
    """A step makes the running statistics once (zeros and ones, so the
    first EMA is 0.01 * the batch's) and then writes them in place: the
    tensors keep their identity, as a CUDA graph's replays need."""
    tm = conv_net(tnm, batch_normalisation=True)
    tm.set_opt("SGD", lr=0.0)
    assert tm.state == {}
    feed = [torch.from_numpy(v) for v in make_feed(tm).values()]
    tm.trainingstep(*feed)
    st = tm.state["c1"]
    ids = (id(st["mean"]), id(st["var"]))
    first = st["mean"].clone()
    tm.trainingstep(*feed)
    assert (id(tm.state["c1"]["mean"]), id(tm.state["c1"]["var"])) == ids
    torch.testing.assert_close(tm.state["c1"]["mean"],
                               first * 0.99 + first, rtol=1e-5, atol=1e-7)


def test_eager_chunk_state_equals_sequential_steps():
    """A fused loop's chunk of two steps writes the same running statistics
    (and parameters) as two sequential ``trainingstep`` calls on the same
    batches and draws; the state is among the loop's written leaves."""
    class Data:
        def __init__(self, m):
            self.m, self.i = m, 0

        def getbatch(self, batch_size):
            self.i += 1
            f = make_feed(self.m, seed=20 + self.i)
            return f["raw"], f["target"]

    runs = []
    for fused in (True, False):
        tm = conv_net(tnm, batch_normalisation=True, dropout_rate=0.3)
        tm.set_opt("Adam", lr=1e-2)
        data = Data(tm)
        if fused:
            loop = HostFedFusedLoop(tm, data, 2, 2, seed=7, prefetch=False)
            losses, _ = loop.run_chunk()
            written = {id(t) for t in loop._written()}
            assert {id(v) for d in tm.state.values()
                    for v in d.values()} <= written
        else:
            gen = torch.Generator().manual_seed(7)
            hyper = tm.optimiser.current_hyper(tm.device)
            losses = []
            for _ in range(2):
                x, t = data.getbatch(2)
                feed = tm._feed(torch.from_numpy(x), torch.from_numpy(t))
                losses.append(float(tm._train_step(feed, gen, hyper)[0]))
        runs.append((np.asarray(losses), tm))
    (lf, mf), (ls, ms) = runs
    np.testing.assert_array_equal(lf, np.asarray(ls, np.float32))
    for n in ms.state:
        for k in ("mean", "var"):
            assert torch.equal(mf.state[n][k], ms.state[n][k])
    for n in ms.params:
        for k in ms.params[n]:
            assert torch.equal(mf.params[n][k], ms.params[n][k])


# ------------------------------------------------------------ dense paths

@contextlib.contextmanager
def counting_k1():
    """Count the calls of K1's wrapper on both routes (the CPU runs its
    plain version and does not count launches)."""
    calls = []
    real = tailconv.conv3x3_dilated

    def wrapper(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)
    saved = neural.conv3x3_dilated
    neural.conv3x3_dilated = wrapper
    tailconv.conv3x3_dilated = wrapper
    try:
        yield calls
    finally:
        neural.conv3x3_dilated = saved
        tailconv.conv3x3_dilated = real


def mfp_bn_net(nm, bn=True, mfp=True):
    """The net of the JAX test ``test_dilated_path_supports_trained_
    batchnorm``: a 2-D MFP Conv with batch norm, then a 1x1 head."""
    from elektronn2_tpu_torch.utils import cnncalculator
    nm.model_manager.reset(seed=60)
    n = cnncalculator([3, 3], [2, 1], desired_patch_size=17, mfp=mfp,
                      ndim=2).input
    inp = nm.Input([2, 1, *n], "b,f,x,y", name="raw")
    c1 = nm.Conv(inp, 4, 3, 2, mfp=mfp, batch_normalisation=bn, name="c1")
    probs = nm.Softmax(nm.Conv(c1, 2, 1, 1, activation_func="lin",
                               name="cls"), name="probs")
    tgt = nm.Input([probs.shape["b"], *probs.shape.spatial_shape], "b,x,y",
                   dtype="int32", name="target")
    loss = nm.AggregateLoss(nm.MultinoulliNLL(probs, tgt,
                                              target_is_sparse=True))
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=probs)
    return m


def test_dilated_path_supports_trained_batchnorm():
    """Counterpart of the JAX test of that name: after three steps the
    dilated path applies batch norm as a per-channel affine and matches the
    tiled path, and JAX's dilated path on the same weights and state."""
    jm = mfp_bn_net(jnm)
    tm = mfp_bn_net(tnm)
    tm.set_params(params_from_jax(jm.params, tm))
    tm.set_opt("Adam", lr=1e-3)
    rng = np.random.RandomState(1)
    for _ in range(3):
        x = rng.rand(*tm.input_node.shape).astype(np.float32)
        y = (rng.rand(*tm.target_node.shape) > 0.5).astype(np.int32)
        tm.trainingstep(torch.from_numpy(x), torch.from_numpy(y))
    assert "c1" in tm.state
    assert inference._dilated_unsupported(tm.prediction_node,
                                          tm.state) is None
    raw = rng.rand(1, 30, 30).astype(np.float32)
    host = tm.predict_dense(raw, prefer_device=False)
    dev = tm.predict_dense_device(torch.from_numpy(raw)).numpy()
    np.testing.assert_allclose(dev, host, atol=1e-5)
    jm.params = {n: {k: jnp.asarray(v.numpy()) for k, v in d.items()}
                 for n, d in tm.params.items()}
    jm.state = {n: {k: jnp.asarray(v.numpy()) for k, v in d.items()}
                for n, d in tm.state.items()}
    want = np.asarray(jm.predict_dense_device(jnp.asarray(raw)))
    np.testing.assert_allclose(dev, want, rtol=RTOL, atol=1e-5)


def test_dilated_path_allows_dropout():
    """Counterpart of the JAX test of that name: a Dropout node (the
    identity in evaluation) keeps the dilated path."""
    tnm.model_manager.reset(seed=61)
    inp = tnm.Input([1, 1, 13, 13], "b,f,x,y", name="raw")
    c = tnm.Conv(inp, 4, 3, 2, mfp=True, name="c1")
    d = tnm.Dropout(c, 0.5, name="dr")
    probs = tnm.Softmax(tnm.Conv(d, 2, 1, 1, activation_func="lin"))
    m = tnm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, prediction_node=probs)
    assert inference._dilated_unsupported(probs, m.state) is None
    raw = np.random.RandomState(2).rand(1, 21, 21).astype(np.float32)
    dev = m.predict_dense_device(torch.from_numpy(raw)).numpy()
    host = m.predict_dense(raw, prefer_device=False)
    np.testing.assert_allclose(dev, host, atol=1e-6)


def test_bn_stats_do_not_poison_negative_cache():
    """Counterpart of the JAX test of that name: before training a
    batch-normed net serves through the tiled path (the batch's
    statistics); once a step made running statistics it takes the dilated
    path."""
    tnm.model_manager.reset(seed=63)
    inp = tnm.Input([2, 1, 14, 14], "b,f,x,y", name="raw")
    c = tnm.Conv(inp, 4, 3, 2, batch_normalisation=True, name="c1")
    probs = tnm.Softmax(tnm.Conv(c, 2, 1, 1, activation_func="lin"))
    tgt = tnm.Input([2, *probs.shape.spatial_shape], "b,x,y",
                    dtype="int32", name="target")
    loss = tnm.AggregateLoss(tnm.MultinoulliNLL(probs, tgt,
                                                target_is_sparse=True))
    m = tnm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=probs)
    m.set_opt("Adam", lr=1e-3)
    rng = np.random.RandomState(3)
    raw = rng.rand(1, 21, 21).astype(np.float32)
    assert inference._dilated_unsupported(probs, m.state) is c
    out = m.predict_dense(raw)
    assert np.isfinite(out).all()
    x = rng.rand(2, 1, 14, 14).astype(np.float32)
    y = (rng.rand(2, *probs.shape.spatial_shape) > 0.5).astype(np.int32)
    m.trainingstep(torch.from_numpy(x), torch.from_numpy(y))
    assert inference._dilated_unsupported(probs, m.state) is None
    dev = m.predict_dense_device(torch.from_numpy(raw)).numpy()
    assert np.isfinite(dev).all()


def k1_net(nm, bn=False, prelu=False, decoder=False):
    """A 3-D net whose (3,3,3) convs are ReLU convs K1 could take; with
    ``bn`` or ``prelu`` the middle conv carries batch norm or prelu's slope.
    ``decoder`` adds an UpConv branch (the conv-dense route)."""
    nm.model_manager.reset(seed=70)
    if decoder:
        inp = nm.Input([1, 1, 14, 22, 22], "b,f,z,x,y", name="raw")
        a = nm.Conv(inp, 3, (3, 3, 3), 1, name="a")
        mid = nm.Conv(a, 4, (3, 3, 3), (1, 2, 2), batch_normalisation=bn,
                      activation_func="prelu" if prelu else "relu",
                      name="mid")
        up = nm.UpConv(mid, 3, (1, 2, 2), name="up")
        h = nm.Conv(nm.FaithlessMerge(a, up, name="merge"), 3, (3, 3, 3),
                    1, name="tail")
    else:
        inp = nm.Input([1, 1, 9, 15, 15], "b,f,z,x,y", name="raw")
        a = nm.Conv(inp, 3, (1, 3, 3), (1, 2, 2), mfp=True, name="a")
        mid = nm.Conv(a, 4, (3, 3, 3), 1, mfp=True, batch_normalisation=bn,
                      activation_func="prelu" if prelu else "relu",
                      name="mid")
        h = nm.Conv(mid, 3, (3, 3, 3), 1, mfp=True, name="tail")
    probs = nm.Softmax(nm.Conv(h, 2, 1, 1, activation_func="lin",
                               name="cls"), name="probs")
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, prediction_node=probs)
    if bn:
        m.state = {"mid": {"mean": torch.full((4,), 0.1),
                           "var": torch.full((4,), 1.5)}}
    return m


@pytest.mark.parametrize("opt", ["plain", "bn", "prelu"])
@pytest.mark.parametrize("route", ["dilated", "convdense"])
def test_k1_guard(route, opt):
    """K1 fuses bias + ReLU: a batch-normed or prelu (3,3,3) conv is never
    handed to it on either route (a plain one is), and the served map
    equals the cuDNN route's."""
    m = k1_net(tnm, bn=opt == "bn", prelu=opt == "prelu",
               decoder=route == "convdense")
    rng = np.random.RandomState(4)
    m.set_params({n: {k: torch.from_numpy(
        (rng.randn(*v.shape) * 0.3).astype(np.float32))
        for k, v in d.items()} for n, d in m.params.items()})
    vol = torch.from_numpy(rng.rand(1, 20, 30, 30).astype(np.float32))
    if route == "dilated":
        on = dict(pallas_tail=True)
        set_impl = m.set_dilated_impl
    else:
        on = dict(ptail=True)
        set_impl = m.set_convdense_impl
    with counting_k1() as calls:
        set_impl(**on)
        got = m.predict_dense_device(vol, pad_raw=True)
    set_impl()
    ref = m.predict_dense_device(vol, pad_raw=True)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    mid_w = tuple(m.params["mid"]["w"].shape)
    taken = [s for s in calls if tuple(s) == mid_w]
    if opt == "plain":
        assert taken
    else:
        assert not taken and calls      # the other convs still take K1
