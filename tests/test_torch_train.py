"""The port's training step against the JAX package's, on the CPU.

Nets are built in both packages from the same seed and the port takes the
JAX weights (``params_from_jax``) and optimiser state
(``opt_state_from_jax``). Tolerances: losses rtol 1e-5 and final parameters
atol 1e-5 after 4 steps (float32 convs and their gradients summed in
another order by XLA and by PyTorch, through four updates); gradients of one
step rtol 1e-5, with an atol of 1e-5 times the leaf's largest gradient (an
entry near zero has no relative precision to hold).
"""

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
from elektronn2_tpu_torch.neuromancer.model import modelload  # noqa: E402
from elektronn2_tpu_torch.neuromancer.optimiser import tree_leaves  # noqa: E402
from elektronn2_tpu_torch.utils.convert import (  # noqa: E402
    neuro3d_train_model, opt_state_from_jax, params_from_jax)

torch.set_num_threads(1)
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
GRAD_RTOL = 1e-5

OPTS = [
    ("SGD", {"lr": 1e-2, "mom": 0.9}),
    ("Adam", {"lr": 1e-3}),
    ("AdaGrad", {"lr": 1e-2}),
    ("AdaDelta", {}),
]


def golden_net(nm, class_weights=None):
    """The net of tests/test_train_golden.py in package ``nm`` (seed 13)."""
    nm.model_manager.reset(seed=13)
    inp = nm.Input([2, 1, 7, 12, 12], "b,f,z,x,y", name="raw")
    c1 = nm.Conv(inp, 5, (3, 3, 3), (1, 2, 2), name="c1")
    c2 = nm.Conv(c1, 6, (1, 3, 3), (1, 1, 1), name="c2")
    probs = nm.Softmax(nm.Conv(c2, 2, 1, 1, activation_func="lin"))
    tgt = nm.Input([2, *probs.shape.spatial_shape], "b,z,x,y",
                   dtype="int32", name="target")
    nll = nm.MultinoulliNLL(probs, tgt, target_is_sparse=True,
                            class_weights=class_weights)
    loss = nm.AggregateLoss(nll)
    err = nm.Errors(probs, tgt, target_is_sparse=True)
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=probs, error_node=err)
    return m


def golden_batch(m):
    rng = np.random.RandomState(99)
    x = rng.rand(2, 1, 7, 12, 12).astype(np.float32)
    y = (rng.rand(2, *m.prediction_node.shape.spatial_shape) > 0.5
         ).astype(np.int32)
    return x, y


def port_twin(jm, build, *args):
    """The port's net built by ``build`` with the JAX model's weights."""
    tm = build(tnm, *args)
    tm.set_params(params_from_jax(jm.params, tm))
    return tm


def assert_params_close(tm, jparams, atol=PARAM_ATOL, what=""):
    assert set(tm.params) == set(jparams)
    for n, d in jparams.items():
        for p, v in d.items():
            np.testing.assert_allclose(tm.params[n][p].numpy(), np.asarray(v),
                                       atol=atol, rtol=0,
                                       err_msg=f"{what} {n}/{p}")


@pytest.mark.parametrize("opt_name, opt_kwargs", OPTS)
def test_four_steps_match_jax(opt_name, opt_kwargs):
    jm = golden_net(jnm)
    tm = port_twin(jm, golden_net)
    jm.set_opt(opt_name, **opt_kwargs)
    tm.set_opt(opt_name, **opt_kwargs)
    x, y = golden_batch(jm)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for step in range(4):
        jl, jaux = jm.trainingstep(x, y)
        tl, taux = tm.trainingstep(tx, ty)
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL,
                                   err_msg=f"{opt_name} step {step}")
        np.testing.assert_allclose(float(taux["gradnorm"]),
                                   float(jaux["gradnorm"]), rtol=LOSS_RTOL)
        assert float(taux["error"]) == pytest.approx(float(jaux["error"]),
                                                     abs=1e-6)
    assert tm._step_count == 4 and int(tm.opt_state["step"]) == 4
    assert_params_close(tm, jm.params, what=opt_name)


def jax_grads(m, x, y):
    feed = m._feed(x, y)

    def f(tp):
        merged = {n: {**m.params[n], **tp.get(n, {})} for n in m.params}
        outs, _ = m._apply([m.loss_node], merged, m.state, feed, None,
                           train=True)
        return outs[0][0]
    return jax.grad(f)(m._trainable(m.params))


def assert_grads_close(tgrads, jgrads):
    assert set(tgrads) == set(jgrads)
    for n, d in jgrads.items():
        for p, g in d.items():
            g = np.asarray(g)
            np.testing.assert_allclose(
                tgrads[n][p].numpy(), g, rtol=GRAD_RTOL,
                atol=GRAD_RTOL * float(np.abs(g).max()),
                err_msg=f"grad {n}/{p}")


def test_gradients_match_jax_grad():
    jm = golden_net(jnm)
    tm = port_twin(jm, golden_net)
    x, y = golden_batch(jm)
    _, _, grads, _ = tm._loss_and_grads(
        tm._feed(torch.from_numpy(x), torch.from_numpy(y)), None)
    assert_grads_close(grads, jax_grads(jm, x, y))


def test_jax_save_resumes_in_port(tmp_path):
    """A JAX ``Model.save`` after two Adam steps, read by the port's
    ``modelload``: the port's third step equals JAX's third."""
    jm = golden_net(jnm)
    jm.set_opt("Adam", lr=1e-3, wd=1e-3)
    x, y = golden_batch(jm)
    for _ in range(2):
        jm.trainingstep(x, y)
    fname = str(tmp_path / "jax.mdl")
    jm.save(fname)
    tm = modelload(fname, device="cpu")
    assert type(tm.optimiser).__name__ == "Adam"
    assert tm.optimiser.hyperparams == jm.optimiser.hyperparams
    assert tm._step_count == 2 and int(tm.opt_state["step"]) == 2
    for a, b in zip(tree_leaves(tm.opt_state["slots"][0]),
                    jax.tree_util.tree_leaves(jm.opt_state["slots"][0])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jl, _ = jm.trainingstep(x, y)
    tl, _ = tm.trainingstep(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert_params_close(tm, jm.params, what="resumed")


def test_port_save_resumes_in_jax(tmp_path):
    """The port's save, read by the JAX ``modelload`` with the optimiser
    state: JAX's next step equals the port's."""
    jm = golden_net(jnm)
    tm = port_twin(jm, golden_net)
    tm.set_opt("SGD", lr=1e-2, mom=0.9, nesterov=True)
    x, y = golden_batch(jm)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(2):
        tm.trainingstep(tx, ty)
    fname = str(tmp_path / "port.mdl")
    tm.save(fname)
    jm2 = jax_modelload(fname)
    assert type(jm2.optimiser).__name__ == "SGD" and jm2.optimiser.nesterov
    assert jm2._step_count == 2 and int(jm2.opt_state["step"]) == 2
    jl, _ = jm2.trainingstep(x, y)
    tl, _ = tm.trainingstep(tx, ty)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert_params_close(tm, jm2.params, what="resumed in jax")
    # and back: the port reads its own file with the same state
    tm2 = modelload(fname, device="cpu")
    assert tm2.optimiser.nesterov and int(tm2.opt_state["step"]) == 2


def test_opt_state_from_jax_carries_slots_and_step():
    jm = golden_net(jnm)
    jm.set_opt("AdaDelta")
    x, y = golden_batch(jm)
    for _ in range(3):
        jm.trainingstep(x, y)
    tm = golden_net(tnm)
    tm.set_params(params_from_jax(jm.params, tm))
    tm.set_opt("AdaDelta")
    opt_state_from_jax(jm.opt_state, tm)
    assert int(tm.opt_state["step"]) == 3
    jl, _ = jm.trainingstep(x, y)
    tl, _ = tm.trainingstep(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert_params_close(tm, jm.params, what="carried")
    with pytest.raises(ValueError, match="slot trees"):
        tm.set_opt("SGD")
        opt_state_from_jax(jm.opt_state, tm)


def jax_neuro3d(batch, patch, widths):
    """``scripts/bench_tpu_pending.py::_neuro3d_model`` (float32) with the
    conv widths as an argument."""
    from elektronn2_tpu.utils.cnncalculator import cnncalculator
    filters = [(1, 3, 3), (1, 3, 3), (3, 3, 3), (3, 3, 3)]
    pools = [(1, 2, 2), (1, 2, 2), (1, 1, 1), (1, 1, 1)]
    calc = cnncalculator(filters, pools, desired_patch_size=list(patch),
                         mfp=False, ndim=3)
    jnm.model_manager.reset(seed=0)
    inp = jnm.Input([batch, 1, *calc.input], "b,f,z,x,y", name="raw")
    h = inp
    for i, (f, p, nf) in enumerate(zip(filters, pools, widths)):
        h = jnm.Conv(h, nf, f, p, name=f"conv{i}")
    probs = jnm.Softmax(jnm.Conv(h, 2, 1, 1, activation_func="lin",
                                 name="cls"), name="probs")
    tgt = jnm.Input([batch, *probs.shape.spatial_shape], "b,z,x,y",
                    dtype="int32", name="target")
    nll = jnm.MultinoulliNLL(probs, tgt, target_is_sparse=True, name="nll")
    m = jnm.model_manager.getmodel("bench_neuro3d")
    m.designate_nodes(input_node=inp, target_node=tgt,
                      loss_node=jnm.AggregateLoss(nll),
                      prediction_node=probs)
    m.set_opt("Adam", lr=1e-3)
    return m


@pytest.mark.parametrize("which", ["narrow", "full_width"])
def test_neuro3d_train_model_step_matches_jax(which):
    if which == "narrow":
        batch, patch, widths = 2, (7, 30, 30), (4, 5, 6, 6)
        jm = jax_neuro3d(batch, patch, widths)
    else:
        # the bench's own builder at the full widths, a small patch
        from scripts.exp_train_largepatch import _model
        batch, patch, widths = 1, (5, 26, 26), None
        jm = _model(batch, patch, None)[0]
    tm = neuro3d_train_model(batch, patch, widths=widths, device="cpu")
    assert list(tm.nodes) == list(jm.nodes)
    for name, node in jm.nodes.items():
        assert tuple(tm.nodes[name].shape) == tuple(node.shape), name
    tm.set_params(params_from_jax(jm.params, tm))
    assert type(tm.optimiser).__name__ == "Adam"
    assert tm.optimiser.hyperparams == jm.optimiser.hyperparams
    rng = np.random.RandomState(4)
    x = rng.rand(batch, 1, *jm.input_node.shape.spatial_shape
                 ).astype(np.float32)
    y = (rng.rand(batch, *jm.prediction_node.shape.spatial_shape) > 0.5
         ).astype(np.int32)
    _, _, grads, _ = tm._loss_and_grads(
        tm._feed(torch.from_numpy(x), torch.from_numpy(y)), None)
    assert_grads_close(grads, jax_grads(jm, x, y))
    jl, _ = jm.trainingstep(x, y)
    tl, _ = tm.trainingstep(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert_params_close(tm, jm.params, what=which)


def test_class_weights_loss_unchanged_and_made_once():
    """MultinoulliNLL with class weights: the loss equals JAX's, and the
    weights become a tensor once per device, not on every forward."""
    cw = [0.3, 1.7]
    jm = golden_net(jnm, class_weights=cw)
    tm = port_twin(jm, golden_net, cw)
    x, y = golden_batch(jm)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(float(tm.loss(tx, ty)), float(jm.loss(x, y)),
                               rtol=LOSS_RTOL)
    nll = tm.nodes["nll"]
    (t1,) = nll._aux_tensors.values()
    jm.set_opt("Adam")
    tm.set_opt("Adam")
    jl, _ = jm.trainingstep(x, y)
    tl, _ = tm.trainingstep(tx, ty)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    (t2,) = nll._aux_tensors.values()
    assert t2 is t1


def test_eval_loss_and_test_error_match_jax():
    jm = golden_net(jnm)
    tm = port_twin(jm, golden_net)
    x, y = golden_batch(jm)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jl, je = jm.test_error(x, y)
    tl, te = tm.test_error(tx, ty)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert float(te) == pytest.approx(float(je), abs=1e-6)
    np.testing.assert_allclose(float(tm.loss(tx, ty)), float(jl),
                               rtol=LOSS_RTOL)


def test_snapshot_repair_and_paramstats():
    tm = golden_net(tnm)
    tm.set_opt("Adam", lr=1e-2)
    x, y = golden_batch(tm)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    tm.trainingstep(tx, ty)
    tm.snapshot_good()
    kept = {n: {p: v.clone() for p, v in d.items()}
            for n, d in tm.params.items()}
    live = {(n, p): v for n, d in tm.params.items() for p, v in d.items()}
    for _ in range(2):
        tm.trainingstep(tx, ty)
    assert not torch.equal(tm.params["c1"]["w"], kept["c1"]["w"])
    assert tm.repair_fuckup(lr_scale=0.5)
    for n, d in kept.items():
        for p, v in d.items():
            assert torch.equal(tm.params[n][p], v)
            assert tm.params[n][p] is live[(n, p)]   # same tensor, in place
    assert int(tm.opt_state["step"]) == 1
    assert tm.optimiser.hyperparams["lr"] == pytest.approx(5e-3)
    stats = tm.paramstats()
    assert set(stats) == {f"{n}/{p}" for n, d in tm.params.items()
                          for p in d}
    assert stats["c1/w"]["shape"] == (5, 1, 3, 3, 3)
    fresh = golden_net(tnm)
    assert fresh.repair_fuckup() is False


def test_untrainable_param_is_left_alone():
    """A parameter registered with trainable=False gets no update and no
    optimiser slot."""
    tm = golden_net(tnm)
    tm.nodes["c2"].param_flags["b"]["trainable"] = False
    tm.set_opt("SGD", lr=0.1)
    assert "b" not in tm.opt_state["slots"][0]["c2"]
    b0 = tm.params["c2"]["b"].clone()
    x, y = golden_batch(tm)
    tm.trainingstep(torch.from_numpy(x), torch.from_numpy(y))
    assert torch.equal(tm.params["c2"]["b"], b0)
    assert not torch.equal(tm.params["c2"]["w"],
                           golden_net(tnm).params["c2"]["w"])


def test_trainingstep_needs_a_loss_and_refuses_host_tensors_elsewhere():
    tm = golden_net(tnm)
    tm.loss_node = None
    x, y = golden_batch(tm)
    with pytest.raises(RuntimeError, match="loss_node"):
        tm.trainingstep(torch.from_numpy(x), torch.from_numpy(y))
    with pytest.raises(KeyError, match="unknown feed"):
        golden_net(tnm).trainingstep({"bogus": torch.from_numpy(x)})
