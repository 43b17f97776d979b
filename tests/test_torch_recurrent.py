"""The recurrent nodes of the port against the JAX package.

Perceptron, GRU, LSTM, ScanN, InitialState_like, Split/split, SquaredLoss and
``ops.conv.dot``: the same graph is built in both packages, or built in the
JAX package, saved with ``Model.save`` and replayed by the port's
``modelload``; both get the same weights and numpy-seeded inputs. Tolerance
atol 1e-5: float32 matmul sums taken in another order by XLA and PyTorch.
"""

import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import elektronn2_tpu.neuromancer as jnm  # noqa: E402
import elektronn2_tpu_torch.neuromancer as tnm  # noqa: E402
from elektronn2_tpu.ops.conv import dot as jax_dot  # noqa: E402
from elektronn2_tpu_torch.neuromancer.model import modelload  # noqa: E402
from elektronn2_tpu_torch.ops.conv import dot, f32_matmuls  # noqa: E402
from elektronn2_tpu_torch.utils.convert import (params_from_jax,  # noqa: E402
                                                tracer_model)
from scripts.exp_tracer_rollout import build_model  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-5


def _randomise(jax_model, seed):
    """Replace every JAX parameter by numpy-seeded values (state0 included,
    which starts at zero)."""
    rng = np.random.RandomState(seed)
    for d in jax_model.params.values():
        for k, v in d.items():
            d[k] = jnp.asarray(rng.randn(*v.shape).astype(np.float32) * 0.3)


def _replay(jax_model, tmp_path):
    path = str(tmp_path / "model.mdl")
    jax_model.save(path)
    return modelload(path, device="cpu")


def _predict_both(jm, tm, x):
    ref = np.asarray(jm.predict(x))
    got = tm.predict(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    return got, ref


def test_tracer_model_mdl_replay_matches_jax(tmp_path):
    """The tracing model saved by the JAX package (its ScanN spec holds node
    lists) replays in the port with the same nodes, parameters and
    predictions."""
    jm = build_model((4, 4, 4), enc_w=8, gru_w=6, batch=2, t=3)
    _randomise(jm, 0)
    tm = _replay(jm, tmp_path)
    assert list(tm.nodes) == list(jm.nodes)
    assert type(tm.nodes["scan"]).__name__ == "ScanN"
    assert [n.name for n in tm.nodes["scan"].in_memory] == ["h0"]
    for n, d in jm.params.items():
        for k, v in d.items():
            np.testing.assert_array_equal(tm.params[n][k].numpy(),
                                          np.asarray(v))
    x = np.random.RandomState(1).rand(3, 2, 1, 4, 4, 4).astype(np.float32)
    got, ref = _predict_both(jm, tm, x)
    assert got.shape == (3, 2, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_tracer_model_matches_jax_build_model_layouts():
    """``tracer_model`` has ``build_model``'s node names and parameter
    layouts, so ``params_from_jax`` is a plain copy; the predictions agree."""
    jm = build_model((4, 4, 4), enc_w=8, gru_w=6, batch=2, t=3)
    _randomise(jm, 2)
    tm = tracer_model((4, 4, 4), enc_w=8, gru_w=6, batch=2, t=3,
                      device="cpu")
    assert list(tm.nodes) == list(jm.nodes)
    shapes = {n: {k: tuple(v.shape) for k, v in d.items()}
              for n, d in tm.params.items()}
    assert shapes == {"enc": {"w": (64, 8), "b": (8,)},
                      "h0": {"state0": (1, 6)},
                      "gru": {"w_gates": (14, 12), "b_gates": (12,),
                              "w_cand": (14, 6), "b_cand": (6,)},
                      "step": {"w": (6, 3), "b": (3,)}}
    tm.set_params(params_from_jax(jm.params, tm))
    x = np.random.RandomState(3).rand(3, 2, 1, 4, 4, 4).astype(np.float32)
    got, ref = _predict_both(jm, tm, x)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("last_only", [False, True])
def test_lstm_scan_split_matches_jax(tmp_path, last_only):
    """LSTM iterated by ScanN, its [h, c] output split by ``split``."""
    T, B, p = 3, 2, (3, 3, 3)
    jnm.model_manager.reset(seed=4)
    seq = jnm.Input([T, B, 1, *p], "s,b,f,z,x,y", name="seq")
    x_t = jnm.Input([B, 1, *p], "b,f,z,x,y", name="x_t")
    enc = jnm.Perceptron(x_t, 5, flatten=True, activation_func="tanh",
                         name="enc")
    hc0 = jnm.InitialState_like(enc, override_f=8, name="hc0")
    cell = jnm.LSTM(enc, hc0, n_f=4, name="lstm")
    scan = jnm.ScanN(cell, in_memory=hc0, in_iterate=x_t, in_iterate_0=seq,
                     last_only=last_only, name="scan")
    h, _ = jnm.split(scan, "f", n_out=2, name="hc")
    out = jnm.Perceptron(h, 3, activation_func="lin", name="step")
    jm = jnm.model_manager.getmodel("lstm_tracer")
    jm.designate_nodes(input_node=seq, prediction_node=out)
    _randomise(jm, 5)
    tm = _replay(jm, tmp_path)
    x = np.random.RandomState(6).rand(T, B, 1, *p).astype(np.float32)
    got, ref = _predict_both(jm, tm, x)
    assert got.shape == ((B, 3) if last_only else (T, B, 3))
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("flatten, act", [
    (True, "relu"), (True, "lin"), (False, "relu"), (False, "tanh"),
    (False, "maxout:2"),
])
def test_perceptron_forms_match_jax(tmp_path, flatten, act):
    """Perceptron flattened (an MLP head) and per position (features on a
    non-last axis, through ``ops.conv.dot``), maxout included."""
    jnm.model_manager.reset(seed=7)
    inp = jnm.Input([2, 3, 4, 5, 6], "b,f,z,x,y", name="x")
    out = jnm.Perceptron(inp, 6, activation_func=act, flatten=flatten,
                         name="dense")
    jm = jnm.model_manager.getmodel("perceptron")
    jm.designate_nodes(input_node=inp, prediction_node=out)
    _randomise(jm, 8)
    tm = _replay(jm, tmp_path)
    assert tuple(tm.nodes["dense"].shape) == tuple(out.shape)
    x = np.random.RandomState(9).randn(2, 3, 4, 5, 6).astype(np.float32)
    got, ref = _predict_both(jm, tm, x)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_initial_state_fed_override_matches_jax(tmp_path):
    """A value fed under the InitialState_like's name replaces state0."""
    jm = build_model((3, 3, 3), enc_w=5, gru_w=4, batch=2, t=2)
    _randomise(jm, 10)
    tm = _replay(jm, tmp_path)
    rng = np.random.RandomState(11)
    x = rng.rand(2, 2, 1, 3, 3, 3).astype(np.float32)
    h = rng.randn(2, 4).astype(np.float32)
    ref, _ = jm._apply([jm.prediction_node], jm.params, jm.state,
                       {"seq": jnp.asarray(x), "h0": jnp.asarray(h)}, None,
                       False)
    got, _ = tm._apply([tm.prediction_node], tm.params, tm.state,
                       {"seq": torch.from_numpy(x), "h0": torch.from_numpy(h)},
                       None, False)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=ATOL)
    plain = tm.predict(torch.from_numpy(x)).numpy()
    assert np.abs(got[0].numpy() - plain).max() > 1e-3   # it did override


@pytest.mark.parametrize("strip", [False, True])
def test_split_matches_jax(tmp_path, strip):
    jnm.model_manager.reset(seed=12)
    inp = jnm.Input([2, 3, 4], "b,f,x", name="x")
    parts = jnm.split(inp, "f", index=[1], strip_singleton_dims=strip,
                      name="part")
    out = jnm.Perceptron(parts[1], 2, activation_func="lin", name="dense")
    jm = jnm.model_manager.getmodel("split")
    jm.designate_nodes(input_node=inp, prediction_node=out,
                       debug_outputs=[parts[0]])
    _randomise(jm, 13)
    tm = _replay(jm, tmp_path)
    assert tuple(tm.nodes["part0"].shape) == tuple(parts[0].shape)
    x = np.random.RandomState(14).randn(2, 3, 4).astype(np.float32)
    got, ref = _predict_both(jm, tm, x)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    (a,), _ = tm._apply([tm.nodes["part0"]], tm.params, {},
                        {"x": torch.from_numpy(x)}, None, False)
    np.testing.assert_array_equal(a.numpy(),
                                  x[:, 0] if strip else x[:, :1])


@pytest.mark.parametrize("margin", [None, 0.3])
def test_squared_loss_matches_jax(tmp_path, margin):
    T, B = 3, 2
    jnm.model_manager.reset(seed=15)
    pred = jnm.Input([T, B, 3], "s,b,f", name="pred")
    tgt = jnm.Input([T, B, 3], "s,b,f", name="target")
    sq = jnm.SquaredLoss(pred, tgt, margin=margin, name="sq")
    loss = jnm.AggregateLoss(sq, name="loss")
    jm = jnm.model_manager.getmodel("sq")
    jm.designate_nodes(input_node=pred, target_node=tgt, loss_node=loss,
                       prediction_node=sq)
    tm = _replay(jm, tmp_path)
    rng = np.random.RandomState(16)
    feed = {"pred": rng.randn(T, B, 3).astype(np.float32),
            "target": rng.randn(T, B, 3).astype(np.float32)}
    ref, _ = jm._apply([sq, loss], jm.params, jm.state,
                       {k: jnp.asarray(v) for k, v in feed.items()}, None,
                       False)
    got, _ = tm._apply([tm.nodes["sq"], tm.nodes["loss"]], tm.params, {},
                       {k: torch.from_numpy(v) for k, v in feed.items()},
                       None, False)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)


@pytest.mark.parametrize("shape, axis", [((2, 3, 4, 5), 1), ((3, 2, 4), 2),
                                         ((4, 3), 1), ((2, 3, 4, 5), 0)])
def test_dot_matches_jax(shape, axis):
    rng = np.random.RandomState(17)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(shape[axis], 7).astype(np.float32)
    got = dot(torch.from_numpy(x), torch.from_numpy(w), axis=axis).numpy()
    ref = np.asarray(jax_dot(jnp.asarray(x), jnp.asarray(w), axis=axis))
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("kw", [dict(batch_normalisation=True),
                                dict(dropout_rate=0.5),
                                dict(activation_func="prelu")])
def test_perceptron_unported_options_raise(kw):
    # these options are ported now (tests/test_torch_train_nodes.py holds
    # them against the JAX package): each builds, with the JAX package's
    # parameters, and no option of Perceptron raises any more
    tnm.model_manager.reset()
    jnm.model_manager.reset()
    t = tnm.Perceptron(tnm.Input([2, 3], "b,f", name="x"), 4, **kw)
    j = jnm.Perceptron(jnm.Input([2, 3], "b,f", name="x"), 4, **kw)
    assert sorted(t.params) == sorted(j.params)
    assert t.dropout_rate == j.dropout_rate
    assert t.batch_normalisation == j.batch_normalisation


def test_scan_rejects_sequence_of_wrong_length():
    tm = tracer_model((3, 3, 3), enc_w=4, gru_w=4, batch=1, t=3,
                      device="cpu")
    with pytest.raises(ValueError, match="expects 3 on axis 0"):
        tm.predict(torch.rand(2, 1, 1, 3, 3, 3))


def test_f32_matmuls_pins_and_restores():
    """TF32 in cuBLAS is off inside the context, and the previous setting
    comes back after it, through whichever API this PyTorch has."""
    mm = torch.backends.cuda.matmul
    attr = "fp32_precision" if hasattr(torch.backends, "fp32_precision") \
        else "allow_tf32"
    on = "tf32" if attr == "fp32_precision" else True
    prev = getattr(mm, attr)
    setattr(mm, attr, on)
    try:
        with f32_matmuls():
            assert getattr(mm, attr) in ("ieee", False)
        assert getattr(mm, attr) == on
    finally:
        setattr(mm, attr, prev)
