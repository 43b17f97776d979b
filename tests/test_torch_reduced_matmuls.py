"""The reduced-precision matmuls of Perceptron, GRU and LSTM
(``Model.set_compute_dtype('bfloat16' | 'float16')``) against the JAX
package's at the same mode, on the CPU.

Each graph is built in the JAX package, saved and replayed by the port's
``modelload``, so both hold the same weights; inputs are numpy-seeded.
Under a reduced type both packages round the operands and the product to
it, and differ only in the order of the float32 sums inside the matmul,
which moves a product by at most one unit of the type's last place: the
outputs are held within 1e-2 of the output's largest magnitude, a training
step's loss within 2e-2 relative (the losses square the outputs). At float32
the port's outputs are bit for bit the plain ``torch.matmul`` formulas the
nodes computed before the reduced types existed. The tracer's rollout stays
float32 under any model dtype, as in the JAX package.
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
from elektronn2_tpu.data.tracing_utils import \
    DeviceTracer as JaxTracer  # noqa: E402
from elektronn2_tpu_torch.data.tracing_utils import DeviceTracer  # noqa: E402
from elektronn2_tpu_torch.neuromancer.model import modelload  # noqa: E402
from scripts.exp_tracer_rollout import build_model  # noqa: E402

torch.set_num_threads(1)
OUT_RTOL = 1e-2
LOSS_RTOL = 2e-2
MODES = ("bfloat16", "float16")


def dot_flat(nm):
    inp = nm.Input([2, 2, 3, 3, 3], "b,f,z,x,y", name="raw")
    h = nm.Perceptron(inp, 6, flatten=True, name="d1")
    out = nm.Perceptron(h, 3, activation_func="lin", name="d2")
    return inp, out, [2, 3], "b,f"


def dot_last(nm):
    inp = nm.Input([3, 2, 6], "s,b,f", name="raw")
    h = nm.Perceptron(inp, 5, name="d1")
    out = nm.Perceptron(h, 3, activation_func="lin", name="d2")
    return inp, out, [3, 2, 3], "s,b,f"


def dot_feature_axis(nm):
    # the feature axis is not last: the ``ops.conv.dot`` route
    inp = nm.Input([2, 4, 2, 3, 3], "b,f,z,x,y", name="raw")
    h = nm.Perceptron(inp, 5, name="d1")
    out = nm.Perceptron(h, 3, activation_func="lin", name="d2")
    return inp, out, [2, 3, 2, 3, 3], "b,f,z,x,y"


def lstm_scan(nm):
    T, B, p = 3, 2, (3, 3, 3)
    seq = nm.Input([T, B, 1, *p], "s,b,f,z,x,y", name="seq")
    x_t = nm.Input([B, 1, *p], "b,f,z,x,y", name="x_t")
    enc = nm.Perceptron(x_t, 5, flatten=True, activation_func="tanh",
                        name="enc")
    hc0 = nm.InitialState_like(enc, override_f=8, name="hc0")
    cell = nm.LSTM(enc, hc0, n_f=4, name="lstm")
    scan = nm.ScanN(cell, in_memory=hc0, in_iterate=x_t, in_iterate_0=seq,
                    name="scan")
    h, _ = nm.split(scan, "f", n_out=2, name="hc")
    out = nm.Perceptron(h, 3, activation_func="lin", name="step")
    return seq, out, [T, B, 3], "s,b,f"


def designed(nm, builder, seed):
    nm.model_manager.reset(seed=seed)
    inp, out, tshape, ttags = builder(nm)
    tgt = nm.Input(tshape, ttags, name="target")
    loss = nm.AggregateLoss(nm.SquaredLoss(out, tgt), name="loss")
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=out)
    return m


def gru_scan(seed):
    """The tracing deployment's model (Perceptron -> GRU through ScanN ->
    step head), at a small size."""
    jnm.model_manager.reset(seed=seed)
    return build_model((3, 3, 3), enc_w=8, gru_w=6, batch=2, t=3)


def randomise(jm, seed):
    rng = np.random.RandomState(seed)
    for d in jm.params.values():
        for k, v in d.items():
            d[k] = jnp.asarray(rng.randn(*v.shape).astype(np.float32) * 0.5)


def pair(name, tmp_path, seed=3):
    """(JAX model, the port's replay of it, input, target)."""
    jm = gru_scan(seed) if name == "gru_scan" else designed(
        jnm, BUILDERS[name], seed)
    randomise(jm, seed)
    path = str(tmp_path / f"{name}.mdl")
    jm.save(path)
    tm = modelload(path, device="cpu")
    rng = np.random.RandomState(seed + 1)
    x = rng.rand(*jm.input_node.shape.shape).astype(np.float32)
    t = rng.randn(*jm.target_node.shape.shape).astype(np.float32)
    return jm, tm, x, t


BUILDERS = {"dot_flat": dot_flat, "dot_last": dot_last,
            "dot_feature_axis": dot_feature_axis, "lstm_scan": lstm_scan}
CASES = ("dot_flat", "dot_last", "dot_feature_axis", "gru_scan", "lstm_scan")


def assert_rel_close(got, want, rtol):
    scale = float(np.abs(want).max())
    assert scale > 0
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES)
def test_forward_and_a_step_match_jax(case, mode, tmp_path):
    jm, tm, x, t = pair(case, tmp_path)
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    f32 = tm.predict(tx)
    jm.set_compute_dtype(mode)
    tm.set_compute_dtype(mode)
    got = tm.predict(tx)
    assert got.dtype == torch.float32
    assert not torch.equal(got, f32)          # the mode reached the matmuls
    assert_rel_close(got.numpy(), np.asarray(jm.predict(x)), OUT_RTOL)
    for m in (jm, tm):
        m.set_opt("SGD", lr=0.05)
    jl = float(jm.trainingstep(x, t)[0])
    tl = float(tm.trainingstep(tx, tt)[0])
    assert np.isfinite(tl)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert_rel_close(tm.predict(tx).numpy(), np.asarray(jm.predict(x)),
                     OUT_RTOL)


def _manual_dot(x, w, b, act, flatten=False, f_ax=None):
    """A Perceptron as it computed before the reduced types: one float32
    ``torch.matmul``, then the bias and the activation."""
    if flatten:
        x = x.reshape(x.shape[0], -1)
    if x.ndim == 2 or f_ax == x.ndim - 1:
        y = torch.matmul(x, w) + b
    else:
        y = torch.movedim(torch.matmul(torch.movedim(x, f_ax, -1), w), -1,
                          f_ax) + b.reshape((1,) * f_ax + (-1,)
                                            + (1,) * (x.ndim - f_ax - 1))
    return torch.relu(y) if act == "relu" else y


@pytest.mark.parametrize("case", ["dot_flat", "dot_last",
                                  "dot_feature_axis"])
def test_float32_perceptron_unchanged(case, tmp_path):
    _, tm, x, _ = pair(case, tmp_path)
    p = tm.params
    tx = torch.from_numpy(x)
    kw = dict(flatten=case == "dot_flat",
              f_ax=tm.nodes["raw"].shape.tag2index("f"))
    with torch.no_grad():
        h = _manual_dot(tx, p["d1"]["w"], p["d1"]["b"], "relu", **kw)
        want = _manual_dot(h, p["d2"]["w"], p["d2"]["b"], "lin",
                           f_ax=kw["f_ax"] if case != "dot_flat" else None)
    tm.set_compute_dtype("bfloat16")
    tm.set_compute_dtype("float32")
    assert torch.equal(tm.predict(tx), want)


def cell_model(nm, kind):
    nm.model_manager.reset(seed=9)
    x = nm.Input([2, 5], "b,f", name="x")
    state = nm.Input([2, 8 if kind == "lstm" else 4], "b,f", name="state")
    cell = (nm.LSTM(x, state, n_f=4, name="cell") if kind == "lstm"
            else nm.GRU(x, state, n_f=4, name="cell"))
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=x, prediction_node=cell,
                      extra_inputs=[state])
    return m


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_float32_cells_unchanged_and_state_float32(kind):
    """At float32 a GRU/LSTM step is bit for bit the plain formulas; under
    bf16 its output (the new state) is float32 within the type's rounding,
    and equals the JAX cell's at the same mode."""
    tm = cell_model(tnm, kind)
    tm.to("cpu")
    rng = np.random.RandomState(10)
    x = torch.from_numpy(rng.randn(2, 5).astype(np.float32))
    s = torch.from_numpy(rng.randn(*tm.nodes["state"].shape.shape).astype(
        np.float32))
    p = tm.params["cell"]
    with torch.no_grad():
        if kind == "gru":
            g = torch.sigmoid(torch.matmul(torch.cat([x, s], -1),
                                           p["w_gates"]) + p["b_gates"])
            z, r = torch.chunk(g, 2, -1)
            c = torch.tanh(torch.matmul(torch.cat([x, r * s], -1),
                                        p["w_cand"]) + p["b_cand"])
            want = (1.0 - z) * s + z * c
        else:
            h, c = torch.chunk(s, 2, -1)
            zz = torch.matmul(torch.cat([x, h], -1), p["w"]) + p["b"]
            i, f, gg, o = torch.chunk(zz, 4, -1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            want = torch.cat([torch.sigmoid(o) * torch.tanh(c_new), c_new],
                             -1)
    assert torch.equal(tm.predict(x, extra=[s]), want)
    jm = cell_model(jnm, kind)
    for k, v in p.items():
        jm.params["cell"][k] = jnp.asarray(v.numpy())
    for mode in MODES:
        tm.set_compute_dtype(mode)
        jm.set_compute_dtype(mode)
        got = tm.predict(x, extra=[s])
        assert got.dtype == torch.float32 and not torch.equal(got, want)
        assert_rel_close(got.numpy(), np.asarray(
            jm.predict(x.numpy(), extra=[s.numpy()])), OUT_RTOL)


def test_set_compute_dtype_takes_every_node():
    m = designed(tnm, lstm_scan, seed=2)
    for mode in ("bfloat16", "float16", "int8", None):
        m.set_compute_dtype(mode)
        assert m._compute_dtype == mode


def test_tracer_rollout_stays_float32_under_any_dtype(tmp_path):
    """A bf16-set (or float16-set) tracer model's ``trace_batch`` is bit for
    bit its float32 rollout, and the rollout graph's key does not change
    (the rollout ignores the model's dtype, as the JAX package's does);
    the JAX tracer of the bf16-set JAX model agrees with it."""
    jm, tm, _, _ = pair("gru_scan", tmp_path, seed=5)
    rng = np.random.RandomState(6)
    vol = rng.rand(1, 20, 20, 20).astype(np.float32)
    seeds = rng.uniform(8, 12, (4, 3)).astype(np.float32)
    dt = DeviceTracer(tm, vol, max_steps=5)
    key = dt.graph_key(tm.params, len(seeds))
    ref = dt.trace_batch(seeds)
    for mode in MODES:
        tm.set_compute_dtype(mode)
        assert dt.graph_key(tm.params, len(seeds)) == key
        for a, b in zip(dt.trace_batch(seeds), ref):
            np.testing.assert_array_equal(a.coords, b.coords)
        for a, b in zip(DeviceTracer(tm, vol, max_steps=5).trace_batch(
                seeds), ref):
            np.testing.assert_array_equal(a.coords, b.coords)
    jm.set_compute_dtype("bfloat16")
    jref = JaxTracer(jm, vol, max_steps=5,
                     use_pallas_extract=False).trace_batch(seeds)
    for a, b in zip(ref, jref):
        np.testing.assert_allclose(a.coords, b.coords, atol=1e-4)
