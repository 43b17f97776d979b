"""The skeleton losses and the tracing heads of the port against the JAX
package's, on the CPU: ``skel_loss_callback`` (the host KD-tree query as an
autograd function), the ``SkelLoss``, ``SkelLossField``, ``SkelPrior`` and
``SkelGetBatch`` nodes, a prelu head in the device rollout, and the fused
loops' refusal of a graph that syncs the host. Mirrors the skeleton-loss
tests of tests/test_tracing.py.

Tolerances: values and gradients of the same function rtol 1e-5 (atol
1e-6); trained losses rtol 1e-5 per step; the field against the host
query 0.6 (voxel quantisation of the field, as the JAX test); rollout
coordinates 1e-4.
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
from elektronn2_tpu.data import skeleton as jsk  # noqa: E402
from elektronn2_tpu.data.tracing_utils import DeviceTracer as JaxTracer  # noqa: E402
import elektronn2_tpu_torch.neuromancer as tnm  # noqa: E402
from elektronn2_tpu_torch.data import skeleton as tsk  # noqa: E402
from elektronn2_tpu_torch.data.tracing_utils import DeviceTracer  # noqa: E402
from elektronn2_tpu_torch.neuromancer.model import modelload  # noqa: E402
from elektronn2_tpu_torch.neuromancer.various import sample_fields  # noqa: E402
from elektronn2_tpu_torch.training.fused_loop import HostFedFusedLoop  # noqa: E402
from elektronn2_tpu_torch.utils.convert import (params_from_jax,  # noqa: E402
                                                tracer_model)

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6


def line_skeleton(mod, n=10, step=2.0):
    pos = np.stack([np.zeros(n), np.zeros(n), np.arange(n) * step],
                   axis=1) + 5.0
    return mod.SkeletonMFK(pos, [(i, i + 1) for i in range(n - 1)])


@pytest.fixture
def registries():
    """Both registries cleared before and after, with the same line."""
    for mod in (tsk, jsk):
        mod.clear_skeleton_registry()
    yield
    for mod in (tsk, jsk):
        mod.clear_skeleton_registry()


def test_skel_loss_value_and_gradient(registries):
    """Counterpart of the JAX test of that name, and against it."""
    sid = tsk.register_skeleton(line_skeleton(tsk, n=20, step=1.0))
    jsk.register_skeleton(line_skeleton(jsk, n=20, step=1.0))
    pos = np.array([[sid, 5.0, 5.0, 10.0], [sid, 5.0, 4.0, 13.3]],
                   np.float32)
    pred = np.array([[0.0, 2.0, 0.0], [0.7, -0.4, 1.1]], np.float32)
    p = torch.from_numpy(pred).requires_grad_()
    val = tsk.skel_loss_callback(p, torch.from_numpy(pos))
    assert abs(val[0].item() - 4.0) < 1e-5           # dist^2 = 2^2
    (g,) = torch.autograd.grad(val.sum(), p)
    np.testing.assert_allclose(g[0].numpy(), [0.0, 4.0, 0.0], atol=1e-5)

    def jloss(pr):
        return jnp.sum(jsk.skel_loss_callback(pr, jnp.asarray(pos)))
    np.testing.assert_allclose(val.sum().item(), float(jloss(pred)),
                               rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(jloss)(
        jnp.asarray(pred))), rtol=RTOL, atol=ATOL)


def skel_head(nm, fields=None, loss="callback", seed=2, batch=2):
    """A Perceptron step head on (batch, 8) features under SkelLoss or
    SkelLossField (with ``fields``), the skeleton rows a GenericInput."""
    nm.model_manager.reset(seed=seed)
    feat = nm.Input([batch, 8], "b,f", name="feat")
    skel = nm.GenericInput(name="skel")
    pred = nm.Perceptron(feat, 3, activation_func="lin", name="step")
    sl = (nm.SkelLoss(pred, skel, name="skel_loss") if loss == "callback"
          else nm.SkelLossField(pred, skel, fields, name="slf"))
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=feat, loss_node=nm.AggregateLoss(sl),
                      prediction_node=pred, extra_inputs=[skel])
    return m


def test_skel_loss_node_in_graph(registries):
    """Counterpart of the JAX test of that name: SkelLoss trains a head
    (the loss falls over 30 Adam steps), step for step as in JAX."""
    sid = tsk.register_skeleton(line_skeleton(tsk, n=20, step=1.0))
    jsk.register_skeleton(line_skeleton(jsk, n=20, step=1.0))
    jm, tm = skel_head(jnm), skel_head(tnm)
    tm.set_params(params_from_jax(jm.params, tm))
    jm.set_opt("Adam", lr=1e-2)
    tm.set_opt("Adam", lr=1e-2)
    x = np.random.RandomState(0).randn(2, 8).astype(np.float32)
    skel_feed = np.array([[sid, 5, 5, 10], [sid, 5, 5, 12]], np.float32)
    jl, tl = [], []
    for _ in range(30):
        jl.append(float(jm.trainingstep(x, None, extra=[skel_feed])[0]))
        tl.append(float(tm.trainingstep(torch.from_numpy(x), None,
                                        extra=[torch.from_numpy(skel_feed)])
                        [0]))
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=RTOL * jl[0])


def test_skel_prior_and_get_batch_match_jax():
    rng = np.random.RandomState(3)
    pred = rng.randn(5, 3).astype(np.float32)
    skel = rng.rand(5, 4).astype(np.float32)
    outs = []
    for nm in (jnm, tnm):
        nm.model_manager.reset(seed=1)
        p = nm.Input([5, 3], "b,f", name="pred")
        s = nm.GenericInput(name="skel")
        prior = nm.SkelPrior(p, target_length=1.5, name="prior")
        batch = nm.SkelGetBatch(s, [5, 4], "b,f", name="batch")
        m = nm.model_manager.getmodel()
        m.designate_nodes(input_node=p, prediction_node=prior,
                          extra_inputs=[s])
        feed = {"pred": pred, "skel": skel}
        if nm is tnm:
            feed = {k: torch.from_numpy(v) for k, v in feed.items()}
        outs.append([np.asarray(v) for v in m._apply(
            [prior, batch], m.params, m.state, feed, None, train=False)[0]])
        assert tuple(batch.shape) == (5, 4)
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def field_pair(fields, **kw):
    jm = skel_head(jnm, fields, loss="field", **kw)
    tm = skel_head(tnm, fields, loss="field", **kw)
    tm.set_params(params_from_jax(jm.params, tm))
    return jm, tm


def test_skel_loss_field_matches_callback_and_jax(registries):
    """Counterpart of ``test_skel_loss_field_matches_callback``: the field's
    values agree with the host query (0.6), with JAX's field exactly to
    float rounding (values and gradients), and the gradient pulls the
    landing point toward the skeleton."""
    sk = line_skeleton(tsk, n=40, step=0.5)
    sid = tsk.register_skeleton(sk)
    fields = tsk.skeleton_distance_field([sk], (32, 32, 32))
    np.testing.assert_array_equal(fields, jsk.skeleton_distance_field(
        [line_skeleton(jsk, n=40, step=0.5)], (32, 32, 32)))
    pos = np.array([[sid, 5.0, 5.0, 10.0], [sid, 5.0, 5.0, 14.5]],
                   np.float32)
    pred = np.array([[0.0, 2.0, 0.0], [1.5, 0.0, 0.0]], np.float32)
    host = tsk.skel_loss_callback(torch.from_numpy(pred),
                                  torch.from_numpy(pos)).numpy()
    jm, tm = field_pair(fields)
    outs, _ = tm._apply([tm.nodes["slf"]], tm.params, tm.state,
                        {"feat": torch.zeros(2, 8),
                         "skel": torch.from_numpy(pos)}, None, train=False)
    assert outs[0].shape == (2,)
    p = torch.from_numpy(pred).requires_grad_()
    v = sample_fields(tm.params["slf"]["fields"],
                      torch.zeros(2, dtype=torch.long),
                      torch.from_numpy(pos[:, 1:]) + p)
    (g,) = torch.autograd.grad(v.sum(), p)
    np.testing.assert_allclose(v.detach().numpy(), host, atol=0.6)
    jvals, jgrad = _jax_field(jm, pos, pred)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jvals),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jgrad), rtol=RTOL,
                               atol=ATOL)
    assert g[0, 1] > 2.0
    assert abs(g[0, 0]) <= 1.5 and abs(g[0, 2]) <= 1.5
    assert g[0, 1] > 2 * max(abs(g[0, 0]), abs(g[0, 2]))


def _jax_field(jm, pos, pred):
    """JAX's SkelLossField on ``pred`` as the step: values and gradient."""
    import elektronn2_tpu.neuromancer as nm
    nm.model_manager.reset(seed=40)
    p_in = nm.Input([2, 3], "b,f", name="pred")
    s_in = nm.GenericInput(name="skel")
    sl = nm.SkelLossField(p_in, s_in, np.asarray(jm.params["slf"]["fields"]),
                          name="slf")
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=p_in, prediction_node=sl,
                      extra_inputs=[s_in])

    def f(pr):
        return m._apply([sl], m.params, m.state,
                        {"pred": pr, "skel": jnp.asarray(pos)}, None,
                        train=False)[0][0]
    return f(jnp.asarray(pred)), jax.grad(lambda pr: jnp.sum(f(pr)))(
        jnp.asarray(pred))


def test_skel_loss_field_trains_like_jax():
    """Counterpart of ``test_skel_loss_field_trains_without_callbacks``: a
    head trained on SkelLossField halves its loss in 40 Adam steps, step
    for step as in JAX; its step holds no host query (a fused loop takes
    it: the eager chunk equals the sequential steps)."""
    sk = line_skeleton(tsk, n=40, step=0.5)
    fields = tsk.skeleton_distance_field([sk], (32, 32, 32))
    jm, tm = field_pair(fields, seed=41, batch=4)
    jm.set_opt("Adam", lr=5e-2)
    tm.set_opt("Adam", lr=5e-2)
    x = np.random.RandomState(5).randn(4, 8).astype(np.float32)
    skel_feed = np.array([[0, 5, 8, 10], [0, 5, 3, 12],
                          [0, 5, 5, 6], [0, 5, 7, 15]], np.float32)
    jl, tl = [], []
    for _ in range(40):
        jl.append(float(jm.trainingstep(x, None, extra=[skel_feed])[0]))
        tl.append(float(tm.trainingstep(torch.from_numpy(x), None,
                                        extra=[torch.from_numpy(skel_feed)])
                        [0]))
    assert tl[-1] < tl[0] * 0.5
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4 * jl[0])
    assert not any(getattr(n, "host_sync", False)
                   for n in tm.loss_node.all_parents())

    class Data:
        def getbatch(self, batch_size):
            return x, skel_feed

    _, tm2 = field_pair(fields, seed=41, batch=4)
    tm2.set_opt("Adam", lr=5e-2)
    tm2.designate_nodes(input_node=tm2.input_node, loss_node=tm2.loss_node,
                        prediction_node=tm2.prediction_node,
                        target_node=tm2.nodes["skel"])
    loop = HostFedFusedLoop(tm2, Data(), 4, 4, prefetch=False)
    losses, _ = loop.run_chunk()
    np.testing.assert_array_equal(losses, np.asarray(tl[:4], np.float32))


def test_skel_loss_field_roundtrip(tmp_path):
    """Counterpart of the JAX test of that name: the field (a non-trainable
    parameter) survives the port's save/load, and a JAX-saved one loads."""
    sk = line_skeleton(tsk, n=10, step=2.0)
    fields = tsk.skeleton_distance_field([sk], (16, 16, 16))
    jm, tm = field_pair(fields, seed=42, batch=1)
    feed = np.array([[0, 8.0, 8.0, 8.0]], np.float32)
    x = np.random.RandomState(1).randn(1, 8).astype(np.float32)
    f1, f2 = str(tmp_path / "jax.mdl"), str(tmp_path / "port.mdl")
    jm.save(f1)
    tm.save(f2)
    want = np.asarray(jm._apply([jm.loss_node], jm.params, jm.state,
                                {"feat": x, "skel": feed}, None,
                                train=False)[0][0])
    for path in (f1, f2):
        m = modelload(path, device="cpu")
        got = m.loss({"feat": torch.from_numpy(x),
                      "skel": torch.from_numpy(feed)})
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_fused_loop_refuses_skel_loss(registries):
    """SkelLoss queries the host in every step: a fused loop refuses to
    capture it, before any capture, naming SkelLossField."""
    tm = skel_head(tnm)
    tm.set_opt("Adam")
    loop = HostFedFusedLoop(tm, None, 2, 2, prefetch=False)
    with pytest.raises(NotImplementedError, match="SkelLossField"):
        loop._capture(tm.optimiser.current_hyper(tm.device))


def test_device_tracer_prelu_head():
    """Counterpart of ``test_device_tracer_prelu_head``: a prelu Perceptron
    between the GRU scan and the step head, rolled out on the device path
    (the port's ``tracer_model(prelu_w=...)``), equals JAX's rollout."""
    rng = np.random.RandomState(13)
    patch, T = (5, 5, 5), 3
    jnm.model_manager.reset(seed=13)
    seq = jnm.Input([T, 1, 1, *patch], "s,b,f,z,x,y", name="seq")
    x_t = jnm.Input([1, 1, *patch], "b,f,z,x,y", name="x_t")
    enc = jnm.Perceptron(x_t, 8, flatten=True, name="enc")
    h0 = jnm.InitialState_like(enc, override_f=8, name="h0")
    gru = jnm.GRU(enc, h0, n_f=8, name="gru")
    scan = jnm.ScanN(gru, in_memory=h0, in_iterate=x_t, in_iterate_0=seq,
                     n_steps=T, name="scan")
    mid = jnm.Perceptron(scan, 6, activation_func="prelu", name="mid")
    out = jnm.Perceptron(mid, 3, activation_func="lin", name="step")
    jm = jnm.model_manager.getmodel()
    jm.designate_nodes(input_node=seq, prediction_node=out)
    jm.params["step"]["b"] = jnp.asarray([0.3, 0.2, 0.1], np.float32)
    jm.params["mid"]["alpha"] = jnp.asarray(
        rng.uniform(0.05, 0.5, 6).astype(np.float32))
    tm = tracer_model(patch, enc_w=8, gru_w=8, batch=1, t=T, device="cpu",
                      prelu_w=6)
    tm.set_params(params_from_jax(jm.params, tm))
    vol = rng.rand(1, 26, 26, 26).astype(np.float32)
    seeds = rng.uniform(10, 16, (4, 3)).astype(np.float32)
    ref = JaxTracer(jm, vol, max_steps=4,
                    use_pallas_extract=False).trace_batch(seeds)
    got = DeviceTracer(tm, vol, max_steps=4).trace_batch(seeds)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(g.coords) == len(r.coords) == 5
        np.testing.assert_allclose(g.coords, r.coords, atol=1e-4)
