"""The tracing trainer of the port against the JAX package, on the CPU.

Covers ``data/skeleton.py`` (``SkeletonMFK``, ``sample_tracing_batch``,
``skeleton_distance_field``), ``data/cnndata.py::AgentData``,
``training/trainer.py::TracingTrainer`` / ``TracingTrainerRNN`` and the
fused truncated-BPTT carry of ``training/fused_loop.py::HostFedFusedLoop``;
mirrors tests/test_tracing.py, tests/test_data.py and
tests/test_training.py. The host skeleton code is a copy: its results equal
the JAX package's exactly on the same ``RandomState``. The trainers start
from the same ``.mdl`` (saved by the JAX package) and draw the same batches
(equal ``RandomState``s, ``n_workers=0``); their per-step losses agree
within ``LOSS_RTOL`` (rtol 1e-5, the float32 sums of the GRU and its
gradients in another order, as in test_torch_trainer.py) and the carried
hidden states within 1e-5. The port's fused carry equals its own per-step
carry exactly (the same operations, eagerly).
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import elektronn2_tpu.neuromancer as jnm
from elektronn2_tpu.data import skeleton as jsk
from elektronn2_tpu.data.cnndata import AgentData as JaxAgentData
from elektronn2_tpu.training.fused_loop import \
    HostFedFusedLoop as JaxHostFedFusedLoop
from elektronn2_tpu.training.trainer import TracingTrainer as JaxTT
from elektronn2_tpu.training.trainer import TracingTrainerRNN as JaxTTRNN
from elektronn2_tpu_torch.data import SkeletonMFK
from elektronn2_tpu_torch.data import skeleton as tsk
from elektronn2_tpu_torch.data.cnndata import AgentData
from elektronn2_tpu_torch.neuromancer.model import modelload
from elektronn2_tpu_torch.scripts import train as train_cli
from elektronn2_tpu_torch.training.fused_loop import HostFedFusedLoop
from elektronn2_tpu_torch.training.trainer import (TracingTrainer,
                                                   TracingTrainerRNN)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACING3D = os.path.join(REPO, "examples", "tracing3d.py")
LOSS_RTOL = 1e-5
CARRY_ATOL = 1e-5


def _line(cls, n=15, step=1.5):
    pos = np.stack([np.zeros(n), np.zeros(n), np.arange(n) * step],
                   axis=1) + 5.0
    return cls(pos, [(i, i + 1) for i in range(n - 1)])


def _helix(cls, n=20, shift=0.0):
    t = np.linspace(0, 2 * np.pi, n)
    pos = np.stack([16 + 6 * np.cos(t), 16 + 6 * np.sin(t),
                    np.linspace(10, 22, n)], 1) + shift
    return cls(pos, [(i, i + 1) for i in range(n - 1)])


def _agent_data(cls, sk_cls, vols, skeletons, seed=3, patch=(5, 5, 5),
                **kw):
    ad = cls(input_data=[v.copy() for v in vols],
             target_data=[(v[0] > 0.5).astype(np.int16) for v in vols], **kw)
    ad.set_geometry(patch)
    ad.skeletons = [sk_cls(s.positions, s.edges) for s in skeletons]
    ad.rng = np.random.RandomState(seed)
    return ad


def _pair(vols, skeletons, **kw):
    return (_agent_data(JaxAgentData, jsk.SkeletonMFK, vols, skeletons, **kw),
            _agent_data(AgentData, SkeletonMFK, vols, skeletons, **kw))


def assert_losses_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL,
                               atol=LOSS_RTOL * abs(want[0]))


# ------------------------------------------------------------ skeletons

def test_skeleton_mfk_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    pos = rng.uniform(0, 30, (25, 3))
    edges = [(i, i + 1) for i in range(24)] + [(3, 12), (7, 20)]
    mine, ref = SkeletonMFK(pos, edges), jsk.SkeletonMFK(pos, edges)
    assert repr(mine) == repr(ref)
    for q in rng.uniform(-2, 32, (10, 3)):
        assert mine.get_closest_node(q) == ref.get_closest_node(q)
        for h in (None, rng.randn(3)):
            for la in (1, 2, 4):
                np.testing.assert_array_equal(
                    mine.direction_target(q, lookahead=la, heading=h),
                    ref.direction_target(q, lookahead=la, heading=h))
    qs = rng.uniform(0, 30, (7, 3))
    np.testing.assert_array_equal(mine.distance_to_skeleton(qs),
                                  ref.distance_to_skeleton(qs))
    for i in range(len(pos)):
        np.testing.assert_array_equal(mine.local_frame(i), ref.local_frame(i))
    r1, r2 = np.random.RandomState(4), np.random.RandomState(4)
    for _ in range(5):
        start = mine.sample_node(r1)
        assert start == ref.sample_node(r2)
        assert mine.walk(start, 9, r1) == ref.walk(start, 9, r2)
    # files written by one package load in the other, exactly
    for ext in ("npz", "nml", "k.zip"):
        for a, b in ((mine, jsk.SkeletonMFK), (ref, SkeletonMFK)):
            path = a.save(str(tmp_path / f"s-{type(a).__module__[:14]}.{ext}"))
            back = b.load(path)
            np.testing.assert_array_equal(back.positions, pos)
            np.testing.assert_array_equal(back.edges, np.asarray(edges))
    kz = mine.to_kzip(str(tmp_path / "forced.zip"))
    np.testing.assert_array_equal(jsk.SkeletonMFK.load(kz).positions, pos)


def test_skeleton_direction_target_endpoint_and_line():
    """The JAX tests' line skeleton: the heading picks the continuation and
    an endpoint does not bounce back."""
    sk, jref = _line(SkeletonMFK, n=10, step=2.0), _line(jsk.SkeletonMFK,
                                                         n=10, step=2.0)
    for h in ([0.0, 0.0, 1.0], [0.0, 0.0, -1.0], None):
        v = sk.direction_target([5.0, 5.0, 8.0], lookahead=2, heading=h)
        np.testing.assert_array_equal(
            v, jref.direction_target([5.0, 5.0, 8.0], lookahead=2,
                                     heading=h))
    assert sk.direction_target([5.0, 5.0, 8.0], heading=[0, 0, 1])[2] > 0.9
    end = sk.positions[-1]
    np.testing.assert_array_equal(sk.direction_target(end),
                                  jref.direction_target(end))
    np.testing.assert_allclose(sk.local_frame(3) @ sk.local_frame(3).T,
                               np.eye(3), atol=1e-9)


def test_skeleton_distance_field_matches_jax():
    sks = [_helix(SkeletonMFK), _line(SkeletonMFK)]
    jsks = [_helix(jsk.SkeletonMFK), _line(jsk.SkeletonMFK)]
    shape = (24, 26, 30)
    mine = tsk.skeleton_distance_field(sks, shape, oversample=1.5)
    ref = jsk.skeleton_distance_field(jsks, shape, oversample=1.5)
    assert mine.shape == (2, *shape) and mine.dtype == np.float32
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("fn", ["skel_loss_callback", "register_skeleton",
                                "clear_skeleton_registry"])
def test_skeleton_loss_helpers_raise_naming_item_2(fn):
    # the helpers are ported now (they raised while item 2 was open): each
    # does what the JAX package's does, with the same registry ids
    sks = [_line(SkeletonMFK), _line(jsk.SkeletonMFK)]
    for mod, sk in zip((tsk, jsk), sks):
        mod.clear_skeleton_registry()
        assert mod.register_skeleton(sk) == 0
    if fn == "register_skeleton":
        assert [m.register_skeleton(sk) for m, sk in
                zip((tsk, jsk), sks)] == [1, 1]
    elif fn == "clear_skeleton_registry":
        tsk.clear_skeleton_registry()
        assert tsk._SKELETON_REGISTRY == []
    else:
        feed = np.array([[0, 5.0, 7.0, 2.0], [0, 5.0, 6.5, 4.0]], np.float32)
        pred = np.array([[0.5, 1.0, 0.0], [0.0, -2.0, 1.0]], np.float32)
        got = tsk.skel_loss_callback(torch.from_numpy(pred),
                                     torch.from_numpy(feed))
        ref = jsk.skel_loss_callback(jnp.asarray(pred), jnp.asarray(feed))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    for mod in (tsk, jsk):
        mod.clear_skeleton_registry()


# ------------------------------------------------------------ AgentData

@pytest.mark.parametrize("rotate", [False, True])
def test_sample_tracing_batch_matches_jax(rotate):
    """The same draws from equal RandomStates: equal patch sequences and
    targets (axis-aligned views with world targets, or frame-aligned views
    with local targets)."""
    rng = np.random.RandomState(1)
    vols = [rng.rand(1, 32, 32, 32).astype(np.float32)]
    jad, ad = _pair(vols, [_helix(SkeletonMFK)], rotate_to_heading=rotate)
    for _ in range(2):
        d, t = ad.get_tracing_batch(batch_size=3, n_steps=4)
        jd, jt = jad.get_tracing_batch(batch_size=3, n_steps=4)
        assert d.shape == (4, 3, 1, 5, 5, 5) and t.shape == (4, 3, 3)
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(t, jt)
    np.testing.assert_allclose(np.linalg.norm(t, axis=-1), 1.0, atol=1e-6)


def test_sample_tracing_batch_rotated_straight_line(rng):
    """tests/test_tracing.py:903, with its draws: a straight flight's local
    target is straight ahead after the first hop, as in the JAX sampler."""
    vols = [rng.rand(1, 32, 32, 32).astype(np.float32)]
    n = 15
    posn = np.stack([np.full(n, 16.0), np.full(n, 16.0),
                     5.0 + np.arange(n) * 1.5], axis=1)
    sk = SkeletonMFK(posn, [(i, i + 1) for i in range(n - 1)])
    jad, ad = _pair(vols, [sk], rotate_to_heading=True)
    state = rng.get_state()
    seq_d, seq_t = tsk.sample_tracing_batch(ad, 3, 4, rng)
    rng.set_state(state)
    jd, jt = jsk.sample_tracing_batch(jad, 3, 4, rng)
    np.testing.assert_array_equal(seq_d, jd)
    np.testing.assert_array_equal(seq_t, jt)
    for t in range(1, 4):
        np.testing.assert_allclose(seq_t[t], np.tile([1.0, 0.0, 0.0],
                                                     (3, 1)), atol=1e-6)


def test_agentdata_skeleton_cube_pairing_matches_jax():
    """tests/test_data.py:676 and :699: ambiguous pairings raise; an
    explicit ``skeleton_cube`` draws from the right cube of each source."""
    rng = np.random.RandomState(5)
    vols = [rng.rand(1, 32, 32, 32).astype(np.float32) for _ in range(3)]
    jad, ad = _pair(vols, [_helix(SkeletonMFK)], patch=(7, 7, 7))
    for a in (ad, jad):
        with pytest.raises(ValueError, match="skeleton_cube"):
            a.get_tracing_batch(batch_size=1, n_steps=2)
        a.skeleton_cube = [2]
    d, t = ad.get_tracing_batch(batch_size=2, n_steps=2)
    jd, jt = jad.get_tracing_batch(batch_size=2, n_steps=2)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(t, jt)
    for a in (ad, jad):
        a.skeleton_cube = [7]
        with pytest.raises(ValueError, match="no skeletons annotate"):
            a.get_tracing_batch(batch_size=1, n_steps=2)
    # the split: skeleton 0 on the train cube, 1 on the valid cube
    sks = [_helix(SkeletonMFK), _helix(SkeletonMFK, shift=1.0)]
    jad, ad = _pair(vols[:2], sks, patch=(7, 7, 7), valid_cubes=[1])
    for src in ("train", "valid"):
        got = []
        for a in (ad, jad):
            a.skeleton_cube = [0, 1]
            got.append(a.get_tracing_batch(batch_size=2, n_steps=2,
                                           source=src))
        np.testing.assert_array_equal(got[0][0], got[1][0])
        np.testing.assert_array_equal(got[0][1], got[1][1])
    for a in (ad, jad):
        a.skeleton_cube = [0, 0]
        with pytest.raises(ValueError, match="no skeletons annotate"):
            a.get_tracing_batch(batch_size=1, n_steps=2, source="valid")


def test_agentdata_loads_skeleton_files(tmp_path):
    path = _helix(jsk.SkeletonMFK).save(str(tmp_path / "helix.k.zip"))
    vols = [np.random.RandomState(6).rand(1, 32, 32, 32).astype(np.float32)]
    ad = AgentData(input_data=vols,
                   target_data=[(vols[0][0] > 0.5).astype(np.int16)],
                   skeleton_files=[path], skeleton_cube=[0])
    jad = JaxAgentData(input_data=vols,
                       target_data=[(vols[0][0] > 0.5).astype(np.int16)],
                       skeleton_files=[path], skeleton_cube=[0])
    np.testing.assert_array_equal(ad.skeletons[0].positions,
                                  jad.skeletons[0].positions)
    assert ad.skeleton_cube == [0] and not ad.rotate_to_heading


# ---------------------------------------------------------- the trainers

def _jax_gru(T=3, B=2, width=8, seed=6):
    """The JAX tests' TBPTT model (tests/test_tracing.py::_tbptt_model)."""
    jnm.model_manager.reset(seed=seed)
    seq = jnm.Input([T, B, 1, 5, 5, 5], "s,b,f,z,x,y", name="seq")
    x_t = jnm.Input([B, 1, 5, 5, 5], "b,f,z,x,y", name="x_t")
    enc = jnm.Perceptron(x_t, width, flatten=True, name="enc")
    h0 = jnm.InitialState_like(enc, override_f=width, name="h0")
    gru = jnm.GRU(enc, h0, n_f=width, name="gru")
    scan = jnm.ScanN(gru, in_memory=h0, in_iterate=x_t, in_iterate_0=seq,
                     n_steps=T, name="scan")
    out = jnm.Perceptron(scan, 3, activation_func="lin", name="readout")
    tgt = jnm.Input([T, B, 3], "s,b,f", name="target")
    loss = jnm.AggregateLoss(jnm.SquaredLoss(out, tgt))
    m = jnm.model_manager.getmodel()
    m.designate_nodes(input_node=seq, target_node=tgt, loss_node=loss,
                      prediction_node=out)
    m.params["h0"]["state0"] = jnp.asarray(
        np.random.RandomState(seed).randn(1, width).astype(np.float32) * 0.3)
    return m


@pytest.fixture
def gru_init(tmp_path):
    path = str(tmp_path / "gru-init.mdl")
    _jax_gru().save(path)
    return path


def _trainers(cls_pair, init, tmp_path, **kw):
    vols = [np.random.RandomState(8).rand(1, 32, 32, 32).astype(np.float32)]
    jad, ad = _pair(vols, [_line(SkeletonMFK)])
    common = dict(model_load_path=init, n_scan_steps=3, batch_size=2,
                  n_workers=0, history_freq=0, save_freq=0,
                  optimiser="Adam", optimiser_params={"lr": 3e-3})
    common.update(kw)
    jt = cls_pair[0](data=jad, save_path=str(tmp_path / "j"), **common)
    tt = cls_pair[1](data=ad, save_path=str(tmp_path / "t"), device="cpu",
                     **common)
    return jt, tt


@pytest.mark.parametrize("carry", [False, True])
def test_tracing_trainer_per_step_matches_jax(gru_init, tmp_path, carry):
    """TracingTrainer per step on AgentData's batches; with carry_state the
    scan's last hidden state is fed to the next batch (detached)."""
    jt, tt = _trainers((JaxTT, TracingTrainer), gru_init, tmp_path,
                       n_steps=6, carry_state=carry)
    assert tt._carry_map == jt._carry_map == ({"scan": "h0"} if carry
                                              else {})
    jh, th = jt.run(), tt.run()
    np.testing.assert_array_equal(th.timeline.data[:, 1], np.arange(1, 7))
    assert_losses_close(th.timeline.data[:, 2], jh.timeline.data[:, 2])
    if carry:
        h = tt._carry["h0"]
        assert tuple(h.shape) == (2, 8) and not h.requires_grad
        np.testing.assert_allclose(h.numpy(), np.asarray(jt._carry["h0"]),
                                   atol=CARRY_ATOL)
        assert np.abs(h.numpy()).max() > 0
    else:
        assert tt._carry == {}
    # getbatch is put back after the run
    assert tt.data.getbatch.__func__ is AgentData.getbatch


def _tbptt_feeds(rng, K, T=3, B=2):
    return [(rng.rand(T, B, 1, 5, 5, 5).astype(np.float32),
             rng.rand(T, B, 3).astype(np.float32)) for _ in range(K)]


class _Stub:
    def __init__(self, items):
        self.items = list(items)

    def getbatch(self, bs, **kw):
        return self.items.pop(0)


def test_fused_carry_equals_per_step_and_jax(gru_init):
    """tests/test_tracing.py:346: the fused chunk's losses and final carried
    hidden state equal the per-step TBPTT path's (exactly, in the port) and
    the JAX fused loop's (1e-5)."""
    K = 5
    feeds = _tbptt_feeds(np.random.RandomState(2), K)

    def port_model():
        m = modelload(gru_init, device="cpu")
        m.set_opt("SGD", lr=1e-2)
        m.debug_outputs.append(m.nodes["scan"])
        return m

    mA = port_model()
    carry, ref = None, []
    for d, t in feeds:
        lv, aux = mA.trainingstep(d, t, feed_overrides=(
            {"h0": carry} if carry is not None else None))
        ref.append(float(lv))
        carry = aux["scan"][-1]
    mB = port_model()
    loop = HostFedFusedLoop(mB, _Stub(feeds), 2, K, prefetch=False,
                            carry_map={"scan": "h0"})
    h_start = loop.rnn_carry["h0"].clone()
    np.testing.assert_array_equal(
        h_start.numpy(), np.broadcast_to(
            mB.params["h0"]["state0"].detach().numpy(), (2, 8)))
    losses, _ = loop.run_chunk()
    np.testing.assert_array_equal(losses, np.asarray(ref, np.float32))
    assert torch.equal(loop.rnn_carry["h0"], carry)
    for n in mA.params:
        for k in mA.params[n]:
            if (n, k) != ("h0", "state0"):
                assert torch.equal(mA.params[n][k], mB.params[n][k]), (n, k)
    # the boundary note: the fused chain feeds state0 as a value, so it gets
    # no gradient; the per-step path trains it on its first batch
    assert torch.equal(mB.params["h0"]["state0"][0], h_start[0])
    assert not torch.equal(mA.params["h0"]["state0"][0], h_start[0])
    # the JAX fused loop on the same feeds
    jm = _jax_gru()
    jm.set_opt("SGD", lr=1e-2)
    jm.debug_outputs.append(jm.nodes["scan"])
    jm._step_fn = None
    jloop = JaxHostFedFusedLoop(jm, _Stub(feeds), 2, K, prefetch=False,
                                carry_map={"scan": "h0"})
    jl, _ = jloop.run_chunk()
    assert_losses_close(losses, jl)
    np.testing.assert_allclose(loop.rnn_carry["h0"].numpy(),
                               np.asarray(jloop.rnn_carry["h0"]),
                               atol=CARRY_ATOL)


def test_fused_carry_map_checks_debug_outputs(gru_init):
    m = modelload(gru_init, device="cpu")
    with pytest.raises(ValueError, match="debug_outputs"):
        HostFedFusedLoop(m, _Stub([]), 2, 2, carry_map={"scan": "h0"})


@pytest.mark.parametrize("n_steps", [6, 8])
def test_tracing_trainer_rnn_fused_matches_jax(gru_init, tmp_path, n_steps):
    """TracingTrainerRNN with fused_steps=3: the carry rides the host-fed
    chunks as in JAX. At n_steps=8 a 2-step tail of plain steps continues
    the carry: the JAX package's tail draws race its prefetch thread, so
    there the chunked steps are held against JAX and the whole run against
    per-step TBPTT on the batches the port drew (its tail waits for the
    prefetch: chunk batches 1-6, the prefetched 7-9 unused, the tail 10-11),
    exactly."""
    jt, tt = _trainers((JaxTTRNN, TracingTrainerRNN), gru_init, tmp_path,
                       n_steps=n_steps, fused_steps=3)
    assert tt.carry_state and tt._carry_map == {"scan": "h0"}
    drawn = []
    draw = tt.data.get_tracing_batch
    tt.data.get_tracing_batch = lambda *a, **k: drawn.append(
        draw(*a, **k)) or drawn[-1]
    jh, th = jt.run(), tt.run()
    assert tt.step == n_steps and isinstance(tt.fused_loop, HostFedFusedLoop)
    got = th.timeline.data[:, 2]
    np.testing.assert_array_equal(th.timeline.data[:, 1],
                                  np.arange(1, n_steps + 1))
    assert_losses_close(got[:6], jh.timeline.data[:6, 2])
    if n_steps == 6:
        return
    assert len(drawn) == 11
    m = modelload(gru_init, device="cpu")
    m.set_opt("Adam", lr=3e-3)
    m.debug_outputs.append(m.nodes["scan"])
    carry, ref = None, []
    for d, t in drawn[:6] + drawn[9:]:
        lv, aux = m.trainingstep(d, t, feed_overrides=(
            None if carry is None else {"h0": carry}))
        ref.append(float(lv))
        carry = aux["scan"][-1]
    np.testing.assert_array_equal(got, np.asarray(ref, np.float32))
    assert torch.equal(tt.fused_loop.rnn_carry["h0"], carry)


def test_tracing_trainer_fused_refuses_device_batch(gru_init, tmp_path):
    _, tt = _trainers((JaxTT, TracingTrainerRNN), gru_init, tmp_path,
                      n_steps=3, fused_steps=3)
    tt.data.device_batch = lambda *a, **k: None
    with pytest.raises(ValueError, match="host-fed"):
        tt.run()


def test_tracing_trainer_preview_rollout_matches_jax(gru_init, tmp_path):
    """tests/test_tracing.py:639: the in-training model rolled out over a
    training cube (DeviceTracer)."""
    jt, tt = _trainers((JaxTT, TracingTrainer), gru_init, tmp_path,
                       n_steps=2)
    got = tt.preview_rollout(n_agents=4, max_steps=6)
    ref = jt.preview_rollout(n_agents=4, max_steps=6)
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert len(a.coords) == len(b.coords)
        np.testing.assert_allclose(a.coords, b.coords, atol=1e-4)
    d, t = tt.debug_getbatch()
    assert d.shape == (3, 2, 1, 5, 5, 5) and t.shape == (3, 2, 3)


def test_tracing3d_trains_through_the_cli_on_the_cpu(tmp_path, monkeypatch):
    """examples/tracing3d.py, unchanged, through the port's train CLI: the
    TracingTrainer on its synthetic helix, the losses finite, a .mdl
    written."""
    runs = []
    run = TracingTrainer.run
    monkeypatch.setattr(TracingTrainer, "run",
                        lambda self: runs.append(self) or run(self))
    out = tmp_path / "run"
    assert train_cli.main(["--cpu", TRACING3D, "--n-steps", "12",
                           "--save-path", str(out)]) == 0
    assert os.path.exists(out / "tracing3d-LAST.mdl")
    (trainer,) = runs
    assert type(trainer) is TracingTrainer and trainer.step == 12
    assert trainer.n_scan_steps == 6 and trainer.data.skeletons
    tl = trainer.history.timeline.data
    np.testing.assert_array_equal(tl[:, 1], np.arange(1, 13))
    assert np.isfinite(tl[:, 2]).all()
