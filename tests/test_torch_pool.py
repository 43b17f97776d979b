"""The tracing pools, ``tune_batch`` and the host ``Tracer`` of the port
against the JAX package.

The respawning pool (``DeviceTracer.trace_pool``), the chained pool
(``trace_pool_chain``) and ``ShotgunRegistry.run(pool=True)`` of the port
(plain patch cuts on the CPU, the chunk loop a card replays as a CUDA graph
run eagerly) are held against the same calls of the JAX package on its XLA
route, on weights carried across from the JAX model (``Model.save`` ->
``modelload``) and numpy-seeded volumes and seeds: the stats equal, the
traces of equal length and within 1e-5 (translation; float32 sums of the
model in another order, fed back through the positions) or 5e-3 (rotated,
as ``tests/test_pallas_extract_rot.py``). Each test also keeps the JAX
test's own checks (``tests/test_tracing.py``). The host ``Tracer`` is held
against the JAX host ``Tracer`` (1e-5) and the port's ``DeviceTracer``.
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
from elektronn2_tpu.data import tracing_utils as jtu  # noqa: E402
from elektronn2_tpu.neuromancer.graphutils import \
    TaggedShape as JaxTaggedShape  # noqa: E402
from elektronn2_tpu_torch.data.tracing_utils import (  # noqa: E402
    DeviceTracer, ShotgunRegistry, Tracer)
from elektronn2_tpu_torch.neuromancer.graphutils import \
    TaggedShape  # noqa: E402
from elektronn2_tpu_torch.neuromancer.model import modelload  # noqa: E402
from elektronn2_tpu_torch.ops import extract, extract_rot  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-5
ROT_ATOL = 5e-3
PATCH = (5, 5, 5)


def _port(jm, tmp_path, name="m"):
    path = str(tmp_path / f"{name}.mdl")
    jm.save(path)
    return modelload(path, device="cpu")


def _jax_ff(rng, bias, scale=0.02, patch=PATCH, zero_w=False):
    """The JAX tests' feedforward step predictor (``_ff_step_model``)."""
    jnm.model_manager.reset(seed=3)
    inp = jnm.Input([1, 1, *patch], "b,f,z,x,y", name="x")
    step = jnm.Perceptron(inp, 3, activation_func="lin", flatten=True,
                          name="step")
    m = jnm.model_manager.getmodel("ff_tracer")
    m.designate_nodes(input_node=inp, prediction_node=step)
    w = (np.zeros((int(np.prod(patch)), 3), np.float32) if zero_w else
         (rng.randn(int(np.prod(patch)), 3) * scale).astype(np.float32))
    m.params["step"]["w"] = jnp.asarray(w)
    m.params["step"]["b"] = jnp.asarray(np.asarray(bias, np.float32))
    return m


def _jax_gru(seed, bias, w_scale=None, T=4, width=8, B=1, name="rec"):
    """The JAX tests' GRU tracing model: Perceptron -> GRU via ScanN ->
    step head."""
    jnm.model_manager.reset(seed=seed)
    seq = jnm.Input([T, B, 1, *PATCH], "s,b,f,z,x,y", name="seq")
    x_t = jnm.Input([B, 1, *PATCH], "b,f,z,x,y", name="x_t")
    enc = jnm.Perceptron(x_t, width, flatten=True, name="enc")
    h0 = jnm.InitialState_like(enc, override_f=width, name="h0")
    gru = jnm.GRU(enc, h0, n_f=width, name="gru")
    scan = jnm.ScanN(gru, in_memory=h0, in_iterate=x_t, in_iterate_0=seq,
                     n_steps=T, name="scan")
    step = jnm.Perceptron(scan, 3, activation_func="lin", name="step")
    m = jnm.model_manager.getmodel(name)
    m.designate_nodes(input_node=seq, prediction_node=step)
    if w_scale is not None:
        m.params["step"]["w"] = jnp.asarray(
            np.asarray(m.params["step"]["w"]) * w_scale)
    m.params["step"]["b"] = jnp.asarray(np.asarray(bias, np.float32))
    return m


def _same(got, ref, atol=ATOL):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert len(g.coords) == len(r.coords), (i, len(g), len(r))
        np.testing.assert_allclose(g.coords, r.coords, atol=atol,
                                   err_msg=f"trace {i}")


def _pair(jm, tm, vol, **kw):
    """The JAX tracer (XLA route) and the port's on the same volume."""
    j = jtu.DeviceTracer(jm, vol, use_pallas_extract=False,
                         use_pallas_rot=False, **kw)
    return j, DeviceTracer(tm, vol, **kw)


# ------------------------------------------------------ the respawning pool

def test_pool_no_respawn_matches_jax(rng, tmp_path):
    """N <= B: every seed fills a slot at t=0; the pool equals trace_batch
    and the JAX pool."""
    jm = _jax_ff(rng, bias=(0.3, -0.2, 0.25))
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 26, 26, 26).astype(np.float32)
    jt, dt = _pair(jm, tm, vol, max_steps=6)
    seeds = np.asarray([[13.0, 12.0, 12.0], [11.5, 13.5, 12.5],
                        [12.5, 11.5, 13.0]], np.float32)
    ref, jstats = jt.trace_pool(seeds, batch_size=4)
    got, stats = dt.trace_pool(seeds, batch_size=4)
    assert stats == jstats and stats["consumed"] == 3
    _same(got, ref)
    batch = dt.trace_batch(seeds)
    _same(got, batch)
    assert stats["effective_steps"] == sum(len(t) - 1 for t in batch)


@pytest.mark.parametrize("chunk", [None, 3])
def test_pool_respawn_matches_jax_and_individual(rng, tmp_path, chunk):
    """N > B with agents marching into the wall: the respawned slots
    reproduce each seed's own rollout, and the JAX pool. ``chunk=3`` cuts
    the wave into chunks of 3 steps (the last one partial), as a card
    replays them."""
    jm = _jax_ff(rng, bias=(1.4, 0.2, -0.1), scale=0.01)
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 24, 24, 24).astype(np.float32)
    jt, dt = _pair(jm, tm, vol, max_steps=10)
    if chunk:
        dt.POOL_CHUNK = chunk
    seeds = rng.uniform(10.0, 14.0, (7, 3)).astype(np.float32)
    ref, jstats = jt.trace_pool(seeds, batch_size=2)
    got, stats = dt.trace_pool(seeds, batch_size=2)
    assert stats == jstats and stats["consumed"] == 7
    if chunk:
        assert stats["slot_steps"] // 2 % chunk      # a partial last chunk
    _same(got, ref)
    _same(got, [dt.trace(s) for s in seeds])
    assert 0 < stats["effective_steps"] <= stats["slot_steps"]


def test_pool_recurrent_respawn_resets_carry(rng, tmp_path):
    """GRU model: a respawned slot starts from the initial hidden state, not
    its predecessor's."""
    jm = _jax_gru(7, bias=(0.9, 0.3, -0.2), name="pool_rec")
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 24, 24, 24).astype(np.float32)
    jt, dt = _pair(jm, tm, vol, max_steps=8)
    seeds = rng.uniform(10.0, 14.0, (5, 3)).astype(np.float32)
    ref, jstats = jt.trace_pool(seeds, batch_size=2)
    got, stats = dt.trace_pool(seeds, batch_size=2)
    assert stats == jstats and stats["consumed"] == 5
    _same(got, ref)
    _same(got, [dt.trace(s) for s in seeds], atol=1e-4)


def test_pool_oob_seed_and_budget(rng, tmp_path):
    """An out-of-bounds seed is consumed and yields a seed-only trace; seeds
    past the step budget are reported unconsumed."""
    jm = _jax_ff(rng, bias=(0.5, 0.1, 0.1), zero_w=True)
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 24, 24, 24).astype(np.float32)
    jt, dt = _pair(jm, tm, vol, max_steps=4)
    seeds = np.asarray([[1.0, 1.0, 1.0], [12.0, 12.0, 12.0],
                        [13.0, 11.0, 12.0]], np.float32)
    for kw in ({}, {"total_steps": 4}, {"total_steps": 0}):
        ref, jstats = jt.trace_pool(seeds, batch_size=2, **kw) \
            if kw.get("total_steps") != 0 else ([], None)
        got, stats = dt.trace_pool(seeds, batch_size=2, **kw)
        if jstats is not None:
            assert stats == jstats
            _same(got, ref)
        assert len(got) == stats["consumed"]
    got, stats = dt.trace_pool(seeds, batch_size=2)
    assert stats["consumed"] == 3 and len(got[0].coords) == 1
    assert len(got[1].coords) > 1
    _, stats = dt.trace_pool(seeds, batch_size=2, total_steps=4)
    assert stats["consumed"] < 3


def test_registry_pool_drain_matches_jax(rng, tmp_path):
    """ShotgunRegistry.run(pool=True) drains through the chained pool; the
    dedupe works across waves; the traces equal the JAX registry's."""
    jm = _jax_ff(rng, bias=(0.8, 0.2, -0.1), scale=0.01)
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 24, 24, 24).astype(np.float32)
    jt, dt = _pair(jm, tm, vol, max_steps=6)
    seeds = [rng.uniform(10.0, 14.0, 3) for _ in range(5)]
    ref = jtu.ShotgunRegistry(seeds, radius=0.05).run(jt, batch_size=2,
                                                      pool=True)
    got = ShotgunRegistry(seeds, radius=0.05).run(dt, batch_size=2, pool=True)
    assert len(got) == 5
    _same(got, ref)
    close = [np.array([12.0, 12.0, 12.0]) + 0.05 * i for i in range(9)]
    for bs in (1, 2):
        reg = ShotgunRegistry(close, radius=50.0)
        out = reg.run(dt, batch_size=bs, pool=True)
        jout = jtu.ShotgunRegistry(close, radius=50.0).run(jt, batch_size=bs,
                                                           pool=True)
        assert len(out) == len(jout) == (8 if bs == 1 else 9)
        _same(out, jout)
        assert reg.next_seed() is None


def test_registry_pool_without_chain_takes_trace_pool(rng, tmp_path,
                                                      monkeypatch):
    """A tracer with trace_pool and no chained pool drains in trace_pool
    waves of 8 x batch_size seeds, as the JAX registry does."""
    jm = _jax_ff(rng, bias=(0.8, 0.2, -0.1), scale=0.01)
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 24, 24, 24).astype(np.float32)
    jt, dt = _pair(jm, tm, vol, max_steps=6)
    for t in (jt, dt):
        monkeypatch.setattr(type(t), "trace_pool_chain", property(
            lambda self: (_ for _ in ()).throw(AttributeError)))
    seeds = [rng.uniform(10.0, 14.0, 3) for _ in range(20)]
    got = ShotgunRegistry(seeds, radius=0.05).run(dt, batch_size=2,
                                                  pool=True)
    ref = jtu.ShotgunRegistry(seeds, radius=0.05).run(jt, batch_size=2,
                                                      pool=True)
    assert len(got) == len(ref) == 20
    _same(got, ref)


# ---------------------------------------------------------- the chained pool

@pytest.mark.parametrize("chunk", [None, 3])
def test_pool_chain_matches_jax_and_individual(rng, tmp_path, chunk):
    """wave_steps smaller than a trace: live agents carry across waves; the
    stitched traces equal each seed's own rollout and the JAX chain."""
    jm = _jax_ff(rng, bias=(0.5, 0.2, -0.15), scale=0.01)
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 24, 24, 24).astype(np.float32)
    jt, dt = _pair(jm, tm, vol, max_steps=10)
    if chunk:
        dt.POOL_CHUNK = chunk
    seeds = rng.uniform(10.0, 14.0, (7, 3)).astype(np.float32)
    kw = dict(batch_size=2, wave_seeds=3, wave_steps=4)
    ref, jstats = jt.trace_pool_chain(seeds, **kw)
    got, stats = dt.trace_pool_chain(seeds, **kw)
    assert stats == jstats
    assert stats["consumed"] == 7 and stats["waves"] >= 2
    _same(got, ref)
    _same(got, [dt.trace(s) for s in seeds])


def test_pool_chain_matches_trace_pool(rng, tmp_path):
    """One big wave: the chain equals the single-wave pool."""
    jm = _jax_ff(rng, bias=(0.3, -0.2, 0.25))
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 26, 26, 26).astype(np.float32)
    jt, dt = _pair(jm, tm, vol, max_steps=6)
    seeds = np.asarray([[13.0, 12.0, 12.0], [11.5, 13.5, 12.5],
                        [12.5, 11.5, 13.0]], np.float32)
    ref, _ = dt.trace_pool(seeds, batch_size=4)
    kw = dict(batch_size=4, wave_seeds=4, wave_steps=24)
    got, stats = dt.trace_pool_chain(seeds, **kw)
    jgot, jstats = jt.trace_pool_chain(seeds, **kw)
    assert stats == jstats and stats["consumed"] == 3
    _same(got, ref)
    _same(got, jgot)


def test_pool_chain_oob_seed_yields_seed_only_trace(rng, tmp_path):
    jm = _jax_ff(rng, bias=(0.3, 0.2, 0.2))
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 24, 24, 24).astype(np.float32)
    jt, dt = _pair(jm, tm, vol, max_steps=5)
    seeds = np.asarray([[12.0, 12.0, 12.0], [1.0, 1.0, 1.0],
                        [13.0, 12.5, 12.0]], np.float32)
    kw = dict(batch_size=2, wave_seeds=2, wave_steps=8)
    got, stats = dt.trace_pool_chain(seeds, **kw)
    ref, jstats = jt.trace_pool_chain(seeds, **kw)
    assert stats == jstats and stats["consumed"] == 3
    assert len(got[1].coords) == 1
    np.testing.assert_allclose(got[1].coords[0], seeds[1], atol=1e-6)
    _same(got, ref)


def test_pool_chain_callable_source_and_register(rng, tmp_path):
    """A callable seed source and a register callback, as the registry
    passes them: every finished trace is registered once, in the JAX
    chain's order."""
    jm = _jax_ff(rng, bias=(0.4, 0.1, -0.1), scale=0.01)
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 24, 24, 24).astype(np.float32)
    jt, dt = _pair(jm, tm, vol, max_steps=5)
    seeds = [np.array([12.0, 12.0, 12.0]) + 3.0 * i * np.array([0, 1, 0])
             for i in range(3)]
    outs = []
    for t in (dt, jt):
        pending = list(seeds)[::-1]
        reg = []
        traces, stats = t.trace_pool_chain(
            lambda: pending.pop() if pending else None, batch_size=2,
            wave_seeds=2, wave_steps=3, register=reg.append)
        assert len(reg) == len(traces) == 3
        outs.append((reg, stats))
    assert outs[0][1] == outs[1][1]
    _same(outs[0][0], outs[1][0])


def test_pool_chain_recurrent_state_crosses_waves(rng, tmp_path):
    """A GRU agent that crosses a wave boundary keeps stepping its hidden
    state: the chain equals trace_batch and the JAX chain."""
    jm = _jax_gru(9, bias=(0.5, 0.15, -0.1), w_scale=0.05, T=3,
                  name="chain_rec")
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 24, 24, 24).astype(np.float32)
    jt, dt = _pair(jm, tm, vol, max_steps=8)
    seeds = rng.uniform(10.0, 14.0, (5, 3)).astype(np.float32)
    kw = dict(batch_size=2, wave_seeds=2, wave_steps=3)
    got, stats = dt.trace_pool_chain(seeds, **kw)
    ref, jstats = jt.trace_pool_chain(seeds, **kw)
    assert stats == jstats and stats["waves"] >= 3
    _same(got, ref)
    _same(got, dt.trace_batch(seeds))


@pytest.mark.parametrize("chain", [False, True])
def test_rotated_recurrent_pool_matches_jax(rng, tmp_path, chain):
    """Rotated GRU pool (the heading resets on respawn): the pool equals the
    port's own batch rollout (1e-5) and the JAX pool (5e-3)."""
    jm = _jax_gru(5, bias=(0.6, 0.2, -0.1), w_scale=0.05, T=3, name="rot")
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 24, 24, 24).astype(np.float32)
    jt, dt = _pair(jm, tm, vol, max_steps=6, rotate_to_heading=True)
    seeds = rng.uniform(10.0, 14.0, (4, 3)).astype(np.float32)
    if chain:
        kw = dict(batch_size=2, wave_seeds=2, wave_steps=4)
        got, stats = dt.trace_pool_chain(seeds, **kw)
        ref, jstats = jt.trace_pool_chain(seeds, **kw)
    else:
        got, stats = dt.trace_pool(seeds, batch_size=2)
        ref, jstats = jt.trace_pool(seeds, batch_size=2)
    assert stats == jstats and stats["consumed"] == 4
    _same(got, dt.trace_batch(seeds))
    _same(got, ref, atol=ROT_ATOL)


def test_bf16_rotated_pool_matches_jax_kernel(tmp_path):
    """``rot_compute_dtype="bfloat16"``: the port's pool through K3's bf16
    plain version against the JAX pool through its Pallas kernel in the
    bf16 mode (interpret mode), on the JAX kernel test's geometry, 5e-3."""
    rng = np.random.RandomState(12)
    jnm.model_manager.reset(seed=3)
    patch = (4, 4, 4)
    inp = jnm.Input([1, 1, *patch], "b,f,z,x,y", name="x")
    step = jnm.Perceptron(inp, 3, activation_func="lin", flatten=True,
                          name="step")
    jm = jnm.model_manager.getmodel("ff_rot_bf16")
    jm.designate_nodes(input_node=inp, prediction_node=step)
    jm.params["step"]["w"] = jnp.asarray(rng.randn(64, 3) * 0.02,
                                         jnp.float32)
    jm.params["step"]["b"] = jnp.asarray([0.5, 0.2, -0.1], jnp.float32)
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 16, 32, 256).astype(np.float32)
    kw = dict(max_steps=5, rotate_to_heading=True,
              rot_compute_dtype="bfloat16")
    jt = jtu.DeviceTracer(jm, vol, use_pallas_rot=True, **kw)
    dt = DeviceTracer(tm, vol, **kw)
    assert jt._rot_kernel and dt._rot_bf16 and not dt._rot_kernel
    seeds = rng.uniform([6, 10, 120], [10, 22, 136], (4, 3)).astype(
        np.float32)
    got, stats = dt.trace_pool(seeds, batch_size=2)
    ref, jstats = jt.trace_pool(seeds, batch_size=2)
    assert stats == jstats
    _same(got, ref, atol=ROT_ATOL)
    _same(dt.trace_batch(seeds), jt.trace_batch(seeds), atol=ROT_ATOL)
    # the bf16 mode is a different rollout from the float32 one
    f32 = DeviceTracer(tm, vol, max_steps=5, rotate_to_heading=True)
    assert any(not np.array_equal(a.coords, b.coords) for a, b in zip(
        dt.trace_batch(seeds), f32.trace_batch(seeds)))


def test_pool_launches_no_kernel_on_the_cpu(rng, tmp_path):
    jm = _jax_ff(rng, bias=(0.3, 0.2, 0.1))
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 22, 22, 22).astype(np.float32)
    before = (extract.launches, extract_rot.launches,
              extract_rot.launches_bf16)
    for rotate in (False, True):
        dt = DeviceTracer(tm, vol, max_steps=3, rotate_to_heading=rotate,
                          rot_compute_dtype="bfloat16")
        dt.trace_pool(rng.uniform(9, 13, (4, 3)), batch_size=2)
        assert dt._pool_graphs == {}
    assert (extract.launches, extract_rot.launches,
            extract_rot.launches_bf16) == before


# --------------------------------------------------------------- tune_batch

def test_tune_batch_matches_jax_contract(rng, tmp_path):
    """tune_batch measures each candidate and returns the best; max_steps
    and the kept rollout graphs are put back; the tracer still traces."""
    jm = _jax_ff(rng, bias=(0.2, -0.1, 0.2))
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 24, 24, 24).astype(np.float32)
    jt, dt = _pair(jm, tm, vol, max_steps=7)
    kept = object()
    dt._graphs["user"] = kept
    res = dt.tune_batch(candidates=(2, 4), steps=3, repeats=1)
    jres = jt.tune_batch(candidates=(2, 4), steps=3, repeats=1)
    assert set(res["table"]) == set(jres["table"]) == {2, 4}
    assert all(v > 0 for v in res["table"].values())
    assert res["best"] in (2, 4)
    assert dt.max_steps == 7 and list(dt._graphs.values()) == [kept]
    del dt._graphs["user"]
    seed = [12.0, 12.0, 12.0]
    np.testing.assert_allclose(dt.trace(seed).coords, jt.trace(seed).coords,
                               atol=ATOL)
    with pytest.raises(ValueError, match="too small"):
        DeviceTracer(tm, rng.rand(1, 8, 8, 8).astype(np.float32)
                     ).tune_batch(candidates=(2,), steps=1)


# ---------------------------------------------------------- the host Tracer

class _FakeModel:
    """A duck-typed step predictor: ``predict`` and ``input_node`` only."""

    class _N:
        pass

    def __init__(self, step, tagged=TaggedShape):
        self.input_node = self._N()
        self.input_node.shape = tagged((1, 1, 5, 5, 5), "b,f,z,x,y")
        self._step = np.asarray([step], np.float32)

    def predict(self, patch):
        return self._step


@pytest.mark.parametrize("rotate", [False, True])
def test_host_tracer_duck_typed_matches_jax(rng, rotate):
    """A hard-wired model: axis-aligned it steps +y and traces a straight
    path; frame-aligned it predicts 'ahead' in the local frame and follows
    its initial heading."""
    vol = rng.rand(1, 28, 28, 28).astype(np.float32)
    step = (2.0, 0.0, 0.0) if rotate else (0.0, 0.0, 2.0)
    kw = dict(max_steps=6 if rotate else 10, rotate_to_heading=rotate)
    seed = [14.0, 5.0, 14.0] if rotate else [12.0, 12.0, 5.0]
    head = [0.0, 1.0, 0.0] if rotate else None
    got = Tracer(_FakeModel(step), vol, **kw).trace(seed,
                                                     initial_heading=head)
    ref = jtu.Tracer(_FakeModel(step, JaxTaggedShape), vol, **kw).trace(
        seed, initial_heading=head)
    _same([got], [ref])
    d = got.coords[-1] - got.coords[0]
    if rotate:
        assert d[1] > 4.0
        np.testing.assert_allclose([d[0], d[2]], [0.0, 0.0], atol=1e-4)
    else:
        assert len(got) > 3 and d[2] > 0
        np.testing.assert_allclose(d[:2], [0.0, 0.0])


def test_host_tracer_feedforward_matches_jax_and_device(rng, tmp_path):
    """Feedforward model: the host Tracer equals the JAX host Tracer and the
    port's DeviceTracer."""
    jm = _jax_ff(rng, bias=(0.1, 0.35, 0.25))
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 28, 28, 28).astype(np.float32)
    seed = [13.0, 12.5, 11.0]
    got = Tracer(tm, vol, max_steps=8).trace(seed)
    ref = jtu.Tracer(jm, vol, max_steps=8).trace(seed)
    assert len(got.coords) == 9
    _same([got], [ref])
    _same([got], [DeviceTracer(tm, vol, max_steps=8).trace(seed)], atol=1e-4)


@pytest.mark.parametrize("rotate", [False, True])
def test_host_tracer_recurrent_matches_jax(rng, tmp_path, rotate):
    """GRU model: the host Tracer steps the scan cell with the hidden state
    carried, as the JAX host Tracer does, and agrees with the port's
    DeviceTracer on its first steps."""
    jm = _jax_gru(7, bias=(0.4, 0.3, -0.2), w_scale=0.05, T=3, B=2,
                  width=16, name="host_rec")
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 24, 24, 24).astype(np.float32)
    seed = np.array([12.0, 12.0, 12.0])
    kw = dict(max_steps=4, step_scale=3.0, rotate_to_heading=rotate)
    got = Tracer(tm, vol, **kw).trace(seed)
    ref = jtu.Tracer(jm, vol, **kw).trace(seed)
    assert len(got.coords) >= 3
    _same([got], [ref], atol=ROT_ATOL if rotate else ATOL)
    dev = DeviceTracer(tm, vol, **kw).trace(seed)
    n = min(len(got.coords), len(dev.coords), 3)
    np.testing.assert_allclose(got.coords[:n], dev.coords[:n], atol=1e-2)


def test_registry_serial_drain_through_host_tracer(rng):
    """The registry's serial drain through a host Tracer dedupes a covered
    seed, as the JAX registry does."""
    vol = rng.rand(1, 24, 24, 24).astype(np.float32)
    seeds = [[12, 12, 6], [12, 12, 6.5], [12, 5, 6]]
    got = ShotgunRegistry(seeds, radius=3.0).run(
        Tracer(_FakeModel((0.0, 0.0, 2.0)), vol, max_steps=5))
    ref = jtu.ShotgunRegistry(seeds, radius=3.0).run(
        jtu.Tracer(_FakeModel((0.0, 0.0, 2.0), JaxTaggedShape), vol,
                   max_steps=5))
    assert len(got) == 2
    _same(got, ref)
