"""Fused agent tracing in the port against the JAX package.

``DeviceTracer.trace_batch`` of the port (plain patch cuts on the CPU) is
held against the JAX ``DeviceTracer.trace_batch`` on its XLA route
(``use_pallas_extract=False``, ``use_pallas_rot=False``; the JAX package's
own tests prove that route equal to its Pallas kernels), on weights carried
across from the JAX model and numpy-seeded volumes and seeds: atol 1e-4 on
the trajectories (float32 matmul sums in another order, fed back through
the positions for up to 8 steps, with step weights scaled 0.02) and equal
lengths, i.e. the same steps recorded. The rest mirrors
``tests/test_tracing.py``: batched equals single, the OOB freeze, the
recurrent rollout against a manual replay, the ShotgunRegistry drains and
the KNOSSOS export.
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
from elektronn2_tpu.data.tracing_utils import \
    DeviceTracer as JaxTracer  # noqa: E402
from elektronn2_tpu.data.tracing_utils import \
    CubeShape as JaxCubeShape  # noqa: E402
from elektronn2_tpu_torch.data.skeleton import read_nml_file  # noqa: E402
from elektronn2_tpu_torch.data.tracing_utils import (  # noqa: E402
    CubeShape, DeviceTracer, ShotgunRegistry)
from elektronn2_tpu_torch.neuromancer.model import modelload  # noqa: E402
from elektronn2_tpu_torch.ops import extract, extract_rot  # noqa: E402
from elektronn2_tpu_torch.utils.convert import (params_from_jax,  # noqa: E402
                                                tracer_model)
from scripts.exp_tracer_rollout import build_model  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-4
PATCH = (5, 5, 5)


def _jax_ff(rng, bias, scale=0.02, patch=PATCH):
    """Feedforward step predictor in the JAX package: patch -> 3-vector."""
    jnm.model_manager.reset(seed=3)
    inp = jnm.Input([1, 1, *patch], "b,f,z,x,y", name="x")
    step = jnm.Perceptron(inp, 3, activation_func="lin", flatten=True,
                          name="step")
    m = jnm.model_manager.getmodel("ff_tracer")
    m.designate_nodes(input_node=inp, prediction_node=step)
    m.params["step"]["w"] = jnp.asarray(
        (rng.randn(int(np.prod(patch)), 3) * scale).astype(np.float32))
    m.params["step"]["b"] = jnp.asarray(np.asarray(bias, np.float32))
    return m


def _port(jax_model, tmp_path):
    path = str(tmp_path / "tracer.mdl")
    jax_model.save(path)
    return modelload(path, device="cpu")


def _jax_gru(rng, patch=PATCH, bias=(0.4, 0.3, -0.2)):
    """The tracing deployment's GRU model, step weights scaled 0.02."""
    jm = build_model(patch, enc_w=16, gru_w=16, batch=2, t=3)
    jm.params["step"]["w"] = jnp.asarray(
        (rng.randn(16, 3) * 0.02).astype(np.float32))
    jm.params["step"]["b"] = jnp.asarray(np.asarray(bias, np.float32))
    jm.params["h0"]["state0"] = jnp.asarray(
        rng.randn(1, 16).astype(np.float32) * 0.5)
    tm = tracer_model(patch, enc_w=16, gru_w=16, batch=2, t=3,
                      device="cpu")
    tm.set_params(params_from_jax(jm.params, tm))
    return jm, tm


def _assert_same_traces(got, ref):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert len(g.coords) == len(r.coords), i
        np.testing.assert_allclose(g.coords, r.coords, atol=ATOL,
                                   err_msg=f"agent {i}")


def _seeds(rng, n, lo, hi):
    return rng.uniform(lo, hi, (n, 3)).astype(np.float32)


def test_translation_rollout_matches_jax(rng, tmp_path):
    """Feedforward rollout, one agent started next to the wall so that it
    leaves the margin and freezes."""
    jm = _jax_ff(rng, bias=(0.3, 0.35, -0.25))
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 26, 24, 28).astype(np.float32)
    seeds = np.concatenate([_seeds(rng, 5, 8, 16),
                            [[20.5, 12.0, 12.0]]]).astype(np.float32)
    K = 8
    ref = JaxTracer(jm, vol, max_steps=K,
                    use_pallas_extract=False).trace_batch(seeds)
    got = DeviceTracer(tm, vol, max_steps=K).trace_batch(seeds)
    _assert_same_traces(got, ref)
    assert len(got[-1].coords) < K + 1          # the wall agent stopped
    assert any(len(t.coords) == K + 1 for t in got)


@pytest.mark.parametrize("rotate", [False, True])
def test_recurrent_rollout_matches_jax(rng, rotate):
    """The GRU tracing model (Perceptron → GRU via ScanN → step head),
    translation and frame-aligned rollouts."""
    jm, tm = _jax_gru(rng)
    vol = rng.rand(1, 30, 30, 30).astype(np.float32)
    seeds = np.concatenate([_seeds(rng, 5, 9, 21),
                            [[24.0, 15.0, 15.0]]]).astype(np.float32)
    K = 8
    kw = dict(max_steps=K, rotate_to_heading=rotate)
    ref = JaxTracer(jm, vol, use_pallas_extract=False, use_pallas_rot=False,
                    **kw).trace_batch(seeds)
    got = DeviceTracer(tm, vol, **kw).trace_batch(seeds)
    _assert_same_traces(got, ref)
    assert sum(len(t.coords) for t in got) > 2 * len(seeds)   # they moved


def test_rotated_rollout_matches_jax_with_headings(rng, tmp_path):
    """Feedforward frame-aligned rollout with given initial headings; one
    agent inside the margin has a diagonal view that crosses the volume's
    far z bound (dims-2), so the ok flag stops it at once."""
    jm = _jax_ff(rng, bias=(0.5, 0.2, -0.1))
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 22, 26, 24).astype(np.float32)
    seeds = np.concatenate([_seeds(rng, 4, 9, 13),
                            [[17.6, 13.0, 12.0]]]).astype(np.float32)
    heads = rng.randn(len(seeds), 3).astype(np.float32)
    heads[-1] = 1.0
    kw = dict(max_steps=6, rotate_to_heading=True)
    ref = JaxTracer(jm, vol, use_pallas_rot=False, **kw).trace_batch(
        seeds, initial_headings=heads)
    got = DeviceTracer(tm, vol, **kw).trace_batch(seeds,
                                                  initial_headings=heads)
    _assert_same_traces(got, ref)
    assert len(got[-1].coords) == 1


def test_batched_equals_single(rng, tmp_path):
    tm = _port(_jax_ff(rng, bias=(0.3, -0.2, 0.25)), tmp_path)
    vol = rng.rand(1, 26, 26, 26).astype(np.float32)
    dt = DeviceTracer(tm, vol, max_steps=6)
    seeds = [[13.0, 12.0, 12.0], [11.5, 13.5, 12.5]]
    for tb, ts in zip(dt.trace_batch(seeds), [dt.trace(s) for s in seeds]):
        np.testing.assert_allclose(tb.coords, ts.coords, atol=1e-5)


def test_oob_freeze(rng, tmp_path):
    """An agent marching at a wall records the step that leaves the margin,
    then freezes."""
    jm = _jax_ff(rng, bias=(3.0, 0.0, 0.0), scale=0.0)
    tm = _port(jm, tmp_path)
    vol = rng.rand(1, 24, 24, 24).astype(np.float32)
    pts = DeviceTracer(tm, vol, max_steps=10).trace([12.0, 12.0, 12.0]).coords
    ref = JaxTracer(jm, vol, max_steps=10,
                    use_pallas_extract=False).trace([12.0, 12.0, 12.0]).coords
    np.testing.assert_allclose(pts, ref, atol=ATOL)
    margin = np.asarray(PATCH) / 2 + 1
    assert len(pts) < 11
    assert np.all(pts[:-1] >= margin - 1e-6)
    assert np.all(pts[:-1] < 24 - margin + 1e-6)
    assert pts[-1][0] >= 24 - margin[0] - 1e-6


def test_recurrent_rollout_equals_manual_replay(rng):
    """The fused rollout equals stepping the model by hand through the
    same step function and patch cut; the hidden state evolves."""
    _, tm = _jax_gru(rng)
    vol = rng.rand(1, 26, 26, 26).astype(np.float32)
    dt = DeviceTracer(tm, vol, max_steps=5)
    tr = dt.trace([13.0, 13.0, 13.0])
    assert len(tr.coords) == 6
    pos = torch.tensor([[13.0, 13.0, 13.0]])
    carry = dt._init_carry(tm.params, 1)
    pts = [pos[0].numpy().copy()]
    with torch.no_grad():
        for _ in range(5):
            pred, carry = dt._step_apply(tm.params,
                                         dt._extract(dt.volume, pos), carry)
            pos = pos + pred.reshape(1, -1)[:, :3]
            pts.append(pos[0].numpy().copy())
    np.testing.assert_allclose(tr.coords, np.asarray(pts), atol=1e-5)
    assert float(carry[0].abs().max()) > 0


def test_registry_batched_drain(rng, tmp_path):
    tm = _port(_jax_ff(rng, bias=(0.3, 0.2, 0.1)), tmp_path)
    vol = rng.rand(1, 26, 26, 26).astype(np.float32)
    dt = DeviceTracer(tm, vol, max_steps=5)
    seeds = [[12.0, 12.0, 12.0], [13.0, 11.0, 12.0], [11.0, 13.0, 13.0],
             [12.5, 12.5, 11.5]]
    reg = ShotgunRegistry(seeds, radius=1.5)
    traces = reg.run(dt, batch_size=2)
    assert 1 <= len(traces) <= 3                  # dedupe fired
    assert reg.next_seed() is None
    assert all(len(t.coords) >= 1 for t in traces)


def test_registry_pads_partial_batch(rng, tmp_path, monkeypatch):
    """The last partial batch is padded to batch_size with its first seed,
    and the padding traces are dropped."""
    tm = _port(_jax_ff(rng, bias=(0.3, 0.2, 0.1)), tmp_path)
    vol = rng.rand(1, 26, 26, 26).astype(np.float32)
    dt = DeviceTracer(tm, vol, max_steps=4)
    sizes = []
    real = dt.trace_batch
    monkeypatch.setattr(dt, "trace_batch",
                        lambda s: sizes.append(len(s)) or real(s))
    seeds = [[12.0, 12.0, 12.0], [13.0, 11.0, 12.0], [11.0, 13.0, 13.0]]
    reg = ShotgunRegistry(seeds, radius=0.1)
    traces = reg.run(dt, batch_size=2)
    assert sizes == [2, 2]
    assert len(traces) == 3
    assert reg.next_seed() is None
    # each trace starts at its own seed (popped last-first)
    np.testing.assert_array_equal([t.coords[0] for t in traces],
                                  np.asarray(seeds[::-1], np.float64))


def test_registry_serial_drain_and_kzip(rng, tmp_path):
    tm = _port(_jax_ff(rng, bias=(0.3, 0.2, 0.1)), tmp_path)
    vol = rng.rand(1, 26, 26, 26).astype(np.float32)
    dt = DeviceTracer(tm, vol, max_steps=3)
    reg = ShotgunRegistry([[12.0, 12.0, 12.0], [14.0, 11.0, 12.0]],
                          radius=0.1)
    out = str(tmp_path / "drain.k.zip")
    traces = reg.run(dt, batch_size=1, save_kzip=out)
    nodes, edges, _ = read_nml_file(out)
    assert len(nodes) == sum(len(t.coords) for t in traces)
    assert len(edges) == len(nodes) - len(traces)


def test_trace_batch_kzip_round_trip(rng, tmp_path):
    """``trace_batch(save_kzip=...)`` writes a KNOSSOS annotation whose
    nodes are the traces' points, bit for bit, chained per trace."""
    _, tm = _jax_gru(rng)
    vol = rng.rand(1, 26, 26, 26).astype(np.float32)
    out = str(tmp_path / "traces.k.zip")
    traces = DeviceTracer(tm, vol, max_steps=4).trace_batch(
        _seeds(rng, 3, 10, 16), save_kzip=out)
    nodes, edges, radii = read_nml_file(out)
    pts = np.asarray([nodes[i] for i in sorted(nodes)])
    np.testing.assert_array_equal(pts, np.concatenate([t.coords
                                                       for t in traces]))
    assert len(edges) == len(pts) - len(traces)
    assert set(radii.values()) == {1.0}


def test_cpu_route_launches_no_kernel(rng):
    _, tm = _jax_gru(rng)
    vol = rng.rand(1, 26, 26, 26).astype(np.float32)
    before = (extract.launches, extract_rot.launches)
    for rotate in (False, True):
        dt = DeviceTracer(tm, vol, max_steps=2, rotate_to_heading=rotate)
        assert not (dt._extract_kernel or dt._rot_kernel)
        dt.trace_batch([[13.0, 13.0, 13.0]])
    assert (extract.launches, extract_rot.launches) == before


@pytest.mark.parametrize("kw, call, exc, match", [
    (dict(use_pallas_extract=True), None, ValueError, "CUDA device"),
    (dict(rotate_to_heading=True, use_pallas_rot=True), None, ValueError,
     "CUDA device"),
    (dict(rot_compute_dtype="float16"), None, ValueError,
     "rot_compute_dtype"),
    (dict(rot_precision="hi"), None, ValueError, "rot_precision"),
    ({}, "mesh", NotImplementedError, "item 8"),
    ({}, "headings", ValueError, "initial_headings"),
])
def test_unported_and_invalid_options_raise(rng, kw, call, exc, match):
    _, tm = _jax_gru(rng)
    vol = rng.rand(1, 20, 20, 20).astype(np.float32)
    with pytest.raises(exc, match=match):
        dt = DeviceTracer(tm, vol, max_steps=2, **kw)
        if call == "mesh":
            dt.trace_batch([[10.0, 10.0, 10.0]], mesh=object())
        elif call == "headings":
            dt.trace_batch([[10.0, 10.0, 10.0]],
                           initial_headings=np.zeros((2, 3)))


def test_cube_shape_matches_jax(rng):
    shape, margin = (20, 24, 28), np.asarray(PATCH) / 2 + 1
    mine, ref = CubeShape(shape, margin), JaxCubeShape(shape, margin)
    for p in rng.uniform(-2, 30, (40, 3)):
        assert mine.inside(p) == ref.inside(p)
        np.testing.assert_array_equal(mine.clip(p), ref.clip(p))


def test_cpu_trace_batch_builds_no_graph(rng, monkeypatch):
    """A CPU volume takes the eager loop: no CUDA graph is captured or
    replayed, for either route."""
    _, tm = _jax_gru(rng)
    vol = rng.rand(1, 26, 26, 26).astype(np.float32)

    def no_graph(*args, **kwargs):
        raise AssertionError("the graphed rollout ran for a CPU volume")

    for rotate in (False, True):
        dt = DeviceTracer(tm, vol, max_steps=3, rotate_to_heading=rotate)
        monkeypatch.setattr(dt, "_rollout_graphed", no_graph)
        traces = dt.trace_batch(_seeds(rng, 2, 11, 15))
        assert len(traces) == 2 and dt._graphs == {}
        assert dt.capture_seconds is None


def _key_tracers(rng, **kw):
    """A GRU tracer model and a volume tensor shared by the tracers made
    from it (DeviceTracer keeps a float32 contiguous tensor as it is)."""
    _, tm = _jax_gru(rng)
    vol = torch.from_numpy(rng.rand(1, 26, 26, 26).astype(np.float32))
    return tm, vol


def test_graph_key_changes_with_params_batch_horizon_and_route(rng):
    tm, vol = _key_tracers(rng)
    dt = DeviceTracer(tm, vol, max_steps=4)
    assert dt.volume is vol
    key = dt.graph_key(tm.params, 8)
    assert dt.graph_key(tm.params, 8) == key
    # B, the horizon and the route
    assert dt.graph_key(tm.params, 9) != key
    assert DeviceTracer(tm, vol, max_steps=5).graph_key(tm.params, 8) != key
    assert DeviceTracer(tm, vol, max_steps=4).graph_key(tm.params, 8) == key
    assert DeviceTracer(tm, vol, max_steps=4, rotate_to_heading=True
                        ).graph_key(tm.params, 8) != key
    assert DeviceTracer(tm, vol, max_steps=4, min_step=0.5
                        ).graph_key(tm.params, 8) != key
    # set_params makes new tensors; the old ones stay held, as a kept graph
    # holds them, so their ids are not reused
    held = tm.params
    tm.set_params({n: {k: v.detach().numpy() for k, v in d.items()}
                   for n, d in held.items()})
    assert tm.params["enc"]["w"] is not held["enc"]["w"]
    replaced = dt.graph_key(tm.params, 8)
    assert replaced != key
    # an in-place update bumps the tensor's version
    with torch.no_grad():
        tm.params["gru"]["w_cand"].mul_(1.0)
    bumped = dt.graph_key(tm.params, 8)
    assert bumped not in (key, replaced)
    # assigning .data swaps the storage: a new address
    w = tm.params["step"]["w"]
    w.data = w.detach().clone()
    assert dt.graph_key(tm.params, 8) not in (key, replaced, bumped)


def test_graph_key_constant_across_registry_batches(rng, monkeypatch):
    """The registry pads its last batch to the batch size, so every batch of
    a drain has one key: one captured graph serves the drain."""
    tm, vol = _key_tracers(rng)
    dt = DeviceTracer(tm, vol, max_steps=3)
    keys = []
    real = dt.trace_batch
    monkeypatch.setattr(dt, "trace_batch", lambda s: keys.append(
        dt.graph_key(tm.params, len(s))) or real(s))
    seeds = _seeds(rng, 5, 10, 16)
    ShotgunRegistry(seeds, radius=0.01).run(dt, batch_size=2)
    assert len(keys) == 3 and len(set(keys)) == 1
