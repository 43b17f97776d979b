"""Sharded serving of the port (``parallel/halo.py``,
``predict_dense_sharded*``, ``sweep_knossos(mesh=...)``, sharded int8
scales, ``trace_batch(mesh=...)``, ``predict --mesh``) on spawned CPU
ranks, against the port's unsharded calls and the JAX package.

Mirrors ``tests/test_parallel.py`` (:77, :105, :127, :135),
``tests/test_pallas_tailconv.py:270``, ``tests/test_inference_device.py``
(:1025, :1039, :1055, :1086, :1118), ``tests/test_review_fixes.py:640``,
``tests/test_integration_extra.py:260``, ``tests/test_tracing.py:959`` and
``tests/test_utils_misc.py:242``. Two spawns of four ``gloo`` ranks
(``torch_sharded_workers``, jax-free) run every case once: one on a
``{"space": 4}`` mesh, one on ``{"data": 2, "space": 2}``; the CLI runs
under torchrun. Every rank is given the whole input and returns the whole
result, so the ranks must agree bit for bit.

Tolerances:
- float32 maps against the port's unsharded call: atol 1e-6, as the JAX
  tests state it (the sharded ranks run their convs over other z extents,
  so cuDNN/oneDNN may sum in another order); the decoder leg 1e-5 and its
  sweep 1e-4, as ``test_inference_device.py:1055`` states them;
- int8 against the port's unsharded int8 call: the logits (the map
  before the softmax) bit for bit (the scales are reduced over the mesh
  and the invalid rows masked out, the sums exact); the probabilities
  within 1e-6, because the CPU's softmax kernel rounds a last bit
  differently with the tensor's shape and the thread count;
- against the JAX package's sharded functions on the conftest's virtual
  CPU mesh, from the same weights: float32 1e-6 (decoder 1e-5; the
  unscaled randn stack of ``test_parallel.py:77``, whose values reach ~400
  through cancelling sums, 1e-6 of its largest magnitude), int8 at
  ``test_torch_quant.py``'s int8 bound 5e-2 (the two packages' float32
  activations differ in summation order, so a value on a rounding
  boundary may quantise one step apart), traces 1e-4
  (``test_torch_tracing.py``);
- the sharded traces against the port's unsharded rollout: 1e-6.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)
import jax.numpy as jnp  # noqa: E402
import elektronn2_tpu.neuromancer as jnm  # noqa: E402
import elektronn2_tpu_torch.neuromancer as tnm  # noqa: E402
import torch_dp_workers as W  # noqa: E402
import torch_sharded_workers as S  # noqa: E402
from test_data import write_knossos  # noqa: E402
from elektronn2_tpu.parallel import make_mesh as jax_mesh  # noqa: E402
from elektronn2_tpu_torch.neuromancer.inference import (  # noqa: E402
    dilated_dense_forward)
from elektronn2_tpu_torch.ops.conv import apply_layer, f32_convs  # noqa: E402
from elektronn2_tpu_torch.utils.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)
F32_ATOL, DEC_ATOL, DEC_SWEEP_ATOL = 1e-6, 1e-5, 1e-4
INT8_JAX_ATOL, TRACE_JAX_ATOL, STACK_JAX_RTOL = 5e-2, 1e-4, 1e-6
WORLD = 4
_cache = {}


def once(key, fn):
    if key not in _cache:
        _cache[key] = fn()
    return _cache[key]


@pytest.fixture(scope="module")
def spawn_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("sharded")


def pair(build, mutate=None, **kw):
    """(JAX model, the port's model with its weights, the weights)."""
    jm = build(jnm, **kw)
    if mutate is not None:
        mutate(jm)
    tm = build(tnm, **kw)
    tm.set_params(params_from_jax(jm.params, tm))
    return jm, tm, W.params_np(tm)


def step_weights(jm):
    """tests/test_tracing.py:959's step predictor: weights scaled 0.02."""
    w = np.asarray(jm.params["step"]["w"])
    jm.params["step"]["w"] = jnp.asarray((np.random.RandomState(5).randn(
        *w.shape) * 0.02).astype(np.float32))
    jm.params["step"]["b"] = jnp.asarray(np.asarray([0.25, -0.15, 0.3],
                                                    np.float32))


def cancel_c2(jm):
    """tests/test_inference_device.py:1118: c2's z taps cancel on a
    z-constant input, so the zero halo rows outgrow every valid value."""
    w = np.asarray(jm.params["c2"]["w"]).copy()
    w[:] = 0.0
    w[:, :, 0] = 0.5
    w[:, :, 2] = -0.5
    jm.params["c2"]["w"] = jnp.asarray(w)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def setup(spawn_dir):
    """Models, inputs, the port's unsharded results, the JAX package's
    sharded results and both spawns, once per module."""
    def run():
        rng = np.random.RandomState(0)
        models = {"dense": pair(S.dense_net),
                  "multihop": pair(S.multihop_net),
                  "ptail": pair(S.ptail_net),
                  "int8": pair(S.int8_net),
                  "int8_adv": pair(S.int8_net, mutate=cancel_c2),
                  "unet": pair(S.unet_net),
                  "zpool": pair(S.zpool_unet),
                  "knossos": pair(S.knossos_net),
                  "fresh": pair(S.knossos_net, trainable=True),
                  "tracer": pair(S.ff_tracer, mutate=step_weights)}
        w = {k: v[2] for k, v in models.items()}
        base = rng.rand(1, 1, 28, 28).astype(np.float32)
        fresh_out = models["fresh"][1].prediction_node.shape.spatial_shape
        inputs = {
            "layers": [
                {"w": rng.randn(4, 1, 3, 3, 3).astype(np.float32),
                 "b": np.zeros(4, np.float32), "activation": "relu"},
                {"w": rng.randn(4, 4, 3, 3, 3).astype(np.float32),
                 "b": np.zeros(4, np.float32), "activation": "relu",
                 "pool": (1, 2, 2)},
                {"w": rng.randn(2, 4, 2, 3, 3).astype(np.float32),
                 "b": np.zeros(2, np.float32), "activation": "lin"}],
            "stack_x": rng.randn(1, 1, 16, 20, 20).astype(np.float32),
            "dense": rng.rand(1, 32, 40, 40).astype(np.float32),
            "dense_pad": rng.rand(1, 30, 40, 40).astype(np.float32),
            "multihop": rng.rand(1, 12, 20, 20).astype(np.float32),
            "ptail": rng.rand(1, 16, 30, 30).astype(np.float32),
            "int8": rng.rand(1, 24, 28, 28).astype(np.float32),
            "int8_adv": [np.repeat(base, z, axis=1) for z in (24, 22)],
            "unet": [rng.randn(2, 1, z, 21, 23).astype(np.float32)
                     for z in (24, 22)],
            "unet_pad": rng.randn(1, 24, 21, 23).astype(np.float32),
            "unet_karr": rng.randn(24, 40, 44).astype(np.float32),
            "fresh_vol": rng.rand(1, 16, 24, 24).astype(np.float32),
            "fresh_x": rng.rand(1, 1, 9, 17, 17).astype(np.float32),
            "fresh_y": (rng.rand(1, *fresh_out) > 0.5).astype(np.int32),
            "trace_vol": rng.rand(1, 26, 26, 26).astype(np.float32),
            "trace_seeds": rng.uniform(10, 16, (10, 3)).astype(np.float32),
            "trace_kzip": str(spawn_dir / "traces"),
            "dense_b": rng.rand(2, 1, 32, 40, 40).astype(np.float32),
            "int8_b": rng.rand(2, 1, 24, 28, 28).astype(np.float32)}
        kvol = (rng.rand(24, 32, 32) * 255).astype(np.uint8)
        kdirs = {"sweep": write_knossos(spawn_dir, kvol, cube_edge=8)}
        space = W.run_ranks(spawn_dir / "space", "torch_sharded_workers:"
                            "space_cases", world=WORLD, w=w, inputs=inputs,
                            kdirs=kdirs)
        dp_sp = W.run_ranks(spawn_dir / "dp_sp", "torch_sharded_workers:"
                            "dp_sp_cases", world=WORLD, w=w, inputs=inputs,
                            kdirs=kdirs)
        return dict(models=models, inputs=inputs, kvol=kvol, kdirs=kdirs,
                    space=space, dp_sp=dp_sp)
    return once("setup", run)


def ranks_equal(results, key):
    """Every rank's ``key`` result equal to rank 0's, bit for bit; rank
    0's."""
    first = results[0][key]
    for r in results[1:]:
        got = r[key]
        if isinstance(first, list):
            assert len(got) == len(first), key
            for a, b in zip(first, got):
                np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            np.testing.assert_array_equal(first, got, err_msg=key)
    return first


def port_dense(tm, vol, pad_raw=False):
    return tm.predict_dense_device(_t(vol), pad_raw=pad_raw).numpy()


# --------------------------------------------------------- halo primitives

def test_halo_gather_single_and_multi_hop(spawn_dir):
    # 16 rows over 4 ranks (4 a shard): halos 0, 2 and 4 are one hop, 9 is
    # three; rows past the global end come back as zeros
    g = np.concatenate([np.arange(16), np.zeros(9)]).astype(np.float32)
    for r, res in enumerate(setup(spawn_dir)["space"]):
        for h, got in res["halo_rows"].items():
            np.testing.assert_array_equal(got.reshape(-1),
                                          g[4 * r:4 * r + 4 + h],
                                          err_msg=f"rank {r} halo {h}")


def test_halo_cp_stack_equals_unsharded(spawn_dir):
    s = setup(spawn_dir)
    got = ranks_equal(s["space"], "stack")
    layers = s["inputs"]["layers"]
    h = _t(s["inputs"]["stack_x"])
    for lay in layers:
        h = apply_layer(h, _t(lay["w"]), _t(lay["b"]), lay["activation"],
                        lay.get("pool"))
    np.testing.assert_allclose(got, h.numpy(), rtol=0, atol=F32_ATOL)
    from elektronn2_tpu.parallel import spatial_cp_stack
    jfn = spatial_cp_stack([{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                 else v) for k, v in lay.items()}
                            for lay in layers],
                           jax_mesh({"space": 4}, n_devices=4))
    want = np.asarray(jfn(jnp.asarray(s["inputs"]["stack_x"])))
    np.testing.assert_allclose(got, want[:, :, :got.shape[2]], rtol=0,
                               atol=STACK_JAX_RTOL * np.abs(want).max())


def test_halo_cp_rejects_bad_shapes(spawn_dir):
    for res in setup(spawn_dir)["space"]:
        assert res["stack_bad_z"][0] == "ValueError"
        assert "not divisible" in res["stack_bad_z"][1]
        assert res["stack_zpool"][0] == "ValueError"
        assert "z-pooling" in res["stack_zpool"][1]


def test_cp_conv_z_is_the_zero_extended_conv(spawn_dir):
    s = setup(spawn_dir)
    lay = s["inputs"]["layers"][0]
    x = np.concatenate([s["inputs"]["stack_x"],
                        np.zeros((1, 1, 2, 20, 20), np.float32)], axis=2)
    with f32_convs():
        want = torch.relu(torch.nn.functional.conv3d(
            _t(x), _t(lay["w"]), _t(lay["b"]))).numpy()
    for r, res in enumerate(s["space"]):
        np.testing.assert_allclose(res["cp_conv"], want[:, :, 4 * r:4 * r + 4],
                                   rtol=0, atol=F32_ATOL)


# ------------------------------------------------------------ dilated leg

def test_sharded_dilated_dense_equals_unsharded(spawn_dir):
    s = setup(spawn_dir)
    jm, tm, _ = s["models"]["dense"]
    vol = s["inputs"]["dense"]
    got = ranks_equal(s["space"], "dense")
    np.testing.assert_allclose(got, port_dense(tm, vol), rtol=0,
                               atol=F32_ATOL)
    want = np.asarray(jm.predict_dense_sharded(
        jnp.asarray(vol), jax_mesh({"space": 4}, n_devices=4)))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def test_sharded_dense_pad_raw_z_not_divisible(spawn_dir):
    s = setup(spawn_dir)
    jm, tm, _ = s["models"]["dense"]
    vol = s["inputs"]["dense_pad"]                # Z = 30 over 4 ranks
    got = ranks_equal(s["space"], "dense_pad")
    assert got.shape == (2, 30, 40, 40)
    np.testing.assert_allclose(got, port_dense(tm, vol, pad_raw=True),
                               rtol=0, atol=F32_ATOL)
    want = np.asarray(jm.predict_dense_sharded(
        jnp.asarray(vol), jax_mesh({"space": 4}, n_devices=4), pad_raw=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def test_sharded_dense_multihop_halo(spawn_dir):
    # 12 rows over 4 ranks: 3 a shard, and c2's halo at z-dilation 2 is 4
    s = setup(spawn_dir)
    jm, tm, _ = s["models"]["multihop"]
    vol = s["inputs"]["multihop"]
    got = ranks_equal(s["space"], "multihop")
    np.testing.assert_allclose(got, port_dense(tm, vol), rtol=0,
                               atol=F32_ATOL)
    want = np.asarray(jm.predict_dense_sharded(
        jnp.asarray(vol), jax_mesh({"space": 4}, n_devices=4)))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def test_sharded_ptail_runs_k1_per_shard(spawn_dir):
    # K1 (its plain version on the CPU) runs once a rank, on the shard's 4
    # rows plus its 2-row halo, and the map equals the unsharded K1 route
    s = setup(spawn_dir)
    _, tm, _ = s["models"]["ptail"]
    vol = s["inputs"]["ptail"]
    got = ranks_equal(s["space"], "ptail")
    for res in s["space"]:
        assert [c[2] for c in res["ptail_calls"]] == [6]
        assert res["ptail_calls"][0][:2] == (1, 4)
    tm.set_dilated_impl("direct", zfold=True, pallas_tail=True)
    try:
        np.testing.assert_allclose(got, port_dense(tm, vol), rtol=0,
                                   atol=F32_ATOL)
    finally:
        tm.set_dilated_impl("direct")


# --------------------------------------------------------------------- int8

def logits_model(weights):
    """The port's int8 net with its prediction before the softmax, int8."""
    m = S.port_model(S.int8_net, weights, logits=True)
    m.set_compute_dtype("int8")
    return m


def test_int8_sharded_matches_unsharded_exactly(spawn_dir):
    s = setup(spawn_dir)
    jm, tm, w = s["models"]["int8"]
    vol = s["inputs"]["int8"]
    np.testing.assert_array_equal(
        ranks_equal(s["space"], "int8_logits"),
        port_dense(logits_model(w), vol, pad_raw=True))
    got = ranks_equal(s["space"], "int8")
    tm.set_compute_dtype("int8")
    jm.set_compute_dtype("int8")
    try:
        np.testing.assert_allclose(got, port_dense(tm, vol, pad_raw=True),
                                   rtol=0, atol=F32_ATOL)
        want = np.asarray(jm.predict_dense_sharded(
            jnp.asarray(vol), jax_mesh({"space": 4}, n_devices=4),
            pad_raw=True))
    finally:
        tm.set_compute_dtype(None)
        jm.set_compute_dtype(None)
    np.testing.assert_allclose(got, want, rtol=0, atol=INT8_JAX_ATOL)


def test_int8_sharded_exact_adversarial_scale_pollution(spawn_dir):
    # a z-constant input and cancelling taps: the zero-halo rows past the
    # end are the largest activations; masked out, the scale is the
    # unsharded one (Z = 24, and 22 with 2 reflect pad rows)
    s = setup(spawn_dir)
    tm = logits_model(s["models"]["int8_adv"][2])
    got = ranks_equal(s["space"], "int8_adv")
    for g, vol in zip(got, s["inputs"]["int8_adv"]):
        np.testing.assert_array_equal(g, port_dense(tm, vol, pad_raw=True))


def test_int8_dp_sp_batched_matches_unsharded_batched(spawn_dir):
    s = setup(spawn_dir)
    jm, tm, w = s["models"]["int8"]
    vols = s["inputs"]["int8_b"]
    with torch.no_grad(), f32_convs():
        np.testing.assert_array_equal(
            ranks_equal(s["dp_sp"], "int8_logits"),
            dilated_dense_forward(logits_model(w), _t(vols),
                                  batch=True).numpy())
    got = ranks_equal(s["dp_sp"], "int8")
    tm.set_compute_dtype("int8")
    jm.set_compute_dtype("int8")
    try:
        with torch.no_grad(), f32_convs():
            ref = dilated_dense_forward(tm, _t(vols), batch=True).numpy()
        want = np.asarray(jm.predict_dense_sharded_batch(
            jnp.asarray(vols), jax_mesh({"data": 2, "space": 4})))
    finally:
        tm.set_compute_dtype(None)
        jm.set_compute_dtype(None)
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(got, want[:, :, :got.shape[2]], rtol=0,
                               atol=INT8_JAX_ATOL)


def test_f32_dp_sp_batched_matches_unsharded_batched(spawn_dir):
    s = setup(spawn_dir)
    _, tm, _ = s["models"]["dense"]
    got = ranks_equal(s["dp_sp"], "dense")
    with torch.no_grad(), f32_convs():
        ref = dilated_dense_forward(tm, _t(s["inputs"]["dense_b"]),
                                    batch=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)


# ------------------------------------------------------- conv-dense leg

def _unet_ref(tm, vols):
    from elektronn2_tpu_torch.neuromancer.inference import \
        convolutional_dense_forward
    tm.set_convdense_impl(upconv="d2s", zfold=True)
    try:
        return convolutional_dense_forward(tm, _t(vols), batch=True).numpy()
    finally:
        tm.set_convdense_impl()


def test_convdense_sharded_matches_unsharded(spawn_dir):
    # space only (batch unsplit); Z = 24, and 22 with 2 reflect pad rows
    s = setup(spawn_dir)
    jm, tm, _ = s["models"]["unet"]
    got = ranks_equal(s["space"], "unet")
    jm.set_convdense_impl(upconv="d2s", zfold=True)
    try:
        for g, vols in zip(got, s["inputs"]["unet"]):
            np.testing.assert_allclose(g, _unet_ref(tm, vols), rtol=0,
                                       atol=DEC_ATOL)
            want = np.asarray(jm.predict_dense_sharded_batch(
                jnp.asarray(vols), jax_mesh({"space": 4}, n_devices=4),
                batch_axis=None))
            np.testing.assert_allclose(g, want[:, :, :g.shape[2]], rtol=0,
                                       atol=DEC_ATOL)
    finally:
        jm.set_convdense_impl()


def test_convdense_dp_sp_matches_unsharded(spawn_dir):
    s = setup(spawn_dir)
    _, tm, _ = s["models"]["unet"]
    got = ranks_equal(s["dp_sp"], "unet")
    for g, vols in zip(got, s["inputs"]["unet"]):
        np.testing.assert_allclose(g, _unet_ref(tm, vols), rtol=0,
                                   atol=DEC_ATOL)


def test_convdense_sharded_pad_raw(spawn_dir):
    s = setup(spawn_dir)
    _, tm, _ = s["models"]["unet"]
    got = ranks_equal(s["space"], "unet_pad")
    tm.set_convdense_impl(upconv="d2s", zfold=True)
    try:
        want = port_dense(tm, s["inputs"]["unet_pad"], pad_raw=True)
    finally:
        tm.set_convdense_impl()
    assert got.shape == want.shape == (2, 24, 21, 23)
    np.testing.assert_allclose(got, want, rtol=0, atol=DEC_ATOL)


@pytest.mark.parametrize("key, exc, match", [
    ("guard_mz", "UnsupportedGraphError", "M_z"),
    ("guard_tiny", "ValueError", "local z shard"),
    ("guard_int8", "ValueError", "calibrate")])
def test_convdense_sharded_guards(spawn_dir, key, exc, match):
    for res in setup(spawn_dir)["space"]:
        assert res[key] is not None and res[key][0] == exc, res[key]
        assert match in res[key][1]


def test_sharded_batch_not_divisible_by_data_axis(spawn_dir):
    for res in setup(spawn_dir)["dp_sp"]:
        assert res["guard_batch"][0] == "ValueError"
        assert "not divisible by mesh axis 'data'=2" in res["guard_batch"][1]


# ------------------------------------------------------------------ sweeps

def _plain_sweep(s, **kw):
    from elektronn2_tpu_torch.data.knossos_array import KnossosArray
    _, tm, _ = s["models"]["knossos"]
    return tm.sweep_knossos(KnossosArray(s["kdirs"]["sweep"], cube_edge=8),
                            step=[12, 16, 16], **kw)


def test_knossos_sweep_sharded_matches_single(spawn_dir):
    s = setup(spawn_dir)
    got = ranks_equal(s["space"], "sweep")
    plain = _plain_sweep(s)
    np.testing.assert_allclose(got, plain, rtol=0, atol=F32_ATOL)
    jm = s["models"]["knossos"][0]
    want = np.asarray(jm.predict_dense_device(
        jnp.asarray(s["kvol"][None].astype(np.float32) / 255.0),
        pad_raw=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_sweep_slab_batch_without_data_axis_sweeps_per_slab(spawn_dir):
    s = setup(spawn_dir)
    for res in s["space"]:
        assert res["sweep_sb2_warned"]
    got = ranks_equal(s["space"], "sweep_sb2")
    np.testing.assert_allclose(got, _plain_sweep(s), rtol=0, atol=F32_ATOL)


def test_sweep_dp_sp_slab_batch(spawn_dir):
    s = setup(spawn_dir)
    got = ranks_equal(s["dp_sp"], "sweep")
    np.testing.assert_allclose(got, _plain_sweep(s, slab_batch=2), rtol=0,
                               atol=F32_ATOL)
    for res in s["dp_sp"]:
        assert res["sweep_sb3"][0] == "ValueError"
        assert "multiple of mesh axis 'data'=2" in res["sweep_sb3"][1]


def test_convdense_sweep_under_mesh(spawn_dir):
    s = setup(spawn_dir)
    _, tm, _ = s["models"]["unet"]
    got = ranks_equal(s["space"], "sweep_unet")
    karr = s["inputs"]["unet_karr"]
    tm.set_convdense_impl(upconv="d2s", zfold=True)
    try:
        whole = port_dense(tm, karr[None], pad_raw=True)
    finally:
        tm.set_convdense_impl()
    np.testing.assert_allclose(got, whole, rtol=0, atol=DEC_SWEEP_ATOL)


def test_sharded_dense_fresh_weights_after_training(spawn_dir):
    # three trainingsteps between two sharded calls: the second serves
    # the new weights (no stale copy anywhere), equal to the unsharded call
    for res in setup(spawn_dir)["space"]:
        before, after, unsharded = res["fresh"]
        assert not np.allclose(before, after)
        np.testing.assert_allclose(after, unsharded, rtol=0, atol=F32_ATOL)


# ----------------------------------------------------------------- tracing

def test_trace_batch_mesh_b10_on_4_ranks(spawn_dir):
    # B = 10 on 4 ranks: padded to 12 by repeating the last seed, trimmed
    from elektronn2_tpu.data.tracing_utils import DeviceTracer as JaxTracer
    from elektronn2_tpu_torch.data.tracing_utils import DeviceTracer
    s = setup(spawn_dir)
    jm, tm, _ = s["models"]["tracer"]
    vol, seeds = s["inputs"]["trace_vol"], s["inputs"]["trace_seeds"]
    got = ranks_equal(s["space"], "trace")
    plain = DeviceTracer(tm, vol, max_steps=6).trace_batch(seeds)
    want = JaxTracer(jm, vol, max_steps=6, use_pallas_extract=False
                     ).trace_batch(seeds, mesh=jax_mesh({"data": 8}))
    assert len(got) == len(plain) == len(want) == 10
    for g, p, j in zip(got, plain, want):
        assert len(g) == len(p.coords) == len(j.coords)
        np.testing.assert_allclose(g, p.coords, rtol=0, atol=1e-6)
        np.testing.assert_allclose(g, j.coords, rtol=0, atol=TRACE_JAX_ATOL)
    assert any(len(g) > 2 for g in got)


def test_trace_batch_mesh_only_rank0_writes_kzip(spawn_dir):
    res = setup(spawn_dir)["space"]
    assert os.path.exists(res[0]["trace_kzip"])
    assert not any(os.path.exists(r["trace_kzip"]) for r in res[1:])


# ---------------------------------------------------------------- the CLI

def _torchrun(n, args, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run",
           f"--nproc_per_node={n}", "--master_port", str(W.free_port()),
           "-m", "elektronn2_tpu_torch.scripts.predict"] + args
    res = subprocess.run(cmd, cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


def test_predict_cli_torchrun_mesh_sweep(spawn_dir, tmp_path):
    # tests/test_utils_misc.py:242 on 4 CPU ranks: a DP x SP batched sweep
    # through the CLI under torchrun; rank 0 writes the file
    from elektronn2_tpu_torch.utils.basic import h5load
    pytest.importorskip("h5py")
    s = setup(spawn_dir)
    jm = S.knossos_net(jnm)               # saved from its own graph
    mdl = str(tmp_path / "mm.mdl")
    jm.save(mdl)
    out = str(tmp_path / "outm.h5")
    _torchrun(4, [mdl, s["kdirs"]["sweep"], "-o", out, "--cpu", "--mesh",
                  "data=2,space=2", "--slab-batch", "2", "--step",
                  "12,16,16"], tmp_path)
    pred = h5load(out, "prediction")
    ref = np.asarray(jm.predict_dense_device(
        jnp.asarray(s["kvol"][None].astype(np.float32) / 255.0),
        pad_raw=True))
    np.testing.assert_allclose(pred, ref, rtol=0, atol=1e-5)
    assert sorted(os.listdir(tmp_path)) == ["mm.mdl", "outm.h5"]


def test_predict_cli_torchrun_trace_mesh(spawn_dir, tmp_path):
    # --trace --mesh data=2 on two CPU ranks: the agents split over 'data',
    # rank 0 writes the k.zip, equal to the one-process CLI's
    from elektronn2_tpu_torch.data.skeleton import read_nml_file
    from elektronn2_tpu_torch.scripts.predict import main
    from elektronn2_tpu_torch.utils.basic import h5save
    pytest.importorskip("h5py")
    s = setup(spawn_dir)
    jm = S.ff_tracer(jnm)
    step_weights(jm)
    mdl = str(tmp_path / "tr.mdl")
    jm.save(mdl)
    h5 = str(tmp_path / "vol.h5")
    h5save({"raw": s["inputs"]["trace_vol"][0]}, h5)
    seeds = ";".join(",".join(f"{v:.3f}" for v in p)
                     for p in s["inputs"]["trace_seeds"][:5])
    args = [mdl, h5 + ":raw", "--cpu", "--trace", seeds, "--trace-steps",
            "6"]
    _torchrun(2, args + ["-o", str(tmp_path / "two.k.zip"), "--mesh",
                         "data=2"], tmp_path)
    assert main(args + ["-o", str(tmp_path / "one.k.zip")]) == 0
    got, want = (read_nml_file(str(tmp_path / f"{n}.k.zip"))[0]
                 for n in ("two", "one"))
    assert sorted(got) == sorted(want) and len(got) > 5
    np.testing.assert_allclose([got[k] for k in sorted(got)],
                               [want[k] for k in sorted(want)], rtol=0,
                               atol=1e-6)
