"""Tensor parallelism of the port (``Model.use_mesh(model_axis=...)``,
``parallel/tensor_parallel.py``) on eight spawned CPU ranks, against the
port's unsharded runs and the JAX package's.

Mirrors ``tests/test_parallel.py`` :268, :291, :311, :320, :919 and
``tests/test_review_fixes.py:495``, on the JAX tests' mesh ``{data: 2,
model: 4}``: one spawn of eight ``gloo`` ranks
(``torch_scaleout_workers.tp_cases``, jax-free) runs every case; each rank
keeps its shards, and returns the whole parameters gathered, so the ranks
must agree bit for bit. The rule's dims are held to the JAX package's
``use_mesh`` shardings on the conftest's virtual mesh, in this process.

Tolerances, as in ``test_torch_parallel.py``: against the port's unsharded
run the loss rtol 1e-6 and the parameters atol 1e-6 (a sharded conv sums
another way); against the JAX package's unsharded step the JAX tests' rtol
1e-5 on the loss and rtol 1e-4 / atol 1e-6 on the parameters; the fused
chunks' losses rtol 1e-6, as ``test_parallel.py:743`` states them.
"""

import os
import sys

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
from elektronn2_tpu_torch.parallel.tensor_parallel import tp_dims  # noqa: E402
from elektronn2_tpu_torch.utils.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)
LOSS_RTOL, W_ATOL = 1e-6, 1e-6
JAX_LOSS_RTOL, JAX_W_RTOL, JAX_W_ATOL = 1e-5, 1e-4, 1e-6
B = 4
_cache = {}


def once(key, fn):
    if key not in _cache:
        _cache[key] = fn()
    return _cache[key]


@pytest.fixture(scope="module")
def spawn_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("tp")


def assert_params(got, want, rtol, atol, what=""):
    for n in want:
        for p in want[n]:
            np.testing.assert_allclose(got[n][p], want[n][p], rtol=rtol,
                                       atol=atol, err_msg=f"{what} {n}/{p}")


def jax_params(jm):
    return {n: {p: np.asarray(v) for p, v in d.items()}
            for n, d in jm.params.items()}


def t(a):
    return torch.from_numpy(np.asarray(a))


def _runs(spawn_dir):
    def run():
        from elektronn2_tpu_torch.ops.warp import DeviceBatchAugmenter
        from elektronn2_tpu_torch.training.fused_loop import (
            FusedTrainLoop, HostFedFusedLoop)
        from elektronn2_tpu_torch.training.trainer import Trainer
        r = np.random.RandomState(0)
        x = [r.randn(B, 1, 16, 16).astype(np.float32) for _ in range(2)]
        y = [(r.rand(B, 7, 7) > 0.5).astype(np.int32) for _ in range(2)]
        xp = r.randn(4, 12).astype(np.float32)
        yp = r.randn(4, 8).astype(np.float32)
        ref = {}
        # each build's unsharded references right after it (the next
        # build resets the graph)
        jm = W.build_model(jnm, B)
        tm = W.build_model(tnm, B)
        tm.set_params(params_from_jax(jm.params, tm))
        w2d = W.params_np(tm)
        jm.set_opt("Adam", lr=1e-3)
        tm.set_opt("Adam", lr=1e-3)
        ref["jax_losses"] = [float(jm.trainingstep(x[i % 2], y[i % 2])[0])
                             for i in range(3)]
        ref["jax_params"] = jax_params(jm)
        ref["losses"] = [float(tm.trainingstep(t(x[i % 2]), t(y[i % 2]))[0])
                         for i in range(3)]
        ref["params"] = W.params_np(tm)
        ref["predict"] = tm.predict(t(x[0])).numpy()
        ref["resumed_loss"] = float(tm.trainingstep(t(x[1]), t(y[1]))[0])
        ref["resumed"] = W.params_np(tm)
        jm = S.perceptron_net(jnm)
        tm = S.perceptron_net(tnm)
        tm.set_params(params_from_jax(jm.params, tm))
        wp = W.params_np(tm)
        ref["jax_perceptron_loss"] = float(jm.trainingstep(xp, yp)[0])
        ref["jax_perceptron"] = jax_params(jm)
        ref["perceptron_loss"] = float(tm.trainingstep(t(xp), t(yp))[0])
        ref["perceptron"] = W.params_np(tm)
        tm = W.build_model(tnm, B, bn=True, dropout=0.3)
        wbn = W.params_np(tm)
        tm.set_opt("SGD", lr=0.05, clip=0.05)
        ref["bn_losses"] = [float(tm.trainingstep(t(x[i]), t(y[i]))[0])
                            for i in range(2)]
        ref["bn"] = W.params_np(tm)
        ref["bn_state"] = {n: {k: v.numpy().copy() for k, v in d.items()}
                           for n, d in tm.state.items()}
        ref["bn_gnorm"] = float(tm.trainingstep(t(x[0]), t(y[0]))[1][
            "gradnorm"])
        tm = S.tp_fused_net(tnm, 8)
        wf = W.params_np(tm)
        tm.set_opt("Adam", lr=1e-3)
        raws, labs = W.fused_cubes()
        aug = DeviceBatchAugmenter(
            raws, labs, patch_size=(4, 12, 12),
            target_size=tuple(tm.prediction_node.shape.spatial_shape),
            grey_channels=[0], seed=3, device="cpu")
        loop = FusedTrainLoop(tm, aug, batch_size=8, n_inner=3, warp=0.5,
                              seed=3)
        ref["fused"] = loop.run_chunk()[0]
        ref["fused_params"] = W.params_np(tm)
        vol = torch.from_numpy(np.random.RandomState(4).rand(
            1, 8, 20, 20).astype(np.float32))
        ref["dense"] = tm.predict_dense_device(vol, pad_raw=True).numpy()
        tm = S.tp_fused_net(tnm, 8)
        tm.set_params(wf)
        tm.set_opt("SGD", lr=0.05)
        loop = HostFedFusedLoop(tm, W.HostBatches(shape=(4, 12, 12),
                                                  tshape=(4, 10, 10)),
                                batch_size=8, n_inner=3, seed=3,
                                prefetch=False)
        ref["hostfed"] = [loop.run_chunk()[0] for _ in range(2)]
        ref["hostfed_params"] = W.params_np(tm)
        loop.close()
        tm = S.tp_fused_net(tnm, 8)
        tm.set_params(wf)
        tm.set_opt("Adam", lr=1e-3)
        tr = Trainer(model=tm, data=W.HostBatches(seed=3, shape=(4, 12, 12),
                                                  tshape=(4, 10, 10)),
                     batch_size=8, n_steps=2, history_freq=0, save_freq=0,
                     n_workers=0, save_path=str(spawn_dir / "tr_ref"),
                     save_name="t", device="cpu")
        tr.run()
        ref["trainer"] = W.params_np(tr.model)
        ranks = W.run_ranks(spawn_dir / "tp", "torch_scaleout_workers:"
                            "tp_cases", world=8, w2d=w2d, x=x, y=y, wp=wp,
                            xp=xp, yp=yp, wbn=wbn, wf=wf,
                            tmp=str(spawn_dir))
        return ranks, ref
    return once("tp", run)


def test_ranks_agree_bit_for_bit(spawn_dir):
    ranks, _ = _runs(spawn_dir)
    for r in ranks[1:]:
        for key in ("losses", "bn_losses", "perceptron_loss",
                    "resumed_loss"):
            assert r[key] == ranks[0][key], key
        for key in ("params", "bn", "perceptron", "fused_params",
                    "hostfed_params", "trainer", "resumed"):
            for n, d in r[key].items():
                for p, v in d.items():
                    assert np.array_equal(v, ranks[0][key][n][p]), (key, n)


def test_dp_tp_trainingstep_matches_unsharded(spawn_dir):
    # test_parallel.py:268: three Adam steps on {data: 2, model: 4}
    ranks, ref = _runs(spawn_dir)
    np.testing.assert_allclose(ref["losses"], ref["jax_losses"],
                               rtol=JAX_LOSS_RTOL)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["losses"], ref["jax_losses"],
                                   rtol=JAX_LOSS_RTOL)
        assert_params(r["params"], ref["params"], 0, W_ATOL, "vs port")
        assert_params(r["params"], ref["jax_params"], JAX_W_RTOL,
                      JAX_W_ATOL, "vs JAX")


def test_tp_params_actually_sharded(spawn_dir):
    # test_parallel.py:291: c1's 4 output channels split 4 ways (each rank
    # holds 1), its slots follow it; the 2-channel head does not divide
    # and stays whole
    ranks, _ = _runs(spawn_dir)
    for r in ranks:
        assert r["dims"] == {"c1": {"w": 0, "b": 0}}
        assert r["shard_shapes"]["c1"] == {"w": (1, 1, 3, 3), "b": (1,)}
        assert r["shard_shapes"]["conv"]["w"] == (2, 4, 1, 1)
        for slots in r["slot_shapes"]:                   # Adam's m and v
            assert slots == r["shard_shapes"]
        assert r["spatial_dims"]["c1"] == {"w": 0, "b": 0}
        assert r["spatial_dims"]["conv"] == {"w": None, "b": None}


@pytest.mark.parametrize("net", ["build_model", "perceptron_net",
                                 "tp_fused_net", "upconv_net"])
def test_sharding_rule_matches_jax(net):
    # the rule's dims against the JAX package's use_mesh shardings on the
    # conftest's virtual {data: 2, model: 4} mesh (Conv and UpConv w on
    # dim 0, Perceptron w on dim 1, biases on dim 0, where 4 divides)
    from elektronn2_tpu.parallel import make_mesh as jax_mesh
    build = {"build_model": lambda nm: W.build_model(nm, B),
             "perceptron_net": S.perceptron_net,
             "tp_fused_net": S.tp_fused_net,
             "upconv_net": upconv_net}[net]
    jm = build(jnm)
    jm.set_opt("Adam", lr=1e-3)
    jm.use_mesh(jax_mesh({"data": 2, "model": 4}), model_axis="model")
    want = {}
    for n, d in jm.params.items():
        for p, v in d.items():
            spec = tuple(v.sharding.spec)
            if "model" in spec:
                want.setdefault(n, {})[p] = spec.index("model")
    tm = build(tnm)
    assert tp_dims(tm.nodes, 4) == want
    assert want


def upconv_net(nm):
    """An encoder-decoder with an UpConv of 8 features (split on dim 0)."""
    nm.model_manager.reset(seed=3)
    inp = nm.Input([2, 1, 4, 12, 12], "b,f,z,x,y", name="raw")
    e = nm.Conv(inp, 4, (1, 3, 3), (1, 2, 2), name="e")
    up = nm.UpConv(e, 8, (1, 2, 2), activation_func="relu", name="up")
    probs = nm.Softmax(nm.Conv(up, 2, 1, 1, activation_func="lin"))
    tgt = nm.Input([2, *probs.shape.spatial_shape], "b,z,x,y",
                   dtype="int32", name="target")
    loss = nm.AggregateLoss(nm.MultinoulliNLL(probs, tgt,
                                              target_is_sparse=True))
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=probs)
    return m


def test_tp_predict_runs_the_sharded_forward(spawn_dir):
    # test_parallel.py:311
    ranks, ref = _runs(spawn_dir)
    for r in ranks:
        assert r["predict"].shape == (B, 2, 7, 7)
        assert np.isfinite(r["predict"]).all()
        np.testing.assert_allclose(r["predict"], ref["predict"], rtol=0,
                                   atol=W_ATOL)


def test_tp_checkpoint_is_whole_and_resumes(spawn_dir):
    # save writes the gathered whole tensors from the mesh's first rank;
    # modelload + use_mesh(model_axis=) shards them again and a fourth
    # step equals the uninterrupted unsharded run's
    from elektronn2_tpu_torch.neuromancer.model import params_from_model_file
    ranks, ref = _runs(spawn_dir)
    saved = params_from_model_file(str(spawn_dir / "tp.mdl"))
    assert_params(saved, ranks[0]["params"], 0, 0)
    for r in ranks:
        assert r["resumed_step0"] == 3
        np.testing.assert_allclose(r["resumed_loss"], ref["resumed_loss"],
                                   rtol=LOSS_RTOL)
        assert_params(r["resumed"], ref["resumed"], 0, W_ATOL)


def test_tp_perceptron_sharded_on_output_dim(spawn_dir):
    # test_review_fixes.py:495: fc1's w (12, 16) split on dim 1, not 0
    ranks, ref = _runs(spawn_dir)
    for r in ranks:
        assert r["fc1_w_shard"] == (12, 4)
        np.testing.assert_allclose(r["perceptron_loss"],
                                   ref["perceptron_loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["perceptron_loss"],
                                   ref["jax_perceptron_loss"],
                                   rtol=JAX_LOSS_RTOL)
        assert_params(r["perceptron"], ref["perceptron"], 0, W_ATOL)
        assert_params(r["perceptron"], ref["jax_perceptron"], JAX_W_RTOL,
                      JAX_W_ATOL)


def test_tp_clip_batchnorm_dropout_match_unsharded(spawn_dir):
    # the global gradient norm counts each shard once (the clip is active:
    # the norm is ~6x the clip), batch norm and dropout run on the joined
    # channels: two SGD steps equal the unsharded ones, running statistics
    # included
    ranks, ref = _runs(spawn_dir)
    assert ref["bn_gnorm"] > 0.05
    for r in ranks:
        np.testing.assert_allclose(r["bn_losses"], ref["bn_losses"],
                                   rtol=LOSS_RTOL)
        assert_params(r["bn"], ref["bn"], 0, W_ATOL)
        assert_params(r["bn_state"], ref["bn_state"], 0, W_ATOL)


def test_tp_fused_loop_matches_unsharded(spawn_dir):
    # test_parallel.py:320: FusedTrainLoop's eager chunk under TP; the
    # model group is part of the graph key
    ranks, ref = _runs(spawn_dir)
    for r in ranks:
        np.testing.assert_allclose(r["fused"], ref["fused"], rtol=LOSS_RTOL)
        assert_params(r["fused_params"], ref["fused_params"], 0, W_ATOL)
        assert r["fused_key_has_tp"]


def test_tp_hostfed_loop_matches_unsharded(spawn_dir):
    # test_parallel.py:919 under TP: two host-fed chunks
    ranks, ref = _runs(spawn_dir)
    for r in ranks:
        for got, want in zip(r["hostfed"], ref["hostfed"]):
            np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        assert_params(r["hostfed_params"], ref["hostfed_params"], 0, W_ATOL)


def test_tp_dense_serving_uses_whole_weights(spawn_dir):
    # predict_dense_device under TP serves the gathered whole weights: the
    # unsharded model's map on the same trained weights
    ranks, ref = _runs(spawn_dir)
    for r in ranks:
        np.testing.assert_allclose(r["dense"], ref["dense"], rtol=0,
                                   atol=W_ATOL)
        assert r["dense_again_same_tensors"]


def test_trainer_mesh_axes_with_a_model_axis(spawn_dir):
    # the Trainer's mesh_axes {"data": 2, "model": 4} trains tensor-parallel
    # and equals the unsharded Trainer's two steps
    ranks, ref = _runs(spawn_dir)
    for r in ranks:
        assert r["trainer_tp"]
        assert_params(r["trainer"], ref["trainer"], 0, W_ATOL)


def test_missing_model_axis_is_refused_as_by_jax(spawn_dir):
    # a model axis the mesh lacks: the JAX package refuses it too
    from elektronn2_tpu.parallel import make_mesh as jax_mesh
    ranks, _ = _runs(spawn_dir)
    for r in ranks:
        assert r["bad_axis"].startswith("ValueError")
        assert "model_axis='nope'" in r["bad_axis"]
    jm = W.build_model(jnm, B)
    jm.set_opt("Adam", lr=1e-3)
    with pytest.raises(KeyError):
        jm.use_mesh(jax_mesh({"data": 2, "model": 4}), model_axis="nope")
