"""Data-parallel training of the port (``Model.use_mesh``, the fused
loops, the Trainer's ``mesh_axes``) on two CPU ranks, against the port's
own unsharded run and the JAX package's unsharded step.

Mirrors the JAX package's ``tests/test_parallel.py`` (:34, :41, :743, :919,
:1030, :1060, :1117) and ``tests/test_multihost.py`` (:250, :356), with a
``{data: 1, model: 2}`` tensor-parallel step and ``MalisNLL`` and
``SkelLoss`` on two ranks (their host pass on the global batch). The ranks
are spawned processes joined into one ``gloo`` group on a free port
(``torch_dp_workers.run_ranks``, jax-free); each is fed the global batch
and keeps its rows. Tolerances, as the JAX tests state them: a DP run
against the unsharded one rtol 1e-5 on the loss and rtol 1e-4 / atol 1e-6
on the weights (chunk losses rtol 1e-6, weights rtol 1e-5 / atol 1e-7 for
the fused loops and the checkpoint restart); the two ranks' parameters are
equal bit for bit. The port's unsharded step is held to the JAX package's
at the same tolerances, through loaded weights.
"""

import os
import shutil
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
from elektronn2_tpu_torch.neuromancer.model import modelload  # noqa: E402
from elektronn2_tpu_torch.utils.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)
B = 8
LOSS_RTOL, W_RTOL, W_ATOL = 1e-5, 1e-4, 1e-6
CHUNK_RTOL, CK_RTOL, CK_ATOL = 1e-6, 1e-5, 1e-7
_cache = {}


def once(key, fn):
    """Run a spawn once for the tests that read it."""
    if key not in _cache:
        _cache[key] = fn()
    return _cache[key]


@pytest.fixture(scope="module")
def spawn_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("dp")


def batches(n=2, seed=0):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(B, 1, 16, 16).astype(np.float32) for _ in range(n)]
    ys = [(rng.rand(B, 7, 7) > 0.5).astype(np.int32) for _ in range(n)]
    return xs, ys


def jax_and_port(bn=False, dropout=0.0):
    """The JAX package's build_model and the port's with its weights."""
    jm = W.build_model(jnm, B, bn=bn, dropout=dropout)
    tm = W.build_model(tnm, B, bn=bn, dropout=dropout)
    tm.set_params(params_from_jax(jm.params, tm))
    return jm, tm


def assert_params(got, want, rtol, atol, what=""):
    for n in want:
        for p in want[n]:
            np.testing.assert_allclose(got[n][p], want[n][p], rtol=rtol,
                                       atol=atol, err_msg=f"{what} {n}/{p}")


# ------------------------------------------------------------------ mesh

def _mesh_runs(spawn_dir):
    return once("mesh", lambda: W.run_ranks(spawn_dir / "mesh",
                                            "mesh_construction"))


def test_mesh_construction_and_info(spawn_dir):
    for info in _mesh_runs(spawn_dir):
        assert info["data"] == {"axes": {"data": 2}, "n_devices": 2,
                                "platform": "cpu"}
        assert info["two"]["axes"] == {"data": 1, "space": 2}
        assert info["list"]["axes"] == {"data": 2, "space": 1}
        assert info["default"]["axes"] == {"data": 2}


def test_mesh_axes_must_multiply_to_the_world(spawn_dir):
    for info in _mesh_runs(spawn_dir):
        assert info["bad"] is not None
        assert "do not multiply to 2 devices" in info["bad"]


# ------------------------------------------------------------ DP steps

HYPER = {"SGD": {"lr": 0.05, "mom": 0.0}, "Adam": {"lr": 1e-3}}


def _dp(spawn_dir, opt):
    def run():
        jm, tm = jax_and_port()
        xs, ys = batches()
        ranks = W.run_ranks(spawn_dir / f"dp_{opt}", "dp_steps",
                            weights=W.params_np(tm), xs=xs, ys=ys,
                            optimiser=opt, hyper=HYPER[opt])
        jm.set_opt(opt, **HYPER[opt])
        tm.set_opt(opt, **HYPER[opt])
        jl, tl = [], []
        for i in range(3):
            jl.append(float(jm.trainingstep(xs[i % 2], ys[i % 2])[0]))
            tl.append(float(tm.trainingstep(torch.from_numpy(xs[i % 2]),
                                            torch.from_numpy(ys[i % 2]))[0]))
        jp = {n: {p: np.asarray(v) for p, v in d.items()}
              for n, d in jm.params.items()}
        return ranks, jl, tl, jp, W.params_np(tm)
    return once(("dp", opt), run)


@pytest.mark.parametrize("opt", ["SGD", "Adam"])
def test_dp_trainingstep_matches_unsharded(spawn_dir, opt):
    ranks, jl, tl, jp, tp = _dp(spawn_dir, opt)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)      # port = JAX
    assert_params(tp, jp, W_RTOL, W_ATOL, "port vs JAX")
    for r in ranks:                                         # DP = unsharded
        np.testing.assert_allclose(r["losses"], tl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["losses"], jl, rtol=LOSS_RTOL)
        assert_params(r["params"], tp, W_RTOL, W_ATOL, "DP vs port")
        assert_params(r["params"], jp, W_RTOL, W_ATOL, "DP vs JAX")


@pytest.mark.parametrize("opt", ["SGD", "Adam"])
def test_ranks_hold_equal_params(spawn_dir, opt):
    a, b = _dp(spawn_dir, opt)[0]
    assert a["losses"] == b["losses"]
    for n in a["params"]:
        for p in a["params"][n]:
            assert np.array_equal(a["params"][n][p], b["params"][n][p]), \
                (n, p)


def test_bn_dropout_dp_matches_unsharded(spawn_dir):
    # batch norm's moments over the global batch (a differentiable
    # all-reduce) and dropout's masks drawn at the global batch's shape:
    # the DP run equals the unsharded port step by step, running statistics
    # included; per-rank moments or per-rank masks fail this
    _, tm = jax_and_port(bn=True, dropout=0.3)
    xs, ys = batches()
    ranks = W.run_ranks(spawn_dir / "bn", "dp_steps",
                        weights=W.params_np(tm), xs=xs, ys=ys,
                        optimiser="SGD", hyper=HYPER["SGD"], bn=True,
                        dropout=0.3)
    tm.set_opt("SGD", **HYPER["SGD"])
    tl = [float(tm.trainingstep(torch.from_numpy(xs[i % 2]),
                                torch.from_numpy(ys[i % 2]))[0])
          for i in range(3)]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], tl, rtol=LOSS_RTOL)
        assert_params(r["params"], W.params_np(tm), W_RTOL, W_ATOL)
        for n, d in tm.state.items():
            for k, v in d.items():
                np.testing.assert_allclose(r["state"][n][k], v.numpy(),
                                           rtol=W_RTOL, atol=W_ATOL)


# ------------------------------------------------------------- refusals

def _refusals(spawn_dir):
    def run():
        _, tm = jax_and_port()
        xs, ys = batches(1)
        return W.run_ranks(spawn_dir / "refuse", "refusals",
                           weights=W.params_np(tm), x=xs[0], y=ys[0])
    return once("refuse", run)


def test_batch_not_divisible_raises(spawn_dir):
    for r in _refusals(spawn_dir):
        assert r["batch"] is not None
        assert "a batch of 3" in r["batch"] and "2 ranks" in r["batch"]


def test_model_axis_raises_citing_item_8d(spawn_dir):
    # tensor parallelism is ported (the name is kept from when it was
    # refused): a model axis the mesh lacks is refused, as the JAX package
    # refuses it (a KeyError there), and on {data: 1, model: 2} a step of
    # c1's split channels equals the unsharded step
    from elektronn2_tpu.parallel import make_mesh as jax_mesh
    jm, tm = jax_and_port()
    xs, ys = batches(1)
    tm.set_opt("SGD", lr=0.05)
    loss = float(tm.trainingstep(torch.from_numpy(xs[0]),
                                 torch.from_numpy(ys[0]))[0])
    for r in _refusals(spawn_dir):
        assert "model_axis='model' is not an axis" in r["model_axis"]
        got = r["model_mesh"]
        assert got["shard"] == (2, 1, 3, 3)
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
        assert_params(got["params"], W.params_np(tm), 0, W_ATOL)
    jm.set_opt("SGD", lr=0.05)
    with pytest.raises(KeyError):
        jm.use_mesh(jax_mesh({"data": 8}), model_axis="model")


def _jax_host_pass_steps(jm, batches, extra=False):
    """The JAX package's steps of ``jm`` on ``batches``: the losses and the
    parameters."""
    losses = []
    for a, b in batches:
        if extra:
            losses.append(float(jm.trainingstep(a, None, extra=[b])[0]))
        else:
            losses.append(float(jm.trainingstep(a, b)[0]))
    return {"losses": losses,
            "params": {n: {p: np.asarray(v) for p, v in d.items()}
                       for n, d in jm.params.items()}}


def _host_pass(spawn_dir):
    def run():
        from elektronn2_tpu.data import skeleton as jsk
        from elektronn2_tpu_torch.data import skeleton as tsk
        r = np.random.RandomState(5)
        mb = [(r.rand(2, 1, 6, 6, 6).astype(np.float32),
               r.randint(0, 3, (2, 6, 6, 6)).astype(np.int32))
              for _ in range(2)]
        sb = [(r.randn(4, 8).astype(np.float32),
               np.array([[0, 5, 5, 5 + k] for k in (3, 6, 9, 12)],
                        np.float32)) for _ in range(2)]
        jm, m = W.malis_net(jnm), W.malis_net(tnm)
        m.set_params(params_from_jax(jm.params, m))
        jm.set_opt("SGD", lr=0.5)
        mw = W.params_np(m)
        ref = {"malis": W.host_pass_steps(m, mb)}
        jref = {"malis": _jax_host_pass_steps(jm, mb)}
        for mod in (tsk, jsk):
            mod.clear_skeleton_registry()
        tsk.register_skeleton(W.line_skeleton())
        jsk.register_skeleton(W.line_skeleton(mod=jsk))
        jm, m = W.skel_net(jnm), W.skel_net(tnm)
        m.set_params(params_from_jax(jm.params, m))
        jm.set_opt("Adam", lr=1e-2)
        sw = W.params_np(m)
        ref["skel"] = W.host_pass_steps(m, sb, extra=True)
        jref["skel"] = _jax_host_pass_steps(jm, sb, extra=True)
        for mod in (tsk, jsk):
            mod.clear_skeleton_registry()
        ranks = W.run_ranks(spawn_dir / "host_pass", "host_pass_losses",
                            malis_w=mw, malis_batches=mb, skel_w=sw,
                            skel_batches=sb)
        return ranks, ref, jref
    return once("host_pass", run)


def _assert_host_pass(spawn_dir, loss):
    ranks, ref, jref = _host_pass(spawn_dir)
    np.testing.assert_allclose(ref[loss]["losses"], jref[loss]["losses"],
                               rtol=LOSS_RTOL)              # port = JAX
    assert_params(ref[loss]["params"], jref[loss]["params"], W_RTOL, W_ATOL,
                  "port vs JAX")
    for r in ranks:                         # two ranks = unsharded, both
        np.testing.assert_allclose(r[loss]["losses"], ref[loss]["losses"],
                                   rtol=1e-6)
        assert_params(r[loss]["params"], ref[loss]["params"], 0, W_ATOL,
                      "two ranks vs port")
        np.testing.assert_allclose(r[loss]["losses"], jref[loss]["losses"],
                                   rtol=LOSS_RTOL)
        assert_params(r[loss]["params"], jref[loss]["params"], W_RTOL,
                      W_ATOL, "two ranks vs JAX")


def test_host_pass_loss_refused_on_two_ranks(spawn_dir):
    # MalisNLL trains on two ranks (the name is kept from when it was
    # refused): the pair counting runs on the global batch's rows, each
    # rank keeps its rows, and two steps equal the port's and the JAX
    # package's unsharded ones
    _assert_host_pass(spawn_dir, "malis")


def test_skel_loss_two_ranks_equals_unsharded(spawn_dir):
    # SkelLoss on two ranks: the KD-tree query on the global batch's
    # landing points, each rank's rows kept; two Adam steps equal one
    # process's, the port's and the JAX package's
    _assert_host_pass(spawn_dir, "skel")


def test_graph_key_moves_with_the_mesh(spawn_dir):
    for r in _refusals(spawn_dir):
        assert r["key_moved"] and r["key_has_rank"]


# ---------------------------------------------------------- fused loops

def _fused(spawn_dir):
    def run():
        from elektronn2_tpu_torch.ops.warp import DeviceBatchAugmenter
        from elektronn2_tpu_torch.training.fused_loop import (
            FusedTrainLoop, HostFedFusedLoop)
        tm = W.fused_net(tnm, B)
        w = W.params_np(tm)
        ranks = W.run_ranks(spawn_dir / "fused", "fused_loops", weights=w,
                            steps=3, warp=0.3, seed=3)
        tm.set_opt("SGD", lr=0.05)
        raws, labs = W.fused_cubes()
        aug = DeviceBatchAugmenter(
            raws, labs, patch_size=(5, 16, 16),
            target_size=tuple(tm.prediction_node.shape.spatial_shape),
            target_strides=(1, 2, 2), grey_channels=[0], seed=0,
            device="cpu")
        loop = FusedTrainLoop(tm, aug, batch_size=B, n_inner=3, warp=0.3,
                              seed=3)
        ref = {"fused": [loop.run_chunk()[0] for _ in range(2)],
               "fused_params": W.params_np(tm)}
        tm = W.fused_net(tnm, B)
        tm.set_params(w)
        tm.set_opt("Adam", lr=1e-3)
        loop = HostFedFusedLoop(tm, W.HostBatches(), batch_size=B,
                                n_inner=3, seed=3, prefetch=False)
        ref["hostfed"] = [loop.run_chunk() for _ in range(2)]
        ref["hostfed_params"] = W.params_np(tm)
        loop.close()
        return ranks, ref
    return once("fused", run)


def test_fused_loop_dp_matches_unsharded(spawn_dir):
    ranks, ref = _fused(spawn_dir)
    for r in ranks:
        for got, want in zip(r["fused"], ref["fused"]):
            np.testing.assert_allclose(got, want, rtol=CHUNK_RTOL)
        assert_params(r["fused_params"], ref["fused_params"], CK_RTOL,
                      CK_ATOL)


def test_hostfed_loop_dp_matches_unsharded(spawn_dir):
    ranks, ref = _fused(spawn_dir)
    for r in ranks:
        for (gl, ge), (wl, we) in zip(r["hostfed"], ref["hostfed"]):
            np.testing.assert_allclose(gl, wl, rtol=CHUNK_RTOL)
            np.testing.assert_allclose(ge, we, rtol=CHUNK_RTOL)
        assert_params(r["hostfed_params"], ref["hostfed_params"], CK_RTOL,
                      CK_ATOL)


# ------------------------------------------- recovery, restart, resume

def test_repair_fuckup_under_mesh(spawn_dir):
    _, tm = jax_and_port()
    xs, ys = batches(1)
    for r in W.run_ranks(spawn_dir / "repair", "repair",
                         weights=W.params_np(tm), x=xs[0], y=ys[0]):
        assert r["ok"] and r["restored"] == [True, True]
        assert r["steps"] == [True, True]
        assert np.isfinite(r["loss"])
        assert r["lr"] == pytest.approx(2.5e-3)


def test_checkpoint_restart_under_mesh(spawn_dir):
    # save after 2 DP steps; fresh processes modelload + use_mesh and run 2
    # more: equal to the uninterrupted unsharded 4-step run
    _, tm = jax_and_port()
    xs, ys = batches()
    ck = str(spawn_dir / "ck.mdl")
    assert W.run_ranks(spawn_dir / "ck1", "ckpt_first",
                       weights=W.params_np(tm), xs=xs, ys=ys,
                       path=ck) == [True, True]
    ranks = W.run_ranks(spawn_dir / "ck2", "ckpt_second", xs=xs, ys=ys,
                        path=ck)
    tm.set_opt("Adam", lr=1e-3)
    for i in range(4):
        tm.trainingstep(torch.from_numpy(xs[i % 2]),
                        torch.from_numpy(ys[i % 2]))
    for r in ranks:
        assert r["step0"] == 2
        assert_params(r["params"], W.params_np(tm), CK_RTOL, CK_ATOL)


def test_trainer_resume_with_mesh(spawn_dir):
    from elektronn2_tpu_torch.training.trainer import Trainer
    save = spawn_dir / "tr"
    tm = W.fused_net(tnm, B)
    w = W.params_np(tm)
    first = W.run_ranks(spawn_dir / "tr1", "trainer_run", weights=w,
                        save_path=str(save), n_steps=2, resume=False)
    assert [r["step"] for r in first] == [2, 2]
    assert os.path.isfile(save / "mres-LAST.mdl")    # npz, from rank 0
    ref_dir = spawn_dir / "tr_ref"
    shutil.copytree(save, ref_dir)
    second = W.run_ranks(spawn_dir / "tr2", "trainer_run", weights=w,
                         save_path=str(save), n_steps=4, resume=True)
    ref = Trainer(data=W.HostBatches(seed=3), batch_size=B, n_steps=4,
                  resume=True, history_freq=0, save_freq=0, n_workers=0,
                  save_path=str(ref_dir), save_name="mres", device="cpu")
    assert ref.step == 2
    ref.run()
    for r in second:
        assert r["step0"] == 2 and r["meshed"] and r["step"] == 4
        assert np.isfinite(r["losses"]).all()
        assert_params(r["params"], W.params_np(ref.model), CK_RTOL, CK_ATOL)


def test_torchrun_two_ranks_train_cli(tmp_path):
    # the multi-rank launch: torchrun starts two CPU ranks of the train CLI
    # on examples/neuro3d_pod.py (mesh_axes {"data": 2} from the loader's
    # device count, the same global batch of 4); the weights it saves equal
    # a one-process run's
    import subprocess
    from elektronn2_tpu_torch.neuromancer.model import params_from_model_file
    repo = os.path.dirname(HERE)
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    args = ["-m", "elektronn2_tpu_torch.scripts.train",
            "examples/neuro3d_pod.py", "--cpu", "--n-steps", "8"]
    runs = {"two": [sys.executable, "-m", "torch.distributed.run",
                    "--nproc_per_node=2", "--master_port",
                    str(W.free_port())] + args,
            "one": [sys.executable] + args}
    for name, cmd in runs.items():
        res = subprocess.run(cmd + ["--save-path", str(tmp_path / name)],
                             cwd=repo, env=env, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-3000:]
    got, want = (params_from_model_file(str(tmp_path / n /
                                            "neuro3d_pod-LAST.mdl"))
                 for n in ("two", "one"))
    assert_params(got, want, W_RTOL, W_ATOL)
