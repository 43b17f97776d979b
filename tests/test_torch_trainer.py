"""The port's training entry point against the JAX package's, on the CPU.

Covers ``elektronn2_tpu_torch/training/{parallelisation,trainutils,
trainer,fused_loop}.py`` (``BackgroundProc``, ``SharedMem``, ``Schedule``,
``HistoryTracker``, the ``Trainer``, ``HostFedFusedLoop``),
``config.py`` and ``scripts/train.py``; mirrors tests/test_training.py.

Both packages train from the same weights (a ``.mdl`` the JAX package
saved, loaded by each through ``model_load_path``) on the same batches (the
data sources' ``rng`` set to equal ``RandomState``s; ``n_workers=0``).
Tolerance of the per-step losses: rtol 1e-5, ``LOSS_RTOL`` of
test_torch_train.py for the neuro3d net (float32 convs and their gradients
summed in another order by XLA and by PyTorch), with an atol of 1e-5 times
the first step's loss: the synthetic neuro3d labels are almost all one
class, the loss falls to ~1e-5 within a few steps, and a loss near zero has
no relative precision to hold (test_torch_train.py's gradient tolerance
makes the same allowance). The eager ``HostFedFusedLoop`` chunk must equal
K sequential ``trainingstep`` calls on the same batches exactly.
"""

import multiprocessing as mp
import os
import sys

import numpy as np
import pytest
import torch

import elektronn2_tpu.neuromancer as jnm
from elektronn2_tpu.config import ExperimentConfig as JaxConfig
from elektronn2_tpu.data.cnndata import BatchCreatorImage as JaxBCI
from elektronn2_tpu.training import trainutils as jtu
from elektronn2_tpu.training.trainer import Trainer as JaxTrainer
import elektronn2_tpu_torch.neuromancer as tnm
from elektronn2_tpu_torch import config as tconfig
from elektronn2_tpu_torch.config import ExperimentConfig
from elektronn2_tpu_torch.data.cnndata import BatchCreatorImage
from elektronn2_tpu_torch.neuromancer.model import Model
from elektronn2_tpu_torch.ops.warp import DeviceBatchAugmenter
from elektronn2_tpu_torch.scripts import train as train_cli
from elektronn2_tpu_torch.training import trainutils as ttu
from elektronn2_tpu_torch.training.fused_loop import HostFedFusedLoop
from elektronn2_tpu_torch.training.parallelisation import (BackgroundProc,
                                                           SharedMem)
from elektronn2_tpu_torch.training.trainer import Trainer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEURO3D = os.path.join(REPO, "examples", "neuro3d.py")
NEURO2D = os.path.join(REPO, "examples", "neuro2d.py")
UNET3D = os.path.join(REPO, "examples", "unet3d.py")
LOSS_RTOL = 1e-5


def assert_losses_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL,
                               atol=LOSS_RTOL * abs(want[0]))


# ----------------------------------------------------------------- workers

@pytest.mark.parametrize("mode", ["thread", "process", "spawn"])
def test_background_proc_produces_and_shuts_down(mode):
    with BackgroundProc(np.random.rand, n_proc=2, target_args=(4,),
                        mode=mode) as bg:
        items = [bg.get(timeout=60) for _ in range(6)]
    assert all(it.shape == (4,) for it in items)
    # forked workers are reseeded: 6 draws from 2 workers are not 2 streams
    assert len({tuple(np.round(it, 6)) for it in items}) >= 4
    if mode != "thread":
        assert not any(w.is_alive() for w in bg._workers)


@pytest.mark.parametrize("mode", ["thread", "process", "spawn"])
def test_background_proc_propagates_errors(mode):
    bg = BackgroundProc(np.random.rand, n_proc=1, target_args=(-1,),
                        mode=mode)
    with pytest.raises(RuntimeError, match="worker"):
        bg.get(timeout=60)
    bg.shutdown()
    with pytest.raises(ValueError, match="mode"):
        BackgroundProc(np.random.rand, mode="nope")


def test_background_proc_reseeds_the_data_source():
    # a forked getbatch draws from its own RandomState (the Trainer's
    # worker path): two workers over one BatchCreatorImage give distinct
    # batches
    r = np.random.RandomState(0)
    raws = [r.rand(1, 16, 16, 16).astype(np.float32)]
    bc = BatchCreatorImage(input_data=raws,
                           target_data=[(raws[0][0] > .5).astype(np.int16)])
    bc.set_geometry((6, 6, 6))
    bc.rng = np.random.RandomState(1)
    with BackgroundProc(bc.getbatch, n_proc=2, target_args=(1,),
                        target_kwargs={"warp": 0.5}) as bg:
        got = [bg.get(timeout=60)[0] for _ in range(4)]
    assert len({b.tobytes() for b in got}) == 4


def _sharedmem_child(name, shape):
    v = SharedMem.attach(name, shape, np.float32)
    v.array[:] *= 2.0
    v.close()


def test_sharedmem_cross_process():
    with SharedMem.alloc((3, 4), np.float32) as shm:
        shm.array[:] = np.arange(12, dtype=np.float32).reshape(3, 4)
        p = mp.get_context("spawn").Process(target=_sharedmem_child,
                                            args=(shm.name, shm.shape))
        p.start()
        p.join(120)
        assert p.exitcode == 0
        np.testing.assert_array_equal(
            shm.array, np.arange(12, dtype=np.float32).reshape(3, 4) * 2)
        assert "owner" in repr(shm)


# ----------------------------------------------------------- trainutils

SCHEDULES = {
    "dec": (dict(dec=0.5, interval=10), 0, range(1, 25)),
    "lindec": (dict(lindec=100), 0, (10, 50, 75, 99)),
    "lindec_resume": (dict(lindec=10000), 5000, (5000, 7500, 9999)),
    "updates": (dict(updates=[(5, 0.1), (10, 0.01)]), 0, range(1, 12)),
    "updates_catch_up": (dict(updates=[(5, 0.1), (10, 0.01), (20, 0.001)]),
                         12, (12, 13, 20)),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
@pytest.mark.parametrize("bind", ["object", "optimiser"])
def test_schedule_equals_jax(case, bind):
    from elektronn2_tpu.neuromancer.optimiser import Adam as JAdam
    from elektronn2_tpu_torch.neuromancer.optimiser import Adam as TAdam
    kw, start, steps = SCHEDULES[case]
    seqs = []
    for tu, adam in ((jtu, JAdam), (ttu, TAdam)):
        if bind == "object":
            obj = type("Obj", (), {"lr": 0.5 if start else 1.0})()
        else:
            obj = adam(lr=0.5 if start else 1.0)
        s = tu.Schedule(**kw).bind_variable(obj=obj, prop_name="lr",
                                            start_step=start,
                                            total_steps=10000 if start
                                            else None)
        vals = []
        for step in steps:
            s.update(step, 100 if case == "lindec" else
                     (10000 if start else None))
            vals.append(obj.lr if bind == "object"
                        else obj.hyperparams["lr"])
        seqs.append(vals)
    assert seqs[0] == seqs[1]
    if bind == "optimiser":
        assert isinstance(s._get(), float)
    with pytest.raises(ValueError, match="exactly one"):
        ttu.Schedule(dec=0.5, lindec=10)


def test_history_tracker_file_equals_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    hs = []
    for tu in (jtu, ttu):
        h = tu.HistoryTracker()
        for i in range(1, 21):
            h.update_timeline(i, 1.0 / i, debug={"gn": np.full(3, i)})
        h.update_history(10, 0.5, 0.2, 0.6, 0.25)
        h.update_history(20, 0.4, None)
        hs.append(h)
    hs[0].save(str(tmp_path / "j"))
    hs[1].save(str(tmp_path / "t"))
    with h5py.File(tmp_path / "j.history.h5") as fj, \
            h5py.File(tmp_path / "t.history.h5") as ft:
        assert sorted(fj) == sorted(ft) == ["debug_gn", "history",
                                            "timeline"]
        for k in fj:
            a, b = fj[k][()], ft[k][()]
            assert a.shape == b.shape and a.dtype == b.dtype
            if k == "timeline":                 # column 0 is wall time
                a, b = a[:, 1:], b[:, 1:]
            elif k == "history":                # column 1 is wall time
                a, b = a[:, [0, 2, 3, 4, 5]], b[:, [0, 2, 3, 4, 5]]
            np.testing.assert_array_equal(a, b)
    assert hs[0].loss_smooth == hs[1].loss_smooth


def test_history_tracker_without_h5py_warns(tmp_path, monkeypatch):
    said = []
    monkeypatch.setitem(sys.modules, "h5py", None)      # import fails
    monkeypatch.setattr(ttu.logger, "warning", said.append)
    h = ttu.HistoryTracker()
    h.update_timeline(1, 0.5)
    h.save(str(tmp_path / "x"))
    assert not os.path.exists(tmp_path / "x.history.h5")
    assert len(said) == 1 and "h5py" in said[0]


def test_history_report_and_small_utils(tmp_path):
    h = ttu.HistoryTracker()
    for i in range(10):
        h.update_timeline(i, 1.0 / (i + 1))
    h.update_history(5, 0.5, 0.2, 0.6, 0.25)
    h.plot(str(tmp_path / "r"))
    html = open(h.html_report(str(tmp_path / "r"))).read()
    assert "smoothed loss" in html
    for t in (3700, 75, 5, 0.4):
        assert ttu.pretty_string_time(t) == jtu.pretty_string_time(t)
    assert ttu.user_input is ttu.ConsoleControl


# ---------------------------------------------------------- the Trainer

@pytest.fixture(scope="module")
def neuro3d_init(tmp_path_factory):
    """The neuro3d config's model built and saved by the JAX package."""
    path = str(tmp_path_factory.mktemp("init") / "neuro3d-init.mdl")
    JaxConfig.from_file(NEURO3D).create_model().save(path)
    return path


def test_trainer_neuro3d_matches_jax(neuro3d_init, tmp_path):
    ov = dict(n_steps=6, history_freq=3, save_freq=0, n_workers=0)
    jt = JaxTrainer(JaxConfig.from_file(
        NEURO3D, override=dict(ov, save_path=str(tmp_path / "j"))),
        model_load_path=neuro3d_init)
    tt = Trainer(ExperimentConfig.from_file(
        NEURO3D, override=dict(ov, save_path=str(tmp_path / "t"))),
        model_load_path=neuro3d_init, device="cpu")
    assert isinstance(tt.model, Model) and isinstance(tt.data,
                                                      BatchCreatorImage)
    jt.data.rng = np.random.RandomState(5)
    tt.data.rng = np.random.RandomState(5)
    jh, th = jt.run(), tt.run()
    jl, tl = jh.timeline.data, th.timeline.data
    np.testing.assert_array_equal(tl[:, 1], np.arange(1, 7))
    np.testing.assert_array_equal(jl[:, 1], tl[:, 1])
    assert_losses_close(tl[:, 2], jl[:, 2])
    np.testing.assert_array_equal(th.history.data[:, 0], [3, 6])
    assert_losses_close(th.history.data[:, [2, 4]].ravel(),
                        jh.history.data[:, [2, 4]].ravel())
    assert tl[-1, 3] < tl[0, 3] * 0.98                 # the loss falls
    assert tt.model._step_count == 6 and tt.step == 6
    assert os.path.exists(tmp_path / "t" / "neuro3d-LAST.mdl")


def small_net(nm, B=2):
    """The fused-loop net of tests/test_training.py (seed 21)."""
    nm.model_manager.reset(seed=21)
    inp = nm.Input([B, 1, 8, 16, 16], "b,f,z,x,y", name="raw")
    c1 = nm.Conv(inp, 6, (3, 3, 3), (1, 2, 2), name="c1")
    probs = nm.Softmax(nm.Conv(c1, 2, 1, 1, activation_func="lin"))
    tgt = nm.Input([B, *probs.shape.spatial_shape], "b,z,x,y",
                   dtype="int32", name="target")
    loss = nm.AggregateLoss(nm.MultinoulliNLL(probs, tgt,
                                              target_is_sparse=True))
    err = nm.Errors(probs, tgt, target_is_sparse=True)
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=probs, error_node=err)
    return m


def small_data(cls=BatchCreatorImage, seed=1):
    r = np.random.RandomState(seed)
    raws = [r.rand(1, 24, 40, 40).astype(np.float32) for _ in range(2)]
    labs = [(x[0] > 0.5).astype(np.int16) for x in raws]
    d = cls(input_data=raws, target_data=labs, valid_cubes=[1])
    d.rng = np.random.RandomState(seed + 10)
    return d


@pytest.fixture
def small_init(tmp_path):
    path = str(tmp_path / "small-init.mdl")
    small_net(jnm).save(path)
    return path


def _trainer(cls, init, tmp_path, name, **kw):
    data = small_data(JaxBCI if cls is JaxTrainer else BatchCreatorImage)
    extra = {} if cls is JaxTrainer else {"device": "cpu"}
    args = dict(model_load_path=init, data=data, batch_size=2,
                history_freq=0, save_freq=0, n_workers=0,
                save_path=str(tmp_path), save_name=name,
                data_batch_args={"warp": 0.5})
    args.update(kw)
    return cls(**args, **extra)


def test_trainer_host_fed_fused_matches_jax(small_init, tmp_path):
    # 2 chunks of 4 through HostFedFusedLoop; nothing else draws from the
    # data source while the prefetch thread does (a validation or a tail
    # batch would race it for the RandomState, in both packages)
    kw = dict(n_steps=8, fused_steps=4)
    jh = _trainer(JaxTrainer, small_init, tmp_path, "jf", **kw).run()
    tr = _trainer(Trainer, small_init, tmp_path, "tf", **kw)
    th = tr.run()
    assert isinstance(tr.fused_loop, HostFedFusedLoop)
    assert tr.step == 8 and tr.model._step_count == 8
    np.testing.assert_array_equal(th.timeline.data[:, 1], np.arange(1, 9))
    assert_losses_close(th.timeline.data[:, 2], jh.timeline.data[:, 2])
    # with validation under data_lock and a 2-step tail of plain steps
    tr = _trainer(Trainer, small_init, tmp_path, "tt", n_steps=10,
                  fused_steps=4, history_freq=4)
    th = tr.run()
    assert tr.step == 10 and tr.model._step_count == 10
    assert np.isfinite(th.timeline.data[:, 2]).all()
    np.testing.assert_array_equal(th.history.data[:, 0], [4, 8])


@pytest.mark.parametrize("prefetch", [False, True])
def test_host_fed_chunk_equals_sequential_steps(small_init, prefetch):
    from elektronn2_tpu_torch.neuromancer.model import modelload
    K, B = 3, 2
    m = modelload(small_init, device="cpu")
    m.set_opt("Adam", lr=1e-3)
    data = small_data().link_model_geometry(m)
    drawn = []
    getbatch = data.getbatch

    def recording(*a, **kw):
        drawn.append(getbatch(*a, **kw))
        return drawn[-1]

    data.getbatch = recording
    loop = HostFedFusedLoop(m, data, B, K, batch_args={"warp": 0.5},
                            prefetch=prefetch)
    m.snapshot_good()
    losses, errs = loop.run_chunk()
    loop.close()
    assert losses.shape == errs.shape == (K,)
    assert m._step_count == K and int(m.opt_state["step"]) == K
    after = {n: {p: v.clone() for p, v in d.items()}
             for n, d in m.params.items()}
    m.repair_fuckup()
    seq, seq_err = [], []
    for d, t in drawn[:K]:
        loss, aux = m.trainingstep(d, t)
        seq.append(float(loss))
        seq_err.append(float(aux["error"]))
    np.testing.assert_array_equal(losses, np.float32(seq))
    np.testing.assert_array_equal(errs, np.float32(seq_err))
    for n, d in after.items():
        for p, v in d.items():
            assert torch.equal(m.params[n][p], v), (n, p)
    # the next chunk draws the next K batches
    loop2 = HostFedFusedLoop(m, data, B, K, batch_args={"warp": 0.5},
                             prefetch=False)
    loop2.run_chunk()
    assert len(drawn) >= 2 * K and not np.array_equal(drawn[0][0],
                                                      drawn[K][0])


def test_trainer_unet3d_host_fed_matches_jax(tmp_path):
    # the decoder config (UpConv, FaithlessMerge) at its own widths: host
    # batches from BatchCreatorImage through HostFedFusedLoop (its
    # fused_steps, one chunk of 8), from the same JAX-saved weights and
    # equal data rngs in both packages
    init = str(tmp_path / "unet3d-init.mdl")
    JaxConfig.from_file(UNET3D).create_model().save(init)
    ov = dict(n_steps=8, history_freq=0, save_freq=0)
    jt = JaxTrainer(JaxConfig.from_file(
        UNET3D, override=dict(ov, save_path=str(tmp_path / "j"))),
        model_load_path=init)
    tt = Trainer(ExperimentConfig.from_file(
        UNET3D, override=dict(ov, save_path=str(tmp_path / "t"))),
        model_load_path=init, device="cpu")
    jt.data.rng = np.random.RandomState(7)
    tt.data.rng = np.random.RandomState(7)
    jh, th = jt.run(), tt.run()
    assert isinstance(tt.fused_loop, HostFedFusedLoop)
    assert tt.fused_loop.n_inner == 8 and tt.step == 8
    np.testing.assert_array_equal(th.timeline.data[:, 1], np.arange(1, 9))
    assert_losses_close(th.timeline.data[:, 2], jh.timeline.data[:, 2])
    assert os.path.exists(tmp_path / "t" / "unet3d-LAST.mdl")


def test_trainer_neuro2d_matches_jax_on_its_batches(tmp_path):
    # 2-D data through the Trainer: the config's DeviceBatchAugmenter
    # promotes the 2-D images inside and draws from the port's own stream,
    # so the JAX model (same saved weights, same optimiser from the same
    # config) takes the batches the port's Trainer recorded, step by step
    init = str(tmp_path / "neuro2d-init.mdl")
    JaxConfig.from_file(NEURO2D).create_model().save(init)
    ov = dict(n_steps=4, history_freq=0, save_freq=0)
    tt = Trainer(ExperimentConfig.from_file(
        NEURO2D, override=dict(ov, save_path=str(tmp_path / "t"))),
        model_load_path=init, device="cpu")
    assert isinstance(tt.data, DeviceBatchAugmenter)
    fed, step = [], tt.model.trainingstep

    def recorded(d, t, **kw):
        fed.append((d.numpy().copy(), t.numpy().copy()))
        return step(d, t, **kw)
    tt.model.trainingstep = recorded
    th = tt.run()
    assert len(fed) == 4 and fed[0][0].ndim == 4     # (b, f, x, y)
    assert tuple(fed[0][0].shape[2:]) == tuple(
        tt.model.input_node.shape.spatial_shape)
    jt = JaxTrainer(JaxConfig.from_file(
        NEURO2D, override=dict(ov, save_path=str(tmp_path / "j"))),
        model_load_path=init)
    jl = [float(jt.model.trainingstep(d, t)[0]) for d, t in fed]
    assert_losses_close(th.timeline.data[:, 2], jl)
    assert os.path.exists(tmp_path / "t" / "neuro2d-LAST.mdl")


def test_trainer_device_sampled_fused_and_tail(tmp_path):
    m = small_net(tnm)
    r = np.random.RandomState(0)
    raws = [r.rand(1, 24, 40, 40).astype(np.float32)]
    aug = DeviceBatchAugmenter(raws, [(raws[0][0] > .5).astype(np.int16)],
                               patch_size=(8, 16, 16),
                               target_size=tuple(m.prediction_node.shape
                                                 .spatial_shape),
                               target_strides=tuple(m.prediction_node.shape
                                                    .strides),
                               device="cpu", seed=3)
    tr = Trainer(model=m, data=aug, batch_size=2, n_steps=10, fused_steps=4,
                 history_freq=0, save_freq=0, save_path=str(tmp_path),
                 save_name="dev", data_batch_args={"warp": 0.5},
                 device="cpu")
    hist = tr.run()
    assert type(tr.fused_loop).__name__ == "FusedTrainLoop"
    assert tr.step == 10 and len(hist.timeline) == 10
    assert np.isfinite(hist.timeline.data[:, 2]).all()


def test_trainer_resume_carries_step_and_adam_state(small_init, tmp_path):
    tr = _trainer(Trainer, small_init, tmp_path, "res", n_steps=5)
    tr.run()
    last = str(tmp_path / "res-LAST.mdl")
    assert os.path.exists(last)
    slots = [t.clone() for t in tr.model.opt_state["slots"][0]["c1"]
             .values()]

    def fail_factory():
        raise AssertionError("resume must not build a fresh model")

    tr2 = _trainer(Trainer, None, tmp_path, "res", n_steps=8, resume=True,
                   create_model=fail_factory)
    assert tr2.step == 5 and int(tr2.model.opt_state["step"]) == 5
    for a, b in zip(slots, tr2.model.opt_state["slots"][0]["c1"].values()):
        assert torch.equal(a, b)
    # both packages continue the port's checkpoint alike
    jt = _trainer(JaxTrainer, last, tmp_path, "jres", n_steps=8)
    assert jt.step == 5
    tr3 = _trainer(Trainer, last, tmp_path, "tres", n_steps=8)
    jh, th = jt.run(), tr3.run()
    assert tr3.step == 8
    assert_losses_close(th.timeline.data[:, 2], jh.timeline.data[:, 2])
    tr2.run()
    assert tr2.step == 8


def test_trainer_async_loss_lag_records_every_step(small_init, tmp_path):
    tr = _trainer(Trainer, small_init, tmp_path, "lag", n_steps=7,
                  history_freq=3)
    hist = tr.run()
    assert [int(r[1]) for r in hist.timeline] == list(range(1, 8))
    assert np.isfinite(hist.timeline.data[:, 2]).all()
    assert [int(r[0]) for r in hist.history] == [3, 6]


def test_trainer_tensorboard_scalars(small_init, tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    _trainer(Trainer, small_init, tmp_path, "tb", n_steps=12,
             tensorboard=True, history_freq=10).run()
    tbdir = tmp_path / "tb" / "tb"
    files = [f for f in os.listdir(tbdir) if "tfevents" in f]
    blob = b"".join(open(tbdir / f, "rb").read() for f in files)
    assert b"train/loss" in blob and b"train/lr" in blob


def test_trainer_schedules_and_console(small_init, tmp_path):
    tr = _trainer(Trainer, small_init, tmp_path, "con", n_steps=4,
                  schedules={"lr": {"dec": 0.5, "interval": 2}})
    tr.run()
    assert tr.model.optimiser.hyperparams["lr"] == pytest.approx(2.5e-4)
    c = tr.console
    for line in ("lr 0.01", "wd 0.001", "stat", "save", "pause", "cont",
                 "bogus"):
        c._handle(line)
    assert tr.model.optimiser.hyperparams["lr"] == 0.01
    assert tr.model.optimiser.hyperparams["wd"] == 0.001
    assert not c.paused
    c._handle("q")
    assert not c.poll()


# ------------------------------------------------------------ config / CLI

def test_config_loader_maps_the_jax_package_to_the_port():
    import builtins
    before = builtins.__import__
    mods = set(sys.modules)
    exp = ExperimentConfig.from_file(NEURO3D, override={"n_steps": 3})
    m = exp.create_model()
    assert isinstance(m, Model)
    assert builtins.__import__ is before
    new = set(sys.modules) - mods
    assert not [k for k in new if k.split(".")[0] == "elektronn2_tpu"]
    d = exp.as_dict()
    assert d["n_steps"] == 3 and d["save_name"] == "neuro3d"
    assert d["data_class"] == "BatchCreatorImage" and "create_model" in d
    assert exp.batch_size == 1
    with pytest.raises(AttributeError):
        exp.no_such_key
    assert tconfig.config.device == "cuda"
    assert tconfig._port_import("elektronn2_tpu.utils", fromlist=["x"]) \
        is sys.modules["elektronn2_tpu_torch.utils"]


def test_train_cli_on_the_cpu(tmp_path):
    h5py = pytest.importorskip("h5py")
    out = tmp_path / "run"
    train_cli.main(["--cpu", NEURO3D, "--n-steps", "4", "--save-path",
                    str(out), "--profile", str(tmp_path / "prof")])
    assert os.path.exists(out / "neuro3d-LAST.mdl")
    with h5py.File(out / "neuro3d.history.h5") as f:
        tl = f["timeline"][()]
    np.testing.assert_array_equal(tl[:, 1], [1, 2, 3, 4])
    assert np.isfinite(tl[:, 2]).all()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def test_train_cli_mlp_mnist_on_the_cpu(tmp_path, monkeypatch):
    # examples/mlp_mnist.py (Perceptrons, dropout 0.1 on the first; the
    # synthetic digits: the repo has no mnist.pkl.gz) through the CLI, with
    # its forked worker: the loss falls over 60 steps
    losses = []
    step = Model.trainingstep

    def recorded(self, *a, **kw):
        out = step(self, *a, **kw)
        losses.append(float(out[0]))
        return out
    monkeypatch.setattr(Model, "trainingstep", recorded)
    monkeypatch.setenv("HOME", str(tmp_path))
    out = tmp_path / "run"
    train_cli.main(["--cpu", os.path.join(REPO, "examples", "mlp_mnist.py"),
                    "--n-steps", "60", "--save-path", str(out)])
    assert len(losses) == 60 and np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < 0.5 * np.mean(losses[:10])
    assert os.path.exists(out / "mlp_mnist-LAST.mdl")


def test_entry_points_need_the_card_unless_asked(small_init, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model_load_path=small_init, save_path=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main([NEURO3D, "--n-steps", "1", "--save-path",
                        str(tmp_path)])


# ---------------------------------------------------------------- unported

def _mesh(tmp_path):
    # data-parallel meshes train (tests/test_torch_parallel.py); a tensor-
    # parallel axis is still refused, naming its ROADMAP item (8d)
    Trainer(model=small_net(tnm), device="cpu",
            mesh_axes={"data": 1, "model": 1}, save_path=str(tmp_path))


def _skel_loss(tmp_path):
    # SkelLoss syncs the host in every step: a fused loop refuses to capture
    # it before any capture, naming the device version
    from elektronn2_tpu_torch.training.fused_loop import HostFedFusedLoop
    tnm.model_manager.reset()
    feat = tnm.Input([2, 4], "b,f", name="feat")
    skel = tnm.GenericInput(name="skel")
    pred = tnm.Perceptron(feat, 3, activation_func="lin", name="step")
    m = tnm.model_manager.getmodel()
    m.designate_nodes(input_node=feat, prediction_node=pred,
                      loss_node=tnm.AggregateLoss(tnm.SkelLoss(pred, skel)),
                      extra_inputs=[skel])
    m.set_opt("Adam")
    loop = HostFedFusedLoop(m, None, 2, 2, prefetch=False)
    loop._capture(m.optimiser.current_hyper(m.device))


@pytest.mark.parametrize("what, item", [
    (_mesh, "item 8"), (_skel_loss, "SkelLossField")])
def test_unported_pieces_raise(what, item, tmp_path):
    with pytest.raises(NotImplementedError, match=item):
        what(tmp_path)


def test_bf16_conv_operands_match_jax():
    # neuro3d_fast's set_compute_dtype("bfloat16"): Conv operands in bf16,
    # float32 accumulation; the same loss as the JAX package's mode within
    # bf16's rounding of the operands (2^-8 relative, summed over the net)
    jm, tmdl = small_net(jnm), None
    from elektronn2_tpu_torch.utils.convert import params_from_jax
    tmdl = small_net(tnm)
    tmdl.set_params(params_from_jax(jm.params, tmdl))
    x = np.random.RandomState(0).rand(2, 1, 8, 16, 16).astype(np.float32)
    t = (np.random.RandomState(1).rand(2, 6, 7, 7) > 0.5).astype(np.int32)
    f32 = float(tmdl.loss(x, t))
    jm.set_compute_dtype("bfloat16")
    tmdl.set_compute_dtype("bfloat16")
    jl, tl = float(jm.loss(x, t)), float(tmdl.loss(x, t))
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    assert tl != f32
    # dense serving takes the mode too: the map within the bf16 tolerance of
    # the JAX package's (5e-2, tests/test_torch_quant.py)
    np.testing.assert_allclose(tmdl.predict_dense(x[0]),
                               np.asarray(jm.predict_dense(x[0])),
                               atol=5e-2, rtol=0)
