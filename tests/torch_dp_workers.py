"""Rank bodies of the data-parallel tests (``test_torch_parallel.py``).

Each scenario runs in processes started with ``spawn`` (never ``fork``
after torch has threads), joined into one ``gloo`` group on a free local
port; it imports only torch, numpy and the port (no jax), and returns a
picklable result per rank. ``run_ranks`` starts the processes and collects
the results. A collective waits at most ``COLLECTIVE_TIMEOUT`` seconds and
a spawn at most its ``deadline``, so a rank that hangs fails its test
instead of stopping the suite.
"""

import contextlib
import datetime
import os
import pickle
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


#: seconds a gloo collective may wait before it raises
COLLECTIVE_TIMEOUT = 120
#: seconds a spawn may run before its ranks are ended and it fails
SPAWN_DEADLINE = 300


def free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, scenario, kwargs, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    try:
        if ":" in scenario:                    # another module's scenario
            import importlib
            mod, _, name = scenario.partition(":")
            fn = getattr(importlib.import_module(mod), name)
        else:
            fn = globals()[scenario]
        res = ("ok", fn(rank, **kwargs))
    except BaseException:                       # reported by the parent
        res = ("error", traceback.format_exc())
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


@contextlib.contextmanager
def mesh_of_one(axes):
    """A CPU mesh of ``axes`` (sizes 1) in this process: a gloo group of
    one is started where none is up, and destroyed after."""
    from elektronn2_tpu_torch.parallel import make_mesh
    started = not dist.is_initialized()
    try:
        yield make_mesh(axes, devices="cpu")
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(out_dir, scenario, world=2, deadline=SPAWN_DEADLINE,
              **kwargs):
    """Run ``scenario(rank, **kwargs)`` on ``world`` spawned gloo ranks;
    returns the results by rank, raising a rank's error. ``scenario`` names
    a function of this module, or ``"module:function"`` of another. Ranks
    still running ``deadline`` seconds after the start are ended and the
    spawn fails."""
    import torch.multiprocessing as mp
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(world, free_port(), scenario,
                                           kwargs, str(out_dir)),
                             nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + deadline
    while not ctx.join(timeout=1):
        if time.monotonic() > end:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(10)
            raise AssertionError(f"{scenario}: {world} ranks still running "
                                 f"after {deadline} s; ended")
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            kind, val = pickle.load(f)
        if kind != "ok":
            raise AssertionError(f"rank {r} of {scenario}:\n{val}")
        out.append(val)
    return out


# ------------------------------------------------------------ the nets

def build_model(nm, batch, seed=11, bn=False, dropout=0.0):
    """``tests/test_parallel.py::build_model`` (2-D, a 3x3 conv pooled 2,
    a 1x1 head, softmax NLL), with batch norm and dropout on request."""
    nm.model_manager.reset(seed=seed)
    inp = nm.Input([batch, 1, 16, 16], "b,f,x,y", name="raw")
    c1 = nm.Conv(inp, 4, 3, 2, name="c1", batch_normalisation=bn,
                 dropout_rate=dropout)
    probs = nm.Softmax(nm.Conv(c1, 2, 1, 1, activation_func="lin"))
    tgt = nm.Input([batch, *probs.shape.spatial_shape], "b,x,y",
                   dtype="int32", name="target")
    loss = nm.AggregateLoss(nm.MultinoulliNLL(probs, tgt,
                                              target_is_sparse=True))
    err = nm.Errors(probs, tgt, target_is_sparse=True)
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=probs, error_node=err)
    return m


def fused_net(nm, batch):
    """``tests/test_parallel.py``'s fused-loop net: (b, 1, 5, 16, 16) ->
    (1,3,3) conv pooled (1,2,2) -> 1x1 -> softmax NLL."""
    nm.model_manager.reset(seed=11)
    inp = nm.Input([batch, 1, 5, 16, 16], "b,f,z,x,y", name="raw")
    c1 = nm.Conv(inp, 4, (1, 3, 3), (1, 2, 2), name="c1")
    probs = nm.Softmax(nm.Conv(c1, 2, 1, 1, activation_func="lin"))
    tgt = nm.Input([batch, *probs.shape.spatial_shape], "b,z,x,y",
                   dtype="int32", name="target")
    loss = nm.AggregateLoss(nm.MultinoulliNLL(probs, tgt,
                                              target_is_sparse=True))
    err = nm.Errors(probs, tgt, target_is_sparse=True)
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=probs, error_node=err)
    return m


def fused_cubes():
    r = np.random.RandomState(0)
    raws = [r.rand(1, 24, 40, 40).astype(np.float32) for _ in range(2)]
    labs = [(r.rand(24, 40, 40) > 0.5).astype(np.int16) for _ in range(2)]
    return raws, labs


class HostBatches:
    """A host data source: ``getbatch`` draws (data, target) batches of
    the fused net's shapes from its own seeded stream."""

    def __init__(self, seed=7, shape=(5, 16, 16), tshape=(5, 7, 7)):
        self.rng = np.random.RandomState(seed)
        self.shape, self.tshape = shape, tshape

    def getbatch(self, bs, **kw):
        d = self.rng.rand(bs, 1, *self.shape).astype(np.float32)
        t = (self.rng.rand(bs, *self.tshape) > 0.5).astype(np.int32)
        return d, t


def params_np(m):
    return {n: {p: v.detach().cpu().numpy().copy() for p, v in d.items()}
            for n, d in m.params.items()}


def _mesh(world=None):
    from elektronn2_tpu_torch.parallel import make_mesh
    return make_mesh({"data": world or dist.get_world_size()},
                     devices="cpu")


# ---------------------------------------------------------- scenarios

def mesh_construction(rank):
    from elektronn2_tpu_torch.parallel import make_mesh, mesh_info
    out = {"data": mesh_info(make_mesh({"data": 2}, devices="cpu")),
           "two": mesh_info(make_mesh({"data": 1, "space": 2},
                                      devices="cpu")),
           "list": mesh_info(make_mesh(["data", "space"], devices="cpu")),
           "default": mesh_info(make_mesh(devices="cpu"))}
    try:
        make_mesh({"data": 3}, devices="cpu")
        out["bad"] = None
    except ValueError as e:
        out["bad"] = str(e)
    return out


def dp_steps(rank, weights, xs, ys, optimiser, hyper, n_steps=3, bn=False,
             dropout=0.0):
    """``n_steps`` DP trainingsteps of build_model on the global batches."""
    import elektronn2_tpu_torch.neuromancer as nm
    m = build_model(nm, xs[0].shape[0], bn=bn, dropout=dropout)
    m.set_params(weights)
    m.set_opt(optimiser, **hyper)
    m.use_mesh(_mesh())
    losses, errs = [], []
    for i in range(n_steps):
        loss, aux = m.trainingstep(torch.from_numpy(xs[i % len(xs)]),
                                   torch.from_numpy(ys[i % len(ys)]))
        losses.append(float(loss))
        errs.append(float(aux["error"]))
    return {"losses": losses, "errors": errs, "params": params_np(m),
            "state": {n: {k: v.numpy().copy() for k, v in d.items()}
                      for n, d in m.state.items()}}


def refusals(rank, weights, x, y):
    """The errors a mesh raises, a tensor-parallel step on ``{data: 1,
    model: 2}``, and the fused loop's key across ``use_mesh``."""
    import elektronn2_tpu_torch.neuromancer as nm
    from elektronn2_tpu_torch.parallel import make_mesh
    from elektronn2_tpu_torch.training.fused_loop import HostFedFusedLoop
    out = {}
    m = build_model(nm, x.shape[0])
    m.set_params(weights)
    m.set_opt("SGD", lr=0.05)
    try:                          # a model axis the mesh lacks
        m.use_mesh(_mesh(), model_axis="model")
        out["model_axis"] = None
    except ValueError as e:
        out["model_axis"] = str(e)
    tp = build_model(nm, x.shape[0])
    tp.set_params(weights)
    tp.set_opt("SGD", lr=0.05)
    tp.use_mesh(make_mesh({"data": 1, "model": 2}, devices="cpu"),
                model_axis="model")
    out["model_mesh"] = {
        "loss": float(tp.trainingstep(torch.from_numpy(x),
                                      torch.from_numpy(y))[0]),
        "shard": tuple(tp.params["c1"]["w"].shape),
        "params": {n: {p: v.numpy().copy() for p, v in d.items()}
                   for n, d in tp._whole_trees()[0].items()}}
    loop = HostFedFusedLoop(m, HostBatches(shape=(16, 16), tshape=(7, 7)),
                            4, 2, prefetch=False)
    key0 = loop.graph_key()
    m.use_mesh(_mesh())
    out["key_moved"] = loop.graph_key() != key0
    out["key_has_rank"] = m._dp.key() in loop.graph_key()[3]
    try:
        m.trainingstep(torch.from_numpy(x[:3]), torch.from_numpy(y[:3]))
        out["batch"] = None
    except ValueError as e:
        out["batch"] = str(e)
    loop.close()
    return out


def malis_net(nm):
    """A 1x1 sigmoid affinity conv trained on ``MalisNLL`` (batch 2), in
    the package ``nm`` (the port's or the JAX package's)."""
    nm.model_manager.reset(seed=1)
    inp = nm.Input([2, 1, 6, 6, 6], "b,f,z,x,y", name="raw")
    aff = nm.Conv(inp, 3, 1, 1, activation_func="sigmoid", name="aff")
    seg = nm.Input([2, 6, 6, 6], "b,z,x,y", dtype="int32", name="seg")
    mal = nm.MalisNLL(aff, None, seg, name="malis")
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=seg,
                      loss_node=nm.AggregateLoss(mal), prediction_node=aff)
    m.set_opt("SGD", lr=0.5)
    return m


def skel_net(nm):
    """A Perceptron step head trained on ``SkelLoss`` (batch 4), the
    skeleton rows a GenericInput, in the package ``nm``."""
    nm.model_manager.reset(seed=2)
    feat = nm.Input([4, 8], "b,f", name="feat")
    skel = nm.GenericInput(name="skel")
    pred = nm.Perceptron(feat, 3, activation_func="lin", name="step")
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=feat, loss_node=nm.AggregateLoss(
        nm.SkelLoss(pred, skel, name="skel_loss")), prediction_node=pred,
        extra_inputs=[skel])
    m.set_opt("Adam", lr=1e-2)
    return m


def line_skeleton(n=20, mod=None):
    """A straight skeleton of ``n`` nodes, of ``mod``'s ``SkeletonMFK``
    (the port's by default)."""
    if mod is None:
        from elektronn2_tpu_torch.data import skeleton as mod
    pos = np.stack([np.zeros(n), np.zeros(n), np.arange(n) * 1.0],
                   axis=1) + 5.0
    return mod.SkeletonMFK(pos, [(i, i + 1) for i in range(n - 1)])


def host_pass_steps(m, batches, extra=False):
    """Steps of ``m`` on ``batches``: the losses and the parameters."""
    losses = []
    for a, b in batches:
        if extra:
            loss, _ = m.trainingstep(torch.from_numpy(a), None,
                                     extra=[torch.from_numpy(b)])
        else:
            loss, _ = m.trainingstep(torch.from_numpy(a),
                                     torch.from_numpy(b))
        losses.append(float(loss))
    return {"losses": losses, "params": params_np(m)}


def host_pass_losses(rank, malis_w, malis_batches, skel_w, skel_batches):
    """``MalisNLL`` and ``SkelLoss`` trained on two ranks: each rank keeps
    its rows, the host pass runs on the global batch's."""
    import elektronn2_tpu_torch.neuromancer as nm
    from elektronn2_tpu_torch.data.skeleton import (clear_skeleton_registry,
                                                    register_skeleton)
    out = {}
    m = malis_net(nm)
    m.set_params(malis_w)
    m.use_mesh(_mesh())
    out["malis"] = host_pass_steps(m, malis_batches)
    clear_skeleton_registry()
    register_skeleton(line_skeleton())
    m = skel_net(nm)
    m.set_params(skel_w)
    m.use_mesh(_mesh())
    out["skel"] = host_pass_steps(m, skel_batches, extra=True)
    return out


def fused_loops(rank, weights, steps, warp, seed):
    """Two eager chunks of FusedTrainLoop and of HostFedFusedLoop under
    the mesh."""
    import elektronn2_tpu_torch.neuromancer as nm
    from elektronn2_tpu_torch.ops.warp import DeviceBatchAugmenter
    from elektronn2_tpu_torch.training.fused_loop import (FusedTrainLoop,
                                                          HostFedFusedLoop)
    out = {}
    m = fused_net(nm, 8)
    m.set_params(weights)
    m.set_opt("SGD", lr=0.05)
    m.use_mesh(_mesh())
    raws, labs = fused_cubes()
    aug = DeviceBatchAugmenter(
        raws, labs, patch_size=(5, 16, 16),
        target_size=tuple(m.prediction_node.shape.spatial_shape),
        target_strides=(1, 2, 2), grey_channels=[0], seed=0, device="cpu")
    loop = FusedTrainLoop(m, aug, batch_size=8, n_inner=steps, warp=warp,
                          seed=seed)
    out["fused"] = [loop.run_chunk()[0] for _ in range(2)]
    out["fused_params"] = params_np(m)
    m = fused_net(nm, 8)
    m.set_params(weights)
    m.set_opt("Adam", lr=1e-3)
    m.use_mesh(_mesh())
    loop = HostFedFusedLoop(m, HostBatches(), batch_size=8, n_inner=steps,
                            seed=seed, prefetch=False)
    out["hostfed"] = [loop.run_chunk() for _ in range(2)]
    out["hostfed_params"] = params_np(m)
    loop.close()
    return out


def repair(rank, weights, x, y):
    """``tests/test_parallel.py::test_repair_fuckup_under_mesh``."""
    import elektronn2_tpu_torch.neuromancer as nm
    m = build_model(nm, x.shape[0])
    m.set_params(weights)
    m.set_opt("Adam", lr=1e-2)
    m.use_mesh(_mesh())
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    m.trainingstep(x, y)
    m.snapshot_good()
    good = params_np(m)
    step = int(m.opt_state["step"])
    out = {"restored": [], "steps": []}
    for _ in range(2):
        with torch.no_grad():
            for d in m.params.values():
                for v in d.values():
                    v.fill_(float("nan"))
        out["ok"] = m.repair_fuckup(lr_scale=0.5)
        out["restored"].append(all(
            np.array_equal(params_np(m)[n][p], good[n][p])
            for n in good for p in good[n]))
        out["steps"].append(int(m.opt_state["step"]) == step)
    out["loss"] = float(m.trainingstep(x, y)[0])
    out["lr"] = m.optimiser.hyperparams["lr"]
    return out


def ckpt_first(rank, weights, xs, ys, path):
    """Two DP steps, then ``save`` (rank 0 writes, all wait)."""
    import elektronn2_tpu_torch.neuromancer as nm
    m = build_model(nm, xs[0].shape[0])
    m.set_params(weights)
    m.set_opt("Adam", lr=1e-3)
    m.use_mesh(_mesh())
    for i in range(2):
        m.trainingstep(torch.from_numpy(xs[i]), torch.from_numpy(ys[i]))
    m.save(path)
    return os.path.exists(path)


def ckpt_second(rank, xs, ys, path):
    """Fresh processes: ``modelload`` + ``use_mesh``, two more steps."""
    from elektronn2_tpu_torch.neuromancer.model import modelload
    m = modelload(path, device="cpu")
    step0 = m._step_count
    m.use_mesh(_mesh())
    for i in range(2, 4):
        m.trainingstep(torch.from_numpy(xs[i % 2]),
                       torch.from_numpy(ys[i % 2]))
    return {"step0": step0, "params": params_np(m)}


def trainer_run(rank, weights, save_path, n_steps, resume):
    """``Trainer`` with ``mesh_axes`` over a host source; with ``resume``
    a fresh model is not given and the rolling checkpoint is reloaded."""
    import elektronn2_tpu_torch.neuromancer as nm
    from elektronn2_tpu_torch.training.trainer import Trainer
    model = None
    if not resume:
        model = fused_net(nm, 8)
        model.set_params(weights)
        model.set_opt("Adam", lr=1e-3)
    tr = Trainer(model=model, data=HostBatches(seed=3), batch_size=8,
                 n_steps=n_steps, resume=resume, mesh_axes={"data": 2},
                 history_freq=0, save_freq=0, n_workers=0,
                 save_path=save_path, save_name="mres", device="cpu")
    step0 = tr.step
    meshed = tr.model._dp is not None
    tr.run()
    return {"step0": step0, "meshed": meshed, "step": tr.step,
            "params": params_np(tr.model),
            "losses": [row[2] for row in tr.history.timeline]}
