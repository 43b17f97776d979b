"""Scenarios of the scale-out training tests (``test_torch_spatial_train``,
``test_torch_tensor_parallel``, ``test_torch_pipeline``), run through
``torch_dp_workers.run_ranks("torch_scaleout_workers:<name>", ...)``.

Each scenario runs every case of its file in one spawn of gloo ranks on
the CPU; it imports only torch, numpy and the port (no jax) and returns
picklable results per rank: losses, and parameters as whole numpy arrays
(tensor-parallel shards gathered). The nets are built by functions that
take the ``neuromancer`` module, so the tests build the JAX package's
twins with the same code.
"""

import numpy as np
import torch

from torch_dp_workers import HostBatches, build_model, fused_cubes, params_np


# ------------------------------------------------------------ the nets

def spatial_net(nm, two_convs=True, dropout=0.0, B=2, Z=8, X=14):
    """``tests/test_parallel.py:153``'s net (``two_convs=False``: :793's):
    (B, 1, Z, X, X) -> (3,3,3) conv 4 pooled (1,2,2) [-> (3,3,3) conv 4]
    -> 1x1 -> softmax NLL; SGD(lr 0.05, mom 0)."""
    nm.model_manager.reset(seed=11)
    inp = nm.Input([B, 1, Z, X, X], "b,f,z,x,y", name="raw")
    h = nm.Conv(inp, 4, (3, 3, 3), (1, 2, 2), name="c1",
                dropout_rate=dropout)
    if two_convs:
        h = nm.Conv(h, 4, (3, 3, 3), (1, 1, 1), name="c2")
    probs = nm.Softmax(nm.Conv(h, 2, 1, 1, activation_func="lin"),
                       name="probs")
    tgt = nm.Input([B, *probs.shape.spatial_shape], "b,z,x,y",
                   dtype="int32", name="target")
    nll = nm.MultinoulliNLL(probs, tgt, target_is_sparse=True, name="nll")
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt,
                      loss_node=nm.AggregateLoss(nll, name="loss"),
                      prediction_node=probs)
    m.set_opt("SGD", lr=0.05, mom=0.0)
    return m


def perceptron_net(nm):
    """``tests/test_review_fixes.py:495``: Perceptron 12 -> 16 (relu) ->
    8 (lin), SquaredLoss; Adam(lr 1e-3)."""
    nm.model_manager.reset(seed=2)
    inp = nm.Input([4, 12], "b,f", name="raw")
    h = nm.Perceptron(inp, 16, name="fc1")
    out = nm.Perceptron(h, 8, activation_func="lin", name="fc2")
    tgt = nm.Input([4, 8], "b,f", name="target")
    loss = nm.AggregateLoss(nm.SquaredLoss(out, tgt))
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=out)
    m.set_opt("Adam", lr=1e-3)
    return m


def tp_fused_net(nm, batch=4):
    """``tests/test_parallel.py:320``'s net: (b, 1, 4, 12, 12) -> (1,3,3)
    conv 8 -> 1x1 -> softmax NLL."""
    nm.model_manager.reset(seed=11)
    inp = nm.Input([batch, 1, 4, 12, 12], "b,f,z,x,y", name="raw")
    c1 = nm.Conv(inp, 8, (1, 3, 3), (1, 1, 1), name="c1")
    probs = nm.Softmax(nm.Conv(c1, 2, 1, 1, activation_func="lin"))
    tgt = nm.Input([batch, *probs.shape.spatial_shape], "b,z,x,y",
                   dtype="int32", name="target")
    loss = nm.AggregateLoss(nm.MultinoulliNLL(probs, tgt,
                                              target_is_sparse=True))
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=probs)
    return m


def flagship_like(nm, B, name="pp_model", n_indep=1, n_cls=2, depth=None):
    """``tests/test_parallel.py:412``'s chain (``n_indep=2, n_cls=4``:
    :701's grouped head; ``depth``: :951's fuzzed chain), SGD(0.05, 0)."""
    inp = nm.Input([B, 1, 9, 16, 16], "b,f,z,x,y", name="raw")
    h = inp
    if depth is None:
        spec = [(4, (1, 3, 3), (1, 2, 2)), (6, (3, 3, 3), (1, 1, 1)),
                (6, (3, 3, 3), (1, 1, 1))]
    else:
        spec = [(4 + 2 * i, (1, 3, 3) if i == 0 else (3, 3, 3),
                 (1, 2, 2) if i == 0 else (1, 1, 1))
                for i in range(depth - 1)]
    for i, (nf, f, p) in enumerate(spec):
        h = nm.Conv(h, nf, f, p, name=f"c{i}")
    logits = nm.Conv(h, n_cls, 1, 1, activation_func="lin", name="logits")
    probs = nm.Softmax(logits, n_indep=n_indep, name="probs")
    tgt = nm.Input([B, *probs.shape.spatial_shape], "b,z,x,y",
                   dtype="int32", name="target")
    loss = nm.AggregateLoss(nm.MultinoulliNLL(probs, tgt,
                                              target_is_sparse=True))
    m = nm.model_manager.getmodel(name)
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=probs)
    m.set_opt("SGD", lr=0.05, mom=0.0)
    return m


def chain_net(nm):
    """``tests/test_parallel.py:453``'s net: conv 4 (3,3,3) pooled
    (1,2,2) -> conv 6 (3,3,3) -> 1x1 ``cls`` (lin), prediction only."""
    nm.model_manager.reset(seed=4)
    inp = nm.Input([2, 1, 10, 16, 16], "b,f,z,x,y", name="raw")
    h = nm.Conv(inp, 4, (3, 3, 3), (1, 2, 2), name="e0")
    h = nm.Conv(h, 6, (3, 3, 3), (1, 1, 1), name="e1")
    out = nm.Conv(h, 2, 1, 1, activation_func="lin", name="cls")
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, prediction_node=out)
    return m


def port(build, weights, **kw):
    """The port's net of ``build`` with ``weights`` on the CPU."""
    import elektronn2_tpu_torch.neuromancer as nm
    m = build(nm, **kw)
    m.set_params(weights)
    return m


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(tree):
    return {n: {p: v.detach().cpu().numpy().copy() for p, v in d.items()}
            for n, d in tree.items()}


def _mesh(axes):
    from elektronn2_tpu_torch.parallel import make_mesh
    return make_mesh(axes, devices="cpu")


def _error(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


# ----------------------------------------------------- spatial (8 ranks)

def _tp_state(m, mesh):
    """This rank's shards of ``m``'s params and optimiser state over the
    mesh's ``model`` axis, the group and the dims."""
    from elektronn2_tpu_torch.parallel.tensor_parallel import (
        ModelGroup, shard_tree, tp_dims)
    tp = ModelGroup(mesh, "model")
    dims = tp_dims(m.nodes, tp.world)
    params = shard_tree(m.params, dims, tp)
    opt = {"step": m.opt_state["step"],
           "slots": tuple(shard_tree(s, dims, tp)
                          for s in m.opt_state["slots"])}
    return params, opt, tp, dims


def _spatial_steps(m, mesh, data, targets, model_axis=None, fused=False,
                   rng=None):
    """Per-step (or one fused chunk of) spatial steps from ``m``'s
    weights; returns (losses, whole params)."""
    from elektronn2_tpu_torch.parallel import (make_fused_spatial_trainstep,
                                               make_spatial_dp_trainstep)
    from elektronn2_tpu_torch.parallel.tensor_parallel import gather_tree
    if model_axis is not None:
        params, opt, tp, dims = _tp_state(m, mesh)
    else:
        params, opt = m.params, m.opt_state
    hyper = m.optimiser.current_hyper("cpu")
    if fused:
        chunk = make_fused_spatial_trainstep(m, mesh, n_inner=len(data),
                                             model_axis=model_axis)
        losses, params, opt, _ = chunk(params, opt, m.state,
                                       _t(np.stack(data)),
                                       _t(np.stack(targets)), hyper, rng)
        losses = losses.tolist()
    else:
        step = make_spatial_dp_trainstep(m, mesh, model_axis=model_axis)
        losses = []
        for d, t in zip(data, targets):
            lv, params, opt, _ = step(params, opt, m.state, _t(d), _t(t),
                                      hyper, rng)
            losses.append(float(lv))
    if model_axis is not None:
        shapes = {n: {p: tuple(v.shape) for p, v in d.items()}
                  for n, d in params.items()}
        return losses, _np(gather_tree(params, dims, tp)), shapes
    return losses, _np(params), None


def _halo_grads(mesh, x, wext, halo):
    """``halo_gather_grad`` of this rank's z block of ``x`` against the
    weighting ``wext`` of its extended rows: the gradient on the block."""
    from elektronn2_tpu_torch.parallel.halo import SpaceGroup
    sp = SpaceGroup(mesh, "space")
    xl = sp.block(_t(x), 2).clone().requires_grad_()
    y = sp.halo(xl, halo)
    z = xl.shape[2]
    w = _t(wext)[:, :, sp.rank * z:sp.rank * z + z + halo]
    return torch.autograd.grad(torch.sum(y * w), xl)[0].numpy()


def spatial_cases(rank, w2, w1, wd, batch, batches, batches3, halo_in):
    """``tests/test_parallel.py`` :153 and :642 (one step from ``w2``),
    :793 and :857 (per step against fused, from ``w1``), the halo's
    gradient, dropout's draws (``wd``), on ``{data: 2, space: 4}`` and
    ``{data: 2, space: 2, model: 2}``."""
    import elektronn2_tpu_torch.neuromancer as nm
    from elektronn2_tpu_torch.parallel import spatial_tp_shardings
    dpsp = _mesh({"data": 2, "space": 4})
    three = _mesh({"data": 2, "space": 2, "model": 2})
    out = {}
    d, t = batch
    out["dpsp"] = _spatial_steps(port(spatial_net, w2), dpsp, [d], [t])
    out["three"] = _spatial_steps(port(spatial_net, w2), three, [d], [t],
                                  model_axis="model")
    pdims, odims = spatial_tp_shardings(port(spatial_net, w2), three,
                                        "model")
    out["three_dims"] = (pdims, odims)
    ds, ts = batches
    out["per_step"] = _spatial_steps(port(spatial_net, w1, two_convs=False),
                                     dpsp, ds, ts)
    out["fused"] = _spatial_steps(port(spatial_net, w1, two_convs=False),
                                  dpsp, ds, ts, fused=True)
    ds3, ts3 = batches3
    out["per_step3"] = _spatial_steps(
        port(spatial_net, w1, two_convs=False), three, ds3, ts3,
        model_axis="model")
    out["fused3"] = _spatial_steps(
        port(spatial_net, w1, two_convs=False), three, ds3, ts3,
        model_axis="model", fused=True)
    out["dropout"] = _spatial_steps(
        port(spatial_net, wd, dropout=0.3), dpsp, [d], [t],
        rng=torch.Generator().manual_seed(5))
    x, wext = halo_in
    out["halo"] = {h: _halo_grads(dpsp, x, wext[h], h) for h in (1, 2, 3)}
    return out


# ---------------------------------------------------- tensor parallel

def _tp_model(build, weights, mesh, opt=None, **kw):
    m = port(build, weights, **kw)
    if opt is not None:
        m.set_opt(*opt[:1], **opt[1])
    return m.use_mesh(mesh, model_axis="model")


def tp_cases(rank, w2d, x, y, wp, xp, yp, wbn, wf, tmp):
    """``tests/test_parallel.py`` :268, :291, :311, :320, :919 and
    ``tests/test_review_fixes.py:495`` on ``{data: 2, model: 4}``, with
    clip, batch norm and dropout, a checkpoint and its resume, dense
    serving of the gathered weights and the Trainer's ``mesh_axes``."""
    import os
    from elektronn2_tpu_torch.neuromancer.model import modelload
    from elektronn2_tpu_torch.ops.warp import DeviceBatchAugmenter
    from elektronn2_tpu_torch.parallel import spatial_tp_shardings
    from elektronn2_tpu_torch.training.fused_loop import (FusedTrainLoop,
                                                          HostFedFusedLoop)
    from elektronn2_tpu_torch.training.trainer import Trainer
    mesh = _mesh({"data": 2, "model": 4})
    out = {}
    # :268 / :291: three Adam steps; the shards and their slots
    m = _tp_model(build_model, w2d, mesh, ("Adam", {"lr": 1e-3}), batch=4)
    out["dims"] = dict(m._tp_dims)
    out["spatial_dims"] = spatial_tp_shardings(m, mesh, "model")[0]
    out["shard_shapes"] = {n: {p: tuple(v.shape) for p, v in d.items()}
                           for n, d in m.params.items()}
    out["slot_shapes"] = [{n: {p: tuple(v.shape) for p, v in d.items()}
                           for n, d in s.items()}
                          for s in m.opt_state["slots"]]
    out["losses"] = [float(m.trainingstep(_t(x[i % 2]), _t(y[i % 2]))[0])
                     for i in range(3)]
    whole, opt = m._whole_trees()
    out["params"] = _np(whole)
    # :311: predict runs the TP forward
    out["predict"] = m.predict(_t(x[0])).numpy()
    # a checkpoint: whole tensors; resumed on the mesh, one more step
    path = os.path.join(tmp, "tp.mdl")
    m.save(path)
    r = modelload(path, device="cpu").use_mesh(mesh, model_axis="model")
    out["resumed_step0"] = r._step_count
    out["resumed_loss"] = float(r.trainingstep(_t(x[1]), _t(y[1]))[0])
    out["resumed"] = _np(r._whole_trees()[0])
    # test_review_fixes.py:495: Perceptron w (12, 16) split on dim 1
    m = _tp_model(perceptron_net, wp, mesh)
    out["fc1_w_shard"] = tuple(m.params["fc1"]["w"].shape)
    out["perceptron_loss"] = float(m.trainingstep(_t(xp), _t(yp))[0])
    out["perceptron"] = _np(m._whole_trees()[0])
    # clip, batch norm (after the channel gather) and dropout
    m = _tp_model(build_model, wbn, mesh, ("SGD", {"lr": 0.05,
                                                   "clip": 0.05}),
                  batch=4, bn=True, dropout=0.3)
    out["bn_losses"] = [float(m.trainingstep(_t(x[i]), _t(y[i]))[0])
                        for i in range(2)]
    out["bn"] = _np(m._whole_trees()[0])
    out["bn_state"] = _np(m.state)
    # :320 / :919: the fused loops' eager chunks
    m = _tp_model(tp_fused_net, wf, mesh, ("Adam", {"lr": 1e-3}), batch=8)
    raws, labs = fused_cubes()
    aug = DeviceBatchAugmenter(
        raws, labs, patch_size=(4, 12, 12),
        target_size=tuple(m.prediction_node.shape.spatial_shape),
        grey_channels=[0], seed=3, device="cpu")
    loop = FusedTrainLoop(m, aug, batch_size=8, n_inner=3, warp=0.5, seed=3)
    out["fused"] = loop.run_chunk()[0]
    out["fused_params"] = _np(m._whole_trees()[0])
    out["fused_key_has_tp"] = m._tp.key() in loop.graph_key()[3]
    # dense serving of the gathered weights
    vol = torch.from_numpy(np.random.RandomState(4).rand(
        1, 8, 20, 20).astype(np.float32))
    out["dense"] = m.predict_dense_device(vol, pad_raw=True).numpy()
    out["dense_again_same_tensors"] = m._tp_whole[1] is not None
    m = _tp_model(tp_fused_net, wf, mesh, ("SGD", {"lr": 0.05}), batch=8)
    loop = HostFedFusedLoop(m, HostBatches(shape=(4, 12, 12),
                                           tshape=(4, 10, 10)),
                            batch_size=8, n_inner=3, seed=3, prefetch=False)
    out["hostfed"] = [loop.run_chunk()[0] for _ in range(2)]
    out["hostfed_params"] = _np(m._whole_trees()[0])
    loop.close()
    # the Trainer's mesh_axes with a "model" axis
    tm = port(tp_fused_net, wf, batch=8)
    tm.set_opt("Adam", lr=1e-3)
    tr = Trainer(model=tm, data=HostBatches(seed=3, shape=(4, 12, 12),
                                            tshape=(4, 10, 10)),
                 batch_size=8, n_steps=2, mesh_axes={"data": 2, "model": 4},
                 history_freq=0, save_freq=0, n_workers=0,
                 save_path=os.path.join(tmp, f"tr{rank}"), save_name="t",
                 device="cpu")
    tr.run()
    out["trainer_tp"] = tr.model._tp is not None
    out["trainer"] = _np(tr.model._whole_trees()[0])
    out["bad_axis"] = _error(lambda: port(build_model, w2d, batch=4).use_mesh(
        mesh, model_axis="nope"))
    return out


# ------------------------------------------------------- pipeline (4)

def _grads(loss, params):
    leaves = [v for p in params for k, v in sorted(p.items())]
    gs = torch.autograd.grad(loss, leaves)
    out, i = [], 0
    for p in params:
        d = {}
        for k in sorted(p):
            d[k] = gs[i].float().numpy()
            i += 1
        out.append(d)
    return out


def _leaf_params(params):
    return [{k: v.detach().clone().requires_grad_() for k, v in p.items()}
            for p in params]


def _sq(pred, tgt):
    return torch.mean((pred.float() - tgt) ** 2)


def _pipe_loss(layers, mesh, mb_shape, M, xm, ym, data_axis=None):
    from elektronn2_tpu_torch.parallel import gpipe_stack
    loss_of, _, params = gpipe_stack(layers, mesh, _sq, mb_shape, M,
                                     data_axis=data_axis)
    params = _leaf_params(params)
    loss = loss_of(params, _t(xm), _t(ym))
    return float(loss), _grads(loss, params)


def _model_steps(build_kw, weights, mesh, M, b_mb, batches, data_axis=None):
    import elektronn2_tpu_torch.neuromancer as nm
    from elektronn2_tpu_torch.parallel import make_gpipe_trainstep, microbatch
    nm.model_manager.reset(seed=11)
    m = flagship_like(nm, **build_kw)
    m.set_params(weights)
    m.set_opt("SGD", lr=0.05, mom=0.0)
    step = make_gpipe_trainstep(m, mesh, n_micro=M, mb_batch=b_mb,
                                data_axis=data_axis)
    hyper = m.optimiser.current_hyper("cpu")
    losses = []
    for d, t in batches:
        lv, _, _ = step(m.params, m.opt_state, microbatch(_t(d), M),
                        microbatch(_t(t), M), hyper)
        losses.append(float(lv))
    return losses, params_np(m)


def pipe_cases(rank, layers, x, ym, x_dp, ym_dp, chain_w, x_chain,
               bf16_layers, x_bf16, models):
    """``tests/test_parallel.py`` :368 (2 and 4 stages), :411, :442, :453,
    :491, :515, :582, :617, :701, :951 on four ranks: ``{pipe: 4}``,
    ``{rep: 2, pipe: 2}`` (two pipelines side by side) and ``{data: 2,
    pipe: 2}``."""
    from elektronn2_tpu_torch.parallel import (gpipe_stack, layers_from_model,
                                               microbatch)
    p4 = _mesh({"pipe": 4})
    p2 = _mesh({"rep": 2, "pipe": 2})
    dp = _mesh({"data": 2, "pipe": 2})
    meshes = {2: p2, 4: p4}
    out = {}
    xm = microbatch(np.asarray(x), 4)
    for S in (2, 4):
        out[f"seq{S}"] = _pipe_loss(layers, meshes[S], (2, 1, 12, 20, 20),
                                    4, xm, ym)
    # :411 eight SGD steps through the pipelined gradient (2 stages)
    loss_of, _, params = gpipe_stack(layers, p2, _sq, (2, 1, 12, 20, 20), 2)
    xm2, ym2 = _t(xm[:2]), _t(np.full_like(ym[:2], 0.3))
    params = _leaf_params(params)
    losses = []
    for _ in range(8):
        loss = loss_of(params, xm2, ym2)
        gs = _grads(loss, params)
        losses.append(float(loss))
        params = [{k: (v - 0.5 * torch.from_numpy(g[k])).detach()
                   .requires_grad_() for k, v in p.items()}
                  for p, g in zip(params, gs)]
    out["train"] = losses
    # :442
    out["too_many_stages"] = _error(lambda: gpipe_stack(
        layers[:3], p4, _sq, (1, 1, 12, 20, 20), 2))
    # :453 layers_from_model
    import elektronn2_tpu_torch.neuromancer as nm
    cm = chain_net(nm)
    cm.set_params(chain_w)
    cl = layers_from_model(cm)
    xcm = microbatch(np.asarray(x_chain), 2)
    loss_of, _, pp = gpipe_stack(cl, p2, _sq, (2, 1, 10, 16, 16), 2)
    out["chain"] = (len(cl), float(loss_of(pp, _t(xcm),
                                           torch.zeros((2, 2, 2, 6, 5, 5)))))
    # :491 bf16
    loss_of, _, params = gpipe_stack(bf16_layers, p2, _sq, (1, 1, 8, 10, 10),
                                     2)
    params = _leaf_params(params)
    loss = loss_of(params, microbatch(_t(x_bf16).to(torch.bfloat16), 2),
                   torch.zeros((2, 1, 2, 6, 8, 8)))
    g = torch.autograd.grad(loss, [params[0]["w"]])[0]
    out["bf16"] = (float(loss), str(g.dtype))
    # :515 DP x PP
    out["dp"] = _pipe_loss(layers, dp, (4, 1, 12, 20, 20), 2,
                           microbatch(np.asarray(x_dp), 2), ym_dp,
                           data_axis="data")
    # :582, :617, :701, :951: make_gpipe_trainstep
    for name, (kw, w, S, M, b_mb, bs, data_axis) in models.items():
        mesh = dp if data_axis else meshes[S]
        out[name] = _model_steps(kw, w, mesh, M, b_mb, bs,
                                 data_axis=data_axis)
    return out
