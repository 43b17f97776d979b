"""Fused training: ``FusedTrainLoop.run_chunk``, one CUDA graph replay of
``chunk_steps`` steps (the on-card augmenter's batch, forward, backward,
Adam) after another.

The mix (``"driver": "train"``) gives the ``batch``, the ``chunk_steps``,
the training ``cubes`` (n, f, z, x, y; uniform raw values from the seed,
labelled raw > 0.5), the augmenter's ``warp_amount``, ``warp_prob``,
``grey_channels`` and ``flip``, the ``warmup_chunks``, the length of the
traced window (``trace_seconds``: a step launches hundreds of kernels) and
the ``check``'s limits. Set-up builds one loop and drives it from the seed
through its first chunk, through the window's own call; that same loop
then runs the window. The plain reference follows the first chunk from the
same weights and seed, and the check compares the first three steps'
losses and the worst leaf's change over the chunk (``chunk_readings``
gives the other readings too, for the record).

Faults (``ctx.fault``, for the checks' own tests and ``calibrate.py``):
``"frozen"`` (the optimiser's update does nothing), ``"half_batch"`` (each
step sees half of its batch), ``"control"`` and ``"float64"`` (the plain
reference with TF32 operands, or in float64, in the program's place for
the first chunk).
"""

import math
import time
from types import SimpleNamespace

import torch

from .. import build, trace, weights
from ..reference.nets import no_tf32
from ..reference.train import train_chunk
from . import common

#: what ``calibrate.py`` puts in the program's place, beside the program
FAULTS = ["control", "half_batch", "float64"]


def leaf_gaps(prog, ref, keep):
    """Each kept leaf's gap between the norms of ``prog`` and ``ref``
    (``{node: {name: tensor}}``), over the larger of the reference leaf's
    norm and the median leaf norm."""
    names = [(n, k) for n in sorted(ref) for k in sorted(ref[n])
             if (n, k) in keep]
    rn = {nk: float(ref[nk[0]][nk[1]].norm()) for nk in names}
    med = sorted(rn.values())[len(rn) // 2]
    return sorted(abs(float(prog[n][k].norm()) - rn[(n, k)])
                  / max(rn[(n, k)], med) for n, k in names)


def moving_leaves(first):
    """(node, name) of the leaves whose first moment is at least a
    thousandth of the median leaf's: the others move under Adam by
    round-off alone."""
    norms = {(n, k): float(v.norm()) for n, d in first.items()
             for k, v in d.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {nk for nk, v in norms.items() if v >= 1e-3 * med}


def _median(gaps):
    return gaps[len(gaps) // 2] if all(math.isfinite(g) for g in gaps) \
        else float("nan")


def chunk_readings(losses, params0, params, first, ref):
    """What the check can compare after the first chunk: the largest
    relative gap of a step's loss over the first three steps and over the
    whole chunk; the worst and the median leaf of Adam's first moment after
    the chunk and of the parameters' change over it."""
    rl, rp, rm = ref
    rel = [abs(a - b) / abs(b) if math.isfinite(a) else float("nan")
           for a, b in zip(losses, rl)]
    keep = moving_leaves(rm)
    d_prog = {n: {k: params[n][k] - params0[n][k] for k in d}
              for n, d in params0.items()}
    d_ref = {n: {k: rp[n][k] - params0[n][k] for k in d}
             for n, d in params0.items()}
    m, d = leaf_gaps(first, rm, keep), leaf_gaps(d_prog, d_ref, keep)
    return {"loss3_gap": common.worst(rel[:3]),
            "loss_gap": common.worst(rel),
            "first_moment_gap": common.worst(m),
            "first_moment_median": _median(m),
            "change_gap": common.worst(d), "change_median": _median(d)}


def make_cubes(seed, shape, device):
    raws = weights.uniform_volume(seed, "cubes", 0, shape, device)
    return raws, (raws[:, 0] > 0.5).to(torch.int16)


def build_loop(ctx):
    """The system under test: the port's model with its optimiser, the
    on-card augmenter over the cubes and the ``FusedTrainLoop`` that the
    window drives, all from ``ctx.seed``; the faults of the checks' own
    tests planted as ``ctx.fault`` says."""
    from elektronn2_tpu_torch.ops.warp import DeviceBatchAugmenter
    from elektronn2_tpu_torch.training.fused_loop import FusedTrainLoop

    net, cfg, tr, dev = ctx.net, ctx.cfg, ctx.traffic, ctx.device
    tc = cfg["train"]
    B, K = tr["batch"], tr["chunk_steps"]
    model = build.port_model(net, B, tc["patch"], dev, optimiser={
        "name": tc["optimiser"], "lr": tc["lr"], "clip": tc["clip"]})
    if list(model.input_node.shape.spatial_shape) != list(tc["patch"]):
        raise ValueError(f"{cfg['name']}: the program's input is "
                         f"{model.input_node.shape.spatial_shape}, the "
                         f"configuration's {tc['patch']}")
    params0 = weights.make_params(net, ctx.seed, dev)
    model.set_params(params0)
    raws, labels = make_cubes(ctx.seed, tr["cubes"], dev)
    ps = model.prediction_node.shape
    aug = DeviceBatchAugmenter(
        list(raws.cpu().numpy()), list(labels.cpu().numpy()),
        patch_size=model.input_node.shape.spatial_shape,
        target_size=ps.spatial_shape, target_strides=ps.strides,
        warp_amount=tr["warp_amount"], grey_channels=tr["grey_channels"],
        device=dev)
    loop_seed = weights.sub_seed(ctx.seed, "loop")
    loop = FusedTrainLoop(model, aug, batch_size=B, n_inner=K,
                          warp=tr["warp_prob"], grey=True, flip=tr["flip"],
                          seed=loop_seed)
    if ctx.fault == "frozen":
        model.optimiser.update = lambda *a, **k: None
    elif ctx.fault == "half_batch":
        step = model._train_step

        def half(feed, *a, **k):
            return step({n: v[:B // 2] for n, v in feed.items()}, *a, **k)
        model._train_step = half
    return SimpleNamespace(model=model, aug=aug, loop=loop, params0=params0,
                           raws=raws, labels=labels, loop_seed=loop_seed)


def run(ctx):
    net, cfg, tr, dev = ctx.net, ctx.cfg, ctx.traffic, ctx.device
    no_tf32()
    common.reset_peak(dev)
    tc = cfg["train"]
    B, K = tr["batch"], tr["chunk_steps"]
    sut = build_loop(ctx)
    model, aug, loop = sut.model, sut.aug, sut.loop
    params0, raws, labels, loop_seed = (sut.params0, sut.raws, sut.labels,
                                        sut.loop_seed)
    common.sync(dev)
    common.mark(ctx, "model, weights, cubes and loop")
    losses0, _ = loop.run_chunk()
    common.mark(ctx, "first chunk (capture and replay)")
    losses0 = [float(x) for x in losses0]
    first_params = {n: {k: v.detach().clone() for k, v in d.items()}
                    for n, d in model.params.items()}
    first_moment = {n: {k: v.detach().clone() for k, v in d.items()}
                    for n, d in model.opt_state["slots"][0].items()}
    if ctx.fault in ("control", "float64"):
        gen = torch.Generator(dev).manual_seed(loop_seed)
        losses0, first_params, first_moment = train_chunk(
            net, params0, raws, labels, gen, K, B, tc, tr,
            control=ctx.fault == "control",
            dtype=torch.float64 if ctx.fault == "float64" else torch.float32)
    for _ in range(tr["warmup_chunks"]):
        loop.run_chunk()
    common.sync(dev)
    common.mark(ctx, "warm-up")

    w = common.record(ctx)
    seconds = min(ctx.seconds, tr["trace_seconds"]) if ctx.trace \
        else ctx.seconds
    steps, bad = 0, 0
    with trace.traced(ctx.trace) as box:
        start = time.perf_counter()
        while True:
            losses, _ = loop.run_chunk()
            steps += K
            bad += int(sum(not math.isfinite(x) for x in losses))
            if time.perf_counter() - start >= seconds:
                break
        w.seconds = time.perf_counter() - start
    w.trace = box[0]
    w.peak_bytes = common.peak_bytes(dev)
    w.steps = w.attempted = steps
    w.failed = bad
    w.voxels_in = steps * B * math.prod(tc["patch"]) * net.input["f"]
    w.model_flops = 3 * steps * net.forward_flops(tc["patch"], B)

    del loop, model, aug
    common.release(dev)
    gen = torch.Generator(dev).manual_seed(loop_seed)
    ref = train_chunk(net, params0, raws, labels, gen, K, B, tc, tr)
    readings = chunk_readings(losses0, params0, first_params, first_moment,
                              ref)
    w.readings = readings
    w.checks = [(k, readings[k], lim) for k, lim in tr["check"].items()]
    return w
