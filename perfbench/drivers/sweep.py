"""Whole-dataset sweeps: ``Model.sweep_knossos`` over a KNOSSOS dataset into
an in-memory ``out``, whole passes one after another.

The mix (``"driver": "sweep"``) gives the ``dataset`` shape (z, x, y; uint8
values uniform from the seed, written at set-up as a KNOSSOS cube tree of
``cube_edge`` cubes under ``$TMPDIR``), the sweep's ``step`` (null: the
program's default) and ``slab_batch``, the model's ``serving`` lowerings,
the ``warmup_passes`` and the ``check``: ``blocks`` output blocks of shape
``block`` drawn from the seed (the first at the dataset's origin corner,
where the reflect padding works) are compared with the plain reference of
the whole volume served with ``pad_raw``, against ``limit``. Each pass
reads the dataset through a fresh ``KnossosArray``: its own cube cache
starts empty, the files are in the page cache (a warm read). Before each
timed pass the compared blocks of ``out`` are set to NaN, so what is
compared is the last timed pass's own write.

Faults (``ctx.fault``, for the checks' own tests and ``calibrate.py``):
``"answer"`` alters a value after each pass, ``"stale"`` makes the timed
passes write nothing, ``"control"`` puts the precision control (the plain
reference with TF32 operands) in the program's place for the compared
blocks after each pass.
"""

import math
import shutil
import tempfile
import time

import numpy as np
import torch

from .. import build, trace, weights
from ..reference.nets import Reference, no_tf32
from . import common

#: what ``calibrate.py`` puts in the program's place, beside the program
FAULTS = ["control"]


def make_dataset(seed, shape, device):
    g = weights.generator(seed, "dataset", device)
    return torch.randint(0, 256, tuple(shape), generator=g, device=device,
                         dtype=torch.uint8)


def block_origins(seed, shape, block, count):
    """``count`` block origins: the origin corner first, the rest drawn
    from ``seed``."""
    g = torch.Generator().manual_seed(weights.sub_seed(seed, "blocks"))
    out = [(0, 0, 0)]
    for _ in range(count - 1):
        out.append(tuple(int(torch.randint(0, s - b + 1, (1,),
                                           generator=g))
                         for s, b in zip(shape, block)))
    return out


def ref_blocks(ref, net, cfg, vol, origins, block):
    """The plain reference's map of ``vol`` (uint8, z x y) over each
    ``block`` at ``origins``, served with ``pad_raw`` (on the CPU)."""
    volf = vol.to(torch.float32).div_(255.0)[None]
    whole = (ref.dense(volf, cfg.get("design_patch"))
             if net.has_upconv else None)
    xpad = None if net.has_upconv else ref.padded(volf)
    out = []
    for o in origins:
        if whole is not None:
            want = whole[(slice(None),) + tuple(
                slice(a, a + b) for a, b in zip(o, block))]
        else:
            want = ref.dilated(xpad[(slice(None), slice(None)) + tuple(
                slice(a, a + b + f - 1) for a, b, f in
                zip(o, block, net.fov))])[0]
        out.append(want.cpu())
    return out


def blocks_of(origins, block):
    """The index of each block in ``out`` (all channels)."""
    return [(slice(None),) + tuple(slice(a, a + b)
                                   for a, b in zip(o, block))
            for o in origins]


def run(ctx):
    from elektronn2_tpu_torch.data.knossos_array import (KnossosArray,
                                                         save_knossos)

    net, cfg, tr, dev = ctx.net, ctx.cfg, ctx.traffic, ctx.device
    no_tf32()
    common.reset_peak(dev)
    model = build.port_model(net, 1, cfg["design_patch"], dev,
                             mfp=not net.has_upconv)
    params = weights.make_params(net, ctx.seed, dev)
    model.set_params(params)
    build.apply_serving(model, tr["serving"])
    shape = tr["dataset"]
    vol = make_dataset(ctx.seed, shape, dev)
    common.sync(dev)
    common.mark(ctx, "model, weights and volume")
    tmp = tempfile.mkdtemp(prefix="perfbench_knossos_")
    try:
        save_knossos(vol.cpu().numpy(), tmp, exp_name="raw",
                     cube_edge=tr["cube_edge"])
        common.mark(ctx, "KNOSSOS dataset written")
        out = np.zeros([net.channels()[net.output["name"]]] + list(shape),
                       np.float32)
        step = tr["step"]
        chk = tr["check"]
        origins = block_origins(ctx.seed, shape, chk["block"],
                                chk["blocks"])
        where = blocks_of(origins, chk["block"])
        if ctx.fault == "control":
            with torch.no_grad():
                ctl = ref_blocks(Reference(net, params, control=True), net,
                                 cfg, vol, origins, chk["block"])

        def sweep(timings, timed=False):
            if timed:
                for ix in where:
                    out[ix] = np.nan
            if not (timed and ctx.fault == "stale"):
                model.sweep_knossos(KnossosArray(tmp), step=step, out=out,
                                    slab_batch=tr["slab_batch"],
                                    timings=timings)
            if ctx.fault == "answer":
                out[0, 0, 0, 0] += 0.01
            elif ctx.fault == "control":
                for ix, c in zip(where, ctl):
                    out[ix] = c.numpy()

        for _ in range(tr["warmup_passes"]):
            sweep({})
        common.sync(dev)
        common.mark(ctx, "warm-up")

        w = common.record(ctx)
        timings, passes = {}, 0
        with trace.traced(ctx.trace) as box:
            start = time.perf_counter()
            while True:
                sweep(timings, timed=True)
                passes += 1
                if time.perf_counter() - start >= ctx.seconds:
                    break
            w.seconds = time.perf_counter() - start
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    w.trace = box[0]
    w.peak_bytes = common.peak_bytes(dev)
    w.timings = timings
    w.slabs = sum(timings.get("slabs", []))
    w.attempted = passes
    w.voxels_out = passes * math.prod(shape)
    w.model_flops = w.voxels_out * net.dense_flops_per_voxel()

    del model
    common.release(dev)
    with torch.no_grad():
        want = ref_blocks(Reference(net, params), net, cfg, vol, origins,
                          chk["block"])
    gaps = [common.max_abs_gap(torch.from_numpy(out[ix]), r)
            for ix, r in zip(where, want)]
    w.checks = [("max_prob_gap", common.worst(gaps), chk["limit"])]
    return w
