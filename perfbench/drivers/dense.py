"""Dense prediction requests: ``Model.predict_dense_device(vol,
pad_raw=True)`` in a closed loop of one client.

The mix (``traffic/*.json``, ``"driver": "dense"``) gives the request's
``shape`` (f, z, x, y), how many distinct volumes the client cycles through
(``volumes``, made on the card from the seed at set-up), the model's
``serving`` lowerings, the ``warmup`` requests, and the ``check``: how many
requests (``count``) of the first ``within``, drawn from the seed, are
compared whole with the plain reference (the last request when the window
ended before any of them), and the ``limit`` on the widest gap between the
served and the reference probabilities. A request runs from the call to its result
ready on the card (a synchronize); the window runs whole requests until
``--seconds`` have passed.

Faults (``ctx.fault``, for the checks' own tests and ``calibrate.py``):
``"answer"`` alters a served value where it is produced, ``"nan_pick"``
makes the second compared request's first value NaN (the window runs until
it has served two), ``"control"`` serves
the precision control (the plain reference with TF32 operands) in the
program's place.
"""

import math
import sys
import time

import torch
from torch.profiler import record_function

from .. import build, netspec, peaks, trace, weights
from ..reference.nets import Reference, no_tf32
from . import common

#: what ``calibrate.py`` puts in the program's place, beside the program
FAULTS = ["control"]


def k1_bound_s(net, cfg, shape, serving):
    """K1's bound for one request: the sum over the convs K1 takes of the
    larger of their FLOPs at the TF32 peak and their bytes at HBM speed
    (``peaks``), from the shapes of the dense computation."""
    convdense = net.has_upconv
    on = (serving.get("convdense_impl", {}).get("ptail") if convdense
          else serving.get("dilated_impl", {}).get("pallas_tail"))
    if not on:
        return 0.0, 0
    total, n = 0.0, 0
    for node, s, d in net.dense_convs(shape[1:], cfg.get("design_patch")):
        if netspec.k1_takes(node, d, convdense):
            f, b = peaks.conv3x3_work(1, *s, node["n_f"], d[1], d[2])
            total += peaks.bound_s(f, b)[0]
            n += 1
    return total, n


def run(ctx):
    from elektronn2_tpu_torch.ops import tailconv

    net, cfg, tr, dev = ctx.net, ctx.cfg, ctx.traffic, ctx.device
    no_tf32()
    common.reset_peak(dev)
    model = build.port_model(net, 1, cfg["design_patch"], dev,
                             mfp=not net.has_upconv)
    params = weights.make_params(net, ctx.seed, dev)
    model.set_params(params)
    build.apply_serving(model, tr["serving"])
    shape = tr["shape"]
    vols = [weights.uniform_volume(ctx.seed, "volume", i, shape, dev)
            for i in range(tr["volumes"])]
    common.sync(dev)
    common.mark(ctx, "model, weights and inputs")
    for i in range(tr["warmup"]):
        model.predict_dense_device(vols[i % len(vols)], pad_raw=True)
    common.sync(dev)
    common.mark(ctx, "warm-up")
    chk = tr["check"]
    picks = set(common.sample(ctx.seed, "check", chk["count"],
                              chk["within"]))
    fault = ctx.fault
    if fault == "control":
        ctl = Reference(net, params, control=True)

        def serve(v):
            with torch.no_grad():
                return ctl.dense(v, cfg.get("design_patch"))
    else:
        def serve(v):
            return model.predict_dense_device(v, pad_raw=True)

    kept, lat = {}, []
    k1_before = tailconv.launches
    w = common.record(ctx)
    with trace.traced(ctx.trace) as box:
        start = time.perf_counter()
        while True:
            i = len(lat)
            t = time.perf_counter()
            with record_function("perfbench.request"):
                y = serve(vols[i % len(vols)])
                if fault == "answer":
                    y[0, 0, 0, 0] += 0.01
                elif fault == "nan_pick" and i in picks and len(kept) == 1:
                    y[0, 0, 0, 0] = float("nan")
            common.sync(dev)
            lat.append(time.perf_counter() - t)
            if i in picks:
                kept[i] = y
            last = None if kept else (i, y)
            del y
            if time.perf_counter() - start >= ctx.seconds and not (
                    fault == "nan_pick" and len(kept) < min(2, len(picks))):
                break
        w.seconds = time.perf_counter() - start
    w.trace = box[0]
    w.peak_bytes = common.peak_bytes(dev)
    w.k1_counter = tailconv.launches - k1_before
    n = len(lat)
    vox = math.prod(shape[1:])
    bound, per_call = k1_bound_s(net, cfg, shape, tr["serving"])
    w.requests = w.attempted = n
    w.latencies_s = lat
    w.voxels_out = n * vox
    w.model_flops = n * vox * net.dense_flops_per_voxel()
    w.k1_bound_s = n * bound

    del model, serve
    common.release(dev)
    if not kept:                 # a window too short for every pick
        kept = dict([last])
    del last
    gaps = []
    with torch.no_grad():
        ref = Reference(net, params)
        for i, y in sorted(kept.items()):
            want = ref.dense(vols[i % len(vols)], cfg.get("design_patch"))
            gaps.append(common.max_abs_gap(y, want))
            del want
    w.checks = [("max_prob_gap", common.worst(gaps), chk["limit"])]
    if w.trace is not None and per_call:
        seen = w.trace.count(lambda k: trace.K1_KERNEL in k)
        print(f"perfbench: K1 kernels in the trace {seen}, tailconv.launches "
              f"moved by {w.k1_counter}"
              + ("" if seen == w.k1_counter else
                 ": they differ, the profile lost launches"),
              file=sys.stderr)
    return w
