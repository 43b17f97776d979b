"""Tracing waves: ``DeviceTracer(model, vol, max_steps=K,
min_step=...).trace_batch(seeds)`` in a closed loop of one client, on the
card a replay of the rollout's CUDA graph and the traces' decode on the
host.

The configuration (``"patch"``, ``"step_scale"``, ``"min_step"`` and the
graph's ``enc`` and ``gru`` widths) builds the program's tracing model,
``utils/convert.py::tracer_model``. The mix (``"driver": "tracer"``) gives
the ``volume`` shape (f, Z, X, Y; float32 uniform in [0, 1), made on the
card from the seed), the ``agents`` B a request and the ``steps`` K of its
rollout, the ``seed_inset`` (each request's B seed positions are drawn
fresh from the run's seed and the request's index, uniform in the margin
box shrunk by it on every side), the ``warmup`` requests (the first
captures the graph), the traced window's length (``trace_seconds``: a step
launches some 33 kernels) and the ``check``: ``count`` requests of the
first ``within``, drawn from the seed (the last request when the window
ended before any of them), are followed by the plain reference
teacher-forced from their own seeds along the program's own traces,
against a limit on the widest gap of a step (``step_gap``, voxels) and on
the agent-steps whose moved flag differs from the reference's decision
(``moved_mismatch``). A request runs from the call to the returned list of
``Trace``; a request that captured a new graph counts as failed. In a
traced run the compared requests' positions also give K2's bytes a launch:
the union of each step's windows (``extract_work.window_union``).

Faults (``ctx.fault``, for the checks' own tests and ``calibrate.py``):
``"answer"`` moves one recorded position of every request by 0.01 voxel,
``"nan_pick"`` makes a recorded position of the second compared request
NaN (the window runs until it has served two), ``"truncated"`` drops the
last recorded position of every request's longest trace, ``"control"``
serves the precision control (the plain reference with TF32 operands) in
the program's place.
"""

import math
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import harness, trace, weights
from ..extract_work import trilinear_patches_work, window_union
from ..peaks import bound_s
from ..reference.nets import no_tf32
from ..reference.tracer import TracerReference
from . import common

#: what ``calibrate.py`` puts in the program's place, beside the program
FAULTS = ["control", "answer", "truncated", "nan_pick"]


def widths(cfg):
    """(patch, the first Perceptron's width, the GRU's width) from the
    configuration."""
    first = {}
    for n in cfg["graph"]:
        first.setdefault(n["op"], n)
    return tuple(cfg["patch"]), first["perceptron"]["n_f"], first["gru"][
        "n_f"]


def param_shapes(cfg):
    """``[(node, name, shape)]`` of the tracing model's parameters, in the
    program's layout."""
    nodes, out = cfg["graph"], []
    f_in = {}
    for n in nodes:
        if n["op"] == "input":
            f_in[n["name"]] = n["f"] * math.prod(cfg["patch"])
        elif n["op"] == "perceptron":
            k = f_in[n["in"]]
            out += [(n["name"], "w", (k, n["n_f"])),
                    (n["name"], "b", (n["n_f"],))]
            f_in[n["name"]] = n["n_f"]
        elif n["op"] == "gru":
            k, m = f_in[n["in"]] + n["n_f"], n["n_f"]
            out += [(n["state"], "state0", (1, m)),
                    (n["name"], "w_gates", (k, 2 * m)),
                    (n["name"], "b_gates", (2 * m,)),
                    (n["name"], "w_cand", (k, m)),
                    (n["name"], "b_cand", (m,))]
            f_in[n["name"]] = m
        else:
            f_in[n["name"]] = f_in[n["in"]]
    return out


def agent_step_flops(cfg):
    """2 x the multiply-adds of one agent's step: every matrix's size."""
    return 2 * sum(math.prod(s) for _, k, s in param_shapes(cfg)
                   if k.startswith("w"))


def make_params(cfg, seed, device):
    """``{node: {name: tensor}}`` on ``device`` from ``seed``, in two calls
    of one generator: matrices normal with std sqrt(1 / fan in), biases and
    the initial state uniform in [-0.1, 0.1)."""
    shapes = param_shapes(cfg)
    mats = [(n, k, s) for n, k, s in shapes if k.startswith("w")]
    vecs = [(n, k, s) for n, k, s in shapes if not k.startswith("w")]
    gen = weights.generator(seed, "tracer_weights", device)
    w_all = torch.randn(sum(math.prod(s) for *_, s in mats), generator=gen,
                        device=device)
    v_all = torch.rand(sum(math.prod(s) for *_, s in vecs), generator=gen,
                       device=device) * 0.2 - 0.1
    params, i = {}, 0
    for n, k, s in mats:
        m = math.prod(s)
        params.setdefault(n, {})[k] = (w_all[i:i + m].reshape(s)
                                       / math.sqrt(s[0])).contiguous()
        i += m
    i = 0
    for n, k, s in vecs:
        m = math.prod(s)
        params.setdefault(n, {})[k] = v_all[i:i + m].reshape(s).clone()
        i += m
    return params


def request_seeds(seed, tag, i, tr, cfg):
    """Request ``i``'s B seed positions, float32 (B, 3), uniform in the
    margin box ``[p / 2 + 1, dim - p / 2 - 1)`` shrunk by ``seed_inset``,
    drawn from ``seed``, the stream ``tag`` and ``i``."""
    m = np.asarray(cfg["patch"], np.float64) / 2 + 1 + tr["seed_inset"]
    lo, hi = m, np.asarray(tr["volume"][1:], np.float64) - m
    g = torch.Generator().manual_seed(weights.sub_seed(seed, tag, i))
    u = torch.rand((tr["agents"], 3), generator=g,
                   dtype=torch.float64).numpy()
    return (lo + u * (hi - lo)).astype(np.float32)


def decode(coords, K):
    """(traj (K, B, 3), moved (K, B)) from each agent's recorded points
    (the seed, then the position after each step it moved in): a stopped
    agent keeps its last position."""
    B = len(coords)
    n = np.array([len(c) - 1 for c in coords])
    traj = np.empty((K, B, 3), np.float32)
    for b, c in enumerate(coords):
        pts = np.asarray(c, np.float32)
        m = min(n[b], K)
        traj[:m, b] = pts[1:m + 1]
        traj[m:, b] = pts[m]
    return traj, np.arange(K)[:, None] < n[None, :]


def k2_launch_bound_s(pos, B, volume, patch):
    """The roofline bound of K2's launch that cuts at ``pos`` (B, 3): its
    FLOPs and the bytes of the union of its windows."""
    return bound_s(*trilinear_patches_work(
        B, volume[0], patch, window_union(pos, patch, tuple(volume[1:]))))[0]


def control_serve(ctl, vol, K):
    """The precision control in the program's place: the reference's free
    rollout, recorded as the program records it."""
    def serve(seeds):
        traj, moved = ctl.rollout(vol, torch.from_numpy(seeds).to(
            vol.device), K)
        traj = traj.cpu().numpy().transpose(1, 0, 2)
        moved = moved.cpu().numpy().T
        return [np.concatenate([seeds[b:b + 1].astype(np.float64),
                                traj[b][moved[b]]]) for b in range(len(
                                    seeds))]
    return serve


def points(out):
    """Each agent's recorded points, a float64 array (n + 1, 3) a trace,
    of the program's ``Trace`` list or the control's arrays."""
    return [t.coords if hasattr(t, "coords") else t for t in out]


def plant(fault, out, i, picks, kept):
    """Break request ``i``'s answer where it is produced, as ``fault``
    says."""
    if fault not in ("answer", "nan_pick", "truncated"):
        return
    pts = points(out)
    longest = max(range(len(pts)), key=lambda b: len(pts[b]))
    if fault == "answer":
        c = pts[longest]
        c[len(c) // 2, 0] += 0.01
    elif fault == "nan_pick" and i in picks and len(kept) == 1:
        pts[longest][-1, 0] = float("nan")
    elif fault == "truncated" and len(pts[longest]) > 1:
        if hasattr(out[longest], "positions"):
            out[longest].positions.length -= 1
        else:
            out[longest] = out[longest][:-1]


def run(ctx):
    from elektronn2_tpu_torch.data.tracing_utils import DeviceTracer
    from elektronn2_tpu_torch.ops import extract
    from elektronn2_tpu_torch.utils.convert import tracer_model

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    no_tf32()
    common.reset_peak(dev)
    patch, enc_w, gru_w = widths(cfg)
    B, K = tr["agents"], tr["steps"]
    model = tracer_model(patch, enc_w=enc_w, gru_w=gru_w, device=dev)
    params = make_params(cfg, ctx.seed, dev)
    model.set_params(params)
    vol = weights.uniform_volume(ctx.seed, "volume", 0, tr["volume"], dev)
    tracer = DeviceTracer(model, vol, step_scale=cfg["step_scale"],
                          max_steps=K, min_step=cfg["min_step"])

    def seeds_of(i):
        return request_seeds(ctx.seed, "seeds", i, tr, cfg)

    common.sync(dev)
    common.mark(ctx, "model, weights and volume")
    for i in range(tr["warmup"]):
        tracer.trace_batch(request_seeds(ctx.seed, "warmup", i, tr, cfg))
    common.sync(dev)
    common.mark(ctx, "warm-up (graph capture)")
    chk = tr["check"]
    picks = set(common.sample(ctx.seed, "check", chk["count"],
                              chk["within"]))
    fault = ctx.fault
    if fault == "control":
        serve = control_serve(TracerReference(cfg, params, control=True),
                              vol, K)
    else:
        serve = tracer.trace_batch
    graphs0 = list(tracer._graphs.values())
    captured0 = tracer.capture_seconds

    kept, lat = {}, []
    failed = moved_steps = 0
    k2_before = extract.launches
    seconds = min(ctx.seconds, tr["trace_seconds"]) if ctx.trace \
        else ctx.seconds
    w = common.record(ctx)
    with trace.traced(ctx.trace) as box:
        start = time.perf_counter()
        while True:
            i = len(lat)
            s = seeds_of(i)
            t = time.perf_counter()
            with record_function("perfbench.request"):
                out = serve(s)
                plant(fault, out, i, picks, kept)
            lat.append(time.perf_counter() - t)
            if (tracer.capture_seconds is not captured0
                    or list(tracer._graphs.values()) != graphs0):
                failed += 1
                graphs0 = list(tracer._graphs.values())
                captured0 = tracer.capture_seconds
            if ctx.trace:
                moved_steps += sum(len(c) - 1 for c in points(out))
            if i in picks:
                kept[i] = out
            last = None if kept else (i, out)
            del out
            if time.perf_counter() - start >= seconds and not (
                    fault == "nan_pick" and len(kept) < min(2, len(picks))):
                break
        w.seconds = time.perf_counter() - start
    w.trace = box[0]
    w.peak_bytes = common.peak_bytes(dev)
    w.k2_counter = extract.launches - k2_before
    n = len(lat)
    w.requests = w.attempted = n
    w.steps = n * K
    w.failed = failed
    w.latencies_s = lat
    w.agent_steps = n * B * K
    w.moved_steps = moved_steps if ctx.trace else None
    w.model_flops = w.agent_steps * agent_step_flops(cfg)

    del tracer, model, serve
    common.release(dev)
    if not kept:                 # a window too short for every pick
        kept = dict([last])
    del last
    ref = TracerReference(cfg, params)
    gaps, mism, bounds = [], 0, []
    for i, out in sorted(kept.items()):
        s = seeds_of(i)
        pts = points(out)
        if len(pts) != len(s):
            gaps.append(float("nan"))
            continue
        first = common.worst(float(np.abs(c[0] - s[b]).max()) if len(c)
                             else math.inf for b, c in enumerate(pts))
        traj, moved = decode(pts, K)
        s_d, traj_d = (torch.from_numpy(a).to(vol.device) for a in (s, traj))
        gap, m = ref.follow(vol, s_d, traj_d,
                            torch.from_numpy(moved).to(vol.device))
        gaps += [first, gap]
        mism += m + sum(len(c) - 1 > K for c in pts)
        if ctx.trace and np.isfinite(traj).all():
            bounds += [k2_launch_bound_s(pos, B, tr["volume"], patch)
                       for pos in [s_d, *traj_d[:-1]]]
    if bounds:
        w.k2_launch_bound_s = sum(bounds) / len(bounds)
    w.checks = [("step_gap", common.worst(gaps), chk["step_gap"]),
                ("moved_mismatch", mism, chk["moved_mismatch"])]
    if w.trace is not None:
        k2 = harness.load_module("metrics", "k2_roofline.trace").K2_KERNEL
        seen = w.trace.count(lambda k: k2 in k)
        print(f"perfbench: K2 kernels in the trace {seen}, extract.launches "
              f"moved by {w.k2_counter}"
              + ("" if seen == w.k2_counter else
                 ": they differ, the profile lost launches"),
              file=sys.stderr)
    return w
