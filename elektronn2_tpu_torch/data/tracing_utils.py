"""Tracing runtime: roll out a recurrent tracing model as a batch of agents.

Port of ``elektronn2_tpu/data/tracing_utils.py`` (reference:
``elektronn2/data/tracing_utils.py``): ``CubeShape``, the host ``Tracer``,
``ShotgunRegistry`` and the fused ``DeviceTracer`` with its respawning and
chained pools and ``tune_batch``. The rollout is a Python loop over
``max_steps`` that only enqueues work on the volume's device: positions, the
alive mask and the recurrent state stay tensors, every stop is a
``torch.where``, and the only copy to the host is the final trajectory. Each
step cuts the agents' patches with the hand-written CUDA kernel K2
(``ops/extract.py``) or, with ``rotate_to_heading=True``, K3
(``ops/extract_rot.py``, float32, or bf16 with
``rot_compute_dtype="bfloat16"``), then evaluates the model's ``ScanN`` cell
on them.

Where the JAX package compiles the rollout into one ``jax.jit(lax.scan)``,
a rollout on the card is captured once into a CUDA graph and replayed: one
dispatch per rollout instead of some 33 launches per step, each of which
costs the host more than the device takes to run it. A graph is kept per
(batch size, horizon, route, volume and parameter tensors), see
:meth:`DeviceTracer.graph_key`; a CPU volume takes the eager loop.

The pools (``trace_pool``, ``trace_pool_chain``) keep every agent's state on
the device (positions, alive, heading, step counter, ids, the queue pointer,
the recurrent carry) and respawn dead slots from a device-resident seed
queue inside the step. On the card a pool wave is replays of one captured
chunk of S steps (S <= ``POOL_CHUNK``); the step index, the wave's length,
its consumption cut, queue length and id offset are device scalars, so one
graph serves every wave of a (B, queue, S), a step past the wave's end is a
no-op, and each replay's rows are copied on the device into the wave's
trajectory. ``trace_batch(mesh=...)`` splits the agents over a mesh axis:
each rank replays its own shard's rollout and the trajectories are gathered
after the replay, so every rank returns every trace.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np
import torch
import torch.distributed as dist

from ..log import logger
from ..ops import extract, extract_rot
from ..ops.conv import f32_matmuls
from .skeleton import Trace


class CubeShape:
    """Geometry helper for a volume being traced (bounds, safe margins)."""

    def __init__(self, shape, margin):
        self.shape = np.asarray(shape, np.float64)
        self.margin = np.asarray(margin, np.float64)

    def inside(self, pos):
        return np.all(pos >= self.margin) and np.all(
            pos < self.shape - self.margin)

    def clip(self, pos):
        return np.clip(pos, self.margin, self.shape - self.margin - 1)


def _discover_scan(model):
    """(scan_node, per-step input node) for a tracing model: the single
    ScanN's sequence input for recurrent graphs, the designated input for
    feedforward step predictors."""
    from ..neuromancer.various import ScanN
    nodes = getattr(model, "nodes", None)
    if not nodes:           # duck-typed step predictor (has .predict only)
        return None, model.input_node
    scan = next((n for n in nodes.values() if isinstance(n, ScanN)), None)
    if scan is not None:
        its = scan.in_iterate
        if len(its) != 1:
            raise ValueError("tracing needs a ScanN with exactly one "
                             f"sequence input, got {len(its)}")
        return scan, its[0]
    return None, model.input_node


class _AgentStepper:
    """Per-step model evaluation: patches (+ carried recurrent state) →
    step prediction, routed through the model graph (the ScanN cell for
    recurrent models; the sequence input is bypassed)."""

    def _step_apply(self, params, patches, carry):
        """One agent step: patches (B, f, *p) + carried state → (pred,
        new_carry)."""
        from ..neuromancer.node_basic import TraceCtx
        model, scan = self.model, self.scan_node
        if scan is None:
            ctx = TraceCtx(params, {self._x_node.name: patches})
            return ctx.get(model.prediction_node), carry
        ctx = TraceCtx(params, {})
        for m, c in zip(scan.in_memory, carry):
            ctx.values[m.name] = c
        ctx.values[self._x_node.name] = patches
        cell_out = ctx.get(scan.step_result)
        new_carry = tuple(ctx.get(o) for o in scan.out_memory)
        if model.prediction_node is scan:
            return cell_out, new_carry
        # head nodes after the scan were built against the time-stacked
        # (s, b, ...) shape, whose axis indices they keep: inject the
        # per-step cell output as a length-1 sequence
        ctx2 = TraceCtx(params, {})
        ctx2.values[scan.name] = cell_out[None]
        return ctx2.get(model.prediction_node)[0], new_carry

    def _init_carry(self, params, batch):
        """Initial carried state, re-broadcast from the model's design
        batch to the rollout batch (initial states are batch-constant)."""
        from ..neuromancer.node_basic import TraceCtx
        if self.scan_node is None:
            return ()
        ctx = TraceCtx(params, {})
        return tuple(v[:1].expand((batch,) + tuple(v.shape[1:]))
                     for v in (ctx.get(m) for m in self.scan_node.in_memory))


class Tracer(_AgentStepper):
    """Iteratively apply a step-prediction model to follow a neurite, one
    agent and one step at a time.

    Reference: ``tracing_utils.py::Tracer``. Each step cuts the agent's
    patch on the host (``warp_slice``, or ``get_tracing_slice`` along the
    heading with ``rotate_to_heading=True``), moves it to the model's
    device, evaluates the model (the ``ScanN`` cell with the hidden state
    carried across steps, for recurrent models) and reads the step back: a
    host round trip per step. ``DeviceTracer`` runs whole batches on the
    device. A duck-typed model with only ``predict`` and ``input_node`` is
    called with the numpy patch.
    """

    def __init__(self, model, volume, step_scale=1.0, max_steps=500,
                 stop_on_oob=True, rotate_to_heading=False):
        self.model = model
        self.volume = volume            # (f, Z, X, Y)
        self.step_scale = float(step_scale)
        self.max_steps = int(max_steps)
        self.stop_on_oob = stop_on_oob
        self.rotate_to_heading = bool(rotate_to_heading)
        self.scan_node, self._x_node = _discover_scan(model)
        ps = self._x_node.shape.spatial_shape
        self.patch_size = ps
        self.cube = CubeShape(volume.shape[1:], np.asarray(ps) / 2 + 1)

    def _is_graph(self):
        return bool(getattr(self.model, "nodes", None))

    def trace(self, seed_position, initial_heading=None):
        """Trace from a seed; returns a ``Trace``. ``initial_heading``
        orients the first frame-aligned view when ``rotate_to_heading=True``
        (default (0, 0, 1))."""
        from .transformations import (WarpingOOBError, flight_frame,
                                      get_tracing_slice, warp_slice)
        pos = np.asarray(seed_position, np.float64)
        heading = (np.array([0.0, 0.0, 1.0]) if initial_heading is None
                   else np.asarray(initial_heading, np.float64))
        trace = Trace([pos])
        graph = self._is_graph()
        device = getattr(self.model, "device", torch.device("cpu"))
        carry = self._init_carry(self.model.params, 1) if graph else ()
        for _ in range(self.max_steps):
            if not self.cube.inside(pos):
                if self.stop_on_oob:
                    break
                pos = self.cube.clip(pos)
            try:
                if self.rotate_to_heading:
                    patch = get_tracing_slice(self.volume, self.patch_size,
                                              position=pos,
                                              direction=heading)
                else:
                    patch = warp_slice(self.volume, self.patch_size,
                                       position=pos)
            except WarpingOOBError:
                break
            if not graph:
                pred = np.asarray(self.model.predict(patch[None]))
            else:
                x = torch.from_numpy(np.ascontiguousarray(
                    patch[None], np.float32)).to(device)
                with torch.no_grad(), f32_matmuls():
                    pred, carry = self._step_apply(self.model.params, x,
                                                   carry)
                pred = pred.cpu().numpy()
            step = np.asarray(pred)[0].reshape(-1)[:3] * self.step_scale
            if self.rotate_to_heading:
                # the prediction lives in the view's local frame -> world
                step = flight_frame(heading).T @ step
            if np.linalg.norm(step) < 1e-4:
                break
            pos = pos + step
            if self.rotate_to_heading:
                heading = step
            trace.append(pos)
        return trace

    def trace_many(self, seeds):
        return [self.trace(s) for s in seeds]


def flight_frame(h):
    """Batched flight frames: (B, 3) headings → (B, 3, 3) orthonormal rows
    (tangent, normal1, normal2). A heading of norm ≤ 1e-12 falls back to
    (0, 0, 1); the reference vector is ŷ where |t·x̂| > 0.9, else x̂.
    Reference: ``tracing_utils.py::_flight_frame_jnp`` and
    ``transformations.py::flight_frame``. The unit vectors are made on the
    device (``torch.eye``): a tensor built from a Python list would be a
    host-to-device copy, which synchronises the host."""
    ex, ey, ez = torch.eye(3, dtype=h.dtype, device=h.device)
    n = torch.linalg.norm(h, dim=1, keepdim=True)
    big = n > 1e-12
    t = torch.where(big, h / torch.where(big, n, torch.ones_like(n)), ez)
    ref = torch.where(t[:, :1].abs() > 0.9, ey, ex)
    n1 = torch.linalg.cross(t, ref, dim=1)
    n1 = n1 / torch.linalg.norm(n1, dim=1, keepdim=True)
    n2 = torch.linalg.cross(t, n1, dim=1)
    return torch.stack([t, n1, n2], dim=1)


def _kernel_route(knob, vol, name):
    """Resolve ``use_pallas_extract`` / ``use_pallas_rot``: None picks the
    kernel for a CUDA volume, True demands it, False takes the plain
    version."""
    if knob is None:
        return vol.device.type == "cuda"
    if knob and vol.device.type != "cuda":
        raise ValueError(f"{name}=True needs the volume on a CUDA device (the "
                         f"kernel has no CPU mode), got {vol.device}")
    return bool(knob)


def _param_tensors(params):
    """The tensors of ``{node: {name: tensor}}``, in a fixed order."""
    return [params[n][k] for n in sorted(params) for k in sorted(params[n])]


#: the kernel launch counters a captured graph replays: K2, K3 in float32,
#: K3 in bf16
_COUNTERS = ((extract, "launches"), (extract_rot, "launches"),
             (extract_rot, "launches_bf16"))


def _counts():
    return tuple(getattr(m, a) for m, a in _COUNTERS)


def _set_counts(values):
    for (m, a), v in zip(_COUNTERS, values):
        setattr(m, a, v)


def _add_counts(values):
    _set_counts(tuple(c + v for c, v in zip(_counts(), values)))


def _to_host(*tensors):
    """Numpy copies of device tensors, after one wait: on the card each is
    copied into pinned memory without blocking and the stream is waited on
    once; on the CPU each is cloned (the pool's state tensors change in
    place later)."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.detach().clone().numpy() for t in tensors]
    outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for o, t in zip(outs, tensors):
        o.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [o.numpy() for o in outs]


class _RolloutGraph:
    """One captured rollout: the CUDA graph, its static inputs (seeds,
    headings) and outputs (``traj``, ``moved``), the tensors it reads
    (held, so that their ids stay unique while the graph lives), the kernel
    launches it makes per replay and the seconds its capture took."""

    def __init__(self, tensors, seeds, heads):
        self.tensors = tensors
        self.seeds, self.heads = seeds, heads
        self.graph = torch.cuda.CUDAGraph()
        self.traj = self.moved = None
        self.launches = (0, 0, 0)            # per replay, as _COUNTERS
        self.capture_seconds = None


class _PoolState:
    """Every pool agent's state on the device, for B slots and a queue of N
    seeds: positions, alive, heading, per-agent step counter, ids (queue
    index of the agent holding a slot, -1 for none), the recurrent carry,
    the queue pointer and step index, and the wave's device scalars (its
    length ``t_end``, consumption cut ``t_cut``, queue length ``n_q`` and
    id offset). The tensors are made once, outside any capture, and updated
    in place: a captured chunk reads and writes them, and the chained pool's
    carry crosses waves in them. The all-dead initial carry, the default
    heading and the recurrent initial state are made here too."""

    def __init__(self, tracer, params, B, N):
        dev = tracer.volume.device
        i32 = dict(dtype=torch.int32, device=dev)
        self.B, self.N = int(B), int(N)
        self.pos = torch.zeros((B, 3), device=dev)
        self.alive = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.h_def = torch.tensor([0.0, 0.0, 1.0],
                                  device=dev).expand(B, 3).contiguous()
        self.heading = self.h_def.clone()
        self.steps = torch.zeros((B,), **i32)
        self.ids = torch.full((B,), -1, **i32)
        self.rnn = tuple(c.contiguous().clone()
                         for c in tracer._init_carry(params, B))
        self.ptr, self.t, self.t_end, self.t_cut, self.n_q, self.id_offset = (
            torch.zeros((), **i32) for _ in range(6))
        self.queue = torch.zeros((N, 3), device=dev)
        self._pinned = (torch.empty((N, 3), pin_memory=True)
                        if dev.type == "cuda" else None)
        self._copied = None        # the event after the last queue upload

    def tensors(self):
        return ([self.pos, self.alive, self.heading, self.steps, self.ids,
                 self.ptr, self.t] + list(self.rnn))

    def reset(self, carry0):
        """All slots dead, headings (0, 0, 1), no ids, the recurrent state
        at its initial value: the start of a pool or of a chain."""
        self.pos.zero_()
        self.alive.zero_()
        self.heading.copy_(self.h_def)
        self.steps.zero_()
        self.ids.fill_(-1)
        for r, c in zip(self.rnn, carry0):
            r.copy_(c)

    def wave(self, seeds, n_q, t_end, t_cut, id_offset):
        """Set up a wave: the queue from ``seeds`` (N, 3) float32 numpy (on
        the card through a pinned buffer, without a host sync), the device
        scalars (``id_offset`` may be a 0-d device tensor, copied on the
        device), and the pointer and step index back to 0."""
        if self._pinned is None:
            self.queue.copy_(torch.from_numpy(seeds))
        else:
            if self._copied is not None:
                self._copied.synchronize()     # the last upload is done
            np.copyto(self._pinned.numpy(), seeds)
            self.queue.copy_(self._pinned, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()
        for t, v in ((self.n_q, n_q), (self.t_end, t_end),
                     (self.t_cut, t_cut), (self.id_offset, id_offset)):
            if isinstance(v, torch.Tensor):
                t.copy_(v)
            else:
                t.fill_(int(v))
        self.ptr.zero_()
        self.t.zero_()


class _PoolGraph:
    """One captured pool chunk over a ``_PoolState``: the CUDA graph, its
    static outputs (``traj``, ``moved``, ``ids``, a row a step), the tensors
    it reads and the state it writes (held), its launches per replay and
    capture time."""

    def __init__(self, tensors, state):
        self.tensors, self.state = tensors, state
        self.graph = torch.cuda.CUDAGraph()
        self.traj = self.moved = self.ids = None
        self.launches = (0, 0, 0)
        self.capture_seconds = None


class DeviceTracer(_AgentStepper):
    """Fused agent rollout: a batch of agents steps through a volume that
    stays on the device.

    Each step cuts every agent's patch at its float position (trilinear,
    translation only; or, with ``rotate_to_heading=True``, resampled along
    its flight heading), evaluates the model's recurrent cell, moves the
    agents and masks the ones that stopped. Reference semantics
    (``tracing_utils.py::DeviceTracer``): OOB margin = patch/2 + 1
    (``CubeShape``), a step shorter than ``min_step`` stops the agent,
    stopped agents freeze in place; a step taken from a valid position is
    recorded even when it leaves the margin, and the agent dies after it.
    Works with recurrent models built around a single-sequence ``ScanN``
    and with feedforward step predictors.

    ``use_pallas_extract`` / ``use_pallas_rot`` choose the patch cut, as
    the JAX knobs do: None takes the CUDA kernel (K2 / K3) for a CUDA
    volume and the plain PyTorch version for a CPU volume, True demands the
    kernel (a CPU volume raises), False takes the plain version. There is no
    eligibility fallback: the kernels take every geometry the plain
    versions take. ``rot_compute_dtype="bfloat16"`` is K3's bf16 mode: a
    bf16 copy of the volume, made once here, bf16 operands and float32 sums
    (``extract_rot.rotated_patches_bf16``; its plain version on the CPU).
    ``rot_precision`` ``'high'`` (the JAX default, a bf16x3 MXU rung) and
    None both mean exact float32 in the float32 mode; the bf16 mode ignores
    it, as in JAX.

    The volume is moved to the model's device; the model's parameters must
    be there already (``Model.to``).

    On the card :meth:`trace_batch` (and so :meth:`trace` and
    ``ShotgunRegistry.run``) replays a CUDA graph of the whole rollout,
    captured on first use for its :meth:`graph_key`; ``capture_seconds`` is
    the last capture's time. At most ``MAX_GRAPHS`` graphs are kept, the
    least recently used dropped first. The pools keep their chunk graphs
    apart, at most ``POOL_GRAPHS``, so a pool never evicts a kept rollout.
    """

    #: captured rollouts kept per tracer
    MAX_GRAPHS = 2
    #: captured pool chunks kept per tracer (the JAX package keeps 4 pool
    #: programs)
    POOL_GRAPHS = 4
    #: the longest pool chunk a graph holds, in steps
    POOL_CHUNK = 64

    def __init__(self, model, volume, step_scale=1.0, max_steps=500,
                 min_step=1e-4, use_pallas_extract=None,
                 rotate_to_heading=False, use_pallas_rot=None,
                 rot_compute_dtype="float32", rot_precision="high"):
        if str(rot_compute_dtype) not in ("float32", "bfloat16"):
            raise ValueError(f"rot_compute_dtype={rot_compute_dtype!r}: "
                             "expected 'float32' or 'bfloat16'")
        if rot_precision not in (None, "high", "highest"):
            raise ValueError(f"rot_precision={rot_precision!r}: expected "
                             "None, 'high' or 'highest' (all exact float32 "
                             "here)")
        self.model = model
        self.rotate_to_heading = bool(rotate_to_heading)
        self.rot_compute_dtype = str(rot_compute_dtype)
        self.rot_precision = rot_precision
        device = getattr(model, "device", torch.device("cpu"))
        # float32 like the host path: an integer volume would truncate the
        # trilinear fractions
        self.volume = torch.as_tensor(volume).to(
            device=device, dtype=torch.float32).contiguous()
        if self.volume.ndim != 4:
            raise ValueError("DeviceTracer volume must be (f, Z, X, Y), "
                             f"got {tuple(self.volume.shape)}")
        self.step_scale = float(step_scale)
        self.max_steps = int(max_steps)
        self.min_step = float(min_step)
        self.scan_node, self._x_node = _discover_scan(model)
        ps = self._x_node.shape.spatial_shape
        if len(ps) != 3:
            raise ValueError("DeviceTracer expects a 3D patch input, got "
                             f"spatial shape {tuple(ps)}")
        self.patch_size = tuple(int(p) for p in ps)
        if any(v < p + 2 for v, p in zip(self.volume.shape[1:],
                                         self.patch_size)):
            raise ValueError(
                f"volume {tuple(self.volume.shape[1:])} too small for "
                f"patch {self.patch_size} (+1 interpolation slab)")
        self._rot_kernel = self.rotate_to_heading and _kernel_route(
            use_pallas_rot, self.volume, "use_pallas_rot")
        self._extract_kernel = not self.rotate_to_heading and _kernel_route(
            use_pallas_extract, self.volume, "use_pallas_extract")
        self._rot_bf16 = (self.rotate_to_heading
                          and self.rot_compute_dtype == "bfloat16")
        # the bf16 mode's copy of the volume, made once (never per step)
        self._vol_bf16 = (self.volume.to(torch.bfloat16).contiguous()
                          if self._rot_bf16 else None)
        # the margin-safe box [lo, hi) of positions, made once: building it
        # in the rollout would copy from the host, which synchronises
        margin = torch.tensor(self.patch_size, dtype=torch.float32,
                              device=self.volume.device) / 2.0 + 1.0
        self._lo = margin
        self._hi = torch.tensor(self.volume.shape[1:], dtype=torch.float32,
                                device=self.volume.device) - margin
        self._graphs = OrderedDict()         # graph_key -> _RolloutGraph
        self._pool_graphs = OrderedDict()    # pool key -> _PoolGraph
        self._pool_states = OrderedDict()    # (B, N) -> _PoolState
        self.capture_seconds = None

    # -- the patch cuts -------------------------------------------------------
    def _extract(self, vol, pos):
        """Translation-only trilinear patches (B, f, *p) at positions
        (B, 3), the plain version of K2."""
        return extract.trilinear_patches_reference(vol, pos, self.patch_size)

    def _bf16_volume(self, vol):
        """The bf16 copy of ``vol``: the one made at construction for the
        tracer's own volume."""
        return self._vol_bf16 if vol is self.volume \
            else vol.to(torch.bfloat16).contiguous()

    def _extract_rot_batch(self, vol, pos, headings):
        """Frame-aligned patches for a batch, the plain version of K3 (in the
        tracer's mode): returns ``(patches (B, f, *p), ok (B,), F (B, 3,
        3))``, with ``ok`` the host ``WarpingOOBError`` criterion and ``F``
        the flight frames."""
        F = flight_frame(headings)
        if self._rot_bf16:
            patches, ok = extract_rot.rotated_patches_bf16_reference(
                self._bf16_volume(vol), pos, F, self.patch_size)
        else:
            patches, ok = extract_rot.rotated_patches_reference(
                vol, pos, F, self.patch_size)
        return patches, ok, F

    def _cut(self, vol, pos, heading):
        """Every agent's patch by the tracer's route: ``(patches, ok, F)``,
        ``ok`` and ``F`` None for translation."""
        if self.rotate_to_heading:
            if not self._rot_kernel:
                return self._extract_rot_batch(vol, pos, heading)
            F = flight_frame(heading)
            if self._rot_bf16:
                patches, ok = extract_rot.rotated_patches_bf16(
                    self._bf16_volume(vol), pos, F, self.patch_size)
            else:
                patches, ok = extract_rot.rotated_patches(vol, pos, F,
                                                          self.patch_size)
            return patches, ok, F
        if self._extract_kernel:
            return extract.trilinear_patches(vol, pos, self.patch_size), \
                None, None
        return self._extract(vol, pos), None, None

    def _inbounds(self, p):
        return torch.all((p >= self._lo) & (p < self._hi), dim=1)

    def _agent_step(self, params, vol, pos, alive, heading, rnn):
        """One step of every agent: cut, model, move. A rotated cut's ``ok``
        stops an agent first. Returns ``(pos, heading, rnn, moved,
        newpos)``: the agents that moved took their step and the new
        recurrent state, the others stay as they were."""
        B = pos.shape[0]
        patches, ok, F = self._cut(vol, pos, heading)
        if ok is not None:
            alive = alive & ok           # host: rotated-cut OOB -> stop
        pred, rnn_new = self._step_apply(params, patches, rnn)
        step = pred.reshape(B, -1)[:, :3].float() * self.step_scale
        if F is not None:
            # the prediction lives in the view's frame -> world
            step = torch.einsum("bji,bj->bi", F, step)
        moved = alive & (torch.linalg.norm(step, dim=1) >= self.min_step)
        newpos = pos + step
        pos = torch.where(moved[:, None], newpos, pos)
        if F is not None:
            heading = torch.where(moved[:, None], step, heading)
        rnn = tuple(torch.where(
            moved.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)
            for new, old in zip(rnn_new, rnn))
        return pos, heading, rnn, moved, newpos

    # -- the rollout ----------------------------------------------------------
    def _rollout(self, params, vol, seeds, headings0, steps=None):
        """Roll out ``steps`` (default ``max_steps``) steps from ``seeds``
        (B, 3); returns the device tensors ``(traj (K, B, 3), moved (K,
        B))``: each step's positions and which agents moved in it. Nothing in
        it waits for the device, so it can be captured in a CUDA graph."""
        B = seeds.shape[0]
        pos = seeds.float()
        alive = self._inbounds(pos)
        heading = headings0.float()
        rnn = self._init_carry(params, B)
        traj, moves = [], []
        with torch.no_grad(), f32_matmuls():
            for _ in range(self.max_steps if steps is None else steps):
                pos, heading, rnn, moved, newpos = self._agent_step(
                    params, vol, pos, alive, heading, rnn)
                alive = moved & self._inbounds(newpos)
                traj.append(pos)
                moves.append(moved)
        if not traj:
            return (torch.zeros((0, B, 3), device=vol.device),
                    torch.zeros((0, B), dtype=torch.bool, device=vol.device))
        return torch.stack(traj), torch.stack(moves)

    # -- the rollout as one CUDA graph -----------------------------------------
    def graph_key(self, params, B, group=None):
        """The key under which a captured rollout of ``B`` agents with
        ``params`` is kept: B, the horizon and step rules, the route (bf16
        mode included), the process group of a sharded ``trace_batch``
        (``group``: its identity, size and this rank), and for the volume
        (and its bf16 copy) and every parameter tensor its identity,
        ``_version`` and address. A graph
        reads its tensors' memory as it was at capture, so
        - ``Model.set_params`` makes new tensors: new ids, a new graph (ids
          are compared only while the kept graph holds the old tensors, so
          no id is reused; an address alone could be);
        - an in-place update (``p.add_(...)``, ``p.copy_(...)``) bumps
          ``_version``: a new graph;
        - assigning ``p.data = other`` bumps nothing but moves the address:
          a new graph. A write through ``p.data`` in place (``p.data.copy_``)
          changes neither, and needs none: the graph reads the same memory.
        """
        mesh_key = () if group is None else (
            id(group), dist.get_world_size(group), dist.get_rank(group))
        return (int(B), self.max_steps, self.step_scale, self.min_step,
                self.rotate_to_heading, self._extract_kernel, self._rot_kernel,
                self._rot_bf16, mesh_key,
                tuple((id(t), t._version, t.data_ptr())
                      for t in self._read_tensors(params)))

    def _read_tensors(self, params):
        """The volume (and its bf16 copy) and every parameter tensor: what a
        captured graph reads besides its own buffers."""
        vols = [self.volume] + ([self._vol_bf16] if self._rot_bf16 else [])
        return vols + _param_tensors(params)

    def _captured(self, entry, record, warm):
        """Capture ``record()`` into ``entry.graph`` on a side stream, after
        ``warm()`` ran there eagerly: the warm-up loads the libraries, makes
        cuBLAS's workspace and lifts the kernels' shared-memory limits, so
        none of that happens inside the capture. The kernel counters tick
        while the capture records, though nothing runs: they are put back,
        and each replay adds the recorded launches instead. Returns what
        ``record`` returned."""
        dev = self.volume.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = _counts()
        t0 = time.perf_counter()
        with torch.cuda.graph(entry.graph, stream=side):
            out = record()
        entry.capture_seconds = self.capture_seconds = \
            time.perf_counter() - t0
        entry.launches = tuple(a - b for a, b in zip(_counts(), before))
        _set_counts(before)
        return out

    def _capture(self, params, seeds, headings0):
        """Capture ``_rollout`` of ``seeds``' batch into a new
        ``_RolloutGraph`` (a one-step eager rollout warms up first)."""
        dev = self.volume.device
        entry = _RolloutGraph(self._read_tensors(params),
                              torch.empty((len(seeds), 3), device=dev),
                              torch.empty((len(seeds), 3), device=dev))
        entry.seeds.copy_(seeds)
        entry.heads.copy_(headings0)
        entry.traj, entry.moved = self._captured(
            entry,
            lambda: self._rollout(params, self.volume, entry.seeds,
                                  entry.heads),
            lambda: self._rollout(params, self.volume, entry.seeds,
                                  entry.heads, steps=1))
        return entry

    def _rollout_graphed(self, params, seeds, headings0, group=None):
        """``_rollout`` of ``max_steps`` steps as one replay of a CUDA graph,
        captured on the first call for :meth:`graph_key`. ``seeds`` and
        ``headings0`` (B, 3) may lie on the host or the card; they are copied
        into the graph's static inputs. Returns clones of the static outputs
        ``(traj, moved)``, so the next replay overwrites nothing a caller
        holds. A failed capture or replay raises: there is no eager
        fallback."""
        with torch.cuda.device(self.volume.device):
            key = self.graph_key(params, seeds.shape[0], group)
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._graphs[key] = self._capture(params, seeds,
                                                          headings0)
                while len(self._graphs) > self.MAX_GRAPHS:
                    self._graphs.popitem(last=False)
            else:
                self._graphs.move_to_end(key)
                entry.seeds.copy_(seeds)
                entry.heads.copy_(headings0)
            entry.graph.replay()
            _add_counts(entry.launches)
            return entry.traj.clone(), entry.moved.clone()

    def trace_batch(self, seeds, save_kzip=None, mesh=None,
                    axis_name="data", initial_headings=None):
        """Roll out a batch of agents; returns a list of ``Trace``, each the
        seed followed by the positions of the steps its agent moved in.
        ``save_kzip``: also write the traces as a KNOSSOS annotation
        (``skeleton.trace_to_kzip``). ``initial_headings``: (B, 3) world
        headings orienting the first frame-aligned views when
        ``rotate_to_heading=True`` (default (0, 0, 1); ignored otherwise).
        On the card the rollout is a replay of its CUDA graph
        (:meth:`graph_key`), and its outputs are copied to the host at once;
        a CPU volume, no seeds or ``max_steps=0`` take the eager loop.

        ``mesh``: split the agents over the mesh axis ``axis_name``. Every
        rank is given all the seeds, pads them (and the headings) to a
        multiple of the axis size by repeating the last one, rolls out its
        own shard against its own copy of the volume and parameters (no
        collective inside the rollout, which is the shard's CUDA graph on
        the card), and gathers the trajectories over the axis's group after
        the replay; every rank returns all the traces, equal to the
        unsharded call's. Only global rank 0 writes ``save_kzip``."""
        seeds = np.asarray(seeds, np.float32).reshape(-1, 3)
        heads = (np.broadcast_to(np.asarray([0.0, 0.0, 1.0], np.float32),
                                 seeds.shape).copy()
                 if initial_headings is None
                 else np.asarray(initial_headings, np.float32).reshape(-1, 3))
        if len(heads) != len(seeds):
            raise ValueError(f"initial_headings: {len(heads)} headings "
                             f"for {len(seeds)} seeds")
        n_real = len(seeds)
        group = None
        run_s, run_h = seeds, heads
        if mesh is not None and n_real:
            from ..parallel.halo import axis_group, shard
            group = axis_group(mesh, axis_name)
            pad = -n_real % dist.get_world_size(group)
            run_s, run_h = (shard(torch.from_numpy(np.concatenate(
                [a, np.repeat(a[-1:], pad, axis=0)])), group, 0).numpy()
                for a in (seeds, heads))
        traj, moved = self._rollout_any(run_s, run_h, group)
        if group is not None:
            from ..parallel.halo import gather
            traj = gather(traj, group, 1)[:, :n_real]
            moved = gather(moved.to(torch.uint8), group, 1)[:, :n_real].bool()
        traj = traj.cpu().numpy().transpose(1, 0, 2)     # (B, K, 3)
        moved = moved.cpu().numpy().T                    # (B, K)
        traces = [Trace(np.concatenate([seeds[b:b + 1].astype(np.float64),
                                        traj[b][moved[b]]], axis=0))
                  for b in range(n_real)]
        if save_kzip and (group is None or dist.get_rank() == 0):
            from .skeleton import trace_to_kzip
            trace_to_kzip(traces, save_kzip)
        return traces

    def _rollout_any(self, seeds, heads, group=None):
        """``_rollout`` of the (B, 3) numpy ``seeds`` and ``heads``: a replay
        of its CUDA graph on the card, else the eager loop (a CPU volume, no
        seeds, ``max_steps=0``); returns the device tensors (traj, moved)."""
        dev = self.volume.device
        if dev.type == "cuda" and len(seeds) and self.max_steps:
            return self._rollout_graphed(self.model.params,
                                         torch.from_numpy(seeds),
                                         torch.from_numpy(heads), group)
        return self._rollout(self.model.params, self.volume,
                             torch.from_numpy(seeds).to(dev),
                             torch.from_numpy(heads).to(dev))

    def trace(self, seed_position, initial_heading=None):
        """Single-agent convenience wrapper (host ``Tracer`` interface)."""
        heads = None if initial_heading is None \
            else np.asarray(initial_heading, np.float32).reshape(1, 3)
        return self.trace_batch([seed_position], initial_headings=heads)[0]

    # -- the pools --------------------------------------------------------------
    def _pool_chunk(self, params, st, steps):
        """``steps`` pool steps on the ``_PoolState`` ``st``, whose tensors
        are updated in place at the end; returns the device tensors
        ``(traj (steps, B, 3), moved (steps, B), ids (steps, B))``. Step t
        (the device index ``st.t``, which the chunk increments) first
        respawns dead slots from the queue while ``t <= t_cut`` (prefix-sum
        slot -> queue matching, one gather, masked resets of position,
        heading, ids, step counter and recurrent state; the pointer advances
        by the respawns, up to N), then steps every agent as the rollout
        does, an agent also dying at ``max_steps`` steps. A step at ``t >=
        t_end`` changes nothing and records no move, so a chunk may run past
        its wave's end. Nothing here syncs the host."""
        B, N = st.B, st.N
        pos, alive, heading = st.pos, st.alive, st.heading
        nsteps, ids, ptr, t, rnn = st.steps, st.ids, st.ptr, st.t, st.rnn
        carry0 = self._init_carry(params, B)
        trajs, moves, idss = [], [], []
        with torch.no_grad(), f32_matmuls():
            for _ in range(steps):
                active = t < st.t_end
                # ---- respawn dead slots from the queue -------------------
                spawn = ~alive & (t <= st.t_cut) & active
                cand = ptr + torch.cumsum(spawn, 0, dtype=torch.int32) - 1
                valid = spawn & (cand < st.n_q)
                newpos = torch.index_select(st.queue, 0,
                                            cand.clamp(0, N - 1).long())
                pos = torch.where(valid[:, None], newpos, pos)
                heading = torch.where(valid[:, None], st.h_def, heading)
                ids = torch.where(valid, cand + st.id_offset, ids)
                nsteps = nsteps.masked_fill(valid, 0)
                alive = alive | (valid & self._inbounds(newpos))
                rnn = tuple(torch.where(
                    valid.reshape((-1,) + (1,) * (c.ndim - 1)), c, r)
                    for c, r in zip(carry0, rnn))
                ptr = torch.clamp(ptr + valid.sum(dtype=torch.int32), max=N)
                # ---- one agent step --------------------------------------
                pos, heading, rnn, moved, newp = self._agent_step(
                    params, self.volume, pos, alive & active, heading, rnn)
                nsteps = nsteps + moved.to(torch.int32)
                alive = torch.where(
                    active, moved & self._inbounds(newp)
                    & (nsteps < self.max_steps), alive)
                t = t + 1
                trajs.append(pos)
                moves.append(moved)
                idss.append(ids)
            for dst, src in zip(st.tensors(), [pos, alive, heading, nsteps,
                                               ids, ptr, t] + list(rnn)):
                dst.copy_(src)
        return torch.stack(trajs), torch.stack(moves), torch.stack(idss)

    def _pool_state(self, params, B, N):
        """The ``_PoolState`` of B slots and an N-seed queue (made on first
        use; a few are kept)."""
        st = self._pool_states.get((B, N))
        if st is None:
            st = self._pool_states[(B, N)] = _PoolState(self, params, B, N)
            while len(self._pool_states) > self.POOL_GRAPHS:
                self._pool_states.popitem(last=False)
        return st

    def _pool_chunk_len(self, steps):
        """S: the chunk length for a wave of ``steps`` steps, at most
        ``POOL_CHUNK``, spread so that the last replay wastes the fewest
        steps."""
        n_rep = -(-int(steps) // self.POOL_CHUNK)
        return -(-int(steps) // n_rep)

    def _pool_graph(self, params, st, S):
        """The captured chunk of S steps over ``st``, captured on first use
        for its key (``graph_key`` with the state's identity, S and N); the
        capture's one-step warm-up is undone on the state."""
        key = ("pool", id(st), st.N, int(S)) + self.graph_key(params, st.B)
        entry = self._pool_graphs.get(key)
        if entry is not None:
            self._pool_graphs.move_to_end(key)
            return entry
        entry = _PoolGraph(self._read_tensors(params), st)

        def warm():
            saved = [x.clone() for x in st.tensors()]
            self._pool_chunk(params, st, 1)
            for x, v in zip(st.tensors(), saved):
                x.copy_(v)

        entry.traj, entry.moved, entry.ids = self._captured(
            entry, lambda: self._pool_chunk(params, st, S), warm)
        self._pool_graphs[key] = entry
        while len(self._pool_graphs) > self.POOL_GRAPHS:
            self._pool_graphs.popitem(last=False)
        return entry

    def _pool_wave(self, params, st, seeds, n_q, steps, t_cut, id_offset,
                   graphed=True):
        """One pool wave of ``steps`` steps over ``st`` with the queue
        ``seeds`` ((N, 3) float32 numpy, the first ``n_q`` valid), the
        consumption cut ``t_cut`` and the id offset: on the card replays of
        the chunk graph, each replay's rows copied on the device into the
        wave's outputs; on the CPU (or with ``graphed=False``, the graph's
        reference) the same chunks eagerly. Returns the device tensors
        ``(traj (steps, B, 3), moved (steps, B), ids (steps, B))``, with no
        host sync."""
        B, dev = st.B, self.volume.device
        st.wave(seeds, n_q, steps, t_cut, id_offset)
        traj = torch.empty((steps, B, 3), device=dev)
        moved = torch.empty((steps, B), dtype=torch.bool, device=dev)
        ids = torch.empty((steps, B), dtype=torch.int32, device=dev)
        if steps == 0:
            return traj, moved, ids
        S = self._pool_chunk_len(steps)
        entry = None
        if dev.type == "cuda" and graphed:
            with torch.cuda.device(dev):
                entry = self._pool_graph(params, st, S)
        for r0 in range(0, steps, S):
            if entry is not None:
                entry.graph.replay()
                _add_counts(entry.launches)
                out = (entry.traj, entry.moved, entry.ids)
            else:
                out = self._pool_chunk(params, st, S)
            n = min(S, steps - r0)
            for dst, src in zip((traj, moved, ids), out):
                dst[r0:r0 + n].copy_(src[:n])
        return traj, moved, ids

    def _pool_setup(self, B, N):
        """The state of B slots and an N-seed queue, reset to all dead."""
        params = self.model.params
        st = self._pool_state(params, B, N)
        st.reset(self._init_carry(params, B))
        return st

    def trace_pool(self, seeds, batch_size=512, total_steps=None,
                   save_kzip=None):
        """Respawning pool rollout over a seed queue.

        ``batch_size`` agent slots step ``total_steps`` steps; the step
        after a slot's agent dies (``min_step`` stop, out of bounds, or its
        ``max_steps`` cap) the slot takes the next seed of the queue, on the
        device, so the cost buys useful steps and not a dead batch majority.
        Slots stop taking seeds after ``total_steps - max_steps``, so every
        consumed agent gets its full budget. Every pool agent starts with
        the (0, 0, 1) heading. The per-slot step streams are decoded on the
        host by one stable argsort on the recorded queue index.

        ``total_steps`` defaults to ``max_steps * (ceil(N / batch_size) +
        1)``. Returns ``(traces, stats)``: one ``Trace`` per consumed seed,
        in seed order (the seeds not consumed are reported, not dropped);
        ``stats`` holds ``consumed``, ``effective_steps`` (recorded agent
        steps) and ``slot_steps`` (B x total_steps). Reference:
        ``tracing_utils.py::DeviceTracer.trace_pool`` / ``_build_pool``.
        """
        seeds = np.asarray(seeds, np.float32).reshape(-1, 3)
        N = len(seeds)
        B = int(batch_size)
        if total_steps is None:
            total_steps = self.max_steps * (-(-N // B) + 1)
        total = int(total_steps)
        if N and total:
            st = self._pool_setup(B, N)
            out = self._pool_wave(self.model.params, st, seeds, N, total,
                                  max(0, total - self.max_steps), 0)
            traj, moved, ids, n_used = _to_host(*out, st.ptr)
            n_used = int(n_used)
        else:
            traj = np.zeros((total, B, 3), np.float32)
            moved = np.zeros((total, B), bool)
            ids = np.zeros((total, B), np.int32)
            n_used = 0
        # an agent holds one slot contiguously: flattened slot-major, its
        # steps stay in step order and one stable argsort groups them
        mt = moved.T
        ids_f = ids.T[mt]
        pts_f = traj.transpose(1, 0, 2)[mt]
        order = np.argsort(ids_f, kind="stable")
        ids_s = ids_f[order]
        pts_s = pts_f[order].astype(np.float64)
        cuts = np.searchsorted(ids_s, np.arange(n_used + 1))
        traces = [Trace(np.concatenate([seeds[i:i + 1].astype(np.float64),
                                        pts_s[cuts[i]:cuts[i + 1]]], axis=0))
                  for i in range(n_used)]
        stats = {"consumed": n_used,
                 "effective_steps": int(moved.sum()),
                 "slot_steps": B * total}
        if save_kzip:
            from .skeleton import trace_to_kzip
            trace_to_kzip(traces, save_kzip)
        return traces, stats

    def trace_pool_chain(self, seed_source, batch_size=512,
                         wave_seeds=None, wave_steps=None, register=None,
                         save_kzip=None):
        """Drain seeds through chained pool waves: the agents' state crosses
        waves, so live agents keep stepping into the next wave and the drain
        tail is paid once, at the end of the whole drain.

        ``seed_source``: an array of seeds, or a callable returning one seed
        per call (None when exhausted), e.g. ``ShotgunRegistry.next_seed``.
        A wave takes up to ``wave_seeds`` (default 8 x ``batch_size``)
        seeds and runs ``wave_steps`` (default ``max_steps * wave_seeds //
        batch_size``) steps with no consumption cut; seeds it did not take
        go to the next wave. After each wave one readback brings the wave's
        outputs, the live ids and the alive mask to the host, and
        ``register`` (optional) is called with each trace whose agent is no
        longer live. Returns ``(traces, stats)``, traces in consumption
        order; stats adds ``waves`` and ``util`` to ``trace_pool``'s.
        Reference: ``tracing_utils.py::DeviceTracer.trace_pool_chain`` /
        ``_build_pool_chained``.
        """
        B = int(batch_size)
        N = int(8 * B if wave_seeds is None else wave_seeds)
        if wave_steps is None:
            wave_steps = self.max_steps * max(1, N // max(1, B))
        wave_steps = int(wave_steps)
        if callable(seed_source):
            get_seed = seed_source
        else:
            _pending = [np.asarray(s, np.float64)
                        for s in np.asarray(seed_source,
                                            np.float64).reshape(-1, 3)]
            _pending.reverse()

            def get_seed():
                return _pending.pop() if _pending else None

        st = self._pool_setup(B, N)
        no_cut = np.iinfo(np.int32).max
        alive = np.zeros(B, bool)
        offset = 0
        queue_back = []                       # unconsumed wave seeds
        global_seeds = []                     # gid -> seed (consumed)
        open_pts = {}                         # gid -> [(n, 3) chunks]
        pending_fin = set()                   # consumed, not finalized
        traces_by_gid = {}
        eff = 0
        waves = 0
        while True:
            wave = list(queue_back)
            queue_back = []
            while len(wave) < N:
                s = get_seed()
                if s is None:
                    break
                wave.append(np.asarray(s, np.float64))
            n_q = len(wave)
            if n_q == 0 and not alive.any():
                break
            padded = np.zeros((N, 3), np.float32)
            if n_q:
                padded[:n_q] = np.asarray(wave, np.float32)
            out = self._pool_wave(self.model.params, st, padded, n_q,
                                  wave_steps, no_cut, offset)
            traj, moved, ids, n_used, alive, live_ids = _to_host(
                *out, st.ptr, st.alive, st.ids)
            waves += 1
            n_used = int(n_used)
            eff += int(moved.sum())
            # ---- cross-wave decode (slot-major, stable) -------------------
            mt = moved.T
            ids_f = ids.T[mt]
            pts_f = traj.transpose(1, 0, 2)[mt]
            order = np.argsort(ids_f, kind="stable")
            ids_s = ids_f[order]
            pts_s = pts_f[order].astype(np.float64)
            for gi in np.unique(ids_s):
                lo = np.searchsorted(ids_s, gi, side="left")
                hi = np.searchsorted(ids_s, gi, side="right")
                open_pts.setdefault(int(gi), []).append(pts_s[lo:hi])
            global_seeds.extend(wave[:n_used])
            pending_fin.update(range(offset, offset + n_used))
            queue_back = wave[n_used:]
            offset += n_used
            # ---- finalize the traces whose agent is no longer live -------
            # (a consumed seed with no recorded step, e.g. an OOB spawn
            # that died at once, still yields its seed-only Trace)
            live = set(live_ids[alive].tolist())
            for gi in sorted(pending_fin - live):
                pts = np.concatenate(
                    [np.asarray(global_seeds[gi], np.float64).reshape(1, 3)]
                    + open_pts.pop(gi, []), axis=0)
                t = Trace(pts)
                traces_by_gid[gi] = t
                pending_fin.discard(gi)
                if register is not None:
                    register(t)
        traces = [traces_by_gid[g] for g in sorted(traces_by_gid)]
        stats = {"consumed": offset,
                 "effective_steps": eff,
                 "slot_steps": B * wave_steps * waves,
                 "waves": waves,
                 "util": round(eff / max(1, B * wave_steps * waves), 3)}
        if save_kzip:
            from .skeleton import trace_to_kzip
            trace_to_kzip(traces, save_kzip)
        return traces, stats

    def tune_batch(self, candidates=(256, 512, 1024, 2048), steps=64,
                   repeats=2, verbose=False):
        """Measure the rollout's agent-steps/s at each candidate batch on
        the tracer's device and return ``{"best": B, "table": {B:
        agent_steps_per_s}}``. Each candidate rolls out ``steps`` steps from
        interior seeds (numpy seed 0): on the card replays of its captured
        rollout graph (two warm-up calls, then the best of two windows of
        ``repeats`` replays), on the CPU the eager loop. Afterwards
        ``max_steps`` and the kept rollout graphs are put back as they
        were: the graphs captured here are dropped, and none the caller
        kept is evicted for good. Reference: ``DeviceTracer.tune_batch``."""
        saved = (OrderedDict(self._graphs), self.max_steps,
                 self.capture_seconds)
        rng = np.random.RandomState(0)
        lo = [m + 1 for m in np.asarray(self.patch_size) / 2.0 + 1.0]
        hi = [d - m - 1 for d, m in zip(self.volume.shape[1:], lo)]
        if any(h < l for l, h in zip(lo, hi)):
            raise ValueError(
                f"volume {tuple(self.volume.shape[1:])} too small to "
                f"sample interior probe seeds for patch "
                f"{tuple(self.patch_size)} (need every dim > patch + 4)")
        dev = self.volume.device
        params = self.model.params
        table = {}

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        try:
            self.max_steps = int(steps)
            for B in candidates:
                seeds = torch.from_numpy(np.stack(
                    [rng.uniform(l, h, B) for l, h in zip(lo, hi)],
                    1).astype(np.float32)).to(dev)
                heads = torch.zeros_like(seeds)
                heads[:, 2] = 1.0
                if dev.type == "cuda":
                    def fn():
                        return self._rollout_graphed(params, seeds, heads)
                else:
                    def fn():
                        return self._rollout(params, self.volume, seeds,
                                             heads)
                fn()
                fn()                             # double warm-up
                sync()
                best = None
                for _ in range(2):
                    t0 = time.perf_counter()
                    for _ in range(repeats):
                        fn()
                    sync()
                    dt = (time.perf_counter() - t0) / repeats
                    best = dt if best is None else min(best, dt)
                table[int(B)] = round(B * steps / best, 1)
                if verbose:
                    print(f"tune_batch: B={B} -> "
                          f"{table[int(B)] / 1e3:.1f} K agent-steps/s",
                          flush=True)
        finally:
            self._graphs, self.max_steps, self.capture_seconds = saved
        best_b = max(table, key=table.get)
        return {"best": best_b, "table": table}


class ShotgunRegistry:
    """Seed-point registry: dedupes seeds against already-traced paths.

    Reference: ``tracing_utils.py::ShotgunRegistry``: seeds within
    ``radius`` of an existing trace are covered and skipped.
    """

    def __init__(self, seeds, radius=5.0):
        self.pending = [np.asarray(s, np.float64) for s in seeds]
        self.radius = float(radius)
        self.traces = []
        self._kdt = None         # built lazily on first register()

    def next_seed(self):
        while self.pending:
            s = self.pending.pop()
            if self._kdt is None or len(self._kdt) == 0:
                return s
            d, _, _ = self._kdt.get_knn(s, k=1)
            if float(d) > self.radius:
                return s
        return None

    def register(self, trace):
        from ..utils.basic import DynamicKDT
        self.traces.append(trace)
        if self._kdt is None:
            self._kdt = DynamicKDT(trace.coords)
        else:
            self._kdt.extend(trace.coords)

    def save_kzip(self, fname, scale=(1.0, 1.0, 1.0)):
        """Export every registered trace as a KNOSSOS annotation (one
        ``thing`` per trace). Reference: ``skeleton.py::trace_to_kzip``."""
        from .skeleton import trace_to_kzip
        return trace_to_kzip(self.traces, fname, scale=scale)

    def run(self, tracer, batch_size=1, save_kzip=None, pool=False):
        """Drain the registry through a tracer.

        With ``batch_size > 1`` and a tracer with ``trace_batch``, seeds are
        rolled out ``batch_size`` at a time; the last partial batch is
        padded with its first seed to a constant batch size and the padding
        traces are dropped, so on the card one captured rollout graph serves
        the whole drain. Seeds of one batch are deduped against earlier
        traces only, not against each other's fresh paths (the reference's
        documented relaxation, bounded by ``radius``).

        ``pool=True`` (``DeviceTracer``): drain through the chained pool
        (``trace_pool_chain``, fed by :meth:`next_seed`, registering each
        finished trace between waves, so later waves dedupe against it), or
        through ``trace_pool`` waves of 8 x ``batch_size`` seeds for a
        tracer with only that. ``save_kzip``: after the drain, write all
        traces as a KNOSSOS annotation.
        """
        batch_size = int(batch_size)
        if pool and hasattr(tracer, "trace_pool_chain"):
            # the carry crosses waves: the drain tail is paid once
            _, stats = tracer.trace_pool_chain(
                self.next_seed, batch_size=batch_size,
                register=self.register)
            logger.info(
                f"chained pool drain: {stats['consumed']} seeds over "
                f"{stats['waves']} waves at {stats['util']:.0%} slot "
                "utilization")
        elif pool and hasattr(tracer, "trace_pool"):
            while True:
                seeds = []
                while len(seeds) < batch_size * 8:
                    s = self.next_seed()
                    if s is None:
                        break
                    seeds.append(s)
                if not seeds:
                    break
                traces, stats = tracer.trace_pool(seeds,
                                                  batch_size=batch_size)
                for t in traces:
                    self.register(t)
                n_used = stats["consumed"]
                if n_used < len(seeds):   # budget-truncated: re-queue
                    self.pending.extend(seeds[n_used:])
                logger.info(
                    f"pool wave: {n_used} seeds, "
                    f"{stats['effective_steps']} steps at "
                    f"{stats['effective_steps'] / max(1, stats['slot_steps']):.0%}"
                    " slot utilization")
        else:
            if pool:
                logger.warning("pool=True needs a trace_pool-capable tracer "
                               "(DeviceTracer); draining without it")
            self._drain(tracer, batch_size)
        if save_kzip:
            self.save_kzip(save_kzip)
        return self.traces

    def _drain(self, tracer, batch_size):
        """The drain without a pool: batches through ``trace_batch``, or
        one seed at a time through ``trace``."""
        if batch_size > 1 and not hasattr(tracer, "trace_batch"):
            logger.warning(
                f"batch_size={batch_size} requested but {type(tracer).__name__} "
                "has no trace_batch: draining serially")
        if batch_size > 1 and hasattr(tracer, "trace_batch"):
            while True:
                seeds = []
                while len(seeds) < batch_size:
                    s = self.next_seed()
                    if s is None:
                        break
                    seeds.append(s)
                if not seeds:
                    break
                n_real = len(seeds)
                seeds = seeds + [seeds[0]] * (batch_size - n_real)
                for t in tracer.trace_batch(seeds)[:n_real]:
                    self.register(t)
                logger.info(f"traced a batch of {n_real} seeds")
        else:
            while True:
                seed = self.next_seed()
                if seed is None:
                    break
                t = tracer.trace(seed)
                self.register(t)
                logger.info(f"traced {len(t)} steps from {seed}")
