"""Tracing runtime: roll out a recurrent tracing model as a batch of agents.

Port of ``CubeShape``, ``ShotgunRegistry`` and the fused ``DeviceTracer``
rollout in ``elektronn2_tpu/data/tracing_utils.py`` (reference:
``elektronn2/data/tracing_utils.py``). The rollout is a Python loop over
``max_steps`` that only enqueues work on the volume's device: positions, the
alive mask and the recurrent state stay tensors, every stop is a
``torch.where``, and the only copy to the host is the final trajectory. Each
step cuts the agents' patches with the hand-written CUDA kernel K2
(``ops/extract.py``) or, with ``rotate_to_heading=True``, K3
(``ops/extract_rot.py``), then evaluates the model's ``ScanN`` cell on them.

Where the JAX package compiles the rollout into one ``jax.jit(lax.scan)``,
a rollout on the card is captured once into a CUDA graph and replayed: one
dispatch per rollout instead of some 33 launches per step, each of which
costs the host more than the device takes to run it. A graph is kept per
(batch size, horizon, route, volume and parameter tensors), see
:meth:`DeviceTracer.graph_key`; a CPU volume takes the eager loop.

Not ported (``NotImplementedError`` naming ROADMAP.md §1 item 7b): the
respawning and chained pools (``trace_pool``, ``trace_pool_chain``,
``ShotgunRegistry.run(pool=True)``), ``tune_batch``, the host ``Tracer``,
the bf16 rotated mode, and (item 11) the mesh-sharded ``trace_batch``.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np
import torch

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
        self.launches = (0, 0)               # (K2, K3) per replay
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
    versions take. ``rot_precision`` ``'high'`` (the JAX default, a bf16x3
    MXU rung) and None both mean exact float32 here.

    The volume is moved to the model's device; the model's parameters must
    be there already (``Model.to``).

    On the card :meth:`trace_batch` (and so :meth:`trace` and
    ``ShotgunRegistry.run``) replays a CUDA graph of the whole rollout,
    captured on first use for its :meth:`graph_key`; ``capture_seconds`` is
    the last capture's time. At most ``MAX_GRAPHS`` graphs are kept, the
    least recently used dropped first.
    """

    #: captured rollouts kept per tracer
    MAX_GRAPHS = 2

    def __init__(self, model, volume, step_scale=1.0, max_steps=500,
                 min_step=1e-4, use_pallas_extract=None,
                 rotate_to_heading=False, use_pallas_rot=None,
                 rot_compute_dtype="float32", rot_precision="high"):
        if str(rot_compute_dtype) != "float32":
            raise NotImplementedError(
                f"rot_compute_dtype={rot_compute_dtype!r}: the bf16 rotated "
                "mode is not ported (ROADMAP.md §1 item 7b)")
        if rot_precision not in (None, "high", "highest"):
            raise ValueError(f"rot_precision={rot_precision!r}: expected "
                             "None, 'high' or 'highest' (all exact float32 "
                             "here)")
        self.model = model
        self.rotate_to_heading = bool(rotate_to_heading)
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
        # the margin-safe box [lo, hi) of positions, made once: building it
        # in the rollout would copy from the host, which synchronises
        margin = torch.tensor(self.patch_size, dtype=torch.float32,
                              device=self.volume.device) / 2.0 + 1.0
        self._lo = margin
        self._hi = torch.tensor(self.volume.shape[1:], dtype=torch.float32,
                                device=self.volume.device) - margin
        self._graphs = OrderedDict()         # graph_key -> _RolloutGraph
        self.capture_seconds = None

    # -- the plain patch cuts (the kernels' oracles) -------------------------
    def _extract(self, vol, pos):
        """Translation-only trilinear patches (B, f, *p) at positions
        (B, 3), the plain version of K2."""
        return extract.trilinear_patches_reference(vol, pos, self.patch_size)

    def _extract_rot_batch(self, vol, pos, headings):
        """Frame-aligned patches for a batch, the plain version of K3:
        returns ``(patches (B, f, *p), ok (B,), F (B, 3, 3))``, with ``ok``
        the host ``WarpingOOBError`` criterion and ``F`` the flight
        frames."""
        F = flight_frame(headings)
        patches, ok = extract_rot.rotated_patches_reference(
            vol, pos, F, self.patch_size)
        return patches, ok, F

    # -- the rollout ----------------------------------------------------------
    def _rollout(self, params, vol, seeds, headings0, steps=None):
        """Roll out ``steps`` (default ``max_steps``) steps from ``seeds``
        (B, 3); returns the device tensors ``(traj (K, B, 3), moved (K,
        B))``: each step's positions and which agents moved in it. Nothing in
        it waits for the device, so it can be captured in a CUDA graph."""
        B = seeds.shape[0]

        def inbounds(p):
            return torch.all((p >= self._lo) & (p < self._hi), dim=1)

        pos = seeds.float()
        alive = inbounds(pos)
        heading = headings0.float()
        rnn = self._init_carry(params, B)
        traj, moves = [], []
        with torch.no_grad(), f32_matmuls():
            for _ in range(self.max_steps if steps is None else steps):
                F = None
                if self.rotate_to_heading:
                    if self._rot_kernel:
                        F = flight_frame(heading)
                        patches, ok = extract_rot.rotated_patches(
                            vol, pos, F, self.patch_size)
                    else:
                        patches, ok, F = self._extract_rot_batch(vol, pos,
                                                                 heading)
                    alive = alive & ok     # host: rotated-cut OOB -> stop
                elif self._extract_kernel:
                    patches = extract.trilinear_patches(vol, pos,
                                                        self.patch_size)
                else:
                    patches = self._extract(vol, pos)
                pred, rnn_new = self._step_apply(params, patches, rnn)
                step = pred.reshape(B, -1)[:, :3].float() * self.step_scale
                if F is not None:
                    # the prediction lives in the view's frame -> world
                    step = torch.einsum("bji,bj->bi", F, step)
                moved = alive & (torch.linalg.norm(step, dim=1)
                                 >= self.min_step)
                newpos = pos + step
                pos = torch.where(moved[:, None], newpos, pos)
                if F is not None:
                    heading = torch.where(moved[:, None], step, heading)
                alive = moved & inbounds(newpos)
                rnn = tuple(torch.where(
                    moved.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)
                    for new, old in zip(rnn_new, rnn))
                traj.append(pos)
                moves.append(moved)
        if not traj:
            return (torch.zeros((0, B, 3), device=vol.device),
                    torch.zeros((0, B), dtype=torch.bool, device=vol.device))
        return torch.stack(traj), torch.stack(moves)

    # -- the rollout as one CUDA graph -----------------------------------------
    def graph_key(self, params, B):
        """The key under which a captured rollout of ``B`` agents with
        ``params`` is kept: B, the horizon and step rules, the route, and
        for the volume and every parameter tensor its identity, ``_version``
        and address. A graph reads its tensors' memory as it was at capture,
        so
        - ``Model.set_params`` makes new tensors: new ids, a new graph (ids
          are compared only while the kept graph holds the old tensors, so
          no id is reused; an address alone could be);
        - an in-place update (``p.add_(...)``, ``p.copy_(...)``) bumps
          ``_version``: a new graph;
        - assigning ``p.data = other`` bumps nothing but moves the address:
          a new graph. A write through ``p.data`` in place (``p.data.copy_``)
          changes neither, and needs none: the graph reads the same memory.
        """
        tensors = [self.volume] + _param_tensors(params)
        return (int(B), self.max_steps, self.step_scale, self.min_step,
                self.rotate_to_heading, self._extract_kernel, self._rot_kernel,
                tuple((id(t), t._version, t.data_ptr()) for t in tensors))

    def _capture(self, params, seeds, headings0):
        """Capture ``_rollout`` of ``seeds``' batch into a new
        ``_RolloutGraph``. A one-step eager rollout on the capture stream
        first loads the libraries, makes cuBLAS's workspace and lifts the
        kernels' shared-memory limits, so none of that happens inside the
        capture. The kernel counters tick while the capture records, though
        nothing runs: they are put back, and each replay adds the recorded
        launches instead."""
        dev = self.volume.device
        entry = _RolloutGraph([self.volume] + _param_tensors(params),
                              torch.empty((len(seeds), 3), device=dev),
                              torch.empty((len(seeds), 3), device=dev))
        entry.seeds.copy_(seeds)
        entry.heads.copy_(headings0)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._rollout(params, self.volume, entry.seeds, entry.heads,
                          steps=1)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = (extract.launches, extract_rot.launches)
        t0 = time.perf_counter()
        with torch.cuda.graph(entry.graph, stream=side):
            entry.traj, entry.moved = self._rollout(params, self.volume,
                                                    entry.seeds, entry.heads)
        entry.capture_seconds = self.capture_seconds = \
            time.perf_counter() - t0
        entry.launches = (extract.launches - before[0],
                          extract_rot.launches - before[1])
        extract.launches, extract_rot.launches = before
        return entry

    def _rollout_graphed(self, params, seeds, headings0):
        """``_rollout`` of ``max_steps`` steps as one replay of a CUDA graph,
        captured on the first call for :meth:`graph_key`. ``seeds`` and
        ``headings0`` (B, 3) may lie on the host or the card; they are copied
        into the graph's static inputs. Returns clones of the static outputs
        ``(traj, moved)``, so the next replay overwrites nothing a caller
        holds. A failed capture or replay raises: there is no eager
        fallback."""
        with torch.cuda.device(self.volume.device):
            key = self.graph_key(params, seeds.shape[0])
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
            extract.launches += entry.launches[0]
            extract_rot.launches += entry.launches[1]
            return entry.traj.clone(), entry.moved.clone()

    def trace_batch(self, seeds, save_kzip=None, mesh=None,
                    axis_name="data", initial_headings=None):
        """Roll out a batch of agents; returns a list of ``Trace``, each the
        seed followed by the positions of the steps its agent moved in.
        ``save_kzip``: also write the traces as a KNOSSOS annotation
        (``skeleton.trace_to_kzip``). ``initial_headings``: (B, 3) world
        headings orienting the first frame-aligned views when
        ``rotate_to_heading=True`` (default (0, 0, 1); ignored otherwise).
        ``mesh`` (sharding agents over devices) is not ported. On the card
        the rollout is a replay of its CUDA graph (:meth:`graph_key`), and
        its outputs are copied to the host at once; a CPU volume, no seeds
        or ``max_steps=0`` take the eager loop."""
        if mesh is not None:
            raise NotImplementedError(
                "trace_batch(mesh=...): sharding agents over devices is not "
                "ported (ROADMAP.md §1 item 11)")
        seeds = np.asarray(seeds, np.float32).reshape(-1, 3)
        heads = (np.broadcast_to(np.asarray([0.0, 0.0, 1.0], np.float32),
                                 seeds.shape).copy()
                 if initial_headings is None
                 else np.asarray(initial_headings, np.float32).reshape(-1, 3))
        if len(heads) != len(seeds):
            raise ValueError(f"initial_headings: {len(heads)} headings "
                             f"for {len(seeds)} seeds")
        dev = self.volume.device
        if dev.type == "cuda" and len(seeds) and self.max_steps:
            traj, moved = self._rollout_graphed(self.model.params,
                                                torch.from_numpy(seeds),
                                                torch.from_numpy(heads))
        else:
            traj, moved = self._rollout(self.model.params, self.volume,
                                        torch.from_numpy(seeds).to(dev),
                                        torch.from_numpy(heads).to(dev))
        traj = traj.cpu().numpy().transpose(1, 0, 2)     # (B, K, 3)
        moved = moved.cpu().numpy().T                    # (B, K)
        traces = [Trace(np.concatenate([seeds[b:b + 1].astype(np.float64),
                                        traj[b][moved[b]]], axis=0))
                  for b in range(len(seeds))]
        if save_kzip:
            from .skeleton import trace_to_kzip
            trace_to_kzip(traces, save_kzip)
        return traces

    def trace(self, seed_position, initial_heading=None):
        """Single-agent convenience wrapper (host ``Tracer`` interface)."""
        heads = None if initial_heading is None \
            else np.asarray(initial_heading, np.float32).reshape(1, 3)
        return self.trace_batch([seed_position], initial_headings=heads)[0]


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
            for p in trace.coords:
                self._kdt.append(p)

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
        documented relaxation, bounded by ``radius``). ``save_kzip``: after
        the drain, write all traces as a KNOSSOS annotation. ``pool=True``
        (the respawning on-device pool) is not ported.
        """
        if pool:
            raise NotImplementedError(
                "ShotgunRegistry.run(pool=True): the respawning and chained "
                "pool rollouts are not ported (ROADMAP.md §1 item 7b)")
        batch_size = int(batch_size)
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
        if save_kzip:
            self.save_kzip(save_kzip)
        return self.traces
