"""Fused multi-step training: K optimisation steps per replay of one CUDA
graph.

Port of ``make_fused_trainstep`` and ``FusedTrainLoop`` in
``elektronn2_tpu/training/fused_loop.py``. There, batch sampling,
augmentation (``DeviceBatchAugmenter.device_batch``), forward, backward and
the optimiser update of K steps are one jitted ``lax.scan``, and the host
dispatches once per K steps and reads back a (K,) loss vector. Here the K
steps are recorded once into a CUDA graph and each chunk is one replay of
it: the host launches one graph, then reads the (K,) losses and errors back
in one copy.

What the graph holds, and why it stays right:
- It reads and writes fixed memory: the parameters, the optimiser's slots
  and step counter (updated in place by ``Optimiser.update``), batch norm's
  running statistics (``Model.state``, made before the capture by
  ``Model.init_state`` and written in place by each step), the
  hyperparameters as 0-d tensors (``Optimiser.current_hyper``, refreshed
  before each replay, so a ``setlr`` between chunks takes effect with no
  recapture), the augmenter's cube stacks, and (2, K) loss/error buffers.
- Its random draws (the batches, dropout's masks, ``GaussianRV``'s noise)
  come from the loop's own ``torch.Generator``, registered with the graph,
  so every replay draws new batches and masks: the state
  advances by the graph's whole offset on each replay, and a replay draws
  what the eager chunk would from the same state.
- A replay bumps no tensor's version, so after it the loop bumps the
  versions of every tensor the chunk wrote
  (``torch.autograd.graph.increment_version``): caches keyed on a version,
  ``ops/tailconv.py::packed_weights`` (K1 serving the trained weights) and
  ``DeviceTracer.graph_key``, see the new weights.
- It is kept under :meth:`FusedTrainLoop.graph_key` (B, K, the warp, grey
  and flip switches, cuDNN's deterministic and benchmark flags, and the
  identity, ``_version`` and address of every parameter, slot and cube
  stack); ``Model.set_params``, ``Model.set_opt``, an outside in-place write
  or a new augmenter changes the key and the next chunk recaptures.
- Augmentation, forward, backward and update run inside
  ``f32_convs``/``f32_matmuls``, during capture too, so cuDNN and cuBLAS
  record their full float32 algorithms and not TF32 ones.

``HostFedFusedLoop`` (JAX ``make_fused_hostfed_trainstep`` and
``HostFedFusedLoop``) runs the same machinery over a host data source: K
``data.getbatch`` batches are stacked into pinned host buffers and copied
into static feed buffers on the card before the replay (never inside a
capture: a copy under capture fails it), and a prefetch thread draws the
next chunk's batches while the graph runs. The pinned buffers come in two
slots used in turn; refilling a slot first waits on the event of that
slot's last copy, so the host never overwrites bytes still being copied
(``PinnedStage``, which also stages the Trainer's per-step batches).

``HostFedFusedLoop(carry_map=...)`` is the fused truncated BPTT of the
tracing trainer: the recurrent state of a ``ScanN`` rides the chunk. Each
step feeds it under the state node's name and the next step takes the
scan's last time slice (a detached value, so gradients stop at every step's
boundary). The carry is a static buffer (``rnn_carry``): the chunk's first
step reads it and its last step writes it, inside the graph, so it crosses
replays.

A failed capture or replay raises; there is no eager fallback on the card.
A graph holding a node that syncs the host (``SkelLoss``, whose KD-tree
query runs on the host) is refused before the capture: such a model trains
per step (``Model.trainingstep``), or on the device with ``SkelLossField``.
A model on the CPU runs the chunk eagerly (there are no graphs there).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..neuromancer.optimiser import opt_leaves, tree_leaves
from ..ops.conv import f32_convs, f32_matmuls


def make_fused_trainstep(model, augmenter, batch_size, n_inner, warp=0.5,
                         flip=True, grey=True):
    """Build ``chunk(gen, hyper, out, steps=n_inner)``: ``steps`` steps of
    augment -> forward -> backward -> update of ``model`` in place, batches
    drawn from ``gen`` by ``augmenter.device_batch``, losses written into
    ``out[0, :steps]`` and errors (0 without an error node) into
    ``out[1, :steps]``. No host sync, so a CUDA graph can capture it."""
    model._check_trainable()
    inp_name = model.input_node.name
    tgt_name = model.target_node.name if model.target_node is not None \
        else None
    has_err = model.error_node is not None

    def chunk(gen, hyper, out, steps=n_inner):
        with f32_convs(), f32_matmuls():
            _steps(gen, hyper, out, steps)

    def _steps(gen, hyper, out, steps):
        for k in range(steps):
            data, tgt = augmenter.device_batch(gen, batch_size, warp=warp,
                                               grey=grey, flip=flip)
            feed = {inp_name: data}
            if tgt_name is not None:
                feed[tgt_name] = tgt
            loss, aux, _ = model._train_step(feed, gen, hyper)
            out[0, k] = loss
            if has_err:
                out[1, k] = aux[0][0]

    return chunk


class _ChunkGraph:
    """One captured chunk: the CUDA graph, the tensors it reads (held, so
    their ids stay unique while the graph lives), its key and the seconds
    its capture took."""

    def __init__(self, tensors):
        self.tensors = tensors
        self.graph = torch.cuda.CUDAGraph()
        self.key = None
        self.capture_seconds = None


class PinnedStage:
    """Host (numpy) batches to the card through reusable page-locked
    buffers, without a host sync. There are two slots of pinned host
    buffers, and one protocol: :meth:`fill` writes the slot after the last
    one filled, :meth:`copy` copies the slot last filled to the card, and
    the two alternate (fill, copy, fill, copy, ...); :meth:`stage` is one
    fill and its copy. A fill may run on another thread than its copy (the
    host-fed loop's prefetch fills slot 1 while the card still runs the
    chunk copied from slot 0). Filling a slot first waits on the event
    recorded after that slot's last copy (long done in steady state), so
    the host never overwrites bytes a copy is still reading; the copy itself
    is non-blocking (a copy from pageable memory would sync the host)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._bufs = ({}, {})
        self._events = [None, None]
        self._slot = 1                # the slot last filled

    def fill(self, arrays):
        """Write ``{name: ndarray}`` into the next slot's pinned buffers
        (made on first use, remade for a new shape or dtype); returns them."""
        slot = self._slot ^ 1
        ev = self._events[slot]
        if ev is not None:
            ev.synchronize()
        bufs = self._bufs[slot]
        for name, a in arrays.items():
            a = np.asarray(a)
            b = bufs.get(name)
            if b is None or tuple(b.shape) != a.shape or \
                    b.numpy().dtype != a.dtype:
                dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
                b = bufs[name] = torch.empty(a.shape, dtype=dtype,
                                             pin_memory=True)
            np.copyto(b.numpy(), a)
        self._slot = slot
        return {name: bufs[name] for name in arrays}

    def copy(self, names, out=None):
        """Copy the last filled slot's buffers ``names`` to the card, into
        the tensors of ``out`` where given (static buffers), else into new
        ones; records the slot's event after the copies. Returns the card
        tensors."""
        bufs = self._bufs[self._slot]
        res = {}
        for name in names:
            if out is not None:
                res[name] = out[name].copy_(bufs[name], non_blocking=True)
            else:
                res[name] = bufs[name].to(self.device, non_blocking=True)
        ev = self._events[self._slot] = torch.cuda.Event()
        ev.record()
        return res

    def stage(self, arrays):
        """:meth:`fill` the next slot with ``arrays`` and :meth:`copy` it
        to the card: ``{name: tensor on the card}``."""
        self.fill(arrays)
        return self.copy(list(arrays))


class _ChunkLoop:
    """What both fused loops share: the chunk's CUDA graph, its key, the
    capture and the replay. A subclass sets ``model``, ``n_inner``,
    ``generator``, ``_out``, ``_has_err``, ``_graph`` and
    ``capture_seconds``, and defines ``_steps(hyper, steps)`` (the chunk
    body), ``_inputs()`` (the tensors a chunk reads besides the parameters
    and slots, in the key with their versions), ``_key_head()``, and may
    add ``_owned()`` (buffers the loop itself writes between chunks, in the
    key by identity and address only)."""

    # -- the tensors a chunk reads and writes ------------------------------
    def _written(self):
        """Every tensor a chunk updates in place: the trainable parameters,
        the optimiser's slots and step counter, the aux state."""
        m = self.model
        return (tree_leaves(m._trainable(m.params)) + opt_leaves(m.opt_state)
                + tree_leaves(m.state))

    def _read(self):
        m = self.model
        return (tree_leaves(m.params) + opt_leaves(m.opt_state)
                + tree_leaves(m.state) + self._inputs())

    def _owned(self):
        return []

    def _restored(self):
        """What a capture's eager warm-up step changes and puts back: what a
        chunk writes."""
        return self._written()

    def graph_key(self):
        """The key under which the captured chunk is kept: the loop's own
        head (B, K, switches), cuDNN's deterministic and benchmark flags,
        the model's trace switches (compute dtype, ``set_train_lowering``,
        ``set_remat``), and for every parameter, optimiser slot and step
        counter and input the tensor's identity, ``_version`` and address
        (see ``DeviceTracer.graph_key``). The loop's own replays bump the
        versions and move the kept key along with them."""
        cudnn = torch.backends.cudnn
        m = self.model
        return (self._key_head(), bool(cudnn.deterministic),
                bool(cudnn.benchmark),
                (m._compute_dtype, m._train_zfold, m._train_skipsum,
                 m._remat),
                tuple((id(t), t._version, t.data_ptr())
                      for t in self._read()),
                tuple((id(t), t.data_ptr()) for t in self._owned()))

    # -- running chunks ------------------------------------------------------
    def _result(self):
        """The chunk's losses and errors as numpy, after one copy (the
        chunk's single sync)."""
        out = self._out.cpu().numpy()
        self.model._step_count += self.n_inner
        return out[0].copy(), (out[1].copy() if self._has_err else None)

    def _launch_eager(self):
        """Launch one chunk eagerly (the CPU's route; on the card the
        reference the graph is held to): same steps, same draws. Like a
        replay it writes in place only tensors the kept graph reads, so a
        key that was current moves along."""
        current = self._graph is not None and self._graph.key == \
            self.graph_key()
        hyper = self.model.optimiser.current_hyper(self.model.device)
        self._steps(hyper, self.n_inner)
        if current:
            self._graph.key = self.graph_key()

    def _launch_graphed(self):
        """Launch one chunk as a replay of its CUDA graph, captured first if
        the kept one's key is not current; then bump the versions of what
        the replay wrote. No host sync unless it captures."""
        hyper = self.model.optimiser.current_hyper(self.model.device)
        if self._graph is None or self._graph.key != self.graph_key():
            self._graph = None              # free the old graph's pool
            self._graph = self._capture(hyper)
        self._graph.graph.replay()
        for t in self._written():
            torch.autograd.graph.increment_version(t)
        self._graph.key = self.graph_key()

    def _capture(self, hyper):
        """Capture one chunk into a new ``_ChunkGraph``. One eager step on
        the capture stream first loads the libraries, makes cuDNN's and
        cuBLAS's workspaces and the loss nodes' constants on the card, so
        none of that happens inside the capture; the values it changed
        (parameters, slots, step counter, aux state, the generator's state)
        are put back before the capture, which runs nothing. A model whose
        step syncs the host is refused first."""
        m = self.model
        sync = sorted(n.name for n in m.loss_node.all_parents()
                      if getattr(n, "host_sync", False))
        if sync:
            raise NotImplementedError(
                f"nodes {sync} query the host in every step (SkelLoss), "
                "which a CUDA graph cannot hold: train with SkelLossField "
                "(the same objective on the device) or per step "
                "(Model.trainingstep)")
        m.init_state()
        dev = m.device
        written = self._restored()
        saved = [t.clone() for t in written]
        gen_state = self.generator.get_state()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._steps(hyper, 1)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(written, saved):
                t.copy_(s)
        self.generator.set_state(gen_state)
        del saved
        entry = _ChunkGraph(self._read() + self._owned())
        entry.graph.register_generator_state(self.generator)
        t0 = time.perf_counter()
        with torch.cuda.graph(entry.graph, stream=side):
            self._steps(hyper, self.n_inner)
        entry.capture_seconds = self.capture_seconds = \
            time.perf_counter() - t0
        return entry


class FusedTrainLoop(_ChunkLoop):
    """Owns the chunk function, its CUDA graph and the random stream, and
    runs the model's training K steps at a time (:meth:`run_chunk`)."""

    def __init__(self, model, augmenter, batch_size, n_inner, warp=0.5,
                 grey=True, flip=True, seed=0):
        if int(n_inner) < 1:
            raise ValueError(f"n_inner must be >= 1, got {n_inner}")
        if augmenter.device != model.device:
            raise ValueError(f"augmenter on {augmenter.device}, model on "
                             f"{model.device}: put both on one device")
        self.model = model
        self._augmenter = augmenter
        self.batch_size = int(batch_size)
        self.n_inner = int(n_inner)
        self._switches = (float(warp), bool(grey), bool(flip))
        self._chunk = make_fused_trainstep(model, augmenter, self.batch_size,
                                           self.n_inner, warp=warp,
                                           grey=grey, flip=flip)
        self.generator = torch.Generator(model.device).manual_seed(int(seed))
        self._has_err = model.error_node is not None
        self._out = torch.zeros((2, self.n_inner), device=model.device)
        self._graph = None
        self.capture_seconds = None

    def _steps(self, hyper, steps):
        self._chunk(self.generator, hyper, self._out, steps=steps)

    def _inputs(self):
        return [self._augmenter.raws, self._augmenter.labels]

    def _key_head(self):
        """B, K and the warp, grey and flip switches."""
        return (self.batch_size, self.n_inner, self._switches)

    def _run_chunk_eager(self):
        """:meth:`run_chunk` with eager launches."""
        self._launch_eager()
        return self._result()

    def run_chunk(self):
        """Run K fused steps; returns (losses (K,), errors (K,) or None) as
        numpy after the chunk's single sync. On the card: one replay of the
        chunk's CUDA graph, captured on the first call for
        :meth:`graph_key`; on the CPU the chunk runs eagerly."""
        m = self.model
        if m.device.type != "cuda":
            return self._run_chunk_eager()
        with torch.cuda.device(m.device):
            self._launch_graphed()
            return self._result()


def make_fused_hostfed_trainstep(model, n_inner, carry_specs=None):
    """Build ``chunk(feeds, gen, hyper, out, steps=n_inner, carry=None)``:
    ``steps`` steps of forward -> backward -> update of ``model`` in place,
    step k fed ``{name: feeds[name][k]}`` (each feed carries a leading (K,)
    axis of stacked host batches), losses written into ``out[0, :steps]``
    and errors (0 without an error node) into ``out[1, :steps]``. No host
    sync, so a CUDA graph can capture it. Port of the JAX package's
    ``make_fused_hostfed_trainstep``.

    ``carry_specs``: ``(aux_index, state_name)`` pairs of the fused
    truncated BPTT. Each step also feeds ``{state_name: carry}`` and the
    next step's carry is the scan's last time slice ``aux[aux_index][-1]``
    (detached: gradients stop at each step's boundary); the first step
    reads ``carry[state_name]`` and the last writes it back in place."""
    model._check_trainable()
    has_err = model.error_node is not None
    carry_specs = list(carry_specs or [])

    def chunk(feeds, gen, hyper, out, steps=n_inner, carry=None):
        rnn = dict(carry or {})
        with f32_convs(), f32_matmuls():
            for k in range(steps):
                feed = {name: v[k] for name, v in feeds.items()}
                feed.update(rnn)
                loss, aux, _ = model._train_step(feed, gen, hyper)
                out[0, k] = loss
                if has_err:
                    out[1, k] = aux[0][0]
                rnn = {name: aux[idx][-1] for idx, name in carry_specs}
            for name, v in rnn.items():
                carry[name].copy_(v)

    return chunk


class HostFedFusedLoop(_ChunkLoop):
    """``FusedTrainLoop``'s interface over a host data source: draws K
    batches from ``data.getbatch``, stacks them, and runs them as one chunk,
    on the card one replay of the chunk's CUDA graph (which reads static
    feed buffers), with one loss readback per K steps.

    On the card the K batches are written into one of two pinned slots
    (``PinnedStage``) and copied into the static feed buffers before the
    replay; with ``prefetch`` a thread draws the next chunk into the other
    slot while the graph runs. ``data.getbatch`` is not thread-safe (one
    ``np.random.RandomState``), so every draw, the prefetch thread's and
    any of the caller's (validation, preview, a chunk's tail), holds
    :attr:`data_lock`. The batches of every chunk keep one shape.

    ``carry_map``: ``{scan_node_name: state_node_name}``, the fused
    truncated BPTT of the tracing trainer. Each scan node must be among the
    model's ``debug_outputs``. The carry (:attr:`rnn_carry`, one static
    buffer per state node on the model's device) starts as the state node's
    learnable ``state0``, broadcast to the node's shape; so ``state0`` gets
    no gradient from the first step, where the per-step path trains it on
    its first batch (the JAX package's boundary note)."""

    _pool = _next = None

    def __init__(self, model, data, batch_size, n_inner, batch_args=None,
                 seed=0, prefetch=True, carry_map=None):
        if int(n_inner) < 1:
            raise ValueError(f"n_inner must be >= 1, got {n_inner}")
        self.model = model
        self.data = data
        self.batch_size = int(batch_size)
        self.n_inner = int(n_inner)
        self.batch_args = dict(batch_args or {})
        self._carry_specs, self.rnn_carry = [], {}
        if carry_map:
            aux_names = ([model.error_node.name]
                         if model.error_node is not None else [])
            aux_names += [n.name for n in model.debug_outputs]
            for scan_name, state_name in carry_map.items():
                if scan_name not in aux_names:
                    raise ValueError(
                        f"carry_map scan node {scan_name!r} must be in "
                        "model.debug_outputs")
                self._carry_specs.append((aux_names.index(scan_name),
                                          state_name))
                # made once, outside any capture
                state0 = model.params[state_name]["state0"]
                self.rnn_carry[state_name] = state0.detach().expand(
                    tuple(model.nodes[state_name].shape)).clone()
        self._chunk = make_fused_hostfed_trainstep(model, self.n_inner,
                                                   self._carry_specs)
        self._inp = model.input_node.name
        self._tgt = (model.target_node.name if model.target_node is not None
                     else None)
        self.generator = torch.Generator(model.device).manual_seed(int(seed))
        self._has_err = model.error_node is not None
        self._out = torch.zeros((2, self.n_inner), device=model.device)
        self._graph = None
        self.capture_seconds = None
        self.data_lock = threading.Lock()
        self._feeds = None           # the chunk's feeds on the model's device
        self._stage = (PinnedStage(model.device)
                       if model.device.type == "cuda" else None)
        if prefetch:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=1)

    def _draw_feeds(self):
        """K batches from ``data.getbatch``, stacked: ``{name: (K, ...)}``."""
        ds, ts = [], []
        for _ in range(self.n_inner):
            with self.data_lock:
                b = self.data.getbatch(self.batch_size, **self.batch_args)
            b = b if isinstance(b, (tuple, list)) else (b,)
            ds.append(np.asarray(b[0]))
            if self._tgt is not None:
                ts.append(np.asarray(b[1]))
        feeds = {self._inp: np.stack(ds)}
        if self._tgt is not None:
            feeds[self._tgt] = np.stack(ts)
        return feeds

    def _fill(self):
        """Draw a chunk into the stage's next pinned slot (on the card) or
        return it (on the CPU)."""
        feeds = self._draw_feeds()
        if self._stage is None:
            return {k: torch.from_numpy(v) for k, v in feeds.items()}
        return self._stage.fill(feeds)

    def _take(self):
        """This chunk's feeds: the prefetched ones, or drawn now."""
        if self._next is not None:
            feeds, self._next = self._next.result(), None
            return feeds
        return self._fill()

    def _upload(self, pinned):
        """Copy the pinned chunk into the static feed buffers (made on the
        first chunk; a batch of another shape raises)."""
        if self._feeds is None:
            self._feeds = {k: torch.empty(v.shape, dtype=v.dtype,
                                          device=self.model.device)
                           for k, v in pinned.items()}
        for k, v in pinned.items():
            if v.shape != self._feeds[k].shape or \
                    v.dtype != self._feeds[k].dtype:
                raise ValueError(
                    f"feed {k!r}: a chunk of {tuple(v.shape)} {v.dtype}, the "
                    f"first was {tuple(self._feeds[k].shape)} "
                    f"{self._feeds[k].dtype}; batches must keep one shape")
        self._stage.copy(list(pinned), out=self._feeds)

    def _steps(self, hyper, steps):
        self._chunk(self._feeds, self.generator, hyper, self._out,
                    steps=steps, carry=self.rnn_carry)

    def _inputs(self):
        return []

    def _owned(self):
        return (list(self._feeds.values()) if self._feeds else []) \
            + list(self.rnn_carry.values())

    def _restored(self):
        return self._written() + list(self.rnn_carry.values())

    def _key_head(self):
        return (self.batch_size, self.n_inner)

    def _prefetch(self):
        """Start drawing the next chunk into the other slot."""
        if self._pool is not None:
            self._next = self._pool.submit(self._fill)

    def _run_chunk_eager(self):
        """:meth:`run_chunk` with an eager launch (on the card: the feeds
        still go through the pinned slots and the static buffers)."""
        feeds = self._take()
        if self._stage is None:
            self._feeds = feeds
        else:
            self._upload(feeds)
        self._launch_eager()
        self._prefetch()
        return self._result()

    def run_chunk(self):
        """Run K fused steps on K host batches; returns (losses (K,),
        errors (K,) or None) as numpy after the chunk's single sync. On the
        card: the feed copy, then one replay of the chunk's CUDA graph
        (captured on the first call for :meth:`graph_key`), then the next
        chunk's prefetch; on the CPU the chunk runs eagerly."""
        m = self.model
        if m.device.type != "cuda":
            return self._run_chunk_eager()
        with torch.cuda.device(m.device):
            self._upload(self._take())
            self._launch_graphed()
            self._prefetch()
            return self._result()

    def settle(self):
        """Wait for the prefetch in flight, so that the caller's own draws
        from the data source (a tail of plain steps) follow the prefetched
        chunk's in order instead of racing them."""
        if self._next is not None:
            self._next.result()

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = self._next = None

    def __del__(self):
        self.close()
