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
  and step counter (updated in place by ``Optimiser.update``), the
  hyperparameters as 0-d tensors (``Optimiser.current_hyper``, refreshed
  before each replay, so a ``setlr`` between chunks takes effect with no
  recapture), the augmenter's cube stacks, and (2, K) loss/error buffers.
- Its random draws come from the loop's own ``torch.Generator``,
  registered with the graph, so every replay draws new batches: the state
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

A failed capture or replay raises; there is no eager fallback on the card.
A model on the CPU runs the chunk eagerly (there are no graphs there).
``HostFedFusedLoop`` (host-fed batches) is not ported (ROADMAP.md §1).
"""

from __future__ import annotations

import time

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


class FusedTrainLoop:
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

    # -- the tensors a chunk reads and writes ------------------------------
    def _written(self):
        """Every tensor a chunk updates in place: the trainable parameters,
        the optimiser's slots and step counter."""
        m = self.model
        return tree_leaves(m._trainable(m.params)) + opt_leaves(m.opt_state)

    def _read(self):
        m, aug = self.model, self._augmenter
        return (tree_leaves(m.params) + opt_leaves(m.opt_state)
                + [aug.raws, aug.labels])

    def graph_key(self):
        """The key under which the captured chunk is kept: B, K, the warp,
        grey and flip switches, cuDNN's deterministic and benchmark flags,
        and for every parameter, optimiser slot and step counter and the
        augmenter's cube stacks, the tensor's identity, ``_version`` and
        address (see ``DeviceTracer.graph_key``). The loop's own replays
        bump the versions and move the kept key along with them."""
        cudnn = torch.backends.cudnn
        return (self.batch_size, self.n_inner, self._switches,
                bool(cudnn.deterministic), bool(cudnn.benchmark),
                tuple((id(t), t._version, t.data_ptr())
                      for t in self._read()))

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
        self._chunk(self.generator, hyper, self._out)
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

    def _capture(self, hyper):
        """Capture one chunk into a new ``_ChunkGraph``. One eager step on
        the capture stream first loads the libraries, makes cuDNN's and
        cuBLAS's workspaces and the loss nodes' constants on the card, so
        none of that happens inside the capture; the values it changed
        (parameters, slots, step counter, the generator's state) are put
        back before the capture, which runs nothing."""
        dev = self.model.device
        written = self._written()
        saved = [t.clone() for t in written]
        gen_state = self.generator.get_state()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._chunk(self.generator, hyper, self._out, steps=1)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(written, saved):
                t.copy_(s)
        self.generator.set_state(gen_state)
        del saved
        entry = _ChunkGraph(self._read())
        entry.graph.register_generator_state(self.generator)
        t0 = time.perf_counter()
        with torch.cuda.graph(entry.graph, stream=side):
            self._chunk(self.generator, hyper, self._out)
        entry.capture_seconds = self.capture_seconds = \
            time.perf_counter() - t0
        return entry
