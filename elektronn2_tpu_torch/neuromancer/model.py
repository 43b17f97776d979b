"""Model — designated nodes, forward evaluation, dense inference, save/load.

Port of ``Model`` and ``modelload`` in ``elektronn2_tpu/neuromancer/model.py``
(reference: ``elektronn2/neuromancer/model.py``): node designation, the
forward ``_apply``, ``predict``, ``predict_dense_device``,
``set_dilated_impl``, ``set_convdense_impl``, the training half (``set_opt``,
``trainingstep``, ``loss``, ``test_error``, ``snapshot_good``,
``repair_fuckup``, ``paramstats``, ``set_train_lowering``, ``set_remat``),
the npz ``save``/``modelload`` format with the optimiser and aux state, and
the stack constructor :func:`simple_cnn`.

PyTorch idiom: parameters are a ``{node: {name: tensor}}`` dict on one
device, moved explicitly with :meth:`Model.to`; calls that get data on
another device raise instead of moving it. Evaluation is eager, with TF32
off in cuDNN and cuBLAS (``ops.conv.f32_convs``, ``ops.conv.f32_matmuls``).
A training step takes its gradients with ``torch.autograd.grad`` over the
trainable leaves (the functional counterpart of ``jax.value_and_grad``) and
runs forward, backward and update inside one pair of those contexts: the
flags are global, and a backward run after the ``with`` block would take
cuDNN's TF32 algorithms. The update writes into the parameter and slot
tensors in place (``neuromancer/optimiser.py``), and the step writes batch
norm's running statistics (``Model.state``) in place too, so a CUDA graph
of steps (``training/fused_loop.py``) replays on fixed addresses.

``predict_dense`` (host-tiled), ``sweep_knossos`` and :func:`rebuild_model`
(``modelload``'s ``override_mfp_to_active`` / ``imposed_patch_size``) serve
a trained net over whole volumes.

Not in this slice (``NotImplementedError`` naming the ROADMAP.md item):
compute dtypes other than float32 and bf16 Conv operands, ``tune_serving``,
orbax checkpoints.
"""

from __future__ import annotations

import io
import json
import math

import numpy as np
import torch

from ..log import logger
from ..ops.conv import f32_convs, f32_matmuls
from .graphmanager import GraphManager
from .node_basic import TraceCtx
from .optimiser import Optimiser, get_optimiser, opt_leaves, tree_leaves


class Model:
    """A view over a node graph with its parameters.

    Usage (mirrors the reference):
        model = model_manager.getmodel()
        model.designate_nodes(input_node=inp, prediction_node=pred, ...)
        model.to("cuda")                  # modelload puts it there itself
        model.set_opt("Adam", lr=1e-3)
        loss, aux = model.trainingstep(data, target)   # tensors on the card
        probs = model.predict(raw)
        dense = model.predict_dense_device(vol, pad_raw=True)
        maps = model.sweep_knossos(KnossosArray(path))
    """

    def __init__(self, graph_manager, name="model"):
        self.gm = graph_manager
        self.name = name
        self.nodes = graph_manager.nodes
        self.input_node = None
        self.target_node = None
        self.loss_node = None
        self.prediction_node = None
        self.prediction_ext_node = None
        self.error_node = None
        self.debug_outputs = []
        self.extra_inputs = []
        self.params = {n.name: {k: v.clone() for k, v in n.params.items()}
                       for n in self.nodes.values() if n.params}
        self.state = {}          # aux state: {node: {"mean", "var"}} of BN
        self.optimiser = None
        self.opt_state = None
        self._lr_mults = self._wd_mults = None
        self._step_count = 0
        self._seed = 0
        self._gen = None                      # made on first use, see seed
        self._compute_dtype = None
        self._dilated_impl = "direct"
        self._dilated_ptail = False
        self._convdense_upconv = "dilate"
        self._convdense_zfold = False
        self._convdense_ptail = False
        self._convdense_poolslice = False
        self._convdense_skipsum = False
        self._train_zfold = False
        self._train_skipsum = False
        self._remat = False

    # ------------------------------------------------------------ designation
    def designate_nodes(self, input_node=None, target_node=None,
                        loss_node=None, prediction_node=None,
                        prediction_ext_node=None, error_node=None,
                        debug_outputs=None, extra_inputs=None):
        self.input_node = input_node
        self.target_node = target_node
        self.loss_node = loss_node
        self.prediction_node = prediction_node
        self.prediction_ext_node = prediction_ext_node
        self.error_node = error_node
        self.debug_outputs = debug_outputs or []
        self.extra_inputs = extra_inputs or []
        self.gm.designations = {
            k: (v.name if v is not None else None) for k, v in [
                ("input_node", input_node), ("target_node", target_node),
                ("loss_node", loss_node), ("prediction_node", prediction_node),
                ("prediction_ext_node", prediction_ext_node),
                ("error_node", error_node)]}
        self.gm.designations["debug_outputs"] = [n.name for n in
                                                 self.debug_outputs]
        self.gm.designations["extra_inputs"] = [n.name for n in
                                                self.extra_inputs]
        return self

    # ------------------------------------------------------------- device
    @property
    def device(self):
        """Device of the parameters (CPU for a model without any)."""
        for d in self.params.values():
            for v in d.values():
                return v.device
        return torch.device("cpu")

    def to(self, device):
        """Move every parameter, the aux state and the optimiser state to
        ``device``; returns the model."""
        self.params = {n: {k: v.to(device) for k, v in d.items()}
                       for n, d in self.params.items()}
        self.state = {n: {k: v.to(device) for k, v in d.items()}
                      for n, d in self.state.items()}
        if self.opt_state is not None:
            self.opt_state = {
                "step": self.opt_state["step"].to(device),
                "slots": tuple({n: {k: v.to(device) for k, v in d.items()}
                                for n, d in s.items()}
                               for s in self.opt_state["slots"])}
        return self

    def _check_device(self, t, what):
        if t.device != self.device:
            raise ValueError(
                f"{what} is on {t.device} but the model's parameters are on "
                f"{self.device}; move one explicitly (tensor.to / model.to)")

    # --------------------------------------------------------------- plumbing
    def set_dilated_impl(self, impl="direct", zfold=False, ztap=False,
                         zmajor=False, poolslice=False, pallas_tail=False):
        """Choose the lowering of the dilated dense path
        (``neuromancer/inference.py::dilated_dense_forward``).

        ``impl='direct'``: each conv runs dilated by the cumulative pool
        stride and each pool as a stride-1 dilated max window.
        ``pallas_tail=True``: every (3,3,3) ReLU conv without pooling runs
        through the hand-written CUDA kernel ``ops.tailconv.conv3x3_dilated``
        (K1; bias and ReLU fused) instead of cuDNN. Equal up to float
        reassociation.
        ``zfold`` is accepted and changes nothing: in the JAX package it
        rewrites kz=1 convs as 2D convs with z folded into the batch, an
        exact rewrite that XLA on the TPU needed; whether folding pays on
        cuDNN is a later measurement.

        The other lowerings of the JAX package are not ported:
        ``impl='s2b'``/``'s2bg'``, ``ztap``, ``zmajor``, ``poolslice``, and
        ``pallas_tail`` as a dict of TPU kernel knobs.
        """
        if impl not in ("direct", "s2b", "s2bg"):
            raise ValueError(f"impl={impl!r}: expected 'direct', 's2b' "
                             "or 's2bg'")
        left_out = {"impl": impl != "direct", "ztap": bool(ztap),
                    "zmajor": bool(zmajor), "poolslice": bool(poolslice),
                    "pallas_tail knobs": isinstance(pallas_tail, dict)}
        bad = [k for k, v in left_out.items() if v]
        if bad:
            raise NotImplementedError(
                f"set_dilated_impl: {', '.join(bad)} not ported to "
                "elektronn2_tpu_torch (XLA/TPU lowerings; ROADMAP.md §1 "
                "item 7)")
        self._dilated_impl = impl
        self._dilated_ptail = bool(pallas_tail)
        return self

    def set_convdense_impl(self, upconv="dilate", zfold=False, ptail=False,
                           poolslice=False, skipsum=False):
        """Choose the lowerings of the convolutional dense path (decoder /
        U-Net graphs, ``neuromancer/inference.py::
        convolutional_dense_forward``); each computes the same function.

        ``upconv``: 'dilate' (``ops.conv.upconv``, a transposed conv) or
        'd2s' (1x1 conv + depth-to-space, ``ops.conv.upconv_d2s``).
        ``zfold``: kz=1 3D convs as 2D convs with z folded into the batch
        (``ops.conv.conv_zfold2d``); 3D graphs only.
        ``ptail``: every (3,3,3) ReLU Conv without MFP, pooled ones included,
        runs through the CUDA kernel ``ops.tailconv.conv3x3_dilated`` (K1;
        bias and ReLU fused, the max pool after it).
        ``poolslice``: non-overlapping pools as maxima of strided slices
        (``ops.conv.pooling_slices``).
        ``skipsum``: a Conv fed by a FaithlessMerge sums the convs of the
        merge's two pieces instead of building their concat (unless K1 takes
        that Conv).

        The knobs touch the conv-dense path only; ``predict`` and the
        dilated path keep their lowerings. ``ptail`` as a dict of TPU kernel
        knobs is not ported.
        """
        if upconv not in ("dilate", "d2s"):
            raise ValueError(f"upconv={upconv!r}: expected 'dilate' "
                             "or 'd2s'")
        if isinstance(ptail, dict):
            raise NotImplementedError(
                "set_convdense_impl: ptail knobs not ported to "
                "elektronn2_tpu_torch (TPU kernel variants; ROADMAP.md §1 "
                "item 7)")
        self._convdense_upconv = upconv
        self._convdense_zfold = bool(zfold)
        self._convdense_ptail = bool(ptail)
        self._convdense_poolslice = bool(poolslice)
        self._convdense_skipsum = bool(skipsum)
        return self

    def set_train_lowering(self, zfold=False, skipsum=False):
        """Lowerings of the node trace (training and ``predict``), each the
        same function: ``zfold`` runs kz=1 3D convs as 2D convs with z folded
        into the batch (``ops.conv.conv_zfold2d``); ``skipsum`` lets a Conv
        fed by a FaithlessMerge sum the convs of the merge's two pieces
        instead of building their concat (it steps aside under
        :meth:`set_remat` and for a batch-normed Conv). The training-side
        siblings of :meth:`set_convdense_impl`. Reference:
        ``Model.set_train_lowering``."""
        self._train_zfold = bool(zfold)
        self._train_skipsum = bool(skipsum)
        return self

    def set_remat(self, enabled=True):
        """Rematerialisation: each parameterised node's activations are
        recomputed in the backward pass instead of kept
        (``torch.utils.checkpoint``, non-reentrant), trading operations for
        device memory. Random draws are made once and reused by the
        recomputation (``TraceCtx.draw``). Reference: ``Model.set_remat``."""
        self._remat = bool(enabled)
        return self

    def set_compute_dtype(self, dtype, activations=False):
        """Mixed precision for training and patch prediction: with
        ``'bfloat16'`` every Conv runs its operands in bf16 with float32
        accumulation, bias and epilogue in float32; None or ``'float32'``
        restores full float32. As in the JAX package's mode, for graphs
        whose weighted nodes are all Convs. The dense serving paths, and
        the other dtypes and ``activations=True``, are not ported (ROADMAP.md
        item 7) and raise."""
        if dtype in (None, "float32"):
            self._compute_dtype = None
            return self
        if dtype != "bfloat16" or activations:
            raise NotImplementedError(
                f"set_compute_dtype({dtype!r}, activations={activations}): "
                "only 'bfloat16' operands in training are ported (ROADMAP.md "
                "item 7)")
        from .neural import Conv
        other = sorted(n.name for n in self.nodes.values()
                       if n.params and not isinstance(n, Conv))
        if other:
            raise NotImplementedError(
                f"set_compute_dtype('bfloat16'): nodes {other} are not Convs; "
                "their bf16 mode is not ported (ROADMAP.md item 7)")
        self._compute_dtype = torch.bfloat16
        return self

    def _check_f32_serving(self):
        if self._compute_dtype is not None:
            raise NotImplementedError(
                "dense serving in bf16 is not ported (ROADMAP.md item 7): "
                "call set_compute_dtype(None) first")

    def _apply(self, out_nodes, params, state, feed, rng, train, noise=None,
               draws=None):
        """Evaluate ``out_nodes`` eagerly; returns (outputs, state). With
        ``train`` autograd records (the caller takes the gradients inside
        its own ``f32_convs``/``f32_matmuls``), else ``torch.no_grad()``.
        ``noise``: random draws to use, by node name (``TraceCtx.draw``);
        ``draws``: a dict that receives the draws the evaluation used."""
        ctx = TraceCtx(params, feed, rng=rng, train=train, state_in=state,
                       noise_in=noise)
        ctx.compute_dtype = self._compute_dtype
        ctx.remat = self._remat and train
        ctx.convdense_zfold = self._train_zfold
        ctx.convdense_skipsum = self._train_skipsum
        with torch.set_grad_enabled(train), f32_convs(), f32_matmuls():
            outs = [ctx.get(n) for n in out_nodes]
        if draws is not None:
            draws.update(ctx.noise_out)
        new_state = dict(state)
        new_state.update(ctx.state_out)
        return outs, new_state

    def _feed(self, data, target=None, extra=None, overrides=None):
        if isinstance(data, dict):
            known = {self.input_node.name} | {n.name for n in self.extra_inputs}
            if self.target_node is not None:
                known.add(self.target_node.name)
            unknown = set(data) - known
            if unknown:
                raise KeyError(
                    f"unknown feed name(s) {sorted(unknown)}; this model's "
                    f"input names are {sorted(known)}")
            feed = dict(data)
        else:
            feed = {self.input_node.name: data}
        if target is not None and self.target_node is not None:
            feed[self.target_node.name] = target
        for node, val in zip(self.extra_inputs, extra or []):
            feed[node.name] = val
        if overrides:
            feed.update(overrides)
        for k, v in feed.items():
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(v)
            if not isinstance(v, torch.Tensor):
                raise TypeError(f"feed {k!r}: expected a tensor or ndarray, "
                                f"got {type(v).__name__}")
            self._check_device(v, f"feed {k!r}")
            feed[k] = v
        return feed

    def seed(self, n):
        """Reset the model's random stream (a ``torch.Generator`` on the
        model's device, handed to every training step)."""
        self._seed = int(n)
        self._gen = torch.Generator(self.device).manual_seed(self._seed)
        return self

    def _next_rng(self):
        """The step's generator: one stream that advances with its draws
        (a moved model starts it anew from the last :meth:`seed`)."""
        if self._gen is None or self._gen.device != self.device:
            self.seed(self._seed)
        return self._gen

    # --------------------------------------------------------------- training
    def set_opt(self, optimiser="Adam", **hyperparams):
        """Attach an optimiser (name or instance) and make its state (zero
        slots, step 0) on the parameters' device. Reference: Model/Trainer
        optimiser setup."""
        if isinstance(optimiser, Optimiser):
            self.optimiser = optimiser
        else:
            self.optimiser = get_optimiser(optimiser)(**hyperparams)
        self.opt_state = self.optimiser.init_state(self._trainable(self.params))
        self._lr_mults = self._mult_tree("lr_mult")
        self._wd_mults = self._mult_tree("wd_mult")
        return self.optimiser

    def _trainable(self, params):
        out = {}
        for nname, pdict in params.items():
            node = self.nodes[nname]
            sub = {p: v for p, v in pdict.items()
                   if node.param_flags[p]["trainable"]}
            if sub:
                out[nname] = sub
        return out

    def _mult_tree(self, key):
        out = {}
        for nname, pdict in self._trainable(self.params).items():
            node = self.nodes[nname]
            out[nname] = {p: node.param_flags[p][key] for p in pdict}
        return out

    def _aux_nodes(self):
        return ([self.error_node] if self.error_node is not None else []) \
            + list(self.debug_outputs)

    def _check_trainable(self):
        if self.loss_node is None:
            raise RuntimeError("designate a loss_node before training")
        if self.optimiser is None:
            self.set_opt("Adam")

    def _loss_and_grads(self, feed, rng, noise=None, draws=None):
        """Forward in training mode and the gradients of the loss with
        respect to every trainable parameter: (loss, aux outputs, grads
        tree, new aux state), all on the device, no host sync. Forward and
        backward run inside one ``f32_convs``/``f32_matmuls``. ``noise``
        feeds random draws by node name and ``draws`` receives the ones
        used (:meth:`_apply`)."""
        leaves = {n: {p: v.detach().requires_grad_() for p, v in d.items()}
                  for n, d in self._trainable(self.params).items()}
        merged = {n: {**d, **leaves.get(n, {})}
                  for n, d in self.params.items()}
        names = [(n, p) for n in sorted(leaves) for p in sorted(leaves[n])]
        with f32_convs(), f32_matmuls():
            outs, new_state = self._apply([self.loss_node] + self._aux_nodes(),
                                          merged, self.state, feed, rng,
                                          train=True, noise=noise,
                                          draws=draws)
            loss = outs[0][0]
            gs = torch.autograd.grad(loss, [leaves[n][p] for n, p in names],
                                     allow_unused=True)
        grads = {}
        for (n, p), g in zip(names, gs):     # an unused leaf: zero gradient
            grads.setdefault(n, {})[p] = (torch.zeros_like(leaves[n][p])
                                          if g is None else g)
        return (loss.detach(), [o.detach() for o in outs[1:]], grads,
                new_state)

    def _train_step(self, feed, rng, hyper, noise=None):
        """One step in place: forward, backward, the optimiser's update of
        the parameter and slot tensors, and the aux state's new values
        copied into its tensors. ``hyper`` is the optimiser's
        ``current_hyper`` dict (read, never written, so a CUDA graph of this
        step reads the live values); ``noise`` feeds random draws
        (:meth:`_apply`). Returns (loss, aux outputs, gradient norm) as
        device tensors; no host sync."""
        self.init_state()
        with f32_convs(), f32_matmuls():
            loss, aux, grads, new_state = self._loss_and_grads(feed, rng,
                                                               noise)
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                                   for g in tree_leaves(grads)))
            self.optimiser.update(self._trainable(self.params), grads,
                                  self.opt_state, hyper, self._lr_mults,
                                  self._wd_mults)
        with torch.no_grad():
            for n, d in self.state.items():
                for k, v in d.items():
                    v.copy_(new_state[n][k])
        return loss, aux, gnorm

    def init_state(self):
        """Make the aux state a training step writes, where a node has none
        yet: batch norm's running statistics start at zeros (mean) and ones
        (variance), as in the JAX package. A training step (and a fused
        loop, before it captures one) calls this; until then an evaluation
        of a batch-normed node without running statistics normalises by the
        batch's own. The tensors are made once and then updated in place."""
        for name, node in self.nodes.items():
            if (name not in self.state and getattr(node, "_bn_nf", None)
                    is not None):
                self.state[name] = node._fresh_bn_state(self.device)

    def trainingstep(self, data, target=None, extra=None,
                     feed_overrides=None):
        """One forward + backward + update step. Returns (loss, aux_dict),
        device tensors (the caller syncs when it reads them).

        aux_dict holds 'gradnorm', 'error' (if an error node is designated)
        and the debug outputs by node name. ``feed_overrides`` injects values
        for non-input nodes that accept feeding (e.g. InitialState_like).
        The feed must lie on the model's device. Reference:
        ``Model.trainingstep``.
        """
        self._check_trainable()
        feed = self._feed(data, target, extra, feed_overrides)
        hyper = self.optimiser.current_hyper(self.device)
        loss, aux, gnorm = self._train_step(feed, self._next_rng(), hyper)
        self._step_count += 1
        aux_dict = {"gradnorm": gnorm}
        i = 0
        if self.error_node is not None:
            aux_dict["error"] = aux[0][0]
            i = 1
        for node, v in zip(self.debug_outputs, aux[i:]):
            aux_dict[node.name] = v
        return loss, aux_dict

    def loss(self, data, target=None, extra=None):
        """The scalar loss without updating (eval mode)."""
        outs, _ = self._apply([self.loss_node], self.params, self.state,
                              self._feed(data, target, extra), None,
                              train=False)
        return outs[0][0]

    def test_error(self, data, target, extra=None):
        """(loss, error rate or None) in eval mode (validation)."""
        nodes = [self.loss_node]
        if self.error_node is not None:
            nodes.append(self.error_node)
        outs, _ = self._apply(nodes, self.params, self.state,
                              self._feed(data, target, extra), None,
                              train=False)
        return (outs[0][0], outs[1][0]) if len(outs) > 1 \
            else (outs[0][0], None)

    # ------------------------------------------------------- blowup recovery
    def snapshot_good(self):
        """Record the current params / optimiser state / aux state as
        known-good: copies on the device, no host transfer.
        :meth:`repair_fuckup` copies them back in place."""
        self._good = (_tree_clone(self.params), _tree_clone(self.opt_state),
                      _tree_clone(self.state))

    def repair_fuckup(self, lr_scale=None):
        """Roll back to the last :meth:`snapshot_good` after a training
        blowup (non-finite loss / exploded params): params, optimiser slots
        and step counter, aux state. The values are copied into the live
        tensors, which keep their addresses. ``lr_scale`` multiplies the
        live learning rate. Returns True if a snapshot existed.
        Reference: ``optimiser.py::repair_fuckup``."""
        good = getattr(self, "_good", None)
        if good is None:
            return False
        p, o, s = good
        _tree_copy_(self.params, p)
        if o is not None and self.opt_state is not None:
            self.opt_state["step"].copy_(o["step"])
            for live, kept in zip(self.opt_state["slots"], o["slots"]):
                _tree_copy_(live, kept)
        for n in list(self.state):       # made after the snapshot
            if n not in s:
                del self.state[n]
        for n, d in s.items():
            if n in self.state:
                _tree_copy_({n: self.state[n]}, {n: d})
            else:
                self.state[n] = _tree_clone(d)
        if lr_scale is not None and self.optimiser is not None:
            self.optimiser.setlr(float(self.optimiser.hyperparams["lr"])
                                 * float(lr_scale))
        return True

    def paramstats(self):
        """Per-node parameter mean/std/min/max (reference:
        Model.paramstats)."""
        stats = {}
        for nname, pdict in self.params.items():
            for pname, v in pdict.items():
                a = v.detach().cpu().numpy()
                stats[f"{nname}/{pname}"] = {
                    "shape": tuple(a.shape),
                    "mean": float(a.mean()), "std": float(a.std()),
                    "min": float(a.min()), "max": float(a.max())}
        return stats

    # -------------------------------------------------------------- inference
    def predict(self, raw, extra=None):
        """Forward pass to the prediction node (eval mode, no stitching)."""
        outs, _ = self._apply([self.prediction_node], self.params, self.state,
                              self._feed(raw, extra=extra), None, train=False)
        return outs[0]

    def predict_dense(self, raw_img, pad_raw=False, as_uint8=False,
                      tile_batch=1, verbose=False, prefer_device=True,
                      device_budget=4 << 30):
        """Dense prediction over a host volume (numpy in, numpy out):
        volumes that fit ``device_budget`` go whole through
        :meth:`predict_dense_device`, larger ones (and all with
        ``prefer_device=False``) through the overlap-tiled sweep
        (``neuromancer/inference.py::predict_dense``)."""
        from .inference import predict_dense
        self._check_f32_serving()
        return predict_dense(self, raw_img, pad_raw=pad_raw,
                             as_uint8=as_uint8, tile_batch=tile_batch,
                             verbose=verbose, prefer_device=prefer_device,
                             device_budget=device_budget)

    def predict_dense_device(self, vol, pad_raw=False, tile_batch=1):
        """Dense sweep of a device-resident volume: (f, Z, X, Y) float32
        tensor on the model's device in, dense map (f_out, Z', X', Y') out
        (with ``pad_raw``, the volume's own spatial shape)."""
        from .inference import predict_dense_device
        self._check_f32_serving()
        return predict_dense_device(self, vol, pad_raw=pad_raw,
                                    tile_batch=tile_batch)

    def sweep_knossos(self, karr, region=None, step=None, out=None,
                      verbose=False, mesh=None, slab_batch=1, timings=None):
        """Dense-predict a whole KNOSSOS dataset slab by staged slab, one or
        ``slab_batch`` slabs per forward, each read back while the next
        computes (``neuromancer/inference.py::sweep_knossos``)."""
        from .inference import sweep_knossos
        self._check_f32_serving()
        return sweep_knossos(self, karr, region=region, step=step, out=out,
                             verbose=verbose, mesh=mesh,
                             slab_batch=slab_batch, timings=timings)

    # ------------------------------------------------------------------ stats
    @property
    def param_count(self):
        return sum(math.prod(v.shape)
                   for nd in self.params.values() for v in nd.values())

    # ---------------------------------------------------------------- save/load
    def save(self, fname, backend="npz"):
        """Serialise spec + params (+ optimiser state) as the JAX package's
        ``Model.save`` does (``backend='npz'``): one ``.npz`` with the JSON
        node spec (``__spec__``), its arg arrays, ``param/<node>/<name>``,
        the aux state ``state/<node>/<key>`` (batch norm's running
        statistics), and with an optimiser ``__opt__`` (class, hyperparams,
        nesterov, step count) and its state's leaves ``opt/<i>`` in
        ``jax.tree_util`` order, so either package resumes the other's
        training."""
        if backend != "npz":
            raise NotImplementedError(
                f"backend={backend!r}: only 'npz' is ported (orbax is a JAX "
                "checkpoint format)")
        spec_json, arg_arrays = self.gm.spec_json()
        payload = {"__spec__": np.frombuffer(spec_json.encode(), np.uint8)}
        payload.update(arg_arrays)
        for nname, pdict in self.params.items():
            for pname, v in pdict.items():
                payload[f"param/{nname}/{pname}"] = v.detach().cpu().numpy()
        for nname, st in self.state.items():
            for k, v in st.items():
                payload[f"state/{nname}/{k}"] = v.detach().cpu().numpy()
        if self.optimiser is not None:
            payload["__opt__"] = np.frombuffer(
                json.dumps(self._opt_meta()).encode(), np.uint8)
            for i, v in enumerate(opt_leaves(self.opt_state)):
                payload[f"opt/{i}"] = v.detach().cpu().numpy()
        buf = io.BytesIO()
        np.savez_compressed(buf, **payload)
        with open(fname, "wb") as f:
            f.write(buf.getvalue())
        logger.info(f"saved model to {fname} ({self.param_count} params)")

    def _opt_meta(self):
        return {"cls": type(self.optimiser).__name__,
                "hyper": self.optimiser.hyperparams,
                "nesterov": bool(getattr(self.optimiser, "nesterov", False)),
                "step_count": self._step_count}

    def _load_opt(self, meta, leaves):
        """Restore an optimiser from a model file's ``__opt__`` and
        ``opt/<i>`` leaves (``{i: array}``, in :func:`opt_leaves` order)."""
        self.set_opt(meta["cls"], **meta["hyper"])
        if meta.get("nesterov"):
            self.optimiser.nesterov = True
        self._step_count = meta.get("step_count", 0)
        with torch.no_grad():
            for i, t in enumerate(opt_leaves(self.opt_state)):
                if i in leaves:
                    t.copy_(torch.as_tensor(leaves[i], dtype=t.dtype))

    def set_params(self, params):
        """Replace the parameters; ``params`` is ``{node: {name: array}}``
        (tensors or ndarrays), converted to contiguous float32 tensors on
        the model's current device (the hand kernels take no strided view).
        Shapes must match the graph's."""
        dev = self.device
        new = {}
        for nname, d in params.items():
            new[nname] = {}
            for pname, v in d.items():
                t = torch.as_tensor(np.asarray(v, dtype=np.float32)
                                    if not isinstance(v, torch.Tensor) else v,
                                    dtype=torch.float32,
                                    device=dev).contiguous()
                want = tuple(self.nodes[nname].params[pname].shape)
                if tuple(t.shape) != want:
                    raise ValueError(f"param {nname}/{pname}: shape "
                                     f"{tuple(t.shape)} != graph's {want}")
                new[nname][pname] = t
        self.params = new

    def __repr__(self):
        return (f"<Model {self.name!r}: {len(self.nodes)} nodes, "
                f"{self.param_count} params>")


def target_device(device):
    """``torch.device(device)`` for an entry point's ``device`` argument.
    A CUDA device without a card raises: the entry points run on the card
    unless the caller asks for the CPU, and never fall back to it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is false): the port's "
            "entry points run on the card by default; pass device='cpu' to "
            "run on the CPU")
    return dev


def modelload(fname, override_mfp_to_active=False, imposed_patch_size=None,
              device="cuda", **kwargs):
    """Load a model file (the npz format of ``Model.save``, written by this
    package or by the JAX package) by replaying its node spec; the
    parameters land on ``device`` (see :func:`target_device`).

    The aux state (``state/…``) and the optimiser and its state
    (``__opt__``, ``opt/…``), where the file has them, are restored on
    ``device`` too. ``override_mfp_to_active`` /
    ``imposed_patch_size`` rebuild the graph after loading
    (:func:`rebuild_model`). Orbax checkpoint directories are not ported.
    """
    device = target_device(device)
    with np.load(fname, allow_pickle=False) as z:
        spec = json.loads(bytes(z["__spec__"].tobytes()).decode())
        arg_arrays = {k: z[k] for k in z.files if k.startswith("__spec__/")}
        params, state, opt_leaves_ = {}, {}, {}
        for k in z.files:
            if k.startswith("param/"):
                _, nname, pname = k.split("/", 2)
                params.setdefault(nname, {})[pname] = z[k]
            elif k.startswith("state/"):
                _, nname, sname = k.split("/", 2)
                state.setdefault(nname, {})[sname] = torch.from_numpy(
                    np.array(z[k], dtype=np.float32))
            elif k.startswith("opt/"):
                opt_leaves_[int(k.split("/")[1])] = z[k]
        opt_meta = (json.loads(bytes(z["__opt__"].tobytes()).decode())
                    if "__opt__" in z.files else None)
    model = _designated(GraphManager.replay(spec["nodes"], arg_arrays),
                        spec.get("designations", {}),
                        spec.get("graph", "model"))
    model.set_params(params)
    model.state = state
    model.to(device)
    if opt_meta is not None:
        model._load_opt(opt_meta, opt_leaves_)
    if override_mfp_to_active or imposed_patch_size is not None:
        model = rebuild_model(model,
                              override_mfp_to_active=override_mfp_to_active,
                              imposed_patch_size=imposed_patch_size)
    logger.info(f"loaded model from {fname}: {model!r}")
    return model


def _designated(gm, designations, name):
    """A new Model over ``gm`` with ``designations`` (node names)."""
    model = Model(gm, name=name)

    def pick(key):
        n = designations.get(key)
        return gm.nodes[n] if n else None

    return model.designate_nodes(
        input_node=pick("input_node"), target_node=pick("target_node"),
        loss_node=pick("loss_node"), prediction_node=pick("prediction_node"),
        prediction_ext_node=pick("prediction_ext_node"),
        error_node=pick("error_node"),
        debug_outputs=[gm.nodes[n] for n in
                       designations.get("debug_outputs", [])],
        extra_inputs=[gm.nodes[n] for n in
                      designations.get("extra_inputs", [])])


def rebuild_model(model, override_mfp_to_active=False,
                  imposed_patch_size=None):
    """Rebuild a model's graph from its own spec, e.g. with another patch
    size for the designated input or with MFP switched on in every Conv
    and Pool for dense inference; the target input is resized to the new
    prediction geometry.

    Port of ``model.py::rebuild_model`` (reference: ``elektronn2``'s).
    Parameters, aux state and the optimiser state are copied (clones, on
    the model's device) wherever their shapes still match, and the serving
    lowerings (``set_dilated_impl``, ``set_convdense_impl``) carry over.
    """
    def _input_fields(d):
        """(shape list, tag list) of an Input descriptor; writes the shape
        back as a plain list so edits to it reach the replay."""
        args = d["args"]
        shape = args[0] if args else d["kwargs"]["shape"]
        tags = args[1] if len(args) > 1 else d["kwargs"]["tags"]
        if isinstance(shape, dict) and "__tuple__" in shape:
            shape = list(shape["__tuple__"])
            if args:
                args[0] = shape
            else:
                d["kwargs"]["shape"] = shape
        if isinstance(tags, dict) and "__tuple__" in tags:
            tags = list(tags["__tuple__"])
        if isinstance(tags, str):
            tags = tags.split(",") if "," in tags else list(tags)
        return shape, tags

    def _set_spatial(d, sizes):
        shape, tags = _input_fields(d)
        sp_idx = [i for i, t in enumerate(tags) if t in ("z", "x", "y")]
        for i, ax in enumerate(sp_idx):
            shape[ax] = int(sizes[i])

    dd_old = model.gm.designations
    in_name = dd_old.get("input_node")
    tgt_name = dd_old.get("target_node")
    changed = imposed_patch_size is not None or override_mfp_to_active
    descriptors, arrays = model.gm.get_descriptors()
    for d in descriptors:
        # the patch applies to the designated data input only; the target
        # input is the network's output size, resized below
        if (d["cls"] == "Input" and imposed_patch_size is not None
                and d["name"] == in_name):
            _set_spatial(d, imposed_patch_size)
        if override_mfp_to_active and d["cls"] in ("Conv", "Pool"):
            d["kwargs"]["mfp"] = True
    new = _designated(GraphManager.replay(descriptors, arrays), dd_old,
                      model.name)
    if tgt_name is not None and new.prediction_node is not None and changed:
        pred_ts = new.prediction_node.shape
        tgt_node = new.nodes.get(tgt_name)
        if tgt_node is not None and (tuple(tgt_node.shape.spatial_shape)
                                     != tuple(pred_ts.spatial_shape)
                                     or tgt_node.shape["b"]
                                     != pred_ts["b"]):
            for d in descriptors:
                if d["name"] == tgt_name:
                    _set_spatial(d, pred_ts.spatial_shape)
                    shape, tags = _input_fields(d)
                    if "b" in tags:
                        shape[tags.index("b")] = int(pred_ts["b"])
            new = _designated(GraphManager.replay(descriptors, arrays),
                              dd_old, model.name)
    for nname, pdict in model.params.items():
        for pname, v in pdict.items():
            if tuple(new.params.get(nname, {}).get(
                    pname, torch.empty(0)).shape) == tuple(v.shape):
                new.params[nname][pname] = v.detach().clone()
    new.to(model.device)
    new.state = _tree_clone(model.state)
    if model.optimiser is not None:
        meta = model._opt_meta()
        new.set_opt(meta["cls"], **meta["hyper"])
        if meta.get("nesterov"):
            new.optimiser.nesterov = True
        new._step_count = model._step_count
        old_l, new_l = opt_leaves(model.opt_state), opt_leaves(new.opt_state)
        if len(old_l) == len(new_l):
            with torch.no_grad():
                for o, n in zip(old_l, new_l):
                    if o.shape == n.shape:
                        n.copy_(o)
    new._seed = model._seed
    for knob in ("_dilated_impl", "_dilated_ptail", "_convdense_upconv",
                 "_convdense_zfold", "_convdense_ptail",
                 "_convdense_poolslice", "_convdense_skipsum",
                 "_train_zfold", "_train_skipsum", "_remat"):
        setattr(new, knob, getattr(model, knob))
    return new


def _tree_clone(tree):
    """Copy of a nested dict/tuple of tensors, on the same devices."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    return tuple(_tree_clone(v) for v in tree)


@torch.no_grad()
def _tree_copy_(dst, src):
    """Copy ``src``'s values into ``dst``'s tensors (``{node: {name:
    tensor}}``), which keep their addresses."""
    for n, d in dst.items():
        for k, v in d.items():
            v.copy_(src[n][k])


def simple_cnn(batch_size, n_ch, n_lab, desired_input, filters, pools,
               nof_filters, activation_func="relu", mfp=False, ndim=3,
               target="nll", dropout_rates=None, batch_normalisation=False):
    """A designated Model of a plain conv stack: Convs ``conv<i>`` (with
    ``dropout_rates`` and ``batch_normalisation``), a 1x1 ``class`` conv to
    ``n_lab`` outputs and, for ``target='nll'``, Softmax ``probs``, a sparse
    ``MultinoulliNLL``, ``AggregateLoss`` ``loss`` and ``Errors``; for
    ``'regression'``/``'affinity'`` a ``SquaredLoss`` of the (softmaxed)
    output. The patch is the valid size nearest ``desired_input``
    (``cnncalculator``). Built on the current graph manager, which is reset;
    the parameters are on the CPU. Reference: ``model.py::simple_cnn``."""
    from ..utils.cnncalculator import cnncalculator
    from . import graphmanager, loss as loss_mod, neural
    from . import node_basic as nb

    dropout_rates = dropout_rates or [0.0] * len(filters)
    for what, seq in (("pools", pools), ("nof_filters", nof_filters),
                      ("dropout_rates", dropout_rates)):
        if len(seq) != len(filters):
            raise ValueError(
                f"simple_cnn: {what} has {len(seq)} entries but filters "
                f"has {len(filters)}: per-layer lists must align")
    calc = cnncalculator(filters, pools, desired_input, mfp=mfp, ndim=ndim)
    patch = calc.input if ndim > 1 else [calc.input]
    tags = ["b", "f"] + list("zxy"[:ndim] if ndim == 3 else "xy"[:ndim])
    gm = graphmanager.current_manager()
    gm.reset()
    inp = nb.Input([batch_size, n_ch] + list(patch), tags, name="raw")
    x = inp
    for i, (f, p, nf, dr) in enumerate(
            zip(filters, pools, nof_filters, dropout_rates)):
        x = neural.Conv(x, nf, f, p, activation_func=activation_func,
                        mfp=mfp, dropout_rate=dr,
                        batch_normalisation=batch_normalisation,
                        name=f"conv{i}")
    out = neural.Conv(x, n_lab, 1, 1, activation_func="lin", name="class")
    tgt_sp = list(out.shape.spatial_shape)
    if target == "nll":
        pred = loss_mod.Softmax(out, name="probs")
        tgt = nb.Input([pred.shape["b"]] + tgt_sp, ["b"] + tags[2:],
                       dtype="int32", name="target")
        nll = loss_mod.MultinoulliNLL(pred, tgt, target_is_sparse=True,
                                      name="nll")
        agg = loss_mod.AggregateLoss(nll, name="loss")
        err = loss_mod.Errors(pred, tgt, target_is_sparse=True)
    elif target in ("regression", "affinity"):
        pred = (loss_mod.Softmax(out, name="probs") if target == "affinity"
                else out)
        tgt = nb.Input([out.shape["b"], n_lab] + tgt_sp, tags,
                       name="target")
        agg = loss_mod.AggregateLoss(
            loss_mod.SquaredLoss(pred, tgt, name="sq"), name="loss")
        err = None
    else:
        raise ValueError(f"unknown simple_cnn target {target!r}; "
                         "use 'nll', 'regression' or 'affinity'")
    model = gm.getmodel("simple_cnn")
    model.designate_nodes(input_node=inp, target_node=tgt, loss_node=agg,
                          prediction_node=pred, error_node=err)
    return model
