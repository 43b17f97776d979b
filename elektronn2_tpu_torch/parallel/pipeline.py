"""Pipeline parallelism (a GPipe schedule) over a ``pipe`` mesh axis.

Port of ``elektronn2_tpu/parallel/pipeline.py`` on ``torch.distributed``.
Contiguous chunks of a conv stack's layers ("stages", ``np.array_split``)
run on the successive ranks of a ``pipe`` axis; microbatches stream through
them, and each tick hands the stages' outputs on with one ``all_gather``
over the axis (every rank is given the whole input, as in every sharded
entry point of the port, and the parameters are replicated: each stage
computes only with its own).

The schedule is explicit (:class:`_GPipe`, a ``torch.autograd.Function``):
M + S - 1 forward ticks, then M + S - 1 backward ticks in reverse. At a
forward tick a stage runs its layers on the microbatch it holds, if any,
and keeps that tick's local autograd graph; at a backward tick it runs
``torch.autograd.grad`` on that local graph alone, with the gradient its
successor handed back, and hands its input's gradient on. Every rank calls
the same 2 (M + S - 1) collectives whatever it computes; a graph of the
whole schedule would not (stage 0 never uses what it receives, so its
backward would skip collectives the others call, and the step would hang).
Each stage's parameter gradients arise on its rank and are summed over the
axis (and over ``data`` under DP x PP); the loss, evaluated per
microbatch on the last stage and skipped by a branch on warm-up ticks and
other stages (a masked 0 * inf would be NaN), is the sum over ranks
divided by M * n_data.

The hand-off buffer is padded to the largest stage boundary, and its dtype
follows the weights' (bf16 works). A stage keeps every microbatch's
activations until the backward, as GPipe does without recomputation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.conv import apply_layer


def microbatch(x, n_micro):
    """(M*b, ...) -> (M, b, ...) microbatch split (order-preserving), of a
    tensor or an array. Reference: ``parallel/pipeline.py::microbatch``."""
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"n_micro={n_micro}")
    return x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))


def _stage_apply(meta, params, idxs, x):
    """Layers ``idxs`` of the stack, in order (``ops.conv.apply_layer``)."""
    for i in idxs:
        x = apply_layer(x, params[i]["w"], params[i].get("b"),
                        meta[i]["activation"], meta[i]["pool"])
    return x


def _pad_to(x, shape):
    """``x`` zero-padded at the end of each dim to ``shape``."""
    pads = []
    for s, t in reversed(list(zip(x.shape, shape))):
        pads += [0, t - s]
    if any(pads):
        x = torch.nn.functional.pad(x, pads)
    return x


def _crop(x, shape):
    return x[tuple(slice(0, d) for d in shape)]


def extract_params(layers):
    """Split a ``halo.py``-style layer list into (meta, params): params are
    ``[{"w", "b"}, ...]`` tensors (arrays become tensors, their dtype
    kept). Reference: ``parallel/pipeline.py::extract_params``."""
    meta = [{"activation": l.get("activation"), "pool": l.get("pool")}
            for l in layers]
    params = [{"w": torch.as_tensor(l["w"])}
              | ({"b": torch.as_tensor(l["b"])} if l.get("b") is not None
                 else {})
              for l in layers]
    return meta, params


def _boundaries(meta, params, stage_idxs, in_shape, dtype):
    """The shapes at the stage boundaries: the microbatch, then each
    stage's output (traced on the meta device, no work)."""
    bounds = [tuple(int(v) for v in in_shape)]
    mp = [{k: torch.empty(v.shape, dtype=v.dtype, device="meta")
           for k, v in p.items()} for p in params]
    for idxs in stage_idxs:
        x = torch.empty(bounds[-1], dtype=dtype, device="meta")
        bounds.append(tuple(_stage_apply(meta, mp, idxs, x).shape))
    return bounds


class _GPipe(torch.autograd.Function):
    """The schedule (see the module): forward evaluates the loss on every
    rank, backward returns every parameter's gradient on every rank."""

    @staticmethod
    def forward(ctx, pipe, keys, x_micro, y_micro, *flat):
        ctx.pipe = pipe
        with torch.enable_grad():
            loss, ctx.saved = pipe._forward(keys, x_micro, y_micro, flat)
        return loss

    @staticmethod
    def backward(ctx, g):
        grads = ctx.pipe._backward(ctx.saved, g)
        ctx.saved = None
        return (None, None, None, None) + tuple(grads)


class _Pipeline:
    """``gpipe_stack``'s loss: ``loss_of(params, x_micro, y_micro)``."""

    def __init__(self, meta, stage_idxs, bounds, buf_shape, dtype, pipe,
                 data, loss_fn, M):
        self.meta, self.stage_idxs = meta, stage_idxs
        self.bounds, self.buf_shape, self.dtype = bounds, buf_shape, dtype
        self.group, self.data, self.loss_fn, self.M = (pipe.group, data,
                                                       loss_fn, M)
        self.S, self.s = pipe.world, pipe.rank

    def __call__(self, params, x_micro, y_micro):
        """The mean loss over the microbatches (a 0-d float32 tensor on
        every rank), differentiable with respect to ``params``' tensors."""
        keys = [(i, k) for i, p in enumerate(params) for k in sorted(p)]
        return _GPipe.apply(self, keys, x_micro, y_micro,
                            *[params[i][k] for i, k in keys])

    def _hand_on(self, t):
        """One tick's hand-off: every stage's buffer, gathered."""
        parts = [torch.empty_like(t) for _ in range(self.S)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return parts

    def _forward(self, keys, x_micro, y_micro, flat):
        S, s, M = self.S, self.s, self.M
        if self.data is not None:                 # DP x PP: this rank's rows
            x_micro = self.data.rows(x_micro, 1)
            y_micro = self.data.rows(y_micro, 1)
        params = [{} for _ in self.meta]
        leaves = []
        for (i, k), v in zip(keys, flat):
            if i in self.stage_idxs[s] and v.requires_grad:
                v = v.detach().requires_grad_()
                leaves.append(((i, k), v))
            params[i][k] = v
        ticks = {}
        acc = torch.zeros((), dtype=torch.float32, device=x_micro.device)
        recv = None
        for t in range(M + S - 1):
            m = t - s
            out = torch.zeros(self.buf_shape, dtype=self.dtype,
                              device=x_micro.device)
            if 0 <= m < M:
                xin = (x_micro[m].to(self.dtype) if s == 0
                       else _crop(recv, self.bounds[s]).detach())
                if s > 0:
                    xin.requires_grad_()
                y = _stage_apply(self.meta, params, self.stage_idxs[s], xin)
                lm = None
                if s == S - 1:                    # a branch, not a mask
                    lm = self.loss_fn(y, y_micro[m]).float()
                    acc = acc + lm.detach()
                else:
                    out = _pad_to(y.detach(), self.buf_shape)
                ticks[t] = (xin, y, lm)
            parts = self._hand_on(out)
            recv = parts[s - 1] if s > 0 else None
        n_data = self.data.world if self.data is not None else 1
        total = acc.reshape(1)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=self.group)
        if self.data is not None:
            dist.all_reduce(total, op=dist.ReduceOp.SUM,
                            group=self.data.group)
        return total[0] / (M * n_data), (ticks, leaves, keys, flat, n_data)

    def _backward(self, saved, g):
        ticks, leaves, keys, flat, n_data = saved
        S, s, M = self.S, self.s, self.M
        scale = g / (M * n_data)
        grads = {key: torch.zeros_like(v) for key, v in leaves}
        send_shape = self.buf_shape
        recv = None
        for t in reversed(range(M + S - 1)):
            m = t - s
            out = None
            if 0 <= m < M:
                xin, y, lm = ticks.pop(t)
                wrt = [v for _, v in leaves] + ([xin] if s > 0 else [])
                if s == S - 1:
                    gs = torch.autograd.grad(lm, wrt, grad_outputs=scale,
                                             allow_unused=True)
                else:
                    gy = _crop(recv, self.bounds[s + 1]).to(y.dtype)
                    gs = torch.autograd.grad(y, wrt, grad_outputs=gy,
                                             allow_unused=True)
                for (key, _), gk in zip(leaves, gs):
                    if gk is not None:
                        grads[key] += gk
                if s > 0:
                    out = _pad_to(gs[-1].detach(), send_shape)
            if out is None:
                out = torch.zeros(send_shape, dtype=self.dtype,
                                  device=g.device)
            parts = self._hand_on(out.to(self.dtype))
            recv = parts[s + 1] if s < S - 1 else None
        # every parameter's gradient on every rank: the stages' summed
        full = [grads.get(key, torch.zeros_like(v))
                for key, v in zip(keys, flat)]
        buf = torch.cat([t.float().reshape(-1) for t in full])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        if self.data is not None:
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.data.group)
        out, off = [], 0
        for v in flat:
            out.append(buf[off:off + v.numel()].view(v.shape).to(v.dtype)
                       if v.requires_grad else None)
            off += v.numel()
        return out


def gpipe_stack(layers, mesh, loss_fn, mb_input_shape, n_micro,
                axis_name="pipe", data_axis=None):
    """Build a pipelined, differentiable loss for a conv stack.

    ``layers``: a ``halo.py``-style list of dicts ``{w, b, activation,
    pool}``, split into as many contiguous stages as the ``axis_name`` axis
    has ranks. ``loss_fn(pred_mb, target_mb) -> scalar`` is evaluated per
    microbatch on the last stage; the loss is its mean over microbatches
    (the unpipelined loss of the whole batch for mean-style losses).
    ``mb_input_shape``: one microbatch's input shape (b_mb, f, *spatial).

    With ``data_axis``, DP composes with PP: each microbatch's batch dim is
    split over that axis (each data rank runs its own pipeline; the
    gradients are summed over it), ``loss_fn`` must be a mean over its
    local batch, and ``mb_input_shape`` stays the global per-microbatch
    shape.

    Returns ``(loss_of, meta, params)``: ``loss_of(params, x_micro,
    y_micro)`` is the loss on every rank (a 0-d float32 tensor), and
    ``torch.autograd.grad`` of it gives every parameter's gradient on every
    rank (the backward schedule is collective: every rank of the mesh
    runs it). ``x_micro``/``y_micro`` carry a leading (n_micro,) axis
    (:func:`microbatch`). Reference: ``parallel/pipeline.py::gpipe_stack``.
    """
    from .data_parallel import AxisGroup, DataGroup
    pipe = AxisGroup(mesh, axis_name)
    S = pipe.world
    M = int(n_micro)
    if M < 1:
        raise ValueError("n_micro must be >= 1")
    if S > len(layers):
        raise ValueError(f"{S} pipeline stages for {len(layers)} layers")
    meta, params = extract_params(layers)
    stage_idxs = [list(c) for c in np.array_split(range(len(layers)), S)]
    dtype = params[0]["w"].dtype      # buffer / compute dtype (bf16 too)
    data = DataGroup(mesh, data_axis) if data_axis else None
    n_data = data.world if data is not None else 1
    if mb_input_shape[0] % n_data:
        raise ValueError(f"microbatch batch dim {mb_input_shape[0]} not "
                         f"divisible by {data_axis}={n_data}")
    mb_input_shape = ((mb_input_shape[0] // n_data,)
                      + tuple(mb_input_shape[1:]))
    bounds = _boundaries(meta, params, stage_idxs, mb_input_shape, dtype)
    buf_shape = tuple(int(max(b[d] for b in bounds))
                      for d in range(len(bounds[0])))
    return (_Pipeline(meta, stage_idxs, bounds, buf_shape, dtype, pipe,
                      data, loss_fn, M), meta, params)


def gpipe_reference_loss(layers, loss_fn, x_micro, y_micro):
    """Unpipelined oracle: the mean over microbatches of the sequential
    stack's loss (what ``gpipe_stack``'s loss must equal). Reference:
    ``parallel/pipeline.py::gpipe_reference_loss``."""
    meta, params = extract_params(layers)
    losses = [loss_fn(_stage_apply(meta, params, range(len(layers)),
                                   x_micro[m]), y_micro[m])
              for m in range(x_micro.shape[0])]
    return torch.mean(torch.stack(losses))


def layers_from_model(model, params=None, with_names=False):
    """The ``{w, b, activation, pool}`` layer list of a linear chain of
    plain ``Conv`` nodes below the model's input (the encoder family
    ``gpipe_stack`` and ``spatial_cp_stack`` take). Raises on branches,
    MFP, batch norm, dropout, prelu, maxout and on a chain interrupted by
    another node (a Softmax or loss head after the last Conv is fine).
    ``with_names`` also returns the chain's node names. Reference:
    ``parallel/pipeline.py::layers_from_model``."""
    from ..neuromancer import neural
    params = model.params if params is None else params
    node = model.input_node
    layers, names = [], []
    while node.children:
        convs = [c for c in node.children if isinstance(c, neural.Conv)]
        if not convs:
            break
        if len(node.children) > 1:
            raise ValueError(f"node {node.name!r} branches; pipeline "
                             "extraction needs a linear Conv chain")
        node = convs[0]
        if node.mfp or node.batch_normalisation or node.dropout_rate:
            raise ValueError(f"Conv {node.name!r} uses mfp/BN/dropout — "
                             "not supported by the layer-list pipeline")
        if node.activation_func == "prelu" or (
                isinstance(node.activation_func, str)
                and node.activation_func.startswith("maxout")):
            raise ValueError(f"Conv {node.name!r} uses "
                             f"{node.activation_func!r} — parameterised/"
                             "shape-changing activations are not supported "
                             "by the layer-list pipeline")
        layers.append({"w": params[node.name]["w"],
                       "b": params[node.name]["b"],
                       "activation": node.activation_func,
                       "pool": tuple(node.pool_shape)})
        names.append(node.name)
    if not layers:
        raise ValueError("no Conv chain found below the input node")
    # a Conv beyond the first non-Conv child means the chain was
    # interrupted: a silent prefix would train the wrong network
    n_convs = sum(isinstance(n, neural.Conv) for n in model.nodes.values())
    if n_convs != len(layers):
        raise ValueError(
            f"extracted {len(layers)} of {n_convs} Conv nodes: the chain is "
            f"interrupted after {node.name!r} by a non-Conv node — the "
            "layer-list pipeline supports only uninterrupted Conv chains")
    return (layers, names) if with_names else layers


def _model_loss_fn(model):
    """The per-microbatch ``loss_fn(pred_mb, target_mb)`` of the model's
    loss graph: AggregateLoss over MultinoulliNLL(Softmax(x)) with sparse
    int targets -> the mean softmax cross-entropy from the chain's logits
    (per group for a grouped Softmax head); over SquaredLoss / AbsLoss ->
    the mean elementwise loss. Reference:
    ``parallel/pipeline.py::_model_loss_fn``."""
    from ..neuromancer import loss as L
    node = model.loss_node
    if isinstance(node, L.AggregateLoss) and len(node.parents) == 1:
        node = node.parents[0]
    if isinstance(node, L.MultinoulliNLL):
        if not node.target_is_sparse:
            raise ValueError("pipeline loss head: only sparse-target "
                             "MultinoulliNLL is supported")
        if node.class_weights is not None \
                or node.example_weights is not None \
                or node.mask_class_labeled is not None:
            raise ValueError("pipeline loss head: class/example weights "
                             "and mask_class_labeled are not supported; "
                             "pass loss_fn= explicitly")
        n_indep = int(getattr(node.parents[0], "n_indep", 1))

        def ce(logits, tgt):
            if n_indep > 1:
                lp = torch.cat([torch.log_softmax(p, dim=1)
                                for p in torch.chunk(logits, n_indep, 1)],
                               dim=1)
            else:
                lp = torch.log_softmax(logits, dim=1)
            picked = torch.gather(lp, 1, tgt[:, None].long())[:, 0]
            return -torch.mean(picked)

        return ce
    if isinstance(node, L.SquaredLoss):
        return lambda p, t: torch.mean((p - t) ** 2)
    if isinstance(node, L.AbsLoss):
        return lambda p, t: torch.mean(torch.abs(p - t))
    raise ValueError(f"pipeline loss head: unsupported loss graph "
                     f"({type(node).__name__}); pass loss_fn= explicitly")


def make_gpipe_trainstep(model, mesh, n_micro, mb_batch, axis_name="pipe",
                         data_axis=None, loss_fn=None):
    """A model-level pipeline-parallel training step: the model's linear
    Conv chain (:func:`layers_from_model`) staged over ``axis_name``, the
    loss head from its loss graph (:func:`_model_loss_fn`) on the last
    stage per microbatch (a microbatch mean of a mean loss is the batch's,
    so the step equals ``Model.trainingstep`` on the same batch), then the
    model's own optimiser.

    Returns ``step(params, opt_state, x_micro, y_micro, hyper) -> (loss,
    params, opt_state)``; ``params`` and ``opt_state`` are **updated in
    place** (the JAX package donates them) and returned. ``x_micro`` /
    ``y_micro`` carry a leading (n_micro,) axis (:func:`microbatch`);
    ``mb_batch`` is one microbatch's global batch (split over
    ``data_axis`` if given); ``hyper`` is
    ``model.optimiser.current_hyper(device)``. Every rank of the mesh
    calls it alike. Reference: ``parallel/pipeline.py::
    make_gpipe_trainstep``.
    """
    from ..ops.conv import f32_convs, f32_matmuls
    if model.optimiser is None:
        raise ValueError("model needs an optimiser (set_opt) first")
    layers, names = layers_from_model(model, with_names=True)
    trainable = set(model._trainable(model.params))
    if trainable - set(names):
        raise ValueError(
            f"model has trainable params outside the Conv chain "
            f"({sorted(trainable - set(names))}) — the pipeline step "
            "would not update them")
    if loss_fn is None:
        loss_fn = _model_loss_fn(model)
    in_sp = model.input_node.shape.spatial_shape
    f_in = model.input_node.shape["f"]
    mb_shape = (int(mb_batch), int(f_in)) + tuple(int(s) for s in in_sp)
    loss_of, _, _ = gpipe_stack(layers, mesh, loss_fn, mb_shape, n_micro,
                                axis_name=axis_name, data_axis=data_axis)
    opt = model.optimiser

    def step(params, opt_state, x_micro, y_micro, hyper):
        train = model._trainable(params)
        leaves = {n: {p: v.detach().requires_grad_() for p, v in d.items()}
                  for n, d in train.items()}
        with f32_convs(), f32_matmuls():
            loss = loss_of([{"w": leaves[n]["w"], "b": leaves[n]["b"]}
                            for n in names], x_micro, y_micro)
            order = [(n, p) for n in names for p in ("w", "b")]
            gs = torch.autograd.grad(loss, [leaves[n][p] for n, p in order])
            grads = {}
            for (n, p), g in zip(order, gs):
                grads.setdefault(n, {})[p] = g
            opt.update(train, grads, opt_state, hyper, model._lr_mults,
                       model._wd_mults)
        return loss.detach(), params, opt_state

    return step
