"""Reparameterised sampling, recurrence and the skeleton losses.

Port of ``GaussianRV``, ``ScanN``, ``SkelLoss``, ``SkelLossField``,
``SkelPrior`` and ``SkelGetBatch`` in ``elektronn2_tpu/neuromancer/
various.py`` (reference: ``elektronn2/neuromancer/various.py``). The JAX
package compiles the recurrence with ``lax.scan``; here it is a Python loop
over the steps with the state carried in tensors, evaluated eagerly.

``SkelLoss`` queries the skeletons' KD-trees on the host
(``data/skeleton.py::skel_loss_callback``), so a step that holds it syncs
the host and runs eagerly; ``SkelLossField`` samples a squared-distance
field on the device and fits in a CUDA graph.
"""

from __future__ import annotations

import numpy as np
import torch

from .graphmanager import register_node_class
from .graphutils import TaggedShape
from .node_basic import Node, TraceCtx


def gaussian_noise(gen, shape, n_samples, device):
    """The draw of ``GaussianRV``: standard normal noise of ``shape``, the
    mean of ``n_samples`` draws."""
    if n_samples == 1:
        return torch.randn(shape, generator=gen, device=device)
    return torch.randn((n_samples,) + tuple(shape), generator=gen,
                       device=device).mean(dim=0)


@register_node_class
class GaussianRV(Node):
    """Reparameterised Gaussian sample ``mu + sig * eps`` in training mode,
    ``mu`` in evaluation. With ``n_samples > 1`` ``eps`` is the mean of that
    many draws. The draw (:func:`gaussian_noise`) is split from the map, so
    a caller can feed ``eps`` (``TraceCtx.noise_in``).

    Reference: ``various.py::GaussianRV``.
    """

    def __init__(self, mu, sig, n_samples=1, name="gaussian_rv",
                 print_repr=True):
        super().__init__([mu, sig], name, print_repr)
        self.n_samples = int(n_samples)
        if self.n_samples < 1:
            raise ValueError(f"n_samples must be >= 1, got {n_samples}")
        self.shape = mu.shape.copy()

    def _compute(self, ctx, mu, sig):
        if not ctx.train:
            return mu
        eps = ctx.draw(self, lambda g, shape: gaussian_noise(
            g, shape, self.n_samples, mu.device), mu.shape)
        return mu if eps is None else mu + sig * eps


@register_node_class
class ScanN(Node):
    """Iterate a sub-graph with carried state, the recurrence engine.

    Reference: ``various.py::ScanN``. Parameters, as there:
      step_result   : node computed each step (the cell output)
      in_memory     : node(s) whose value is the carried state; their normal
                      value (e.g. ``InitialState_like``) seeds step 0
      out_memory    : node(s) giving the next carry (default: [step_result])
      in_iterate    : placeholder node(s) fed a new time slice each step
      in_iterate_0  : node(s) providing full sequences; time on axis 0
      n_steps       : static iteration count (required if no sequences)
      last_only     : return only the final step's result

    Output shape: ``(s=n_steps,) + step_result.shape``, or
    ``step_result.shape`` with ``last_only``.
    """

    _lazy = True

    def __init__(self, step_result, in_memory, out_memory=None,
                 in_iterate=None, in_iterate_0=None, n_steps=None,
                 last_only=False, name="scan", print_repr=True):
        def aslist(x):
            if x is None:
                return []
            return list(x) if isinstance(x, (list, tuple)) else [x]

        self.step_result = step_result
        self.in_memory = aslist(in_memory)
        self.out_memory = aslist(out_memory) or [step_result]
        self.in_iterate = aslist(in_iterate)
        self.in_iterate_0 = aslist(in_iterate_0)
        if len(self.in_iterate) != len(self.in_iterate_0):
            raise ValueError("in_iterate and in_iterate_0 must pair up")
        if len(self.in_memory) != len(self.out_memory):
            raise ValueError("in_memory and out_memory must pair up")
        if n_steps is None:
            if not self.in_iterate_0:
                raise ValueError("need n_steps or sequence inputs")
            n_steps = self.in_iterate_0[0].shape["s"]
        self.n_steps = int(n_steps)
        self.last_only = bool(last_only)

        parents = ([step_result] + self.in_memory + self.out_memory
                   + self.in_iterate_0)
        uniq = list({p.name: p for p in parents}.values())
        super().__init__(uniq, name, print_repr)
        if self.last_only:
            self.shape = step_result.shape.copy()
        else:
            self.shape = step_result.shape.addaxis(0, self.n_steps, "s")

    def _compute_lazy(self, ctx):
        carry = tuple(ctx.get(m) for m in self.in_memory)
        seqs = tuple(ctx.get(s) for s in self.in_iterate_0)
        for s, node in zip(seqs, self.in_iterate_0):
            if s.shape[0] != self.n_steps:
                raise ValueError(
                    f"sequence {node.name} has {s.shape[0]} steps, scan "
                    f"expects {self.n_steps} on axis 0")
        ys = []
        for t in range(self.n_steps):
            sub = TraceCtx(ctx.params, ctx.feed, rng=ctx.rng,
                           train=ctx.train, state_in=ctx.state_in)
            sub.remat = ctx.remat
            sub.compute_dtype = ctx.compute_dtype
            for m, c in zip(self.in_memory, carry):
                sub.values[m.name] = c
            for it, x in zip(self.in_iterate, seqs):
                sub.values[it.name] = x[t]
            ys.append(sub.get(self.step_result))
            carry = tuple(sub.get(o) for o in self.out_memory)
        return ys[-1] if self.last_only else torch.stack(ys)


@register_node_class
class SkelLoss(Node):
    """Squared distance of each landing point (position + predicted step)
    to the nearest node of its skeleton, queried on the host
    (``data/skeleton.py::skel_loss_callback``; its gradient pulls the
    landing point toward that node).

    Inputs: ``pred`` (b, 3) step vectors, ``skel_data`` (b, 4) rows of
    [skel_id, z, x, y] (a ``GenericInput``). Reference:
    ``various.py::SkelLoss``. A step with this node syncs the host; the
    fused loops refuse to capture it (``SkelLossField`` is the device
    version).
    """

    host_sync = True

    def __init__(self, pred, skel_data, loss_kwargs=None, name="skel_loss",
                 print_repr=True):
        super().__init__([pred, skel_data], name, print_repr)
        self.loss_kwargs = dict(loss_kwargs or {})
        self.shape = TaggedShape((pred.shape["b"],), ("b",))

    def _compute(self, ctx, pred, skel):
        from ..data.skeleton import skel_loss_callback
        return skel_loss_callback(pred, skel, **self.loss_kwargs)


def sample_fields(fields, sid, p):
    """Trilinear samples of ``fields`` (n, Z, X, Y) at the points ``p``
    (b, 3), each in the volume ``sid`` (b,) int64; a point is clamped so
    its 2x2x2 cell stays inside. Differentiable in ``p`` through the
    interpolation weights."""
    n, Z, X, Y = fields.shape
    p = torch.stack([p[:, i].clamp(0.0, d - 1.0 - 1e-4)
                     for i, d in enumerate((Z, X, Y))], dim=1)
    base = torch.floor(p)
    frac = p - base
    b = base.long()
    flat = fields.reshape(-1)
    out = 0.0
    for dz in (0, 1):
        wz = frac[:, 0] if dz else 1.0 - frac[:, 0]
        for dx in (0, 1):
            wx = frac[:, 1] if dx else 1.0 - frac[:, 1]
            for dy in (0, 1):
                wy = frac[:, 2] if dy else 1.0 - frac[:, 2]
                idx = (((sid * Z + b[:, 0] + dz) * X + b[:, 1] + dx) * Y
                       + b[:, 2] + dy)
                out = out + wz * wx * wy * flat[idx]
    return out


@register_node_class
class SkelLossField(Node):
    """The objective of ``SkelLoss`` on the device: the squared distance of
    the landing point to the skeleton, sampled trilinearly from a
    precomputed squared-distance field stack (one (Z, X, Y) volume per
    skeleton, ``data.skeleton.skeleton_distance_field``), held as a
    non-trainable parameter. No host sync, so a training step with it fits
    in a CUDA graph.

    Inputs as ``SkelLoss``. Reference: ``various.py::SkelLossField``.
    """

    def __init__(self, pred, skel_data, fields, name="skel_loss_field",
                 print_repr=True):
        super().__init__([pred, skel_data], name, print_repr)
        fields = np.asarray(fields, np.float32)
        if fields.ndim != 4:
            raise ValueError("fields must be (n_skel, Z, X, Y) squared-"
                             f"distance volumes, got {fields.shape}")
        self.shape = TaggedShape((pred.shape["b"],), ("b",))
        self.register_param("fields", fields, trainable=False)

    def _compute(self, ctx, pred, skel):
        landing = skel[:, 1:4] + pred.float()
        return sample_fields(ctx.param(self, "fields"), skel[:, 0].long(),
                             landing)


@register_node_class
class SkelPrior(Node):
    """Soft penalty of the step length's deviation from ``target_length``.

    Reference: ``various.py::SkelPrior``.
    """

    def __init__(self, pred, target_length=1.0, name="skel_prior",
                 print_repr=True):
        super().__init__(pred, name, print_repr)
        self.target_length = float(target_length)
        self.shape = TaggedShape((pred.shape["b"],), ("b",))

    def _compute(self, ctx, pred):
        norm = torch.sqrt(torch.sum(torch.square(pred), dim=-1) + 1e-8)
        return torch.square(norm - self.target_length)


@register_node_class
class SkelGetBatch(Node):
    """Passes an externally fed tracing batch through, for spec
    compatibility: the tracing batches come from ``AgentData``.

    Reference: ``various.py::SkelGetBatch``.
    """

    def __init__(self, skel_data, shape, tags, name="skel_batch",
                 print_repr=True):
        super().__init__(skel_data, name, print_repr)
        self.shape = TaggedShape(shape, tags)

    def _compute(self, ctx, skel):
        return skel
