"""Recurrence: the ``ScanN`` node.

Port of ``ScanN`` in ``elektronn2_tpu/neuromancer/various.py`` (reference:
``elektronn2/neuromancer/various.py``). The JAX package compiles the
recurrence with ``lax.scan``; here it is a Python loop over the steps with
the state carried in tensors, evaluated eagerly. ``GaussianRV`` and the
skeleton losses (``SkelLoss``, ``SkelPrior``, ``SkelGetBatch``) are not
ported yet (ROADMAP.md §1 item 2).
"""

from __future__ import annotations

import torch

from .graphmanager import register_node_class
from .node_basic import Node, TraceCtx


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
            for m, c in zip(self.in_memory, carry):
                sub.values[m.name] = c
            for it, x in zip(self.in_iterate, seqs):
                sub.values[it.name] = x[t]
            ys.append(sub.get(self.step_result))
            carry = tuple(sub.get(o) for o in self.out_memory)
        return ys[-1] if self.last_only else torch.stack(ys)
