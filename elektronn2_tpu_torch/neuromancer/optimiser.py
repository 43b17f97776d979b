"""Optimisers: update rules with live-tunable hyperparameters.

Port of ``Optimiser``, ``SGD``, ``Adam``, ``AdaGrad`` and ``AdaDelta`` in
``elektronn2_tpu/neuromancer/optimiser.py`` (reference:
``elektronn2/neuromancer/optimiser.py``), with the same update arithmetic,
order of operations included: decoupled weight decay on the pre-update
parameter, a global-gradient-norm ``clip`` that is 0 to disable, per-leaf
``lr_mult``/``wd_mult``.

PyTorch idiom: :meth:`Optimiser.update` writes the new parameters and slots
into the tensors it was given, so every parameter and slot keeps its address
and a CUDA graph that captured a training step reads and writes the same
memory on every replay. The hyperparameters are 0-d float32 tensors on the
parameters' device (:meth:`Optimiser.current_hyper`); a setter between two
replays changes the value the graph reads, with no recapture, as a traced
``hyper`` takes effect in the JAX package with no recompile. The step
counter is an int32 tensor on the device too, so Adam's bias correction is
computed there.

State layout (the JAX package's, leaf for leaf): ``{"step": int32 0-d,
"slots": (tree, ...)}`` where each slot tree is ``{node: {param: tensor}}``;
:func:`opt_leaves` lists the leaves in ``jax.tree_util``'s order (``slots``
before ``step``, each tree by sorted node, then sorted parameter name), the
order of ``opt/<i>`` in a model file.
"""

from __future__ import annotations

import torch


def tree_leaves(tree):
    """Leaves of a ``{node: {param: tensor}}`` tree, by sorted node, then
    sorted parameter name (``jax.tree_util``'s order for dicts)."""
    return [tree[n][p] for n in sorted(tree) for p in sorted(tree[n])]


def opt_leaves(state):
    """The optimiser state's leaves in ``jax.tree_util``'s order: every slot
    tree's leaves, slot by slot, then the step counter."""
    return [v for s in state["slots"] for v in tree_leaves(s)] \
        + [state["step"]]


def _tree_zeros(params):
    return {n: {p: torch.zeros_like(v) for p, v in d.items()}
            for n, d in params.items()}


class Optimiser:
    """Base class. Subclasses define ``defaults`` and ``_update_leaf``.

    Common hyperparams: ``lr``, ``wd`` (decoupled weight decay), ``clip``
    (global-gradient-norm clip; 0 disables).
    """

    defaults = {"lr": 1e-3, "wd": 0.0, "clip": 0.0}

    def __init__(self, **hyperparams):
        self.hyperparams = dict(self.defaults)
        unknown = set(hyperparams) - set(self.defaults)
        if unknown:
            raise ValueError(f"unknown hyperparams {unknown} for "
                             f"{type(self).__name__}; known: "
                             f"{sorted(self.defaults)}")
        self.hyperparams.update(hyperparams)
        #: per device: the 0-d tensors a step reads, and the values last
        #: written into them
        self._hyper_t = {}

    # -- live-tuning API (reference: shared-variable setters) -------------
    def setlr(self, lr):
        self.hyperparams["lr"] = float(lr)

    def setwd(self, wd):
        self.hyperparams["wd"] = float(wd)

    def setmom(self, mom):
        if "mom" not in self.defaults:
            raise ValueError(f"{type(self).__name__} has no momentum")
        self.hyperparams["mom"] = float(mom)

    def current_hyper(self, device="cpu"):
        """The hyperparams as 0-d float32 tensors on ``device``: the same
        tensors on every call, with the current values written into those
        that changed (an asynchronous fill, no host sync). A CUDA graph that
        captured a step reads these tensors, so call this before each
        replay, never inside a capture (the fill would be recorded with the
        value of that moment)."""
        device = torch.device(device)
        tensors, written = self._hyper_t.setdefault(device, ({}, {}))
        for k, v in self.hyperparams.items():
            if k not in tensors:
                tensors[k] = torch.zeros((), dtype=torch.float32,
                                         device=device)
            if written.get(k) != v:
                tensors[k].fill_(float(v))
                written[k] = v
        return dict(tensors)

    # -- the update ----------------------------------------------------------
    def init_state(self, params):
        device = next((v.device for d in params.values() for v in d.values()),
                      torch.device("cpu"))
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "slots": self._init_slots(params)}

    def _init_slots(self, params):
        return ()

    @torch.no_grad()
    def update(self, params, grads, state, hyper, lr_mults=None,
               wd_mults=None, sumsq=None):
        """One optimisation step, in place: the tensors of ``params`` and
        of ``state`` (slots and step) get their new values. ``grads`` and the
        mult trees (python floats, or None for 1) are congruent with
        ``params``; ``hyper`` is :meth:`current_hyper`'s dict. When
        ``hyper['clip'] > 0`` the gradients are rescaled to that global norm
        first, chosen on the device (no host branch). ``sumsq``: the sum of
        the squares of the whole gradients where ``grads`` holds shards
        (tensor parallelism, ``parallel.tensor_parallel.ModelGroup.sumsq``);
        by default that of ``grads``."""
        state["step"].add_(1)
        step = state["step"]
        names = [(n, p) for n in sorted(params) for p in sorted(params[n])]
        gs = [grads[n][p] for n, p in names]
        clip = hyper["clip"]
        if sumsq is None:
            sumsq = sum(torch.sum(torch.square(g)) for g in gs)
        gnorm = torch.sqrt(sumsq + 1e-12)
        scale = torch.where(clip > 0, torch.clamp(clip / gnorm, max=1.0),
                            torch.ones_like(clip))
        slots = state["slots"]
        for (n, pn), g in zip(names, gs):
            g = g * scale
            p = params[n][pn]
            lm = 1.0 if lr_mults is None else lr_mults[n][pn]
            wm = 1.0 if wd_mults is None else wd_mults[n][pn]
            s_i = [s[n][pn] for s in slots]
            p2, s2 = self._update_leaf(p, g, s_i, hyper, step, lm)
            if wm:
                p2 = p2 - hyper["lr"] * hyper["wd"] * wm * lm * p
            p.copy_(p2)
            for old, new in zip(s_i, s2):
                old.copy_(new)

    def _update_leaf(self, p, g, slots, hyper, step, lr_mult):
        """(new parameter, new slots) of one leaf, out of place."""
        raise NotImplementedError

    def __repr__(self):
        return f"<{type(self).__name__} {self.hyperparams}>"


class SGD(Optimiser):
    """SGD with (Nesterov) momentum. Reference: ``optimiser.py::SGD``."""

    defaults = {"lr": 1e-3, "mom": 0.9, "wd": 0.0, "clip": 0.0,
                "nesterov": False}

    def __init__(self, **hyperparams):
        self.nesterov = bool(hyperparams.pop("nesterov", False))
        super().__init__(**hyperparams)
        self.hyperparams.pop("nesterov", None)
        self.defaults = {k: v for k, v in self.defaults.items()
                         if k != "nesterov"}

    def _init_slots(self, params):
        return (_tree_zeros(params),)

    def _update_leaf(self, p, g, slots, hyper, step, lr_mult):
        (v,) = slots
        lr = hyper["lr"] * lr_mult
        v_new = hyper["mom"] * v - lr * g
        if self.nesterov:
            p_new = p + hyper["mom"] * v_new - lr * g
        else:
            p_new = p + v_new
        return p_new, (v_new,)


class Adam(Optimiser):
    """Adam with bias correction. Reference: ``optimiser.py::Adam``."""

    defaults = {"lr": 1e-3, "beta1": 0.9, "beta2": 0.999, "eps": 1e-8,
                "wd": 0.0, "clip": 0.0}

    def _init_slots(self, params):
        return (_tree_zeros(params), _tree_zeros(params))

    def _update_leaf(self, p, g, slots, hyper, step, lr_mult):
        m, v = slots
        b1, b2 = hyper["beta1"], hyper["beta2"]
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        t = step.to(torch.float32)
        m_hat = m / (1 - torch.pow(b1, t))
        v_hat = v / (1 - torch.pow(b2, t))
        p_new = p - hyper["lr"] * lr_mult * m_hat / (torch.sqrt(v_hat)
                                                     + hyper["eps"])
        return p_new, (m, v)


class AdaGrad(Optimiser):
    """AdaGrad. Reference: ``optimiser.py::AdaGrad``."""

    defaults = {"lr": 1e-2, "eps": 1e-8, "wd": 0.0, "clip": 0.0}

    def _init_slots(self, params):
        return (_tree_zeros(params),)

    def _update_leaf(self, p, g, slots, hyper, step, lr_mult):
        (acc,) = slots
        acc = acc + torch.square(g)
        p_new = p - hyper["lr"] * lr_mult * g / (torch.sqrt(acc)
                                                 + hyper["eps"])
        return p_new, (acc,)


class AdaDelta(Optimiser):
    """AdaDelta. Reference: ``optimiser.py::AdaDelta``."""

    defaults = {"lr": 1.0, "rho": 0.95, "eps": 1e-6, "wd": 0.0, "clip": 0.0}

    def _init_slots(self, params):
        return (_tree_zeros(params), _tree_zeros(params))

    def _update_leaf(self, p, g, slots, hyper, step, lr_mult):
        acc_g, acc_d = slots
        rho, eps = hyper["rho"], hyper["eps"]
        acc_g = rho * acc_g + (1 - rho) * torch.square(g)
        delta = -torch.sqrt(acc_d + eps) / torch.sqrt(acc_g + eps) * g
        acc_d = rho * acc_d + (1 - rho) * torch.square(delta)
        return p + hyper["lr"] * lr_mult * delta, (acc_g, acc_d)


OPTIMISERS = {"SGD": SGD, "Adam": Adam, "AdaGrad": AdaGrad,
              "AdaDelta": AdaDelta}


def get_optimiser(name):
    if isinstance(name, Optimiser):
        return name
    try:
        return OPTIMISERS[name]
    except KeyError:
        raise ValueError(f"unknown optimiser {name!r}; "
                         f"known: {sorted(OPTIMISERS)}") from None
