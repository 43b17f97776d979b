"""Loss nodes.

Port of ``Softmax``, ``MultinoulliNLL``, ``BinaryNLL``, ``GaussianNLL``,
``SquaredLoss``, ``AbsLoss``, ``Errors`` and ``AggregateLoss`` in
``elektronn2_tpu/neuromancer/loss.py`` (reference:
``elektronn2/neuromancer/loss.py``). Autograd differentiates them for
training (``Model.trainingstep``). Per-voxel losses return (b, *spatial)
maps; ``AggregateLoss`` reduces them to a (1,) tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .graphmanager import register_node_class
from .graphutils import TaggedShape
from .node_basic import Node

_EPS = 1e-10


def _loss_map_shape(pred_shape):
    """TaggedShape of a per-voxel loss map: drop the feature axis."""
    return pred_shape.delaxis("f")


@register_node_class
class Softmax(Node):
    """Softmax over the feature axis, optionally in independent groups.

    Reference: ``loss.py::Softmax`` (``n_indep`` groups, e.g. two
    independent binary decisions in one output tensor).
    """

    def __init__(self, parent, n_indep=1, name="softmax", print_repr=True):
        super().__init__(parent, name, print_repr)
        self.n_indep = int(n_indep)
        if parent.shape["f"] % self.n_indep:
            raise ValueError("features not divisible by n_indep")
        self.shape = parent.shape.copy()

    def _compute(self, ctx, x):
        return grouped_softmax(x, self.n_indep, self.shape.tag2index("f"))


def grouped_softmax(x, n_indep, axis):
    """Softmax over ``axis`` in ``n_indep`` equal independent groups."""
    if n_indep == 1:
        return F.softmax(x, dim=axis)
    parts = torch.chunk(x, n_indep, dim=axis)
    return torch.cat([F.softmax(p, dim=axis) for p in parts], dim=axis)


def _resolve_aux(value):
    """Normalise a class/example-weight argument: arrays become float32
    numpy constants; Node instances pass through (the caller registers them
    as extra parents)."""
    if value is None or isinstance(value, Node):
        return value
    return np.asarray(value, dtype=np.float32)


@register_node_class
class MultinoulliNLL(Node):
    """Weighted multinoulli (categorical) negative log-likelihood.

    Reference: ``loss.py::MultinoulliNLL``. ``pred`` must be probabilities
    (post-Softmax). Supports sparse integer targets, per-class weights,
    per-example weights, and ``mask_class_labeled`` (b, n_class).
    """

    def __init__(self, pred, target, target_is_sparse=False,
                 class_weights=None, example_weights=None,
                 mask_class_labeled=None, name="nll", print_repr=True):
        parents = [pred, target]
        self.class_weights = _resolve_aux(class_weights)
        self.example_weights = _resolve_aux(example_weights)
        self.mask_class_labeled = _resolve_aux(mask_class_labeled)
        for aux in (self.class_weights, self.example_weights,
                    self.mask_class_labeled):
            if isinstance(aux, Node):
                parents.append(aux)
        super().__init__(parents, name, print_repr)
        self.target_is_sparse = bool(target_is_sparse)
        self.n_class = pred.shape["f"]
        self.shape = _loss_map_shape(pred.shape)
        self._aux_tensors = {}   # (id of the constant, device) -> tensor

    def _aux_value(self, aux, parent_vals, like):
        """A weight argument's value: a parent's output, or the constant as
        a tensor on ``like``'s device, made once per device. Copying it from
        the host on every forward would stall each step and break a CUDA
        graph's capture."""
        if aux is None:
            return None
        if isinstance(aux, Node):
            return parent_vals[self.parents.index(aux)]
        key = (id(aux), like.device)
        t = self._aux_tensors.get(key)
        if t is None:
            t = self._aux_tensors[key] = torch.as_tensor(aux,
                                                         device=like.device)
        return t

    def _compute(self, ctx, *pv):
        pred, target = pv[0], pv[1]
        f_ax = self.parents[0].shape.tag2index("f")
        cw = self._aux_value(self.class_weights, pv, pred)
        ew = self._aux_value(self.example_weights, pv, pred)
        mcl = self._aux_value(self.mask_class_labeled, pv, pred)

        logp = torch.log(torch.clamp(pred, min=_EPS))
        if self.target_is_sparse:
            t = target.long()
            nll = -torch.gather(logp, f_ax, t.unsqueeze(f_ax)).squeeze(f_ax)
            if cw is not None:
                nll = nll * cw[t]
            if mcl is not None:
                b_idx = torch.arange(t.shape[0], device=t.device).reshape(
                    (-1,) + (1,) * (t.ndim - 1))
                nll = nll * mcl[b_idx, t]
        else:
            t = target
            w = (torch.ones(self.n_class, dtype=pred.dtype, device=pred.device)
                 if cw is None else cw)
            wshape = [1] * pred.ndim
            wshape[f_ax] = self.n_class
            nll = -torch.sum(t * logp * w.reshape(wshape), dim=f_ax)
            if mcl is not None:
                lab = torch.sum(t * mcl.reshape(mcl.shape[:1] + (self.n_class,)
                                                + (1,) * (pred.ndim - 2)),
                                dim=f_ax)
                nll = nll * lab
        if ew is not None:
            # per-example weights are (b,): broadcast from the left
            if ew.ndim < nll.ndim:
                ew = ew.reshape(tuple(ew.shape) + (1,) * (nll.ndim - ew.ndim))
            nll = nll * ew
        return nll


@register_node_class
class BinaryNLL(Node):
    """Binary cross-entropy on probabilities, summed over features.

    Reference: ``loss.py::BinaryNLL``.
    """

    def __init__(self, pred, target, name="binary_nll", print_repr=True):
        super().__init__([pred, target], name, print_repr)
        self.shape = _loss_map_shape(pred.shape)

    def _compute(self, ctx, pred, target):
        nll = -(target * torch.log(torch.clamp(pred, min=_EPS))
                + (1 - target) * torch.log(torch.clamp(1 - pred, min=_EPS)))
        return torch.sum(nll, dim=self.parents[0].shape.tag2index("f"))


@register_node_class
class GaussianNLL(Node):
    """Gaussian negative log-likelihood of ``target`` under a predicted mean
    and standard deviation (or its log, ``sig_is_log``), summed over
    features, without the constant term.

    Reference: ``loss.py::GaussianNLL``.
    """

    def __init__(self, mu, sig, target, sig_is_log=False, name="gaussian_nll",
                 print_repr=True):
        super().__init__([mu, sig, target], name, print_repr)
        self.sig_is_log = bool(sig_is_log)
        self.shape = _loss_map_shape(mu.shape)

    def _compute(self, ctx, mu, sig, target):
        if self.sig_is_log:
            log_sig, sig = sig, torch.exp(sig)
        else:
            sig = torch.clamp(sig, min=_EPS)
            log_sig = torch.log(sig)
        nll = 0.5 * torch.square((target - mu) / sig) + log_sig
        return torch.sum(nll, dim=self.parents[0].shape.tag2index("f"))


@register_node_class
class SquaredLoss(Node):
    """Squared error summed over features, per position; ``margin`` zeroes
    residuals smaller than it.

    Reference: ``loss.py::SquaredLoss`` (the tracing models' step loss).
    """

    def __init__(self, pred, target, margin=None, name="squared_loss",
                 print_repr=True):
        super().__init__([pred, target], name, print_repr)
        self.margin = margin
        self.shape = _loss_map_shape(pred.shape)

    def _compute(self, ctx, pred, target):
        r = pred - target
        if self.margin is not None:
            r = torch.where(torch.abs(r) < self.margin, 0.0, r)
        return torch.sum(torch.square(r),
                         dim=self.parents[0].shape.tag2index("f"))


@register_node_class
class AbsLoss(Node):
    """L1 loss summed over features, per position.

    Reference: ``loss.py::AbsLoss``.
    """

    def __init__(self, pred, target, name="abs_loss", print_repr=True):
        super().__init__([pred, target], name, print_repr)
        self.shape = _loss_map_shape(pred.shape)

    def _compute(self, ctx, pred, target):
        return torch.sum(torch.abs(pred - target),
                         dim=self.parents[0].shape.tag2index("f"))


@register_node_class
class Errors(Node):
    """Classification error rate (argmax mismatch fraction), as a (1,)
    tensor.

    Reference: ``loss.py::Errors``.
    """

    def __init__(self, pred, target, target_is_sparse=False, name="errors",
                 print_repr=True):
        super().__init__([pred, target], name, print_repr)
        self.target_is_sparse = bool(target_is_sparse)
        self.shape = TaggedShape((1,), ("f",))

    def _compute(self, ctx, pred, target):
        f_ax = self.parents[0].shape.tag2index("f")
        cls = torch.argmax(pred, dim=f_ax)
        t = target.long() if self.target_is_sparse \
            else torch.argmax(target, dim=f_ax)
        return torch.mean((cls != t).float()).reshape(1)


@register_node_class
class AggregateLoss(Node):
    """Reduce one or more loss maps to the scalar objective, as a (1,) tensor.

    Reference: ``loss.py::AggregateLoss`` (weighted mean over everything).
    """

    def __init__(self, parent_nodes, mixing_weights=None, name="loss",
                 print_repr=True):
        if isinstance(parent_nodes, Node):
            parent_nodes = [parent_nodes]
        super().__init__(parent_nodes, name, print_repr)
        if mixing_weights is not None and len(mixing_weights) != len(self.parents):
            raise ValueError("need one mixing weight per parent")
        self.mixing_weights = ([float(w) for w in mixing_weights]
                               if mixing_weights is not None
                               else [1.0] * len(self.parents))
        self.shape = TaggedShape((1,), ("f",))

    def _compute(self, ctx, *parent_values):
        total = 0.0
        for w, v in zip(self.mixing_weights, parent_values):
            total = total + w * torch.mean(v)
        return torch.reshape(torch.as_tensor(total), (1,))
