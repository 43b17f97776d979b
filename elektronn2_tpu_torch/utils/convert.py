"""Bridges from the JAX package: parameters, and the port's own copies of
the repo's model builders.

``params_from_jax`` turns the JAX package's ``{node: {name: array}}``
parameters into the port's tensors. Every ported node keeps the JAX
package's parameter layout (conv ``w`` ``(Cout, Cin, kz, kx, ky)``, UpConv
``w`` ``(f_out, f_in, *pool)``, Perceptron ``w`` ``(f_in, n_f)``, GRU
``w_gates``/``b_gates``/``w_cand``/``b_cand``, ``InitialState_like``
``state0``, batch norm's ``bn_gamma``/``bn_beta``, prelu's ``alpha``), so
the conversion is an exact copy.

``opt_state_from_jax`` carries the JAX package's optimiser state (slots and
step counter) into a port model the same way.

The builders have the arguments, node names and geometry of their
counterparts: ``flagship_model`` of ``__graft_entry__._flagship_model`` (the
neuro3d-class net), ``neuro3d_train_model`` of the bench's training net
(``scripts/bench_tpu_pending.py::_neuro3d_model``; its batch-normed,
dropout form ``neuro3d_bn_train_model`` through ``simple_cnn``),
``tracer_model`` of
``scripts/exp_tracer_rollout.py::build_model`` (the tracing deployment's
recurrent model), ``wide_unet_model`` of ``examples/unet3d_wide.py::
create_model`` and ``unet3d_model`` of ``examples/unet3d.py::create_model``
(the decoder graphs of U-Net serving). Each puts its parameters on
``device``, the card unless the caller asks for the CPU; without a card the
default raises (``neuromancer.model.target_device``).
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params, model=None):
    """``{node: {name: array}}`` (jax or numpy arrays) → float32 tensors.

    Every array must be floating point. With ``model`` (a port ``Model``),
    the node and parameter names must be exactly the model's and every
    shape must equal the model's; the tensors land on the model's device.
    """
    want = None if model is None else model.params
    device = torch.device("cpu") if model is None else model.device
    if want is not None and set(params) != set(want):
        raise ValueError(f"param nodes differ: only in JAX "
                         f"{sorted(set(params) - set(want))}, only in port "
                         f"{sorted(set(want) - set(params))}")
    out = {}
    for nname, d in params.items():
        if want is not None and set(d) != set(want[nname]):
            raise ValueError(f"node {nname!r}: param names {sorted(d)} != "
                             f"{sorted(want[nname])}")
        out[nname] = {}
        for pname, v in d.items():
            a = np.asarray(v)
            if not np.issubdtype(a.dtype, np.floating):
                raise TypeError(f"param {nname}/{pname}: dtype {a.dtype} is "
                                "not floating point")
            if want is not None and a.shape != tuple(want[nname][pname].shape):
                raise ValueError(
                    f"param {nname}/{pname}: shape {a.shape} != port's "
                    f"{tuple(want[nname][pname].shape)}")
            out[nname][pname] = torch.tensor(a, dtype=torch.float32,
                                             device=device)
    return out


def opt_state_from_jax(opt_state, model):
    """The JAX package's optimiser state (``{"step": int, "slots": (tree,
    ...)}``, jax or numpy arrays) written into ``model.opt_state`` (a port
    ``Model`` after ``set_opt`` with the same optimiser): every slot and the
    step counter, copied into the port's tensors in place. Shapes and the
    number of slots must match."""
    from ..neuromancer.optimiser import tree_leaves
    mine = model.opt_state
    if len(opt_state["slots"]) != len(mine["slots"]):
        raise ValueError(f"{len(opt_state['slots'])} slot trees in JAX, "
                         f"{len(mine['slots'])} in the port")
    with torch.no_grad():
        for src, dst in zip(opt_state["slots"], mine["slots"]):
            if set(src) != set(dst):
                raise ValueError(f"slot nodes differ: {sorted(src)} vs "
                                 f"{sorted(dst)}")
            for a, t in zip(tree_leaves(src), tree_leaves(dst)):
                a = np.asarray(a)
                if a.shape != tuple(t.shape):
                    raise ValueError(f"slot shape {a.shape} != port's "
                                     f"{tuple(t.shape)}")
                t.copy_(torch.tensor(a, dtype=t.dtype))
        mine["step"].fill_(int(np.asarray(opt_state["step"])))
    return mine


#: the neuro3d training net of the bench (``scripts/bench_tpu_pending.py::
#: _neuro3d_model``, ``scripts/exp_train_largepatch.py::_model``)
NEURO3D_FILTERS = [(1, 3, 3), (1, 3, 3), (3, 3, 3), (3, 3, 3)]
NEURO3D_POOLS = [(1, 2, 2), (1, 2, 2), (1, 1, 1), (1, 1, 1)]
NEURO3D_WIDTHS = (20, 30, 40, 40)


def neuro3d_train_model(batch=4, patch=(15, 55, 55), widths=None,
                        device="cuda"):
    """The bench's training net (``_neuro3d_model`` of
    ``scripts/bench_tpu_pending.py`` and ``_model`` of
    ``scripts/exp_train_largepatch.py``, float32): convs (1,3,3), (1,3,3),
    (3,3,3), (3,3,3) at widths 20/30/40/40 with pools (1,2,2), (1,2,2), 1,
    1; a 1x1 ``cls`` conv to 2 classes; Softmax ``probs``;
    ``MultinoulliNLL(target_is_sparse=True)`` against the int32 ``target``
    -> ``AggregateLoss``; ``Adam(lr=1e-3)``. ``patch`` is the desired patch
    (the input is the nearest valid size, ``cnncalculator``); ``batch``
    sizes the inputs; ``widths`` narrows the four convs (tests). Weights
    come from ``model_manager.reset(seed=0)``'s generator."""
    from .. import neuromancer as nm
    from ..neuromancer.model import target_device
    from .cnncalculator import cnncalculator

    device = target_device(device)
    nof = tuple(widths or NEURO3D_WIDTHS)
    calc = cnncalculator(NEURO3D_FILTERS, NEURO3D_POOLS,
                         desired_patch_size=list(patch), mfp=False, ndim=3)
    z, x, y = calc.input
    nm.model_manager.reset(seed=0)
    inp = nm.Input([batch, 1, z, x, y], "b,f,z,x,y", name="raw")
    h = inp
    for i, (f, p, nf) in enumerate(zip(NEURO3D_FILTERS, NEURO3D_POOLS, nof)):
        h = nm.Conv(h, nf, f, p, name=f"conv{i}")
    out = nm.Conv(h, 2, 1, 1, activation_func="lin", name="cls")
    probs = nm.Softmax(out, name="probs")
    tgt = nm.Input([batch, *probs.shape.spatial_shape], "b,z,x,y",
                   dtype="int32", name="target")
    nll = nm.MultinoulliNLL(probs, tgt, target_is_sparse=True, name="nll")
    model = nm.model_manager.getmodel("bench_neuro3d")
    model.designate_nodes(input_node=inp, target_node=tgt,
                          loss_node=nm.AggregateLoss(nll),
                          prediction_node=probs)
    model.to(device)
    model.set_opt("Adam", lr=1e-3)
    return model


#: dropout of the BN training net: mlp_mnist's rate on the two (3,3,3) convs
NEURO3D_BN_DROPOUT = (0.0, 0.0, 0.1, 0.1)


def neuro3d_bn_train_model(batch=4, patch=(15, 55, 55), widths=None,
                           device="cuda"):
    """The bench's neuro3d training net with batch norm and dropout, built
    by ``simple_cnn``: the convs of :func:`neuro3d_train_model`
    (``NEURO3D_FILTERS``/``POOLS``/``WIDTHS``) each batch-normed between its
    pool and its ReLU, dropout :data:`NEURO3D_BN_DROPOUT` after the ReLU, a
    1x1 ``class`` conv to 2 classes, Softmax ``probs``, the sparse NLL's
    ``loss`` and ``Errors``; ``Adam(lr=1e-3)``. ``patch`` is the desired
    patch, ``widths`` narrows the convs (tests)."""
    from ..neuromancer.model import simple_cnn, target_device

    device = target_device(device)
    model = simple_cnn(batch, 1, 2, list(patch), NEURO3D_FILTERS,
                       NEURO3D_POOLS, list(widths or NEURO3D_WIDTHS),
                       dropout_rates=list(NEURO3D_BN_DROPOUT),
                       batch_normalisation=True)
    model.to(device)
    model.set_opt("Adam", lr=1e-3)
    return model


def flagship_model(mfp=True, patch=None, batch=1, extra_convs=0,
                   device="cuda"):
    """neuro3d-style 3D EM segmentation net (the flagship workload).

    conv0 (1,3,3) 1→20 + pool (1,2,2); conv1 (1,3,3) 20→30 + pool (1,2,2);
    conv2, conv3 (3,3,3) →40; a 1×1×1 ``barrier`` conv to 2 classes; Softmax;
    MultinoulliNLL + AggregateLoss. ``extra_convs`` appends (3,3,3) no-pool
    conv layers; ``batch`` sizes the designated input. Weights come from
    ``model_manager.reset(seed=0)``'s generator.
    """
    from .. import neuromancer as nm
    from ..neuromancer.model import target_device
    from .cnncalculator import cnncalculator

    device = target_device(device)
    filters = [(1, 3, 3), (1, 3, 3), (3, 3, 3), (3, 3, 3)] \
        + [(3, 3, 3)] * extra_convs
    pools = [(1, 2, 2), (1, 2, 2), (1, 1, 1), (1, 1, 1)] \
        + [(1, 1, 1)] * extra_convs
    nof = [20, 30, 40, 40] + [40] * extra_convs
    calc = cnncalculator(filters, pools,
                         desired_patch_size=list(patch or [15, 55, 55]),
                         mfp=mfp, ndim=3)
    z, x, y = calc.input
    nm.model_manager.reset(seed=0)
    inp = nm.Input([batch, 1, z, x, y], "b,f,z,x,y", name="raw")
    h = inp
    for i, (f, p, nf) in enumerate(zip(filters, pools, nof)):
        h = nm.Conv(h, nf, f, p, mfp=mfp, name=f"conv{i}")
    out = nm.Conv(h, 2, 1, 1, activation_func="lin", name="barrier")
    probs = nm.Softmax(out, name="probs")
    tgt = nm.Input([probs.shape["b"], *probs.shape.spatial_shape],
                   "b,z,x,y", dtype="int32", name="target")
    nll = nm.MultinoulliNLL(probs, tgt, target_is_sparse=True, name="nll")
    loss = nm.AggregateLoss(nll, name="loss")
    model = nm.model_manager.getmodel("flagship")
    model.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                          prediction_node=probs)
    return model.to(device)


def tracer_model(patch, enc_w=64, gru_w=64, batch=2, t=4, device="cuda",
                 prelu_w=0):
    """The recurrent tracing model of the tracing deployment, with the JAX
    package's node names: ``x_t`` (one step's patch) →
    ``Perceptron(enc_w, flatten=True)`` ``enc`` → ``GRU(gru_w)`` ``gru``
    seeded by ``InitialState_like`` ``h0``, iterated over the ``seq`` input
    by ``ScanN`` ``scan`` → ``Perceptron(3, 'lin')`` ``step``, with
    ``SquaredLoss`` + ``AggregateLoss`` against ``target``. ``batch`` and
    ``t`` size the designated inputs; a rollout runs any batch. Weights come
    from ``model_manager.reset()``'s generator. ``prelu_w`` > 0 puts a
    ``Perceptron(prelu_w, 'prelu')`` ``mid`` between the scan and the step
    head (the structure of the JAX test ``test_device_tracer_prelu_head``).
    """
    from .. import neuromancer as nm
    from ..neuromancer.model import target_device

    device = target_device(device)
    nm.model_manager.reset()
    seq = nm.Input([t, batch, 1, *patch], "s,b,f,z,x,y", name="seq")
    x_t = nm.Input([batch, 1, *patch], "b,f,z,x,y", name="x_t")
    enc = nm.Perceptron(x_t, enc_w, flatten=True, name="enc")
    h0 = nm.InitialState_like(enc, override_f=gru_w, name="h0")
    gru = nm.GRU(enc, h0, n_f=gru_w, name="gru")
    scan = nm.ScanN(gru, in_memory=h0, in_iterate=x_t, in_iterate_0=seq,
                    n_steps=t, name="scan")
    head = scan
    if prelu_w:
        head = nm.Perceptron(scan, prelu_w, activation_func="prelu",
                             name="mid")
    step_vec = nm.Perceptron(head, 3, activation_func="lin", name="step")
    tgt = nm.Input([t, batch, 3], "s,b,f", name="target")
    loss = nm.AggregateLoss(nm.SquaredLoss(step_vec, tgt), name="loss")
    model = nm.model_manager.getmodel("tracer_bench")
    model.designate_nodes(input_node=seq, target_node=tgt, loss_node=loss,
                          prediction_node=step_vec)
    return model.to(device)


#: ``examples/unet3d_wide.py``: design patch and encoder widths
WIDE_UNET_PATCH = (16, 64, 64)
WIDE_UNET_WIDTHS = (64, 128, 256)


def _unet_head(nm, name, inp, dec):
    """The U-Net examples' common tail: a 1x1 ``cls`` conv to 2 classes,
    Softmax ``probs``, NLL, loss and error rate against ``target``."""
    probs = nm.Softmax(nm.Conv(dec, 2, 1, 1, activation_func="lin",
                               name="cls"), name="probs")
    tgt = nm.Input([probs.shape["b"], *probs.shape.spatial_shape],
                   "b,z,x,y", dtype="int32", name="target")
    nll = nm.MultinoulliNLL(probs, tgt, target_is_sparse=True, name="nll")
    loss = nm.AggregateLoss(nll, name="loss")
    err = nm.Errors(probs, tgt, target_is_sparse=True)
    model = nm.model_manager.getmodel(name)
    model.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                          prediction_node=probs, error_node=err)
    return model


def wide_unet_model(batch=None, patch=None, widths=None, device="cuda"):
    """The width-realistic 3D U-Net of ``examples/unet3d_wide.py``.

    e0a (1,3,3) →w0; e0b (1,3,3) →w0 + pool (1,2,2); e1a (3,3,3) →w1; e1b
    (3,3,3) →w1 + pool (1,2,2); bott (3,3,3) →w2; u1 UpConv →w1 (ReLU); m1
    FaithlessMerge(u1, e1a); d1 (3,3,3) →w1; u0 UpConv →w0 (ReLU); m0
    FaithlessMerge(u0, e0a); d0 (1,3,3) →w0; ``cls`` 1x1 to 2 classes;
    Softmax. Widths (w0, w1, w2) default to (64, 128, 256), the patch to
    (16, 64, 64). Weights come from ``model_manager.reset()``'s generator.
    """
    from .. import neuromancer as nm
    from ..neuromancer.model import target_device

    device = target_device(device)
    p = tuple(patch or WIDE_UNET_PATCH)
    w0, w1, w2 = widths or WIDE_UNET_WIDTHS
    nm.model_manager.reset()
    inp = nm.Input([batch or 1, 1, *p], "b,f,z,x,y", name="raw")
    e0a = nm.Conv(inp, w0, (1, 3, 3), (1, 1, 1), name="e0a")
    e0b = nm.Conv(e0a, w0, (1, 3, 3), (1, 2, 2), name="e0b")
    e1a = nm.Conv(e0b, w1, (3, 3, 3), (1, 1, 1), name="e1a")
    e1b = nm.Conv(e1a, w1, (3, 3, 3), (1, 2, 2), name="e1b")
    bott = nm.Conv(e1b, w2, (3, 3, 3), (1, 1, 1), name="bott")
    u1 = nm.UpConv(bott, w1, (1, 2, 2), activation_func="relu", name="u1")
    m1 = nm.FaithlessMerge(u1, e1a, name="m1")
    d1 = nm.Conv(m1, w1, (3, 3, 3), (1, 1, 1), name="d1")
    u0 = nm.UpConv(d1, w0, (1, 2, 2), activation_func="relu", name="u0")
    m0 = nm.FaithlessMerge(u0, e0a, name="m0")
    d0 = nm.Conv(m0, w0, (1, 3, 3), (1, 1, 1), name="d0")
    return _unet_head(nm, "unet3d_wide", inp, d0).to(device)


def unet3d_model(device="cuda"):
    """The encoder/decoder example of ``examples/unet3d.py``: enc0 (1,3,3)
    →12; enc1 (3,3,3) →24 + pool (1,2,2); enc2 (3,3,3) →24; up UpConv →12
    (ReLU); merge FaithlessMerge(up, enc0); dec (1,3,3) →16; ``cls``;
    Softmax. Patch (16, 32, 32), batch 1."""
    from .. import neuromancer as nm
    from ..neuromancer.model import target_device

    device = target_device(device)
    nm.model_manager.reset()
    inp = nm.Input([1, 1, 16, 32, 32], "b,f,z,x,y", name="raw")
    enc0 = nm.Conv(inp, 12, (1, 3, 3), (1, 1, 1), name="enc0")
    enc1 = nm.Conv(enc0, 24, (3, 3, 3), (1, 2, 2), name="enc1")
    enc2 = nm.Conv(enc1, 24, (3, 3, 3), (1, 1, 1), name="enc2")
    up = nm.UpConv(enc2, 12, (1, 2, 2), activation_func="relu", name="up")
    merged = nm.FaithlessMerge(up, enc0, name="merge")
    dec = nm.Conv(merged, 16, (1, 3, 3), (1, 1, 1), name="dec")
    return _unet_head(nm, "unet3d", inp, dec).to(device)
