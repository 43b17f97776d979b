"""Bridges from the JAX package: parameters and the flagship net.

``params_from_jax`` turns the JAX package's ``{node: {name: array}}``
parameters into the port's tensors. Conv weights are
``(Cout, Cin, kz, kx, ky)`` and biases ``(Cout,)`` in both packages, so for
the nodes of this slice the conversion is an exact copy.

``flagship_model`` is the port's counterpart of
``__graft_entry__._flagship_model``: the neuro3d-class net with the same
arguments, node names and geometry.
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


def flagship_model(mfp=True, patch=None, batch=1, extra_convs=0):
    """neuro3d-style 3D EM segmentation net (the flagship workload).

    conv0 (1,3,3) 1→20 + pool (1,2,2); conv1 (1,3,3) 20→30 + pool (1,2,2);
    conv2, conv3 (3,3,3) →40; a 1×1×1 ``barrier`` conv to 2 classes; Softmax;
    MultinoulliNLL + AggregateLoss. ``extra_convs`` appends (3,3,3) no-pool
    conv layers; ``batch`` sizes the designated input. Weights come from
    ``model_manager.reset(seed=0)``'s generator.
    """
    from .. import neuromancer as nm
    from .cnncalculator import cnncalculator

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
    return model
