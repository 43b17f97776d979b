"""The system under test, built from a configuration's graph through the
port's own node API (``elektronn2_tpu_torch.neuromancer``), and its serving
lowerings set from a traffic mix's ``serving`` entry."""

import torch


def port_model(net, batch, patch, device, mfp=False, optimiser=None):
    """The configuration's net as a port ``Model`` with an input of
    ``batch`` x ``patch``, a sparse NLL loss against an int32 ``target``
    and the error rate as its error node (what each training step of the
    example jobs computes beside the loss), its parameters on ``device``.
    ``mfp`` builds the convs as max-fragment-pooling nodes (the dense
    graphs without an UpConv, whose design patch is MFP-valid);
    ``optimiser`` is ``{"name", **hyper}``."""
    from elektronn2_tpu_torch import neuromancer as nm

    nm.model_manager.reset(seed=0)
    made = {}
    for n in net.nodes:
        ps = [made[p["name"]] for p in net.parents(n)]
        op, name = n["op"], n["name"]
        if op == "input":
            node = nm.Input([batch, n["f"], *patch], "b,f,z,x,y", name=name)
        elif op == "conv":
            node = nm.Conv(ps[0], n["n_f"], tuple(n["filter"]),
                           tuple(n["pool"]), activation_func=n["act"],
                           mfp=mfp and n["act"] == "relu", name=name)
        elif op == "upconv":
            node = nm.UpConv(ps[0], n["n_f"], tuple(n["pool"]),
                             activation_func=n["act"], name=name)
        elif op == "merge":
            node = nm.FaithlessMerge(ps[0], ps[1], name=name)
        elif op == "softmax":
            node = nm.Softmax(ps[0], name=name)
        else:
            raise ValueError(f"unknown op {op!r}")
        made[name] = node
    probs = made[net.output["name"]]
    tgt = nm.Input([probs.shape["b"], *probs.shape.spatial_shape],
                   "b,z,x,y", dtype="int32", name="target")
    nll = nm.MultinoulliNLL(probs, tgt, target_is_sparse=True, name="nll")
    loss = nm.AggregateLoss(nll, name="loss")
    err = nm.Errors(probs, tgt, target_is_sparse=True, name="errors")
    model = nm.model_manager.getmodel(net.cfg["name"])
    model.designate_nodes(input_node=made[net.input["name"]],
                          target_node=tgt, loss_node=loss,
                          prediction_node=probs, error_node=err)
    model.to(torch.device(device))
    if optimiser is not None:
        hyper = dict(optimiser)
        model.set_opt(hyper.pop("name"), **hyper)
    return model


def apply_serving(model, serving):
    """``serving``: ``{"dilated_impl": {...}}`` and/or ``{"convdense_impl":
    {...}}``, the keyword arguments of the model's setters."""
    if "dilated_impl" in serving:
        model.set_dilated_impl(**serving["dilated_impl"])
    if "convdense_impl" in serving:
        model.set_convdense_impl(**serving["convdense_impl"])
