"""Rank bodies of the sharded-serving tests (``test_torch_sharded.py``).

Scenarios for ``torch_dp_workers.run_ranks`` (``"torch_sharded_workers:
name"``): spawned processes joined into one ``gloo`` group, jax-free. Every
rank is given the whole input, as the port's sharded entry points require,
and returns what it computed; the parent compares the ranks with each
other, with the port's unsharded calls and with the JAX package.

The graph functions take the package's ``neuromancer`` module, so the parent
builds the same graph in both packages.
"""

import numpy as np
import torch
import torch.distributed as dist


# ---------------------------------------------------------------- graphs

def _model(nm, inp, pred):
    m = nm.model_manager.getmodel()
    m.designate_nodes(input_node=inp, prediction_node=pred)
    return m


def dense_net(nm):
    """tests/test_parallel.py::test_sharded_dilated_dense_equals_unsharded."""
    nm.model_manager.reset(seed=11)
    inp = nm.Input([1, 1, 11, 21, 21], "b,f,z,x,y", name="raw")
    c1 = nm.Conv(inp, 4, (3, 3, 3), (1, 2, 2), mfp=True, name="c1")
    c2 = nm.Conv(c1, 2, (3, 3, 3), (1, 2, 2), mfp=True, name="c2")
    return _model(nm, inp, nm.Softmax(c2))


def multihop_net(nm):
    """tests/test_parallel.py::test_sharded_dense_multihop_halo: c2 sits at
    z-dilation 2, so its halo is 4 rows."""
    nm.model_manager.reset(seed=11)
    inp = nm.Input([1, 1, 11, 13, 13], "b,f,z,x,y", name="raw")
    c1 = nm.Conv(inp, 3, (3, 3, 3), (2, 2, 2), mfp=True, name="c1")
    c2 = nm.Conv(c1, 2, (3, 3, 3), (1, 1, 1), mfp=True, name="c2")
    return _model(nm, inp, nm.Softmax(c2))


def ptail_net(nm):
    """tests/test_pallas_tailconv.py::test_sharded_dense_with_ptail_equals_
    unsharded: c1 pools, c2 is K1's."""
    nm.model_manager.reset(seed=11)
    inp = nm.Input([1, 1, 11, 21, 21], "b,f,z,x,y", name="raw")
    c1 = nm.Conv(inp, 4, (3, 3, 3), (1, 2, 2), mfp=True, name="c1")
    c2 = nm.Conv(c1, 4, (3, 3, 3), (1, 1, 1), mfp=True, name="c2")
    return _model(nm, inp, nm.Softmax(nm.Conv(c2, 2, 1, 1,
                                               activation_func="lin")))


def int8_net(nm, logits=False):
    """tests/test_inference_device.py::_int8_probe_model; with ``logits``
    its prediction is the map before the softmax."""
    nm.model_manager.reset(seed=11)
    inp = nm.Input([1, 1, 11, 21, 21], "b,f,z,x,y", name="raw")
    c1 = nm.Conv(inp, 6, (1, 3, 3), (1, 2, 2), mfp=True, name="c1")
    c2 = nm.Conv(c1, 8, 3, 2, mfp=True, name="c2")
    cls = nm.Conv(c2, 2, 1, 1, activation_func="lin", name="cls")
    return _model(nm, inp, cls if logits else nm.Softmax(cls))


def unet_net(nm):
    """tests/test_inference_device.py::faithless_unet3d (patch z 8, fov z
    5)."""
    nm.model_manager.reset(seed=11)
    inp = nm.Input([1, 1, 8, 16, 16], "b,f,z,x,y", name="raw")
    enc0 = nm.Conv(inp, 4, (1, 3, 3), (1, 1, 1), name="enc0")
    enc1 = nm.Conv(enc0, 8, (3, 3, 3), (1, 2, 2), name="enc1")
    enc2 = nm.Conv(enc1, 8, (3, 3, 3), (1, 1, 1), name="enc2")
    up = nm.UpConv(enc2, 4, (1, 2, 2), activation_func="relu", name="up")
    merged = nm.FaithlessMerge(up, enc0, name="merge")
    dec = nm.Conv(merged, 8, (1, 3, 3), (1, 1, 1), name="dec")
    return _model(nm, inp, nm.Softmax(nm.Conv(dec, 2, 1, 1,
                                              activation_func="lin",
                                              name="cls")))


def zpool_unet(nm):
    """A decoder that pools in z (M_z = 2): the sharded leg refuses it."""
    nm.model_manager.reset(seed=11)
    inp = nm.Input([1, 1, 12, 16, 16], "b,f,z,x,y", name="raw")
    e0 = nm.Conv(inp, 4, (1, 3, 3), (1, 1, 1), name="e0")
    e1 = nm.Conv(e0, 6, (3, 3, 3), (2, 2, 2), name="e1")
    up = nm.UpConv(e1, 4, (2, 2, 2), activation_func="relu", name="up")
    mg = nm.FaithlessMerge(up, e0, name="mg")
    return _model(nm, inp, nm.Softmax(nm.Conv(mg, 2, 1, 1,
                                              activation_func="lin")))


def knossos_net(nm, trainable=False):
    """tests/test_integration_extra.py's sweep net; with ``trainable`` a
    softmax NLL on it (tests/test_review_fixes.py:640)."""
    nm.model_manager.reset(seed=7)
    inp = nm.Input([1, 1, 9, 17, 17], "b,f,z,x,y", name="raw")
    c1 = nm.Conv(inp, 4, 3, 2, mfp=True, name="c1")
    probs = nm.Softmax(nm.Conv(c1, 2, 1, 1, activation_func="lin"))
    m = nm.model_manager.getmodel()
    if not trainable:
        m.designate_nodes(input_node=inp, prediction_node=probs)
        return m
    tgt = nm.Input([1, *probs.shape.spatial_shape], "b,z,x,y",
                   dtype="int32", name="target")
    loss = nm.AggregateLoss(nm.MultinoulliNLL(probs, tgt,
                                              target_is_sparse=True))
    m.designate_nodes(input_node=inp, target_node=tgt, loss_node=loss,
                      prediction_node=probs)
    return m


def ff_tracer(nm, patch=(5, 5, 5)):
    """A feedforward step predictor: patch -> 3-vector
    (tests/test_tracing.py::_ff_step_model's shape)."""
    nm.model_manager.reset(seed=3)
    inp = nm.Input([1, 1, *patch], "b,f,z,x,y", name="x")
    step = nm.Perceptron(inp, 3, activation_func="lin", flatten=True,
                         name="step")
    m = nm.model_manager.getmodel("ff_tracer")
    m.designate_nodes(input_node=inp, prediction_node=step)
    return m


def port_model(build, weights, **kw):
    import elektronn2_tpu_torch.neuromancer as tnm
    m = build(tnm, **kw)
    m.set_params(weights)
    return m


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _error(fn):
    """(type name, message) of what ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:                  # noqa: BLE001 — reported
        return type(e).__name__, str(e)
    return None


# ------------------------------------------------------------- scenarios

def space_cases(rank, w, inputs, kdirs):
    """Every case on a ``{"space": world}`` mesh (four ranks): the halo
    primitives, the dilated leg (float32, pad_raw, multi-hop, K1 per
    shard, int8 with dynamic scales, the adversarial scale), the conv-dense
    leg and its guards, ``sweep_knossos(mesh=...)``, fresh weights after
    trainingsteps, and ``trace_batch(mesh=...)``."""
    from elektronn2_tpu_torch.neuromancer.inference import \
        predict_dense_sharded_batch
    from elektronn2_tpu_torch.ops import tailconv
    from elektronn2_tpu_torch.parallel import (cp_conv_z, halo_gather,
                                               make_mesh, spatial_cp_stack)
    from elektronn2_tpu_torch.parallel.halo import shard
    world = dist.get_world_size()
    mesh = make_mesh({"space": world}, devices="cpu")
    group = mesh.get_group("space")
    out = {}

    # halo primitives
    layers = [{k: (_t(v) if isinstance(v, np.ndarray) else v)
               for k, v in layer.items()} for layer in inputs["layers"]]
    out["stack"] = _np(spatial_cp_stack(layers, mesh)(_t(inputs["stack_x"])))
    out["stack_bad_z"] = _error(lambda: spatial_cp_stack(layers, mesh)(
        torch.zeros(1, 1, 15, 10, 10)))
    out["stack_zpool"] = _error(lambda: spatial_cp_stack(
        [dict(layers[0], pool=(2, 2, 2))], mesh))
    rows = torch.arange(4 * world, dtype=torch.float32).reshape(
        1, 1, 4 * world, 1, 1)
    out["halo_rows"] = {h: _np(halo_gather(shard(rows, group, 2), h, group))
                        for h in (0, 2, 4, 9)}
    out["cp_conv"] = _np(cp_conv_z(shard(_t(inputs["stack_x"]), group, 2),
                                   layers[0]["w"], layers[0]["b"], group,
                                   "relu"))

    # the dilated leg, float32
    m = port_model(dense_net, w["dense"])
    out["dense"] = _np(m.predict_dense_sharded(_t(inputs["dense"]), mesh))
    out["dense_pad"] = _np(m.predict_dense_sharded(
        _t(inputs["dense_pad"]), mesh, pad_raw=True))
    m = port_model(multihop_net, w["multihop"])
    out["multihop"] = _np(m.predict_dense_sharded(_t(inputs["multihop"]),
                                                  mesh))

    # K1 per shard: its plain version on the CPU, called once per conv on
    # each rank's halo-extended block
    m = port_model(ptail_net, w["ptail"])
    m.set_dilated_impl("direct", zfold=True, pallas_tail=True)
    calls, k1 = [], tailconv.conv3x3_dilated

    def recorded(x, *a, **k):
        calls.append(tuple(x.shape))
        return k1(x, *a, **k)
    tailconv.conv3x3_dilated = recorded
    try:
        out["ptail"] = _np(m.predict_dense_sharded(_t(inputs["ptail"]),
                                                   mesh))
    finally:
        tailconv.conv3x3_dilated = k1
    out["ptail_calls"] = calls

    # int8: dynamic scales, masked and reduced over the axis
    m = port_model(int8_net, w["int8"])
    m.set_compute_dtype("int8")
    out["int8"] = _np(m.predict_dense_sharded(_t(inputs["int8"]), mesh,
                                              pad_raw=True))
    m = port_model(int8_net, w["int8"], logits=True)
    m.set_compute_dtype("int8")
    out["int8_logits"] = _np(m.predict_dense_sharded(_t(inputs["int8"]),
                                                     mesh, pad_raw=True))
    m = port_model(int8_net, w["int8_adv"], logits=True)
    m.set_compute_dtype("int8")
    out["int8_adv"] = [_np(m.predict_dense_sharded(_t(v), mesh, pad_raw=True))
                       for v in inputs["int8_adv"]]

    # the conv-dense leg and its guards
    m = port_model(unet_net, w["unet"])
    m.set_convdense_impl(upconv="d2s", zfold=True)
    out["unet"] = [_np(m.predict_dense_sharded_batch(_t(v), mesh,
                                                     batch_axis=None))
                   for v in inputs["unet"]]
    out["unet_pad"] = _np(m.predict_dense_sharded(_t(inputs["unet_pad"]),
                                                  mesh, pad_raw=True))
    out["guard_tiny"] = _error(lambda: m.predict_dense_sharded_batch(
        torch.zeros(1, 1, 12, 21, 23), mesh, batch_axis=None))
    m.set_compute_dtype("int8")
    out["guard_int8"] = _error(lambda: m.predict_dense_sharded_batch(
        torch.zeros(1, 1, 24, 21, 23), mesh, batch_axis=None))
    mz = port_model(zpool_unet, w["zpool"])
    out["guard_mz"] = _error(lambda: predict_dense_sharded_batch(
        mz, torch.zeros(1, 1, 24, 24, 24), mesh, batch_axis=None))

    # sweep_knossos under the mesh
    from elektronn2_tpu_torch.data.knossos_array import KnossosArray
    m = port_model(knossos_net, w["knossos"])
    out["sweep"] = m.sweep_knossos(KnossosArray(kdirs["sweep"], cube_edge=8),
                                   step=[12, 16, 16], mesh=mesh)
    logs = _capture_warnings(lambda: out.__setitem__(
        "sweep_sb2", m.sweep_knossos(KnossosArray(kdirs["sweep"],
                                                  cube_edge=8),
                                     step=[12, 16, 16], mesh=mesh,
                                     slab_batch=2)))
    out["sweep_sb2_warned"] = any("per-slab z-sharded" in r for r in logs)
    m = port_model(unet_net, w["unet"])
    m.set_convdense_impl(upconv="d2s", zfold=True)
    out["sweep_unet"] = m.sweep_knossos(inputs["unet_karr"],
                                        step=(12, 20, 22), mesh=mesh)

    # fresh weights after trainingsteps (every rank trains alike)
    m = port_model(knossos_net, w["fresh"], trainable=True)
    m.set_opt("Adam", lr=5e-2)
    vol = _t(inputs["fresh_vol"])
    a = m.predict_dense_sharded(vol, mesh)
    for _ in range(3):
        m.trainingstep(_t(inputs["fresh_x"]), _t(inputs["fresh_y"]))
    out["fresh"] = (_np(a), _np(m.predict_dense_sharded(vol, mesh)),
                    _np(m.predict_dense_device(vol)))

    # agents over a data axis of the same ranks
    from elektronn2_tpu_torch.data.tracing_utils import DeviceTracer
    tm = port_model(ff_tracer, w["tracer"])
    dt = DeviceTracer(tm, inputs["trace_vol"], max_steps=6)
    kz = inputs["trace_kzip"] + f".rank{rank}.k.zip"
    traces = dt.trace_batch(inputs["trace_seeds"], save_kzip=kz,
                            mesh=make_mesh({"data": world}, devices="cpu"))
    out["trace"] = [t.coords for t in traces]
    out["trace_kzip"] = kz
    return out


def _capture_warnings(fn):
    """The port logger's warning messages while ``fn()`` runs."""
    import logging
    from elektronn2_tpu_torch.log import logger
    msgs = []

    class H(logging.Handler):
        def emit(self, record):
            msgs.append(record.getMessage())
    h = H(level=logging.WARNING)
    logger.addHandler(h)
    try:
        fn()
    finally:
        logger.removeHandler(h)
    return msgs


def dp_sp_cases(rank, w, inputs, kdirs):
    """Every case on a ``{"data": 2, "space": 2}`` mesh (four ranks): the
    dilated leg in float32 and int8 and the conv-dense leg with the slab
    batch split over ``data``, and ``sweep_knossos(mesh=..., slab_batch=2)``
    (and its refusal of a slab batch the ``data`` axis does not divide)."""
    from elektronn2_tpu_torch.data.knossos_array import KnossosArray
    from elektronn2_tpu_torch.parallel import make_mesh
    mesh = make_mesh({"data": 2, "space": 2}, devices="cpu")
    out = {}
    m = port_model(dense_net, w["dense"])
    out["dense"] = _np(m.predict_dense_sharded_batch(_t(inputs["dense_b"]),
                                                     mesh))
    m = port_model(int8_net, w["int8"])
    m.set_compute_dtype("int8")
    out["int8"] = _np(m.predict_dense_sharded_batch(_t(inputs["int8_b"]),
                                                    mesh))
    m = port_model(int8_net, w["int8"], logits=True)
    m.set_compute_dtype("int8")
    out["int8_logits"] = _np(m.predict_dense_sharded_batch(
        _t(inputs["int8_b"]), mesh))
    m = port_model(unet_net, w["unet"])
    m.set_convdense_impl(upconv="d2s", zfold=True)
    out["unet"] = [_np(m.predict_dense_sharded_batch(_t(v), mesh))
                   for v in inputs["unet"]]
    out["guard_batch"] = _error(lambda: m.predict_dense_sharded_batch(
        torch.zeros(3, 1, 24, 21, 23), mesh))
    m = port_model(knossos_net, w["knossos"])
    out["sweep"] = m.sweep_knossos(KnossosArray(kdirs["sweep"], cube_edge=8),
                                   step=[12, 16, 16], mesh=mesh,
                                   slab_batch=2)
    out["sweep_sb3"] = _error(lambda: m.sweep_knossos(
        KnossosArray(kdirs["sweep"], cube_edge=8), step=[12, 16, 16],
        mesh=mesh, slab_batch=3))
    return out
