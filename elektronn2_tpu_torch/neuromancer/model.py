"""Model — designated nodes, forward evaluation, dense inference, save/load.

Port of ``Model`` and ``modelload`` in ``elektronn2_tpu/neuromancer/model.py``
(reference: ``elektronn2/neuromancer/model.py``), for inference: node
designation, the forward ``_apply``, ``predict``, ``predict_dense_device``,
``set_dilated_impl`` and the npz ``save``/``modelload`` format.

PyTorch idiom: parameters are a ``{node: {name: tensor}}`` dict on one
device, moved explicitly with :meth:`Model.to`; calls that get data on
another device raise instead of moving it. Evaluation is eager, under
``torch.no_grad()``, with cuDNN's TF32 off (``ops.conv.f32_convs``).

Not in this slice (``NotImplementedError`` naming the ROADMAP.md item):
training (§1 item 6), compute dtypes other than float32, the host-tiled
``predict_dense`` and orbax checkpoints.
"""

from __future__ import annotations

import io
import json
import math

import numpy as np
import torch

from ..log import logger
from ..ops.conv import f32_convs
from .graphmanager import GraphManager
from .node_basic import TraceCtx


class Model:
    """A view over a node graph with its parameters.

    Usage (mirrors the reference):
        model = model_manager.getmodel()
        model.designate_nodes(input_node=inp, prediction_node=pred, ...)
        model.to("cuda")
        probs = model.predict(raw)
        dense = model.predict_dense_device(vol, pad_raw=True)
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
        self.state = {}                       # aux state (BN: not ported)
        self._dilated_impl = "direct"
        self._dilated_ptail = False

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
        """Move every parameter to ``device``; returns the model."""
        self.params = {n: {k: v.to(device) for k, v in d.items()}
                       for n, d in self.params.items()}
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
                "elektronn2_tpu_torch (XLA/TPU lowerings; ROADMAP.md §1, "
                "'Left out of the dense slice')")
        self._dilated_impl = impl
        self._dilated_ptail = bool(pallas_tail)
        return self

    def set_compute_dtype(self, dtype, activations=False):
        """Only float32 is ported (``None``/``'float32'``)."""
        if dtype not in (None, "float32"):
            raise NotImplementedError(
                f"set_compute_dtype({dtype!r}): bf16/fp16/int8 serving is not "
                "ported (ROADMAP.md §1, 'Left out of the dense slice')")
        if activations:
            raise NotImplementedError(
                "set_compute_dtype(activations=True) is not ported")
        return self

    def _apply(self, out_nodes, params, state, feed, rng, train):
        """Evaluate ``out_nodes`` eagerly; returns (outputs, state)."""
        if train:
            raise NotImplementedError(
                "training is not ported yet (ROADMAP.md §1 item 6)")
        ctx = TraceCtx(params, feed)
        with torch.no_grad(), f32_convs():
            outs = [ctx.get(n) for n in out_nodes]
        return outs, dict(state)

    def _feed(self, data, extra=None):
        if isinstance(data, dict):
            known = {self.input_node.name} | {n.name for n in self.extra_inputs}
            unknown = set(data) - known
            if unknown:
                raise KeyError(
                    f"unknown feed name(s) {sorted(unknown)}; this model's "
                    f"input names are {sorted(known)}")
            feed = dict(data)
        else:
            feed = {self.input_node.name: data}
        for node, val in zip(self.extra_inputs, extra or []):
            feed[node.name] = val
        for k, v in feed.items():
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(v)
            if not isinstance(v, torch.Tensor):
                raise TypeError(f"feed {k!r}: expected a tensor or ndarray, "
                                f"got {type(v).__name__}")
            self._check_device(v, f"feed {k!r}")
            feed[k] = v
        return feed

    # -------------------------------------------------------------- inference
    def predict(self, raw, extra=None):
        """Forward pass to the prediction node (eval mode, no stitching)."""
        outs, _ = self._apply([self.prediction_node], self.params, self.state,
                              self._feed(raw, extra=extra), None, train=False)
        return outs[0]

    def predict_dense(self, *args, **kwargs):
        raise NotImplementedError(
            "the host-tiled predict_dense is not ported yet (ROADMAP.md §1, "
            "'Left out of the dense slice'); use predict_dense_device")

    def predict_dense_device(self, vol, pad_raw=False, tile_batch=1):
        """Dense sweep of a device-resident volume: (f, Z, X, Y) float32
        tensor on the model's device in, dense map (f_out, Z', X', Y') out
        (with ``pad_raw``, the volume's own spatial shape)."""
        from .inference import predict_dense_device
        return predict_dense_device(self, vol, pad_raw=pad_raw,
                                    tile_batch=tile_batch)

    # ------------------------------------------------------------------ stats
    @property
    def param_count(self):
        return sum(math.prod(v.shape)
                   for nd in self.params.values() for v in nd.values())

    # ---------------------------------------------------------------- save/load
    def save(self, fname, backend="npz"):
        """Serialise spec + params as the JAX package's ``Model.save`` does
        (``backend='npz'``): one ``.npz`` with the JSON node spec
        (``__spec__``), its arg arrays and ``param/<node>/<name>``."""
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
        buf = io.BytesIO()
        np.savez_compressed(buf, **payload)
        with open(fname, "wb") as f:
            f.write(buf.getvalue())
        logger.info(f"saved model to {fname} ({self.param_count} params)")

    def set_params(self, params):
        """Replace the parameters; ``params`` is ``{node: {name: array}}``
        (tensors or ndarrays), converted to float32 tensors on the model's
        current device. Shapes must match the graph's."""
        dev = self.device
        new = {}
        for nname, d in params.items():
            new[nname] = {}
            for pname, v in d.items():
                t = torch.as_tensor(np.asarray(v, dtype=np.float32)
                                    if not isinstance(v, torch.Tensor) else v,
                                    dtype=torch.float32, device=dev)
                want = tuple(self.nodes[nname].params[pname].shape)
                if tuple(t.shape) != want:
                    raise ValueError(f"param {nname}/{pname}: shape "
                                     f"{tuple(t.shape)} != graph's {want}")
                new[nname][pname] = t
        self.params = new

    def __repr__(self):
        return (f"<Model {self.name!r}: {len(self.nodes)} nodes, "
                f"{self.param_count} params>")


def modelload(fname, override_mfp_to_active=False, imposed_patch_size=None,
              **kwargs):
    """Load a model file (the npz format of ``Model.save``, written by this
    package or by the JAX package) by replaying its node spec.

    Optimiser slots (``opt/…``, ``__opt__``) are training state and are not
    read. ``override_mfp_to_active`` / ``imposed_patch_size``
    (``rebuild_model``) and orbax checkpoint directories are not ported.
    """
    if override_mfp_to_active or imposed_patch_size is not None:
        raise NotImplementedError(
            "modelload: rebuild_model (override_mfp_to_active / "
            "imposed_patch_size) is not ported yet (ROADMAP.md §1 item 9)")
    with np.load(fname, allow_pickle=False) as z:
        spec = json.loads(bytes(z["__spec__"].tobytes()).decode())
        arg_arrays = {k: z[k] for k in z.files if k.startswith("__spec__/")}
        params, state = {}, {}
        for k in z.files:
            if k.startswith("param/"):
                _, nname, pname = k.split("/", 2)
                params.setdefault(nname, {})[pname] = z[k]
            elif k.startswith("state/"):
                _, nname, sname = k.split("/", 2)
                state.setdefault(nname, {})[sname] = torch.from_numpy(z[k])
    gm = GraphManager.replay(spec["nodes"], arg_arrays)
    gm.designations = spec.get("designations", {})
    model = Model(gm, name=spec.get("graph", "model"))
    d = gm.designations

    def pick(key):
        n = d.get(key)
        return gm.nodes[n] if n else None

    model.designate_nodes(
        input_node=pick("input_node"), target_node=pick("target_node"),
        loss_node=pick("loss_node"), prediction_node=pick("prediction_node"),
        prediction_ext_node=pick("prediction_ext_node"),
        error_node=pick("error_node"),
        debug_outputs=[gm.nodes[n] for n in d.get("debug_outputs", [])],
        extra_inputs=[gm.nodes[n] for n in d.get("extra_inputs", [])])
    model.set_params(params)
    model.state = state
    logger.info(f"loaded model from {fname}: {model!r}")
    return model
