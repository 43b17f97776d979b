"""Combined data-parallel x spatial-context-parallel training.

Port of ``elektronn2_tpu/parallel/spatial_train.py`` on
``torch.distributed``. For volumes too large for one card at training time
the batch is split over a ``data`` mesh axis and the volume's z axis over a
``space`` axis; every valid conv with ``kz > 1`` fetches its z halo from
the next ranks through a differentiable exchange
(``parallel/halo.py::halo_gather_grad``: the gradient of a halo row goes
back to the rank that owns it), the per-voxel loss is masked to the
globally valid rows, and after ``torch.autograd.grad`` the gradients and
the loss are summed over both axes before the model's optimiser updates
every rank alike. With ``model_axis`` the weights are also split over a
``model`` axis (``parallel/tensor_parallel.py``), the three-axis
DP x SP x TP step.

Contract (checked): a 3-D conv graph whose loss is one ``AggregateLoss``
over one per-voxel loss map; no z pooling, no MFP, no ``FaithlessMerge``
whose parents differ in z, no explicit z ``Crop``, no batch norm. The
target is padded along z to the input's z extent
(:func:`pad_target_for_spatial`), so its blocks align with the input's
(the pad rows lie in the masked region). As for every sharded entry point
of the port, each rank is given the whole batch and keeps its (batch, z)
block; the result equals the unsharded step's.

Random draws (dropout, ``GaussianRV``) are made at the unsharded step's
shape from the step's generator and each rank keeps its block
(``TraceCtx.draw``), so they are the unsharded step's; the JAX package
folds the data and space indices into the key instead.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..log import logger
from ..ops.conv import f32_convs, f32_matmuls


def pad_target_for_spatial(target, input_z):
    """Pad a (b, z_out, x, y) target (an array or a tensor) along z with
    zeros to the input's z extent (the pad rows fall in the masked region).
    Reference: ``parallel/spatial_train.py::pad_target_for_spatial``."""
    pad = input_z - target.shape[1]
    if pad <= 0:
        return target
    if isinstance(target, torch.Tensor):
        return torch.cat([target, target.new_zeros(
            (target.shape[0], pad) + tuple(target.shape[2:]))], dim=1)
    return np.pad(np.asarray(target),
                  [(0, 0), (0, pad)] + [(0, 0)] * (target.ndim - 2))


def _check_graph(model):
    """The checks of the JAX package's ``_build_spatial_parts``, with its
    messages. Returns the loss map node."""
    from ..neuromancer.loss import AggregateLoss
    if not isinstance(model.loss_node, AggregateLoss) \
            or len(model.loss_node.parents) != 1:
        raise ValueError("spatial training requires AggregateLoss over one "
                         "per-voxel loss map")
    if len(model.input_node.shape.spatial_axes) != 3:
        raise ValueError("spatial training is for 3D models")
    for node in model.loss_node.all_parents():
        pool = getattr(node, "pool_shape", None)
        if pool is not None and pool[0] != 1:
            raise ValueError(f"node {node.name}: z-pooling is unsupported "
                             "under z-sharding")
        if getattr(node, "mfp", False):
            raise ValueError(f"node {node.name}: MFP training under "
                             "z-sharding is unsupported (train plain, "
                             "infer with predict_dense_sharded)")
        if type(node).__name__ == "FaithlessMerge":
            za = int(node.parents[0].shape.spatial_shape[0])
            zb = int(node.parents[1].shape.spatial_shape[0])
            if za != zb:
                # every halo-exchanged branch keeps z_local rows, so the
                # merge's centre crop would pair misaligned z rows
                raise ValueError(
                    f"node {node.name}: FaithlessMerge crops z (parent z "
                    f"extents {za} vs {zb}) — z-sharded training would "
                    "pair misaligned skip rows; train unsharded "
                    "(z-sharded SERVING of decoder graphs is supported: "
                    "predict_dense_sharded)")
        if type(node).__name__ == "Crop" \
                and tuple(node.crop[0]) != (0, 0):
            raise ValueError(
                f"node {node.name}: explicit z crop {node.crop[0]} is "
                "unsupported under z-sharding (per-rank crops remove "
                "z_local rows, not the global border)")
        if getattr(node, "batch_normalisation", False) \
                or type(node).__name__ == "BatchNorm":
            # the batch moments would include the last rank's zero-halo
            # rows (the mask protects the loss, not the moments)
            raise ValueError(f"node {node.name}: BatchNorm training "
                             "under z-sharding is unsupported (batch "
                             "stats would include invalid halo rows); "
                             "train unsharded or drop BN")
    return model.loss_node.parents[0]


class _SpatialStep:
    """The per-rank step shared by :func:`make_spatial_dp_trainstep` and
    :func:`make_fused_spatial_trainstep` (JAX ``_build_spatial_parts``)."""

    def __init__(self, model, mesh, data_axis, space_axis, model_axis):
        from .data_parallel import DataGroup
        from .halo import SpaceGroup
        from .tensor_parallel import ModelGroup, tp_dims
        if model.optimiser is None:
            raise ValueError("model needs an optimiser (set_opt) first")
        self.loss_map = _check_graph(model)
        self.model = model
        self.dp = DataGroup(mesh, data_axis)
        self.sp = SpaceGroup(mesh, space_axis)
        self.tp = (ModelGroup(mesh, model_axis) if model_axis is not None
                   else None)
        self.dims = ({} if self.tp is None else
                     tp_dims(model.nodes, self.tp.world))
        self.fov_z = int(model.prediction_node.shape.fov[0])
        # the global mean's denominator is static: batch x valid output z
        # x output x x output y
        shape = model.input_node.shape
        self.z_total = int(shape.spatial_shape[0])
        lmap_sp = self.loss_map.shape.spatial_shape
        self.count = float(shape["b"] * (self.z_total - (self.fov_z - 1))
                           * int(np.prod(lmap_sp[1:])))
        self.weight = float(model.loss_node.mixing_weights[0])
        self._mask = {}

    def key(self):
        """What a captured chunk depends on: the groups and the model's
        trace switches."""
        m = self.model
        return (self.dp.key(), self.sp.key(),
                self.tp.key() if self.tp is not None else None,
                m._compute_dtype, m._train_zfold, m._remat)

    def mask(self, z_loc, device):
        """1 on this rank's rows with global z < Z - (fov_z - 1), else 0,
        shaped to broadcast over a (b, z, x, y) map; made once."""
        key = (z_loc, device)
        if key not in self._mask:
            row = self.sp.rank * z_loc + torch.arange(z_loc, device=device)
            self._mask[key] = (row < self.z_total - (self.fov_z - 1)
                               ).float().reshape(1, -1, 1, 1)
        return self._mask[key]

    def _check_shards(self, params):
        for n, d in self.dims.items():
            for p, dim in d.items():
                whole = self.model.nodes[n].params[p].shape[dim]
                if params[n][p].shape[dim] != whole // self.tp.world:
                    raise ValueError(
                        f"param {n}/{p}: dim {dim} is {params[n][p].shape[dim]}"
                        f", this rank's shard has {whole // self.tp.world}: "
                        "pass the shards (tensor_parallel.shard_tree with "
                        "the dims of spatial_tp_shardings)")

    def __call__(self, params, opt_state, state, data, target, hyper, rng):
        """One step in place (see :func:`make_spatial_dp_trainstep`)."""
        from ..neuromancer.node_basic import TraceCtx
        from ..neuromancer.optimiser import tree_leaves
        m = self.model
        if self.tp is not None:
            self._check_shards(params)
        x = self.sp.block(self.dp.rows(data, 0), 2)
        t = self.sp.block(self.dp.rows(target, 0), 1)
        train = m._trainable(params)
        leaves = {n: {p: v.detach().requires_grad_() for p, v in d.items()}
                  for n, d in train.items()}
        merged = {n: {**d, **leaves.get(n, {})} for n, d in params.items()}
        names = [(n, p) for n in sorted(leaves) for p in sorted(leaves[n])]
        with f32_convs(), f32_matmuls():
            ctx = TraceCtx(merged, {m.input_node.name: x,
                                    m.target_node.name: t},
                           rng=rng, train=True, state_in=state)
            ctx.dp, ctx.halo_axis = self.dp, self.sp
            ctx.tp, ctx.tp_dims = self.tp, self.dims
            ctx.compute_dtype = m._trace_dtype()
            ctx.remat = m._remat
            ctx.convdense_zfold = m._train_zfold
            lmap = ctx.get(self.loss_map)          # (b_loc, z_loc, xo, yo)
            # the LOCAL masked sum over the static global count; the sums
            # over the axes come after the gradient
            loss = torch.sum(lmap * self.mask(lmap.shape[1], lmap.device)) \
                * (self.weight / self.count)
            gs = torch.autograd.grad(loss, [leaves[n][p] for n, p in names],
                                     allow_unused=True)
            grads = {}
            for (n, p), g in zip(names, gs):
                grads.setdefault(n, {})[p] = (torch.zeros_like(leaves[n][p])
                                              if g is None else g)
            flat = torch.cat([g.reshape(-1) for g in tree_leaves(grads)]
                             + [loss.detach().reshape(1)])
            for group in (self.dp.group, self.sp.group):
                dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            off = 0
            for n, p in names:
                g = grads[n][p]
                grads[n][p] = flat[off:off + g.numel()].view_as(g)
                off += g.numel()
            loss = flat[off]
            sumsq = (self.tp.sumsq(grads, self.dims) if self.tp is not None
                     else None)
            m.optimiser.update(train, grads, opt_state, hyper, m._lr_mults,
                               m._wd_mults, sumsq=sumsq)
        return loss, params, opt_state, state


def make_spatial_dp_trainstep(model, mesh, data_axis="data",
                              space_axis="space", model_axis=None):
    """Build a DP x SP training step.

    Returns ``step(params, opt_state, state, data, target, hyper, rng) ->
    (loss, params, opt_state, state)``. ``data``: the global (B, f, Z, X,
    Y) batch, B divisible by the data axis and Z by the space axis;
    ``target``: the global (B, Z, X_out, Y_out) int batch, z-padded
    (:func:`pad_target_for_spatial`); both on the model's device and alike
    on every rank. ``hyper``: ``model.optimiser.current_hyper(device)``;
    ``rng``: a ``torch.Generator`` on the device (or None without random
    nodes). ``params`` and ``opt_state`` are **updated in place** and
    returned (the JAX package donates them); ``state`` is returned as it
    came (batch norm is refused). The loss is the global batch's
    (a 0-d tensor, no host sync).

    ``model_axis`` (DP x SP x TP): ``params`` and ``opt_state`` are this
    rank's shards over that axis (``tensor_parallel.shard_tree`` with the
    dims of :func:`spatial_tp_shardings`), and the nodes with sharded
    weights compute their channel slices. Reference:
    ``parallel/spatial_train.py::make_spatial_dp_trainstep``.
    """
    step = _SpatialStep(model, mesh, data_axis, space_axis, model_axis)
    logger.info(f"spatial DP train step: mesh "
                f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}, "
                f"fov_z={step.fov_z}")
    return step


class _FusedSpatialChunk:
    """K spatial steps a call; on the card with NCCL one replay of a CUDA
    graph of them (see :func:`make_fused_spatial_trainstep`)."""

    def __init__(self, step, n_inner):
        self.step = step
        self.n_inner = n_inner
        self._graph = None
        self.capture_seconds = None

    def _steps(self, args, out, steps):
        params, opt_state, state, data_K, target_K, hyper, rng = args
        for k in range(steps):
            loss, *_ = self.step(params, opt_state, state, data_K[k],
                                 target_K[k], hyper, rng)
            out[k] = loss

    def _graphed(self, device):
        s = self.step
        groups = [s.dp.group, s.sp.group] + ([s.tp.group] if s.tp else [])
        return device.type == "cuda" and all(
            dist.get_backend(g) == "nccl" for g in groups)

    def _written(self, params, opt_state):
        from ..neuromancer.optimiser import opt_leaves, tree_leaves
        return (tree_leaves(self.step.model._trainable(params))
                + opt_leaves(opt_state))

    def _key(self, args, inputs):
        from ..neuromancer.optimiser import opt_leaves, tree_leaves
        params, opt_state, state, _, _, hyper, rng = args
        cudnn = torch.backends.cudnn
        read = (tree_leaves(params) + opt_leaves(opt_state)
                + tree_leaves(state))
        return (self.step.key(), bool(cudnn.deterministic),
                bool(cudnn.benchmark), id(rng),
                tuple(id(hyper[k]) for k in sorted(hyper)),
                tuple((id(t), t._version, t.data_ptr()) for t in read),
                tuple((tuple(t.shape), t.dtype) for t in inputs))

    def __call__(self, params, opt_state, state, data_K, target_K, hyper,
                 rng):
        device = data_K.device
        if data_K.shape[0] != self.n_inner or target_K.shape[0] != \
                self.n_inner:
            raise ValueError(f"data_K/target_K carry {data_K.shape[0]}/"
                             f"{target_K.shape[0]} steps, the chunk "
                             f"{self.n_inner}")
        if not self._graphed(device):
            out = torch.zeros(self.n_inner, device=device)
            self._steps((params, opt_state, state, data_K, target_K, hyper,
                         rng), out, self.n_inner)
            return out, params, opt_state, state
        with torch.cuda.device(device):
            return self._replay(params, opt_state, state, data_K, target_K,
                                hyper, rng)

    def _replay(self, params, opt_state, state, data_K, target_K, hyper,
                rng):
        g = self._graph
        args = (params, opt_state, state, data_K, target_K, hyper, rng)
        key = self._key(args, (data_K, target_K))
        if g is None or g["key"] != key:
            self._graph = None               # free the old graph's pool
            g = self._graph = self._capture(args)
        g["data"].copy_(data_K)
        g["target"].copy_(target_K)
        g["graph"].replay()
        for t in self._written(params, opt_state):
            torch.autograd.graph.increment_version(t)
        g["key"] = self._key(args, (data_K, target_K))
        return g["out"].clone(), params, opt_state, state

    def _capture(self, args):
        """One eager step on the capture stream first (it makes the
        communicators, cuDNN's and cuBLAS's workspaces), its changes put
        back; then the K steps captured, reading static batch buffers."""
        params, opt_state, state, data_K, target_K, hyper, rng = args
        dev = data_K.device
        data = data_K.clone()
        target = target_K.clone()
        out = torch.zeros(self.n_inner, device=dev)
        static = (params, opt_state, state, data, target, hyper, rng)
        written = self._written(params, opt_state)
        saved = [t.clone() for t in written]
        gen_state = rng.get_state() if rng is not None else None
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._steps(static, out, 1)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(written, saved):
                t.copy_(s)
        if rng is not None:
            rng.set_state(gen_state)
        del saved
        graph = torch.cuda.CUDAGraph()
        if rng is not None:
            graph.register_generator_state(rng)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=side):
            self._steps(static, out, self.n_inner)
        self.capture_seconds = time.perf_counter() - t0
        # "held" keeps what the graph reads alive, so the ids in its key
        # stay unique while it lives
        return {"graph": graph, "data": data, "target": target, "out": out,
                "key": None, "held": (params, opt_state, state, hyper, rng)}


def make_fused_spatial_trainstep(model, mesh, n_inner, data_axis="data",
                                 space_axis="space", model_axis=None):
    """K DP x SP steps a call (``make_spatial_dp_trainstep``'s, in order).

    Returns ``chunk(params, opt_state, state, data_K, target_K, hyper,
    rng) -> (losses (K,), params, opt_state, state)``. ``data_K``: (K, B,
    f, Z, X, Y); ``target_K``: (K, B, Z, X_out, Y_out) (z-padded, see
    :func:`pad_target_for_spatial`); ``rng`` draws for all K steps.

    On the card, when every group of the mesh is NCCL, the K steps are one
    CUDA graph, halo ``all_gather``\\ s and gradient all-reduces inside it,
    captured on the first call (after one eager step whose changes are put
    back) and replayed while :meth:`key` — the groups, the trace switches,
    cuDNN's flags, the generator and the hyperparameter tensors' identity,
    and the identity, ``_version`` and address of every parameter, slot
    and state tensor — stays; the batch is copied into static buffers
    before each replay, and the generator is registered with the graph.
    Elsewhere (the CPU, gloo) the steps run eagerly. ``params`` and
    ``opt_state`` are **updated in place** (the JAX package donates them);
    a replay bumps their versions. ``chunk.capture_seconds`` is the last
    capture's. Reference:
    ``parallel/spatial_train.py::make_fused_spatial_trainstep``.
    """
    K = int(n_inner)
    if K < 1:
        raise ValueError(f"n_inner must be >= 1, got {n_inner}")
    step = _SpatialStep(model, mesh, data_axis, space_axis, model_axis)
    logger.info(f"fused spatial DP train chunk: K={K}, mesh "
                f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}")
    return _FusedSpatialChunk(step, K)


def spatial_tp_shardings(model, mesh, model_axis):
    """(param dims, optimiser-state dims): trees congruent with
    ``model.params`` and ``model.opt_state`` whose leaves are the dim a
    leaf is split on over ``model_axis``, or None where it is replicated —
    the rule of ``Model.use_mesh(model_axis=...)``
    (``tensor_parallel.tp_dims``), computed without changing the model.
    Reference: ``parallel/spatial_train.py::spatial_tp_shardings``."""
    from .halo import axis_group
    from .tensor_parallel import tp_dims
    dims = tp_dims(model.nodes,
                   dist.get_world_size(axis_group(mesh, model_axis)))
    pdims = {n: {p: dims.get(n, {}).get(p) for p in d}
             for n, d in model.params.items()}
    odims = None
    if model.opt_state is not None:
        odims = {"step": None,
                 "slots": tuple({n: {p: dims.get(n, {}).get(p) for p in d}
                                 for n, d in sl.items()}
                                for sl in model.opt_state["slots"])}
    return pdims, odims


def conv_supports_halo(ctx):
    """True when the trace runs z-sharded (set by the spatial step)."""
    return getattr(ctx, "halo_axis", None) is not None
