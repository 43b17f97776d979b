"""Shape bookkeeping for the graph layer.

Reference: ``elektronn2/neuromancer/graphutils.py::TaggedShape`` — a shape
whose axes carry semantic tags (``b`` batch, ``f`` feature, ``z``/``x``/``y``
spatial, ``s`` sequence/time, ``r`` recurrent-extra), plus per-spatial-axis
*strides*, *field of view* (fov) and *MFP fragment offsets*. This object is
propagated through every node and powers both ``cnncalculator``-style shape
math and dense-inference stitching.

Port: a copy of ``TaggedShape`` in ``elektronn2_tpu/neuromancer/graphutils.py``
(numpy only). Shapes are plain static Python data and TaggedShape is
immutable-ish (mutating helpers return updated copies). ``make_func``
gives an eager callable (PyTorch has no compile step to defer).
"""

from __future__ import annotations

import numpy as np

floatX = np.float32

SPATIAL_TAGS = ("z", "x", "y")
ALL_TAGS = ("b", "f", "s", "r", "z", "x", "y")


def as_floatX(x):
    """Cast array/scalar to the framework float dtype (float32)."""
    return np.asarray(x, dtype=floatX)


class TaggedShape:
    """A shape with per-axis tags and conv/pool geometry bookkeeping.

    Parameters
    ----------
    shape : sequence of int
        Axis sizes.
    tags : sequence of str or comma/space-free string
        One tag per axis, e.g. ``['b','f','z','x','y']`` or ``'b,f,z,x,y'``.
    strides : sequence of int, optional
        Cumulative output stride per *spatial* axis (in input-voxel units).
    fov : sequence of int, optional
        Field of view per spatial axis (odd for centred valid convs).
    mfp_offsets : array-like (n_frag, n_spatial), optional
        Input-space shift of each max-fragment-pooling fragment. ``[[0,..]]``
        when no MFP pooling has occurred.
    """

    def __init__(self, shape, tags, strides=None, fov=None, mfp_offsets=None):
        shape = tuple(int(s) for s in shape)
        if isinstance(tags, str):
            tags = tags.split(",") if "," in tags else list(tags)
        tags = tuple(str(t) for t in tags)
        if len(shape) != len(tags):
            raise ValueError(f"shape {shape} and tags {tags} length mismatch")
        for t in tags:
            if t not in ALL_TAGS:
                raise ValueError(f"unknown tag {t!r}; allowed: {ALL_TAGS}")
        if len(set(tags)) != len(tags):
            raise ValueError(f"duplicate tags in {tags}")
        self._shape = shape
        self._tags = tags
        nsp = len(self.spatial_axes)
        self._strides = tuple(int(s) for s in (strides if strides is not None
                                               else (1,) * nsp))
        self._fov = tuple(int(f) for f in (fov if fov is not None
                                           else (1,) * nsp))
        if len(self._strides) != nsp or len(self._fov) != nsp:
            raise ValueError("strides/fov must have one entry per spatial axis")
        if mfp_offsets is None:
            mfp_offsets = np.zeros((1, nsp), dtype=np.int64)
        mfp_offsets = np.asarray(mfp_offsets, dtype=np.int64)
        self._mfp_offsets = (mfp_offsets.reshape(-1, nsp) if nsp
                             else np.zeros((1, 0), dtype=np.int64))

    # -- basic protocol ----------------------------------------------------
    @property
    def shape(self):
        return self._shape

    @property
    def tags(self):
        return self._tags

    @property
    def ndim(self):
        return len(self._shape)

    def __len__(self):
        return len(self._shape)

    def __iter__(self):
        return iter(self._shape)

    def __getitem__(self, key):
        """Index by tag name (str) or positional index/slice."""
        if isinstance(key, str):
            return self._shape[self.tag2index(key)]
        return self._shape[key]

    def __eq__(self, other):
        if isinstance(other, TaggedShape):
            return (self._shape == other._shape and self._tags == other._tags)
        return tuple(self._shape) == tuple(other)

    def __repr__(self):
        ax = ",".join(f"{t}={s}" for t, s in zip(self._tags, self._shape))
        extra = ""
        if any(s != 1 for s in self._strides) or any(f != 1 for f in self._fov):
            extra = f"; strides={list(self._strides)}, fov={list(self._fov)}"
        if len(self._mfp_offsets) > 1:
            extra += f", n_frag={len(self._mfp_offsets)}"
        return f"<TaggedShape ({ax}){extra}>"

    # -- tag queries ---------------------------------------------------------
    def hastag(self, tag):
        return tag in self._tags

    def tag2index(self, tag):
        try:
            return self._tags.index(tag)
        except ValueError:
            raise KeyError(f"tag {tag!r} not in {self._tags}") from None

    @property
    def spatial_axes(self):
        """Positional indices of spatial axes, in tag order of appearance."""
        return tuple(i for i, t in enumerate(self._tags) if t in SPATIAL_TAGS)

    @property
    def spatial_tags(self):
        return tuple(t for t in self._tags if t in SPATIAL_TAGS)

    @property
    def spatial_shape(self):
        return tuple(self._shape[i] for i in self.spatial_axes)

    @property
    def spatial_size(self):
        return int(np.prod(self.spatial_shape)) if self.spatial_axes else 0

    @property
    def strides(self):
        return self._strides

    @property
    def fov(self):
        return self._fov

    @property
    def fov_all_offsets(self):
        """fov enlarged by the spread of MFP fragment offsets."""
        if len(self._mfp_offsets) <= 1:
            return self._fov
        spread = self._mfp_offsets.max(0) - self._mfp_offsets.min(0)
        return tuple(int(f + s) for f, s in zip(self._fov, spread))

    @property
    def offsets(self):
        """Left margin of the first output voxel centre, per spatial axis.

        For a valid-mode stack, output voxel ``i`` (of fragment ``k``) sits at
        input coordinate ``offsets + mfp_offsets[k] + i * strides``.
        """
        return tuple((f - 1) // 2 for f in self._fov)

    @property
    def mfp_offsets(self):
        return self._mfp_offsets

    @property
    def n_frag(self):
        return len(self._mfp_offsets)

    # -- functional updates ---------------------------------------------------
    def copy(self, shape=None, tags=None, strides=None, fov=None,
             mfp_offsets=None):
        return TaggedShape(
            self._shape if shape is None else shape,
            self._tags if tags is None else tags,
            self._strides if strides is None else strides,
            self._fov if fov is None else fov,
            self._mfp_offsets if mfp_offsets is None else mfp_offsets,
        )

    def updateshape(self, tag, size):
        """Return a copy with axis ``tag`` resized to ``size``."""
        i = self.tag2index(tag)
        shape = list(self._shape)
        shape[i] = int(size)
        return self.copy(shape=shape)

    def addaxis(self, position, size, tag):
        """Return a copy with a new axis inserted at ``position``."""
        if isinstance(position, str):
            position = self.tag2index(position)
        if position < 0:
            position = self.ndim + 1 + position
        shape = list(self._shape)
        tags = list(self._tags)
        shape.insert(position, int(size))
        tags.insert(position, tag)
        if tag in SPATIAL_TAGS:
            # new spatial axis: splice neutral geometry at its spatial rank
            sp_rank = sum(1 for t in tags[:position] if t in SPATIAL_TAGS)
            strides = list(self._strides)
            fov = list(self._fov)
            strides.insert(sp_rank, 1)
            fov.insert(sp_rank, 1)
            off = np.insert(self._mfp_offsets, sp_rank, 0, axis=1)
            return TaggedShape(shape, tags, strides, fov, off)
        return TaggedShape(shape, tags, self._strides, self._fov,
                           self._mfp_offsets)

    def delaxis(self, position):
        """Return a copy with axis ``position`` (index or tag) removed."""
        if isinstance(position, str):
            position = self.tag2index(position)
        if position < 0:
            position = self.ndim + position
        tag = self._tags[position]
        shape = [s for i, s in enumerate(self._shape) if i != position]
        tags = [t for i, t in enumerate(self._tags) if i != position]
        if tag in SPATIAL_TAGS:
            sp_rank = sum(1 for t in self._tags[:position] if t in SPATIAL_TAGS)
            strides = [s for i, s in enumerate(self._strides) if i != sp_rank]
            fov = [f for i, f in enumerate(self._fov) if i != sp_rank]
            off = np.delete(self._mfp_offsets, sp_rank, axis=1)
            return TaggedShape(shape, tags, strides, fov, off)
        return TaggedShape(shape, tags, self._strides, self._fov,
                           self._mfp_offsets)

    # -- serialisation ---------------------------------------------------------
    def to_dict(self):
        return {
            "shape": list(self._shape),
            "tags": list(self._tags),
            "strides": list(self._strides),
            "fov": list(self._fov),
            "mfp_offsets": self._mfp_offsets.tolist(),
        }

    @classmethod
    def from_dict(cls, d):
        return cls(d["shape"], d["tags"], d.get("strides"), d.get("fov"),
                   d.get("mfp_offsets"))


def make_func(inputs, outputs, name="func", profile_execution=False,
              train=False, device=None):
    """A callable evaluating ``outputs`` (a Node or a list) from fed
    ``inputs`` (the same), eagerly on ``device``.

    Reference: ``graphutils.py::make_func``. The parameters are the
    ancestor nodes' registered initial values, moved to ``device`` (the
    card unless the CPU is asked for) once; ``f(*arrays, params=None)``
    takes tensors or arrays (moved to the device) and a ``params`` tree
    (``{node: {name: tensor}}``, e.g. a Model's) to evaluate with instead.
    With ``profile_execution`` the seconds of each call (CUDA events on the
    card, the host clock on the CPU) are appended to ``f.exec_times``.
    """
    import time

    import torch

    from ..ops.conv import f32_convs, f32_matmuls
    from .model import target_device
    from .node_basic import Node, TraceCtx

    dev = target_device(device or "cuda")
    single = isinstance(outputs, Node)
    outs = [outputs] if single else list(outputs)
    ins = [inputs] if isinstance(inputs, Node) else list(inputs)
    for n in ins + outs:
        if not isinstance(n, Node):
            raise TypeError(f"make_func takes Nodes, got {n!r}")
    seen, order = set(), []
    for o in outs:
        for n in o.all_parents():
            if n.name not in seen:
                seen.add(n.name)
                order.append(n)
    missing = [n.name for n in ins if n.name not in seen]
    if missing:
        raise ValueError(f"inputs {missing} are not ancestors of the "
                         "requested outputs")
    init_params = {n.name: {k: v.to(dev) for k, v in n.params.items()}
                   for n in order if n.params}

    def f(*arrays, params=None):
        if len(arrays) != len(ins):
            raise TypeError(f"{name} expects {len(ins)} input(s) "
                            f"({[n.name for n in ins]}), got {len(arrays)}")
        feed = {n.name: torch.as_tensor(a).to(dev)
                for n, a in zip(ins, arrays)}
        cuda = profile_execution and dev.type == "cuda"
        if cuda:
            t0, t1 = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            t0.record()
        elif profile_execution:
            t0 = time.perf_counter()
        ctx = TraceCtx(init_params if params is None else params, feed,
                       train=train)
        with torch.no_grad(), f32_convs(), f32_matmuls():
            vals = [ctx.get(o) for o in outs]
        if cuda:
            t1.record()
            t1.synchronize()
            f.exec_times.append(t0.elapsed_time(t1) / 1e3)
        elif profile_execution:
            f.exec_times.append(time.perf_counter() - t0)
        return vals[0] if single else tuple(vals)

    f.__name__ = name
    f.exec_times = []
    f.input_nodes = ins
    f.output_nodes = outs
    return f
