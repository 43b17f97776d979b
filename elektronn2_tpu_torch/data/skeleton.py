"""Neurite skeletons, traces of the tracing agent and their KNOSSOS export.

Jax-free copy of ``Trace``, ``SkeletonMFK``, ``_parse_nml``, ``_build_nml``,
``_write_nml_file``, ``trace_to_kzip``, ``sample_tracing_batch`` and
``skeleton_distance_field`` in ``elektronn2_tpu/data/skeleton.py``
(reference: ``elektronn2/data/skeleton.py``), plus :func:`read_nml_file`,
the reading half of ``SkeletonMFK.load`` for NML and k.zip files, and the
skeleton loss helpers of the ``SkelLoss`` node (``skel_loss_callback``,
``register_skeleton``, ``clear_skeleton_registry``).
"""

from __future__ import annotations

import os
import zipfile
import xml.etree.ElementTree as ET

import numpy as np
import torch

from ..utils.basic import AccumulationArray, DynamicKDT


class Trace:
    """A recorded flight path of the tracing agent.

    Reference: ``skeleton.py::Trace``: positions (z, x, y) and direction
    statistics.
    """

    def __init__(self, positions=None):
        self.positions = AccumulationArray(right_shape=(3,),
                                           dtype=np.float64)
        if positions is not None:
            self.positions.extend(np.asarray(positions, np.float64))

    def append(self, position):
        self.positions.append(np.asarray(position, np.float64))

    @property
    def coords(self):
        return self.positions.data

    def avg_dir(self, n_last=5):
        c = self.coords
        if len(c) < 2:
            return np.array([0.0, 0.0, 1.0])
        seg = c[-1] - c[max(0, len(c) - n_last)]
        n = np.linalg.norm(seg)
        return seg / n if n > 0 else np.array([0.0, 0.0, 1.0])

    def tortuosity(self, n_last=None):
        c = self.coords if n_last is None else self.coords[-n_last:]
        if len(c) < 3:
            return 1.0
        path = np.linalg.norm(np.diff(c, axis=0), axis=1).sum()
        chord = np.linalg.norm(c[-1] - c[0])
        return float(path / max(chord, 1e-9))

    def __len__(self):
        return len(self.positions)


def _parse_nml(data):
    """Parse KNOSSOS NML XML → (nodes {id: (z,x,y)}, edges [(a,b)], radii)."""
    root = ET.fromstring(data)
    nodes, edges, radii = {}, [], {}
    for thing in root.iter("thing"):
        for node in thing.iter("node"):
            nid = int(node.get("id"))
            # NML stores x, y, z; framework order is (z, x, y)
            nodes[nid] = (float(node.get("z")), float(node.get("x")),
                          float(node.get("y")))
            radii[nid] = float(node.get("radius", 1.0))
        for edge in thing.iter("edge"):
            edges.append((int(edge.get("source")), int(edge.get("target"))))
    return nodes, edges, radii


def read_nml_file(fname):
    """Read an ``.nml`` file, or the first ``.nml``/``.xml`` member of a
    ``.k.zip``/``.zip`` (KNOSSOS stores ``annotation.xml``), and parse it
    with :func:`_parse_nml`. Reference: ``SkeletonMFK.load``."""
    fname = os.fspath(fname)
    if fname.endswith((".k.zip", ".zip")):
        with zipfile.ZipFile(fname) as zf:
            names = [n for n in zf.namelist() if n.endswith((".nml", ".xml"))]
            if not names:
                raise ValueError(
                    f"{fname}: no .nml/.xml skeleton file inside the zip "
                    f"(members: {zf.namelist()[:5]}...)")
            data = zf.read(names[0])
    else:
        with open(fname, "rb") as f:
            data = f.read()
    return _parse_nml(data)


def _build_nml(things, scale=(1.0, 1.0, 1.0), experiment="elektronn2_tpu"):
    """Serialise skeleton graphs to KNOSSOS NML XML (the inverse of
    ``_parse_nml``). ``things``: list of ``(positions (n,3) zxy, edges
    (m,2) 0-based, radii (n,)|None, comment|None)``. Node ids are global
    across things (KNOSSOS requires uniqueness file-wide); float coordinates
    are written with ``repr`` so a load of the file gives them back exactly.
    """
    root = ET.Element("things")
    params = ET.SubElement(root, "parameters")
    ET.SubElement(params, "experiment", name=str(experiment))
    ET.SubElement(params, "scale", x=repr(float(scale[1])),
                  y=repr(float(scale[2])), z=repr(float(scale[0])))
    next_id = 1
    for t_id, (pos, edges, radii, comment) in enumerate(things, start=1):
        pos = np.asarray(pos, np.float64).reshape(-1, 3)
        attrs = {"id": str(t_id)}
        if comment is not None:     # '' is a valid (empty) comment
            attrs["comment"] = str(comment)
        thing = ET.SubElement(root, "thing", **attrs)
        nodes_el = ET.SubElement(thing, "nodes")
        base = next_id
        for i, p in enumerate(pos):
            r = 1.0 if radii is None else float(radii[i])
            # framework order (z, x, y) → NML stores x, y, z
            ET.SubElement(nodes_el, "node", id=str(base + i),
                          radius=repr(r), x=repr(float(p[1])),
                          y=repr(float(p[2])), z=repr(float(p[0])),
                          inVp="0", inMag="1", time="0")
        next_id = base + len(pos)
        edges_el = ET.SubElement(thing, "edges")
        for a, b in np.asarray(edges, np.int64).reshape(-1, 2):
            ET.SubElement(edges_el, "edge", source=str(base + int(a)),
                          target=str(base + int(b)))
    ET.SubElement(root, "comments")
    ET.SubElement(root, "branchpoints")
    ET.indent(root)
    return ET.tostring(root, encoding="utf-8", xml_declaration=True)


def _write_nml_file(fname, things, scale=(1.0, 1.0, 1.0),
                    experiment="elektronn2_tpu", force_zip=False):
    """Write NML: bare ``.nml``, or zipped as ``annotation.xml`` inside a
    ``.k.zip``/``.zip`` (the member name KNOSSOS writes and expects)."""
    fname = os.fspath(fname)
    data = _build_nml(things, scale=scale, experiment=experiment)
    if force_zip or fname.endswith((".k.zip", ".zip")):
        with zipfile.ZipFile(fname, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("annotation.xml", data)
    else:
        with open(fname, "wb") as f:
            f.write(data)
    return fname


def trace_to_kzip(traces, fname, scale=(1.0, 1.0, 1.0),
                  experiment="elektronn2_tpu", comments=None):
    """Export tracing results as a KNOSSOS-loadable annotation.

    ``traces``: ``Trace`` objects (or bare (n,3) coordinate arrays, z,x,y
    order). Each trace becomes one ``thing`` whose nodes are chained by
    consecutive edges. A missing or ``None`` comment falls back to
    ``trace_<i>``; an explicit ``''`` is kept. Reference:
    ``skeleton.py::trace_to_kzip``.
    """
    things = []
    for i, tr in enumerate(traces):
        coords = tr.coords if isinstance(tr, Trace) else \
            np.asarray(tr, np.float64).reshape(-1, 3)
        n = len(coords)
        edges = np.stack([np.arange(n - 1), np.arange(1, n)], 1) \
            if n > 1 else np.zeros((0, 2), np.int64)
        comment = (comments[i]
                   if comments is not None and i < len(comments)
                   and comments[i] is not None
                   else f"trace_{i}")
        things.append((coords, edges, None, comment))
    return _write_nml_file(fname, things, scale=scale,
                           experiment=experiment)


class SkeletonMFK:
    """A neurite skeleton graph with tracing geometry.

    Reference: ``skeleton.py::SkeletonMFK``. Holds node positions (z, x, y),
    edges and radii; provides KD-tree queries, flight-path sampling and
    next-step direction targets.
    """

    def __init__(self, positions, edges, radii=None):
        self.positions = np.asarray(positions, np.float64).reshape(-1, 3)
        self.edges = np.asarray(edges, np.int64).reshape(-1, 2)
        self.radii = (np.asarray(radii, np.float64)
                      if radii is not None
                      else np.ones(len(self.positions)))
        self._adj = [[] for _ in range(len(self.positions))]
        for a, b in self.edges:
            self._adj[a].append(b)
            self._adj[b].append(a)
        self._kdt = DynamicKDT(self.positions)

    # ------------------------------------------------------------- loading
    @classmethod
    def load(cls, fname):
        """Load from .nml, .k.zip (``annotation.xml`` or ``.nml`` inside) or
        .npz (positions/edges arrays)."""
        fname = os.fspath(fname)
        if fname.endswith(".npz"):
            z = np.load(fname)
            return cls(z["positions"], z["edges"],
                       z["radii"] if "radii" in z.files else None)
        nodes, edges, radii = read_nml_file(fname)
        ids = sorted(nodes)
        remap = {nid: i for i, nid in enumerate(ids)}
        pos = np.array([nodes[i] for i in ids])
        e = np.array([(remap[a], remap[b]) for a, b in edges
                      if a in remap and b in remap])
        r = np.array([radii[i] for i in ids])
        return cls(pos, e, r)

    def save(self, fname, scale=(1.0, 1.0, 1.0)):
        """Save as .npz (arrays), .nml (KNOSSOS XML), or .k.zip/.zip
        (zipped NML), picked from the extension. Returns the path written
        (np.savez appends .npz when it is missing)."""
        fname = os.fspath(fname)
        if fname.endswith((".nml", ".k.zip", ".zip")):
            return _write_nml_file(
                fname, [(self.positions, self.edges, self.radii, None)],
                scale=scale)
        np.savez(fname, positions=self.positions, edges=self.edges,
                 radii=self.radii)
        return fname if fname.endswith(".npz") else fname + ".npz"

    def to_kzip(self, fname, scale=(1.0, 1.0, 1.0)):
        """Explicit KNOSSOS export (k.zip), regardless of extension."""
        return _write_nml_file(
            fname, [(self.positions, self.edges, self.radii, None)],
            scale=scale, force_zip=True)

    # ------------------------------------------------------------- queries
    def get_closest_node(self, position):
        dist, pts, idx = self._kdt.get_knn(np.asarray(position,
                                                      np.float64), k=1)
        return int(idx), float(dist)

    def distance_to_skeleton(self, positions):
        """Distance of arbitrary points to the nearest skeleton node."""
        d, _, _ = self._kdt.get_knn(np.asarray(positions, np.float64), k=1)
        return np.atleast_1d(d)

    # ------------------------------------------------------ flight sampling
    def sample_node(self, rng):
        return int(rng.randint(len(self.positions)))

    def walk(self, start, n_steps, rng, avoid_backtrack=True):
        """Random walk along edges: list of node indices (may repeat at
        dead ends)."""
        path = [start]
        prev = -1
        cur = start
        for _ in range(n_steps):
            nbrs = self._adj[cur]
            if not nbrs:
                path.append(cur)
                continue
            cand = [n for n in nbrs if n != prev] or nbrs
            nxt = cand[rng.randint(len(cand))]
            path.append(nxt)
            prev, cur = cur, nxt
        return path

    def direction_target(self, position, lookahead=2, heading=None):
        """Unit direction from ``position`` toward the skeleton, then along
        it: the tracing training target. ``heading`` (the agent's flight
        direction) picks the continuation aligned with it; without one the
        walk takes the neighbour farthest from ``position``. The walk never
        steps back to the node it came from."""
        position = np.asarray(position, np.float64)
        idx, dist = self.get_closest_node(position)
        target_node = idx
        prev = None
        for _ in range(lookahead):
            nbrs = [n for n in self._adj[target_node] if n != prev]
            if not nbrs:
                break
            if heading is not None:
                h = np.asarray(heading, np.float64)
                nxt = max(nbrs, key=lambda n: float(
                    (self.positions[n] - position) @ h))
            else:
                nxt = max(nbrs, key=lambda n: np.linalg.norm(
                    self.positions[n] - position))
            prev, target_node = target_node, nxt
        vec = self.positions[target_node] - position
        n = np.linalg.norm(vec)
        return vec / n if n > 0 else np.array([0.0, 0.0, 1.0])

    def local_frame(self, node_idx):
        """Orthonormal frame at a node: (tangent, normal1, normal2)."""
        from .transformations import flight_frame
        nbrs = self._adj[node_idx]
        if nbrs:
            t = self.positions[nbrs[0]] - self.positions[node_idx]
        else:
            t = np.array([0.0, 0.0, 1.0])
        return flight_frame(t)

    def __repr__(self):
        return (f"<SkeletonMFK {len(self.positions)} nodes, "
                f"{len(self.edges)} edges>")


def _skel_loss_host(skeletons, landing, skel_ids):
    """Squared distance of each landing point to the nearest node of its
    skeleton, and its gradient in the point, on the host (float64 query,
    float32 results)."""
    landing = np.asarray(landing, np.float64)
    out_d = np.zeros(len(landing), np.float32)
    out_g = np.zeros((len(landing), 3), np.float32)
    for i, (p, sid) in enumerate(zip(landing, skel_ids)):
        sk = skeletons[int(sid)]
        idx, dist = sk.get_closest_node(p)
        out_d[i] = dist ** 2
        out_g[i] = 2.0 * (p - sk.positions[idx])
    return out_d, out_g


class _SkelLoss(torch.autograd.Function):
    """The host KD-tree query as an autograd function: forward copies the
    landing points to the host and the distances back; backward scales the
    saved host gradient (the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, pred, skel_feed, skeletons):
        landing = (skel_feed[:, 1:4] + pred).detach().cpu().numpy()
        ids = skel_feed[:, 0].detach().cpu().numpy().astype(np.int32)
        d, g = _skel_loss_host(skeletons, landing, ids)
        ctx.save_for_backward(torch.from_numpy(g).to(pred.device))
        return torch.from_numpy(d).to(pred.device)

    @staticmethod
    def backward(ctx, ct):
        (g,) = ctx.saved_tensors
        return ct[:, None] * g, None, None


def skel_loss_callback(pred, skel_feed, positions=None, skeletons=None):
    """Differentiable skeleton distance loss: ``pred`` (b, 3) step vectors,
    ``skel_feed`` (b, 4) rows of [skel_id, z, x, y] positions; per sample
    the squared distance of position + step to the nearest node of the
    skeleton (by default from the registry, :func:`register_skeleton`).
    The query runs on the host, so a call syncs it. Reference:
    ``skeleton.py::skel_loss_callback``."""
    if skeletons is None:
        skeletons = _SKELETON_REGISTRY
    return _SkelLoss.apply(pred, skel_feed, skeletons)


#: registry of the skeletons ``SkelLoss`` nodes refer to by integer id
#: (node specs stay JSON-serialisable)
_SKELETON_REGISTRY = []


def register_skeleton(sk):
    """Add ``sk`` to the registry; returns its id."""
    _SKELETON_REGISTRY.append(sk)
    return len(_SKELETON_REGISTRY) - 1


def clear_skeleton_registry():
    _SKELETON_REGISTRY.clear()


def sample_tracing_batch(agent_data, batch_size, n_steps, rng,
                         source="train"):
    """(patch sequences, direction targets) for ``TracingTrainer``:
    ``(n_steps, b, f, *patch)`` float32 views and ``(n_steps, b, 3)``
    targets, for ``ScanN``.

    For each sample: pick a skeleton and walk it; at each step cut the image
    patch at the current position (``warp_slice``) and compute the direction
    target along the walk's next hop. With ``agent_data.rotate_to_heading``
    the view is cut in the flight frame of the previous hop
    (``get_tracing_slice``) and the target is expressed in that frame.
    ``source='valid'`` cuts from the held-out cubes. Skeletons pair with
    cubes through ``agent_data.skeleton_cube`` (original-order cube
    indices), by position when the counts match, or trivially with one
    cube; anything else raises. Reference: ``skeleton.py::
    sample_tracing_batch``, whose draws from ``rng`` this repeats exactly.
    """
    from .transformations import (WarpingOOBError, flight_frame,
                                  get_tracing_slice, warp_slice)
    rotate = bool(getattr(agent_data, "rotate_to_heading", False))
    if not agent_data.skeletons:
        raise ValueError("AgentData has no skeletons loaded")
    if source == "valid":
        vols = agent_data.valid_d
        if not vols:
            raise ValueError("no validation cubes configured")
    else:
        vols = agent_data.train_d
    ps = agent_data.patch_size
    seq_d = np.zeros((n_steps, batch_size, agent_data.n_ch, *ps), np.float32)
    seq_t = np.zeros((n_steps, batch_size, 3), np.float32)
    cubes = getattr(agent_data, "skeleton_cube", None)
    n_sk = len(agent_data.skeletons)
    eligible = None
    orig2local = None
    if cubes is not None:
        # skeleton_cube holds original-order indices: map them into this
        # source's split and draw only skeletons of its cubes
        vset = sorted(set(getattr(agent_data, "valid_cubes", []) or []))
        if source == "valid":
            orig2local = {orig: k for k, orig in enumerate(vset)}
        else:
            orig2local = {}
            k = 0
            n_orig = len(vols) + len(vset)
            for orig in range(n_orig):
                if orig not in vset:
                    orig2local[orig] = k
                    k += 1
        eligible = [j for j in range(n_sk)
                    if int(cubes[j]) in orig2local]
        if not eligible:
            raise ValueError(
                f"no skeletons annotate a {source} cube "
                f"(skeleton_cube={list(map(int, cubes))}, "
                f"valid_cubes={vset})")
    for b in range(batch_size):
        if eligible is not None:
            j = eligible[rng.randint(len(eligible))]
            sk = agent_data.skeletons[j]
            ci = orig2local[int(cubes[j])]
        else:
            j = rng.randint(n_sk)
            sk = agent_data.skeletons[j]
            if len(vols) == 1:
                ci = 0
            elif len(vols) == n_sk:
                ci = j
            else:
                raise ValueError(
                    f"cannot pair {n_sk} skeletons with {len(vols)} "
                    f"{source} cubes — pass AgentData(skeleton_cube=[...])"
                    f" with one ORIGINAL-order cube index per skeleton")
        vol = vols[ci]
        path = sk.walk(sk.sample_node(rng), n_steps, rng)
        prev_head = None
        for t in range(n_steps):
            pos = sk.positions[path[t]]
            pos = np.clip(pos, np.asarray(ps) / 2 + 1,
                          np.asarray(vol.shape[1:]) - np.asarray(ps) / 2 - 1)
            # the target follows the flight direction (the walk's next hop)
            nxt = sk.positions[path[min(t + 1, len(path) - 1)]]
            head = nxt - sk.positions[path[t]]
            if np.linalg.norm(head) == 0:
                head = None
            tgt = sk.direction_target(pos, heading=head)
            if rotate:
                # the view looks along the previous hop (where the agent
                # came from); the target lives in that frame
                view_dir = (prev_head if prev_head is not None
                            else (head if head is not None
                                  else (0.0, 0.0, 1.0)))
                tgt = flight_frame(view_dir) @ tgt
                try:
                    seq_d[t, b] = get_tracing_slice(vol, ps, position=pos,
                                                    direction=view_dir)
                except WarpingOOBError:
                    pass  # keep zeros for degenerate geometry
            else:
                try:
                    seq_d[t, b] = warp_slice(vol, ps, position=pos)
                except WarpingOOBError:
                    pass  # keep zeros for degenerate geometry
            seq_t[t, b] = tgt
            if head is not None:
                prev_head = head
    return seq_d, seq_t


def skeleton_distance_field(skeletons, shape, oversample=2.0):
    """(n_skel, Z, X, Y) float32 stack of squared distances to each
    skeleton's rasterised curve (edges sampled ``oversample`` points per
    voxel of length), by a Euclidean distance transform on the host.
    Reference: ``skeleton.py::skeleton_distance_field``."""
    from scipy import ndimage
    shape = tuple(int(s) for s in shape)
    fields = []
    for sk in skeletons:
        mask = np.zeros(shape, bool)
        pts_all = [sk.positions]
        for a, b in sk.edges:
            pa, pb = sk.positions[a], sk.positions[b]
            n = max(2, int(np.ceil(np.linalg.norm(pb - pa) * oversample)))
            t = np.linspace(0.0, 1.0, n)[:, None]
            pts_all.append(pa[None] + t * (pb - pa)[None])
        pts = np.concatenate(pts_all, axis=0)
        ijk = np.clip(np.round(pts).astype(int), 0,
                      np.asarray(shape) - 1)
        mask[tuple(ijk.T)] = True
        d = ndimage.distance_transform_edt(~mask)
        fields.append((d.astype(np.float32)) ** 2)
    return np.stack(fields)
