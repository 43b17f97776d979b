"""Traces of the tracing agent and their KNOSSOS export.

Jax-free copy of ``Trace``, ``_parse_nml``, ``_build_nml``,
``_write_nml_file`` and ``trace_to_kzip`` in
``elektronn2_tpu/data/skeleton.py`` (reference:
``elektronn2/data/skeleton.py``), plus :func:`read_nml_file`, the reading
half of ``SkeletonMFK.load`` for NML and k.zip files. ``SkeletonMFK`` and the
skeleton losses wait for the training slice (ROADMAP.md §1 item 6).
"""

from __future__ import annotations

import os
import zipfile
import xml.etree.ElementTree as ET

import numpy as np

from ..utils.basic import AccumulationArray


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
