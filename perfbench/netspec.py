"""A configuration's net as data, and the arithmetic of its shapes.

A configuration is ``configs/<name>.json``: its source, its sizes and its
``graph``, a list of nodes in evaluation order, each ``{"name", "op", ...}``:

- ``input``: ``f`` channels;
- ``conv``: ``in``, ``n_f``, ``filter`` and ``pool`` (z, x, y), ``act``
  (``relu`` or ``lin``): a valid conv with bias, then a max pool of window
  and stride ``pool``, then the activation;
- ``upconv``: ``in``, ``n_f``, ``pool``, ``act``: a transposed conv with
  kernel and stride ``pool``;
- ``merge``: ``in`` (two names): both centre-cropped to their common
  shape and concatenated over channels;
- ``softmax``: ``in``, over channels.

Everything here is shapes and counts: no torch, nothing of the program.
The plain reference (``reference/``), the harness's builders and the metric
readers all read a net through this module.
"""

import json
import math
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load_config(name):
    """``configs/<name>.json`` as a dict; raises ``FileNotFoundError``."""
    with open(os.path.join(HERE, "configs", f"{name}.json")) as fh:
        return json.load(fh)


def _parents(node):
    p = node.get("in")
    return [] if p is None else ([p] if isinstance(p, str) else list(p))


class Net:
    """The graph of a configuration with its receptive field, its strides
    and its shapes."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.nodes = list(cfg["graph"])
        self.by_name = {n["name"]: n for n in self.nodes}
        self.input = self.nodes[0]
        self.output = self.nodes[-1]
        self.has_upconv = any(n["op"] == "upconv" for n in self.nodes)
        self._fov_strides()

    def parents(self, node):
        return [self.by_name[p] for p in _parents(node)]

    def _fov_strides(self):
        """Receptive field and cumulative stride of every node, by the
        program's convention: a merge keeps its first parent's."""
        fov, st = {}, {}
        for n in self.nodes:
            if n["op"] == "input":
                fov[n["name"]], st[n["name"]] = [1, 1, 1], [1, 1, 1]
                continue
            p = _parents(n)[0]
            f, s = list(fov[p]), list(st[p])
            if n["op"] == "conv":
                f = [a + (k - 1) * b for a, k, b in zip(f, n["filter"], s)]
                f = [a + (q - 1) * b for a, q, b in zip(f, n["pool"], s)]
                s = [b * q for b, q in zip(s, n["pool"])]
            elif n["op"] == "upconv":
                s = [b // q for b, q in zip(s, n["pool"])]
            fov[n["name"]], st[n["name"]] = f, s
        self.fov = fov[self.output["name"]]
        self.strides = st
        #: the valid-size period: the largest cumulative stride
        self.period = [max(st[n["name"]][d] for n in self.nodes)
                       for d in range(3)]

    def channels(self):
        ch = {}
        for n in self.nodes:
            if n["op"] == "input":
                ch[n["name"]] = n["f"]
            elif n["op"] in ("conv", "upconv"):
                ch[n["name"]] = n["n_f"]
            elif n["op"] == "merge":
                ch[n["name"]] = sum(ch[p] for p in _parents(n))
            else:
                ch[n["name"]] = ch[_parents(n)[0]]
        return ch

    # ---------------------------------------------------------- valid mode
    def valid_shapes(self, sp):
        """Spatial shape of every node on a valid-mode input of shape
        ``sp``; for a conv also ``<name>.pre``, its shape before the
        pool."""
        out = {}
        for n in self.nodes:
            if n["op"] == "input":
                out[n["name"]] = list(sp)
                continue
            s = out[_parents(n)[0]]
            if n["op"] == "conv":
                pre = [v - k + 1 for v, k in zip(s, n["filter"])]
                out[n["name"] + ".pre"] = pre
                s = [v // q for v, q in zip(pre, n["pool"])]
            elif n["op"] == "upconv":
                s = [v * q for v, q in zip(s, n["pool"])]
            elif n["op"] == "merge":
                s = [min(a, b) for a, b in zip(*(out[p] for p in
                                                  _parents(n)))]
            out[n["name"]] = s
        return out

    def forward_flops(self, sp, batch=1):
        """2 x multiply-adds of one valid-mode forward pass of ``batch``
        inputs of spatial shape ``sp``."""
        shapes, ch = self.valid_shapes(sp), self.channels()
        macs = 0
        for n in self.nodes:
            if n["op"] == "conv":
                cin = ch[_parents(n)[0]]
                macs += (n["n_f"] * cin * math.prod(n["filter"])
                         * math.prod(shapes[n["name"] + ".pre"]))
            elif n["op"] == "upconv":
                macs += n["n_f"] * ch[_parents(n)[0]] * math.prod(
                    shapes[n["name"]])
        return 2 * macs * batch

    # ---------------------------------------------------------- dense maps
    def dense_flops_per_voxel(self):
        """2 x multiply-adds a voxel of a dense map, halos left out. A graph
        without an UpConv is dense at every layer (the dilated form); in a
        decoder graph a layer does its per-voxel work at its own density,
        1 / the volume of its cumulative stride."""
        ch = self.channels()

        def dens(name):
            return math.prod(self.strides[name]) if self.has_upconv else 1

        macs = 0.0
        for n in self.nodes:
            par = _parents(n)
            if n["op"] == "conv":
                macs += (n["n_f"] * ch[par[0]] * math.prod(n["filter"])
                         / dens(par[0]))
            elif n["op"] == "upconv":
                macs += n["n_f"] * ch[par[0]] / dens(n["name"])
        return 2 * macs

    def pad_raw(self):
        """Front and back reflect pads of a ``pad_raw`` request: the
        centre offset (fov - 1) // 2 in front, the rest behind."""
        lo = [(f - 1) // 2 for f in self.fov]
        return lo, [f - 1 - a for f, a in zip(self.fov, lo)]

    def convdense_geometry(self, V, patch0):
        """The whole-volume pass of a decoder graph over a volume of
        spatial shape ``V`` served with ``pad_raw``: the front pads (the
        centre offset rounded up to the period), the back pads, the valid
        extent ``N`` the graph runs on (``patch0`` plus a multiple of the
        period, reached by a second reflect pad at the back) and the front
        trim of its output."""
        M = self.period
        off, hi = self.pad_raw()
        lo = [-(-o // m) * m for o, m in zip(off, M)]
        Vp = [v + a + b for v, a, b in zip(V, lo, hi)]
        out0 = self.valid_shapes(patch0)[self.output["name"]]
        delta = [max(0, (p - f + 1) - o)
                 for p, f, o in zip(patch0, self.fov, out0)]
        N = [p + max(0, -(-(v + d - p) // m)) * m
             for p, v, d, m in zip(patch0, Vp, delta, M)]
        trim = [a - o for a, o in zip(lo, off)]
        return lo, hi, N, trim

    def dense_convs(self, V, patch0=None):
        """Every conv of one dense map of spatial shape ``V`` (``pad_raw``),
        as ``(node, input shape (Cin, z, x, y), dilation (z, x, y))``: the
        dilated form for graphs without an UpConv (each conv dilated by
        its input's stride, each pool a stride-1 window), the whole-volume
        valid pass otherwise."""
        ch = self.channels()
        res = []
        if self.has_upconv:
            N = self.convdense_geometry(V, patch0)[2]
            shapes = self.valid_shapes(N)
            for n in self.nodes:
                if n["op"] == "conv":
                    p = _parents(n)[0]
                    res.append((n, [ch[p]] + shapes[p], [1, 1, 1]))
            return res
        ext = {self.input["name"]: [v + f - 1 for v, f in zip(V, self.fov)]}
        for n in self.nodes[1:]:
            p = _parents(n)[0]
            s, d = ext[p], self.strides[p]
            if n["op"] == "conv":
                res.append((n, [ch[p]] + s, d))
                s = [v - (k - 1) * b for v, k, b in zip(s, n["filter"], d)]
                s = [v - (q - 1) * b for v, q, b in zip(s, n["pool"], d)]
            ext[n["name"]] = s
        return res


def k1_takes(node, dil, convdense):
    """Whether the port's K1 route takes this conv: a (3,3,3) ReLU conv at
    z-dilation 1, unpooled on the dilated path, pooled ones too on the
    conv-dense path."""
    return (node["op"] == "conv" and list(node["filter"]) == [3, 3, 3]
            and node["act"] == "relu" and dil[0] == 1
            and (convdense or all(q == 1 for q in node["pool"])))
