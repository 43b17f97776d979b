"""The plain reference of a configuration's net: plain PyTorch convs, pools
and softmax, float32 with TF32 off, read from the net's graph
(``netspec.Net``). It imports nothing of the program and takes nothing the
program made: the benchmark hands it the same weights and inputs it hands
the program.

``control=True`` is the precision control: every conv's and transposed
conv's operands rounded to TF32 (10 mantissa bits, round to nearest) before
a float32 sum, which is what cuDNN computes with TF32 on. It is the step
below the configuration's float32 that would tempt a later change, and the
output check has to fail it.
"""

import itertools

import torch
import torch.nn.functional as F


def no_tf32():
    """Full float32 convs and matmuls in this process."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def tf32_round(t):
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _straight_through(t, fn):
    """``fn(t)`` forward, identity backward."""
    return t + (fn(t) - t).detach() if t.requires_grad else fn(t)


def _act(y, act):
    if act == "relu":
        return torch.relu(y)
    if act == "lin":
        return y
    raise ValueError(f"unknown activation {act!r}")


def _crop_to(x, common):
    idx = [slice(None), slice(None)]
    for s, c in zip(x.shape[2:], common):
        lo = (s - c) // 2
        idx.append(slice(lo, lo + c))
    return x[tuple(idx)]


class Reference:
    """``params`` is ``{node: {"w": tensor, "b": tensor}}`` in the
    program's layout (conv ``w`` (Cout, Cin, kz, kx, ky), transposed conv
    ``w`` (Cout, Cin, *pool))."""

    def __init__(self, net, params, control=False):
        self.net = net
        self.params = params
        self.control = control

    def _ops(self, x, w):
        if not self.control:
            return x, w
        return (_straight_through(x, tf32_round),
                _straight_through(w, tf32_round))

    def _evaluate(self, x, conv, pool):
        """The graph on ``x`` (B, f, z, x, y), each value freed after its
        last consumer; ``conv(node, x, w, b, dil)`` and ``pool(node, y,
        dil)`` pick the form (valid or dilated). Returns the output."""
        net = self.net
        uses = {n["name"]: 0 for n in net.nodes}
        for n in net.nodes:
            for p in net.parents(n):
                uses[p["name"]] += 1
        vals = {net.input["name"]: x}
        dil = {net.input["name"]: [1, 1, 1]}
        for n in net.nodes[1:]:
            ps = net.parents(n)
            a = vals[ps[0]["name"]]
            d = dil[ps[0]["name"]]
            if n["op"] == "conv":
                p = self.params[n["name"]]
                y = conv(n, a, p["w"], p["b"], d)
                y, d = pool(n, y, d)
                y = _act(y, n["act"])
            elif n["op"] == "upconv":
                p = self.params[n["name"]]
                xa, w = self._ops(a, p["w"])
                y = F.conv_transpose3d(xa, w.transpose(0, 1), p["b"],
                                       stride=tuple(n["pool"]))
                y = _act(y, n["act"])
            elif n["op"] == "merge":
                b = vals[ps[1]["name"]]
                common = [min(s, t) for s, t in zip(a.shape[2:],
                                                    b.shape[2:])]
                y = torch.cat([_crop_to(a, common), _crop_to(b, common)], 1)
            elif n["op"] == "softmax":
                y = torch.softmax(a, 1)
            else:
                raise ValueError(f"unknown op {n['op']!r}")
            vals[n["name"]], dil[n["name"]] = y, d
            del a, y
            for p in ps:
                uses[p["name"]] -= 1
                if uses[p["name"]] == 0:
                    del vals[p["name"]]
        return vals[net.output["name"]]

    def valid(self, x):
        """Valid-mode forward of ``x`` (B, f, z, x, y): what a training
        step computes."""
        def conv(n, a, w, b, d):
            a, w = self._ops(a, w)
            return F.conv3d(a, w, b)

        def pool(n, y, d):
            if any(q > 1 for q in n["pool"]):
                y = F.max_pool3d(y, tuple(n["pool"]))
            return y, d
        return self._evaluate(x, conv, pool)

    def dilated(self, xpad):
        """The dense map of an already padded volume ``xpad`` (B, f, z, x,
        y) by a graph without UpConvs: each conv dilated by its input's
        cumulative stride, each pool a stride-1 max window dilated alike.
        Output: (B, f_out, z - fov_z + 1, ...)."""
        def conv(n, a, w, b, d):
            a, w = self._ops(a, w)
            return F.conv3d(a, w, b, dilation=tuple(d))

        def pool(n, y, d):
            if any(q > 1 for q in n["pool"]):
                y = F.max_pool3d(y, tuple(n["pool"]), stride=1,
                                 dilation=tuple(d))
            return y, [a * q for a, q in zip(d, n["pool"])]
        return self._evaluate(xpad, conv, pool)

    def padded(self, vol):
        """``vol`` (f, z, x, y) reflect-padded by the fov as a ``pad_raw``
        request is: (1, f, z + fov_z - 1, ...)."""
        lo, hi = self.net.pad_raw()
        return F.pad(vol[None], _pads(lo, hi), mode="reflect")

    def dense(self, vol, patch0=None):
        """The dense map (f_out, z, x, y) of ``vol`` (f, z, x, y) served with
        ``pad_raw``: the output voxel at v is the net on the padded volume's
        window that starts at v. A decoder graph runs once over the whole
        volume, front-padded to its period and back-padded to a valid size
        (``netspec.Net.convdense_geometry``; ``patch0`` is the net's design
        patch), and is trimmed."""
        V = list(vol.shape[1:])
        if not self.net.has_upconv:
            return self.dilated(self.padded(vol))[0]
        lo, hi, N, trim = self.net.convdense_geometry(V, patch0)
        x = F.pad(vol[None], _pads(lo, hi), mode="reflect")
        back = [n - s for n, s in zip(N, x.shape[2:])]
        if any(back):
            x = F.pad(x, _pads([0, 0, 0], back), mode="reflect")
        y = self.valid(x)
        return y[(0, slice(None)) + tuple(
            slice(t, t + v) for t, v in zip(trim, V))]


def _pads(lo, hi):
    """``F.pad``'s list: (lo, hi) pairs from the last axis backwards."""
    return list(itertools.chain.from_iterable(
        (a, b) for a, b in zip(reversed(lo), reversed(hi))))
