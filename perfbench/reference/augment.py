"""A frozen copy of the training batch's sampling arithmetic, so that the
reference re-derives every batch from the cubes and the seed.

The arithmetic is that of the port's on-card augmenter (cube index, margin-
respecting uniform positions, warp gates, affine warp matrices with flips,
the four separable resampling passes, nearest-neighbour labels, grey
augmentation), itself the JAX package's, written out here for the
configuration the benchmark runs: no elastic field. Its random numbers come
from a ``torch.Generator`` seeded as the program's loop generator is, drawn
by the same calls in the same order, so the same seed gives the same batch.
It imports nothing of the program.
"""

import numpy as np
import torch


def _axis_grid(n, device):
    return torch.arange(n, dtype=torch.float32, device=device) - (n - 1) / 2.0


def _sep_geometry(patch_size, amount):
    amount = max(float(amount), 0.0)
    th = min(np.pi * amount, np.pi / 2)
    q2m = np.tan(th / 2)
    scM = 1.0 + 0.2 * amount
    shm = 0.2 * amount
    hz, hx, hy = [(int(p) - 1) / 2.0 for p in patch_size]
    nx3 = 2 * int(np.ceil(hx + q2m * hy)) + 3
    bbz = int(np.ceil(scM * hz)) + 3
    bbx = int(np.ceil(scM * (1 + shm) * (hx + hy))) + 3
    bby = int(np.ceil(scM * (hx + hy))) + 3
    return nx3, (2 * bbz + 1, 2 * bbx + 1, 2 * bby + 1)


def _lin_weights(pos, n_src):
    i = torch.arange(n_src, dtype=torch.float32, device=pos.device)
    p = torch.clamp(pos, 0.0, n_src - 1.0)
    return torch.clamp(1.0 - torch.abs(p[..., None] - i), min=0.0)


def _nn_weights(pos, n_src):
    i = torch.arange(n_src, dtype=torch.float32, device=pos.device)
    p = torch.clamp(torch.round(pos), 0.0, n_src - 1.0)
    return (p[..., None] == i).to(torch.float32)


def _uniform(u, lo, hi):
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return torch.clamp(u * float(np.float32(hi32 - lo32)) + float(lo32),
                       min=float(lo32))


def _warp_matrices(gen, B, amount, device):
    """Affine warp matrices (B, 4, 4): scales and flips x in-plane shear x
    in-plane rotation, z locked, anisotropic z scale."""
    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)
    d = {"rot": u(B), "shear": u(B), "scale": u(B, 3), "fx": u(B),
         "fy": u(B), "fz": u(B)}
    rot = _uniform(d["rot"], -np.pi * amount, np.pi * amount)
    shear_a = _uniform(d["shear"], -0.2, 0.2) * amount
    sc = 1.0 + _uniform(d["scale"], -0.2, 0.2) * amount
    sc = torch.cat([1.0 + (sc[:, :1] - 1.0) * 0.5, sc[:, 1:]], 1)
    fx, fy = d["fx"] < 0.5, d["fy"] < 0.5
    fz = torch.zeros(B, dtype=torch.bool, device=device)
    c, s = torch.cos(rot), torch.sin(rot)
    one, zero = torch.ones(B, device=device), torch.zeros(B, device=device)
    R = torch.stack([torch.stack([one, zero, zero], 1),
                     torch.stack([zero, c, -s], 1),
                     torch.stack([zero, s, c], 1)], 1)
    Sh = torch.eye(3, device=device).repeat(B, 1, 1)
    Sh[:, 1, 2] += shear_a
    sign = torch.stack([torch.where(fz, -1.0, 1.0),
                        torch.where(fx, -1.0, 1.0),
                        torch.where(fy, -1.0, 1.0)], 1)
    D = torch.diag_embed(sc * sign)
    lin = torch.einsum("bij,bjk,bkl->bil", D, Sh, R)
    M = torch.zeros(B, 4, 4, device=device)
    M[:, :3, :3] = lin
    M[:, 3, 3] = 1.0
    return M


class Augment:
    """The batches of a training run: ``raws`` (n, f, Z, X, Y) float32 and
    ``labels`` (n, Z, X, Y) integer cubes of one shape, on the device."""

    def __init__(self, raws, labels, patch, target, target_strides,
                 warp_amount, grey_channels):
        self.device = raws.device
        self.patch = tuple(int(p) for p in patch)
        self.target = tuple(int(t) for t in target)
        self.strides = tuple(float(s) for s in target_strides)
        self.amount = float(warp_amount)
        self.grey_channels = list(grey_channels or [])
        self.shapes = torch.tensor([list(raws.shape[2:])] * raws.shape[0],
                                   dtype=torch.float32, device=self.device)
        _, bb = _sep_geometry(self.patch, self.amount)
        pads = [max(0, n - s) for n, s in zip(bb, raws.shape[2:])]
        self.raws = _pad_trailing(raws, pads)
        self.labels = _pad_trailing(labels.to(torch.int32), pads)
        self.n = raws.shape[0]
        self.patch_t = torch.tensor(self.patch, dtype=torch.float32,
                                    device=self.device)

    def _margin(self):
        a = self.amount
        return float(np.linalg.norm(self.patch) / 2 * (1.0 + 0.2 * a)
                     * (1.0 + 0.2 * a) + 2)

    def batch(self, gen, B, warp_prob, grey=True, flip=True):
        """One (data (B, f, *patch), target (B, *target)) batch."""
        dev = self.device
        idx = torch.arange(self.n, device=dev)[
            torch.randint(self.n, (B,), generator=gen, device=dev)]
        lo_all = torch.clamp(self.shapes / 2 - 1, max=self._margin())
        lo = lo_all[idx]
        hi = self.shapes[idx] - lo_all[idx]
        u = torch.rand((B, 3), generator=gen, device=dev)
        pos = lo + u * (hi - lo)
        warp_on = torch.rand(B, generator=gen, device=dev) < warp_prob
        aligned = torch.floor(pos - (self.patch_t - 1) / 2) \
            + (self.patch_t - 1) / 2
        pos = torch.where(warp_on.reshape(-1, 1), pos, aligned)
        Ms = _warp_matrices(gen, B, self.amount, dev)
        Mf = (_warp_matrices(gen, B, 0.0, dev) if flip
              else torch.eye(4, device=dev).expand(B, 4, 4))
        Ms = torch.where(warp_on.reshape(B, 1, 1), Ms, Mf)
        data, tgt = self._warp(idx, Ms, pos)
        if self.grey_channels and grey:
            data = self._grey(gen, data)
        return data, tgt

    def _grey(self, gen, x):
        B, Fn = x.shape[:2]
        draws = [torch.rand((B, Fn), generator=gen, device=self.device)
                 for _ in range(3)]
        alpha = 1.0 + _uniform(draws[0], -0.3, 0.3)
        beta = _uniform(draws[1], -0.15, 0.15)
        gamma = 2.0 ** _uniform(draws[2], -1.0, 1.0)
        shape = (B, Fn) + (1,) * (x.ndim - 2)
        y = x * alpha.reshape(shape) + beta.reshape(shape)
        y = torch.clamp(y, 0.0, 1.0) ** gamma.reshape(shape)
        keep = {int(c) for c in self.grey_channels}
        return torch.stack([y[:, c] if c in keep else x[:, c]
                            for c in range(Fn)], 1)

    def _warp(self, idx, M, position):
        raws, labels, dev = self.raws, self.labels, self.device
        B = idx.shape[0]
        pz, px, py = self.patch
        nx3, (nbz, nbx, nby) = _sep_geometry(self.patch, self.amount)
        a, b = M[:, 1, 1], M[:, 1, 2]
        c, d = M[:, 2, 1], M[:, 2, 2]
        dz = M[:, 0, 0]
        T = M[:, :3, 3] + position
        fold = d < 0
        sgn = torch.where(fold, -1.0, 1.0)
        a, b, c, d = a * sgn, b * sgn, c * sgn, d * sgn
        r = torch.hypot(c, d)
        q2 = -c / (r + d)
        s = r
        q1 = (b - a * q2) / s
        p1 = a - q1 * c
        corner = torch.stack([
            torch.clamp(torch.round(T[:, k]) - (n - 1) / 2, 0,
                        raws.shape[2 + k] - n)
            for k, n in enumerate((nbz, nbx, nby))], 1).to(torch.int64)
        zi = corner[:, 0, None] + torch.arange(nbz, device=dev)
        xi = corner[:, 1, None] + torch.arange(nbx, device=dev)
        yi = corner[:, 2, None] + torch.arange(nby, device=dev)

        def box(stack):
            ch = torch.arange(stack.shape[1], device=dev)
            return stack[idx[:, None, None, None, None],
                         ch[None, :, None, None, None],
                         zi[:, None, :, None, None],
                         xi[:, None, None, :, None],
                         yi[:, None, None, None, :]]

        x3 = _axis_grid(nx3, dev)
        yb = torch.arange(nby, dtype=torch.float32, device=dev)
        corner_f = corner.to(torch.float32)
        cz, cx, cy = (corner_f[:, 0, None], corner_f[:, 1, None],
                      corner_f[:, 2, None])

        def col(v):
            return v[:, None, None]

        def passes(vol, tz, tx, ty, weights):
            tx = tx[None, :] * sgn[:, None]
            ty = ty[None, :] * sgn[:, None]
            Wz = weights(dz[:, None] * tz[None, :] + T[:, 0, None] - cz, nbz)
            v = torch.einsum("bpz,bfzxy->bfpxy", Wz, vol)
            pos1 = (col(p1) * x3[None, :, None]
                    + col(q1) * (yb[None, None, :] + cy[:, :, None])
                    + col(T[:, 1] - q1 * T[:, 2]) - cx[:, :, None])
            W1 = weights(pos1.transpose(1, 2), nbx)
            v = torch.einsum("byXx,bfzxy->bfzXy", W1, v)
            pos2 = (col(c) * x3[None, :, None] + col(s) * ty[:, None, :]
                    + col(T[:, 2]) - cy[:, :, None])
            W2 = weights(pos2, nby)
            v = torch.einsum("bxYy,bfzxy->bfzxY", W2, v)
            pos3 = (tx[:, :, None] + col(q2) * ty[:, None, :]
                    + (nx3 - 1) / 2)
            W3 = weights(pos3.transpose(1, 2), nx3)
            return torch.einsum("byXx,bfzxy->bfzXy", W3, v)

        out = passes(box(raws), _axis_grid(pz, dev), _axis_grid(px, dev),
                     _axis_grid(py, dev), _lin_weights)
        tg = [(torch.arange(t, dtype=torch.float32, device=dev)
               - (t - 1) / 2) * float(np.float32(st))
              for t, st in zip(self.target, self.strides)]
        t_out = passes(box(labels[:, None]).to(torch.float32), *tg,
                       _nn_weights)
        return out, torch.round(t_out).to(torch.int32)[:, 0]


def _pad_trailing(vol, pads):
    if not any(pads):
        return vol
    return torch.nn.functional.pad(vol, (0, pads[2], 0, pads[1], 0, pads[0]))
