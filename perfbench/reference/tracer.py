"""The plain reference of the tracing deployment: agents that cut a
trilinear patch at their position, run the recurrent step model on it and
move by its prediction, in plain PyTorch, float32 with TF32 off. Written
from the semantics; it imports nothing of the program and takes nothing the
program made (the benchmark hands it the same weights, volume and seeds).

The cut: a patch of ``p`` voxels a side centred on the position; its
corner ``pos - (p - 1) / 2`` splits into a whole part and a fraction, the
fraction taken before the whole part is clipped to ``[0, dim - (p + 1)]``,
and each voxel of the patch is the weighted sum of the 8 volume values
around it (weights ``1 - frac`` or ``frac`` in each axis).

The model (``configs/tracer.json``'s graph): ``enc`` = act(flatten(patch) @
w + b); the GRU ``gates = sigmoid([x, h] @ w_gates + b_gates)`` split into
z and r, ``cand = tanh([x, r h] @ w_cand + b_cand)``, ``h' = (1 - z) h + z
cand``, seeded by the learnt ``state0``; ``step`` = h' @ w + b.

The move rule: an agent is alive while inside the margin box ``[m, dim -
m)``, ``m = p / 2 + 1``; its step is the prediction's first three values x
``step_scale``; a step shorter than ``min_step`` stops it; a step from a
valid position is taken (and recorded) even when it leaves the box, and the
agent dies after it; a stopped agent keeps its position and state.

``control=True`` is the precision control: every matmul's operands rounded
to TF32 before a float32 sum, what the card computes with TF32 on.
"""

import torch

from .nets import tf32_round

ACTS = {"relu": torch.relu, "lin": lambda y: y, "tanh": torch.tanh}


def cut(vol, pos, patch):
    """(B, f, *patch) float32 trilinear patches of ``vol`` (f, Z, X, Y) at
    the float32 positions ``pos`` (B, 3): each agent's (p + 1)^3 window
    gathered, then the 8 corner-shifted views weighted and summed."""
    f = vol.shape[0]
    dims = torch.tensor(vol.shape[1:], device=pos.device)
    p = torch.tensor(patch, device=pos.device)
    corner = pos - (p - 1).to(pos.dtype) / 2
    whole = torch.floor(corner)
    frac = corner - whole
    base = torch.minimum(torch.clamp(whole, min=0), (dims - p - 1).to(
        pos.dtype)).long()
    ax = [torch.arange(n + 1, device=pos.device) for n in patch]
    iz = base[:, 0, None, None, None] + ax[0][:, None, None]
    ix = base[:, 1, None, None, None] + ax[1][None, :, None]
    iy = base[:, 2, None, None, None] + ax[2][None, None, :]
    flat = (iz * vol.shape[2] + ix) * vol.shape[3] + iy     # (B, p+1, ...)
    win = vol.reshape(f, -1)[:, flat]                        # (f, B, ...)
    pz, px, py = patch
    out = torch.zeros((f, pos.shape[0], *patch), dtype=vol.dtype,
                      device=vol.device)
    for dz in (0, 1):
        for dx in (0, 1):
            for dy in (0, 1):
                w = ((frac[:, 0] if dz else 1 - frac[:, 0])
                     * (frac[:, 1] if dx else 1 - frac[:, 1])
                     * (frac[:, 2] if dy else 1 - frac[:, 2]))
                out += w[None, :, None, None, None] * win[
                    :, :, dz:dz + pz, dx:dx + px, dy:dy + py]
    return out.transpose(0, 1)


class TracerReference:
    """The rollout of ``cfg`` (``configs/tracer.json``) with ``params``
    ``{node: {name: tensor}}`` in the program's layout (Perceptron ``w``
    (f_in, n_f); GRU ``w_gates`` (f_in + n, 2 n), ``w_cand`` (f_in + n, n);
    the initial state ``state0`` (1, n) under the GRU's ``state`` name)."""

    def __init__(self, cfg, params, control=False):
        self.cfg = cfg
        self.params = params
        self.control = control
        self.patch = tuple(cfg["patch"])
        self.nodes = cfg["graph"]
        self.gru = next(n for n in self.nodes if n["op"] == "gru")

    def _mm(self, a, w):
        if self.control:
            a, w = tf32_round(a), tf32_round(w)
        return a @ w

    def _gru(self, x, h):
        p, n = self.params[self.gru["name"]], self.gru["n_f"]
        g = torch.sigmoid(self._mm(torch.cat([x, h], 1), p["w_gates"])
                          + p["b_gates"])
        z, r = g[:, :n], g[:, n:]
        cand = ACTS[self.gru["act"]](
            self._mm(torch.cat([x, r * h], 1), p["w_cand"]) + p["b_cand"])
        return (1 - z) * h + z * cand

    def h0(self, B):
        s = self.params[self.gru["state"]]["state0"]
        return s.reshape(1, -1).expand(B, -1)

    def step(self, patches, h):
        """(prediction (B, n_out), new state) of one step."""
        vals, h_new = {}, None
        for n in self.nodes:
            op = n["op"]
            if op == "input":
                vals[n["name"]] = patches
            elif op == "perceptron":
                x = vals[n["in"]]
                if n.get("flatten"):
                    x = x.reshape(x.shape[0], -1)
                p = self.params[n["name"]]
                vals[n["name"]] = ACTS[n["act"]](self._mm(x, p["w"]) + p["b"])
            elif op == "gru":
                h_new = vals[n["name"]] = self._gru(vals[n["in"]], h)
            elif op == "scan":
                vals[n["name"]] = vals[n["in"]]
            else:
                raise ValueError(f"unknown op {op!r}")
        return vals[self.nodes[-1]["name"]], h_new

    def box(self, vol):
        m = torch.tensor(self.patch, dtype=torch.float32,
                         device=vol.device) / 2 + 1
        return m, torch.tensor(vol.shape[1:], dtype=torch.float32,
                               device=vol.device) - m

    def _move(self, vol, pos, h, alive, lo, hi):
        """One step of every agent at ``pos``: (step, moved, new state,
        alive after it)."""
        pred, h_new = self.step(cut(vol, pos, self.patch), h)
        step = pred[:, :3] * self.cfg["step_scale"]
        moved = alive & (torch.linalg.norm(step, dim=1)
                         >= self.cfg["min_step"])
        newpos = pos + step
        inside = ((newpos >= lo) & (newpos < hi)).all(1)
        return step, moved, h_new, moved & inside

    @torch.no_grad()
    def rollout(self, vol, seeds, steps):
        """Free run from ``seeds`` (B, 3): (traj (K, B, 3), moved (K, B)),
        each step's positions and which agents moved in it."""
        lo, hi = self.box(vol)
        pos = seeds.float()
        alive = ((pos >= lo) & (pos < hi)).all(1)
        h = self.h0(len(pos))
        traj, moves = [], []
        for _ in range(steps):
            step, moved, h_new, alive = self._move(vol, pos, h, alive, lo, hi)
            pos = torch.where(moved[:, None], pos + step, pos)
            h = torch.where(moved[:, None], h_new, h)
            traj.append(pos)
            moves.append(moved)
        return torch.stack(traj), torch.stack(moves)

    @torch.no_grad()
    def follow(self, vol, seeds, traj, moved):
        """Teacher-forced along another rollout's path: at each step the
        patch is cut at that rollout's position (``seeds``, then ``traj``
        (K, B, 3)) and the state is this reference's own, carried where
        ``moved`` (K, B) says the agent moved. Returns (the widest gap
        between the path's step and this reference's step where both
        moved, NaN if the path holds a non-finite value; the number of
        agent-steps whose moved flag differs from this reference's
        decision at the same position)."""
        lo, hi = self.box(vol)
        pos = seeds.float()
        alive = ((pos >= lo) & (pos < hi)).all(1)
        h = self.h0(len(pos))
        gap = torch.zeros((), dtype=torch.float64, device=vol.device)
        mismatch = 0
        finite = bool(torch.isfinite(traj).all())
        for k in range(traj.shape[0]):
            step, want, h_new, _ = self._move(vol, pos, h, alive, lo, hi)
            got = moved[k]
            mismatch += int((want != got).sum())
            both = want & got
            d = (traj[k].double() - pos.double() - step.double()).abs()
            gap = torch.maximum(gap, d[both].max() if bool(both.any())
                                else gap)
            h = torch.where(got[:, None], h_new, h)
            alive = got & ((traj[k] >= lo) & (traj[k] < hi)).all(1)
            pos = traj[k]
        return (float(gap) if finite else float("nan")), mismatch
