"""The work of K2, the tracer's patch cut, frozen here.

A call cuts B trilinear patches of p = (pz, px, py) voxels from an f-channel
float32 volume: each output value is the weighted sum of the 8 values
around it (8 multiply-adds), and each agent reads its (p + 1)^3 window, its
position once, and writes its patch once. Windows of different agents
overlap, and a stopped agent is cut again where it stopped: the bytes a
call needs are the union of its windows, read once (``window_union``, from
the positions of that call), not the sum of the agents' windows.
"""

import math

import torch

from .peaks import F32


def trilinear_patches_work(B, f, patch, window_voxels=None):
    """FLOPs and bytes of one call of ``B`` patches of shape ``patch`` from
    an ``f``-channel float32 volume whose windows cover ``window_voxels``
    voxels together (default: every agent's window counted whole, the most
    a call can need)."""
    out = B * f * math.prod(patch)
    if window_voxels is None:
        window_voxels = B * math.prod(p + 1 for p in patch)
    flops = 2 * 8 * out
    nbytes = F32 * (f * window_voxels + out + 3 * B)
    return flops, nbytes


def window_bases(pos, patch, dims):
    """The (B, 3) corner of each agent's (p + 1)^3 window at the float32
    positions ``pos`` (B, 3) in a volume of spatial ``dims``: the patch's
    corner ``pos - (p - 1) / 2`` rounded down, clipped to ``[0, dim - (p +
    1)]``, as the cut reads it."""
    p = torch.tensor(patch, device=pos.device)
    d = torch.tensor(dims, device=pos.device)
    whole = torch.floor(pos - (p - 1).to(pos.dtype) / 2)
    return torch.minimum(torch.clamp(whole, min=0),
                         (d - p - 1).to(pos.dtype)).long()


def window_union(pos, patch, dims):
    """Voxels of a ``dims`` volume that the (p + 1)^3 windows at ``pos``
    (B, 3) cover together, each counted once."""
    base = window_bases(pos, patch, dims)
    ax = [torch.arange(n + 1, device=pos.device) for n in patch]
    iz = base[:, 0, None, None, None] + ax[0][:, None, None]
    ix = base[:, 1, None, None, None] + ax[1][None, :, None]
    iy = base[:, 2, None, None, None] + ax[2][None, None, :]
    flat = (iz * dims[1] + ix) * dims[2] + iy
    seen = torch.zeros(math.prod(dims), dtype=torch.bool, device=pos.device)
    seen[flat.reshape(-1)] = True
    return int(seen.sum())
