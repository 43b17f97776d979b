"""On-device warp augmentation: batched 3D affine + elastic resampling.

Port of ``elektronn2_tpu/ops/warp.py`` (reference:
``elektronn2/data/transformations.py::warp_slice``, which ran per patch on
host CPU workers): the training cubes live on the card, and one call cuts,
warps, flips and grey-augments a whole batch there.

Two resampling cores, as in the JAX package:

1. :func:`warp_patch`, a trilinear gather (indexing into the flattened
   volume): any ``M``, exact trilinear elastic; the host-parity oracle.
2. :func:`warp_patch_separable`: the warp family of
   :func:`random_warp_matrices` (z scale, in-plane shear, rotation, scales
   and flips) factors exactly into four axis-separable passes, each a
   batched matmul (``torch.einsum``) against a 2-banded interpolation
   matrix: z-scale, x-pass, y-pass, x-shear, in the JAX package's closed
   form (a rotation past 90 degrees folds into an exact output flip).
   Elastic fields run as three more scanline passes over a margin-enlarged
   patch (coordinate-exact for constant fields, O(|e|·∇e) off trilinear for
   smooth ones).

Every item of a batch is handled by batched tensor ops (no loop over items,
no host sync): a per-item box is cut from the stack of cubes by index
arithmetic on the card (an index grid plus the item's corner), the
counterpart of ``lax.dynamic_slice`` with traced starts. So a whole
augmented batch can be captured in a CUDA graph (``training/fused_loop.py``).

Random parameters: each random function is a draw from a ``torch.Generator``
(uniform or normal numbers) followed by a deterministic map of the draws
(``warp_matrices``, ``elastic_fields``, ``grey_map``). The maps take the
JAX package's arithmetic, so the same draws (for instance ``jax.random``'s,
fed in by a test) give the same matrices, fields and grey values; the
streams themselves differ (``torch`` is not ``jax.random``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .conv import f32_matmuls


def _dev(device):
    return torch.device("cpu") if device is None else torch.device(device)


def _axis_grid(n, device, stride=1.0, offset=0.0):
    """Centre-relative positions of ``n`` samples along one axis, times
    ``stride`` plus ``offset``, float32, made on ``device`` (no host
    copy: a CUDA graph can capture it)."""
    g = torch.arange(n, dtype=torch.float32, device=device) - (n - 1) / 2.0
    if stride != 1.0:
        g = g * float(np.float32(stride))
    if offset != 0.0:
        g = g + float(np.float32(offset))
    return g


def make_grid(patch_size, device=None, strides=None, offset=None):
    """Centre-relative output grid, (3, N) float32; with ``strides`` and
    ``offset`` the grid of a target of that stride and offset."""
    dev = _dev(device)
    strides = strides or (1.0, 1.0, 1.0)
    offset = offset or (0.0, 0.0, 0.0)
    axes = [_axis_grid(int(p), dev, st, o)
            for p, st, o in zip(patch_size, strides, offset)]
    return torch.stack([g.reshape(-1) for g in
                        torch.meshgrid(*axes, indexing="ij")])


def _cut(stack, idx, coords_lin):
    """``stack`` (n, f, S) flattened volumes, ``idx`` (B,) cube indices,
    ``coords_lin`` (B, N) linear voxel indices -> (B, f, N)."""
    f = stack.shape[1]
    ch = torch.arange(f, device=stack.device)
    return stack[idx[:, None, None], ch[None, :, None], coords_lin[:, None, :]]


def _trilinear_b(stack, idx, coords, sp):
    """Border-clamped trilinear samples of cube ``idx[b]`` of ``stack``
    (n, f, S) at ``coords`` (B, 3, N) in a volume of spatial shape ``sp``
    -> (B, f, N)."""
    c0 = torch.floor(coords).to(torch.int64)
    frac = coords - c0
    frac = torch.clamp(frac, 0.0, 1.0)
    z0, x0, y0 = [torch.clamp(c0[:, k], 0, max(n - 2, 0))
                  for k, n in enumerate(sp)]
    z1, x1, y1 = [torch.clamp(c + 1, max=n - 1)
                  for c, n in zip((z0, x0, y0), sp)]
    fz, fx, fy = frac[:, 0, None], frac[:, 1, None], frac[:, 2, None]
    sx, sy = sp[1] * sp[2], sp[2]

    def g(dz, dx, dy):
        lin = ((z1 if dz else z0) * sx + (x1 if dx else x0) * sy
               + (y1 if dy else y0))
        return _cut(stack, idx, lin)

    w000 = (1 - fz) * (1 - fx) * (1 - fy)
    w001 = (1 - fz) * (1 - fx) * fy
    w010 = (1 - fz) * fx * (1 - fy)
    w011 = (1 - fz) * fx * fy
    w100 = fz * (1 - fx) * (1 - fy)
    w101 = fz * (1 - fx) * fy
    w110 = fz * fx * (1 - fy)
    w111 = fz * fx * fy
    return (g(0, 0, 0) * w000 + g(0, 0, 1) * w001
            + g(0, 1, 0) * w010 + g(0, 1, 1) * w011
            + g(1, 0, 0) * w100 + g(1, 0, 1) * w101
            + g(1, 1, 0) * w110 + g(1, 1, 1) * w111)


def _nearest_b(stack, idx, coords, sp):
    """Border-clamped nearest samples, as :func:`_trilinear_b`."""
    c = torch.round(coords).to(torch.int64)
    cz, cx, cy = [torch.clamp(c[:, k], 0, n - 1) for k, n in enumerate(sp)]
    lin = cz * (sp[1] * sp[2]) + cx * sp[2] + cy
    return _cut(stack, idx, lin)


def _one(src):
    """One volume (f, Z, X, Y) as a stack of one: (1, f, S), index 0."""
    return (src.reshape(1, src.shape[0], -1),
            torch.zeros(1, dtype=torch.int64, device=src.device))


def trilinear_gather(src, coords):
    """src: (f, Z, X, Y); coords: (3, N) -> (f, N). Border-clamped."""
    stack, idx = _one(src)
    return _trilinear_b(stack, idx, coords[None], tuple(src.shape[1:]))[0]


def nearest_gather(src, coords):
    """src: (Z, X, Y) or (f, Z, X, Y); coords: (3, N). Border-clamped."""
    squeeze = src.ndim == 3
    if squeeze:
        src = src[None]
    stack, idx = _one(src)
    out = _nearest_b(stack, idx, coords[None], tuple(src.shape[1:]))[0]
    return out[0] if squeeze else out


def transform_grid(grid, M, position):
    """Apply homogeneous M (..., 4, 4) and a translation (..., 3) to a
    (3, N) grid -> (..., 3, N)."""
    lin = M[..., :3, :3] @ grid + M[..., :3, 3:4]
    w = M[..., 3:4, :3] @ grid + M[..., 3:4, 3:4]
    return lin / w + position[..., :, None]


def target_grid_indices(patch_size, target_patch_size, target_strides=None,
                        target_offset=None, device=None):
    """Indices (per dim, int64 tensors on ``device``) of the target grid's
    positions within the image patch grid (rounded; used to sample the
    per-patch elastic field). The arithmetic of
    ``elektronn2_tpu/data/transformations.py::target_grid_indices``, in
    float64 on the device."""
    dev = _dev(device)
    strides = target_strides or (1.0, 1.0, 1.0)
    offset = target_offset or (0.0, 0.0, 0.0)
    idx = []
    for p, t, st, o in zip(patch_size, target_patch_size, strides, offset):
        pos = ((torch.arange(t, dtype=torch.float64, device=dev)
                - (t - 1) / 2.0) * float(st) + float(o) + (p - 1) / 2.0)
        idx.append(torch.clamp(torch.round(pos).to(torch.int64), 0, p - 1))
    return idx


def _field_at(field, patch_size, tps, target_strides, target_offset):
    """A (B, 3, *patch) field sampled at the target grid's positions."""
    iz, ix, iy = target_grid_indices(patch_size, tps, target_strides,
                                     target_offset, field.device)
    return field[:, :, iz][:, :, :, ix][..., iy]


def _warp_gather_b(raws, labels, idx, M, position, patch_size,
                   target_patch_size=None, target_strides=None,
                   target_offset=None, elastic=None):
    """The gather core over a batch: item b cuts cube ``idx[b]`` of
    ``raws`` (n, f, Z, X, Y) (and of ``labels`` (n, [f,] Z, X, Y) if given)
    with M[b], position[b] and elastic[b] (B, 3, *patch)."""
    B, f = idx.shape[0], raws.shape[1]
    sp = tuple(raws.shape[2:])
    grid = make_grid(patch_size, raws.device)
    coords = transform_grid(grid, M, position)
    if elastic is not None:
        coords = coords + elastic.reshape(B, 3, -1)
    out = _trilinear_b(raws.reshape(raws.shape[0], f, -1), idx, coords, sp)
    out = out.reshape((B, f) + tuple(patch_size))
    if labels is None:
        return out
    tps = tuple(target_patch_size or patch_size)
    t_coords = transform_grid(make_grid(tps, raws.device, target_strides,
                                        target_offset), M, position)
    if elastic is not None:
        # labels follow the image's deformation: the per-patch field at the
        # target grid's (static) positions within the patch
        f_t = _field_at(elastic.reshape((B, 3) + tuple(patch_size)),
                        patch_size, tps, target_strides, target_offset)
        t_coords = t_coords + f_t.reshape(B, 3, -1)
    lab4 = labels[:, None] if labels.ndim == 4 else labels
    t_out = _nearest_b(lab4.reshape(lab4.shape[0], lab4.shape[1], -1), idx,
                       t_coords, sp)
    t_out = t_out.reshape((B, lab4.shape[1]) + tps)
    return out, (t_out[:, 0] if labels.ndim == 4 else t_out)


def warp_patch(src, M, position, patch_size, target=None,
               target_patch_size=None, target_strides=None,
               target_offset=None, elastic=None):
    """Cut one warped patch (+ the aligned nearest-interpolated target).

    Device analog of ``data.transformations.warp_slice`` (border clamp
    instead of an out-of-bounds error: position validity is the sampler's
    job). ``src`` (f, Z, X, Y), ``M`` (4, 4), ``position`` (3,);
    ``elastic``: optional (3, *patch) displacement field added in source
    space (see :func:`random_elastic_fields`).
    """
    idx = torch.zeros(1, dtype=torch.int64, device=src.device)
    res = _warp_gather_b(src[None], None if target is None else target[None],
                         idx, M[None], position[None], patch_size,
                         target_patch_size, target_strides, target_offset,
                         None if elastic is None else elastic[None])
    if target is None:
        return res[0]
    return res[0][0], res[1][0]


# ------------------------------------------- separable (matmul) resampling

def _sep_geometry(patch_size, amount):
    """Static array extents for the separable pipeline, sized for the worst
    case of the ``random_warp_matrices(amount=...)`` family (post-fold
    rotation <= 90 degrees, scales within 1 +- 0.2 amount, shear <= 0.2
    amount)."""
    amount = max(float(amount), 0.0)
    th = min(np.pi * amount, np.pi / 2)
    q2m = np.tan(th / 2)
    scM = 1.0 + 0.2 * amount
    shm = 0.2 * amount
    hz, hx, hy = [(int(p) - 1) / 2.0 for p in patch_size]
    nx3 = 2 * int(np.ceil(hx + q2m * hy)) + 3       # intermediate x extent
    bbz = int(np.ceil(scM * hz)) + 3
    bbx = int(np.ceil(scM * (1 + shm) * (hx + hy))) + 3
    bby = int(np.ceil(scM * (hx + hy))) + 3
    return nx3, (2 * bbz + 1, 2 * bbx + 1, 2 * bby + 1)


def _lin_weights(pos, n_src):
    """Row-stochastic 2-banded linear-interp matrix: (..., n_out) fractional
    source indices -> (..., n_out, n_src). Border-clamped."""
    i = torch.arange(n_src, dtype=torch.float32, device=pos.device)
    p = torch.clamp(pos, 0.0, n_src - 1.0)
    return torch.clamp(1.0 - torch.abs(p[..., None] - i), min=0.0)


def _nn_weights(pos, n_src):
    """One-hot nearest-neighbour matrix (labels)."""
    i = torch.arange(n_src, dtype=torch.float32, device=pos.device)
    p = torch.clamp(torch.round(pos), 0.0, n_src - 1.0)
    return (p[..., None] == i).to(torch.float32)


def _elastic_passes(vol, disp, weights, grids, margin=0):
    """Resample ``vol`` (B, f, *sp_enlarged) by a per-voxel displacement
    ``disp`` (B, 3, *out_sp, in the enlarged volume's index units), one
    axis at a time (three banded-matmul passes, the scanline
    decomposition). Each pass shrinks its axis from the margin-enlarged
    extent to the final one; the displacement is edge-extended over the
    axes not yet reduced."""
    m = int(margin)
    gz, gx, gy = grids            # output index grids per axis (1-D)

    def epad(arr, mx, my):        # edge-extend (B, z, x, y) over x and y
        return F.pad(arr, (my, my, mx, mx), mode="replicate") \
            if (mx or my) else arr

    # z-pass: out[z,x,y] = vol[z + dz(z,x,y), x, y]
    Wz = weights(torch.movedim(gz[None, :, None, None]
                               + epad(disp[:, 0], m, m), 1, -1),
                 vol.shape[2])                        # (B, x, y, z_out, Z)
    v = torch.einsum("bxyzZ,bfZxy->bfzxy", Wz, vol)
    Wx = weights(torch.movedim(gx[None, None, :, None]
                               + epad(disp[:, 1], 0, m), 2, -1),
                 v.shape[3])                          # (B, z, y, x_out, X)
    v = torch.einsum("bzyxX,bfzXy->bfzxy", Wx, v)
    Wy = weights(gy[None, None, None, :] + disp[:, 2], v.shape[4])
    return torch.einsum("bzxyY,bfzxY->bfzxy", Wy, v)  # (B, z, x, y_out, Y)


def _bbox_fit_pads(shape, amount_bound, patch_size, margin):
    """Trailing zero pads per spatial dim so the separable core's static
    bounding box fits a volume of spatial ``shape``."""
    pe = [int(p) + 2 * margin for p in patch_size]
    _, bb = _sep_geometry(pe, amount_bound)
    return [max(0, n - s) for n, s in zip(bb, shape)]


def _pad_trailing(vol, pads):
    """Zero-pad the last three dims of ``vol`` at their ends."""
    if not any(pads):
        return vol
    return F.pad(vol, (0, pads[2], 0, pads[1], 0, pads[0]))


def _warp_separable_b(raws, labels, idx, M, position, patch_size,
                      target_patch_size=None, target_strides=None,
                      target_offset=None, amount_bound=1.0, elastic=None,
                      elastic_margin=3):
    """The separable core over a batch: item b cuts cube ``idx[b]`` of
    ``raws`` (n, f, Z, X, Y) and ``labels`` (n, [f,] Z, X, Y) or None,
    both already padded so that the bounding box fits
    (:func:`_bbox_fit_pads`)."""
    B, dev = idx.shape[0], raws.device
    pz, px, py = [int(p) for p in patch_size]
    # with elastic on, the affine patch is computed with a static margin so
    # the displacement passes sample interior data instead of border clamps
    m = int(elastic_margin) if elastic is not None else 0
    pe = (pz + 2 * m, px + 2 * m, py + 2 * m)
    nx3, (nbz, nbx, nby) = _sep_geometry(pe, amount_bound)

    # ---- per-item pass parameters (closed form, no trig), each (B,)
    a, b = M[:, 1, 1], M[:, 1, 2]
    c, d = M[:, 2, 1], M[:, 2, 2]
    dz = M[:, 0, 0]
    if elastic is not None:
        # patch-space displacement: d_p = A^-1 e  (original, unfolded A)
        det = (a * d - b * c)[:, None, None, None]
        e = elastic.reshape(B, 3, pz, px, py)
        disp = torch.stack([e[:, 0] / dz[:, None, None, None],
                            (d[:, None, None, None] * e[:, 1]
                             - b[:, None, None, None] * e[:, 2]) / det,
                            (-c[:, None, None, None] * e[:, 1]
                             + a[:, None, None, None] * e[:, 2]) / det], 1)
    T = M[:, :3, 3] + position       # absolute source coords of the centre
    fold = d < 0                      # in-plane rotation beyond +-90 deg:
    sgn = torch.where(fold, -1.0, 1.0)  # fold a 180 deg turn into a flip
    a, b, c, d = a * sgn, b * sgn, c * sgn, d * sgn
    r = torch.hypot(c, d)
    q2 = -c / (r + d)                 # last-pass shear  (|q2| <= 1 post-fold)
    s = r                             # y-pass scale  (== d - c*q2, exactly)
    q1 = (b - a * q2) / s             # first-pass shear
    p1 = a - q1 * c                   # first-pass scale (== dx, exactly)

    # ---- bounding-box cut: an index grid plus each item's corner
    corner = torch.stack([
        torch.clamp(torch.round(T[:, k]) - (n - 1) / 2, 0, raws.shape[2 + k] - n)
        for k, n in enumerate((nbz, nbx, nby))], 1).to(torch.int64)  # (B, 3)
    zi = corner[:, 0, None] + torch.arange(nbz, device=dev)
    xi = corner[:, 1, None] + torch.arange(nbx, device=dev)
    yi = corner[:, 2, None] + torch.arange(nby, device=dev)

    def box(stack):                   # (n, f, Z, X, Y) -> (B, f, nbz, nbx, nby)
        ch = torch.arange(stack.shape[1], device=dev)
        return stack[idx[:, None, None, None, None],
                     ch[None, :, None, None, None],
                     zi[:, None, :, None, None], xi[:, None, None, :, None],
                     yi[:, None, None, None, :]]

    def grid(n):
        return _axis_grid(n, dev)

    x3 = grid(nx3)
    yb = torch.arange(nby, dtype=torch.float32, device=dev)   # bbox y indices
    corner_f = corner.to(torch.float32)
    cz, cx, cy = corner_f[:, 0, None], corner_f[:, 1, None], corner_f[:, 2, None]
    col = (lambda v: v[:, None, None])    # (B,) -> (B, 1, 1)

    def passes(vol, tz, tx, ty, weights):
        # the fold (A <- -A) is compensated exactly by negating the in-plane
        # output grid: F(p) = src(Ap + T) = G(-p) with G built from -A
        tx = tx[None, :] * sgn[:, None]                           # (B, px)
        ty = ty[None, :] * sgn[:, None]
        # z-pass: src_z = dz z + T_z
        Wz = weights(dz[:, None] * tz[None, :] + T[:, 0, None] - cz, nbz)
        v = torch.einsum("bpz,bfzxy->bfpxy", Wz, vol)
        # x-pass onto the intermediate grid: src_x = p1 x3 + q1 y_abs + t1
        pos1 = (col(p1) * x3[None, :, None]
                + col(q1) * (yb[None, None, :] + cy[:, :, None])
                + col(T[:, 1] - q1 * T[:, 2]) - cx[:, :, None])   # (B, nx3, nby)
        W1 = weights(pos1.transpose(1, 2), nbx)                   # (B, nby, nx3, nbx)
        v = torch.einsum("byXx,bfzxy->bfzXy", W1, v)
        # y-pass onto the output y grid: src_y = c x3 + s y + T_y
        pos2 = (col(c) * x3[None, :, None] + col(s) * ty[:, None, :]
                + col(T[:, 2]) - cy[:, :, None])                  # (B, nx3, py)
        W2 = weights(pos2, nby)                                   # (B, nx3, py, nby)
        v = torch.einsum("bxYy,bfzxy->bfzxY", W2, v)
        # x-shear onto the output x grid: x3 = x + q2 y
        pos3 = (tx[:, :, None] + col(q2) * ty[:, None, :]
                + (nx3 - 1) / 2)                                  # (B, px, py)
        W3 = weights(pos3.transpose(1, 2), nx3)                   # (B, py, px, nx3)
        return torch.einsum("byXx,bfzxy->bfzXy", W3, v)

    out = passes(box(raws), grid(pe[0]), grid(pe[1]), grid(pe[2]),
                 _lin_weights)
    if elastic is not None:
        idx_grids = [torch.arange(n, dtype=torch.float32, device=dev) + m
                     for n in (pz, px, py)]
        out = _elastic_passes(out, disp, _lin_weights, idx_grids, margin=m)

    if labels is None:
        return out
    tps = tuple(int(t) for t in (target_patch_size or patch_size))
    st = tuple(float(v) for v in (target_strides or (1.0, 1.0, 1.0)))
    toff = tuple(float(v) for v in (target_offset or (0.0, 0.0, 0.0)))
    tg = [(torch.arange(t + 2 * m, dtype=torch.float32, device=dev) - m
           - (t - 1) / 2) * float(np.float32(s_)) + float(np.float32(o))
          for t, s_, o in zip(tps, st, toff)]
    squeeze = labels.ndim == 4
    lab5 = labels[:, None] if squeeze else labels
    t_out = passes(box(lab5).to(torch.float32), *tg, _nn_weights)
    if elastic is not None:
        # labels follow the image's deformation: the patch-space field at
        # the target grid's (static) positions, in target-index units
        d_t = _field_at(disp, patch_size, tps, target_strides,
                        target_offset)
        d_t = torch.stack([d_t[:, k] / float(np.float32(st[k]))
                           for k in range(3)], 1)
        t_grids = [torch.arange(t, dtype=torch.float32, device=dev) + m
                   for t in tps]
        t_out = _elastic_passes(t_out, d_t, _nn_weights, t_grids, margin=m)
    t_out = (torch.round(t_out).to(labels.dtype) if not
             labels.dtype.is_floating_point else t_out.to(labels.dtype))
    return out, (t_out[:, 0] if squeeze else t_out)


def warp_patch_separable(src, M, position, patch_size, target=None,
                         target_patch_size=None, target_strides=None,
                         target_offset=None, amount_bound=1.0,
                         elastic=None, elastic_margin=3):
    """Cut one warped patch through four matmul passes (no gathers).

    Requires M from the :func:`random_warp_matrices` family (z decoupled:
    M[0,1:3] = M[1:3,0] = 0, affine: M[3,:3] = 0); the structure is assumed,
    not checked. For a general M use :func:`warp_patch`. Interface and
    return values mirror :func:`warp_patch`; values differ from it at the
    interpolation-error level (axis-factored vs direct trilinear blending).
    ``elastic``: optional (3, *patch) source-space displacement field,
    applied as a post-warp of the affine patch by the field mapped through
    A^-1, itself resampled in three banded-matmul passes.
    """
    m = int(elastic_margin) if elastic is not None else 0
    pads = _bbox_fit_pads(src.shape[1:], amount_bound, patch_size, m)
    idx = torch.zeros(1, dtype=torch.int64, device=src.device)
    res = _warp_separable_b(
        _pad_trailing(src, pads)[None],
        None if target is None else _pad_trailing(target, pads)[None],
        idx, M[None], position[None], patch_size, target_patch_size,
        target_strides, target_offset, amount_bound,
        None if elastic is None else elastic[None], elastic_margin)
    if target is None:
        return res[0]
    return res[0][0], res[1][0]


# ------------------------------------------------- random params, on device

def _uniform(u, lo, hi):
    """``jax.random.uniform``'s map of [0, 1) draws ``u`` onto [lo, hi), in
    float32: ``max(lo, u * (hi - lo) + lo)``."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return torch.clamp(u * float(np.float32(hi32 - lo32)) + float(lo32),
                       min=float(lo32))


def warp_draws(gen, batch_size, device=None):
    """The uniform [0, 1) draws of :func:`random_warp_matrices`: rotation,
    shear (B,), scales (B, 3), x/y/z flips (B,)."""
    dev = _dev(device)
    B = batch_size

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)
    return {"rot": u(B), "shear": u(B), "scale": u(B, 3), "fx": u(B),
            "fy": u(B), "fz": u(B)}


def warp_matrices(draws, amount=1.0, lock_z=True, no_x_flip=False,
                  sample_aniso=True):
    """Warp matrices (B, 4, 4) from :func:`warp_draws`' draws: scales and
    flips times an in-plane shear times an in-plane rotation, the map of
    the JAX package's ``random_warp_matrices``."""
    rot = _uniform(draws["rot"], -np.pi * amount, np.pi * amount)
    shear_a = _uniform(draws["shear"], -0.2, 0.2) * amount
    sc = 1.0 + _uniform(draws["scale"], -0.2, 0.2) * amount
    if sample_aniso:
        sc = torch.cat([1.0 + (sc[:, :1] - 1.0) * 0.5, sc[:, 1:]], 1)
    B, dev = rot.shape[0], rot.device
    no = torch.zeros(B, dtype=torch.bool, device=dev)
    fx = no if no_x_flip else draws["fx"] < 0.5
    fy = draws["fy"] < 0.5
    fz = no if lock_z else draws["fz"] < 0.5

    c, s = torch.cos(rot), torch.sin(rot)
    one, zero = torch.ones(B, device=dev), torch.zeros(B, device=dev)
    R = torch.stack([torch.stack([one, zero, zero], 1),
                     torch.stack([zero, c, -s], 1),
                     torch.stack([zero, s, c], 1)], 1)
    Sh = torch.eye(3, device=dev).repeat(B, 1, 1)
    Sh[:, 1, 2] += shear_a
    sign = torch.stack([torch.where(fz, -1.0, 1.0),
                        torch.where(fx, -1.0, 1.0),
                        torch.where(fy, -1.0, 1.0)], 1)
    D = torch.diag_embed(sc * sign)
    lin = torch.einsum("bij,bjk,bkl->bil", D, Sh, R)
    M = torch.zeros(B, 4, 4, device=dev)
    M[:, :3, :3] = lin
    M[:, 3, 3] = 1.0
    return M


def random_warp_matrices(gen, batch_size, amount=1.0, lock_z=True,
                         no_x_flip=False, sample_aniso=True, device=None):
    """Batched random warp matrices, (B, 4, 4): device analog of
    ``transformations.get_random_warp_params`` + ``make_warp_matrix``."""
    return warp_matrices(warp_draws(gen, batch_size, device), amount,
                         lock_z, no_x_flip, sample_aniso)


def _resize_weights(n_in, n_out, device):
    """(n_out, n_in) weights of ``jax.image.resize(method='trilinear')``
    along one axis (``jax.image.scale_and_translate``'s triangle kernel:
    half-pixel centres, weights normalised over the samples inside the
    input, an antialiasing kernel widened by the scale when downsampling).
    For upsampling this is ``F.interpolate(mode='trilinear',
    align_corners=False)``'s two-tap rule with the border clamped."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]) / kscale
    w = torch.clamp(1.0 - x, min=0.0)
    tot = torch.sum(w, 0, keepdim=True)
    w = torch.where(torch.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).T


def elastic_fields(normals, patch_size, sigma=3.0):
    """Displacement fields (B, 3, *patch) from standard normal draws (B, 3,
    g, g, g): the coarse Gaussian displacements ``normals * sigma``
    resized trilinearly to the patch grid (``jax.image.resize``'s rule,
    :func:`_resize_weights`)."""
    coarse = normals * sigma
    dev = coarse.device
    g = coarse.shape[2:]
    wz, wx, wy = [_resize_weights(n, int(p), dev)
                  for n, p in zip(g, patch_size)]
    fields = torch.einsum("bcijk,zi,xj,yk->bczxy", coarse, wz, wx, wy)
    # singleton axes (2D data promoted to z=1) get NO displacement: a
    # nonzero z-component would sample the zero padding around the single
    # real plane and black out patch regions
    return torch.stack([torch.zeros_like(fields[:, d]) if int(p) == 1
                        else fields[:, d]
                        for d, p in enumerate(patch_size)], 1)


def random_elastic_fields(gen, batch_size, patch_size, grid=4, sigma=3.0,
                          device=None):
    """Batched low-frequency elastic displacement fields, (B, 3, *patch).

    Device analog of ``data.transformations.make_elastic_field``: coarse
    Gaussian displacements upsampled trilinearly to the patch grid.
    """
    normals = torch.randn((batch_size, 3, grid, grid, grid), generator=gen,
                          device=_dev(device))
    return elastic_fields(normals, patch_size, sigma)


def grey_draws(gen, batch_size, n_channels, device=None):
    """The uniform [0, 1) draws of :func:`grey_augment`: contrast,
    brightness and gamma, each (B, F)."""
    dev = _dev(device)
    return [torch.rand((batch_size, n_channels), generator=gen, device=dev)
            for _ in range(3)]


def grey_map(x, draws, channels=None):
    """The brightness/contrast/gamma distortion of ``x`` (B, F, *sp) in
    [0, 1] from :func:`grey_draws`' draws; channels not in ``channels``
    (all when None) pass through untouched."""
    B, Fn = x.shape[:2]
    alpha = 1.0 + _uniform(draws[0], -0.3, 0.3)
    beta = _uniform(draws[1], -0.15, 0.15)
    gamma = 2.0 ** _uniform(draws[2], -1.0, 1.0)
    shape = (B, Fn) + (1,) * (x.ndim - 2)
    y = x * alpha.reshape(shape) + beta.reshape(shape)
    y = torch.clamp(y, 0.0, 1.0) ** gamma.reshape(shape)
    if channels is not None:
        # excluded channels pass through UNTOUCHED (the host greyAugment
        # never reads them): even the [0,1] clip would corrupt channels
        # holding e.g. signed distance features
        keep = {int(c) for c in channels}
        y = torch.stack([y[:, c] if c in keep else x[:, c]
                         for c in range(Fn)], 1)
    return y


def grey_augment(gen, x, channels=None):
    """Batched on-device brightness/contrast/gamma distortion; device
    analog of ``data.image.greyAugment``; x: (B, f, *sp) in [0, 1]."""
    return grey_map(x, grey_draws(gen, x.shape[0], x.shape[1], x.device),
                    channels)


# ------------------------------------------------------- batched pipeline

class DeviceBatchAugmenter:
    """Card-resident augmentation pipeline.

    Training cubes are stacked (zero-padded to one shape) into one tensor
    on the card; per batch only cube indices and positions are drawn, by
    the host (:meth:`getbatch`) or on the card (:meth:`device_batch`, the
    building block of ``training.fused_loop``), and one call produces the
    whole augmented (data, target) batch there. The replacement for the
    reference's forked CPU augmentation workers.

    ``device`` is the card unless the caller asks for the CPU (see
    ``neuromancer.model.target_device``). The generator of the host-sampled
    path (``self.gen``) lives there too; :meth:`device_batch` takes the
    caller's generator.
    """

    def __init__(self, raws, labels, patch_size, target_size=None,
                 target_strides=None, warp_amount=1.0, grey_channels=None,
                 elastic_sigma=0.0, elastic_grid=4, valid_cubes=None,
                 seed=0, resample="auto", device="cuda"):
        from ..neuromancer.model import target_device
        dev = target_device(device)
        # 2D data: promote to singleton-z 3D (squeezed back in getbatch)
        self._is_2d = len(patch_size) == 2
        if self._is_2d:
            raws = [r[:, None] if r.ndim == 3 else r for r in raws]
            labels = [l[None] if l.ndim == 2 else l for l in labels]
            patch_size = (1,) + tuple(patch_size)
            if target_size is not None:
                target_size = (1,) + tuple(target_size)
            if target_strides is not None:
                target_strides = (1,) + tuple(target_strides)
        f = raws[0].shape[0]
        sp = np.max([r.shape[1:] for r in raws], axis=0)
        self.n_cubes = len(raws)
        self.valid_cubes = sorted(set(valid_cubes or []))
        self.train_cubes = [i for i in range(self.n_cubes)
                            if i not in self.valid_cubes]
        if not self.train_cubes:
            raise ValueError("no training cubes left after valid split")
        # labels keep their dtype family (float regression targets allowed)
        l_dtype = (np.float32 if np.asarray(labels[0]).dtype.kind == "f"
                   else np.int32)
        stack_r = np.zeros((self.n_cubes, f, *sp), np.float32)
        stack_l = np.zeros((self.n_cubes, *sp), l_dtype)
        for i, (r, l) in enumerate(zip(raws, labels)):
            sl = tuple(slice(0, s) for s in r.shape[1:])
            stack_r[(i, slice(None)) + sl] = r
            stack_l[(i,) + sl] = l
        self.cube_shapes = np.array([r.shape[1:] for r in raws])
        self.patch_size = tuple(int(p) for p in patch_size)
        self.target_size = tuple(int(t) for t in (target_size or patch_size))
        self.target_strides = (tuple(target_strides)
                               if target_strides is not None else None)
        self.warp_amount = float(warp_amount)
        self.grey_channels = grey_channels
        self.elastic_sigma = float(elastic_sigma)
        self.elastic_grid = int(elastic_grid)
        # resampling core: 'separable' = matmul passes (no gathers; elastic
        # applied as scanline post-passes), 'gather' = trilinear gather (the
        # host-parity oracle path), 'auto' = separable
        if resample not in ("auto", "separable", "gather"):
            raise ValueError(f"resample={resample!r}: expected 'auto', "
                             "'separable' or 'gather'")
        self._separable = resample in ("separable", "auto")
        # elastic scanline margin: cover ~3 sigma displacements
        self._elastic_margin = (max(3, int(np.ceil(3 * self.elastic_sigma)))
                                if self.elastic_sigma > 0 else 0)
        self.raws = torch.as_tensor(stack_r, device=dev)
        self.labels = torch.as_tensor(stack_l, device=dev)
        dev = self.device = self.raws.device        # "cuda" -> "cuda:0"
        if self._separable:
            # pad the stacks once so the per-item box cuts never re-pad
            # (geometry sized for the elastic-margin-enlarged patch)
            pads = _bbox_fit_pads(self.raws.shape[2:], self.warp_amount,
                                  self.patch_size, self._elastic_margin)
            self.raws = _pad_trailing(self.raws, pads)
            self.labels = _pad_trailing(self.labels, pads)
        # the samplers' constants, on the card once
        self._pool = torch.as_tensor(self.train_cubes, dtype=torch.int64,
                                     device=dev)
        self._shapes = torch.as_tensor(self.cube_shapes, dtype=torch.float32,
                                       device=dev)
        self._patch = torch.as_tensor(self.patch_size, dtype=torch.float32,
                                      device=dev)
        self._eye4 = torch.eye(4, device=dev)
        self._seed0 = int(seed)
        self.gen = torch.Generator(dev).manual_seed(self._seed0)
        self._host_rng = np.random.RandomState(seed)

    def _batch_fn(self, gen, cube_idx, positions, warp_on, grey_on, flip_on):
        """Cut, warp, flip and grey-augment one batch on the card: draws
        from ``gen``; ``cube_idx`` (B,), ``positions`` (B, 3) and
        ``warp_on`` (B,) are tensors on the card, ``grey_on`` and
        ``flip_on`` python bools. The matmul passes run in full float32
        (no TF32)."""
        with f32_matmuls():
            return self._batch(gen, cube_idx, positions, warp_on, grey_on,
                               flip_on)

    def _batch(self, gen, cube_idx, positions, warp_on, grey_on, flip_on):
        B = cube_idx.shape[0]
        dev = self.device
        Ms = random_warp_matrices(gen, B, amount=self.warp_amount,
                                  device=dev)
        # the unwarped part of a TRAINING batch still gets random FLIPS
        # (amount=0: identity rotation/shear/scale, flips only);
        # flip_on=False (validation) takes the identity
        Mf = (random_warp_matrices(gen, B, amount=0.0, device=dev)
              if flip_on else self._eye4.expand(B, 4, 4))
        Ms = torch.where(warp_on.reshape(B, 1, 1), Ms, Mf)
        fields = None
        if self.elastic_sigma > 0:
            fields = random_elastic_fields(gen, B, self.patch_size,
                                           self.elastic_grid,
                                           self.elastic_sigma, device=dev)
            fields = fields * warp_on.reshape(B, 1, 1, 1, 1)
        kw = dict(target_patch_size=self.target_size,
                  target_strides=self.target_strides, elastic=fields)
        if self._separable:
            data, tgt = _warp_separable_b(
                self.raws, self.labels, cube_idx, Ms, positions,
                self.patch_size, amount_bound=self.warp_amount,
                elastic_margin=self._elastic_margin, **kw)
        else:
            data, tgt = _warp_gather_b(self.raws, self.labels, cube_idx, Ms,
                                       positions, self.patch_size, **kw)
        if self.grey_channels and grey_on:
            data = grey_augment(gen, data, self.grey_channels)
        return data, tgt

    def reseed(self, n):
        """Re-derive the sampling streams from ``n`` (a restarted run draws
        fresh batches instead of replaying the sequence from step 1)."""
        mix = (self._seed0 * 40503 + int(n) * 2654435761 + 12345) % (2 ** 31)
        self.gen.manual_seed(mix)
        self._host_rng = np.random.RandomState(mix)
        return self

    def _safe_margin(self):
        """Position margin covering the WORST-CASE warp: rotation (patch
        diagonal) x scale (<= 1+0.2 amount) x shear (<= 1+0.2 amount) +
        elastic displacement. Cubes smaller than twice this margin still
        clamp (fixed-shape device sampling cannot retry)."""
        a = float(self.warp_amount)
        m = (np.linalg.norm(self.patch_size) / 2
             * (1.0 + 0.2 * a) * (1.0 + 0.2 * a))
        return float(m + self._elastic_margin + 2)

    def _align_unwarped(self, pos, warp_on):
        """Integer-align the positions of non-warped samples so identity /
        flip-only patches are EXACT voxel crops (no interpolation blur)."""
        aligned = torch.floor(pos - (self._patch - 1) / 2) \
            + (self._patch - 1) / 2
        return torch.where(warp_on.reshape(-1, 1), pos, aligned)

    # ---- device-side sampling (for fused multi-step training loops) ----
    def _sample_device(self, gen, batch_size, warp_prob):
        """The card's counterpart of :meth:`getbatch`'s host sampling:
        cube indices, margin-respecting uniform positions, warp gates, all
        drawn from ``gen`` on the card."""
        dev = self.device
        idx = self._pool[torch.randint(len(self.train_cubes), (batch_size,),
                                       generator=gen, device=dev)]
        lo_all = torch.clamp(self._shapes / 2 - 1, max=self._safe_margin())
        lo = lo_all[idx]
        hi = self._shapes[idx] - lo_all[idx]
        u = torch.rand((batch_size, 3), generator=gen, device=dev)
        pos = lo + u * (hi - lo)
        warp_on = torch.rand(batch_size, generator=gen,
                             device=dev) < warp_prob
        pos = self._align_unwarped(pos, warp_on)
        if self._is_2d:
            pos = torch.cat([torch.zeros_like(pos[:, :1]), pos[:, 1:]], 1)
        return idx, pos, warp_on

    def device_batch(self, gen, batch_size, warp=0.5, grey=True, flip=True):
        """Sampling and augmentation of one batch on the card, all drawn
        from ``gen`` (a ``torch.Generator`` on the augmenter's device): no
        host sync, so a CUDA graph can capture it. Returns (data, target)
        with the shapes of ``getbatch(source='train')``."""
        wp = 1.0 if warp is True else float(warp or 0.0)
        idx, pos, warp_on = self._sample_device(gen, batch_size, wp)
        data, tgt = self._batch_fn(gen, idx, pos, warp_on, bool(grey),
                                   bool(flip))
        return self._squeeze_2d(data, tgt)

    def _squeeze_2d(self, data, tgt):
        if self._is_2d:
            data = data[:, :, 0]
            tgt = tgt[:, 0] if tgt.ndim == 4 else tgt[..., 0, :, :]
        return data, tgt

    def getbatch(self, batch_size=1, warp=0.5, source="train", flip=True,
                 **_ignored):
        """Host-side driver: sample cubes/positions on the host, run the
        batch on the card with ``self.gen``.

        ``source='valid'`` samples the held-out cubes (``valid_cubes``) with
        augmentation disabled.
        """
        rng = self._host_rng
        if source == "valid":
            if not self.valid_cubes:
                raise ValueError("no validation cubes configured")
            pool = self.valid_cubes
            warp = 0.0
        else:
            pool = self.train_cubes
        idx = np.asarray(pool)[rng.randint(0, len(pool), size=batch_size)]
        margin = self._safe_margin()
        pos = np.empty((batch_size, 3), np.float32)
        for b, i in enumerate(idx):
            sh = self.cube_shapes[i]
            lo = np.minimum(margin, sh / 2 - 1)
            pos[b] = rng.uniform(lo, sh - lo)
        warp_on = rng.rand(batch_size) < (1.0 if warp is True else
                                          float(warp or 0.0))
        p = np.asarray(self.patch_size, np.float64)
        aligned = np.floor(pos - (p - 1) / 2) + (p - 1) / 2
        pos = np.where(warp_on[:, None], pos, aligned).astype(np.float32)
        if self._is_2d:
            pos[:, 0] = 0.0
        dev = self.device
        data, tgt = self._batch_fn(
            self.gen, torch.as_tensor(idx, dtype=torch.int64, device=dev),
            torch.as_tensor(pos, device=dev),
            torch.as_tensor(warp_on, device=dev), source == "train",
            bool(flip) and source == "train")
        return self._squeeze_2d(data, tgt)
