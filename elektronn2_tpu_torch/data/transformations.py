"""Geometric warping on the host: the warp matrices, the elastic field,
the trilinear and nearest gathers, and ``warp_slice``.

Jax-free copy of ``elektronn2_tpu/data/transformations.py`` (reference:
``elektronn2/data/transformations.py::warp_slice, get_random_warpparams,
map_coordinates_linear, map_coordinates_nearest, WarpingOOBError``). It
composes a homogeneous 4x4 transform (rotation, shear, anisotropic scale,
flip, perspective) plus a low-frequency elastic displacement field,
back-projects the output patch grid into source coordinates, reads only the
source bounding box (numpy arrays, h5py datasets and ``KnossosArray`` all
slice lazily) and interpolates trilinearly for raw images, nearest for
labels. The gathers run in the C++ core ``warp_core.cpp`` (a copy of the
JAX package's, built on first use by ``_warp_native``) and fall back to the
vectorised numpy path, the semantics oracle, where no compiler is found.
Everything here is numpy: ``BatchCreatorImage`` calls it in forked worker
processes, which must not touch torch.

Coordinate convention: spatial axes ordered (z, x, y); matrices act on
homogeneous column vectors ``[z, x, y, 1]`` measured relative to the patch
centre; ``position`` is the patch-centre location in the source volume.
"""

from __future__ import annotations

import os

import numpy as np


class WarpingOOBError(ValueError):
    """Raised when a warped patch needs voxels outside the source volume.

    Reference: ``transformations.py::WarpingOOBError`` — batch creators
    catch this and retry with a new position.
    """


# ------------------------------------------------------------ matrix helpers

def identity():
    return np.eye(4, dtype=np.float64)


def translate(dz, dx, dy):
    M = identity()
    M[:3, 3] = (dz, dx, dy)
    return M


def scale(sz, sx=None, sy=None):
    if sx is None:
        sx = sz
    if sy is None:
        sy = sx
    return np.diag([sz, sx, sy, 1.0])


def flip(fz=False, fx=False, fy=False):
    return np.diag([-1.0 if fz else 1.0, -1.0 if fx else 1.0,
                    -1.0 if fy else 1.0, 1.0])


def rotate_z(angle):
    """Rotation in the (x, y) plane (about the z axis — the usual EM case,
    since z is the anisotropic sectioning axis)."""
    c, s = np.cos(angle), np.sin(angle)
    M = identity()
    M[1, 1], M[1, 2], M[2, 1], M[2, 2] = c, -s, s, c
    return M


def rotate_axis(axis, angle):
    """Rotation about an arbitrary unit 3-vector (z, x, y components)."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    z, x, y = axis
    c, s = np.cos(angle), np.sin(angle)
    C = 1 - c
    R = np.array([
        [z * z * C + c, z * x * C - y * s, z * y * C + x * s],
        [x * z * C + y * s, x * x * C + c, x * y * C - z * s],
        [y * z * C - x * s, y * x * C + z * s, y * y * C + c],
    ])
    M = identity()
    M[:3, :3] = R
    return M


def shear(plane_axis, amount):
    """Shear in the plane orthogonal to ``plane_axis`` (0=z,1=x,2=y)."""
    M = identity()
    a, b = [i for i in range(3) if i != plane_axis]
    M[a, b] = amount
    return M


def perspective(pz=0.0, px=0.0, py=0.0):
    M = identity()
    M[3, :3] = (pz, px, py)
    return M


_perspective_fn = perspective   # kwarg-shadow-safe alias (make_warp_matrix)


def aniso_warp_matrix(M, aniso_factor):
    """Conjugate a physical-space warp into anisotropic voxel space:
    z voxels are ``aniso_factor``× thicker, so rotations/scales designed in
    physical coordinates become S⁻¹·M·S with S = diag(a, 1, 1)."""
    a = float(aniso_factor)
    if a == 1.0:
        return M
    S = np.diag([a, 1.0, 1.0, 1.0])
    S_inv = np.diag([1.0 / a, 1.0, 1.0, 1.0])
    return S_inv @ M @ S


def chain(*mats):
    """Compose transforms left-to-right application order: chain(A, B) is
    "apply A, then B" (i.e. B @ A)."""
    M = identity()
    for m in mats:
        M = m @ M
    return M


def flight_frame(direction):
    """Orthonormal frame ``(tangent, normal1, normal2)`` (rows) for a
    flight heading in (z, x, y) world coordinates. Degenerate/zero
    headings fall back to (0, 0, 1) — the same fallback
    ``SkeletonMFK.direction_target`` uses. Same construction as
    ``SkeletonMFK.local_frame`` (which delegates here)."""
    t = np.asarray(direction, np.float64)
    n = np.linalg.norm(t)
    t = t / n if n > 0 else np.array([0.0, 0.0, 1.0])
    ref = np.array([1.0, 0.0, 0.0])
    if abs(t @ ref) > 0.9:
        ref = np.array([0.0, 1.0, 0.0])
    n1 = np.cross(t, ref)
    n1 /= np.linalg.norm(n1)
    n2 = np.cross(t, n1)
    return np.stack([t, n1, n2])


def tracing_frame_matrix(direction, aniso_factor=1.0):
    """4×4 warp matrix rotating the output patch into the local flight
    frame: the patch z-axis samples along ``direction`` (and the normals
    span the perpendicular view plane). ``aniso_factor`` conjugates the
    rotation into anisotropic voxel space (z voxels ``aniso_factor``×
    thicker) via :func:`aniso_warp_matrix`."""
    F = flight_frame(direction)
    M = identity()
    M[:3, :3] = F.T          # columns = frame vectors: patch axes → world
    return aniso_warp_matrix(M, aniso_factor)


def get_tracing_slice(img, patch_size, position, direction=None,
                      aniso_factor=1.0, target=None, target_patch_size=None,
                      target_strides=None, target_offset=None,
                      return_M=False):
    """Cut the tracing agent's view patch, rotated into the local flight
    frame.

    Reference: ``transformations.py::get_tracing_slice`` — the agent's
    view is cut along its flight direction so the network always "looks"
    where it is going; predicted step vectors then live in the same local
    frame (components along ``flight_frame(direction)``'s rows). With
    ``direction=None`` this is an axis-aligned :func:`warp_slice` cut
    (the framework's default tracing mode — both train and rollout paths
    accept ``rotate_to_heading=True`` to switch to frame-aligned views
    consistently).

    ``return_M=True`` additionally returns the 4×4 warp matrix so callers
    can express targets in / recover world vectors from the local frame.
    Raises :class:`WarpingOOBError` like :func:`warp_slice`.
    """
    M = (identity() if direction is None
         else tracing_frame_matrix(direction, aniso_factor))
    out = warp_slice(img, patch_size, M=M, position=position, target=target,
                     target_patch_size=target_patch_size,
                     target_strides=target_strides,
                     target_offset=target_offset)
    return (out, M) if return_M else out


def get_random_warp_params(rng, amount=1.0, lock_z=True, no_x_flip=False,
                           perspective_on=False, sample_aniso=True):
    """Random warp parameter set, scaled by ``amount`` in [0, 1].

    Reference: ``transformations.py::get_random_warpparams`` (name slightly
    normalised). Returns a dict consumable by :func:`make_warp_matrix`.
    """
    rot_max = np.pi * amount
    params = {
        "rot_z": rng.uniform(-rot_max, rot_max),
        "shear_amount": rng.uniform(-0.2, 0.2) * amount,
        "scale": 1.0 + rng.uniform(-0.2, 0.2, size=3) * amount,
        "flip_x": False if no_x_flip else bool(rng.rand() < 0.5),
        "flip_y": bool(rng.rand() < 0.5),
        "flip_z": bool(rng.rand() < 0.5) if not lock_z else False,
    }
    if not lock_z:
        axis = rng.randn(3)
        params["rot_axis"] = axis / np.linalg.norm(axis)
        params["rot_axis_angle"] = rng.uniform(-0.3, 0.3) * amount
    if perspective_on:
        params["perspective"] = rng.uniform(-1e-3, 1e-3, size=3) * amount
    if sample_aniso:
        params["scale"][0] = 1.0 + rng.uniform(-0.1, 0.1) * amount
    return params


def make_warp_matrix(rot_z=0.0, shear_amount=0.0, scale_factors=None,
                     scale=None, flip_z=False, flip_x=False, flip_y=False,
                     rot_axis=None, rot_axis_angle=0.0,
                     perspective_params=None, perspective=None, **_ignored):
    """Build the composed homogeneous warp matrix from a parameter dict
    (e.g. the output of :func:`get_random_warp_params`; the ``scale``/
    ``perspective`` aliases accept that dict's key names directly)."""
    scale_factors = scale if scale is not None else scale_factors
    perspective_params = (perspective if perspective is not None
                          else perspective_params)
    mats = [rotate_z(rot_z)]
    if rot_axis is not None and rot_axis_angle:
        mats.append(rotate_axis(rot_axis, rot_axis_angle))
    if shear_amount:
        mats.append(shear(0, shear_amount))
    if scale_factors is not None:
        s = np.broadcast_to(np.asarray(scale_factors, np.float64), (3,))
        mats.append(np.diag([s[0], s[1], s[2], 1.0]))
    mats.append(flip(flip_z, flip_x, flip_y))
    if perspective_params is not None:
        p = np.asarray(perspective_params, np.float64)
        # NB: the `perspective` kwarg shadows the module function here
        mats.append(_perspective_fn(p[0], p[1], p[2]))
    return chain(*mats)


# -------------------------------------------------------------- interpolation

#: native C++ gather core (the reference's numba inner loops) — built with
#: g++ on first use; None after a failed probe (no compiler → numpy path)
_NATIVE = "unprobed"


def _native():
    global _NATIVE
    if _NATIVE == "unprobed":
        if os.environ.get("ELEKTRONN2_NO_NATIVE_WARP"):
            _NATIVE = None
        else:
            try:
                from . import _warp_native
                _warp_native.get_lib()
                _NATIVE = _warp_native
            except Exception:
                _NATIVE = None
    return _NATIVE


def map_coordinates_linear(src, coords):
    """Vectorised trilinear gather. ``src``: (z, x, y) or (f, z, x, y);
    ``coords``: (3, N) float source coordinates (voxel-centre convention).

    Reference: ``transformations.py::map_coordinates_linear`` (numba inner
    loop). Two implementations: a C++ core (``data/warp_core.cpp`` via
    ctypes, threaded — the native counterpart of the reference's numba
    loops, used for float32 sources) and this vectorised-numpy fallback,
    which is also the semantics oracle (tests assert agreement to float32
    tolerance).
    """
    multi = src.ndim == 4
    if not multi:
        src = src[None]
    nat = _native()
    if nat is not None and src.dtype == np.float32:
        out = nat.map_linear_f32(src, coords)
        return out if multi else out[0]
    sp = src.shape[1:]
    c0 = np.floor(coords).astype(np.int64)
    frac = (coords - c0).astype(src.dtype if src.dtype.kind == "f"
                                else np.float32)
    # clamp per dim; singleton dims (2D data promoted to 3D) collapse to 0
    c0 = np.clip(c0, 0, np.maximum(np.array(sp).reshape(3, 1) - 2, 0))
    c1 = np.minimum(c0 + 1, np.array(sp).reshape(3, 1) - 1)
    z0, x0, y0 = c0
    z1, x1, y1 = c1
    fz, fx, fy = np.clip(frac, 0.0, 1.0)

    def g(dz, dx, dy):
        zz = z1 if dz else z0
        xx = x1 if dx else x0
        yy = y1 if dy else y0
        return src[:, zz, xx, yy].astype(np.float32)

    out = (g(0, 0, 0) * (1 - fz) * (1 - fx) * (1 - fy)
           + g(0, 0, 1) * (1 - fz) * (1 - fx) * fy
           + g(0, 1, 0) * (1 - fz) * fx * (1 - fy)
           + g(0, 1, 1) * (1 - fz) * fx * fy
           + g(1, 0, 0) * fz * (1 - fx) * (1 - fy)
           + g(1, 0, 1) * fz * (1 - fx) * fy
           + g(1, 1, 0) * fz * fx * (1 - fy)
           + g(1, 1, 1) * fz * fx * fy)
    return out if multi else out[0]


def map_coordinates_nearest(src, coords):
    """Nearest-neighbour gather (labels). Same layout as the linear variant.

    Reference: ``transformations.py::map_coordinates_nearest``.
    """
    multi = src.ndim == 4
    if not multi:
        src = src[None]
    nat = _native()
    if nat is not None and src.dtype == np.int32:
        out = nat.map_nearest_i32(src, coords)
        return out if multi else out[0]
    sp = src.shape[1:]
    c = np.rint(coords).astype(np.int64)
    c = np.clip(c, 0, np.array(sp).reshape(3, 1) - 1)
    out = src[:, c[0], c[1], c[2]]
    return out if multi else out[0]


# ------------------------------------------------------------------ elastic

def make_elastic_field(rng, patch_size, grid=4, sigma=3.0):
    """Low-frequency random displacement field: coarse (grid³, 3) Gaussian
    displacements upsampled trilinearly to the patch grid. Returns
    (3, *patch_size)."""
    coarse = rng.randn(3, grid, grid, grid) * sigma
    # upsample by linear interpolation along each axis
    field = coarse
    for ax, n in enumerate(patch_size):
        idx = np.linspace(0, field.shape[1 + ax] - 1, int(n))
        lo = np.floor(idx).astype(np.int64)
        hi = np.minimum(lo + 1, field.shape[1 + ax] - 1)
        w = (idx - lo).reshape([-1 if i == ax else 1 for i in range(3)])
        lo_sl = np.take(field, lo, axis=1 + ax)
        hi_sl = np.take(field, hi, axis=1 + ax)
        field = lo_sl * (1 - w) + hi_sl * w
    return field


def target_grid_indices(patch_size, target_patch_size, target_strides=None,
                        target_offset=None):
    """Indices (per dim) of the target grid's positions within the image
    patch grid (rounded; used to sample the per-patch elastic field)."""
    strides = (np.ones(3) if target_strides is None
               else np.asarray(target_strides, np.float64))
    offset = (np.zeros(3) if target_offset is None
              else np.asarray(target_offset, np.float64))
    idx = []
    for d, (p, t) in enumerate(zip(patch_size, target_patch_size)):
        pos = ((np.arange(t) - (t - 1) / 2.0) * strides[d] + offset[d]
               + (p - 1) / 2.0)
        idx.append(np.clip(np.rint(pos).astype(np.int64), 0, p - 1))
    return idx


def _sample_field_at_target(field, patch_size, target_patch_size,
                            target_strides, target_offset):
    iz, ix, iy = target_grid_indices(patch_size, target_patch_size,
                                     target_strides, target_offset)
    return field[:, iz][:, :, ix][:, :, :, iy]


# ------------------------------------------------------------------ warp core

def warp_coords(patch_size, M=None, position=None, elastic=None,
                grid_strides=None, grid_offset=None):
    """Source coordinates for every output voxel.

    Returns (3, N) float coords and the output grid shape. ``M`` maps
    centre-relative output coords to centre-relative source coords;
    ``position`` (default: centre requirement supplied by caller) is added.
    ``grid_strides``/``grid_offset`` space/shift the output grid BEFORE the
    transform — used for strided prediction targets and per-MFP-fragment
    target shifts.
    """
    patch_size = tuple(int(p) for p in patch_size)
    if M is None:
        M = identity()
    strides = (np.ones(3) if grid_strides is None
               else np.asarray(grid_strides, np.float64))
    offset = (np.zeros(3) if grid_offset is None
              else np.asarray(grid_offset, np.float64))
    grids = np.meshgrid(
        *[(np.arange(p, dtype=np.float64) - (p - 1) / 2.0) * strides[d]
          + offset[d] for d, p in enumerate(patch_size)], indexing="ij")
    flat = np.stack([grid.ravel() for grid in grids] +
                    [np.ones(int(np.prod(patch_size)))])
    src = M @ flat
    w = src[3]
    coords = src[:3] / w                       # perspective divide
    if elastic is not None:
        coords = coords + elastic.reshape(3, -1)
    if position is not None:
        coords = coords + np.asarray(position, np.float64).reshape(3, 1)
    return coords, patch_size


def source_bbox(coords, margin=1):
    """Bounding box (lo, hi exclusive) of the coords, + interpolation margin
    (scalar or per-dim; singleton source dims need margin 0)."""
    lo = np.floor(coords.min(axis=1)).astype(np.int64)
    hi = np.ceil(coords.max(axis=1)).astype(np.int64) + np.asarray(margin) + 1
    return lo, hi


def warp_slice(img, patch_size, M=None, position=None, target=None,
               target_patch_size=None, target_strides=None,
               target_offset=None, elastic=None, rng=None,
               elastic_params=None, skip_img=False):
    """Cut a warped patch (and optionally an aligned target patch).

    Reference: ``transformations.py::warp_slice`` — THE augmentation entry
    point. ``img``: (f, Z, X, Y) array-like supporting numpy basic slicing
    (numpy array, h5py dataset or KnossosArray — only the needed slab is
    read). ``target``: (Z, X, Y) or (ft, Z, X, Y) label volume, interpolated
    nearest. ``position``: patch-centre coordinates in the source volume
    (default: volume centre). ``target_offset``: spatial offset of the target
    patch centre relative to the image patch centre (defaults to aligned
    centres — valid-conv FOV cropping is symmetric).

    Raises :class:`WarpingOOBError` if the warped patch needs out-of-bounds
    voxels — callers retry with a different position.

    ``skip_img=True`` (requires ``target``) interpolates ONLY the target
    patch and returns ``(None, t_out)`` — MFP training cuts one image
    patch but one target per fragment offset, and re-interpolating the
    full image per fragment was ~n_frag× redundant host work on the hot
    batch path (review r2 s5).
    """
    img_shape = np.array(img.shape[-3:], dtype=np.int64)
    patch_size = tuple(int(p) for p in patch_size)
    if position is None:
        position = (img_shape - 1) / 2.0
    if elastic is None and elastic_params:
        rng = rng or np.random
        elastic = make_elastic_field(rng, patch_size, **elastic_params)

    if skip_img:
        if target is None:
            raise ValueError("skip_img=True requires a target")
        out = None
    else:
        coords, _ = warp_coords(patch_size, M, position, elastic)
        lo, hi = source_bbox(coords,
                             margin=(img_shape > 1).astype(np.int64))
        if np.any(lo < 0) or np.any(hi > img_shape):
            raise WarpingOOBError(
                f"warped patch bbox [{lo}, {hi}) exceeds source volume "
                f"{tuple(img_shape)}")

        # lazy slab read: only the bbox is materialised from the store
        slab = np.asarray(img[..., lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]])
        local = coords - lo.reshape(3, 1)
        out = map_coordinates_linear(slab, local)
        out = out.reshape((-1,) + patch_size).astype(np.float32)

    if target is None:
        return out

    if target_patch_size is None:
        target_patch_size = patch_size
    target_patch_size = tuple(int(t) for t in target_patch_size)
    # target grid: centred on (possibly offset) patch centre, same transform
    # AND the same elastic deformation — labels must follow the image.
    # The field is defined per image-patch voxel; sample it (nearest) at the
    # target grid's positions within the patch.
    t_elastic = None
    if elastic is not None:
        t_elastic = _sample_field_at_target(elastic, patch_size,
                                            target_patch_size,
                                            target_strides, target_offset)
    t_coords, _ = warp_coords(target_patch_size, M, position, t_elastic,
                              grid_strides=target_strides,
                              grid_offset=target_offset)
    t_shape = np.array(target.shape[-3:], dtype=np.int64)
    t_lo, t_hi = source_bbox(t_coords, margin=(t_shape > 1).astype(np.int64))
    if np.any(t_lo < 0) or np.any(t_hi > t_shape):
        raise WarpingOOBError(
            f"warped target bbox [{t_lo}, {t_hi}) exceeds target volume "
            f"{tuple(t_shape)}")
    t_slab = np.asarray(target[..., t_lo[0]:t_hi[0], t_lo[1]:t_hi[1],
                               t_lo[2]:t_hi[2]])
    t_local = t_coords - t_lo.reshape(3, 1)
    t_out = map_coordinates_nearest(t_slab, t_local)
    t_out = t_out.reshape(((-1,) if target.ndim == 4 else ())
                          + target_patch_size)
    return out, t_out
