"""Batch creation from volumetric EM datasets.

Jax-free copy of ``elektronn2_tpu/data/cnndata.py`` (reference:
``elektronn2/data/cnndata.py::BatchCreatorImage, GridData, AgentData``).
Loads HDF5 raw/label cube pairs (train/valid split), and
``getbatch`` cuts random warped patches (lazy bbox reads →
``transformations.warp_slice``), applies grayscale augmentation, and returns
numpy batches shaped for the model's TaggedShape — including strided targets
for pooled nets and per-fragment targets for MFP training.

The batches are numpy and nothing here runs torch: the Trainer's forked
``BackgroundProc`` workers call ``getbatch`` after the parent has set up
CUDA, and a forked child must not touch CUDA (or torch's CPU thread pool).
``AgentData`` draws its tracing batches through
``skeleton.sample_tracing_batch``.
"""

from __future__ import annotations

import time

import numpy as np

from ..log import logger
from .transformations import (
    warp_slice, WarpingOOBError, make_warp_matrix, get_random_warp_params,
)
from .image import greyAugment
from ..utils.basic import h5load, as_list


def _to_3d(a):
    """Promote 2D arrays to 3D with a singleton z axis."""
    a = np.asarray(a)
    if a.ndim == 2:
        return a[None]
    return a


class BatchCreatorImage:
    """Image-to-image training data source.

    Parameters (mirroring the reference):
      d_path/l_path   : directories of raw / label HDF5 files
      d_files/l_files : list of (filename, h5_key) pairs
      input_data/target_data : alternatively, in-memory arrays
                        (list of (f, z, x, y) raws and (z, x, y) labels)
      cube_prios      : sampling priority per training cube (default ∝ size)
      valid_cubes     : indices of cubes held out for validation
      aniso_factor    : z anisotropy (scales warp geometry)
      target_discrete_ix : target channels that are discrete labels
      normalize_mode  : raw normalisation ('divide255' for uint8, 'none')
    """

    def __init__(self, d_path=None, l_path=None, d_files=None, l_files=None,
                 input_data=None, target_data=None, cube_prios=None,
                 valid_cubes=None, aniso_factor=2,
                 target_discrete_ix=None, normalize_mode="auto",
                 warp_kwargs=None):
        self.aniso_factor = float(aniso_factor)
        self.target_discrete_ix = target_discrete_ix
        self.warp_kwargs = dict(warp_kwargs or {})
        valid_cubes = set(valid_cubes or [])

        raws, labels = [], []
        if input_data is not None:
            for r, t in zip(as_list(input_data), as_list(target_data)):
                raws.append(self._norm(_to_3d(r), normalize_mode))
                labels.append(_to_3d(t))
        else:
            import os
            for (df, dk), (lf, lk) in zip(d_files, l_files):
                r = h5load(os.path.join(d_path or "", df), dk)
                t = h5load(os.path.join(l_path or "", lf), lk)
                raws.append(self._norm(_to_3d(r), normalize_mode))
                labels.append(_to_3d(t))
        for i, (r, t) in enumerate(zip(raws, labels)):
            if r.ndim == 3:
                raws[i] = r[None]  # add feature axis

        self._all_labels = labels     # original cube order (refs, not copies)
        self.valid_cubes = sorted(valid_cubes)   # original-order indices
        self.train_d = [r for i, r in enumerate(raws) if i not in valid_cubes]
        self.train_l = [t for i, t in enumerate(labels)
                        if i not in valid_cubes]
        self.valid_d = [r for i, r in enumerate(raws) if i in valid_cubes]
        self.valid_l = [t for i, t in enumerate(labels) if i in valid_cubes]
        if not self.train_d:
            raise ValueError("no training cubes")
        if cube_prios is None:
            sizes = np.array([t.size for t in self.train_l], np.float64)
            cube_prios = sizes / sizes.sum()
        self.cube_prios = np.asarray(cube_prios) / np.sum(cube_prios)

        self.n_ch = self.train_d[0].shape[0]
        self.rng = np.random.RandomState(int(time.time() * 100) % 2**31)
        # geometry (set by link_model_geometry or explicitly)
        self.patch_size = None
        self.target_size = None
        self.target_strides = None
        self.frag_offsets = None
        self._n_successful = 0
        self._n_failed = 0

    @staticmethod
    def _norm(r, mode):
        if mode == "none":
            return r.astype(np.float32)
        if r.dtype == np.uint8 or mode == "divide255":
            return r.astype(np.float32) / 255.0
        return r.astype(np.float32)

    # ------------------------------------------------------------- geometry
    def link_model_geometry(self, model):
        """Wire patch/target geometry from a designated Model (the reference
        Trainer does this implicitly by passing model shapes into the data
        class)."""
        in_ts = model.input_node.shape
        self.patch_size = list(in_ts.spatial_shape)
        pred = model.prediction_node
        tgt = model.target_node
        if tgt is not None:
            t_ts = tgt.shape
            self.target_size = list(t_ts.spatial_shape)
        elif pred is not None:
            self.target_size = list(pred.shape.spatial_shape)
        if pred is not None:
            ps = pred.shape
            from ..ops.mfp import _interleave_geometry
            if ps.n_frag > 1:
                _, _, _ = _interleave_geometry(ps.mfp_offsets)  # validate
                self.frag_offsets = np.asarray(ps.mfp_offsets)
            self.target_strides = list(ps.strides)
        self._is_2d = len(self.patch_size) == 2
        if self._is_2d:
            self.patch_size = [1] + self.patch_size
            if self.target_size is not None:
                self.target_size = [1] + self.target_size
            if self.target_strides is not None:
                self.target_strides = [1] + self.target_strides
        logger.info(f"data geometry: patch={self.patch_size} "
                    f"target={self.target_size} strides={self.target_strides}"
                    f" n_frag={1 if self.frag_offsets is None else len(self.frag_offsets)}")
        return self

    def set_geometry(self, patch_size, target_size=None, target_strides=None,
                     frag_offsets=None):
        self.patch_size = list(patch_size)
        self.target_size = list(target_size or patch_size)
        self.target_strides = list(target_strides or [1] * len(patch_size))
        self.frag_offsets = (np.asarray(frag_offsets)
                             if frag_offsets is not None else None)
        self._is_2d = len(self.patch_size) == 2
        if self._is_2d:
            self.patch_size = [1] + self.patch_size
            self.target_size = [1] + self.target_size
            self.target_strides = [1] + self.target_strides
        return self

    def compute_class_weights(self, n_classes=None, clip=(0.25, 4.0)):
        """Inverse-frequency class weights over the training labels
        (normalised to mean 1, clipped) — feed to ``MultinoulliNLL``.
        Reference configs hand-tuned these; the helper derives them.
        """
        labels = np.concatenate([l.ravel() for l in self.train_l])
        labels = labels[labels >= 0]
        if n_classes is None:
            n_classes = int(labels.max()) + 1
        counts = np.bincount(labels.astype(np.int64),
                             minlength=n_classes).astype(np.float64)
        counts = np.maximum(counts, 1.0)
        w = counts.sum() / (n_classes * counts)
        w = np.clip(w, *clip)
        return (w / w.mean()).astype(np.float32)

    # --------------------------------------------------------------- batches
    def _pick_cube(self, source):
        if source == "train":
            i = self.rng.choice(len(self.train_d), p=self.cube_prios)
            return self.train_d[i], self.train_l[i]
        if not self.valid_d:
            raise ValueError("no validation cubes configured")
        i = self.rng.randint(len(self.valid_d))
        return self.valid_d[i], self.valid_l[i]

    def _sample_position(self, vol_shape, margin):
        vol_shape = np.asarray(vol_shape, np.float64)
        lo = np.asarray(margin, np.float64).copy()
        hi = vol_shape - margin
        # singleton dims (2D data promoted to 3D): position pinned to 0
        single = vol_shape <= 1
        lo[single] = 0.0
        hi[single] = np.nextafter(0.0, 1.0)
        if np.any(hi <= lo):
            raise WarpingOOBError(f"volume {vol_shape} too small for "
                                  f"margin {margin}")
        return self.rng.uniform(lo, hi)

    def getbatch(self, batch_size=1, source="train",
                 grey_augment_channels=None, warp=0.5, warp_args=None,
                 ignore_thresh=0.0, force_dense=False, flip=True,
                 max_retries=20):
        """Assemble one (data, target) batch.

        Reference: ``BatchCreatorImage.getbatch``. ``warp`` is the
        probability of a random warp per sample (False/0 disables);
        ``warp_args`` forwards to ``get_random_warp_params``;
        ``ignore_thresh``: resample while the labeled fraction of the target
        patch is below this threshold.
        """
        if self.patch_size is None:
            raise RuntimeError("call link_model_geometry()/set_geometry() "
                               "before getbatch()")
        warp_args = dict(warp_args or self.warp_kwargs)
        data_b, target_b = [], []
        n_frag = 1 if self.frag_offsets is None else len(self.frag_offsets)
        for _ in range(int(batch_size)):
            for attempt in range(max_retries):
                try:
                    d, t = self._try_sample(source, warp, warp_args, flip)
                    if ignore_thresh and t is not None:
                        labeled = np.mean(t >= 0)
                        if labeled < ignore_thresh:
                            raise WarpingOOBError("below ignore_thresh")
                    break
                except WarpingOOBError:
                    self._n_failed += 1
                    continue
            else:
                raise RuntimeError(
                    f"could not sample a valid patch in {max_retries} tries "
                    f"(patch {self.patch_size} vs volumes "
                    f"{[v.shape for v in self.train_d]})")
            self._n_successful += 1
            data_b.append(d)
            target_b.append(t)
        data = np.stack(data_b)
        if grey_augment_channels and source == "train":
            for i in range(len(data)):
                data[i] = greyAugment(data[i], grey_augment_channels,
                                      self.rng)
        if target_b[0] is None:
            return data, None
        # fragment-major stacking to match MFP batch layout (ops/mfp.py)
        if n_frag > 1:
            # target_b entries are (n_frag, *tsp) → (n_frag*b, *tsp)
            target = np.concatenate(
                [np.stack([tb[k] for tb in target_b]) for k in range(n_frag)])
        else:
            target = np.stack(target_b)
        tdix = self.target_discrete_ix
        if tdix is None and target.dtype.kind in "iu":
            target = target.astype(np.int32)
        if getattr(self, "_is_2d", False):
            data = data[:, :, 0]          # drop the synthetic z axis
            target = target[:, 0] if target.ndim == 4 else target[..., 0, :, :]
        return data, target

    def _try_sample(self, source, warp, warp_args, flip):
        vol_d, vol_l = self._pick_cube(source)
        do_warp = bool(warp) and (warp is True or self.rng.rand() < warp) \
            and source == "train"
        M = None
        flip_only = False
        if not do_warp and flip and source == "train":
            # flips live inside the warp matrix, so flip=True was silently
            # inert whenever the warp gate didn't fire (review r2 s5):
            # amount=0 yields an identity rot/shear/scale with random
            # flips only. The position is integer-aligned below, so the
            # flipped coordinates land on the voxel lattice and the
            # interpolation is an exact axis reversal (no blur).
            fkw = {k: warp_args[k] for k in ("lock_z", "no_x_flip")
                   if k in warp_args}
            params = get_random_warp_params(self.rng, amount=0.0, **fkw)
            if any(params[f] for f in ("flip_x", "flip_y", "flip_z")):
                M = make_warp_matrix(**params)
                flip_only = True
        if do_warp:
            # NOTE: no .pop — warp_args is shared across samples/retries
            amount = warp_args.get("amount", 1.0)
            rest = {k: v for k, v in warp_args.items() if k != "amount"}
            params = get_random_warp_params(self.rng, amount=amount, **rest)
            if not flip:
                params["flip_x"] = params["flip_y"] = params["flip_z"] = False
            M = make_warp_matrix(**params)
            if self.aniso_factor != 1.0:
                # rotations/scales are designed in physical space; conjugate
                # into anisotropic voxel space (z voxels aniso_factor× thick)
                from .transformations import aniso_warp_matrix
                M = aniso_warp_matrix(M, self.aniso_factor)
        diag = np.linalg.norm(np.asarray(self.patch_size, np.float64))
        margin = (np.asarray(self.patch_size, np.float64) / 2 + 1
                  if M is None or flip_only else
                  np.minimum(np.asarray(vol_d.shape[1:], np.float64) / 2 - 1,
                             diag / 2 + 2))
        position = self._sample_position(vol_d.shape[1:], margin)
        if M is None or flip_only:
            # no warp → integer-align so the patch is an exact voxel crop
            # (no interpolation blur), as in the reference's unwarped path
            # (a flip-only matrix keeps the lattice alignment: reversal
            # about an aligned centre hits integer coordinates)
            p = np.asarray(self.patch_size, np.float64)
            position = np.floor(position - (p - 1) / 2) + (p - 1) / 2
        tsz = self.target_size
        tst = self.target_strides
        if self.frag_offsets is None:
            d, t = warp_slice(vol_d, self.patch_size, M=M, position=position,
                              target=vol_l, target_patch_size=tsz,
                              target_strides=tst)
            return d, t
        # MFP training: one target per fragment, shifted by its offset —
        # the image patch is interpolated ONCE (skip_img: the per-fragment
        # calls cut targets only; review r2 s5)
        d = warp_slice(vol_d, self.patch_size, M=M, position=position)
        frags = []
        for off in self.frag_offsets:
            off3 = np.zeros(3)
            off3[-len(off):] = off
            _, t = warp_slice(vol_d, self.patch_size, M=M, position=position,
                              target=vol_l, target_patch_size=tsz,
                              target_strides=tst, target_offset=off3,
                              skip_img=True)
            frags.append(t)
        return d, np.stack(frags)

    def __repr__(self):
        return (f"<BatchCreatorImage {len(self.train_d)} train cubes, "
                f"{len(self.valid_d)} valid cubes, n_ch={self.n_ch}, "
                f"ok={self._n_successful} failed={self._n_failed}>")


class GridData(BatchCreatorImage):
    """Image data plus sparse point annotations (e.g. synapse locations).

    Reference: ``cnndata.py::GridData`` — extends BatchCreatorImage with
    sparse grid/vector targets. Point annotations are rasterised into an
    extra label id (or a separate channel) at load time: every voxel within
    ``point_radius`` of an annotated point gets ``point_label``.

    ``grid_points``: per-cube list of (N, 3) arrays of (z, x, y) positions.
    """

    def __init__(self, *args, grid_points=None, point_radius=2,
                 point_label=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.grid_points = grid_points or []
        self.point_radius = float(point_radius)
        if grid_points:
            r = int(np.ceil(self.point_radius))
            # ONE label id for the point class across ALL cubes (a per-cube
            # max+1 would rasterise the same semantic class under different
            # ids in cubes whose existing label ranges differ)
            lab = (point_label if point_label is not None
                   else int(max(int(c.max()) for c in self._all_labels))
                   + 1)
            # pair with cubes in the ORIGINAL order the user supplied
            # (train/valid splitting reorders train_l/valid_l); own the
            # list before swapping entries (it may be the caller's)
            self._all_labels = list(self._all_labels)
            for ci, (cube_l, pts) in enumerate(zip(self._all_labels,
                                                   self.grid_points)):
                # rasterise into a COPY — writing the caller's array would
                # pollute it permanently (and a second GridData over the
                # same arrays would derive lab = max+1 from the already-
                # rasterised spheres; review r2 s5)
                out_l = np.array(cube_l, copy=True)
                sh = out_l.shape[-3:]
                for p in np.asarray(pts, np.float64).reshape(-1, 3):
                    lo = np.maximum(np.floor(p - r).astype(int), 0)
                    hi = np.minimum(np.ceil(p + r).astype(int) + 1, sh)
                    zz, xx, yy = np.meshgrid(*[np.arange(a, b) for a, b
                                               in zip(lo, hi)],
                                             indexing="ij")
                    m = ((zz - p[0]) ** 2 + (xx - p[1]) ** 2
                         + (yy - p[2]) ** 2) <= self.point_radius ** 2
                    # mask the trailing spatial axes (labels may be 4D)
                    out_l[..., lo[0]:hi[0], lo[1]:hi[1],
                          lo[2]:hi[2]][..., m] = lab
                # swap the copy in wherever the original is referenced
                # (train/valid splits hold the same objects)
                for coll in (self.train_l, self.valid_l):
                    for k, c in enumerate(coll):
                        if c is cube_l:
                            coll[k] = out_l
                self._all_labels[ci] = out_l


class AgentData(BatchCreatorImage):
    """Skeleton-following tracing batches.

    Reference: ``cnndata.py::AgentData``: serves (image patch sequence,
    direction target) pairs for the recurrent tracing workload, sampled
    along neurite skeletons (``skeleton.py::sample_tracing_batch``).
    ``skeleton_cube``: one original-order cube index per skeleton (None
    pairs by position or with the single cube). ``rotate_to_heading``: cut
    views in the local flight frame and express targets in it (pair with
    ``Tracer(rotate_to_heading=True)`` at rollout).
    """

    def __init__(self, *args, skeleton_files=None, skeleton_cube=None,
                 rotate_to_heading=False, **kwargs):
        super().__init__(*args, **kwargs)
        from .skeleton import SkeletonMFK
        self.skeletons = [SkeletonMFK.load(f) for f in (skeleton_files or [])]
        self.skeleton_cube = (None if skeleton_cube is None
                              else [int(c) for c in skeleton_cube])
        self.rotate_to_heading = bool(rotate_to_heading)

    def get_tracing_batch(self, batch_size=1, n_steps=8, source="train"):
        from .skeleton import sample_tracing_batch
        return sample_tracing_batch(self, batch_size, n_steps, self.rng,
                                    source=source)
