"""Output voxels of dense prediction a second: every voxel of every request
completed in the window over the window's length (host clock)."""


def read(w):
    return w.voxels_out / w.seconds / 1e6 if w.requests else None
