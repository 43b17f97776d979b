"""Input voxels trained a second: batch x input voxels x steps completed in
the window over the window's length (host clock)."""


def read(w):
    return w.voxels_in / w.seconds / 1e6 if w.steps else None
