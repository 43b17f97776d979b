"""Voxels written into ``out`` a second over whole passes of the KNOSSOS
dataset, host staging and write-back included (host clock)."""


def read(w):
    return w.voxels_out / w.seconds / 1e6 if w.slabs else None
