"""Host ms a slab on the sweep's staging thread (KNOSSOS cubes read,
reflect pad, pinned buffer): the program's own ``timings["stage_s"]`` over
the traced window's passes."""


def read(w):
    if not w.timings or not w.slabs:
        return None
    return 1e3 * sum(w.timings["stage_s"]) / w.slabs
