"""Host ms a slab on the sweep's writer thread (the trimmed result written
into ``out``): the program's own ``timings["write_s"]`` over the traced
window's passes."""


def read(w):
    if not w.timings or not w.slabs:
        return None
    return 1e3 * sum(w.timings["write_s"]) / w.slabs
