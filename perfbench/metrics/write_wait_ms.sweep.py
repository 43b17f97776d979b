"""Device idle ms a pass while the sweep's main thread waits for its
writer thread: the time inside the spans ``sweep_knossos.wait_write`` (the
writer more than ``WRITE_DEPTH`` chunks behind) and ``sweep_knossos.drain``
(the pass's last write-backs) in which no device activity runs, clipped to
the traced window, over the window's passes (``stage_wait_ms.sweep``'s
reading). Nothing where the program opens no such span."""

from perfbench.harness import load_module

NAMES = ("sweep_knossos.wait_write", "sweep_knossos.drain")

_idle_in_spans = load_module("metrics", "stage_wait_ms.sweep").idle_in_spans


def read(w):
    return _idle_in_spans(w, NAMES)
