"""Device idle ms a pass while the sweep's main thread waits for its
staging thread: the time inside the spans ``sweep_knossos.wait_stage``
(around ``fut.result()``) in which no device activity runs, clipped to the
traced window, over the window's passes. The main thread runs chunks ahead
of the card, so most of its waiting overlaps the card's work; only the
idle inside it is the staging's cost. Nothing where the program opens no
such span."""

from perfbench.trace import WINDOW_SPAN, _union

NAMES = ("sweep_knossos.wait_stage",)


def idle_in_spans(w, names):
    """Device idle ms a pass inside the main thread's spans ``names``
    (merged, clipped to the window), or None where there are none."""
    if w.trace is None or not w.attempted:
        return None
    main = {h[3] for h in w.trace.host if h[0] == WINDOW_SPAN}
    lo, hi = w.trace.window
    spans = _union((max(a, lo), min(b, hi)) for n, a, b, t, _ in w.trace.host
                   if n in names and t in main and b > lo and a < hi)
    if not spans:
        return None
    busy = _union((e[1], e[2]) for e in w.trace.device)
    idle, j = 0, 0
    for a, b in spans:                 # both sorted and disjoint
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        t, k = a, j
        while k < len(busy) and busy[k][0] < b:
            idle += max(0, busy[k][0] - t)
            t = max(t, busy[k][1])
            k += 1
        idle += max(0, b - t)
    return idle / 1e6 / w.attempted


def read(w):
    return idle_in_spans(w, NAMES)
