"""The 95th percentile of the latency of every request in the window, from
the call to its result ready on the card (host clock), in ms."""

import statistics


def read(w):
    if len(w.latencies_s) < 20:
        return None
    return statistics.quantiles(w.latencies_s, n=20)[-1] * 1e3
