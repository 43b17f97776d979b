"""Seconds from the run's start to its window: imports, kernel builds and
loads, weights and inputs, warm-up."""


def read(w):
    return w.setup_s
