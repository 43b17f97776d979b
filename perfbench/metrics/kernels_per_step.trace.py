"""Device kernels a rollout step in the traced window: every kernel of the
requests' graph replays (and of their decode) over requests x steps.
Nothing when no kernel ran."""


def read(w):
    if w.trace is None or not w.steps:
        return None
    n = len(w.trace.kernels())
    return n / w.steps if n else None
