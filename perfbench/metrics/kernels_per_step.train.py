"""Device kernels a training step in the traced window: the augmenter, the
forward and backward passes and the optimiser's update of a chunk's CUDA
graph, over its steps."""


def read(w):
    if w.trace is None or not w.steps:
        return None
    return len(w.trace.kernels()) / w.steps
