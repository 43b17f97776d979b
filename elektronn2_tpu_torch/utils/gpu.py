"""Device-selection helpers of the reference's startup code.

Port of ``elektronn2_tpu/utils/gpu.py`` (reference: ``elektronn2/utils/
gpu.py``): ``initgpu`` and ``get_free_gpu``, on ``torch.cuda``.
"""

from __future__ import annotations

import torch

from ..log import logger


def initgpu(gpu="auto"):
    """Select a device as the reference's ``--gpu`` values ask: 'auto' or
    None (the first card), an index, or 'none' / 'cpu' (the CPU). Makes the
    chosen card current; returns the ``torch.device``. A card asked for
    where there is none raises."""
    if gpu in ("none", "cpu"):
        logger.info("initgpu: CPU")
        return torch.device("cpu")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(f"initgpu({gpu!r}): no CUDA device; pass 'cpu' "
                           "to run on the CPU")
    idx = 0 if gpu in ("auto", None) else int(gpu)
    if not 0 <= idx < n:
        raise ValueError(f"initgpu: device index {idx} out of range "
                         f"({n} card(s))")
    torch.cuda.set_device(idx)
    dev = torch.device("cuda", idx)
    logger.info(f"initgpu: using {dev} ({torch.cuda.get_device_name(idx)})")
    return dev


def get_free_gpu(wait=0, nb_gpus=-1):
    """Index of the card with the most free memory (``torch.cuda.
    mem_get_info``), or -1 without one. ``wait`` and ``nb_gpus`` are
    accepted for the reference's signature."""
    if not torch.cuda.is_available():
        return -1
    free = [torch.cuda.mem_get_info(i)[0]
            for i in range(torch.cuda.device_count())]
    return max(range(len(free)), key=free.__getitem__) if free else -1
