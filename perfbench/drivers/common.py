"""What the drivers share: device helpers and the window record."""

import gc
import math
import sys
import time
from types import SimpleNamespace

import torch

from .. import weights


def mark(ctx, what):
    """Say on standard error how far set-up has come: seconds since the
    run's start when ``what`` was done."""
    print(f"perfbench: set-up {what} done at "
          f"{time.perf_counter() - ctx.t0:.2f} s", file=sys.stderr)


def sync(device):
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def device_kind(device):
    if str(device).startswith("cuda"):
        return torch.cuda.get_device_name()
    return "cpu"


def reset_peak(device):
    if str(device).startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device):
    if str(device).startswith("cuda"):
        return int(torch.cuda.max_memory_allocated())
    return 0


def release(device):
    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()


def sample(seed, tag, count, within):
    """``count`` distinct indices below ``within``, drawn from ``seed``."""
    g = torch.Generator().manual_seed(weights.sub_seed(seed, tag))
    return sorted(torch.randperm(within, generator=g)[:count].tolist())


def record(ctx, **fields):
    """The window record the metric readers read; ``setup_s`` is taken
    from the run's start to now (call it as the window opens)."""
    w = SimpleNamespace(trace=None, requests=0, steps=0, slabs=0,
                        voxels_out=0, voxels_in=0, latencies_s=[],
                        model_flops=0.0, k1_bound_s=0.0, k1_counter=None,
                        timings=None, checks=[], attempted=0, failed=0,
                        device_kind=device_kind(ctx.device), peak_bytes=0)
    w.__dict__.update(fields)
    w.setup_s = time.perf_counter() - ctx.t0
    return w


def worst(gaps):
    """The largest of ``gaps``, or NaN if any is not finite (``max`` would
    pass over a NaN after the first value)."""
    gaps = list(gaps)
    if not gaps or not all(math.isfinite(g) for g in gaps):
        return float("nan")
    return max(gaps)


def max_abs_gap(got, ref):
    """The largest absolute difference, as a float (NaN if either holds a
    non-finite value or the shapes differ)."""
    if tuple(got.shape) != tuple(ref.shape):
        return float("nan")
    d = (got.to(ref.device) - ref).abs().max()
    return float(d) if bool(torch.isfinite(got).all()) else float("nan")
