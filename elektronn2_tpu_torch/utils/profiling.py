"""Profiling and timing helpers.

Port of ``elektronn2_tpu/utils/profiling.py`` (reference: Theano function
profiling, ``Model.measure_exectimes`` and ``scripts/elektronn2-profile``):
a ``torch.profiler`` trace, FLOP counts from
``torch.utils.flop_counter.FlopCounterMode``, wall-clock timing that
synchronises the card, and the directory the port builds its kernels into.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from ..log import logger


@contextlib.contextmanager
def trace(logdir="torch-trace"):
    """Record a ``torch.profiler`` trace (CPU and, where there is a card,
    CUDA activity) of the block and write it to ``logdir`` as a Chrome
    trace (TensorBoard / Perfetto). Yields the profiler.

    Usage:
        with profiling.trace("trace_dir"):
            model.trainingstep(d, t)
    """
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info(f"device trace written to {path}")


def cost_analysis(fn, *example_args, **example_kwargs):
    """FLOPs of one call of ``fn`` on the example arguments, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (the call runs):
    ``{"flops": total, "by_op": {op: flops}}``. Bytes are not counted."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*example_args, **example_kwargs)
    by_op = {}
    for ops in counter.get_flop_counts().values():
        for op, n in ops.items():
            by_op[str(op)] = max(by_op.get(str(op), 0), int(n))
    return {"flops": int(counter.get_total_flops()), "by_op": by_op}


def _sync_all(out):
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out


def benchmark(fn, *args, n_warmup=2, n_runs=10, sync=None):
    """Seconds per call of ``fn(*args)``: ``n_warmup`` calls, then
    ``n_runs`` back to back, timed on the host clock up to ``sync(out)``
    (default: ``torch.cuda.synchronize()`` when the card is in use)."""
    sync = sync or _sync_all
    for _ in range(n_warmup):
        sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n_runs):
        out = fn(*args)
    sync(out)
    return (time.perf_counter() - t0) / n_runs


def flops_per_second(fn, flops, *args, **bench_kwargs):
    """(``flops`` / seconds per call, seconds per call) of ``fn(*args)``."""
    dt = benchmark(fn, *args, **bench_kwargs)
    return flops / dt, dt


def enable_compile_cache(cache_dir=None, min_compile_secs=2.0):
    """Point the port's kernel builds (``utils/cuda_build.py``'s ``nvcc``
    libraries and ``utils/native_build.py``'s host cores) at ``cache_dir``,
    else ``$ELEKTRONN2_COMPILE_CACHE``, else the package's ``_build``
    directory (the default). A library whose source is unchanged loads
    from there without a build. Returns the directory.

    ``min_compile_secs`` is the JAX package's threshold below which a
    compiled program is not cached. It is accepted and has no effect here:
    every kernel build is kept, however short it took."""
    from . import cuda_build, native_build
    cache_dir = (cache_dir or os.environ.get("ELEKTRONN2_COMPILE_CACHE")
                 or cuda_build.BUILD_DIR)
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError as e:       # never fail the caller over a cache
        logger.warning(f"kernel build directory {cache_dir!r} unusable: {e}")
        return cuda_build.BUILD_DIR
    cuda_build.BUILD_DIR = native_build.BUILD_DIR = cache_dir
    logger.debug(f"kernel build directory: {cache_dir}")
    return cache_dir
