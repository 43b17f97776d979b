"""Profiling and timing helpers.

Port of ``elektronn2_tpu/utils/profiling.py`` (reference: Theano function
profiling, ``Model.measure_exectimes`` and ``scripts/elektronn2-profile``):
a ``torch.profiler`` trace, the port's host spans, FLOP counts from
``torch.utils.flop_counter.FlopCounterMode``, wall-clock timing that
synchronises the card, and the directory the port builds its kernels into.

*Spans*. The port marks where its serving work happens with :func:`span`,
and its own kernel launches with :func:`launch_op`; both cost one flag read
when no profiler runs. The spans (``neuromancer/inference.py``):

- ``predict_dense_device``: the whole call; what no node span holds is the
  path's own pads, trims, casts, phase merges and copies;
- ``dense/<node name>``: one node's evaluation on the dilated path
  (``dilated_dense_forward``) or the conv-dense walk
  (``convolutional_dense_forward`` and the sweep's batched chunks);
- ``dense.pool``: a pool inside a node (the dilated path's pools,
  ``Conv._pool``, ``Pool._compute``);
- ``sweep_knossos`` (the call), and on its main thread
  ``sweep_knossos.wait_stage`` (waiting for the staging thread),
  ``sweep_knossos.enqueue`` (a chunk's copy to the card, its forward and
  read-back enqueued), ``sweep_knossos.wait_write`` (the writer more than
  ``WRITE_DEPTH`` chunks behind) and ``sweep_knossos.drain`` (the last
  write-backs); on its worker threads ``sweep_knossos.stage`` and
  ``sweep_knossos.write``. Each worker is one thread taking chunks in
  order, so the n-th ``stage`` or ``write`` span on its thread is chunk
  n's, as the n-th ``enqueue`` is on the main thread.

K1 and K4 open the op ``tailconv.launch`` around their ``ctypes`` launch,
so that the profiler links their kernels to a host op, and through it to
the node span they ran in, as it links aten's kernels to their ops.
A profiler records only the threads it was started on unless told
otherwise: :func:`trace` records every thread, so the sweep's worker spans
are in its file.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from ..log import logger


#: the prefix of a dense path's node span: ``dense/<node name>``
NODE_SPAN = "dense/"
#: the span of a pool inside a node
POOL_SPAN = "dense.pool"

#: what :func:`span` returns while no profiler runs
_OFF = contextlib.nullcontext()


def span(name):
    """A host span ``name`` on the profiler's clock
    (``torch.profiler.record_function``), around a ``with`` block. While no
    profiler runs it is one shared null context, whose cost is the flag
    read."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def launch_op(name):
    """A host op ``name`` around one of the port's own kernel launches (a
    ``ctypes`` call, which no aten op wraps). Unlike a span it is an op, as
    an aten op is, so the profiler links the kernel it launches to it, and
    a trace reader finds that kernel under the spans around the launch.
    While no profiler runs it is the shared null context."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name, (), {})


@contextlib.contextmanager
def trace(logdir="torch-trace"):
    """Record a ``torch.profiler`` trace (CPU and, where there is a card,
    CUDA activity) of the block and write it to ``logdir`` as a Chrome
    trace (TensorBoard / Perfetto). Yields the profiler.

    Every thread is recorded (``profile_all_threads``), so the spans of
    the sweep's staging and writer threads are in the file beside the main
    thread's. The spans are listed in this module's docstring.

    Usage:
        with profiling.trace("trace_dir"):
            model.trainingstep(d, t)
    """
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    cfg = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=acts, experimental_config=cfg) as prof:
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
