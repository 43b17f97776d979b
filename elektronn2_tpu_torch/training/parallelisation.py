"""Background batch production.

Jax-free copy of ``elektronn2_tpu/training/parallelisation.py``. Reference: ``elektronn2/training/parallelisation.py::BackgroundProc,
SharedQ, SharedMem`` — fork()ed worker processes pushing batches through
shared ctypes memory.

Two backends with one surface (``get()``, ``reset()``, ``shutdown()``):

* ``mode='process'`` (default, = ``'fork'``): fork()ed workers, batches
  returned through a multiprocessing queue — the reference's design. The
  Trainer forks them after its first step, when CUDA is already set up in
  the parent. A forked child that touches CUDA dies ("Cannot re-initialize
  CUDA in forked subprocess"), and one that runs torch CPU ops can hang on
  the parent's intra-op thread pool; so a forked target must be numpy
  only, as ``BatchCreatorImage.getbatch`` is.
* ``mode='spawn'`` / ``mode='forkserver'``: fresh-interpreter workers,
  free of that rule. The target (and everything it closes over) must be
  picklable; lambdas are not.
* ``mode='thread'``: an in-process thread pool — zero-copy, right choice
  when the producer itself touches torch (e.g. DeviceBatchAugmenter) or
  when the dataset must not be forked.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import threading
import time

from ..log import logger


class TimeoutError(RuntimeError):
    pass


def _reseed_target_rngs(target, seed):
    """Reseed numpy RNGs reachable from the target: the global RNG, a bound
    method's self.rng, and (for lambdas/closures, e.g. TracingTrainer's
    wrapped getbatch) any closed-over object carrying .rng or .data.rng."""
    import numpy as np
    np.random.seed(seed)

    def maybe(obj):
        if obj is None:
            return False
        if hasattr(obj, "rng"):
            obj.rng = np.random.RandomState(seed)
            return True
        return False

    self_obj = getattr(target, "__self__", None)
    maybe(self_obj)
    for cell in getattr(target, "__closure__", None) or ():
        try:
            obj = cell.cell_contents
        except ValueError:
            continue
        if not maybe(obj):
            maybe(getattr(obj, "data", None))


def _proc_worker(target, args, kwargs, q, stop, err_flag):
    """Child process loop: produce → enqueue until told to stop."""
    try:
        seed = (os.getpid() * 2654435761) % 2 ** 31
        _reseed_target_rngs(target, seed)
    except Exception:
        pass
    while not stop.is_set():
        try:
            item = target(*args, **kwargs)
        except Exception as e:
            err_flag.set()   # visible to get() even if the queue is full
            while not stop.is_set():
                try:
                    q.put(("__error__", repr(e)), timeout=0.5)
                    break
                except queue.Full:
                    continue
            return
        while not stop.is_set():
            try:
                q.put(("__item__", item), timeout=0.2)
                break
            except queue.Full:
                continue


class BackgroundProc:
    """Run ``target(*args, **kwargs)`` repeatedly in the background,
    buffering results in a bounded queue.

    Usage (mirrors the reference):
        bg = BackgroundProc(data.getbatch, n_proc=2,
                            target_args=(batch_size,),
                            target_kwargs=batch_kwargs)
        batch = bg.get()
        bg.shutdown()
    """

    def __init__(self, target, n_proc=2, target_args=(), target_kwargs=None,
                 queue_size=4, profile=False, mode="process"):
        self.target = target
        self.target_args = tuple(target_args)
        self.target_kwargs = dict(target_kwargs or {})
        self.mode = mode
        self.profile = profile
        self._exc = None
        n_proc = max(1, int(n_proc))
        queue_size = max(1, int(queue_size))
        if mode in ("process", "fork", "spawn", "forkserver"):
            method = "fork" if mode in ("process", "fork") else mode
            self.mode = "process"
            ctx = mp.get_context(method)
            self.q = ctx.Queue(maxsize=queue_size)
            self._stop = ctx.Event()
            self._err_flag = ctx.Event()
            self._workers = [
                ctx.Process(target=_proc_worker,
                            args=(target, self.target_args,
                                  self.target_kwargs, self.q, self._stop,
                                  self._err_flag),
                            daemon=True)
                for _ in range(n_proc)]
        elif mode == "thread":
            self.q = queue.Queue(maxsize=queue_size)
            self._stop = threading.Event()
            self._target_lock = threading.Lock()
            if n_proc > 1:
                logger.warning(
                    f"thread mode serialises target calls (shared RNG is "
                    f"not thread-safe): n_proc={n_proc} threads add no "
                    "prep parallelism — use process mode for that")
            self._workers = [
                threading.Thread(target=self._thread_work, daemon=True,
                                 name=f"bgproc-{i}")
                for i in range(n_proc)]
        else:
            raise ValueError(f"unknown mode {mode!r}")
        for w in self._workers:
            w.start()

    def _thread_work(self):
        while not self._stop.is_set():
            try:
                # one target call at a time: data sources draw from a
                # shared np.RandomState, which is NOT thread-safe —
                # unlocked concurrent getbatch can emit duplicated
                # batches. (Thread mode still overlaps batch prep with
                # the main loop; process mode reseeds per worker and
                # runs truly parallel.)
                with self._target_lock:
                    t0 = time.perf_counter()   # prep time, not lock wait
                    item = self.target(*self.target_args,
                                       **self.target_kwargs)
                if self.profile:
                    logger.debug(f"bgproc item in "
                                 f"{time.perf_counter() - t0:.3f}s")
            except Exception as e:
                self._exc = e
                self._stop.set()
                break
            while not self._stop.is_set():
                try:
                    self.q.put(("__item__", item), timeout=0.2)
                    break
                except queue.Full:
                    continue

    def get(self, timeout=120.0):
        """Fetch the next ready batch (blocking)."""
        deadline = time.monotonic() + timeout
        while True:
            if self._exc is not None:
                raise RuntimeError("background worker failed") from self._exc
            try:
                kind, payload = self.q.get(timeout=0.2)
            except queue.Empty:
                if self.mode == "process" and self._err_flag.is_set():
                    raise RuntimeError(
                        "a background worker failed (see its traceback "
                        "report on the queue or stderr)")
                if self.mode == "process" and not any(
                        w.is_alive() for w in self._workers):
                    raise RuntimeError("all background workers died")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"no batch produced within {timeout}s")
                continue
            if kind == "__error__":
                raise RuntimeError(f"background worker failed: {payload}")
            return payload

    def reset(self):
        """Drop buffered batches (e.g. after data parameters changed)."""
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass

    def shutdown(self):
        self._stop.set()
        self.reset()
        for w in self._workers:
            w.join(timeout=2.0)
        if self.mode == "process":
            for w in self._workers:
                if w.is_alive():
                    w.terminate()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    def __del__(self):
        try:
            self._stop.set()
        except Exception:
            pass


#: reference alias — the queue abstraction and the proc pool were separate
#: classes there; one class serves both here.
SharedQ = BackgroundProc


class SharedMem:
    """Zero-copy numpy array in OS shared memory, visible across worker
    processes (any start method — fork/spawn/forkserver).

    Reference: ``parallelisation.py::SharedMem`` — there: shared ctypes
    buffers carrying batches between fork()ed workers and the trainer.
    Here batches travel the worker queue by default (pickle; fine at EM
    batch sizes); ``SharedMem`` is the zero-copy option for larger
    payloads and the direct equivalent of the reference surface.

    Usage::

        shm = SharedMem.alloc((4, 1, 64, 64, 64), np.float32)
        shm.array[:] = batch                       # producer
        view = SharedMem.attach(shm.name, shm.shape, shm.dtype)  # consumer
        ...
        view.close(); shm.close(); shm.unlink()    # owner unlinks ONCE
    """

    def __init__(self, shm, shape, dtype, owner):
        import numpy as _np
        self._shm = shm
        self.name = shm.name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = _np.dtype(dtype)
        self._owner = bool(owner)
        self.array = _np.ndarray(self.shape, self.dtype, buffer=shm.buf)

    @classmethod
    def alloc(cls, shape, dtype):
        from multiprocessing import shared_memory
        import numpy as _np
        nbytes = int(_np.dtype(dtype).itemsize * _np.prod(shape))
        shm = shared_memory.SharedMemory(create=True, size=max(1, nbytes))
        return cls(shm, shape, dtype, owner=True)

    @classmethod
    def attach(cls, name, shape, dtype):
        from multiprocessing import shared_memory
        return cls(shared_memory.SharedMemory(name=name), shape, dtype,
                   owner=False)

    def close(self):
        # the ndarray view must die before the mapping can close
        self.array = None
        self._shm.close()

    def unlink(self):
        if self._owner:
            self._shm.unlink()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        if self._owner:
            self.unlink()
        return False

    def __repr__(self):
        return (f"<SharedMem {self.name} {self.shape} "
                f"{self.dtype.name}{' owner' if self._owner else ''}>")
