"""The training loop.

Port of ``elektronn2_tpu/training/trainer.py::Trainer`` (reference:
``elektronn2/training/trainer.py``: ``run``, ``test_model``,
``debug_getbatch``, preview predictions, rolling saves). Batches stream
from background workers (``parallelisation.BackgroundProc``), each step is
one ``Model.trainingstep`` on the card (forward, backward and update in
place), schedules change live hyperparameters, and monitoring reads only
the previous step's loss, so the host's one sync a step overlaps the
current step.

What differs from the JAX package:

- The Trainer runs on ``device`` (``config.device``, the card, unless the
  caller asks for the CPU; no card raises, there is no fallback). A model
  from ``create_model()`` is built on the CPU and moved there before its
  optimiser is made; ``model_load_path`` loads onto it.
- Host batches (numpy) reach the card through ``fused_loop.PinnedStage``:
  pinned buffers in two slots and a non-blocking copy, so a step makes no
  host sync of its own.
- The forked workers start after the first step, when CUDA is up in the
  parent: a data source they run must be numpy only
  (``parallelisation``'s module docstring).
- ``fused_steps`` runs ``FusedTrainLoop`` (a ``device_batch`` source) or
  ``HostFedFusedLoop`` (a host source): one CUDA graph replay a chunk. The
  tracing trainer's state carry rides the host-fed chunk
  (``HostFedFusedLoop(carry_map=...)``).
- ``mesh_axes`` (``{"data": n}``) trains data-parallel through
  ``Model.use_mesh`` over a ``torch.distributed`` mesh: every rank draws
  the same global batch (the same seeds; no background workers on more
  than one rank, whose queue order would differ by rank) and keeps its
  rows. Checkpoints are npz (orbax is a JAX format) written by rank 0;
  ``resume=True`` reloads on every rank and meshes again. Logging, the
  log file and the history come from rank 0 only. Tensor, spatial and
  pipeline axes are not ported (ROADMAP.md item 8d/8e).

``TracingTrainer`` and ``TracingTrainerRNN`` (the recurrent tracing
workload over ``AgentData``) are the JAX package's, with the per-step
truncated BPTT through ``feed_overrides`` and ``debug_outputs``.
"""

from __future__ import annotations

import contextlib
import inspect
import logging
import os
import time

import numpy as np

from ..config import config
from ..log import add_file_handler, logger
from ..neuromancer.model import modelload, target_device
from ..parallel.multihost import is_main_process
from .fused_loop import FusedTrainLoop, HostFedFusedLoop, PinnedStage
from .parallelisation import BackgroundProc
from .trainutils import (ConsoleControl, HistoryTracker, Schedule, TBWriter,
                         pretty_string_time)


class Trainer:
    """Drive model training from an experiment configuration.

    Accepts either an ``ExperimentConfig`` (see config.py — the exec'd
    Python file surface of the reference) or explicit ``model=...,
    data=...`` objects plus keyword overrides. ``device`` is where the
    model trains (default ``config.device``, the card).
    """

    def __init__(self, exp_config=None, model=None, data=None, device=None,
                 **kwargs):
        cfg = {}
        if exp_config is not None:
            cfg.update(exp_config.as_dict()
                       if hasattr(exp_config, "as_dict") else vars(exp_config))
        cfg.update(kwargs)
        self.cfg = cfg
        self.device = target_device(device or config.device)
        self.save_path = cfg.get("save_path", "./")
        self.save_name = cfg.get("save_name", "model")
        self.batch_size = int(cfg.get("batch_size", 1))
        self.n_steps = int(cfg.get("n_steps", 1000))
        self.max_runtime = float(cfg.get("max_runtime", 4 * 24 * 3600))
        self.history_freq = int(cfg.get("history_freq", 200))
        self.preview_freq = int(cfg.get("preview_freq", 0) or 0)
        self.save_freq = int(cfg.get("save_freq", 1000))
        self.monitor_batch_size = int(cfg.get("monitor_batch_size",
                                              self.batch_size))
        self.data_batch_args = dict(cfg.get("data_batch_args", {}))
        self.n_workers = int(cfg.get("n_workers", 2))
        self.preview_data = cfg.get("preview_data")
        self.preview_kwargs = dict(cfg.get("preview_kwargs", {}))
        self.schedules = dict(cfg.get("schedules", {}))
        self.is_main = is_main_process()
        if not self.is_main:             # rank 0 logs for the group
            logger.setLevel(logging.WARNING)

        # crash recovery: resume=True picks up the rolling -LAST.mdl
        # (params, optimiser state, step counter) when one exists
        if cfg.get("resume") and model is None \
                and not cfg.get("model_load_path"):
            last = os.path.join(self.save_path, self.save_name
                                + "-LAST.mdl")
            if os.path.exists(last):
                cfg["model_load_path"] = last
                logger.info(f"resume: found checkpoint {last}")

        # model: direct, from config factory, or from a saved file
        self.model = model
        if self.model is None:
            if cfg.get("model_load_path"):
                self.model = modelload(cfg["model_load_path"],
                                       device=self.device)
            elif cfg.get("create_model"):
                self.model = cfg["create_model"]()
            else:
                raise ValueError("no model: pass model=, create_model() "
                                 "in the config, or model_load_path")
        if self.model.device != self.device:
            self.model.to(self.device)
        if self.model.optimiser is None:
            opt_name = cfg.get("optimiser", "Adam")
            self.model.set_opt(opt_name, **dict(cfg.get("optimiser_params",
                                                        {})))
        # scale-out from the config surface: mesh_axes = {"data": n}
        if cfg.get("mesh_axes"):
            from ..parallel import make_mesh
            axes = dict(cfg["mesh_axes"])
            self.model.use_mesh(
                make_mesh(axes, devices=self.device.type),
                model_axis="model" if "model" in axes else None)
            if self.model._dp.world > 1 and self.n_workers:
                logger.info("mesh of more than one rank: no background "
                            "workers (every rank draws the same batches)")
                self.n_workers = 0
            logger.info(f"training mesh: {axes}")

        # data: direct or from config
        self.data = data
        if self.data is None and cfg.get("data_class") is not None:
            data_class = cfg["data_class"]
            if isinstance(data_class, str):
                from .. import data as dmod
                data_class = getattr(dmod, data_class)
            kw = dict(cfg.get("data_init_kwargs", {}))
            if "device" in inspect.signature(data_class).parameters:
                kw.setdefault("device", self.device)   # on-card sources
            self.data = data_class(**kw)
        if self.data is not None and hasattr(self.data,
                                             "link_model_geometry"):
            if getattr(self.data, "patch_size", None) is None:
                self.data.link_model_geometry(self.model)

        os.makedirs(self.save_path, exist_ok=True)
        if self.is_main:
            add_file_handler(os.path.join(self.save_path,
                                          self.save_name + ".log"))
        self.history = HistoryTracker()
        self.console = None
        self.step = getattr(self.model, "_step_count", 0)
        self._bind_schedules()       # after self.step: lindec resume
        # semantics need the checkpointed step (Schedule.bind_variable)
        if self.step and self.data is not None \
                and hasattr(self.data, "reseed"):
            # restart-from-checkpoint must NOT replay the batch sequence
            # from step 1: fold the resume step into the data stream's RNG
            self.data.reseed(self.step)
        self._bg = None
        self._stage = None
        self._tb = (TBWriter(os.path.join(self.save_path, "tb",
                                          self.save_name))
                    if cfg.get("tensorboard") else None)

    def _tb_scalars(self, loss, err=np.nan, va_loss=None, va_err=None):
        if self._tb is None:
            return
        self._tb.scalar("train/loss", loss, self.step)
        lr = self.model.optimiser.hyperparams.get("lr")
        if lr is not None:
            self._tb.scalar("train/lr", lr, self.step)
        if err == err:   # not NaN
            self._tb.scalar("train/error", err, self.step)
        if va_loss is not None:
            self._tb.scalar("valid/loss", va_loss, self.step)
        if va_err is not None:
            self._tb.scalar("valid/error", va_err, self.step)

    # ------------------------------------------------------------- plumbing
    def _bind_schedules(self):
        bound = {}
        for key, sched in self.schedules.items():
            if isinstance(sched, dict):
                sched = Schedule(**sched)
            if key in self.model.optimiser.hyperparams:
                sched.bind_variable(obj=self.model.optimiser, prop_name=key,
                                    start_step=self.step,
                                    total_steps=self.n_steps)
            else:
                sched.bind_variable(obj=self, prop_name=key,
                                    start_step=self.step,
                                    total_steps=self.n_steps)
            bound[key] = sched
        self.schedules = bound

    def to_device(self, d, t=None):
        """A host batch ``(d, t)`` (numpy; ``t`` may be None) as the model's
        feed: on the card through the pinned slots (``PinnedStage``, a
        non-blocking copy), on the CPU as it is. Device tensors pass."""
        if self.device.type != "cuda" or not isinstance(d, np.ndarray):
            return d, t
        if self._stage is None:
            self._stage = PinnedStage(self.device)
        arrays = {"d": d} if t is None else {"d": d, "t": t}
        out = self._stage.stage(arrays)
        return out["d"], out.get("t")

    def _train_batch(self, batch):
        """One training step on a host batch: staged to the device, then
        ``trainingstep``. Returns the step's (loss, aux) as device tensors;
        no host sync."""
        d, t = self.to_device(batch[0], batch[1] if len(batch) > 1 else None)
        return self.model.trainingstep(d, t, **self._step_kwargs())

    def debug_getbatch(self):
        return self.data.getbatch(self.batch_size, source="train",
                                  **self.data_batch_args)

    def save_model(self, suffix="-LAST"):
        path = os.path.join(self.save_path, self.save_name + suffix + ".mdl")
        self.model.save(path)
        return path

    def preview_prediction(self):
        if self.preview_data is None:
            logger.warning("no preview_data configured")
            return None
        out = self.model.predict_dense(self.preview_data,
                                       **self.preview_kwargs)
        try:
            from ..utils.plotting import save_preview_images
            save_preview_images(out, os.path.join(
                self.save_path, f"{self.save_name}-preview-{self.step}"))
        except Exception as e:  # pragma: no cover
            logger.warning(f"preview plotting failed: {e}")
        return out

    def _data_guard(self):
        """Lock serialising data.getbatch against a fused loop's prefetch
        thread (the RandomState inside a data source is not thread-safe);
        nullcontext outside fused host-fed runs."""
        lock = getattr(self, "_data_lock", None)
        return lock if lock is not None else contextlib.nullcontext()

    def test_model(self, source="valid"):
        """Validation loss/error on one monitoring batch."""
        try:
            with self._data_guard():
                d, t = self.data.getbatch(self.monitor_batch_size,
                                          source=source,
                                          **{**self.data_batch_args,
                                             "warp": False})
        except (ValueError, RuntimeError) as e:
            if not getattr(self, "_warned_no_valid", False):
                self._warned_no_valid = True
                logger.warning(
                    f"no {source!r} data available ({e}) — validation "
                    "skipped (configure valid_cubes for held-out metrics)")
            return np.nan, np.nan
        loss, err = self.model.test_error(*self.to_device(d, t))
        return (float(loss), float(err) if err is not None else np.nan)

    # ------------------------------------------------------------ the loop
    def run(self):
        """The training hot loop. Reference: ``Trainer.run``."""
        model, data = self.model, self.data
        t_start = time.time()
        self.console = ConsoleControl(self)
        fused = int(self.cfg.get("fused_steps", 0) or 0)
        if fused > 1:
            if data is None:
                raise ValueError("fused_steps requires a data source")
            # device-resident sources fuse sampling+augmentation into the
            # chunk; host sources get the host-fed variant (K stacked
            # batches per replay — still one launch + one readback per K
            # steps)
            return self._run_fused(fused, t_start)
        use_bg = data is not None and self.n_workers > 0
        if use_bg and type(data).__name__ == "DeviceBatchAugmenter":
            # device-side producer: batches are made on the card in the
            # main process; background host workers add nothing
            use_bg = False
        logger.info(f"training {model.name} on {self.device}: "
                    f"{self.n_steps} steps, batch {self.batch_size}, "
                    f"{model.param_count} params")
        if use_bg and self.step < self.n_steps:
            # run the FIRST step synchronously before starting the workers
            # (CUDA, cuDNN and the first batch are set up with no worker
            # competing for the host); the workers then fork with CUDA up
            batch = data.getbatch(self.batch_size, **self.data_batch_args)
            loss, aux = self._train_batch(batch)
            self._post_step(aux)
            self.step += 1
            self.history.update_timeline(self.step, float(loss))
            for sched in self.schedules.values():
                sched.update(self.step, self.n_steps)
            logger.info(f"step {self.step}/{self.n_steps} (warmup) "
                        f"loss={float(loss):.4f}")
            self._bg = BackgroundProc(
                data.getbatch, n_proc=self.n_workers,
                target_args=(self.batch_size,),
                target_kwargs=dict(self.data_batch_args),
                queue_size=max(2, self.n_workers * 2),
                mode=self.cfg.get("worker_mode", "process"))
            if getattr(self._bg, "_target_lock", None) is not None:
                # thread-mode workers share the data source's RandomState
                # with the main thread's validation/preview getbatch calls
                # — serialise them on the worker lock (process/spawn modes
                # fork their own copy, no lock there)
                self._data_lock = self._bg._target_lock
        last_loss, last_err = np.nan, np.nan
        t_step = time.time()
        self._t_step_at = self.step
        # async monitoring: the loss scalar of step N is materialised only
        # AFTER step N+1 has been launched (a one-step lag), so the host's
        # sync overlaps device compute instead of stalling it; every
        # logging/validation boundary flushes the lagged value first
        pending = None                 # (step_id, device loss, aux)

        def flush():
            nonlocal pending
            if pending is None:
                return np.nan
            sid, lv, paux = pending
            lv = float(lv)
            self.history.update_timeline(sid, lv)
            pending = None
            return lv

        try:
            while self.step < self.n_steps:
                if self.console.paused:
                    time.sleep(0.2)
                    # poll() returns False on 'q' — honour it while paused
                    # too, or quit-from-pause spins forever
                    if not self.console.poll():
                        break
                    continue
                batch = (self._bg.get() if use_bg
                         else data.getbatch(self.batch_size,
                                            **self.data_batch_args))
                loss, aux = self._train_batch(batch)
                self._post_step(aux)
                self.step += 1
                flush()                         # materialise the PREVIOUS
                pending = (self.step, loss, aux)
                for sched in self.schedules.values():
                    sched.update(self.step, self.n_steps)

                sync = (self.step % 50 == 0 or self.step == 1
                        or (self.history_freq
                            and self.step % self.history_freq == 0)
                        or (self.preview_freq
                            and self.step % self.preview_freq == 0)
                        or (self.save_freq
                            and self.step % self.save_freq == 0)
                        or (self._tb is not None and self.step % 10 == 0))
                if not sync:
                    if not self.console.poll():
                        break
                    if time.time() - t_start > self.max_runtime:
                        logger.info("max_runtime reached — stopping")
                        break
                    continue
                loss_f = flush()
                # blowup detection/recovery (reference:
                # optimiser.py::repair_fuckup): a non-finite synced loss
                # rolls params/optimiser back to the last finite sync
                # point and halves the lr; finite → refresh the snapshot
                if np.isfinite(loss_f):
                    model.snapshot_good()
                elif model.repair_fuckup(lr_scale=0.5):
                    logger.warning(
                        f"step {self.step}: non-finite loss ({loss_f}) — "
                        "rolled back to the last good snapshot, lr halved "
                        f"to {model.optimiser.hyperparams.get('lr'):.2e}")
                if self._tb is not None and self.step % 10 == 0:
                    self._tb_scalars(loss_f,
                                     float(aux["error"])
                                     if "error" in aux else np.nan)
                if self.step % 50 == 0 or self.step == 1:
                    # divide by the steps actually elapsed since the last
                    # log (1 at the step==1 log, up to 50 after)
                    n_since = (self.step - getattr(self, "_t_step_at", 0))
                    dt = (time.time() - t_step) / max(1, n_since)
                    t_step = time.time()
                    self._t_step_at = self.step
                    logger.info(
                        f"step {self.step}/{self.n_steps} "
                        f"loss={loss_f:.4f} "
                        f"smooth={self.history.loss_smooth:.4f} "
                        f"({dt * 1000:.0f} ms/it, "
                        f"lr={model.optimiser.hyperparams.get('lr'):.2e})")
                if self.history_freq and self.step % self.history_freq == 0:
                    last_loss, last_err = self.test_model()
                    tr_err = float(aux["error"]) if "error" in aux else np.nan
                    self.history.update_history(self.step, loss_f,
                                                tr_err, last_loss, last_err)
                    self._tb_scalars(loss_f, tr_err, last_loss,
                                     last_err)
                    if np.isfinite(last_loss):
                        logger.info(f"validation: loss={last_loss:.4f} "
                                    f"err={last_err:.4f}")
                if self.preview_freq and self.step % self.preview_freq == 0:
                    self.preview_prediction()
                if self.save_freq and self.step % self.save_freq == 0:
                    self.save_model()
                    self.save_history()
                if not self.console.poll():
                    break
                if time.time() - t_start > self.max_runtime:
                    logger.info("max_runtime reached — stopping")
                    break
        except KeyboardInterrupt:
            logger.info("interrupted — saving and exiting")
        finally:
            try:
                flush()                        # record the final step's loss
            except Exception:
                pass
            if self._bg is not None:
                self._bg.shutdown()
            self.console.quit = True
            if self._tb is not None:
                self._tb.close()
            path = self.save_model()
            self.save_history()
            logger.info(f"trained {self.step} steps in "
                        f"{pretty_string_time(time.time() - t_start)}; "
                        f"saved to {path}")
        return self.history

    def _run_fused(self, n_inner, t_start):
        """Launch-minimised loop: ``fused_steps`` training steps per CUDA
        graph replay (``training.fused_loop``). Schedules and
        hyperparameters apply at chunk granularity; a truncated-BPTT state
        carry rides the host-fed chunk (``_fused_carry_map``)."""
        if self._fused_incompatible():
            raise ValueError(
                "fused_steps is incompatible with trainers that inject "
                "per-step feed overrides or post-step hooks "
                f"({type(self).__name__})")
        model = self.model
        # fold the starting step in so a resumed run draws fresh batches
        loop_seed = (int(self.cfg.get("seed", 0))
                     + self.step * 2654435761) % (2 ** 31)
        carry_map = self._fused_carry_map()
        if hasattr(self.data, "device_batch"):
            if carry_map:
                raise ValueError("TBPTT state carry requires a host-fed "
                                 "data source (no device_batch)")
            warp = self.data_batch_args.get("warp", 0.5)
            flip = self.data_batch_args.get("flip", True)
            loop = FusedTrainLoop(model, self.data, self.batch_size,
                                  n_inner, warp=warp, flip=flip,
                                  seed=loop_seed)
            mode = "device-sampled"
        else:
            loop = HostFedFusedLoop(model, self.data, self.batch_size,
                                    n_inner, batch_args=self.data_batch_args,
                                    seed=loop_seed, carry_map=carry_map)
            self._data_lock = loop.data_lock
            mode = "host-fed+TBPTT" if carry_map else "host-fed"
        self.fused_loop = loop
        logger.info(f"training {model.name} on {self.device}: "
                    f"{self.n_steps} steps in {mode} fused chunks of "
                    f"{n_inner}, batch {self.batch_size}, "
                    f"{model.param_count} params")
        last_loss, last_err = np.nan, np.nan
        t_chunk = time.time()
        try:
            while self.step < self.n_steps:
                if self.console.paused:
                    time.sleep(0.2)
                    # poll() returns False on 'q' — honour it while paused
                    # too, or quit-from-pause spins forever
                    if not self.console.poll():
                        break
                    continue
                if self.n_steps - self.step < n_inner:
                    # tail shorter than a chunk: finish with plain steps so
                    # the optimiser runs EXACTLY n_steps updates; a TBPTT
                    # carry continues the chunked chain uninterrupted
                    if isinstance(loop, HostFedFusedLoop):
                        loop.settle()
                    while self.step < self.n_steps:
                        with self._data_guard():
                            batch = self.data.getbatch(
                                self.batch_size, **self.data_batch_args)
                        d, t = self.to_device(
                            batch[0], batch[1] if len(batch) > 1 else None)
                        ov = dict(getattr(loop, "rnn_carry", {}) or {})
                        lv, aux = model.trainingstep(
                            d, t, feed_overrides=ov or None)
                        for scan_name, state_name in (carry_map
                                                      or {}).items():
                            ys = aux.get(scan_name)
                            if ys is not None:
                                loop.rnn_carry[state_name].copy_(ys[-1])
                        self.step += 1
                        self.history.update_timeline(self.step, float(lv))
                        for sched in self.schedules.values():
                            sched.update(self.step, self.n_steps)
                        if not self.console.poll() \
                                or time.time() - t_start > self.max_runtime:
                            break
                    break
                losses, errs = loop.run_chunk()
                for i, lv in enumerate(losses):
                    self.step += 1
                    self.history.update_timeline(self.step, float(lv))
                # blowup recovery at chunk granularity (see run's per-step
                # variant): a chunk ending non-finite rolls back to the
                # last finite chunk boundary
                if np.isfinite(float(losses[-1])):
                    model.snapshot_good()
                elif model.repair_fuckup(lr_scale=0.5):
                    logger.warning(
                        f"step {self.step}: non-finite fused-chunk loss — "
                        "rolled back to the last good snapshot, lr halved "
                        f"to {model.optimiser.hyperparams.get('lr'):.2e}")
                if self._tb is not None:
                    self._tb_scalars(float(losses[-1]),
                                     float(errs[-1]) if errs is not None
                                     else np.nan)
                # schedules fire for every step in the chunk (an %interval
                # schedule unaligned with n_inner must not be skipped);
                # mutated hyperparams apply from the NEXT chunk on
                for s_id in range(self.step - n_inner + 1, self.step + 1):
                    for sched in self.schedules.values():
                        sched.update(s_id, self.n_steps)
                dt = (time.time() - t_chunk) / n_inner
                t_chunk = time.time()
                logger.info(
                    f"step {self.step}/{self.n_steps} "
                    f"loss={float(losses[-1]):.4f} "
                    f"smooth={self.history.loss_smooth:.4f} "
                    f"({dt * 1000:.1f} ms/it fused, "
                    f"lr={model.optimiser.hyperparams.get('lr'):.2e})")
                if self.history_freq and self.step % self.history_freq \
                        < n_inner:
                    last_loss, last_err = self.test_model()
                    tr_err = (float(errs[-1]) if errs is not None
                              else np.nan)
                    self.history.update_history(
                        self.step, float(losses[-1]), tr_err, last_loss,
                        last_err)
                    if np.isfinite(last_loss):
                        logger.info(f"validation: loss={last_loss:.4f} "
                                    f"err={last_err:.4f}")
                if self.preview_freq and self.step % self.preview_freq \
                        < n_inner:
                    self.preview_prediction()
                if self.save_freq and self.step % self.save_freq < n_inner:
                    self.save_model()
                    self.save_history()
                if not self.console.poll():
                    break
                if time.time() - t_start > self.max_runtime:
                    logger.info("max_runtime reached — stopping")
                    break
        except KeyboardInterrupt:
            logger.info("interrupted — saving and exiting")
        finally:
            self.console.quit = True
            if hasattr(loop, "close"):
                loop.close()            # stop the host-fed prefetch thread
            self._data_lock = None
            if self._tb is not None:
                self._tb.close()
            path = self.save_model()
            self.save_history()
            logger.info(f"trained {self.step} steps in "
                        f"{pretty_string_time(time.time() - t_start)}; "
                        f"saved to {path}")
        return self.history

    def _step_kwargs(self):
        """Extra kwargs for model.trainingstep (hook for subclasses)."""
        return {}

    def _post_step(self, aux):
        """Per-step hook after trainingstep (subclasses: state carry)."""

    def _fused_incompatible(self):
        """True when this trainer's per-step hooks preclude the fused
        chunk. Subclasses whose hooks are conditionally inert override."""
        return (type(self)._step_kwargs is not Trainer._step_kwargs
                or type(self)._post_step is not Trainer._post_step)

    def _fused_carry_map(self):
        """{scan_node_name: state_node_name} for fused TBPTT, or None
        (hook for TracingTrainer's carry_state)."""
        return None

    def save_history(self):
        if not self.is_main:
            return
        prefix = os.path.join(self.save_path, self.save_name)
        self.history.save(prefix)
        try:
            self.history.plot(prefix)
            self.history.html_report(prefix, title=self.save_name)
        except Exception as e:  # pragma: no cover
            logger.warning(f"history plot failed: {e}")


class TracingTrainer(Trainer):
    """Trainer for the recurrent skeleton-tracing workload.

    Reference: ``trainer.py::TracingTrainer``: drives ``AgentData`` tracing
    batches (``get_tracing_batch``, ``n_scan_steps`` long) through a
    ScanN/GRU model. With ``carry_state=True`` the scan's final hidden state
    is fed back as the next batch's initial state, a detached value, so
    gradients stop at batch boundaries (truncated BPTT). With
    ``fused_steps`` the carry rides the host-fed chunk
    (``HostFedFusedLoop(carry_map=...)``).
    """

    def __init__(self, exp_config=None, model=None, data=None,
                 n_scan_steps=8, carry_state=False, **kwargs):
        super().__init__(exp_config, model, data, **kwargs)
        self.n_scan_steps = int(n_scan_steps)
        self.carry_state = bool(carry_state)
        self._carry = {}
        self._carry_map = {}
        if self.carry_state:
            from ..neuromancer.various import ScanN
            for node in self.model.nodes.values():
                if (isinstance(node, ScanN) and len(node.in_memory) == 1
                        and node.out_memory == [node.step_result]
                        and not node.last_only):
                    self._carry_map[node.name] = node.in_memory[0].name
                    if node not in self.model.debug_outputs:
                        self.model.debug_outputs.append(node)
            if not self._carry_map:
                logger.warning("carry_state=True but no carryable ScanN "
                               "node found")

    def _step_kwargs(self):
        return ({"feed_overrides": dict(self._carry)} if self._carry
                else {})

    def _post_step(self, aux):
        for scan_name, state_name in self._carry_map.items():
            ys = aux.get(scan_name)
            if ys is not None:
                self._carry[state_name] = ys[-1].detach()   # truncation

    def debug_getbatch(self):
        return self.data.get_tracing_batch(self.batch_size,
                                           n_steps=self.n_scan_steps)

    def _fused_incompatible(self):
        # the per-step hooks are inert without carry_state, and the carry
        # itself rides the fused chunk (_fused_carry_map)
        return False

    def _fused_carry_map(self):
        """carry_state=True in fused mode: the ScanN hidden state rides the
        chunk and crosses chunks. The learnable initial state is fed as a
        value at the very first step, so unlike the per-step path it gets
        no gradient from the first batch (used once per run)."""
        return dict(self._carry_map) if self.carry_state else None

    def preview_rollout(self, n_agents=16, max_steps=128, seeds=None,
                        cube=0):
        """Roll the current model out as a batch of agents
        (``DeviceTracer``, K2 on the card) over a training cube and log
        simple quality statistics (mean length, mean tortuosity); returns
        the traces."""
        from ..data.tracing_utils import DeviceTracer
        vol = np.asarray(self.data.train_d[int(cube)], np.float32)
        tracer = DeviceTracer(self.model, vol, max_steps=int(max_steps))
        if seeds is None:
            rng = np.random.RandomState(self.step)
            margin = np.asarray(tracer.patch_size) / 2 + 2
            lo, hi = margin, np.asarray(vol.shape[1:]) - margin
            seeds = rng.uniform(lo, hi, size=(int(n_agents), 3))
        traces = tracer.trace_batch(seeds)
        lens = [len(t.coords) for t in traces]
        torts = [t.tortuosity() for t in traces if len(t.coords) > 2]
        logger.info(
            f"rollout preview @step {self.step}: {len(traces)} agents, "
            f"mean length {np.mean(lens):.1f}, mean tortuosity "
            f"{np.mean(torts) if torts else float('nan'):.2f}")
        return traces

    def run(self):
        # tracing batches come from get_tracing_batch instead of getbatch
        orig = self.data.getbatch if self.data is not None else None
        if self.data is not None:
            self.data.getbatch = (
                lambda bs, **kw: self.data.get_tracing_batch(
                    bs, n_steps=self.n_scan_steps,
                    source=kw.get("source", "train")))
        try:
            return super().run()
        finally:
            if orig is not None:
                self.data.getbatch = orig


class TracingTrainerRNN(TracingTrainer):
    """``trainer.py::TracingTrainerRNN``: ``TracingTrainer`` with
    ``carry_state=True`` by default (truncated BPTT across batches; in fused
    mode the state rides the chunk)."""

    def __init__(self, exp_config=None, model=None, data=None,
                 n_scan_steps=8, carry_state=True, **kwargs):
        super().__init__(exp_config, model, data,
                         n_scan_steps=n_scan_steps,
                         carry_state=carry_state, **kwargs)
