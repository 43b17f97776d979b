"""Training-side utilities: history tracking, schedules, live console.

Jax-free copy of ``elektronn2_tpu/training/trainutils.py``; ``Schedule``
binds the port's ``neuromancer.optimiser.Optimiser``. One difference:
``HistoryTracker.save`` writes the ``.history.h5`` through h5py, and where
h5py does not import (the card's machine has none) it logs a warning and
writes nothing, so the Trainer's closing save does not fail (ROADMAP.md
§3). Reference: ``elektronn2/training/trainutils.py::HistoryTracker, Schedule,
user_input, pretty_string_time``.
"""

from __future__ import annotations

import math
import os
import select
import sys
import threading
import time

import numpy as np

from ..log import logger
from ..utils.basic import AccumulationArray, h5save


def pretty_string_time(t):
    """Seconds → 'Xh Ym Zs'. Reference: ``trainutils.pretty_string_time``."""
    t = float(t)
    h, rem = divmod(t, 3600)
    m, s = divmod(rem, 60)
    if h >= 1:
        return f"{int(h)}h {int(m):02d}m {int(s):02d}s"
    if m >= 1:
        return f"{int(m)}m {int(s):02d}s"
    return f"{s:.1f}s"


class HistoryTracker:
    """Accumulates training/validation curves; renders plots and reports.

    Reference: ``trainutils.py::HistoryTracker`` (loss/NLL/error buffers +
    timeline → png/html report). Smoothed loss uses an exponential moving
    average, as there.
    """

    def __init__(self, smoothing=0.995):
        self.timeline = AccumulationArray(right_shape=(4,))  # t, step, loss, smooth
        self.history = AccumulationArray(right_shape=(6,))   # step, t, tr_loss, tr_err, va_loss, va_err
        self.loss_smooth = None
        self.smoothing = float(smoothing)
        self._t0 = time.time()
        self.debug_outputs = {}

    def register_debug_output_names(self, names):
        for n in names:
            self.debug_outputs.setdefault(n, AccumulationArray())

    def update_timeline(self, step, loss, debug=None):
        loss = float(loss)
        if self.loss_smooth is None or math.isnan(self.loss_smooth):
            self.loss_smooth = loss
        else:
            a = self.smoothing
            self.loss_smooth = a * self.loss_smooth + (1 - a) * loss
        self.timeline.append([time.time() - self._t0, step, loss,
                              self.loss_smooth])
        for k, v in (debug or {}).items():
            self.debug_outputs.setdefault(k, AccumulationArray()).append(
                float(np.asarray(v).mean()))

    def update_history(self, step, train_loss, train_err, valid_loss=np.nan,
                       valid_err=np.nan):
        self.history.append([step, time.time() - self._t0,
                             float(train_loss),
                             float(train_err) if train_err is not None
                             else np.nan,
                             float(valid_loss), float(valid_err)])

    def save(self, path_prefix):
        try:
            import h5py  # noqa: F401
        except ImportError:
            logger.warning(f"h5py is not installed: {path_prefix}"
                           ".history.h5 is not written")
            return
        h5save({"timeline": self.timeline.data,
                "history": self.history.data,
                **{f"debug_{k}": v.data
                   for k, v in self.debug_outputs.items()}},
               path_prefix + ".history.h5")

    def html_report(self, path_prefix, title="training report"):
        """Self-contained HTML report embedding the curve images + a stats
        table. Reference: HistoryTracker's html report output."""
        import base64

        def embed(p):
            try:
                with open(p, "rb") as f:
                    b64 = base64.b64encode(f.read()).decode()
                return f'<img src="data:image/png;base64,{b64}"/>'
            except OSError:
                return "<i>(no image)</i>"

        tl = self.timeline.data
        hist = self.history.data
        rows = ""
        if len(tl):
            rows += (f"<tr><td>steps</td><td>{int(tl[-1, 1])}</td></tr>"
                     f"<tr><td>last loss</td><td>{tl[-1, 2]:.5f}</td></tr>"
                     f"<tr><td>smoothed loss</td><td>{tl[-1, 3]:.5f}</td></tr>"
                     f"<tr><td>wall time</td>"
                     f"<td>{pretty_string_time(tl[-1, 0])}</td></tr>")
        if len(hist):
            h = hist[-1]
            rows += (f"<tr><td>train err</td><td>{h[3]:.4f}</td></tr>"
                     f"<tr><td>valid loss</td><td>{h[4]:.4f}</td></tr>"
                     f"<tr><td>valid err</td><td>{h[5]:.4f}</td></tr>")
        doc = (f"<html><head><title>{title}</title></head><body>"
               f"<h2>{title}</h2><table border=1 cellpadding=4>{rows}"
               f"</table><br/>{embed(path_prefix + '.history.png')}"
               f"</body></html>")
        with open(path_prefix + ".report.html", "w") as f:
            f.write(doc)
        return path_prefix + ".report.html"

    def plot(self, path_prefix):
        """Write loss/error curve PNGs (matplotlib Agg)."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception as e:  # pragma: no cover
            logger.warning(f"plotting unavailable: {e}")
            return
        tl = self.timeline.data
        hist = self.history.data
        fig, axes = plt.subplots(1, 2, figsize=(11, 4))
        if len(tl):
            axes[0].plot(tl[:, 1], tl[:, 2], lw=0.4, alpha=0.4,
                         label="loss")
            axes[0].plot(tl[:, 1], tl[:, 3], lw=1.5, label="smoothed")
            axes[0].set_xlabel("step")
            axes[0].legend()
        if len(hist):
            axes[1].plot(hist[:, 0], hist[:, 3], label="train err")
            valid = ~np.isnan(hist[:, 5])
            if valid.any():
                axes[1].plot(hist[valid, 0], hist[valid, 5],
                             label="valid err")
            axes[1].set_xlabel("step")
            axes[1].legend()
        fig.tight_layout()
        fig.savefig(path_prefix + ".history.png", dpi=110)
        plt.close(fig)


class TBWriter:
    """Optional TensorBoard scalar sink (SURVEY.md §6 observability:
    'same artifacts + optional TensorBoard scalars'). Degrades to a no-op
    with a warning when tensorboard isn't importable."""

    def __init__(self, logdir):
        self._w = None
        err = None
        for importer in (
                lambda: __import__("torch.utils.tensorboard",
                                   fromlist=["SummaryWriter"]
                                   ).SummaryWriter,
                lambda: __import__("tensorboardX",
                                   fromlist=["SummaryWriter"]
                                   ).SummaryWriter):
            try:
                self._w = importer()(logdir)
                break
            except Exception as e:  # pragma: no cover
                err = e
        if self._w is None:  # pragma: no cover
            logger.warning(f"no tensorboard writer available ({err}); "
                           "scalars off — install torch or tensorboardX")

    def scalar(self, tag, value, step):
        if self._w is not None and value is not None \
                and math.isfinite(float(value)):
            self._w.add_scalar(tag, float(value), int(step))

    def close(self):
        if self._w is not None:
            self._w.flush()
            self._w.close()


class Schedule:
    """Declarative hyperparameter schedule.

    Reference: ``trainutils.py::Schedule`` — binds to an optimiser
    hyperparam (shared variable there; live dict here) or any object
    attribute, updating per step. Modes:
      * ``dec``: exponential decay ``value *= dec`` every ``interval`` steps
      * ``lindec``: linear from current value to 0 over ``n_steps``
      * ``updates``: explicit [(step, value), ...] table

    Usage:
        lr_schedule = Schedule(dec=0.995)
        lr_schedule.bind_variable(obj=optimiser, prop_name='lr')
    """

    def __init__(self, dec=None, lindec=None, updates=None, interval=1000):
        if sum(x is not None for x in (dec, lindec, updates)) != 1:
            raise ValueError("specify exactly one of dec/lindec/updates")
        self.dec = dec
        self.lindec = lindec
        self.updates = sorted(updates) if updates else None
        self.interval = int(interval)
        self._obj = None
        self._prop = None
        self._initial = None
        self._last_step = None

    def bind_variable(self, obj=None, prop_name=None, initial_val=None,
                      start_step=0, total_steps=None):
        self._obj = obj
        self._prop = prop_name
        if initial_val is not None:
            self._set(initial_val)
        self._initial = self._get()
        if self.lindec is not None and start_step:
            # resume: the bound value was checkpointed ALREADY decayed at
            # start_step — reconstruct the step-0 initial, else the next
            # update() decays twice (0.5·lr0 at half-way would resume as
            # 0.25·lr0 with the wrong slope; review r2 s5)
            total = float(total_steps or self.lindec)
            frac = 1.0 - start_step / total
            if frac > 1e-9:
                self._initial = self._get() / frac
        return self

    def _get(self):
        from ..neuromancer.optimiser import Optimiser
        if isinstance(self._obj, Optimiser):
            return self._obj.hyperparams[self._prop]
        return getattr(self._obj, self._prop)

    def _set(self, v):
        from ..neuromancer.optimiser import Optimiser
        if isinstance(self._obj, Optimiser):
            self._obj.hyperparams[self._prop] = float(v)
        else:
            setattr(self._obj, self._prop, float(v))

    def update(self, step, n_steps=None):
        if self._obj is None:
            return
        if self.dec is not None:
            if step > 0 and step % self.interval == 0:
                self._set(self._get() * self.dec)
        elif self.lindec is not None:
            total = n_steps or self.lindec
            frac = max(0.0, 1.0 - step / float(total))
            self._set(self._initial * frac)
        elif self.updates is not None:
            # catch-up semantics: fire the LATEST entry in the window
            # (last_seen_step, step] — a resumed run whose first update()
            # lands past a table entry still applies it (entries set
            # absolute values, so applying only the latest is exact)
            prev = self._last_step if self._last_step is not None else -1
            fire = None
            for s, v in self.updates:
                if prev < s <= step:
                    fire = v
            if fire is not None:
                self._set(fire)
        self._last_step = step

    def __repr__(self):
        mode = ("dec", self.dec) if self.dec is not None else \
            ("lindec", self.lindec) if self.lindec is not None else \
            ("updates", self.updates)
        return f"<Schedule {mode[0]}={mode[1]} -> {self._prop}>"


class ConsoleControl:
    """Non-blocking stdin console for the training loop.

    Reference: ``trainutils.py::user_input`` — the prompt_toolkit live
    console (pause, lr/mom changes, preview, save, quit). Rebuilt on a
    plain stdin reader thread (no extra dependency); same commands:

      ``q``            quit & save        ``pause`` / ``cont``  toggle
      ``lr <v>``       set learning rate  ``mom <v>``  set momentum
      ``wd <v>``       set weight decay   ``preview``  render preview
      ``save``         snapshot now       ``stat``     print param stats
      ``ipython``      drop into an interactive shell (trainer/model in
                       scope; training pauses until exit)
    """

    def __init__(self, trainer):
        self.trainer = trainer
        self.paused = False
        self.quit = False
        self._lines = []
        self._lock = threading.Lock()
        self._thread = None
        if sys.stdin is not None and sys.stdin.isatty():
            self._thread = threading.Thread(target=self._read_loop,
                                            daemon=True)
            self._thread.start()

    def _read_loop(self):
        while not self.quit:
            try:
                r, _, _ = select.select([sys.stdin], [], [], 0.5)
                if r:
                    line = sys.stdin.readline()
                    if not line:
                        break
                    with self._lock:
                        self._lines.append(line.strip())
            except Exception:
                break

    def poll(self):
        with self._lock:
            lines, self._lines = self._lines, []
        for line in lines:
            self._handle(line)
        return not self.quit

    def _handle(self, line):
        t = self.trainer
        parts = line.split()
        if not parts:
            return
        cmd = parts[0].lower()
        try:
            if cmd == "q":
                logger.info("console: quit & save")
                self.quit = True
            elif cmd == "pause":
                self.paused = True
            elif cmd in ("cont", "c"):
                self.paused = False
            elif cmd == "lr":
                t.model.optimiser.setlr(float(parts[1]))
                logger.info(f"console: lr = {parts[1]}")
            elif cmd == "mom":
                t.model.optimiser.setmom(float(parts[1]))
            elif cmd == "wd":
                t.model.optimiser.setwd(float(parts[1]))
            elif cmd == "save":
                t.save_model()
            elif cmd == "preview":
                t.preview_prediction()
            elif cmd == "stat":
                for k, v in t.model.paramstats().items():
                    logger.info(f"{k}: {v}")
            elif cmd in ("ip", "ipython"):
                # reference parity: drop into an interactive shell with the
                # trainer/model in scope (``user_input``'s 'ipython' cmd);
                # training is paused for the duration
                was_paused, self.paused = self.paused, True
                try:
                    import IPython
                    logger.info("console: IPython shell — `trainer`, "
                                "`model` in scope; exit to resume")
                    IPython.embed(user_ns={"trainer": t, "model": t.model})
                except ImportError:
                    import code
                    code.interact(local={"trainer": t, "model": t.model})
                self.paused = was_paused
            else:
                logger.warning(f"console: unknown command {line!r} "
                               "(q/pause/cont/lr/mom/wd/save/preview/"
                               "stat/ipython)")
        except Exception as e:
            logger.warning(f"console command {line!r} failed: {e}")


#: reference surface alias — ``trainutils.py::user_input`` is the live
#: console entry point there; ``ConsoleControl`` is its object form here
#: (constructed with the trainer, polled by the run loop).
user_input = ConsoleControl
