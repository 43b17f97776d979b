"""training — the training loop and its support machinery.

Port of ``elektronn2_tpu/training``: the ``Trainer`` (``trainer``), the
background batch workers (``parallelisation``), history, schedules and the
console (``trainutils``), and the fused K-step loops, one CUDA graph a
chunk (``fused_loop``). The CLI resolves a config's ``trainer_class`` here.
"""

from .parallelisation import BackgroundProc, SharedQ
from .trainer import Trainer, TracingTrainer, TracingTrainerRNN
from .trainutils import HistoryTracker, Schedule, pretty_string_time

__all__ = ["HistoryTracker", "Schedule", "pretty_string_time",
           "BackgroundProc", "SharedQ", "Trainer", "TracingTrainer",
           "TracingTrainerRNN"]
