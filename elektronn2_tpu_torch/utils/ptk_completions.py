"""Tab completion for the live training console.

Jax-free copy of ``elektronn2_tpu/utils/ptk_completions.py`` (reference:
``elektronn2/utils/ptk_completions.py``, a prompt_toolkit
completer over trainer/model attribute names). prompt_toolkit is not a
dependency; the same UX is provided with stdlib ``readline``:
command names and optimiser hyperparameter names complete on TAB when the
console runs on a TTY.
"""

from __future__ import annotations

COMMANDS = ("q", "pause", "cont", "lr", "mom", "wd", "save", "preview",
            "stat")


class ConsoleCompleter:
    """readline completer over console commands + live hyperparam names."""

    def __init__(self, trainer=None):
        self.trainer = trainer
        self._matches = []

    def _candidates(self):
        cands = list(COMMANDS)
        if self.trainer is not None and self.trainer.model.optimiser:
            cands += list(self.trainer.model.optimiser.hyperparams)
        return cands

    def complete(self, text, state):
        if state == 0:
            self._matches = [c for c in self._candidates()
                             if c.startswith(text)]
        return self._matches[state] if state < len(self._matches) else None

    def install(self):
        try:
            import readline
            readline.set_completer(self.complete)
            readline.parse_and_bind("tab: complete")
            return True
        except Exception:
            return False
