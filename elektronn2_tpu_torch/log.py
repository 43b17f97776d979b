"""Logging setup.

Port of ``elektronn2_tpu/log.py``: the same colored console logger on stdlib
logging, under the logger name ``elektronn2_tpu_torch``.
"""

import logging
import os
import sys

_COLORS = {
    logging.DEBUG: "\033[36m",      # cyan
    logging.INFO: "\033[32m",       # green
    logging.WARNING: "\033[33m",    # yellow
    logging.ERROR: "\033[31m",      # red
    logging.CRITICAL: "\033[35m",   # magenta
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelno, "")
            return f"{color}{msg}{_RESET}"
        return msg


logger = logging.getLogger("elektronn2_tpu_torch")
if not logger.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(_ColorFormatter("[%(levelname).1s] %(message)s"))
    logger.addHandler(_handler)
    logger.setLevel(os.environ.get("ELEKTRONN2_LOGLEVEL", "INFO").upper())
    logger.propagate = False


def add_file_handler(path):
    """Attach a per-experiment logfile (mirrors the reference's save-dir log)."""
    fh = logging.FileHandler(path)
    fh.setFormatter(logging.Formatter("%(asctime)s [%(levelname).1s] %(message)s"))
    logger.addHandler(fh)
    return fh
