"""Run logging for the training CLIs (own copy of ``relaxtpu/utils/logging.py``):
a stderr handler, plus a file handler for ``--artifacts-dir``'s train.log."""

from __future__ import annotations

import logging
import sys


def setup_logger(name: str = "relaxtpu_torch", log_file: str | None = None, level=logging.INFO):
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter("%(levelname)s - %(message)s"))
        logger.addHandler(fh)
    return logger
