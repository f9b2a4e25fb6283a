"""Structured logging (port of `opticalflowclustering_tpu/utils/logging.py`).

One logger namespace for the port; the format carries the logger's name and
the time, so runs of the queue can be searched.
"""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str = "ofc_torch", level: int = logging.INFO) -> logging.Logger:
    """The logger `name`, given one stderr handler the first time it is asked
    for (and not propagated, so a root handler does not print it twice)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger
