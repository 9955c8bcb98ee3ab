# The PyTorch port's own copy of elasticdl_tpu/common/log_utils.py: the port imports
# nothing of the JAX package.
"""Logging helpers (reference: elasticdl/python/common/log_utils.py [U])."""

from __future__ import annotations

import logging
import sys

_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"

_default_level = "INFO"
_loggers: dict = {}


def get_logger(name: str, level: str = "") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel((level or _default_level).upper())
    _loggers[name] = logger
    return logger


def set_level(level: str) -> None:
    """Apply --log_level to every framework logger, existing and future
    (master/worker mains call this right after parsing the job config)."""
    global _default_level
    _default_level = level
    for logger in _loggers.values():
        logger.setLevel(level.upper())
