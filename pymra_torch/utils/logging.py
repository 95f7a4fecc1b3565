"""Logging as a proper subsystem (counterpart of
``pymra_tpu/utils/logging.py``).

One package-level logger hierarchy under ``pymra_torch``, a single
:func:`configure` entry point, and an environment override
(``PYMRA_LOG_LEVEL``, declared in :mod:`pymra_torch.utils.config`).
"""
from __future__ import annotations

import logging

__all__ = ["get_logger", "configure"]

_ROOT = "pymra_torch"


def get_logger(name: str | None = None) -> logging.Logger:
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)


def configure(level: str | int | None = None,
              fmt: str = "%(asctime)s %(name)s %(levelname)s %(message)s",
              datefmt: str = "%H:%M:%S") -> logging.Logger:
    """Set the package logger's level (``PYMRA_LOG_LEVEL`` when ``level``
    is None) and attach one stream handler to it. Idempotent: a second call
    changes the level and adds no handler."""
    logger = logging.getLogger(_ROOT)
    if level is None:
        from pymra_torch.utils.config import flag

        level = flag("PYMRA_LOG_LEVEL")
    logger.setLevel(level)
    if not any(getattr(h, "_pymra", False) for h in logger.handlers):
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(fmt, datefmt))
        handler._pymra = True
        logger.addHandler(handler)
        logger.propagate = False
    return logger
