"""Plan logging (stdlib only).

Counterpart: ``regent_fft_tpu/utils/plog.py``.  Enable with
``set_log_level(1)`` (plan events) or ``2`` (plus the step list).  The port
reads no environment variable.
"""
from __future__ import annotations

import logging

logger = logging.getLogger("regent_fft_tpu_torch")


def set_log_level(level: int):
    """0 = silent, 1 = plan events, 2 = + step detail.

    Counterpart: ``regent_fft_tpu/utils/plog.py:34``.
    """
    logger.setLevel({0: logging.WARNING, 1: logging.INFO}.get(level, logging.DEBUG))


def log_plan(plan):
    """Counterpart: ``regent_fft_tpu/utils/plog.py:39``."""
    logger.info("make_plan: %r", plan)
    if logger.isEnabledFor(logging.DEBUG):
        logger.debug("schedule:\n%s", plan.describe())
