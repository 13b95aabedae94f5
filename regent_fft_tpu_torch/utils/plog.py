"""Plan logging (stdlib only).

Counterpart: ``regent_fft_tpu/utils/plog.py``.  Enable with
``REGENT_FFT_LOG=1`` (plan events) or ``2`` (plus the step list and each
collective a distributed plan issues), read once at import, or with
``set_log_level``.  Records go to stderr as ``[regent_fft_tpu_torch INFO]
make_plan: ...`` through the logger's own handler; they do not propagate
to the root logger.
"""
from __future__ import annotations

import logging
import os
import sys


logger = logging.getLogger("regent_fft_tpu_torch")
_handler = logging.StreamHandler(sys.stderr)
_handler.setFormatter(logging.Formatter("[%(name)s %(levelname)s] %(message)s"))
logger.addHandler(_handler)
logger.propagate = False


def _init_level():
    """``REGENT_FFT_LOG`` as the level; a malformed value means 0.
    Counterpart: ``regent_fft_tpu/utils/plog.py:26``."""
    try:
        set_log_level(int(os.environ.get("REGENT_FFT_LOG", "0")))
    except ValueError:
        set_log_level(0)


def set_log_level(level: int):
    """0 = silent, 1 = plan events, 2 = + step and collective detail.

    Counterpart: ``regent_fft_tpu/utils/plog.py:34``.
    """
    logger.setLevel({0: logging.WARNING, 1: logging.INFO}.get(level, logging.DEBUG))


def log_plan(plan):
    """Counterpart: ``regent_fft_tpu/utils/plog.py:39``."""
    logger.info("make_plan: %r", plan)
    if logger.isEnabledFor(logging.DEBUG):
        describe = getattr(plan, "describe", None)
        logger.debug("schedule:\n%s", describe() if describe is not None
                     else getattr(plan, "description", ""))


def log_collective(name: str, axis: str, shape):
    """One record per collective a distributed plan issues, at level 2.
    The JAX package logs each site once per trace; the port logs every
    call, since nothing is traced.
    Counterpart: ``regent_fft_tpu/utils/plog.py:45``."""
    logger.debug("collective %s over axis %r, local shape %s", name, axis,
                 tuple(shape))


def dump_machine_model() -> str:
    """The process's place in the ``torch.distributed`` world and its
    CUDA devices, logged at level 1 and returned (the reference's
    machine-model dump, logging_mapper.cc:92-123).
    Counterpart: ``regent_fft_tpu/utils/plog.py:49``."""
    import torch
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        head = (f"rank {dist.get_rank()}/{dist.get_world_size()}, backend "
                f"{dist.get_backend()}")
    else:
        head = "rank 0/1, no process group"
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    lines = [f"{head}, {n} local CUDA devices"]
    for i in range(n):
        prop = torch.cuda.get_device_properties(i)
        lines.append(f"  device cuda:{i}: {prop.name} "
                     f"(memory={prop.total_memory / 2**30:.1f}GiB, "
                     f"{prop.multi_processor_count} SMs)")
    msg = "\n".join(lines)
    logger.info("machine model:\n%s", msg)
    return msg


_init_level()
