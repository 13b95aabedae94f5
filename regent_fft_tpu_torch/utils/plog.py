"""Plan logging (stdlib only).

Counterpart: ``regent_fft_tpu/utils/plog.py``.  Enable with
``set_log_level(1)`` (plan events) or ``2`` (plus the step list and each
collective a distributed plan issues).  The port reads no environment
variable.
"""
from __future__ import annotations

import logging

logger = logging.getLogger("regent_fft_tpu_torch")


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
