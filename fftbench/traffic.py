"""The one traffic generator: input fields and the step schedule of a
cell, from its configuration, its workload file and ``--seed``.

A workload file (``workloads/<cell>.json``) is data:

* ``config``: the configuration's name (``configs/<config>.json``);
* ``interface``: ``complex`` (torch complex or real tensors through
  ``Plan.__call__``) or ``planes`` (float re/im planes through
  ``execute_split``, one real plane through ``execute_real``);
* ``loop`` and ``callers``: ``closed`` and 1, the one mix the generator
  makes: the next step is issued once step i - ``inflight`` has
  finished on the device;
* ``inflight``: steps the caller may have in flight;
* ``fields``: how many seeded fields the steps take in turn;
* ``chips``: the cards the cell runs on, one rank each;
* ``limits``: the limit of each number the check compares.

Every step runs the forward plan on field ``i % fields`` and the backward
plan on that output.  A field is made on the device in blocks along axis
0, one block a rank, each block from its own generator, so any rank can
make any block again for the reference.  The seed picks the values only:
every seed gives the same sizes, the same schedule and the same work.
"""
from __future__ import annotations

import hashlib

import torch

SAMPLE_WINDOW = 16   # the sampled step is drawn from the window's first steps


def check_workload(workload: dict) -> None:
    """Refuse a mix this generator does not make."""
    if workload.get("loop") != "closed" or workload.get("callers") != 1:
        raise ValueError(f"{workload['name']}: only a closed loop with one "
                         f"caller is generated")
    if workload["interface"] not in ("complex", "planes"):
        raise ValueError(f"unknown interface {workload['interface']!r}")


def seed_for(seed: int, *tags) -> int:
    """A 63-bit generator seed for ``tags`` under the run's ``seed``
    (any integer, as large as the caller likes)."""
    text = ":".join(str(t) for t in (int(seed),) + tags)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def block_rows(shape, nblocks: int, block: int) -> slice:
    n0 = shape[0]
    if n0 % nblocks:
        raise ValueError(f"axis 0 of {tuple(shape)} is not {nblocks} blocks")
    b = n0 // nblocks
    return slice(block * b, (block + 1) * b)


def field_block(cfg: dict, seed: int, field: int, block: int, nblocks: int,
                device) -> tuple:
    """Block ``block`` of ``nblocks`` along axis 0 of field ``field``:
    standard normal float32 (re, im) planes for a complex input, one
    float32 plane for a real one (``kind`` "r2c")."""
    shape = list(cfg["shape"])
    rows = block_rows(shape, nblocks, block)
    shape[0] = rows.stop - rows.start
    g = torch.Generator(device=device)
    g.manual_seed(seed_for(seed, "field", field, "block", block))
    re = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    if cfg["kind"] == "r2c":
        return (re,)
    im = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    return re, im


def as_interface(planes: tuple, interface: str, plane_dtype) -> object:
    """The field as the cell's interface takes it: a complex64 tensor (or
    the real tensor) for ``complex``; for ``planes`` the planes in the
    plan's plane dtype."""
    if interface == "complex":
        return planes[0] if len(planes) == 1 else torch.complex(*planes)
    if interface == "planes":
        return tuple(p.to(plane_dtype).contiguous() for p in planes)
    raise ValueError(f"unknown interface {interface!r}")


def sample_step(seed: int, n_steps: int) -> int:
    """The window step whose outputs the check keeps, besides the last,
    drawn from the seed among the first ``SAMPLE_WINDOW`` steps."""
    return seed_for(seed, "sample") % max(1, min(SAMPLE_WINDOW, n_steps))
