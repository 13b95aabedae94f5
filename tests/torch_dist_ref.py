"""The test side of the port's distributed tests: the JAX plans on the
first P of the 8 virtual CPU devices, the port's plans on a pool of P gloo
ranks (``torch_dist_pool``), and the comparisons between them.

Not a test module, and never imported by the ranks (it imports JAX).
"""
from __future__ import annotations

import re

import numpy as np
import pytest

from regent_fft_tpu.parallel import mesh as jmesh
from regent_fft_tpu.utils.verify import to_numpy_complex as jax_np
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance
from torch_dist_pool import RankPool


def port_enums(obj):
    """``obj`` with the JAX package's Direction/Kind/Norm members turned
    into the port's (by value), in tuples, lists and dicts: the ranks
    never unpickle a JAX object."""
    import enum
    from regent_fft_tpu import dtypes as jd
    from regent_fft_tpu_torch import dtypes as pd
    if isinstance(obj, enum.Enum) and type(obj) in (jd.Direction, jd.Kind,
                                                    jd.Norm):
        return getattr(pd, type(obj).__name__)(obj.value)
    if isinstance(obj, (tuple, list)):
        return type(obj)(port_enums(o) for o in obj)
    if isinstance(obj, dict):
        return {k: port_enums(v) for k, v in obj.items()}
    return obj


class Pool:
    """The test's handle on a RankPool: JAX enums in the arguments
    become the port's."""

    def __init__(self, pool):
        self.pool = pool

    def run(self, name, *args, **kwargs):
        return self.pool.run(name, *port_enums(args), **port_enums(kwargs))


def pool_fixture(world: int):
    """A module-scoped fixture: one pool of ``world`` ranks per file."""
    @pytest.fixture(scope="module")
    def pool():
        import jax
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 (virtual) devices")
        p = RankPool(world)
        try:
            yield Pool(p)
        finally:
            p.close()
    return pool


def crand(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def assemble(results, stage: int = -1) -> np.ndarray:
    """The global output of one stage of a ``plan_chain`` from every
    rank's local block."""
    first = results[0][stage]
    out = np.zeros(first["out_shape"], first["y"].dtype)
    for r in results:
        out[r[stage]["out_block"]] = r[stage]["y"]
    return out


def chain(pool, stages, x):
    """Run a chain of plans on the pool; returns the per-rank results."""
    return pool.run("plan_chain", stages, x)


def run(pool, name, x, *args, **kw):
    """One port plan on the pool: (assembled output, rank 0's fields)."""
    res = chain(pool, [(name, args, kw)], x)
    return assemble(res), res[0][0]


def fft_mesh(p):
    return jmesh.make_fft_mesh(p)


def pencil_mesh(shape):
    return jmesh.make_pencil_mesh(shape)


def agree(port, jax_y, ref, n, dtype="complex64"):
    """The port's output within tolerance(n, dtype) of the JAX plan's and
    of the float64 reference; returns both errors."""
    tol = tolerance(n, dtype)
    e_jax, e_ref = rel_l2(port, jax_y), rel_l2(port, ref)
    assert e_jax <= tol and e_ref <= tol, (e_jax, e_ref, tol)
    return e_jax, e_ref


def _padded(desc, shape, spec, off):
    """The padded global extents of the JAX plan's split axes, read from
    its "uneven blocks a->b|..." note (slab: axes 0 and -1; pencil: Z, Y,
    X; the real slab and pencil plans: axes 0 and 1)."""
    m = re.search(r"uneven blocks ([0-9>|-]+)", desc)
    pads = {}
    if m:
        pairs = [tuple(int(v) for v in s.split("->"))
                 for s in m.group(1).split("|")]
        if "-r2c" in desc or "-c2r" in desc:
            axes = [0, 1]
        else:
            axes = ([off, len(shape) - 1] if len(pairs) == 2
                    else [off, off + 1, off + 2])
        pads = {a: b for a, (_, b) in zip(axes, pairs)}
    return tuple(pads.get(i, n) if spec[i] is not None else n
                 for i, n in enumerate(shape))


def jax_blocks(jplan, sharding, true_shape, off=0):
    """Every device's slices of the JAX plan's padded global array under
    ``sharding``, cut to the true extent, in mesh (rank) order, as
    (start, stop) pairs."""
    spec = tuple(sharding.spec) + (None,) * (len(true_shape)
                                             - len(sharding.spec))
    padded = _padded(jplan.description, true_shape, spec, off)
    idx = sharding.devices_indices_map(padded)
    out = []
    for d in jplan.mesh.devices.flat:
        blk = []
        for s, n, pn in zip(idx[d], true_shape, padded):
            a = 0 if s.start is None else s.start
            b = pn if s.stop is None else s.stop
            blk.append((min(a, n), min(b, n)))
        out.append(blk)
    return out


def port_blocks(blocks):
    return [[(s.start, s.stop) for s in b] for b in blocks]
