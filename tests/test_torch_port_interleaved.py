"""Interleaved complex64 I/O at a plan's ends, planned and dispatched on
the host.

A C2C complex64 plan on a card reads the caller's complex64 tensor as it
is where its first step's kernel can (``fft_fused2``'s register body:
``stockham2``), and its last step's kernel writes the returned tensor where
it can (``fft_cols`` on a non-last axis of rank >= 3 planes: ``stockham``);
each end is the step kind's own (``plan.STEPS[kind].ends``,
``plan.complex_ends``), and ``Plan.__call__`` takes the input end only for
a tensor ``plan.reads_complex`` accepts.  Every other input, and every end
with no such kernel, goes through the split and combine copies.  A plan on
the CPU keeps the copies; here each plan is built on the CPU and given the
ends a 132-SM card computes for its steps, so ``Plan.__call__`` routes as
on the card and the wrappers' plain versions run the steps (the kernels'
addressing is emulated in ``test_torch_port_fused2_cluster.py`` and
``test_torch_port_cols_regs.py``).  Each case is held against numpy in
float64 within ``tolerance`` and, bit for bit, against the same plan on
the copies; ``trace.COUNTS["interleaved_in"]``/``["interleaved_out"]``
say which ends were taken.
"""
import numpy as np
import pytest
import torch

from regent_fft_tpu_torch import plan as tplan
from regent_fft_tpu_torch.dtypes import Direction, Kind, SplitComplex
from regent_fft_tpu_torch.utils import trace
from regent_fft_tpu_torch.utils.verify import rel_l2, tolerance

# name: (shape, axes, the ends a 132-SM card computes for its steps)
PLANS = {
    "3d": ((4, 512, 512), (0, 1, 2), (True, True)),
    "3d_stage_walk": ((8, 256, 256), (0, 1, 2), (False, True)),
    "2d": ((512, 512), (0, 1), (True, False)),
    "1d": ((512,), (0,), (False, False)),
    "fourstep_last": ((4, 8192), (1,), (False, False)),
}


def _plan(name, direction=Direction.FORWARD):
    shape, axes, _ = PLANS[name]
    p = tplan.Plan(tplan.PlanSpec(shape=shape, axes=axes, kind=Kind.C2C,
                                  direction=direction, device="cpu",
                                  backend="stockham"))
    return p


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape)
                             + 1j * rng.standard_normal(shape))
                            .astype(np.complex64))


def _offset_view(x):
    """x's values in a contiguous view one element into a larger buffer."""
    buf = torch.zeros(x.numel() + 3, dtype=x.dtype)
    v = buf[1:1 + x.numel()].view(x.shape)
    v.copy_(x)
    assert v.storage_offset() == 1 and v.is_contiguous()
    return v


def _strided_view(x):
    """x's values in a view of every other element of a larger buffer."""
    buf = torch.zeros(x.shape[:-1] + (2 * x.shape[-1],), dtype=x.dtype)
    v = buf[..., ::2]
    v.copy_(x)
    assert not v.is_contiguous()
    return v


# name: (the input made from the field, its value as complex128 numpy,
# whether a plan whose first step reads complex64 reads it as it is)
INPUTS = {
    "contiguous": (lambda x: x, lambda x: x.numpy(), True),
    "offset_view": (_offset_view, lambda x: x.numpy(), True),
    "conj_bit": (lambda x: x.conj(), lambda x: x.numpy().conj(), False),
    "strided_view": (_strided_view, lambda x: x.numpy(), False),
    "complex128": (lambda x: x.to(torch.complex128), lambda x: x.numpy(),
                   False),
    "numpy": (lambda x: x.numpy(), lambda x: x.numpy(), False),
    "split_complex": (lambda x: SplitComplex(x.real.contiguous(),
                                             x.imag.contiguous()),
                      lambda x: x.numpy(), False),
}


@pytest.mark.parametrize("inp", sorted(INPUTS))
@pytest.mark.parametrize("name", sorted(PLANS))
def test_dispatch_takes_the_ends_that_fit(name, inp):
    shape, axes, ends = PLANS[name]
    p = _plan(name)
    assert p.complex_ends == (False, False)       # a CPU plan keeps copies
    assert tplan.complex_ends(p.steps, shape, p.cdtype, 132) == ends
    make, value, fits = INPUTS[inp]
    x = _field(shape, len(name) + len(inp))
    arg = make(x)
    want_split = p(arg)
    p.complex_ends = ends                          # as on a 132-SM card
    trace.reset_counts()
    y = p(arg)
    assert trace.COUNTS["interleaved_in"] == int(ends[0] and fits)
    assert trace.COUNTS["interleaved_out"] == int(ends[1])
    trace.reset_counts()
    assert y.dtype == torch.complex64 and tuple(y.shape) == shape
    assert y.is_contiguous() and not y.is_conj()
    assert torch.equal(y, want_split)
    ref = np.fft.fftn(value(x).astype(np.complex128), axes=axes)
    assert rel_l2(y.numpy(), ref) <= tolerance(p.spec.logical_n)


@pytest.mark.parametrize("direction", [Direction.FORWARD,
                                       Direction.BACKWARD])
def test_both_ends_both_directions(direction):
    """The 3-D plan's two interleaved ends in each direction: the backward
    plan's 1/N rides the interleaved store, as it rides the planar one."""
    shape, axes, ends = PLANS["3d"]
    p = _plan("3d", direction)
    x = _field(shape, int(direction) + 5)
    want = p(x)
    p.complex_ends = ends
    trace.reset_counts()
    y = p(x)
    assert trace.COUNTS["interleaved_in"] == trace.COUNTS["interleaved_out"] == 1
    trace.reset_counts()
    assert torch.equal(y, want)
    xd = x.numpy().astype(np.complex128)
    ref = (np.fft.fftn(xd, axes=axes) if direction == Direction.FORWARD
           else np.fft.ifftn(xd, axes=axes))
    assert rel_l2(y.numpy(), ref) <= tolerance(p.spec.logical_n)


def test_reads_complex_predicate():
    """reads_complex: a complex64 tensor of the planned shape on the plan's
    device, contiguous, no conjugate or negative bit; a CPU tensor is not
    read by a card's plan, nor a tensor of another shape or dtype."""
    x = _field((4, 512, 512), 3)
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert tplan.reads_complex(x, cpu, x.shape)
    assert not tplan.reads_complex(x, card, x.shape)
    assert not tplan.reads_complex(x, cpu, (4, 512, 256))
    assert not tplan.reads_complex(x.conj(), cpu, x.shape)
    assert not tplan.reads_complex(x.to(torch.complex128), cpu, x.shape)
    assert not tplan.reads_complex(x.real, cpu, x.shape)
    assert not tplan.reads_complex(x.numpy(), cpu, x.shape)
    assert not tplan.reads_complex(_strided_view(x), cpu, x.shape)
    assert tplan.reads_complex(_offset_view(x), cpu, x.shape)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_other_plane_types_keep_the_copies(dtype):
    """Planes of complex32 (bf16) and complex128 (f64) plans have no
    interleaved instance at either end."""
    shape = PLANS["3d"][0]
    steps = [("stockham2", 1, (512, 512)), ("stockham", 0, 4)]
    assert tplan.complex_ends(steps, shape, torch.float32, 132) == (True,
                                                                  True)
    assert tplan.complex_ends(steps, shape, dtype, 132) == (False, False)
