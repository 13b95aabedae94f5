"""Plan lifecycle of the PyTorch port: C2C, R2C and C2R at any rank, in
complex64, complex32 and complex128.

Counterpart: ``regent_fft_tpu/plan.py``.  A :class:`Plan` precomputes the
per-axis step list (the same list the JAX package builds, so
``describe()`` prints the same step lines) and runs it eagerly on the
plan's device:

* ``stockham``  one butterfly-kernel pass along an axis
  (``ops/stockham_kernels.fft_axis_stockham``); on a non-last axis with
  ``axis0_impl="fourstep"`` or ``"dma"`` it takes the two-stage four-step
  (``fourstep_ring``, ``ops/fourstep.fft_axis0_fourstep``) or the slab
  ring (``dma_ring``, ``fft_axis_dma``) where their gates hold
  (:func:`route_steps`);
* ``stockham2`` one fused kernel pass over the trailing axis pair
  (``fft_axes2_stockham``), or with ``f2_impl="ring"`` the slab ring
  over whole planes (``fused2_ring``, ``fft_axes2_ring``);
* ``stockham_gap`` one kernel pass over axes -3 and -1
  (``fft_axes_gap_stockham``), taken as in the JAX package only when
  ``REGENT_FFT_GAP_FUSED=1`` is set as the plan is made (:class:`Switches`);
  the mid axis follows as a ``stockham`` step;
* ``stockham4`` the four-step last axis, n = 4096..2M
  (``fft_last_four_step``: the twiddle column pass, the last-axis pass,
  the sub-axis swap);
* ``direct`` / ``mixed2`` dense DFT contractions (``ops/stockham.py``);
* ``general`` the 1-D pipeline of ``stockham.build_c2c_1d`` (direct,
  mixed radix, Rader or Bluestein; Bluestein's two inner transforms take
  ``fft_last`` on a CUDA plan where the padded length is a kernel length),
  or under ``backend="pallas"`` the matmul-form kernels of
  ``ops/pallas_fft.build_c2c_1d_pallas`` (``fft_mm1`` for n <= 128,
  ``fft_mm2`` for a two-factor n with both factors in 16..128), as in the
  JAX package (plan.py:318-326, 400-402): every transformed axis is a
  ``general`` step there, and a length with no such schedule, and every
  complex128 axis (the kernels compute in f32), takes the dense pipeline.

A real plan (R2C/C2R) transforms its last listed axis as the real axis
and the others with the steps above.  The real axis takes one of three
routes, chosen as in the JAX package: the row-pair r2c/c2r kernels
(``fft_last_r2c_stockham`` / ``ifft_last_c2r_stockham``, Nyquist-packed
between the steps when ``r2c_packed_supported``), the half-length
conjugate-even reduction on the last-axis kernel, or that reduction on
the dense pipeline (``ops/real.py``).

The norm scale rides the last kernel step's write when the list ends in
one, else the real kernel's write.  Plans live on ``device`` (default
``"cuda"``); ``device="cpu"`` is opt-in and runs the kernels' plain
versions.

Data types (``_compute_dtype``, as in the JAX package): a complex64 plan
runs f32 planes; a complex32 C2C plan keeps bf16 planes between its steps
(the butterfly kernels read and write bf16 and compute in f32; the
contraction steps and the four-step last axis cast to f32 around
themselves) and returns a SplitComplex of bf16 planes; a complex32 real
plan computes in f32 and rounds its output to bf16; a complex128 plan runs
f64 planes through the contraction steps only, since the kernels compute
in f32.

The precision tiers ``"high"`` and ``"default"`` plan the same steps as
``"highest"`` in every dtype, and ``describe()`` prints the tier.  The JAX
package runs them faster and less exactly on the TPU (``"high"`` scopes
its b32 bf16x3 scheme to the four-step stages, plan.py:276-297;
``"default"`` runs one-pass bf16 products); the port computes exact f32
(f64 for complex128) at every tier, which is at least as accurate.

The planner rigor ladder (plan.py:61-70 there): ``"estimate"`` (static
routing), ``"model"`` (contraction splits from the native cost model,
``native/planner.cc``), ``"measure"`` (the radix schedules of every length
and, under ``backend="auto"``, the backends raced on the plan's device,
``utils/measure.py``), ``"patient"`` (also the leading-axis x trailing-pair
routes) and ``"exhaustive"`` (also the deep schedule space and the kernel
knobs that select a kernel on the device: none so far).  Winners persist
in ``_BACKEND_WISDOM``/``_PATIENT_WISDOM``/``_EXHAUSTIVE_WISDOM``, keyed
with the plan's device type as the schedule overrides of
``ops/factor.py`` are (``utils/wisdom.py`` exports them).

A plan reads the JAX plan's user switches once, as it is made
(:class:`Switches`): ``REGENT_FFT_GAP_FUSED``, ``REGENT_FFT_AXIS0_IMPL``,
``REGENT_FFT_F2_IMPL``, ``REGENT_FFT_DMA_MIN_POST``, ``REGENT_FFT_R2C_1D``
and ``REGENT_FFT_MXU_IMPL``.  The plan cache keys on them and
``inverse()`` keeps them.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .dtypes import (Direction, Kind, Norm, SplitComplex, as_real, as_split,
                     check_dtype, from_split)
from .ops import factor as _factor
from .ops import fourstep as _fs
from .ops import nd as _nd
from .ops import pallas_fft as _pf
from .ops import real as _real
from .ops import stockham as _stockham
from .ops import stockham_kernels as _sk

AXIS0_IMPLS = ("auto", "fourstep", "dma", "grid")
F2_IMPLS = ("auto", "grid", "ring", "off")    # off = unfused pair


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """Hashable problem description, the plan-cache key.

    The JAX ``PlanSpec``'s fields plus ``device``.
    Counterpart: ``regent_fft_tpu/plan.py:42``.
    """

    shape: Tuple[int, ...]
    axes: Tuple[int, ...]
    kind: Kind
    direction: Direction
    norm: Norm = Norm.BACKWARD
    dtype: str = "complex64"
    precision: str = "highest"
    use_3m: bool = False
    max_radix: int = _factor.DEFAULT_MAX_RADIX
    backend: str = "auto"             # auto|xla|stockham|hybrid
    donate: bool = False              # kept for spec parity; inputs are never written
    planner: str = "estimate"
    axis0_impl: str = "auto"
    f2_impl: str = "auto"             # auto|grid|off (off = unfused pair)
    xla_direct_max: int = 512
    packed_layout: bool = False
    device: str = "cuda"

    def __post_init__(self):
        shape = tuple(int(s) for s in self.shape)
        axes = tuple(a % len(shape) for a in self.axes)
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "axes", axes)
        object.__setattr__(self, "kind", Kind(self.kind))
        object.__setattr__(self, "direction", Direction(self.direction))
        object.__setattr__(self, "norm", Norm(self.norm))
        object.__setattr__(self, "device", str(torch.device(self.device)))
        if self.dtype == "complex32" and self.precision == "highest":
            # plan.py:95-99: bf16 planes make exact f32 products pointless;
            # the spec takes the fast precision and 3M products
            object.__setattr__(self, "precision", "default")
            object.__setattr__(self, "use_3m", True)
        if len(set(axes)) != len(axes):
            raise ValueError(f"duplicate axes: {self.axes}")
        if not axes:
            raise ValueError("at least one transform axis required")
        if self.kind == Kind.R2C and self.direction != Direction.FORWARD:
            raise ValueError("R2C transforms are forward-only (use C2R for inverse)")
        if self.kind == Kind.C2R and self.direction != Direction.BACKWARD:
            raise ValueError("C2R transforms are backward-only")
        if self.precision not in ("highest", "high", "default"):
            raise ValueError("precision must be one of "
                             "['highest', 'high', 'default']")
        if self.backend not in ("auto", "xla", "stockham", "hybrid", "pallas"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.planner not in ("estimate", "model", "measure", "patient",
                                "exhaustive"):
            raise ValueError(f"unknown planner {self.planner!r}")
        if self.axis0_impl not in AXIS0_IMPLS:
            raise ValueError(f"axis0_impl must be {'|'.join(AXIS0_IMPLS)}, "
                             f"got {self.axis0_impl!r}")
        if self.f2_impl not in F2_IMPLS:
            raise ValueError(f"f2_impl must be {'|'.join(F2_IMPLS)}, "
                             f"got {self.f2_impl!r}")
        if self.max_radix < 2:
            raise ValueError(f"max_radix must be >= 2, got {self.max_radix}")
        if self.packed_layout and self.kind not in (Kind.R2C, Kind.C2R):
            raise ValueError("packed_layout applies to R2C/C2R plans only")

    @property
    def transform_lengths(self) -> Tuple[int, ...]:
        return tuple(self.shape[a] for a in self.axes)

    @property
    def logical_n(self) -> int:
        return int(np.prod(self.transform_lengths))

    @property
    def batch(self) -> int:
        b = 1
        for i, s in enumerate(self.shape):
            if i not in self.axes:
                b *= s
        return b


def spec_from_jax(obj, device: str = "cuda") -> PlanSpec:
    """The port's PlanSpec for any object carrying the JAX ``PlanSpec``
    fields (duck-typed; nothing of the JAX package is imported).  Enums map
    by value.  Counterpart of ``regent_fft_tpu/plan.py:42``'s fields."""
    return PlanSpec(
        shape=tuple(obj.shape), axes=tuple(obj.axes),
        kind=Kind(obj.kind.value), direction=Direction(int(obj.direction)),
        norm=Norm(obj.norm.value), dtype=obj.dtype, precision=obj.precision,
        use_3m=obj.use_3m, max_radix=obj.max_radix, backend=obj.backend,
        donate=obj.donate, planner=obj.planner, axis0_impl=obj.axis0_impl,
        f2_impl=obj.f2_impl, xla_direct_max=obj.xla_direct_max,
        packed_layout=obj.packed_layout, device=device)


# Measured winners, each keyed by _backend_key(spec): the backend
# (measure mode), the {"axis0_impl", "f2_impl", "backend"} of the patient
# race, and that dict with "knobs" of the exhaustive race.  Counterpart:
# regent_fft_tpu/plan.py:173-199; utils/wisdom.py persists them.
_BACKEND_WISDOM: dict = {}
_PATIENT_WISDOM: dict = {}
_EXHAUSTIVE_WISDOM: dict = {}


def _backend_key(spec: PlanSpec) -> PlanSpec:
    """The winner tables' key: the spec with the raced fields at their
    defaults and its device reduced to the device type, so a winner
    measured on the CPU never steers a CUDA plan, and one measured on a
    card steers every card's plans.  Counterpart: plan.py:186."""
    return dataclasses.replace(spec, backend="auto", planner="estimate",
                               donate=False, axis0_impl="auto",
                               f2_impl="auto",
                               device=torch.device(spec.device).type)


def _auto_backend(spec: PlanSpec) -> str:
    """The backend of a ``backend="auto"`` plan: a measured winner first
    (plan.py:306-309), else plan.py:316: the kernel hybrid on the card,
    the contraction path elsewhere.  The measure race always times the
    hybrid on a CUDA plan (``measure.backend_candidates``), so a winner it
    stores has beaten this default."""
    return _BACKEND_WISDOM.get(_backend_key(spec)) or (
        "hybrid" if torch.device(spec.device).type == "cuda" else "xla")


def _compute_dtype(spec: PlanSpec) -> torch.dtype:
    """The plane dtype a plan's steps run on.

    Counterpart: ``regent_fft_tpu/plan.py:143``: f64 for complex128; bf16
    planes between the passes of a complex32 C2C plan (the kernels read
    and write bf16 blocks and compute in f32); f32 otherwise, a complex32
    real plan included.  The JAX package needs ``JAX_ENABLE_X64`` for f64;
    the port has no such switch.
    """
    if spec.dtype == "complex128":
        return torch.float64
    if spec.dtype == "complex32" and spec.kind == Kind.C2C:
        return torch.bfloat16
    return torch.float32


def resolve_device(device) -> torch.device:
    """The torch device of a plan or entry point: ``"cuda"`` (the current
    card) or ``"cpu"`` (opt-in, the plain versions); a CUDA device without
    a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: regent_fft_tpu_torch plans run on the card; "
            "pass device='cpu' to run the plain versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _norm_scale(spec: PlanSpec) -> float:
    """Scale applied to the unscaled DFT / N-times-inverse-DFT core.

    Counterpart: ``regent_fft_tpu/plan.py:160``.
    """
    n = spec.logical_n
    fwd = spec.direction == Direction.FORWARD
    if spec.norm == Norm.NONE:
        return 1.0
    if spec.norm == Norm.BACKWARD:
        return 1.0 if fwd else 1.0 / n
    if spec.norm == Norm.FORWARD:
        return 1.0 / n if fwd else 1.0
    return 1.0 / math.sqrt(n)


def axis_steps(spec: PlanSpec, backend: str, axes_list,
               gap_fused: bool = False, device=None):
    """Per-axis steps with the JAX package's routing.

    Counterpart: ``regent_fft_tpu/plan.py:333`` (``axis_steps``): with
    ``gap_fused`` (``REGENT_FFT_GAP_FUSED=1``), axes -3 and -1 take one ``stockham_gap``
    step when the last three axes are transformed, ``fused_gap_supported``
    holds and the mid axis is a power of two within its cap; the
    trailing pair fuses into one ``stockham2`` step when
    ``fused2_supported``; a kernel length within its cap is a
    ``stockham`` step; a power-of-two last axis of 4096..2M is a
    ``stockham4`` (four-step) step under ``stockham``, and under
    ``hybrid`` when it has no two-factor split; otherwise a ``direct``
    (n <= xla_direct_max) or ``mixed2`` contraction step, and the
    ``general`` 1-D pipeline for lengths with no two-factor split.  Under
    ``backend="pallas"`` every axis without a kernel step is a ``general``
    step on :func:`_pallas_general` (plan.py:400-402).  A complex128 plan
    takes no kernel step (plan.py:331): the kernels compute in f32.
    ``device`` is the plan's: the ``general`` steps are built for it.
    """
    steps = []
    ndim = len(spec.shape)
    axes_list = list(axes_list)
    kernels = (backend in ("stockham", "hybrid")
               and spec.dtype != "complex128")
    if (gap_fused and kernels
            and len(axes_list) >= 3 and ndim >= 3
            and axes_list[:3] == [ndim - 1, ndim - 2, ndim - 3]):
        z, y, x = spec.shape[ndim - 3:]
        if (_sk.fused_gap_supported(z, x) and y <= _sk.MAX_STOCKHAM_N
                and (y & (y - 1)) == 0):
            steps.append(("stockham_gap", ndim - 3, (z, x)))
            axes_list = [ndim - 2] + axes_list[3:]
    if (kernels and spec.f2_impl != "off"
            and len(axes_list) >= 2 and ndim >= 2
            and axes_list[0] == ndim - 1 and axes_list[1] == ndim - 2):
        n1, n2 = spec.shape[ndim - 2], spec.shape[ndim - 1]
        if _sk.fused2_supported(n1, n2):
            steps.append(("stockham2", ndim - 2, (n1, n2)))
            axes_list = axes_list[2:]
    for a in axes_list:
        n = spec.shape[a]
        is_last = a == ndim - 1 and ndim > 1
        cap = _sk.MAX_LAST_N if is_last else _sk.MAX_STOCKHAM_N
        pow2 = n >= 2 and (n & (n - 1)) == 0
        kern = pow2 or (n >= 128 and _sk.kernel_len_ok(n, is_last))
        if kernels and kern:
            if n <= cap:
                steps.append(("stockham", a, n))
                continue
            if is_last and _sk.four_step_supported(n):
                split = _stockham.best_two_factor(n, spec.max_radix)
                if backend == "stockham" or split is None:
                    steps.append(("stockham4", a, n))
                    continue
        if backend == "pallas":
            steps.append(("general", a, _pallas_general(spec, n, device)))
            continue
        ov = _factor.schedule_override(n, spec.max_radix, spec.device)
        if ov is not None:
            if len(ov) == 1:
                steps.append(("direct", a, n))
            elif len(ov) == 2:
                steps.append(("mixed2", a, (n, ov[0])))
            else:
                steps.append(("general", a, _general(spec, n, device)))
            continue
        if 2 <= n <= spec.xla_direct_max:
            steps.append(("direct", a, n))
            continue
        if spec.planner == "model":
            # the native cost model's split (plan.py:418-423); its search
            # mirrors the executor, so two factors are a mixed2 step
            ms = _factor.schedule(n, spec.max_radix, "model", spec.device)
            if ms is not None and len(ms) == 2:
                steps.append(("mixed2", a, (n, ms[0])))
                continue
        split = _stockham.best_two_factor(n, spec.max_radix)
        if split is None:
            steps.append(("general", a, _general(spec, n, device)))
        else:
            steps.append(("mixed2", a, (n, split[0])))
    return steps


# The default of REGENT_FFT_DMA_MIN_POST (plan.py:467): the least trailing
# extent of a leading axis that takes the four-step or slab-ring route.
DMA_MIN_POST = 65536


@dataclasses.dataclass(frozen=True)
class Switches:
    """The JAX plan's user switches, read from the environment once as a
    plan is made (:meth:`from_env`); the plan cache keys on them and
    ``inverse()`` keeps them.  The defaults are those of unset variables.

    * ``gap_fused``: ``REGENT_FFT_GAP_FUSED=1``, the gap-fused pass
      (plan.py:344);
    * ``axis0_impl``, ``f2_impl``: ``REGENT_FFT_AXIS0_IMPL`` and
      ``REGENT_FFT_F2_IMPL``, which stand in for the spec's field where
      it is "auto" (plan.py:470-473, 516-518); read as the JAX plan reads
      them, at the step's route only, so ``f2_impl="off"`` here keeps the
      pair fused on the grid route (the spec's "off" unfuses it);
    * ``dma_min_post``: ``REGENT_FFT_DMA_MIN_POST`` (plan.py:467);
    * ``r2c_half``: ``REGENT_FFT_R2C_1D=half``, the half-length route for
      an R2C last axis (plan.py:652-655);
    * ``mxu_impl``: ``REGENT_FFT_MXU_IMPL``, the plain bf16 tile body
      (``stockham_kernels.tile_impl``); on the card the bf16 kernels'
      FFMA tile stands in for every body.
    """

    gap_fused: bool = False
    axis0_impl: str = "auto"
    f2_impl: str = "auto"
    dma_min_post: int = DMA_MIN_POST
    r2c_half: bool = False
    mxu_impl: str = "direct"

    def __post_init__(self):
        if self.axis0_impl not in AXIS0_IMPLS:
            raise ValueError(f"REGENT_FFT_AXIS0_IMPL must be "
                             f"{'|'.join(AXIS0_IMPLS)}, got "
                             f"{self.axis0_impl!r}")
        if self.f2_impl not in F2_IMPLS:
            raise ValueError(f"REGENT_FFT_F2_IMPL must be "
                             f"{'|'.join(F2_IMPLS)}, got {self.f2_impl!r}")

    @classmethod
    def from_env(cls) -> "Switches":
        env = os.environ.get
        return cls(gap_fused=env("REGENT_FFT_GAP_FUSED") == "1",
                   axis0_impl=env("REGENT_FFT_AXIS0_IMPL", "auto"),
                   f2_impl=env("REGENT_FFT_F2_IMPL", "auto"),
                   dma_min_post=int(env("REGENT_FFT_DMA_MIN_POST",
                                        DMA_MIN_POST)),
                   r2c_half=env("REGENT_FFT_R2C_1D") == "half",
                   mxu_impl=env("REGENT_FFT_MXU_IMPL", "direct"))


# Step kinds that end in a kernel write, so the norm scale can ride it.
KERNEL_STEPS = ("stockham", "stockham2", "stockham4", "fourstep_ring",
                "dma_ring", "fused2_ring", "stockham_gap")


def route_steps(spec: PlanSpec, steps, shape, switches: Switches):
    """The kernel route of each butterfly step, on the planes of ``shape``
    the steps transform.  Counterpart: the route choice inside
    ``regent_fft_tpu/plan.py:459-532`` for an explicit impl, the spec's
    or, where the spec says "auto", the switch's: a non-last ``stockham``
    axis becomes ``fourstep_ring`` when the impl is "fourstep" and
    ``dma_ring`` when it is "dma" (each when post >= the switches'
    ``dma_min_post`` and its gate holds), a ``stockham2`` pair becomes
    ``fused2_ring`` when the impl is "ring" and ``fused2_ring_supported``.
    The JAX package takes these routes only on the TPU and also under
    "auto"; the port takes them wherever they are asked for (the plain
    versions on the CPU, the kernels on the card) and keeps the butterfly
    and grid routes under "auto"."""
    a0 = (spec.axis0_impl if spec.axis0_impl != "auto"
          else switches.axis0_impl)
    f2 = spec.f2_impl if spec.f2_impl != "auto" else switches.f2_impl
    out = []
    for kind_, a, arg in steps:
        if kind_ == "stockham" and a != len(shape) - 1:
            post = int(np.prod(shape[a + 1:]))
            big = post >= switches.dma_min_post
            if (a0 == "fourstep" and big
                    and _sk.axis0_fourstep_supported(arg, post, shape[-1])):
                kind_ = "fourstep_ring"
            elif (a0 == "dma" and big
                    and _sk.axis0_dma_supported(arg, post)):
                kind_ = "dma_ring"
        elif (kind_ == "stockham2" and f2 == "ring"
                and _sk.fused2_ring_supported(*arg)):
            kind_ = "fused2_ring"
        out.append((kind_, a, arg))
    return out


def _general_dtype(spec: PlanSpec) -> torch.dtype:
    """The planes a ``general`` step runs on: f64 for complex128, else f32
    (``run_steps`` casts bf16 planes to f32 around it)."""
    return torch.float64 if spec.dtype == "complex128" else torch.float32


def _general(spec: PlanSpec, n: int, device=None) -> Callable:
    """The dense 1-D pipeline for the plan's ``device`` (Counterpart:
    ``build_1d``, ``regent_fft_tpu/plan.py:318``)."""
    return _stockham.build_c2c_1d(n, spec.direction, spec.max_radix,
                                  spec.use_3m, device, _general_dtype(spec),
                                  spec.planner)


def _pallas_general(spec: PlanSpec, n: int, device=None) -> Callable:
    """The ``general`` step of a ``backend="pallas"`` axis: the matmul-form
    kernels, or the dense pipeline where they have no schedule and for
    complex128 (f64 planes; the kernels compute in f32, and the JAX plan
    runs the dense pipeline off the TPU).  Counterpart: ``build_1d``,
    ``regent_fft_tpu/plan.py:318``."""
    fn = None
    if spec.dtype != "complex128":
        fn = _pf.build_c2c_1d_pallas(n, spec.direction)
    return fn if fn is not None else _general(spec, n, device)


def _step_name(spec: PlanSpec, kind_: str, a: int, arg) -> str:
    """The JAX package's trace-log string for a step (plan.py:439-553)."""
    if kind_ == "direct":
        return f"direct-einsum(n={arg})"
    if kind_ == "stockham":
        return f"kernel-butterfly(n={arg})"
    if kind_ == "stockham2":
        return f"kernel-fused2{arg}"
    if kind_ == "stockham4":
        return f"kernel-fourstep-last(n={arg})"
    if kind_ == "fourstep_ring":
        return f"kernel-fourstep-ring(n={arg})"
    if kind_ == "dma_ring":
        return f"kernel-dma-ring(n={arg})"
    if kind_ == "fused2_ring":
        return f"kernel-fused2-ring{arg}"
    if kind_ == "stockham_gap":
        return f"kernel-gap-fused{arg}"
    if kind_ == "general":
        desc = _stockham.schedule_description(
            spec.shape[a], spec.max_radix, _factor.device_type(spec.device))
        return f"1d-pipeline[{desc}]"
    n, n1 = arg
    return f"einsum-mixed2({n}={n1}x{n // n1})"


def run_steps(steps, xr, xi, direction: Direction, use_3m: bool,
              fuse_scale: float = 1.0):
    """Execute the steps; ``fuse_scale`` rides the last step's write when
    that step is a kernel.  bf16 planes go through the contraction steps
    as f32 and come back bf16 (plan.py:450-455, 554-555).
    Counterpart: ``regent_fft_tpu/plan.py:439``."""
    s = int(direction)
    last_fusable = (len(steps) - 1 if steps
                    and steps[-1][0] in KERNEL_STEPS else -1)
    for idx, (kind_, a, arg) in enumerate(steps):
        ksc = fuse_scale if idx == last_fusable else 1.0
        bf = (xr.dtype == torch.bfloat16
              and kind_ in ("direct", "mixed2", "general"))
        if bf:
            xr, xi = xr.float(), xi.float()
        if kind_ == "direct":
            xr, xi = _stockham.direct_dft_axis(xr, xi, a, arg, s, use_3m)
        elif kind_ == "stockham":
            xr, xi = _sk.fft_axis_stockham(xr, xi, a, direction, scale=ksc)
        elif kind_ == "stockham2":
            xr, xi = _sk.fft_axes2_stockham(xr, xi, direction, scale=ksc)
        elif kind_ == "stockham4":
            xr, xi = _fs.fft_last_four_step(xr, xi, direction, scale=ksc)
        elif kind_ == "fourstep_ring":
            xr, xi = _fs.fft_axis0_fourstep(xr, xi, a, direction, scale=ksc)
        elif kind_ == "dma_ring":
            xr, xi = _fs.fft_axis_dma(xr, xi, a, direction, scale=ksc)
        elif kind_ == "fused2_ring":
            xr, xi = _fs.fft_axes2_ring(xr, xi, direction, scale=ksc)
        elif kind_ == "stockham_gap":
            xr, xi = _sk.fft_axes_gap_stockham(xr, xi, direction, scale=ksc)
        elif kind_ == "general":
            xr, xi = _nd.apply_along_axis(arg, a, xr, xi)
        else:
            n, n1 = arg
            xr, xi = _stockham.mixed_radix_fft_axis(xr, xi, a, n, n1, s,
                                                    use_3m)
        if bf:
            xr, xi = xr.to(torch.bfloat16), xi.to(torch.bfloat16)
    return xr, xi


def _apply_scale(y, scale: float):
    """``y`` times the norm scale rounded to its dtype, as the JAX plan's
    ``y * jnp.asarray(scale, y.dtype)``."""
    return y * float(torch.tensor(scale, dtype=y.dtype))


# ---------------------------------------------------------------------------
# Real transforms
# ---------------------------------------------------------------------------
def _rev_freq(x, axes):
    """Modular frequency negation x[k] -> x[(-k) mod n] along ``axes``.

    Counterpart: ``regent_fft_tpu/plan.py:208``.
    """
    for a in axes:
        n = x.shape[a]
        x = torch.cat([x.narrow(a, 0, 1), x.narrow(a, 1, n - 1).flip(a)], a)
    return x


def _unpack_nyquist(yr, yi, axes):
    """(..., n/2) Nyquist-packed planes -> (..., n/2+1) half spectrum.

    After the other axes' transforms, bin 0 holds Z = F(X0) + i F(Nq),
    X0 and Nq the real bin-0 and bin-n/2 slabs; they untangle as
    F(X0) = (Z + conj Z[-k]) / 2, F(Nq) = (Z - conj Z[-k]) / 2i, with -k
    the reversal along every transformed axis.
    Counterpart: ``regent_fft_tpu/plan.py:218``.
    """
    zr, zi = yr[..., 0], yi[..., 0]
    rr, ri = _rev_freq(zr, axes), _rev_freq(zi, axes)
    x0r, x0i = 0.5 * (zr + rr), 0.5 * (zi - ri)
    nqr, nqi = 0.5 * (zi + ri), -0.5 * (zr - rr)
    return (torch.cat([x0r[..., None], yr[..., 1:], nqr[..., None]], -1),
            torch.cat([x0i[..., None], yi[..., 1:], nqi[..., None]], -1))


def _pack_nyquist(xr, xi, axes):
    """(..., n/2+1) half spectrum -> (..., n/2) Nyquist-packed planes.

    Bin 0 becomes X0 + i Nq, the bin-0 and bin-n/2 slabs each projected
    onto its conjugate-even part along ``axes`` first: that is what
    numpy's ``irfftn`` keeps of them (its last-axis irfft drops their
    imaginary parts), and the identity for Hermitian input.
    Counterpart: ``regent_fft_tpu/plan.py:242``.
    """
    m = xr.shape[-1] - 1

    def herm(r, i):
        return 0.5 * (r + _rev_freq(r, axes)), 0.5 * (i - _rev_freq(i, axes))

    x0r, x0i = herm(xr[..., 0], xi[..., 0])
    nqr, nqi = herm(xr[..., m], xi[..., m])
    pr, pi = xr[..., :m].clone(), xi[..., :m].clone()
    pr[..., 0] = x0r - nqi
    pi[..., 0] = x0i + nqr
    return pr, pi


def _half_shape(spec: PlanSpec) -> Tuple[int, ...]:
    """Complex-side shape of a real plan: (..., n/2+1), or (..., n/2) with
    ``packed_layout``.  Counterpart: ``regent_fft_tpu/plan.py:1105``."""
    shape = list(spec.shape)
    ax = spec.axes[-1]
    shape[ax] = shape[ax] // 2 if spec.packed_layout else shape[ax] // 2 + 1
    return tuple(shape)


class RealRoute(NamedTuple):
    """How a real plan transforms its real axis."""

    axis: int              # the real axis (the last listed one)
    n: int                 # its real length
    other: List[int]       # the axes the steps transform
    route: str             # "kernel" | "half" | "einsum"
    packed: bool           # Nyquist-packed planes between kernel and steps
    fn: Optional[Callable]  # the 1-D r2c/c2r of the half and einsum routes
    note: str              # describe()'s real-axis note


def _real_route(spec: PlanSpec, backend: str, steps, device=None,
                r2c_half: bool = False) -> RealRoute:
    """The JAX package's choice for the real axis (plan.py:619-739): the
    row-pair kernels where ``r2c_last_supported``, except that a 1-D C2R
    plan prefers the half-length reduction on the last-axis kernel (as
    does a 1-D R2C plan the row-pair kernel cannot take, and every R2C
    plan under ``r2c_half``, ``REGENT_FFT_R2C_1D=half``, which leaves a
    multi-axis R2C plan the dense reduction, as in the JAX package); else
    the reduction on the dense pipeline, built for the plan's ``device``."""
    r2c = spec.kind == Kind.R2C
    axis = spec.axes[-1]
    n = spec.shape[axis]
    other = [a for a in spec.axes if a != axis]
    last = (backend in ("stockham", "hybrid") and spec.dtype != "complex128"
            and axis == len(spec.shape) - 1)
    kernel = last and _sk.r2c_last_supported(n) and not (r2c and r2c_half)
    half = (not other and last and _sk.r2c_half_supported(n)
            and not (r2c and kernel))
    kernel = kernel and not half
    packed = (kernel and bool(steps or spec.packed_layout)
              and _sk.r2c_packed_supported(n))
    if spec.packed_layout and not packed:
        raise ValueError(
            "packed_layout requires the kernel real-transform path: "
            "power-of-two last axis with n/2 a lane multiple, and a "
            "stockham/hybrid backend (pass backend='stockham' explicitly "
            "on the CPU)")
    fn = None
    if not kernel:
        core = None
        if half:
            def core(zr, zi):
                return _sk.fft_axis_stockham(zr, zi, -1, spec.direction)
        build = _real.build_r2c_1d if r2c else _real.build_c2r_1d
        fn = build(n, spec.max_radix, spec.use_3m, core, device,
                   _general_dtype(spec))
    tag = "r2c" if r2c else "c2r"
    if kernel:
        route = "kernel"
        note = ("shared-head row-pair kernel r2c" if r2c
                else "fused kernel c2r")
        note += " [nyquist-packed mids]" if packed else ""
    elif half:
        route, note = "half", f"half-length conjugate-even kernel {tag}"
    else:
        route, note = "einsum", f"conjugate-even einsum {tag}"
    return RealRoute(axis, n, other, route, packed, fn, note)


def _kernel_lengths(steps, real: Optional[RealRoute], ndim: int):
    """The (length, stage-list function) pair of every twiddle table the
    kernels of a plan read, in step order, the real axis's last: a
    ``stockham2``, ``stockham_gap`` or ``fused2_ring`` step's two axes take
    ``fused2_stages`` (all run the cluster body); ``fft_last`` (a
    ``stockham`` step on the last axis of a rank >= 2 array, the n2 of a
    ``stockham4`` step, the half-length core of the real ``half`` route)
    and the real row-pair kernels of the ``kernel`` route take
    ``last_stages``; the column kernels ``cols_stages``: ``fft_cols`` and
    ``fft_axis0`` (every other ``stockham`` step), the axis ring
    (``dma_ring``), ``fft_cols_tw`` (the n1 of a ``stockham4`` step) and
    both four-step stages (``fourstep_ring``: r1 and r2); Bluestein's
    padded length m takes ``last_stages`` where its inner transforms run
    ``fft_last`` (a ``general`` step's, or the ``einsum`` real route's
    core, whose ``kernel_m`` is m).  ``ndim`` is the rank of the planes
    the steps transform."""
    cs, ls, fs2 = _sk.cols_stages, _sk.last_stages, _sk.fused2_stages
    out = []
    for kind_, a, arg in steps:
        if kind_ in ("stockham2", "stockham_gap", "fused2_ring"):
            out += [(arg[0], fs2), (arg[1], fs2)]
        elif kind_ == "stockham4":
            n1, n2 = _sk._four_step_split(arg)
            out += [(n1, cs), (n2, ls)]
        elif kind_ == "fourstep_ring":
            out += [(r, cs) for r in _sk._a0fs_split(arg)]
        elif kind_ == "stockham" and a == ndim - 1 and ndim > 1:
            out.append((arg, ls))
        elif kind_ in ("stockham", "dma_ring"):
            out.append((arg, cs))
        elif kind_ == "general" and getattr(arg, "kernel_m", None):
            out.append((arg.kernel_m, ls))
    if real is not None and getattr(real.fn, "kernel_m", None):
        out.append((real.fn.kernel_m, ls))
    if real is not None and real.route == "half":
        out.append((real.n // 2, ls))
    elif real is not None and real.route == "kernel":
        out.append((real.n, ls))
    return out


class Plan:
    """An executable C2C, R2C or C2R plan on one device, in complex64,
    complex32 or complex128.

    Create with :func:`make_plan`.  Reusable for any input of the planned
    shape.  ``switches`` are the environment switches as :func:`make_plan`
    read them (read here when None).  With ``race`` (the default) a
    "measure", "patient" or "exhaustive" planner races its candidates on
    the plan's device first (:meth:`_race`; the results in
    ``measurements``); ``race=False`` builds the steps of ``spec`` as it
    stands (:func:`_build_core`, a race's candidate).
    Counterpart: ``regent_fft_tpu/plan.py:790``.
    """

    def __init__(self, spec: PlanSpec, switches: Optional[Switches] = None,
                 race: bool = True):
        check_dtype(spec.dtype)
        self.spec = spec
        self.switches = Switches.from_env() if switches is None else switches
        self.device = resolve_device(spec.device)
        self.measurements = {}
        self.knobs = {}
        exec_spec = self._race(spec) if race else spec
        backend = exec_spec.backend
        if backend == "auto":
            backend = _auto_backend(exec_spec)
        self.backend = backend
        axes = spec.axes if spec.kind == Kind.C2C else spec.axes[:-1]
        steps = axis_steps(exec_spec, backend, sorted(axes, reverse=True),
                           self.gap_fused, self.device)
        self.real = (None if spec.kind == Kind.C2C
                     else _real_route(exec_spec, backend, steps, self.device,
                                      self.switches.r2c_half))
        step_shape = list(spec.shape)      # the planes the steps transform
        if self.real is not None:
            r = self.real
            step_shape[r.axis] = r.n // 2 if r.packed else r.n // 2 + 1
        self.steps = route_steps(exec_spec, steps, step_shape,
                                 self.switches)
        self.cdtype = _compute_dtype(spec)
        self.trace_log = {i: _step_name(exec_spec, k, a, arg)
                          for i, (k, a, arg) in enumerate(self.steps)}
        # the kernels' twiddle tables go to the card now, not on first call
        sign = int(spec.direction)
        self.tables = [] if self.device.type != "cuda" else [
            _sk.device_tables(n, sign, self.device, stages)
            for n, stages in _kernel_lengths(self.steps, self.real,
                                             len(step_shape))]
        self.scale = _norm_scale(spec)
        self.fused = bool(self.steps) and self.steps[-1][0] in KERNEL_STEPS
        self._destroyed = False

    @property
    def gap_fused(self) -> bool:
        """The ``REGENT_FFT_GAP_FUSED`` switch the plan was made under."""
        return self.switches.gap_fused

    def _race(self, spec: PlanSpec) -> PlanSpec:
        """The spec the plan runs, after the races of its planner tier on
        the plan's device (plan.py:802-872 there): "measure" and up race
        the schedules of every length (``deep`` for "exhaustive") and,
        under ``backend="auto"``, the backends; "patient" the routes;
        "exhaustive" the routes and the knobs.  A winner already in a
        wisdom table is taken as it stands ("cached-wisdom")."""
        if spec.planner not in ("measure", "patient", "exhaustive"):
            return spec
        from .utils import measure as _measure

        def build(s):
            return _build_core(s, self.switches)
        key = _backend_key(spec)
        self.measurements = _measure.measure_plan_sizes(
            spec, deep=spec.planner == "exhaustive")
        exec_spec = spec
        if spec.backend == "auto":
            winner = _BACKEND_WISDOM.get(key)
            timings = "cached-wisdom"
            if winner is None:
                winner, timings = _measure.measure_backends(spec, build)
                _BACKEND_WISDOM[key] = winner
            self.measurements["backend"] = {"winner": winner,
                                            "timings": timings}
            exec_spec = dataclasses.replace(spec, backend=winner)
        tier = spec.planner
        if tier == "measure":
            return exec_spec
        table = _PATIENT_WISDOM if tier == "patient" else _EXHAUSTIVE_WISDOM
        race = (_measure.measure_patient if tier == "patient"
                else _measure.measure_exhaustive)
        w = table.get(key)
        timings = "cached-wisdom"
        if w is None:
            w, timings = race(exec_spec, build)
            table[key] = dict(w)
        self.measurements[tier] = {"winner": dict(w), "timings": timings}
        self.knobs = dict(w.get("knobs") or {})
        return dataclasses.replace(
            exec_spec, axis0_impl=w.get("axis0_impl", exec_spec.axis0_impl),
            f2_impl=w.get("f2_impl", exec_spec.f2_impl))

    # -- accounting ------------------------------------------------------
    @property
    def flops(self) -> float:
        """Reported-flop convention: 5 N log2 N per transform (2.5 real).

        Counterpart: ``regent_fft_tpu/plan.py:885``.
        """
        return self.spec.batch * _factor.fft_flops_convention(
            self.spec.logical_n, self.spec.kind != Kind.C2C)

    @property
    def algorithm_flops(self) -> int:
        """Real-flop count of the matmul schedule (the JAX package's
        accounting, plan.py:891), for describe()."""
        total = 0
        n_all = self.spec.logical_n
        mr = self.spec.max_radix
        for n in self.spec.transform_lengths:
            kind, info = _factor.plan_factors(n, mr, device=self.device)
            factors = (n,) if kind == "direct" else info if kind == "mixed" else None
            if factors is None:
                m = info
                kind2, mf = _factor.plan_factors(m, mr, device=self.device)
                if kind2 == "direct":
                    mf = (m,)
                cmuls = 1 if kind == "rader" else 3
                per = 2 * _factor.stage_flops(m, mf) + 6 * cmuls * m
                total += (n_all // n) * (per // n if n else 0) * n
            else:
                total += (n_all // n) * _factor.stage_flops(n, factors)
        scale = 1.0 if self.spec.kind == Kind.C2C else 0.5
        return int(self.spec.batch * total * scale)

    def cost(self) -> float:
        """``fftw_cost`` analog: the native cost model's estimate for the
        plan, in its time units; 0.0 where the model is not built or a
        length falls outside it (FFTW's "no cost information").
        Counterpart: ``regent_fft_tpu/plan.py:914``."""
        from .native import planner as _native
        if not _native.available():
            return 0.0
        total = 0.0
        n_all = self.spec.logical_n
        for n in self.spec.transform_lengths:
            per = _native.schedule_cost(n, self.spec.max_radix)
            if per is None or per <= 0:
                return 0.0
            total += per * (n_all // max(n, 1))
        return self.spec.batch * total

    @property
    def bytes_ideal(self) -> int:
        """Least device-memory traffic: read the input once, write the
        output once, at 4, 8 or 16 B per complex element (complex32, 64,
        128); a real element counts half of that.
        Counterpart: ``regent_fft_tpu/plan.py:935``."""
        itemsize = {"complex32": 4, "complex64": 8,
                    "complex128": 16}[self.spec.dtype]
        n_elems = int(np.prod(self.spec.shape))
        if self.spec.kind == Kind.C2C:
            return 2 * n_elems * itemsize
        return (n_elems * itemsize // 2
                + int(np.prod(_half_shape(self.spec))) * itemsize)

    def describe(self) -> str:
        """fftw_print_plan analog, with the JAX package's step lines.

        Counterpart: ``regent_fft_tpu/plan.py:972``.
        """
        s = self.spec
        lines = [
            f"(plan-{s.kind.value}-{len(s.axes)}d shape={s.shape} axes={s.axes} "
            f"dir={'fwd' if s.direction == Direction.FORWARD else 'bwd'} "
            f"norm={s.norm.value} dtype={s.dtype} backend={s.backend} "
            f"precision={s.precision}{' 3M' if s.use_3m else ''} "
            f"device={s.device}"
        ]
        real_line = (None if self.real is None else
                     f"  (real axis {self.real.axis}: n={self.real.n} "
                     f"{self.real.note})")
        if s.kind == Kind.R2C:
            lines.append(real_line)      # r2c: the real axis goes first
        for idx, (_, a, _) in enumerate(self.steps):
            lines.append(f"  (axis {a}: {self.trace_log[idx]})")
        if s.kind == Kind.C2R:
            lines.append(real_line)      # c2r: the real axis goes last
        lines.append(
            f"  (flops={self.flops:.3e} [5NlogN conv] "
            f"algo_flops={self.algorithm_flops:.3e} batch={s.batch}))")
        return "\n".join(lines)

    def print_plan(self):
        print(self.describe())

    def __repr__(self):
        s = self.spec
        return (f"Plan({s.kind.value}, shape={s.shape}, axes={s.axes}, "
                f"dir={int(s.direction)}, dtype={s.dtype}, device={s.device})")

    @property
    def core_fn(self) -> Callable:
        """The split-plane core: :meth:`execute_real` for an R2C plan (one
        real plane in, the half-spectrum planes out), else
        :meth:`execute_split`.  Counterpart: ``regent_fft_tpu/plan.py:1010``.
        """
        return (self.execute_real if self.spec.kind == Kind.R2C
                else self.execute_split)

    def benchmark(self, iters: int = 10, seed: int = 0, *,
                  latency: bool = False,
                  profile_dir: Optional[str] = None) -> dict:
        """Time the plan by the port's one method (``utils/timing.py``):
        the median of ``iters`` calls of :attr:`core_fn` on the plan's
        device, CUDA events with the L2 flushed on a card; or with
        ``latency`` the fastest ``plan(x)`` from a host array, the round
        trip included (``latency_s``).  Reports GFLOP/s by the 5 N log2 N
        convention and the fraction of the device's roofline, priced on
        its datasheet whatever calibration is installed (None on a device
        with no entry: ``flopcount.datasheet``): the function's bound, :attr:`bytes_ideal` over the memory rate or :attr:`flops`
        (5 N log2 N) over the FP32 peak, whichever is larger; the JAX
        package prices :attr:`algorithm_flops`, the dense matmul
        schedule's, which the butterfly kernels do not run.  ``profile_dir``
        adds one traced call (``timing.trace``), written there as a
        Chrome trace, its total and its kernels under ``"trace"``.
        Counterpart: ``regent_fft_tpu/plan.py:1014``."""
        from .utils import flopcount as _fc
        from .utils import timing as _timing
        if latency:
            best = _timing.time_plan_latency(self, iters=iters, seed=seed)
        else:
            best = _timing.time_plan(self, reps=iters, seed=seed)
        hw = _fc.datasheet(self.device)
        out = {
            "time_s": best,
            "gflops_convention": self.flops / best / 1e9,
            "roofline_fraction": _fc.roofline_fraction(
                self.bytes_ideal, self.flops, best, hw),
            "hardware": None if hw is None else hw.name,
            "methodology": ("latency" if latency
                            else _timing.methodology(self.device)),
        }
        if latency:
            out["latency_s"] = best
        if profile_dir:
            args = _timing.plan_inputs(self, seed)
            total, rows = _timing.trace(lambda: self.core_fn(*args),
                                        self.device, profile_dir)
            out["trace"] = {"ms": total, "by_kernel": rows}
        return out

    # -- execution -------------------------------------------------------
    def _steps(self, xr, xi):
        with _sk.mxu_impl_scope(self.switches.mxu_impl):
            return run_steps(self.steps, xr, xi, self.spec.direction,
                             self.spec.use_3m,
                             fuse_scale=self.scale if self.fused else 1.0)

    def execute_split(self, xr: torch.Tensor, xi: torch.Tensor):
        """Run a C2C or C2R plan on contiguous planes of the plan's compute
        dtype (``cdtype``) already on the plan's device: returns the output
        planes (C2C) or the real output (C2R) in that dtype.
        Counterpart: the JAX plan's core (plan.py:606,741).
        """
        if self.spec.kind == Kind.R2C:
            raise TypeError("an R2C plan takes one real plane: execute_real")
        r = self.real
        if r is None:
            yr, yi = self._steps(xr, xi)
            if self.scale != 1.0 and not self.fused:
                yr = _apply_scale(yr, self.scale)
                yi = _apply_scale(yi, self.scale)
            return yr, yi
        if r.route == "kernel":
            if r.packed and not self.spec.packed_layout:
                xr, xi = _pack_nyquist(xr, xi, r.other)
            xr, xi = self._steps(xr, xi)
            return _sk.ifft_last_c2r_stockham(
                xr, xi, r.n, packed=r.packed,
                scale=1.0 if self.fused else self.scale)
        xr, xi = self._steps(xr, xi)
        y = _nd.apply_along_axis_real_out(r.fn, r.axis, xr, xi)
        return (y if self.fused or self.scale == 1.0
                else _apply_scale(y, self.scale))

    def execute_real(self, x: torch.Tensor):
        """Run an R2C plan on one contiguous real plane of the plan's
        compute dtype already on the plan's device; returns the
        half-spectrum planes.
        Counterpart: the JAX plan's R2C core (plan.py:674).
        """
        if self.spec.kind != Kind.R2C:
            raise TypeError("only an R2C plan takes a real plane")
        r = self.real
        if r.route == "kernel":
            yr, yi = _sk.fft_last_r2c_stockham(
                x, packed=r.packed, scale=1.0 if self.fused else self.scale)
            yr, yi = self._steps(yr, yi)
            if r.packed and not self.spec.packed_layout:
                yr, yi = _unpack_nyquist(yr, yi, r.other)
            return yr, yi
        yr, yi = self._steps(*_nd.apply_along_axis_real_in(r.fn, r.axis, x))
        if self.scale != 1.0 and not self.fused:
            yr = _apply_scale(yr, self.scale)
            yi = _apply_scale(yi, self.scale)
        return yr, yi

    def __call__(self, x):
        """Transform ``x`` on the plan's device.

        C2C takes a numpy array, tensor or SplitComplex and returns the
        plan dtype's representation: ``torch.complex64``,
        ``torch.complex128``, or for complex32 a SplitComplex of bf16
        planes.  R2C takes a real array or tensor and returns the half
        spectrum in the same representation; C2R takes the half spectrum
        and returns float32, float64 or bfloat16.
        Counterpart: ``regent_fft_tpu/plan.py:1056``.
        """
        if self._destroyed:
            raise RuntimeError("plan was destroyed (destroy_plan); re-plan first")
        s = self.spec
        if s.kind == Kind.R2C:
            x = as_real(x, self.device, self.cdtype)
            if tuple(x.shape) != s.shape:
                raise ValueError(f"input shape {tuple(x.shape)} != planned "
                                 f"{s.shape}")
            return from_split(SplitComplex(*self.execute_real(x)), s.dtype)
        sx = as_split(x, self.device, self.cdtype)
        expect = s.shape if s.kind == Kind.C2C else _half_shape(s)
        if sx.shape != expect:
            raise ValueError(f"input shape {sx.shape} != planned {expect}")
        if s.kind == Kind.C2R:
            y = self.execute_split(sx.re, sx.im)
            return y.to(torch.bfloat16) if s.dtype == "complex32" else y
        return from_split(SplitComplex(*self.execute_split(sx.re, sx.im)),
                          s.dtype)

    execute = __call__

    def inverse(self) -> "Plan":
        """Plan for the mathematical inverse of this transform, under the
        same switches as this plan.

        Counterpart: ``regent_fft_tpu/plan.py:1080``.
        """
        s = self.spec
        if s.norm == Norm.NONE:
            inv_norm = (Norm.BACKWARD if s.direction == Direction.FORWARD
                        else Norm.FORWARD)
        else:
            inv_norm = s.norm
        if s.kind == Kind.R2C:
            inv = dataclasses.replace(
                s, kind=Kind.C2R, direction=Direction.BACKWARD, norm=inv_norm)
        elif s.kind == Kind.C2R:
            inv = dataclasses.replace(
                s, kind=Kind.R2C, direction=Direction.FORWARD, norm=inv_norm)
        else:
            d = (Direction.BACKWARD if s.direction == Direction.FORWARD
                 else Direction.FORWARD)
            inv = dataclasses.replace(s, direction=d, norm=inv_norm)
        return _cached_plan(inv, self.switches)


# ---------------------------------------------------------------------------
# Plan cache + lifecycle API
# ---------------------------------------------------------------------------
_PLAN_CACHE: dict = {}     # (spec, switches) -> Plan


def _cached_plan(spec: PlanSpec, switches: Switches) -> Plan:
    plan = _PLAN_CACHE.get((spec, switches))
    if plan is None or plan._destroyed:
        plan = Plan(spec, switches)
        _PLAN_CACHE[(spec, switches)] = plan
        from .utils.plog import log_plan
        log_plan(plan)
    return plan


def make_plan(spec_or_shape, **kwargs) -> Plan:
    """Create (or fetch from the cache) a plan.

    ``make_plan(PlanSpec(...))`` or ``make_plan(shape, **fields)``; a shape
    defaults to a forward C2C transform over all axes on ``"cuda"``.  Reads
    the environment switches (:class:`Switches`), and the cache keys on
    them.
    Counterpart: ``regent_fft_tpu/plan.py:1125``.
    """
    if isinstance(spec_or_shape, PlanSpec):
        spec = spec_or_shape
    else:
        shape = tuple(spec_or_shape)
        kwargs.setdefault("axes", tuple(range(len(shape))))
        kwargs.setdefault("kind", Kind.C2C)
        kwargs.setdefault("direction", Direction.FORWARD)
        spec = PlanSpec(shape=shape, **kwargs)
    return _cached_plan(spec, Switches.from_env())


def execute_plan(plan: Plan, x):
    """Counterpart: ``regent_fft_tpu/plan.py:1148``."""
    return plan(x)


def destroy_plan(plan: Plan):
    """Evict from the cache and mark the plan unusable.

    Counterpart: ``regent_fft_tpu/plan.py:1153``.
    """
    _PLAN_CACHE.pop((plan.spec, plan.switches), None)
    plan._destroyed = True


def clear_plan_cache():
    """Counterpart: ``regent_fft_tpu/plan.py:1165``."""
    _PLAN_CACHE.clear()


def cached_plans():
    """Counterpart: ``regent_fft_tpu/plan.py:1170``."""
    return list(_PLAN_CACHE.values())


def _build_core(spec: PlanSpec, switches: Optional[Switches] = None) -> Plan:
    """The unraced, uncached plan of ``spec`` as it stands, under
    ``switches`` (the environment's when None): a race's candidate
    (``utils/measure.py`` times its ``core_fn``).
    Counterpart: ``regent_fft_tpu/plan.py:296``."""
    return Plan(spec, switches, race=False)


def cleanup():
    """``fftw_cleanup`` analog: drop every cached plan and all planner
    knowledge (schedule overrides, winners, calibration).  Plans a caller
    holds keep working.  Counterpart: ``regent_fft_tpu/plan.py:1174``."""
    from .utils import wisdom as _wisdom
    _wisdom.forget_wisdom()
