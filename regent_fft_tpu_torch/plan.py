"""Plan lifecycle of the PyTorch port: complex64 C2C at any rank.

Counterpart: ``regent_fft_tpu/plan.py``.  A :class:`Plan` precomputes the
per-axis step list (the same list the JAX package builds, so
``describe()`` prints the same step lines) and runs it eagerly on the
plan's device:

* ``stockham``  one butterfly-kernel pass along an axis
  (``ops/stockham_kernels.fft_axis_stockham``);
* ``stockham2`` one fused kernel pass over the trailing axis pair
  (``fft_axes2_stockham``);
* ``direct`` / ``mixed2`` dense DFT contractions (``ops/stockham.py``).

The norm scale rides the last kernel step's write when the list ends in
one.  Plans live on ``device`` (default ``"cuda"``); ``device="cpu"`` is
opt-in and runs the kernels' plain versions.

Outside this slice (each raises ``NotImplementedError`` naming its
ROADMAP item): R2C/C2R, complex32/complex128, the four-step last axis
(``stockham4``, n > 2048), the general 1-D pipeline, ``backend="pallas"``,
planners other than ``"estimate"``, the TPU leading-axis routes
(``axis0_impl`` fourstep/dma) and ``precision`` other than
``"highest"``.  The gap-fused pass (``stockham_gap``) is reachable in the
JAX package only through an environment switch the port does not read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from .dtypes import (Direction, Kind, Norm, SplitComplex, as_split,
                     check_dtype, from_split)
from .ops import factor as _factor
from .ops import stockham as _stockham
from .ops import stockham_kernels as _sk


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
        if len(set(axes)) != len(axes):
            raise ValueError(f"duplicate axes: {self.axes}")
        if not axes:
            raise ValueError("at least one transform axis required")
        if self.kind == Kind.R2C and self.direction != Direction.FORWARD:
            raise ValueError("R2C transforms are forward-only (use C2R for inverse)")
        if self.kind == Kind.C2R and self.direction != Direction.BACKWARD:
            raise ValueError("C2R transforms are backward-only")
        if self.backend not in ("auto", "xla", "stockham", "hybrid", "pallas"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.planner not in ("estimate", "model", "measure", "patient",
                                "exhaustive"):
            raise ValueError(f"unknown planner {self.planner!r}")
        if self.axis0_impl not in ("auto", "fourstep", "dma", "grid"):
            raise ValueError(f"axis0_impl must be auto|fourstep|dma|grid, "
                             f"got {self.axis0_impl!r}")
        if self.f2_impl not in ("auto", "grid", "ring", "off"):
            raise ValueError(f"f2_impl must be auto|grid|ring|off, "
                             f"got {self.f2_impl!r}")
        if self.max_radix < 2:
            raise ValueError(f"max_radix must be >= 2, got {self.max_radix}")

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


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is {item} of the PyTorch port")


def _check_scope(spec: PlanSpec):
    """Raise for the parts of the JAX plan outside this slice."""
    check_dtype(spec.dtype)
    if spec.kind != Kind.C2C:
        _unported(f"{spec.kind.value.upper()} planning", "ROADMAP slice 3")
    if spec.backend == "pallas":
        _unported('backend="pallas" (matmul-form kernels)',
                  "ROADMAP Queue 2 (pallas_fft.py kernels)")
    if spec.planner != "estimate":
        _unported(f'planner="{spec.planner}"', "ROADMAP Queue 1 #11")
    if spec.axis0_impl in ("fourstep", "dma"):
        _unported(f'axis0_impl="{spec.axis0_impl}"', "ROADMAP slice 2")
    if spec.f2_impl == "ring":
        _unported('f2_impl="ring"', "ROADMAP slice 2")
    if spec.precision != "highest":
        _unported(f'precision="{spec.precision}"', "ROADMAP slice 4")


def _resolve_device(spec: PlanSpec) -> torch.device:
    dev = torch.device(spec.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: regent_fft_tpu_torch plans run on the card; "
            "pass device='cpu' to run the plain versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {spec.device!r}")
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


def axis_steps(spec: PlanSpec, backend: str, axes_list):
    """Per-axis steps with the JAX package's routing.

    Counterpart: ``regent_fft_tpu/plan.py:333`` (``axis_steps``): the
    trailing pair fuses into one ``stockham2`` step when
    ``fused2_supported``; a kernel length within its cap is a
    ``stockham`` step; otherwise a ``direct`` (n <= xla_direct_max) or
    ``mixed2`` contraction step.
    """
    steps = []
    ndim = len(spec.shape)
    axes_list = list(axes_list)
    kernels = backend in ("stockham", "hybrid")
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
                    _unported(f"the four-step last axis (n={n})",
                              "ROADMAP slice 2")
        ov = _factor._SCHEDULE_OVERRIDES.get((n, spec.max_radix))
        if ov is not None:
            if len(ov) == 1:
                steps.append(("direct", a, n))
            elif len(ov) == 2:
                steps.append(("mixed2", a, (n, ov[0])))
            else:
                _stockham.build_c2c_1d(n)
            continue
        if 2 <= n <= spec.xla_direct_max:
            steps.append(("direct", a, n))
            continue
        split = _stockham.best_two_factor(n, spec.max_radix)
        if split is None:
            _stockham.build_c2c_1d(n)
        steps.append(("mixed2", a, (n, split[0])))
    return steps


def _step_name(kind_: str, arg) -> str:
    """The JAX package's trace-log string for a step (plan.py:439-553)."""
    if kind_ == "direct":
        return f"direct-einsum(n={arg})"
    if kind_ == "stockham":
        return f"kernel-butterfly(n={arg})"
    if kind_ == "stockham2":
        return f"kernel-fused2{arg}"
    n, n1 = arg
    return f"einsum-mixed2({n}={n1}x{n // n1})"


def run_steps(steps, xr, xi, direction: Direction, use_3m: bool,
              fuse_scale: float = 1.0):
    """Execute the steps; ``fuse_scale`` rides the last step's write when
    that step is a kernel.  Counterpart: ``regent_fft_tpu/plan.py:439``."""
    s = int(direction)
    last_fusable = (len(steps) - 1 if steps
                    and steps[-1][0] in ("stockham", "stockham2") else -1)
    for idx, (kind_, a, arg) in enumerate(steps):
        ksc = fuse_scale if idx == last_fusable else 1.0
        if kind_ == "direct":
            xr, xi = _stockham.direct_dft_axis(xr, xi, a, arg, s, use_3m)
        elif kind_ == "stockham":
            xr, xi = _sk.fft_axis_stockham(xr, xi, a, direction, scale=ksc)
        elif kind_ == "stockham2":
            xr, xi = _sk.fft_axes2_stockham(xr, xi, direction, scale=ksc)
        else:
            n, n1 = arg
            xr, xi = _stockham.mixed_radix_fft_axis(xr, xi, a, n, n1, s,
                                                    use_3m)
    return xr, xi


class Plan:
    """An executable complex64 C2C plan on one device.

    Create with :func:`make_plan`.  Reusable for any input of the planned
    shape.  Counterpart: ``regent_fft_tpu/plan.py:790``.
    """

    def __init__(self, spec: PlanSpec):
        _check_scope(spec)
        self.spec = spec
        self.device = _resolve_device(spec)
        backend = spec.backend
        if backend == "auto":
            # plan.py:316: the kernel hybrid on the accelerator, the
            # contraction path elsewhere
            backend = "hybrid" if self.device.type == "cuda" else "xla"
        self.backend = backend
        self.steps = axis_steps(spec, backend, sorted(spec.axes, reverse=True))
        self.trace_log = {i: _step_name(k, arg)
                          for i, (k, _, arg) in enumerate(self.steps)}
        # the kernels' twiddle tables go to the card now, not on first call
        self.tables = [] if self.device.type != "cuda" else [
            _sk.device_tables(n, int(spec.direction), self.device)
            for k, _, arg in self.steps if k in ("stockham", "stockham2")
            for n in (arg if k == "stockham2" else (arg,))]
        self.scale = _norm_scale(spec)
        self.fused = bool(self.steps) and self.steps[-1][0] in ("stockham",
                                                                "stockham2")
        self._destroyed = False

    # -- accounting ------------------------------------------------------
    @property
    def flops(self) -> float:
        """Reported-flop convention: 5 N log2 N per transform.

        Counterpart: ``regent_fft_tpu/plan.py:885``.
        """
        return self.spec.batch * _factor.fft_flops_convention(self.spec.logical_n)

    @property
    def algorithm_flops(self) -> int:
        """Real-flop count of the matmul schedule (the JAX package's
        accounting, plan.py:891), for describe()."""
        total = 0
        n_all = self.spec.logical_n
        mr = self.spec.max_radix
        for n in self.spec.transform_lengths:
            kind, info = _factor.plan_factors(n, mr)
            factors = (n,) if kind == "direct" else info if kind == "mixed" else None
            if factors is None:
                m = info
                kind2, mf = _factor.plan_factors(m, mr)
                if kind2 == "direct":
                    mf = (m,)
                cmuls = 1 if kind == "rader" else 3
                per = 2 * _factor.stage_flops(m, mf) + 6 * cmuls * m
                total += (n_all // n) * (per // n if n else 0) * n
            else:
                total += (n_all // n) * _factor.stage_flops(n, factors)
        return int(self.spec.batch * total)

    @property
    def bytes_ideal(self) -> int:
        """Least device-memory traffic: read the input once, write the
        output once.  Counterpart: ``regent_fft_tpu/plan.py:935``."""
        return 2 * int(np.prod(self.spec.shape)) * 8

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
        for idx, (_, a, _) in enumerate(self.steps):
            lines.append(f"  (axis {a}: {self.trace_log[idx]})")
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

    # -- execution -------------------------------------------------------
    def execute_split(self, xr: torch.Tensor, xi: torch.Tensor):
        """Run the steps on contiguous f32 planes already on the plan's
        device; returns the output planes."""
        yr, yi = run_steps(self.steps, xr, xi, self.spec.direction,
                           self.spec.use_3m,
                           fuse_scale=self.scale if self.fused else 1.0)
        if self.scale != 1.0 and not self.fused:
            yr = yr * self.scale
            yi = yi * self.scale
        return yr, yi

    def __call__(self, x) -> torch.Tensor:
        """Transform ``x`` (numpy array, tensor or SplitComplex) and return
        a ``torch.complex64`` tensor on the plan's device.

        Counterpart: ``regent_fft_tpu/plan.py:1056``.
        """
        if self._destroyed:
            raise RuntimeError("plan was destroyed (destroy_plan); re-plan first")
        sx = as_split(x, self.device)
        if sx.shape != self.spec.shape:
            raise ValueError(f"input shape {sx.shape} != planned {self.spec.shape}")
        return from_split(SplitComplex(*self.execute_split(sx.re, sx.im)))

    execute = __call__

    def inverse(self) -> "Plan":
        """Plan for the mathematical inverse of this transform.

        Counterpart: ``regent_fft_tpu/plan.py:1080``.
        """
        s = self.spec
        if s.norm == Norm.NONE:
            inv_norm = (Norm.BACKWARD if s.direction == Direction.FORWARD
                        else Norm.FORWARD)
        else:
            inv_norm = s.norm
        d = (Direction.BACKWARD if s.direction == Direction.FORWARD
             else Direction.FORWARD)
        return make_plan(dataclasses.replace(s, direction=d, norm=inv_norm))


# ---------------------------------------------------------------------------
# Plan cache + lifecycle API
# ---------------------------------------------------------------------------
_PLAN_CACHE: dict = {}


def make_plan(spec_or_shape, **kwargs) -> Plan:
    """Create (or fetch from the cache) a plan.

    ``make_plan(PlanSpec(...))`` or ``make_plan(shape, **fields)``; a shape
    defaults to a forward C2C transform over all axes on ``"cuda"``.
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
    plan = _PLAN_CACHE.get(spec)
    if plan is None or plan._destroyed:
        plan = Plan(spec)
        _PLAN_CACHE[spec] = plan
        from .utils.plog import log_plan
        log_plan(plan)
    return plan


def execute_plan(plan: Plan, x):
    """Counterpart: ``regent_fft_tpu/plan.py:1148``."""
    return plan(x)


def destroy_plan(plan: Plan):
    """Evict from the cache and mark the plan unusable.

    Counterpart: ``regent_fft_tpu/plan.py:1153``.
    """
    _PLAN_CACHE.pop(plan.spec, None)
    plan._destroyed = True


def clear_plan_cache():
    """Counterpart: ``regent_fft_tpu/plan.py:1165``."""
    _PLAN_CACHE.clear()


def cached_plans():
    """Counterpart: ``regent_fft_tpu/plan.py:1170``."""
    return list(_PLAN_CACHE.values())
