"""One-shot calibration of the model planner's cost parameters.

Counterpart: ``regent_fft_tpu/utils/calibrate.py``.  FFTW's planner learns
a machine by timing solvers (``kernel/planner.c``) and keeps the result as
wisdom.  Here measure-mode (``utils/measure.py``) times whole schedules,
and this module calibrates the *model* planner, the cost model of
``native/planner.cc``, from four probes run once on the device with the
port's timer (``utils/timing.py``):

* the matmul rate: an f32 ``torch.matmul`` with TF32 off (a probe of the
  rate the contraction steps run at, not a kernel of the port);
* the elementwise rate: a twiddle-shaped complex multiply (6 flops an
  element), as the contraction steps' twiddle passes run it;
* the bandwidth: ``timing.measured_copy_gbps``;
* the stage overhead: the time of the executor's two-stage contraction
  step (``stockham.mixed_radix_fft_axis``) left over after its matmul
  flops, its twiddle pass and its two passes over device memory are
  priced at the measured rates, half of it a stage (the JAX package's
  residual, calibrate.py:174).

``mxu_edge`` keeps the reference's 128.  ``calibrate(install=True)`` sets
the native cost parameters, has ``flopcount.detect_hardware`` report the
measured rates (a roofline fraction stays priced on the datasheet), and
keeps the calibration for wisdom export.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Measured rates of one device and the cost parameters they give.

    ``mxu_rate`` stays 1.0: the model's time unit is one matmul flop at
    the measured rate, and only the ratios below steer the DP.
    Counterpart: ``regent_fft_tpu/utils/calibrate.py:37``.
    """

    device: str
    mxu_tflops: float          # f32 matmul rate (TFLOP/s)
    vpu_gflops: float          # elementwise rate (GFLOP/s)
    hbm_gbps: float            # device-memory bandwidth (GB/s)
    stage_overhead_s: float    # fixed seconds per stage (per call)
    mxu_edge: float = 128.0
    mxu_rate: float = 1.0

    @property
    def vpu_rate(self) -> float:
        """Elementwise flops per matmul flop in a unit of time."""
        if self.mxu_tflops <= 0:
            return 0.05
        return max(self.vpu_gflops * 1e9 / (self.mxu_tflops * 1e12), 1e-6)

    @property
    def bw_unit(self) -> float:
        """A byte of device-memory traffic in matmul-flop time units."""
        if self.mxu_tflops <= 0 or self.hbm_gbps <= 0:
            return 100.0
        return self.mxu_tflops * 1e12 / (self.hbm_gbps * 1e9)

    def stage_overhead_units(self, n: int = 1024, batch: int = 1024) -> float:
        """The model charges ``stage_overhead * n * 0.25`` matmul-flop
        units a stage a batch row; the measured seconds in those units."""
        if self.stage_overhead_s <= 0 or self.mxu_tflops <= 0:
            return 0.0
        units = self.stage_overhead_s * self.mxu_tflops * 1e12
        return units / (0.25 * n * batch)

    def to_dict(self) -> dict:
        return {"device": self.device, "mxu_tflops": self.mxu_tflops,
                "vpu_gflops": self.vpu_gflops, "hbm_gbps": self.hbm_gbps,
                "stage_overhead_s": self.stage_overhead_s,
                "mxu_edge": self.mxu_edge, "mxu_rate": self.mxu_rate}

    @staticmethod
    def from_dict(d: dict) -> "Calibration":
        return Calibration(
            device=str(d.get("device", "unknown")),
            mxu_tflops=float(d["mxu_tflops"]),
            vpu_gflops=float(d["vpu_gflops"]),
            hbm_gbps=float(d["hbm_gbps"]),
            stage_overhead_s=float(d["stage_overhead_s"]),
            mxu_edge=float(d.get("mxu_edge", 128.0)),
            mxu_rate=float(d.get("mxu_rate", 1.0)))


_CURRENT: Optional[Calibration] = None


def current() -> Optional[Calibration]:
    """The installed calibration (None before calibrate or import)."""
    return _CURRENT


def _randn(shape, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device)


def measure_mxu_tflops(m: int = 8192, k: int = 1024, reps: int = 10,
                       device="cuda") -> float:
    """f32 rate of an (m, k) @ (k, k) ``torch.matmul`` with TF32 off (the
    contraction steps' exact f32 products).  Counterpart: :115."""
    a = _randn((m, k), device, 0)
    w = _randn((k, k), device, 1) / math.sqrt(k)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        from . import timing as _timing
        ms = _timing.time_ms(lambda: torch.matmul(a, w), reps, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return 2.0 * m * k * k / (ms * 1e-3) / 1e12


def measure_vpu_gflops(rows: int = 4096, cols: int = 4096, inner: int = 8,
                       reps: int = 10, device="cuda") -> float:
    """Elementwise rate of ``inner`` in-place complex multiplies by a
    twiddle plane (6 flops an element each), as the contraction steps'
    twiddle passes run.  Counterpart: :147."""
    theta = 2 * math.pi * torch.rand((rows, cols), device=device,
                                     generator=torch.Generator(
                                         device=device).manual_seed(2))
    w = torch.polar(torch.ones_like(theta), theta)
    x = torch.complex(_randn((rows, cols), device, 3),
                      _randn((rows, cols), device, 4))

    def step():
        for _ in range(inner):
            x.mul_(w)
    from . import timing as _timing
    ms = _timing.time_ms(step, reps, device)
    return 6.0 * inner * rows * cols / (ms * 1e-3) / 1e9


def measure_stage_overhead_s(n: int = 1024, batch: int = 1024,
                             mxu_tflops: float = 0.0,
                             vpu_gflops: float = 0.0,
                             hbm_gbps: float = 0.0, reps: int = 10,
                             device="cuda") -> float:
    """Fixed cost a stage: the time of the executor's two-stage step on
    (batch, n) planes less the rate model's prediction (two passes over
    device memory, the true matmul flops, one twiddle pass), half of it a
    stage, at least 0.  Counterpart: :184."""
    from ..ops import factor as _factor
    from ..ops import stockham as _stockham
    from . import measure as _measure
    s2 = _stockham.best_two_factor(n, _factor.DEFAULT_MAX_RADIX)
    if s2 is None:
        raise ValueError(f"n={n} lacks a two-factor split; pick a smooth n")
    t2 = _measure.time_fn(_measure._schedule_step_fn(n, s2, -1, False),
                          (batch, n), k=reps, device=device)
    predicted = 0.0
    if hbm_gbps > 0:
        predicted += 2 * 16.0 * n * batch / (hbm_gbps * 1e9)
    if mxu_tflops > 0:
        predicted += 8.0 * n * sum(s2) * batch / (mxu_tflops * 1e12)
    if vpu_gflops > 0:
        predicted += 6.0 * n * batch / (vpu_gflops * 1e9)
    return max(t2 - predicted, 0.0) / 2.0


def calibrate(install: bool = True, quick: bool = False,
              device="cuda") -> Calibration:
    """Run the probes on ``device`` and optionally install the result.

    ``quick`` shrinks every probe (CPU tests; the numbers are valid but
    noisy).  Counterpart: ``regent_fft_tpu/utils/calibrate.py:222``.
    """
    from . import timing as _timing
    from ..plan import resolve_device
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if quick:
        mxu = measure_mxu_tflops(m=512, k=256, reps=3, device=dev)
        vpu = measure_vpu_gflops(rows=256, cols=512, inner=4, reps=3,
                                 device=dev)
        hbm = _timing.measured_copy_gbps(nbytes=1 << 25, reps=3,
                                         min_bytes=1 << 25, device=dev)
        ovh = measure_stage_overhead_s(n=256, batch=64, mxu_tflops=mxu,
                                       vpu_gflops=vpu, hbm_gbps=hbm, reps=3,
                                       device=dev)
    else:
        mxu = measure_mxu_tflops(device=dev)
        vpu = measure_vpu_gflops(device=dev)
        hbm = _timing.measured_copy_gbps(device=dev)
        ovh = measure_stage_overhead_s(mxu_tflops=mxu, vpu_gflops=vpu,
                                       hbm_gbps=hbm, device=dev)
    cal = Calibration(device=name, mxu_tflops=mxu, vpu_gflops=vpu,
                      hbm_gbps=hbm, stage_overhead_s=ovh)
    if install:
        install_calibration(cal)
    return cal


def install_calibration(cal: Calibration) -> None:
    """Apply a calibration (measured now or imported from wisdom): the
    native cost parameters and the rates ``flopcount.detect_hardware``
    reports for its device (``Plan.benchmark``'s roofline stays on the
    datasheet).
    Counterpart: ``regent_fft_tpu/utils/calibrate.py:255``."""
    global _CURRENT
    _CURRENT = cal
    from ..native import planner as _native
    from . import flopcount as _fc
    _native.set_cost_params(cal.mxu_edge, cal.mxu_rate, cal.vpu_rate,
                            cal.stage_overhead_units(), cal.bw_unit)
    _fc.install_measured(cal.device, hbm_gbps=cal.hbm_gbps,
                         f32_tflops=cal.mxu_tflops)
    from .plog import logger
    logger.info("calibration installed: %s", cal.to_dict())


def reset_calibration() -> None:
    """Drop the installed calibration: the native parameters go back to
    their defaults, ``detect_hardware`` to the datasheet.
    Counterpart: ``regent_fft_tpu/utils/calibrate.py:269``."""
    global _CURRENT
    _CURRENT = None
    from ..native import planner as _native
    from . import flopcount as _fc
    _native.set_cost_params()
    _fc.clear_measured()
