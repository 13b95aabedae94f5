"""Flop and byte accounting and roofline reporting (stdlib and torch).

Counterpart: ``regent_fft_tpu/utils/flopcount.py``: FFTW's ``api/flops.c``
and the libbench2 convention (``libbench2/mflops.c``): benchmarks report
5 N log2 N / time (2.5 for real transforms) whatever the algorithm's flop
count, so numbers compare across libraries.

The datasheet table holds one card, the NVIDIA H100 SXM (80 GB HBM3):
3350 GB/s of device memory, 67 TFLOP/s FP32 outside the tensor cores,
989 TFLOP/s bf16 dense, the rates at its full 700 W limit.  Any other
device, the CPU included, has no datasheet entry and gets no roofline
(None).  :func:`install_measured` (``utils/calibrate.py``) overlays
measured rates on what :func:`detect_hardware` reports, for the cost
model; a roofline fraction is priced on :func:`datasheet` alone, so a
calibration never moves it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """A card's peak rates, for roofline fractions."""

    name: str
    hbm_gbps: float          # device-memory bandwidth, GB/s
    f32_tflops: float        # FP32 peak outside the tensor cores
    bf16_tflops: float       # bf16 dense tensor-core peak


H100 = HardwareModel("h100-sxm", hbm_gbps=3350.0, f32_tflops=67.0,
                     bf16_tflops=989.0)

# Name fragments of cards with other rates that also read "H100".
_NOT_SXM = ("pcie", "nvl")

# Rates measured by utils.calibrate, and the device name they were taken
# on: (kind, model).
_MEASURED: Optional[tuple] = None


def _device_kind(device=None) -> str:
    """Lower-case name of ``device`` (default: the current card, else the
    CPU): ``torch.cuda.get_device_name`` for a CUDA device, "cpu"."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    return torch.cuda.get_device_name(dev).lower()


def _detect_datasheet(kind: str) -> Optional[HardwareModel]:
    kind = kind.lower()
    if "h100" in kind and not any(t in kind for t in _NOT_SXM):
        return H100
    return None


def install_measured(name: str, hbm_gbps: float, f32_tflops: float) -> None:
    """Use measured rates for the device called ``name`` (its
    ``torch.cuda.get_device_name``, or "cpu").
    Counterpart: ``regent_fft_tpu/utils/flopcount.py:36``."""
    global _MEASURED
    base = _detect_datasheet(name)
    model = HardwareModel(
        name=f"{base.name if base else name.lower()} (measured)",
        hbm_gbps=hbm_gbps, f32_tflops=f32_tflops,
        bf16_tflops=base.bf16_tflops if base else f32_tflops)
    _MEASURED = (name.lower(), model)


def clear_measured() -> None:
    global _MEASURED
    _MEASURED = None


def datasheet(device=None) -> Optional[HardwareModel]:
    """The datasheet rates of ``device`` (default: the current card, else
    the CPU), None where the table has no entry: the peaks a roofline
    fraction is priced on."""
    return _detect_datasheet(_device_kind(device))


def detect_hardware(device=None) -> Optional[HardwareModel]:
    """The rates of ``device`` (default: the current card, else the CPU):
    measured ones where :func:`install_measured` has them for it, else its
    datasheet entry, else None.
    Counterpart: ``regent_fft_tpu/utils/flopcount.py:62``."""
    kind = _device_kind(device)
    if _MEASURED is not None and (device is None or _MEASURED[0] == kind):
        return _MEASURED[1]
    return _detect_datasheet(kind)


def mflops_convention(n: int, t_seconds: float, real: bool = False) -> float:
    """libbench2 mflops.c: 5 N log2(N) / t / 1e6 (half for real).
    Counterpart: ``regent_fft_tpu/utils/flopcount.py:70``."""
    if n <= 1 or t_seconds <= 0:
        return 0.0
    f = 5.0 * n * math.log2(n)
    if real:
        f *= 0.5
    return f / t_seconds / 1e6


def gflops_convention(n: int, t_seconds: float, real: bool = False) -> float:
    return mflops_convention(n, t_seconds, real) / 1e3


def roofline_time_s(bytes_moved: int, flops: float, hw: HardwareModel,
                    f32: bool = True) -> float:
    """Least wall time: the larger of the bytes over the memory rate and
    the flops over the peak.  Counterpart: ``flopcount.py:84``."""
    t_bw = bytes_moved / (hw.hbm_gbps * 1e9)
    peak = (hw.f32_tflops if f32 else hw.bf16_tflops) * 1e12
    return max(t_bw, flops / peak)


def roofline_fraction(bytes_moved: int, flops: float, t_seconds: float,
                      hw: Optional[HardwareModel] = None,
                      f32: bool = True) -> Optional[float]:
    """Bound time over measured time (1.0 = the bound); None where ``hw``
    is None (no rates for the device).  Counterpart: ``flopcount.py:94``
    (whose ``hw`` defaults to the detected chip; here the caller passes
    its device's model)."""
    if hw is None:
        return None
    if t_seconds <= 0:
        return 0.0
    return roofline_time_s(bytes_moved, flops, hw, f32) / t_seconds
