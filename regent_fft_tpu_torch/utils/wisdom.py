"""Wisdom: the planner's knowledge as JSON.

Counterpart: ``regent_fft_tpu/utils/wisdom.py`` (FFTW's wisdom import and
export, ``api/export-wisdom*.c``, ``import-wisdom*.c``): the plan specs
worth making again, the schedule overrides of measure mode, the backend,
patient and exhaustive winners and the calibration, under the JAX
package's keys and ``WISDOM_VERSION``.  Three differences:

* the ``"library"`` tag is ``"regent_fft_tpu_torch"``, and an import of
  another library's wisdom raises ``ValueError``: a TPU's winners name
  routes that are other kernels here (:func:`autoload_system_wisdom`
  skips such a file);
* the default file is ``~/.regent_fft_tpu_torch.wisdom.json``;
* a schedule entry carries the ``"device"`` type it was measured on, as
  the winner tables' specs do: a CPU race never steers a CUDA plan.

``REGENT_FFT_WISDOM`` (another file) and ``REGENT_FFT_NO_WISDOM`` (no
autoload) are read as the JAX package reads them.  The distributed
strategies' table (``"distrib"``) is exported empty and not read: the
port's distributed plans are still to come.
"""
from __future__ import annotations

import dataclasses
import json
import os

from ..dtypes import Direction, Kind, Norm
from ..plan import PlanSpec, make_plan, _PLAN_CACHE

WISDOM_VERSION = 1
LIBRARY = "regent_fft_tpu_torch"


def _spec_to_dict(spec: PlanSpec) -> dict:
    d = dataclasses.asdict(spec)
    d["kind"] = spec.kind.value
    d["direction"] = int(spec.direction)
    d["norm"] = spec.norm.value
    return d


def _spec_from_dict(d: dict) -> PlanSpec:
    d = dict(d)
    d["kind"] = Kind(d["kind"])
    d["direction"] = Direction(d["direction"])
    d["norm"] = Norm(d["norm"])
    d["shape"] = tuple(d["shape"])
    d["axes"] = tuple(d["axes"])
    return PlanSpec(**d)


def _tables():
    from .. import plan as _plan
    return {"backends": _plan._BACKEND_WISDOM,
            "patient": _plan._PATIENT_WISDOM,
            "exhaustive": _plan._EXHAUSTIVE_WISDOM}


def export_wisdom_to_string() -> str:
    """The cached plans' specs, the schedule overrides, the measured
    winners and the calibration as JSON.
    Counterpart: ``regent_fft_tpu/utils/wisdom.py:46``."""
    from ..ops import factor as _factor
    from . import calibrate as _calibrate
    out = {"version": WISDOM_VERSION, "library": LIBRARY,
           "plans": [_spec_to_dict(s) for s, _ in _PLAN_CACHE],
           "schedules": [{"n": n, "max_radix": mr, "factors": list(f),
                          "device": d}
                         for (d, n, mr), f in
                         _factor._SCHEDULE_OVERRIDES.items()]}
    for key, table in _tables().items():
        out[key] = [{"spec": _spec_to_dict(k), "winner": w if key == "backends"
                     else dict(w)} for k, w in table.items()]
    out["distrib"] = []
    cal = _calibrate.current()
    if cal is not None:
        out["calibration"] = cal.to_dict()
    return json.dumps(out, indent=2)


def export_wisdom_to_filename(path: str) -> None:
    with open(path, "w") as f:
        f.write(export_wisdom_to_string())


def import_wisdom_from_string(s: str, build: bool = True) -> int:
    """Install the wisdom of ``s`` and, with ``build``, make its plans;
    returns the number of entries.  Raises ``ValueError`` for another
    version or another library's wisdom.
    Counterpart: ``regent_fft_tpu/utils/wisdom.py:83``."""
    data = json.loads(s)
    if data.get("version") != WISDOM_VERSION:
        raise ValueError(f"unsupported wisdom version: {data.get('version')}")
    if data.get("library") != LIBRARY:
        raise ValueError(
            f"wisdom of {data.get('library')!r}, not {LIBRARY!r}: its winners "
            f"name routes of another library's kernels")
    from ..ops import factor as _factor
    from ..plan import _backend_key
    from . import calibrate as _calibrate
    n = 0
    cal = data.get("calibration")
    if cal is not None:
        _calibrate.install_calibration(_calibrate.Calibration.from_dict(cal))
        n += 1
    for o in data.get("schedules", []):
        _factor.set_schedule_override(o["n"], tuple(o["factors"]),
                                      o.get("max_radix", 128), o["device"])
        n += 1
    for key, table in _tables().items():
        for o in data.get(key, []):
            w = o["winner"]
            table[_backend_key(_spec_from_dict(o["spec"]))] = (
                w if key == "backends" else dict(w))
            n += 1
    for d in data.get("plans", []):
        if build:
            make_plan(_spec_from_dict(d))
        n += 1
    return n


def import_wisdom_from_filename(path: str, build: bool = True) -> int:
    with open(path) as f:
        return import_wisdom_from_string(f.read(), build=build)


def forget_wisdom() -> None:
    """fftw_forget_wisdom analog: drop the plan cache, the schedule
    overrides, every winner table and the calibration.
    Counterpart: ``regent_fft_tpu/utils/wisdom.py:143``."""
    from ..ops import factor as _factor
    from ..ops import stockham as _stockham
    from . import calibrate as _calibrate
    _PLAN_CACHE.clear()
    _factor._SCHEDULE_OVERRIDES.clear()
    _stockham.schedule_description.cache_clear()
    for table in _tables().values():
        table.clear()
    _calibrate.reset_calibration()


def default_wisdom_path() -> str:
    return os.environ.get(
        "REGENT_FFT_WISDOM",
        os.path.expanduser("~/.regent_fft_tpu_torch.wisdom.json"))


def autoload_system_wisdom() -> int:
    """Import the wisdom file (:func:`default_wisdom_path`) without
    making its plans, at the package's import: FFTW's system wisdom
    (``api/import-system-wisdom.c``).  Nothing when the file is missing,
    unreadable or another library's, or under ``REGENT_FFT_NO_WISDOM``.
    Counterpart: ``regent_fft_tpu/utils/wisdom.py:231``."""
    if os.environ.get("REGENT_FFT_NO_WISDOM"):
        return 0
    path = default_wisdom_path()
    if not os.path.exists(path):
        return 0
    try:
        return import_wisdom_from_filename(path, build=False)
    except (OSError, ValueError, KeyError, TypeError):
        return 0  # corrupt, stale or foreign wisdom must never break import
