"""Real-to-real transforms: FFTW's r2r layer (DCT/DST/DHT/halfcomplex).

Counterpart: ``regent_fft_tpu/ops/r2r.py``.  FFTW's public API plans
eleven r2r kinds (``fftw-3.3.8/api/fftw3.h`` kind enum); every kind
reduces to one length-L complex FFT with O(n) passes around it:

* ``R2HC`` / ``HC2R`` -- halfcomplex packing of the real DFT
  (``[r0 .. r_{n/2}, i_{ceil(n/2)-1} .. i_1]``), L = n;
* ``DHT`` -- ``Re(F) - Im(F)``, L = n;
* ``REDFT10``/``REDFT01`` (DCT-II/III) -- Makhoul's even/odd reorder and
  quarter-wave twiddle, and its inverse, L = n;
* ``REDFT00``/``RODFT00`` (DCT-I/DST-I) -- symmetric extensions, L =
  2(n-1) / 2(n+1);
* ``REDFT11`` (DCT-IV) -- a half-shifted transform, L = 2n;
  ``RODFT10``/``RODFT01``/``RODFT11`` (DST-II/III/IV) by the
  sign-alternation identities onto their DCT.

All kinds are unnormalized with FFTW's conventions (scipy.fft types 1-4
with ``norm=None`` agree).  The length-L core is the plan device's
choice (:func:`_fft_pair`): ``fft_last`` on a CUDA device with f32 planes
where it takes L (a power of two, 64..``MAX_LAST_N``), else the dense
pipeline ``stockham.build_c2c_1d``.  The cos/sin/chirp/sign tables are
made in float64 numpy with the JAX package's expressions and go to the
device once, when a function is built.

An :class:`R2RPlan` computes in the input's precision: float32 input in
f32 (the kernel where it takes L), float64 input in f64 on the dense
pipeline (the JAX package with x64 on; FFTW's r2r is double).
"""
from __future__ import annotations

import math
from enum import IntEnum

import numpy as np
import torch

from ..dtypes import Direction
from . import bluestein as _bluestein
from . import factor as _factor
from .stockham import build_c2c_1d


class R2RKind(IntEnum):
    """FFTW r2r kinds, with FFTW's enum values (``api/fftw3.h``).
    Counterpart: ``regent_fft_tpu/ops/r2r.py:44``."""
    R2HC = 0
    HC2R = 1
    DHT = 2
    REDFT00 = 3   # DCT-I
    REDFT01 = 4   # DCT-III
    REDFT10 = 5   # DCT-II
    REDFT11 = 6   # DCT-IV
    RODFT00 = 7   # DST-I
    RODFT01 = 8   # DST-III
    RODFT10 = 9   # DST-II
    RODFT11 = 10  # DST-IV


_DCT_TYPES = {1: R2RKind.REDFT00, 2: R2RKind.REDFT10,
              3: R2RKind.REDFT01, 4: R2RKind.REDFT11}
_DST_TYPES = {1: R2RKind.RODFT00, 2: R2RKind.RODFT10,
              3: R2RKind.RODFT01, 4: R2RKind.RODFT11}
_PRECISIONS = ("highest", "high", "default")


def logical_size(n: int, kind: R2RKind) -> int:
    """FFTW's logical transform size (``fftw-3.3.8/api/plan-r2r.c``): 2(n-1)
    for REDFT00, 2(n+1) for RODFT00, 2n for the other trig kinds, n for
    R2HC/HC2R/DHT.  Counterpart: ``regent_fft_tpu/ops/r2r.py:65``."""
    k = R2RKind(kind)
    if k == R2RKind.REDFT00:
        return 2 * (n - 1)
    if k == R2RKind.RODFT00:
        return 2 * (n + 1)
    if k in (R2RKind.R2HC, R2RKind.HC2R, R2RKind.DHT):
        return n
    return 2 * n


def core_length(n: int, kind: R2RKind) -> int:
    """The length L of the complex FFT a kind reduces to (the length the
    kernel sees): 2(n-1) for DCT-I, 2(n+1) for DST-I, 2n for DCT-IV and
    DST-IV, n otherwise."""
    k = R2RKind(kind)
    if k in (R2RKind.REDFT00, R2RKind.RODFT00, R2RKind.REDFT11,
             R2RKind.RODFT11):
        return logical_size(n, k)
    return n


def _alt_signs(n: int) -> np.ndarray:
    """f64 host table (-1)^j.  Counterpart: ``regent_fft_tpu/ops/r2r.py:79``."""
    return (-1.0) ** np.arange(n)


def _unreorder_perm(n: int) -> np.ndarray:
    """Static permutation p with x = v[:, p] inverting
    :func:`_reorder_even_odd`.  Counterpart: ``regent_fft_tpu/ops/r2r.py:113``."""
    r = np.concatenate([np.arange(0, n, 2), np.arange(1, n, 2)[::-1]])
    p = np.empty(n, dtype=np.int32)
    p[r] = np.arange(n, dtype=np.int32)
    return p


def _reorder_even_odd(x2: torch.Tensor) -> torch.Tensor:
    """(B, n) -> Makhoul's v = [x[0::2], reversed(x[1::2])], contiguous.
    Counterpart: ``regent_fft_tpu/ops/r2r.py:107``."""
    return torch.cat([x2[:, 0::2], x2[:, 1::2].flip(1)], 1)


def host_tables(n: int, kind) -> dict:
    """The float64 (and index) host tables of one kind at length n, made
    with the JAX package's expressions in its float order
    (``regent_fft_tpu/ops/r2r.py:153-242``); the DST kinds use their DCT
    base's and the sign table ``alt``."""
    kind = R2RKind(kind)
    k = np.arange(n)
    if kind == R2RKind.HC2R:
        re_idx = np.minimum(k, n - k) % n
        head = (k >= 1) & (k < (n + 1) // 2)
        tail = k > n // 2
        im_idx = np.where(head, (n - k) % n, np.where(tail, k, 0))
        im_sign = head.astype(np.float64) - tail.astype(np.float64)
        return {"re_idx": re_idx, "im_idx": im_idx, "im_sign": im_sign}
    if kind == R2RKind.REDFT10:
        th = np.pi * np.arange(n) / (2.0 * n)
        return {"c2": 2.0 * np.cos(th), "s2": 2.0 * np.sin(th)}
    if kind == R2RKind.REDFT01:
        th = np.pi * k / (2.0 * n)
        cr = np.cos(th)
        sr = np.sin(th)
        cr[0] = 1.0
        sr[0] = 0.0
        return {"cr": cr, "sr": sr, "flip_idx": (n - k) % n,
                "not_first": (k != 0).astype(np.float64),
                "perm": _unreorder_perm(n)}
    if kind == R2RKind.REDFT11:
        j = np.arange(n)
        pre = np.exp(-1j * np.pi * j / (2.0 * n))
        post = 2.0 * np.exp(-1j * np.pi * (2 * j + 1) / (4.0 * n))
        return {"pre_re": pre.real, "pre_im": pre.imag,
                "post_re": post.real, "post_im": post.imag}
    if kind in (R2RKind.RODFT10, R2RKind.RODFT01, R2RKind.RODFT11):
        return {"alt": _alt_signs(n)}
    return {}


def _upload(tables: dict, device, dtype) -> dict:
    """A kind's host tables on ``device`` (the host when None): floats at
    the planes' dtype, indices as int64."""
    device = torch.device("cpu" if device is None else device)
    return {name: (torch.from_numpy(np.ascontiguousarray(t)).to(
        device=device,
        dtype=torch.int64 if name.endswith(("idx", "perm")) else dtype))
        for name, t in tables.items()}


def _fft_pair(L: int, direction: Direction, max_radix: int, use_3m: bool,
              device, dtype, kernel_pair):
    """(fn, kernel) for the (B, L) split-complex FFT of a reduction.

    ``kernel_pair(L)`` gives the last-axis kernel's (forward, backward)
    pair or None; f32 planes take it where it is given, everything else
    the dense pipeline.  Counterpart: ``regent_fft_tpu/ops/r2r.py:91``,
    gated there on the TPU backend and ``REGENT_FFT_R2R_KERNEL``, which
    the port does not read.
    """
    if dtype == torch.float32 and kernel_pair is not None:
        pair = kernel_pair(L)
        if pair is not None:
            return pair[0 if direction == Direction.FORWARD else 1], True
    return build_c2c_1d(L, direction, max_radix, use_3m, device, dtype), False


def build_r2r_1d(n: int, kind, max_radix: int = _factor.DEFAULT_MAX_RADIX,
                 use_3m: bool = False, device=None,
                 dtype: torch.dtype = torch.float32, kernel_pair=None):
    """Build fn((B, n) real) -> (B, n) real for one FFTW r2r kind, on
    planes of ``dtype`` (f32 or f64).

    Unnormalized FFTW semantics.  ``kernel_pair`` maps the core length L to
    the kernel's (forward, backward) pair or None; by default it is the
    device's (``fft_last`` on CUDA where it takes L, its tables for both
    signs fetched now).  Tests pass ``bluestein.kernel_pair`` to run the
    kernel route through ``fft_last_plain`` on the host.  The tables go to
    ``device`` (the host when None) now, at ``dtype``; the function takes
    planes on that device and of that dtype.  The function's
    ``kernel_len`` is L when its core is the kernel, else None; it calls
    its core once per call.
    Counterpart: ``regent_fft_tpu/ops/r2r.py:121``.
    """
    kind = R2RKind(kind)
    if n < 1:
        raise ValueError(f"r2r needs n >= 1, got {n}")
    if kind == R2RKind.REDFT00 and n < 2:
        raise ValueError("REDFT00 (DCT-I) needs n >= 2")
    if kernel_pair is None and device is not None:
        def kernel_pair(L):
            return _bluestein._inner_kernel_pair(L, device)
    h = n // 2 + 1
    L = core_length(n, kind)

    def pair(direction):
        return _fft_pair(L, direction, max_radix, use_3m, device, dtype,
                         kernel_pair)

    def made(fn, kernel):
        # rows of a moved axis can be a strided view, and elementwise ops
        # keep their strides: the kernel takes contiguous planes
        def run(x2):
            return fn(x2.contiguous())
        run.kernel_len = L if kernel else None
        return run

    if kind in (R2RKind.RODFT10, R2RKind.RODFT01, R2RKind.RODFT11):
        # DST kinds II/III/IV via the sign-alternation DCT identities:
        # dst2(x) = rev(dct2(alt*x)), dst3(x) = alt * dct3(rev(x)),
        # dst4(x) = rev(dct4(alt*x)).
        base_kind = {R2RKind.RODFT10: R2RKind.REDFT10,
                     R2RKind.RODFT01: R2RKind.REDFT01,
                     R2RKind.RODFT11: R2RKind.REDFT11}[kind]
        base = build_r2r_1d(n, base_kind, max_radix, use_3m, device, dtype,
                            kernel_pair)
        alt = _upload(host_tables(n, kind), device, dtype)["alt"]
        if kind == R2RKind.RODFT01:
            def fn(x2):
                return alt * base(x2.flip(1))
        else:
            def fn(x2):
                return base(x2 * alt).flip(1)
        return made(fn, base.kernel_len)

    t = _upload(host_tables(n, kind), device, dtype)

    if kind == R2RKind.R2HC:
        fwd, kern = pair(Direction.FORWARD)

        def fn(x2):
            yr, yi = fwd(x2, torch.zeros_like(x2))
            return torch.cat([yr[:, :h], yi[:, 1:(n + 1) // 2].flip(1)], 1)
        return made(fn, kern)

    if kind == R2RKind.HC2R:
        bwd, kern = pair(Direction.BACKWARD)
        # the full Hermitian spectrum from the halfcomplex vector by two
        # static gathers, then one backward C2C; imag(result) == 0 by
        # symmetry and is dropped

        def fn(x2):
            sr = x2.index_select(1, t["re_idx"])
            si = x2.index_select(1, t["im_idx"]) * t["im_sign"]
            yr, _ = bwd(sr, si)
            return yr
        return made(fn, kern)

    if kind == R2RKind.DHT:
        fwd, kern = pair(Direction.FORWARD)

        def fn(x2):        # cas kernel: H[k] = Re F[k] - Im F[k]
            yr, yi = fwd(x2, torch.zeros_like(x2))
            return yr - yi
        return made(fn, kern)

    if kind == R2RKind.REDFT10:  # DCT-II
        fwd, kern = pair(Direction.FORWARD)

        def fn(x2):
            v = _reorder_even_odd(x2)
            vr, vi = fwd(v, torch.zeros_like(v))
            return t["c2"] * vr + t["s2"] * vi
        return made(fn, kern)

    if kind == R2RKind.REDFT01:  # DCT-III = unnormalized inverse of DCT-II
        bwd, kern = pair(Direction.BACKWARD)
        # V[0] = u[0]/2; V[k] = (u[k] - i u[n-k]) e^{i pi k/2n} / 2;
        # y = unreorder(Re(backward_fft(V)) * 2), the 1/2 and the *2 folded

        def fn(x2):
            cw, sw, nf = t["cr"], t["sr"], t["not_first"]
            u_rev = x2.index_select(1, t["flip_idx"]) * nf  # u[n-0] := 0
            vr = x2 * cw + u_rev * sw
            vi = (x2 * sw - u_rev * cw) * nf                # V[0] = u[0]
            yr, _ = bwd(vr, vi)
            return yr.index_select(1, t["perm"])
        return made(fn, kern)

    if kind == R2RKind.REDFT00:  # DCT-I over 2(n-1) points
        fwd, kern = pair(Direction.FORWARD)

        def fn(x2):
            v = torch.cat([x2, x2[:, 1:n - 1].flip(1)], 1)
            yr, _ = fwd(v, torch.zeros_like(v))
            return yr[:, :n]
        return made(fn, kern)

    if kind == R2RKind.RODFT00:  # DST-I over 2(n+1) points
        fwd, kern = pair(Direction.FORWARD)

        def fn(x2):
            z = x2.new_zeros((x2.shape[0], 1))
            v = torch.cat([z, x2, z, -x2.flip(1)], 1)
            _, yi = fwd(v, torch.zeros_like(v))
            return -yi[:, 1:n + 1]
        return made(fn, kern)

    # REDFT11: DCT-IV via the half-shifted 2n-point FFT
    fwd, kern = pair(Direction.FORWARD)

    def fn(x2):
        zpad = torch.zeros_like(x2)
        cr = torch.cat([x2 * t["pre_re"], zpad], 1)
        ci = torch.cat([x2 * t["pre_im"], zpad], 1)
        gr, gi = fwd(cr, ci)
        return t["post_re"] * gr[:, :n] - t["post_im"] * gi[:, :n]
    return made(fn, kern)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x)


class R2RPlan:
    """Plan for an N-D real-to-real transform, one FFTW kind per axis, on
    one device (``fftw_plan_r2r`` analog, ``fftw-3.3.8/api/plan-r2r.c``).

    Callable on real tensors or arrays of the planned shape, float32 (f32
    compute) or float64 (f64, the dense pipeline); returns a tensor of the
    input's dtype on the plan's device.  ``routes`` gives each transformed
    axis's f32 core: ``(axis, kind, L, "kernel" | "dense")``.
    ``precision_name`` is checked as the port's plans check it; as there
    (``plan.py``), every tier computes as ``"highest"``.
    Counterpart: ``regent_fft_tpu/ops/r2r.py:272``.
    """

    def __init__(self, shape, kinds, axes, max_radix: int,
                 precision_name: str, device="cuda"):
        from ..plan import resolve_device
        if precision_name not in _PRECISIONS:
            raise ValueError(f"precision must be one of {list(_PRECISIONS)}")
        self.shape = tuple(int(s) for s in shape)
        self.axes = tuple(axes)
        self.kinds = tuple(R2RKind(k) for k in kinds)
        self.max_radix = int(max_radix)
        self.device = resolve_device(device)
        self._fns = {}
        f32 = self._fns_for(torch.float32)
        self.routes = tuple(
            (a, k.name, core_length(self.shape[a], k),
             "kernel" if fn.kernel_len else "dense")
            for (a, fn), k in zip(f32, self.kinds))
        # flops by the libbench2 real-transform convention over logical
        # sizes (2.5 N log2 N, ``libbench2/mflops.c:26-27``)
        self.flops = 0.0
        for a, k in zip(self.axes, self.kinds):
            nl = logical_size(self.shape[a], k)
            self.flops += (2.5 * np.prod(self.shape) / self.shape[a]
                           * nl * max(1.0, math.log2(max(nl, 2))))
        self._destroyed = False
        self._key = None
        desc_kinds = ",".join(k.name for k in self.kinds)
        self.description = (f"(plan-r2r shape={self.shape} axes={self.axes} "
                            f"kinds=[{desc_kinds}] unnormalized)")

    def _fns_for(self, dtype):
        fns = self._fns.get(dtype)
        if fns is None:
            fns = [(a, build_r2r_1d(self.shape[a], k, self.max_radix,
                                    device=self.device, dtype=dtype))
                   for a, k in zip(self.axes, self.kinds)]
            self._fns[dtype] = fns
        return fns

    def _core(self, x: torch.Tensor) -> torch.Tensor:
        """Run the axes on a tensor of the planned shape already on the
        plan's device (f32 or f64)."""
        ndim = x.ndim
        for a, fn in self._fns_for(x.dtype):
            ax = a % ndim
            moved = x.movedim(ax, -1) if ax != ndim - 1 else x
            lead = moved.shape[:-1]
            y2 = fn(moved.reshape(-1, moved.shape[-1]))
            y = y2.reshape(*lead, y2.shape[-1])
            x = y.movedim(-1, ax) if ax != ndim - 1 else y
        return x.contiguous()

    def __call__(self, x):
        """Execute on a real tensor or array: float32 computes in f32,
        float64 in f64.  Counterpart: ``regent_fft_tpu/ops/r2r.py:314``."""
        if self._destroyed:
            raise RuntimeError("plan was destroyed")
        x = _as_tensor(x)
        if x.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"r2r plans take real input, got {x.dtype}")
        if tuple(x.shape) != self.shape:
            raise ValueError(f"input shape {tuple(x.shape)} != planned "
                             f"{self.shape}")
        return self._core(x.to(self.device).contiguous())

    execute = __call__

    def print_plan(self):
        print(self.description)

    def destroy(self):
        """Mark the plan unusable and evict it from the plan cache."""
        self._destroyed = True
        self._fns = {}
        if _R2R_CACHE.get(self._key) is self:
            del _R2R_CACHE[self._key]


# Plan cache: one-shot helpers (r2r/dct/dst/dht) reuse plans and their
# uploaded tables; ``destroy()`` evicts.
# Counterpart: ``regent_fft_tpu/ops/r2r.py:341``.
_R2R_CACHE: dict = {}


def plan_r2r(shape, kinds, axes=None, max_radix: int = _factor.DEFAULT_MAX_RADIX,
             precision: str = "highest", device="cuda") -> R2RPlan:
    """Plan an N-D r2r transform (``fftw_plan_r2r`` analog).

    ``kinds``: one :class:`R2RKind` (applied to every transformed axis) or
    one per axis.  ``axes`` defaults to all axes.  Plans are cached per
    (shape, kinds, axes, max_radix, precision, device).
    Counterpart: ``regent_fft_tpu/ops/r2r.py:344``.
    """
    from ..plan import resolve_device
    shape = tuple(int(s) for s in shape)
    if axes is None:
        axes = tuple(range(len(shape)))
    axes = tuple(a % len(shape) for a in axes)
    if isinstance(kinds, (int, R2RKind)):
        kinds = (R2RKind(kinds),) * len(axes)
    kinds = tuple(R2RKind(k) for k in kinds)
    if len(kinds) != len(axes):
        raise ValueError(f"{len(kinds)} kinds for {len(axes)} axes")
    dev = resolve_device(device)
    key = (shape, kinds, axes, int(max_radix), precision, str(dev))
    hit = _R2R_CACHE.get(key)
    if hit is not None and not hit._destroyed:
        return hit
    plan = R2RPlan(shape, kinds, axes, max_radix, precision, dev)
    plan._key = key
    _R2R_CACHE[key] = plan
    return plan


def r2r(x, kind, axis: int = -1, device="cuda"):
    """One-shot 1-D r2r transform along ``axis`` (unnormalized FFTW
    semantics); plans are cached across calls.
    Counterpart: ``regent_fft_tpu/ops/r2r.py:371``."""
    x = _as_tensor(x)
    plan = plan_r2r(tuple(x.shape), (R2RKind(kind),), axes=(axis,),
                    device=device)
    return plan(x)


# ---------------------------------------------------------------------------
# scipy.fft-parity one-shots (``n``/``s`` crop or zero-pad, ``norm``,
# ``orthogonalize``); the kinds stay FFTW-unnormalized, the rest is
# diagonal pre/post scaling, so the N-D forms run as ONE multi-axis plan.
# Counterpart: regent_fft_tpu/ops/r2r.py:379-563.
# ---------------------------------------------------------------------------
_INV_TYPE = {1: 1, 2: 3, 3: 2, 4: 4}
_SQRT2 = math.sqrt(2.0)
# scipy's orthogonalize endpoint adjustments, per executed (family, type):
# *sqrt(2) on input (PRE) / /sqrt(2) on output (POST).
_ORTHO_PRE = {("dct", 1): (0, -1), ("dct", 3): (0,), ("dst", 3): (-1,)}
_ORTHO_POST = {("dct", 1): (0, -1), ("dct", 2): (0,), ("dst", 2): (-1,)}


def _resize_axis(x: torch.Tensor, n, axis: int) -> torch.Tensor:
    """Crop or zero-pad ``x`` along ``axis`` to length ``n``.
    Counterpart: ``regent_fft_tpu/ops/r2r.py:402``."""
    n = int(n)
    if n < 1:
        raise ValueError(f"invalid number of data points ({n}) specified")
    cur = x.shape[axis]
    if n == cur:
        return x
    if n < cur:
        return x.narrow(axis, 0, n)
    shape = list(x.shape)
    shape[axis] = n - cur
    return torch.cat([x, x.new_zeros(shape)], axis)


def _entry_scaled(x: torch.Tensor, axis: int, idx: int,
                  factor: float) -> torch.Tensor:
    """A copy of ``x`` with the ``idx`` hyperplane along ``axis`` times
    ``factor``.  Counterpart: ``regent_fft_tpu/ops/r2r.py:418``."""
    y = x.clone()
    y.select(axis, idx % x.shape[axis]).mul_(factor)
    return y


def _norm_scale(norm, logical_n: int, inverse: bool) -> float:
    """Counterpart: ``regent_fft_tpu/ops/r2r.py:425``."""
    if norm in (None, "backward"):
        return 1.0 / logical_n if inverse else 1.0
    if norm == "ortho":
        return 1.0 / math.sqrt(logical_n)
    if norm == "forward":
        return 1.0 if inverse else 1.0 / logical_n
    raise ValueError(f"Invalid norm value {norm!r}; should be 'backward', "
                     "'ortho' or 'forward'")


def _scipy_r2r(x, family: str, typ: int, s, axes, norm, orthogonalize,
               inverse: bool, device):
    """Shared worker for the dct/dst/dctn/dstn one-shots.
    Counterpart: ``regent_fft_tpu/ops/r2r.py:436``."""
    from ..plan import resolve_device
    tables = _DCT_TYPES if family == "dct" else _DST_TYPES
    if typ not in tables:
        raise ValueError(f"{family.upper()} type must be 1-4, got {typ}")
    if norm not in (None, "backward", "ortho", "forward"):
        raise ValueError(f"Invalid norm value {norm!r}; should be "
                         "'backward', 'ortho' or 'forward'")
    if orthogonalize is None:
        orthogonalize = norm == "ortho"
    x = _as_tensor(x)
    if x.is_complex():
        raise TypeError(f"{family} transforms take real input, got {x.dtype}")
    if not x.is_floating_point():
        x = x.to(torch.float32)  # scipy promotes integer input
    x = x.to(resolve_device(device))
    if isinstance(axes, int):
        axes = (axes,)
    if s is not None and np.ndim(s) == 0:
        s = (int(s),)
    if s is not None and axes is None:
        axes = tuple(range(x.ndim - len(s), x.ndim))
    if axes is None:
        axes = tuple(range(x.ndim))
    axes = tuple(a % x.ndim for a in axes)
    if len(set(axes)) != len(axes):
        raise ValueError("all axes must be unique")
    if s is not None:
        if len(s) != len(axes):
            raise ValueError("when given, axes and shape arguments"
                             " have to be of the same length")
        for a, m in zip(axes, s):
            if m is not None and int(m) != -1:
                x = _resize_axis(x, m, a)

    exec_typ = _INV_TYPE[typ] if inverse else typ
    kind = tables[exec_typ]
    scale = 1.0
    for a in axes:
        scale *= _norm_scale(norm, logical_size(x.shape[a], kind), inverse)
    if orthogonalize:
        for a in axes:
            for i in _ORTHO_PRE.get((family, exec_typ), ()):
                x = _entry_scaled(x, a, i, _SQRT2)
    y = plan_r2r(tuple(x.shape), kind, axes=axes, device=x.device)(x)
    if orthogonalize:
        for a in axes:
            for i in _ORTHO_POST.get((family, exec_typ), ()):
                y = _entry_scaled(y, a, i, 1.0 / _SQRT2)
    if scale != 1.0:
        y = y * scale
    return y


def dct(x, type: int = 2, n=None, axis: int = -1, norm=None,
        overwrite_x=False, workers=None, orthogonalize=None, device="cuda"):
    """DCT types 1-4 with scipy.fft.dct semantics (``n`` crop/pad,
    ``norm``, ``orthogonalize``); compute follows the input dtype (f32, or
    f64 for float64 input).  ``overwrite_x``/``workers`` are accepted and
    ignored.  Counterpart: ``regent_fft_tpu/ops/r2r.py:490``."""
    return _scipy_r2r(x, "dct", type, None if n is None else (n,), (axis,),
                      norm, orthogonalize, False, device)


def idct(x, type: int = 2, n=None, axis: int = -1, norm=None,
         overwrite_x=False, workers=None, orthogonalize=None, device="cuda"):
    """Inverse DCT (scipy.fft.idct semantics).
    Counterpart: ``regent_fft_tpu/ops/r2r.py:501``."""
    return _scipy_r2r(x, "dct", type, None if n is None else (n,), (axis,),
                      norm, orthogonalize, True, device)


def dst(x, type: int = 2, n=None, axis: int = -1, norm=None,
        overwrite_x=False, workers=None, orthogonalize=None, device="cuda"):
    """DST types 1-4 with scipy.fft.dst semantics.
    Counterpart: ``regent_fft_tpu/ops/r2r.py:509``."""
    return _scipy_r2r(x, "dst", type, None if n is None else (n,), (axis,),
                      norm, orthogonalize, False, device)


def idst(x, type: int = 2, n=None, axis: int = -1, norm=None,
         overwrite_x=False, workers=None, orthogonalize=None, device="cuda"):
    """Inverse DST (scipy.fft.idst semantics).
    Counterpart: ``regent_fft_tpu/ops/r2r.py:516``."""
    return _scipy_r2r(x, "dst", type, None if n is None else (n,), (axis,),
                      norm, orthogonalize, True, device)


def dctn(x, type: int = 2, s=None, axes=None, norm=None, overwrite_x=False,
         workers=None, orthogonalize=None, device="cuda"):
    """N-D DCT over ``axes`` (scipy.fft.dctn semantics), one multi-axis
    r2r plan.  Counterpart: ``regent_fft_tpu/ops/r2r.py:523``."""
    return _scipy_r2r(x, "dct", type, s, axes, norm, orthogonalize, False,
                      device)


def idctn(x, type: int = 2, s=None, axes=None, norm=None, overwrite_x=False,
          workers=None, orthogonalize=None, device="cuda"):
    """N-D inverse DCT (scipy.fft.idctn).
    Counterpart: ``regent_fft_tpu/ops/r2r.py:531``."""
    return _scipy_r2r(x, "dct", type, s, axes, norm, orthogonalize, True,
                      device)


def dstn(x, type: int = 2, s=None, axes=None, norm=None, overwrite_x=False,
         workers=None, orthogonalize=None, device="cuda"):
    """N-D DST over ``axes`` (scipy.fft.dstn semantics).
    Counterpart: ``regent_fft_tpu/ops/r2r.py:538``."""
    return _scipy_r2r(x, "dst", type, s, axes, norm, orthogonalize, False,
                      device)


def idstn(x, type: int = 2, s=None, axes=None, norm=None, overwrite_x=False,
          workers=None, orthogonalize=None, device="cuda"):
    """N-D inverse DST (scipy.fft.idstn).
    Counterpart: ``regent_fft_tpu/ops/r2r.py:545``."""
    return _scipy_r2r(x, "dst", type, s, axes, norm, orthogonalize, True,
                      device)


def dht(x, axis: int = -1, device="cuda"):
    """Discrete Hartley transform (FFTW_DHT, unnormalized).
    Counterpart: ``regent_fft_tpu/ops/r2r.py:552``."""
    return r2r(x, R2RKind.DHT, axis, device)


def idht(x, axis: int = -1, device="cuda"):
    """Inverse DHT: the DHT divided by n, so idht(dht(x)) == x.
    Counterpart: ``regent_fft_tpu/ops/r2r.py:557``."""
    x = _as_tensor(x)
    n = x.shape[axis]
    return r2r(x, R2RKind.DHT, axis, device) / n
