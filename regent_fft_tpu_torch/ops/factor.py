"""Size factorization: the static planner core (numpy-free, stdlib only).

The port's own copy of ``regent_fft_tpu/ops/factor.py``.  Only the
"estimate" schedule and the matmul-form kernels' ``pallas_schedule`` are
carried; the calibrated native cost model (``planner="model"``) is
ROADMAP Queue 1 #11.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

# Largest size implemented as one direct O(N^2) DFT contraction.
DEFAULT_MAX_RADIX = 128

# Largest power-of-two length the butterfly kernels accept
# (ops/stockham_kernels.py MAX_LAST_N); drives the rader-vs-bluestein choice.
KERNEL_POW2_MAX = 2048


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def prime_factors(n: int) -> List[int]:
    """Prime factorization, smallest first.

    Counterpart: ``regent_fft_tpu/ops/factor.py:35``.
    """
    if n < 1:
        raise ValueError(f"n must be positive, got {n}")
    out = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        out.append(n)
    return out


def is_smooth(n: int, max_prime: int = DEFAULT_MAX_RADIX) -> bool:
    """True if all prime factors of n are <= max_prime.

    Counterpart: ``regent_fft_tpu/ops/factor.py:51``.
    """
    return all(p <= max_prime for p in prime_factors(n))


@functools.lru_cache(maxsize=4096)
def factorize(n: int, max_radix: int = DEFAULT_MAX_RADIX
              ) -> Optional[Tuple[int, ...]]:
    """Factor ``n`` into radices <= max_radix, largest first (None if a
    prime factor exceeds max_radix).

    Counterpart: ``regent_fft_tpu/ops/factor.py:57``.
    """
    if n < 1:
        raise ValueError(f"n must be positive, got {n}")
    if n == 1:
        return (1,)
    primes = prime_factors(n)
    if primes[-1] > max_radix:
        return None
    primes.sort(reverse=True)
    factors: List[int] = []
    cur = 1
    for p in primes:
        if cur * p <= max_radix:
            cur *= p
        else:
            factors.append(cur)
            cur = p
    factors.append(cur)
    factors.sort(reverse=True)
    return tuple(factors)


@functools.lru_cache(maxsize=4096)
def next_fast_len(n: int, max_radix: int = DEFAULT_MAX_RADIX) -> int:
    """Smallest smooth size >= n (5-, 3- or 2-smooth per the radix cap).

    Counterpart: ``regent_fft_tpu/ops/factor.py:89``.
    """
    if max_radix < 2:
        raise ValueError(f"max_radix must be >= 2, got {max_radix}")
    if n <= 2:
        return max(n, 1)
    best = 1 << (n - 1).bit_length()
    max_p5 = best if max_radix >= 5 else 1
    max_p3 = best if max_radix >= 3 else 1
    p5 = 1
    while p5 <= max_p5 and p5 < best:
        p35 = p5
        while p35 <= max_p3 * p5 and p35 < best:
            q = -(-n // p35)
            p2 = 1 << max(0, (q - 1).bit_length())
            cand = p35 * p2
            if n <= cand < best:
                best = cand
            if max_p3 == 1:
                break
            p35 *= 3
        if max_p5 == 1:
            break
        p5 *= 5
    return best


@functools.lru_cache(maxsize=4096)
def prev_fast_len(n: int, max_radix: int = DEFAULT_MAX_RADIX) -> int:
    """Largest smooth size <= n (scipy.fft.prev_fast_len analog), by the
    smoothness of :func:`next_fast_len`.

    Counterpart: ``regent_fft_tpu/ops/factor.py:123``.
    """
    if n < 1:
        raise ValueError(f"n must be positive, got {n}")
    cap = 5 if max_radix >= 5 else (3 if max_radix >= 3 else 2)
    m = n
    while m > 1 and not is_smooth(m, cap):
        m -= 1
    return m


def stage_flops(n: int, factors: Tuple[int, ...]) -> int:
    """Real-FLOP count of the matmul-form mixed-radix schedule.

    Counterpart: ``regent_fft_tpu/ops/factor.py:141``.
    """
    fl = 0
    for i, r in enumerate(factors):
        fl += 8 * n * r
        if i + 1 < len(factors):
            fl += 6 * n
    return fl


def fft_flops_convention(n: int, real: bool = False) -> float:
    """The reporting convention: 5 N log2 N (2.5 for real transforms).

    Counterpart: ``regent_fft_tpu/ops/factor.py:156``.
    """
    if n <= 1:
        return 0.0
    base = 5.0 * n * math.log2(n)
    return base / 2 if real else base


# Smallest radix of a matmul-form kernel schedule (``pallas_schedule``).
MIN_PALLAS_RADIX = 16


@functools.lru_cache(maxsize=4096)
def pallas_schedule(n: int, max_radix: int = DEFAULT_MAX_RADIX,
                    min_radix: int = MIN_PALLAS_RADIX):
    """Factorization with every factor in [min_radix, max_radix], or None.

    A single direct DFT (n <= max_radix) is always allowed.  Otherwise the
    fewest stages win, then the smallest sum of radices (fewest flops).
    The matmul-form kernels (``ops/pallas_fft.py``) take one or two stages.
    Counterpart: ``regent_fft_tpu/ops/factor.py:172``.
    """
    if n < 2:
        return None
    if n <= max_radix:
        return (n,)

    best = None

    def rec(m, partial):
        nonlocal best
        if best is not None and len(partial) >= len(best):
            return
        for f in range(min(max_radix, m), min_radix - 1, -1):
            if m % f:
                continue
            rest = m // f
            if rest == 1:
                cand = tuple(sorted(partial + [f], reverse=True))
                if (best is None or len(cand) < len(best)
                        or (len(cand) == len(best) and sum(cand) < sum(best))):
                    best = cand
            elif rest >= min_radix:
                rec(rest, partial + [f])

    rec(n, [])
    return best


# Schedule overrides: (n, max_radix) -> factors.  The port has no
# measure-mode autotuner yet, so only set_schedule_override fills it.
_SCHEDULE_OVERRIDES: dict = {}


def set_schedule_override(n: int, factors, max_radix: int = DEFAULT_MAX_RADIX):
    """Pin the radix schedule for a size.

    Counterpart: ``regent_fft_tpu/ops/factor.py:217``.
    """
    factors = tuple(int(f) for f in factors)
    prod = 1
    for f in factors:
        prod *= f
        if f > max_radix:
            raise ValueError(f"factor {f} > max_radix {max_radix}")
    if prod != n:
        raise ValueError(f"product of {factors} != {n}")
    _SCHEDULE_OVERRIDES[(n, max_radix)] = factors


def schedule(n: int, max_radix: int = DEFAULT_MAX_RADIX):
    """Radix schedule for a smooth size (None if not smooth); overrides win.

    Counterpart: ``regent_fft_tpu/ops/factor.py:230`` in "estimate" mode.
    """
    ov = _SCHEDULE_OVERRIDES.get((n, max_radix))
    if ov is not None:
        return ov
    return factorize(n, max_radix)


def plan_factors(n: int, max_radix: int = DEFAULT_MAX_RADIX):
    """('direct'|'mixed'|'rader'|'bluestein', info) for a length.

    Counterpart: ``regent_fft_tpu/ops/factor.py:256``.
    """
    if n <= max_radix and (n, max_radix) not in _SCHEDULE_OVERRIDES:
        return ("direct", n)
    factors = schedule(n, max_radix)
    if factors is not None:
        if len(factors) == 1:
            return ("direct", n)
        return ("mixed", factors)
    m = bluestein_pad(n, max_radix)
    if len(prime_factors(n)) == 1 and is_smooth(n - 1, max_radix):
        rader_kernel = _is_pow2(n - 1) and n - 1 <= KERNEL_POW2_MAX
        bluestein_kernel = _is_pow2(m) and m <= KERNEL_POW2_MAX
        if rader_kernel or not bluestein_kernel:
            return ("rader", n - 1)
    return ("bluestein", m)


def bluestein_pad(n: int, max_radix: int = DEFAULT_MAX_RADIX) -> int:
    """Padded inner size for a Bluestein transform of length n.

    Counterpart: ``regent_fft_tpu/ops/factor.py:291``.
    """
    m = next_fast_len(2 * n - 1, max_radix)
    m2 = 1 << (2 * n - 2).bit_length()
    return m2 if m2 <= 1.2 * m else m
