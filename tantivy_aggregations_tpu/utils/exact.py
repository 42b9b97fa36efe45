"""Exact, order-independent aggregation arithmetic.

The reference (a sequential Rust collector, SURVEY.md §3.1) accumulates f64
sums in left-to-right doc order. A parallel device engine cannot (and should
not) chase that iteration order: its reductions run in whatever order the
compiled program picks. This module makes "bit-identical results"
achievable anyway by making every sum **exact**:

- Every addend (u64/i64/date value, or an f64 decomposed into
  sign * mantissa * 2^exp) is represented as a fixed-point integer and split
  into 26-bit limbs. Limbs are accumulated in int64 (exact integer
  arithmetic on any backend). 26-bit limbs guarantee no int64 overflow for up to 2^37
  addends — far beyond any index this engine addresses per shard group.
- Limb accumulators are order-independent (integer addition commutes), so
  per-segment execution, grid re-tiling, or cross-device psum all
  produce the same bits.
- The final limb sums are recombined on the host with Python big ints and
  correctly rounded to f64 (via Fraction -> float, which CPython rounds
  correctly). The result equals the true real-number sum rounded once —
  strictly more accurate than the reference's sequential f64 accumulation,
  and deterministic by construction.

Also here: exact histogram bucket boundaries for f64 fields (computed with
rationals on the host, compared in the int64 mono domain on device), so f64
bucketing is exact too. See SURVEY.md §A.5/§A.8.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np

from . import mono as mono_mod

LIMB_BITS = 26
LIMB_MASK = (1 << LIMB_BITS) - 1

# Max addend count for which 26-bit limbs cannot overflow int64 accumulators.
MAX_ADDENDS = 1 << (63 - LIMB_BITS - 1)  # 2**36, with 2x headroom


# ---------------------------------------------------------------------------
# f64 decomposition: value = (-1)^s * mant * 2^(e_eff - 1075)
# ---------------------------------------------------------------------------

def f64_decompose(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact IEEE-754 decomposition. Returns (sign, mant, e_eff):
    value == (-1)^sign * mant * 2^(e_eff - 1075), mant in [0, 2^53),
    e_eff in [1, 2046] (subnormals use e_eff=1 with no implicit bit)."""
    v = np.asarray(v, dtype=np.float64)
    bits = v.view(np.uint64)
    sign = (bits >> np.uint64(63)).astype(np.int64)
    e = ((bits >> np.uint64(52)) & np.uint64(0x7FF)).astype(np.int64)
    frac = (bits & np.uint64((1 << 52) - 1)).astype(np.int64)
    if (e == 0x7FF).any():
        raise ValueError("Inf/NaN not allowed in f64 fast fields")
    mant = np.where(e > 0, frac | np.int64(1 << 52), frac)
    e_eff = np.maximum(e, 1)
    return sign, mant, e_eff


def f64_limb_planes(v: np.ndarray, base_exp: int, n_limbs: int) -> np.ndarray:
    """Signed 26-bit limb planes for exact f64 summation.

    The fixed-point integer of v is I = (-1)^s * (mant << (e_eff - base_exp));
    limb_i holds bits [26i, 26i+26) of |I|, with the sign applied per limb so
    plain integer accumulation reconstructs the signed total. Returns an
    int32 array of shape v.shape + (n_limbs,).
    """
    sign, mant, e_eff = f64_decompose(v)
    # zeros (mant == 0) contribute nothing; their e_eff may sit below the
    # nonzero-derived base_exp, so pin their shift to 0
    shift = np.where(mant == 0, 0, e_eff - base_exp)
    if (shift < 0).any():
        raise ValueError("base_exp larger than some value's exponent")
    sgn = np.where(sign == 1, np.int64(-1), np.int64(1))
    um = mant.astype(np.uint64)
    out = np.empty(v.shape + (n_limbs,), dtype=np.int32)
    for i in range(n_limbs):
        # limb_i = ((mant << shift) >> 26i) & mask, without materializing the
        # (possibly > 64-bit) shifted integer: right-shift mant when the limb
        # sits at/above bit `shift`, left-shift (low 26 bits only) otherwise.
        # Shift counts are clipped to 63 to avoid UB; correctness holds since
        # mant < 2^53 (right shift >= 53 -> 0) and a left shift >= 26 leaves
        # zero low bits under the mask either way.
        rel = LIMB_BITS * i - shift
        right = np.clip(rel, 0, 63).astype(np.uint64)
        left = np.clip(-rel, 0, 63).astype(np.uint64)
        limb = np.where(rel >= 0, um >> right, um << left) & np.uint64(LIMB_MASK)
        out[..., i] = limb.astype(np.int64) * sgn
    return out


def f64_sum_plan(values: np.ndarray) -> Tuple[int, int]:
    """Choose (base_exp, n_limbs) so every value's fixed-point integer fits.
    Values with mant == 0 (zeros) are ignored for the exponent range."""
    sign, mant, e_eff = f64_decompose(values)
    nz = mant != 0
    if not nz.any():
        return 1, 1
    lo = int(e_eff[nz].min())
    hi = int(e_eff[nz].max())
    n_limbs = (hi - lo + 53 + LIMB_BITS - 1) // LIMB_BITS
    return lo, n_limbs


def f64_reconstruct_sum(limb_sums: np.ndarray, base_exp: int) -> float:
    """Exact recombination of int64 limb accumulators -> correctly rounded f64."""
    total = 0
    for i, s in enumerate(limb_sums.tolist()):
        total += int(s) << (LIMB_BITS * i)
    if total == 0:
        return 0.0
    return float(Fraction(total) * Fraction(2) ** (base_exp - 1075))


def f64_exact_sum_host(values: np.ndarray) -> float:
    """Host-side exact sum of f64 values (oracle path): Python big-int exact."""
    values = np.asarray(values, dtype=np.float64)
    if values.size == 0:
        return 0.0
    sign, mant, e_eff = f64_decompose(values)
    total = 0
    # vectorize by exponent groups to keep Python loop short
    b = int(e_eff.min())
    for e in np.unique(e_eff):
        sel = e_eff == e
        s = int(np.sum(np.where(sign[sel] == 1, -mant[sel], mant[sel]), dtype=object))
        total += s << (int(e) - b)
    if total == 0:
        return 0.0
    return float(Fraction(total) * Fraction(2) ** (b - 1075))


# ---------------------------------------------------------------------------
# Integer-field sums: v = w + field_min with w = mono - min_mono >= 0.
# ---------------------------------------------------------------------------

def int_limb_planes(w: np.ndarray, n_limbs: int) -> np.ndarray:
    """26-bit limb planes of non-negative int64 offsets w. Shape + (n_limbs,)."""
    w = np.asarray(w, dtype=np.int64)
    uw = w.view(np.uint64)
    out = np.zeros(w.shape + (n_limbs,), dtype=np.int32)
    for i in range(n_limbs):
        out[..., i] = ((uw >> np.uint64(LIMB_BITS * i)) & np.uint64(LIMB_MASK)).astype(np.int32)
    return out


def carry_normalize_planes(plane_sums: np.ndarray) -> np.ndarray:
    """Per-row int64 sums of 26-bit limb planes -> canonical signed 26-bit
    int32 limb planes (two extra planes absorb carries; the last plane is
    signed). Exact: sum_i out[..., i] << 26i == sum_i plane_sums[..., i] << 26i.
    Used to precompute per-doc exact sums of multi-valued fields so metric
    aggs over CSR fields reduce in doc space (no per-query row gathers)."""
    plane_sums = np.asarray(plane_sums, dtype=np.int64)
    L = plane_sums.shape[-1]
    out = np.empty(plane_sums.shape[:-1] + (L + 2,), dtype=np.int32)
    carry = np.zeros(plane_sums.shape[:-1], dtype=np.int64)
    for i in range(L):
        t = plane_sums[..., i] + carry
        lo = t - ((t >> LIMB_BITS) << LIMB_BITS)  # floor split: in [0, 2^26)
        carry = t >> LIMB_BITS
        out[..., i] = lo
    lo = carry - ((carry >> LIMB_BITS) << LIMB_BITS)
    out[..., L] = lo
    out[..., L + 1] = carry >> LIMB_BITS  # signed tail
    return out


def int_reconstruct_sum(limb_sums: np.ndarray) -> int:
    total = 0
    for i, s in enumerate(np.asarray(limb_sums).tolist()):
        total += int(s) << (LIMB_BITS * i)
    return total


# ---------------------------------------------------------------------------
# Exact f64 histogram boundaries
# ---------------------------------------------------------------------------

def _smallest_f64_geq(r: Fraction) -> float:
    """Smallest IEEE f64 x with x >= r (r finite rational)."""
    x = float(r)  # correctly rounded to nearest
    if Fraction(x) >= r:
        return x
    return float(np.nextafter(x, np.inf))


def f64_histogram_buckets(
    min_val: float, max_val: float, interval: float, offset: float
) -> Tuple[int, np.ndarray]:
    """Exact bucket layout for an f64 histogram.

    Semantics (SURVEY.md §A.5, ES-compatible):
        key_index(v) = floor((v - offset) / interval)   in exact arithmetic.
    Returns (k_min, inner_boundaries_mono[int64]) where bucket j (0-based,
    j = key_index - k_min) covers values v with
        boundaries[j-1] <= v_mono < boundaries[j]
    evaluated as  bucket_j(v) = searchsorted(boundaries, v_mono, 'right').
    Boundaries are exact: boundary j is the smallest f64 >= offset+(k_min+j+1)*interval.
    """
    iv = Fraction(interval)
    if iv <= 0:
        raise ValueError("interval must be > 0")
    off = Fraction(offset)
    k_min = (Fraction(min_val) - off) // iv
    k_max = (Fraction(max_val) - off) // iv
    nb = int(k_max - k_min) + 1
    bounds = np.empty(nb - 1, dtype=np.float64)
    for j in range(nb - 1):
        b = _smallest_f64_geq(off + (k_min + j + 1) * iv)
        if b == 0.0:
            # -0.0 == 0.0 numerically but mono(-0.0) < mono(+0.0): place a
            # zero boundary at -0.0 so v == -0.0 buckets on the >= side
            # (mirrors query/compile.py _zero_bound for range lower bounds)
            b = -0.0
        bounds[j] = b
    bounds_mono = mono_mod.f64_to_mono(bounds) if nb > 1 else np.empty(0, dtype=np.int64)
    return int(k_min), bounds_mono


def f64_histogram_key(k: int, interval: float, offset: float) -> float:
    """User-facing bucket key: offset + k*interval, correctly rounded."""
    return float(Fraction(offset) + k * Fraction(interval))


# ---------------------------------------------------------------------------
# Percentile rank interpolation (host side, deterministic)
# ---------------------------------------------------------------------------

_INT_DOMAIN = {"u64": (0, 2**64 - 1), "date": (0, 2**64 - 1),
               "i64": (-(2**63), 2**63 - 1)}


def norm_int_bound(type_value: str, value, is_lower: bool,
                   inclusive: bool):
    """Exact normalization of one range bound on an INTEGER field
    (SURVEY.md §A.10 spec choice): fractional bounds tighten to the
    nearest in-range integer (v >= 10.5 == v >= 11), exclusivity folds in
    via the integer bijection, NaN matches nothing, and out-of-domain or
    infinite bounds become "all" (vacuous) or "empty" instead of wrapping
    through the storage dtype. Returns an inclusive USER-domain bound
    (int), "all", or "empty". The single implementation both engines use
    (query/compile.py and oracle/engine.py)."""
    if value is None:
        return "all"
    dmin, dmax = _INT_DOMAIN[type_value]
    b = value
    if isinstance(b, (float, np.floating)):
        b = float(b)
        if math.isnan(b):
            return "empty"
        if math.isinf(b):
            if is_lower:
                return "empty" if b > 0 else "all"
            return "all" if b > 0 else "empty"
        bi = math.ceil(b) if is_lower else math.floor(b)
        if bi != b:
            inclusive = True  # strictness absorbed by the rounding
        b = int(bi)
    else:
        b = int(b)
    if not inclusive:
        b += 1 if is_lower else -1
    if is_lower:
        if b <= dmin:
            return "all"
        if b > dmax:
            return "empty"
    else:
        if b >= dmax:
            return "all"
        if b < dmin:
            return "empty"
    return b


def percentile_rank(p: float, m: int) -> Tuple[int, int, float]:
    """Exact rank split for percentile p over m sorted values.

    rank = (p/100) * (m-1) evaluated exactly (p taken as its IEEE rational);
    returns (lo_index, hi_index, frac) with result = v[lo] + (v[hi]-v[lo])*frac.
    frac is the correctly rounded f64 of the exact fractional part.
    """
    if m <= 0:
        raise ValueError("no values")
    pi = int(p)
    if pi == p:
        # integer percents (the ES defaults; also the serving hot path —
        # host harvest runs this per percent per query): pure int
        # arithmetic. rem/100 is the correctly rounded f64 of the exact
        # rational, i.e. identical to float(Fraction(rem, 100)).
        num = pi * (m - 1)
        lo = num // 100
        lo = max(0, min(lo, m - 1))
        hi = min(lo + 1, m - 1)
        return lo, hi, (num - 100 * lo) / 100
    r = Fraction(p) * (m - 1) / 100
    lo = int(r // 1)
    lo = max(0, min(lo, m - 1))
    hi = min(lo + 1, m - 1)
    frac = float(r - lo)
    return lo, hi, frac


def interpolate(v_lo: float, v_hi: float, frac: float) -> float:
    """The ONE f64 rounding point of percentile harvest; host-evaluated,
    identical expression in oracle and engine."""
    return v_lo + (v_hi - v_lo) * frac
