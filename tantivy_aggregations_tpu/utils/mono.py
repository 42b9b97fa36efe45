"""Order-preserving integer ("mono") domain for device-side numeric compute.

Device replacement for tantivy's monotonic u64 fast-field mapping
(SURVEY.md §2.2 T4): every numeric field type maps into **int64** such that
the mapping is strictly order-preserving and invertible. All device-side
comparisons, min/max, sorting, bucketing and range predicates run on this
domain (exact integer arithmetic; the device stores it as int32 offset
planes, index/loader.py); the inverse map back to user values happens only
at host harvest.

Mappings (all order-preserving):
- i64:  identity.
- u64:  v - 2**63            (wraps u64 order onto signed int64 order)
- date: same as u64 (microseconds since epoch)
- f64:  IEEE-754 total-order trick, then the u64->i64 shift:
          bits = bitcast(v, u64)
          mono_u64 = bits ^ 0x8000...0     if v >= +0.0 (sign bit clear)
                     ~bits                 if sign bit set
          mono_i64 = mono_u64 - 2**63
  -0.0 < +0.0 in this order (harmless for aggregation semantics; documented).
  NaN is rejected at index build time.

These are host-side (NumPy) transforms applied at index load; the device
only ever sees int64 mono values.
"""

from __future__ import annotations

import struct

import numpy as np

_SIGN = np.uint64(0x8000000000000000)
_SHIFT = np.int64(-(2**63))  # adding this == subtracting 2**63 in wraparound


def u64_to_mono(v: np.ndarray) -> np.ndarray:
    """u64 -> order-preserving int64."""
    v = np.asarray(v, dtype=np.uint64)
    return (v ^ _SIGN).view(np.int64)


def mono_to_u64(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.int64)
    return m.view(np.uint64) ^ _SIGN


def i64_to_mono(v: np.ndarray) -> np.ndarray:
    return np.asarray(v, dtype=np.int64)


def mono_to_i64(m: np.ndarray) -> np.ndarray:
    return np.asarray(m, dtype=np.int64)


def f64_to_mono(v: np.ndarray) -> np.ndarray:
    """f64 -> order-preserving int64 (IEEE total order, NaN rejected)."""
    v = np.asarray(v, dtype=np.float64)
    if np.isnan(v).any():
        raise ValueError("NaN not allowed in f64 fast fields")
    bits = v.view(np.uint64)
    neg = (bits & _SIGN) != 0
    # total-order u64 (neg -> ~bits, pos -> bits|SIGN), then ^SIGN to land in
    # signed int64 order; composed: pos -> bits (identity), neg -> ~bits^SIGN.
    mono_u = np.where(neg, ~bits ^ _SIGN, bits)
    return mono_u.view(np.int64)


def mono_to_f64(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.int64)
    u = m.view(np.uint64)
    neg = (u & _SIGN) != 0  # negative mono == negative float
    bits = np.where(neg, ~(u ^ _SIGN), u)
    return bits.view(np.float64)


_TO_MONO = {
    "u64": u64_to_mono,
    "date": u64_to_mono,
    "i64": i64_to_mono,
    "f64": f64_to_mono,
}

_FROM_MONO = {
    "u64": mono_to_u64,
    "date": mono_to_u64,
    "i64": mono_to_i64,
    "f64": mono_to_f64,
}


def to_mono(type_value: str, v: np.ndarray) -> np.ndarray:
    return _TO_MONO[type_value](v)


def from_mono(type_value: str, m: np.ndarray) -> np.ndarray:
    return _FROM_MONO[type_value](m)


def scalar_to_mono(type_value: str, v) -> int:
    """Map one user-domain scalar into the mono domain (for query params)."""
    arr = np.asarray([v])
    if type_value in ("u64", "date"):
        arr = arr.astype(np.uint64)
    elif type_value == "i64":
        arr = arr.astype(np.int64)
    elif type_value == "f64":
        arr = arr.astype(np.float64)
    else:
        raise ValueError(type_value)
    return int(_TO_MONO[type_value](arr)[0])


_U64_MASK = (1 << 64) - 1
_SIGN_INT = 1 << 63


def scalar_from_mono(type_value: str, m: int):
    """Pure-Python scalar inverse of the mono maps (bit-identical to the
    NumPy array forms above; per-scalar np round-trips measured ~8us each
    on the host harvest hot path, this is ~0.3us)."""
    m = int(m)
    if type_value == "i64":
        return m
    if type_value in ("u64", "date"):
        return (m + _SIGN_INT) & _U64_MASK  # == m.view(u64) ^ SIGN
    if type_value == "f64":
        u = m & _U64_MASK
        bits = (~(u ^ _SIGN_INT)) & _U64_MASK if (u & _SIGN_INT) else u
        return struct.unpack("<d", bits.to_bytes(8, "little"))[0]
    raise ValueError(type_value)


#: mono value that sorts after every real value (int64 max); used to pad
#: non-matching slots before sorts so matched values form a prefix.
MONO_POS_INF = 2**63 - 1
#: mono value that sorts before every real value.
MONO_NEG_INF = -(2**63)
