"""Masked / bucketed reduction primitives, v2 (int32-plane engine).

Device replacements for the reference's per-doc collect loop (SURVEY.md
§3.1). The hot paths are elementwise compares plus int32 tree reductions
and int8 matmuls over the row axis; int64 appears only on small arrays
(block totals, per-bucket results). Scatter, row-index gathers and sorts
over the 10M-row axis stay off the hot paths and survive only as `slot_*`
fallbacks for rare agg shapes (sharded meshes run the same prefix/rank
fast paths as one device: per-shard OrderedLayouts + psum'd partials).

Core tricks:
- **Two-stage exact sums** (`ts_sum_plane`): split each int32 addend at bit
  13, reduce 1024-row blocks in int32 (overflow-impossible by construction),
  then combine block sums in int64. Exact for any masked int32 plane,
  including signed f64 limb planes.
- **Blocked one-hot bucket reduce** (`dense_bucket_*`): for nb <= ~256
  buckets, compare-select-reduce per 1024-row block — O(rows * nb)
  elementwise work, no scatter. Used by histograms and small-cardinality
  terms.
- **32-block prefix machinery** (`block32_*`): for the high-cardinality
  terms path over a bucket-sorted OrderedLayout: per-32-row block sums, a
  small int64 cumsum (rows/32 elements), then bounds-gather differences.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

I32 = jnp.int32
I64 = jnp.int64
BLOCK = 1024
I32_MAX = 2**31 - 1
I64_MAX = 2**63 - 1
I64_MIN = -(2**63)


def _blocks(x):
    return x.reshape(-1, BLOCK)


def ts_count(mask) -> jnp.ndarray:
    """Exact int64 count of a bool/int8 mask."""
    b = _blocks(mask.astype(I32)).sum(axis=1)
    return b.astype(I64).sum()


def ts_sum_plane(plane, mask) -> jnp.ndarray:
    """Exact int64 sum of a masked int32 plane (values in (-2^31, 2^31),
    signed allowed). Two-stage: 13-bit split keeps 1024-row block sums in
    int32 (|hi| < 2^18 * 2^10 = 2^28, lo < 2^13 * 2^10 = 2^23)."""
    v = jnp.where(mask, plane, 0)
    hi = v >> 13
    lo = v - (hi << 13)
    hs = _blocks(hi).sum(axis=1).astype(I64).sum()
    ls = _blocks(lo).sum(axis=1).astype(I64).sum()
    return (hs << 13) + ls


def masked_min_i32(plane, mask) -> jnp.ndarray:
    return jnp.min(jnp.where(mask, plane, I32_MAX))


def masked_max_i32(plane, mask) -> jnp.ndarray:
    return jnp.max(jnp.where(mask, plane, -1))


def wide_recon(hi, lo) -> jnp.ndarray:
    """(hi, lo) monoized int32 planes -> order-isomorphic int64 ("rm"
    domain: rm = w - 2^63)."""
    return (hi.astype(I64) << 32) + (lo.astype(I64) + 2**31)


def masked_min_i64(rm, mask) -> jnp.ndarray:
    return jnp.min(jnp.where(mask, rm, I64_MAX))


def masked_max_i64(rm, mask) -> jnp.ndarray:
    return jnp.max(jnp.where(mask, rm, I64_MIN))


def masked_min_wide(hi, lo, mask) -> jnp.ndarray:
    """Exact masked min of a wide (hi, lo) int32 plane pair in the rm
    domain, via TWO int32 passes over the resident planes (lexicographic:
    min hi, then min lo among rows at that hi) — no [rows] int64
    intermediate. Empty mask yields exactly I64_MAX, same as masked_min_i64:
    ((2^31-1) << 32) + (2^31-1) + 2^31 == 2^63 - 1."""
    mh = jnp.min(jnp.where(mask, hi, I32_MAX))
    ml = jnp.min(jnp.where(mask & (hi == mh), lo, I32_MAX))
    return (mh.astype(I64) << 32) + (ml.astype(I64) + 2**31)


def masked_max_wide(hi, lo, mask) -> jnp.ndarray:
    """Exact masked max of a wide (hi, lo) pair (see masked_min_wide);
    empty mask yields exactly I64_MIN."""
    mh = jnp.max(jnp.where(mask, hi, -I32_MAX - 1))
    ml = jnp.max(jnp.where(mask & (hi == mh), lo, -I32_MAX - 1))
    return (mh.astype(I64) << 32) + (ml.astype(I64) + 2**31)


# ---------------------------------------------------------------------------
# Blocked one-hot bucket reductions (nb small)
# ---------------------------------------------------------------------------

def dense_bucket_counts(bid, valid, nb: int) -> jnp.ndarray:
    """[rows] int32 bucket ids (+validity) -> [nb] int64 counts.
    Out-of-range ids (e.g. -1) simply match nothing."""
    b2 = _blocks(bid)
    m2 = _blocks(valid.astype(jnp.bool_)) if valid.dtype != jnp.bool_ \
        else _blocks(valid)
    oh = (b2[:, :, None] == jnp.arange(nb, dtype=I32)[None, None, :]) \
        & m2[:, :, None]
    per_block = jnp.where(oh, 1, 0).sum(axis=1)  # [G, nb] int32, <= 1024
    return per_block.astype(I64).sum(axis=0)


def dense_bucket_sum(bid, valid, plane, nb: int) -> jnp.ndarray:
    """Exact per-bucket int64 sums of a masked int32 plane via blocked
    one-hot + 13-bit split."""
    b2 = _blocks(bid)
    m2 = _blocks(valid.astype(jnp.bool_)) if valid.dtype != jnp.bool_ \
        else _blocks(valid)
    v2 = _blocks(plane)
    hi = v2 >> 13
    lo = v2 - (hi << 13)
    oh = (b2[:, :, None] == jnp.arange(nb, dtype=I32)[None, None, :]) \
        & m2[:, :, None]
    hs = jnp.where(oh, hi[:, :, None], 0).sum(axis=1).astype(I64).sum(axis=0)
    ls = jnp.where(oh, lo[:, :, None], 0).sum(axis=1).astype(I64).sum(axis=0)
    return (hs << 13) + ls


# -- int8 matmul formulation (static bucket-id planes) ----------------------
#
# The one-hot forms above are O(rows * nb) elementwise work PER QUERY —
# under a 128-query msearch batch that multiplies into the dominant cost of
# dense bucket trees. When the bucket-id plane is STATIC (query-independent
# — every MaskCtx-rooted dense node), bucket aggregation is literally a
# matmul:
#
#     counts[q, j] = sum_r mask[q, r] * onehot[r, j]
#     sums[q, j]   = sum_r mask[q, r] * (piece_i[r] * onehot[r, j])
#
# with the right operand query-independent: the per-chunk one-hot/piece
# operand is built once per chunk (amortized over the whole batch, since
# bid/plane are unbatched under vmap) and the batched mask rides an
# s8 x s8 -> s32 matmul. Exactness is by dtype: every piece is int8 (in
# [-128, 127]) and each per-chunk s32 lane sum is <= 524288 * 127 < 2^31;
# per-chunk partials accumulate in int64. lax.scan over row chunks bounds
# the transient footprint to one [B, chunk] int8 mask block instead of a
# [B, rows] copy. Materializing the [chunk, K] operand each step grows
# with the piece count, so callers pass STATIC value bounds wherever the
# plane has a known span — npieces_for_bound shrinks K from the
# worst-case 5 pieces/plane to ceil(bits/7).

_MXU_DENSE_CHUNKS = (524288, 262144, 131072, 65536, 32768, 8192, 4096)
#: transient [chunk, K] int8 operand cap: fewer, larger scan steps up to
#: a 64 MB operand
_MXU_OP_BUDGET = 1 << 26


def npieces_for_bound(bound) -> int:
    """Number of 7-bit pieces needed to decompose int32 values with STATIC
    bounds `bound = (lo, hi)` (inclusive) exactly: low pieces are
    (v >> 7i) & 127 in [0, 127], the top piece is the arithmetic shift
    v >> 7*(np-1) and must land in [-128, 127] (int8 operand range; each
    chunked-matmul s32 partial is bounded by 524288 * 127 < 2^31).
    v == sum_lowpieces + (top << 7*(np-1)) holds for any signed int32.
    None (unknown bounds) -> 5 pieces (the full-int32 decomposition)."""
    if bound is None:
        return 5
    lo, hi = int(bound[0]), int(bound[1])
    for np_ in range(1, 5):
        s = 7 * (np_ - 1)
        if -128 <= (lo >> s) and (hi >> s) <= 127:
            return np_
    return 5


def _pieces(v, np_: int):
    """The np_ 7-bit pieces of int32 plane v (see npieces_for_bound)."""
    out = []
    for i in range(np_):
        out.append((v >> (7 * i)) & 127 if i < np_ - 1
                   else v >> (7 * (np_ - 1)))
    return out


def _recombine(acc_pieces):
    """int64 piece sums [np_, ...] -> exact int64 total.

    Vectorized shift-sum on purpose: the scalar accumulation loop
    ``out = out + (acc_pieces[i] << (7 * i))`` MISCOMPILES under jit on
    this jax build (0.9.0) for np_ >= 5 — XLA drops shifted terms
    data-dependently (seen on the CPU backend, fuzz-verified; eager mode
    and numpy agree). Do not rewrite as a Python loop."""
    np_ = acc_pieces.shape[0]
    shifts = (jnp.arange(np_, dtype=I64) * 7).reshape(
        (np_,) + (1,) * (acc_pieces.ndim - 1))
    return jnp.sum(acc_pieces << shifts, axis=0)


def _mxu_dense_chunk(rows: int, K: int = 1):
    """Largest dividing chunk whose [chunk, K] int8 operand fits the
    transient budget; the smallest dividing chunk when K alone exceeds it
    (correctness never depends on the choice — see _dense_mxu_scan)."""
    fit = [c for c in _MXU_DENSE_CHUNKS if rows % c == 0]
    if not fit:
        return None
    for c in fit:
        if c * max(1, K) <= _MXU_OP_BUDGET:
            return c
    return fit[-1]


def _dense_mxu_scan(valid, K: int, n_chunks: int, chunk: int, make_op):
    """Shared chunked-matmul driver: acc[k] += m_chunk @ op_chunk[r, k],
    s8 x s8 -> s32. Exact by dtype alone: every per-chunk lane sum is
    <= 524288 * 127 < 2^31 for any chunk in _MXU_DENSE_CHUNKS."""
    def body(acc, c):
        m = jax.lax.dynamic_slice_in_dim(valid, c * chunk, chunk)
        op = make_op(c)  # [chunk, K] int8, query-independent
        part = jnp.einsum("r,rk->k", m.astype(jnp.int8), op,
                          preferred_element_type=I32)
        return acc + part.astype(I64), None

    acc, _ = jax.lax.scan(body, jnp.zeros(K, I64), jnp.arange(n_chunks))
    return acc


def dense_bucket_counts_mxu(bid, valid, nb: int) -> jnp.ndarray:
    """dense_bucket_counts for a STATIC bid plane, as chunked int8 matmuls.
    Falls back to the one-hot form when rows don't chunk cleanly."""
    rows = bid.shape[0]
    chunk = _mxu_dense_chunk(rows, nb)
    if chunk is None:
        return dense_bucket_counts(bid, valid, nb)
    iota = jnp.arange(nb, dtype=I32)

    def make_op(c):
        b = jax.lax.dynamic_slice_in_dim(bid, c * chunk, chunk)
        return (b[:, None] == iota).astype(jnp.int8)

    return _dense_mxu_scan(valid, nb, rows // chunk, chunk, make_op)


def dense_bucket_sum_mxu(bid, valid, plane, nb: int, bound=None) -> jnp.ndarray:
    """dense_bucket_sum for a STATIC bid plane: 7-bit pieces of the int32
    payload each ride the same chunked matmul; recombined with int64
    shifts. `bound` is an optional STATIC inclusive (lo, hi) on the
    plane's values at valid rows — it shrinks the piece count (and hence
    the dominant per-chunk operand materialization) from the worst-case 5
    (full int32) down to e.g. 2 for a 14-bit column span."""
    rows = bid.shape[0]
    npieces = npieces_for_bound(bound)
    chunk = _mxu_dense_chunk(rows, npieces * nb)
    if chunk is None or plane.dtype != I32:
        return dense_bucket_sum(bid, valid, plane, nb)
    if bound is not None and bound[0] == 0 and bound[1] == 0:
        return jnp.zeros(nb, I64)  # statically all-zero plane
    iota = jnp.arange(nb, dtype=I32)

    def make_op(c):
        b = jax.lax.dynamic_slice_in_dim(bid, c * chunk, chunk)
        v = jax.lax.dynamic_slice_in_dim(plane, c * chunk, chunk)
        oh = b[:, None] == iota
        return jnp.concatenate(
            [jnp.where(oh, p[:, None], 0).astype(jnp.int8)
             for p in _pieces(v, npieces)], axis=1)  # [chunk, npieces*nb]

    acc = _dense_mxu_scan(valid, npieces * nb, rows // chunk, chunk, make_op)
    return _recombine(acc.reshape(npieces, nb))


def masked_sum_planes_mxu(mask, planes, bounds=None) -> jnp.ndarray:
    """Exact int64 masked sums of L int32 planes in ONE chunked matmul pass:
    sums[l] = sum_r mask[r] * planes[l][r]. The 7-bit pieces of every
    plane concatenate into a single [chunk, sum(npieces)] static operand,
    so an msearch batch pays one matmul stream instead of L VPU reduction
    passes per query (bench c2's avg-over-multi-valued was 3 such passes).
    `bounds` is an optional per-plane list of STATIC inclusive (lo, hi)
    value bounds (None entries -> worst-case 5 pieces); statically-zero
    planes ((0, 0) bounds — e.g. high carry-limb planes of a small-valued
    column) are dropped from the operand entirely.
    Falls back to ts_sum_plane when rows don't chunk cleanly."""
    rows = planes[0].shape[0]
    L = len(planes)
    if bounds is None:
        bounds = [None] * L
    live = [l for l in range(L)
            if bounds[l] is None or tuple(bounds[l]) != (0, 0)]
    nps = [npieces_for_bound(bounds[l]) for l in live]
    K = sum(nps)
    chunk = _mxu_dense_chunk(rows, K)
    if chunk is None or any(p.dtype != I32 for p in planes):
        return jnp.stack([ts_sum_plane(p, mask) for p in planes])
    if not live:
        return jnp.zeros(L, I64)

    def make_op(c):
        ops = []
        for l, np_ in zip(live, nps):
            v = jax.lax.dynamic_slice_in_dim(planes[l], c * chunk, chunk)
            ops.extend(pc.astype(jnp.int8) for pc in _pieces(v, np_))
        return jnp.stack(ops, axis=1)  # [chunk, K]

    acc = _dense_mxu_scan(mask, K, rows // chunk, chunk, make_op)
    out = [jnp.zeros((), I64)] * L
    o = 0
    for l, np_ in zip(live, nps):
        out[l] = _recombine(acc[o:o + np_])
        o += np_
    return jnp.stack(out)


def dense_bucket_min(bid, valid, plane, nb: int) -> jnp.ndarray:
    b2 = _blocks(bid)
    m2 = _blocks(valid.astype(jnp.bool_)) if valid.dtype != jnp.bool_ \
        else _blocks(valid)
    v2 = _blocks(plane)
    oh = (b2[:, :, None] == jnp.arange(nb, dtype=I32)[None, None, :]) \
        & m2[:, :, None]
    dt_max = I32_MAX if plane.dtype == I32 else I64_MAX
    return jnp.where(oh, v2[:, :, None], dt_max).min(axis=1).min(axis=0)


def dense_bucket_max(bid, valid, plane, nb: int) -> jnp.ndarray:
    b2 = _blocks(bid)
    m2 = _blocks(valid.astype(jnp.bool_)) if valid.dtype != jnp.bool_ \
        else _blocks(valid)
    v2 = _blocks(plane)
    oh = (b2[:, :, None] == jnp.arange(nb, dtype=I32)[None, None, :]) \
        & m2[:, :, None]
    dt_min = -(2**31) if plane.dtype == I32 else I64_MIN
    return jnp.where(oh, v2[:, :, None], dt_min).max(axis=1).max(axis=0)


# ---------------------------------------------------------------------------
# 32-block prefix machinery (high-cardinality terms over OrderedLayout)
# ---------------------------------------------------------------------------

def block32_counts(mask) -> jnp.ndarray:
    """[R] mask -> [R/32] int32 per-32-row counts."""
    return mask.astype(I32).reshape(-1, 32).sum(axis=1)


def slot_block32_counts(slot, mask, ns: int) -> jnp.ndarray:
    """[R] int32 slot ids (outside [0, ns) match nothing) + [R] mask ->
    [R/32, ns] int32 matched counts per 32-row block per slot."""
    oh = (slot.reshape(-1, 32)[:, :, None]
          == jnp.arange(ns, dtype=I32)[None, None, :])
    m = mask.reshape(-1, 32)[:, :, None]
    return jnp.where(oh & m, 1, 0).sum(axis=1)


def block32_sums(plane, mask) -> jnp.ndarray:
    """[R] masked int32 plane -> [R/32] int64 exact per-32-row sums
    (32 * 2^31 overflows int32, so split at 13 bits then widen)."""
    v = jnp.where(mask, plane, 0).reshape(-1, 32)
    hi = v >> 13
    lo = v - (hi << 13)
    return (hi.sum(axis=1).astype(I64) << 13) + lo.sum(axis=1).astype(I64)


def prefix_diff(block_vals, bounds32) -> jnp.ndarray:
    """Exclusive prefix over [R/32] block values, gathered at 32-unit bucket
    bounds [card+1] -> per-bucket totals [card] int64."""
    pref = jnp.cumsum(block_vals.astype(I64))
    pref = jnp.concatenate([jnp.zeros(1, I64), pref])
    at = pref[bounds32]
    return at[1:] - at[:-1]


# ---------------------------------------------------------------------------
# Exact matmul prefix scan (a cumsum formulation for per-query block axes)
# ---------------------------------------------------------------------------
#
# A prefix scan IS a triangular matmul: split values into 7-bit pieces
# (each piece and every f32 partial stays exactly representable in a
# bf16 x bf16 -> f32 product: |piece| <= 127, chunk sums <= 2048 * 127 <
# 2^18 << 2^24, so the f32 accumulation is exact in any order), multiply
# each chunk by a constant upper-triangular 0/1 matrix, then stitch chunk
# offsets with a tiny int64 scan. Exact for any int32 input by
# construction; pure XLA (works on every backend and under
# shard_map/vmap). chip_smoke.py checks it against jnp.cumsum at the
# benchmark's [128, R/32] shape.

_SCAN_CHUNK = 2048


def _signed_pieces(x, max_abs: int):
    """x int32 [..] -> list of int32 piece arrays, low-to-high: pieces
    0..n-2 in [0, 127], top piece signed in [-64, 63] (given |x| <=
    max_abs); x == sum(p_i << 7i) exactly (two's complement identity)."""
    n = 1
    while (int(max_abs) >> (7 * (n - 1))) > 63:
        n += 1
    pieces = []
    for i in range(n - 1):
        pieces.append((x >> (7 * i)) & 127)
    pieces.append(x >> (7 * (n - 1)))
    return pieces


def mxu_cumsum(x, max_abs: int, chunk: int = _SCAN_CHUNK) -> jnp.ndarray:
    """Exact int64 inclusive cumsum along the LAST axis of an int32 array
    with |values| <= max_abs, computed as piece-decomposed triangular
    bf16 matmuls plus a tiny cross-chunk int64 scan."""
    g = x.shape[-1]
    lead = x.shape[:-1]
    pad = (-g) % chunk
    if pad:
        x = jnp.concatenate(
            [x, jnp.zeros((*lead, pad), x.dtype)], axis=-1)
    c = (g + pad) // chunk
    x3 = x.reshape(*lead, c, chunk)
    # build the triangular operand IN-TRACE from iotas: a host np.triu
    # constant would embed a [chunk, chunk] literal in the HLO (megabytes
    # of program text per instance)
    ri = jax.lax.broadcasted_iota(jnp.int32, (chunk, chunk), 0)
    ci = jax.lax.broadcasted_iota(jnp.int32, (chunk, chunk), 1)
    tri = (ri <= ci).astype(jnp.bfloat16)
    # vectorized shift-sum (see _recombine: the scalar shift-accumulate
    # loop miscompiles under jit on this jax build)
    parts = jnp.stack(
        [jnp.einsum("...ck,kj->...cj", p.astype(jnp.bfloat16), tri,
                    preferred_element_type=jnp.float32).astype(I32)
         for p in _signed_pieces(x3, max_abs)])
    shifts = (jnp.arange(parts.shape[0], dtype=I64) * 7).reshape(
        (parts.shape[0],) + (1,) * (parts.ndim - 1))
    intra = jnp.sum(parts.astype(I64) << shifts, axis=0)
    # chunk totals -> exclusive int64 offsets (tiny: [.., c])
    tot = intra[..., -1]
    off = jnp.cumsum(tot, axis=-1) - tot
    cum = (intra + off[..., None]).reshape(*lead, c * chunk)
    return cum[..., :g] if pad else cum


def prefix_diff_counts(vm, bounds32) -> jnp.ndarray:
    """prefix_diff(block32_counts(vm), bounds32) with an int32 cumsum
    (exact: totals <= R < 2^31)."""
    pref = jnp.cumsum(block32_counts(vm)).astype(I64)
    pref = jnp.concatenate([jnp.zeros(1, I64), pref])
    at = pref[bounds32]
    return at[1:] - at[:-1]


def prefix_diff_sums(plane, mask, bounds32) -> jnp.ndarray:
    """prefix_diff(block32_sums(plane, mask), bounds32) without ever
    materializing an int64 block axis: the 13-bit split's per-block hi/lo
    int32 sums (|hi_sum| <= 32 * 2^18, lo_sum < 32 * 2^13) each scan
    through mxu_cumsum and recombine at the [card+1] bounds gather."""
    v = jnp.where(mask, plane, 0).reshape(-1, 32)
    hi = v >> 13
    lo = v - (hi << 13)
    ch = mxu_cumsum(hi.sum(axis=1), 32 << 18)
    cl = mxu_cumsum(lo.sum(axis=1), 32 << 13)
    pref = (ch << 13) + cl
    pref = jnp.concatenate([jnp.zeros(1, I64), pref])
    at = pref[bounds32]
    return at[1:] - at[:-1]


# ---------------------------------------------------------------------------
# Scatter fallbacks (rare agg shapes)
# ---------------------------------------------------------------------------

def slot_count(slot, valid, nslots: int) -> jnp.ndarray:
    return jnp.zeros(nslots, I64).at[slot].add(
        jnp.where(valid, 1, 0).astype(I64), mode="drop")


def slot_min(vals, slot, valid, nslots: int) -> jnp.ndarray:
    big = I32_MAX if vals.dtype == I32 else I64_MAX
    return jnp.full(nslots, big, vals.dtype).at[slot].min(
        jnp.where(valid, vals, big), mode="drop")


def slot_max(vals, slot, valid, nslots: int) -> jnp.ndarray:
    small = -(2**31) if vals.dtype == I32 else I64_MIN
    return jnp.full(nslots, small, vals.dtype).at[slot].max(
        jnp.where(valid, vals, small), mode="drop")


def slot_sum(vals, slot, valid, nslots: int) -> jnp.ndarray:
    return jnp.zeros(nslots, I64).at[slot].add(
        jnp.where(valid, vals.astype(I64), 0), mode="drop")


def values_hit_to_doc_mask(hits, doc_id, T: int) -> jnp.ndarray:
    """CSR value-row hits -> doc mask (scatter-or; multi-valued query fields
    only — single-cardinality fields are dense and never come here)."""
    acc = jnp.zeros(T, jnp.int32).at[doc_id].max(
        hits.astype(jnp.int32), mode="drop")
    return acc > 0
