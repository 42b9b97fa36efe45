"""Value-domain cube lowering: per-query work without the row axis.

The reference engine walks every matched doc per query (SURVEY.md §3.1's
collect loop); the v2 plane engine replaced that with one vectorized pass
over the 10M-row axis per msearch batch. This module removes the row axis
from the per-query cost entirely for a large class of trees:

When every query-chain field is a SINGLE-VALUED narrow/stringy column and
the product of their w-domains is small (<= CUBE_DOM_CAP cells), the chain
mask is a pure elementwise function of the domain tuple: mask[r] =
f(w_1[r], .., w_k[r]). Every masked reduction the engine needs then
regroups by domain cell:

    count        = sum_v ind[v] * C[v]          C[v]   = #rows at cell v
    sum(plane)   = sum_v ind[v] * S[v]          S[v]   = sum of plane at v
    bucket j     = sum_v ind[v] * C[v, j]       (static bucket-id planes)
    min / max    = min/max over {M[v] : ind[v]}
    rank prefix  = sum_v ind[v] * H[b, v]       (per-block histograms)

with ind[v] = f(v) evaluated by the SAME query/compile.eval_mask code over
a virtual iota domain (bit-identical semantics by construction: eval_mask
is elementwise in w for the gated field classes). C/S/M/H are
query-independent: exact int64 host pre-aggregates (counts via bincount;
sums via 13-bit-split float64 bincounts — each half-sum < 2^42 < 2^53, so
the float accumulation is exact; min/max via ufunc.at), decomposed into
7-bit int8 pieces. A query then costs one [Dprod] indicator eval plus one
[B, Dprod] x [Dprod, K] s8 x s8 -> s32 matmul per msearch batch, in
place of a pass over the row planes per query.

Exactness: every piece is int8; a dot lane sums <= Dprod * 127 < 2^24
terms in int32 (Dprod <= 2^17); recombination shifts in int64. The cube is
an exact regrouping of the same integer addends, so results are
bit-identical to the row formulation (and to the oracle) — not just close.

Gating (aggs/compile.py::_cube_gate): programs whose chain has at least one
extracted parameter. Match-all-shaped trees keep the row paths — the cube
is an adaptive access structure for parameterized queries, not a result
cache (EngineConfig.msearch_dedup covers repeated identical requests).

Sharded meshes build PER-SHARD operands (round 5, VERDICT r4 #1): each
shard chunk's rows build their own [Dprod, K] pieces (stacked [S, Dprod, K],
row-sharded over the mesh), every shard dots its local operand against the
replicated indicator, and ONE int32 psum over the [K] dot vector merges —
recombine is linear in the dots, so the shifted shard partials sum to the
exact global value. The build_sum exactness proof then bounds per-SHARD
counts (MAX_BUILD_ROWS per chunk), so the cube survives global indexes of
any size; operand memory and build cost shard with the mesh. Per-shard dot
lanes stay < 2^24 in int32, so the psum'd lanes are < S * 2^24 — exact up
to 128 shards. Min/max cells merge by pmin/pmax instead of psum.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

I32 = jnp.int32
I64 = jnp.int64
I32_MAX = 2**31 - 1
I64_MAX = 2**63 - 1

#: max product-domain cells for a cube (a [B, Dprod] int8 indicator batch
#: and the [Dprod, K] piece operand must stay small next to the row planes)
CUBE_DOM_CAP = 1 << 17
#: max rows PER BUILD (per shard on a mesh): bounds per-cell counts so the
#: host build_sum float64-bincount accumulation stays exact (each 13-bit
#: half-sum < 2^42 < 2^53). Sharded meshes build per-shard operands, so a
#: GLOBAL index may exceed this as long as each shard chunk stays under it
MAX_BUILD_ROWS = 1 << 24
#: max static piece columns per cube site
CUBE_COLS_CAP = 4096
#: max composite (domain cell x bucket) cells for a bucket-agg cube (host
#: bincount domain; 2^23 int64 cells = 64MB transient per build)
CUBE_BCELLS_CAP = 1 << 23
#: PEAK-HBM byte budget for a percentile block-histogram build (the one
#: big cube). The budget covers the transient build scratch too (see
#: BLOCK_BUILD_FACTOR), so the RESIDENT histogram is bounded by a third
#: of this — the same 128MB residency bound as before the accounting fix
CUBE_BLOCK_MEM = 384 << 20
#: candidate block sizes for block histograms: counts <= G decompose into
#: two base-128 digits (G >> 7 <= 64 <= 127 keeps the high digit in int8)
BLOCK_GS = (128, 256, 512, 1024, 2048, 4096, 8192)


def factor_meta(col):
    """(domain size, offset) of one chain field's w-domain. Stringy columns
    include the -1 missing sentinel as cell 0 (offset 1); numeric
    single-valued columns always hold a value (writer default 0), so their
    domain is [0, span]."""
    if col.ftype.is_stringy:
        return int(len(col.terms)) + 1, 1
    return int(col.span) + 1, 0


def npieces_i64(lo: int, hi: int) -> int:
    """Signed 7-bit piece count for int64 values in [lo, hi]: low pieces
    are (v >> 7i) & 127, the top piece is the arithmetic shift v >> 7(n-1)
    and must land in [-128, 127]. v == sum(p_i << 7i) exactly (two's
    complement identity), for any signed int64."""
    for n in range(1, 10):
        s = 7 * (n - 1)
        if -128 <= (lo >> s) and (hi >> s) <= 127:
            return n
    return 10


def pieces_host(x: np.ndarray, n: int) -> np.ndarray:
    """int64 [D] -> int8 [D, n] pieces (see npieces_i64)."""
    out = np.empty(x.shape + (n,), np.int8)
    for i in range(n):
        p = (x >> (7 * i)) & 127 if i < n - 1 else x >> (7 * (n - 1))
        out[..., i] = p.astype(np.int8)
    return out


def strides_of(factors):
    """Mixed-radix strides (last factor fastest), shared by the host cell
    index and the traced virtual domain planes."""
    strides = []
    s = 1
    for _, Df, _ in reversed(factors):
        strides.append(s)
        s *= Df
    return list(reversed(strides)), s


def dom_planes(factors):
    """Traced virtual w-planes over the product domain: plane[field] holds
    the field's w value at every domain cell (iota decode). eval_mask over
    these planes IS the chain predicate as a function of the cell."""
    strides, Dprod = strides_of(factors)
    iota = jax.lax.iota(I32, Dprod)
    planes = {}
    for (f, Df, off), st in zip(factors, strides):
        planes[f"{f}:w"] = (iota // st) % Df - off
    return planes, Dprod


def host_cell(factors, host_ws, avalid) -> np.ndarray:
    """int64 cell index per row from host w-planes; rows outside the alive
    mask get -1 (dropped by every builder)."""
    strides, _ = strides_of(factors)
    cell = np.zeros(host_ws[0].shape[0], np.int64)
    for (f, Df, off), st, w in zip(factors, strides, host_ws):
        cell += (w.astype(np.int64) + off) * st
    return np.where(avalid, cell, -1)


def build_count(cell: np.ndarray, Dprod: int) -> np.ndarray:
    """Exact int64 per-cell row counts."""
    ok = cell >= 0
    return np.bincount(cell[ok], minlength=Dprod).astype(np.int64)


def build_sum(cell: np.ndarray, plane: np.ndarray, Dprod: int) -> np.ndarray:
    """Exact int64 per-cell sums of an int32 plane via 13-bit-split float64
    bincounts: |hi| <= 2^18 and counts <= 2^24, so each half-sum stays
    < 2^42 < 2^53 — every float add is exact. The count precondition is
    asserted locally (not just at the planner gate) so a future direct
    caller on a larger build fails loudly instead of losing exactness."""
    assert cell.shape[0] <= MAX_BUILD_ROWS, \
        "build_sum exactness requires per-cell counts <= MAX_BUILD_ROWS " \
        f"(got {cell.shape[0]} rows)"
    ok = cell >= 0
    c = cell[ok]
    v = plane[ok].astype(np.int64)
    hi = v >> 13
    lo = v - (hi << 13)
    s_hi = np.bincount(c, weights=hi.astype(np.float64), minlength=Dprod)
    s_lo = np.bincount(c, weights=lo.astype(np.float64), minlength=Dprod)
    return (s_hi.astype(np.int64) << 13) + s_lo.astype(np.int64)


def build_min64(cell, rm, Dprod, valid=None) -> np.ndarray:
    """Per-cell int64 minimum (I64_MAX at empty cells — the engine's empty
    min sentinel)."""
    ok = cell >= 0 if valid is None else (cell >= 0) & valid
    out = np.full(Dprod, I64_MAX, np.int64)
    np.minimum.at(out, cell[ok], rm[ok])
    return out


def build_max64(cell, rm, Dprod, valid=None) -> np.ndarray:
    ok = cell >= 0 if valid is None else (cell >= 0) & valid
    out = np.full(Dprod, -(2**63), np.int64)
    np.maximum.at(out, cell[ok], rm[ok])
    return out


def build_min32(cell, w, Dprod, valid=None) -> np.ndarray:
    """Per-cell int32 minimum of a non-negative w plane (I32_MAX empty —
    matches reductions.masked_min_i32)."""
    ok = cell >= 0 if valid is None else (cell >= 0) & valid
    out = np.full(Dprod, I32_MAX, np.int32)
    np.minimum.at(out, cell[ok], w[ok])
    return out


def build_max32(cell, w, Dprod, valid=None) -> np.ndarray:
    """Per-cell int32 maximum (empty -> -1 — matches masked_max_i32: w
    planes are non-negative)."""
    ok = cell >= 0 if valid is None else (cell >= 0) & valid
    out = np.full(Dprod, -1, np.int32)
    np.maximum.at(out, cell[ok], w[ok])
    return out


def bucket_cell(cell: np.ndarray, bid: np.ndarray, nb: int) -> np.ndarray:
    """Composite (domain cell, bucket) index per row for bucket-agg cubes:
    cell * nb + bid, with dropped rows (dead docs / missing bucket values)
    at -1."""
    ok = (cell >= 0) & (bid >= 0)
    return np.where(ok, cell * np.int64(nb) + bid, -1)


def build_bucket_counts(cell2: np.ndarray, Dprod: int, nb: int) -> np.ndarray:
    """Exact int64 [nb, Dprod] per-(bucket, cell) row counts — row j is
    bucket j's count vector over the product domain."""
    ok = cell2 >= 0
    c = np.bincount(cell2[ok], minlength=Dprod * nb)
    return np.ascontiguousarray(c.reshape(Dprod, nb).T.astype(np.int64))


def build_bucket_sums(cell2: np.ndarray, plane: np.ndarray, Dprod: int,
                      nb: int) -> np.ndarray:
    """Exact int64 [nb, Dprod] per-(bucket, cell) sums of an int32 plane
    (same 13-bit-split exactness proof as build_sum over the composite
    domain)."""
    s = build_sum(cell2, plane, Dprod * nb)
    return np.ascontiguousarray(s.reshape(Dprod, nb).T)


def split_rm(rm: np.ndarray):
    """int64 rm values -> (hi, lo) int32 planes such that
    reductions.wide_recon(hi, lo) == rm exactly (incl. the I64_MAX/I64_MIN
    empty sentinels)."""
    hi = (rm >> 32).astype(np.int32)
    lo = (rm - (rm >> 32 << 32) - 2**31).astype(np.int64).astype(np.int32)
    return hi, lo


#: contracting-axis alignment of every cube dot. XLA:GPU (jax 0.9.0,
#: H100) returns wrong batched s8 x s8 -> s32 products when the
#: contracting size is not a multiple of 4 (measured: D in {2, 3, 5, 6, 7,
#: 9, 17, 31, 33, 4097} wrong at B >= 2, doubled values; D = 5 is bench
#: c2's status domain), while zero-padding D to a multiple of 128 was
#: exact at every shape tried and faster at D = 100000. Zero rows add
#: nothing to any dot, so the padding is exact by construction.
DOT_ALIGN = 128


def _align_rows(a, axis: int = 0):
    """Zero-pad `a` along `axis` to a multiple of DOT_ALIGN (host or
    traced arrays)."""
    pad = (-a.shape[axis]) % DOT_ALIGN
    if not pad:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return (np.pad(a, widths) if isinstance(a, np.ndarray)
            else jnp.pad(a, widths))


def pack_groups(groups):
    """[(name, int64 [m] cells), ...] -> (int8 [Dprod, K] pieces, layout)
    where layout = [(name, m, npieces), ...] in column order."""
    cols = []
    layout = []
    for name, arr in groups:
        a = np.asarray(arr, np.int64)
        if a.ndim == 1:
            a = a[None, :]  # [m=1, Dprod]
        lo = int(a.min()) if a.size else 0
        hi = int(a.max()) if a.size else 0
        n = npieces_i64(lo, hi)
        for row in a:
            cols.append(pieces_host(row, n))  # [Dprod, n]
        layout.append((name, a.shape[0], n))
    pieces = np.concatenate(cols, axis=1) if cols else \
        np.zeros((0, 0), np.int8)
    return _align_rows(pieces), layout


def pack_groups_sharded(groups):
    """Per-shard pack: [(name, int64 [S, m, Dprod] or [S, Dprod]), ...] ->
    (int8 [S, Dprod, K] pieces, layout). The piece count per group is
    chosen from the bounds ACROSS shards, so every shard shares one column
    layout and the per-shard int32 dot vectors psum into exactly
    recombine-able totals (recombine is linear in the dots: shifts
    distribute over the shard sum). Column order matches pack_groups
    (group-major, value-row-major, piece-minor)."""
    cols = []
    layout = []
    for name, arr in groups:
        a = np.asarray(arr, np.int64)
        if a.ndim == 2:
            a = a[:, None, :]  # [S, m=1, Dprod]
        lo = int(a.min()) if a.size else 0
        hi = int(a.max()) if a.size else 0
        n = npieces_i64(lo, hi)
        S, m, D = a.shape
        p = pieces_host(a, n)                    # [S, m, Dprod, n]
        cols.append(np.moveaxis(p, 1, 2).reshape(S, D, m * n))
        layout.append((name, m, n))
    pieces = np.concatenate(cols, axis=2) if cols else \
        np.zeros((1, 0, 0), np.int8)
    return _align_rows(pieces, 1), layout


def recombine(dots, layout):
    """Traced: int32 dot vector [K] -> {name: int64 [m] (or scalar m==1)}.
    Runs under x64 semantics (the engine scopes traced int64).

    Vectorized shift-sum on purpose: the scalar-loop form
    ``v = v + (sl[:, i] << (7 * i))`` MISCOMPILES under jit on this jax
    build (0.9.0; XLA drops shifted terms data-dependently, seen on the
    CPU backend — caught by a bit-identity gate, eager mode and numpy
    agree). Do not rewrite as a Python accumulation loop."""
    out = {}
    off = 0
    for name, m, n in layout:
        sl = dots[off:off + m * n].reshape(m, n)
        shifts = jnp.arange(n, dtype=I64) * 7
        v = jnp.sum(sl.astype(I64) << shifts[None, :], axis=1)
        out[name] = v[0] if m == 1 else v
        off += m * n
    return out


def cube_dots(ind8, pieces):
    """One s8 x s8 -> s32 matmul: [Dprod] . [Dprod, K]. Exact by dtype:
    lane sums <= Dprod * 127 < 2^24 (Dprod <= 2^17). Under vmap the batch
    shares the static right operand ([B, Dprod] x [Dprod, K]). Both
    operands are zero-padded to a DOT_ALIGN contracting size (operands
    are built aligned, so only the indicator pads per call)."""
    D = max(ind8.shape[-1], pieces.shape[0])
    D += (-D) % DOT_ALIGN
    ind8 = jnp.pad(ind8, (0, D - ind8.shape[-1]))
    pieces = jnp.pad(pieces, ((0, D - pieces.shape[0]), (0, 0)))
    return jnp.einsum("d,dk->k", ind8, pieces,
                      preferred_element_type=I32)


# -- percentile block histograms (rank-path prefix counts) -------------------

#: transient-build multiplier for the block-histogram byte budget: the
#: device build scatters into an int32 [NB*Dprod] counts scratch (4x the
#: int8 result per digit = 2x the two-digit histogram) and transposes a
#: copy, so peak HBM during build is ~3x the resident histogram
BLOCK_BUILD_FACTOR = 3


def choose_block(n_rows: int, Dprod: int):
    """Smallest block size whose two-digit [Dprod, 2 * n_rows/G] histogram
    AND its transient build scratch (BLOCK_BUILD_FACTOR x) fit the byte
    budget (smaller G = finer prefix = cheaper lazy window recompute at
    selection), or None."""
    for G in BLOCK_GS:
        if n_rows % G == 0 and \
                BLOCK_BUILD_FACTOR * 2 * (n_rows // G) * Dprod \
                <= CUBE_BLOCK_MEM:
            return G
    return None


def build_blockhist(cell_dev, Dprod: int, G: int):
    """Device-built [Dprod, 2*NB] int8 two-digit per-block cell histogram
    from an int32 cell plane over PERMUTED rows (cell < 0 = dropped). A
    one-time 10M-row scatter (off the per-query path); per-query block
    counts are then counts[b] = dot0[b] + (dot1[b] << 7) from one matmul.
    Digits: counts <= G <= 8192 -> low 7 bits + (c >> 7) <= 64, both int8."""
    R = cell_dev.shape[0]
    NB = R // G
    blk = jax.lax.iota(I32, R) // G
    idx = jnp.where(cell_dev >= 0, blk * Dprod + cell_dev, NB * Dprod)
    counts = jnp.zeros(NB * Dprod, I32).at[idx].add(1, mode="drop")
    c2 = counts.reshape(NB, Dprod)
    d0 = (c2 & 127).astype(jnp.int8).T     # [Dprod, NB]
    d1 = (c2 >> 7).astype(jnp.int8).T
    return _align_rows(jnp.concatenate([d0, d1], axis=1))  # [Dprod, 2*NB]


def block_counts(ind8, hist2):
    """Traced per-block chain-match counts [NB] int32 from the two-digit
    histogram: exact (each dot < 2^24; counts <= G)."""
    NB = hist2.shape[1] // 2
    dots = cube_dots(ind8, hist2)
    return dots[:NB] + (dots[NB:] << 7)


def choose_block_ns(n_rows: int, Dprod: int, ns: int):
    """choose_block for per-SLOT block histograms: the [Dprod, ns * 2NB]
    operand (and its BLOCK_BUILD_FACTOR x build scratch) must fit the
    byte budget."""
    for G in BLOCK_GS:
        if n_rows % G == 0 and \
                BLOCK_BUILD_FACTOR * 2 * (n_rows // G) * ns * Dprod \
                <= CUBE_BLOCK_MEM:
            return G
    return None


def build_slot_blockhist(cell_dev, slot_dev, ns: int, Dprod: int, G: int):
    """Device-built [Dprod, 2*NB*ns] two-digit per-(block, slot) cell
    histogram (cell < 0 or slot < 0 = dropped): the slot_rank analog of
    build_blockhist. Column order is block-major slot-minor so the traced
    counts reshape to [ns, NB] with one transpose."""
    R = cell_dev.shape[0]
    NB = R // G
    blk = jax.lax.iota(I32, R) // G
    ok = (cell_dev >= 0) & (slot_dev >= 0)
    comp = (blk * ns + jnp.maximum(slot_dev, 0)) * Dprod + cell_dev
    idx = jnp.where(ok, comp, NB * ns * Dprod)
    counts = jnp.zeros(NB * ns * Dprod, I32).at[idx].add(1, mode="drop")
    c2 = counts.reshape(NB * ns, Dprod)
    d0 = (c2 & 127).astype(jnp.int8).T     # [Dprod, NB*ns]
    d1 = (c2 >> 7).astype(jnp.int8).T
    return _align_rows(jnp.concatenate([d0, d1], axis=1))


def slot_block_counts(ind8, hist2, ns: int):
    """Traced per-slot per-block chain-match counts [ns, NB] int32 from
    the slot block histogram (exact: counts <= G <= 8192, two digits)."""
    M = hist2.shape[1] // 2  # NB * ns
    dots = cube_dots(ind8, hist2)
    c = dots[:M] + (dots[M:] << 7)
    return c.reshape(M // ns, ns).T  # block-major slot-minor -> [ns, NB]
