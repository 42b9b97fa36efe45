"""Device index loader: host segments -> device-resident int32 column planes.

Device redesign of tantivy's fast-field storage (SURVEY.md §2.2 T4/T5).
Stored planes are int32/int8 only, so every resident byte is a plane a
32-bit compare or reduction reads directly, and the exact-sum machinery
(utils/exact.py) never depends on device int64 storage:

- **All device compute is int32.** Each numeric field maps through the
  order-preserving int64 "mono" domain (utils/mono.py) but is STORED as
  int32 planes of the offset w = mono - min_mono:
    - narrow (span < 2^31-1): one plane `w` — exact compares, min/max, and
      two-stage exact sums directly (half the HBM traffic of int64);
    - wide: two monoized planes (hi, lo) of w's u64 value — compares and
      min/max are lexicographic; exact sums use signed 26-bit limb planes.
  f64 fields additionally carry limb planes of the exact fixed-point value
  (utils/exact.py) for exact order-independent sums.
- **Single-cardinality keyword fields are DENSE**: one int32 global-ordinal
  column (-1 = missing) aligned with the doc axis — term queries are a
  vector compare and terms aggs scatter-free; only truly multi-valued
  fields pay the CSR indirection.
- **Segments are concatenated** on one padded doc axis; global ordinals are
  aligned at load (§A.6) so bucket merges are dense integer adds.
- **OrderedLayout** (ordered_layout()): a load-time argsort of a column with
  32-aligned bucket padding, enabling prefix-difference bucket reductions
  and rank-selection percentiles without per-query sorts or scatters.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..schema import Cardinality, FieldType, Schema
from ..utils import exact, mono as mono_mod

#: doc/value axes are padded to a multiple of this (<0.4% padding on 10M
#: docs). Every row axis then divides by the 32-row prefix blocks, the
#: 1024-row two-stage sum blocks and every chunk in ops/reductions.py
#: _MXU_DENSE_CHUNKS up to 32768; the chunked-sum overflow proofs rely on
#: those divisions.
PAD_BLOCK = 32768
#: narrow-column span bound: span+1 must stay in int32
NARROW_MAX_SPAN = 2**31 - 2
#: OrderedLayout bucket boundaries are aligned to this many rows
ALIGN = 32
#: multi-valued NARROW fields with at most this many values per doc also get
#: doc-aligned dense planes (value k of each doc), so term/range doc masks
#: are pure compares instead of the (measured-pathological) scatter-or
DENSE_MULTI_K = 8

I32 = np.int32


def _pad_to(n: int, block: int) -> int:
    return max(block, ((n + block - 1) // block) * block)


def _put(arr, mesh, spec_ndim: int = 1):
    """Host array -> device: the default device, or sharded over the
    mesh's 'd' axis along axis 0."""
    if mesh is None:
        return jnp.asarray(arr)
    from jax.sharding import NamedSharding, PartitionSpec as P
    spec = P("d", *([None] * (spec_ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


@functools.lru_cache(maxsize=None)
def _derive_limbs_fn(narrow: bool, is_f64: bool, n_limbs: int):
    """Jitted on-device derivation of the exact-sum 26-bit limb planes from
    a column's resident compare planes — the device mirror of
    utils/exact.int_limb_planes / f64_limb_planes (bit-identical, incl.
    padding rows, which carry the column-min value's limbs on both paths).
    Runs under an enable_x64(True) scope (XLA int64)."""
    LB, MASK = exact.LIMB_BITS, exact.LIMB_MASK
    F52 = (1 << 52) - 1
    SIGN = -(2**63)  # int64 bit pattern 0x8000...

    def fn(planes, min_mono, base_exp):
        if narrow:
            u = planes[0].astype(jnp.int64)  # w in [0, span]
        else:
            hi = planes[0].astype(jnp.int64) + 2**31
            lo = planes[1].astype(jnp.int64) + 2**31
            u = (hi << 32) | lo  # u64 offset w as an int64 bit pattern
        if not is_f64:
            # integer path: limbs of the u64 offset w itself
            return jnp.stack(
                [(jax.lax.shift_right_logical(u, LB * i) & MASK)
                 .astype(jnp.int32) for i in range(n_limbs)], axis=-1)
        # f64: mono = w + min_mono (wraparound) -> IEEE bits -> decompose
        mono = u + min_mono
        neg = mono < 0
        bits = jnp.where(neg, ~(mono ^ SIGN), mono)
        e = jax.lax.shift_right_logical(bits, 52) & 0x7FF
        frac = bits & F52
        mant = jnp.where(e > 0, frac | (1 << 52), frac)
        e_eff = jnp.maximum(e, 1)
        shift = jnp.where(mant == 0, 0, e_eff - base_exp.astype(jnp.int64))
        sgn = jnp.where(neg, jnp.int64(-1), jnp.int64(1))
        outs = []
        for i in range(n_limbs):
            rel = LB * i - shift
            right = jnp.clip(rel, 0, 63)
            left = jnp.clip(-rel, 0, 63)
            limb = jnp.where(rel >= 0,
                             jax.lax.shift_right_logical(mant, right),
                             mant << left) & MASK
            outs.append((limb * sgn).astype(jnp.int32))
        return jnp.stack(outs, axis=-1)

    return jax.jit(fn)


def _split_wide(w_u64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """u64 offsets -> (hi, lo) monoized int32 planes (lexicographic order
    over (hi, lo) == numeric order over w)."""
    hi = ((w_u64 >> np.uint64(32)).astype(np.int64) - 2**31).astype(I32)
    lo = ((w_u64 & np.uint64(0xFFFFFFFF)).astype(np.int64) - 2**31).astype(I32)
    return hi, lo


def monoize_u32(x: int) -> int:
    """u32 -> order-preserving int32 (for wide-plane compare params)."""
    return int(x) - 2**31


@dataclass
class OrderedLayout:
    """Static value-order view of a column (see module docstring)."""

    perm: np.ndarray  # [R] int32: row index (doc or value-row) per position
    n_rows: int  # padded length R (multiple of PAD_BLOCK, incl. dead pad)
    #: for bucket layouts: 32-aligned row offsets per bucket id [card+1]
    bounds: Optional[np.ndarray] = None
    valid_perm: Optional[jnp.ndarray] = None  # [R] int8: 0 on padding rows
    valid_perm_host: Optional[np.ndarray] = None  # host copy (never pull)
    #: for percentile layouts: values in position order (host int64 mono)
    sorted_mono: Optional[np.ndarray] = None
    sorted_mono_dev: Optional[jnp.ndarray] = None
    #: permuted device array cache: key -> [R,...] array
    cache: Dict[str, jnp.ndarray] = field(default_factory=dict)


@dataclass
class DeviceColumn:
    """One loaded column. Device planes (`w`/`hi`/`lo`/`doc_id`/`valid`/
    `multi_planes`/`tail_*`) are LAZY properties: the host int32 plane is
    built at load, but nothing is copied to the device until a compiled
    program actually declares the plane as an input (see _put). Structure
    checks use `has_multi_planes` / `has_tail` so planning never triggers
    a transfer."""

    name: str
    ftype: FieldType
    multi: bool  # True only for CSR storage (real multi-valued fields)
    # -- compare/minmax planes (value rows: [T] dense or [V] CSR) -----------
    narrow: bool = True
    # keyword: `w` holds global ordinals (dense: -1 = missing)
    # -- keyword --------------------------------------------------------------
    terms: Optional[np.ndarray] = None  # global sorted term table (host)
    # -- static metadata ------------------------------------------------------
    min_mono: int = 0
    max_mono: int = 0
    n_values: int = 0
    span: int = 0  # max_mono - min_mono (as u64 width)
    # -- exact-sum plan -------------------------------------------------------
    sum_direct: bool = True  # narrow ints: sum the w plane directly
    f64_base_exp: int = 1
    sum_n_limbs: int = 1
    _mesh: Optional[object] = None
    #: (index path, epoch, n_shards) — cross-process prep-cache anchor
    _prep: Optional[tuple] = None
    _host_values: Optional[np.ndarray] = None  # user-domain, padded layout
    _host_valid: Optional[np.ndarray] = None
    _host_mono: Optional[np.ndarray] = None  # int64 mono, padded layout
    _host_doc: Optional[np.ndarray] = None  # CSR doc ids (padded layout)
    _orig_docs: Optional[np.ndarray] = None  # CSR: global doc per value row
    _orig_values: Optional[np.ndarray] = None  # CSR: values, original order
    # -- host planes backing the lazy device properties -----------------------
    _w_host: Optional[np.ndarray] = None   # int32 [R] (narrow / ordinals)
    _hi_host: Optional[np.ndarray] = None  # int32 [R] (wide)
    _lo_host: Optional[np.ndarray] = None
    _valid8_host: Optional[np.ndarray] = None  # int8 [V] (CSR)
    #: dense doc-aligned planes for multi-valued NARROW/keyword fields:
    #: [T] int32 w-planes (-1 = no value at that position), positions
    #: 0..DENSE_MULTI_K-1 of each doc
    multi_planes_host: Optional[list] = None
    #: dense doc-aligned planes for multi-valued WIDE fields: per value
    #: position k a (hi, lo) int32 pair (same lexicographic rm-domain split
    #: as single wide columns) + one shared value-count plane `mpn` (the
    #: validity guard — wide pairs have no free sentinel value)
    multi_planes_wide_host: Optional[list] = None
    _mpn_host: Optional[np.ndarray] = None
    #: overflow tail for docs with more than DENSE_MULTI_K values: the
    #: remaining value rows as a (small) CSR triple — term/range doc masks
    #: are plane compares plus a scatter-or over just these rows
    _tail_w_host: Optional[np.ndarray] = None
    _tail_hi_host: Optional[np.ndarray] = None
    _tail_lo_host: Optional[np.ndarray] = None
    _tail_doc_host: Optional[np.ndarray] = None
    _tail_valid8_host: Optional[np.ndarray] = None
    #: lazily shipped device arrays, keyed by plane name
    _dev: Dict[str, jnp.ndarray] = field(default_factory=dict)
    # -- numeric terms dictionary (lazy) --------------------------------------
    _term_ids: Optional[jnp.ndarray] = None
    _term_ids_host: Optional[np.ndarray] = None
    _term_values_mono: Optional[np.ndarray] = None
    # -- ordered layouts (lazy; unsharded only) -------------------------------
    _bucket_layout: Optional[OrderedLayout] = None
    _value_layout: Optional[OrderedLayout] = None
    # per-doc pre-aggregate planes for CSR metric sub-aggs (lazy, static)
    _doc_preagg: Optional[dict] = None

    # -- lazy device planes ---------------------------------------------------

    def _ship(self, key: str, host, ndim: int = 1):
        if host is None:
            return None
        if key not in self._dev:
            self._dev[key] = _put(host, self._mesh, ndim)
        return self._dev[key]

    @property
    def w(self):
        return self._ship("w", self._w_host)

    @property
    def hi(self):
        return self._ship("hi", self._hi_host)

    @property
    def lo(self):
        return self._ship("lo", self._lo_host)

    @property
    def doc_id(self):
        return self._ship("doc", self._host_doc)

    @property
    def valid(self):
        return self._ship("valid", self._valid8_host)

    @property
    def has_multi_planes(self) -> bool:
        return self.multi_planes_host is not None

    @property
    def multi_planes(self):
        if self.multi_planes_host is None:
            return None
        return [self._ship(f"mp{k}", p)
                for k, p in enumerate(self.multi_planes_host)]

    @property
    def has_multi_planes_wide(self) -> bool:
        return self.multi_planes_wide_host is not None

    @property
    def multi_planes_wide(self):
        if self.multi_planes_wide_host is None:
            return None
        return [(self._ship(f"mph{k}", h), self._ship(f"mpl{k}", l))
                for k, (h, l) in enumerate(self.multi_planes_wide_host)]

    @property
    def mpn(self):
        return self._ship("mpn", self._mpn_host)

    @property
    def has_tail(self) -> bool:
        return (self._tail_w_host is not None
                or self._tail_hi_host is not None)

    @property
    def has_value_rows(self) -> bool:
        """CSR columns whose padded value rows carry a doc map — the gate
        for VALUE-ROW OrderedLayouts (rank/bisect percentiles over
        multi-valued fields; rows partition by owning shard, so per-shard
        sorts and cross-shard bisection apply unchanged)."""
        return self.multi and self._host_doc is not None

    @property
    def tail_w(self):
        return self._ship("tw", self._tail_w_host)

    @property
    def tail_hi(self):
        return self._ship("th", self._tail_hi_host)

    @property
    def tail_lo(self):
        return self._ship("tl", self._tail_lo_host)

    @property
    def tail_doc(self):
        return self._ship("tdoc", self._tail_doc_host)

    @property
    def tail_valid(self):
        return self._ship("tvalid", self._tail_valid8_host)

    # -- lazy exact-sum limb planes -------------------------------------------

    def sum_limbs(self) -> jnp.ndarray:
        if "limbs" not in self._dev:
            if self._mesh is None:
                # derive ON DEVICE from the already-resident compare planes:
                # limbs are a pure bit function of the mono value, so this
                # copies no extra host bytes (bit-identical to
                # sum_limbs_host; see _derive_limbs_fn)
                planes = (self.w,) if self.narrow else (self.hi, self.lo)
                fn = _derive_limbs_fn(self.narrow,
                                      self.ftype == FieldType.F64,
                                      self.sum_n_limbs)
                with jax.enable_x64(True):
                    self._dev["limbs"] = fn(
                        planes, jnp.int64(self.min_mono),
                        jnp.int32(self.f64_base_exp))
            else:
                self._dev["limbs"] = _put(self.sum_limbs_host(),
                                          self._mesh, 2)
        return self._dev["limbs"]

    def sum_limbs_host(self) -> np.ndarray:
        if self.ftype == FieldType.F64:
            return exact.f64_limb_planes(
                self._host_values, self.f64_base_exp, self.sum_n_limbs)
        wu = _w_u64(self._host_mono, self.min_mono)
        return exact.int_limb_planes(wu.view(np.int64), self.sum_n_limbs)

    def limb_bounds(self) -> list:
        """Per-plane STATIC (lo, hi) value bounds of the sum_limbs() planes
        (trace-time metadata for the int8 piece decomposition). Integer
        fields: limbs of the non-negative offset w <= span, so plane i is
        bounded by span >> 26i — the top plane of a modest-span column
        needs 1 piece instead of 5. f64: signed 26-bit limbs."""
        if self.ftype == FieldType.F64:
            m = exact.LIMB_MASK
            return [(-m, m)] * self.sum_n_limbs
        return [(0, min(exact.LIMB_MASK,
                        int(self.span) >> (exact.LIMB_BITS * i)))
                for i in range(self.sum_n_limbs)]

    # -- lazy numeric terms dictionary ----------------------------------------

    def term_ids(self):
        if self._term_ids is None:
            m = self._host_mono
            real = m if self._host_valid is None else m[self._host_valid]
            uniq = np.unique(real) if real.size else np.zeros(1, np.int64)
            ids = np.clip(np.searchsorted(uniq, m), 0, len(uniq) - 1) \
                .astype(I32)
            if self._host_valid is not None:
                ids = np.where(self._host_valid, ids, -1)
            self._term_ids_host = ids
            self._term_ids = _put(ids, self._mesh, 1)
            self._term_values_mono = uniq
        return self._term_ids, self._term_values_mono

    @property
    def card(self) -> int:
        if self.ftype.is_stringy:
            return max(1, len(self.terms))
        self.term_ids()
        return max(1, len(self._term_values_mono))

    def min_user(self):
        return mono_mod.scalar_from_mono(self.ftype.value, self.min_mono)

    # -- precomputed histogram bucket ids (host-exact, cached per layout) -----
    _bid_cache: Optional[dict] = None

    def bucket_id_plane(self, key: str, build_host):
        """Cached device int32 plane of per-row bucket ids for a histogram
        shape (interval/offset static per compiled tree): computed host-side
        with exact integer/rational arithmetic once, then HBM-resident —
        replaces an in-trace int64 division pass per query."""
        if self._bid_cache is None:
            self._bid_cache = {}
        if key not in self._bid_cache:
            self._bid_cache[key] = _put(build_host().astype(I32), self._mesh)
        return self._bid_cache[key]

    # -- per-doc pre-aggregates for CSR metric aggs ---------------------------
    # Static and exact: computed once from the (query-independent) full value
    # set, so metric aggs over multi-valued fields reduce in DOC space —
    # no per-query value-row gathers or scatters.

    def doc_preagg_host(self, T: int) -> dict:
        if self._doc_preagg is None:
            docs = self._orig_docs
            n = docs.shape[0]
            cnt = np.bincount(docs, minlength=T).astype(I32) if n \
                else np.zeros(T, I32)
            # per-doc exact sums -> canonical signed 26-bit limb planes
            if self.ftype == FieldType.F64:
                row_planes = exact.f64_limb_planes(
                    self._orig_values, self.f64_base_exp, self.sum_n_limbs)
            else:
                wu = _w_u64(np.asarray(mono_mod.to_mono(
                    self.ftype.value, self._orig_values), np.int64),
                    self.min_mono)
                row_planes = exact.int_limb_planes(
                    wu.view(np.int64), self.sum_n_limbs)
            L = row_planes.shape[1]
            plane_sums = np.zeros((T, L), np.int64)
            for i in range(L):
                plane_sums[:, i] = np.bincount(
                    docs, weights=row_planes[:, i].astype(np.float64),
                    minlength=T).astype(np.int64)
            sum_planes = exact.carry_normalize_planes(plane_sums)
            # per-doc min/max in mono domain (rows are doc-ascending)
            offs = np.zeros(T + 1, np.int64)
            np.cumsum(cnt, out=offs[1:])
            monos = np.asarray(mono_mod.to_mono(
                self.ftype.value, self._orig_values), np.int64) if n \
                else np.zeros(0, np.int64)
            has = cnt > 0
            mn = np.full(T, self.min_mono, np.int64)
            mx = np.full(T, self.min_mono, np.int64)
            if n:
                # reduceat needs indices < len(operand), but offs reaches n
                # for every doc past the last value row. Clamping offs to
                # n-1 would chop the LAST valued doc's final value out of
                # its group (fuzz-found: its per-doc max came back as its
                # min) — append a duplicate of the last value instead so
                # index n is addressable and group boundaries stay exact
                # (the duplicate only ever joins the last valued doc's own
                # group; empty/padding groups are masked by `has`).
                ext = np.concatenate([monos, monos[-1:]])
                mn = np.where(has, np.minimum.reduceat(ext, offs[:-1]),
                              self.min_mono)
                mx = np.where(has, np.maximum.reduceat(ext, offs[:-1]),
                              self.min_mono)
            _, mnA, mnB = _mono_planes(mn, self.min_mono, self.span)
            _, mxA, mxB = _mono_planes(mx, self.min_mono, self.span)
            self._doc_preagg = {"cnt": cnt, "sum": sum_planes,
                                "minA": mnA, "minB": mnB,
                                "maxA": mxA, "maxB": mxB}
        return self._doc_preagg

    _preagg_bounds: Optional[dict] = None

    def preagg_bounds(self, T: int) -> dict:
        """STATIC (lo, hi) bounds of the doc_preagg planes, computed once
        from the host pre-aggregates (query-independent): 'cnt' for the
        per-doc value-count plane, 'sum' per carry-normalized limb plane.
        High limb planes of small-valued columns come back (0, 0) and are
        dropped from the int8 matmul operands entirely."""
        if self._preagg_bounds is None:
            pre = self.doc_preagg_host(T)
            s = pre["sum"]
            self._preagg_bounds = {
                "cnt": (0, int(pre["cnt"].max(initial=0))),
                "sum": [(int(s[:, i].min(initial=0)),
                         int(s[:, i].max(initial=0)))
                        for i in range(s.shape[1])],
            }
        return self._preagg_bounds

    # -- ordered layouts ------------------------------------------------------

    def _layout_cached(self, kind_key, build) -> "OrderedLayout":
        """Build-or-load an OrderedLayout through the cross-process prep
        cache (utils/prep_cache.py): the 10M-row stable argsorts cost
        seconds per layout and are pure functions of the index contents,
        so a warm serving restart skips them. [VERDICT r3 #7]"""
        prep = getattr(self, "_prep", None)
        if prep is None or prep[0] is None:
            return build()
        from ..utils import prep_cache as PC
        path, epoch, D = prep
        key = ("layout", self.name, kind_key)
        h = PC.load(path, epoch, D, key)
        if h is not None:
            vp = h["valid"]
            return OrderedLayout(
                perm=h["perm"], n_rows=int(h["perm"].shape[0]),
                bounds=h.get("bounds"),
                valid_perm=_put(vp, self._mesh, 1), valid_perm_host=vp,
                sorted_mono=h.get("sm"))
        lo = build()
        arrays = {"perm": lo.perm, "valid": lo.valid_perm_host}
        if lo.bounds is not None:
            arrays["bounds"] = lo.bounds
        if lo.sorted_mono is not None:
            arrays["sm"] = lo.sorted_mono
        PC.save(path, epoch, D, key, arrays)
        return lo

    def layout_for_ids(self, key: str, ids_host: np.ndarray,
                       card: int) -> OrderedLayout:
        """Cached OrderedLayout over arbitrary static per-row bucket ids
        (e.g. precomputed histogram buckets): rows sorted by id with
        32-aligned boundaries for prefix-difference reductions."""
        if self._bid_cache is None:
            self._bid_cache = {}
        lkey = ("layout", key)
        if lkey not in self._bid_cache:
            def build():
                ids = np.asarray(ids_host, np.int64)
                if self._host_valid is not None:
                    ids = np.where(self._host_valid, ids, -1)
                return _build_bucket_layout(ids.astype(np.int32), card,
                                            self._mesh)
            self._bid_cache[lkey] = self._layout_cached(("ids", key),
                                                        build)
        return self._bid_cache[lkey]

    def bucket_layout(self) -> OrderedLayout:
        """Rows sorted by bucket id with 32-aligned bucket boundaries, for
        prefix-difference terms aggs (unsharded path)."""
        if self._bucket_layout is None:
            def build():
                if self.ftype.is_stringy:
                    ids = np.where(self._host_valid,
                                   self._host_mono, -1).astype(I32)
                    card = max(1, len(self.terms))
                else:
                    self.term_ids()
                    ids = self._term_ids_host
                    card = self.card
                return _build_bucket_layout(ids, card, self._mesh)
            self._bucket_layout = self._layout_cached("bucket", build)
        return self._bucket_layout

    def global_doc_of_rows(self, T: int) -> np.ndarray:
        """CSR only: [V] int64 GLOBAL doc id per value row (the stored
        doc ids are shard-local; add each shard block's doc base). Lets
        permuted value-row views gather doc-aligned planes per row."""
        D = _mesh_D(self._mesh)
        V = self._host_doc.shape[0]
        base = (np.arange(V, dtype=np.int64) // (V // D)) * (T // D)
        return self._host_doc.astype(np.int64) + base

    def value_layout(self) -> OrderedLayout:
        """Rows (docs for dense columns, VALUE rows for CSR) sorted by value
        (mono order) for rank-selection percentiles. Sharded meshes sort PER
        SHARD chunk (the permutation never crosses shard boundaries — CSR
        value rows are already partitioned by owning shard); rank selection
        then runs as a cross-shard bisection over the static value domain
        (aggs/compile.py _eval_percentiles, pmode 'rank' + 'bisect')."""
        if self._value_layout is None:
            def build():
                m = self._host_mono
                valid = self._host_valid
                key = m.copy()
                if valid is not None:
                    key = np.where(valid, key, np.iinfo(np.int64).max)
                D = _mesh_D(self._mesh)
                n = key.shape[0]
                if D == 1:
                    perm = np.argsort(key, kind="stable").astype(I32)
                    R = _pad_to(n, PAD_BLOCK)
                    perm_p = np.zeros(R, I32)
                    perm_p[:n] = perm
                    vp = np.zeros(R, np.int8)
                    vp[:n] = (1 if valid is None
                              else valid[perm].astype(np.int8))
                    return OrderedLayout(
                        perm=perm_p, n_rows=R,
                        valid_perm=_put(vp, self._mesh, 1),
                        valid_perm_host=vp,
                        sorted_mono=key[perm],
                        sorted_mono_dev=None)
                # n is T (dense) or V (CSR value rows); both are multiples
                # of PAD_BLOCK * D and chunk-partitioned by owning shard
                chunk = n // D
                perm = np.concatenate([
                    s * chunk + np.argsort(key[s * chunk:(s + 1) * chunk],
                                           kind="stable")
                    for s in range(D)]).astype(I32)
                vp = (np.ones(n, np.int8) if valid is None
                      else valid[perm].astype(np.int8))
                return OrderedLayout(
                    perm=perm, n_rows=n,
                    valid_perm=_put(vp, self._mesh, 1),
                    valid_perm_host=vp,
                    sorted_mono=key[perm],
                    sorted_mono_dev=None)
            self._value_layout = self._layout_cached("value", build)
        return self._value_layout


def _mesh_D(mesh) -> int:
    return 1 if mesh is None else int(np.prod(mesh.devices.shape))


def _bucket_layout_chunk(ids: np.ndarray, card: int):
    """One shard's (perm positions, bounds) for a bucket-sorted layout:
    local row indices sorted by id, each bucket padded to a 32-row multiple
    so every bucket boundary is 32-aligned. Rows with id < 0 (missing) are
    excluded. Returns (local_perm_src, local_pos, bounds_raw[card+1])."""
    order = np.argsort(ids, kind="stable").astype(np.int64)
    sorted_ids = ids[order]
    start = int(np.searchsorted(sorted_ids, 0))
    order = order[start:]
    sorted_ids = sorted_ids[start:]
    counts = np.bincount(sorted_ids, minlength=card) if sorted_ids.size \
        else np.zeros(card, np.int64)
    padded = ((counts + ALIGN - 1) // ALIGN) * ALIGN
    bounds = np.zeros(card + 1, np.int64)
    np.cumsum(padded, out=bounds[1:])
    src_off = np.zeros(card + 1, np.int64)
    np.cumsum(counts, out=src_off[1:])
    pos = np.repeat(bounds[:-1], counts) + (
        np.arange(len(order)) - np.repeat(src_off[:-1], counts))
    return order, pos, bounds


def _build_bucket_layout(ids: np.ndarray, card: int, mesh) -> OrderedLayout:
    """Sort row indices by id with 32-aligned bucket boundaries (coarse
    prefix sums then resolve bounds exactly).

    Sharded meshes get a PER-SHARD layout (SURVEY.md §3.5 / VERDICT r1 #7):
    each shard's contiguous doc chunk is sorted independently, so the
    permutation never crosses shard boundaries — permuted planes shard over
    'd' like any doc-aligned column, per-bucket partials reduce shard-
    locally via the same 32-block prefix machinery, and ONE psum over the
    [card] partial vector is the only cross-chip traffic per bucket agg.
    `bounds` is [card+1] (unsharded) or [D, card+1] (per-shard local
    offsets, sharded over axis 0)."""
    D = _mesh_D(mesh)
    if D == 1:
        order, pos, bounds = _bucket_layout_chunk(ids, card)
        R = _pad_to(int(bounds[-1]), PAD_BLOCK)
        perm = np.zeros(R, I32)
        valid = np.zeros(R, np.int8)
        perm[pos] = order.astype(I32)
        valid[pos] = 1
        return OrderedLayout(perm=perm, n_rows=R,
                             bounds=(bounds // ALIGN).astype(I32),
                             valid_perm=_put(valid, mesh, 1),
                             valid_perm_host=valid)
    T = ids.shape[0]
    chunk = T // D
    parts = [_bucket_layout_chunk(ids[s * chunk:(s + 1) * chunk], card)
             for s in range(D)]
    # worst-case per-bucket ALIGN padding: chunk + card*ALIGN rows suffice
    # for every shard, so one static local length keeps shards rectangular
    R_loc = _pad_to(max(int(b[-1]) for _, _, b in parts), PAD_BLOCK)
    perm = np.zeros(D * R_loc, I32)
    valid = np.zeros(D * R_loc, np.int8)
    bounds = np.zeros((D, card + 1), np.int64)
    for s, (order, pos, b) in enumerate(parts):
        perm[s * R_loc + pos] = (order + s * chunk).astype(I32)
        valid[s * R_loc + pos] = 1
        bounds[s] = b
    return OrderedLayout(perm=perm, n_rows=D * R_loc,
                         bounds=(bounds // ALIGN).astype(I32),
                         valid_perm=_put(valid, mesh, 1),
                         valid_perm_host=valid)


@dataclass
class DeviceIndex:
    schema: Schema
    epoch: int
    T: int
    n_docs: int
    total_values: int
    columns: Dict[str, DeviceColumn]
    seg_starts: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    mesh: Optional[object] = None
    n_shards: int = 1
    #: host alive copy ([T] int8; 0 on padding and deleted docs)
    alive_host: Optional[np.ndarray] = None
    _alive_dev: Optional[jnp.ndarray] = None
    #: deferred per-column builders (name -> thunk); columns build on first
    #: access so cold start pays host prep + host->device copies only for
    #: fields a program actually touches
    _col_builders: Dict[str, object] = field(default_factory=dict)
    _max_addends: int = 1
    #: set-type query expansions (query/compile.py match_runs cache)
    set_query_runs: Dict[tuple, list] = field(default_factory=dict)
    #: on-disk index directory (None for RAM indexes) — the anchor of the
    #: cross-process prep cache (utils/prep_cache.py)
    path: Optional[str] = None

    @property
    def alive(self) -> jnp.ndarray:
        """[T] int8 device mask, copied to the device on first use."""
        if self._alive_dev is None:
            self._alive_dev = _put(self.alive_host, self.mesh)
        return self._alive_dev

    def column(self, name: str) -> DeviceColumn:
        col = self.columns.get(name)
        if col is not None:
            return col
        build = self._col_builders.get(name)
        if build is None:
            raise KeyError(f"field {name!r} not loaded (not FAST or unknown)")
        col = build()
        if col.ftype.is_numeric:
            _plan_sums(col, self._max_addends)
        # anchor for the cross-process layout cache (utils/prep_cache.py)
        col._prep = (self.path, self.epoch, self.n_shards)
        self.columns[name] = col
        return col

    def keyword_ord(self, field: str, term: str) -> int:
        col = self.column(field)
        i = int(np.searchsorted(col.terms, term))
        if i < len(col.terms) and col.terms[i] == term:
            return i
        return -1


def load_device_index(index, mesh=None) -> DeviceIndex:
    """Columns are DEFERRED: this registers a builder per fast field and
    returns immediately (alive mask + metadata only). Each column's host
    prep (concat, mono planes, CSR partition, dense multi planes) runs on
    its first `column()` access — cold start pays only for the fields the
    compiled programs actually touch."""
    schema: Schema = index.schema
    segments = index.segments
    if mesh is not None and tuple(mesh.axis_names) != ("d",):
        raise ValueError("mesh must have a single axis named 'd'")
    D = 1 if mesh is None else int(np.prod(mesh.devices.shape))
    n_docs = sum(s.max_doc for s in segments)
    T = _pad_to(max(n_docs, 1), PAD_BLOCK * D)

    alive = np.zeros(T, dtype=np.int8)
    pos = 0
    for s in segments:
        alive[pos:pos + s.max_doc] = s.alive_mask()
        pos += s.max_doc

    builders: Dict[str, object] = {}
    total_values = 0
    for entry in schema.fields:
        if not entry.fast:
            continue
        # per-field value count from CSR metadata alone (no value pass)
        nv = sum(int(s.fields[entry.name].values.shape[0]) for s in segments)
        total_values = max(total_values, nv)
        if entry.type.is_stringy:
            if entry.cardinality == Cardinality.SINGLE:
                builders[entry.name] = (
                    lambda e=entry: _load_keyword_dense(e, segments, T, mesh))
            else:
                builders[entry.name] = (
                    lambda e=entry: _load_csr(e, segments, T, D, mesh,
                                              keyword=True))
        elif any(s.fields[entry.name].offsets is not None for s in segments):
            builders[entry.name] = (
                lambda e=entry: _load_csr(e, segments, T, D, mesh,
                                          keyword=False))
        else:
            builders[entry.name] = (
                lambda e=entry: _load_numeric_single(e, segments, T, mesh))

    if max(total_values, n_docs) >= exact.MAX_ADDENDS:
        raise ValueError("index exceeds the exact-sum addend bound (2^36)")

    seg_starts = (np.cumsum([0] + [s.max_doc for s in segments])[:-1]
                  if segments else np.zeros(1))
    return DeviceIndex(schema=schema, epoch=index.epoch, T=T, n_docs=n_docs,
                       total_values=total_values, columns={},
                       seg_starts=np.asarray(seg_starts, np.int64),
                       mesh=mesh, n_shards=D, alive_host=alive,
                       _col_builders=builders,
                       _max_addends=max(total_values, n_docs),
                       path=getattr(index, "path", None))


def _plan_sums(col: DeviceColumn, max_addends: int) -> None:
    guard_bits = max(1, max_addends).bit_length()
    if col.ftype == FieldType.F64:
        col.sum_direct = False
        real = col._host_values if col._host_valid is None \
            else col._host_values[col._host_valid]
        base, n_limbs = exact.f64_sum_plan(real) if real.size else (1, 1)
        col.f64_base_exp, col.sum_n_limbs = base, n_limbs
    else:
        bits = max(1, int(col.span).bit_length())
        # direct = the narrow w plane itself is the exact addend
        col.sum_direct = col.narrow
        col.sum_n_limbs = (bits + exact.LIMB_BITS - 1) // exact.LIMB_BITS


def _w_u64(m: np.ndarray, min_mono: int) -> np.ndarray:
    """Exact unsigned offset w = mono - min_mono (wraparound u64)."""
    base = np.array(min_mono, np.int64).view(np.uint64)
    return m.view(np.uint64) - base


def _mono_planes(m: np.ndarray, min_mono: int, span: int):
    """int64 mono values -> (narrow?, w | (hi, lo)) int32 planes."""
    wu = _w_u64(m, min_mono)
    if span <= NARROW_MAX_SPAN:
        return True, wu.astype(np.int64).astype(I32), None
    hi, lo = _split_wide(wu)
    return False, hi, lo


def _load_numeric_single(entry, segments, T, mesh) -> DeviceColumn:
    from .segment import numeric_dtype
    parts = [s.fields[entry.name].values for s in segments]
    vals = (np.concatenate(parts) if parts
            else np.zeros(0, dtype=numeric_dtype(entry.type)))
    m = np.asarray(mono_mod.to_mono(entry.type.value, vals), dtype=np.int64)
    n = m.shape[0]
    min_mono = int(m.min()) if n else 0
    max_mono = int(m.max()) if n else 0
    span = ((max_mono - min_mono) % 2**64) if n else 0
    mono_p = np.full(T, min_mono, np.int64)
    mono_p[:n] = m
    host = np.zeros(T, dtype=vals.dtype if n else np.float64)
    host[:n] = vals
    if n:
        host[n:] = mono_mod.from_mono(entry.type.value,
                                      np.full(T - n, min_mono, np.int64))
    hvalid = np.zeros(T, bool)
    hvalid[:n] = True
    narrow, a, b = _mono_planes(mono_p, min_mono, span)
    col = DeviceColumn(
        name=entry.name, ftype=entry.type, multi=False, narrow=narrow,
        min_mono=min_mono, max_mono=max_mono, span=span, n_values=n,
        _mesh=mesh, _host_values=host, _host_valid=hvalid, _host_mono=mono_p)
    if narrow:
        col._w_host = a
    else:
        col._hi_host, col._lo_host = a, b
    return col


def _load_keyword_dense(entry, segments, T, mesh) -> DeviceColumn:
    """Single-cardinality keyword -> dense int32 global-ordinal column."""
    name = entry.name
    gterms = sorted(set().union(*[set(s.fields[name].terms or [])
                                  for s in segments])) if segments else []
    gterms = np.asarray(gterms, dtype=object)
    ords = np.full(T, -1, I32)
    base = 0
    for s in segments:
        fd = s.fields[name]
        local = np.asarray(fd.terms or [], dtype=object)
        remap = (np.searchsorted(gterms, local).astype(I32)
                 if len(local) else np.zeros(0, I32))
        offs = fd.offsets.astype(np.int64)
        has = np.diff(offs) > 0
        docs = np.nonzero(has)[0]
        ords[base + docs] = remap[fd.values[offs[:-1][has]].astype(np.int64)]
        base += s.max_doc
    n = int((ords >= 0).sum())
    col = DeviceColumn(
        name=name, ftype=entry.type, multi=False, narrow=True,
        terms=gterms, n_values=n, _mesh=mesh,
        _host_mono=ords.astype(np.int64), _host_valid=ords >= 0)
    col._w_host = ords
    return col


def _load_csr(entry, segments, T, D, mesh, keyword: bool) -> DeviceColumn:
    from .segment import numeric_dtype
    name = entry.name
    if keyword:
        gterms = sorted(set().union(*[set(s.fields[name].terms or [])
                                      for s in segments])) if segments else []
        gterms = np.asarray(gterms, dtype=object)
    vals_parts, doc_parts = [], []
    doc_base = 0
    for s in segments:
        fd = s.fields[name]
        offs = fd.offsets.astype(np.int64)
        reps = np.diff(offs)
        doc_of_val = np.repeat(np.arange(s.max_doc, dtype=np.int64), reps)
        if keyword:
            local = np.asarray(fd.terms or [], dtype=object)
            remap = (np.searchsorted(gterms, local).astype(np.int64)
                     if len(local) else np.zeros(0, np.int64))
            vals_parts.append(remap[fd.values.astype(np.int64)])
        else:
            vals_parts.append(fd.values)
        doc_parts.append(doc_of_val + doc_base)
        doc_base += s.max_doc
    if keyword:
        vals = (np.concatenate(vals_parts) if vals_parts
                else np.zeros(0, np.int64))
        m = vals.astype(np.int64)
    else:
        vals = (np.concatenate(vals_parts) if vals_parts
                else np.zeros(0, dtype=numeric_dtype(entry.type)))
        m = np.asarray(mono_mod.to_mono(entry.type.value, vals), np.int64)
    docs = (np.concatenate(doc_parts) if doc_parts
            else np.zeros(0, np.int64))
    n = m.shape[0]
    min_mono = int(m.min()) if n else 0
    max_mono = int(m.max()) if n else 0
    span = ((max_mono - min_mono) % 2**64) if n else 0
    if keyword:
        min_mono, max_mono, span = 0, max_mono, int(max_mono)

    chunk = T // D
    shard_of_row = docs // chunk if n else docs
    counts = np.bincount(shard_of_row.astype(np.int64), minlength=D) \
        if n else np.zeros(D, np.int64)
    Vp = _pad_to(int(counts.max()) if n else 1, PAD_BLOCK)
    V = D * Vp
    mono_out = np.full(V, min_mono, np.int64)
    doc_out = np.zeros(V, I32)
    valid_out = np.zeros(V, bool)
    host_out = np.zeros(V, np.int64 if keyword else
                        (vals.dtype if n else np.float64))
    if not keyword and n:
        host_out[:] = mono_mod.from_mono(entry.type.value,
                                         np.full(V, min_mono, np.int64))
    start = 0
    for d in range(D):
        c = int(counts[d])
        sel = slice(start, start + c)
        o = d * Vp
        mono_out[o:o + c] = m[sel]
        doc_out[o:o + c] = (docs[sel] - d * chunk).astype(I32)
        valid_out[o:o + c] = True
        host_out[o:o + c] = vals[sel]
        start += c
    col = DeviceColumn(
        name=name, ftype=entry.type, multi=True,
        terms=gterms if keyword else None,
        min_mono=min_mono, max_mono=max_mono, span=span, n_values=n,
        _mesh=mesh, _host_values=host_out, _host_valid=valid_out,
        _host_mono=mono_out, _host_doc=doc_out,
        _orig_docs=docs.astype(np.int64), _orig_values=vals)
    col._valid8_host = valid_out.astype(np.int8)
    if keyword:
        col.narrow = True
        col._w_host = np.where(valid_out, mono_out, -1).astype(I32)
    else:
        narrow, a, b = _mono_planes(mono_out, min_mono, span)
        col.narrow = narrow
        if narrow:
            col._w_host = a
        else:
            col._hi_host, col._lo_host = a, b

    # doc-aligned dense planes for narrow/keyword multi fields (value
    # positions 0..DENSE_MULTI_K-1), plus a sparse overflow tail for docs
    # with more values — term/range doc masks are pure plane compares plus
    # a scatter-or over only the tail rows (usually none)
    if col.narrow or keyword:
        cnt = np.bincount(docs, minlength=T) if n else np.zeros(T, np.int64)
        kmax = int(cnt.max()) if n else 0
        if keyword:
            wvals = m.astype(np.int64)  # global ords
        else:
            wvals = _w_u64(m, min_mono).astype(np.int64)
        offs_g = np.zeros(T + 1, np.int64)
        np.cumsum(cnt, out=offs_g[1:])
        planes_host = []
        for k in range(max(min(kmax, DENSE_MULTI_K), 1)):
            pk = np.full(T, -1, np.int64)
            has = cnt > k
            pk[has] = wvals[offs_g[:-1][has] + k]
            planes_host.append(pk.astype(I32))
        col.multi_planes_host = planes_host
        if kmax > DENSE_MULTI_K:
            # overflow rows: value positions >= DENSE_MULTI_K of each doc
            pos_in_doc = np.arange(n, dtype=np.int64) - offs_g[:-1][docs]
            sel = pos_in_doc >= DENSE_MULTI_K
            t_docs = docs[sel]
            t_w = wvals[sel].astype(I32)
            tw, tdoc, tvalid = _shard_partition_csr(
                t_w, t_docs, T, D, fill=np.int32(-1))
            col._tail_w_host = tw
            col._tail_doc_host = tdoc
            col._tail_valid8_host = tvalid.astype(np.int8)
    else:
        # doc-aligned dense planes for WIDE multi fields: per position a
        # lexicographic (hi, lo) int32 pair (same rm-domain split as the
        # single-valued wide planes, so the SAME wide query params compare
        # against them) + a shared value-count plane as the validity guard
        # (any (hi, lo) pair is an attainable value — no -1 sentinel). Same
        # overflow-tail contract as the narrow planes above.
        cnt = np.bincount(docs, minlength=T) if n else np.zeros(T, np.int64)
        kmax = int(cnt.max()) if n else 0
        wv_u64 = _w_u64(m, min_mono)
        offs_g = np.zeros(T + 1, np.int64)
        np.cumsum(cnt, out=offs_g[1:])
        planes_wide = []
        for k in range(max(min(kmax, DENSE_MULTI_K), 1)):
            hp = np.zeros(T, I32)
            lp = np.zeros(T, I32)
            has = cnt > k
            hk, lk = _split_wide(wv_u64[offs_g[:-1][has] + k])
            hp[has] = hk
            lp[has] = lk
            planes_wide.append((hp, lp))
        col.multi_planes_wide_host = planes_wide
        col._mpn_host = np.minimum(cnt, 2**31 - 1).astype(I32)
        if kmax > DENSE_MULTI_K:
            pos_in_doc = np.arange(n, dtype=np.int64) - offs_g[:-1][docs]
            sel = pos_in_doc >= DENSE_MULTI_K
            t_docs = docs[sel]
            # partition INDICES once so both planes share the row order
            tidx, tdoc, tvalid = _shard_partition_csr(
                np.flatnonzero(sel), t_docs, T, D, fill=np.int64(0))
            th, tl = _split_wide(np.where(tvalid, wv_u64[tidx],
                                          np.uint64(0)))
            col._tail_hi_host = th
            col._tail_lo_host = tl
            col._tail_doc_host = tdoc
            col._tail_valid8_host = tvalid.astype(np.int8)
    return col


def _shard_partition_csr(vals: np.ndarray, docs: np.ndarray, T: int, D: int,
                         fill):
    """Partition CSR rows by owning shard (doc // (T/D)), pad each shard's
    slice to a common PAD_BLOCK multiple, localize doc ids. Returns
    (vals [V], doc [V] int32 shard-local, valid [V] bool)."""
    n = vals.shape[0]
    chunk = T // D
    shard_of_row = docs // chunk if n else docs
    counts = (np.bincount(shard_of_row.astype(np.int64), minlength=D)
              if n else np.zeros(D, np.int64))
    Vp = _pad_to(int(counts.max()) if n else 1, PAD_BLOCK)
    V = D * Vp
    vals_out = np.full(V, fill, dtype=vals.dtype)
    doc_out = np.zeros(V, I32)
    valid_out = np.zeros(V, bool)
    order = np.argsort(shard_of_row, kind="stable") if n else \
        np.zeros(0, np.int64)
    start = 0
    for d in range(D):
        c = int(counts[d])
        sel = order[start:start + c]
        o = d * Vp
        vals_out[o:o + c] = vals[sel]
        doc_out[o:o + c] = (docs[sel] - d * chunk).astype(I32)
        valid_out[o:o + c] = True
        start += c
    return vals_out, doc_out, valid_out
