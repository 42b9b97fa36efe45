"""Agg-tree compiler v2: IR -> one fused jitted device program + host harvest.

Device replacement for the reference's Agg/PreparedAgg/SegmentAgg triple
(SURVEY.md §2.1 C2, §3.1): `plan` resolves fields and picks an execution
MODE per node from static index metadata; the traced function evaluates the
whole tree as masked/bucketed reductions; `harvest` reconstructs exact
user-domain fruits (bit-identical to the oracle).

Execution modes (selected per node at plan time; see ops/reductions.py for
the formulations):

- metrics: two-stage exact reductions over int32 planes; multi-valued
  fields reduce STATIC per-doc pre-aggregates in doc space (no per-query
  value-row gathers).
- histogram / small-cardinality terms ("dense"): blocked one-hot
  compare-reduce, composite slots for nesting (nb_flat <= DENSE_NB).
  MaskCtx-rooted dense nodes (static bucket-id planes) ride chunked int8
  matmuls instead (ops/reductions.py dense_bucket_*_mxu): the one-hot /
  7-bit-piece right operand is query-independent, so an msearch batch
  shares it and the per-query work becomes one batched dot.
- high-cardinality terms ("prefix"): bucket-sorted OrderedLayout; the query
  mask is evaluated directly in permuted space over cached permuted column
  planes; per-bucket totals come from 32-block sums + a small int64 cumsum
  + bounds-gather differences. No sort, no scatter, no big gather. Sharded
  meshes use PER-SHARD layouts (permutations never cross shards) and psum
  the [card] partial vectors — the only cross-chip traffic per bucket agg.
- percentiles ("rank"): value-sorted OrderedLayout + coarse prefix counts;
  rank rows are resolved in a tiny second-phase program and mapped to
  values on the host. Sharded meshes select by BISECTING the value domain
  against per-shard sorted planes (_bisect_select_values) — no all-gather,
  no sort, O(log span) tiny psums; sharded non-integer percents resolve
  through the same phase-2 cross-shard bisection over (cum32, vmask)
  intermediates. Multi-valued (CSR) fields rank-select over VALUE-ROW
  layouts (every value is a row; the query mask is gathered per row's
  owning doc), so they ride the same rank/bisect paths. NON-DENSE query
  chains (CSR overflow tails / token streams among the query fields) take
  the doc mask through a static perm∘row_doc index plane ("mask_gather")
  and then the same rank/bisect selection — there is no sort lowering.
- "scatter" fallback for everything else (XLA:CPU executes scatters well).
- value-domain CUBE (ops/cube.py, EngineConfig.use_cube): trees whose
  parameterized query chain lives on small single-valued domains answer
  root-level counts/metrics/filter counts, dense bucket aggs (histogram /
  small-card terms with Count/Sum/Avg subs), and flat integer-percent rank
  prefixes from exact [Dprod]-cell pre-aggregates via int8 matmuls —
  no per-query row pass at all. An exact regrouping of the same integer
  addends: bit-identical by construction. Sharded meshes build PER-SHARD
  operand stacks and psum the dot vectors (round 5), so the exactness
  bound is per-shard rows and global index size is unbounded.

Nesting compiles to composite bucket slots (SURVEY.md §7 step 4), including
percentiles/top_hits under bucket aggs (slot_rank / in-slot sort paths);
sharded meshes select nested percentiles by per-slot cross-shard bisection
and nested top_hits by per-shard top-k + one [ns, D*k] merge sort.
Remaining device limits route to the exact host fallback via
NotImplementedError at plan time (searcher._HostFallback): non-integer
percents under bucket aggs on a sharded mesh, more than one level of
multi-valued bucket nesting (one level lowers via the static cross-product
expansion — _build_xpand), in-slot top_hits over huge (>4096) flat bucket
spaces, and histograms whose column-span bucket count exceeds
MAX_HIST_NB_HOST (the host applies the realized-span ceiling — the one
refusal condition, defined in oracle/engine.py::_check_hist_span).
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..aggs import ir as A
from ..query import compile as qc
from ..query import ir as Q
from ..schema import FieldType
from ..ops import reductions as R
from ..utils import exact, mono as mono_mod

I32 = jnp.int32
I64 = jnp.int64
I64_MAX = 2**63 - 1
MAX_TERMS_CARD = 1 << 27
MAX_HIST_NB = 1 << 20  # f64 bucket-layout bound (host boundary list is O(nb))
MAX_HIST_NB_HOST = 1 << 24  # columns spanning more buckets than this skip
# device planning entirely (host path); the oracle then refuses iff the
# REALIZED matched span exceeds 2^24 (oracle/engine.py::_check_hist_span) —
# a filtered query over a wide column is still answered
DENSE_NB = 256  # one-hot bucket budget (O(rows * nb) VPU work)


def _wrap64(x: int) -> int:
    return ((x + 2**63) % 2**64) - 2**63


@dataclass
class MaskCtx:
    mask: object  # [T] bool
    chain: tuple  # ((query, param path), ...) incl. root; for permuted views


@dataclass
class SlotCtx:
    bid: object          # [rows] int32 flat composite slot (<0 = no slot)
    valid: object        # [rows] bool
    dims: Tuple[int, ...]
    rows_are_docs: bool  # payload planes align with rows directly
    doc: object          # [rows] int32 doc per row (None iff rows_are_docs)
    mode: str            # "dense" | "scatter"
    slot_of_doc: object = None
    slot_valid_of_doc: object = None
    #: bid is a query-independent resident plane (MaskCtx-rooted dense
    #: nodes) -> counts/sums may use the int8 matmul formulation, whose
    #: right-hand operand must be unbatched under vmap to be worthwhile
    bid_static: bool = False

    @property
    def nslots(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n


def _iter_set_queries(query, aggs):
    """Yield every set-type query node (TermSet/Fuzzy/Regex) reachable from
    the outer query and the agg tree's filter/post_filter queries."""
    def walk_q(q):
        if isinstance(q, (Q.TermSetQuery, Q.FuzzyTermQuery, Q.RegexQuery)):
            yield q
        elif isinstance(q, Q.BooleanQuery):
            for c in (*q.must, *q.should, *q.must_not):
                yield from walk_q(c)

    def walk_a(node):
        if isinstance(node, dict):
            for v in node.values():
                yield from walk_a(v)
            return
        if isinstance(node, (A.FilterAgg, A.PostFilterAgg)):
            yield from walk_q(node.query)
        for _, sub in getattr(node, "sub_aggs", ()):
            yield from walk_a(sub)

    yield from walk_q(query)
    yield from walk_a(aggs)


class Program:
    def __init__(self, dindex, query: Q.Query, aggs: Dict[str, A.Agg],
                 config=None):
        from ..engine_config import EngineConfig
        A.validate_agg_tree(dindex.schema, aggs)
        # set-type queries: prepare-time type/param validation (TypeError/
        # ValueError, matching the oracle). Run-count overflow is NOT a
        # construction error — the program's run-slot shape is valid for
        # every fitting same-shape request; the searcher's accepts() gate
        # routes individual overflowing requests to the exact host path.
        from ..utils import termmatch
        self._set_shape = False
        for n in _iter_set_queries(query, aggs):
            self._set_shape = True
            termmatch.check_set_query_field(dindex.schema.field(n.field).type,
                                            n)
        self.dindex = dindex
        self.query = query
        self.aggs = aggs
        self.config = config or EngineConfig()
        self.dense_nb = self.config.dense_nb
        self._sharded = dindex.mesh is not None
        self.plan: Dict[tuple, dict] = {}
        #: nearest multi-valued bucket ancestor whose VALUE ROWS form the
        #: current row space during planning (None = doc-rooted;
        #: "__deep__" = an expansion already re-based the row space)
        self._mparent = None
        self._arrays: Dict[str, object] = {"alive": dindex.alive}
        self._root_chain = ((query, ("q",)),)
        self._plan_aggs(aggs, ("a",), in_slot=False, parent_single=True,
                        hdims=(), tflat=1, chain=self._root_chain,
                        bchain=())
        self._collect_query_arrays(query)

        def fn(params, arrays):
            # int64 appears only in traced ops (never in stored columns);
            # x64 is scoped here, never global
            with jax.enable_x64(True):
                self._lT = arrays["alive"].shape[0]
                self._ind_cache = {}  # per-trace cube indicator memo
                mask = qc.eval_mask(query, dindex, params, ("q",), self._lT,
                                    arrays) & (arrays["alive"] > 0)
                ctx = MaskCtx(mask, self._root_chain)
                out = {name: self._eval(agg, ctx, params, arrays,
                                        ("a", name))
                       for name, agg in aggs.items()}
                # pack every small fruit leaf into ONE int64 vector: one
                # device->host copy per group instead of one per leaf
                return self._pack_outputs(out, aggs)

        if self._sharded:
            from jax.sharding import PartitionSpec as P
            # cube operands are PER-SHARD [S, ...] stacks ("CUBEP#" keys)
            # that ride the default row-shard spec like any plane; every
            # other resident array is a row-sharded plane too
            arr_specs = {k: (P() if k.startswith("CUBE#")
                             else P("d", *([None] * (v.ndim - 1))))
                         for k, v in self._arrays.items()}
            # packed fruits are replicated (psum/all-gather merged); the
            # only per-shard outputs are non-integer-percent percentile
            # prefix intermediates (cum32, vmask_perm), resolved by the
            # phase-2 cross-shard bisection
            big_specs = {}
            for path, pp in self.plan.items():
                if not (isinstance(pp, dict)
                        and pp.get("kind") == "percentiles"):
                    continue
                if pp["pmode"] == "rank" and not pp["int_percents"]:
                    big_specs["/".join(path)] = (P("d"), P("d"))
                elif pp["pmode"] == "slot_rank" \
                        and not pp["int_percents"]:
                    # per-shard (cum [R/32, ns], vm [R], slot [R])
                    big_specs["/".join(path)] = (P("d"), P("d"), P("d"))
            fn = jax.shard_map(fn, mesh=dindex.mesh,
                               in_specs=(P(), arr_specs),
                               out_specs={"packed": P(), "big": big_specs},
                               check_vma=False)
        self.raw_fn = fn
        self._fn = jax.jit(fn)
        self._fn_vmapped = None  # lazily compiled msearch variant
        self._vm_keys = None  # (scalar-packed, passthrough) param keys
        self._zero_pvec = {}  # batch size -> cached [B, 1] zeros operand
        self.batch_cap = self._batch_cap()
        self._defer_topk = 0  # >0 while tracing inside a plane fan-out

    # ======================================================================
    # public
    # ======================================================================

    #: HBM headroom an msearch batch's per-query row-axis state may occupy
    #: (the resident columns + layouts live in the remaining HBM)
    _BATCH_MEM_BUDGET = 4 << 30
    #: slot_rank flat-slot-space admission above the dense budget: slot
    #: count cap and the byte budget for the XLA path's [R/32, ns] cum
    #: state (see _plan_percentiles' big-slot-space gate)
    PCT_SLOT_CAP = 4096
    _BIG_SLOT_MEM = 256 << 20

    def _batch_cap(self):
        """Program-specific msearch group bound, or None (no per-query
        row-axis residency worth capping). The rare per-slot selection
        paths keep O(rows)-sized state per batched query alive through
        selection — slot planes (slot_rank), 3-key sort buffers (in-slot
        top_hits) — so the group must shrink as rows grow or a 10M-row
        batch would exhaust HBM."""
        per_q = 0  # SUM over nodes: XLA liveness may keep several
        # subtrees' [rows] intermediates alive at once in one program
        for p in self.plan.values():
            if not isinstance(p, dict):
                continue
            kind = p.get("kind")
            if kind == "percentiles" and p.get("pmode") == "slot_rank":
                rows = p["layout"].n_rows
                if p.get("scube") is not None:
                    # only the [ns, R/G] counts + cumsum stay live
                    per_q += (rows // p["scube"]["G"]) * p["nslots"] * 8
                else:
                    per_q += rows * (9 + p["nslots"] // 4)
                    if p.get("wslots"):
                        # K [R] int32 composite slot planes stay live
                        per_q += rows * 4 * len(p["mterms"]["keys"])
            elif kind == "percentiles" and p.get("pmode") == "rank" \
                    and p.get("pcube") is not None:
                # cube rank prefix: only the [R/G] counts + cumsum live
                per_q += (p["layout"].n_rows // p["pcube"]["G"]) * 8
            elif kind == "percentiles" and p.get("pmode") == "rank":
                # mask-gather mode adds the [R] int32 take result
                per_q += p["layout"].n_rows * \
                    (7 if p.get("mask_gather") else 3)
            elif kind in ("terms", "histogram") and p.get("mask_gather"):
                # bucket mask-gather keeps the [R] int32 take + vm live
                per_q += p["layout"].n_rows * 7
            elif kind == "top_hits" and p.get("in_slot"):
                per_q += self.dindex.T * 50
        if per_q == 0:
            return None
        cap = max(1, self._BATCH_MEM_BUDGET // per_q)
        b = 1
        while b * 2 <= cap:  # power of two: stable vmapped jit shapes
            b *= 2
        return b

    def accepts(self, query, aggs) -> bool:
        """True when this program can answer `query` exactly: a same-shape
        request whose set-type query expansions (if any) fit the compiled
        run slots. The searcher routes rejected requests to the exact host
        path without evicting the program."""
        if not self._set_shape:
            return True
        return Program.accepts_on(self.dindex, query, aggs)

    @staticmethod
    def accepts_on(dindex, query, aggs) -> bool:
        for n in _iter_set_queries(query, aggs):
            if len(qc.match_runs(dindex, n)) > Q.run_slots(n):
                return False
        return True

    def run(self, query, aggs):
        return self.finalize(self.submit(query, aggs), aggs)

    def scan_bytes(self) -> int:
        """Bytes of resident ROW-EXTENT device data this program's plan
        references — the per-query HBM traffic of a one-pass row
        formulation (the information-theoretic scan bound a masked-column
        engine pays per request). The bench divides this by measured
        stream time to report EFFECTIVE scan bandwidth against the HBM
        roofline: ~100% means the row pass runs at speed of light; >100%
        means the engine beats the scan bound outright (value-domain
        cubes answer without the row pass; batched matmul
        formulations amortize one pass across an msearch group). Static
        batch-shared operands (cube sites, block histograms) are
        excluded — they are not per-query traffic."""
        total = 0
        for k, v in self._arrays.items():
            if k.startswith(("CUBE#", "CUBEP#", "PCUBE#", "SCUBE#",
                             "MOP#")):
                # static batch-shared / sliced-per-query operands, not
                # per-query row traffic (a member block operand reads one
                # ~W-byte row per query)
                continue
            total += int(np.prod(v.shape)) * v.dtype.itemsize
        return total

    def example_inputs(self):
        """(params, arrays) for this program's own (query, aggs) pair —
        valid example arguments for raw_fn / the jitted _fn."""
        params = qc.extract_params(self.query, self.dindex)
        self._extract_filter_params(self.aggs, ("a",), params)
        return params, self._arrays

    def as_callable(self):
        """(raw_fn, example_args): the full fused device step as a plain
        jittable function plus example inputs (driver compile checks)."""
        return self.raw_fn, self.example_inputs()

    def submit(self, query, aggs):
        params = qc.extract_params(query, self.dindex)
        self._extract_filter_params(aggs, ("a",), params)
        return self._fn(params, self._arrays)

    def param_key(self, query, aggs):
        """Canonical hashable key of a request's extracted device params.
        A compiled program is a pure function of (params, resident
        arrays), so equal keys imply bit-identical fruits — the msearch
        driver uses this to compute repeated queries of a serving group
        ONCE (searcher._submit_group)."""
        params = qc.extract_params(query, self.dindex)
        self._extract_filter_params(aggs, ("a",), params)

        def sc(v):
            try:
                return int(v)
            except (TypeError, ValueError):
                return np.asarray(v).tobytes()

        return tuple(sorted((k, sc(v)) for k, v in params.items()))

    # -- msearch: B same-shape queries in ONE device dispatch ---------------
    # (Elasticsearch Multi-Search parity; also the serving-throughput mode —
    # column passes are shared across the batch, and the per-dispatch cost
    # is paid once instead of B times.)

    def submit_many(self, queries, aggs, pad_to=None):
        plist = []
        for q in queries:
            params = qc.extract_params(q, self.dindex)
            self._extract_filter_params(aggs, ("a",), params)
            plist.append(params)
        if pad_to is not None:
            while len(plist) < pad_to:  # avoid a jit entry per batch size
                plist.append(plist[-1])
        if self._fn_vmapped is None:
            # Pack every int32 SCALAR param into one [B, P] device array:
            # a batch pushes ONE param array, not one per param key
            # (w-domain scalars, query/compile.py). Non-scalar params
            # (set-query run tables) stay their own stacked arrays — rare,
            # and their shapes are program-structural.
            p0 = plist[0]
            sk = tuple(sorted(k for k in p0 if np.ndim(p0[k]) == 0
                              and np.asarray(p0[k]).dtype == np.int32))
            ok = tuple(sorted(k for k in p0 if k not in sk))
            self._vm_keys = (sk, ok)
            raw_fn = self.raw_fn

            def packed_fn(pvec, others, arrays):
                params = {k: pvec[i] for i, k in enumerate(sk)}
                params.update(others)
                return raw_fn(params, arrays)

            self._fn_vmapped = jax.jit(jax.vmap(packed_fn,
                                                in_axes=(0, 0, None)))
        sk, ok = self._vm_keys
        if not sk:
            # param-less batch (match-all shapes): the [B, 1] zeros operand
            # never changes — cache it per batch size so serving groups
            # skip the host->device copy
            pv = self._zero_pvec.get(len(plist))
            if pv is None:
                pv = self._zero_pvec[len(plist)] = jnp.zeros(
                    (len(plist), 1), I32)
        else:
            pvec = np.zeros((len(plist), len(sk)), np.int32)
            for b, p in enumerate(plist):
                for i, k in enumerate(sk):
                    pvec[b, i] = p[k]
            pv = jnp.asarray(pvec)
        others = {k: jnp.asarray(np.stack([p[k] for p in plist]))
                  for k in ok}
        return self._fn_vmapped(pv, others, self._arrays)

    def stage(self, raw, aggs):
        """Start the async device->host copy of the ONE packed fruit vector
        (hides the transfer round trip behind subsequent dispatches;
        everything small is packed into a single int64 vector inside the
        traced program)."""
        packed, big = self.fetch_strip(aggs, raw)
        if hasattr(packed, "copy_to_host_async"):
            packed.copy_to_host_async()
        return packed, big

    def finalize_many(self, raw, aggs, B: int, staged=None):
        packed, big = (staged if staged is not None
                       else self.fetch_strip(aggs, raw))  # packed: [Bpad, F]
        vecs = np.asarray(jax.device_get(packed))
        hosts = [self._unpack_host(vecs[b]) for b in range(B)]
        if big:
            # batch the phase-2 rank/take gathers across all B queries
            gathers = {}
            for path, dev in big.items():
                p = self.plan[path]
                bpad = (dev[0] if isinstance(dev, tuple) else dev).shape[0]
                if p["pmode"] == "slot_rank":
                    rks = [self._slot_ranks(p, self._node_at(hosts[b], path))
                           for b in range(B)]
                    while len(rks) < bpad:
                        rks.append(rks[-1])
                    with jax.enable_x64(True):
                        rk = jnp.asarray(np.stack(rks), I64)
                    if p.get("wslots"):
                        cum, wms = dev
                        gathers[path] = _wslot_rank_select_batch(cum, wms,
                                                                 rk)
                    elif p.get("phase2_vals"):
                        cum, vm8, slot32 = dev
                        fn, planes = self._slot_bisect_phase2(path, p, True)
                        gathers[path] = fn(cum, vm8, slot32, rk, planes)
                    else:
                        cum, vm8, slot32 = dev
                        gathers[path] = _slot_rank_select_batch(cum, vm8,
                                                                slot32, rk)
                    continue
                rk = []
                for b in range(B):
                    node_host = self._node_at(hosts[b], path)
                    m = int(node_host["m"])
                    fracs, ranks = [], []
                    for q in p["percents"]:
                        lo, hi, fr = ((0, 0, 0.0) if m == 0
                                      else exact.percentile_rank(q, m))
                        fracs.append(fr)
                        ranks.extend([lo, hi])
                    node_host["_fracs"] = fracs
                    rk.append(ranks)
                while len(rk) < bpad:  # batch padding (pow-2 jit shapes)
                    rk.append(rk[-1])
                with jax.enable_x64(True):
                    ranks = jnp.asarray(rk, I64)  # [Bpad, 2P]
                if p.get("bisect"):
                    cum32, vm = dev
                    fn, planes = self._bisect_phase2(path, p, True)
                    gathers[path] = fn(cum32, vm, ranks, planes)
                else:
                    cum32, vm = dev
                    gathers[path] = jax.vmap(_rank_select)(cum32, vm,
                                                           ranks)
            got = jax.device_get(gathers)
            for path, vals in got.items():
                for b in range(B):
                    self._node_at(hosts[b], path)["pvals"] = vals[b]
        return [self.harvest_host(h, aggs) for h in hosts]

    def finalize(self, raw, aggs, staged=None):
        packed, big = (staged if staged is not None
                       else self.fetch_strip(aggs, raw))
        host = self._unpack_host(np.asarray(jax.device_get(packed)))
        gathers = self.percentile_gathers(host, big)
        if gathers:
            self.attach_percentiles(host, jax.device_get(gathers))
        return self.harvest_host(host, aggs)

    def harvest_host(self, host, aggs):
        return {name: self._harvest(agg, host[name], ("a", name), None)
                for name, agg in aggs.items()}

    # ======================================================================
    # merges (cross-shard collectives; no-ops on one chip)
    # ======================================================================

    def _madd(self, x):
        return jax.lax.psum(x, "d") if self._sharded else x

    def _mmin(self, x):
        if not self._sharded:
            return x
        return jnp.min(jax.lax.all_gather(x, "d", tiled=False), axis=0)

    def _mmax(self, x):
        if not self._sharded:
            return x
        return jnp.max(jax.lax.all_gather(x, "d", tiled=False), axis=0)

    # ======================================================================
    # planning
    # ======================================================================

    def _col(self, field):
        return self.dindex.column(field)

    def _need(self, key, arr):
        self._arrays[key] = arr

    def _need_col_planes(self, col):
        if col.narrow or col.ftype.is_stringy:
            self._need(f"{col.name}:w", col.w)
        else:
            self._need(f"{col.name}:hi", col.hi)
            self._need(f"{col.name}:lo", col.lo)
        if col.multi:
            self._need(f"{col.name}:doc", col.doc_id)
            self._need(f"{col.name}:valid", col.valid)
            if col.has_multi_planes:
                for kk, pk in enumerate(col.multi_planes):
                    self._need(f"{col.name}:mp{kk}", pk)
            if col.has_multi_planes_wide:
                for kk, (ph, pl) in enumerate(col.multi_planes_wide):
                    self._need(f"{col.name}:mph{kk}", ph)
                    self._need(f"{col.name}:mpl{kk}", pl)
                self._need(f"{col.name}:mpn", col.mpn)
            if col.has_tail:
                if col.has_multi_planes_wide:
                    self._need(f"{col.name}:th", col.tail_hi)
                    self._need(f"{col.name}:tl", col.tail_lo)
                    self._need(f"{col.name}:tvalid", col.tail_valid)
                else:
                    self._need(f"{col.name}:tw", col.tail_w)
                self._need(f"{col.name}:tdoc", col.tail_doc)

    def _collect_query_arrays(self, q):
        if isinstance(q, Q.BooleanQuery):
            for c in (*q.must, *q.should, *q.must_not):
                self._collect_query_arrays(c)
        elif isinstance(q, (Q.TermQuery, Q.RangeQuery, Q.PrefixQuery,
                            Q.ExistsQuery, Q.PhraseQuery, Q.TermSetQuery,
                            Q.FuzzyTermQuery, Q.RegexQuery)):
            self._need_col_planes(self._col(q.field))

    def _chain_fields(self, chain):
        out = set()
        for q, _ in chain:
            qc.query_fields(q, out)
        return out

    def _chain_is_dense(self, chain) -> bool:
        """True when every query field in the chain is evaluable in ANY
        doc-aligned permuted row space: single-valued, or multi-valued with
        FULL dense plane coverage (<= DENSE_MULTI_K values per doc, no
        overflow tail). This is what gates the prefix/rank fast paths."""
        for f in self._chain_fields(chain):
            col = self._col(f)
            if col.multi and (not (col.has_multi_planes
                                   or col.has_multi_planes_wide)
                              or col.has_tail):
                return False
        return True

    def _chain_pkeys(self, chain):
        """Deterministic flat order of the chain's query param keys."""
        keys = []
        for q, qpath in chain:
            keys.extend(qc.extract_params(q, self.dindex, path=qpath))
        return keys

    def _chain_plane_keys(self, chain):
        """Short plane keys (sans view prefix) the chain's eval_mask reads;
        valid only under _chain_is_dense."""
        keys = []
        for f in sorted(self._chain_fields(chain)):
            col = self._col(f)
            if col.multi and col.has_multi_planes_wide:
                for kk in range(len(col.multi_planes_wide_host)):
                    keys += [f"{f}:mph{kk}", f"{f}:mpl{kk}"]
                keys.append(f"{f}:mpn")
            elif col.multi:
                keys += [f"{f}:mp{kk}"
                         for kk in range(len(col.multi_planes_host))]
            elif col.narrow or col.ftype.is_stringy:
                keys.append(f"{f}:w")
            else:
                keys += [f"{f}:hi", f"{f}:lo"]
        return keys

    # -- value-domain cubes (ops/cube.py) -------------------------------------

    def _cube_cache(self):
        cc = getattr(self.dindex, "_cube_cache", None)
        if cc is None:
            cc = {}
            self.dindex._cube_cache = cc
        return cc

    @staticmethod
    def _cube_query_ok(q) -> bool:
        """Queries whose eval_mask over a single-valued narrow/stringy field
        reads ONLY the `{f}:w` plane and is elementwise in w — the property
        that makes evaluation over the virtual domain planes the chain
        predicate itself. PhraseQuery (position windows over the token
        stream) is the one field-query that is not."""
        if isinstance(q, Q.BooleanQuery):
            return all(Program._cube_query_ok(c)
                       for c in (*q.must, *q.should, *q.must_not))
        return isinstance(q, (Q.MatchAllQuery, Q.ExistsQuery, Q.TermQuery,
                              Q.RangeQuery, Q.PrefixQuery, Q.TermSetQuery,
                              Q.FuzzyTermQuery, Q.RegexQuery))

    def _cube_gate(self, chain):
        """(factors, Dprod) for a cube-able chain, else None: every chain
        field single-valued narrow/stringy, every chain query elementwise
        in w, product domain <= CUBE_DOM_CAP, and at least one extracted
        query param — match-all shaped chains keep the row paths (the cube
        is an adaptive access structure for parameterized queries, not a
        result cache; dedup covers repeated identical requests). Rows PER
        BUILD <= cube.MAX_BUILD_ROWS keeps the host build_sum float64
        accumulation exact (per-cell row counts bound the half-sums).

        Sharded meshes build PER-SHARD operands (round 5, VERDICT r4 #1):
        each shard chunk builds its own pieces (stacked [S, Dprod, K],
        row-sharded over the mesh), shards dot locally, and one int32 psum
        over the [K] dot vector merges exactly (recombine is linear in the
        dots). The exactness bound is then per-SHARD rows — a global index
        of any size cubes as long as each chunk stays under the bound —
        and operand HBM/build cost shard with the mesh. Min/max cell
        planes merge by all-gather min/max. Only the device-built
        percentile block-histogram cubes (pcube/scube) stay unsharded:
        their block axis is the layout row order, which is per-shard on a
        mesh where rank selection bisects instead."""
        from ..ops import cube
        if not self.config.use_cube:
            return None
        if self.dindex.T // self.dindex.n_shards > cube.MAX_BUILD_ROWS:
            return None
        if not all(self._cube_query_ok(q) for q, _ in chain):
            return None
        facs = []
        Dprod = 1
        for f in sorted(self._chain_fields(chain)):
            col = self._col(f)
            if col.multi or not (col.narrow or col.ftype.is_stringy):
                return None
            Df, off = cube.factor_meta(col)
            facs.append((f, Df, off))
            Dprod *= Df
        if Dprod > cube.CUBE_DOM_CAP or not self._chain_pkeys(chain):
            return None
        return tuple(facs), Dprod

    def _prep_cached(self, ck, build, to_host, from_host):
        """Build-or-load one cube-cache entry through the CROSS-PROCESS
        prep cache (utils/prep_cache.py): operands are pure functions of
        the index contents (keyed by index path + epoch + shard count +
        cache key), so a warm serving restart skips the argsort /
        bincount / device-scatter builds entirely. [VERDICT r3 #7]"""
        cc = self._cube_cache()
        if ck in cc:
            return cc[ck]
        from ..utils import prep_cache as PC
        di = self.dindex
        h = PC.load(di.path, di.epoch, di.n_shards, ck)
        if h is not None:
            cc[ck] = from_host(h)
            return cc[ck]
        v = build()
        cc[ck] = v
        hv = to_host(v)
        if hv is not None:
            PC.save(di.path, di.epoch, di.n_shards, ck, hv)
        return v

    def _cube_host_cell(self, facs):
        """Host int64 domain-cell index per doc row (alive rows only;
        cached on the device index — shared by every cube over the same
        factor set)."""
        from ..ops import cube
        key = ("cell",) + tuple(f for f, _, _ in facs)

        def build():
            ws = [self._host_planes(self._col(f))[0] for f, _, _ in facs]
            return cube.host_cell(facs, ws, self.dindex.alive_host > 0)

        return self._prep_cached(key, build,
                                 to_host=lambda v: {"cell": v},
                                 from_host=lambda h: h["cell"])

    def _cube_put(self, arr, ndim):
        """Device placement for a cube operand: the default device on one
        card; sharded over axis 0 on a mesh (per-shard operand stacks
        [S, ...] — each shard holds only ITS chunk's pre-aggregates)."""
        from ..index.loader import _put
        mesh = self.dindex.mesh
        if mesh is None:
            return _put(arr, None, ndim)
        from jax.sharding import NamedSharding, PartitionSpec as P
        return jax.device_put(
            np.asarray(arr),
            NamedSharding(mesh, P("d", *([None] * (ndim - 1)))))

    def _cube_build_groups(self, build_one):
        """Run a cube group builder over the full row space (unsharded) or
        once per contiguous shard chunk, stacking each group's arrays
        along a leading shard axis. `build_one(sel)` must apply `sel` to
        every per-row host array it reads. Per-shard builds keep the
        build_sum float64-bincount exactness proof bounded by SHARD rows,
        so global indexes past cube.MAX_BUILD_ROWS still cube (VERDICT
        r4 #1)."""
        if not self._sharded:
            return build_one(lambda a: a)
        S = self.dindex.n_shards
        chunk = self.dindex.T // S
        per = [build_one(lambda a, s=s: a[s * chunk:(s + 1) * chunk])
               for s in range(S)]
        return [(name, np.stack([p[i][1] for p in per]))
                for i, (name, _) in enumerate(per[0])]

    def _cube_build_arr(self, build_one):
        """_cube_build_groups for a single-array builder (min/max cell
        planes): returns the array (unsharded) or a [S, ...] stack."""
        if not self._sharded:
            return build_one(lambda a: a)
        S = self.dindex.n_shards
        chunk = self.dindex.T // S
        return np.stack([build_one(lambda a, s=s: a[s * chunk:(s + 1) * chunk])
                         for s in range(S)])

    def _cube_site(self, facs, sig, build_groups):
        """Register one packed [Dprod, K] int8 piece operand (built host-
        exact on miss, cached on the device index); returns (array key,
        column layout), or (None, None) when the site exceeds the static
        column cap (the caller falls back to the row paths)."""
        from ..ops import cube
        from ..utils import prep_cache as PC
        cc = self._cube_cache()
        di = self.dindex
        fkey = tuple(f for f, _, _ in facs)
        # per-shard operands get distinct cache keys AND array-key prefix:
        # "CUBEP#" arrays are [S, ...] stacks row-sharded over the mesh
        # (default P('d', ...) in_specs), "CUBE#" stays replicated P()
        key = (("site", "ps") if self._sharded else ("site",)) \
            + fkey + (sig,)
        if key not in cc:
            h = PC.load(di.path, di.epoch, di.n_shards, key)
            if h is not None:
                pieces = h["pieces"]
                layout = [(str(nm), int(m), int(n)) for nm, m, n
                          in zip(h["lnames"], h["lm"], h["ln"])]
            else:
                pieces, layout = (
                    cube.pack_groups_sharded(build_groups())
                    if self._sharded else cube.pack_groups(build_groups()))
                if pieces.shape[-1] <= cube.CUBE_COLS_CAP:
                    PC.save(di.path, di.epoch, di.n_shards, key,
                            {"pieces": pieces,
                             "lnames": np.asarray([nm for nm, _, _
                                                   in layout], dtype="U"),
                             "lm": np.asarray([m for _, m, _ in layout]),
                             "ln": np.asarray([n for _, _, n in layout])})
            cc[key] = (None if pieces.shape[-1] > cube.CUBE_COLS_CAP
                       else (self._cube_put(pieces, pieces.ndim), layout))
        if cc[key] is None:
            return None, None
        dev, layout = cc[key]
        akey = ("CUBEP#" if self._sharded else "CUBE#") \
            + "|".join(fkey) + "#" + sig
        self._need(akey, dev)
        return akey, layout

    def _cube_base(self, facs, Dprod, chain):
        return {"factors": facs, "Dprod": Dprod, "chain": chain,
                "ind_key": (facs, tuple(qp for _, qp in chain))}

    def _plan_cube_count(self, p, chain) -> bool:
        from ..ops import cube
        g = self._cube_gate(chain)
        if g is None:
            return False
        facs, Dprod = g
        cell = self._cube_host_cell(facs)
        key, layout = self._cube_site(
            facs, "cnt",
            lambda: self._cube_build_groups(
                lambda sel: [("cnt", cube.build_count(sel(cell), Dprod))]))
        if key is None:
            return False
        p["cube"] = {**self._cube_base(facs, Dprod, chain),
                     "key": key, "layout": layout}
        return True

    def _plan_cube_metric(self, node, p, chain) -> bool:
        from ..ops import cube
        g = self._cube_gate(chain)
        if g is None:
            return False
        facs, Dprod = g
        col = self._col(node.field)
        need_min, need_max, need_sum = self._metric_needs(node)
        cell = self._cube_host_cell(facs)
        sig = (f"metric:{node.field}:"
               f"{int(need_min)}{int(need_max)}{int(need_sum)}")

        def build_one(sel):
            groups = []
            c = sel(cell)
            if col.multi:
                pre = self._doc_preagg_host(col)
                groups.append(
                    ("cnt", cube.build_sum(c, sel(pre["cnt"]), Dprod)))
                if need_sum:
                    sm = sel(pre["sum"])
                    groups.append(("sum", np.stack(
                        [cube.build_sum(c, sm[:, i], Dprod)
                         for i in range(sm.shape[1])])))
            else:
                groups.append(("cnt", cube.build_count(c, Dprod)))
                if need_sum:
                    if col.sum_direct:
                        groups.append(("sum", cube.build_sum(
                            c, sel(self._host_planes(col)[0]), Dprod)))
                    else:
                        limbs = sel(self._sum_limbs_host(col))
                        groups.append(("sum", np.stack(
                            [cube.build_sum(c, limbs[:, i], Dprod)
                             for i in range(limbs.shape[1])])))
            return groups

        key, layout = self._cube_site(
            facs, sig, lambda: self._cube_build_groups(build_one))
        if key is None:
            return False
        cb = {**self._cube_base(facs, Dprod, chain),
              "key": key, "layout": layout, "mm": {}, "mm_narrow": col.narrow}
        if need_min or need_max:
            self._cube_minmax(cb, facs, Dprod, cell, col,
                              need_min, need_max)
        p["cube"] = cb
        return True

    def _cube_minmax(self, cb, facs, Dprod, cell, col, need_min, need_max):
        """Per-cell min/max planes (separate from the matmul operand):
        narrow -> one int32 [Dprod] plane; wide -> a [2, Dprod] (hi, lo)
        split of the int64 rm min/max. Empty-cell sentinels match the row
        reductions exactly (I32_MAX / -1 narrow, I64_MAX / I64_MIN wide)."""
        from ..ops import cube
        cc = self._cube_cache()
        fkey = tuple(f for f, _, _ in facs)
        if col.multi:
            pre = self._doc_preagg_host(col)
            valid = pre["cnt"] > 0
            if col.narrow:
                srcs = {"min": pre["minA"], "max": pre["maxA"]}
            else:
                srcs = {"min": (pre["minA"], pre["minB"]),
                        "max": (pre["maxA"], pre["maxB"])}
        else:
            valid = None
            hp = self._host_planes(col)
            srcs = {"min": (hp[0] if col.narrow else (hp[0], hp[1])),
                    "max": (hp[0] if col.narrow else (hp[0], hp[1]))}
        for which, need in (("min", need_min), ("max", need_max)):
            if not need:
                continue
            ck = (("mm", "ps") if self._sharded else ("mm",)) \
                + fkey + (col.name, which, col.multi)

            def build_one(sel, which=which):
                src = srcs[which]
                c = sel(cell)
                va = None if valid is None else sel(valid)
                if col.narrow:
                    return (cube.build_min32(c, sel(src), Dprod, va)
                            if which == "min"
                            else cube.build_max32(c, sel(src), Dprod, va))
                hi, lo = src
                rm = ((sel(hi).astype(np.int64) << 32)
                      + sel(lo).astype(np.int64) + 2**31)
                m64 = (cube.build_min64(c, rm, Dprod, va)
                       if which == "min"
                       else cube.build_max64(c, rm, Dprod, va))
                return np.stack(cube.split_rm(m64))

            def build_put(b=build_one):
                arr = self._cube_build_arr(b)
                return self._cube_put(arr, arr.ndim)

            self._prep_cached(
                ck, build_put,
                to_host=lambda v: {"a": np.asarray(v)},
                from_host=lambda h: self._cube_put(h["a"], h["a"].ndim))
            akey = (f"{'CUBEP' if self._sharded else 'CUBE'}#"
                    f"{'|'.join(fkey)}#mm:{col.name}:{which}:{col.multi}")
            self._need(akey, cc[ck])
            cb["mm"][which] = akey

    def _cube_ind(self, cb, params):
        """Traced [Dprod] int8 chain indicator over the virtual domain
        planes — the same eval_mask code as the row formulation, so the
        predicate semantics are identical by construction. Memoized per
        trace (nodes sharing a chain share the indicator)."""
        from ..ops import cube
        hit = self._ind_cache.get(cb["ind_key"])
        if hit is not None:
            return hit
        planes, Dprod = cube.dom_planes(cb["factors"])
        m = jnp.ones(Dprod, dtype=bool)
        for q, qpath in cb["chain"]:
            m = m & qc.eval_mask(q, self.dindex, params, qpath, Dprod,
                                 planes)
        ind = m.astype(jnp.int8)
        self._ind_cache[cb["ind_key"]] = ind
        return ind

    def _cube_rec(self, cb, params, arrays):
        """Indicator + recombined group values. Sharded meshes see the
        LOCAL [1, Dprod, K] slice of the per-shard operand stack: dot it,
        psum the [K] int32 dot vector (lanes < S * 2^24 — exact), and
        recombine — linearity of the shifted recombination over the shard
        sum makes the total the exact global value."""
        from ..ops import cube
        ind = self._cube_ind(cb, params)
        op = arrays[cb["key"]]
        if self._sharded:
            dots = self._madd(cube.cube_dots(ind, op[0]))
        else:
            dots = cube.cube_dots(ind, op)
        return ind, cube.recombine(dots, cb["layout"])

    def _cube_mm_eval(self, cb, ind, arrays, which, is_min):
        a = arrays[cb["mm"][which]]
        if self._sharded:
            a = a[0]  # local per-shard cell plane; merged below
        if cb["mm_narrow"]:
            sent = 2**31 - 1 if is_min else -1
            v = jnp.where(ind > 0, a, sent)
        else:
            rm = R.wide_recon(a[0], a[1])
            sent = I64_MAX if is_min else -(2**63)
            v = jnp.where(ind > 0, rm, sent)
        v = jnp.min(v) if is_min else jnp.max(v)
        return (self._mmin(v) if is_min else self._mmax(v))

    def _eval_metric_cube(self, node, params, arrays, p):
        cb = p["cube"]
        need_min, need_max, need_sum = self._metric_needs(node)
        ind, rec = self._cube_rec(cb, params, arrays)
        out = {"cnt": rec["cnt"]}
        if need_min:
            out["min"] = self._cube_mm_eval(cb, ind, arrays, "min", True)
        if need_max:
            out["max"] = self._cube_mm_eval(cb, ind, arrays, "max", False)
        if need_sum:
            out["sum"] = rec["sum"]
        return out

    def _plan_cube_bucket(self, node, sig_base, chain, nb, bid_host,
                          sub_aggs):
        """Cube lowering for a ROOT-LEVEL dense bucket agg (histogram or
        small-card terms) over a cube-able chain: per-bucket counts and
        Count/Sum/Avg sub-agg fruits become [nb, Dprod]-shaped exact piece
        operands — bucket j's fruit is one more dot lane of the SAME
        [B, Dprod] indicator matmul, so the whole bucket tree costs no row
        pass per query. `sub_aggs` is the Count/Sum/Avg subset the cube
        answers (callers plan any ctx-free rest — slot_rank percentiles —
        through the normal in-slot machinery). Returns the cube plan dict
        or None (row paths)."""
        from ..ops import cube
        g = self._cube_gate(chain)
        if g is None:
            return None
        facs, Dprod = g
        if Dprod * nb > cube.CUBE_BCELLS_CAP:
            return None
        cell = self._cube_host_cell(facs)
        subs = {}
        for name, s in sub_aggs:
            if isinstance(s, A.CountAgg):
                continue
            scol = self._col(s.field)
            if scol.multi:
                subs[name] = {
                    "multi": True,
                    "L": int(self._doc_preagg_host(scol)["sum"].shape[1])}
            elif scol.sum_direct:
                subs[name] = {"multi": False, "L": 0}
            else:
                subs[name] = {
                    "multi": False,
                    "L": int(self._sum_limbs_host(scol).shape[1])}
        sig = sig_base + "#" + "|".join(
            f"{name}:{type(s).__name__}:{getattr(s, 'field', '')}"
            for name, s in sub_aggs)

        def build_one(sel):
            cell2 = cube.bucket_cell(sel(cell), sel(bid_host), nb)
            groups = [("counts",
                       cube.build_bucket_counts(cell2, Dprod, nb))]
            for name, s in sub_aggs:
                if isinstance(s, A.CountAgg):
                    continue  # eval reuses the counts group
                scol = self._col(s.field)
                if scol.multi:
                    pre = self._doc_preagg_host(scol)
                    groups.append((f"c:{name}", cube.build_bucket_sums(
                        cell2, sel(pre["cnt"]), Dprod, nb)))
                    limbs = sel(pre["sum"])
                elif scol.sum_direct:
                    groups.append((f"s:{name}", cube.build_bucket_sums(
                        cell2, sel(self._host_planes(scol)[0]), Dprod, nb)))
                    continue
                else:
                    limbs = sel(self._sum_limbs_host(scol))
                S = np.stack(
                    [cube.build_bucket_sums(cell2, limbs[:, i], Dprod, nb)
                     for i in range(limbs.shape[1])], axis=1)
                groups.append((f"s:{name}",
                               S.reshape(nb * limbs.shape[1], Dprod)))
            return groups

        key, layout = self._cube_site(
            facs, sig, lambda: self._cube_build_groups(build_one))
        if key is None:
            return None
        return {**self._cube_base(facs, Dprod, chain), "key": key,
                "layout": layout, "nb": nb, "subs": subs}

    def _plan_cube_sub(self, sub, path, hdims):
        """Plan entries under a cube'd bucket agg: harvest metadata only
        (the parent's cube answers every sub fruit; no row planes)."""
        if isinstance(sub, A.CountAgg):
            self.plan[path] = {"kind": "count", "hdims": hdims}
        else:
            self.plan[path] = self._metric_plan_dict(sub, hdims)

    def _eval_bucket_cube(self, node, p, params, arrays):
        """(counts [nbuckets], sub_out) for a cube'd root bucket agg —
        same shapes/dtypes as the dense row formulation's slot fruits
        (direct sums 1-D, limb sums [nb, L]), so selection and harvest
        are shared."""
        cb = p["cube"]
        nb = cb["nb"]
        _, rec = self._cube_rec(cb, params, arrays)
        counts = jnp.reshape(rec["counts"], (nb,))
        sub_out = {}
        for name, sub in node.sub_aggs:
            if isinstance(sub, A.CountAgg):
                sub_out[name] = {"cnt": counts}
                continue
            if not isinstance(sub, (A.SumAgg, A.AvgAgg)):
                continue  # ctx-free rest (slot_rank percentiles): caller
            spec = cb["subs"][name]
            cnt = (jnp.reshape(rec[f"c:{name}"], (nb,)) if spec["multi"]
                   else counts)
            s = rec[f"s:{name}"]
            sub_out[name] = {
                "cnt": cnt,
                "sum": (jnp.reshape(s, (nb,)) if spec["L"] == 0
                        else jnp.reshape(s, (nb, spec["L"])))}
        return counts, sub_out

    def _plan_cube_pct(self, p, chain, layout):
        """Cube lowering for the flat rank-percentile prefix: per-G-row
        block chain-match counts become one int8 matmul against a
        static [Dprod, 2*NB] two-digit per-block cell histogram. The
        histogram is built ONCE on device from the permuted chain planes
        that the window recompute already keeps resident (no extra host
        copies). Unsharded, integer percents, dense chains only (the block
        axis is the layout row order — per-shard on a mesh, where rank
        selection bisects instead)."""
        from ..ops import cube
        g = None if self._sharded else self._cube_gate(chain)
        if g is None:
            return None
        facs, Dprod = g
        G = cube.choose_block(layout.n_rows, Dprod)
        if G is None:
            return None
        fkey = tuple(f for f, _, _ in facs)
        ck = ("phist", p["prefix"], fkey, G)
        dev = self._prep_cached(
            ck, lambda: self._build_pct_blockhist(facs, Dprod, G, layout),
            to_host=lambda v: {"a": np.asarray(v)},
            from_host=lambda h: self._cube_put(h["a"], 2))
        key = f"PCUBE#{p['prefix']}#{'|'.join(fkey)}#{G}"
        self._need(key, dev)
        return {**self._cube_base(facs, Dprod, chain), "key": key, "G": G}

    def _plan_cube_slots(self, p, chain, layout, nslots, bchain):
        """Cube lowering for slot_rank nested percentiles: per-(slot,
        block) chain-match counts from one int8 matmul against a
        static [Dprod, ns*2NB] histogram over (composite ancestor slot,
        G-row block, domain cell) — built once on device from the
        resident permuted planes + the static composite-slot plane.
        Unsharded, integer percents, single-valued value fields."""
        from ..ops import cube
        g = None if self._sharded else self._cube_gate(chain)
        if g is None:
            return None
        facs, Dprod = g
        G = cube.choose_block_ns(layout.n_rows, Dprod, nslots)
        if G is None:
            return None
        p["ckeys"] = self._chain_plane_keys(chain)
        self._build_permuted_view(layout, p["prefix"], chain, ())
        self._build_slotcomp(p, layout, p["prefix"], bchain)
        fkey = tuple(f for f, _, _ in facs)
        ck = ("shist", p["prefix"], fkey, G, p["slotk"])

        def build_hist():
            strides, _ = cube.strides_of(facs)
            alive = layout.cache["alive"]
            ws = [layout.cache[f"{f}:w"] for f, _, _ in facs]
            vp = layout.valid_perm
            sp = layout.cache[p["slotk"]]

            @jax.jit
            def build(alive, vp, sp, *ws):
                cell = jnp.zeros(ws[0].shape[0], I32)
                for (_, Df, off), st, w in zip(facs, strides, ws):
                    cell = cell + (w + off) * st
                cell = jnp.where((alive > 0) & (vp > 0), cell, -1)
                return cube.build_slot_blockhist(cell, sp, nslots, Dprod,
                                                 G)

            with jax.enable_x64(False):
                return build(alive, vp, sp, *ws)

        dev = self._prep_cached(
            ck, build_hist,
            to_host=lambda v: {"a": np.asarray(v)},
            from_host=lambda h: self._cube_put(h["a"], 2))
        key = f"SCUBE#{p['prefix']}#{'|'.join(fkey)}#{G}#{p['slotk']}"
        self._need(key, dev)
        return {**self._cube_base(facs, Dprod, chain), "key": key, "G": G}

    def _build_pct_blockhist(self, facs, Dprod, G, layout):
        """One-time jitted device build of the [Dprod, 2*NB] block-cell
        histogram from the layout's permuted w planes (a query-independent
        10M-row scatter — off the per-query path)."""
        from ..ops import cube
        strides, _ = cube.strides_of(facs)
        alive = layout.cache["alive"]
        ws = [layout.cache[f"{f}:w"] for f, _, _ in facs]
        vp = layout.valid_perm

        @jax.jit
        def build(alive, vp, *ws):
            cell = jnp.zeros(ws[0].shape[0], I32)
            for (_, Df, off), st, w in zip(facs, strides, ws):
                cell = cell + (w + off) * st
            cell = jnp.where((alive > 0) & (vp > 0), cell, -1)
            return cube.build_blockhist(cell, Dprod, G)

        with jax.enable_x64(False):
            return build(alive, vp, *ws)

    # -- permuted views ------------------------------------------------------

    def _build_permuted_view(self, layout, prefix, chain, payload_fields,
                             bucket_fields=(), row_doc=None):
        """Materialize (cached on the layout) permuted planes for mask
        evaluation + metric payloads (+ ancestor bucket-id recomputation);
        register them as array inputs. For VALUE-ROW layouts over CSR
        columns, `row_doc` maps rows to their owning GLOBAL doc, and every
        doc-aligned plane (alive, chain fields, payload preaggs, bucket
        ids) is gathered per row's doc; padding rows map to doc 0 and are
        killed by the layout's lvalid plane."""
        perm = layout.perm if row_doc is None else \
            row_doc[layout.perm].astype(np.int64)

        def cache(key, build):
            if key not in layout.cache:
                from ..index.loader import _put
                layout.cache[key] = _put(np.asarray(build()),
                                         self.dindex.mesh)
            self._need(prefix + key, layout.cache[key])

        cache("alive", lambda: self.dindex.alive_host[perm])
        self._need(prefix + "lvalid", layout.valid_perm)
        for f in set(bucket_fields):
            colf = self._col(f)
            hp = self._host_planes(colf)
            if colf.narrow or colf.ftype.is_stringy:
                cache(f"{f}:w", lambda hp=hp: hp[0][perm])
            else:
                cache(f"{f}:hi", lambda hp=hp: hp[0][perm])
                cache(f"{f}:lo", lambda hp=hp: hp[1][perm])
            if colf.ftype.is_numeric:
                colf.term_ids()
                if colf._term_ids_host is not None:
                    cache(f"{f}:tid",
                          lambda colf=colf: colf._term_ids_host[perm])
        for f in self._chain_fields(chain):
            colf = self._col(f)
            if colf.multi:
                if not (colf.has_multi_planes
                        or colf.has_multi_planes_wide) or colf.has_tail:
                    raise NotImplementedError(
                        "CSR query field in permuted view")
                # dense per-position planes are doc-aligned: they permute
                # into the layout like any single-valued column
                if colf.has_multi_planes_wide:
                    for kk, (hh, ll) in enumerate(
                            colf.multi_planes_wide_host):
                        cache(f"{f}:mph{kk}", lambda hh=hh: hh[perm])
                        cache(f"{f}:mpl{kk}", lambda ll=ll: ll[perm])
                    mpn = colf._mpn_host
                    cache(f"{f}:mpn", lambda mpn=mpn: mpn[perm])
                    continue
                for kk, ph in enumerate(colf.multi_planes_host):
                    cache(f"{f}:mp{kk}", lambda ph=ph: ph[perm])
                continue
            hp = self._host_planes(colf)
            if colf.narrow or colf.ftype.is_stringy:
                cache(f"{f}:w", lambda hp=hp: hp[0][perm])
            else:
                cache(f"{f}:hi", lambda hp=hp: hp[0][perm])
                cache(f"{f}:lo", lambda hp=hp: hp[1][perm])
        for g in payload_fields:
            colg = self._col(g)
            if colg.multi:
                pre = self._doc_preagg_host(colg)
                cache(f"pay:{g}:cnt", lambda pre=pre: pre["cnt"][perm])
                for i in range(pre["sum"].shape[1]):
                    cache(f"pay:{g}:s{i}",
                          lambda pre=pre, i=i: pre["sum"][perm, i])
                self.plan.setdefault(("payL", prefix, g),
                                     {"L": pre["sum"].shape[1]})
            elif colg.sum_direct:
                hp = self._host_planes(colg)
                cache(f"pay:{g}:s0", lambda hp=hp: hp[0][perm])
                self.plan.setdefault(("payL", prefix, g), {"L": 1})
            else:
                limbs = self._sum_limbs_host(colg)
                for i in range(limbs.shape[1]):
                    cache(f"pay:{g}:s{i}", lambda limbs=limbs, i=i: limbs[perm, i])
                self.plan.setdefault(("payL", prefix, g),
                                     {"L": limbs.shape[1]})

    def _build_slotcomp(self, p, layout, prefix, bchain):
        """STATIC composite ancestor-slot plane over the value layout's
        permuted rows (host-exact, cached on the layout): the scube
        per-(slot, block) histogram is built against it, and the lazy
        window recompute slices it. Values: flat slot in [0, nslots) or -1
        (row outside every bucket). Must agree exactly with the in-trace
        composite of _eval_percentiles_slots: hist ids via
        _host_bucket_ids (the same host source as the resident bid
        planes), terms ids via the w/tid host planes."""
        from ..index.loader import _put
        perm = layout.perm

        sig = []
        for kind, f, meta in bchain:
            if kind == "terms":
                sig.append(f"t:{f}:{meta}")
            else:
                rb = meta.get("rbounds")
                sig.append("h:%s:%s:%s:%s:%s:%s" % (
                    f, meta["hmode"], meta["nb"], meta.get("w_base"),
                    meta.get("iv"),
                    None if rb is None else hash(rb.tobytes())))
        key = "slotcomp@" + "|".join(sig)
        if key not in layout.cache:
            slot = np.zeros(len(perm), np.int64)
            valid = np.ones(len(perm), bool)
            for kind, f, meta in bchain:
                colf = self._col(f)
                if kind == "hist":
                    bid = self._host_bucket_ids(colf, meta)[perm]
                    slot = slot * meta["nb"] + bid
                else:
                    if colf.ftype.is_stringy:
                        ids = self._host_planes(colf)[0][perm]
                    else:
                        colf.term_ids()
                        ids = colf._term_ids_host[perm]
                    valid &= ids >= 0
                    slot = slot * meta + np.maximum(ids, 0)
            sp = np.where(valid, slot, -1).astype(np.int32)
            layout.cache[key] = _put(sp, self.dindex.mesh)
        self._need(prefix + key, layout.cache[key])
        p["slotk"] = key

    #: per-shard cap on the (parent-row x child-row) expansion length — a
    #: pathological fan-out (huge per-doc value lists on both fields) routes
    #: to the exact host fallback instead of exhausting HBM
    _XPAND_CAP = 1 << 23

    def _build_xpand(self, pfield: str, cfield: str):
        """STATIC cross-product expansion of a multi-valued bucket CHILD
        under a multi-valued row-space ANCESTOR (SURVEY.md §3.2's weighted
        recursion on device): E rows, one per (parent value row, child
        value row) pair sharing a doc. All planes are query-independent and
        shard-local (value rows of both fields partition by owning doc's
        shard, so pairs never cross shards): prow/crow gather the parent
        slot plane / child bucket ids, doc feeds metric sub-aggs. Returns
        the registered array keys, or None when the expansion exceeds the
        per-shard cap (caller falls back to the exact host path)."""
        from ..index.loader import _put, _mesh_D, PAD_BLOCK
        pcol, ccol = self._col(pfield), self._col(cfield)
        ckey = ("xpand", pfield)
        if ccol._bid_cache is None:
            ccol._bid_cache = {}
        if ckey not in ccol._bid_cache:
            D = _mesh_D(self.dindex.mesh)
            Tl = self.dindex.T // D
            pd_all = pcol._host_doc.astype(np.int64)
            cd_all = ccol._host_doc.astype(np.int64)
            pv_all = pcol._host_valid
            cv_all = ccol._host_valid
            Prl, Crl = len(pd_all) // D, len(cd_all) // D
            shards = []
            for s in range(D):
                pd = pd_all[s * Prl:(s + 1) * Prl]
                pv = pv_all[s * Prl:(s + 1) * Prl]
                cd = cd_all[s * Crl:(s + 1) * Crl]
                cv = cv_all[s * Crl:(s + 1) * Crl]
                idx_c = np.nonzero(cv)[0]
                cnt = np.bincount(cd[idx_c], minlength=Tl)
                coff = np.zeros(Tl + 1, np.int64)
                np.cumsum(cnt, out=coff[1:])
                idx_p = np.nonzero(pv)[0]
                reps = cnt[pd[idx_p]]
                E = int(reps.sum())
                prow = np.repeat(idx_p, reps)
                starts = np.repeat(coff[pd[idx_p]], reps)
                within = (np.arange(E, dtype=np.int64)
                          - np.repeat(np.cumsum(reps) - reps, reps))
                crow = idx_c[starts + within]
                shards.append((prow.astype(np.int32),
                               crow.astype(np.int32),
                               pd[prow].astype(np.int32)))
            epad = max((len(sh[0]) for sh in shards), default=0)
            epad = max(PAD_BLOCK, -(-epad // PAD_BLOCK) * PAD_BLOCK)
            if epad > self._XPAND_CAP:
                ccol._bid_cache[ckey] = None
            else:
                def padcat(i, fill):
                    return np.concatenate(
                        [np.concatenate([sh[i], np.full(epad - len(sh[i]),
                                                        fill, np.int32)])
                         for sh in shards])
                xval = np.concatenate(
                    [np.concatenate([np.ones(len(sh[0]), np.int8),
                                     np.zeros(epad - len(sh[0]), np.int8)])
                     for sh in shards])
                mesh = self.dindex.mesh
                ccol._bid_cache[ckey] = {
                    "prow": _put(padcat(0, 0), mesh),
                    "crow": _put(padcat(1, 0), mesh),
                    "doc": _put(padcat(2, 0), mesh),
                    "valid": _put(xval, mesh),
                }
        planes = ccol._bid_cache[ckey]
        if planes is None:
            return None
        keys = {}
        for nm, arr in planes.items():
            k = f"XP:{pfield}>{cfield}#{nm}"
            self._need(k, arr)
            keys[nm] = k
        return keys

    def _need_bounds32(self, prefix, layout):
        """Register a bucket layout's 32-unit bounds: [card+1] unsharded,
        [D, card+1] sharded (axis 0 over 'd' — each shard sees its own
        local bounds row inside shard_map)."""
        from ..index.loader import _put
        b = np.asarray(layout.bounds)
        self._need(prefix + "bounds32", _put(b, self.dindex.mesh, b.ndim))

    def _need_sorted_value_planes(self, col, layout, prefix):
        """Ascending device planes of the value layout's sorted values, for
        cross-shard bisection selection. Invalid/padding rows carry the
        domain maximum (sorted_mono already holds I64_MAX there), so the
        stored planes are ascending end to end."""
        from ..index.loader import _put, _w_u64, _split_wide

        def cache(key, build):
            if key not in layout.cache:
                layout.cache[key] = _put(np.asarray(build()),
                                         self.dindex.mesh)
            self._need(prefix + key, layout.cache[key])

        wu = _w_u64(layout.sorted_mono, col.min_mono)
        if col.narrow:
            cache("sv0", lambda: np.minimum(
                wu, np.uint64(2**31 - 1)).astype(np.int32))
        else:
            h, l = _split_wide(wu)
            cache("sv0", lambda: h)
            cache("sv1", lambda: l)

    def _host_planes(self, col):
        if getattr(col, "_host_planes_cache", None) is None:
            from ..index.loader import _mono_planes
            if col.ftype.is_stringy:
                a = np.where(col._host_valid, col._host_mono, -1) \
                    .astype(np.int32)
                col._host_planes_cache = (a, None)
            else:
                _, a, b = _mono_planes(col._host_mono, col.min_mono, col.span)
                col._host_planes_cache = (a, b)
        return col._host_planes_cache

    def _sum_limbs_host(self, col):
        if getattr(col, "_sum_limbs_host_cache", None) is None:
            col._sum_limbs_host_cache = col.sum_limbs_host()
        return col._sum_limbs_host_cache

    def _doc_preagg_host(self, col):
        return col.doc_preagg_host(self.dindex.T)

    def _need_preagg(self, col, need_sum, need_minmax):
        from ..index.loader import _put
        pre = self._doc_preagg_host(col)
        mesh = self.dindex.mesh
        key = f"{col.name}:pre:"
        if key + "cnt" not in self._arrays:
            self._need(key + "cnt", _put(pre["cnt"], mesh))
        if need_sum and key + "sum" not in self._arrays:
            self._need(key + "sum", _put(pre["sum"], mesh, 2))
        if need_minmax:
            if col.narrow:
                self._need(key + "minA", _put(pre["minA"], mesh))
                self._need(key + "maxA", _put(pre["maxA"], mesh))
            else:
                for nm in ("minA", "minB", "maxA", "maxB"):
                    self._need(key + nm, _put(pre[nm], mesh))

    # -- node planners -------------------------------------------------------

    def _plan_aggs(self, node, path, *, in_slot, parent_single, hdims, tflat,
                   chain, bchain=()):
        if isinstance(node, (dict, tuple)):
            items = node.items() if isinstance(node, dict) else node
            for name, sub in items:
                self._plan_aggs(sub, path + (name,), in_slot=in_slot,
                                parent_single=parent_single, hdims=hdims,
                                tflat=tflat, chain=chain, bchain=bchain)
            return
        if isinstance(node, A.CountAgg):
            p = {"kind": "count", "hdims": hdims}
            if not in_slot:
                self._plan_cube_count(p, chain)
            self.plan[path] = p
            return
        if isinstance(node, (A.SumAgg, A.MinAgg, A.MaxAgg, A.AvgAgg,
                             A.StatsAgg)):
            self._plan_metric(node, path, hdims,
                              chain=(chain if not in_slot else None))
            return
        if isinstance(node, A.PercentilesAgg):
            self._plan_percentiles(node, path, hdims, chain,
                                   in_slot=in_slot, bchain=bchain)
            return
        if isinstance(node, A.HistogramAgg):
            self._plan_histogram(node, path, in_slot=in_slot,
                                 parent_single=parent_single, hdims=hdims,
                                 tflat=tflat, chain=chain, bchain=bchain)
            return
        if isinstance(node, A.TermsAgg):
            self._plan_terms(node, path, in_slot=in_slot,
                             parent_single=parent_single, hdims=hdims,
                             tflat=tflat, chain=chain, bchain=bchain)
            return
        if isinstance(node, (A.FilterAgg, A.PostFilterAgg)):
            self._collect_query_arrays(node.query)
            p = {"kind": "filter", "hdims": hdims}
            sub_chain = chain + ((node.query, path + ("fq",)),)
            if not in_slot:
                self._plan_cube_count(p, sub_chain)
            self.plan[path] = p
            self._plan_aggs(node.sub_aggs, path, in_slot=in_slot,
                            parent_single=parent_single, hdims=hdims,
                            tflat=tflat, chain=sub_chain, bchain=bchain)
            return
        if isinstance(node, A.TopHitsAgg):
            if in_slot:
                # the shipped fruit is POST-SELECTION ([keff] for topk
                # terms ancestors — _gather_top reorders every sub leaf
                # in-trace), so the host-transfer bound is prod(hdims)*k,
                # not the trace-time flat slot space; the latter only
                # bounds the [tflat, k] device intermediate (round 4:
                # terms(100k card, size 10){top_hits} now lowers)
                out_flat = 1
                for d in hdims:
                    out_flat *= d
                k = min(node.size, self.dindex.T)
                if out_flat * k > 4096 or tflat * k > (1 << 22):
                    raise NotImplementedError(
                        "top_hits under huge bucket spaces answers through "
                        "the exact host fallback")
            if node.sort_field is None:
                # score order (§A.10): constant scores, doc-order selection
                self.plan[path] = {"kind": "top_hits", "hdims": hdims,
                                   "k": min(node.size, self.dindex.T),
                                   "in_slot": in_slot, "score": True}
                return
            col = self._col(node.sort_field)
            if col.multi:
                raise TypeError("top_hits sort field must be single-valued")
            self._need_col_planes(col)
            self.plan[path] = {"kind": "top_hits", "hdims": hdims,
                               "k": min(node.size, self.dindex.T),
                               "in_slot": in_slot,
                               "narrow": col.narrow,
                               "min_mono": col.min_mono,
                               "ftype": col.ftype}
            return
        raise TypeError(f"unknown agg {type(node)!r}")

    @staticmethod
    def _metric_needs(node):
        need_min = isinstance(node, (A.MinAgg, A.StatsAgg))
        need_max = isinstance(node, (A.MaxAgg, A.StatsAgg))
        need_sum = isinstance(node, (A.SumAgg, A.AvgAgg, A.StatsAgg))
        return need_min, need_max, need_sum

    def _metric_plan_dict(self, node, hdims):
        """Harvest metadata for a metric node (shared by the row planner
        and the cube planners, which register no row planes)."""
        col = self._col(node.field)
        return {"kind": "metric", "ftype": col.ftype, "narrow": col.narrow,
                "multi": col.multi,
                "direct": col.sum_direct and not col.multi,
                "min_mono": col.min_mono,
                "min_user": (col.min_user() if col.ftype != FieldType.F64
                             else None),
                "base": col.f64_base_exp, "hdims": hdims}

    def _plan_metric(self, node, path, hdims, chain=None):
        col = self._col(node.field)
        need_min, need_max, need_sum = self._metric_needs(node)
        p = self._metric_plan_dict(node, hdims)
        if chain is not None and self._plan_cube_metric(node, p, chain):
            # the cube answers cnt/sum/min/max from [Dprod] operands —
            # no row planes needed for this node
            self.plan[path] = p
            return
        if col.multi:
            self._need_preagg(col, need_sum, need_min or need_max)
        else:
            self._need_col_planes(col)
            if need_sum and not col.sum_direct:
                self._need(f"{node.field}:limbs", col.sum_limbs())
        self.plan[path] = p

    def _plan_percentiles(self, node, path, hdims, chain, in_slot=False,
                          bchain=()):
        col = self._col(node.field)
        p = {"kind": "percentiles", "ftype": col.ftype, "narrow": col.narrow,
             "min_mono": col.min_mono, "percents": node.percents,
             "hdims": hdims}
        if in_slot:
            # per-bucket percentiles: recompute ancestor bucket slots in the
            # value layout's permuted space (possible when every ancestor
            # bucket is a dense-mode single-valued field) and rank-select
            # per slot. Non-integer percents resolve ranks in a second phase
            # (host rank arithmetic + one device gather). Sharded meshes
            # select via a per-slot cross-shard BISECTION over the same
            # per-shard value-sorted planes the flat rank path uses — no
            # all-gather (VERDICT r2 #5); non-integer percents stay on the
            # host fallback there (phase 2 would ship full per-shard
            # slot-space intermediates).
            int_p = all(float(q).is_integer() for q in node.percents)
            ok = ((not col.multi or col.has_value_rows)
                  and self._chain_is_dense(chain)
                  and bchain is not None and len(bchain) > 0)
            # occurrence-weighted slot factors (multi-valued terms
            # ancestors — "mterms" bchain entries): K per-position
            # composite slot planes, weighted windows at selection.
            # Unsharded only (the cross-shard bisection would need a
            # weighted variant); non-integer percents resolve ranks in
            # phase 2 over the (cum, wms) intermediates
            mts = [e for e in (bchain or ()) if e[0] == "mterms"]
            if mts and (self._sharded or len(mts) != 1):
                ok = False
            # non-integer percents resolve ranks in phase 2 over FULL
            # slot-space intermediates, so they cannot pass through a terms
            # ancestor's in-trace top-k gather — the terms planner detects
            # the shape and forces host-side selection (sel="host", exact
            # order semantics) so every fruit stays full-slot-space.
            # Sharded meshes resolve phase 2 by the same per-slot
            # cross-shard bisection the integer path uses in-trace
            # (_slot_bisect_phase2) — the per-shard (cum, vm, slot)
            # intermediates never leave the device (VERDICT r3 #4).
            nslots = 1
            if ok:
                for kind, f, meta in bchain:
                    nslots *= meta["nb"] if kind == "hist" else meta
            ns_ok = ok and nslots <= self.dense_nb
            if ok and not ns_ok and int_p and nslots <= self.PCT_SLOT_CAP \
                    and not col.multi and not self._sharded:
                # big flat slot spaces (round 4): the dense budget bounds
                # the ANCESTORS' mode, not this machinery — slot_rank is
                # viable whenever a memory-bounded formulation carries it:
                # the scube per-(slot, block) histogram keeps per-query
                # state at [ns, 2*R/G] int32 (G >= 128), and the plain
                # XLA path is admitted only while its [R/32, ns] cum
                # state stays under a hard byte budget (the msearch batch
                # accounting then shrinks groups to fit)
                from ..ops import cube
                R_ = col.value_layout().n_rows
                g = self._cube_gate(chain)
                ns_ok = ((g is not None
                          and cube.choose_block_ns(R_, g[1], nslots)
                          is not None)
                         or (R_ // 32) * nslots * 4 <= self._BIG_SLOT_MEM)
            if not ok or not ns_ok:
                raise NotImplementedError(
                    "percentiles under bucket aggs need dense single-valued "
                    "ancestors (flat slot space within the device budget); "
                    "non-integer percents under a sharded mesh answer "
                    "through the exact host path")
            p["pmode"] = "slot_rank"
            p["int_percents"] = int_p
            p["bchain"] = bchain
            p["chain"] = chain
            p["nslots"] = nslots
            layout = col.value_layout()
            p["layout"] = layout
            prefix = f"VL:{node.field}#"
            p["prefix"] = prefix
            row_doc = (col.global_doc_of_rows(self.dindex.T)
                       if col.multi else None)
            p["wslots"] = bool(mts)
            if p["wslots"]:
                # occurrence-weighted slots: static permuted per-position
                # parent bucket-id planes; counts and selection windows
                # sum over the K planes (no cube variant yet)
                p["scube"] = None
                mfield, mcard = mts[0][1], mts[0][2]
                p["mterms"] = {"field": mfield, "card": mcard}
                bucket_fields = [f for kind2, f, _ in bchain
                                 if kind2 != "mterms"]
                self._build_permuted_view(layout, prefix, chain, (),
                                          bucket_fields=bucket_fields,
                                          row_doc=row_doc)
                self._register_mslots(p, layout, prefix, row_doc)
                p["slot_bisect"] = False
                p["phase2_vals"] = False
                p["span"] = col.span
                self.plan[path] = p
                return
            # value-domain cube (ops/cube.py): per-(slot, block) counts
            # from ONE int8 matmul against a static [Dprod, ns*2NB]
            # histogram — no per-query row pass on cube-able chains
            p["scube"] = (self._plan_cube_slots(p, chain, layout, nslots,
                                                bchain)
                          if int_p and not col.multi else None)
            if p["scube"] is None:
                bucket_fields = [f for _, f, _ in bchain]
                self._build_permuted_view(layout, prefix, chain, (),
                                          bucket_fields=bucket_fields,
                                          row_doc=row_doc)
            p["slot_bisect"] = self._sharded
            # sharded non-integer percents: phase 2 emits VALUES (w/rm
            # domain) via the per-slot cross-shard bisection, not layout
            # rows — the harvest decodes accordingly
            p["phase2_vals"] = self._sharded and not int_p
            p["span"] = col.span
            if p["slot_bisect"]:
                self._need_sorted_value_planes(col, layout, prefix)
            self.plan[path] = p
            return
        if self._chain_is_dense(chain) and (not col.multi
                                            or col.has_value_rows):
            # single-valued dense rows, or CSR VALUE rows (every value of
            # every doc is a row; the query mask is gathered per row's
            # owning doc) — both rank-select over the value-sorted layout,
            # and sharded meshes bisect with no all-gather (VERDICT r2 #6)
            p["pmode"] = "rank"
            # integer percents (incl. the ES defaults) resolve ranks inside
            # the main program: no big intermediates leave the device and no
            # second transfer round is needed. Non-integer percents resolve
            # ranks host-side (exact rationals) in a second phase over the
            # per-shard prefix intermediates.
            p["int_percents"] = all(float(q).is_integer()
                                    for q in node.percents)
            layout = col.value_layout()
            p["layout"] = layout
            prefix = f"VL:{node.field}#"
            p["prefix"] = prefix
            p["chain"] = chain
            row_doc = (col.global_doc_of_rows(self.dindex.T)
                       if col.multi else None)
            p["row_doc"] = row_doc
            self._build_permuted_view(layout, prefix, chain, (),
                                      row_doc=row_doc)
            # sharded: selected values come from a cross-shard bisection
            # over the (per-shard sorted) value planes, not from row
            # positions — register the ascending value plane(s)
            p["bisect"] = self._sharded
            p["span"] = col.span
            if p["bisect"]:
                self._need_sorted_value_planes(col, layout, prefix)
            # value-domain cube (ops/cube.py): per-block chain-match counts
            # from ONE [Dprod] x [Dprod, 2*NB] int8 matmul against a static
            # two-digit per-block cell histogram (built once ON DEVICE from
            # the already-resident permuted planes) — no per-query row pass
            p["pcube"] = (self._plan_cube_pct(p, chain, layout)
                          if p["int_percents"] else None)
            if p["pcube"] is not None:
                p["ckeys"] = self._chain_plane_keys(chain)
        else:
            # NON-DENSE chain (CSR overflow tails / token streams among the
            # query fields): the mask cannot be re-evaluated in permuted row
            # space. GATHER the doc mask through the STATIC perm∘row_doc
            # index plane (one take per query) and ride the exact same rank
            # / bisect selection machinery as dense chains (no all-gather,
            # no per-query sort).
            if col.multi and not col.has_value_rows:
                raise NotImplementedError(
                    "percentiles over a CSR column without value rows")
            p["pmode"] = "rank"
            p["mask_gather"] = True
            p["int_percents"] = all(float(q).is_integer()
                                    for q in node.percents)
            layout = col.value_layout()
            p["layout"] = layout
            prefix = f"VL:{node.field}#"
            p["prefix"] = prefix
            p["chain"] = chain
            p["bisect"] = self._sharded
            p["span"] = col.span
            self._need(prefix + "lvalid", layout.valid_perm)
            self._register_pdoc(col, layout, prefix)
            if p["bisect"]:
                self._need_sorted_value_planes(col, layout, prefix)
        self.plan[path] = p

    def _register_mslots(self, p, layout, prefix, row_doc):
        """Static permuted per-position PARENT BUCKET-ID planes for the
        occurrence-weighted slot_rank path (wslots): plane k holds, per
        value-layout row, the mterms parent's bucket id via the doc's k-th
        value position (-1 where none). Stringy mp planes already hold
        global ordinals; numeric planes hold w-domain values and map to
        distinct-value term ids host-side (exact searchsorted)."""
        from ..index.loader import _put
        mcol = self._col(p["mterms"]["field"])
        perm = (layout.perm if row_doc is None
                else row_doc[layout.perm].astype(np.int64))
        keys = []
        for k, ph in enumerate(mcol.multi_planes_host):
            ck = f"ms:{mcol.name}:{k}"
            if ck not in layout.cache:
                if mcol.ftype.is_stringy:
                    ids = ph.astype(np.int64)
                else:
                    mcol.term_ids()
                    uniq = mcol._term_values_mono
                    ids = np.searchsorted(
                        uniq, ph.astype(np.int64) + mcol.min_mono)
                    ids = np.where(ph >= 0,
                                   np.clip(ids, 0, len(uniq) - 1), -1)
                layout.cache[ck] = _put(ids[perm].astype(np.int32),
                                        self.dindex.mesh)
            key = prefix + ck
            self._need(key, layout.cache[ck])
            keys.append(key)
        p["mterms"]["keys"] = keys

    def _register_pdoc(self, col, layout, prefix):
        """Static shard-local doc index per PERMUTED value row ("pdoc"):
        layout row i reads the query mask at mask[pdoc[i]]. Composes the
        layout permutation with the CSR row->doc map; sharded chunks
        subtract their shard's doc base so the gather stays shard-local
        under shard_map (the permutation never crosses shards)."""
        from ..index.loader import _put, _mesh_D
        if "pdoc" not in layout.cache:
            pd = (col.global_doc_of_rows(self.dindex.T)[layout.perm]
                  if col.multi else layout.perm.astype(np.int64))
            D = _mesh_D(self.dindex.mesh)
            if D > 1:
                R = pd.shape[0]
                pd = pd - (np.arange(R, dtype=np.int64) // (R // D)) \
                    * (self.dindex.T // D)
            layout.cache["pdoc"] = _put(pd.astype(np.int32),
                                        self.dindex.mesh)
        self._need(prefix + "pdoc", layout.cache["pdoc"])

    def _hist_layout(self, col, node):
        if col.n_values == 0:
            return {"hmode": "empty", "k_min": 0, "nb": 1}
        if getattr(node, "calendar", None):
            # calendar intervals (beyond-reference, utils/calendar.py):
            # static period boundaries over the column's [min, max] -> the
            # same "bounds" machinery as f64 histograms; bucket keys are
            # the period starts themselves
            from ..utils import calendar as cal
            lo = mono_mod.scalar_from_mono("date", col.min_mono)
            hi = mono_mod.scalar_from_mono("date", col.max_mono)
            keys, inner = cal.calendar_layout(node.calendar, lo, hi)
            nb = len(keys)
            if nb > MAX_HIST_NB:
                # device capacity limit, not a user error: the oracle
                # answers this tree, so route to the exact host fallback
                raise NotImplementedError(
                    f"calendar histogram would span {nb} buckets on "
                    "device (host path handles it)")
            # rm domain: rm = (mono - min_mono) - 2^63; boundary micros b ->
            # mono = b - 2^63 (the u64->mono shift)
            rb = [_wrap64(((int(b) - 2**63) - col.min_mono) - 2**63)
                  for b in inner]
            return {"hmode": "bounds", "k_min": 0, "nb": nb,
                    "rbounds": np.asarray(rb, np.int64),
                    "keys": np.asarray(keys, np.int64)}
        if col.ftype == FieldType.F64:
            lo = mono_mod.scalar_from_mono("f64", col.min_mono)
            hi = mono_mod.scalar_from_mono("f64", col.max_mono)
            k_min, bounds_mono = exact.f64_histogram_buckets(
                lo, hi, float(node.interval), float(node.offset))
            nb = len(bounds_mono) + 1
            if nb > MAX_HIST_NB_HOST:
                # not a plan-time user error: the refusal condition is the
                # oracle's REALIZED-span ceiling, applied on the host path
                raise NotImplementedError(
                    f"f64 histogram column spans {nb} buckets; host path "
                    "applies the realized-span ceiling")
            if nb > MAX_HIST_NB:
                raise NotImplementedError(
                    f"f64 histogram would span {nb} buckets on device "
                    "(host path handles it)")
            # rm domain: rm = (mono - min_mono) - 2^63
            rb = [_wrap64((int(b) - col.min_mono) - 2**63)
                  for b in bounds_mono]
            return {"hmode": "bounds", "k_min": k_min, "nb": nb,
                    "rbounds": np.asarray(rb, np.int64)}
        iv, off = int(node.interval), int(node.offset)
        lo_u = col.min_user()
        hi_u = mono_mod.scalar_from_mono(col.ftype.value, col.max_mono)
        k_min = (lo_u - off) // iv
        k_max = (hi_u - off) // iv
        nb = k_max - k_min + 1
        if nb > MAX_HIST_NB_HOST:
            # see the f64 branch: host path applies the realized-span ceiling
            raise NotImplementedError(
                f"histogram column spans {nb} buckets; host path applies "
                "the realized-span ceiling")
        # j = (w - w_base) // iv with w_base = (off + k_min*iv) - lo_u <= 0
        w_base = (off + k_min * iv) - lo_u
        span_num = col.span - w_base
        if col.narrow and span_num <= 2**31 - 1:
            return {"hmode": "direct32", "k_min": k_min, "nb": nb,
                    "w_base": int(w_base), "iv": iv}
        if span_num <= 2**63 - 1:
            return {"hmode": "direct64", "k_min": k_min, "nb": nb,
                    "w_base": int(w_base), "iv": iv}
        raise NotImplementedError("histogram span exceeds 2^63")

    @staticmethod
    def _host_bucket_ids(col, p) -> np.ndarray:
        """Exact host computation of 0-based bucket indices per value row
        (padding/invalid rows land in bucket 0; masked off at query time)."""
        from ..index.loader import _w_u64
        m = col._host_mono
        if p["hmode"] == "empty":
            return np.zeros(m.shape[0], np.int64)
        if p["hmode"] == "bounds":
            # rbounds are rm-domain (w - 2^63); compare in the same domain
            rm = (_w_u64(m, col.min_mono)
                  - np.uint64(2**63)).view(np.int64)
            return np.searchsorted(p["rbounds"], rm, side="right")
        # direct32/direct64: j = (w - w_base) // iv with -w_base in [0, iv)
        w = _w_u64(m, col.min_mono)
        num = w + np.uint64(-p["w_base"])  # fits u64 (span_num checked)
        return (num // np.uint64(p["iv"])).astype(np.int64)

    def _plan_histogram(self, node, path, *, in_slot, parent_single, hdims,
                        tflat, chain, bchain=()):
        col = self._col(node.field)
        p = {"kind": "histogram", "ftype": col.ftype, "multi": col.multi,
             "hdims": hdims}
        if in_slot and not parent_single and col.multi:
            # multi-valued child under a multi-valued row-space ancestor:
            # static (parent row x child row) cross-product expansion
            # (_build_xpand). One level only; deeper nests / oversize
            # fan-outs answer through the exact host fallback.
            xp = (self._build_xpand(self._mparent, node.field)
                  if self._mparent not in (None, "__deep__") else None)
            if xp is None:
                raise NotImplementedError(
                    "multi-valued bucket agg nested under a multi-valued "
                    "bucket field (no device expansion for this shape)")
            p["xpand"] = xp
        p.update(self._hist_layout(col, node))
        nb = p["nb"]
        if tflat * nb >= 2**31:
            raise NotImplementedError(
                "composite bucket slot space exceeds 2^31 on device "
                "(host path handles it)")
        # precomputed per-row bucket ids (host-exact, device-cached)
        bid_key = (f"{node.field}:bid:cal:{node.calendar}" if node.calendar
                   else f"{node.field}:bid:{node.interval}:{node.offset}")
        bid_host = self._host_bucket_ids(col, p)
        entry = self.dindex.schema.field(node.field)
        p["chain_ok"] = (not col.multi) or entry.cardinality.value == "single"
        if tflat * nb <= self.dense_nb and not in_slot and not col.multi:
            CSA = (A.CountAgg, A.SumAgg, A.AvgAgg)
            cube_subs = [ns2 for ns2 in node.sub_aggs
                         if isinstance(ns2[1], CSA)]
            rest = [ns2 for ns2 in node.sub_aggs
                    if not isinstance(ns2[1], CSA)]
            cb = None
            if all(isinstance(s2, A.PercentilesAgg) for _, s2 in rest):
                cb = self._plan_cube_bucket(node, "h:" + bid_key, chain,
                                            nb, bid_host, cube_subs)
            if cb is not None:
                p["mode"] = "dense"
                p["cube"] = cb
                self.plan[path] = p
                for name, sub in cube_subs:
                    self._plan_cube_sub(sub, path + (name,), hdims + (nb,))
                if rest:
                    # ctx-free subs (slot_rank percentiles): see
                    # _plan_terms — row slot-ctx DCE'd at compile
                    self._need_col_planes(col)
                    self._need(bid_key,
                               col.bucket_id_plane(bid_key,
                                                   lambda: bid_host))
                    p["bid_key"] = bid_key
                    sub_bchain = (bchain + (("hist", node.field, dict(p)),)
                                  if bchain is not None and p["chain_ok"]
                                  else None)
                    for name, sub in rest:
                        self._plan_aggs(sub, path + (name,), in_slot=True,
                                        parent_single=parent_single
                                        and p["chain_ok"],
                                        hdims=hdims + (nb,),
                                        tflat=tflat * nb, chain=chain,
                                        bchain=sub_bchain)
                return
        self._need_col_planes(col)
        self._need(bid_key, col.bucket_id_plane(bid_key, lambda: bid_host))
        p["bid_key"] = bid_key
        sub_kinds_ok = all(isinstance(s, (A.CountAgg, A.SumAgg, A.AvgAgg))
                           for _, s in node.sub_aggs)
        if tflat * nb <= self._dense_budget(node):
            p["mode"] = "dense"
        elif not in_slot and not col.multi and sub_kinds_ok:
            # large histogram: static bucket ids -> the same prefix-layout
            # machinery as high-cardinality terms (sorted rows + 32-aligned
            # bounds + prefix differences; no scatter, no sort). Sharded
            # meshes use per-shard layouts + one [nb] psum (SURVEY.md §3.5).
            p["mode"] = "prefix"
            layout = col.layout_for_ids(bid_key, bid_host, nb)
            p["layout"] = layout
            prefix = f"HL:{bid_key}#"
            p["prefix"] = prefix
            p["chain"] = chain
            self._plan_prefix_lowering(node, p, col, layout, prefix, chain)
        else:
            p["mode"] = "scatter"
        self.plan[path] = p
        if p["mode"] == "prefix":
            for name, sub in node.sub_aggs:
                if isinstance(sub, A.CountAgg):
                    self.plan[path + (name,)] = {"kind": "count",
                                                 "hdims": hdims + (nb,)}
                else:
                    self._plan_metric(sub, path + (name,), hdims + (nb,))
            return
        sub_bchain = (bchain + (("hist", node.field, dict(p)),)
                      if (bchain is not None and p["chain_ok"]
                          and p["mode"] == "dense"
                          and not col.multi) else None)
        prev_mp = self._mparent
        if "xpand" in p:
            self._mparent = "__deep__"  # expansion rows, not a field's rows
        elif col.multi and not p.get("plane_fanout"):
            self._mparent = node.field  # children chain over THIS row space
        try:
            for name, sub in node.sub_aggs:
                # parent_single = "the slot context stays doc-rooted": AND
                # of every ancestor's chain_ok (one multi ancestor forces
                # all descendants into row-space chaining)
                self._plan_aggs(sub, path + (name,), in_slot=True,
                                parent_single=parent_single
                                and p["chain_ok"],
                                hdims=hdims + (nb,), tflat=tflat * nb,
                                chain=chain,
                                bchain=sub_bchain if bchain is not None
                                and sub_bchain is not None else None)
        finally:
            self._mparent = prev_mp

    def _dense_budget(self, node) -> int:
        """Dense-mode flat-slot admission for a bucket node: dense_nb (the
        one-hot/matmul vs prefix cutover) — EXTENDED to PCT_SLOT_CAP
        when a percentile descendant needs the bucket in the slot_rank
        bchain (round 4): prefix/scatter ancestors cannot thread a static
        slot plane, so without the extension the whole subtree fell to the
        exact host path; a somewhat-past-cutover dense ancestor is far
        cheaper than that (the fuzz census measured this shape at ~9% of
        random draws — tests/test_fuzz.py::test_fallback_shape_rarity)."""
        if any(isinstance(s, A.PercentilesAgg) or _has_pct_sub(s)
               for _, s in node.sub_aggs):
            return max(self.dense_nb, self.PCT_SLOT_CAP)
        return self.dense_nb

    def _has_terms(self, node) -> bool:
        if isinstance(node, A.TermsAgg):
            return True
        subs = getattr(node, "sub_aggs", ())
        return any(self._has_terms(s) for _, s in subs)

    def _has_selection_sub(self, node) -> bool:
        """True if any descendant's fruit is a non-additive selection
        (top_hits, percentiles): per-plane fruits of those cannot be merged
        after the fact, so plane fan-out must not be used above them."""
        for _, s in getattr(node, "sub_aggs", ()):
            if isinstance(s, (A.TopHitsAgg, A.PercentilesAgg)):
                return True
            if self._has_selection_sub(s):
                return True
        return False

    def _plan_terms(self, node, path, *, in_slot, parent_single, hdims,
                    tflat, chain, bchain=()):
        col = self._col(node.field)
        p = {"kind": "terms", "ftype": col.ftype, "multi": col.multi,
             "hdims": hdims}
        if in_slot and not parent_single and col.multi:
            # see _plan_histogram: device cross-product expansion, one level
            xp = (self._build_xpand(self._mparent, node.field)
                  if self._mparent not in (None, "__deep__") else None)
            if xp is None:
                raise NotImplementedError(
                    "multi-valued bucket agg nested under a multi-valued "
                    "bucket field (no device expansion for this shape)")
            p["xpand"] = xp
        if col.ftype.is_stringy:
            card = col.card
            p["keys"] = col.terms
        else:
            tid, values_mono = col.term_ids()
            card = col.card
            p["keys_mono"] = values_mono
        if card > MAX_TERMS_CARD:
            raise NotImplementedError(
                f"terms cardinality {card} exceeds the device bound "
                "(host path handles it)")
        if tflat * card >= 2**31:
            raise NotImplementedError(
                "composite bucket slot space exceeds 2^31 on device "
                "(host path handles it)")
        p["card"] = card
        p["keff"] = min(node.size, card)
        if isinstance(node, A.FacetAgg):
            # facet: host selection over the full per-ordinal count vector;
            # the child set is a static slice of the sorted term table
            p["facet_children"] = self._facet_children(col, node.path)
            p["keff"] = card
        self._plan_terms_order(node, p)
        entry = self.dindex.schema.field(node.field)
        p["chain_ok"] = (not col.multi) or entry.cardinality.value == "single"
        # plane fan-out: short multi keyword parents evaluate per position
        # and merge fruits BEFORE top-k; per-plane chaining makes nested
        # histograms/metrics/filters legal (nested terms would select
        # per-plane, which is wrong, so they stay unsupported)
        p["plane_fanout"] = (
            not in_slot and col.multi and col.ftype.is_stringy
            and not isinstance(node, A.FacetAgg)
            and col.has_multi_planes and not col.has_tail
            and tflat * card <= self.dense_nb
            and not self._has_selection_sub(node))
        if p["plane_fanout"]:
            p["chain_ok"] = True

        if (tflat * card <= self.dense_nb and not in_slot and not col.multi
                and not isinstance(node, A.FacetAgg)):
            CSA = (A.CountAgg, A.SumAgg, A.AvgAgg)
            cube_subs = [ns2 for ns2 in node.sub_aggs
                         if isinstance(ns2[1], CSA)]
            rest = [ns2 for ns2 in node.sub_aggs
                    if not isinstance(ns2[1], CSA)]
            cb = None
            if all(isinstance(s2, A.PercentilesAgg) for _, s2 in rest):
                bid_h = (self._host_planes(col)[0] if col.ftype.is_stringy
                         else col._term_ids_host)
                cb = self._plan_cube_bucket(node, f"t:{node.field}:{card}",
                                            chain, card, bid_h, cube_subs)
            if cb is not None:
                p["mode"] = "dense"
                p["cube"] = cb
                self.plan[path] = p
                sub_hdims = hdims + ((card if p["sel"] == "host"
                                      else p["keff"]),)
                for name, sub in cube_subs:
                    self._plan_cube_sub(sub, path + (name,), sub_hdims)
                if rest:
                    # ctx-free subs (slot_rank percentiles): standard
                    # in-slot planning; the row slot-ctx they ignore is
                    # DCE'd at compile, so no row pass survives
                    self._need_col_planes(col)
                    if not col.ftype.is_stringy:
                        self._need(f"{node.field}:tid", tid)
                    sub_bchain = (bchain + (("terms", node.field, card),)
                                  if bchain is not None and p["chain_ok"]
                                  else None)
                    for name, sub in rest:
                        self._plan_aggs(sub, path + (name,), in_slot=True,
                                        parent_single=parent_single
                                        and p["chain_ok"],
                                        hdims=sub_hdims,
                                        tflat=tflat * card, chain=chain,
                                        bchain=sub_bchain)
                return
        self._need_col_planes(col)
        if not col.ftype.is_stringy:
            self._need(f"{node.field}:tid", tid)
        sub_kinds_ok = all(isinstance(s, (A.CountAgg, A.SumAgg, A.AvgAgg))
                           for _, s in node.sub_aggs)
        if tflat * card <= self._dense_budget(node):
            p["mode"] = "dense"
        elif not in_slot and not col.multi and sub_kinds_ok:
            p["mode"] = "prefix"
            layout = col.bucket_layout()
            p["layout"] = layout
            prefix = f"BL:{node.field}#"
            p["prefix"] = prefix
            p["chain"] = chain
            self._plan_prefix_lowering(node, p, col, layout, prefix, chain)
        else:
            p["mode"] = "scatter"
        self.plan[path] = p
        # host-side selection ships ALL card buckets; sub fruits stay full
        sub_hdims = hdims + ((card if p["sel"] == "host" else p["keff"]),)
        if p["mode"] == "prefix":
            # record metric plans for harvest reconstruction
            for name, sub in node.sub_aggs:
                if isinstance(sub, A.CountAgg):
                    self.plan[path + (name,)] = {"kind": "count",
                                                 "hdims": sub_hdims}
                else:
                    self._plan_metric(sub, path + (name,), sub_hdims)
        else:
            sub_bchain = None
            if bchain is not None and p["mode"] == "dense":
                if p["chain_ok"] and not col.multi:
                    sub_bchain = bchain + (("terms", node.field, card),)
                elif (col.multi and col.has_multi_planes
                      and not col.has_tail
                      and not col.has_multi_planes_wide
                      and not any(k == "mterms" for k, _, _ in bchain)):
                    # occurrence-WEIGHTED slot factor: percentile
                    # descendants lower via the wslots machinery (one
                    # mterms factor per chain — §3.2 weighted recursion)
                    sub_bchain = bchain + (("mterms", node.field, card),)
            prev_mp = self._mparent
            if "xpand" in p:
                self._mparent = "__deep__"
            elif col.multi and not p.get("plane_fanout"):
                self._mparent = node.field
            try:
                for name, sub in node.sub_aggs:
                    self._plan_aggs(sub, path + (name,), in_slot=True,
                                    parent_single=parent_single
                                    and p["chain_ok"],
                                    hdims=sub_hdims, tflat=tflat * card,
                                    chain=chain,
                                    bchain=sub_bchain if bchain is not None
                                    and sub_bchain is not None else None)
            finally:
                self._mparent = prev_mp

    @staticmethod
    def _facet_children(col, path: str) -> np.ndarray:
        """Global ordinals of the immediate children of `path` (terms that
        start with path+'/' and have no further '/'), from the static
        sorted term table."""
        terms = col.terms
        pfx = (path.rstrip("/") + "/") if path else "/"
        lo = int(np.searchsorted(terms, pfx, side="left"))
        succ = qc._prefix_successor(pfx)
        hi = (int(np.searchsorted(terms, succ, side="left"))
              if succ is not None else len(terms))
        return np.asarray(
            [j for j in range(lo, hi)
             if "/" not in str(terms[j])[len(pfx):]], dtype=np.int64)

    def _plan_terms_order(self, node, p):
        """Pick the selection mode for a terms agg's `order`:
        - "topk": default (count desc, key asc) composite-key lax.top_k;
        - "device": a 3-key batched lax.sort over an exact int64 order key
          (possible for _count/_key/count-sub/min/max, and direct integer
          sums with a static no-overflow proof) — order-isomorphic to the
          harvested user values, so selection matches the oracle exactly;
        - "host": ship ALL buckets' fruits; harvest reconstructs exact user
          values and selects host-side (avg, f64 sums, limb-plane sums)."""
        target, direction = node.order
        p["order"] = node.order
        if isinstance(node, A.FacetAgg):
            p["sel"] = "host"  # full count vector; children picked at harvest
            return
        if _has_nonint_pct_sub(node):
            # a non-integer-percent percentile descendant resolves its
            # ranks in phase 2 over FULL slot-space intermediates — an
            # in-trace top-k/sort gather would collapse its sibling fruits
            # to selected buckets and break the slot addressing, so this
            # node selects host-side (exact order semantics, tested for
            # every order target)
            p["sel"] = "host"
            return
        if node.order == ("_count", "desc"):
            p["sel"] = "topk"
            return
        if target in ("_count", "_key"):
            p["sel"] = "device"
            return
        sub = dict(node.sub_aggs)[target]
        if isinstance(sub, (A.CountAgg, A.MinAgg, A.MaxAgg)):
            # count is exact i64; min/max device values (w / rm) are
            # order-isomorphic to user values with identical tie structure
            p["sel"] = "device"
            return
        if isinstance(sub, A.SumAgg):
            scol = self._col(sub.field)
            if (scol.ftype != FieldType.F64 and scol.sum_direct
                    and not scol.multi):
                mu = int(scol.min_user())
                n = max(self.dindex.total_values, self.dindex.n_docs, 1)
                if n * (abs(mu) + int(scol.span) + 1) < 2**61:
                    p["sel"] = "device"  # okey = w_sum + cnt*min_user, exact
                    p["order_mu"] = mu
                    return
        p["sel"] = "host"

    def _extract_filter_params(self, node, path, out):
        if isinstance(node, (dict, tuple)):
            items = node.items() if isinstance(node, dict) else node
            for name, sub in items:
                self._extract_filter_params(sub, path + (name,), out)
            return
        if isinstance(node, (A.FilterAgg, A.PostFilterAgg)):
            out.update(qc.extract_params(node.query, self.dindex,
                                         path=path + ("fq",)))
            self._extract_filter_params(node.sub_aggs, path, out)
            return
        if isinstance(node, (A.HistogramAgg, A.TermsAgg)):
            self._extract_filter_params(node.sub_aggs, path, out)

    # ======================================================================
    # trace-time evaluation
    # ======================================================================

    def _planes_only(self, field, arrays, rows_doc=None):
        return self._planes_only_pfx(field, arrays, "", rows_doc)

    def _planes_only_pfx(self, field, arrays, prefix, rows_doc=None):
        col = self._col(field)
        g = lambda k: (arrays[prefix + f"{field}:{k}"] if rows_doc is None
                       else arrays[prefix + f"{field}:{k}"][rows_doc])
        if col.narrow or col.ftype.is_stringy:
            return {"w": g("w")}
        return {"hi": g("hi"), "lo": g("lo")}

    def _recon_rm(self, field, planes):
        col = self._col(field)
        if col.narrow or col.ftype.is_stringy:
            return planes["w"].astype(I64)
        return R.wide_recon(planes["hi"], planes["lo"])

    def _eval(self, node, ctx, params, arrays, path):
        p = self.plan.get(path)

        if isinstance(node, A.CountAgg):
            if isinstance(ctx, MaskCtx):
                if p is not None and p.get("cube") is not None:
                    _, rec = self._cube_rec(p["cube"], params, arrays)
                    return {"cnt": rec["cnt"]}
                return {"cnt": self._madd(R.ts_count(ctx.mask))}
            return {"cnt": self._madd(self._slot_counts(ctx))}

        if isinstance(node, (A.SumAgg, A.MinAgg, A.MaxAgg, A.AvgAgg,
                             A.StatsAgg)):
            if (p is not None and p.get("cube") is not None
                    and isinstance(ctx, MaskCtx)):
                return self._eval_metric_cube(node, params, arrays, p)
            return self._eval_metric(node, ctx, arrays, p)

        if isinstance(node, A.PercentilesAgg):
            return self._eval_percentiles(node, ctx, params, arrays, path, p)

        if isinstance(node, A.HistogramAgg):
            return self._eval_histogram(node, ctx, params, arrays, path, p)

        if isinstance(node, A.TermsAgg):
            return self._eval_terms(node, ctx, params, arrays, path, p)

        if isinstance(node, (A.FilterAgg, A.PostFilterAgg)):
            fmask = qc.eval_mask(node.query, self.dindex, params,
                                 path + ("fq",), self._lT, arrays)
            out = {}
            if isinstance(ctx, MaskCtx):
                sub_ctx = MaskCtx(ctx.mask & fmask,
                                  ctx.chain + ((node.query,
                                                path + ("fq",)),))
                if p is not None and p.get("cube") is not None:
                    # sub-aggs may still consume sub_ctx.mask; when every
                    # consumer is cube'd too, XLA DCEs the whole row pass
                    _, rec = self._cube_rec(p["cube"], params, arrays)
                    out["cnt"] = rec["cnt"]
                else:
                    out["cnt"] = self._madd(R.ts_count(sub_ctx.mask))
            else:
                fr = fmask if ctx.rows_are_docs else fmask[ctx.doc]
                valid = ctx.valid & fr
                svd = None if ctx.slot_valid_of_doc is None else \
                    ctx.slot_valid_of_doc & fmask
                sub_ctx = SlotCtx(ctx.bid, valid, ctx.dims,
                                  ctx.rows_are_docs, ctx.doc, ctx.mode,
                                  ctx.slot_of_doc, svd)
                out["cnt"] = self._madd(self._slot_counts(sub_ctx))
            for name, sub in node.sub_aggs:
                out[name] = self._eval(sub, sub_ctx, params, arrays,
                                       path + (name,))
            return out

        if isinstance(node, A.TopHitsAgg):
            return self._eval_top_hits(node, ctx, arrays, path, p)

        raise TypeError(f"unknown agg {type(node)!r}")

    @staticmethod
    def _merge_plane_outs(outs):
        """Merge per-plane sub-agg output dicts: additive for counts/sums,
        min/max for extrema (valid because each plane is a disjoint set of
        value occurrences of the same docs)."""
        def merge(vals, key):
            if key == "min":
                r = vals[0]
                for v in vals[1:]:
                    r = jnp.minimum(r, v)
                return r
            if key == "max":
                r = vals[0]
                for v in vals[1:]:
                    r = jnp.maximum(r, v)
                return r
            r = vals[0]
            for v in vals[1:]:
                r = r + v
            return r

        out = {}
        for key in outs[0]:
            if isinstance(outs[0][key], dict):
                out[key] = Program._merge_plane_outs([o[key] for o in outs])
            else:
                out[key] = merge([o[key] for o in outs], key)
        return out

    # -- slot reductions (mode dispatch) -------------------------------------

    def _slot_counts(self, ctx: SlotCtx):
        if ctx.mode == "dense":
            if ctx.bid_static and self.config.dense_mxu:
                return R.dense_bucket_counts_mxu(ctx.bid, ctx.valid,
                                                 ctx.nslots)
            return R.dense_bucket_counts(ctx.bid, ctx.valid, ctx.nslots)
        return R.slot_count(ctx.bid, ctx.valid, ctx.nslots)

    def _slot_sum_plane(self, ctx: SlotCtx, plane, bound=None):
        """`bound`: optional STATIC (lo, hi) on the plane's values at valid
        rows — shrinks the int8 piece decomposition (see reductions.py)."""
        if ctx.mode == "dense":
            if ctx.bid_static and self.config.dense_mxu:
                return R.dense_bucket_sum_mxu(ctx.bid, ctx.valid, plane,
                                              ctx.nslots, bound=bound)
            return R.dense_bucket_sum(ctx.bid, ctx.valid, plane, ctx.nslots)
        return R.slot_sum(plane, ctx.bid, ctx.valid, ctx.nslots)

    def _slot_min(self, ctx: SlotCtx, vals):
        if ctx.mode == "dense":
            return R.dense_bucket_min(ctx.bid, ctx.valid, vals, ctx.nslots)
        return R.slot_min(vals, ctx.bid, ctx.valid, ctx.nslots)

    def _slot_max(self, ctx: SlotCtx, vals):
        if ctx.mode == "dense":
            return R.dense_bucket_max(ctx.bid, ctx.valid, vals, ctx.nslots)
        return R.slot_max(vals, ctx.bid, ctx.valid, ctx.nslots)

    # -- metrics -------------------------------------------------------------

    def _eval_metric(self, node, ctx, arrays, p):
        field = node.field
        col = self._col(field)
        need_min, need_max, need_sum = self._metric_needs(node)
        out = {}

        if isinstance(ctx, MaskCtx):
            if col.multi:
                pre = f"{field}:pre:"
                cnt_doc = arrays[pre + "cnt"]
                sum_cols = (
                    [arrays[pre + "sum"][:, i]
                     for i in range(arrays[pre + "sum"].shape[1])]
                    if need_sum else [])
                if self.config.dense_mxu:
                    # cnt + every limb plane in ONE chunked matmul pass
                    pb = col.preagg_bounds(self.dindex.T)
                    sums = R.masked_sum_planes_mxu(
                        ctx.mask, [cnt_doc] + sum_cols,
                        bounds=[pb["cnt"]] + (pb["sum"] if need_sum else []))
                    out["cnt"] = self._madd(sums[0])
                    if need_sum:
                        out["sum"] = self._madd(sums[1:])
                else:
                    out["cnt"] = self._madd(
                        R.ts_sum_plane(cnt_doc, ctx.mask))
                    if need_sum:
                        out["sum"] = self._madd(jnp.stack(
                            [R.ts_sum_plane(c, ctx.mask)
                             for c in sum_cols]))
                mm_mask = ctx.mask & (cnt_doc > 0)
                if need_min:
                    out["min"] = self._mmin(self._pre_minmax(
                        arrays, pre, "min", mm_mask, col, True))
                if need_max:
                    out["max"] = self._mmax(self._pre_minmax(
                        arrays, pre, "max", mm_mask, col, False))
                return out
            planes = self._planes_only(field, arrays)
            vmask = ctx.mask
            out["cnt"] = self._madd(R.ts_count(vmask))
            if need_min:
                out["min"] = self._mmin(
                    R.masked_min_i32(planes["w"], vmask) if col.narrow
                    else R.masked_min_wide(planes["hi"], planes["lo"],
                                           vmask))
            if need_max:
                out["max"] = self._mmax(
                    R.masked_max_i32(planes["w"], vmask) if col.narrow
                    else R.masked_max_wide(planes["hi"], planes["lo"],
                                           vmask))
            if need_sum:
                if p["direct"]:
                    out["sum"] = self._madd(R.ts_sum_plane(planes["w"],
                                                           vmask))
                elif self.config.dense_mxu:
                    limbs = arrays[f"{field}:limbs"]
                    out["sum"] = self._madd(R.masked_sum_planes_mxu(
                        vmask, [limbs[:, i]
                                for i in range(limbs.shape[1])],
                        bounds=col.limb_bounds()))
                else:
                    limbs = arrays[f"{field}:limbs"]
                    out["sum"] = self._madd(jnp.stack(
                        [R.ts_sum_plane(limbs[:, i], vmask)
                         for i in range(limbs.shape[1])]))
            return out

        # SlotCtx
        if col.multi:
            pre = f"{field}:pre:"
            pb = col.preagg_bounds(self.dindex.T)
            cnt_doc = arrays[pre + "cnt"]
            cnt_rows = cnt_doc if ctx.rows_are_docs else cnt_doc[ctx.doc]
            out["cnt"] = self._madd(
                self._slot_sum_plane(ctx, cnt_rows, bound=pb["cnt"]))
            if need_min or need_max:
                mm_valid = ctx.valid & (cnt_rows > 0)
                mctx = SlotCtx(ctx.bid, mm_valid, ctx.dims,
                               ctx.rows_are_docs, ctx.doc, ctx.mode)
                if need_min:
                    out["min"] = self._mmin(self._slot_preagg_minmax(
                        mctx, arrays, pre, "min", col, True))
                if need_max:
                    out["max"] = self._mmax(self._slot_preagg_minmax(
                        mctx, arrays, pre, "max", col, False))
            if need_sum:
                planes = arrays[pre + "sum"]
                rows = planes if ctx.rows_are_docs else planes[ctx.doc]
                out["sum"] = self._madd(jnp.stack(
                    [self._slot_sum_plane(ctx, rows[:, i],
                                          bound=pb["sum"][i])
                     for i in range(planes.shape[1])], axis=-1))
            return out

        get = lambda k: (arrays[f"{field}:{k}"] if ctx.rows_are_docs
                         else arrays[f"{field}:{k}"][ctx.doc])
        out["cnt"] = self._madd(self._slot_counts(ctx))
        if need_min or need_max:
            if col.narrow:
                v = get("w")
            else:
                v = R.wide_recon(get("hi"), get("lo"))
            if need_min:
                out["min"] = self._mmin(self._slot_min(ctx, v))
            if need_max:
                out["max"] = self._mmax(self._slot_max(ctx, v))
        if need_sum:
            if p["direct"]:
                out["sum"] = self._madd(self._slot_sum_plane(
                    ctx, get("w"), bound=(0, int(col.span))))
            else:
                limbs = arrays[f"{field}:limbs"]
                lb = col.limb_bounds()
                rows = limbs if ctx.rows_are_docs else limbs[ctx.doc]
                out["sum"] = self._madd(jnp.stack(
                    [self._slot_sum_plane(ctx, rows[:, i], bound=lb[i])
                     for i in range(limbs.shape[1])], axis=-1))
        return out

    def _pre_minmax(self, arrays, pre, which, mask, col, is_min):
        if col.narrow:
            v = arrays[pre + which + "A"]
            return R.masked_min_i32(v, mask) if is_min \
                else R.masked_max_i32(v, mask)
        a, b = arrays[pre + which + "A"], arrays[pre + which + "B"]
        return R.masked_min_wide(a, b, mask) if is_min \
            else R.masked_max_wide(a, b, mask)

    def _slot_preagg_minmax(self, ctx, arrays, pre, which, col, is_min):
        if col.narrow:
            v = arrays[pre + which + "A"]
        else:
            v = R.wide_recon(arrays[pre + which + "A"],
                             arrays[pre + which + "B"])
        rows = v if ctx.rows_are_docs else v[ctx.doc]
        return self._slot_min(ctx, rows) if is_min \
            else self._slot_max(ctx, rows)

    # -- percentiles ---------------------------------------------------------

    def _perm_mask(self, chain, params, arrays, prefix, Rn):
        m = (arrays[prefix + "alive"] > 0) & (arrays[prefix + "lvalid"] > 0)
        for q, qpath in chain:
            m &= qc.eval_mask(q, self.dindex, params, qpath, Rn, arrays,
                              prefix)
        return m

    def _plan_prefix_lowering(self, node, p, col, layout, prefix, chain):
        """Pick the prefix-mode mask source for a bucket agg, best first:
        member block operand (one ~W-byte slice per query) > permuted-view
        chain re-eval — both need a DENSE chain (every query field
        evaluable in permuted row space).
        NON-DENSE chains (token-stream / CSR-overflow-tail query fields)
        gather the already-evaluated doc mask through the static pdoc
        plane instead — the same escape percentiles use — so they ride
        the cumsum+bounds prefix machinery rather than the scatter
        formulation."""
        payload_fields = [s.field for _, s in node.sub_aggs
                          if isinstance(s, (A.SumAgg, A.AvgAgg))]
        if self._chain_is_dense(chain):
            if not self._plan_member_op(node, p, chain, layout, prefix):
                self._build_permuted_view(layout, prefix, chain,
                                          payload_fields)
        else:
            p["mask_gather"] = True
            self._build_permuted_view(layout, prefix, (), payload_fields)
            self._register_pdoc(col, layout, prefix)
        self._need_bounds32(prefix, layout)

    # -- member block operands (single-value term queries on multi fields) --

    #: byte budget for one [Df, W] member block operand
    MEMBER_MEM = 2 << 30

    def _member_eligible(self, q) -> bool:
        """TermQuery leaves on dense non-f64 multi-valued narrow/stringy
        columns with a small value domain: a doc matches TermQuery(f, v)
        iff v is in its value set, so per-(value, 32-block) counts and
        payload sums are PRECOMPUTABLE — a query then dynamic-slices one
        ~NB-byte operand row instead of scanning the row planes. Measured
        motivation: bench c7's fused-kernel row formulation ran at 95% of
        HBM roofline, so fewer scanned bytes was the only lever left."""
        if not isinstance(q, Q.TermQuery):
            return False
        col = self._col(q.field)
        if not (col.multi and col.has_multi_planes and not col.has_tail
                and not col.has_multi_planes_wide
                and col.ftype != FieldType.F64):
            return False
        Df = len(col.terms) if col.ftype.is_stringy else int(col.span) + 1
        # rough domain gate (the real budget check in _plan_member_op uses
        # the layout card and piece counts): one int8 column must fit
        return 1 <= Df <= self.MEMBER_MEM

    def _member_split(self, chain):
        """(reduced_chain, member_specs): every POSITIVE CONJUNCTIVE
        (root-or-must position) eligible TermQuery leaf is replaced by
        MatchAll IN PLACE (sibling param paths are untouched — params are
        still extracted from the ORIGINAL query) and recorded as a member
        spec. Unsharded only."""
        if self._sharded:
            return chain, ()
        specs = []

        def walk(q, qpath):
            if self._member_eligible(q):
                col = self._col(q.field)
                Df = (len(col.terms) if col.ftype.is_stringy
                      else int(col.span) + 1)
                specs.append({"field": q.field, "pkey": qc._key(qpath),
                              "stringy": col.ftype.is_stringy, "Df": Df})
                return Q.MatchAllQuery()
            if isinstance(q, Q.BooleanQuery):
                must = tuple(walk(c, qpath + ("m", i))
                             for i, c in enumerate(q.must))
                if any(m is not c for m, c in zip(must, q.must)):
                    return Q.BooleanQuery(must=must, should=q.should,
                                          must_not=q.must_not)
            return q

        red = tuple((walk(q, qp), qp) for q, qp in chain)
        return red, tuple(specs)

    @staticmethod
    def _chain_is_matchall(chain) -> bool:
        """True when every chain entry matches everything (alive-masked):
        MatchAll, or a Boolean whose musts all match everything with no
        must_not (should is a scoring hint under a non-empty must, and an
        all-matchall empty-should boolean is all-true)."""
        def all_q(q):
            if isinstance(q, Q.MatchAllQuery):
                return True
            if isinstance(q, Q.BooleanQuery):
                return (len(q.must) > 0 and not q.must_not
                        and all(all_q(c) for c in q.must))
            return False
        return all(all_q(q) for q, _ in chain)

    def _plan_member_op(self, node, p, chain, layout, prefix):
        """Member operand lowering for a prefix-mode bucket agg whose
        ENTIRE chain is one eligible TermQuery (possibly wrapped in pure
        must-conjunctions): per-(member value, BUCKET) matched counts and
        payload sums are precomputed into ONE [Df_pad, W] int8 piece
        operand, so a query dynamic-slices one ~W-byte row and recombines
        [card]-sized vectors — no per-query row pass, no per-query cumsum.
        (The first formulation kept per-32-BLOCK cells and rode the
        cumsum+bounds machinery; its per-query [R/32]-long cumsums
        measured 2.1 ms/q on the 10M c7 shape vs ~0.39 ms/q for the
        slice alone, so the bucket reduction moved into the build.)
        Exact: every cell is an exact integer aggregate (i32 counts, i64
        limb-plane sums) decomposed into signed 7-bit pieces
        (ops/cube.py npieces_i64 identity); the slice-and-recombine
        regroups the same addends. Returns True when planned."""
        if not self.config.use_member_ops:
            return False
        rchain, member = self._member_split(chain)
        if len(member) != 1 or not self._chain_is_matchall(rchain):
            return False
        spec = member[0]
        col = self._col(spec["field"])
        Df = spec["Df"]
        card = len(layout.bounds) - 1
        # payload planes (same sources as _build_permuted_view)
        pay_fields = []
        for _, s in node.sub_aggs:
            if isinstance(s, (A.SumAgg, A.AvgAgg)) \
                    and s.field not in pay_fields:
                pay_fields.append(s.field)
        planes = []   # (group key, host plane int32 [T], nonneg)
        pay_meta = {}
        for g in pay_fields:
            colg = self._col(g)
            meta = {"skeys": [], "cnt_key": None,
                    "direct": colg.sum_direct and not colg.multi}
            if colg.multi:
                pre = self._doc_preagg_host(colg)
                for i in range(pre["sum"].shape[1]):
                    meta["skeys"].append(f"s:{g}:{i}")
                    planes.append((f"s:{g}:{i}", pre["sum"][:, i]))
                meta["cnt_key"] = f"c:{g}"
                planes.append((f"c:{g}", pre["cnt"]))
            elif colg.sum_direct:
                meta["skeys"] = [f"s:{g}:0"]
                planes.append((f"s:{g}:0", self._host_planes(colg)[0]))
            else:
                limbs = self._sum_limbs_host(colg)
                for i in range(limbs.shape[1]):
                    meta["skeys"].append(f"s:{g}:{i}")
                    planes.append((f"s:{g}:{i}", limbs[:, i]))
            pay_meta[g] = meta
        # static piece counts from host-known cell bounds: a (value,
        # bucket) cell holds at most min(bucket rows, docs containing the
        # value) rows, so counts and plane sums are bounded without
        # building anything
        from ..ops import cube
        # layout.bounds is in 32-row block units (loader ALIGN)
        maxbucket = 32 * int(np.max(np.diff(layout.bounds))) if card else 0
        vc = np.zeros(Df, np.int64)
        for ph in col.multi_planes_host:
            v = ph[ph >= 0]
            if v.size:
                vc += np.bincount(v, minlength=Df)[:Df]
        cellcap = min(maxbucket, int(vc.max()) if Df else 0)
        cols = [("cnt", cube.npieces_i64(0, cellcap))]
        for gk, ph in planes:
            mx = int(ph.max()) if ph.size else 0
            if mx > (2**31 - 1) // 32:
                return False  # build-stage 32-block sums must stay int32
            cols.append((gk, cube.npieces_i64(0, mx * cellcap)))
        U = 32
        Dpad = -(-Df // U) * U
        # rows pad to 32 x 128-column tiles; the operand is [Df, W/128, 128]
        W = -(-(card * sum(n for _, n in cols)) // 4096) * 4096
        if Dpad * W > self.MEMBER_MEM:
            return False
        key = f"MOP#{prefix}{spec['field']}#" + "|".join(
            f"{gk}:{n}" for gk, n in cols)
        dev = self._prep_cached(
            key,
            lambda: self._build_member_op(layout, col, Df, W,
                                          [ph for _, ph in planes],
                                          [n for _, n in cols]),
            to_host=lambda v: {"a": np.asarray(v)},
            from_host=lambda h: self._cube_put(h["a"], 3))
        self._need(key, dev)
        p["member_op"] = {"spec": spec, "key": key, "card": card,
                          "cols": cols, "pay": pay_meta}
        return True

    def _build_member_op(self, layout, col, Df, W, pay_planes, pieces):
        """One-time device build of the [Df_pad, W] per-(value, bucket)
        member operand from the PERMUTED per-position planes: U domain
        values per chunk, each chunk one fused compare + 32-block reduce
        + cumsum + bounds-difference pass, decomposed straight to int8
        pieces (i64 work stays inside the build; queries never touch it)."""
        from ..index.loader import _put
        perm = layout.perm
        mps = []
        for kk, ph in enumerate(col.multi_planes_host):
            ck = f"{col.name}:mp{kk}"
            if ck not in layout.cache:
                layout.cache[ck] = _put(np.asarray(ph[perm]), None)
            mps.append(layout.cache[ck])
        if "mo_avalid" not in layout.cache:
            av = ((self.dindex.alive_host[perm] > 0)
                  & (layout.valid_perm_host > 0))
            layout.cache["mo_avalid"] = _put(av.astype(np.int8), None)
        avalid = layout.cache["mo_avalid"]
        pays = [_put(np.asarray(ph[perm]).astype(np.int32), None)
                for ph in pay_planes]
        U = 32
        Dpad = -(-Df // U) * U
        R = int(mps[0].shape[0])
        NB = (R + 31) // 32
        # layout.bounds is ALREADY in 32-row block units (loader ALIGN)
        bnd = jnp.asarray(layout.bounds.astype(np.int64))

        def _pieces(x, n):
            # vectorized signed 7-bit decomposition (see npieces_i64);
            # NEVER a scalar accumulate chain (ROADMAP jit miscompile)
            out = []
            for i in range(n):
                pc = (x >> (7 * i)) & 127 if i < n - 1 \
                    else x >> (7 * (n - 1))
                out.append(pc.astype(jnp.int8))
            return out

        @jax.jit
        def chunk(u0, avalid, bnd, *planes):
            nmp = len(mps)
            mp_list, pay_list = planes[:nmp], planes[nmp:]
            u = u0 + jax.lax.iota(I32, U)
            m = jnp.zeros((U, R), dtype=bool)
            for mp in mp_list:
                m = m | (mp[None, :] == u[:, None])
            m = m & (avalid[None, :] > 0)

            def cells(blocks32):
                # [U, NB] i32 block aggregates -> [U, card] i64 exact
                # cell totals via cumsum + 32-unit bounds differences
                pref = jnp.cumsum(blocks32.astype(I64), axis=-1)
                at = jnp.concatenate(
                    [jnp.zeros((U, 1), I64), pref], axis=1)[:, bnd]
                return at[:, 1:] - at[:, :-1]

            cb = jnp.sum(m.reshape(U, NB, 32), axis=-1, dtype=I32)
            parts = _pieces(cells(cb), pieces[0])
            for pv, n in zip(pay_list, pieces[1:]):
                s = jnp.sum(jnp.where(m, pv[None, :], 0)
                            .reshape(U, NB, 32), axis=-1, dtype=I32)
                parts.extend(_pieces(cells(s), n))
            out = jnp.concatenate(parts, axis=1)
            # pad to the plan's tile-aligned row width, 3-D
            out = jnp.pad(out, ((0, 0), (0, W - out.shape[1])))
            return out.reshape(U, W // 128, 128)

        with jax.enable_x64(True):
            outs = [chunk(jnp.int32(u0), avalid, bnd, *mps, *pays)
                    for u0 in range(0, Dpad, U)]
            out = jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]
            return jax.block_until_ready(out)

    def _eval_prefix_member(self, node, params, arrays, p):
        """Prefix-mode bucket totals from ONE dynamic-slice row of the
        member operand: (per-bucket counts [card] i64, sub_out) — same
        contracts as the kernel/_perm_mask formulations, ~W bytes of HBM
        traffic and [card]-sized recombines per query."""
        mo = p["member_op"]
        spec, card = mo["spec"], mo["card"]
        op = arrays[mo["key"]]
        k = spec["pkey"]
        if spec["stringy"]:
            t = params[k + ":t"]
            tv = (t >= 0).astype(I32)
        else:
            # non-f64 narrow fields: the t0/t1 candidate pair is identical
            # (one mono per value), so one slice suffices
            t = params[k + ":t0"]
            tv = params[k + ":tv0"]
        idx = jnp.clip(t, 0, op.shape[0] - 1).astype(I32)
        # a vmapped msearch group turns this into one [B, W] row gather
        row = jax.lax.dynamic_slice(
            op, (idx, jnp.int32(0), jnp.int32(0)),
            (1,) + op.shape[1:]).reshape(-1)
        groups = {}
        with jax.enable_x64(True):
            tv64 = tv.astype(I64)  # invalid params zero every group
            off = 0
            for gk, n in mo["cols"]:
                sl = row[off * card:(off + n) * card] \
                    .reshape(n, card).astype(I64)
                # vectorized shift-sum (see ROADMAP: scalar accumulate
                # chains miscompile under jit)
                shifts = jnp.arange(n, dtype=I64) * 7
                groups[gk] = jnp.sum(sl << shifts[:, None],
                                     axis=0) * tv64
                off += n
        counts = groups["cnt"]
        sub_out = {}
        for name, sub in node.sub_aggs:
            if isinstance(sub, A.CountAgg):
                sub_out[name] = {"cnt": counts}
                continue
            meta = mo["pay"][sub.field]
            ssum = jnp.stack([groups[sk] for sk in meta["skeys"]], axis=-1)
            gcnt = groups[meta["cnt_key"]] if meta["cnt_key"] else counts
            if len(meta["skeys"]) == 1 and meta["direct"]:
                sub_out[name] = {"cnt": gcnt, "sum": ssum[:, 0]}
            else:
                sub_out[name] = {"cnt": gcnt, "sum": ssum}
        return counts, sub_out

    def _int_ranks(self, p, m):
        """0-based (lo, hi) rank pairs per percent, traced exactly in int64:
        rank = (q * (m-1)) // 100 (q integer <= 100: q * (m-1) < 100 * 2^36
        << 2^63); matches utils/exact.py percentile_rank for integer q."""
        ms = jnp.maximum(m - 1, 0)
        ranks = []
        for q in p["percents"]:
            num = jnp.int64(int(q)) * ms
            lo = num // 100
            hi = jnp.minimum(lo + 1, ms)
            ranks.extend([lo, hi])
        return ranks

    def _window_mask(self, p, params, arrays, blk, G=128):
        """Chain-mask bits of the G-row window at group `blk`, recomputed
        from dynamic slices of the ORIGINAL permuted planes (the cube path
        never materializes the [R] mask)."""
        prefix, chain = p["prefix"], p["chain"]
        base = (blk * G).astype(I32)
        sl = {prefix + k: jax.lax.dynamic_slice(
                  arrays[prefix + k], (base,), (G,))
              for k in ("alive", "lvalid", *p["ckeys"])}
        m = (sl[prefix + "alive"] > 0) & (sl[prefix + "lvalid"] > 0)
        for q, qpath in chain:
            m = m & qc.eval_mask(q, self.dindex, params, qpath, G, sl,
                                 prefix)
        return m

    def _eval_percentiles(self, node, ctx, params, arrays, path, p):
        field = node.field
        col = self._col(field)
        if p["pmode"] == "slot_rank":
            return self._eval_percentiles_slots(node, ctx, params, arrays,
                                                path, p)
        if p["pmode"] == "rank" and p.get("pcube") is not None:
            from ..ops import cube
            cb = p["pcube"]
            ind = self._cube_ind(cb, params)
            cblocks = cube.block_counts(ind, arrays[cb["key"]])
            # int32 prefix is exact (block counts <= G, totals <= Rn < 2^31)
            cum = jnp.cumsum(cblocks)
            m = self._madd(cum[-1].astype(I64))
            ranks = self._int_ranks(p, m)
            G = cb["G"]
            rows = _rank_select_rows_lazy(
                cum, jnp.stack(ranks),
                lambda blk: self._window_mask(p, params, arrays, blk, G),
                G=G)
            return {"m": m, "rows": rows}
        if p["pmode"] == "rank":
            # local (shard) row count: layout.n_rows is the global length
            Rn = arrays[p["prefix"] + "lvalid"].shape[0]
            if p.get("mask_gather"):
                # non-dense chain: take the already-evaluated doc mask
                # through the static permuted row->doc index plane
                vm = (jnp.take(ctx.mask, arrays[p["prefix"] + "pdoc"],
                               axis=0)
                      & (arrays[p["prefix"] + "lvalid"] > 0))
            else:
                vm = self._perm_mask(ctx.chain, params, arrays,
                                     p["prefix"], Rn)
            # int32 prefix: per-block counts <= 32 and totals <= Rn < 2^31,
            # so the cumsum is exact
            cum32 = jnp.cumsum(R.block32_counts(vm))
            m = self._madd(cum32[-1].astype(I64))
            if not p["int_percents"]:
                return {"m": m, "cum32": cum32,
                        "vmask_perm": vm.astype(jnp.int8)}
            ranks = self._int_ranks(p, m)
            if p.get("bisect"):
                planes = {k: arrays[p["prefix"] + k]
                          for k in (("sv0",) if p["narrow"]
                                    else ("sv0", "sv1"))}
                vals = _bisect_select_values(
                    planes, vm.astype(jnp.int8), cum32,
                    jnp.stack(ranks), p, self._madd)
                return {"m": m, "vals": vals}
            rows = _rank_select_rows(cum32, vm.astype(jnp.int8),
                                     jnp.stack(ranks))
            return {"m": m, "rows": rows}
        raise AssertionError(f"unknown pmode {p['pmode']!r}")

    def _window_mask32_slot(self, p, params, arrays, blk, s, G=32):
        """Chain-mask & slot bits of the G-row window at block `blk`,
        recomputed from dynamic slices of the ORIGINAL permuted planes
        (the cube path never materializes the [R] mask)."""
        prefix, chain = p["prefix"], p["chain"]
        base = (blk * G).astype(I32)
        sl = {prefix + k: jax.lax.dynamic_slice(
                  arrays[prefix + k], (base,), (G,))
              for k in ("alive", "lvalid", *p["ckeys"])}
        m = (sl[prefix + "alive"] > 0) & (sl[prefix + "lvalid"] > 0)
        for q, qpath in chain:
            m = m & qc.eval_mask(q, self.dindex, params, qpath, G, sl,
                                 prefix)
        srow = jax.lax.dynamic_slice(arrays[prefix + p["slotk"]],
                                     (base,), (G,))
        return m & (srow == s)

    def _eval_percentiles_slots_cube(self, node, params, arrays, p):
        """slot_rank via the value-domain cube: [ns, NB] per-slot block
        counts from one int8 matmul, then an int32 cumsum + in-trace
        integer ranks + lazy G-row window selection."""
        from ..ops import cube
        cb = p["scube"]
        ns, G = p["nslots"], cb["G"]
        ind = self._cube_ind(cb, params)
        cns = cube.slot_block_counts(ind, arrays[cb["key"]], ns)
        cum = jnp.cumsum(cns, axis=-1)
        m_s = self._madd(cum[:, -1].astype(I64))  # [ns]
        ms = jnp.maximum(m_s - 1, 0)
        ranks = []
        for q in node.percents:
            num = jnp.int64(int(q)) * ms
            lo = num // 100
            hi = jnp.minimum(lo + 1, ms)
            ranks.extend([lo, hi])
        ranks = jnp.stack(ranks, axis=1)  # [ns, 2P]
        rows = _slot_rank_select_rows_lazy(
            cum, ranks,
            lambda blk, s: self._window_mask32_slot(p, params, arrays,
                                                    blk, s, G),
            G=G)
        return {"m": m_s, "rows": rows}

    def _eval_percentiles_wslots(self, node, params, arrays, p):
        """Occurrence-WEIGHTED per-bucket percentiles (multi-valued terms
        ancestors, §3.2): K composite slot planes — one per parent value
        position, -1 where none — summed into per-(slot, 32-block) weighted
        counts; selection walks weighted windows. A doc with the parent
        value at j positions contributes its percentile values j times to
        that slot's multiset, exactly like the oracle's weighted
        recursion."""
        prefix = p["prefix"]
        Rn = arrays[prefix + "lvalid"].shape[0]
        ns = p["nslots"]
        vm = self._perm_mask(p["chain"], params, arrays, prefix, Rn)
        mt = p["mterms"]
        K = len(mt["keys"])
        slots_k = []
        for key in mt["keys"]:
            slot = jnp.zeros(Rn, I32)
            valid = vm
            for kind, f, meta in p["bchain"]:
                if kind == "hist":
                    bid = self._bucket_ids(meta, f, arrays, prefix)
                    slot = slot * meta["nb"] + bid
                elif kind == "terms":
                    colf = self._col(f)
                    ids = (arrays[prefix + f"{f}:w"]
                           if colf.ftype.is_stringy
                           else arrays[prefix + f"{f}:tid"])
                    valid = valid & (ids >= 0)
                    slot = slot * meta + jnp.maximum(ids, 0)
                else:  # mterms: substitute THIS position's bucket ids
                    mk = arrays[key]
                    valid = valid & (mk >= 0)
                    slot = slot * meta + jnp.maximum(mk, 0)
            slots_k.append(jnp.where(valid, slot, -1))
        wms = jnp.stack(slots_k)  # [K, R] composite slots per position
        # weighted per-slot 32-block counts: weights <= 32*K per block and
        # totals <= K*R < 2^31 keep the int32 cumsum exact
        oh = (wms.reshape(K, -1, 32)[:, :, :, None]
              == jnp.arange(ns, dtype=I32)[None, None, None, :])
        c32 = jnp.where(oh, 1, 0).sum(axis=(0, 2))  # [R/32, ns] int32
        cum = jnp.cumsum(c32, axis=0)
        m_s = self._madd(cum[-1, :].astype(I64))  # [ns] weighted counts
        if not p["int_percents"]:
            # phase 2 resolves ranks host-side (exact rationals), then one
            # weighted-window gather over these big intermediates
            return {"m": m_s, "cum": cum, "wms": wms}
        ms = jnp.maximum(m_s - 1, 0)
        ranks = []
        for q in node.percents:
            num = jnp.int64(int(q)) * ms
            lo = num // 100
            hi = jnp.minimum(lo + 1, ms)
            ranks.extend([lo, hi])
        ranks = jnp.stack(ranks, axis=1)  # [ns, 2P]
        rows = _wslot_rank_select_rows(cum, wms, ranks)
        return {"m": m_s, "rows": rows}

    def _eval_percentiles_slots(self, node, ctx, params, arrays, path, p):
        """Per-bucket percentiles: ancestor bucket slots recomputed in the
        value layout's permuted space; per-slot coarse prefix + rank rows."""
        if p.get("wslots"):
            return self._eval_percentiles_wslots(node, params, arrays, p)
        if p.get("scube") is not None:
            return self._eval_percentiles_slots_cube(node, params, arrays,
                                                     p)
        prefix = p["prefix"]
        # local (shard) row count: layout.n_rows is the global length
        Rn = arrays[prefix + "lvalid"].shape[0]
        ns = p["nslots"]
        vm = self._perm_mask(p["chain"], params, arrays, prefix, Rn)
        slot = jnp.zeros(Rn, I32)
        valid = jnp.ones(Rn, dtype=bool)
        for kind, f, meta in p["bchain"]:
            colf = self._col(f)
            if kind == "hist":
                bid = self._bucket_ids(meta, f, arrays, prefix)
                slot = slot * meta["nb"] + bid
            else:  # terms
                ids = (arrays[prefix + f"{f}:w"] if colf.ftype.is_stringy
                       else arrays[prefix + f"{f}:tid"])
                valid = valid & (ids >= 0)
                slot = slot * meta + jnp.maximum(ids, 0)
        vm = vm & valid
        # per-slot 32-block counts -> int32 prefixes [R/32, ns] (exact:
        # per-slot totals <= Rn < 2^31)
        c32 = R.slot_block32_counts(slot, vm, ns)
        cum = jnp.cumsum(c32, axis=0)  # [R/32, ns] per-shard prefixes
        m_s = self._madd(cum[-1, :].astype(I64))  # [ns] GLOBAL counts
        vm8 = vm.astype(jnp.int8)
        slot32 = slot
        if not p["int_percents"]:
            # phase 2 resolves ranks host-side (exact rationals), then one
            # device gather over these big intermediates (unsharded only —
            # plan-gated)
            return {"m": m_s, "cum": cum, "vm": vm8, "slot": slot32}

        ms = jnp.maximum(m_s - 1, 0)  # [ns]
        ranks = []
        for q in node.percents:
            num = jnp.int64(int(q)) * ms
            lo = num // 100
            hi = jnp.minimum(lo + 1, ms)
            ranks.extend([lo, hi])
        ranks = jnp.stack(ranks, axis=1)  # [ns, 2P]
        if p.get("slot_bisect"):
            # sharded: per-(slot, rank) cross-shard bisection over the
            # per-shard value-sorted planes — emits VALUES, no all-gather
            planes = {k: arrays[prefix + k]
                      for k in (("sv0",) if p["narrow"]
                                else ("sv0", "sv1"))}
            vals = _bisect_select_slot_values(planes, vm8, cum, slot32,
                                              ranks, p, self._madd)
            return {"m": m_s, "vals": vals}  # [ns], [ns, 2P]
        rows = _slot_rank_select_rows(cum, vm8, slot32, ranks)
        return {"m": m_s, "rows": rows}  # [ns], [ns, 2P]

    # -- histogram -----------------------------------------------------------

    def _bucket_ids(self, p, field, arrays, prefix=""):
        col = self._col(field)
        if p["hmode"] == "empty":
            base = arrays[prefix + f"{field}:w"] if (col.narrow or
                                                     col.ftype.is_stringy) \
                else arrays[prefix + f"{field}:hi"]
            return jnp.zeros(base.shape, I32)
        if p["hmode"] == "direct32":
            w = arrays[prefix + f"{field}:w"]
            return (w - p["w_base"]) // p["iv"]
        planes = self._planes_only_pfx(field, arrays, prefix)
        if p["hmode"] == "direct64":
            if col.narrow:
                rm = planes["w"].astype(I64)
                base = p["w_base"]
            else:
                rm = R.wide_recon(planes["hi"], planes["lo"])
                base = _wrap64(p["w_base"] - 2**63)
            return ((rm - base) // p["iv"]).astype(I32)
        # bounds
        rm = self._recon_rm(field, planes)
        j = jnp.zeros(rm.shape, I32)
        for b in p["rbounds"].tolist():
            j = j + (rm >= b).astype(I32)
        return j

    def _prefix_bucket_outputs(self, node, arrays, p, counts, vm):
        """Shared prefix-mode sub-agg evaluation (terms + large histograms):
        per-bucket exact sums/counts from permuted payload planes."""
        prefix = p["prefix"]
        bounds32 = self._local_bounds32(arrays, prefix)
        sub_out = {}
        for name, sub in node.sub_aggs:
            if isinstance(sub, A.CountAgg):
                sub_out[name] = {"cnt": counts}
                continue
            g = sub.field
            colg = self._col(g)
            L = self.plan[("payL", prefix, g)]["L"]
            planes = [arrays[prefix + f"pay:{g}:s{i}"] for i in range(L)]
            if colg.multi:
                cnt_rows = arrays[prefix + f"pay:{g}:cnt"]
                gcnt = self._madd(
                    R.prefix_diff_sums(cnt_rows, vm, bounds32))
            else:
                gcnt = counts
            sums = jnp.stack(
                [self._madd(R.prefix_diff_sums(pl, vm, bounds32))
                 for pl in planes], axis=-1)
            if len(planes) == 1 and not colg.multi and colg.sum_direct:
                sub_out[name] = {"cnt": gcnt, "sum": sums[:, 0]}
            else:
                sub_out[name] = {"cnt": gcnt, "sum": sums}
        return sub_out

    def _eval_histogram(self, node, ctx, params, arrays, path, p):
        nb = p["nb"]
        field = node.field
        col = self._col(field)
        if p["mode"] == "prefix":
            if p.get("member_op"):
                counts, sub_out = self._eval_prefix_member(node, params,
                                                           arrays, p)
                return {"counts": counts, **sub_out}
            prefix = p["prefix"]
            if p.get("mask_gather"):
                # non-dense chain: take the already-evaluated doc mask
                # through the static permuted row->doc index plane
                vm = (jnp.take(ctx.mask, arrays[prefix + "pdoc"], axis=0)
                      & (arrays[prefix + "lvalid"] > 0))
            else:
                vm = self._perm_mask(ctx.chain, params, arrays, prefix,
                                     arrays[prefix + "lvalid"].shape[0])
            bounds32 = self._local_bounds32(arrays, prefix)
            counts = self._madd(R.prefix_diff_counts(vm, bounds32))
            out = {"counts": counts}
            out.update(self._prefix_bucket_outputs(node, arrays, p, counts,
                                                   vm))
            return out
        if p.get("cube") is not None and isinstance(ctx, MaskCtx):
            counts, sub_out = self._eval_bucket_cube(node, p, params,
                                                     arrays)
            rest = [ns2 for ns2 in node.sub_aggs
                    if ns2[0] not in sub_out]
            if rest:
                # ctx-free subs (slot_rank percentiles): see _eval_terms
                bid_r = arrays[p["bid_key"]]
                sub_ctx = SlotCtx(bid_r, ctx.mask, (nb,), True, None,
                                  p["mode"], bid_static=True)
                sod, svd = self._chain_slots(sub_ctx)
                sub_ctx.slot_of_doc = sod
                sub_ctx.slot_valid_of_doc = svd
                for name, sub in rest:
                    sub_out[name] = self._eval(sub, sub_ctx, params,
                                               arrays, path + (name,))
            return {"counts": counts, **sub_out}
        bid_own = arrays[p["bid_key"]]
        if isinstance(ctx, MaskCtx):
            if col.multi:
                rdoc = arrays[f"{field}:doc"]
                valid = ctx.mask[rdoc] & (arrays[f"{field}:valid"] > 0)
                rows_are_docs = False
            else:
                rdoc = None
                valid = ctx.mask
                rows_are_docs = True
            bid = bid_own
            dims = (nb,)
        else:
            if p.get("xpand"):
                # multi child under a multi row-space ancestor: static
                # (parent row, child row) pair expansion — each pair is one
                # collect of this child (§3.2 weighted recursion on device)
                xp = p["xpand"]
                prow, crow = arrays[xp["prow"]], arrays[xp["crow"]]
                rdoc = arrays[xp["doc"]]
                rows_are_docs = False
                pslot = jnp.where(ctx.valid, ctx.bid, -1)[prow]
                valid = (arrays[xp["valid"]] > 0) & (pslot >= 0)
                bid_c = bid_own[crow]
            elif ctx.slot_of_doc is None:
                # row-space chaining under a multi-valued ancestor: each
                # parent value row is one collect of this child (§3.2
                # occurrence weighting); child values gather at the row's doc
                rdoc = ctx.doc
                rows_are_docs = ctx.rows_are_docs
                pslot = jnp.where(ctx.valid, ctx.bid, -1)
                valid = ctx.valid
                bid_c = bid_own if rows_are_docs else bid_own[ctx.doc]
            elif col.multi:
                rdoc = arrays[f"{field}:doc"]
                gvalid = arrays[f"{field}:valid"] > 0
                rows_are_docs = False
                pslot = ctx.slot_of_doc[rdoc]
                pvalid = ctx.slot_valid_of_doc[rdoc]
                valid = gvalid & pvalid
                bid_c = bid_own
            else:
                rdoc = None
                rows_are_docs = True
                pslot = ctx.slot_of_doc
                valid = ctx.slot_valid_of_doc
                bid_c = bid_own
            bid = jnp.where(pslot >= 0, pslot, 0) * nb + bid_c
            bid = jnp.where(pslot >= 0, bid, -1)
            dims = ctx.dims + (nb,)
        sub_ctx = SlotCtx(bid, valid, dims, rows_are_docs, rdoc, p["mode"],
                          bid_static=isinstance(ctx, MaskCtx))
        out = {"counts": self._madd(self._slot_counts(sub_ctx))}
        if node.sub_aggs:
            doc_rooted = isinstance(ctx, MaskCtx) or ctx.slot_of_doc is not None
            if p["chain_ok"] and doc_rooted:
                sod, svd = self._chain_slots(sub_ctx)
                sub_ctx.slot_of_doc = sod
                sub_ctx.slot_valid_of_doc = svd
            for name, sub in node.sub_aggs:
                out[name] = self._eval(sub, sub_ctx, params, arrays,
                                       path + (name,))
        return out

    def _chain_slots(self, ctx: SlotCtx):
        if ctx.rows_are_docs:
            return jnp.where(ctx.valid, ctx.bid, -1), ctx.valid
        T = self._lT
        sod = jnp.full(T, -1, I32).at[ctx.doc].max(
            jnp.where(ctx.valid, ctx.bid.astype(I32), -1), mode="drop")
        return sod, sod >= 0

    # -- terms ---------------------------------------------------------------

    def _eval_terms(self, node, ctx, params, arrays, path, p):
        card, keff = p["card"], p["keff"]
        field = node.field
        col = self._col(field)

        if p["mode"] == "prefix":
            return self._eval_terms_prefix(node, ctx, params, arrays, path, p)
        if p.get("cube") is not None and isinstance(ctx, MaskCtx):
            counts, sub_out = self._eval_bucket_cube(node, p, params,
                                                     arrays)
            rest = [ns2 for ns2 in node.sub_aggs
                    if ns2[0] not in sub_out]
            if rest:
                # ctx-free subs (slot_rank percentiles): hand them the
                # standard slot ctx anyway — they never read it, so XLA
                # DCEs the whole row pass at compile
                ids_r = arrays[f"{field}:w"] if col.ftype.is_stringy \
                    else arrays[f"{field}:tid"]
                valid_r = ctx.mask & (ids_r >= 0)
                sub_ctx = SlotCtx(ids_r, valid_r, (card,), True, None,
                                  p["mode"], bid_static=True)
                sod, svd = self._chain_slots(sub_ctx)
                sub_ctx.slot_of_doc = sod
                sub_ctx.slot_valid_of_doc = svd
                for name, sub in rest:
                    sub_out[name] = self._eval(sub, sub_ctx, params,
                                               arrays, path + (name,))
            return self._terms_select_traced(p, counts, sub_out, 1)

        ids = arrays[f"{field}:w"] if col.ftype.is_stringy \
            else arrays[f"{field}:tid"]
        if (isinstance(ctx, MaskCtx) and p.get("plane_fanout")
                and p["mode"] == "dense"):
            # short multi keyword: per-position dense planes (doc-aligned) —
            # no value-row gather; sub-agg fruits merge across positions
            # BEFORE any top-k (nested terms defer their selection until the
            # merge, so per-position partial selections never happen)
            per_plane = []
            self._defer_topk += 1
            try:
                for kk in range(len(col.multi_planes_host)):
                    pk = arrays[f"{field}:mp{kk}"]
                    valid_k = ctx.mask & (pk >= 0)
                    sub_ctx = SlotCtx(pk, valid_k, (card,), True, None,
                                      "dense",
                                      slot_of_doc=jnp.where(valid_k, pk, -1),
                                      slot_valid_of_doc=valid_k,
                                      bid_static=True)
                    one = {"counts": self._slot_counts(sub_ctx)}
                    for name, sub in node.sub_aggs:
                        one[name] = self._eval(sub, sub_ctx, params, arrays,
                                               path + (name,))
                    per_plane.append(one)
            finally:
                self._defer_topk -= 1
            # NB: sub-agg evals are already cross-shard-merged internally;
            # only the raw counts need the psum here
            merged = self._merge_plane_outs(per_plane)
            counts = self._madd(merged.pop("counts"))
            merged = self._apply_deferred_topk(node.sub_aggs, merged,
                                               path, card)
            return self._terms_select_traced(p, counts, merged, 1)
        if isinstance(ctx, MaskCtx):
            if col.multi:
                rdoc = arrays[f"{field}:doc"]
                vmask = ctx.mask[rdoc] & (arrays[f"{field}:valid"] > 0)
                rows_are_docs = False
            else:
                rdoc = None
                vmask = ctx.mask
                rows_are_docs = True
            bid = ids
            valid = vmask & (ids >= 0)
            anc_flat = 1
            dims = (card,)
        else:
            if p.get("xpand"):
                # multi child under a multi row-space ancestor: static pair
                # expansion (see _eval_histogram / _build_xpand)
                xp = p["xpand"]
                prow, crow = arrays[xp["prow"]], arrays[xp["crow"]]
                rdoc = arrays[xp["doc"]]
                rows_are_docs = False
                ids_r = ids[crow]
                pslot = jnp.where(ctx.valid, ctx.bid, -1)[prow]
                valid = ((arrays[xp["valid"]] > 0) & (pslot >= 0)
                         & (ids_r >= 0))
            elif ctx.slot_of_doc is None:
                # row-space chaining under a multi-valued ancestor (see
                # _eval_histogram): child ids gather at each parent row's doc
                rdoc = ctx.doc
                rows_are_docs = ctx.rows_are_docs
                ids_r = ids if rows_are_docs else ids[ctx.doc]
                pslot = jnp.where(ctx.valid, ctx.bid, -1)
                valid = ctx.valid & (ids_r >= 0)
            elif col.multi:
                rdoc = arrays[f"{field}:doc"]
                gvalid = arrays[f"{field}:valid"] > 0
                rows_are_docs = False
                pslot = ctx.slot_of_doc[rdoc]
                pvalid = ctx.slot_valid_of_doc[rdoc]
                valid = gvalid & pvalid & (ids >= 0)
                ids_r = ids
            else:
                rdoc = None
                rows_are_docs = True
                pslot = ctx.slot_of_doc
                valid = ctx.slot_valid_of_doc & (ids >= 0)
                ids_r = ids
            bid = jnp.where(pslot >= 0, pslot, 0) * card + ids_r
            bid = jnp.where((pslot >= 0) & (ids_r >= 0), bid, -1)
            anc_flat = ctx.nslots
            dims = ctx.dims + (card,)
        sub_ctx = SlotCtx(bid, valid, dims, rows_are_docs, rdoc, p["mode"],
                          bid_static=isinstance(ctx, MaskCtx))
        counts = self._madd(self._slot_counts(sub_ctx))

        sub_out = {}
        if node.sub_aggs:
            doc_rooted = isinstance(ctx, MaskCtx) or ctx.slot_of_doc is not None
            if p["chain_ok"] and doc_rooted:
                sod, svd = self._chain_slots(sub_ctx)
                sub_ctx.slot_of_doc = sod
                sub_ctx.slot_valid_of_doc = svd
            for name, sub in node.sub_aggs:
                sub_out[name] = self._eval(sub, sub_ctx, params, arrays,
                                           path + (name,))
        if self._defer_topk:
            # inside a plane fan-out: selection happens after the merge
            return {"counts": counts, **sub_out}
        return self._terms_select_traced(p, counts, sub_out, anc_flat)

    def _apply_deferred_topk(self, sub_aggs, out, path, anc_flat):
        """Post-merge pass over a plane-fanout subtree: run top-k (+sub
        gather) for every nested terms node, deepest first."""
        for name, sub in sub_aggs:
            if isinstance(sub, A.TermsAgg):
                sp = self.plan[path + (name,)]
                inner = out[name]
                inner = self._apply_deferred_topk(
                    sub.sub_aggs, inner, path + (name,),
                    anc_flat * sp["card"])
                counts = inner.pop("counts")
                out[name] = self._terms_select_traced(sp, counts, inner,
                                                      anc_flat)
            elif isinstance(sub, A.HistogramAgg):
                hp = self.plan[path + (name,)]
                out[name] = self._apply_deferred_topk(
                    sub.sub_aggs, out[name], path + (name,),
                    anc_flat * hp["nb"])
            elif isinstance(sub, (A.FilterAgg, A.PostFilterAgg)):
                out[name] = self._apply_deferred_topk(
                    sub.sub_aggs, out[name], path + (name,), anc_flat)
        return out

    def _terms_select_traced(self, p, counts, sub_out, anc_flat):
        """Dispatch the planned selection mode (see _plan_terms_order)."""
        card, keff = p["card"], p["keff"]
        if p["sel"] == "host":
            return self._terms_all(counts, sub_out, anc_flat, card)
        if p["sel"] == "topk":
            return self._terms_topk(counts, sub_out, anc_flat, card, keff)
        return self._terms_topk_ordered(p, counts, sub_out, anc_flat)

    @staticmethod
    def _terms_all(counts, sub_out, anc_flat, card):
        """No device selection (host-side ordering): per-bucket fruits for
        ALL card buckets plus per-ancestor totals."""
        total = jnp.sum(counts.reshape(anc_flat, card), axis=1)
        return {"counts": counts, "total": total.reshape(anc_flat),
                **sub_out}

    @staticmethod
    def _gather_top(c2, top_ids, sub_out, anc_flat, card, keff):
        top_counts = jnp.take_along_axis(c2, top_ids, axis=1)
        total = jnp.sum(c2, axis=1)

        def gather(a):
            rest = a.shape[0] // (anc_flat * card)
            b = a.reshape((anc_flat, card, rest) + a.shape[1:])
            g = b[jnp.arange(anc_flat)[:, None], top_ids]
            return g.reshape((anc_flat * keff * rest,) + a.shape[1:])

        sub_out = jax.tree_util.tree_map(gather, sub_out)
        return {"counts": top_counts.reshape(anc_flat * keff),
                "ids": top_ids.reshape(anc_flat * keff).astype(I32),
                "total": total.reshape(anc_flat),
                **sub_out}

    @staticmethod
    def _terms_topk(counts, sub_out, anc_flat, card, keff):
        c2 = counts.reshape(anc_flat, card)
        ids = jnp.arange(card, dtype=I64)
        key = c2 * (1 << 27) + (card - 1 - ids)[None, :]
        _, top_ids = jax.lax.top_k(key, keff)
        return Program._gather_top(c2, top_ids, sub_out, anc_flat, card,
                                   keff)

    @staticmethod
    def _terms_topk_ordered(p, counts, sub_out, anc_flat):
        """Selection for non-default `order`: batched 3-key sort over
        (validity class, exact int64 order key, bucket id). Validity class:
        0 = present bucket with a non-null order metric, 1 = present bucket
        whose order metric is null (sorts after all non-null, key asc —
        oracle semantics), 2 = absent bucket (count 0; never emitted).
        Bucket ids ascend in key order by construction of the global
        term/value tables, so the id tie-break IS the key-asc tie-break."""
        card, keff = p["card"], p["keff"]
        target, direction = p["order"]
        c2 = counts.reshape(anc_flat, card)
        iota = jnp.broadcast_to(jnp.arange(card, dtype=I64)[None, :],
                                (anc_flat, card))
        none = jnp.zeros((anc_flat, card), dtype=bool)
        if target == "_count":
            okey = c2
        elif target == "_key":
            okey = iota
        else:
            sr = sub_out[target]
            mcnt = sr["cnt"].reshape(anc_flat, card)
            if "min" in sr or "max" in sr:
                v = (sr["min"] if "min" in sr else sr["max"])
                okey = v.reshape(anc_flat, card).astype(I64)
                none = mcnt == 0
            elif "sum" in sr:
                okey = (sr["sum"].reshape(anc_flat, card)
                        + mcnt * p["order_mu"])  # exact (plan-proved bound)
            else:  # count sub-agg
                okey = mcnt
        okey = jnp.where(none, 0, okey)
        if direction == "desc":
            okey = jnp.where(none, 0, -okey)
        flag = jnp.where(c2 > 0, jnp.where(none, 1, 0), 2).astype(I32)
        _, _, sid = jax.lax.sort((flag, okey, iota), dimension=1, num_keys=3)
        top_ids = sid[:, :keff]
        return Program._gather_top(c2, top_ids, sub_out, anc_flat, card,
                                   keff)

    def _local_bounds32(self, arrays, prefix):
        """This shard's bucket bounds: sharded layouts register [D, card+1]
        (axis 0 over 'd'), so inside shard_map the local slice is
        [1, card+1] — flatten it back to [card+1]."""
        b = arrays[prefix + "bounds32"]
        return b.reshape(-1) if b.ndim == 2 else b

    def _eval_terms_prefix(self, node, ctx, params, arrays, path, p):
        if p.get("member_op"):
            counts, sub_out = self._eval_prefix_member(node, params,
                                                       arrays, p)
            return self._terms_select_traced(p, counts, sub_out, 1)
        prefix = p["prefix"]
        if p.get("mask_gather"):
            # non-dense chain (token streams / CSR tails): gather the doc
            # mask through the static pdoc plane — no chain re-eval
            vm = (jnp.take(ctx.mask, arrays[prefix + "pdoc"], axis=0)
                  & (arrays[prefix + "lvalid"] > 0))
        else:
            vm = self._perm_mask(ctx.chain, params, arrays, prefix,
                                 arrays[prefix + "lvalid"].shape[0])
        counts = self._madd(R.prefix_diff_counts(
            vm, self._local_bounds32(arrays, prefix)))
        sub_out = self._prefix_bucket_outputs(node, arrays, p, counts, vm)
        return self._terms_select_traced(p, counts, sub_out, 1)

    # -- top hits ------------------------------------------------------------

    def _eval_top_hits_slots(self, node, ctx, arrays, path, p):
        """Per-bucket top hits: one batched 3-key sort with the flat slot id
        as the leading key, then a contiguous per-slot gather (slots are
        runs in the sorted order). Sharded meshes sort per shard, gather
        only the k candidates per (shard, slot), and k-way merge with one
        more [ns, D*k] sort — O(ns * D * k) cross-chip traffic, never
        O(rows) (VERDICT r2 #5)."""
        ns = ctx.nslots
        k = min(p["k"], self._lT)
        rows_doc = None if ctx.rows_are_docs else ctx.doc
        if p.get("score"):
            # score order: constant key, (slot, doc) tie-break does it all
            key = jnp.zeros(self._lT if rows_doc is None
                            else rows_doc.shape[0], dtype=I64)
        else:
            field = node.sort_field
            planes = self._planes_only(field, arrays)
            rm = self._recon_rm(field, planes)
            rm_rows = rm if rows_doc is None else rm[rows_doc]
            key = rm_rows if node.ascending else ~rm_rows
        skey = jnp.where(ctx.valid & (ctx.bid >= 0),
                         ctx.bid.astype(I32), ns)
        doc = (jnp.arange(self._lT, dtype=I64) if rows_doc is None
               else rows_doc.astype(I64))
        if self._sharded:
            # globalize shard-local doc/row ids (each shard owns one
            # contiguous doc block, so ties still break on global doc id)
            doc = doc + jax.lax.axis_index("d").astype(I64) * self._lT
        if not ctx.rows_are_docs:
            # collapse occurrence weights: one hit per (slot, doc) (§A.9);
            # a doc's value rows all live on its owning shard, so the
            # per-shard collapse is also the global one
            s1, d1, k1 = jax.lax.sort((skey, doc, key), num_keys=2)
            dup = jnp.concatenate([
                jnp.zeros(1, dtype=bool),
                (s1[1:] == s1[:-1]) & (d1[1:] == d1[:-1])])
            skey, doc, key = jnp.where(dup, ns, s1), d1, k1
        s2, k2, d2 = jax.lax.sort((skey, key, doc), num_keys=3)
        starts = jnp.searchsorted(s2, jnp.arange(ns + 1, dtype=I32))
        m_s = (starts[1:] - starts[:-1]).astype(I64)
        rows = jnp.minimum(starts[:-1, None].astype(I64)
                           + jnp.arange(k, dtype=I64)[None, :],
                           s2.shape[0] - 1)
        validk = jnp.arange(k, dtype=I64)[None, :] < m_s[:, None]
        if self._sharded:
            # k-way merge of the per-shard candidates: matched-ness leads
            # (unmatched candidates carry garbage key/doc and sort last)
            inv = jnp.where(validk, 0, 1).astype(I32)
            ck, cd = k2[rows], d2[rows]
            gi = jnp.moveaxis(jax.lax.all_gather(inv, "d"), 1, 0) \
                .reshape(ns, -1)
            gk = jnp.moveaxis(jax.lax.all_gather(ck, "d"), 1, 0) \
                .reshape(ns, -1)
            gd = jnp.moveaxis(jax.lax.all_gather(cd, "d"), 1, 0) \
                .reshape(ns, -1)
            mi, mk, md = jax.lax.sort((gi, gk, gd), dimension=1, num_keys=3)
            m_s = self._madd(m_s)
            validk = jnp.arange(k, dtype=I64)[None, :] < m_s[:, None]
            keys = jnp.where(validk, mk[:, :k], 0)
            docs = jnp.where(validk, md[:, :k], 0)
            return {"keys": keys, "docs": docs, "m": m_s}
        keys = jnp.where(validk, k2[rows], 0)
        docs = jnp.where(validk, d2[rows], 0)
        return {"keys": keys, "docs": docs, "m": m_s}

    def _eval_top_hits(self, node, ctx, arrays, path, p):
        if not isinstance(ctx, MaskCtx):
            return self._eval_top_hits_slots(node, ctx, arrays, path, p)
        # matched-ness is an explicit leading sort key, NOT a value sentinel:
        # on wide columns the descending key ~rm of the column-min doc equals
        # I64_MAX exactly, so a sentinel would tie matched rows with
        # unmatched ones and let the doc-id tie-break pick a non-match
        inv = jnp.where(ctx.mask, 0, 1).astype(I32)
        if p.get("score"):
            # score order (§A.10): constant key; doc tie-break selects the
            # first-k matched docs
            key = jnp.zeros(self._lT, dtype=I64)
        else:
            field = node.sort_field
            planes = self._planes_only(field, arrays)
            rm = self._recon_rm(field, planes)
            key = rm if node.ascending else ~rm
        doc = jnp.arange(self._lT, dtype=I64)
        if self._sharded:
            doc = doc + jax.lax.axis_index("d").astype(I64) * self._lT
        si, sk, sd = jax.lax.sort((inv, key, doc), num_keys=3)
        k = min(p["k"], self._lT)
        si, sk, sd = si[:k], sk[:k], sd[:k]
        if self._sharded:
            si = jax.lax.all_gather(si, "d", tiled=True)
            sk = jax.lax.all_gather(sk, "d", tiled=True)
            sd = jax.lax.all_gather(sd, "d", tiled=True)
            si, sk, sd = jax.lax.sort((si, sk, sd), num_keys=3)
            sk, sd = sk[:p["k"]], sd[:p["k"]]
        return {"keys": sk, "docs": sd, "m": self._madd(R.ts_count(ctx.mask))}

    # ======================================================================
    # fetch (batched device->host)
    # ======================================================================

    def _pack_outputs(self, out, aggs):
        """Trace-time fruit packing: walk the agg tree in deterministic
        order, keep every small integer leaf, concatenate into ONE int64
        vector (all device fruits are integral by design — exact limb sums,
        w-domain min/max, counts, ids). Big per-row intermediates
        (non-integer-percent percentile state) stay separate device arrays
        for the phase-2 gather machinery."""
        spec = []
        parts = []
        bigs = {}

        def keep(path, key, v):
            spec.append((path, key, tuple(v.shape)))
            parts.append(v.reshape(-1).astype(I64))

        def strip(node, r, path):
            if isinstance(node, (dict, tuple)):
                items = node.items() if isinstance(node, dict) else node
                for n, s in items:
                    strip(s, r[n], path + (n,))
                return
            if isinstance(node, A.PercentilesAgg):
                p = self.plan[path]
                keep(path, "m", r["m"])
                if "vals" in r:
                    keep(path, "vals", r["vals"])
                elif "rows" in r:
                    keep(path, "rows", r["rows"])
                elif p["pmode"] == "slot_rank":
                    bigs["/".join(path)] = ((r["cum"], r["wms"])
                                            if "wms" in r
                                            else (r["cum"], r["vm"],
                                                  r["slot"]))
                elif p["pmode"] == "rank":
                    bigs["/".join(path)] = (r["cum32"], r["vmask_perm"])
                return
            if isinstance(node, (A.HistogramAgg, A.TermsAgg,
                                 A.FilterAgg, A.PostFilterAgg)):
                for k, v in r.items():
                    if not isinstance(v, dict):
                        keep(path, k, v)
                for n, s in node.sub_aggs:
                    strip(s, r[n], path + (n,))
                return
            for k, v in r.items():  # metric / count / top_hits leaf dicts
                keep(path, k, v)

        strip(aggs, out, ("a",))
        self._pack_spec = spec
        self._big_path_of = {"/".join(p): p for p in
                             (self.plan.keys())
                             if isinstance(p, tuple) and p and p[0] == "a"}
        return {"packed": jnp.concatenate(parts), "big": bigs}

    def _unpack_host(self, vec: np.ndarray):
        """One packed int64 host vector -> nested fruit dict of np views."""
        host: Dict[str, dict] = {}
        off = 0
        for path, key, shape in self._pack_spec:
            node = host
            for k in path[1:]:
                node = node.setdefault(k, {})
            size = 1
            for d in shape:
                size *= d
            node[key] = (vec[off:off + size].reshape(shape) if shape
                         else vec[off])
            off += size
        return host

    def fetch_strip(self, aggs, raw):
        """(packed fruit vector, big device intermediates keyed by path)."""
        return raw["packed"], {self._big_path_of[k]: v
                               for k, v in raw["big"].items()}

    @staticmethod
    def _node_at(host, path):
        node = host
        for k in path[1:]:
            node = node[k]
        return node

    def _slot_ranks(self, p, node_host) -> np.ndarray:
        """[ns, 2P] exact 0-based rank pairs for a slot_rank phase-2 node."""
        m_vec = np.asarray(node_host["m"]).reshape(-1)
        ns = m_vec.shape[0]
        ranks = np.zeros((ns, 2 * len(p["percents"])), np.int64)
        for s in range(ns):
            m = int(m_vec[s])
            if m == 0:
                continue
            for i, q in enumerate(p["percents"]):
                lo, hi, _ = exact.percentile_rank(q, m)
                ranks[s, 2 * i], ranks[s, 2 * i + 1] = lo, hi
        return ranks

    def _bisect_phase2(self, path, p, batched: bool):
        """Jitted cross-shard bisection select for phase-2 (non-integer
        percents): host-resolved ranks + per-shard (cum32, vmask) prefix
        intermediates -> selected values, replicated. `batched` adds a
        leading msearch batch axis on (cum32, vm, ranks)."""
        cache = self.__dict__.setdefault("_phase2_cache", {})
        key = (path, batched)
        if key not in cache:
            from jax.sharding import PartitionSpec as P
            keys = ("sv0",) if p["narrow"] else ("sv0", "sv1")

            def one(cum32, vm8, ranks, planes):
                with jax.enable_x64(True):
                    return _bisect_select_values(
                        planes, vm8, cum32, ranks, p,
                        lambda x: jax.lax.psum(x, "d"))

            if batched:
                def f(c, v, r, pl):
                    return jax.vmap(
                        lambda cb, vb, rb: one(cb, vb, rb, pl))(c, v, r)
                in_specs = (P(None, "d"), P(None, "d"), P(),
                            {k: P("d") for k in keys})
            else:
                f = one
                in_specs = (P("d"), P("d"), P(), {k: P("d") for k in keys})
            fn = jax.shard_map(f, mesh=self.dindex.mesh, in_specs=in_specs,
                               out_specs=P(), check_vma=False)
            cache[key] = (jax.jit(fn),
                          {k: self._arrays[p["prefix"] + k] for k in keys})
        return cache[key]

    def _slot_bisect_phase2(self, path, p, batched: bool):
        """Jitted per-slot cross-shard bisection select for phase-2
        (non-integer percents under bucket aggs on a mesh): host-resolved
        ranks + per-shard (cum32 [R/32, ns], vm8, slot32) intermediates ->
        selected VALUES [ns, 2P], replicated — the same
        _bisect_select_slot_values the integer path runs in-trace."""
        cache = self.__dict__.setdefault("_phase2_cache", {})
        key = (path, batched, "slot")
        if key not in cache:
            from jax.sharding import PartitionSpec as P
            keys = ("sv0",) if p["narrow"] else ("sv0", "sv1")

            def one(cum, vm8, slot32, ranks, planes):
                with jax.enable_x64(True):
                    return _bisect_select_slot_values(
                        planes, vm8, cum, slot32, ranks, p,
                        lambda x: jax.lax.psum(x, "d"))

            if batched:
                def f(c, v, s, r, pl):
                    return jax.vmap(
                        lambda cb, vb, sb, rb: one(cb, vb, sb, rb, pl))(
                            c, v, s, r)
                in_specs = (P(None, "d"), P(None, "d"), P(None, "d"), P(),
                            {k: P("d") for k in keys})
            else:
                f = one
                in_specs = (P("d"), P("d"), P("d"), P(),
                            {k: P("d") for k in keys})
            fn = jax.shard_map(f, mesh=self.dindex.mesh, in_specs=in_specs,
                               out_specs=P(), check_vma=False)
            cache[key] = (jax.jit(fn),
                          {k: self._arrays[p["prefix"] + k] for k in keys})
        return cache[key]

    def percentile_gathers(self, host, big):
        gathers = {}
        for path, dev in big.items():
            node_host = self._node_at(host, path)
            p = self.plan[path]
            if p["pmode"] == "slot_rank":
                with jax.enable_x64(True):
                    rk = jnp.asarray(self._slot_ranks(p, node_host), I64)
                if p.get("wslots"):
                    cum, wms = dev
                    gathers[path] = _wslot_rank_select(cum, wms, rk)
                elif p.get("phase2_vals"):
                    cum, vm8, slot32 = dev
                    fn, planes = self._slot_bisect_phase2(path, p, False)
                    gathers[path] = fn(cum, vm8, slot32, rk, planes)
                else:
                    cum, vm8, slot32 = dev
                    gathers[path] = _slot_rank_select(cum, vm8, slot32, rk)
                continue
            m = int(node_host["m"])
            fracs, ranks = [], []
            for q in p["percents"]:
                if m == 0:
                    lo = hi = 0
                    fr = 0.0
                else:
                    lo, hi, fr = exact.percentile_rank(q, m)
                fracs.append(fr)
                ranks.extend([lo, hi])
            node_host["_fracs"] = fracs
            with jax.enable_x64(True):
                rarr = jnp.asarray(ranks, I64)
            if p.get("bisect"):
                cum32, vm = dev
                fn, planes = self._bisect_phase2(path, p, False)
                gathers[path] = fn(cum32, vm, rarr, planes)
            else:
                cum32, vm = dev
                gathers[path] = _rank_select(cum32, vm, rarr)
        return gathers

    def attach_percentiles(self, host, got):
        for path, vals in got.items():
            self._node_at(host, path)["pvals"] = vals

    # ======================================================================
    # harvest
    # ======================================================================

    @staticmethod
    def _flat(raw, flat, key):
        """Fruit scalar for this node at flattened bucket-prefix index
        `flat` (None = root scope, raw entries are unbucketed scalars).
        The flat index is threaded down the recursion as a plain int
        (child = parent * child_axis + j) instead of re-raveling prefix
        tuples per bucket — np.ravel_multi_index boxing was ~60% of the
        measured host harvest cost on bucketed trees (74ms/128-query
        batch on bench c3)."""
        a = raw[key]
        if flat is None:
            return a
        return a[flat]

    def _harvest(self, node, raw, path, flat):
        """`flat`: flattened index of the enclosing bucket prefix under
        this node's hdims chain (row-major, matching the device fruit
        layout), or None at root."""
        if isinstance(node, A.CountAgg):
            return {"value": int(self._flat(raw, flat, "cnt"))}
        if isinstance(node, (A.SumAgg, A.MinAgg, A.MaxAgg, A.AvgAgg,
                             A.StatsAgg)):
            return self._harvest_metric(node, raw, path, flat)
        if isinstance(node, A.PercentilesAgg):
            return self._harvest_percentiles(node, raw, path, flat)
        if isinstance(node, A.HistogramAgg):
            return self._harvest_histogram(node, raw, path, flat)
        if isinstance(node, A.FacetAgg):
            return self._harvest_facet(node, raw, path, flat)
        if isinstance(node, A.TermsAgg):
            return self._harvest_terms(node, raw, path, flat)
        if isinstance(node, (A.FilterAgg, A.PostFilterAgg)):
            out = {"doc_count": int(self._flat(raw, flat, "cnt"))}
            for name, sub in node.sub_aggs:
                out[name] = self._harvest(sub, raw[name], path + (name,),
                                          flat)
            return out
        if isinstance(node, A.TopHitsAgg):
            return self._harvest_top_hits(node, raw, path, flat)
        raise TypeError(f"unknown agg {type(node)!r}")

    def _mono_from_mm(self, p, raw_val) -> int:
        """Device min/max output (narrow: w int32; wide: rm int64) -> mono."""
        if p["narrow"]:
            w = int(raw_val)
        else:
            w = int(raw_val) + 2**63
        return _wrap64(p["min_mono"] + w)

    def _user_scalar(self, ftype, mono: int):
        v = mono_mod.scalar_from_mono(ftype.value, mono)
        return float(v) if ftype == FieldType.F64 else int(v)

    def _reconstruct_sum(self, p, sum_out, cnt: int):
        if p["ftype"] == FieldType.F64:
            return exact.f64_reconstruct_sum(
                np.atleast_1d(np.asarray(sum_out)), p["base"])
        if p["direct"] and np.ndim(sum_out) == 0:
            return int(sum_out) + cnt * int(p["min_user"])
        return exact.int_reconstruct_sum(np.asarray(sum_out)) \
            + cnt * int(p["min_user"])

    def _sum_at(self, p, raw, flat, cnt: int):
        """_reconstruct_sum for a bucketed node, with a vectorized fast
        path: integer limb accumulators recombine for ALL buckets in one
        int64 numpy pass (cached on the raw dict) when the per-limb
        magnitude bound proves the int64 math cannot overflow; per-bucket
        Python big-int exactness otherwise. Same result by construction —
        the fast path only runs when its values equal the big-int ones."""
        if flat is None or p["ftype"] == FieldType.F64:
            return self._reconstruct_sum(p, self._flat(raw, flat, "sum"),
                                         cnt)
        a = np.asarray(raw["sum"])
        if a.ndim < 2:  # direct mode: one int32-ranged scalar per bucket
            return int(a[flat]) + cnt * int(p["min_user"])
        tot = raw.get("_sumtot", None)
        if tot is None:
            tot = _limb_totals_vec(a)
            raw["_sumtot"] = False if tot is None else tot
        if tot is not False:
            return int(tot[flat]) + cnt * int(p["min_user"])
        return exact.int_reconstruct_sum(a[flat]) + cnt * int(p["min_user"])

    def _harvest_metric(self, node, raw, path, flat):
        p = self.plan[path]
        ftype = p["ftype"]
        cnt = int(self._flat(raw, flat, "cnt"))

        def mmval(key):
            if cnt == 0:
                return None
            return self._user_scalar(
                ftype,
                self._mono_from_mm(p, self._flat(raw, flat, key)))

        if isinstance(node, A.SumAgg):
            return {"value": self._sum_at(p, raw, flat, cnt)}
        if isinstance(node, A.MinAgg):
            return {"value": mmval("min")}
        if isinstance(node, A.MaxAgg):
            return {"value": mmval("max")}
        s = self._sum_at(p, raw, flat, cnt)
        avg = None if cnt == 0 else (
            s / cnt if ftype == FieldType.F64 else float(Fraction(s) / cnt))
        if isinstance(node, A.AvgAgg):
            return {"value": avg, "sum": s, "count": cnt}
        return {"count": cnt, "sum": s, "min": mmval("min"),
                "max": mmval("max"), "avg": avg}

    def _harvest_percentiles(self, node, raw, path, flat=None):
        p = self.plan[path]
        ftype = p["ftype"]
        if p.get("pmode") == "slot_rank":
            flat = 0 if flat is None else flat
            m = int(np.asarray(raw["m"]).reshape(-1)[flat])
            if m == 0:
                return {"values": {str(q): None for q in node.percents}}
            if "vals" in raw or ("rows" not in raw
                                 and p.get("phase2_vals")):
                # sharded slot bisection (in-trace "vals", or phase-2
                # "pvals" for non-integer percents) emitted the selected
                # VALUES directly (narrow: w domain; wide: rm domain)
                vals = np.asarray(raw["vals"] if "vals" in raw
                                  else raw["pvals"]).reshape(
                    -1, 2 * len(node.percents))[flat]
                out = {}
                for i, q in enumerate(node.percents):
                    _, _, frac = exact.percentile_rank(q, m)
                    v_lo = self._user_scalar(
                        ftype, self._mono_from_mm(p, vals[2 * i]))
                    v_hi = self._user_scalar(
                        ftype, self._mono_from_mm(p, vals[2 * i + 1]))
                    out[str(q)] = exact.interpolate(float(v_lo),
                                                    float(v_hi), frac)
                return {"values": out}
            rows = np.asarray(raw["rows"] if "rows" in raw
                              else raw["pvals"]).reshape(
                -1, 2 * len(node.percents))[flat]
            out = {}
            for i, q in enumerate(node.percents):
                _, _, frac = exact.percentile_rank(q, m)
                v_lo = self._user_scalar(
                    ftype, int(p["layout"].sorted_mono[int(rows[2 * i])]))
                v_hi = self._user_scalar(
                    ftype,
                    int(p["layout"].sorted_mono[int(rows[2 * i + 1])]))
                out[str(q)] = exact.interpolate(float(v_lo), float(v_hi),
                                                frac)
            return {"values": out}
        m = int(raw["m"])
        if m == 0:
            return {"values": {str(q): None for q in node.percents}}
        if p["pmode"] == "rank" and p.get("int_percents"):
            if p.get("bisect"):
                # cross-shard bisection emitted the selected VALUES directly
                # (narrow: w domain; wide: rm domain)
                vals = np.asarray(raw["vals"])
                out = {}
                for i, q in enumerate(node.percents):
                    _, _, frac = exact.percentile_rank(q, m)
                    v_lo = self._user_scalar(
                        ftype, self._mono_from_mm(p, vals[2 * i]))
                    v_hi = self._user_scalar(
                        ftype, self._mono_from_mm(p, vals[2 * i + 1]))
                    out[str(q)] = exact.interpolate(float(v_lo), float(v_hi),
                                                    frac)
                return {"values": out}
            rows = np.asarray(raw["rows"])
            out = {}
            for i, q in enumerate(node.percents):
                _, _, frac = exact.percentile_rank(q, m)
                v_lo = self._user_scalar(
                    ftype, int(p["layout"].sorted_mono[int(rows[2 * i])]))
                v_hi = self._user_scalar(
                    ftype, int(p["layout"].sorted_mono[int(rows[2 * i + 1])]))
                out[str(q)] = exact.interpolate(float(v_lo), float(v_hi),
                                                frac)
            return {"values": out}
        got = np.asarray(raw["pvals"])
        fracs = raw["_fracs"]
        out = {}
        for i, q in enumerate(node.percents):
            if p["pmode"] == "rank" and not p.get("bisect"):
                lo_mono = int(p["layout"].sorted_mono[int(got[2 * i])])
                hi_mono = int(p["layout"].sorted_mono[int(got[2 * i + 1])])
            else:  # bisect paths emitted rm (wide) or w (narrow) values
                def to_mono(v):
                    w = int(v) if p["narrow"] else int(v) + 2**63
                    return _wrap64(p["min_mono"] + w)
                lo_mono = to_mono(got[2 * i])
                hi_mono = to_mono(got[2 * i + 1])
            v_lo = self._user_scalar(ftype, lo_mono)
            v_hi = self._user_scalar(ftype, hi_mono)
            out[str(q)] = exact.interpolate(float(v_lo), float(v_hi),
                                            fracs[i])
        return {"values": out}

    def _harvest_histogram(self, node, raw, path, flat):
        p = self.plan[path]
        nb, k_min, ftype = p["nb"], p["k_min"], p["ftype"]
        base = (0 if flat is None else flat) * nb
        row = np.asarray(raw["counts"]).reshape(-1)[base:base + nb]
        buckets = []
        for j in np.nonzero(row)[0].tolist():
            c = int(row[j])
            k = k_min + j
            if "keys" in p:  # calendar: keys ARE the period-start micros
                key = int(p["keys"][k])
            elif ftype == FieldType.F64:
                key = exact.f64_histogram_key(k, float(node.interval),
                                              float(node.offset))
            else:
                key = int(node.offset) + k * int(node.interval)
            b = {"key": key, "doc_count": c}
            for name, sub in node.sub_aggs:
                b[name] = self._harvest(sub, raw[name], path + (name,),
                                        base + j)
            buckets.append(b)
        return {"buckets": buckets}

    def _term_key_user(self, p, tid: int):
        if p["ftype"] == FieldType.BYTES:
            return bytes(p["keys"][tid])
        if p["ftype"].is_stringy:
            return str(p["keys"][tid])
        return self._user_scalar(p["ftype"], int(p["keys_mono"][tid]))

    def _harvest_terms_hostsel(self, node, raw, path, flat):
        """Host-side exact selection for `order` modes the device cannot
        prove exact (avg, f64 sums, limb-plane sums): compares HARVESTED
        user values — the identical comparator to the oracle — with key-asc
        ties via the key-ascending bucket id order."""
        p = self.plan[path]
        card = p["card"]
        base = 0 if flat is None else flat
        cvec = np.asarray(raw["counts"]).reshape(-1, card)[base]
        present = np.nonzero(cvec > 0)[0].tolist()
        target, direction = p["order"]
        desc = direction == "desc"
        if target == "_count":
            # host-forced selection of a count-ordered node (e.g. a
            # non-integer-percent percentile sub pins the fruits to full
            # slot space): (count desc/asc, key asc) like the device top-k
            order_ids = sorted(present,
                               key=lambda j: (-int(cvec[j]) if desc
                                              else int(cvec[j]), j))
        elif target == "_key":
            order_ids = sorted(present, reverse=desc)
        else:
            sub = dict(node.sub_aggs)[target]
            vals = {j: self._harvest(sub, raw[target], path + (target,),
                                     base * card + j)["value"]
                    for j in present}
            ids = [j for j in present if vals[j] is not None]
            nones = [j for j in present if vals[j] is None]
            ids.sort(key=lambda j: vals[j], reverse=desc)
            order_ids = ids + nones
        top = order_ids[: node.size]
        buckets = []
        shown = 0
        for j in top:
            c = int(cvec[j])
            shown += c
            b = {"key": self._term_key_user(p, j), "doc_count": c}
            for name, s in node.sub_aggs:
                b[name] = self._harvest(s, raw[name], path + (name,),
                                        base * card + j)
            buckets.append(b)
        return {"buckets": buckets,
                "sum_other_doc_count": int(cvec.sum()) - shown}

    def _harvest_facet(self, node, raw, path, flat):
        """Facet harvest (§A.12): slice the full per-ordinal count vector
        to the static child ordinals, order (count desc, path asc)."""
        p = self.plan[path]
        card = p["card"]
        base = 0 if flat is None else flat
        cvec = np.asarray(raw["counts"]).reshape(-1, card)[base]
        rows = [(str(p["keys"][j]), int(cvec[j]))
                for j in p["facet_children"] if cvec[j] > 0]
        rows.sort(key=lambda kv: (-kv[1], kv[0]))
        return {"buckets": [{"key": k, "doc_count": c}
                            for k, c in rows[: node.size]]}

    def _harvest_terms(self, node, raw, path, flat):
        p = self.plan[path]
        if p["sel"] == "host":
            return self._harvest_terms_hostsel(node, raw, path, flat)
        keff = p["keff"]
        base = (0 if flat is None else flat) * keff
        crow = np.asarray(raw["counts"]).reshape(-1)[base:base + keff]
        ids = np.asarray(raw["ids"]).reshape(-1)
        total = np.asarray(raw["total"]).reshape(-1)
        total_here = int(total[0 if flat is None else flat])
        shown = 0
        buckets = []
        for i in np.nonzero(crow)[0].tolist():
            c = int(crow[i])
            tid = int(ids[base + i])
            key = self._term_key_user(p, tid)
            shown += c
            b = {"key": key, "doc_count": c}
            for name, sub in node.sub_aggs:
                b[name] = self._harvest(sub, raw[name], path + (name,),
                                        base + i)
            buckets.append(b)
        return {"buckets": buckets, "sum_other_doc_count": total_here - shown}

    def _harvest_top_hits(self, node, raw, path, flat=None):
        p = self.plan[path]
        if p.get("in_slot"):
            flat = 0 if flat is None else flat
            keys_a = np.asarray(raw["keys"])
            kcap = keys_a.shape[-1]
            m = int(np.asarray(raw["m"]).reshape(-1)[flat])
            k = min(node.size, m, kcap)
            keys = keys_a.reshape(-1, kcap)[flat][:k]
            docs = np.asarray(raw["docs"]).reshape(-1, kcap)[flat][:k]
        else:
            m = int(raw["m"])
            k = min(node.size, m)
            keys = np.asarray(raw["keys"])[:k]
            docs = np.asarray(raw["docs"])[:k]
        starts = self.dindex.seg_starts
        hits = []
        for kk, dd in zip(keys.tolist(), docs.tolist()):
            si = int(np.searchsorted(starts, dd, side="right")) - 1
            hit = {"segment": si, "doc": int(dd - starts[si])}
            if p.get("score"):
                hit["score"] = 1.0  # scoring-disabled constant score (§A.10)
            else:
                rm = int(kk) if node.ascending else int(~np.int64(kk))
                mono = self._mono_from_mm(p, rm)
                hit["value"] = self._user_scalar(p["ftype"], mono)
            hits.append(hit)
        return {"hits": hits}


def _limb_totals_vec(a: np.ndarray):
    """[H, L] int64 limb accumulators -> [H] exact totals as int64, or
    None when the magnitude bound cannot prove the recombination
    int64-overflow-free (caller falls back to per-bucket Python big
    ints). Proof: |sum_i a[h,i] << LIMB_BITS*i| and every prefix partial
    are <= sum_i max_h|a[h,i]| << LIMB_BITS*i = bound < 2^62."""
    if a.ndim != 2 or a.size == 0:
        return None
    mx = np.abs(a).max(axis=0)
    bound = sum(int(m) << (exact.LIMB_BITS * i)
                for i, m in enumerate(mx.tolist()))
    if bound >= 2 ** 62:
        return None
    tot = a[:, 0].astype(np.int64, copy=True)
    for i in range(1, a.shape[1]):
        tot += a[:, i].astype(np.int64) << np.int64(exact.LIMB_BITS * i)
    return tot


# ---------------------------------------------------------------------------
# Cross-shard bisection rank selection (sharded percentiles fast path)
#
# Replaces the all-gather + full-sort fallback (SURVEY.md §3.5 / VERDICT r1
# #7): each shard holds a STATIC value-sorted view of its own rows
# (index/loader.py value_layout, per-shard chunks), the query mask reduces
# to a per-shard 32-block matched-count prefix, and the rank-r value is
# found by bisecting the VALUE DOMAIN — count(x) = psum over shards of
# "masked rows with value <= x", each a binary search over the shard's
# sorted plane plus one prefix lookup. Per query: one local cumsum (the
# only O(rows) work) + ~31/64 iterations of tiny gathers and one [K]-vector
# psum each. Exact for any mask; no cross-chip value traffic at all.
# ---------------------------------------------------------------------------

def _mcount_at(cum32, vm8, posn):
    """Matched rows among the first `posn` permuted rows (posn in [0, R]).
    cum32: [R/32] inclusive per-32-block matched-count prefix (int32 or
    int64). Returns int64."""
    nblk = vm8.shape[0] // 32
    blk = jnp.minimum(posn // 32, nblk - 1)
    base = jnp.where(blk > 0, cum32[jnp.maximum(blk - 1, 0)], 0).astype(I64)
    win = jax.lax.dynamic_slice(vm8, ((blk * 32).astype(I32),), (32,))
    extra = posn - blk * 32  # in [0, 32]
    inner = jnp.sum(jnp.where(jnp.arange(32) < extra, win, 0).astype(I64))
    return base + inner


def _ss_right(plane, x, lo, hi):
    """Rightmost binary search over an ascending int32 plane restricted to
    positions [lo, hi): the absolute end position after every row in
    [lo, hi) with plane[r] <= x. x is int64 (no wraparound at the int32
    domain edges); fixed trip count (static R)."""
    iters = max(1, int(plane.shape[0]).bit_length())

    def body(_, lh):
        l, h = lh
        mid = (l + h) // 2
        v = plane[jnp.minimum(mid, plane.shape[0] - 1).astype(I32)]
        pred = (v.astype(I64) <= x) & (mid < h)
        return (jnp.where(pred, mid + 1, l), jnp.where(pred, h, mid))

    l, _ = jax.lax.fori_loop(0, iters, body, (lo, hi))
    return l


def _bisect_values(count_of, t, dom_lo: int, dom_hi: int):
    """Smallest x in [dom_lo, dom_hi] with count_of(x) >= t, for a vector of
    targets t [K]. count_of maps [K] int64 values -> [K] int64 GLOBAL counts
    (monotone in x). Static trip count from the domain width."""
    width = dom_hi - dom_lo
    iters = max(1, int(width).bit_length())
    lo0 = jnp.full_like(t, dom_lo)
    hi0 = jnp.full_like(t, dom_hi)

    def body(_, lh):
        lo, hi = lh
        mid = lo + (hi - lo) // 2  # domain widths are < 2^63: no overflow
        ge = count_of(mid) >= t
        return (jnp.where(ge, lo, mid + 1), jnp.where(ge, mid, hi))

    lo, _ = jax.lax.fori_loop(0, iters, body, (lo0, hi0))
    return lo


def _bisect_select_values(planes, vm8, cum32, ranks, p, madd):
    """Selected values for 0-based ranks [K] over the per-shard value-sorted
    layout. Returns int64 [K]: narrow columns in the w domain, wide columns
    in the rm domain (both as _mono_from_mm expects). Garbage when the
    global match count is 0 (harvest gates on m == 0)."""
    Rn = vm8.shape[0]
    t = ranks + 1

    def local_le_plane(plane, x):  # [K] masked local counts of value <= x
        def one(xi):
            return _mcount_at(cum32, vm8,
                              _ss_right(plane, xi, jnp.int64(0),
                                        jnp.int64(Rn)))
        return jax.vmap(one)(x)

    if p["narrow"]:
        span = int(p["span"])
        w = _bisect_values(
            lambda x: madd(local_le_plane(planes["sv0"], x)),
            t, 0, span)
        return w

    # wide: lexicographic (hi, lo) — phase A selects the hi plane value,
    # phase B selects lo within the (contiguous) hi == h* row range
    svh, svl = planes["sv0"], planes["sv1"]
    hi_max = (int(p["span"]) >> 32) - 2**31
    h = _bisect_values(
        lambda x: madd(local_le_plane(svh, x)),
        t, -(2**31), hi_max)

    def local_range(hx):  # per-rank local [a, b) bounds of rows with hi==h*
        def one(hxi):
            b = _ss_right(svh, hxi, jnp.int64(0), jnp.int64(Rn))
            a = _ss_right(svh, hxi - 1, jnp.int64(0), jnp.int64(Rn))
            return a, b
        return jax.vmap(one)(hx)

    a, b = local_range(h)
    gmc_a = madd(jax.vmap(lambda ai: _mcount_at(cum32, vm8, ai))(a))
    t2 = t - gmc_a  # rank within the hi == h* candidate rows

    def count_lo(x):
        def one(ai, bi, xi):
            pos = _ss_right(svl, xi, ai, bi)
            return _mcount_at(cum32, vm8, pos)
        return madd(jax.vmap(one)(a, b, x)) - gmc_a

    l = _bisect_values(count_lo, t2, -(2**31), 2**31 - 1)
    return (h << 32) + (l + 2**31)  # rm domain (matches wide_recon)


def _mcount_slot_at(cum2, vm8, slot32, s, posn):
    """Matched rows OF SLOT s among the first `posn` permuted rows: cum2
    [G, ns] inclusive per-32-block PER-SLOT matched-count prefixes (the
    slot_rank c32 cumsum), plus a slot-conditioned partial-block scan.
    Returns int64 (local shard count)."""
    nblk = vm8.shape[0] // 32
    blk = jnp.minimum(posn // 32, nblk - 1)
    base = jnp.where(blk > 0,
                     cum2[jnp.maximum(blk - 1, 0), s], 0).astype(I64)
    wrow = jax.lax.dynamic_slice(vm8, ((blk * 32).astype(I32),), (32,))
    srow = jax.lax.dynamic_slice(slot32, ((blk * 32).astype(I32),), (32,))
    extra = posn - blk * 32  # in [0, 32]
    win = (wrow > 0) & (srow == s)
    inner = jnp.sum(jnp.where(jnp.arange(32) < extra, win, False)
                    .astype(I64))
    return base + inner


def _has_pct_sub(node) -> bool:
    """True when any descendant agg is a PercentilesAgg (drives the
    dense-budget extension for slot_rank bchain ancestors)."""
    for _, sub in getattr(node, "sub_aggs", ()):
        if isinstance(sub, A.PercentilesAgg) or _has_pct_sub(sub):
            return True
    return False


def _has_nonint_pct_sub(node) -> bool:
    """True when any descendant agg is a PercentilesAgg with non-integer
    percents (the shape whose phase-2 machinery needs full-slot-space
    fruits — see _plan_terms_order / _plan_percentiles)."""
    for _, sub in getattr(node, "sub_aggs", ()):
        if isinstance(sub, A.PercentilesAgg) \
                and not all(float(q).is_integer() for q in sub.percents):
            return True
        if _has_nonint_pct_sub(sub):
            return True
    return False


def _bisect_select_slot_values(planes, vm8, cum2, slot32, ranks, p, madd):
    """Per-(slot, rank) cross-shard bisection over the value-sorted layout
    with SLOT conditioning (sharded slot_rank percentiles): ranks [ns, 2P]
    0-based; returns int64 [ns, 2P] selected values — narrow columns in
    the w domain, wide in the rm domain (both as _mono_from_mm expects).
    Garbage in any slot with zero matches (harvest gates on m_s == 0).
    Same two-phase structure as _bisect_select_values; every count is a
    per-shard slot-conditioned prefix lookup psum'd across the mesh."""
    ns, twoP = ranks.shape
    Rn = jnp.int64(vm8.shape[0])
    slots = jnp.repeat(jnp.arange(ns, dtype=I32), twoP)  # [K] lane slots
    t = ranks.reshape(-1) + 1

    def local_le_plane(plane, x):  # [K] slot-masked local counts <= x
        def one(s, xi):
            return _mcount_slot_at(cum2, vm8, slot32, s,
                                   _ss_right(plane, xi, jnp.int64(0), Rn))
        return jax.vmap(one)(slots, x)

    if p["narrow"]:
        span = int(p["span"])
        w = _bisect_values(
            lambda x: madd(local_le_plane(planes["sv0"], x)), t, 0, span)
        return w.reshape(ns, twoP)

    svh, svl = planes["sv0"], planes["sv1"]
    hi_max = (int(p["span"]) >> 32) - 2**31
    h = _bisect_values(
        lambda x: madd(local_le_plane(svh, x)), t, -(2**31), hi_max)

    def local_range(hx):  # per-lane local [a, b) bounds of rows hi == h*
        def one(hxi):
            b = _ss_right(svh, hxi, jnp.int64(0), Rn)
            a = _ss_right(svh, hxi - 1, jnp.int64(0), Rn)
            return a, b
        return jax.vmap(one)(hx)

    a, b = local_range(h)
    gmc_a = madd(jax.vmap(
        lambda s, ai: _mcount_slot_at(cum2, vm8, slot32, s, ai))(slots, a))
    t2 = t - gmc_a  # rank within the slot's hi == h* candidate rows

    def count_lo(x):
        def one(s, ai, bi, xi):
            pos = _ss_right(svl, xi, ai, bi)
            return _mcount_slot_at(cum2, vm8, slot32, s, pos)
        return madd(jax.vmap(one)(slots, a, b, x)) - gmc_a

    l = _bisect_values(count_lo, t2, -(2**31), 2**31 - 1)
    return ((h << 32) + (l + 2**31)).reshape(ns, twoP)


def _rank_select_rows_lazy(cum128, ranks, window_of, G=128):
    """For each 0-based rank r: the layout row of the (r+1)-th matched row,
    from an inclusive per-G-row-group match-count prefix (int32) and a
    `window_of(blk) -> bool [G]` recompute callback (no materialized
    mask). Trace-time body; expects x64 semantics."""
    targets = ranks + 1

    def one(t):
        blk = jnp.searchsorted(cum128, t.astype(cum128.dtype), side="left")
        base = jnp.where(blk > 0, cum128[jnp.maximum(blk - 1, 0)],
                         0).astype(I64)
        window = window_of(blk)
        inner = jnp.cumsum(window.astype(I32))
        off = jnp.sum((inner.astype(I64) < (t - base)).astype(I32))
        return (blk * G + off).astype(I32)

    return jax.vmap(one)(targets)


def _rank_select_rows(cum32, vmask_perm, ranks):
    """For each 0-based rank r: the layout row of the (r+1)-th matched row.
    cum32: inclusive per-32-row-block match-count prefix (int32 — counts
    fit, the device cumsum runs native; int64 also accepted).
    Trace-time body (callable inside programs); expects x64 semantics."""
    targets = ranks + 1

    def one(t):
        blk = jnp.searchsorted(cum32, t.astype(cum32.dtype), side="left")
        base = jnp.where(blk > 0, cum32[jnp.maximum(blk - 1, 0)],
                         0).astype(I64)
        window = jax.lax.dynamic_slice(vmask_perm, (blk * 32,), (32,))
        inner = jnp.cumsum(window.astype(I64))
        off = jnp.sum((inner < (t - base)).astype(I32))
        return (blk * 32 + off).astype(I32)

    return jax.vmap(one)(targets)


@jax.jit
def _rank_select(cum32, vmask_perm, ranks):
    with jax.enable_x64(True):
        return _rank_select_rows(cum32, vmask_perm, ranks)


def _slot_rank_select_rows_lazy(cum_ns, ranks, window_of, G=32):
    """Per-slot rank gather without materialized mask/slot planes:
    cum_ns [ns, NB] inclusive per-G-row-block per-slot match prefixes,
    ranks [ns, 2P] 0-based; `window_of(blk, s) -> bool [G]` recomputes
    the chain-mask & slot bits of one block from the original permuted
    planes. Trace-time body (x64 semantics)."""
    ns = cum_ns.shape[0]

    def per_slot(s, rk):
        cs = cum_ns[s]
        targets = rk + 1

        def one(t):
            blk = jnp.searchsorted(cs, t.astype(cs.dtype), side="left")
            base = jnp.where(blk > 0, cs[jnp.maximum(blk - 1, 0)],
                             0).astype(I64)
            win = window_of(blk, s)
            inner = jnp.cumsum(win.astype(I32))
            off = jnp.sum((inner.astype(I64) < (t - base)).astype(I32))
            return (blk * G + off).astype(I32)

        return jax.vmap(one)(targets)

    return jax.vmap(per_slot)(jnp.arange(ns, dtype=I32), ranks)


def _wslot_rank_select_rows(cum, wms, ranks):
    """Occurrence-WEIGHTED per-slot rank gather: cum [G, ns] inclusive
    per-32-block weighted prefixes; wms [K, R] per-position composite
    slot planes (-1 none). A row's weight in slot s is the number of
    planes mapping it to s; the selected row is the one whose cumulative
    weight first reaches rank+1 (a weight-j row owns j consecutive
    ranks). Trace-time body (x64 semantics)."""
    ns = cum.shape[1]
    K = wms.shape[0]

    def per_slot(s, rk):
        cs = cum[:, s]
        targets = rk + 1

        def one(t1):
            blk = jnp.searchsorted(cs, t1.astype(cs.dtype), side="left")
            base = jnp.where(blk > 0, cs[jnp.maximum(blk - 1, 0)],
                             0).astype(I64)
            win = jax.lax.dynamic_slice(
                wms, (jnp.int32(0), (blk * 32).astype(I32)), (K, 32))
            w = jnp.sum((win == s).astype(I64), axis=0)  # [32] weights
            inner = jnp.cumsum(w)
            off = jnp.sum((inner < (t1 - base)).astype(I32))
            return (blk * 32 + off).astype(I32)

        return jax.vmap(one)(targets)

    return jax.vmap(per_slot)(jnp.arange(ns, dtype=I32), ranks)


def _slot_rank_select_rows(cum, vm8, slot32, ranks):
    """Per-slot rank gather: cum [G, ns] inclusive per-32-row-block per-slot
    match prefixes, ranks [ns, 2P] 0-based -> [ns, 2P] layout rows of the
    (rank+1)-th matched row of each slot. Trace-time body (x64 semantics)."""
    ns = cum.shape[1]

    def per_slot(s, rk):
        cs = cum[:, s]
        targets = rk + 1

        def one(t):
            blk = jnp.searchsorted(cs, t.astype(cs.dtype), side="left")
            base = jnp.where(blk > 0, cs[jnp.maximum(blk - 1, 0)],
                             0).astype(I64)
            wrow = jax.lax.dynamic_slice(vm8, (blk * 32,), (32,))
            srow = jax.lax.dynamic_slice(slot32, (blk * 32,), (32,))
            win = (wrow > 0) & (srow == s)
            inner = jnp.cumsum(win.astype(I64))
            off = jnp.sum((inner < (t - base)).astype(I32))
            return (blk * 32 + off).astype(I32)

        return jax.vmap(one)(targets)

    return jax.vmap(per_slot)(jnp.arange(ns, dtype=I32), ranks)


@jax.jit
def _wslot_rank_select(cum, wms, ranks):
    with jax.enable_x64(True):
        return _wslot_rank_select_rows(cum, wms, ranks)


@jax.jit
def _wslot_rank_select_batch(cum, wms, ranks):
    with jax.enable_x64(True):
        return jax.vmap(_wslot_rank_select_rows)(cum, wms, ranks)


@jax.jit
def _slot_rank_select(cum, vm8, slot32, ranks):
    with jax.enable_x64(True):
        return _slot_rank_select_rows(cum, vm8, slot32, ranks)


@jax.jit
def _slot_rank_select_batch(cum, vm8, slot32, ranks):
    with jax.enable_x64(True):
        return jax.vmap(_slot_rank_select_rows)(cum, vm8, slot32, ranks)


def get_program(dindex, query, aggs, config=None) -> Program:
    return Program(dindex, query, aggs, config=config)
