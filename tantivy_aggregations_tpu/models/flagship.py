"""Flagship workload: the judged five-config benchmark suite as code.

In an ML framework this directory would hold model families; this engine's
"models" are canonical index schemas + aggregation pipelines. The flagship
pipeline is the benchmark contract from BASELINE.json `configs` — the five
judged (query, agg tree) pairs over the standard benchmark schema — reused
by bench.py, __graft_entry__.py, and the C++ baseline driver so every
consumer measures exactly the same programs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .. import (
    BooleanQuery,
    MatchAllQuery,
    PrefixQuery,
    RangeQuery,
    SchemaBuilder,
    TermQuery,
    TermSetQuery,
    avg_agg,
    count_agg,
    date_histogram_agg,
    histogram_agg,
    max_agg,
    min_agg,
    percentiles_agg,
    post_filter_agg,
    sum_agg,
    terms_agg,
)
from ..schema import Cardinality, Schema

#: default high-cardinality keyword vocabulary size for the benchmark index
BENCH_CARD = 100_000


def bench_schema() -> Schema:
    return (
        SchemaBuilder()
        .add_u64_field("amount")                       # config 1: count+sum
        .add_u64_field("qty")
        .add_f64_field("price")
        .add_keyword_field("status")                   # low-card filter field
        .add_keyword_field("sku", )                    # high-card terms field
        .add_u64_field("weights", cardinality=Cardinality.MULTI)  # config 2
        .add_date_field("ts")                          # config 3 histogram
        .build()
    )


def generate_bench_columns(n_docs: int, seed: int = 42,
                           card: int = BENCH_CARD) -> Dict[str, object]:
    """Fixed-seed synthetic columns for the benchmark index (SURVEY.md §4.5)."""
    rng = np.random.default_rng(seed)
    cols = {}
    cols["amount"] = rng.integers(0, 10_000, n_docs, dtype=np.uint64)
    cols["qty"] = rng.integers(0, 100, n_docs, dtype=np.uint64)
    cols["price"] = np.round(rng.lognormal(3.0, 1.0, n_docs), 2)
    statuses = np.array(["active", "archived", "deleted", "pending"],
                        dtype=object)
    cols["status"] = statuses[rng.integers(0, 4, n_docs)]
    # zipf-ish skew over a high-cardinality vocabulary
    sku_ids = rng.zipf(1.2, n_docs) % card
    cols["sku"] = np.array([f"sku{int(i):07d}" for i in sku_ids], dtype=object)
    # multi-valued u64: 0-3 values per doc
    nvals = rng.integers(0, 4, n_docs)
    offsets = np.zeros(n_docs + 1, dtype=np.uint32)
    np.cumsum(nvals, out=offsets[1:])
    cols["weights"] = (offsets,
                       rng.integers(0, 1000, int(offsets[-1]), dtype=np.uint64))
    # timestamps across ~30 days of microseconds
    day = 86_400_000_000
    cols["ts"] = (np.uint64(1_600_000_000_000_000)
                  + rng.integers(0, 30 * day, n_docs, dtype=np.uint64))
    return cols


def judged_configs():
    """The five judged (name, query, agg tree) pairs [BASELINE.json configs]."""
    day = 86_400_000_000
    return [
        ("c1_count_sum",
         MatchAllQuery(),
         {"n": count_agg(), "s": sum_agg("amount")}),
        ("c2_minmaxavg_term_filter",
         TermQuery("status", "active"),
         {"lo": min_agg("price"), "hi": max_agg("price"),
          "avg_w": avg_agg("weights")}),
        ("c3_date_histogram_sum",
         MatchAllQuery(),
         {"h": histogram_agg("ts", interval=day,
                             sub_aggs={"s": sum_agg("amount")})}),
        ("c4_terms_highcard_nested",
         MatchAllQuery(),
         {"t": terms_agg("sku", size=10,
                         sub_aggs={"s": sum_agg("amount"),
                                   "n": count_agg()})}),
        ("c5_percentiles_mixed_postfilter",
         BooleanQuery(must=[RangeQuery("amount", lower=100, upper=9000,
                                       include_upper=True)]),
         {"p": percentiles_agg("price"),
          "pf": post_filter_agg(TermQuery("status", "active"),
                                sub_aggs={"n": count_agg(),
                                          "s": sum_agg("qty"),
                                          "h": histogram_agg("qty", interval=10)}),
          "t": terms_agg("status", size=4, sub_aggs={"s": sum_agg("amount")})}),
    ]


def extra_configs():
    """Non-judged bench configs (identity-gated and reported, but outside
    the 5-config BASELINE.json geomean contract). c6 exercises terms top-k
    ORDERED BY SUB-METRIC (SURVEY.md §2.1 C10's 'or by sub-metric')."""
    return [
        (6, "c6_terms_order_by_sum",
         MatchAllQuery(),
         {"t": terms_agg("sku", size=10, order=("s", "desc"),
                         sub_aggs={"s": sum_agg("amount"),
                                   "n": count_agg()})}),
        # c4-shaped tree gated by a TermQuery on a MULTI-VALUED field: the
        # dense per-position planes keep the high-card terms on the prefix
        # path (VERDICT r1 #4 done-criterion)
        (7, "c7_terms_prefix_multiquery",
         TermQuery("weights", 500),
         {"t": terms_agg("sku", size=10,
                         sub_aggs={"s": sum_agg("amount"),
                                   "n": count_agg()})}),
        # c8: the beyond-reference query/agg surface measured end to end —
        # a keyword PREFIX query gating a CALENDAR-month date histogram
        (8, "c8_calendar_hist_prefix_query",
         PrefixQuery("sku", "sku000"),
         {"n": count_agg(),
          "h": date_histogram_agg("ts", calendar_interval="month",
                                  sub_aggs={"s": sum_agg("amount")})}),
        # c9: the nested-selection device path — per-bucket percentiles
        # (slot_rank) under a terms agg. (top_hits under buckets exists and
        # is parity-tested, but its per-slot path is a full-row sort — not
        # a sensible 10M-row benchmark.)
        (9, "c9_terms_nested_percentiles",
         RangeQuery("amount", lower=100, upper=9000, include_upper=True),
         {"t": terms_agg("status", size=4,
                         sub_aggs={"p": percentiles_agg(
                                       "price", (25.0, 50.0, 75.0))})}),
        # c10: the set-query surface (§A.14) measured end to end — a
        # TermSetQuery over the 100k-card sku vocabulary (run-slot compare
        # lowering) gating count/sum + a dense histogram; the stream
        # rotates DIFFERENT 8-term sets through one compiled program
        (10, "c10_termset_query_hist",
         TermSetQuery("sku", c10_values(0)),
         {"n": count_agg(), "s": sum_agg("amount"),
          "h": histogram_agg("amount", interval=500)}),
    ]


def c10_values(j: int) -> list:
    """The j-th rotating sku set for config 10 (8 terms, scattered across
    the zipf-skewed vocabulary; mirrored by baseline_cpp config10 at j=0)."""
    return [f"sku{(37 * j + 101 * i) % BENCH_CARD:07d}" for i in range(8)]


def varied_requests(cfg: int, aggs, n: int):
    """A length-`n` serving stream for judged config `cfg`: the SAME query
    shape with rotating parameter values wherever the config has parameters
    (term values, range bounds), so benchmarks measure the no-recompile
    param-dispatch path rather than one literal query repeated. Configs
    whose query is MatchAll (c1/c3/c4) have no parameters to vary."""
    if cfg <= 5:
        _, query, _ = judged_configs()[cfg - 1]
    else:
        query = next(q for i, _, q, _ in extra_configs() if i == cfg)
    if cfg == 2:
        vals = ["active", "archived", "deleted", "pending"]
        return [(TermQuery("status", vals[j % len(vals)]), aggs)
                for j in range(n)]
    if cfg == 5:
        out = []
        for j in range(n):
            k = j % 32
            q = BooleanQuery(must=[RangeQuery("amount", lower=100 + k,
                                              upper=9000 - k,
                                              include_upper=True)])
            out.append((q, aggs))
        return out
    if cfg == 7:
        return [(TermQuery("weights", 500 + (j % 32)), aggs)
                for j in range(n)]
    if cfg == 8:
        return [(PrefixQuery("sku", f"sku00{j % 10}"), aggs)
                for j in range(n)]
    if cfg == 9:
        return [(RangeQuery("amount", lower=100 + (j % 32),
                            upper=9000 - (j % 32), include_upper=True),
                 aggs)
                for j in range(n)]
    if cfg == 10:
        return [(TermSetQuery("sku", c10_values(j % 32)), aggs)
                for j in range(n)]
    return [(query, aggs)] * n


def build_bench_index(path, n_docs: int, seed: int = 42,
                      card: int = BENCH_CARD, n_segments: int = 1):
    """Create (or overwrite) the on-disk benchmark index."""
    from .. import Index
    idx = Index.create(path, bench_schema(), overwrite=True)
    w = idx.writer()
    per = n_docs // n_segments
    cols = generate_bench_columns(n_docs, seed, card)
    for s in range(n_segments):
        lo = s * per
        hi = n_docs if s == n_segments - 1 else (s + 1) * per
        part = {}
        for k, v in cols.items():
            if isinstance(v, tuple):
                offs, vals = v
                part[k] = (offs[lo:hi + 1] - offs[lo], vals[offs[lo]:offs[hi]])
            else:
                part[k] = v[lo:hi]
        w.add_documents_columnar(part, hi - lo)
        w.commit()
    return idx
