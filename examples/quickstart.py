"""Quickstart: build an index, run aggregations, use msearch batching.

Run from the repo root: python examples/quickstart.py
(CPU or GPU — the engine picks whatever JAX backend is active.)"""

import os
import sys

# make `python examples/quickstart.py` work without an install: the
# interpreter puts examples/ (not the cwd) on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import tantivy_aggregations_tpu as tat

schema = (tat.SchemaBuilder()
          .add_u64_field("amount")
          .add_f64_field("price")
          .add_date_field("ts")
          .add_keyword_field("status")
          .add_keyword_field("tags", cardinality=tat.Cardinality.MULTI)
          .add_text_field("title")
          .build())

idx = tat.Index.create_in_ram(schema)
w = idx.writer()
rng = np.random.default_rng(0)
n = 50_000
day = 86_400_000_000
w.add_documents_columnar({
    "amount": rng.integers(0, 10_000, n, dtype=np.uint64),
    "price": np.round(rng.lognormal(3, 1, n), 2),
    "ts": np.uint64(1_600_000_000_000_000) + rng.integers(0, 30 * day, n,
                                                          dtype=np.uint64),
    "status": np.array(["active", "archived"], object)[rng.integers(0, 2, n)],
    "title": [f"item {i % 97} deluxe" for i in range(n)],
}, n)
w.commit()

searcher = idx.searcher()
result = searcher.agg_search(
    tat.BooleanQuery(must=[tat.TermQuery("status", "active"),
                           tat.RangeQuery("amount", lower=100)]),
    {"n": tat.count_agg(),
     "revenue": tat.sum_agg("price"),
     "stats": tat.stats_agg("amount"),
     "p": tat.percentiles_agg("price"),
     "daily": tat.date_histogram_agg("ts", interval_micros=day,
                                     sub_aggs={"rev": tat.sum_agg("price")}),
     "words": tat.terms_agg("title", size=5)})
print("matched:", result["n"]["value"])
print("revenue:", result["revenue"]["value"])
print("p50 price:", result["p"]["values"]["50.0"])
print("first day:", result["daily"]["buckets"][0])
print("top words:", [(b["key"], b["doc_count"]) for b in result["words"]["buckets"]])

# msearch: many same-shape queries in one device dispatch
queries = [tat.RangeQuery("amount", lower=int(lo), upper=int(lo) + 2000)
           for lo in range(0, 8000, 1000)]
aggs = {"n": tat.count_agg(), "s": tat.sum_agg("price")}
for q, r in zip(queries, searcher.agg_search_batch([(q, aggs) for q in queries])):
    print(q.lower, "->", r["n"]["value"], round(r["s"]["value"], 2))

# everything above is bit-identical to the sequential oracle:
assert result == idx.oracle_searcher().agg_search(
    tat.BooleanQuery(must=[tat.TermQuery("status", "active"),
                           tat.RangeQuery("amount", lower=100)]),
    {"n": tat.count_agg(), "revenue": tat.sum_agg("price"),
     "stats": tat.stats_agg("amount"), "p": tat.percentiles_agg("price"),
     "daily": tat.date_histogram_agg("ts", interval_micros=day,
                                     sub_aggs={"rev": tat.sum_agg("price")}),
     "words": tat.terms_agg("title", size=5)})
print("oracle parity: OK")
