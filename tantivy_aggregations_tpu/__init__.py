"""tantivy_aggregations_tpu — an accelerator index-and-aggregate engine in JAX.

A from-scratch rebuild of the capability surface of the Rust crate
``anti-social/tantivy-aggregations`` (Elasticsearch-style aggregations over a
tantivy-like segment index), re-designed as device programs:

- Fast-field columns are device-resident dense arrays (int64 order-preserving
  "mono" domain + CSR for multi-valued fields).
- Query matching is a vectorized docid-bitmask materializer instead of a
  per-doc postings seek loop.
- The aggregation walk (count/sum/min/max/avg/percentiles/histogram/terms
  with nested sub-aggs, filter/post-filter) compiles to fused masked
  segmented reductions under ``jax.jit``.
- Multi-segment indexes are concatenated on one doc axis; sharded indexes
  shard that axis over a ``jax.sharding.Mesh`` and merge fruits with
  ``psum``-style collectives.

Exactness contract: every aggregate the engine returns is *exact* (integer
aggregates trivially; float64 sums via order-independent fixed-point limb
accumulation; float64 order statistics via the monotonic u64 mapping), so
results are bit-identical to the in-repo sequential oracle regardless of
execution order, segmentation, or sharding. See SURVEY.md §A.

Reference parity map (reference = anti-social/tantivy-aggregations; the
reference source was not available during the survey, so citations are to
SURVEY.md sections rather than file:line — see SURVEY.md provenance notice):
- public API constructors / AggSearcher      -> aggs/ir.py, searcher.py   [SURVEY §2.1 C1]
- Agg/PreparedAgg/SegmentAgg trait triple    -> aggs/ir.py + aggs/compile.py [C2]
- search driver / fruit merge                -> searcher.py + parallel/   [C3]
- per-agg modules (count..terms, filter)     -> aggs/                      [C4..C13]
- tantivy schema/segments/fastfields/...     -> schema.py, index/          [§2.2 T1..T10]
"""

# NOTE on 64-bit semantics: the engine's exact arithmetic uses int64 ONLY in
# trace-time XLA ops (reductions, cumsums, top-k keys); every device-resident
# column is int32/int8. Those segments are traced under scoped
# `jax.enable_x64(True)` contexts inside the compiled programs, so the global
# x64 flag stays OFF: no array is silently widened to 64 bits (device
# planes stay int32/int8 and every int64 is an explicit choice).

from .schema import Schema, FieldType, Cardinality, SchemaBuilder  # noqa: E402
from .index.index import Index  # noqa: E402
from .index.merge_policy import LogMergePolicy  # noqa: E402
from .searcher import Searcher  # noqa: E402
from .parallel.shard import make_mesh  # noqa: E402
from .parallel.replica import ReplicatedSearcher  # noqa: E402
from .query.ir import (  # noqa: E402
    MatchAllQuery,
    TermQuery,
    RangeQuery,
    BooleanQuery,
    ExistsQuery,
    PhraseQuery,
    PrefixQuery,
    TermSetQuery,
    FuzzyTermQuery,
    RegexQuery,
)
from .aggs.ir import (  # noqa: E402
    count_agg,
    sum_agg,
    min_agg,
    max_agg,
    avg_agg,
    stats_agg,
    percentiles_agg,
    histogram_agg,
    date_histogram_agg,
    terms_agg,
    facet_agg,
    filter_agg,
    post_filter_agg,
    top_hits_agg,
)
from .aggs import ir as _agg_ir  # noqa: E402

# typed aliases (reference ergonomics): sum_agg_f64, terms_agg_str, ...
for _n in dir(_agg_ir):
    if _n.endswith(("_u64", "_i64", "_f64", "_date", "_str")):
        globals()[_n] = getattr(_agg_ir, _n)
del _n

__version__ = "0.1.0"

__all__ = [
    "Schema",
    "SchemaBuilder",
    "FieldType",
    "Cardinality",
    "Index",
    "LogMergePolicy",
    "Searcher",
    "make_mesh",
    "ReplicatedSearcher",
    "MatchAllQuery",
    "TermQuery",
    "RangeQuery",
    "BooleanQuery",
    "ExistsQuery",
    "PhraseQuery",
    "PrefixQuery",
    "TermSetQuery",
    "FuzzyTermQuery",
    "RegexQuery",
    "count_agg",
    "sum_agg",
    "min_agg",
    "max_agg",
    "avg_agg",
    "stats_agg",
    "percentiles_agg",
    "histogram_agg",
    "date_histogram_agg",
    "terms_agg",
    "facet_agg",
    "filter_agg",
    "post_filter_agg",
    "top_hits_agg",
]
