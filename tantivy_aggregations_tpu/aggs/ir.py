"""Aggregation-tree IR and user-facing constructor functions.

Device analog of the reference's `Agg` values and constructor functions
(SURVEY.md §2.1 C1/C2: `count_agg()`, `sum_agg_f64("price")`,
`terms_agg_*(..., sub_aggs)`, `histogram_agg(...)`, `filter_agg(query, sub)`).
Where the Rust crate composes sibling aggs as tuples, this engine composes
them as **named dicts** — `{"total": sum_agg("price"), "n": count_agg()}` —
and the fruit mirrors the dict shape.

An agg tree is pure data. `aggs/compile.py` lowers a (tree shape, index
layout) pair once into a fused jitted device program; subsequent queries with
the same shapes reuse the compiled program (that cache hit is where the
throughput comes from — SURVEY.md §7).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple, Union

from ..query.ir import Query, structural_key as query_structural_key

DEFAULT_PERCENTS = (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0)


class Agg:
    """Marker base class for aggregation nodes."""

    __slots__ = ()


def _freeze_subs(sub_aggs: Optional[Mapping[str, "Agg"]]) -> Tuple[Tuple[str, "Agg"], ...]:
    if not sub_aggs:
        return ()
    for name, agg in sub_aggs.items():
        if not isinstance(agg, Agg):
            raise TypeError(f"sub_agg {name!r} is not an Agg: {agg!r}")
    return tuple(sub_aggs.items())


@dataclass(frozen=True)
class CountAgg(Agg):
    """Number of matched docs (not values). SURVEY.md §2.1 C4."""


@dataclass(frozen=True)
class SumAgg(Agg):
    """Exact sum of every value of `field` over matched docs. C5."""

    field: str


@dataclass(frozen=True)
class MinAgg(Agg):
    """Minimum value (None when nothing matched). C6."""

    field: str


@dataclass(frozen=True)
class MaxAgg(Agg):
    field: str


@dataclass(frozen=True)
class AvgAgg(Agg):
    """sum / value_count; multi-valued fields use the VALUE count as the
    denominator (SURVEY.md §A.4 — explicit, tested spec choice). C7."""

    field: str


@dataclass(frozen=True)
class StatsAgg(Agg):
    """count+sum+min+max+avg in one pass (fused on device)."""

    field: str


@dataclass(frozen=True)
class PercentilesAgg(Agg):
    """Exact rank-interpolated percentiles over matched values (§A.7). C8."""

    field: str
    percents: Tuple[float, ...] = DEFAULT_PERCENTS


@dataclass(frozen=True)
class HistogramAgg(Agg):
    """Fixed-interval histogram: key_index(v) = floor((v-offset)/interval),
    exact; only non-empty buckets emitted, keys ascending (§A.5). C9.

    `calendar` in {"month", "quarter", "year"} switches to ES-style
    calendar bucketing on a date field (bucket key = UTC period start in
    micros; utils/calendar.py defines the shared spec); interval/offset are
    ignored then. Beyond-reference extension."""

    field: str
    interval: Union[int, float]
    offset: Union[int, float] = 0
    sub_aggs: Tuple[Tuple[str, Agg], ...] = ()
    calendar: Optional[str] = None

    def __init__(self, field, interval, offset=0, sub_aggs=None,
                 calendar=None):
        object.__setattr__(self, "field", field)
        object.__setattr__(self, "interval", interval)
        object.__setattr__(self, "offset", offset)
        object.__setattr__(self, "sub_aggs", _freeze_subs(sub_aggs))
        object.__setattr__(self, "calendar", calendar)


@dataclass(frozen=True)
class TermsAgg(Agg):
    """Group-by on keyword or numeric values; top-`size` buckets ordered by
    `order` = (target, "asc"|"desc") where target is "_count" (default,
    desc), "_key", or the name of a single-valued metric sub-agg
    (count/sum/avg/min/max) — SURVEY.md §2.1 C10 "top-k selection by count
    (or by sub-metric)". Ties always break by key ascending; buckets whose
    order metric is null sort last. Bucket doc_count counts value
    occurrences (the reference's per-ordinal collect loop — §3.2)."""

    field: str
    size: int = 10
    sub_aggs: Tuple[Tuple[str, Agg], ...] = ()
    order: Tuple[str, str] = ("_count", "desc")

    def __init__(self, field, size=10, sub_aggs=None, order=None):
        object.__setattr__(self, "field", field)
        object.__setattr__(self, "size", int(size))
        object.__setattr__(self, "sub_aggs", _freeze_subs(sub_aggs))
        if order is None:
            order = ("_count", "desc")
        object.__setattr__(self, "order",
                           (str(order[0]), str(order[1]).lower()))


@dataclass(frozen=True)
class FacetAgg(TermsAgg):
    """Hierarchical facet counts (tantivy's FacetCollector analog, SURVEY.md
    §2.2 T1): buckets are the immediate CHILDREN of `path` in a FACET
    field, counted inclusively of all descendants (the writer indexes every
    ancestor prefix per doc exactly once, so a child's count is its own
    per-ordinal count). Subclasses TermsAgg so it rides the terms planning
    and count machinery; selection is always on the host over the full
    per-ordinal count vector (the child set is a static term-table slice).
    Order: (count desc, path asc); truncated to `size` (0 = all children).
    No sub-aggs (reference facet collectors count only)."""

    path: str = ""

    def __init__(self, field, path="", size=0):
        TermsAgg.__init__(self, field, size=(int(size) if size else 1 << 30))
        object.__setattr__(self, "path", str(path))


@dataclass(frozen=True)
class FilterAgg(Agg):
    """Sub-aggs restricted to docs matching both the outer query and
    `query` — a vectorized AND of masks (SURVEY.md §3.4). C11."""

    query: Query
    sub_aggs: Tuple[Tuple[str, Agg], ...] = ()

    def __init__(self, query, sub_aggs=None):
        object.__setattr__(self, "query", query)
        object.__setattr__(self, "sub_aggs", _freeze_subs(sub_aggs))


@dataclass(frozen=True)
class PostFilterAgg(Agg):
    """Per-subtree mask refinement applied after outer matching (C12).
    Mathematically identical to FilterAgg under this engine's mask algebra;
    kept as a distinct node for reference API parity."""

    query: Query
    sub_aggs: Tuple[Tuple[str, Agg], ...] = ()

    def __init__(self, query, sub_aggs=None):
        object.__setattr__(self, "query", query)
        object.__setattr__(self, "sub_aggs", _freeze_subs(sub_aggs))


@dataclass(frozen=True)
class TopHitsAgg(Agg):
    """Top-`size` docs ordered by a fast field or by score (C13; optional
    in the reference). Returns (key, doc addresses).

    `sort_field=None` orders by SCORE. Spec choice (SURVEY.md §A.10): this
    engine runs scoring-disabled (constant score 1.0 for every match), so
    score order resolves entirely through the doc-address tie-break —
    hits are the first `size` matched docs in (segment, doc) order, each
    carrying "score": 1.0. Exact and identical to a tf-less scorer."""

    size: int
    sort_field: Optional[str] = None
    ascending: bool = False


# -- constructor functions (reference API parity: SURVEY.md §2.1 C1) --------

def count_agg() -> CountAgg:
    return CountAgg()


def sum_agg(field: str) -> SumAgg:
    return SumAgg(field)


def min_agg(field: str) -> MinAgg:
    return MinAgg(field)


def max_agg(field: str) -> MaxAgg:
    return MaxAgg(field)


def avg_agg(field: str) -> AvgAgg:
    return AvgAgg(field)


def stats_agg(field: str) -> StatsAgg:
    return StatsAgg(field)


def percentiles_agg(field: str, percents=DEFAULT_PERCENTS) -> PercentilesAgg:
    return PercentilesAgg(field, tuple(float(p) for p in percents))


def histogram_agg(field: str, interval, offset=0, sub_aggs=None) -> HistogramAgg:
    return HistogramAgg(field, interval, offset, sub_aggs)


def date_histogram_agg(field: str, interval_micros: int = 0, offset: int = 0,
                       sub_aggs=None, calendar_interval: str = None
                       ) -> HistogramAgg:
    """Date histogram == integer histogram over microsecond timestamps.

    `calendar_interval` (ES-style, beyond the reference's fixed intervals):
    minute/hour/day lower to fixed micros; week lowers to a 7-day interval
    anchored on Monday; month/quarter/year use true calendar boundaries
    (utils/calendar.py). With a calendar_interval, interval_micros/offset
    are ignored."""
    if calendar_interval is not None:
        from ..utils import calendar as cal
        ci = str(calendar_interval)
        if ci in cal.FIXED_MICROS:
            return HistogramAgg(field, cal.FIXED_MICROS[ci], 0, sub_aggs)
        if ci == "week":
            return HistogramAgg(field, 7 * cal.DAY_MICROS,
                                cal.WEEK_OFFSET_MICROS, sub_aggs)
        if ci in cal.CALENDAR_INTERVALS:
            return HistogramAgg(field, 0, 0, sub_aggs, calendar=ci)
        raise ValueError(f"unknown calendar_interval {calendar_interval!r}")
    return HistogramAgg(field, int(interval_micros), int(offset), sub_aggs)


def terms_agg(field: str, size: int = 10, sub_aggs=None,
              order=None) -> TermsAgg:
    return TermsAgg(field, size, sub_aggs, order)


def facet_agg(field: str, path: str = "", size: int = 0) -> FacetAgg:
    """Counts per immediate child of `path` in a facet field (size=0: all
    children). Counts are doc-inclusive of descendants."""
    return FacetAgg(field, path, size)


def filter_agg(query: Query, sub_aggs=None) -> FilterAgg:
    return FilterAgg(query, sub_aggs)


def post_filter_agg(query: Query, sub_aggs=None) -> PostFilterAgg:
    return PostFilterAgg(query, sub_aggs)


def top_hits_agg(size: int, sort_field: Optional[str] = None,
                 ascending: bool = False) -> TopHitsAgg:
    """sort_field=None orders by score (constant-score doc order, §A.10)."""
    return TopHitsAgg(int(size), sort_field, ascending)


# -- typed constructor aliases (reference API ergonomics: the Rust crate
# exposes per-dtype constructors like `sum_agg_f64("price")`; this engine
# infers the dtype from the schema, so these are thin aliases kept so users
# migrating from the reference find the names they expect) -------------------

def _typed_aliases():
    g = globals()
    for base in ("sum", "min", "max", "avg", "percentiles"):
        for suffix in ("u64", "i64", "f64", "date"):
            g[f"{base}_agg_{suffix}"] = g[f"{base}_agg"]
    g["terms_agg_str"] = terms_agg
    g["terms_agg_u64"] = terms_agg
    g["terms_agg_i64"] = terms_agg


_typed_aliases()


# -- prepare-time validation -------------------------------------------------
# Reference parity: Agg::prepare resolves field names against the schema and
# errors on missing / type-mismatched fields (SURVEY.md §3.1 L4).

def validate_agg_tree(schema, node) -> None:
    from ..schema import FieldType

    def _numeric(field: str, what: str):
        entry = schema.field(field)  # KeyError on missing field
        if not entry.type.is_numeric:
            raise TypeError(f"{what} requires a numeric fast field, "
                            f"but {field!r} is {entry.type.value}")
        if not entry.fast:
            raise TypeError(f"{what} requires a FAST field; {field!r} is not")

    if isinstance(node, dict):
        for sub in node.values():
            validate_agg_tree(schema, sub)
        return
    if isinstance(node, CountAgg):
        return
    if isinstance(node, (SumAgg, MinAgg, MaxAgg, AvgAgg, StatsAgg, PercentilesAgg)):
        _numeric(node.field, type(node).__name__)
        if isinstance(node, PercentilesAgg):
            if not node.percents:
                raise ValueError("percents must be non-empty")
            for p in node.percents:
                # ES-compatible validation; also required by the device rank
                # paths, whose traced rank arithmetic assumes 0 <= p <= 100
                if not (0.0 <= float(p) <= 100.0):  # False for NaN too
                    raise ValueError(
                        f"percentile {p!r} out of range [0, 100]")
        return
    if isinstance(node, HistogramAgg):
        _numeric(node.field, "HistogramAgg")
        if node.calendar is not None:
            from ..utils import calendar as cal
            if node.calendar not in cal.CALENDAR_INTERVALS:
                raise ValueError(
                    f"calendar interval {node.calendar!r} must be one of "
                    f"{cal.CALENDAR_INTERVALS}")
            if schema.field(node.field).type != FieldType.DATE:
                raise TypeError("calendar histograms require a date field")
        elif not (node.interval > 0):
            raise ValueError("interval must be > 0")
        for _, sub in node.sub_aggs:
            validate_agg_tree(schema, sub)
        return
    if isinstance(node, FacetAgg):
        entry = schema.field(node.field)
        if entry.type != FieldType.FACET:
            raise TypeError(f"FacetAgg requires a facet field, but "
                            f"{node.field!r} is {entry.type.value}")
        if node.path:
            from ..index.writer import facet_prefixes
            facet_prefixes(node.path)  # validates "/a/b" shape
        return
    if isinstance(node, TermsAgg):
        entry = schema.field(node.field)
        if not entry.fast:
            raise TypeError(f"TermsAgg requires a FAST field; {node.field!r} is not")
        if node.size <= 0:
            raise ValueError("terms size must be > 0")
        target, direction = node.order
        if direction not in ("asc", "desc"):
            raise ValueError(f"terms order direction {direction!r} "
                             "must be 'asc' or 'desc'")
        if target not in ("_count", "_key"):
            subs = dict(node.sub_aggs)
            if target not in subs:
                raise ValueError(f"terms order target {target!r} is not a "
                                 "sub-aggregation of this terms agg")
            if not isinstance(subs[target],
                              (CountAgg, SumAgg, AvgAgg, MinAgg, MaxAgg)):
                raise TypeError(
                    f"terms order target {target!r} must be a single-valued "
                    "metric (count/sum/avg/min/max)")
        for _, sub in node.sub_aggs:
            validate_agg_tree(schema, sub)
        return
    if isinstance(node, (FilterAgg, PostFilterAgg)):
        for _, sub in node.sub_aggs:
            validate_agg_tree(schema, sub)
        return
    if isinstance(node, TopHitsAgg):
        if node.sort_field is not None:
            _numeric(node.sort_field, "TopHitsAgg sort")
        return
    raise TypeError(f"unknown agg node {type(node)!r}")


# -- structural keys ---------------------------------------------------------

def structural_key(node) -> tuple:
    """Hashable shape of an agg tree for the compile cache. Parameters that
    change program structure (fields, interval, size, percents count, query
    shapes) are part of the key."""
    if isinstance(node, dict):
        return tuple((k, structural_key(v)) for k, v in node.items())
    if isinstance(node, CountAgg):
        return ("count",)
    if isinstance(node, SumAgg):
        return ("sum", node.field)
    if isinstance(node, MinAgg):
        return ("min", node.field)
    if isinstance(node, MaxAgg):
        return ("max", node.field)
    if isinstance(node, AvgAgg):
        return ("avg", node.field)
    if isinstance(node, StatsAgg):
        return ("stats", node.field)
    if isinstance(node, PercentilesAgg):
        return ("percentiles", node.field, node.percents)
    if isinstance(node, HistogramAgg):
        return ("histogram", node.field, node.interval, node.offset,
                node.calendar,
                tuple((k, structural_key(v)) for k, v in node.sub_aggs))
    if isinstance(node, FacetAgg):
        return ("facet", node.field, node.path, node.size)
    if isinstance(node, TermsAgg):
        return ("terms", node.field, node.size, node.order,
                tuple((k, structural_key(v)) for k, v in node.sub_aggs))
    if isinstance(node, FilterAgg):
        return ("filter", query_structural_key(node.query),
                tuple((k, structural_key(v)) for k, v in node.sub_aggs))
    if isinstance(node, PostFilterAgg):
        return ("post_filter", query_structural_key(node.query),
                tuple((k, structural_key(v)) for k, v in node.sub_aggs))
    if isinstance(node, TopHitsAgg):
        return ("top_hits", node.size, node.sort_field, node.ascending)
    raise TypeError(f"unknown agg node {type(node)!r}")
