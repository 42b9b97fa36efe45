"""Query IR — the device analog of tantivy's Query/Weight/Scorer stack.

Where tantivy lowers a query to per-segment `Scorer` DocSet iterators
(SURVEY.md §2.2 T6/T7), this engine lowers a query to a **mask program**: a
vectorized boolean expression over HBM-resident columns producing a doc
bitmask. Boolean composition becomes bitwise algebra; range queries become
column compares in the int64 mono domain; term queries on keyword fields
become ordinal compares. Scoring is intentionally absent: every judged
aggregation path is scoring-independent (SURVEY.md §A.10).

Queries are immutable dataclasses. Their *structure* (tree shape, fields,
which bounds are present) is a jit-cache key; their *parameters* (the term,
the bounds) are traced device scalars, so re-running the same query shape
with different constants does not recompile.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple, Union


class Query:
    """Marker base class."""

    __slots__ = ()


@dataclass(frozen=True)
class MatchAllQuery(Query):
    """Matches every alive doc."""


@dataclass(frozen=True)
class TermQuery(Query):
    """Matches docs holding the exact value (any position for multi-valued).

    value: str for keyword fields, int for u64/i64/date, float for f64.
    """

    field: str
    value: Union[str, int, float]


@dataclass(frozen=True)
class RangeQuery(Query):
    """Inclusive/exclusive range over a numeric fast field (mono compare)."""

    field: str
    lower: Optional[Union[int, float]] = None
    upper: Optional[Union[int, float]] = None
    include_lower: bool = True
    include_upper: bool = False


@dataclass(frozen=True)
class PrefixQuery(Query):
    """Matches docs holding at least one term that starts with `prefix`
    (keyword/text fields). Lowered to an inclusive global-ordinal range —
    the term table is sorted, so all prefix-extensions form one contiguous
    ordinal run; like every parameter, the run's bounds are traced scalars
    (same query shape never recompiles)."""

    field: str
    prefix: str


@dataclass(frozen=True)
class PhraseQuery(Query):
    """Matches docs whose TEXT token stream contains the phrase's tokens
    ADJACENTLY and in order (tantivy `PhraseQuery` analog, zero slop —
    SURVEY.md §2.2 T7 era surface; spec in §A.13). `text` is run through
    the same tokenizer as indexing. Spec choice (§A.13): a multi-value
    text field indexes one concatenated token stream per doc, so phrases
    may match across adjacent values. Zero tokens match nothing; one
    token behaves like a TermQuery on the token.

    Lowering: the stored CSR token stream is position-ordered, so the
    phrase is a SHIFTED AND over the ordinal plane (row r matches iff
    ord[r+j] == token_j for all j and row r+n-1 is the same doc) — or,
    for docs within the dense per-position planes, an OR over start
    positions of per-plane compares (which also rides permuted views).
    Token ordinals are traced params: same
    token COUNT never recompiles."""

    field: str
    text: str

    @property
    def tokens(self) -> Tuple[str, ...]:
        from ..utils.tokenize import tokenize
        return tuple(tokenize(self.text))


@dataclass(frozen=True)
class TermSetQuery(Query):
    """Matches docs holding ANY of `values` (tantivy `TermSetQuery` analog,
    SURVEY.md §2.2 T7 era surface; spec §A.14). Semantics are exactly the
    OR of per-value TermQuery matches — every per-type coercion rule
    (stringy_term, numeric mono mapping, the f64 ±0 pair) is inherited.

    Lowering: values map to the column's w/ordinal domain and collapse into
    inclusive compare RUNS (adjacent integers merge), padded to a
    power-of-two run-slot count derived from len(values) — the slot count
    is the only structural component, so same-sized sets never recompile
    and the runs ride the multi-plane and permuted-view paths like ranges.
    Sets whose runs exceed 64 slots answer on the exact host path."""

    field: str
    values: Tuple = ()

    def __init__(self, field, values=()):
        object.__setattr__(self, "field", field)
        object.__setattr__(self, "values", tuple(values))


@dataclass(frozen=True)
class FuzzyTermQuery(Query):
    """Matches docs holding at least one term within Damerau-Levenshtein
    OSA edit `distance` of `term` (tantivy `FuzzyTermQuery` analog; spec
    §A.14 — `transpositions` picks OSA vs plain Levenshtein, distance must
    be 0..2, `prefix_length` chars must match verbatim). Keyword/text
    fields; the match is against stored terms (post-tokenization for text).

    Lowering: the predicate (utils/termmatch.py) runs over the global term
    table host-side; matched ordinals collapse into compare runs (fixed 32
    run slots — beyond that, the exact host path answers)."""

    field: str
    term: str
    distance: int = 1
    transpositions: bool = True
    prefix_length: int = 0


@dataclass(frozen=True)
class RegexQuery(Query):
    """Matches docs holding at least one term that FULLY matches `pattern`
    (tantivy `RegexQuery` analog; spec §A.14 — Python `re` syntax, anchored
    like the reference's fullmatch semantics). Keyword/text/facet fields.
    Same run lowering as FuzzyTermQuery (fixed 64 run slots)."""

    field: str
    pattern: str


#: device run-slot capacities (structural: part of the compare-program
#: shape; expansions beyond them answer on the exact host path)
FUZZY_RUN_SLOTS = 32
REGEX_RUN_SLOTS = 64
TERMSET_RUN_CAP = 64


def run_slots(q: Query) -> int:
    """Padded run-slot count for a set-type query — a pure function of the
    query alone (never of the index), so structural keys stay
    index-independent."""
    if isinstance(q, TermSetQuery):
        n = min(max(len(q.values), 1), TERMSET_RUN_CAP)
        s = 1
        while s < n:
            s *= 2
        return s
    if isinstance(q, FuzzyTermQuery):
        return FUZZY_RUN_SLOTS
    if isinstance(q, RegexQuery):
        return REGEX_RUN_SLOTS
    raise TypeError(f"not a set-type query: {type(q)!r}")


@dataclass(frozen=True)
class ExistsQuery(Query):
    """Matches docs holding at least one value for `field`. Single-valued
    numeric fields always hold a value (missing -> type default, SURVEY.md
    §A.3), so exists on them is match-all."""

    field: str


@dataclass(frozen=True)
class BooleanQuery(Query):
    """Lucene/tantivy boolean semantics: all musts, no must_nots, and — when
    there are no must clauses — at least one should."""

    must: Tuple[Query, ...] = ()
    should: Tuple[Query, ...] = ()
    must_not: Tuple[Query, ...] = ()

    def __init__(self, must=(), should=(), must_not=()):
        object.__setattr__(self, "must", tuple(must))
        object.__setattr__(self, "should", tuple(should))
        object.__setattr__(self, "must_not", tuple(must_not))


def structural_key(q: Query) -> tuple:
    """Hashable description of the query *shape* (jit-cache key component).

    Parameters that are traced at runtime (term values, range bounds) are
    excluded; parameters that change program structure (which bounds exist,
    inclusivity) are included.
    """
    if isinstance(q, MatchAllQuery):
        return ("all",)
    if isinstance(q, TermQuery):
        return ("term", q.field)
    if isinstance(q, ExistsQuery):
        return ("exists", q.field)
    if isinstance(q, PrefixQuery):
        return ("prefix", q.field)
    if isinstance(q, TermSetQuery):
        return ("tset", q.field, run_slots(q))
    if isinstance(q, FuzzyTermQuery):
        return ("fuzzy", q.field)
    if isinstance(q, RegexQuery):
        return ("regex", q.field)
    if isinstance(q, PhraseQuery):
        # token COUNT is structural (static shift/plane-window count);
        # the token ordinals themselves are traced params
        return ("phrase", q.field, len(q.tokens))
    if isinstance(q, RangeQuery):
        return (
            "range",
            q.field,
            q.lower is not None,
            q.upper is not None,
            q.include_lower,
            q.include_upper,
        )
    if isinstance(q, BooleanQuery):
        return (
            "bool",
            tuple(structural_key(c) for c in q.must),
            tuple(structural_key(c) for c in q.should),
            tuple(structural_key(c) for c in q.must_not),
        )
    raise TypeError(f"unknown query type {type(q)!r}")
