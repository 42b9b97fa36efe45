"""TermSet / Fuzzy / Regex query parity (SURVEY §A.14): device run-slot
lowering vs the oracle's spec-first per-term predicates, across field types
(keyword/text/facet, narrow+wide numerics, multi-valued), segments,
deletes, agg-tree filters, msearch reuse, and the run-overflow host path."""

import numpy as np
import pytest

from tantivy_aggregations_tpu import (
    BooleanQuery,
    Cardinality,
    FuzzyTermQuery,
    Index,
    MatchAllQuery,
    RegexQuery,
    SchemaBuilder,
    TermQuery,
    TermSetQuery,
    count_agg,
    filter_agg,
    sum_agg,
    terms_agg,
)
from fixtures import basic_index

AGGS = {"n": count_agg(), "s": sum_agg("qty")}


def build(docs, schema=None, deletes=(), segments_at=()):
    if schema is None:
        schema = (SchemaBuilder()
                  .add_keyword_field("cat")
                  .add_keyword_field("tags", cardinality=Cardinality.MULTI)
                  .add_text_field("body")
                  .add_u64_field("qty")
                  .add_u64_field("big")
                  .add_f64_field("price")
                  .build())
    idx = Index.create_in_ram(schema)
    w = idx.writer()
    for i, d in enumerate(docs):
        w.add_document(d)
        if i in segments_at:
            w.commit()
    w.commit()
    if deletes:
        w2 = idx.writer()
        for f, v in deletes:
            w2.delete_term(f, v)
        w2.commit()
    return idx


DOCS = [
    {"cat": "apple", "tags": ["red", "ripe"], "body": "fresh apple pie",
     "qty": 1, "big": 10, "price": 0.5},
    {"cat": "apply", "tags": ["red"], "body": "apply the patch",
     "qty": 2, "big": 2**40, "price": -0.0},
    {"cat": "banana", "tags": ["yellow", "long"], "body": "banana bread",
     "qty": 4, "big": 2**40 + 1, "price": 0.0},
    {"cat": "band", "tags": [], "body": "the band played on",
     "qty": 8, "big": 7, "price": 3.25},
    {"cat": "bend", "tags": ["blue", "bent"], "body": "bend the rules",
     "qty": 16, "big": 2**63, "price": -3.25},
    {"tags": ["red", "blue"], "body": "no category here",
     "qty": 32, "big": 11, "price": 100.0},
]


def check(idx, q, aggs=AGGS):
    got = idx.searcher().agg_search(q, aggs)
    want = idx.oracle_searcher().agg_search(q, aggs)
    assert got == want, f"\nquery: {q}\ndevice: {got}\noracle: {want}"
    return got


# -- TermSetQuery ------------------------------------------------------------

def test_termset_keyword():
    idx = build(DOCS, segments_at=(2,))
    out = check(idx, TermSetQuery("cat", ["apple", "bend"]))
    assert out["n"]["value"] == 2 and out["s"]["value"] == 17
    check(idx, TermSetQuery("cat", ["apple", "apply", "banana", "band"]))
    check(idx, TermSetQuery("cat", ["nope", "banana", "zzz"]))
    assert check(idx, TermSetQuery("cat", []))["n"]["value"] == 0
    assert check(idx, TermSetQuery("cat", ["missing"]))["n"]["value"] == 0
    # duplicates collapse
    check(idx, TermSetQuery("cat", ["band", "band", "band"]))


def test_termset_multi_keyword_and_text():
    idx = build(DOCS, segments_at=(1, 3))
    out = check(idx, TermSetQuery("tags", ["red", "yellow"]))
    assert out["n"]["value"] == 4
    check(idx, TermSetQuery("tags", ["bent"]))
    check(idx, TermSetQuery("body", ["banana", "rules", "nothere"]))


def test_termset_numeric_narrow_wide_f64():
    idx = build(DOCS)
    # narrow u64: adjacent values merge into one run
    out = check(idx, TermSetQuery("qty", [1, 2, 4, 99]))
    assert out["n"]["value"] == 3
    # wide u64 (span > 2^31): lexicographic pair-run compares
    out = check(idx, TermSetQuery("big", [2**40, 2**40 + 1, 2**63, 5]))
    assert out["n"]["value"] == 3
    # f64: 0.0 matches the stored -0.0 too (±0 mono pair, §A.10)
    out = check(idx, TermSetQuery("price", [0.0]))
    assert out["n"]["value"] == 2
    out = check(idx, TermSetQuery("price", [-0.0, 3.25]))
    assert out["n"]["value"] == 3
    check(idx, TermSetQuery("price", [float("nan"), 100.0]))
    # plain TermQuery inherits the same NaN-matches-nothing spec
    assert check(idx, TermQuery("price", float("nan")))["n"]["value"] == 0


def test_termset_on_basic_fixture_with_deletes():
    idx = basic_index(num_segments=2, with_deletes=True)
    check(idx, TermSetQuery("cat", ["a", "c"]),
          {"n": count_agg(), "t": terms_agg("tags")})
    check(idx, TermSetQuery("counts", [2, 3, 10]))


def test_termset_inside_bool_and_filter_agg():
    idx = build(DOCS, segments_at=(2,))
    q = BooleanQuery(must=[TermSetQuery("cat", ["apple", "banana", "bend"])],
                     must_not=[TermQuery("tags", "yellow")])
    check(idx, q)
    aggs = {"f": filter_agg(TermSetQuery("tags", ["red", "blue"]),
                            {"n": count_agg(), "s": sum_agg("qty")})}
    check(idx, MatchAllQuery(), aggs)


# -- FuzzyTermQuery ----------------------------------------------------------

def test_fuzzy_keyword():
    idx = build(DOCS, segments_at=(2,))
    out = check(idx, FuzzyTermQuery("cat", "apple", 1))
    assert out["n"]["value"] == 2  # apple, apply
    out = check(idx, FuzzyTermQuery("cat", "band", 1))
    assert out["n"]["value"] == 2  # band, bend
    check(idx, FuzzyTermQuery("cat", "banana", 0))
    check(idx, FuzzyTermQuery("cat", "bananaz", 2))
    check(idx, FuzzyTermQuery("cat", "zzz", 2))  # no match


def test_fuzzy_transpositions_and_prefix():
    idx = build(DOCS)
    # "appel" -> "apple" is one transposition: OSA matches at 1, plain
    # Levenshtein needs 2
    assert check(idx, FuzzyTermQuery("cat", "appel", 1, True))[
        "n"]["value"] == 1
    assert check(idx, FuzzyTermQuery(
        "cat", "appel", 1, transpositions=False))["n"]["value"] == 0
    assert check(idx, FuzzyTermQuery(
        "cat", "appel", 2, transpositions=False))["n"]["value"] >= 1
    # prefix gate: "bend" is 1 edit from "band" but fails prefix "ban"
    assert check(idx, FuzzyTermQuery("cat", "band", 1, prefix_length=3))[
        "n"]["value"] == 1


def test_fuzzy_text_tokens_and_multi():
    idx = build(DOCS, segments_at=(1,))
    check(idx, FuzzyTermQuery("body", "bannana", 1))
    check(idx, FuzzyTermQuery("tags", "rde", 1))      # OSA: matches "red"
    check(idx, FuzzyTermQuery("tags", "yello", 1))


def test_fuzzy_validation():
    idx = build(DOCS)
    with pytest.raises(ValueError):
        idx.searcher().agg_search(FuzzyTermQuery("cat", "x", 3), AGGS)
    with pytest.raises(ValueError):
        idx.oracle_searcher().agg_search(FuzzyTermQuery("cat", "x", 3), AGGS)
    for s in (idx.searcher(), idx.oracle_searcher()):
        with pytest.raises(TypeError):
            s.agg_search(FuzzyTermQuery("qty", "3", 1), AGGS)


# -- RegexQuery --------------------------------------------------------------

def test_regex_keyword_text():
    idx = build(DOCS, segments_at=(2,), deletes=[("cat", "band")])
    out = check(idx, RegexQuery("cat", "ap.*"))
    assert out["n"]["value"] == 2
    check(idx, RegexQuery("cat", "b.nd"))
    check(idx, RegexQuery("cat", ".*an.*"))
    check(idx, RegexQuery("cat", "zzz.*"))  # no match
    check(idx, RegexQuery("body", "p(ie|atch)"))
    # anchored: "pi" alone must NOT match "pie"
    n_pi = check(idx, RegexQuery("body", "pi"))["n"]["value"]
    assert n_pi == 0


def test_regex_type_errors():
    idx = build(DOCS)
    for s in (idx.searcher(), idx.oracle_searcher()):
        with pytest.raises(TypeError):
            s.agg_search(RegexQuery("qty", ".*"), AGGS)


# -- run overflow: exact host path, program survives -------------------------

def test_regex_run_overflow_host_path():
    # 200 terms matching a scatter pattern (every other term) -> 100 runs
    # > the 64 regex slots: the searcher must answer on the exact host
    # path; a fitting regex of the SAME shape keeps the device program
    docs = [{"cat": f"t{i:03d}x" if i % 2 else f"t{i:03d}", "qty": i}
            for i in range(200)]
    idx = build(docs)
    s = idx.searcher()
    fitting = RegexQuery("cat", "t00.*")
    overflowing = RegexQuery("cat", "t\\d{3}x")
    for q in (fitting, overflowing, fitting):
        got = s.agg_search(q, AGGS)
        want = idx.oracle_searcher().agg_search(q, AGGS)
        assert got == want
    # the overflow answer really came from the host path
    from tantivy_aggregations_tpu.query.compile import match_runs
    dindex = s._get_device_index()
    assert len(match_runs(dindex, overflowing)) > 64
    assert len(match_runs(dindex, fitting)) <= 64


def test_termset_large_set_buckets():
    # 100 values -> 64-slot bucket; contiguous terms collapse into few runs
    docs = [{"cat": f"c{i:03d}", "qty": i} for i in range(150)]
    idx = build(docs, segments_at=(70,))
    vals = [f"c{i:03d}" for i in range(100)]
    out = check(idx, TermSetQuery("cat", vals))
    assert out["n"]["value"] == 100
    # scattered set beyond 64 runs -> host path, still exact
    vals = [f"c{i:03d}" for i in range(0, 150, 2)]
    check(idx, TermSetQuery("cat", vals))


# -- msearch: same shape, different sets, one dispatch ------------------------

def test_set_queries_msearch():
    idx = build(DOCS, segments_at=(2,))
    reqs = [
        (TermSetQuery("cat", ["apple", "band"]), AGGS),
        (TermSetQuery("cat", ["bend", "zzz"]), AGGS),
        (TermSetQuery("cat", ["banana", "apply"]), AGGS),
        (FuzzyTermQuery("cat", "band", 1), AGGS),
        (FuzzyTermQuery("cat", "apple", 2), AGGS),
        (RegexQuery("cat", "a.*"), AGGS),
        (RegexQuery("cat", ".*nd"), AGGS),
    ]
    got = idx.searcher().agg_search_batch(reqs)
    want = [idx.oracle_searcher().agg_search(q, a) for q, a in reqs]
    assert got == want


def test_regex_facet():
    schema = (SchemaBuilder().add_facet_field("path")
              .add_u64_field("qty").build())
    idx = Index.create_in_ram(schema)
    w = idx.writer()
    for i, p in enumerate(["/a/x", "/a/y", "/b/x", "/b/z/q"]):
        w.add_document({"path": p, "qty": i + 1})
    w.commit()
    check(idx, RegexQuery("path", "/a/.*"))
    check(idx, RegexQuery("path", "/b/z(/.*)?"))
