"""Feature tests: TEXT fields + tokenizer, lexicographic string ranges,
document retrieval, segment merging, EngineConfig, stats."""

import numpy as np
import pytest

from tantivy_aggregations_tpu import (
    BooleanQuery,
    Index,
    MatchAllQuery,
    RangeQuery,
    SchemaBuilder,
    TermQuery,
    avg_agg,
    count_agg,
    sum_agg,
    terms_agg,
    top_hits_agg,
)
from tantivy_aggregations_tpu.engine_config import EngineConfig
from tantivy_aggregations_tpu.schema import Cardinality


def text_index():
    schema = (SchemaBuilder()
              .add_u64_field("qty")
              .add_text_field("body")
              .add_keyword_field("cat")
              .build())
    idx = Index.create_in_ram(schema)
    w = idx.writer()
    w.add_document({"qty": 1, "body": "The quick brown Fox!", "cat": "a"})
    w.add_document({"qty": 2, "body": "fox-trot, quick quick slow", "cat": "b"})
    w.commit()
    w.add_document({"qty": 3, "body": "Lazy dogs sleep.", "cat": "a"})
    w.commit()
    return idx


def check(idx, query, aggs):
    got = idx.searcher().agg_search(query, aggs)
    want = idx.oracle_searcher().agg_search(query, aggs)
    assert got == want, f"\ndevice: {got}\noracle: {want}"
    return got


def test_text_term_query():
    idx = text_index()
    r = check(idx, TermQuery("body", "quick"), {"n": count_agg(),
                                                "s": sum_agg("qty")})
    assert r["n"]["value"] == 2 and r["s"]["value"] == 3
    r = check(idx, TermQuery("body", "fox"), {"n": count_agg()})
    assert r["n"]["value"] == 2  # "Fox!" lowercased, "fox-trot" split
    r = check(idx, TermQuery("body", "Fox"), {"n": count_agg()})
    assert r["n"]["value"] == 0  # query terms are exact (pre-tokenized)


def test_text_terms_agg():
    idx = text_index()
    r = check(idx, MatchAllQuery(), {"t": terms_agg("body", size=3)})
    top = [(b["key"], b["doc_count"]) for b in r["t"]["buckets"]]
    assert top[0] == ("quick", 3)  # occurrence counting


def test_string_range_query():
    idx = text_index()
    r = check(idx, RangeQuery("cat", lower="a", upper="a",
                              include_upper=True), {"n": count_agg()})
    assert r["n"]["value"] == 2
    r = check(idx, RangeQuery("body", lower="d", upper="g"),
              {"n": count_agg()})
    # tokens in [d, g): dogs, fox -> docs 0, 1, 2
    assert r["n"]["value"] == 3
    r = check(idx, RangeQuery("cat", lower="b"), {"n": count_agg()})
    assert r["n"]["value"] == 1


def test_doc_retrieval():
    idx = text_index()
    d = idx.doc(0, 0)
    assert d["qty"] == 1 and d["cat"] == "a"
    assert d["body"] == ["the", "quick", "brown", "fox"]
    d = idx.doc(1, 0)
    assert d["cat"] == "a" and d["qty"] == 3
    with pytest.raises(IndexError):
        idx.doc(0, 99)


def test_top_hits_then_doc():
    idx = text_index()
    r = idx.searcher().agg_search(MatchAllQuery(),
                                  {"th": top_hits_agg(1, "qty")})
    hit = r["th"]["hits"][0]
    assert idx.doc(hit["segment"], hit["doc"])["qty"] == 3


def test_merge_segments():
    from fixtures import basic_index
    idx = basic_index(num_segments=3, with_deletes=True)
    before = idx.oracle_searcher().agg_search(
        MatchAllQuery(), {"n": count_agg(), "s": sum_agg("price"),
                          "t": terms_agg("cat", size=10),
                          "a": avg_agg("scores")})
    assert len(idx.segments) > 1
    idx.merge_segments()
    assert len(idx.segments) == 1
    assert idx.segments[0].alive is None or idx.segments[0].alive.all()
    after_o = idx.oracle_searcher().agg_search(
        MatchAllQuery(), {"n": count_agg(), "s": sum_agg("price"),
                          "t": terms_agg("cat", size=10),
                          "a": avg_agg("scores")})
    after_d = idx.searcher().agg_search(
        MatchAllQuery(), {"n": count_agg(), "s": sum_agg("price"),
                          "t": terms_agg("cat", size=10),
                          "a": avg_agg("scores")})
    assert before == after_o == after_d


def test_merge_persisted(tmp_path):
    from fixtures import basic_schema, DOCS
    idx = Index.create(str(tmp_path / "m"), basic_schema())
    w = idx.writer()
    for d in DOCS:
        w.add_document(d)
        w.commit()
    idx.merge_segments()
    idx2 = Index.open(str(tmp_path / "m"))
    assert len(idx2.segments) == 1
    r1 = idx.oracle_searcher().agg_search(MatchAllQuery(), {"n": count_agg()})
    r2 = idx2.oracle_searcher().agg_search(MatchAllQuery(), {"n": count_agg()})
    assert r1 == r2


def test_engine_config_dense_nb():
    # tiny dense budget forces the scatter path; results must not change
    from fixtures import random_index
    idx = random_index(21, n_docs=200, n_segments=2)
    aggs = {"t": terms_agg("cat", size=5, sub_aggs={"s": sum_agg("qty")})}
    a = idx.searcher(config=EngineConfig(dense_nb=1)).agg_search(
        MatchAllQuery(), aggs)
    b = idx.searcher().agg_search(MatchAllQuery(), aggs)
    c = idx.oracle_searcher().agg_search(MatchAllQuery(), aggs)
    assert a == b == c


def test_stats_collection():
    from fixtures import basic_index
    idx = basic_index()
    s = idx.searcher(config=EngineConfig(collect_stats=True))
    s.agg_search(MatchAllQuery(), {"n": count_agg()})
    st = s.last_stats
    assert st is not None and st.total_ms > 0
    assert st.program_cached is False
    s.agg_search(MatchAllQuery(), {"n": count_agg()})
    assert s.last_stats.program_cached is True


def test_exists_query():
    from tantivy_aggregations_tpu import ExistsQuery
    schema = (SchemaBuilder().add_u64_field("v")
              .add_keyword_field("k")
              .add_keyword_field("tags", cardinality=Cardinality.MULTI)
              .build())
    idx = Index.create_in_ram(schema)
    w = idx.writer()
    w.add_document({"v": 1, "k": "a", "tags": ["x"]})
    w.add_document({"v": 2})
    w.add_document({"k": "b", "tags": []})
    w.commit()
    r = check(idx, ExistsQuery("k"), {"n": count_agg()})
    assert r["n"]["value"] == 2
    r = check(idx, ExistsQuery("tags"), {"n": count_agg()})
    assert r["n"]["value"] == 1
    r = check(idx, ExistsQuery("v"), {"n": count_agg()})
    assert r["n"]["value"] == 3  # single numeric always has a value (§A.3)
    r = check(idx, BooleanQuery(must=[ExistsQuery("k")],
                                must_not=[ExistsQuery("tags")]),
              {"n": count_agg()})
    assert r["n"]["value"] == 1


def test_pallas_interpret_metrics_parity():
    """Root metrics (count/sum/min/max over a narrow plane) run as plain
    XLA reductions — the fused metrics kernel they once had is gone —
    with the int8 matmul limb sums on and off."""
    from fixtures import random_index
    idx = random_index(31, n_docs=300, n_segments=2, delete_frac=0.2)
    aggs = {"st": __import__("tantivy_aggregations_tpu").stats_agg("qty"),
            "sp": sum_agg("price"), "n": count_agg()}
    for cfg in (EngineConfig(), EngineConfig(dense_mxu=False)):
        for q in [MatchAllQuery(), RangeQuery("qty", lower=100, upper=800)]:
            a = idx.searcher(config=cfg).agg_search(q, aggs)
            b = idx.oracle_searcher().agg_search(q, aggs)
            assert a == b


def test_epoch_invalidation_on_mutation():
    """Searcher must reload device columns after commits/deletes/merges."""
    from fixtures import basic_schema
    idx = Index.create_in_ram(basic_schema())
    w = idx.writer()
    w.add_document({"qty": 5, "cat": "x"})
    w.commit()
    s = idx.searcher()
    o = idx.oracle_searcher()
    q = MatchAllQuery()
    aggs = {"n": count_agg(), "s": sum_agg("qty")}
    assert s.agg_search(q, aggs) == o.agg_search(q, aggs)
    w2 = idx.writer()
    w2.add_document({"qty": 7, "cat": "y"})
    w2.commit()
    r = s.agg_search(q, aggs)
    assert r == o.agg_search(q, aggs) and r["s"]["value"] == 12
    w3 = idx.writer()
    w3.delete_term("cat", "x")
    w3.commit()
    r = s.agg_search(q, aggs)
    assert r == o.agg_search(q, aggs) and r["n"]["value"] == 1
    idx.merge_segments()
    r = s.agg_search(q, aggs)
    assert r == o.agg_search(q, aggs) and r["s"]["value"] == 7


def test_columnar_vs_perdoc_equivalence():
    """The bulk columnar ingestion path must produce a byte-equivalent index
    to per-doc ingestion (same fruits for a broad tree)."""
    import numpy as np
    from fixtures import basic_schema
    rng = np.random.default_rng(5)
    n = 200
    qty = rng.integers(0, 50, n, dtype=np.uint64)
    price = np.round(rng.standard_normal(n) * 9, 2)
    cats = [f"c{int(i)}" for i in rng.integers(0, 6, n)]
    nv = rng.integers(0, 3, n)
    offs = np.zeros(n + 1, np.uint32)
    np.cumsum(nv, out=offs[1:])
    counts_vals = rng.integers(0, 9, int(offs[-1]), dtype=np.uint64)

    idx_a = Index.create_in_ram(basic_schema())
    wa = idx_a.writer()
    wa.add_documents_columnar(
        {"qty": qty, "price": price, "cat": cats,
         "counts": (offs, counts_vals)}, n)
    wa.commit()

    idx_b = Index.create_in_ram(basic_schema())
    wb = idx_b.writer()
    for i in range(n):
        wb.add_document({"qty": int(qty[i]), "price": float(price[i]),
                         "cat": cats[i],
                         "counts": [int(v) for v in
                                    counts_vals[offs[i]:offs[i + 1]]]})
    wb.commit()

    aggs = {"n": count_agg(), "s": sum_agg("price"),
            "t": terms_agg("cat", size=10, sub_aggs={"q": sum_agg("qty")}),
            "a": avg_agg("counts")}
    q = MatchAllQuery()
    ra = idx_a.searcher().agg_search(q, aggs)
    rb = idx_b.searcher().agg_search(q, aggs)
    ro = idx_a.oracle_searcher().agg_search(q, aggs)
    assert ra == rb == ro


# -- round-2 regression tests -------------------------------------------------

def test_bool_should_is_scoring_hint_under_must():
    """SURVEY §A.10 spec choice: with scoring disabled, `should` does not
    constrain the match set when a `must` clause is present (Lucene/ES
    filter-context semantics); with no `must`, at least one `should` must
    match."""
    from fixtures import basic_index
    idx = basic_index()
    must_only = check(idx, BooleanQuery(must=[TermQuery("cat", "a")]),
                      {"n": count_agg()})
    with_should = check(
        idx, BooleanQuery(must=[TermQuery("cat", "a")],
                          should=[TermQuery("qty", 7)]),
        {"n": count_agg()})
    assert with_should["n"]["value"] == must_only["n"]["value"] == 2
    should_only = check(
        idx, BooleanQuery(should=[TermQuery("cat", "a"), TermQuery("qty", 7)]),
        {"n": count_agg()})
    assert should_only["n"]["value"] == 3  # OR semantics without must


def test_pallas_fused_metrics_large_span_exact():
    """ADVICE r1 (high): 13-bit-split partial sums can overflow int32 for
    narrow columns with span >= ~2^26. The plain XLA metric reductions
    (ts_count / ts_sum_plane / masked min-max) stay exact there."""
    import jax
    import jax.numpy as jnp
    from tantivy_aggregations_tpu.ops import reductions as R

    def fused_metrics(mask, plane):
        with jax.enable_x64(True):
            return (R.ts_count(mask), R.ts_sum_plane(plane, mask),
                    R.masked_min_i32(plane, mask),
                    R.masked_max_i32(plane, mask))

    rng = np.random.default_rng(0)
    n = 262144
    vals = rng.integers(0, 2**30, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    cnt, tot, mn, mx = jax.jit(fused_metrics)(jnp.asarray(mask),
                                              jnp.asarray(vals))
    sel = vals[mask]
    assert int(cnt) == int(mask.sum())
    assert int(tot) == int(np.sum(sel, dtype=np.int64))
    assert int(mn) == int(sel.min())
    assert int(mx) == int(sel.max())
    # signed limb-plane-style values (floor-shift negative high splits)
    svals = rng.integers(-(2**25), 2**25, n).astype(np.int32)
    _, stot, smn, smx = jax.jit(fused_metrics)(jnp.asarray(mask),
                                               jnp.asarray(svals))
    ssel = svals[mask]
    assert int(stot) == int(np.sum(ssel, dtype=np.int64))
    assert int(smn) == int(ssel.min()) and int(smx) == int(ssel.max())


def test_pallas_large_span_engine_parity():
    """End-to-end: a u64 column with span > 2^26 through the root metric
    path stays bit-identical to the oracle."""
    from tantivy_aggregations_tpu import stats_agg
    schema = SchemaBuilder().add_u64_field("big").build()
    idx = Index.create_in_ram(schema)
    w = idx.writer()
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 2**30, 4096, dtype=np.uint64)
    vals[0] = 2**30 + 12345
    w.add_documents_columnar({"big": vals}, 4096)
    w.commit()
    s = idx.searcher()
    aggs = {"st": stats_agg("big")}
    prog = s._program_for(MatchAllQuery(), aggs)
    assert prog.plan[("a", "st")]["kind"] == "metric"
    got = s.agg_search(MatchAllQuery(), aggs)
    want = idx.oracle_searcher().agg_search(MatchAllQuery(), aggs)
    assert got == want


def test_top_hits_sentinel_collision():
    """ADVICE r1 (high): on wide columns the descending sort key of the
    column-min doc equals the old unmatched sentinel I64_MAX; the engine
    returned a non-matching doc. Matched-ness is now an explicit sort key."""
    schema = SchemaBuilder().add_u64_field("v").build()
    idx = Index.create_in_ram(schema)
    w = idx.writer()
    w.add_document({"v": 2**40})   # doc 0: wide span; excluded by the query
    w.add_document({"v": 0})       # doc 1: the column minimum (key ~rm = I64_MAX)
    w.add_document({"v": 3})       # doc 2
    w.commit()
    q = RangeQuery("v", upper=5, include_upper=True)
    r = check(idx, q, {"h": top_hits_agg(2, "v", ascending=False)})
    assert [h["doc"] for h in r["h"]["hits"]] == [2, 1]
    # ascending variant with the max-value doc matched
    r = check(idx, q, {"h": top_hits_agg(3, "v", ascending=True)})
    assert [h["doc"] for h in r["h"]["hits"]] == [1, 2]


def test_percentile_percents_validation():
    """Out-of-range percents are rejected at prepare time (ES parity);
    ADVICE r1: the device rank path assumed 0 <= p <= 100."""
    from tantivy_aggregations_tpu import percentiles_agg
    from fixtures import basic_index
    idx = basic_index()
    for bad in (-1.0, 100.5, float("nan")):
        with pytest.raises(ValueError):
            idx.searcher().agg_search(
                MatchAllQuery(), {"p": percentiles_agg("qty", [50.0, bad])})
        with pytest.raises(ValueError):
            idx.oracle_searcher().agg_search(
                MatchAllQuery(), {"p": percentiles_agg("qty", [bad])})
    with pytest.raises(ValueError):
        idx.searcher().agg_search(MatchAllQuery(),
                                  {"p": percentiles_agg("qty", [])})
    # boundary percents are legal and exact
    r = check(idx, MatchAllQuery(),
              {"p": percentiles_agg("qty", [0.0, 100.0])})
    assert r["p"]["values"]["0.0"] == 0.0
    assert r["p"]["values"]["100.0"] == 11.0


def test_program_public_entry_surface():
    """Program.as_callable() exposes (raw_fn, example_args) without private
    attribute access (used by __graft_entry__.entry)."""
    import jax
    from fixtures import basic_index
    idx = basic_index()
    s = idx.searcher()
    aggs = {"n": count_agg(), "s": sum_agg("qty")}
    prog = s._program_for(TermQuery("cat", "a"), aggs)
    fn, args = prog.as_callable()
    raw = jax.jit(fn)(*args)
    assert prog.finalize(raw, aggs) == \
        idx.oracle_searcher().agg_search(TermQuery("cat", "a"), aggs)


def test_prefix_query():
    """PrefixQuery: keyword/text prefix match == contiguous ordinal run of
    the sorted term table (device) == startswith (oracle, spec-first)."""
    from tantivy_aggregations_tpu import PrefixQuery
    from fixtures import random_index, basic_index
    idx = random_index(21, n_docs=400, n_segments=3, card=60)
    s, o = idx.searcher(), idx.oracle_searcher()
    aggs = {"n": count_agg(), "s": sum_agg("qty"),
            "t": terms_agg("tags", size=5)}
    for q in [PrefixQuery("cat", "cat00"),       # many matches
              PrefixQuery("cat", "cat0001"),     # exact-term prefix
              PrefixQuery("cat", ""),            # empty prefix = exists
              PrefixQuery("cat", "zzz"),         # no matches
              PrefixQuery("tags", "t"),          # multi-valued field
              BooleanQuery(must=[PrefixQuery("cat", "cat001")],
                           must_not=[PrefixQuery("tags", "t1")])]:
        got = s.agg_search(q, aggs)
        want = o.agg_search(q, aggs)
        assert got == want, f"{q}\n{got}\n{want}"
    # same shape, different prefix params -> no recompile (cached program)
    p1 = s._program_for(PrefixQuery("cat", "cat00"), aggs)
    p2 = s._program_for(PrefixQuery("cat", "cat03"), aggs)
    assert p1 is p2
    # type guard
    import pytest
    with pytest.raises(TypeError):
        s.agg_search(PrefixQuery("qty", "1"), {"n": count_agg()})


def test_top_hits_by_score():
    """sort_field=None orders by SCORE (§A.10: scoring-disabled constant
    scores -> first-k matched docs in (segment, doc) order, score 1.0)."""
    from fixtures import basic_index, random_index
    idx = basic_index(num_segments=2, with_deletes=True)
    r = check(idx, MatchAllQuery(), {"th": top_hits_agg(3)})
    hits = r["th"]["hits"]
    assert all(h["score"] == 1.0 for h in hits)
    addrs = [(h["segment"], h["doc"]) for h in hits]
    assert addrs == sorted(addrs) and len(hits) == 3
    # filtered query: only matched docs appear
    r = check(idx, TermQuery("cat", "b"), {"th": top_hits_agg(10)})
    assert len(r["th"]["hits"]) == 2
    # under a bucket agg (in-slot selection), vs oracle on random data
    idx2 = random_index(33, n_docs=300, n_segments=3, card=8)
    check(idx2, MatchAllQuery(),
          {"t": terms_agg("cat", size=4,
                          sub_aggs={"th": top_hits_agg(2)})})
    check(idx2, RangeQuery("qty", lower=100, upper=700),
          {"th": top_hits_agg(5)})
