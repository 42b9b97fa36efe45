"""Bucket mask-gather lowering (round 4, VERDICT r3 weak #3/#5): a
high-cardinality terms or large histogram gated by a NON-DENSE query
chain (token-stream text/phrase fields, CSR-overflow-tail multi fields)
used to drop to the scatter formulation. Now the already-evaluated
doc mask is gathered through the static pdoc plane (perm∘row_doc) and
rides the exact cumsum+bounds prefix machinery, like the percentile
mask_gather escape. [SURVEY.md §3.4; §2.1 C10]"""

import numpy as np

from tantivy_aggregations_tpu import (
    BooleanQuery,
    Index,
    MatchAllQuery,
    PhraseQuery,
    RangeQuery,
    SchemaBuilder,
    TermQuery,
    avg_agg,
    count_agg,
    histogram_agg,
    sum_agg,
    terms_agg,
)
from tantivy_aggregations_tpu.index.loader import DENSE_MULTI_K
from tantivy_aggregations_tpu.schema import Cardinality


def check(idx, query, aggs, mesh=None):
    got = idx.searcher(mesh=mesh).agg_search(query, aggs)
    want = idx.oracle_searcher().agg_search(query, aggs)
    assert got == want, f"\nquery: {query}\ndevice: {got}\noracle: {want}"
    return got


def text_index(n=2000, seed=21):
    """Text (token-stream) query field + high-card keyword and wide-domain
    u64 bucket fields — the c4/c3 shapes gated by phrase queries. Bodies
    routinely exceed DENSE_MULTI_K tokens, so the token column carries a
    CSR overflow tail and phrase masks are NOT permuted-view evaluable
    (the shape that used to force scatter mode)."""
    schema = (SchemaBuilder()
              .add_text_field("body")
              .add_u64_field("amount")
              .add_f64_field("price")
              .add_keyword_field("sku")
              .build())
    idx = Index.create_in_ram(schema)
    w = idx.writer()
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "omega", "zeta"]
    for i in range(n):
        nt = int(rng.integers(1, 8)) if rng.random() < 0.8 \
            else int(rng.integers(DENSE_MULTI_K + 1, DENSE_MULTI_K + 30))
        body = " ".join(words[int(j)] for j in rng.integers(0, 6, nt))
        w.add_document({
            "body": body,
            "amount": int(rng.integers(0, 2000)),
            "price": float(np.round(rng.lognormal(2.0, 1.0), 2)),
            "sku": f"s{int(rng.integers(0, 600)):05d}",
        })
        if i == n // 2:
            w.commit()
    w.commit()
    col = idx.searcher()._get_device_index().column("body")
    assert col.has_tail  # the non-dense shape is actually exercised
    return idx


def tailed_index(n=1200, seed=5):
    """CSR-overflow-tail multi query field + the same bucket fields."""
    schema = (SchemaBuilder()
              .add_u64_field("amount")
              .add_u64_field("vals", cardinality=Cardinality.MULTI)
              .add_keyword_field("sku")
              .build())
    idx = Index.create_in_ram(schema)
    w = idx.writer()
    rng = np.random.default_rng(seed)
    for i in range(n):
        nv = int(rng.integers(0, 4)) if rng.random() < 0.9 \
            else int(rng.integers(DENSE_MULTI_K, DENSE_MULTI_K + 9))
        w.add_document({"amount": int(rng.integers(0, 2000)),
                        "vals": [int(x) for x in rng.integers(0, 50, nv)],
                        "sku": f"s{int(rng.integers(0, 500)):05d}"})
    w.commit()
    col = idx.searcher()._get_device_index().column("vals")
    assert col.tail_w is not None
    return idx


TERMS = {"t": terms_agg("sku", size=10,
                        sub_aggs={"s": sum_agg("amount"),
                                  "a": avg_agg("price"),
                                  "n": count_agg()})}
HIST = {"h": histogram_agg("amount", interval=1,
                           sub_aggs={"s": sum_agg("amount")})}


def _plan(idx, q, aggs, path, mesh=None):
    return idx.searcher(mesh=mesh)._program_for(q, aggs).plan[path]


def test_phrase_gated_terms_plans_prefix():
    """VERDICT r3 #5 done-criterion: a phrase-gated high-card terms tree
    plans prefix (mask_gather), NOT scatter."""
    idx = text_index()
    p = _plan(idx, PhraseQuery("body", "alpha beta"), TERMS, ("a", "t"))
    assert p["mode"] == "prefix" and p.get("mask_gather"), p["mode"]
    for q in (PhraseQuery("body", "alpha beta"),
              PhraseQuery("body", "omega"),
              PhraseQuery("body", "alpha zebra"),       # missing token
              BooleanQuery(must=[PhraseQuery("body", "beta gamma"),
                                 RangeQuery("amount", lower=100)])):
        check(idx, q, TERMS)


def test_phrase_gated_histogram_plans_prefix():
    idx = text_index()
    p = _plan(idx, PhraseQuery("body", "alpha beta"), HIST, ("a", "h"))
    assert p["mode"] == "prefix" and p.get("mask_gather")
    check(idx, PhraseQuery("body", "alpha beta"), HIST)
    check(idx, PhraseQuery("body", "delta omega"), HIST)


def test_tail_gated_terms_plans_prefix():
    """CSR-overflow-tail query field: same escape."""
    idx = tailed_index()
    aggs = {"t": terms_agg("sku", size=10,
                           sub_aggs={"s": sum_agg("amount")})}
    p = _plan(idx, TermQuery("vals", 7), aggs, ("a", "t"))
    assert p["mode"] == "prefix" and p.get("mask_gather")
    for q in (TermQuery("vals", 7),
              RangeQuery("vals", lower=10, upper=30),
              TermQuery("vals", 9999)):
        check(idx, q, aggs)


def test_mask_gather_sharded_mesh():
    """Sharded: pdoc stays shard-local, counts psum over the mesh."""
    from tantivy_aggregations_tpu.parallel.shard import make_mesh
    idx = text_index(n=1600)
    mesh = make_mesh(4)
    p = _plan(idx, PhraseQuery("body", "alpha beta"), TERMS, ("a", "t"),
              mesh=mesh)
    assert p["mode"] == "prefix" and p.get("mask_gather")
    check(idx, PhraseQuery("body", "alpha beta"), TERMS, mesh=mesh)
    check(idx, PhraseQuery("body", "gamma"), HIST, mesh=mesh)


def test_mask_gather_msearch_batch():
    idx = text_index()
    s = idx.searcher()
    o = idx.oracle_searcher()
    reqs = [(PhraseQuery("body", ph), TERMS)
            for ph in ("alpha beta", "omega", "beta gamma",
                       "alpha beta", "zeta delta")]
    outs = s.agg_search_batch(reqs)
    for (q, a), got in zip(reqs, outs):
        assert got == o.agg_search(q, a), q


def test_mask_gather_with_deletes():
    idx = text_index(n=900)
    w = idx.writer()
    w.delete_term("sku", "s00007")
    w.commit()
    check(idx, PhraseQuery("body", "alpha beta"), TERMS)
