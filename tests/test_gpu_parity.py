"""GPU parity lane (SURVEY.md §4): a compact device-parity matrix that runs
against whatever JAX backend is active. In the default test lane this
executes on the virtual CPU mesh like everything else; run it on one GPU
with

    TAT_GPU_TESTS=1 python -m pytest tests -m gpu -q -p no:xdist

(one process for the card). The GPU lane is the regression net for
backend-specific behavior the CPU suite can't see: scoped x64, the batched
int8 dots (XLA:GPU once returned wrong products for unaligned contracting
sizes — ops/cube.py DOT_ALIGN), sort/top_k and the jitted piece
recombines on the GPU backend."""

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
    filter_agg,
    histogram_agg,
    max_agg,
    min_agg,
    percentiles_agg,
    stats_agg,
    sum_agg,
    terms_agg,
    top_hits_agg,
)
from tantivy_aggregations_tpu.schema import Cardinality

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def idx():
    schema = (SchemaBuilder()
              .add_u64_field("amount")        # narrow, direct-sum path
              .add_u64_field("big")           # span > 2^26
              .add_i64_field("delta")
              .add_f64_field("price")         # limb planes
              .add_date_field("ts")
              .add_keyword_field("status")    # low card dense
              .add_keyword_field("sku")       # high card -> prefix layout
              .add_keyword_field("tags", cardinality=Cardinality.MULTI)
              .add_u64_field("counts", cardinality=Cardinality.MULTI)
              .build())
    index = Index.create_in_ram(schema)
    w = index.writer()
    rng = np.random.default_rng(42)
    n = 40_000
    nv = rng.integers(0, 3, n)
    offs = np.zeros(n + 1, np.uint32)
    np.cumsum(nv, out=offs[1:])
    tags_nv = rng.integers(0, 4, n)
    tags_offs = np.zeros(n + 1, np.uint32)
    np.cumsum(tags_nv, out=tags_offs[1:])
    tag_vocab = np.asarray([f"t{i}" for i in range(12)], object)
    cols = {
        "amount": rng.integers(0, 10_000, n, dtype=np.uint64),
        "big": rng.integers(0, 2**30, n, dtype=np.uint64),
        "delta": rng.integers(-500, 500, n, dtype=np.int64),
        "price": np.round(rng.lognormal(2.0, 1.0, n), 2),
        "ts": (np.uint64(1_600_000_000_000_000)
               + rng.integers(0, 30 * 86_400_000_000, n, dtype=np.uint64)),
        "status": np.asarray(["a", "b", "c", "d"], object)[
            rng.integers(0, 4, n)],
        "sku": np.asarray([f"sku{int(i):05d}"
                           for i in rng.zipf(1.3, n) % 2000], object),
        "tags": (tags_offs, tag_vocab[rng.integers(0, 12, int(tags_offs[-1]))]),
        "counts": (offs, rng.integers(0, 100, int(offs[-1]),
                                      dtype=np.uint64)),
    }
    half = n // 2
    for lo, hi in ((0, half), (half, n)):
        part = {}
        for k, v in cols.items():
            if isinstance(v, tuple):
                o, vals = v
                part[k] = (o[lo:hi + 1] - o[lo], vals[o[lo]:o[hi]])
            else:
                part[k] = v[lo:hi]
        w.add_documents_columnar(part, hi - lo)
        w.commit()
    # deletes exercise the alive mask
    w2 = index.writer()
    w2.delete_term("status", "d")
    w2.commit()
    return index


def run(idx, query, aggs):
    got = idx.searcher().agg_search(query, aggs)
    want = idx.oracle_searcher().agg_search(query, aggs)
    assert got == want, f"\ndevice: {got}\noracle: {want}"
    return got


def test_metrics_pallas_paths(idx):
    run(idx, MatchAllQuery(),
        {"st": stats_agg("amount"), "big": stats_agg("big"),
         "sp": sum_agg("price"), "sd": sum_agg("delta"), "n": count_agg()})
    run(idx, TermQuery("status", "a"),
        {"st": stats_agg("amount"), "avg_c": avg_agg("counts")})


def test_queries_matrix(idx):
    for q in [
        RangeQuery("amount", lower=100, upper=9000, include_upper=True),
        RangeQuery("price", lower=1.5, upper=80.0),
        TermQuery("counts", 7),
        TermQuery("tags", "t3"),
        BooleanQuery(must=[RangeQuery("delta", lower=-100)],
                     must_not=[TermQuery("status", "b")]),
        RangeQuery("sku", lower="sku00010", upper="sku01000"),
    ]:
        run(idx, q, {"n": count_agg(), "s": sum_agg("amount")})


def test_bucket_paths(idx):
    day = 86_400_000_000
    run(idx, MatchAllQuery(),
        {"h": histogram_agg("ts", interval=day,
                            sub_aggs={"s": sum_agg("amount")})})
    run(idx, MatchAllQuery(),
        {"t": terms_agg("sku", size=10,
                        sub_aggs={"s": sum_agg("amount"),
                                  "n": count_agg()})})  # prefix layout
    run(idx, MatchAllQuery(),
        {"t": terms_agg("status", size=4, sub_aggs={
            "h": histogram_agg("amount", interval=1000,
                               sub_aggs={"a": avg_agg("price")})})})
    run(idx, MatchAllQuery(),
        {"t": terms_agg("tags", size=12, sub_aggs={"s": sum_agg("amount")})})


def test_terms_order_paths(idx):
    run(idx, MatchAllQuery(),
        {"t": terms_agg("sku", size=10, order=("s", "desc"),
                        sub_aggs={"s": sum_agg("amount")})})
    run(idx, MatchAllQuery(),
        {"t": terms_agg("status", size=4, order=("a", "asc"),
                        sub_aggs={"a": avg_agg("price")})})


def test_percentiles_and_tophits(idx):
    run(idx, RangeQuery("amount", lower=100),
        {"p": percentiles_agg("price"),
         "pf": filter_agg(TermQuery("status", "a"),
                          sub_aggs={"n": count_agg()})})
    run(idx, MatchAllQuery(),
        {"p": percentiles_agg("delta", [2.5, 50.0, 97.5])})
    run(idx, RangeQuery("big", upper=2**29),
        {"th": top_hits_agg(5, "big", ascending=False),
         "lo": min_agg("big")})
    run(idx, MatchAllQuery(),
        {"t": terms_agg("status", size=4, sub_aggs={
            "p": percentiles_agg("price"),
            "th": top_hits_agg(3, "amount")})})


def test_msearch_stream_on_device(idx):
    s = idx.searcher()
    o = idx.oracle_searcher()
    aggs = {"n": count_agg(), "s": sum_agg("amount"),
            "lo": min_agg("price")}
    reqs = [(TermQuery("status", c), aggs) for c in "abcabc"] * 4
    outs = list(s.agg_search_stream(iter(reqs), lookahead=3))
    for (q, a), got in zip(reqs, outs):
        assert got == o.agg_search(q, a)


def test_calendar_and_prefix(idx):
    from tantivy_aggregations_tpu import PrefixQuery, date_histogram_agg
    run(idx, PrefixQuery("sku", "sku000"),
        {"n": count_agg(), "s": sum_agg("amount"),
         "w": date_histogram_agg("ts", calendar_interval="week")})
    run(idx, MatchAllQuery(),
        {"m": date_histogram_agg("ts", calendar_interval="month",
                                 sub_aggs={"s": sum_agg("amount")}),
         "d": date_histogram_agg("ts", calendar_interval="day")})
    run(idx, BooleanQuery(must=[PrefixQuery("tags", "t1")],
                          must_not=[PrefixQuery("status", "b")]),
        {"n": count_agg()})


def test_prefix_pallas_compiled(idx):
    """Prefix-mode terms (permuted chain re-eval + per-32-block counts and
    split payload sums, cumsums at the bucket bounds) on the live backend
    stay bit-identical to the oracle; tests/test_pallas_prefix.py is the
    CPU matrix."""
    s = idx.searcher()
    aggs = {"t": terms_agg("sku", size=8,
                           sub_aggs={"s": sum_agg("amount"),
                                     "sp": sum_agg("price"),
                                     "n": count_agg()})}
    q = RangeQuery("amount", lower=50, upper=9000)
    prog = s._program_for(q, aggs)
    assert prog.plan[("a", "t")]["mode"] == "prefix"
    run(idx, q, aggs)
    # multi-valued chain field (mp-plane compares in layout space) + avg
    # over a multi-valued payload (per-doc preagg cnt/sum planes through
    # the 13-bit-split sums). The range conjunct keeps the chain off the
    # member-operand path (a bare term-on-multi would plan member_op)
    q2 = BooleanQuery(must=[TermQuery("tags", "t5"),
                            RangeQuery("amount", lower=1)])
    aggs2 = {"t": terms_agg("sku", size=6,
                            sub_aggs={"a": avg_agg("counts")})}
    prog2 = s._program_for(q2, aggs2)
    assert not prog2.plan[("a", "t")].get("member_op")
    run(idx, q2, aggs2)


def test_slot_rank_pallas_compiled(idx):
    """slot_rank nested percentiles on the device: the default config
    plans the value-domain cube (scube — per-slot block-histogram int8
    matmul) for this cube-able chain, use_cube=False takes the row-pass
    per-slot block counts, and both stay bit-identical to the oracle."""
    from tantivy_aggregations_tpu.engine_config import EngineConfig
    s = idx.searcher()
    q = RangeQuery("amount", lower=100, upper=9000)
    aggs = {"t": terms_agg("status", size=4,
                           sub_aggs={"p": percentiles_agg(
                               "price", (25.0, 50.0, 75.0))})}
    prog = s._program_for(q, aggs)
    assert prog.plan[("a", "t", "p")]["pmode"] == "slot_rank"
    assert prog.plan[("a", "t", "p")].get("scube") is not None, \
        f"slot_rank fell off the cube path: {prog.plan[('a', 't', 'p')]}"
    run(idx, q, aggs)
    # the row-pass slot counts (cube off)
    sk = idx.searcher(config=EngineConfig(use_cube=False))
    progk = sk._program_for(q, aggs)
    assert progk.plan[("a", "t", "p")].get("scube") is None
    assert sk.agg_search(q, aggs) == idx.oracle_searcher().agg_search(
        q, aggs)


def test_phrase_query_on_device(idx):
    """PhraseQuery shifted-AND + scatter-or doc-mask lowering on the live
    backend (CSR stream path), small dedicated text index."""
    import numpy as np
    from tantivy_aggregations_tpu import PhraseQuery, SchemaBuilder
    schema = (SchemaBuilder().add_text_field("body")
              .add_u64_field("q").build())
    tix = Index.create_in_ram(schema)
    w = tix.writer()
    rng = np.random.default_rng(17)
    vocab = ["p%d" % i for i in range(6)]
    for i in range(400):
        toks = [vocab[int(t)] for t in rng.integers(0, 6,
                                                    int(rng.integers(0, 16)))]
        w.add_document({"body": " ".join(toks), "q": int(i)})
    w.commit()
    for text in ("p1 p2", "p0 p0", "p3 p4 p5"):
        got = tix.searcher().agg_search(PhraseQuery("body", text),
                                        {"n": count_agg(),
                                         "s": sum_agg("q")})
        want = tix.oracle_searcher().agg_search(
            PhraseQuery("body", text), {"n": count_agg(),
                                        "s": sum_agg("q")})
        assert got == want


def test_set_queries_on_device(idx):
    """TermSet/Fuzzy/Regex run-slot lowering on the live backend (§A.14):
    flat masks across field types, and a set query as the CHAIN of a
    prefix-mode terms agg (run compares in permuted layout space)."""
    from tantivy_aggregations_tpu import (FuzzyTermQuery, RegexQuery,
                                          TermSetQuery)
    for q in [
        TermSetQuery("status", ["a", "c"]),
        TermSetQuery("amount", [5, 6, 7, 9000]),
        TermSetQuery("counts", [7, 8, 42]),        # multi-valued CSR field
        FuzzyTermQuery("status", "b", 1),
        FuzzyTermQuery("tags", "t33", 1),
        RegexQuery("sku", "sku000[0-5]\\d"),
    ]:
        run(idx, q, {"n": count_agg(), "s": sum_agg("amount")})
    # set query in a prefix-terms chain -> run compares inside the kernel
    s = idx.searcher()
    aggs = {"t": terms_agg("sku", size=8, sub_aggs={"s": sum_agg("amount")})}
    q = RegexQuery("status", "[ab]")
    prog = s._program_for(q, aggs)
    assert prog.plan[("a", "t")]["mode"] == "prefix"
    run(idx, q, aggs)


def test_member_op_gather_rows_on_device(idx):
    """Member operand (per-(value, bucket) int8 pieces) fetched by a
    dynamic-slice row gather on the live backend: bench c7's shape."""
    s = idx.searcher()
    o = idx.oracle_searcher()
    aggs = {"t": terms_agg("sku", size=8,
                           sub_aggs={"s": sum_agg("amount"),
                                     "n": count_agg()})}
    prog = s._program_for(TermQuery("counts", 42), aggs)
    mo = prog.plan[("a", "t")].get("member_op")
    assert mo, prog.plan[("a", "t")]
    for v in (42, 0, 99, 10**9):
        run(idx, TermQuery("counts", v), aggs)
    # msearch rotation: the vmapped group becomes one [B, W] row gather
    reqs = [(TermQuery("counts", v), aggs) for v in (42, 7, 42, 99, 3)]
    assert s.agg_search_batch(reqs) == [o.agg_search(qq, aa)
                                        for qq, aa in reqs]


def test_bucket_mask_gather_on_device():
    """Token-stream (CSR-tail) gated prefix terms/histogram: the doc mask
    gathers through the static pdoc plane on the chip instead of scatter
    mode (tests/test_bucket_mask_gather.py is the CPU matrix)."""
    from tantivy_aggregations_tpu import PhraseQuery
    schema = (SchemaBuilder().add_text_field("body")
              .add_u64_field("amount").add_keyword_field("sku").build())
    tix = Index.create_in_ram(schema)
    w = tix.writer()
    rng = np.random.default_rng(33)
    words = ["alpha", "beta", "gamma", "delta"]
    for i in range(3000):
        nt = int(rng.integers(1, 6)) if rng.random() < 0.8 \
            else int(rng.integers(9, 30))
        w.add_document({"body": " ".join(words[int(j)]
                                         for j in rng.integers(0, 4, nt)),
                        "amount": int(rng.integers(0, 2000)),
                        "sku": f"s{int(rng.integers(0, 600)):05d}"})
    w.commit()
    aggs = {"t": terms_agg("sku", size=8, sub_aggs={"s": sum_agg("amount")})}
    p = tix.searcher()._program_for(PhraseQuery("body", "alpha beta"),
                                    aggs).plan[("a", "t")]
    assert p["mode"] == "prefix" and p.get("mask_gather"), p["mode"]
    for text in ("alpha beta", "gamma", "alpha zebra"):
        got = tix.searcher().agg_search(PhraseQuery("body", text), aggs)
        want = tix.oracle_searcher().agg_search(PhraseQuery("body", text),
                                                aggs)
        assert got == want


def test_nonint_pct_under_terms_on_device(idx):
    """Non-integer percents under a terms ancestor: slot_rank device plan
    with host-resolved phase-2 ranks over full-slot-space intermediates
    (the terms node selects host-side) — traced-int64 heavy, a
    backend-specific regression surface."""
    s = idx.searcher()
    aggs = {"t": terms_agg("status", size=4,
                           sub_aggs={"p": percentiles_agg(
                               "price", (12.5, 50.5, 99.9))})}
    prog = s._program_for(MatchAllQuery(), aggs)
    pp = prog.plan[("a", "t", "p")]
    assert pp["pmode"] == "slot_rank" and not pp["int_percents"]
    assert prog.plan[("a", "t")]["sel"] == "host"
    for q in (MatchAllQuery(), TermQuery("status", "a"),
              RangeQuery("amount", lower=10**9)):
        run(idx, q, aggs)


def test_structural_fuzz_sampled_on_device():
    """A sampled slice of the CPU structural-fuzz lane on the live
    backend: random tree x query draws, device == oracle."""
    from fixtures import random_index
    from test_fuzz import _rand_bucket, _rand_leafy, _rand_query
    for seed in (7, 91):
        rng = np.random.default_rng(seed)
        fix = random_index(seed, n_docs=400, n_segments=2)
        s, o = fix.searcher(), fix.oracle_searcher()
        done = 0
        for _attempt in range(60):
            if done >= 6:
                break
            q = _rand_query(rng)
            tree = {"a": _rand_bucket(rng, depth=1)}
            if rng.random() < 0.5:
                tree["m"] = _rand_leafy(rng)
            try:
                want = o.agg_search(q, tree)
            except (ValueError, TypeError, KeyError):
                continue
            assert s.agg_search(q, tree) == want, (seed, q, tree)
            done += 1
        assert done >= 6


def test_facet_bytes_on_device():
    """Facet hierarchies and bytes fields on the live backend."""
    from tantivy_aggregations_tpu import facet_agg
    from test_facet_bytes import bytes_index, facet_index
    fix = facet_index()
    for a in (facet_agg("cat"), facet_agg("cat", "/books"),
              facet_agg("cat", "/electronics", size=2)):
        got = fix.searcher().agg_search(MatchAllQuery(), {"f": a})
        assert got == fix.oracle_searcher().agg_search(MatchAllQuery(),
                                                       {"f": a})
    bix = bytes_index()
    aggs = {"t": terms_agg("tag", size=5), "n": count_agg()}
    got = bix.searcher().agg_search(MatchAllQuery(), aggs)
    assert got == bix.oracle_searcher().agg_search(MatchAllQuery(), aggs)


def test_cube_msearch_dedup_on_device(idx):
    """Value-domain cube through the msearch batch path with request
    dedup ON and OFF: the [B, P] packed-param int8 dot and the dedup
    regrouping both lower on the live backend."""
    import dataclasses
    s = idx.searcher()
    o = idx.oracle_searcher()
    aggs = {"n": count_agg(), "s": sum_agg("amount"),
            "lo": min_agg("price")}
    prog = s._program_for(TermQuery("status", "a"), aggs)
    assert any(isinstance(pp, dict) and pp.get("cube") is not None
               for pp in prog.plan.values()), "chain did not cube"
    reqs = [(TermQuery("status", c), aggs) for c in "abcab"] * 3
    want = [o.agg_search(q, a) for q, a in reqs]
    assert s.agg_search_batch(reqs) == want          # dedup ON (default)
    s.config = dataclasses.replace(s.config, msearch_dedup=False)
    try:
        assert s.agg_search_batch(reqs) == want      # raw compute path
    finally:
        s.config = dataclasses.replace(s.config, msearch_dedup=True)


def test_replicated_round_robin_on_device(idx):
    """ReplicatedSearcher on one device (1 replica = a 1-shard mesh):
    the shard_map program + round-robin batch split serve bit-identically."""
    from tantivy_aggregations_tpu import ReplicatedSearcher
    rs = ReplicatedSearcher(idx, replicas=1)
    o = idx.oracle_searcher()
    aggs = {"n": count_agg(), "s": sum_agg("amount")}
    for q in (MatchAllQuery(), TermQuery("status", "a")):
        assert rs.agg_search(q, aggs) == o.agg_search(q, aggs)
    reqs = [(TermQuery("status", c), aggs) for c in "abcba"]
    assert rs.agg_search_batch(reqs) == [o.agg_search(q, a)
                                         for q, a in reqs]


def test_wide_multi_on_device():
    """Wide (hi, lo) multi-valued planes: term/range masks and percentiles
    over a multi u64 field whose span exceeds the narrow int32 domain."""
    schema = (SchemaBuilder().add_u64_field("q")
              .add_u64_field("big", cardinality=Cardinality.MULTI).build())
    wix = Index.create_in_ram(schema)
    w = wix.writer()
    rng = np.random.default_rng(5)
    for i in range(2000):
        w.add_document({"q": int(rng.integers(0, 100)),
                        "big": [int(x) for x in
                                rng.integers(0, 2**40,
                                             int(rng.integers(0, 3)))]})
    w.commit()
    col = wix.searcher()._get_device_index().column("big")
    assert col.has_multi_planes_wide
    for q, aggs in [
        (TermQuery("big", 7), {"n": count_agg()}),
        (RangeQuery("big", lower=2**38, upper=2**39),
         {"n": count_agg(), "s": sum_agg("q")}),
        (MatchAllQuery(), {"p": percentiles_agg("big")}),
    ]:
        got = wix.searcher().agg_search(q, aggs)
        assert got == wix.oracle_searcher().agg_search(q, aggs)


def test_host_fallback_shapes_on_device(idx):
    """Shapes the planner routes to the exact host fallback still answer
    bit-identically alongside compiled programs (never-raise contract)."""
    aggs = {"t": terms_agg("tags", size=5, sub_aggs={
        "t2": terms_agg("counts", size=5, sub_aggs={
            "t3": terms_agg("status", size=3)})})}
    run(idx, TermQuery("status", "a"), aggs)


def test_wslot_percentiles_on_device(idx):
    """Occurrence-weighted percentiles under a MULTI-VALUED terms parent
    (wslots): K composite slot planes + weighted-window selection on the
    live backend."""
    aggs = {"t": terms_agg("tags", size=12, sub_aggs={
        "p": percentiles_agg("price", (25, 50, 75)),
        "n": count_agg()})}
    prog = idx.searcher()._program_for(MatchAllQuery(), aggs)
    assert hasattr(prog, "plan") \
        and prog.plan[("a", "t", "p")].get("wslots"), "not on wslots"
    run(idx, MatchAllQuery(), aggs)
    run(idx, TermQuery("status", "a"), aggs)

