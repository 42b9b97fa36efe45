"""Member block operands (round 4, VERDICT r3 weak #4 / bench c7): a
prefix-mode bucket agg whose ENTIRE query chain is one TermQuery on a
dense multi-valued field answers from ONE dynamic-slice row of a
precomputed [Df, W] per-(value, 32-block) count/payload-sum operand —
no per-query row pass at all. Exactness: block counts <= 32 fit one int8
digit; payload block sums < 2^31 are split into 7-bit int8 pieces and
recombined with a vectorized shift-sum (the jit-safe form, see
ROADMAP.md); the slice is an exact regrouping of the same integer
addends, so results stay bit-identical to the NumPy oracle.
[SURVEY.md §2.1 C10/C5 exactness contract; §6 bytes-scanned axis]"""

import numpy as np

from tantivy_aggregations_tpu import (
    BooleanQuery,
    Index,
    MatchAllQuery,
    RangeQuery,
    SchemaBuilder,
    TermQuery,
    avg_agg,
    count_agg,
    histogram_agg,
    sum_agg,
    terms_agg,
)
from tantivy_aggregations_tpu.schema import Cardinality

from test_multi_query_fields import check, planeable_index


def _member_plan(idx, q, aggs, path=("a", "t"), mesh=None):
    prog = idx.searcher(mesh=mesh)._program_for(q, aggs)
    return prog.plan[path].get("member_op")


def rich_index(n=2500, seed=11):
    """planeable_index plus a multi keyword field (stringy member ops)
    and an f64 payload (limb sums)."""
    schema = (SchemaBuilder()
              .add_u64_field("amount")
              .add_f64_field("price")
              .add_u64_field("weights", cardinality=Cardinality.MULTI)
              .add_keyword_field("tags", cardinality=Cardinality.MULTI)
              .add_keyword_field("sku")
              .build())
    idx = Index.create_in_ram(schema)
    w = idx.writer()
    rng = np.random.default_rng(seed)
    nv = rng.integers(0, 4, n)
    offs = np.zeros(n + 1, np.uint32)
    np.cumsum(nv, out=offs[1:])
    nt = rng.integers(0, 3, n)
    toffs = np.zeros(n + 1, np.uint32)
    np.cumsum(nt, out=toffs[1:])
    w.add_documents_columnar({
        "amount": rng.integers(0, 1000, n, dtype=np.uint64),
        "price": np.round(rng.lognormal(2.0, 1.0, n), 2),
        "weights": (offs, rng.integers(0, 100, int(offs[-1]),
                                       dtype=np.uint64)),
        "tags": (toffs, np.asarray([f"g{int(i):02d}" for i in
                                    rng.integers(0, 25, int(toffs[-1]))],
                                   object)),
        "sku": np.asarray([f"s{int(i):05d}"
                           for i in rng.integers(0, 600, n)], object),
    }, n)
    w.commit()
    return idx


AGGS = {"t": terms_agg("sku", size=10,
                       sub_aggs={"s": sum_agg("amount"),
                                 "n": count_agg()})}


def test_member_op_planned_for_term_on_multi():
    """The c7 shape plans a member operand; range queries and mixed
    conjunctions (non-matchall residue) do not."""
    idx = planeable_index()
    assert _member_plan(idx, TermQuery("weights", 42), AGGS)
    assert _member_plan(idx, BooleanQuery(must=[TermQuery("weights", 7)]),
                        AGGS)
    # range on the multi field: not a TermQuery leaf -> plane/kernel path
    assert not _member_plan(idx, RangeQuery("weights", lower=10, upper=60),
                            AGGS)
    # conjunction with a non-member leaf: residue chain isn't matchall
    assert not _member_plan(
        idx, BooleanQuery(must=[TermQuery("weights", 7),
                                RangeQuery("amount", lower=100)]), AGGS)
    # sharded programs never plan member ops (per-shard layouts)
    from tantivy_aggregations_tpu.parallel.shard import make_mesh
    assert not _member_plan(idx, TermQuery("weights", 42), AGGS,
                            mesh=make_mesh(4))


def test_member_op_identity_terms():
    """Bit-identity across the value domain: boundary values, a value
    absent from every doc, and an out-of-domain parameter (the invalid-
    param gate zeros the sliced row)."""
    idx = planeable_index()
    for v in (0, 1, 42, 99, 100, 10**9):
        check(idx, TermQuery("weights", v), AGGS)
    check(idx, BooleanQuery(must=[TermQuery("weights", 42)]), AGGS)


def test_member_op_identity_histogram():
    """The histogram plan site (HL: prefix) takes the same lowering once
    the bucket count pushes past the dense one-hot cutover."""
    idx = planeable_index()
    aggs = {"h": histogram_agg("amount", interval=1,
                               sub_aggs={"s": sum_agg("amount")})}
    prog = idx.searcher()._program_for(TermQuery("weights", 42), aggs)
    assert prog.plan[("a", "h")]["mode"] == "prefix"
    assert _member_plan(idx, TermQuery("weights", 42), aggs,
                        path=("a", "h"))
    for v in (0, 42, 77, 12345):
        check(idx, TermQuery("weights", v), aggs)


def test_member_op_payload_kinds():
    """Payload plane sources: direct narrow sum (amount), f64 limb sums
    (price), multi-valued per-doc preaggs with value-count denominators
    (avg over weights itself)."""
    idx = rich_index()
    aggs = {"t": terms_agg("sku", size=8,
                           sub_aggs={"sa": sum_agg("amount"),
                                     "sp": sum_agg("price"),
                                     "aw": avg_agg("weights")})}
    assert _member_plan(idx, TermQuery("weights", 13), aggs)
    for v in (13, 0, 99):
        check(idx, TermQuery("weights", v), aggs)


def test_member_op_stringy_field():
    """TermQuery on a MULTI KEYWORD field: the operand is indexed by term
    ordinal; unknown terms hit the invalid-param zeroing."""
    idx = rich_index()
    assert _member_plan(idx, TermQuery("tags", "g07"), AGGS)
    for t in ("g00", "g07", "g24", "nope"):
        check(idx, TermQuery("tags", t), AGGS)


def test_member_op_msearch_rotation():
    """The serving pattern: one compiled program, rotating member values
    through msearch batches — every request bit-identical."""
    idx = planeable_index()
    s = idx.searcher()
    o = idx.oracle_searcher()
    reqs = [(TermQuery("weights", v), AGGS)
            for v in (42, 7, 42, 99, 0, 10**9, 55)]
    outs = s.agg_search_batch(reqs)
    for (q, a), got in zip(reqs, outs):
        assert got == o.agg_search(q, a), q


def test_member_op_gather_rows_kernel():
    """The member-operand row fetch is a plain lax.dynamic_slice (a
    vmapped msearch group becomes one [B, W] row gather, which the trace
    of bench c7 on the H100 does not show among its top device ops)."""
    idx = planeable_index()
    s = idx.searcher()
    o = idx.oracle_searcher()
    prog = s._program_for(TermQuery("weights", 42), AGGS)
    mo = prog.plan[("a", "t")]["member_op"]
    assert mo and "gr" not in mo, mo
    for v in (42, 0, 99, 10**9):
        assert s.agg_search(TermQuery("weights", v), AGGS) == \
            o.agg_search(TermQuery("weights", v), AGGS)
    reqs = [(TermQuery("weights", v), AGGS) for v in (42, 7, 99, 42)]
    assert s.agg_search_batch(reqs) == [o.agg_search(q, a)
                                        for q, a in reqs]


def test_member_op_with_deletes():
    """Alive masks fold into the precomputed operand (it is built from
    alive&valid rows), so deletes stay exact."""
    idx = rich_index(n=800)
    w = idx.writer()
    w.delete_term("tags", "g03")
    w.commit()
    assert _member_plan(idx, TermQuery("weights", 13), AGGS)
    check(idx, TermQuery("weights", 13), AGGS)
    check(idx, TermQuery("tags", "g07"), AGGS)
