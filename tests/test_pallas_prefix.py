"""Prefix-mode bucket totals: the plain XLA form (the chain mask
re-evaluated in permuted layout space -> per-32-row counts and 13-bit-split
payload sums -> cumsums gathered at the 32-unit bucket bounds) that
replaced the chain_blocks kernel, and its terms/histogram integration in
aggs/compile.py, bit-parity with the oracle. Same shapes, params and
oracle checks as the kernel's tests had. PERF.md keeps the kernel's
measurements on the H100 and why it was removed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tantivy_aggregations_tpu as tat
from tantivy_aggregations_tpu.engine_config import EngineConfig
from tantivy_aggregations_tpu.ops import reductions as R

from fixtures import random_index


def test_chain_blocks_kernel_unit():
    rows = 32768
    rng = np.random.default_rng(3)
    w = rng.integers(-5000, 5000, rows).astype(np.int32)
    alive = (rng.random(rows) < 0.95).astype(np.int8)
    lvalid = (rng.random(rows) < 0.95).astype(np.int8)
    av = (alive > 0) & (lvalid > 0)
    pay = rng.integers(-(2**26), 2**26, rows).astype(np.int32)
    # 32-unit bucket bounds over the 1024 blocks (some buckets empty)
    cuts = np.sort(rng.choice(np.arange(1, rows // 32), 40, replace=False))
    bounds32 = np.concatenate([[0], cuts, [rows // 32]]).astype(np.int64)
    wd, ad, ld, pd = (jnp.asarray(x) for x in (w, alive, lvalid, pay))

    def totals(pv):
        m = (wd >= pv[0]) & (wd <= pv[1]) & (ad > 0) & (ld > 0)
        b = jnp.asarray(bounds32)
        return R.prefix_diff_counts(m, b), R.prefix_diff_sums(pd, m, b)

    def ref(qlo, qhi):
        m = (w >= qlo) & (w <= qhi) & av
        c = np.add.reduceat(m.astype(np.int64), bounds32[:-1] * 32)
        s_ = np.add.reduceat(np.where(m, pay.astype(np.int64), 0),
                             bounds32[:-1] * 32)
        return c, s_

    with jax.enable_x64(True):
        counts, sums = jax.jit(totals)(jnp.asarray([-100, 3000], jnp.int32))
    c_ref, s_ref = ref(-100, 3000)
    np.testing.assert_array_equal(np.asarray(counts), c_ref)
    np.testing.assert_array_equal(np.asarray(sums), s_ref)

    # vmapped over an msearch batch of params, planes unbatched
    pmat = jnp.asarray([[-100, 3000], [0, 50], [4900, 4999], [10, 9]],
                       jnp.int32)
    with jax.enable_x64(True):
        outs_c, outs_s = jax.jit(jax.vmap(totals))(pmat)
    for b in range(4):
        c_ref, s_ref = ref(int(pmat[b, 0]), int(pmat[b, 1]))
        np.testing.assert_array_equal(np.asarray(outs_c[b]), c_ref)
        np.testing.assert_array_equal(np.asarray(outs_s[b]), s_ref)


@pytest.fixture(scope="module")
def pidx():
    # cat cardinality exceeds the shrunken dense budget -> prefix mode
    return random_index(seed=21, n_docs=40_000)


@pytest.fixture(scope="module")
def psearch(pidx):
    # member ops off: TermQuery-on-multi chains must exercise the chain
    # re-eval here (the member operand would supersede it — covered in
    # tests/test_member_op.py)
    cfg = EngineConfig(dense_nb=8, use_member_ops=False)
    return pidx.searcher(config=cfg), pidx.oracle_searcher()


def _plans_prefix_reeval(searcher, query, aggs, path):
    prog = searcher._program_for(query, aggs)
    p = prog.plan[path]
    assert p["mode"] == "prefix", p
    assert not p.get("member_op") and not p.get("mask_gather"), \
        f"prefix node did not take the permuted chain re-eval: {p}"


CASES = [
    (tat.MatchAllQuery(),),
    (tat.RangeQuery("qty", lower=30, upper=800),),
    (tat.TermQuery("tags", "t3"),),          # multi-valued chain field
    (tat.RangeQuery("qty", lower=10**7),),   # empty result
    # set-type chain queries (§A.14): run-slot compares in layout space
    (tat.TermSetQuery("tags", ["t1", "t4", "t7"]),),
    (tat.TermSetQuery("qty", [5, 6, 7, 300, 301, 999]),),
    (tat.FuzzyTermQuery("cat", "cat0010", 1),),
    (tat.RegexQuery("cat", "cat00[0-3]."),),
]


@pytest.mark.parametrize("q", [c[0] for c in CASES])
def test_terms_prefix_pallas_parity(psearch, q):
    s, o = psearch
    aggs = {"t": tat.terms_agg("cat", size=7,
                               sub_aggs={"s": tat.sum_agg("price"),
                                         "sq": tat.sum_agg("qty"),
                                         "n": tat.count_agg()})}
    _plans_prefix_reeval(s, q, aggs, ("a", "t"))
    assert s.agg_search(q, aggs) == o.agg_search(q, aggs)


@pytest.mark.parametrize("q", [c[0] for c in CASES[:3]])
def test_histogram_prefix_pallas_parity(psearch, q):
    s, o = psearch
    aggs = {"h": tat.histogram_agg("qty", interval=13,
                                   sub_aggs={"s": tat.sum_agg("delta")})}
    _plans_prefix_reeval(s, q, aggs, ("a", "h"))
    assert s.agg_search(q, aggs) == o.agg_search(q, aggs)


def test_prefix_pallas_multi_payload(psearch):
    """Multi-valued payload field (per-doc preaggs: cnt plane + sum
    planes) through the prefix split sums."""
    s, o = psearch
    q = tat.RangeQuery("qty", lower=5, upper=950)
    aggs = {"t": tat.terms_agg("cat", size=6,
                               sub_aggs={"a": tat.avg_agg("counts"),
                                         "sc": tat.sum_agg("scores")})}
    _plans_prefix_reeval(s, q, aggs, ("a", "t"))
    assert s.agg_search(q, aggs) == o.agg_search(q, aggs)


def test_prefix_pallas_msearch_batch(psearch):
    """The batched (vmapped msearch) lane: per-query results identical
    to the oracle."""
    s, o = psearch
    aggs = {"t": tat.terms_agg("cat", size=5,
                               sub_aggs={"s": tat.sum_agg("price")}),
            "h": tat.histogram_agg("qty", interval=29)}
    reqs = [(tat.RangeQuery("qty", lower=j * 7, upper=900 - j * 3), aggs)
            for j in range(9)]
    outs = s.agg_search_batch(reqs)
    for (q, a), out in zip(reqs, outs):
        assert out == o.agg_search(q, a)
