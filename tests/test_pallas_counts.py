"""Rank-percentile prefix counts: the plain XLA form (the chain mask in
permuted value-layout space -> per-32-row counts -> int32 cumsum) that
replaced the removed chain_counts kernel, and its rank-percentile integration
in aggs/compile.py, bit-parity with the oracle. Same shapes, params and
oracle checks as the kernel's tests had; use_cube=False keeps the rank
prefix off the value-domain cube (test_cube.py covers pcube)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tantivy_aggregations_tpu as tat
from tantivy_aggregations_tpu.engine_config import EngineConfig
from tantivy_aggregations_tpu.ops import reductions as R

from fixtures import random_index


def test_chain_counts_kernel_unit():
    R_ = 32768 * 2
    rng = np.random.default_rng(0)
    w = rng.integers(0, 1000, R_).astype(np.int32)
    av = (rng.random(R_) < 0.9).astype(np.int8)
    wd, avd = jnp.asarray(w), jnp.asarray(av)

    def counts(pv):
        m = (wd >= pv[0]) & (wd <= pv[1]) & (avd > 0)
        return jnp.cumsum(R.block32_counts(m))

    out = jax.jit(counts)(jnp.asarray([100, 700], jnp.int32))
    ref = ((w >= 100) & (w <= 700) & (av > 0)).reshape(-1, 32).sum(1)
    np.testing.assert_array_equal(np.asarray(out), np.cumsum(ref))

    # vmapped over an msearch batch of params, planes unbatched
    pmat = jnp.asarray([[100, 700], [0, 50], [900, 999], [500, 499]],
                       jnp.int32)
    outs = jax.jit(jax.vmap(counts))(pmat)
    for b in range(4):
        lo, hi = int(pmat[b, 0]), int(pmat[b, 1])
        refb = ((w >= lo) & (w <= hi) & (av > 0)).reshape(-1, 32).sum(1)
        np.testing.assert_array_equal(np.asarray(outs[b]), np.cumsum(refb))


@pytest.fixture(scope="module")
def pidx():
    return random_index(seed=11, n_docs=40_000)


@pytest.fixture(scope="module")
def psearch(pidx):
    # use_cube=False: this module pins the row-pass rank prefix, which the
    # value-domain cube supersedes on cube-able chains (ops/cube.py).
    return (pidx.searcher(config=EngineConfig(use_cube=False)),
            pidx.oracle_searcher())


CASES = [
    (tat.MatchAllQuery(), "price", (1, 25, 50, 75, 99)),
    (tat.RangeQuery("qty", 10, 900000), "price", (5, 50, 95)),
    (tat.RangeQuery("qty", 10, 900000), "qty", (2.5, 50.0, 97.5)),
    (tat.TermQuery("cat", "c3"), "delta", (50,)),
    (tat.TermQuery("cat", "zzz-missing"), "price", (50,)),  # m == 0
    (tat.BooleanQuery(must=[tat.RangeQuery("qty", 100, 900000)],
                      must_not=[tat.TermQuery("cat", "c1")]),
     "ts", (25, 50, 75)),
    (tat.BooleanQuery(should=[tat.TermQuery("cat", "c1"),
                              tat.TermQuery("cat", "c2")]),
     "price", (50, 99.9)),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_rank_percentiles_via_kernel(psearch, case):
    s, o = psearch
    q, field, pc = CASES[case]
    tree = {"p": tat.percentiles_agg(field, percents=list(pc))}
    prog = s._program_for(q, tree)
    p = prog.plan[("a", "p")]
    assert p["pmode"] == "rank" and p.get("pcube") is None \
        and not p.get("mask_gather"), (q, field, p)
    assert s.agg_search(q, tree) == o.agg_search(q, tree)


def test_cube_supersedes_kernel_on_cubeable_chains(pidx):
    """With the default config (use_cube=True), integer-percent rank
    paths over cube-able chains plan the block-histogram cube (pcube) and
    the row-pass prefix serves the rest — both bit-identical."""
    s = pidx.searcher()
    o = pidx.oracle_searcher()
    for case, want_cube in [(1, True), (2, False), (3, True), (0, False)]:
        q, field, pc = CASES[case]
        tree = {"p": tat.percentiles_agg(field, percents=list(pc))}
        prog = s._program_for(q, tree)
        planned_cube = prog.plan[("a", "p")].get("pcube") is not None
        assert planned_cube == want_cube, (case, q, field)
        assert s.agg_search(q, tree) == o.agg_search(q, tree)


def test_rank_percentiles_kernel_msearch(psearch):
    s, o = psearch
    for pc in ([5, 50, 95], [2.5, 50.0, 97.5]):  # in-trace + lazy phase-2
        reqs = [(tat.RangeQuery("qty", 10 + k, 900000 - k),
                 {"p": tat.percentiles_agg("price", percents=pc)})
                for k in range(6)]
        outs = s.agg_search_batch(reqs)
        for (q, t), rd in zip(reqs, outs):
            assert rd == o.agg_search(q, t)


def test_rank_percentiles_kernel_msearch_matchall(psearch):
    # empty param chain: the mask is unbatched under the msearch vmap
    s, o = psearch
    for pc in ([5, 50, 95], [2.5, 50.0, 97.5]):
        reqs = [(tat.MatchAllQuery(),
                 {"p": tat.percentiles_agg("price", percents=pc)})] * 4
        outs = s.agg_search_batch(reqs)
        for (q, t), rd in zip(reqs, outs):
            assert rd == o.agg_search(q, t)
