"""slot_rank per-slot block counts: the plain XLA form (chain mask &
composite slot -> per-(32-row block, slot) counts -> int32 cumsum) that
replaced the removed chain_slot_counts kernel, and the slot_rank
nested-percentile integration in aggs/compile.py, bit-parity with the
oracle. Same shapes, params and oracle checks as the kernel's tests had;
use_cube=False keeps the counts off the value-domain cube (test_cube.py
covers scube)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tantivy_aggregations_tpu as tat
from tantivy_aggregations_tpu.engine_config import EngineConfig
from tantivy_aggregations_tpu.ops import reductions as R

from fixtures import random_index


def test_chain_slot_counts_kernel_unit():
    rows = 32768
    ns = 5
    rng = np.random.default_rng(11)
    w = rng.integers(-5000, 5000, rows).astype(np.int32)
    av = (rng.random(rows) < 0.9).astype(np.int8)
    slot = rng.integers(-1, ns, rows).astype(np.int32)
    wd, avd, sd = jnp.asarray(w), jnp.asarray(av), jnp.asarray(slot)

    def counts(pv):
        m = (wd >= pv[0]) & (wd <= pv[1]) & (avd > 0)
        return R.slot_block32_counts(sd, m, ns)

    def ref_counts(qlo, qhi):
        m = (w >= qlo) & (w <= qhi) & (av > 0)
        return np.stack([(m & (slot == s)).reshape(-1, 32).sum(1)
                         for s in range(ns)], axis=1)

    out = jax.jit(counts)(jnp.asarray([-200, 2500], jnp.int32))
    np.testing.assert_array_equal(np.asarray(out), ref_counts(-200, 2500))

    # vmapped over an msearch batch of params, planes unbatched
    pmat = jnp.asarray([[-200, 2500], [0, 10], [4999, 4999], [7, 3]],
                       jnp.int32)
    with jax.enable_x64(True):
        outs = jax.jit(jax.vmap(counts))(pmat)
    for b in range(4):
        np.testing.assert_array_equal(
            np.asarray(outs[b]), ref_counts(int(pmat[b, 0]),
                                            int(pmat[b, 1])))


@pytest.fixture(scope="module")
def sidx():
    # small cat cardinality: a composite slot space within the dense budget
    return random_index(seed=33, n_docs=30_000, card=6)


@pytest.fixture(scope="module")
def ssearch(sidx):
    # use_cube=False: this module pins the row-pass slot counts, which the
    # value-domain cube supersedes on cube-able chains (ops/cube.py scube)
    cfg = EngineConfig(use_cube=False)
    return sidx.searcher(config=cfg), sidx.oracle_searcher()


def _plans_slot_counts(searcher, query, aggs, path):
    prog = searcher._program_for(query, aggs)
    p = prog.plan[path]
    assert p["pmode"] == "slot_rank", p
    assert p.get("scube") is None and not p.get("wslots"), \
        f"slot_rank node did not take the row-pass slot counts: {p}"


QUERIES = [
    tat.MatchAllQuery(),
    tat.RangeQuery("qty", lower=100, upper=800),
    tat.TermQuery("tags", "t2"),          # multi-valued chain field
    tat.RangeQuery("qty", lower=10**7),   # empty result
]


@pytest.mark.parametrize("q", QUERIES)
def test_slot_rank_terms_parity(ssearch, q):
    s, o = ssearch
    aggs = {"t": tat.terms_agg("cat", size=6,
                               sub_aggs={"p": tat.percentiles_agg(
                                   "qty", (25.0, 50.0, 75.0))})}
    _plans_slot_counts(s, q, aggs, ("a", "t", "p"))
    assert s.agg_search(q, aggs) == o.agg_search(q, aggs)


@pytest.mark.parametrize("q", QUERIES[:3])
def test_slot_rank_histogram_parity(ssearch, q):
    s, o = ssearch
    aggs = {"h": tat.histogram_agg("qty", interval=200,
                                   sub_aggs={"p": tat.percentiles_agg(
                                       "delta")})}
    _plans_slot_counts(s, q, aggs, ("a", "h", "p"))
    assert s.agg_search(q, aggs) == o.agg_search(q, aggs)


def test_slot_rank_pallas_msearch_batch(ssearch):
    """The batched (vmapped msearch) lane: per-query results identical to
    the oracle."""
    s, o = ssearch
    aggs = {"t": tat.terms_agg("cat", size=4,
                               sub_aggs={"p": tat.percentiles_agg(
                                   "qty", (25.0, 50.0, 75.0))})}
    reqs = [(tat.RangeQuery("qty", lower=j * 11, upper=950 - j * 7), aggs)
            for j in range(7)]
    outs = s.agg_search_batch(reqs)
    for (q, a), out in zip(reqs, outs):
        assert out == o.agg_search(q, a)


def test_slot_rank_noninteger_percents_skip_kernel(ssearch):
    """Non-integer percents resolve ranks host-side in a second phase over
    the per-slot prefix intermediates."""
    s, o = ssearch
    q = tat.RangeQuery("qty", lower=50, upper=900)
    aggs = {"h": tat.histogram_agg("qty", interval=250,
                                   sub_aggs={"p": tat.percentiles_agg(
                                       "delta", (33.3, 66.6))})}
    prog = s._program_for(q, aggs)
    p = prog.plan[("a", "h", "p")]
    assert p["pmode"] == "slot_rank" and not p["int_percents"], p
    assert s.agg_search(q, aggs) == o.agg_search(q, aggs)
