"""Value-domain cube lowering (ops/cube.py): parameterized queries over
small single-valued domains answer metrics/counts from [Dprod]-cell
pre-aggregates via exact int8 matmuls — no per-query row pass. Every
result must stay bit-identical to the oracle and to the row formulation
(use_cube=False), because the cube is an exact regrouping of the same
integer addends (SURVEY.md §A invariants)."""

import numpy as np
import pytest

from tantivy_aggregations_tpu import (
    Index,
    MatchAllQuery,
    PrefixQuery,
    RangeQuery,
    SchemaBuilder,
    TermQuery,
    avg_agg,
    count_agg,
    filter_agg,
    max_agg,
    min_agg,
    stats_agg,
    sum_agg,
)
from tantivy_aggregations_tpu.engine_config import EngineConfig
from tantivy_aggregations_tpu.query.ir import BooleanQuery, TermSetQuery
from tantivy_aggregations_tpu.schema import Cardinality


def build_index(n=700, seed=3):
    schema = (SchemaBuilder()
              .add_keyword_field("cat")
              .add_keyword_field("opt")      # missing on some docs
              .add_u64_field("qty")
              .add_i64_field("delta")
              .add_f64_field("price")
              .add_u64_field("wide")         # wide single-valued
              .add_u64_field("counts", cardinality=Cardinality.MULTI)
              .build())
    idx = Index.create_in_ram(schema)
    w = idx.writer()
    rng = np.random.default_rng(seed)
    cats = ["a", "b", "c", "d", "e", "f"]
    for i in range(n):
        doc = {"cat": cats[rng.integers(len(cats))],
               "qty": int(rng.integers(0, 40)),
               "delta": int(rng.integers(-25, 25)),
               "price": float(np.round(rng.normal() * 50, 3)),
               "wide": int(rng.integers(0, 2**40)),
               "counts": [int(x)
                          for x in rng.integers(0, 7, rng.integers(0, 4))]}
        if rng.random() < 0.6:
            doc["opt"] = cats[rng.integers(3)]
        w.add_document(doc)
        if i == n // 2:
            w.commit()
    w.commit()
    return idx


AGGS = {
    "n": count_agg(),
    "s": sum_agg("delta"),
    "sw": sum_agg("wide"),
    "st": stats_agg("qty"),
    "pr": stats_agg("price"),
    "wst": stats_agg("wide"),
    "av": avg_agg("counts"),
    "mc": stats_agg("counts"),
    "mn": min_agg("delta"),
    "mx": max_agg("price"),
    "f": filter_agg(RangeQuery("delta", lower=-10, upper=10),
                    {"inner": stats_agg("price"), "c2": count_agg()}),
}

QUERIES = [
    TermQuery("cat", "a"),
    TermQuery("cat", "nope"),              # missing term
    TermQuery("opt", "b"),                 # field missing on some docs
    RangeQuery("qty", lower=5, upper=30),
    RangeQuery("qty", lower=39, upper=5),  # empty range
    PrefixQuery("cat", "a"),
    TermSetQuery("cat", ("a", "c", "zz")),
    BooleanQuery(must=(TermQuery("cat", "b"),
                       RangeQuery("qty", lower=2, upper=35)),
                 must_not=(RangeQuery("delta", lower=0, upper=5),)),
    BooleanQuery(should=(TermQuery("cat", "a"), TermQuery("opt", "c"))),
]


@pytest.fixture(scope="module")
def idx():
    return build_index()


def n_cube_sites(searcher):
    total = 0
    for prog in searcher._programs.values():
        plan = getattr(prog, "plan", None) or {}
        total += sum(1 for p in plan.values()
                     if isinstance(p, dict) and p.get("cube") is not None)
    return total


def test_cube_bit_identity(idx):
    oracle = idx.oracle_searcher()
    s_on = idx.searcher(config=EngineConfig(use_cube=True))
    s_off = idx.searcher(config=EngineConfig(use_cube=False))
    for q in QUERIES:
        want = oracle.agg_search(q, AGGS)
        assert s_off.agg_search(q, AGGS) == want
        assert s_on.agg_search(q, AGGS) == want
    assert n_cube_sites(s_on) >= 9
    assert n_cube_sites(s_off) == 0


def test_cube_msearch_batch(idx):
    """The vmapped msearch path shares the static [Dprod, K] operand across
    the batch ([B, Dprod] x [Dprod, K])."""
    oracle = idx.oracle_searcher()
    s_on = idx.searcher(config=EngineConfig(use_cube=True))
    reqs = [(TermQuery("cat", c), AGGS) for c in "abcdefab"] + \
        [(RangeQuery("qty", lower=int(lo), upper=int(lo) + 7), AGGS)
         for lo in range(6)]
    got = s_on.agg_search_batch(reqs)
    want = [oracle.agg_search(q, a) for q, a in reqs]
    assert got == want
    assert n_cube_sites(s_on) >= 9


def test_cube_gate_rejects_unsupported(idx):
    """Chains over multi-valued or wide query fields keep the row paths —
    and stay bit-identical there. (Param-less aggs only: a parameterized
    filter_agg under a rejected root still cubes its own sub-chain.)"""
    oracle = idx.oracle_searcher()
    s_on = idx.searcher(config=EngineConfig(use_cube=True))
    aggs = {k: v for k, v in AGGS.items() if k != "f"}
    for q in (RangeQuery("counts", lower=1, upper=4),    # multi chain field
              RangeQuery("wide", lower=0, upper=2**39),  # wide chain field
              MatchAllQuery()):                          # no params
        want = oracle.agg_search(q, aggs)
        assert s_on.agg_search(q, aggs) == want
    assert n_cube_sites(s_on) == 0


def test_cube_filter_chain_under_matchall(idx):
    """A parameterized filter chain cubes even under a match-all root: the
    filter query's params make the chain adaptive."""
    oracle = idx.oracle_searcher()
    s_on = idx.searcher(config=EngineConfig(use_cube=True))
    aggs = {"f": filter_agg(RangeQuery("delta", lower=-10, upper=10),
                            {"inner": stats_agg("price"),
                             "c2": count_agg()})}
    q = MatchAllQuery()
    assert s_on.agg_search(q, aggs) == oracle.agg_search(q, aggs)
    assert n_cube_sites(s_on) == 3


def test_cube_bucket_aggs(idx):
    """Root-level dense bucket aggs (histogram / small-card terms) with
    Count/Sum/Avg subs lower onto per-bucket cube operands — bit-identical
    to the oracle and the row formulation across key orders, f64 limb
    sums, multi-valued avg subs, and missing-keyword buckets."""
    from tantivy_aggregations_tpu import histogram_agg, terms_agg
    oracle = idx.oracle_searcher()
    s_on = idx.searcher(config=EngineConfig(use_cube=True))
    s_off = idx.searcher(config=EngineConfig(use_cube=False))
    aggs = {
        "h": histogram_agg("qty", interval=7,
                           sub_aggs={"s": sum_agg("delta"),
                                     "av": avg_agg("counts"),
                                     "n2": count_agg(),
                                     "pw": sum_agg("price")}),
        "hf": histogram_agg("price", interval=25.0),
        "t": terms_agg("cat", size=3, sub_aggs={"s": sum_agg("qty")}),
        "to": terms_agg("opt", size=2, order=("s", "desc"),
                        sub_aggs={"s": sum_agg("qty")}),
        "ta": terms_agg("cat", size=4, order=("av", "asc"),
                        sub_aggs={"av": avg_agg("counts")}),
        "tw": terms_agg("wide", size=5),
    }
    for q in (TermQuery("cat", "b"),
              RangeQuery("delta", lower=-5, upper=20),
              TermQuery("opt", "a"),
              RangeQuery("qty", lower=30, upper=2)):   # empty match
        want = oracle.agg_search(q, aggs)
        assert s_off.agg_search(q, aggs) == want
        assert s_on.agg_search(q, aggs) == want
    assert n_cube_sites(s_on) >= 6
    assert n_cube_sites(s_off) == 0


def test_cube_bucket_under_filter(idx):
    """A bucket agg under a parameterized filter cubes over the filter's
    chain even when the root query is match-all."""
    from tantivy_aggregations_tpu import histogram_agg
    oracle = idx.oracle_searcher()
    s_on = idx.searcher(config=EngineConfig(use_cube=True))
    aggs = {"f": filter_agg(
        TermQuery("cat", "c"),
        {"h": histogram_agg("qty", interval=5,
                            sub_aggs={"s": sum_agg("delta")})})}
    q = MatchAllQuery()
    assert s_on.agg_search(q, aggs) == oracle.agg_search(q, aggs)
    assert n_cube_sites(s_on) >= 2


def test_cube_bucket_msearch(idx):
    """Bucket cubes ride the vmapped msearch batch (shared static right
    operand)."""
    from tantivy_aggregations_tpu import histogram_agg, terms_agg
    oracle = idx.oracle_searcher()
    s_on = idx.searcher(config=EngineConfig(use_cube=True))
    aggs = {"h": histogram_agg("qty", interval=6,
                               sub_aggs={"s": sum_agg("delta")}),
            "t": terms_agg("cat", size=4,
                           sub_aggs={"n2": count_agg()})}
    reqs = [(TermQuery("cat", c), aggs) for c in "abcdef"] + \
        [(RangeQuery("delta", lower=int(lo), upper=int(lo) + 9), aggs)
         for lo in range(-12, 0, 2)]
    got = s_on.agg_search_batch(reqs)
    want = [oracle.agg_search(q, a) for q, a in reqs]
    assert got == want


def test_cube_percentiles(idx):
    """Flat rank percentiles over a cube-able chain plan the block-cell
    histogram matmul (pcube) and stay bit-identical — incl. multi-valued
    value fields (value-row layouts) and non-integer percents (which keep
    the non-cube paths)."""
    from tantivy_aggregations_tpu import percentiles_agg
    oracle = idx.oracle_searcher()
    s_on = idx.searcher(config=EngineConfig(use_cube=True))
    s_off = idx.searcher(config=EngineConfig(use_cube=False))
    aggs = {"p": percentiles_agg("price"),
            "pq": percentiles_agg("qty", (25.0, 50.0, 75.0)),
            "pm": percentiles_agg("counts"),
            "pn": percentiles_agg("qty", (33.3,))}
    for q in QUERIES:
        want = oracle.agg_search(q, aggs)
        assert s_off.agg_search(q, aggs) == want
        assert s_on.agg_search(q, aggs) == want
    n_pcube = sum(
        1 for prog in s_on._programs.values()
        for p in (getattr(prog, "plan", None) or {}).values()
        if isinstance(p, dict) and p.get("pcube") is not None)
    # p/pq/pm cube under unique query shapes (same-shape queries share a
    # cached program); lower bound only — exact program-cache counts are
    # planner internals, not semantics
    assert n_pcube >= 3


def test_cube_slot_rank_percentiles(idx):
    """Nested (slot_rank) percentiles under bucket ancestors over a
    cube-able chain plan the per-slot block-histogram matmul (scube) and
    stay bit-identical — across terms and histogram ancestors, empty
    slots, and empty matches."""
    from tantivy_aggregations_tpu import histogram_agg, percentiles_agg, \
        terms_agg
    oracle = idx.oracle_searcher()
    s_on = idx.searcher(config=EngineConfig(use_cube=True))
    s_off = idx.searcher(config=EngineConfig(use_cube=False))
    aggs = {
        "t": terms_agg("cat", size=6,
                       sub_aggs={"p": percentiles_agg("price",
                                                      (25.0, 50.0, 75.0))}),
        "h": histogram_agg("qty", interval=10,
                           sub_aggs={"p": percentiles_agg("delta", (50.0,))}),
    }
    for q in (TermQuery("cat", "b"),
              RangeQuery("delta", lower=-5, upper=20),
              TermQuery("opt", "a"),
              RangeQuery("qty", lower=30, upper=2)):   # empty match
        want = oracle.agg_search(q, aggs)
        assert s_off.agg_search(q, aggs) == want
        assert s_on.agg_search(q, aggs) == want
    n_scube = sum(
        1 for prog in s_on._programs.values()
        for p in (getattr(prog, "plan", None) or {}).values()
        if isinstance(p, dict) and p.get("scube") is not None)
    assert n_scube >= 6  # both nested nodes x 3 unique query shapes


def test_cube_under_bucket_aggs_unaffected(idx):
    """in_slot metrics never plan cubes; nested trees stay identical."""
    from tantivy_aggregations_tpu import terms_agg
    oracle = idx.oracle_searcher()
    s_on = idx.searcher(config=EngineConfig(use_cube=True))
    aggs = {"t": terms_agg("cat", size=10,
                           sub_aggs={"st": stats_agg("qty")}),
            "n": count_agg()}
    q = RangeQuery("qty", lower=3, upper=33)
    assert s_on.agg_search(q, aggs) == oracle.agg_search(q, aggs)


def test_cube_sharded_mesh(idx):
    """Sharded meshes cube with PER-SHARD operands (round 5): each shard
    chunk builds its own [Dprod, K] piece stack, shards dot locally, and
    one int32 psum over the dot vector merges exactly — metric, filter,
    and bucket cubes all plan on an 8-device mesh and stay bit-identical.
    Min/max cell planes merge via all-gather min/max. The device-built
    percentile block-histogram cubes (pcube/scube) stay unsharded."""
    from tantivy_aggregations_tpu import histogram_agg, percentiles_agg, \
        terms_agg
    from tantivy_aggregations_tpu.parallel.shard import make_mesh
    oracle = idx.oracle_searcher()
    mesh = make_mesh(8)
    s_on = idx.searcher(mesh=mesh, config=EngineConfig(use_cube=True))
    s_off = idx.searcher(mesh=mesh, config=EngineConfig(use_cube=False))
    aggs = dict(AGGS)
    aggs["h"] = histogram_agg("qty", interval=7,
                              sub_aggs={"s": sum_agg("delta"),
                                        "av": avg_agg("counts")})
    aggs["t"] = terms_agg("cat", size=3, sub_aggs={"s": sum_agg("qty")})
    aggs["p"] = percentiles_agg("price")
    for q in QUERIES:
        want = oracle.agg_search(q, aggs)
        assert s_off.agg_search(q, aggs) == want
        assert s_on.agg_search(q, aggs) == want
    assert n_cube_sites(s_on) >= 9
    assert n_cube_sites(s_off) == 0
    for prog in s_on._programs.values():
        for p in (getattr(prog, "plan", None) or {}).values():
            if isinstance(p, dict):
                assert p.get("pcube") is None and p.get("scube") is None


def test_cube_sharded_msearch(idx):
    """Sharded bucket/metric cubes ride the vmapped msearch batch."""
    from tantivy_aggregations_tpu import histogram_agg, terms_agg
    from tantivy_aggregations_tpu.parallel.shard import make_mesh
    oracle = idx.oracle_searcher()
    s_on = idx.searcher(mesh=make_mesh(8),
                        config=EngineConfig(use_cube=True))
    aggs = {"h": histogram_agg("qty", interval=6,
                               sub_aggs={"s": sum_agg("delta")}),
            "t": terms_agg("cat", size=4, sub_aggs={"n2": count_agg()}),
            "n": count_agg()}
    reqs = [(TermQuery("cat", c), aggs) for c in "abcdef"] + \
        [(RangeQuery("delta", lower=int(lo), upper=int(lo) + 9), aggs)
         for lo in range(-12, 0, 2)]
    got = s_on.agg_search_batch(reqs)
    want = [oracle.agg_search(q, a) for q, a in reqs]
    assert got == want
    assert n_cube_sites(s_on) >= 3


def test_cube_shards_lift_build_rows_bound(monkeypatch):
    """The build_sum exactness bound applies PER BUILD — per shard chunk
    on a mesh (VERDICT r4 #1). On a 40k-doc index (2 pad blocks flat;
    one 32768-row chunk per shard on an 8-mesh), shrinking
    cube.MAX_BUILD_ROWS to one chunk makes the unsharded planner refuse
    to cube (global rows exceed the bound) while the mesh still plans
    per-shard cube sites and stays bit-identical to the oracle — the
    engine's biggest serving lever no longer turns off on indexes large
    enough to need a mesh. The real 2^24 bound behaves identically at
    >=16.7M global rows / 2.1M-row shards (same arithmetic, same code
    path)."""
    from tantivy_aggregations_tpu.ops import cube as cube_mod
    from tantivy_aggregations_tpu.parallel.shard import make_mesh
    schema = (SchemaBuilder().add_keyword_field("cat")
              .add_u64_field("qty").add_i64_field("delta").build())
    big = Index.create_in_ram(schema)
    w = big.writer()
    rng = np.random.default_rng(11)
    n = 40_000
    cats, qty, dl = (rng.integers(0, 6, n), rng.integers(0, 40, n),
                     rng.integers(-25, 25, n))
    for i in range(n):
        w.add_document({"cat": "abcdef"[cats[i]], "qty": int(qty[i]),
                        "delta": int(dl[i])})
    w.commit()
    mesh = make_mesh(8)
    T_flat = int(big.searcher()._get_device_index().T)
    T_mesh = int(big.searcher(mesh=mesh)._get_device_index().T)
    chunk = T_mesh // 8
    assert T_flat > chunk, (T_flat, T_mesh)
    monkeypatch.setattr(cube_mod, "MAX_BUILD_ROWS", chunk)
    oracle = big.oracle_searcher()
    aggs = {"st": stats_agg("qty"), "n": count_agg(),
            "f": filter_agg(TermQuery("cat", "b"),
                            sub_aggs={"s": sum_agg("delta")})}
    q = RangeQuery("qty", lower=4, upper=30)
    s_flat = big.searcher(config=EngineConfig(use_cube=True))
    assert s_flat.agg_search(q, aggs) == oracle.agg_search(q, aggs)
    assert n_cube_sites(s_flat) == 0, \
        "global rows past MAX_BUILD_ROWS must not cube unsharded"
    s_mesh = big.searcher(mesh=mesh, config=EngineConfig(use_cube=True))
    assert s_mesh.agg_search(q, aggs) == oracle.agg_search(q, aggs)
    assert n_cube_sites(s_mesh) >= 3, \
        "per-shard builds must keep cubing past the global bound"


@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 2, 3, 5, 7, 9, 17, 33, 4097])
def test_cube_dots_unaligned_contracting(D):
    """Batched cube dots over contracting sizes that are not a multiple of
    4 (the shapes XLA:GPU got wrong unpadded, bench c2's D=5 among them):
    exact against an int64 host product, and pack_groups builds operands
    whose contracting axis is already DOT_ALIGN-aligned."""
    import jax
    import jax.numpy as jnp
    from tantivy_aggregations_tpu.ops import cube as cube_mod
    rng = np.random.default_rng(D)
    cells = rng.integers(-(2**20), 2**20, D)
    pieces, layout = cube_mod.pack_groups([("s", cells)])
    assert pieces.shape[0] % cube_mod.DOT_ALIGN == 0
    assert not pieces[D:].any()
    ind = (rng.random((8, D)) < 0.5).astype(np.int8)
    dots = jax.jit(jax.vmap(cube_mod.cube_dots, in_axes=(0, None)))(
        jnp.asarray(ind), jnp.asarray(pieces))
    ref = ind.astype(np.int64) @ pieces[:D].astype(np.int64)
    np.testing.assert_array_equal(np.asarray(dots, np.int64), ref)
    with jax.enable_x64(True):
        tot = jax.jit(lambda d: cube_mod.recombine(d, layout)["s"])(dots[0])
    assert int(tot) == int((ind[0].astype(np.int64) * cells).sum())
