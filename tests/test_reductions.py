"""Unit exactness tests for ops/reductions.py primitives — especially the
triangular-matmul prefix scan (mxu_cumsum), whose correctness argument is
a piece-decomposition proof (7-bit pieces stay exact through a
bf16 x bf16 -> f32 product); these pin the extremes of that proof."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tantivy_aggregations_tpu.ops import reductions as R


@pytest.mark.parametrize("shape,maxv", [
    ((5000,), 32),                    # counts-like, 1-D
    ((4, 5000), 32),                  # batched counts
    ((3, 7001), 32 << 18),            # signed sums-like, non-divisible len
    ((2, 2048), 32 << 13),            # exactly one chunk
    ((1,), 5),                        # single element
    ((2, 2049), 32 << 18),            # chunk + 1
])
def test_mxu_cumsum_exact(shape, maxv):
    rng = np.random.default_rng(hash(shape) % 2**32)
    lo = 0 if maxv <= 32 else -maxv
    x = rng.integers(lo, maxv + 1, shape).astype(np.int32)
    if x.size >= 10:
        x.reshape(-1)[:5] = maxv       # pin the extremes
        x.reshape(-1)[5:10] = lo
    with jax.enable_x64(True):
        got = np.asarray(jax.jit(
            lambda a: R.mxu_cumsum(a, maxv))(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.cumsum(x.astype(np.int64),
                                                 axis=-1))


def test_prefix_diff_mxu_matches_reference():
    rng = np.random.default_rng(7)
    Rn = 32 * 4096
    plane = rng.integers(-(2**26), 2**26, Rn).astype(np.int32)
    mask = jnp.asarray(rng.random(Rn) < 0.7)
    bounds = np.sort(rng.choice(Rn // 32 + 1, 50,
                                replace=False)).astype(np.int32)
    with jax.enable_x64(True):
        ref_s = R.prefix_diff(R.block32_sums(jnp.asarray(plane), mask),
                              jnp.asarray(bounds))
        got_s = R.prefix_diff_sums(jnp.asarray(plane), mask,
                                   jnp.asarray(bounds))
        ref_c = R.prefix_diff(R.block32_counts(mask), jnp.asarray(bounds))
        got_c = R.prefix_diff_counts(mask, jnp.asarray(bounds))
    np.testing.assert_array_equal(np.asarray(got_s), np.asarray(ref_s))
    np.testing.assert_array_equal(np.asarray(got_c), np.asarray(ref_c))


def test_mxu_cumsum_under_vmap():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 129, (6, 3000)).astype(np.int32)
    with jax.enable_x64(True):
        got = np.asarray(jax.jit(jax.vmap(
            lambda a: R.mxu_cumsum(a, 128)))(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.cumsum(x.astype(np.int64),
                                                 axis=-1))


def test_masked_minmax_wide_matches_i64():
    rng = np.random.default_rng(5)
    n = 4096
    hi = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    lo = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    with jax.enable_x64(True):
        rm = R.wide_recon(jnp.asarray(hi), jnp.asarray(lo))
        for frac in (0.5, 0.001, 0.0):  # incl. the EMPTY mask sentinel
            mask = jnp.asarray(rng.random(n) < frac)
            assert int(R.masked_min_wide(jnp.asarray(hi), jnp.asarray(lo),
                                         mask)) == int(R.masked_min_i64(
                                             rm, mask))
            assert int(R.masked_max_wide(jnp.asarray(hi), jnp.asarray(lo),
                                         mask)) == int(R.masked_max_i64(
                                             rm, mask))


@pytest.mark.parametrize("rows", [32768, 3 * 131072, 2048])
def test_dense_mxu_matches_onehot(rows):
    """dense_bucket_{counts,sum}_mxu == the one-hot forms bit-for-bit:
    full-range signed int32 payloads, invalid (-1) ids, single + vmapped.
    rows=2048 exercises the no-clean-chunk fallback (not a 4096 multiple)."""
    rng = np.random.default_rng(rows)
    nb = 12
    bid = jnp.asarray(rng.integers(-1, nb, rows).astype(np.int32))
    plane = jnp.asarray(
        rng.integers(-(2**31) + 1, 2**31 - 1, rows).astype(np.int32))
    with jax.enable_x64(True):
        m1 = jnp.asarray(rng.random(rows) < 0.6)
        assert (np.asarray(R.dense_bucket_counts_mxu(bid, m1, nb))
                == np.asarray(R.dense_bucket_counts(bid, m1, nb))).all()
        assert (np.asarray(R.dense_bucket_sum_mxu(bid, m1, plane, nb))
                == np.asarray(R.dense_bucket_sum(bid, m1, plane, nb))).all()
        vm = jnp.asarray(rng.random((4, rows)) < 0.5)
        got_c = jax.vmap(lambda m: R.dense_bucket_counts_mxu(bid, m, nb))(vm)
        ref_c = jax.vmap(lambda m: R.dense_bucket_counts(bid, m, nb))(vm)
        got_s = jax.vmap(
            lambda m: R.dense_bucket_sum_mxu(bid, m, plane, nb))(vm)
        ref_s = jax.vmap(lambda m: R.dense_bucket_sum(bid, m, plane, nb))(vm)
        assert (np.asarray(got_c) == np.asarray(ref_c)).all()
        assert (np.asarray(got_s) == np.asarray(ref_s)).all()


@pytest.mark.parametrize("bound", [
    (0, 0), (0, 99), (0, 127), (0, 128), (0, 9999), (0, 2**14 - 1),
    (0, 2**26 - 1), (-(2**26 - 1), 2**26 - 1), (-5, 5), (0, 2**31 - 2),
])
def test_bounded_piece_decomposition_exact(bound):
    """Span-derived piece counts stay bit-exact at the bound edges: values
    drawn ON the bounds (and across the whole range) through both bounded
    int8 matmul entry points == the unbounded/one-hot references."""
    rng = np.random.default_rng(abs(bound[1]) + 1)
    rows, nb = 32768, 7
    lo, hi = bound
    vals = rng.integers(lo, hi + 1, rows).astype(np.int32)
    vals[:8] = lo          # force edge values through the top piece
    vals[8:16] = hi
    plane = jnp.asarray(vals)
    bid = jnp.asarray(rng.integers(-1, nb, rows).astype(np.int32))
    np_ = R.npieces_for_bound(bound)
    assert 1 <= np_ <= 5
    # the decomposition identity itself, on the numpy side
    recon = sum((((vals.astype(np.int64) >> (7 * i)) & 127) << (7 * i))
                for i in range(np_ - 1))
    recon = recon + ((vals.astype(np.int64) >> (7 * (np_ - 1)))
                     << (7 * (np_ - 1)))
    assert (recon == vals).all()
    with jax.enable_x64(True):
        m1 = jnp.asarray(rng.random(rows) < 0.5)
        got = np.asarray(R.dense_bucket_sum_mxu(bid, m1, plane, nb,
                                                bound=bound))
        ref = np.asarray(R.dense_bucket_sum(bid, m1, plane, nb))
        assert (got == ref).all()
        zero = jnp.zeros(rows, jnp.int32)
        gotp = np.asarray(R.masked_sum_planes_mxu(
            m1, [plane, zero, plane], bounds=[bound, (0, 0), None]))
        refp = np.asarray(jnp.stack(
            [R.ts_sum_plane(p, m1) for p in (plane, zero, plane)]))
        assert (gotp == refp).all()


def test_masked_sum_planes_mxu_matches_ts():
    rng = np.random.default_rng(77)
    for rows in (32768, 2 * 131072, 2048):  # 2048: fallback path
        planes = [jnp.asarray(rng.integers(-(2**31) + 1, 2**31 - 1,
                                           rows).astype(np.int32))
                  for _ in range(3)]
        with jax.enable_x64(True):
            m1 = jnp.asarray(rng.random(rows) < 0.5)
            got = np.asarray(R.masked_sum_planes_mxu(m1, planes))
            ref = np.asarray(jnp.stack([R.ts_sum_plane(p, m1)
                                        for p in planes]))
            assert (got == ref).all(), rows
            vm = jnp.asarray(rng.random((4, rows)) < 0.5)
            gotb = np.asarray(jax.vmap(
                lambda m: R.masked_sum_planes_mxu(m, planes))(vm))
            refb = np.asarray(jax.vmap(
                lambda m: jnp.stack([R.ts_sum_plane(p, m)
                                     for p in planes]))(vm))
            assert (gotb == refb).all(), rows


def test_recombine_under_jit_exact():
    """Regression (round 3): this jax build (0.9.0) MISCOMPILES scalar
    shift-accumulate chains ``out = out + (x[i] << (7 * i))`` under jit
    when the chain has >= 5 shifted terms — XLA drops terms
    data-dependently (seen on the CPU backend; eager mode and
    numpy agree; ~3% of random cases). _recombine and cube.recombine are
    therefore written as vectorized shift-sums; this pins them under jit
    exactly as the engine's programs run them."""
    from tantivy_aggregations_tpu.ops import cube

    @jax.jit
    def f(a):
        with jax.enable_x64(True):
            return R._recombine(a)

    rng = np.random.default_rng(5)
    for trial in range(40):
        np_ = int(rng.integers(2, 8))
        m = int(rng.integers(1, 6))
        acc = rng.integers(-2**40, 2**40, size=(np_, m))
        ref = np.sum(acc << (7 * np.arange(np_)[:, None]), axis=0)
        with jax.enable_x64(True):
            got = np.asarray(f(jnp.asarray(acc)))
        assert np.array_equal(got, ref), (trial, np_)

    # cube piece pipeline end to end under jit: pack -> dot -> recombine
    for trial in range(20):
        m = int(rng.integers(1, 5))
        D = int(rng.integers(2, 40))
        vals = rng.integers(-2**45, 2**45, size=(m, D))
        pieces, layout = cube.pack_groups([("g", vals)])
        ind = (rng.random(D) < 0.5).astype(np.int8)
        ref = (vals * ind[None, :].astype(np.int64)).sum(axis=1)

        @jax.jit
        def g(i8, p):
            with jax.enable_x64(True):
                return cube.recombine(cube.cube_dots(i8, p), layout)["g"]

        got = np.atleast_1d(np.asarray(g(jnp.asarray(ind),
                                         jnp.asarray(pieces))))
        assert np.array_equal(got, ref), trial


def test_masked_sum_planes_mxu_under_jit():
    """Full-range (5-piece) int8 matmul sums under jit — the engine's actual
    compilation mode (the eager variant above misses the jit-only XLA
    shift-chain bug)."""
    rng = np.random.default_rng(11)
    rows = 32768
    planes = [jnp.asarray(rng.integers(-(2**31) + 1, 2**31 - 1,
                                       rows).astype(np.int32))
              for _ in range(3)]

    @jax.jit
    def f(m):
        with jax.enable_x64(True):
            return R.masked_sum_planes_mxu(m, planes)

    @jax.jit
    def ref_f(m):
        with jax.enable_x64(True):
            return jnp.stack([R.ts_sum_plane(p, m) for p in planes])

    for seed in range(5):
        m1 = jnp.asarray(np.random.default_rng(seed).random(rows) < 0.5)
        assert (np.asarray(f(m1)) == np.asarray(ref_f(m1))).all(), seed
