#!/usr/bin/env python
"""Smoke test of the engine on one NVIDIA GPU at the benchmark's full size.

    python chip_smoke.py            # one GPU, 10M-doc benchmark index
    python chip_smoke.py --four     # only the sharded path, four GPUs

One process drives the card; the NumPy oracle runs in CPU-only worker
processes (JAX_PLATFORMS=cpu) that never open it. Phases, all on the
benchmark index (models/flagship.py: 10M docs, 4 segments, seed 42, built
once under .bench_cache/ exactly as bench.py builds it):

1. configs: every bench config c1-c10 through Searcher.agg_search with the
   canonical params (`==` the oracle), then one msearch group of 128 varied
   requests (`==` the single-query path; 3 distinct ones `==` the oracle).
   Prints first-call seconds, the plan modes chosen and the compiled
   program's memory_analysis().
2. formulations: mxu_cumsum against jnp.cumsum at the c4 layout's
   [128, R/32] shape, the widest bench cube_dots site and one
   _dense_mxu_scan site (11.8M rows x 128 queries) against int32 einsums,
   bit for bit. Times are taken after warm-up with a device_get of a
   slice inside each timed loop. (The repository has no hand-written
   kernel: PERF.md says why the last one was removed.)

`--four` runs only the sharded dry run of __graft_entry__ over a 1-D mesh
of four GPUs (c1-c5 sharded, the sharded fast-path plan checks) and a
4-replica ReplicatedSearcher msearch group, all `==` the oracle.

Any failed check exits non-zero. The last stdout line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU the script exits non-zero before any work; `--docs N` on the
CPU runs the phases at a small size as a rehearsal and still exits
non-zero, with no result line.
"""

import argparse
import json
import os
import sys
import time

_ORACLE = {}


def _oracle_init():
    # workers must never open the card: fix the platform before any JAX
    # import in this process
    os.environ["JAX_PLATFORMS"] = "cpu"


def _oracle_eval(path, query, aggs):
    """Worker: oracle result of (query, aggs) on the on-disk index."""
    if path not in _ORACLE:
        from tantivy_aggregations_tpu import Index
        _ORACLE[path] = Index.open(path).oracle_searcher()
    return _ORACLE[path].agg_search(query, aggs)


class PoolOracle:
    """Oracle answers computed ahead of time in CPU worker processes;
    agg_search() returns the prefetched answer (or computes it in a
    worker when it was not prefetched)."""

    def __init__(self, pool, path):
        self.pool, self.path, self.futs = pool, path, {}

    def prefetch(self, requests):
        for q, a in requests:
            k = repr((q, a))
            if k not in self.futs:
                self.futs[k] = self.pool.apply_async(_oracle_eval,
                                                     (self.path, q, a))

    def agg_search(self, query, aggs):
        self.prefetch([(query, aggs)])
        return self.futs[repr((query, aggs))].get()


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def timed(fn, args, n=10):
    """(seconds per call, last output): warm-up call first, then n calls,
    each ending in a device_get of a one-element slice of its output."""
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
        jax.device_get(jax.tree.leaves(out)[0].reshape(-1)[:1])
    return (time.perf_counter() - t0) / n, out


def plan_modes(prog) -> str:
    tags = []
    for path, p in prog.plan.items():
        if not (isinstance(p, dict) and path and path[0] == "a"):
            continue
        t = [p.get("kind", "?")]
        t += [f"{k}={p[k]}" for k in ("mode", "pmode", "hmode") if p.get(k)]
        t += [k for k in ("cube", "pcube", "scube", "member_op")
              if p.get(k) is not None]
        t += [k for k in ("mask_gather", "bisect", "slot_bisect", "wslots")
              if p.get(k)]
        tags.append("/".join(path[1:]) + ":" + ",".join(t))
    return " ".join(tags)


def load_all_planes(dindex):
    """Build every column on the host, then copy its planes to the device:
    (host build seconds, copy seconds, bytes copied)."""
    import jax
    t0 = time.perf_counter()
    cols = [dindex.column(entry.name) for entry in dindex.schema.fields]
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    n = 0
    for col in cols:
        arrs = [col.w] if (col.narrow or col.ftype.is_stringy) \
            else [col.hi, col.lo]
        if col.multi:
            arrs += [col.doc_id, col.valid]
        jax.block_until_ready(arrs)
        n += sum(a.size * a.dtype.itemsize for a in arrs)
    return t_host, time.perf_counter() - t0, n


def config_phase(idx, oracle, configs):
    import dataclasses
    from tantivy_aggregations_tpu.models import flagship
    from tantivy_aggregations_tpu.searcher import _HostFallback
    searcher = idx.searcher()
    t0 = time.perf_counter()
    dindex = searcher._get_device_index()
    t_load = time.perf_counter() - t0
    t_host, t_put, nbytes = load_all_planes(dindex)
    log(f"[smoke] device index: segments {t_load:.3f}s, host column builds "
        f"{t_host:.3f}s, column planes to the device {nbytes / 1e6:.1f} MB "
        f"in {t_put:.3f}s")
    for i, name, query, aggs in configs:
        t0 = time.perf_counter()
        got = searcher.agg_search(query, aggs)
        first = time.perf_counter() - t0
        prog = searcher._program_for(query, aggs)
        check(not isinstance(prog, _HostFallback),
              f"c{i} fell to the host path: {getattr(prog, 'reason', '')}")
        ma = prog._fn.lower(*prog.example_inputs()).compile() \
            .memory_analysis()
        log(f"[smoke] c{i} {name}: first call {first:.3f}s; plan "
            f"{plan_modes(prog)}; memory: args "
            f"{ma.argument_size_in_bytes} out {ma.output_size_in_bytes} "
            f"temp {ma.temp_size_in_bytes} code "
            f"{ma.generated_code_size_in_bytes} bytes")
        check(got == oracle.agg_search(query, aggs),
              f"c{i} canonical != oracle")
        reqs = flagship.varied_requests(i, aggs, 128)
        expect, distinct = {}, []
        for q, _ in reqs:
            if repr(q) not in expect:
                expect[repr(q)] = searcher.agg_search(q, aggs)
                distinct.append(q)
        searcher.config = dataclasses.replace(searcher.config,
                                              msearch_dedup=False)
        t0 = time.perf_counter()
        outs = searcher.agg_search_batch(reqs)
        t_group = time.perf_counter() - t0
        searcher.config = dataclasses.replace(searcher.config,
                                              msearch_dedup=True)
        check(all(o == expect[repr(q)] for o, (q, _) in zip(outs, reqs)),
              f"c{i} msearch group != single-query path")
        for q in distinct[:3]:
            check(expect[repr(q)] == oracle.agg_search(q, aggs),
                  f"c{i} varied {q!r} != oracle")
        log(f"[smoke] c{i}: 128-request msearch group == single-query "
            f"path ({len(distinct)} distinct param sets, first group "
            f"{t_group:.3f}s incl. compile), {min(3, len(distinct))} == "
            f"oracle")
    return searcher


def dots_phase(base):
    import jax
    import jax.numpy as jnp
    from tantivy_aggregations_tpu.models import flagship
    from tantivy_aggregations_tpu.ops import cube
    from tantivy_aggregations_tpu.ops import reductions as R

    B = 128
    _, q4, a4 = flagship.judged_configs()[3]
    rows = base._program_for(q4, a4).plan[("a", "t")]["layout"].n_rows
    # -- mxu_cumsum vs jnp.cumsum on [B, R/32] --
    key = jax.random.PRNGKey(42)
    G = rows // 32
    bound = 32 << 18
    x = jax.random.randint(key, (B, G), -bound, bound + 1, jnp.int32)
    with jax.enable_x64(True):
        f_m = jax.jit(lambda v: R.mxu_cumsum(v, bound))
        f_c = jax.jit(lambda v: jnp.cumsum(v.astype(jnp.int64), axis=-1))
        t_m, om = timed(f_m, (x,))
        t_c, oc = timed(f_c, (x,))
        check(bool(jnp.array_equal(om, oc)), "mxu_cumsum != jnp.cumsum")
    log(f"[dots] mxu_cumsum [{B} x {G}] == jnp.cumsum (int64); "
        f"mxu_cumsum {t_m * 1e3:.4f} ms, jnp.cumsum {t_c * 1e3:.4f} ms")

    # -- the widest cube_dots site of the bench configs vs int32 einsum --
    sites = [pr._arrays[k] for pr in (base._program_for(q, a)
                                      for _, _, q, a in configs_of(flagship))
             if hasattr(pr, "_arrays")
             for k in pr._arrays if k.startswith("CUBE#")]
    pieces = max(sites, key=lambda v: v.size)
    Dprod, K = pieces.shape
    ind = jax.random.randint(jax.random.PRNGKey(7), (B, Dprod), 0, 2,
                             jnp.int32).astype(jnp.int8)
    f_d = jax.jit(jax.vmap(cube.cube_dots, in_axes=(0, None)))
    f_e = jax.jit(lambda i, pc: jnp.einsum(
        "bd,dk->bk", i.astype(jnp.int32), pc.astype(jnp.int32)))
    t_d, od = timed(f_d, (ind, pieces))
    t_e, oe = timed(f_e, (ind, pieces))
    check(bool(jnp.array_equal(od, oe)), "cube_dots != int32 einsum")
    log(f"[dots] cube_dots [{B} x {Dprod}] x [{Dprod} x {K}] == int32 "
        f"einsum; int8 {t_d * 1e3:.4f} ms, int32 {t_e * 1e3:.4f} ms")

    # -- one _dense_mxu_scan site (dense bucket counts) vs int32 einsum --
    nb = 30
    bid = jax.random.randint(jax.random.PRNGKey(3), (rows,), 0, nb,
                             jnp.int32)
    masks = jax.random.bernoulli(jax.random.PRNGKey(5), 0.5, (B, rows))
    with jax.enable_x64(True):
        f_s = jax.jit(jax.vmap(lambda m: R.dense_bucket_counts_mxu(
            bid, m, nb)))
        f_r = jax.jit(lambda m: jnp.einsum(
            "br,rk->bk", m.astype(jnp.int32),
            (bid[:, None] == jnp.arange(nb)).astype(jnp.int32)))
        t_s, os_ = timed(f_s, (masks,))
        t_r, or_ = timed(f_r, (masks,))
        check(bool(jnp.array_equal(os_, or_.astype(jnp.int64))),
              "_dense_mxu_scan != int32 einsum")
    log(f"[dots] _dense_mxu_scan counts [{B} x {rows}] x [{rows} x {nb}] "
        f"== int32 einsum; int8 scan {t_s * 1e3:.4f} ms, int32 einsum "
        f"{t_r * 1e3:.4f} ms")


def configs_of(flagship):
    out = [(i, n, q, a) for i, (n, q, a)
           in enumerate(flagship.judged_configs(), start=1)]
    return out + flagship.extra_configs()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the sharded path, on four GPUs")
    ap.add_argument("--docs", type=int, default=None,
                    help="index size for a CPU rehearsal (no result line)")
    args = ap.parse_args()

    import jax
    on_gpu = jax.default_backend() == "gpu"
    if not on_gpu and args.docs is None:
        print(f"no GPU: JAX backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    import bench
    import multiprocessing as mp
    bench.setup_compile_cache()
    log(f"[smoke] jax {jax.__version__}; devices {jax.devices()}; "
        f"device_kind {jax.devices()[0].device_kind!r}")
    if on_gpu:
        log(f"[smoke] card: {bench.gpu_name_power()}")
    n_docs = args.docs or 10_000_000
    t0 = time.perf_counter()
    idx, path = bench.ensure_index(n_docs, 4, seed=42)
    log(f"[smoke] index {n_docs} docs ready in "
        f"{time.perf_counter() - t0:.3f}s")
    ctx = mp.get_context("spawn")
    with ctx.Pool(min(8, os.cpu_count() or 1),
                  initializer=_oracle_init) as pool:
        oracle = PoolOracle(pool, path)
        if args.four:
            import __graft_entry__ as graft
            devices = jax.devices()
            check(len(devices) == 4, f"--four needs 4 devices, have "
                  f"{len(devices)}")
            oracle.prefetch(graft.dryrun_requests(replicas=4))
            t0 = time.perf_counter()
            graft._dryrun_multichip_inproc(devices, idx, oracle=oracle,
                                           replicas=4)
            log(f"[smoke] four-device phase {time.perf_counter() - t0:.3f}s")
        else:
            from tantivy_aggregations_tpu.models import flagship
            configs = configs_of(flagship)
            for i, _, q, a in configs:
                oracle.prefetch([(q, a)])
            for i, _, q, a in configs:
                seen = {repr(q)}
                for qv, _ in flagship.varied_requests(i, a, 128):
                    if repr(qv) not in seen and len(seen) < 4:
                        seen.add(repr(qv))
                        oracle.prefetch([(qv, a)])
            t0 = time.perf_counter()
            base = config_phase(idx, oracle, configs)
            log(f"[smoke] config phase {time.perf_counter() - t0:.3f}s")
            t0 = time.perf_counter()
            dots_phase(base)
            log(f"[smoke] dots phase {time.perf_counter() - t0:.3f}s")
    if not on_gpu:
        print("rehearsal on the CPU passed; no GPU, so no result",
              file=sys.stderr)
        return 3
    log(bench.gpu_name_power())
    print(json.dumps({"ok": True, "device": bench.device_info()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
