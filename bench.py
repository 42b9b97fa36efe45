#!/usr/bin/env python
"""Benchmark harness: the engine on one NVIDIA GPU vs the single-core C++
baseline on the five judged configs (BASELINE.json) plus five extras,
10M-doc fixed-seed index.

Prints ONE JSON line to stdout:
  {"metric": ..., "value": <geomean qps>, "unit": "qps",
   "vs_baseline": <geomean speedup>, "device": {...}}
All progress/detail goes to stderr. Results of the two engines are asserted
EQUAL (exact arithmetic on both sides) before any number is reported. The
engine must run on a GPU listed in PEAKS; anything else is an error.

Usage: python bench.py [--smoke] [--docs N] [--reps R] [--segments S]
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from fractions import Fraction

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, ".bench_cache")

#: published peaks per device_kind (NVIDIA H100 SXM data sheet: 80 GB HBM3
#: at 3.35 TB/s). A device missing here is an error, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0},
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def setup_compile_cache():
    """JAX's persistent compile cache: JAX_COMPILATION_CACHE_DIR when set
    (JAX reads it itself), else the fixed .bench_cache/jaxcache."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(CACHE, "jaxcache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def gpu_name_power() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip()


def device_info() -> dict:
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


# ---------------------------------------------------------------------------
# index build (cached on disk)
# ---------------------------------------------------------------------------

def ensure_index(n_docs: int, n_segments: int, seed: int = 42):
    from tantivy_aggregations_tpu import Index
    from tantivy_aggregations_tpu.models import flagship
    path = os.path.join(CACHE, f"idx_{n_docs}_{n_segments}_{seed}")
    if os.path.exists(os.path.join(path, "meta.json")):
        log(f"[bench] reusing cached index {path}")
        return Index.open(path), path
    log(f"[bench] building {n_docs}-doc index at {path} ...")
    t0 = time.time()
    idx = flagship.build_bench_index(path, n_docs, seed=seed,
                                     n_segments=n_segments)
    log(f"[bench] built in {time.time()-t0:.1f}s")
    return idx, path


def write_manifest(idx, path: str) -> str:
    """Manifest + terms.txt sidecars for the C++ baseline."""
    mpath = os.path.join(path, "baseline_manifest.txt")
    with open(mpath, "w") as f:
        f.write(f"base {path}\n")
        for seg in idx.segments:
            segdir = f"seg_{seg.id}"
            has_alive = 1 if seg.alive is not None else 0
            f.write(f"segment {segdir} {seg.max_doc} {has_alive}\n")
            for entry in idx.schema.fields:
                fd = seg.fields[entry.name]
                csr = 1 if fd.offsets is not None else 0
                f.write(f"field {entry.name} {entry.type.value} "
                        f"{1 if entry.cardinality.value=='multi' else 0} {csr}\n")
                if fd.terms is not None:
                    tpath = os.path.join(path, segdir,
                                         f"{entry.name}.terms.txt")
                    with open(tpath, "w") as tf:
                        tf.write("\n".join(fd.terms))
    return mpath


def build_baseline() -> str:
    exe = os.path.join(REPO, "baseline_cpp", "engine")
    subprocess.run(["make", "-s", "-C", os.path.join(REPO, "baseline_cpp")],
                   check=True)
    return exe


# ---------------------------------------------------------------------------
# C++ raw fruit -> engine-shaped final fruit (shared exact harvest helpers)
# ---------------------------------------------------------------------------

def _f64(bits: int) -> float:
    from tantivy_aggregations_tpu.utils import mono
    return float(mono.mono_to_f64(np.asarray([bits], dtype=np.int64))[0])


def finalize_cpp(cfg: int, raw: dict) -> dict:
    from tantivy_aggregations_tpu.utils import exact
    if cfg == 1:
        return {"n": {"value": raw["n"]}, "s": {"value": int(raw["s"])}}
    if cfg == 2:
        cnt = raw["cnt"]
        wc, ws = raw["w_cnt"], int(raw["w_sum"])
        return {
            "lo": {"value": None if cnt == 0 else _f64(raw["lo_bits"])},
            "hi": {"value": None if cnt == 0 else _f64(raw["hi_bits"])},
            "avg_w": {"value": None if wc == 0 else float(Fraction(ws) / wc),
                      "sum": ws, "count": wc},
        }
    if cfg == 3:
        return {"h": {"buckets": [
            {"key": k, "doc_count": c, "s": {"value": int(s)}}
            for k, c, s in raw["buckets"]]}}
    if cfg in (4, 6, 7):  # c6 = ordered by sum desc; c7 = multi-field query
        return {"t": {
            "buckets": [{"key": k, "doc_count": c, "s": {"value": int(s)},
                         "n": {"value": c2}}
                        for k, c, s, c2 in raw["buckets"]],
            "sum_other_doc_count": int(raw["other"])}}
    if cfg == 8:  # prefix query + calendar month histogram {sum}
        return {"n": {"value": raw["n"]},
                "h": {"buckets": [
                    {"key": k, "doc_count": c, "s": {"value": int(s)}}
                    for k, c, s in raw["buckets"]]}}
    if cfg == 10:  # termset query + count/sum + histogram (§A.14 surface)
        return {"n": {"value": raw["n"]}, "s": {"value": int(raw["s"])},
                "h": {"buckets": [{"key": k, "doc_count": c}
                                  for k, c in raw["buckets"]]}}
    if cfg == 9:  # terms{percentiles} nested slot_rank selection
        pcts = (25.0, 50.0, 75.0)
        buckets = []
        for key, cnt, ranks in raw["buckets"]:
            values = {}
            for p, (lo_bits, hi_bits) in zip(pcts, ranks):
                if cnt == 0:
                    values[str(p)] = None
                    continue
                lo, hi, frac = exact.percentile_rank(p, cnt)
                values[str(p)] = exact.interpolate(
                    _f64(lo_bits), _f64(hi_bits), frac)
            buckets.append({"key": key, "doc_count": cnt,
                            "p": {"values": values}})
        return {"t": {"buckets": buckets,
                      "sum_other_doc_count": int(raw["other"])}}
    if cfg == 5:
        m = raw["m"]
        pcts = (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0)
        values = {}
        for p, (lo_bits, hi_bits) in zip(pcts, raw["ranks"]):
            if m == 0:
                values[str(p)] = None
                continue
            lo, hi, frac = exact.percentile_rank(p, m)
            values[str(p)] = exact.interpolate(_f64(lo_bits), _f64(hi_bits),
                                               frac)
        return {
            "p": {"values": values},
            "pf": {"doc_count": raw["pf_n"],
                   "n": {"value": raw["pf_n"]},
                   "s": {"value": int(raw["pf_sum"])},
                   "h": {"buckets": [{"key": k, "doc_count": c}
                                     for k, c in raw["pf_hist"]]}},
            "t": {"buckets": [{"key": k, "doc_count": c,
                               "s": {"value": int(s)}}
                              for k, c, s, *_ in raw["st"]["buckets"]],
                  "sum_other_doc_count": int(raw["st"]["other"])},
        }
    raise ValueError(cfg)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="100k docs")
    ap.add_argument("--docs", type=int, default=None)
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument("--segments", type=int, default=4)
    ap.add_argument("--skip-baseline", action="store_true")
    args = ap.parse_args()

    n_docs = args.docs or (100_000 if args.smoke else 10_000_000)
    reps = args.reps or 96          # sequential-latency reps (p50)
    from tantivy_aggregations_tpu.engine_config import EngineConfig
    # sustained-stream length: 6 msearch groups at the serving batch size
    stream_reps = 6 * EngineConfig().max_batch
    cpp_reps = 3

    import jax
    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX backend is "
                         f"{jax.default_backend()!r}")
    dev = device_info()
    if dev["kind"] not in PEAKS:
        raise SystemExit(f"no published peaks for device {dev['kind']!r}")
    peak = PEAKS[dev["kind"]]
    setup_compile_cache()
    from tantivy_aggregations_tpu.models import flagship
    idx, path = ensure_index(n_docs, args.segments)
    log(f"[bench] engine devices: {jax.devices()}")
    log(f"[bench] card: {gpu_name_power()}")

    # --- C++ single-core baseline -----------------------------------------
    cpp_results, cpp_secs = {}, {}
    if not args.skip_baseline:
        exe = build_baseline()
        manifest = write_manifest(idx, path)
        for cfg in range(1, 11):
            t0 = time.time()
            out = subprocess.run([exe, manifest, str(cfg), str(cpp_reps)],
                                 capture_output=True, text=True, check=True)
            j = json.loads(out.stdout)
            cpp_results[cfg] = finalize_cpp(cfg, j["result"])
            cpp_secs[cfg] = j["seconds"]
            log(f"[bench] cpp c{cfg}: best {j['seconds']*1000:.1f}ms "
                f"(wall {time.time()-t0:.1f}s)")

    # --- engine on the GPU ---------------------------------------------------
    searcher = idx.searcher()
    oracle = idx.oracle_searcher()
    # host<->device floor: median round trip of a tiny device->host pull,
    # so the p50 breakdown separates the copy floor from device time
    import jax.numpy as jnp
    tiny = jnp.zeros(8, jnp.int32)
    tiny.block_until_ready()
    rtts = []
    for _ in range(7):
        t0 = time.time()
        np.asarray(jax.device_get(tiny))
        rtts.append(time.time() - t0)
    rtt_ms = statistics.median(rtts) * 1000
    log(f"[bench] null device->host round trip: {rtt_ms:.3f}ms")
    configs = [(i, n, q, a) for i, (n, q, a)
               in enumerate(flagship.judged_configs(), start=1)]
    configs += flagship.extra_configs()  # identity-gated, outside geomean
    dev_p50, dev_qtime, dev_results, roofline = {}, {}, {}, {}
    for i, name, query, aggs in configs:
        t0 = time.time()
        r = searcher.agg_search(query, aggs)  # compile + first run
        log(f"[bench] c{i} first call {time.time()-t0:.3f}s")
        # sequential p50 latency (includes per-call dispatch round-trip)
        times = []
        for _ in range(reps):
            t0 = time.time()
            r = searcher.agg_search(query, aggs)
            times.append(time.time() - t0)
        dev_results[i] = r
        dev_p50[i] = statistics.median(times)
        # phase breakdown of one representative sequential call
        # (EngineConfig is frozen; swap a stats-enabled copy in and out)
        import dataclasses
        plain_cfg = searcher.config
        searcher.config = dataclasses.replace(plain_cfg, collect_stats=True)
        searcher.agg_search(query, aggs)
        st = searcher.last_stats
        searcher.config = plain_cfg
        log(f"[bench] c{i} p50 breakdown: prepare {st.prepare_ms:.3f}ms, "
            f"dispatch {st.dispatch_ms:.3f}ms, execute+copy "
            f"{st.wait_ms:.3f}ms (host<->device round trip "
            f"~{rtt_ms:.3f}ms), harvest {st.harvest_ms:.3f}ms")
        # sustained msearch throughput over VARIED query params: same query
        # SHAPE, rotating parameter values (term values / range bounds), so
        # the measured qps demonstrates the serving pattern — one compiled
        # program, no recompiles, param-only dispatches. Correctness of the
        # varied stream is anchored per distinct param: once against the
        # engine's own single-query path, and (sampled) against the oracle.
        reqs = flagship.varied_requests(i, aggs, stream_reps)
        expect, distinct = {}, {}
        for q, _ in reqs:
            k = repr(q)
            distinct.setdefault(k, q)
            if k not in expect:
                expect[k] = searcher.agg_search(q, aggs)
        # the canonical query is already identity-gated vs the C++ baseline;
        # anchor a sample of the VARIED params against the oracle
        canon = repr(query)
        for q in [q for k, q in distinct.items() if k != canon][:3]:
            if expect[repr(q)] != oracle.agg_search(q, aggs):
                log(f"[bench] ORACLE MISMATCH config {i} query {q!r}")
                raise SystemExit(1)
        # headline stream: msearch dedup OFF, so the geomean measures raw
        # per-request compute throughput (streams repeat param sets; the
        # request-cache dedup would collapse them and flatter the number)
        searcher.config = dataclasses.replace(plain_cfg, msearch_dedup=False)
        searcher.agg_search_batch(reqs[: searcher.config.max_batch * 2])
        t0 = time.time()
        outs = list(searcher.agg_search_stream(iter(reqs), lookahead=6))
        batch_t = (time.time() - t0) / len(reqs)
        assert all(o == expect[repr(q)] for o, (q, _) in zip(outs, reqs))
        dev_qtime[i] = batch_t
        # serving mode (default config): dedup ON — stderr visibility only
        # (warm one pass first: deduped groups submit at smaller pow2 pads,
        # i.e. program shapes the dedup-off stream never compiled)
        searcher.config = plain_cfg
        list(searcher.agg_search_stream(iter(reqs), lookahead=6))
        t0 = time.time()
        outs2 = list(searcher.agg_search_stream(iter(reqs), lookahead=6))
        dedup_t = (time.time() - t0) / len(reqs)
        assert all(o == expect[repr(q)] for o, (q, _) in zip(outs2, reqs))
        log(f"[bench] c{i} ({name}): p50 {dev_p50[i]*1000:.3f}ms, "
            f"stream {batch_t*1000:.4f}ms/q over {len(expect)} distinct "
            f"param sets (serving mode w/ request dedup: "
            f"{dedup_t*1000:.4f}ms/q)")
        # scan accounting: the program's resident row-extent bytes over
        # the measured stream time, beside the card's published HBM
        # bandwidth. Cubes and batch-shared passes read fewer bytes than
        # this bound, so the share can pass 100%: it is not a kernel
        # roofline share
        HBM_GBPS = peak["hbm_gbps"]
        prog = searcher._program_for(query, aggs)
        sb = prog.scan_bytes()
        n_cube = sum(1 for pp in prog.plan.values()
                     if isinstance(pp, dict)
                     and (pp.get("cube") is not None
                          or pp.get("pcube") is not None
                          or pp.get("scube") is not None))
        eff = sb / batch_t / 1e9
        # the bandwidth comparison is only meaningful when the scan bound
        # dominates the fixed per-group dispatch/copy floor: at smoke
        # scale (100k docs) the % column is floor noise, so label it
        small = n_docs < 2_000_000
        log(f"[bench] c{i} scan bound {sb/1e6:.1f} MB/q, "
            f"effective {eff:.0f} GB/s"
            + ("" if small else
               f" = {100*eff/HBM_GBPS:.1f}% of published HBM bandwidth "
               f"({HBM_GBPS:.0f} GB/s)")
            + (" [smoke scale: dispatch floor dominates, % suppressed]"
               if small else "")
            + (f"; {n_cube} cube site(s) bypass the row pass"
               if n_cube else ""))
        roofline[i] = (sb, eff)

    # --- identity gate -----------------------------------------------------
    if cpp_results:
        for cfg in sorted(cpp_results):
            if dev_results[cfg] != cpp_results[cfg]:
                log(f"[bench] MISMATCH config {cfg}!")
                log(f"  engine: {json.dumps(dev_results[cfg])[:2000]}")
                log(f"  cpp: {json.dumps(cpp_results[cfg])[:2000]}")
                raise SystemExit(1)
        log(f"[bench] identity gate: all {len(cpp_results)} configs EQUAL "
            "(engine == cpp)")

    # --- report (geomean over the 5 JUDGED configs; extras on stderr) ------
    for i, name, _, _ in configs:
        if i > 5 and cpp_secs:
            log(f"[bench] extra c{i} ({name}): {1.0/dev_qtime[i]:.1f} qps, "
                f"{cpp_secs[i]/dev_qtime[i]:.1f}x vs cpp")
    dev_qtime = {i: t for i, t in dev_qtime.items() if i <= 5}
    cpp_secs = {i: t for i, t in cpp_secs.items() if i <= 5}
    qps = {i: 1.0 / dev_qtime[i] for i in dev_qtime}
    geo_qps = math.exp(sum(math.log(v) for v in qps.values()) / len(qps))
    if cpp_secs:
        speedups = {i: cpp_secs[i] / dev_qtime[i] for i in cpp_secs}
        geo_speedup = math.exp(
            sum(math.log(v) for v in speedups.values()) / len(speedups))
        for i in sorted(speedups):
            log(f"[bench] c{i}: {qps[i]:.1f} qps, {speedups[i]:.1f}x vs cpp "
                f"(p50 latency {dev_p50[i]*1000:.1f}ms)")
    else:
        geo_speedup = 0.0
    print(json.dumps({
        "metric": f"agg qps geomean (sustained msearch stream), 5 judged configs, {n_docs} "
                  f"docs, identical-results gate vs single-core C++ baseline",
        "value": round(geo_qps, 3),
        "unit": "qps",
        "vs_baseline": round(geo_speedup, 2),
        "device": dev,
    }))


if __name__ == "__main__":
    main()
