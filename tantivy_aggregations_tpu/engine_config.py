"""EngineConfig: the engine's (deliberately small) tuning surface.

The reference has no flag system — everything is typed constructor
arguments (SURVEY.md §5); this engine keeps that posture and exposes only
the hardware-mapping knobs that plan-time mode selection uses."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EngineConfig:
    #: blocked one-hot bucket budget: bucket aggs with a flat slot space up
    #: to this size use compare-reduce; larger use prefix/scatter paths
    dense_nb: int = 256
    #: collect per-query QueryStats on the searcher (last_stats)
    collect_stats: bool = False
    #: msearch group cap: same-shape queries per vmapped dispatch; multiple
    #: groups pipeline (device->host copies overlap later groups' compute).
    #: Each group pays one dispatch and one device->host copy, so larger
    #: groups amortize both; per-query row-axis state is capped separately
    #: (Program.batch_cap)
    max_batch: int = 128
    #: dedup identical requests inside an msearch group (request-cache
    #: analog of Elasticsearch's shard request cache): a compiled program
    #: is a pure function of its extracted params, so equal param sets
    #: compute once and fan the fruits out. Serving wins; benchmarks that
    #: want to measure raw compute throughput should turn it off.
    msearch_dedup: bool = True
    #: dense bucket counts/sums over STATIC bucket-id planes ride chunked
    #: int8 matmuls (ops/reductions.py dense_bucket_*_mxu) instead of
    #: per-query one-hot compare-reduce; exact by 7-bit piece construction
    dense_mxu: bool = True
    #: value-domain cube lowering (ops/cube.py): trees whose parameterized
    #: query chain lives on a small single-valued domain evaluate as exact
    #: domain-indicator matmuls — no per-query row pass. Sharded meshes
    #: build PER-SHARD operands and psum the dot vectors (round 5); only
    #: the device-built block-histogram cubes (pcube/scube) stay unsharded
    use_cube: bool = True
    #: member block operands: prefix-mode bucket aggs gated by ONE
    #: TermQuery on a dense multi-valued field answer from one ~W-byte
    #: dynamic-slice row of a precomputed per-(value, 32-block)
    #: count/payload operand — no per-query row pass (bench c7's lever)
    use_member_ops: bool = True

    def validate(self) -> "EngineConfig":
        if self.dense_nb < 1:
            raise ValueError("dense_nb must be >= 1")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        return self
