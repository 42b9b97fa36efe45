"""Sharded (multi-chip) execution helpers.

The reference has no distributed story (SURVEY.md §2.3: single process, a
thread pool over segments at most). This rebuild shards the concatenated
doc axis over a 1-D `jax.sharding.Mesh` ("d") — data parallelism over docs:

- columns are loaded shard-partitioned (value rows co-located with their
  docs, shard-local doc ids — see index/loader.py), so mask materialization
  and every scatter/gather stays on-chip;
- fruit merges are the ONLY cross-chip traffic: `psum` for counts and exact
  limb sums (integer addition commutes — exactness survives sharding),
  all-gather + local reduce for min/max, and CROSS-SHARD BISECTION for
  order statistics (O(log span) scalar psums over per-shard value-sorted
  layouts — no all-gather, no resort; aggs/compile.py
  `_bisect_select_values`). On GPUs XLA lowers these to NCCL collectives.

`make_mesh` builds the mesh; pass it to `Index.searcher(mesh=...)`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over `n_devices` (default: all) with the doc-shard axis 'd'."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("d",))
