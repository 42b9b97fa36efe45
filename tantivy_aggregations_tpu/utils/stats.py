"""Observability: per-query stats, profiler hooks, structured logging.

The reference has no tracing/metrics story (SURVEY.md §5 — users attach
external Rust profilers); this engine ships one because compiled device
programs are opaque without it:

- `QueryStats`: wall-time breakdown of one agg_search (param prep, device
  dispatch+execute, transfer, harvest) plus result facts (docs matched).
- `trace(...)`: context manager around `jax.profiler.trace` — writes an
  XPlane trace viewable in TensorBoard/XProf when enabled, no-op otherwise.
- module logger `log`: std-logging, structured key=value formatting.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field as dc_field
from typing import Optional

log = logging.getLogger("tantivy_aggregations_tpu")


@dataclass
class QueryStats:
    prepare_ms: float = 0.0
    device_ms: float = 0.0  # dispatch + execute + device->host transfer
    harvest_ms: float = 0.0
    total_ms: float = 0.0
    #: finer split of device_ms (collect_stats only): host-side dispatch of
    #: the jitted program vs the blocking wait for execution + the
    #: device->host fruit transfer (one host<->device round trip)
    dispatch_ms: float = 0.0
    wait_ms: float = 0.0
    docs_matched: Optional[int] = None
    batch_size: int = 1
    program_cached: bool = True

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in
                ("prepare_ms", "device_ms", "dispatch_ms", "wait_ms",
                 "harvest_ms", "total_ms", "docs_matched", "batch_size",
                 "program_cached")}


class _Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        t = time.perf_counter()
        out = (t - self.t0) * 1000.0
        self.t0 = t
        return out


def timer() -> _Timer:
    return _Timer()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the enclosed queries with jax.profiler (TensorBoard XPlane
    format). No-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import jax
    with jax.profiler.trace(log_dir):
        yield
