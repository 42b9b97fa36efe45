"""Searcher: the engine's `agg_search` entry point (SURVEY.md §2.1 C1/C3).

Reference analog: `AggSearcher::agg_search(query, agg)` — prepare the agg
tree against the schema, drive per-segment collection, merge fruits. Here:
load the index's columns to device HBM once (cached per index epoch),
compile the (query shape, agg tree shape) pair to one fused jitted program
(cached), execute, and harvest host-side fruits.
"""

from __future__ import annotations

from typing import Dict, Optional

from .aggs import ir as agg_ir
from .query import ir as query_ir


def _copy_fruits(v):
    """Independent copy of a fruit tree (dicts/lists of scalars — the
    only shapes harvest produces)."""
    if isinstance(v, dict):
        return {k: _copy_fruits(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_copy_fruits(x) for x in v]
    return v


class _HostFallback:
    """Exact host execution for the rare agg-tree shapes the device planner
    cannot lower yet (SURVEY.md §2.1: the spec defines semantics for every
    tree; the engine must never refuse one). The oracle IS the engine's
    host path — same index, same exact arithmetic — so results are
    identical by construction. Carries just enough of the Program protocol
    for the msearch/stream drivers to pass groups through synchronously."""

    def __init__(self, oracle, reason: str):
        self.oracle = oracle
        self.reason = reason

    def run(self, query, aggs):
        return self.oracle.agg_search(query, aggs)


class Searcher:
    def __init__(self, index, mesh=None, config=None):
        from .engine_config import EngineConfig
        self.index = index
        self.schema = index.schema
        self._mesh = mesh
        self.config = (config or EngineConfig()).validate()
        #: QueryStats of the most recent agg_search (when collect_stats)
        self.last_stats = None
        self._device_index = None
        self._device_epoch = None
        self._programs = {}  # insertion-ordered; pruned LRU-style
        self._max_programs = 256
        self._overflow_fb = None  # host path for set-query run overflow

    # -- device index ----------------------------------------------------------

    def _get_device_index(self):
        from .index.loader import load_device_index
        if self._device_index is None or self._device_epoch != self.index.epoch:
            self._device_index = load_device_index(self.index, mesh=self._mesh)
            self._device_epoch = self.index.epoch
            self._programs.clear()
        return self._device_index

    # -- entry point -----------------------------------------------------------

    def _program_for(self, query, aggs):
        from .aggs.compile import get_program
        dindex = self._get_device_index()
        key = (query_ir.structural_key(query), agg_ir.structural_key(aggs))
        prog = self._programs.get(key)
        self._program_was_cached = prog is not None
        if prog is None:
            try:
                prog = get_program(dindex, query, aggs, config=self.config)
            except NotImplementedError as e:
                from .utils.stats import log
                log.warning("agg tree has no device lowering (%s); "
                            "running the exact host path", e)
                prog = _HostFallback(self.index.oracle_searcher(), str(e))
            self._programs[key] = prog
            while len(self._programs) > self._max_programs:
                self._programs.pop(next(iter(self._programs)))
        else:
            self._programs.pop(key)  # refresh LRU position
            self._programs[key] = prog
        if (not isinstance(prog, _HostFallback)
                and not prog.accepts(query, aggs)):
            # same shape, but THIS request's set-query expansion exceeds
            # the compiled run slots: answer it on the exact host path
            # without evicting the program (fitting requests keep using it)
            from .utils.stats import log
            log.warning("set query expansion exceeds the program's run "
                        "slots; running the exact host path")
            if self._overflow_fb is None:
                self._overflow_fb = _HostFallback(
                    self.index.oracle_searcher(), "set-query run overflow")
            return self._overflow_fb
        return prog

    def agg_search(self, query: query_ir.Query,
                   aggs: Dict[str, agg_ir.Agg]) -> Dict[str, dict]:
        """Run `aggs` over docs matching `query`; returns host-side fruits
        bit-identical to OracleSearcher.agg_search on the same index."""
        if not self.config.collect_stats:
            return self._program_for(query, aggs).run(query, aggs)
        from .utils.stats import QueryStats, timer
        t = timer()
        prog = self._program_for(query, aggs)
        st = QueryStats(program_cached=self._program_was_cached)
        st.prepare_ms = t.lap()
        if isinstance(prog, _HostFallback):
            out = prog.run(query, aggs)
            st.device_ms = t.lap()
        else:
            raw = prog.submit(query, aggs)
            st.dispatch_ms = t.lap()
            staged = prog.stage(raw, aggs)
            import jax
            import numpy as np
            np.asarray(jax.device_get(staged[0]))  # block: execute + copy
            st.wait_ms = t.lap()
            out = prog.finalize(raw, aggs, staged=staged)
            st.harvest_ms = t.lap()
            st.device_ms = st.dispatch_ms + st.wait_ms + st.harvest_ms
        st.total_ms = st.prepare_ms + st.device_ms
        self.last_stats = st
        return out

    def agg_search_batch(self, requests) -> list:
        """Multi-search ("msearch") execution of [(query, aggs), ...].

        Runs of consecutive requests sharing the same (query shape, agg
        shape) are vmapped into ONE device dispatch — column passes are
        shared across the batch and the per-dispatch overhead is paid once
        per group instead of once per query. Groups with different shapes
        are dispatched asynchronously back-to-back, and all device->host
        transfers are batched. (The reference is strictly synchronous per
        query — SURVEY.md §3.1; this is the engine's batched serving
        pattern.)"""
        submitted = self._submit_batch(requests)
        # phase 2: collect (transfers have been landing in the background)
        results = []
        for group in submitted:
            results.extend(self._collect_group(group))
        return results

    def _submit_batch(self, requests) -> list:
        """Phase 1 of agg_search_batch: group consecutive same-shape
        requests (capped so multiple groups pipeline — each group's
        device->host copy overlaps the next group's compute) and dispatch
        every group asynchronously. Returns submitted group handles for
        _collect_group (also the unit the replica layer round-robins)."""
        groups = []  # (prog, [queries], aggs)
        for query, aggs in requests:
            prog = self._program_for(query, aggs)
            cap = self._group_cap(prog)
            if (groups and groups[-1][0] is prog and groups[-1][2] is aggs
                    and len(groups[-1][1]) < cap):
                groups[-1][1].append(query)
            else:
                groups.append((prog, [query], aggs))
        return [self._submit_group(prog, queries, aggs)
                for prog, queries, aggs in groups]

    def _group_cap(self, prog) -> int:
        """msearch group size for one program: the serving batch, shrunk by
        the program's own HBM-residency cap (per-query [rows] state in the
        rare slot_rank / in-slot-top_hits / sort paths must fit alongside
        the resident columns — see Program.batch_cap)."""
        cap = self.config.max_batch
        pc = getattr(prog, "batch_cap", None)
        return cap if pc is None else max(1, min(cap, pc))

    def _collect_group(self, group):
        prog, queries, aggs, raw, staged, idxmap, nuniq = group
        if isinstance(prog, _HostFallback):
            return [prog.run(q, aggs) for q in queries]
        if nuniq == 1:
            uniq_outs = [prog.finalize(raw, aggs, staged=staged)]
        else:
            uniq_outs = prog.finalize_many(raw, aggs, nuniq, staged=staged)
        if len(queries) == nuniq:
            return uniq_outs
        # duplicated requests: each caller gets its own result object
        # (fruits are plain dict/list/scalar trees — a direct recursive
        # copy is ~10x cheaper than copy.deepcopy's memo machinery, and
        # deepcopy dominated the dedup serving mode on bucketed trees)
        seen = [False] * nuniq
        out = []
        for i in idxmap:
            out.append(uniq_outs[i] if not seen[i]
                       else _copy_fruits(uniq_outs[i]))
            seen[i] = True
        return out

    def agg_search_stream(self, requests, lookahead: int = 2):
        """Sustained-serving generator over an iterable of (query, aggs):
        keeps `lookahead` msearch groups in flight so each group's
        device->host transfer lands while later groups compute — the final
        round trip amortizes over the whole stream instead of every
        agg_search_batch call. Yields result dicts in request order."""
        from collections import deque
        it = iter(requests)
        pending = deque()  # (prog, queries, aggs, raw, staged)
        holdover = []  # request that ended the previous group (shape change)

        def next_group():
            group_q, group_aggs, prog = [], None, None
            cap = self.config.max_batch
            while True:
                if holdover:
                    query, aggs = holdover.pop()
                else:
                    try:
                        query, aggs = next(it)
                    except StopIteration:
                        break
                p = self._program_for(query, aggs)
                if prog is None:
                    prog, group_aggs = p, aggs
                    cap = self._group_cap(p)
                elif p is not prog or aggs is not group_aggs:
                    holdover.append((query, aggs))  # starts the next group
                    break
                group_q.append(query)
                if len(group_q) >= cap:
                    break
            if not group_q:
                return False
            pending.append(self._submit_group(prog, group_q, group_aggs))
            return True

        for _ in range(lookahead):
            if not next_group():
                break
        while pending:
            group = pending.popleft()
            next_group()
            yield from self._collect_group(group)

    def _submit_group(self, prog, queries, aggs):
        if isinstance(prog, _HostFallback):
            return (prog, queries, aggs, None, None, None, 0)
        # dedup identical requests (config.msearch_dedup): serving streams
        # repeat queries, and a compiled program is a pure function of its
        # extracted params — compute each distinct param set ONCE and fan
        # the fruits out
        if self.config.msearch_dedup:
            keymap, uniq, idxmap = {}, [], []
            for q in queries:
                k = prog.param_key(q, aggs)
                j = keymap.get(k)
                if j is None:
                    j = keymap[k] = len(uniq)
                    uniq.append(q)
                idxmap.append(j)
        else:
            uniq = list(queries)
            idxmap = list(range(len(queries)))
        if len(uniq) == 1:
            raw = prog.submit(uniq[0], aggs)
        else:
            pad = 1
            while pad < len(uniq):
                pad *= 2
            raw = prog.submit_many(uniq, aggs, pad_to=pad)
        return (prog, queries, aggs, raw, prog.stage(raw, aggs),
                idxmap, len(uniq))
