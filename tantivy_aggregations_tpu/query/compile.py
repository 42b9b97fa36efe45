"""Query -> docid bitmask materializer, v2 (int32-plane engine).

`extract_params` maps query constants into each column's w-domain (the
int32 offset planes of SURVEY.md §2.2 T4's monotonic mapping, re-planned
for this hardware — see index/loader.py) with exact Python big-int
arithmetic, clamping bounds into representable range so the traced program
is branch-free. `eval_mask` emits pure vector compares over the planes.

Exactness notes:
- Exclusive range bounds are normalized to inclusive in the mono domain
  (mono is an integer bijection, so v > b == v >= b+1 for every field type
  including f64).
- f64 signed zeros: -0.0 == 0.0 must hold; equality carries the ±0 mono
  pair, range bounds at zero pick the float-correct side.
- The `prefix` argument re-targets the same query program onto a permuted
  (OrderedLayout) view of the columns — used by the high-cardinality terms
  and percentile fast paths, which evaluate masks directly in value order.
"""

from __future__ import annotations

import math
from typing import Dict

import jax.numpy as jnp
import numpy as np

from ..query import ir as Q
from ..schema import FieldType
from ..utils import exact as exact_mod
from ..utils import mono as mono_mod
from ..ops import reductions as R

U64_MAX = 2**64 - 1


def _mono(ftype: FieldType, value) -> int:
    return mono_mod.scalar_to_mono(ftype.value, value)


def _key(path) -> str:
    return "/".join(map(str, path))


def _wide_pair(w: int):
    """u64 w -> (hi, lo) monoized int32 params."""
    return (w >> 32) - 2**31, (w & 0xFFFFFFFF) - 2**31


def extract_params(query: Q.Query, dindex, path=("q",)) -> Dict[str, np.int32]:
    out: Dict[str, np.int32] = {}
    _extract(query, dindex, path, out)
    return out


def _term_w_params(col, ftype, value):
    """Exact w-domain equality targets for one user value: list of candidate
    monos (the ±0 pair for f64 zero), each -> (present, w). A NaN f64 term
    matches nothing (fields cannot store NaN; the oracle's IEEE == is
    all-false for NaN — same spec as NaN range bounds, §A.10)."""
    if ftype == FieldType.F64 and math.isnan(float(value)):
        return [None, None]
    monos = [_mono(ftype, value)]
    if ftype == FieldType.F64 and float(value) == 0.0:
        monos = [_mono(ftype, 0.0), _mono(ftype, -0.0)]
    outs = []
    for m in monos:
        if col.n_values and col.min_mono <= m <= col.max_mono:
            outs.append(m - col.min_mono)  # exact python int, in [0, span]
        else:
            outs.append(None)
    if len(outs) == 1:
        outs.append(outs[0])
    return outs


def match_runs(dindex, q) -> list:
    """Matched-set compare runs of a set-type query (TermSet/Fuzzy/Regex)
    against the GLOBAL term table / mono w-domain: inclusive (lo, hi) exact
    python ints, sorted, lo >= 0, adjacent values merged. Cached on the
    device index — msearch streams re-extract params per request, and the
    fuzzy/regex predicates scan the whole term table."""
    from ..utils import termmatch
    if isinstance(q, Q.TermSetQuery):
        key = ("tset", q.field, q.values)
    elif isinstance(q, Q.FuzzyTermQuery):
        key = ("fuzzy", q.field, q.term, q.distance, q.transpositions,
               q.prefix_length)
    else:
        key = ("regex", q.field, q.pattern)
    cache = dindex.set_query_runs
    hit = cache.get(key)
    if hit is not None:
        return hit
    entry = dindex.schema.field(q.field)
    col = dindex.column(q.field)
    termmatch.check_set_query_field(entry.type, q)
    if isinstance(q, Q.TermSetQuery):
        if entry.type.is_stringy:
            from ..schema import stringy_term
            ws = {dindex.keyword_ord(q.field, stringy_term(entry.type, v))
                  for v in q.values}
            ws.discard(-1)
        else:
            ws = set()
            for v in q.values:
                for w in _term_w_params(col, entry.type, v):
                    if w is not None:
                        ws.add(w)
        runs = termmatch.runs_from_sorted(sorted(ws))
    else:
        if isinstance(q, Q.FuzzyTermQuery):
            tmask = termmatch.fuzzy_term_mask(
                col.terms, str(q.term), q.distance, q.transpositions,
                q.prefix_length)
        else:
            tmask = termmatch.regex_term_mask(col.terms, str(q.pattern))
        runs = termmatch.runs_from_sorted(
            np.flatnonzero(tmask).tolist())
    cache[key] = runs
    return runs


def _extract(q, dindex, path, out) -> None:
    if isinstance(q, (Q.MatchAllQuery, Q.ExistsQuery)):
        return
    if isinstance(q, (Q.TermSetQuery, Q.FuzzyTermQuery, Q.RegexQuery)):
        entry = dindex.schema.field(q.field)
        col = dindex.column(q.field)
        runs = match_runs(dindex, q)
        S = Q.run_slots(q)
        if len(runs) > S:
            # plan-time acceptance (Program.accepts) keeps overflowing
            # queries off compiled programs; this guards direct callers
            raise NotImplementedError(
                f"set query expands to {len(runs)} runs > {S} slots")
        k = _key(path)
        narrow = entry.type.is_stringy or col.narrow
        for i in range(S):
            lo, hi = runs[i] if i < len(runs) else (1, 0)  # empty run
            if narrow:
                out[f"{k}:s{i}l"] = np.int32(lo)
                out[f"{k}:s{i}h"] = np.int32(hi)
            else:
                lh, ll = _wide_pair(lo)
                hh, hl = _wide_pair(hi)
                out[f"{k}:s{i}lh"], out[f"{k}:s{i}ll"] = (np.int32(lh),
                                                          np.int32(ll))
                out[f"{k}:s{i}hh"], out[f"{k}:s{i}hl"] = (np.int32(hh),
                                                          np.int32(hl))
        return
    if isinstance(q, Q.TermQuery):
        entry = dindex.schema.field(q.field)
        col = dindex.column(q.field)
        k = _key(path)
        if entry.type.is_stringy:
            from ..schema import stringy_term
            ordv = dindex.keyword_ord(q.field,
                                      stringy_term(entry.type, q.value))
            out[k + ":t"] = np.int32(ordv if ordv >= 0 else -2)
            return
        ws = _term_w_params(col, entry.type, q.value)
        if col.narrow:
            for i, w in enumerate(ws):
                out[f"{k}:t{i}"] = np.int32(w if w is not None else 0)
                out[f"{k}:tv{i}"] = np.int32(1 if w is not None else 0)
        else:
            for i, w in enumerate(ws):
                hi, lo = _wide_pair(w if w is not None else 0)
                out[f"{k}:th{i}"] = np.int32(hi)
                out[f"{k}:tl{i}"] = np.int32(lo)
                out[f"{k}:tv{i}"] = np.int32(1 if w is not None else 0)
        return
    if isinstance(q, Q.PhraseQuery):
        entry = dindex.schema.field(q.field)
        if entry.type != FieldType.TEXT:
            raise TypeError("phrase query requires a text field")
        k = _key(path)
        for i, tok in enumerate(q.tokens):
            ordv = dindex.keyword_ord(q.field, tok)
            # -2 sentinel (like missing TermQuery ordinals): never equals a
            # stored ordinal (>= 0) nor the -1 fill of shifted windows
            out[f"{k}:p{i}"] = np.int32(ordv if ordv >= 0 else -2)
        return
    if isinstance(q, Q.PrefixQuery):
        entry = dindex.schema.field(q.field)
        if not entry.type.is_stringy or entry.type == FieldType.BYTES:
            raise TypeError(
                "prefix query requires a keyword, text, or facet field")
        col = dindex.column(q.field)
        k = _key(path)
        # all prefix-extensions form one contiguous run of the sorted term
        # table: [prefix, successor(prefix)) where the successor increments
        # the last non-maximal character (carry towards the front)
        terms = col.terms
        lo_ord = int(np.searchsorted(terms, str(q.prefix), side="left"))
        succ = _prefix_successor(str(q.prefix))
        hi_ord = (int(np.searchsorted(terms, succ, side="left")) - 1
                  if succ is not None else len(terms) - 1)
        if len(terms) == 0 or hi_ord < lo_ord:
            lo_ord, hi_ord = 1, 0  # empty
        out[k + ":lo"] = np.int32(lo_ord)
        out[k + ":hi"] = np.int32(max(hi_ord, 0))
        return
    if isinstance(q, Q.RangeQuery):
        entry = dindex.schema.field(q.field)
        col = dindex.column(q.field)
        k = _key(path)
        if entry.type.is_stringy:
            from ..schema import stringy_term
            # lexicographic range -> inclusive global-ordinal range
            card = len(col.terms)
            lo_ord, hi_ord = 0, card - 1
            if q.lower is not None:
                side = "left" if q.include_lower else "right"
                lo_ord = int(np.searchsorted(
                    col.terms, stringy_term(entry.type, q.lower), side=side))
            if q.upper is not None:
                side = "right" if q.include_upper else "left"
                hi_ord = int(np.searchsorted(
                    col.terms, stringy_term(entry.type, q.upper),
                    side=side)) - 1
            if card == 0 or hi_ord < lo_ord or hi_ord < 0:
                lo_ord, hi_ord = 1, 0  # empty
            out[k + ":lo"] = np.int32(lo_ord)
            out[k + ":hi"] = np.int32(max(hi_ord, 0))
            return
        if not entry.type.is_numeric:
            raise TypeError("range query requires a numeric or string field")
        # normalize to inclusive mono bounds
        forced_empty = False
        if entry.type != FieldType.F64:
            # integer fields: exact bound normalization (SURVEY §A.10;
            # shared spec implementation in utils/exact.py, also used by
            # oracle/engine.py _range_mask)
            lo_r = exact_mod.norm_int_bound(entry.type.value, q.lower, True,
                                            q.include_lower)
            hi_r = exact_mod.norm_int_bound(entry.type.value, q.upper,
                                            False, q.include_upper)
            forced_empty = lo_r == "empty" or hi_r == "empty"
            lo_m = (_mono(entry.type, lo_r) if isinstance(lo_r, int)
                    else col.min_mono)
            hi_m = (_mono(entry.type, hi_r) if isinstance(hi_r, int)
                    else col.max_mono)
        elif ((q.lower is not None and math.isnan(float(q.lower)))
              or (q.upper is not None and math.isnan(float(q.upper)))):
            # NaN bounds match nothing on f64 fields too (the oracle's
            # IEEE compares are all-false for NaN; encode the same)
            forced_empty = True
            lo_m, hi_m = col.min_mono, col.max_mono
        else:
            if q.lower is not None:
                lo_m = _zero_bound(entry.type, q.lower, True,
                                   q.include_lower)
                if not q.include_lower:
                    lo_m += 1
            else:
                lo_m = col.min_mono
            if q.upper is not None:
                hi_m = _zero_bound(entry.type, q.upper, False,
                                   q.include_upper)
                if not q.include_upper:
                    hi_m -= 1
            else:
                hi_m = col.max_mono
        if forced_empty:
            lo_m, hi_m = 1, 0  # flows into the empty-range param encoding
        lo_w = lo_m - col.min_mono  # exact python ints
        hi_w = hi_m - col.min_mono
        if col.n_values == 0 or lo_w > col.span or hi_w < 0 or lo_w > hi_w:
            lo_w, hi_w = 1, 0  # empty
        else:
            lo_w = max(0, lo_w)
            hi_w = min(col.span, hi_w)
        if col.narrow:
            out[k + ":lo"] = np.int32(lo_w)
            out[k + ":hi"] = np.int32(hi_w)
        else:
            lh, ll = _wide_pair(min(max(lo_w, 0), U64_MAX))
            hh, hl = _wide_pair(min(max(hi_w, 0), U64_MAX))
            if lo_w > hi_w:  # empty: force lexicographic impossibility
                lh, ll = _wide_pair(1)
                hh, hl = _wide_pair(0)
            out[k + ":loh"], out[k + ":lol"] = np.int32(lh), np.int32(ll)
            out[k + ":hih"], out[k + ":hil"] = np.int32(hh), np.int32(hl)
        return
    if isinstance(q, Q.BooleanQuery):
        for i, c in enumerate(q.must):
            _extract(c, dindex, path + ("m", i), out)
        for i, c in enumerate(q.should):
            _extract(c, dindex, path + ("s", i), out)
        for i, c in enumerate(q.must_not):
            _extract(c, dindex, path + ("n", i), out)
        return
    raise TypeError(f"unknown query {type(q)!r}")


def _prefix_successor(prefix: str):
    """Smallest string greater than every prefix-extension, or None when no
    such string exists (prefix is all U+10FFFF)."""
    chars = list(prefix)
    for i in range(len(chars) - 1, -1, -1):
        if ord(chars[i]) < 0x10FFFF:
            return "".join(chars[:i]) + chr(ord(chars[i]) + 1)
    return None


def _zero_bound(ftype: FieldType, value, is_lower: bool, inclusive: bool) -> int:
    if ftype == FieldType.F64 and float(value) == 0.0:
        if (is_lower and inclusive) or (not is_lower and not inclusive):
            return _mono(ftype, -0.0)
        return _mono(ftype, 0.0)
    return _mono(ftype, value)


def query_fields(q: Q.Query, out=None) -> set:
    if out is None:
        out = set()
    if isinstance(q, (Q.TermQuery, Q.RangeQuery, Q.PrefixQuery,
                      Q.ExistsQuery, Q.PhraseQuery, Q.TermSetQuery,
                      Q.FuzzyTermQuery, Q.RegexQuery)):
        out.add(q.field)
    elif isinstance(q, Q.BooleanQuery):
        for c in (*q.must, *q.should, *q.must_not):
            query_fields(c, out)
    return out


def eval_mask(q, dindex, params, path, T, arrays, prefix="") -> jnp.ndarray:
    """Trace-time mask evaluation over the (possibly permuted) plane view.
    With a permuted prefix, CSR query fields are unsupported (plan-guarded:
    permuted views only cache dense columns)."""
    if isinstance(q, Q.MatchAllQuery):
        return jnp.ones(T, dtype=bool)
    if isinstance(q, Q.ExistsQuery):
        col = dindex.column(q.field)
        if col.multi:
            if col.has_multi_planes:
                # position-0 plane: any value => a first value exists
                return arrays[prefix + f"{q.field}:mp0"] >= 0
            if col.has_multi_planes_wide:
                return arrays[prefix + f"{q.field}:mpn"] > 0
            if prefix:
                raise NotImplementedError(
                    "CSR query field under a permuted view")
            return R.values_hit_to_doc_mask(
                arrays[f"{q.field}:valid"] > 0, arrays[f"{q.field}:doc"], T)
        if col.ftype.is_stringy:
            return arrays[prefix + f"{q.field}:w"] >= 0
        return jnp.ones(T, dtype=bool)
    if isinstance(q, Q.PhraseQuery):
        col = dindex.column(q.field)
        k = _key(path)
        n = len(q.tokens)
        if n == 0:
            return jnp.zeros(T, dtype=bool)
        if col.has_multi_planes and not col.has_tail:
            # dense per-position planes: plane index IS the token position,
            # so the phrase is an OR over start positions of ANDed per-plane
            # compares — doc-aligned, permutes like any plane (works under
            # permuted views)
            K = len(col.multi_planes_host)
            m = jnp.zeros(T, dtype=bool)
            for p0 in range(0, K - n + 1):
                mm = (arrays[prefix + f"{q.field}:mp{p0}"]
                      == params[f"{k}:p0"])
                for j in range(1, n):
                    mm &= (arrays[prefix + f"{q.field}:mp{p0 + j}"]
                           == params[f"{k}:p{j}"])
                m |= mm
            return m
        if prefix:
            raise NotImplementedError(
                "CSR query field under a permuted view")
        # CSR token stream (position-ordered by construction): the phrase
        # is a SHIFTED AND over the ordinal plane; the window's last row
        # must be a real row of the SAME doc (rows of one doc are
        # contiguous, so the endpoints pin the whole window)
        w = arrays[f"{q.field}:w"]
        doc = arrays[f"{q.field}:doc"]
        valid = arrays[f"{q.field}:valid"] > 0

        def shift(x, j, fill):
            if j == 0:
                return x
            return jnp.concatenate(
                [x[j:], jnp.full((j,), fill, x.dtype)])

        hits = valid & (w == params[f"{k}:p0"])
        for j in range(1, n):
            hits &= shift(w, j, -1) == params[f"{k}:p{j}"]
        if n > 1:
            hits &= shift(valid, n - 1, False)
            hits &= shift(doc, n - 1, -1) == doc
        return R.values_hit_to_doc_mask(hits, doc, T)
    if isinstance(q, (Q.TermQuery, Q.RangeQuery, Q.PrefixQuery,
                      Q.TermSetQuery, Q.FuzzyTermQuery, Q.RegexQuery)):
        # prefix queries carry the same :lo/:hi ordinal params as string
        # ranges and share the range compare paths below; set-type queries
        # (termset/fuzzy/regex) are a disjunction of run-slot range
        # compares (run los are >= 0 and empty slots carry (1, 0), so -1
        # plane fill can never match — no extra guard needed)
        col = dindex.column(q.field)
        k = _key(path)
        a = lambda s: arrays[prefix + f"{q.field}:{s}"]
        is_set = isinstance(q, (Q.TermSetQuery, Q.FuzzyTermQuery,
                                Q.RegexQuery))
        S = Q.run_slots(q) if is_set else 0

        def set_cmp32(pk):
            m = (pk >= params[f"{k}:s0l"]) & (pk <= params[f"{k}:s0h"])
            for i in range(1, S):
                m |= (pk >= params[f"{k}:s{i}l"]) \
                    & (pk <= params[f"{k}:s{i}h"])
            return m

        def set_cmp_wide(hi, lo):
            m = None
            for i in range(S):
                ge = (hi > params[f"{k}:s{i}lh"]) | (
                    (hi == params[f"{k}:s{i}lh"])
                    & (lo >= params[f"{k}:s{i}ll"]))
                le = (hi < params[f"{k}:s{i}hh"]) | (
                    (hi == params[f"{k}:s{i}hh"])
                    & (lo <= params[f"{k}:s{i}hl"]))
                m = (ge & le) if m is None else (m | (ge & le))
            return m
        if col.multi and col.has_multi_planes:
            # multi field with dense per-position planes: OR of doc-aligned
            # compares (works under permuted views too — planes permute like
            # any doc-aligned column); docs with > DENSE_MULTI_K values
            # contribute their overflow rows via a scatter-or over just the
            # (small) tail. -1 fill rows can never match: term params are
            # w-domain (>= 0) or the -2 missing-ordinal sentinel, and the
            # range compare carries an explicit >= 0 guard.
            def cmp32(pk):
                if is_set:
                    return set_cmp32(pk)
                if isinstance(q, Q.TermQuery):
                    if col.ftype.is_stringy:
                        return pk == params[k + ":t"]
                    return (((pk == params[k + ":t0"])
                             & (params[k + ":tv0"] > 0))
                            | ((pk == params[k + ":t1"])
                               & (params[k + ":tv1"] > 0)))
                return ((pk >= params[k + ":lo"])
                        & (pk <= params[k + ":hi"]) & (pk >= 0))

            m = jnp.zeros(T, dtype=bool)
            for kk in range(len(col.multi_planes_host)):
                m |= cmp32(arrays[prefix + f"{q.field}:mp{kk}"])
            if col.has_tail:
                # plan guards keep tailed fields out of permuted views
                m |= R.values_hit_to_doc_mask(
                    cmp32(arrays[f"{q.field}:tw"]),
                    arrays[f"{q.field}:tdoc"], T)
            return m
        if col.multi and col.has_multi_planes_wide:
            # WIDE multi field with dense per-position (hi, lo) plane
            # pairs: OR of doc-aligned lexicographic compares. Validity
            # comes from the shared value-count plane (every (hi, lo) pair
            # is an attainable value, so zero-filled positions would
            # otherwise be range-matchable). Permutes like the narrow
            # planes; overflow rows ride the same small scatter-or tail.
            def cmpw(hik, lok):
                if is_set:
                    return set_cmp_wide(hik, lok)
                if isinstance(q, Q.TermQuery):
                    return (((hik == params[k + ":th0"])
                             & (lok == params[k + ":tl0"])
                             & (params[k + ":tv0"] > 0))
                            | ((hik == params[k + ":th1"])
                               & (lok == params[k + ":tl1"])
                               & (params[k + ":tv1"] > 0)))
                ge = (hik > params[k + ":loh"]) | (
                    (hik == params[k + ":loh"])
                    & (lok >= params[k + ":lol"]))
                le = (hik < params[k + ":hih"]) | (
                    (hik == params[k + ":hih"])
                    & (lok <= params[k + ":hil"]))
                return ge & le

            mpn = arrays[prefix + f"{q.field}:mpn"]
            m = jnp.zeros(T, dtype=bool)
            for kk in range(len(col.multi_planes_wide_host)):
                m |= (cmpw(arrays[prefix + f"{q.field}:mph{kk}"],
                           arrays[prefix + f"{q.field}:mpl{kk}"])
                      & (mpn > kk))
            if col.has_tail:
                # plan guards keep tailed fields out of permuted views
                m |= R.values_hit_to_doc_mask(
                    cmpw(arrays[f"{q.field}:th"], arrays[f"{q.field}:tl"])
                    & (arrays[f"{q.field}:tvalid"] > 0),
                    arrays[f"{q.field}:tdoc"], T)
            return m
        if is_set:
            if col.ftype.is_stringy or col.narrow:
                hits = set_cmp32(a("w"))
            else:
                hits = set_cmp_wide(a("hi"), a("lo"))
        elif isinstance(q, Q.TermQuery) and col.ftype.is_stringy:
            hits = a("w") == params[k + ":t"]
        elif isinstance(q, Q.TermQuery):
            if col.narrow:
                w = a("w")
                hits = ((w == params[k + ":t0"]) & (params[k + ":tv0"] > 0)) \
                    | ((w == params[k + ":t1"]) & (params[k + ":tv1"] > 0))
            else:
                hi, lo = a("hi"), a("lo")
                hits = (((hi == params[k + ":th0"]) & (lo == params[k + ":tl0"])
                         & (params[k + ":tv0"] > 0))
                        | ((hi == params[k + ":th1"]) & (lo == params[k + ":tl1"])
                           & (params[k + ":tv1"] > 0)))
        else:  # range
            if col.narrow:
                w = a("w")
                hits = (w >= params[k + ":lo"]) & (w <= params[k + ":hi"])
            else:
                hi, lo = a("hi"), a("lo")
                ge = (hi > params[k + ":loh"]) | (
                    (hi == params[k + ":loh"]) & (lo >= params[k + ":lol"]))
                le = (hi < params[k + ":hih"]) | (
                    (hi == params[k + ":hih"]) & (lo <= params[k + ":hil"]))
                hits = ge & le
        if col.multi:
            if prefix:
                raise NotImplementedError(
                    "CSR query field under a permuted view")
            hits = hits & (arrays[f"{q.field}:valid"] > 0)
            return R.values_hit_to_doc_mask(hits, arrays[f"{q.field}:doc"], T)
        return hits
    if isinstance(q, Q.BooleanQuery):
        m = jnp.ones(T, dtype=bool)
        for i, c in enumerate(q.must):
            m &= eval_mask(c, dindex, params, path + ("m", i), T, arrays, prefix)
        if q.should and not q.must:
            s = jnp.zeros(T, dtype=bool)

            for i, c in enumerate(q.should):
                s |= eval_mask(c, dindex, params, path + ("s", i), T, arrays,
                               prefix)
            m &= s
        for i, c in enumerate(q.must_not):
            m &= ~eval_mask(c, dindex, params, path + ("n", i), T, arrays,
                            prefix)
        return m
    raise TypeError(f"unknown query {type(q)!r}")
