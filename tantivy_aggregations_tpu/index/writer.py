"""IndexWriter: document ingestion and segment building.

Device-engine analog of tantivy's IndexWriter (SURVEY.md §2.2 T3, §3.3): docs
are buffered on the host, `commit()` serializes one immutable segment
(columns + CSR + sorted term table) and applies pending deletes. Indexing is
a host-side NumPy path — there is deliberately no on-device indexing; the
device consumes immutable columns (SURVEY.md §2.2 T3 "Rebuild equivalent").

Two ingestion paths:
- `add_document({field: value_or_list})` — per-doc, test/fixture friendly.
- `add_documents_columnar({field: array | (offsets, values) | list})` — bulk,
  used by the 10M-doc benchmark generator.

Delete semantics mirror tantivy's opstamp ordering: `delete_term` kills every
doc containing the term that was added before the delete call, across all
committed segments and the in-flight buffer (SURVEY.md §A.2).
"""

from __future__ import annotations

import uuid
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..schema import Cardinality, FieldType, Schema
from ..utils.tokenize import tokenize
from .segment import Segment, SegmentFieldData, numeric_dtype


def _as_value_list(v) -> list:
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v]


def facet_prefixes(path: str) -> List[str]:
    """ "/a/b/c" -> ["/a", "/a/b", "/a/b/c"] (every ancestor, §2.2 T1)."""
    if (not path.startswith("/") or path == "/" or path.endswith("/")
            or "//" in path):
        raise ValueError(
            f"facet path must look like /seg or /seg/seg, got {path!r}")
    parts = path.split("/")[1:]
    return ["/" + "/".join(parts[:i + 1]) for i in range(len(parts))]


def coerce_bytes(v) -> bytes:
    """bytes stay raw; str encodes utf-8; anything else is a type error."""
    from ..schema import stringy_term
    return stringy_term(FieldType.BYTES, v)


def _stringy_doc_terms(ftype: FieldType, vals: list) -> list:
    """Per-doc term list for a stringy field (shared by both build paths)."""
    if ftype == FieldType.TEXT:
        return [t for v in vals for t in tokenize(str(v))]
    if ftype == FieldType.BYTES:
        return [coerce_bytes(v) for v in vals]
    if ftype == FieldType.FACET:
        # index every ancestor once per doc: facet counts and facet term
        # queries become plain per-ordinal operations
        return sorted({p for v in vals for p in facet_prefixes(str(v))})
    return [str(v) for v in vals]


class IndexWriter:
    def __init__(self, index):
        self._index = index
        self._schema: Schema = index.schema
        self._docs: List[dict] = []
        # ops log entries: ("add", doc) applied in order with deletes
        self._pending_deletes: List[Tuple[str, object, int]] = []  # field, value, opstamp
        self._opstamp = 0

    # -- ingestion -----------------------------------------------------------

    def add_document(self, doc: Dict[str, object]) -> int:
        for name in doc:
            if not self._schema.has_field(name):
                raise KeyError(f"field {name!r} not in schema")
        self._docs.append({"doc": doc, "opstamp": self._opstamp})
        self._opstamp += 1
        return self._opstamp - 1

    def add_documents_columnar(self, columns: Dict[str, object], num_docs: int) -> None:
        """Bulk ingestion. `columns[name]` is either a dense array [num_docs]
        (single-valued numeric), a (offsets, values) CSR pair, or a list of
        per-doc python values/lists."""
        self._docs.append({"columnar": columns, "n": int(num_docs),
                           "opstamp": self._opstamp})
        self._opstamp += 1

    def delete_term(self, field: str, value) -> None:
        entry = self._schema.field(field)
        self._pending_deletes.append((field, value, self._opstamp))
        self._opstamp += 1

    # -- commit --------------------------------------------------------------

    def commit(self) -> Optional[str]:
        """Build a segment from buffered docs (if any) and apply deletes."""
        seg = None
        if self._docs:
            seg = self._build_segment()  # opstamp-aware deletes applied inside
            self._docs.clear()
        if self._pending_deletes:
            self._apply_deletes()  # older segments: all their docs predate the deletes
            self._pending_deletes.clear()
        if seg is not None:
            self._index._add_segment(seg)
        self._index._commit_meta()
        # automatic compaction (tantivy's post-commit merge loop analog):
        # the index's merge policy decides; default LogMergePolicy keeps
        # write-heavy indexes at O(log N) segments (index/merge_policy.py)
        self._index.maybe_merge()
        return seg.id if seg is not None else None

    # -- internals -----------------------------------------------------------

    def _iter_buffered(self):
        """Yield (doc_dict, opstamp) expanding columnar blocks lazily."""
        for item in self._docs:
            if "doc" in item:
                yield item["doc"], item["opstamp"]
            else:
                cols, n, op = item["columnar"], item["n"], item["opstamp"]
                for i in range(n):
                    d = {}
                    for name, col in cols.items():
                        if isinstance(col, tuple):
                            offsets, values = col
                            d[name] = list(values[offsets[i]:offsets[i + 1]])
                        elif isinstance(col, np.ndarray):
                            d[name] = col[i]
                        else:
                            d[name] = col[i]
                    yield d, op

    def _build_segment(self) -> Segment:
        # Fast path: a single columnar block builds arrays without a doc loop.
        if len(self._docs) == 1 and "columnar" in self._docs[0]:
            return self._build_segment_columnar(self._docs[0])

        docs = [(d, op) for d, op in self._iter_buffered()]
        max_doc = len(docs)
        fields: Dict[str, SegmentFieldData] = {}
        for entry in self._schema.fields:
            name, ftype, card = entry.name, entry.type, entry.cardinality
            if ftype.is_stringy:
                per_doc: List[List[str]] = []
                for d, _ in docs:
                    vals = _as_value_list(d.get(name, []))
                    if card == Cardinality.SINGLE and len(vals) > 1:
                        raise ValueError(f"field {name!r} is single-valued")
                    per_doc.append(_stringy_doc_terms(ftype, vals))
                terms = sorted({t for vals in per_doc for t in vals})
                ord_of = {t: i for i, t in enumerate(terms)}
                offsets = np.zeros(max_doc + 1, dtype=np.uint32)
                flat: List[int] = []
                for i, vals in enumerate(per_doc):
                    flat.extend(ord_of[t] for t in vals)
                    offsets[i + 1] = len(flat)
                fields[name] = SegmentFieldData(
                    np.asarray(flat, dtype=np.uint32), offsets, terms)
            else:
                dtype = numeric_dtype(ftype)
                if card == Cardinality.SINGLE:
                    vals = np.zeros(max_doc, dtype=dtype)  # missing -> default
                    for i, (d, _) in enumerate(docs):
                        if name in d and d[name] is not None:
                            v = d[name]
                            if isinstance(v, (list, tuple)):
                                if len(v) > 1:
                                    raise ValueError(f"field {name!r} is single-valued")
                                v = v[0] if v else 0
                            vals[i] = dtype(v)
                    fields[name] = SegmentFieldData(vals)
                else:
                    offsets = np.zeros(max_doc + 1, dtype=np.uint32)
                    flat: List = []
                    for i, (d, _) in enumerate(docs):
                        vs = _as_value_list(d.get(name, []))
                        flat.extend(dtype(v) for v in vs)
                        offsets[i + 1] = len(flat)
                    fields[name] = SegmentFieldData(
                        np.asarray(flat, dtype=dtype), offsets)
        seg = Segment(uuid.uuid4().hex[:12], max_doc, fields)
        # deletes whose opstamp is after an add must still kill buffered docs
        self._apply_deletes_to_segment(seg, buffered_opstamps=[op for _, op in docs])
        return seg

    def _build_segment_columnar(self, item) -> Segment:
        cols, max_doc = item["columnar"], item["n"]
        fields: Dict[str, SegmentFieldData] = {}
        for entry in self._schema.fields:
            name, ftype, card = entry.name, entry.type, entry.cardinality
            if name not in cols:
                if ftype.is_stringy or card == Cardinality.MULTI:
                    fields[name] = SegmentFieldData(
                        np.zeros(0, dtype=np.uint32 if ftype.is_stringy
                                 else numeric_dtype(ftype)),
                        np.zeros(max_doc + 1, dtype=np.uint32),
                        [] if ftype.is_stringy else None)
                else:
                    fields[name] = SegmentFieldData(
                        np.zeros(max_doc, dtype=numeric_dtype(ftype)))
                continue
            col = cols[name]
            if ftype.is_stringy:
                if ftype in (FieldType.TEXT, FieldType.FACET):
                    per_doc_tokens = [
                        _stringy_doc_terms(ftype, _as_value_list(v))
                        for v in col]
                    offsets = np.zeros(max_doc + 1, dtype=np.uint32)
                    np.cumsum([len(t) for t in per_doc_tokens],
                              out=offsets[1:])
                    values = [t for ts in per_doc_tokens for t in ts]
                elif isinstance(col, tuple):
                    offsets, values = col
                    offsets = np.asarray(offsets, dtype=np.uint32)
                    conv = coerce_bytes if ftype == FieldType.BYTES else str
                    values = [conv(v) for v in values]
                else:
                    conv = coerce_bytes if ftype == FieldType.BYTES else str
                    values = [conv(v) for v in col]
                    offsets = np.arange(max_doc + 1, dtype=np.uint32)
                if ftype == FieldType.BYTES:
                    # the native encoder is str-only; bytes sort raw
                    terms = sorted(set(values))
                    ord_of = {t: i for i, t in enumerate(terms)}
                    ords = [ord_of[v] for v in values]
                else:
                    from ..native import encode_terms
                    terms, ords = encode_terms(values)
                fields[name] = SegmentFieldData(
                    np.asarray(ords, np.uint32), offsets, terms)
            else:
                dtype = numeric_dtype(ftype)
                if isinstance(col, tuple):
                    offsets, values = col
                    fields[name] = SegmentFieldData(
                        np.asarray(values, dtype=dtype),
                        np.asarray(offsets, dtype=np.uint32))
                else:
                    arr = np.asarray(col, dtype=dtype)
                    if card == Cardinality.MULTI:
                        fields[name] = SegmentFieldData(
                            arr, np.arange(max_doc + 1, dtype=np.uint32))
                    else:
                        fields[name] = SegmentFieldData(arr)
        seg = Segment(uuid.uuid4().hex[:12], max_doc, fields)
        block_op = item["opstamp"]
        self._apply_deletes_to_segment(
            seg, buffered_opstamps=np.full(max_doc, block_op, dtype=np.int64))
        return seg

    def _doc_matches_term(self, seg: Segment, field: str, value) -> np.ndarray:
        entry = self._schema.field(field)
        fd = seg.fields[field]
        if entry.type.is_stringy:
            term = (coerce_bytes(value) if entry.type == FieldType.BYTES
                    else str(value))
            try:
                ordv = fd.terms.index(term)
            except ValueError:
                return np.zeros(seg.max_doc, dtype=bool)
            hit_vals = fd.values == np.uint32(ordv)
        else:
            dtype = numeric_dtype(entry.type)
            hit_vals = fd.values == dtype(value)
        if fd.offsets is None:
            return hit_vals
        # CSR: doc matches if any of its values match
        out = np.zeros(seg.max_doc, dtype=bool)
        idx = np.nonzero(hit_vals)[0]
        if idx.size:
            doc_of_val = np.searchsorted(fd.offsets, idx, side="right") - 1
            out[doc_of_val] = True
        return out

    def _apply_deletes_to_segment(self, seg: Segment, buffered_opstamps=None):
        """Apply pending deletes to a freshly built segment, honoring opstamp
        order when the buffered docs' opstamps are known."""
        for field, value, del_op in self._pending_deletes:
            hits = self._doc_matches_term(seg, field, value)
            if buffered_opstamps is not None:
                hits &= np.asarray(buffered_opstamps, dtype=np.int64) < del_op
            if hits.any():
                alive = seg.alive_mask().copy()
                alive &= ~hits
                seg.alive = alive

    def _apply_deletes(self):
        for seg in self._index.segments:
            for field, value, _ in self._pending_deletes:
                hits = self._doc_matches_term(seg, field, value)
                if hits.any():
                    alive = seg.alive_mask().copy()
                    alive &= ~hits
                    seg.alive = alive
            self._index._segment_mutated(seg)
