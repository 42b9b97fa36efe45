"""Index: a set of immutable segments + schema, in RAM or on disk.

Device-engine analog of tantivy's Index/meta.json (SURVEY.md §2.2 T2/T10).
`create_in_ram` is the test fixture path (the reference's RAM-directory
equivalent, SURVEY.md §4); `create`/`open` persist segments to a directory —
the engine's checkpoint/resume story (SURVEY.md §5).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional

import numpy as np

from ..schema import Schema
from .segment import Segment, read_segment, write_segment


class Index:
    def __init__(self, schema: Schema, path: Optional[str] = None):
        self.schema = schema
        self.path = path
        self.segments: List[Segment] = []
        #: bumped whenever segment data changes; device loaders key on it
        self.epoch = 0
        #: automatic compaction policy, consulted after every commit
        #: (IndexWriter.commit -> maybe_merge). None disables.
        from .merge_policy import LogMergePolicy
        self.merge_policy = LogMergePolicy()

    # -- constructors ---------------------------------------------------------

    @staticmethod
    def create_in_ram(schema: Schema) -> "Index":
        return Index(schema, path=None)

    @staticmethod
    def create(path: str, schema: Schema, overwrite: bool = False) -> "Index":
        if os.path.exists(path):
            if overwrite:
                shutil.rmtree(path)
            elif os.listdir(path):
                raise FileExistsError(f"{path} exists and is non-empty")
        os.makedirs(path, exist_ok=True)
        idx = Index(schema, path=path)
        idx._commit_meta()
        return idx

    @staticmethod
    def open(path: str) -> "Index":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        schema = Schema.from_json(meta["schema"])
        idx = Index(schema, path=path)
        for seg_id in meta["segments"]:
            idx.segments.append(
                read_segment(os.path.join(path, f"seg_{seg_id}"), schema))
        return idx

    # -- API ------------------------------------------------------------------

    def writer(self):
        from .writer import IndexWriter
        return IndexWriter(self)

    def searcher(self, **kwargs):
        from ..searcher import Searcher
        return Searcher(self, **kwargs)

    def oracle_searcher(self):
        from ..oracle.engine import OracleSearcher
        return OracleSearcher(self)

    @property
    def max_doc_total(self) -> int:
        return sum(s.max_doc for s in self.segments)

    # -- doc store: reconstruct stored documents from columns -----------------
    # (tantivy's doc store analog; this engine's columns are lossless for
    # fast fields, so retrieval reads them back. TEXT fields return their
    # token lists — original byte-exact text is not retained, documented.)

    def doc(self, segment: int, doc_id: int) -> dict:
        from ..schema import Cardinality, FieldType
        seg = self.segments[segment]
        if not (0 <= doc_id < seg.max_doc):
            raise IndexError(f"doc {doc_id} out of range")
        out = {}
        for entry in self.schema.fields:
            fd = seg.fields[entry.name]
            if entry.type.is_stringy:
                lo, hi = int(fd.offsets[doc_id]), int(fd.offsets[doc_id + 1])
                vals = [fd.terms[int(o)] for o in fd.values[lo:hi]]
                if entry.cardinality == Cardinality.SINGLE:
                    if vals:
                        out[entry.name] = vals[0]
                else:
                    out[entry.name] = vals
            elif fd.offsets is not None:
                lo, hi = int(fd.offsets[doc_id]), int(fd.offsets[doc_id + 1])
                conv = float if entry.type == FieldType.F64 else int
                out[entry.name] = [conv(v) for v in fd.values[lo:hi]]
            else:
                conv = float if entry.type == FieldType.F64 else int
                out[entry.name] = conv(fd.values[doc_id])
        return out

    # -- segment merging (tantivy merge-policy analog, SURVEY.md §2.2 T2) -----

    def merge_segments(self, start: int = 0, count: Optional[int] = None) -> str:
        """Compact the contiguous run segments[start:start+count] into one,
        dropping deleted docs; the merged segment takes the run's position
        (segment order defines global doc order, so merging a contiguous
        run preserves it — doc ids shift only by the dropped deletes).
        Default merges ALL segments. Returns the new segment id."""
        import os
        import shutil
        import uuid
        from ..schema import Cardinality
        from .segment import Segment, SegmentFieldData
        import numpy as np
        if not self.segments:
            raise ValueError("no segments to merge")
        if count is None:
            count = len(self.segments) - start
        if not (0 <= start and count >= 1
                and start + count <= len(self.segments)):
            raise ValueError(f"bad merge run [{start}, {start + count})")
        old = self.segments[start:start + count]
        keep_masks = [s.alive_mask() for s in old]
        new_max = int(sum(m.sum() for m in keep_masks))
        fields = {}
        for entry in self.schema.fields:
            name = entry.name
            if entry.type.is_stringy:
                gterms = sorted(set().union(*[set(s.fields[name].terms or [])
                                              for s in old]))
                ord_of = {t: i for i, t in enumerate(gterms)}
                offs = np.zeros(new_max + 1, np.uint32)
                flat = []
                pos = 0
                for s, keep in zip(old, keep_masks):
                    fd = s.fields[name]
                    so = fd.offsets.astype(np.int64)
                    remap = np.asarray([ord_of[t] for t in (fd.terms or [])],
                                       dtype=np.int64)
                    for d in np.nonzero(keep)[0]:
                        for o in fd.values[so[d]:so[d + 1]]:
                            flat.append(remap[int(o)])
                        pos += 1
                        offs[pos] = len(flat)
                # re-sort the merged table is already sorted (set union)
                # prune unused terms for tantivy-merge parity
                used = sorted(set(flat))
                if len(used) != len(gterms):
                    newmap = {u: i for i, u in enumerate(used)}
                    flat = [newmap[o] for o in flat]
                    gterms = [gterms[u] for u in used]
                fields[name] = SegmentFieldData(
                    np.asarray(flat, np.uint32), offs, gterms)
            elif entry.cardinality == Cardinality.MULTI:
                offs = np.zeros(new_max + 1, np.uint32)
                parts = []
                pos = 0
                total = 0
                for s, keep in zip(old, keep_masks):
                    fd = s.fields[name]
                    so = fd.offsets.astype(np.int64)
                    for d in np.nonzero(keep)[0]:
                        parts.append(fd.values[so[d]:so[d + 1]])
                        total += so[d + 1] - so[d]
                        pos += 1
                        offs[pos] = total
                vals = (np.concatenate(parts) if parts
                        else np.zeros(0, old[0].fields[name].values.dtype))
                fields[name] = SegmentFieldData(vals, offs)
            else:
                parts = [s.fields[name].values[keep]
                         for s, keep in zip(old, keep_masks)]
                fields[name] = SegmentFieldData(np.concatenate(parts))
        seg = Segment(uuid.uuid4().hex[:12], new_max, fields)
        # swap the merged segment into the run's position
        if self.path is not None:
            for s in old:
                shutil.rmtree(os.path.join(self.path, f"seg_{s.id}"),
                              ignore_errors=True)
        tail = self.segments[start + count:]
        self.segments = self.segments[:start]
        self._add_segment(seg)
        self.segments.extend(tail)
        self._commit_meta()
        return seg.id

    def maybe_merge(self) -> List[str]:
        """Apply this index's merge policy (tantivy's IndexWriter merge
        loop analog, SURVEY.md §2.2 T2): repeatedly merge policy-selected
        contiguous runs until none qualifies. Runs synchronously at commit
        (this engine has no background threads by design — segments are
        immutable and searchers snapshot the list). Returns new ids."""
        out = []
        if self.merge_policy is None:
            return out
        while True:
            run = self.merge_policy.select(self.segments)
            if run is None:
                return out
            out.append(self.merge_segments(*run))

    # -- internal hooks used by IndexWriter ------------------------------------

    def _add_segment(self, seg: Segment) -> None:
        self.segments.append(seg)
        self.epoch += 1
        if self.path is not None:
            write_segment(seg, self.schema, os.path.join(self.path, f"seg_{seg.id}"))

    def _segment_mutated(self, seg: Segment) -> None:
        self.epoch += 1
        if self.path is not None:
            write_segment(seg, self.schema, os.path.join(self.path, f"seg_{seg.id}"))

    def _commit_meta(self) -> None:
        self.epoch += 1
        if self.path is None:
            return
        meta = {"schema": self.schema.to_json(),
                "segments": [s.id for s in self.segments]}
        tmp = os.path.join(self.path, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(self.path, "meta.json"))
