"""Schema: typed field definitions for the index.

Device-engine analog of tantivy's schema subsystem (SURVEY.md §2.2 T1): fields
are typed (u64/i64/f64/date/keyword), flagged FAST for columnar storage, and
carry a cardinality (single vs multi). In this engine every queryable field
is also a fast field — queries are evaluated as vectorized column compares,
not postings seeks — so the FAST flag is about storage intent parity with
the reference, not a different code path.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field
from enum import Enum
from typing import Dict, List, Optional


class FieldType(str, Enum):
    U64 = "u64"
    I64 = "i64"
    F64 = "f64"
    DATE = "date"  # stored as u64 microseconds since epoch
    KEYWORD = "keyword"  # exact-match string, dictionary-encoded to ordinals
    TEXT = "text"  # tokenized full text; tokens dictionary-encoded (CSR)
    BYTES = "bytes"  # exact-match byte strings, dictionary-encoded (T1)
    FACET = "facet"  # hierarchical paths "/a/b"; ancestors indexed per doc

    @property
    def is_numeric(self) -> bool:
        return self in (FieldType.U64, FieldType.I64, FieldType.F64, FieldType.DATE)

    @property
    def is_stringy(self) -> bool:
        return self in (FieldType.KEYWORD, FieldType.TEXT, FieldType.BYTES,
                        FieldType.FACET)


class Cardinality(str, Enum):
    SINGLE = "single"
    MULTI = "multi"


def stringy_term(ftype: FieldType, v):
    """Canonical coercion of a user-supplied term for a stringy field,
    shared by the writer, the query compiler, and the oracle: BYTES
    accepts bytes or str (utf-8-encoded); everything else coerces str()."""
    if ftype == FieldType.BYTES:
        if isinstance(v, bytes):
            return v
        if isinstance(v, str):
            return v.encode("utf-8")
        raise TypeError(
            f"bytes field value must be bytes or str, got {type(v)!r}")
    return str(v)


@dataclass(frozen=True)
class FieldEntry:
    name: str
    type: FieldType
    cardinality: Cardinality = Cardinality.SINGLE
    fast: bool = True
    indexed: bool = True

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "type": self.type.value,
            "cardinality": self.cardinality.value,
            "fast": self.fast,
            "indexed": self.indexed,
        }

    @staticmethod
    def from_json(d: dict) -> "FieldEntry":
        return FieldEntry(
            name=d["name"],
            type=FieldType(d["type"]),
            cardinality=Cardinality(d["cardinality"]),
            fast=d.get("fast", True),
            indexed=d.get("indexed", True),
        )


@dataclass(frozen=True)
class Schema:
    fields: tuple

    def field(self, name: str) -> FieldEntry:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"field {name!r} not in schema")

    def has_field(self, name: str) -> bool:
        return any(f.name == name for f in self.fields)

    @property
    def field_names(self) -> List[str]:
        return [f.name for f in self.fields]

    def to_json(self) -> list:
        return [f.to_json() for f in self.fields]

    @staticmethod
    def from_json(lst: list) -> "Schema":
        return Schema(tuple(FieldEntry.from_json(d) for d in lst))

    def dumps(self) -> str:
        return json.dumps(self.to_json())

    @staticmethod
    def loads(s: str) -> "Schema":
        return Schema.from_json(json.loads(s))


@dataclass
class SchemaBuilder:
    """Fluent builder mirroring tantivy's SchemaBuilder ergonomics."""

    _fields: List[FieldEntry] = dc_field(default_factory=list)

    def _add(self, name: str, ftype: FieldType, cardinality: Cardinality,
             fast: bool, indexed: bool) -> "SchemaBuilder":
        if any(f.name == name for f in self._fields):
            raise ValueError(f"duplicate field {name!r}")
        self._fields.append(FieldEntry(name, ftype, cardinality, fast, indexed))
        return self

    def add_u64_field(self, name, cardinality=Cardinality.SINGLE, fast=True, indexed=True):
        return self._add(name, FieldType.U64, Cardinality(cardinality), fast, indexed)

    def add_i64_field(self, name, cardinality=Cardinality.SINGLE, fast=True, indexed=True):
        return self._add(name, FieldType.I64, Cardinality(cardinality), fast, indexed)

    def add_f64_field(self, name, cardinality=Cardinality.SINGLE, fast=True, indexed=True):
        return self._add(name, FieldType.F64, Cardinality(cardinality), fast, indexed)

    def add_date_field(self, name, cardinality=Cardinality.SINGLE, fast=True, indexed=True):
        return self._add(name, FieldType.DATE, Cardinality(cardinality), fast, indexed)

    def add_keyword_field(self, name, cardinality=Cardinality.SINGLE, fast=True, indexed=True):
        return self._add(name, FieldType.KEYWORD, Cardinality(cardinality), fast, indexed)

    def add_text_field(self, name, fast=True, indexed=True):
        """Tokenized text (simple tokenizer: lowercase, split on
        non-alphanumeric — tantivy's default analyzer behavior). Token
        ordinals are stored CSR like a multi-valued keyword."""
        return self._add(name, FieldType.TEXT, Cardinality.MULTI, fast, indexed)

    def add_bytes_field(self, name, cardinality=Cardinality.SINGLE, fast=True,
                        indexed=True):
        """Exact-match byte strings (tantivy's bytes fast field, SURVEY.md
        §2.2 T1), dictionary-encoded to ordinals exactly like keyword —
        term order is lexicographic over the raw bytes."""
        return self._add(name, FieldType.BYTES, Cardinality(cardinality),
                         fast, indexed)

    def add_facet_field(self, name, fast=True, indexed=True):
        """Hierarchical facet paths like "/electronics/phones" (SURVEY.md
        §2.2 T1). The writer indexes every ancestor prefix of each path per
        doc (deduplicated), so a TermQuery on "/electronics" matches docs
        faceted anywhere beneath it and facet_agg counts come from plain
        per-ordinal counts. Always multi-valued."""
        return self._add(name, FieldType.FACET, Cardinality.MULTI, fast,
                         indexed)

    def build(self) -> Schema:
        return Schema(tuple(self._fields))
