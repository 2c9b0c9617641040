"""Bulk file loading (LOAD DATA INFILE).

Counterpart of tidb_tpu/storage/loader.py. Reference:
pkg/executor/load_data.go and Lightning's mydump parsers. ``parse_block``
turns text rows into an unappended HostBlock (dbgen's trailing
separator, ``\\N`` and the empty field as NULL); the DXF import's subtasks
share it. ``load_file`` picks the parser as the JAX package does: the
native splitter (storage/native.py, g++ over csrc/loader.cpp) when every
column's kind has a native type code and the separator is one
character, and ``parse_block`` otherwise (DATETIME and TIME columns).
Unlike the JAX package, a failed native build raises: it never falls
back to the Python parser.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from tidb_tpu_torch.chunk import HostBlock, HostColumn, column_from_values
from tidb_tpu_torch.dtypes import STRING, Kind


def _parse_value(text: str, typ):
    if text == "" or text == r"\N":
        return None
    k = typ.kind
    if k == Kind.INT:
        return int(float(text)) if "." in text or "e" in text.lower() else int(text)
    if k in (Kind.FLOAT, Kind.DECIMAL):
        return float(text)
    if k == Kind.BOOL:
        return text.strip().lower() in ("1", "true", "on", "yes")
    return text  # STRING and the temporals: column_from_values parses them


def parse_block(table, lines: List[str], sep: str) -> Optional[HostBlock]:
    """Parse text rows into an unappended HostBlock (None when no row):
    the Encode step of LOAD DATA and of the DXF import's subtasks. The
    values are the JAX package's ``_parse_value`` of each field, taken a
    column at a time."""
    names = table.schema.names
    types = [t for _, t in table.schema.columns]
    k = len(names)
    rows = [ln.split(sep) for ln in (ln.rstrip("\n").rstrip("\r") for ln in lines) if ln]
    if not rows:
        return None
    widths = set(map(len, rows))
    # every line of k fields, or each ending in dbgen's trailing separator
    # (the columns below take the first k), else row by row
    if widths != {k} and not (widths == {k + 1} and all(r[-1] == "" for r in rows)):
        for r in rows:
            if r[-1] == "" and len(r) == k + 1:
                r.pop()  # dbgen's trailing separator
            elif len(r) != k:
                raise ValueError(f"row has {len(r)} fields, table {table.name} has {k}")
    return HostBlock.from_columns({
        name: _encode_texts(texts) if typ.kind == Kind.STRING
        else column_from_values(_parse_column(texts, typ), typ)
        for name, texts, typ in zip(names, zip(*rows), types)})


_NULL_TEXTS = ("", r"\N")


def _encode_texts(texts) -> HostColumn:
    """A string column's fields as ``encode_strings`` encodes their
    ``_parse_value`` (the empty field and ``\\N`` are NULL): one sort of
    the distinct fields, then the NULL spellings taken out of it."""
    uniq = sorted(set(texts))
    lookup = {v: i for i, v in enumerate(uniq)}
    codes = np.fromiter(map(lookup.__getitem__, texts), dtype=np.int64, count=len(texts))
    nulls = np.array(sorted(lookup[v] for v in _NULL_TEXTS if v in lookup), dtype=np.int64)
    valid = np.ones(len(codes), dtype=bool)
    if len(nulls):
        valid = ~np.isin(codes, nulls)
        codes -= np.searchsorted(nulls, codes, side="right")
        codes[~valid] = 0
        uniq = [v for v in uniq if v not in _NULL_TEXTS]
    return HostColumn(STRING, codes.astype(np.int32), valid, np.array(uniq, dtype=object))


def _parse_column(texts: List[str], typ) -> list:
    """``_parse_value`` over one column's fields."""
    k = typ.kind
    null = _NULL_TEXTS
    if k == Kind.INT:
        try:
            return [None if t in null else int(t) for t in texts]
        except ValueError:
            return [_parse_value(t, typ) for t in texts]
    if k in (Kind.FLOAT, Kind.DECIMAL):
        return [None if t in null else float(t) for t in texts]
    if k == Kind.BOOL:
        return [_parse_value(t, typ) for t in texts]
    return [None if t in null else t for t in texts]


def load_rows_python(table, lines: List[str], sep: str) -> int:
    block = parse_block(table, lines, sep)
    if block is None:
        return 0
    table.append_block(block)
    return block.nrows


def read_file(table, path: str, sep: str = "\t") -> Optional[HostBlock]:
    """A delimited file as one unappended block (None when it holds no
    row), parsed by the native splitter where it applies."""
    from tidb_tpu_torch.storage import native

    if native.applies(table, sep):
        return native.parse_file(table, path, sep)
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return parse_block(table, f.readlines(), sep)


def load_file(table, path: str, sep: str = "\t") -> int:
    """Load a delimited file into `table`; returns the rows appended."""
    block = read_file(table, path, sep)
    if block is None:
        return 0
    table.append_block(block)
    return block.nrows
