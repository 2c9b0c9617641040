"""Carry tables across from the JAX package as plain numpy arrays.

``catalog_from_numpy`` builds the port's ``Catalog`` from tables given
per column as (data, validity, string dictionary) arrays plus the
schema's types and constraints, so both engines can load identical data
and write to it alike; ``add_table`` adds one such table to a catalog. Types are the port's ``SQLType`` or a ``(kind,
scale, collation)`` tuple whose kind is a ``Kind`` value string ("int",
"decimal", "string", ...). ``table_state`` reads a table's current
state back as numpy from either package's ``Table``, so that tests can
hold the two packages' storage against each other array for array.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from tidb_tpu_torch.chunk import HostBlock, HostColumn
from tidb_tpu_torch.dtypes import Kind, SQLType
from tidb_tpu_torch.storage.catalog import Catalog
from tidb_tpu_torch.storage.table import TableSchema


def sql_type(t) -> SQLType:
    if isinstance(t, SQLType):
        return t
    kind, scale, collation = t
    return SQLType(Kind(kind), int(scale), collation)


def catalog_from_numpy(dbs: Dict[str, Dict[str, dict]]) -> Catalog:
    """``dbs``: {db: {table: {"columns": [(name, type)], "primary_key":
    [names] or None, "data": {name: (data, valid, dictionary or None)},
    and optionally "not_null": [names], "defaults": {name: value},
    "autoinc_col": name, "autoinc_next": int}}}. Each table becomes one
    block; arrays are copied in their physical dtypes."""
    cat = Catalog()
    for db, tables in dbs.items():
        cat.create_database(db, if_not_exists=True)
        for name, spec in tables.items():
            add_table(cat, db, name, spec)
    return cat


def add_table(cat: Catalog, db: str, name: str, spec: dict):
    """Create table `name` in `cat`'s database `db` from one table spec of
    ``catalog_from_numpy`` (a string column's dictionary sorted, its codes
    indexing it), as one block. Returns the table."""
    columns = [(n, sql_type(t)) for n, t in spec["columns"]]
    schema = TableSchema(
        columns, primary_key=spec.get("primary_key"),
        not_null=tuple(spec.get("not_null") or ()),
    )
    cols = {}
    for n, typ in columns:
        data, valid, dictionary = spec["data"][n]
        cols[n] = HostColumn(
            typ,
            np.array(data, dtype=typ.np_dtype),
            np.array(valid, dtype=bool),
            None if dictionary is None else np.array(dictionary, dtype=object),
        )
    t = cat.create_table(db, name, schema)
    t.dictionaries.update({n: c.dictionary for n, c in cols.items() if c.dictionary is not None})
    t.replace_blocks([HostBlock.from_columns(cols)] if cols else [])
    t.defaults = dict(spec.get("defaults") or {})
    t.autoinc_col = spec.get("autoinc_col")
    t.autoinc_next = int(spec.get("autoinc_next", 1))
    return t


def table_state(table) -> dict:
    """A table's current state as numpy, from the port's ``Table`` or the
    JAX package's (both keep blocks per version and one dictionary per
    string column): per column (data, validity, dictionary or None) over
    the concatenated blocks, plus ``autoinc_next`` and
    ``modify_count``."""
    blocks = table.blocks()
    cols = {}
    for n, typ in table.schema.columns:
        cs = [b.columns[n] for b in blocks]
        cols[n] = (
            np.concatenate([c.data for c in cs]) if cs else np.zeros(0, dtype=typ.np_dtype),
            np.concatenate([c.valid for c in cs]) if cs else np.zeros(0, dtype=bool),
            None if n not in table.dictionaries else np.array(table.dictionaries[n], dtype=object),
        )
    return {
        "columns": cols,
        "autoinc_next": int(table.autoinc_next),
        "modify_count": int(table.modify_count),
    }
