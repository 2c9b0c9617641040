"""A table's DDL as text, and its logical export as SQL.

Counterpart of tidb_tpu/tools/dump.py: ``create_table_sql``, which SHOW
CREATE TABLE prints (generated columns, CHECK and FOREIGN KEY clauses
with their ON DELETE actions, as the JAX package renders them), and
``dump_table_sql``, the schema and INSERT batches of one table, read at
one pinned version. A partitioned table's PARTITION BY RANGE, LIST or
HASH clause and its TTL clause are rendered as the JAX package renders
them; the CSV format and the command line are not ported.
"""

from __future__ import annotations

import datetime
from typing import List

from tidb_tpu_torch.dtypes import Kind, days_to_date, micros_to_datetime, micros_to_time


def _sql_literal(v, t) -> str:
    if v is None:
        return "NULL"
    if t.kind == Kind.STRING:
        return "'" + str(v).replace("\\", "\\\\").replace("'", "''") + "'"
    if t.kind in (Kind.DATE, Kind.DATETIME, Kind.TIME):
        if isinstance(v, str):
            return f"'{v}'"
        conv = {Kind.DATE: days_to_date, Kind.DATETIME: micros_to_datetime,
                Kind.TIME: micros_to_time}[t.kind]
        return f"'{conv(int(v))}'"
    if t.kind == Kind.BOOL:
        return "1" if v else "0"
    if t.kind == Kind.DECIMAL:
        return f"{v:.{t.scale}f}"
    return str(v)


_TYPE_SQL = {
    Kind.INT: "bigint",
    Kind.FLOAT: "double",
    Kind.BOOL: "boolean",
    Kind.DATE: "date",
    Kind.DATETIME: "datetime",
    Kind.TIME: "time",
    Kind.STRING: "varchar(255)",
}


def create_table_sql(t) -> str:
    parts = []
    for n, ty in t.schema.columns:
        if ty.kind == Kind.DECIMAL:
            decl = f"decimal(38,{ty.scale})"
        else:
            decl = _TYPE_SQL.get(ty.kind, "varchar(255)")
        if n in (t.schema.not_null or ()):
            decl += " not null"
        dflt = (t.defaults or {}).get(n)
        if dflt is not None:
            if isinstance(dflt, str):
                decl += " default " + _sql_literal(dflt, ty)
            elif isinstance(dflt, bool):
                decl += f" default {int(dflt)}"
            elif isinstance(dflt, (int, float)):
                decl += f" default {dflt}"
        if n == t.autoinc_col:
            decl += " auto_increment"
        for gc, gtxt, gstored in t.generated:
            if gc == n:
                decl += f" generated always as ({gtxt}) " + ("stored" if gstored else "virtual")
        parts.append(f"`{n}` {decl}")
    if t.schema.primary_key:
        parts.append("primary key (" + ", ".join(t.schema.primary_key) + ")")
    for iname, cols in sorted(t.indexes.items()):
        kw = "unique index" if iname in t.unique_indexes else "index"
        parts.append(f"{kw} {iname} (" + ", ".join(cols) + ")")
    for nm, txt in t.checks:
        parts.append(f"constraint {nm} check ({txt})")
    for nm, col, rdb, rtbl, rcol in t.fks:
        # the JAX package renders the ON DELETE action only
        suffix = {"cascade": " on delete cascade",
                  "set_null": " on delete set null"}.get(t.fk_actions.get(nm.lower()), "")
        parts.append(f"constraint {nm} foreign key ({col}) references {rdb}.{rtbl} ({rcol}){suffix}")
    opts = _partition_sql(t)
    if getattr(t, "ttl", None):
        col, iv, unit = t.ttl
        opts += f" ttl = {col} + interval {iv} {unit}"
    return f"CREATE TABLE `{t.name}` (\n  " + ",\n  ".join(parts) + f"\n){opts};"


def _partition_sql(t) -> str:
    """A table's PARTITION BY clause, with a leading space, or ''."""
    part = t.partition
    if part is None:
        return ""
    kind, pcol, spec = part
    if kind == "hash":
        return f" partition by hash ({pcol}) partitions {spec}"
    ptype = t.schema.types.get(pcol)

    def bound(u):
        if u is None:
            return "maxvalue"
        if ptype is not None and ptype.kind == Kind.DATE:
            return f"(date '{days_to_date(int(u))}')"
        if ptype is not None and ptype.kind == Kind.DATETIME:
            # sub-second digits kept: a dump and restore must not move rows
            txt = (datetime.datetime(1970, 1, 1) + datetime.timedelta(microseconds=int(u))
                   ).strftime("%Y-%m-%d %H:%M:%S.%f").rstrip("0").rstrip(".")
            return f"('{txt}')"
        if ptype is not None and ptype.kind == Kind.DECIMAL:
            return f"({int(u) / 10**ptype.scale})"
        return f"({u})"

    if kind == "list":
        decls = ", ".join(
            f"partition {n} values in ("
            + ", ".join("null" if v is None else bound(v).strip("()") for v in vals) + ")"
            for n, vals in spec)
        return f" partition by list ({pcol}) ({decls})"
    decls = ", ".join(f"partition {n} values less than {bound(u)}" for n, u in spec)
    return f" partition by range ({pcol}) ({decls})"


def _decoded_rows(t):
    cols = t.schema.names
    types = [ty for _, ty in t.schema.columns]
    version = t.version
    t.pin(version)  # one snapshot
    try:
        for b in t.blocks(version):
            decoded = [b.columns[c].decode() for c in cols]
            for i in range(b.nrows):
                yield [d[i] for d in decoded], types
    finally:
        t.unpin(version)


def dump_table_sql(t, out_path: str, batch_rows: int = 500) -> int:
    """Write a table's schema and INSERT batches; returns the rows
    written. Generated columns are left out of the INSERTs: the restore
    computes them, and an INSERT that writes one is refused."""
    n = 0
    gen = {c for c, *_ in t.generated}
    names = t.schema.names
    keep = [i for i, c in enumerate(names) if c not in gen]
    collist = " (" + ", ".join(f"`{names[i]}`" for i in keep) + ")" if gen else ""
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(create_table_sql(t) + "\n")
        batch: List[str] = []
        for row, types in _decoded_rows(t):
            batch.append("(" + ", ".join(_sql_literal(row[i], types[i]) for i in keep) + ")")
            n += 1
            if len(batch) >= batch_rows:
                f.write(f"INSERT INTO `{t.name}`{collist} VALUES\n" + ",\n".join(batch) + ";\n")
                batch = []
        if batch:
            f.write(f"INSERT INTO `{t.name}`{collist} VALUES\n" + ",\n".join(batch) + ";\n")
    return n
