"""A table's DDL as text.

Counterpart of tidb_tpu/tools/dump.py, cut to ``create_table_sql``, which
SHOW CREATE TABLE prints. The port's tables carry no CHECK, FOREIGN KEY,
generated column, partitioning or TTL, so the clauses the JAX package
renders for those never arise; the logical export itself is not ported.
"""

from __future__ import annotations

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
        parts.append(f"`{n}` {decl}")
    if t.schema.primary_key:
        parts.append("primary key (" + ", ".join(t.schema.primary_key) + ")")
    for iname, cols in sorted(t.indexes.items()):
        kw = "unique index" if iname in t.unique_indexes else "index"
        parts.append(f"{kw} {iname} (" + ", ".join(cols) + ")")
    return f"CREATE TABLE `{t.name}` (\n  " + ",\n  ".join(parts) + "\n);"
