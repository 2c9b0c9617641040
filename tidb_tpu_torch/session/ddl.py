"""DDL over existing tables: indexes, RENAME TABLE and ALTER TABLE, and
the generated-column machinery.

Counterpart of tidb_tpu/session/ddl.py and of the CREATE/DROP INDEX,
RENAME TABLE, ALTER TABLE and multi-spec ALTER branches of the JAX
session. A mixin of ``Session``: every method runs in a session's
context (its catalog, database and statement state).

CREATE INDEX climbs the online schema-state ladder WRITE_ONLY ->
WRITE_REORG -> PUBLIC (writers check an index from its first state,
readers use it once public) and rolls the registration back when a
UNIQUE index finds duplicates. The JAX ladder's ``ddl/index-*`` and
``ddl/modify-column-*`` failpoints are left out on purpose: the port's
DDL sites are ``ddl/create-index``, ``ddl/alter-table``,
``ddl/rename-table`` and ``ddl/generated-recompute``. Column DDL is refused where a CHECK, a
generated column or a FOREIGN KEY depends on the column
(``_guard_column_refs``). Generated columns
(STORED and VIRTUAL alike) are computed row by row on the host when
rows are written (``_fill_generated``) and over the whole table after
ALTER TABLE ... ADD ... AS or a MODIFY of an input
(``_recompute_generated``).

Partitioning: a CREATE TABLE's PARTITION BY clause is encoded into the
table's raw domain (``_encode_partition``); ALTER TABLE ... ADD, DROP and
TRUNCATE PARTITION run over ``Table.alter_add_partitions`` and
``alter_drop_partitions`` (DROP and TRUNCATE apply the children's ON
DELETE actions, as a DELETE does), and EXCHANGE PARTITION swaps a
partition's blocks with an unpartitioned table's of the same definition
(``_run_exchange_partition``). Partition DDL other than ADD is refused
inside a transaction.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tidb_tpu_torch.dtypes import Kind
from tidb_tpu_torch.parser import ast
from tidb_tpu_torch.storage import convert as CV
from tidb_tpu_torch.utils.checkeval import (
    CheckEvalError, check_columns, eval_check, validate_expr_ops,
)
from tidb_tpu_torch.utils.failpoint import inject

#: ALTER TABLE actions that manage partitions: none combines with another
#: spec, and those that remove or move rows take the table locks and are
#: refused inside a transaction
PARTITION_ACTIONS = ("add_partition", "drop_partition", "truncate_partition",
                     "exchange_partition")
PARTITION_WRITES = ("drop_partition", "truncate_partition", "exchange_partition")


def coerce_default(v, typ):
    """A DEFAULT literal coerced to a column's kind, or None when it does
    not convert (the JAX package's ``_gen_coerce``)."""
    if v is None:
        return None
    k = typ.kind
    try:
        if k == Kind.STRING:
            return v if isinstance(v, str) else str(v)
        if k == Kind.BOOL:
            return bool(v)
        if k == Kind.INT:
            return int(round(float(v))) if not isinstance(v, bool) else int(v)
        if k in (Kind.DECIMAL, Kind.FLOAT):
            return float(v)
    except (ValueError, TypeError):
        return None
    return v


class DDLMixin:
    # -- column DDL guards ----------------------------------------------------
    def _guard_column_refs(self, t, db, tname, cn: str, verb: str) -> None:
        """Refuse column DDL (`verb`: drop, rename, modify) that would
        break a CHECK, a generated column (not a MODIFY: that recomputes
        its dependents) or a FOREIGN KEY on either side."""
        for nm, ex in self._check_exprs_for(t):
            if cn in check_columns(ex):
                raise ValueError(f"cannot {verb} column {cn!r}: used by CHECK {nm!r}")
        if verb != "modify":
            for gc, ex in self._gen_exprs_for(t):
                if cn in check_columns(ex):
                    raise ValueError(f"cannot {verb} column {cn!r}: used by generated column {gc!r}")
        for nm, col, _rdb, _rtbl, _rcol in t.fks:
            if cn == col:
                raise ValueError(f"cannot {verb} column {cn!r}: used by FOREIGN KEY {nm!r}")
        for cdb, ctn, nm, _c, rcol, _act in self._fk_children(db, tname):
            if cn == rcol:
                raise ValueError(
                    f"cannot {verb} column {cn!r}: referenced by FOREIGN KEY {nm!r} on {cdb}.{ctn}")

    # -- generated columns ----------------------------------------------------
    def _validate_generated(self, s, auto, colnames):
        """A CREATE TABLE's generated-column clauses checked; returns the
        [(column, expression text, stored)] metadata in definition order
        (an evaluation order: a generated column may read only earlier
        ones)."""
        if not any(c.generated is not None for c in s.columns):
            return []
        ai_name = auto[0].name.lower() if auto else None
        gen_names = {c.name.lower() for c in s.columns if c.generated is not None}
        base_cols = colnames - gen_names
        pk_cols = {p.lower() for p in s.primary_key}
        earlier: set = set()
        meta = []
        for c in s.columns:
            n = c.name.lower()
            if c.generated is None:
                continue
            txt, expr, stored = c.generated
            try:
                validate_expr_ops(expr)
            except CheckEvalError as ex:
                raise ValueError(f"generated column {n!r}: {ex}") from None
            deps = check_columns(expr)
            bad = deps - base_cols - earlier
            if bad:
                raise ValueError(
                    f"generated column {n!r} references unknown or "
                    f"later generated columns {sorted(bad)}")
            if ai_name is not None and ai_name in deps:
                raise ValueError(f"generated column {n!r} cannot depend on the AUTO_INCREMENT column")
            if c.default is not None:
                raise ValueError(f"generated column {n!r} cannot have a DEFAULT value")
            if c.auto_increment:
                raise ValueError(f"generated column {n!r} cannot be AUTO_INCREMENT")
            if not stored and n in pk_cols:
                raise ValueError(
                    "virtual generated column cannot be a PRIMARY KEY (make it STORED)")
            earlier.add(n)
            meta.append((n, txt, bool(stored)))
        return meta

    def _gen_exprs_for(self, t):
        """[(column, parsed expression)] of a table's generated columns,
        parsed once."""
        from tidb_tpu_torch.parser.sqlparse import parse_expr

        cache = getattr(t, "_gen_exprs", None)
        if cache is None or len(cache) != len(t.generated):
            cache = t._gen_exprs = [(col, parse_expr(txt)) for col, txt, _st in t.generated]
        return cache

    def _fill_generated(self, t, rows) -> None:
        """Compute the generated columns of Python rows in place, in
        definition order, so a later one reads the earlier ones. A row is
        a full list in schema order or a dict column -> value."""
        gen = self._gen_exprs_for(t)
        if not gen or not rows:
            return
        names = t.schema.names
        types = t.schema.types
        idx = {n: i for i, n in enumerate(names)}
        for r in rows:
            vals = r if isinstance(r, dict) else dict(zip(names, r))
            for col, ex in gen:
                v = coerce_default(eval_check(ex, vals), types[col])
                vals[col] = v
                if vals is not r:
                    r[idx[col]] = v

    def _reject_generated_targets(self, t, cols, verb: str) -> None:
        hit = {c for c, _txt, _st in t.generated} & set(cols)
        if hit:
            raise ValueError(f"cannot {verb} generated column(s) {sorted(hit)}")

    def _recompute_generated(self, t) -> None:
        """Every generated column over the whole table again, from its
        decoded rows (the JAX package's row-at-a-time rewrite): after
        ALTER TABLE ... ADD ... AS and after a MODIFY of an input."""
        inject("ddl/generated-recompute")
        gen = self._gen_exprs_for(t)
        if not gen or not t.blocks():
            return
        names = t.schema.names
        rows = []
        for b in t.blocks():
            decs = [b.columns[n].decode() for n in names]
            vals = [b.columns[n].valid for n in names]
            for k in range(b.nrows):
                rows.append([decs[c][k] if vals[c][k] else None for c in range(len(names))])
        self._fill_generated(t, rows)
        saved_blocks, saved_dicts = list(t.blocks()), dict(t.dictionaries)
        t.replace_blocks([], modified_rows=len(rows))
        try:
            if rows:
                t.append_rows(rows)
        except Exception:
            t.replace_blocks(saved_blocks, modified_rows=len(rows))
            t.dictionaries = saved_dicts
            raise
        finally:
            self._drop_cached(invalidate=[t])

    def _alter_add_generated(self, t, s) -> None:
        """ALTER TABLE ADD COLUMN ... [GENERATED ALWAYS] AS (expr): the
        expression checked against the existing columns, the rule
        installed and the stored rows backfilled."""
        cd = s.column
        n = cd.name.lower()
        txt, expr, stored = cd.generated
        if s.default is not None or cd.default is not None:
            raise ValueError(f"generated column {n!r} cannot have a DEFAULT value")
        try:
            validate_expr_ops(expr)
        except CheckEvalError as ex:
            raise ValueError(f"generated column {n!r}: {ex}") from None
        deps = check_columns(expr)
        bad = deps - set(t.schema.names)
        if bad:
            raise ValueError(f"generated column {n!r} references unknown columns {sorted(bad)}")
        if t.autoinc_col and t.autoinc_col in deps:
            raise ValueError(f"generated column {n!r} cannot depend on the AUTO_INCREMENT column")
        # every existing generated column is defined earlier, so the list
        # stays in evaluation order
        t.alter_add_column(cd.name, cd.type, None)
        t.generated = list(t.generated) + [(n, txt, bool(stored))]
        t._gen_exprs = None
        self._recompute_generated(t)

    # -- indexes -----------------------------------------------------------
    def _add_index(self, t, name: str, columns, unique: bool = False) -> None:
        """ADD INDEX through WRITE_ONLY (writers maintain and check it,
        readers ignore it), WRITE_REORG (the backfill: a UNIQUE index's
        duplicate check over the stored rows, then the sorted index of
        its leading column built) and PUBLIC (the planner may read it). A
        failed backfill removes the registration."""
        iname = name.lower()
        if iname in t.indexes:
            raise ValueError(f"index {name} already exists")
        cols = [c.lower() for c in columns]
        unknown = set(cols) - set(t.schema.names)
        if unknown:
            raise ValueError(f"unknown columns {sorted(unknown)}")
        with t._lock:
            t.indexes[iname] = cols
            t.index_states[iname] = "write_only"
            if unique:
                t.unique_indexes.add(iname)
        try:
            t.index_states[iname] = "write_reorg"
            if unique:
                if len(cols) == 1:
                    svals, _perm, nvalid = t._sorted_index(cols[0])
                    dup = nvalid and len(np.unique(svals[:nvalid])) != nvalid
                else:
                    sv = t._sorted_composite(tuple(cols))
                    dup = sv is not None and len(sv) > 1 and bool((sv[1:] == sv[:-1]).any())
                if dup:
                    raise ValueError(
                        f"cannot create unique index {name}: duplicate "
                        f"entries in columns ({', '.join(cols)})")
            t._sorted_index(cols[0])
        except BaseException:
            with t._lock:
                t.indexes.pop(iname, None)
                t.index_states.pop(iname, None)
                t.unique_indexes.discard(iname)
            raise
        t.index_states[iname] = "public"
        # a transaction whose shadow predates the index conflicts at
        # commit instead of installing rows never checked against it
        t.bump_version()

    def _run_create_index(self, s: ast.CreateIndex) -> None:
        inject("ddl/create-index")
        t = self.catalog.table(s.db or self.db, s.table)
        if s.name.lower() in t.indexes:
            if not s.if_not_exists:
                raise ValueError(f"index {s.name} already exists")
            return
        self._add_index(t, s.name, s.columns, unique=s.unique)
        self.catalog.schema_version += 1
        self._drop_cached(invalidate=[t])

    def _run_drop_index(self, s: ast.DropIndex) -> None:
        t = self.catalog.table(s.db or self.db, s.table)
        iname = s.name.lower()
        if iname not in t.indexes:
            if not s.if_exists:
                raise ValueError(f"unknown index {s.name}")
            return
        del t.indexes[iname]
        t.index_states.pop(iname, None)
        t.unique_indexes.discard(iname)
        t.invisible_indexes.discard(iname)
        t.bump_version()
        self.catalog.schema_version += 1
        self._drop_cached(invalidate=[t])

    # -- partitions -------------------------------------------------------------
    def _encode_partition(self, schema, part):
        """A PARTITION BY clause as table metadata, raw-encoded: RANGE
        bounds as days for DATE, micros for DATETIME and scaled integers
        for DECIMAL; a HASH count; LIST value sets, NULL in at most one
        partition. MAXVALUE may only close a RANGE ladder."""
        from tidb_tpu_torch.dtypes import date_to_days, datetime_to_micros
        from tidb_tpu_torch.planner.logical import ExprBinder

        kind, pcol, spec = part
        pcol = pcol.lower()
        ptype = schema.types.get(pcol)
        if ptype is None:
            raise ValueError(f"unknown partition column {pcol!r}")
        if ptype.kind not in (Kind.INT, Kind.DATE, Kind.DATETIME, Kind.DECIMAL):
            raise ValueError(
                "partitioning needs an integer-encoded column "
                f"({pcol!r} is {ptype.kind.value})")
        if kind == "hash":
            n = int(spec)
            if n < 1:
                raise ValueError("PARTITIONS must be >= 1")
            return ("hash", pcol, n)

        def enc_const(upper, what):
            c = ExprBinder._const_arg(upper)
            if c is None:
                raise ValueError(f"{what} expects a constant")
            v = c.value
            if v is None:
                return None
            if ptype.kind == Kind.DATE and isinstance(v, str):
                return int(date_to_days(v))
            if ptype.kind == Kind.DATETIME and isinstance(v, str):
                return int(datetime_to_micros(v))
            if ptype.kind == Kind.DECIMAL:
                return round(float(v) * 10**ptype.scale)
            return int(v)

        if kind == "list":
            parts, seen = [], {}
            for pname, item in spec:
                if not (isinstance(item, tuple) and item[0] == "in"):
                    raise ValueError("LIST partitions need VALUES IN (...)")
                vals = []
                for e in item[1]:
                    enc = enc_const(e, "VALUES IN")
                    if enc in seen:
                        raise ValueError(
                            f"list value {enc!r} appears in partitions "
                            f"{seen[enc]!r} and {pname.lower()!r}")
                    seen[enc] = pname.lower()
                    vals.append(enc)
                parts.append((pname.lower(), tuple(vals)))
            return ("list", pcol, parts)
        parts, prev = [], None
        for pname, upper in spec:
            if isinstance(upper, tuple) and upper and upper[0] == "in":
                raise ValueError("VALUES IN requires PARTITION BY LIST")
            enc = None
            if upper is not None:
                enc = enc_const(upper, "VALUES LESS THAN")
                if enc is None:
                    raise ValueError("VALUES LESS THAN bound cannot be NULL")
                if prev is not None and enc <= prev:
                    raise ValueError("VALUES LESS THAN must be strictly increasing")
                prev = enc
            parts.append((pname.lower(), enc))
        nones = [i for i, (_n, u) in enumerate(parts) if u is None]
        if nones and nones != [len(parts) - 1]:
            raise ValueError("MAXVALUE must be the last partition")
        return ("range", pcol, parts)

    def _run_partition_ddl(self, t, s: ast.AlterTable) -> None:
        """ALTER TABLE ... ADD, DROP, TRUNCATE or EXCHANGE PARTITION. The
        rows DROP and TRUNCATE remove go as a DELETE's do: the children's
        ON DELETE actions apply against the rows left, and a RESTRICT
        anywhere restores every table and the defs."""
        db = s.db or self.db
        if s.action == "add_partition":
            if t.partition is None or t.partition[0] not in ("range", "list"):
                raise ValueError("ADD PARTITION requires a RANGE- or LIST-partitioned table")
            enc = self._encode_partition(t.schema, (t.partition[0], t.partition[1], s.partitions))
            t.alter_add_partitions(enc[2])
            return
        if self._txn is not None:
            raise ValueError("partition DDL is not allowed inside a transaction; COMMIT first")
        if s.action == "exchange_partition":
            self._run_exchange_partition(t, s)
            return
        children = self._fk_children(db, s.name)
        undo: list = []
        self._fk_undo_snapshot(undo, t)
        saved_defs = t.partition
        removed = t.alter_drop_partitions(s.partitions,
                                          truncate_only=s.action == "truncate_partition")
        try:
            if children and removed:
                self._enforce_parent_constraints(db, s.name, {
                    rc: self._table_keyset(t, rc) for rc in self._parent_need(t, db, children)},
                    actions=True, undo=undo)
        except BaseException:
            self._fk_undo_restore(undo)
            t.partition = saved_defs  # the undo restores blocks only
            raise
        finally:
            self._drop_cached(invalidate=[u[0] for u in undo])

    @staticmethod
    def _exchange_schema_mismatch(t, nt):
        """The first difference of definition that forbids an exchange,
        or None."""
        if nt.partition is not None:
            return "the WITH TABLE side must be unpartitioned"
        if list(t.schema.columns) != list(nt.schema.columns):
            return "column definitions differ"
        if (t.schema.primary_key or None) != (nt.schema.primary_key or None):
            return "PRIMARY KEY definitions differ"
        if set(t.schema.not_null) != set(nt.schema.not_null):
            return "NOT NULL sets differ"
        if (t.schema.enums or {}) != (nt.schema.enums or {}):
            return "ENUM domains differ"
        if (t.schema.sets or {}) != (nt.schema.sets or {}):
            return "SET domains differ"
        if t.indexes != nt.indexes or t.unique_indexes != nt.unique_indexes:
            return "index definitions differ"
        if t.generated != nt.generated:
            return "generated column definitions differ"
        if [c for _n, c in t.checks] != [c for _n, c in nt.checks]:
            return "CHECK constraints differ"
        if t.autoinc_col != nt.autoinc_col:
            return "AUTO_INCREMENT columns differ"
        return None

    def _run_exchange_partition(self, t, s: ast.AlterTable) -> None:
        """ALTER TABLE pt EXCHANGE PARTITION p WITH TABLE nt [WITH |
        WITHOUT VALIDATION]: the partition's blocks and the plain table's
        change places, after their definitions prove equal and (WITH
        VALIDATION, the default) every incoming row routes to p. Blocks
        cross dictionary spaces through each side's dictionary alignment;
        a uniqueness conflict with the rest of pt refuses the exchange,
        and any failure restores both tables."""
        tdb, tname, validate = s.exchange
        db = s.db or self.db
        tdb = tdb or db
        pname = s.partitions[0]
        if t.partition is None:
            raise ValueError("EXCHANGE PARTITION requires a partitioned table")
        names = t.partition_names()
        if pname not in names:
            raise ValueError(f"unknown partition {pname!r}")
        pid = names.index(pname)
        nt = self.catalog.table(tdb, tname)
        why = self._exchange_schema_mismatch(t, nt)
        if why is not None:
            raise ValueError(f"tables have different definitions: {why}")
        if t.fks or nt.fks or self._fk_children(db, s.name) or self._fk_children(tdb, tname):
            raise ValueError(
                "EXCHANGE PARTITION is not allowed on tables with foreign keys (MySQL parity)")
        pcol = t.partition[1]
        if validate:
            mismatch = ValueError(
                f"found a row that does not match the partition {pname!r} "
                "(use WITHOUT VALIDATION to skip)")
            null_pid = t.null_partition()
            for b in nt.blocks():
                c = b.columns[pcol]
                pid_of = np.zeros(b.nrows, dtype=np.int64)
                if c.valid.any():
                    try:
                        pid_of[c.valid] = t.partition_of(c.data[c.valid])
                    except ValueError:
                        # a value no partition lists is a mismatch for p
                        raise mismatch from None
                if ((c.valid & (pid_of != pid)) | (~c.valid & (null_pid != pid))).any():
                    raise mismatch
        undo: list = []
        self._fk_undo_snapshot(undo, t)
        self._fk_undo_snapshot(undo, nt)
        try:
            # alignment can shift codes handed out earlier: grow each
            # side's dictionaries to their final superset first, then remap
            for b in nt.blocks():
                t._align_dictionaries(b)
            moved_in = [dataclasses.replace(t._align_dictionaries(b), part_id=pid)
                        for b in nt.blocks()]
            pt_blocks = []
            for b in t.blocks():
                pt_blocks.extend(t.split_by_partition(b) if b.part_id is None else [b])
            keep = [b for b in pt_blocks if b.part_id != pid]
            out = [b for b in pt_blocks if b.part_id == pid]
            self._exchange_check_unique(t, keep, moved_in)
            for b in out:
                nt._align_dictionaries(b)
            moved_out = [dataclasses.replace(nt._align_dictionaries(b), part_id=None)
                         for b in out]
            n = sum(b.nrows for b in moved_in) + sum(b.nrows for b in moved_out)
            t.replace_blocks(keep + moved_in, modified_rows=n)
            nt.replace_blocks(moved_out, modified_rows=n)
            if t.autoinc_col:
                # both allocators stay ahead of both images
                t.autoinc_next = nt.autoinc_next = max(t.autoinc_next, nt.autoinc_next)
        except BaseException:
            self._fk_undo_restore(undo)
            raise
        finally:
            self._drop_cached(invalidate=[t, nt])

    @staticmethod
    def _exchange_check_unique(t, keep, moved_in) -> None:
        """Incoming rows must not collide with the rest of the table on
        the PRIMARY KEY or a UNIQUE index. Each side is unique already,
        so only the intersection needs checking, in t's encoded domain."""
        uniq = [(f"unique index {i!r}", list(t.indexes[i]))
                for i in sorted(t.unique_indexes) if t.indexes.get(i)]
        if t.schema.primary_key:
            uniq.append(("primary key", list(t.schema.primary_key)))
        for label, cols in uniq:
            sides = []
            for blocks in (keep, moved_in):
                mats = [m for b in blocks if b.nrows
                        for m in [t._key_matrix(b.columns, cols)] if len(m)]
                sides.append(t._rows_view(np.vstack(mats)) if mats else None)
            if sides[0] is None or sides[1] is None:
                continue
            if np.intersect1d(sides[0], sides[1]).size:
                raise ValueError(
                    f"EXCHANGE PARTITION would create a duplicate entry for {label} "
                    f"({', '.join(cols)})")

    # -- RENAME TABLE --------------------------------------------------------
    def _run_rename_table(self, s: ast.RenameTable) -> None:
        """Atomic over its pairs: a later pair's failure moves the earlier
        ones back. The renamed tables' device columns are released."""
        inject("ddl/rename-table")
        done, moved = [], []
        try:
            for (sdb, sname), (ddb, dname) in s.pairs:
                self.catalog.rename_table(sdb or self.db, sname, ddb or self.db, dname)
                done.append(((sdb or self.db, sname), (ddb or self.db, dname)))
                moved.append(self.catalog.table(ddb or self.db, dname))
        except Exception:
            for (sdb, sname), (ddb, dname) in reversed(done):
                self.catalog.rename_table(ddb, dname, sdb, sname)
            raise
        self._drop_cached(release=moved)

    # -- ALTER TABLE -----------------------------------------------------------
    def _run_alter_table(self, s: ast.AlterTable) -> None:
        inject("ddl/alter-table")
        t = self.catalog.table(s.db or self.db, s.name)
        if s.action in PARTITION_ACTIONS:
            self._run_partition_ddl(t, s)
        elif s.action == "add" and s.column.generated is not None:
            self._alter_add_generated(t, s)
        elif s.action == "add":
            default = s.default
            coerced = None
            if s.default is not None:
                # checked before any change: an invalid default leaves
                # no half-added column behind
                coerced = coerce_default(s.default, s.column.type)
                if coerced is None:
                    raise ValueError(f"Invalid default value for {s.column.name!r}")
                default = coerced
            if default is None and s.column.not_null:
                # MySQL fills the type's zero for a NOT NULL column
                default = "" if s.column.type.kind == Kind.STRING else 0
            t.alter_add_column(s.column.name, s.column.type, default)
            if coerced is not None:
                t.defaults[s.column.name.lower()] = coerced
        elif s.action in ("modify", "change"):
            self._run_modify_column(t, s)
        elif s.action == "index_visibility":
            iname = s.col_name.lower()
            if iname not in t.indexes:
                raise ValueError(f"unknown index {iname!r}")
            if s.new_name == "invisible":
                t.invisible_indexes.add(iname)
            else:
                t.invisible_indexes.discard(iname)
            t.bump_version()
        elif s.action == "set_default":
            cn = s.col_name.lower()
            if cn not in t.schema.types:
                raise ValueError(f"unknown column {cn!r}")
            coerced = coerce_default(s.default, t.schema.types[cn])
            if coerced is None and s.default is not None:
                raise ValueError(f"Invalid default value for {cn!r}")
            t.defaults[cn] = coerced
            t.bump_version()
        elif s.action == "drop_default":
            cn = s.col_name.lower()
            if cn not in t.schema.types:
                raise ValueError(f"unknown column {cn!r}")
            t.defaults.pop(cn, None)
            t.bump_version()
        elif s.action == "rename_col":
            self._guard_column_refs(t, s.db or self.db, s.name, s.col_name.lower(), "rename")
            t.alter_rename_column(s.col_name, s.new_name)
        elif s.action == "rename":
            self.catalog.rename_table(s.db or self.db, s.name, s.db or self.db, s.new_name)
        else:  # drop
            cn = s.col_name.lower()
            self._guard_column_refs(t, s.db or self.db, s.name, cn, "drop")
            t.alter_drop_column(s.col_name)
            if any(g[0] == cn for g in t.generated):
                # dropping a generated column removes its rule
                t.generated = [g for g in t.generated if g[0] != cn]
                t._gen_exprs = None
        self.catalog.schema_version += 1
        # a renamed table's columns are released, as RENAME TABLE's are
        self._drop_cached(release=[t] if s.action == "rename" else (), invalidate=[t])

    def _run_modify_column(self, t, s: ast.AlterTable) -> None:
        """MODIFY / CHANGE COLUMN. A change within a kind (and a
        DECIMAL's scale) is metadata only, plus the rename; any other
        converts every block (``Table.alter_modify_column``), and a UNIQUE
        index over the column is checked again after the conversion, so
        a narrowing that merges two values aborts with no visible state."""
        old_name = (s.col_name or s.column.name).lower()
        new_name = s.column.name.lower()
        types = t.schema.types
        if old_name not in types:
            raise ValueError(f"unknown column {old_name!r}")
        self._reject_generated_targets(t, [old_name], "MODIFY")
        if s.column.generated is not None:
            raise ValueError("cannot convert a column to GENERATED with MODIFY/CHANGE")
        if new_name != old_name:
            # a rename would orphan a dependent expression's text: refused
            # on both paths before anything is published
            for gc, ex in self._gen_exprs_for(t):
                if old_name in check_columns(ex):
                    raise ValueError(
                        f"cannot rename column {old_name!r}: used by generated column {gc!r}")
        if new_name != old_name and new_name in types:
            raise ValueError(f"column {new_name!r} exists")
        old_t, new_t = types[old_name], s.column.type
        if (old_name in (t.schema.enums or {}) or old_name in (t.schema.sets or {})
                or old_name in t.schema.json_cols):
            raise ValueError("MODIFY COLUMN on ENUM/SET/JSON columns is not supported")
        if s.column.not_null:
            for b in t.blocks():
                if not bool(b.columns[old_name].valid.all()):
                    raise ValueError(f"column {old_name!r} contains NULLs: cannot add NOT NULL")
        if CV.meta_only(old_t, new_t):
            if new_name != old_name:
                self._guard_column_refs(t, s.db or self.db, s.name, old_name, "rename")
                t.alter_rename_column(old_name, new_name)
            else:
                t.bump_version()
        else:
            self._guard_column_refs(t, s.db or self.db, s.name, old_name, "modify")
            pk = t.schema.primary_key
            if pk and old_name in pk:
                raise ValueError(
                    "MODIFY COLUMN with data conversion on a PRIMARY KEY column is not supported")

            def validate(new_blocks):
                for iname in list(t.unique_indexes):
                    cols = [new_name if c == old_name else c for c in (t.indexes.get(iname) or [])]
                    if new_name not in cols or not new_blocks:
                        continue
                    datas = [np.concatenate([b.columns[c].data for b in new_blocks])
                             for c in cols]
                    valid = np.logical_and.reduce(
                        [np.concatenate([b.columns[c].valid for b in new_blocks]) for c in cols])
                    keyed = [d[valid] for d in datas]
                    if len(keyed[0]) < 2:
                        continue
                    order = np.lexsort(keyed[::-1])
                    eq = np.ones(len(order) - 1, dtype=bool)
                    for d in keyed:
                        ds = d[order]
                        eq &= ds[1:] == ds[:-1]
                    if eq.any():
                        raise ValueError(
                            f"Duplicate entry under unique index {iname!r} "
                            "after MODIFY COLUMN conversion")

            t.alter_modify_column(
                old_name, new_t, CV.make_converter(old_t, new_t, old_name),
                rename_to=new_name if new_name != old_name else None, validate=validate)
        # the DEFAULT follows the column: an explicit clause wins, else
        # the old default moves across the rename and casts to the new type
        dflt = t.defaults
        if s.default is not None:
            dflt.pop(old_name, None)
            dflt[new_name] = s.default
        elif old_name in dflt:
            v = dflt.pop(old_name)
            nk = new_t.kind
            try:
                if nk == Kind.STRING:
                    v = str(v)
                elif nk in (Kind.INT, Kind.BOOL) and not isinstance(v, bool):
                    v = int(round(float(v)))
                elif nk in (Kind.DECIMAL, Kind.FLOAT):
                    v = float(v)
                dflt[new_name] = v
            except (ValueError, TypeError):
                pass  # a default that does not convert is dropped
        # stored generated columns over the converted column recompute
        if any(old_name in check_columns(ex) for _c, ex in self._gen_exprs_for(t)):
            self._recompute_generated(t)

    def _run_multi_alter(self, s: ast.MultiAlter) -> None:
        """Comma-separated ALTER specs, applied in order; when one fails,
        the table's schema, indexes, defaults, AUTO_INCREMENT, rows and
        dictionaries return to their state before the statement. RENAME
        and partition specs do not combine."""
        for spec in s.specs:
            act = getattr(spec, "action", None)
            if act == "rename" or act in PARTITION_ACTIONS:
                raise ValueError(
                    f"ALTER action {act!r} cannot be combined with other specs in one statement")
        t = self.catalog.table(s.db or self.db, s.name)
        snap = {
            "schema": t.schema,
            "indexes": {k: list(v) for k, v in t.indexes.items()},
            "unique_indexes": set(t.unique_indexes),
            "index_states": dict(t.index_states),
            "defaults": dict(t.defaults),
            "generated": list(t.generated),
            "checks": list(t.checks),
            "fks": (list(t.fks), dict(t.fk_actions), dict(t.fk_update_actions)),
            "partition": t.partition,
            "autoinc": (t.autoinc_col, t.autoinc_next),
            "blocks": list(t.blocks()),
            "dictionaries": dict(t.dictionaries),
        }
        try:
            for spec in s.specs:
                self._dispatch(spec)
        except BaseException:
            t.schema = snap["schema"]
            t.indexes = snap["indexes"]
            t.unique_indexes = snap["unique_indexes"]
            t.index_states = snap["index_states"]
            t.defaults = snap["defaults"]
            t.generated = snap["generated"]
            t._gen_exprs = None
            t.checks = snap["checks"]
            t.fks, t.fk_actions, t.fk_update_actions = snap["fks"]
            t.partition = snap["partition"]
            t.autoinc_col, t.autoinc_next = snap["autoinc"]
            t.dictionaries = snap["dictionaries"]
            t.replace_blocks(snap["blocks"], modified_rows=0)
            self.catalog.schema_version += 1
            self._drop_cached(invalidate=[t])
            raise
        self.catalog.schema_version += 1
        self._drop_cached(invalidate=[t])
