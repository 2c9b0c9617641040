"""Catalog: databases and tables.

Counterpart of tidb_tpu/storage/catalog.py: databases (CREATE/DROP
DATABASE), ``create_table``/``drop_table``, ``table(db, name)``, the
listings SHOW reads (``databases``, ``tables``), and the catalog-level
state every session and server connection over the same store shares:
the user store (``users``), the GLOBAL sysvar store
(``global_sysvars``), the pessimistic lock manager (``lock_manager``)
and the commit mutex (``_commit_mu``) under which a transaction's
conflict check and install run.

Views are stored as their SELECT text and column list per database
(``create_view``, ``drop_view``, ``view_def``); the logical planner
expands a view reference by planning that text. Sequences
(``create_sequence``, ``sequence``) share the namespace of tables and
views. A table a FOREIGN KEY
references cannot be dropped, nor the database holding it while a child
outside it remains.

information_schema: ``tables``, ``columns``, ``schemata``,
``statistics``, ``table_constraints``, ``key_column_usage``,
``referential_constraints``, ``views``, ``sequences`` and
``partitions`` (one row per partition, its rows counted per
``part_id``) are built from the catalog as the JAX package builds them,
memoized per schema version and data fingerprint (a fresh table per
statement would carry a fresh uid, and the executor would recompile its
plan and re-copy its columns every time). The tables of the moment are
built anew at every read: ``memory_usage`` and
``memory_usage_ops_history`` (the instance watchdog, utils/watchdog.py),
``slow_query``, ``statements_summary`` and its ``_history`` and
``metrics`` (utils/metrics.py), ``tpu_engine`` (obs/engine_watch.py: the
name is the JAX package's, the rows the CUDA engine's) and
``resource_groups`` (``resource_groups``, utils/resgroup.py, shared by
every session over the catalog). ``top_sql``, ``inspection_result``,
``cluster_links`` and metrics_schema refuse by name.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from typing import Dict, List

from tidb_tpu_torch.dtypes import FLOAT64, INT64, STRING, Kind, days_to_date
from tidb_tpu_torch.storage.locks import LockManager
from tidb_tpu_torch.storage.table import Table, TableSchema
from tidb_tpu_torch.utils import racecheck
from tidb_tpu_torch.utils.failpoint import inject
from tidb_tpu_torch.utils.privilege import UserStore
from tidb_tpu_torch.utils.resgroup import ResourceGroupManager


class Catalog:
    def __init__(self) -> None:
        self._lock = racecheck.make_lock("catalog")
        self._dbs: Dict[str, Dict[str, Table]] = {"test": {}}
        # views per database: name -> (SELECT text, column names or None)
        self._views: Dict[str, Dict[str, tuple]] = {"test": {}}
        # sequences per database: name -> storage.sequence.Sequence
        self._seqs: Dict[str, dict] = {}
        # (schema version, (parent db, parent table) -> [child FK]): the
        # reverse FOREIGN KEY map, built once per schema version
        self._fk_child_cache = None
        # account + grant store (reference: mysql.user et al cached by
        # pkg/privilege); lives on the catalog so every session/server
        # over the same store shares one authority
        self.users = UserStore()
        # shared GLOBAL sysvar store (mysql.global_variables analog)
        self.global_sysvars: Dict[str, object] = {}
        self._conn_ids = itertools.count(1)
        # connection id -> live Session over this store, for SHOW
        # PROCESSLIST and KILL (reference: the server's clientConn
        # registry, pkg/server/server.go); weak, so a closed session
        # drops out once it is collected
        self._session_registry: "weakref.WeakValueDictionary[int, object]" = (
            weakref.WeakValueDictionary())
        # shared by every session over this store: table locks of
        # pessimistic transactions and autocommit writers, and the mutex
        # that makes an optimistic commit's check and install one step
        self.lock_manager = LockManager()
        self._commit_mu = racecheck.make_lock("catalog.commit")
        # bumped by every DDL: the information_schema memo's key
        self.schema_version = 0
        self._is_table_cache: Dict[str, tuple] = {}
        # per thread: the tables of the moment its statement built
        self._live_tls = threading.local()
        # SQL bindings: statement digest -> {"for_sql", "using_sql", "hints"}
        self.bindings: Dict[str, dict] = {}
        # advisory locks (GET_LOCK): name -> [holder conn_id, depth],
        # waited for on the condition
        self._user_locks: Dict[str, list] = {}
        self._user_locks_cv = racecheck.make_condition("session.user_locks")
        # resource groups and their RU buckets (CREATE RESOURCE GROUP)
        self.resource_groups = ResourceGroupManager()

    def create_database(self, name: str, if_not_exists: bool = False) -> None:
        name = name.lower()
        with self._lock:
            if name in self._dbs:
                if if_not_exists:
                    return
                raise ValueError(f"database {name!r} exists")
            self._dbs[name] = {}
            self._views[name] = {}
            self.schema_version += 1

    def drop_database(self, name: str) -> None:
        name = name.lower()
        with self._lock:
            # a child outside the database that references a table in it
            # blocks the drop (children inside go with it)
            for d2, tabs in self._dbs.items():
                if d2 == name:
                    continue
                for tn2, t2 in tabs.items():
                    for nm, _c, rdb, rtbl, _rc in t2.fks:
                        if rdb == name and rtbl in self._dbs.get(name, {}):
                            raise ValueError(
                                f"cannot drop database {name}: {name}.{rtbl} "
                                f"is referenced by FOREIGN KEY {nm!r} on {d2}.{tn2}")
            self._dbs.pop(name, None)
            self._views.pop(name, None)
            self.schema_version += 1

    def create_table(
        self, db: str, name: str, schema: TableSchema, if_not_exists: bool = False
    ) -> Table:
        inject("catalog/create-table")
        db, name = db.lower(), name.lower()
        with self._lock:
            if db not in self._dbs:
                raise ValueError(f"unknown database {db!r}")
            if name in self._dbs[db]:
                if if_not_exists:
                    return self._dbs[db][name]
                raise ValueError(f"table {name!r} exists")
            if name in self._views.get(db, {}):
                raise ValueError(f"view {name!r} exists")
            if name in self._seqs.get(db, {}):
                raise ValueError(f"sequence {name!r} exists")
            t = Table(name, schema)
            self._dbs[db][name] = t
            self.schema_version += 1
            return t

    def drop_table(self, db: str, name: str, if_exists: bool = False) -> None:
        inject("catalog/drop-table")
        db, name = db.lower(), name.lower()
        with self._lock:
            if name not in self._dbs.get(db, {}):
                if name in self._views.get(db, {}):
                    raise ValueError(f"{db}.{name} is a view (use DROP VIEW)")
                if if_exists:
                    return
                raise ValueError(f"unknown table {db}.{name}")
            for d2, tabs in self._dbs.items():
                for tn2, t2 in tabs.items():
                    if d2 == db and tn2 == name:
                        continue  # a self-referential FK never blocks
                    for nm, _col, rdb, rtbl, _rc in t2.fks:
                        if rdb == db and rtbl == name:
                            raise ValueError(
                                f"cannot drop {db}.{name}: referenced by "
                                f"FOREIGN KEY {nm!r} on {d2}.{tn2}")
            del self._dbs[db][name]
            self.schema_version += 1

    def rename_table(self, db: str, name: str, new_db: str, new_name: str) -> None:
        """RENAME TABLE / ALTER TABLE ... RENAME TO: a move within the
        catalog (the Table keeps its identity, rows and indexes). FOREIGN
        KEYs that reference the table follow its new name."""
        db, name = db.lower(), name.lower()
        new_db, new_name = new_db.lower(), new_name.lower()
        with self._lock:
            if name not in self._dbs.get(db, {}):
                raise ValueError(f"unknown table {db}.{name}")
            if new_db not in self._dbs:
                raise ValueError(f"unknown database {new_db}")
            if new_name in self._dbs[new_db] or new_name in self._views.get(new_db, {}):
                raise ValueError(f"table {new_db}.{new_name} exists")
            t = self._dbs[db].pop(name)
            t.name = new_name
            self._dbs[new_db][new_name] = t
            for tabs in self._dbs.values():
                for t2 in tabs.values():
                    if t2.fks:
                        t2.fks = [(nm, col, new_db, new_name, rcol) if (rdb, rtbl) == (db, name)
                                  else (nm, col, rdb, rtbl, rcol)
                                  for nm, col, rdb, rtbl, rcol in t2.fks]
            self.schema_version += 1

    def table(self, db: str, name: str) -> Table:
        why = unported_virtual_table(db, name)
        if why is not None:
            raise NotImplementedError(why)
        if db.lower() == "information_schema":
            return self._infoschema_table(name.lower())
        try:
            return self._dbs[db.lower()][name.lower()]
        except KeyError:
            if name.lower() in self._views.get(db.lower(), {}):
                raise ValueError(f"{db}.{name} is a view, not a base table") from None
            raise ValueError(f"unknown table {db}.{name}") from None

    def has_table(self, db: str, name: str) -> bool:
        if db.lower() == "information_schema":
            return name.lower() in _IS_BUILT
        return name.lower() in self._dbs.get(db.lower(), {})

    def tables(self, db: str) -> List[str]:
        return sorted(self._dbs.get(db.lower(), {}))

    def databases(self) -> List[str]:
        return sorted(self._dbs)

    # -- views -------------------------------------------------------------
    def create_view(self, db: str, name: str, sql: str, columns=None,
                    or_replace: bool = False) -> None:
        db, name = db.lower(), name.lower()
        with self._lock:
            if db not in self._dbs:
                raise ValueError(f"unknown database {db!r}")
            if name in self._dbs[db]:
                raise ValueError(f"table {name!r} exists")
            if name in self._seqs.get(db, {}):
                raise ValueError(f"sequence {name!r} exists")
            if name in self._views[db] and not or_replace:
                raise ValueError(f"view {name!r} exists")
            self._views[db][name] = (sql, tuple(c.lower() for c in columns) if columns else None)
            self.schema_version += 1

    def drop_view(self, db: str, name: str, if_exists: bool = False) -> None:
        db, name = db.lower(), name.lower()
        with self._lock:
            if name not in self._views.get(db, {}):
                if if_exists:
                    return
                raise ValueError(f"unknown view {db}.{name}")
            del self._views[db][name]
            self.schema_version += 1

    def view_def(self, db: str, name: str):
        """(SELECT text, column names or None) of a view, else None."""
        return self._views.get(db.lower(), {}).get(name.lower())

    def has_view(self, db: str, name: str) -> bool:
        return name.lower() in self._views.get(db.lower(), {})

    def views(self, db: str) -> List[str]:
        return sorted(self._views.get(db.lower(), {}))

    def _view_columns(self, db: str, name: str):
        """[(column, type)] of a view, by planning its body. A body that
        cannot be planned alone (a scalar subquery needs a session)
        yields no columns rather than failing the listing."""
        vdef = self.view_def(db, name)
        # a view over information_schema.columns would plan this listing
        # again from inside itself
        if vdef is None or getattr(self, "_planning_view_cols", False):
            return []
        self._planning_view_cols = True
        sql_text, vcols = vdef
        try:
            from tidb_tpu_torch.parser import parse
            from tidb_tpu_torch.planner.logical import build_query, qualify_view_body

            stmt = parse(sql_text)[0]
            qualify_view_body(stmt, db)
            plan = build_query(stmt, self, db, None)
            names = list(vcols) if vcols else [c.name for c in plan.schema]
            return list(zip(names, [c.type for c in plan.schema.cols]))
        except Exception:
            return []
        finally:
            self._planning_view_cols = False

    # -- sequences ---------------------------------------------------------
    def create_sequence(self, db: str, name: str, seq, if_not_exists: bool = False):
        db, name = db.lower(), name.lower()
        with self._lock:
            if db not in self._dbs:
                raise ValueError(f"unknown database {db!r}")
            if name in self._dbs[db] or name in self._views.get(db, {}):
                raise ValueError(f"table or view {name!r} exists")
            if name in self._seqs.setdefault(db, {}):
                if if_not_exists:
                    return self._seqs[db][name]
                raise ValueError(f"sequence {name!r} exists")
            self._seqs[db][name] = seq
            self.schema_version += 1
            return seq

    def drop_sequence(self, db: str, name: str, if_exists: bool = False) -> None:
        db, name = db.lower(), name.lower()
        with self._lock:
            if name not in self._seqs.get(db, {}):
                if if_exists:
                    return
                raise ValueError(f"unknown sequence {db}.{name}")
            del self._seqs[db][name]
            self.schema_version += 1

    def sequences(self, db: str) -> List[str]:
        return sorted(self._seqs.get(db.lower(), {}))

    def sequence(self, db: str, name: str):
        s = self._seqs.get(db.lower(), {}).get(name.lower())
        if s is None:
            raise ValueError(f"unknown sequence {db}.{name}")
        return s

    # -- FOREIGN KEYs --------------------------------------------------------
    def fk_children(self, db: str, name: str) -> list:
        """[(child db, child table, fk name, fk column, referenced column,
        ON DELETE action)] of every FOREIGN KEY referencing db.name. The
        reverse map is built once per schema version, so a write to a
        table nothing references pays no walk over every table."""
        cache = self._fk_child_cache
        if cache is None or cache[0] != self.schema_version:
            rev: dict = {}
            with self._lock:
                for d in sorted(self._dbs):
                    for tn in sorted(self._dbs[d]):
                        t2 = self._dbs[d][tn]
                        for nm, col, rdb, rtbl, rcol in t2.fks:
                            rev.setdefault((rdb, rtbl), []).append(
                                (d, tn, nm, col, rcol, t2.fk_actions.get(nm.lower(), "restrict")))
            cache = self._fk_child_cache = (self.schema_version, rev)
        return cache[1].get((db.lower(), name.lower()), [])

    def next_conn_id(self) -> int:
        """A session's CONNECTION_ID(): catalog-wide, from 1."""
        with self._lock:
            return next(self._conn_ids)

    # -- information_schema ----------------------------------------------
    def _infoschema_table(self, name: str) -> Table:
        """The virtual table `name`, memoized per catalog state."""
        if name not in _IS_BUILT:
            raise ValueError(f"unknown table information_schema.{name}")
        if name in _IS_LIVE:
            return self._live_infoschema_table(name)
        state = (self.schema_version, self._data_fingerprint())
        hit = self._is_table_cache.get(name)
        if hit is not None and hit[0] == state:
            return hit[1]
        t = self._build_infoschema_table(name)
        self._is_table_cache[name] = (state, t)
        return t

    def _live_infoschema_table(self, name: str) -> Table:
        """A table of the moment, built once per statement on this
        thread: the plan, its cache key and the scan all read one build
        (a metric registered or a statement recorded between two builds
        would shift a dictionary's codes). The build of the thread's
        previous statement leaves the device's scan cache, so that reads
        of diagnostic tables never push the tables' columns out. Outside
        a statement every call builds anew."""
        from tidb_tpu_torch.obs.engine_watch import ENGINE_WATCH
        from tidb_tpu_torch.storage import scan

        stmt = ENGINE_WATCH.current()
        memo = getattr(self._live_tls, "tables", None)
        if memo is None:
            memo = self._live_tls.tables = {}
        hit = memo.get(name)
        if hit is not None and stmt is not None and hit[0] is stmt:
            return hit[1]
        t = self._build_infoschema_table(name)
        if stmt is not None:
            if hit is not None:
                scan.release(hit[1])
            memo[name] = (stmt, t)
        return t

    def _data_fingerprint(self) -> tuple:
        with self._lock:
            return tuple(
                (db, tn, t.version)
                for db in sorted(self._dbs)
                for tn, t in sorted(self._dbs[db].items())
            )

    def _user_tables(self):
        """(db, name, table) of every table outside the internal
        databases (``_cte_scratch``), sorted."""
        with self._lock:
            return [
                (db, tn, self._dbs[db][tn])
                for db in sorted(self._dbs) if not db.startswith("_")
                for tn in sorted(self._dbs[db])
            ]

    def _build_infoschema_table(self, name: str) -> Table:
        """The rows of the JAX package's ``_build_infoschema_table``:
        tables and views, columns (a view's by planning its body),
        primary keys, indexes, CHECKs, FOREIGN KEYs and their actions."""
        tables = self._user_tables()
        with self._lock:
            views = [(db, vn, self._views[db][vn]) for db in sorted(self._views)
                     for vn in sorted(self._views[db])]
        if name == "tables":
            schema = TableSchema([("table_schema", STRING), ("table_name", STRING),
                                  ("table_rows", INT64)])
            with self._lock:
                dbs = [db for db in sorted(self._dbs) if not db.startswith("_")]
            # each database's tables, then its views
            rows = [r for db in dbs for r in
                    [(db, tn, t.nrows) for d, tn, t in tables if d == db]
                    + [(db, vn, 0) for d, vn, _v in views if d == db]]
        elif name == "columns":
            schema = TableSchema([("table_schema", STRING), ("table_name", STRING),
                                  ("column_name", STRING), ("ordinal_position", INT64),
                                  ("data_type", STRING)])
            rows = [(db, tn, cn, i, repr(ct).lower())
                    for db, tn, t in tables
                    for i, (cn, ct) in enumerate(t.schema.columns, 1)]
            rows += [(db, vn, cn, i, repr(ct).lower())
                     for db, vn, _v in views
                     for i, (cn, ct) in enumerate(self._view_columns(db, vn), 1)]
        elif name == "statistics":
            schema = TableSchema([("table_schema", STRING), ("table_name", STRING),
                                  ("index_name", STRING), ("seq_in_index", INT64),
                                  ("column_name", STRING), ("non_unique", INT64)])
            rows = []
            for db, tn, t in tables:
                rows += [(db, tn, "primary", i, cn, 0)
                         for i, cn in enumerate(t.schema.primary_key or [], 1)]
                rows += [(db, tn, iname, i, cn, 0 if iname in t.unique_indexes else 1)
                         for iname in sorted(t.indexes)
                         for i, cn in enumerate(t.indexes[iname], 1)]
        elif name == "table_constraints":
            schema = TableSchema([("constraint_schema", STRING), ("constraint_name", STRING),
                                  ("table_schema", STRING), ("table_name", STRING),
                                  ("constraint_type", STRING)])
            rows = []
            for db, tn, t in tables:
                if t.schema.primary_key:
                    rows.append((db, "PRIMARY", db, tn, "PRIMARY KEY"))
                rows += [(db, iname, db, tn, "UNIQUE") for iname in sorted(t.unique_indexes)]
                rows += [(db, nm, db, tn, "FOREIGN KEY") for nm, *_rest in t.fks]
                rows += [(db, nm, db, tn, "CHECK") for nm, _txt in t.checks]
        elif name == "key_column_usage":
            schema = TableSchema([("constraint_name", STRING), ("table_schema", STRING),
                                  ("table_name", STRING), ("column_name", STRING),
                                  ("ordinal_position", INT64),
                                  ("referenced_table_schema", STRING),
                                  ("referenced_table_name", STRING),
                                  ("referenced_column_name", STRING)])
            rows = []
            for db, tn, t in tables:
                rows += [("PRIMARY", db, tn, c, i, None, None, None)
                         for i, c in enumerate(t.schema.primary_key or [], 1)]
                rows += [(iname, db, tn, c, i, None, None, None)
                         for iname in sorted(t.unique_indexes)
                         for i, c in enumerate(t.indexes.get(iname) or [], 1)]
                rows += [(nm, db, tn, col, 1, rdb or db, rtbl, rcol)
                         for nm, col, rdb, rtbl, rcol in t.fks]
        elif name == "referential_constraints":
            schema = TableSchema([("constraint_schema", STRING), ("constraint_name", STRING),
                                  ("unique_constraint_schema", STRING),
                                  ("update_rule", STRING), ("delete_rule", STRING),
                                  ("table_name", STRING), ("referenced_table_name", STRING)])
            # an action left unspecified shows as NO ACTION (RESTRICT in effect)
            rule = {"cascade": "CASCADE", "set_null": "SET NULL", "restrict": "RESTRICT"}
            rows = [(db, nm, rdb or db,
                     rule.get(t.fk_update_actions.get(nm.lower()), "NO ACTION"),
                     rule.get(t.fk_actions.get(nm.lower()), "NO ACTION"), tn, rtbl)
                    for db, tn, t in tables for nm, _col, rdb, rtbl, _rcol in t.fks]
        elif name == "views":
            schema = TableSchema([("table_schema", STRING), ("table_name", STRING),
                                  ("view_definition", STRING), ("definer", STRING)])
            rows = [(db, vn, v[0], "root") for db, vn, v in views]
        elif name == "sequences":
            # "start_value", not START: START is reserved in the parser
            schema = TableSchema([("sequence_schema", STRING), ("sequence_name", STRING),
                                  ("start_value", INT64), ("increment", INT64),
                                  ("min_value", INT64), ("max_value", INT64),
                                  ("cycle", INT64), ("cache", INT64)])
            with self._lock:
                metas = [(db, sn, self._seqs[db][sn].meta()) for db in sorted(self._seqs)
                         for sn in sorted(self._seqs[db])]
            rows = [(db, sn, m["start"], m["increment"], m["minvalue"], m["maxvalue"],
                     int(m["cycle"]), m["cache"]) for db, sn, m in metas]
        elif name == "partitions":
            schema = TableSchema([("table_schema", STRING), ("table_name", STRING),
                                  ("partition_name", STRING),
                                  ("partition_ordinal_position", INT64),
                                  ("partition_method", STRING),
                                  ("partition_expression", STRING),
                                  ("partition_description", STRING), ("table_rows", INT64)])
            rows = []
            for db, tn, t in tables:
                if t.partition is None:
                    rows.append((db, tn, None, None, None, None, None, t.nrows))
                    continue
                kind, pcol, _spec = t.partition
                per: Dict[object, int] = {}
                for b in t.blocks():
                    per[b.part_id] = per.get(b.part_id, 0) + b.nrows
                rows += [(db, tn, pname, i + 1, kind.upper(), f"`{pcol}`",
                          _partition_description(t, i), per.get(i, 0))
                         for i, pname in enumerate(t.partition_names())]
        elif name == "memory_usage":
            # the instance's memory (reference: information_schema.
            # memory_usage over the watchdog's state)
            from tidb_tpu_torch.utils.watchdog import gvar, host_memory, parse_mem_limit

            rss, total = host_memory()
            wd = getattr(self, "_watchdog", None)
            limit = parse_mem_limit(gvar(self, "tidb_server_memory_limit", "0"), total)
            schema = TableSchema([("memory_total", INT64), ("memory_limit", INT64),
                                  ("memory_current", INT64),
                                  ("memory_usage_alarm_ratio", FLOAT64),
                                  ("alarm_records", INT64), ("watchdog_samples", INT64)])
            rows = [(total, limit, rss,
                     float(gvar(self, "tidb_memory_usage_alarm_ratio", 0.7)),
                     len(wd.alarm_records) if wd else 0, wd.samples if wd else 0)]
        elif name == "memory_usage_ops_history":
            # the watchdog's actions: its alarms, then its kills
            wd = getattr(self, "_watchdog", None)
            schema = TableSchema([("time", FLOAT64), ("op", STRING), ("conn_id", INT64),
                                  ("memory_current", INT64), ("memory_limit", INT64),
                                  ("sql_text", STRING)])
            rows = []
            if wd is not None:
                rows += [(r["time"], "alarm", 0, r["rss"], int(r["ratio"] * r["total"]), "")
                         for r in wd.alarm_records]
                rows += [(r["time"], "kill", r["conn_id"], r["rss"], r["limit"], r["sql"])
                         for r in wd.kill_records]
        elif name in _DIAGNOSTIC:
            schema, rows = _diagnostic_table(self, name)
        else:  # schemata
            schema = TableSchema([("schema_name", STRING)])
            with self._lock:
                rows = [(db,) for db in sorted(self._dbs) if not db.startswith("_")]
        t = Table(name, schema)
        if rows:
            t.append_rows(rows)
        return t


def _partition_description(t, i: int):
    """information_schema.partitions' description of partition i: its
    RANGE bound or LIST values as MySQL prints them; NULL for HASH."""
    kind, pcol, spec = t.partition
    ptype = t.schema.types.get(pcol)

    def fmt(v):
        if v is None:
            return "NULL"
        if ptype is not None and ptype.kind == Kind.DATE:
            return f"'{days_to_date(int(v))}'"
        if ptype is not None and ptype.kind == Kind.DECIMAL:
            return str(int(v) / 10 ** ptype.scale)
        return str(v)

    if kind == "hash":
        return None
    if kind == "list":
        return ",".join(fmt(v) for v in spec[i][1])
    return "MAXVALUE" if spec[i][1] is None else fmt(spec[i][1])


#: statements_summary's mean phase columns: (column, flight phase)
_PHASE_COLS = (
    ("avg_parse", "parse"), ("avg_plan", "plan"), ("avg_compile", "compile"),
    ("avg_execute", "execute"), ("avg_final_merge", "final-merge"),
    ("avg_dispatch", "fragment-dispatch"), ("avg_shuffle_produce", "shuffle-produce"),
    ("avg_shuffle_push", "shuffle-push"), ("avg_shuffle_wait", "shuffle-wait"),
    ("avg_shuffle_stage", "shuffle-stage"),
)

_SUMMARY_HEAD = [("digest_text", STRING), ("exec_count", INT64), ("sum_latency", FLOAT64),
                 ("max_latency", FLOAT64), ("p50_latency", FLOAT64), ("p95_latency", FLOAT64),
                 ("p99_latency", FLOAT64), ("plan_digest", STRING)]


def _diagnostic_table(catalog, name: str):
    """(schema, rows) of a diagnostic table, as the JAX catalog renders
    it (catalog.py:589-790)."""
    from tidb_tpu_torch.obs.engine_watch import ENGINE_WATCH
    from tidb_tpu_torch.utils.metrics import REGISTRY, SLOW_LOG, STMT_HISTORY, STMT_SUMMARY

    if name == "slow_query":
        return TableSchema([("time", FLOAT64), ("query", STRING), ("query_time", FLOAT64),
                            ("digest", STRING), ("conn_id", INT64), ("phases", STRING),
                            ("plan", STRING)]), SLOW_LOG.rows()
    if name == "statements_summary":
        schema = TableSchema(
            _SUMMARY_HEAD + [(cn, FLOAT64) for cn, _p in _PHASE_COLS]
            + [("shuffle_bytes", INT64), ("shuffle_retries", INT64), ("dispatch_retries", INT64),
               ("rows_sent", INT64), ("plan_cache_hits", INT64), ("plan_cache_misses", INT64),
               ("jit_compilations", INT64), ("retraces", INT64), ("h2d_bytes", INT64),
               ("d2h_bytes", INT64), ("device_mem_peak_bytes", INT64),
               ("compile_flops", FLOAT64), ("compile_bytes_accessed", FLOAT64),
               ("compile_output_bytes", FLOAT64), ("est_rows", FLOAT64), ("act_rows", FLOAT64),
               ("card_divergence", FLOAT64), ("sample_text", STRING)])
        rows = []
        for e in STMT_SUMMARY.rows_full():
            n = max(e["exec_count"], 1)
            ph = e["phases"]
            none = (0.0, 0, 0)
            rows.append(
                tuple(e[k] for k, _t in _SUMMARY_HEAD)
                + tuple(ph.get(p, none)[0] / n for _cn, p in _PHASE_COLS)
                + (ph.get("shuffle-push", none)[1], ph.get("shuffle-push", none)[2],
                   ph.get("fragment-dispatch", none)[2])
                + tuple(e[k] for k in (
                    "rows_sent", "plan_cache_hits", "plan_cache_misses", "jit_compilations",
                    "retraces", "h2d_bytes", "d2h_bytes", "device_mem_peak_bytes",
                    "compile_flops", "compile_bytes_accessed", "compile_output_bytes",
                    "est_rows", "act_rows", "card_divergence", "sample_text")))
        return schema, rows
    if name == "statements_summary_history":
        schema = TableSchema(
            [("summary_begin_time", FLOAT64), ("summary_end_time", FLOAT64)] + _SUMMARY_HEAD
            + [("rows_sent", INT64), ("device_mem_peak_bytes", INT64), ("est_rows", FLOAT64),
               ("act_rows", FLOAT64), ("card_divergence", FLOAT64), ("sample_text", STRING)])
        keys = [k for k, _t in schema.columns[2:]]
        return schema, [(b, e) + tuple(r.get(k, 0.0) for k in keys)
                        for b, e, r in STMT_HISTORY.rows()]
    if name == "metrics":
        return TableSchema([("name", STRING), ("kind", STRING), ("value", FLOAT64)]), \
            REGISTRY.rows()
    if name == "tpu_engine":
        return TableSchema([("qid", INT64), ("query", STRING), ("jit_compilations", INT64),
                            ("retraces", INT64), ("h2d_bytes", INT64), ("d2h_bytes", INT64),
                            ("device_mem_peak_bytes", INT64), ("duration", FLOAT64),
                            ("compile_flops", FLOAT64), ("compile_bytes_accessed", FLOAT64),
                            ("compile_output_bytes", FLOAT64)]), ENGINE_WATCH.rows()
    # resource_groups
    return TableSchema([("name", STRING), ("ru_per_sec", INT64), ("burstable", STRING),
                        ("consumed_ru", FLOAT64), ("queries", INT64)]), \
        catalog.resource_groups.rows()


#: the diagnostic tables (``_diagnostic_table``)
_DIAGNOSTIC = ("slow_query", "statements_summary", "statements_summary_history", "metrics",
               "tpu_engine", "resource_groups")

_IS_BUILT = ("tables", "columns", "schemata", "statistics", "table_constraints",
             "key_column_usage", "referential_constraints", "views", "sequences",
             "partitions", "memory_usage", "memory_usage_ops_history") + _DIAGNOSTIC

#: information_schema tables of the moment: never memoized
_IS_LIVE = ("memory_usage", "memory_usage_ops_history") + _DIAGNOSTIC

#: information_schema tables the port refuses, with the feature they wait for
IS_UNPORTED = {
    **{n: "a diagnostic table of the time-series tier, not ported yet" for n in (
        "top_sql", "inspection_result")},
    "cluster_links": "the multi-host tier's link health, not ported yet",
}


def unported_virtual_table(db: str, name: str):
    """Why a read of the virtual table `db`.`name` is refused, or None."""
    db, name = db.lower(), name.lower()
    if db == "metrics_schema":
        return f"metrics_schema.{name} is not ported yet (the time-series tier)"
    if db == "information_schema" and name in IS_UNPORTED:
        return f"information_schema.{name} is not ported yet ({IS_UNPORTED[name]})"
    return None
