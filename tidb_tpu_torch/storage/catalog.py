"""Catalog: databases and tables.

Counterpart of tidb_tpu/storage/catalog.py: databases (CREATE/DROP
DATABASE), ``create_table``/``drop_table``, ``table(db, name)``, the
listings SHOW reads (``databases``, ``tables``), and the catalog-level
state every session and server connection over the same store shares:
the user store (``users``), the GLOBAL sysvar store
(``global_sysvars``), the pessimistic lock manager (``lock_manager``)
and the commit mutex (``_commit_mu``) under which a transaction's
conflict check and install run.

information_schema: ``tables``, ``columns``, ``schemata``,
``statistics``, ``table_constraints`` and ``key_column_usage`` are
built from the catalog as the JAX package builds them, memoized per
schema version and data fingerprint (a fresh table per statement would
carry a fresh uid, and the executor would recompile its plan and re-copy
its columns every time). The tables of features the port lacks (views,
sequences, partitions, foreign keys) and the diagnostic tables refuse by
name. Views, sequences and RENAME are not ported.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from typing import Dict, List

from tidb_tpu_torch.dtypes import INT64, STRING
from tidb_tpu_torch.storage.locks import LockManager
from tidb_tpu_torch.storage.table import Table, TableSchema
from tidb_tpu_torch.utils.privilege import UserStore


class Catalog:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._dbs: Dict[str, Dict[str, Table]] = {"test": {}}
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
        self._commit_mu = threading.Lock()
        # bumped by every DDL: the information_schema memo's key
        self.schema_version = 0
        self._is_table_cache: Dict[str, tuple] = {}
        # SQL bindings: statement digest -> {"for_sql", "using_sql", "hints"}
        self.bindings: Dict[str, dict] = {}

    def create_database(self, name: str, if_not_exists: bool = False) -> None:
        name = name.lower()
        with self._lock:
            if name in self._dbs:
                if if_not_exists:
                    return
                raise ValueError(f"database {name!r} exists")
            self._dbs[name] = {}
            self.schema_version += 1

    def drop_database(self, name: str) -> None:
        name = name.lower()
        with self._lock:
            self._dbs.pop(name, None)
            self.schema_version += 1

    def create_table(
        self, db: str, name: str, schema: TableSchema, if_not_exists: bool = False
    ) -> Table:
        db, name = db.lower(), name.lower()
        with self._lock:
            if db not in self._dbs:
                raise ValueError(f"unknown database {db!r}")
            if name in self._dbs[db]:
                if if_not_exists:
                    return self._dbs[db][name]
                raise ValueError(f"table {name!r} exists")
            t = Table(name, schema)
            self._dbs[db][name] = t
            self.schema_version += 1
            return t

    def drop_table(self, db: str, name: str, if_exists: bool = False) -> None:
        db, name = db.lower(), name.lower()
        with self._lock:
            if name not in self._dbs.get(db, {}):
                if if_exists:
                    return
                raise ValueError(f"unknown table {db}.{name}")
            del self._dbs[db][name]
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
            raise ValueError(f"unknown table {db}.{name}") from None

    def has_table(self, db: str, name: str) -> bool:
        if db.lower() == "information_schema":
            return name.lower() in _IS_BUILT
        return name.lower() in self._dbs.get(db.lower(), {})

    def tables(self, db: str) -> List[str]:
        return sorted(self._dbs.get(db.lower(), {}))

    def databases(self) -> List[str]:
        return sorted(self._dbs)

    def next_conn_id(self) -> int:
        """A session's CONNECTION_ID(): catalog-wide, from 1."""
        with self._lock:
            return next(self._conn_ids)

    # -- information_schema ----------------------------------------------
    def _infoschema_table(self, name: str) -> Table:
        """The virtual table `name`, memoized per catalog state."""
        if name not in _IS_BUILT:
            raise ValueError(f"unknown table information_schema.{name}")
        state = (self.schema_version, self._data_fingerprint())
        hit = self._is_table_cache.get(name)
        if hit is not None and hit[0] == state:
            return hit[1]
        t = self._build_infoschema_table(name)
        self._is_table_cache[name] = (state, t)
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
        """The rows of the JAX package's ``_build_infoschema_table`` for
        the ported tables. The port's tables have no secondary or UNIQUE
        indexes, CHECKs or FOREIGN KEYs, so those rows are absent."""
        tables = self._user_tables()
        if name == "tables":
            schema = TableSchema([("table_schema", STRING), ("table_name", STRING),
                                  ("table_rows", INT64)])
            rows = [(db, tn, t.nrows) for db, tn, t in tables]
        elif name == "columns":
            schema = TableSchema([("table_schema", STRING), ("table_name", STRING),
                                  ("column_name", STRING), ("ordinal_position", INT64),
                                  ("data_type", STRING)])
            rows = [(db, tn, cn, i, repr(ct).lower())
                    for db, tn, t in tables
                    for i, (cn, ct) in enumerate(t.schema.columns, 1)]
        elif name == "statistics":
            schema = TableSchema([("table_schema", STRING), ("table_name", STRING),
                                  ("index_name", STRING), ("seq_in_index", INT64),
                                  ("column_name", STRING), ("non_unique", INT64)])
            rows = [(db, tn, "primary", i, cn, 0)
                    for db, tn, t in tables
                    for i, cn in enumerate(t.schema.primary_key or [], 1)]
        elif name == "table_constraints":
            schema = TableSchema([("constraint_schema", STRING), ("constraint_name", STRING),
                                  ("table_schema", STRING), ("table_name", STRING),
                                  ("constraint_type", STRING)])
            rows = [(db, "PRIMARY", db, tn, "PRIMARY KEY")
                    for db, tn, t in tables if t.schema.primary_key]
        elif name == "key_column_usage":
            schema = TableSchema([("constraint_name", STRING), ("table_schema", STRING),
                                  ("table_name", STRING), ("column_name", STRING),
                                  ("ordinal_position", INT64),
                                  ("referenced_table_schema", STRING),
                                  ("referenced_table_name", STRING),
                                  ("referenced_column_name", STRING)])
            rows = [("PRIMARY", db, tn, c, i, None, None, None)
                    for db, tn, t in tables
                    for i, c in enumerate(t.schema.primary_key or [], 1)]
        else:  # schemata
            schema = TableSchema([("schema_name", STRING)])
            with self._lock:
                rows = [(db,) for db in sorted(self._dbs) if not db.startswith("_")]
        t = Table(name, schema)
        if rows:
            t.append_rows(rows)
        return t


_IS_BUILT = ("tables", "columns", "schemata", "statistics", "table_constraints",
             "key_column_usage")

#: information_schema tables the port refuses, with the feature they wait for
IS_UNPORTED = {
    "views": "views are not ported",
    "sequences": "sequences are not ported",
    "partitions": "partitions are not ported",
    "referential_constraints": "FOREIGN KEY is not ported",
    **{n: "a diagnostic table: observability is not ported" for n in (
        "slow_query", "statements_summary", "statements_summary_history", "metrics",
        "top_sql", "tpu_engine", "memory_usage", "memory_usage_ops_history",
        "cluster_links", "inspection_result", "resource_groups")},
}


def unported_virtual_table(db: str, name: str):
    """Why a read of the virtual table `db`.`name` is refused, or None."""
    db, name = db.lower(), name.lower()
    if db == "metrics_schema":
        return f"metrics_schema.{name} is not ported yet (observability)"
    if db == "information_schema" and name in IS_UNPORTED:
        return f"information_schema.{name} is not ported yet ({IS_UNPORTED[name]})"
    return None
