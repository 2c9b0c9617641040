"""Session: SQL text in, rows out.

Counterpart of tidb_tpu/session/session.py. ``execute`` parses, plans
(``build_query``), runs the plan on the session's device and
materializes rows, as the JAX session's ``_run_select`` does, and
returns the same ``Result``; a full ORDER BY too large for the device
is ordered in host RAM instead (``_try_host_sorted``). An uncorrelated
scalar subquery runs first, as a statement of its own, and enters the
plan as a literal. ANALYZE stores per-column statistics that the
planner's join ordering reads.

Session statements: SET of session, global and user variables (and SET
NAMES / SET TRANSACTION, which only latch variables), USE (also of
information_schema), SHOW DATABASES / TABLES / VARIABLES / STATUS /
WARNINGS / OPEN TABLES / TABLE STATUS / COLUMNS / INDEX / CREATE TABLE /
CREATE DATABASE / COLLATION / CHARSET / ENGINES / PROCESSLIST / GRANTS /
BINDINGS [LIKE], DO, FLUSH / LOCK / UNLOCK TABLES (no-ops), OPTIMIZE TABLE
(which re-analyzes), FROM-less SELECT with ``@@`` references and session
functions (DATABASE(), CONNECTION_ID(), ...), PREPARE / EXECUTE /
DEALLOCATE and their API (``prepare``, ``execute_prepared``,
``deallocate``), CREATE / DROP USER, GRANT / REVOKE and privilege checks
for the session's user, and CREATE / DROP BINDING (a SELECT's digest ->
hints). ``tidb_mem_quota_query`` and ``tidb_tpu_stream_rows`` reach the
executor per statement; the STREAM_ROWS(n) hint for one statement.

information_schema: ``tables``, ``columns``, ``schemata``,
``statistics``, ``table_constraints``, ``key_column_usage``,
``referential_constraints``, ``views``, ``sequences``, ``partitions`` and
the diagnostic tables of the moment (storage/catalog.py).

Stale reads: ``AS OF TIMESTAMP``, ``tidb_snapshot`` (which also refuses
writes) and ``tidb_read_staleness`` read a table's version of that time
(``_resolve_table_for_read``), kept for ``tidb_gc_life_time``.

Statement control: ``max_execution_time``, the MAX_EXECUTION_TIME hint
and ``KILL [QUERY | CONNECTION] id`` (the id is the target Session's
``conn_id``, CONNECTION_ID()) stop a running statement at its next
safepoint (utils/sqlkiller.py: each capacity-discovery attempt and each
streamed chunk) with ``QueryKilled``; a killed statement leaves no lock,
pin or partial row behind. KILL and SHOW PROCESSLIST take no lock, so
they reach a statement that holds the statement lock.

Writes: CREATE/DROP DATABASE, CREATE TABLE (PRIMARY KEY, NOT NULL,
DEFAULT, AUTO_INCREMENT, [UNIQUE] INDEX, IF NOT EXISTS, ... LIKE, ... AS
SELECT), DROP TABLE, TRUNCATE, CREATE [UNIQUE] INDEX, DROP INDEX, RENAME
TABLE, ALTER TABLE (ADD / DROP / MODIFY / CHANGE / RENAME COLUMN, SET /
DROP DEFAULT, RENAME TO, ADD / DROP INDEX, ALTER INDEX ... [IN]VISIBLE,
and comma-separated specs with whole-statement rollback;
session/ddl.py), INSERT (VALUES, column lists, defaults, ... SELECT,
IGNORE, ON DUPLICATE KEY UPDATE with VALUES(col), AUTO_INCREMENT with
LAST_INSERT_ID()), REPLACE, DELETE and UPDATE (WHERE, ORDER BY ...
LIMIT; UPDATE takes the columnar path where the JAX session does and
rewrites the table otherwise), multi-table UPDATE and DELETE over a join
(row handles through ``_tidb_rowid``), and transactions: BEGIN / START TRANSACTION [READ ONLY], COMMIT, ROLLBACK,
SAVEPOINT, ROLLBACK TO, RELEASE and SELECT ... FOR UPDATE. A transaction
writes into shadow tables and reads pinned snapshots of the rest; COMMIT
installs the shadows after a version check (first committer wins).
``tidb_txn_mode = pessimistic`` (the default) takes table locks per DML
statement until the transaction ends; an autocommit writer takes them
for its statement. An autocommit DML that changed more than
``tidb_auto_analyze_ratio`` of a table re-analyzes it. Conflicts of
REPLACE, ON DUPLICATE KEY UPDATE and INSERT IGNORE resolve against the
PRIMARY KEY and every UNIQUE index, in the encoded domain.

The statement's record: each top-level statement has a flight
(obs/flight.py: its parse, plan, compile, execute and final-merge) and an
engine-watch record (obs/engine_watch.py: plan builds, transfers, device
memory) open on its thread; after the device's statement lock is let go
it lands in the statement summary, the slow log and the counters
(``_observe_stmt``, utils/metrics.py), keyed by a digest made from the
parse's own tokens. TRACE returns the statement's spans
(utils/tracing.py), PLAN REPLAYER DUMP writes its zip
(utils/planreplayer.py), and CREATE / ALTER / DROP RESOURCE GROUP and SET
RESOURCE GROUP bill each statement in request units, its wait for the
group's bucket taken before any lock (utils/resgroup.py).
information_schema's time-series and multi-host tables and
metrics_schema raise ``NotImplementedError`` naming themselves.

Bulk loads and checks: LOAD DATA [LOCAL] INFILE (storage/loader.py, the
native splitter where the JAX package takes it; a constrained table is
checked after the append and rolled back on a violation), IMPORT INTO
over the DXF (dxf/: four executors parse byte ranges, the finalize
appends), CREATE TABLE ... TTL (utils/ttl.py expires the rows), and
ADMIN CHECK TABLE / CHECK INDEX / CHECKSUM TABLE / SHOW DDL JOBS and
CHECK TABLE (session/admin.py).

Partitioned tables: CREATE TABLE ... PARTITION BY RANGE, HASH or LIST
(``_encode_partition``), ALTER TABLE ... ADD, DROP, TRUNCATE and
EXCHANGE PARTITION (session/ddl.py; all but ADD refused inside a
transaction), pruning in the plan with the defs of the version read and
EXPLAIN's ``partitions=[...]``. Sequences: CREATE / DROP SEQUENCE,
NEXTVAL / LASTVAL / SETVAL (folded once per statement, per row in INSERT
... VALUES; LASTVAL per session). LOCAL TEMPORARY tables live in the
session's view of the catalog (``_SessionCatalog``): invisible to other
sessions and to SHOW TABLES, shadowing a shared table of their name.
The session-state builtins fold before planning: the advisory locks
(GET_LOCK and its family, shared per catalog), RANDOM_BYTES, the SQL
digest functions; SLEEP sleeps at plan time, cut short by KILL.

WITH RECURSIVE materializes each recursive CTE step by step into a
scratch table (``_run_recursive_with``); EXPLAIN renders the plan with
estimated rows and the access path of each scan under a Selection
(IndexRangeScan or IndexMerge), and EXPLAIN ANALYZE runs it once
instrumented (``_run_explain``).

One statement's work on a device runs at a time in a process
(``statement_lock``): the scan cache, the transfer and launch counters
and the spill sizing's reading of the card's free memory are shared by
every session. Parsing and the wait for table locks stay outside it, so
a writer blocked on another transaction's lock never holds up the
COMMIT that would free it.

The session runs on CUDA unless the caller passes ``device="cpu"``; with
no card present, CUDA raises instead of moving to the CPU.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import hashlib
import itertools
import json
import math
import operator
import os
import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tidb_tpu_torch.chunk import (
    Batch,
    HostBlock,
    HostColumn,
    block_to_rows,
    column_from_values,
    materialize_rows,
    resolve_device,
)
from tidb_tpu_torch.dtypes import (
    INT64,
    Kind,
    SQLType,
    date_to_days,
    datetime_to_micros,
    days_to_date,
    micros_to_datetime,
    micros_to_time,
    time_to_micros,
)
from tidb_tpu_torch.expression.expr import Literal, _mysql_numeric_prefix, literal_type
from tidb_tpu_torch.expression.hostfns import sql_like_match
from tidb_tpu_torch.expression.kernels import compile_expr, string_expr
from tidb_tpu_torch.obs.engine_watch import ENGINE_WATCH
from tidb_tpu_torch.obs.flight import FLIGHT, c_slow_captures
from tidb_tpu_torch.parser import ast, parse, parse_tokens
from tidb_tpu_torch.planner import build_query
from tidb_tpu_torch.planner.logical import ExprBinder, Schema, _display_name, _scalar_subq
from tidb_tpu_torch.planner.physical import PhysicalExecutor, StaleWidthsError
from tidb_tpu_torch.planner.streamed import try_streamed_sort
from tidb_tpu_torch.session.admin import AdminMixin
from tidb_tpu_torch.session.constraints import ConstraintMixin
from tidb_tpu_torch.session.ddl import PARTITION_WRITES, DDLMixin
from tidb_tpu_torch.stats import analyze_table
from tidb_tpu_torch.stats.handle import maybe_auto_analyze
from tidb_tpu_torch.storage import Catalog, Table, TableSchema
from tidb_tpu_torch.storage import scan as _scan
from tidb_tpu_torch.storage.catalog import unported_virtual_table
from tidb_tpu_torch.storage.loader import load_file
from tidb_tpu_torch.storage.locks import DeadlockError, next_txn_id
from tidb_tpu_torch.storage.sequence import Sequence
from tidb_tpu_torch.storage.table import set_gc_life
from tidb_tpu_torch.tools.dump import create_table_sql
from tidb_tpu_torch.utils import collate as _coll
from tidb_tpu_torch.utils import racecheck
from tidb_tpu_torch.utils.failpoint import inject
from tidb_tpu_torch.utils.collate import CHARSET_DEFAULTS
from tidb_tpu_torch.utils.checkeval import check_columns
from tidb_tpu_torch.utils.metrics import (
    REGISTRY, SLOW_LOG, STMT_HISTORY, STMT_SUMMARY, digest_tokens, sql_digest,
)
from tidb_tpu_torch.utils import sqlkiller as _sk
from tidb_tpu_torch.utils.sqlkiller import SQLKiller
from tidb_tpu_torch.utils.sysvar import SysVars
from tidb_tpu_torch.utils.tracing import Tracer

_READS = (ast.Select, ast.Union, ast.With, ast.SetOp)
_DML = (ast.Insert, ast.Update, ast.Delete, ast.LoadData)

#: statements this slice leaves out, by the name the error gives them
_UNPORTED = {
    ast.BackupLog: "BACKUP LOG (log backup, ROADMAP.md queue 1, item 7)",
    ast.RestorePoint: "RESTORE POINT (point-in-time recovery, ROADMAP.md queue 1, item 7)",
    ast.ChangefeedStmt: "CHANGEFEED (change data capture, ROADMAP.md queue 1, item 7)",
}

#: the knobs whose first SET starts the instance watchdog
_WATCHDOG_KNOBS = ("tidb_server_memory_limit", "tidb_memory_usage_alarm_ratio",
                   "tidb_expensive_query_time_threshold")

#: the advisory-lock builtins, folded before planning
_USER_LOCK_FUNCS = ("get_lock", "release_lock", "is_free_lock", "is_used_lock",
                    "release_all_locks")

# process-unique names of recursive CTEs' scratch tables: the scratch
# database is shared by every session of a catalog
_cte_scratch_seq = itertools.count(1)

#: the statement counters (utils/metrics.py REGISTRY)
_C_STATEMENTS = REGISTRY.counter("tidbtpu_session_statements_total", "statements executed")
_C_ERRORS = REGISTRY.counter("tidbtpu_session_statement_errors_total", "failed statements")
_H_LATENCY = REGISTRY.histogram("tidbtpu_session_query_duration_seconds", "statement latency")

_STATEMENT_LOCKS: Dict[str, object] = {}
_STATEMENT_LOCKS_GUARD = racecheck.make_lock("session.statement_guard")


def statement_lock(device):
    """The process-wide lock under which one statement at a time runs on
    `device`. Re-entrant: EXECUTE of a statement prepared by text runs
    ``execute`` again inside it."""
    with _STATEMENT_LOCKS_GUARD:
        lk = _STATEMENT_LOCKS.get(str(device))
        if lk is None:
            lk = _STATEMENT_LOCKS[str(device)] = racecheck.make_rlock("session.statement")
        return lk


class _SessionCatalog:
    """A session's view of its catalog: its LOCAL TEMPORARY tables shadow
    the catalog's tables by name for this session only, and every other
    attribute (users, sysvars, locks, sequences, the databases) is the
    shared catalog's. Temporary tables stay out of ``tables()`` (SHOW
    TABLES, information_schema) but win ``table()`` and ``has_table()``."""

    __slots__ = ("_base", "_temp")

    def __init__(self, base):
        object.__setattr__(self, "_base", base)
        object.__setattr__(self, "_temp", {})

    def __getattr__(self, n):
        return getattr(object.__getattribute__(self, "_base"), n)

    def __setattr__(self, n, v):
        setattr(object.__getattribute__(self, "_base"), n, v)

    def table(self, db: str, name: str):
        t = self._temp.get((db.lower(), name.lower()))
        return t if t is not None else self._base.table(db, name)

    def has_table(self, db: str, name: str) -> bool:
        return (db.lower(), name.lower()) in self._temp or self._base.has_table(db, name)

    def create_temp_table(self, db: str, name: str, schema) -> Table:
        db, name = db.lower(), name.lower()
        if db not in self._base._dbs:
            raise ValueError(f"unknown database {db!r}")
        if (db, name) in self._temp:
            raise ValueError(f"temporary table {name!r} exists")
        t = self._temp[(db, name)] = Table(name, schema)
        # plans are keyed by the schema version: a plan over the
        # shadowed table must not serve the temporary one, nor the reverse
        self._base.schema_version += 1
        return t

    def drop_table(self, db: str, name: str, if_exists: bool = False,
                   temporary_only: bool = False) -> None:
        key = (db.lower(), name.lower())
        if key in self._temp:
            del self._temp[key]
            self._base.schema_version += 1
            return
        if temporary_only:
            if if_exists:
                return
            raise ValueError(f"unknown temporary table {db}.{name}")
        self._base.drop_table(db, name, if_exists)


def _release_session_locks(base_catalog, conn_id: int) -> None:
    """A collected session's advisory locks are released, as a closed
    MySQL connection's are."""
    cv = base_catalog._user_locks_cv
    with cv:
        for name in [k for k, v in base_catalog._user_locks.items() if v[0] == conn_id]:
            del base_catalog._user_locks[name]
        cv.notify_all()


@dataclasses.dataclass
class Result:
    columns: List[str]
    rows: List[Tuple]
    affected: int = 0
    elapsed_s: float = 0.0
    types: Optional[List[SQLType]] = None  # per-column, for wire encoding

    def sorted(self) -> List[Tuple]:
        return sorted(self.rows, key=lambda r: tuple((v is None, str(v)) for v in r))


def _walk_dataclasses(obj, fn, _seen=None):
    """Pre-order walk over a dataclass tree (lists/tuples/dicts
    descended); fn(node) on every dataclass instance."""
    if _seen is None:
        _seen = set()
    if isinstance(obj, (list, tuple)):
        for x in obj:
            _walk_dataclasses(x, fn, _seen)
        return
    if isinstance(obj, dict):
        for x in obj.values():
            _walk_dataclasses(x, fn, _seen)
        return
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        return
    if id(obj) in _seen:
        return
    _seen.add(id(obj))
    fn(obj)
    for f in dataclasses.fields(obj):
        _walk_dataclasses(getattr(obj, f.name), fn, _seen)


def _without_literal_rows(s):
    """An INSERT whose VALUES rows are literals only, with the rows left
    out: the whole-statement walks (table references, refused clauses)
    find nothing in literals, and walking a 1,000-row VALUES list costs
    more than the INSERT itself."""
    if isinstance(s, ast.Insert) and s.rows and all(
            type(v) is ast.Const for row in s.rows for v in row):
        return dataclasses.replace(s, rows=[])
    return s


def _count_params(stmt) -> int:
    mx = [-1]

    def see(n):
        idx = getattr(n, "param_index", None)
        if isinstance(n, ast.Const) and idx is not None:
            mx[0] = max(mx[0], idx)

    _walk_dataclasses(stmt, see)
    return mx[0] + 1


def _bind_ast_params(stmt, values) -> None:
    """Write EXECUTE's values into the '?' Const nodes of a copy of the
    template, in place. A bound parameter is a plain literal: the port
    replans every EXECUTE (its plans are eager torch, with no trace to
    keep), so no runtime slot survives binding."""

    def see(n):
        idx = getattr(n, "param_index", None)
        if isinstance(n, ast.Const) and idx is not None:
            n.value = values[idx]
            n.type_hint = None
            n.param_index = None

    _walk_dataclasses(stmt, see)


def _refs_table(node, name: str) -> bool:
    """Does this AST subtree reference table ``name`` (unqualified)?"""
    if isinstance(node, ast.TableRef):
        if node.db is None and node.name.lower() == name.lower():
            return True
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return any(_refs_table(getattr(node, f.name), name) for f in dataclasses.fields(node))
    if isinstance(node, (list, tuple)):
        return any(_refs_table(x, name) for x in node)
    return False


def _render_plan(plan, depth: int, out: List[str], catalog=None, resolver=None) -> None:
    """EXPLAIN's lines: one per node, indented by depth, with the
    estimated rows ``est_rows`` annotated and, for a Selection over a
    Scan, the access path the executor takes over the catalog's tables
    and the partitions it keeps (the JAX package's ``_render_plan``).
    `resolver` gives the (table, version) the run would read, so a pinned
    or stale reader's EXPLAIN prunes with the defs of its version."""
    from tidb_tpu_torch.planner import logical as L
    from tidb_tpu_torch.planner.physical import (
        _extract_index_merge, _extract_pk_range, _prune_partitions, partition_label,
    )

    pad = "  " * depth
    name = type(plan).__name__
    detail = ""
    if isinstance(plan, L.Scan):
        detail = f" table={plan.db}.{plan.table} cols={len(plan.columns)}"
    elif isinstance(plan, L.Selection):
        detail = f" pred={plan.predicate!r}"
        if catalog is not None and isinstance(plan.child, L.Scan):
            def current(db, tb):
                return catalog.table(db, tb), 0

            r = _extract_pk_range(plan.predicate, plan.child, current)
            mr = None if r is not None else _extract_index_merge(
                plan.predicate, plan.child, current)
            if r is not None:
                col, lo, hi = r
                detail += f" access=IndexRangeScan({col} in [{lo}, {hi}])"
            elif mr is not None:
                def b(v, open_s):
                    return open_s if abs(v) >= (1 << 62) else v

                spans = " | ".join(f"{c}[{b(lo, '-inf')},{b(hi, 'inf')}]" for c, lo, hi in mr)
                detail += f" access=IndexMerge(union: {spans})"
            res = resolver or (lambda db, tb: (catalog.table(db, tb), catalog.table(db, tb).version))
            pp = _prune_partitions(plan.predicate, plan.child, res)
            if pp is not None:
                detail += partition_label(*res(plan.child.db, plan.child.table), pp)
    elif isinstance(plan, L.Aggregate):
        detail = (f" groups={[n for n, _ in plan.group_exprs]}"
                  f" aggs={[f'{f}({n})' for n, f, _, _ in plan.aggs]}")
    elif isinstance(plan, L.JoinPlan):
        detail = f" kind={plan.kind} keys={len(plan.equi_keys)}"
        if plan.broadcast:
            detail += f" broadcast={plan.broadcast}"
    elif isinstance(plan, L.Sort):
        detail = f" keys={len(plan.keys)}"
    elif isinstance(plan, L.Limit):
        detail = f" limit={plan.count} offset={plan.offset}"
    elif isinstance(plan, L.Projection):
        detail = f" exprs={[n for n, _ in plan.exprs]}{' +base' if plan.additive else ''}"
    est = getattr(plan, "est", None)
    if est is not None:
        detail += f" est={est:.0f}"
    out.append(pad + name + detail)
    for attr in ("child", "left", "right"):
        c = getattr(plan, attr, None)
        if c is not None:
            _render_plan(c, depth + 1, out, catalog, resolver)
    for c in getattr(plan, "children", []) or []:
        _render_plan(c, depth + 1, out, catalog, resolver)


def _present(v, t: Optional[SQLType]):
    """A raw temporal value as the tableless surface shows it."""
    if t is None or v is None:
        return v
    if t.kind == Kind.DATE:
        return days_to_date(int(v))
    if t.kind == Kind.DATETIME:
        return micros_to_datetime(int(v))
    if t.kind == Kind.TIME:
        return micros_to_time(int(v))
    return v


def _mysql_round(f: float) -> int:
    """CAST to an integer: MySQL rounds half away from zero."""
    return int(math.floor(f + 0.5) if f >= 0 else math.ceil(f - 0.5))


def _concat_str(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float) and math.isfinite(v) and v == int(v):
        return str(int(v))
    return str(v)


_CONST_BINARY = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "eq": operator.eq, "ne": operator.ne, "lt": operator.lt, "le": operator.le,
    "gt": operator.gt, "ge": operator.ge,
}
_CONST_HOST_OPS = set(_CONST_BINARY) | {
    "div", "neg", "not", "and", "or", "coalesce", "isnull", "isnotnull", "cast",
    "concat", "concat_ws",
}


class Session(DDLMixin, ConstraintMixin, AdminMixin):
    def __init__(
        self,
        catalog: Optional[Catalog] = None,
        db: str = "test",
        device=None,
        user: str = "root",
    ):
        base = catalog if catalog is not None else Catalog()
        if isinstance(base, _SessionCatalog):
            base = base._base  # one overlay per session, never stacked
        self.catalog = _SessionCatalog(base)
        self.db = db
        self.user = user
        self.device = resolve_device(device)
        self.executor = PhysicalExecutor(self.catalog, device=self.device)
        self.vars = SysVars(self.catalog.global_sysvars)
        self.user_vars: Dict[str, object] = {}
        # prepared statements: name -> {"ast", "nparams"} or, where the
        # grammar cannot hold a '?' (LIMIT ?), {"textual", "nparams"}
        self._prepared: Dict[str, dict] = {}
        self.conn_id = self.catalog.next_conn_id()
        self.last_insert_id = 0
        self._found_rows = 0
        self._last_affected = -1
        self._depth = 0
        # the executor values last taken from the sysvars (the
        # executor's own defaults, which the variables' defaults mean)
        self._applied = {"quota_bytes": None, "stream_rows": -1}
        # the open transaction: pins (key -> snapshot version), shadows
        # (key -> written copy), base_versions (key -> version at first
        # touch, the commit's conflict baseline), savepoints, read_only,
        # pin_objs, and once locks are taken txn_id / locked; None under
        # autocommit
        self._txn: Optional[dict] = None
        self.executor.table_hook = self._resolve_table_for_read
        # one record per recursive CTE the last statement materialized:
        # its name, steps, rows, and the seconds of its steps (the first
        # and the slowest too)
        self.cte_log: List[dict] = []
        # KILL and max_execution_time: the executor polls the killer at
        # its safepoints; cleared with the deadline per top-level statement
        self.killer = SQLKiller()
        self.executor.kill_check = self.killer.check
        self._killed_conn = False  # KILL CONNECTION: every later statement raises
        self.catalog._session_registry[self.conn_id] = self
        # SHOW PROCESSLIST: (statement text, start) while one runs
        self._current_stmt: Optional[tuple] = None
        # the diagnostics area (SHOW WARNINGS): (Level, Code, Message),
        # cleared by every statement but SHOW WARNINGS itself
        self._warnings: List[tuple] = []
        self._stmt_count = 0
        self._select_count = 0
        self._start_ts = time.time()
        # stale reads: the statement's AS OF TIMESTAMP per (db, table),
        # and whether tidb_read_staleness applies (a top-level read)
        self._stmt_as_of: Dict[tuple, float] = {}
        self._stale_ok = False
        # LASTVAL() per (db, sequence): this session's last NEXTVAL
        self._seq_lastval: Dict[tuple, int] = {}
        # TRACE's spans, the plan of the last read (the slow log's plan
        # capture) and the resource group statements are billed to
        self.tracer = Tracer()
        self._last_plan = None
        self._reads_open = 0  # _run_select's depth: only the outer one is phased
        self.resource_group = "default"
        # its advisory locks (GET_LOCK) go with the session
        weakref.finalize(self, _release_session_locks, base, self.conn_id)

    def execute(self, sql: str) -> Result:
        t_parse = time.perf_counter()
        stmts, toks = parse_tokens(sql)
        parse_s = time.perf_counter() - t_parse
        res = Result([], [])
        for i, s in enumerate(stmts):
            if len(stmts) == 1:
                # a single statement's text: its digest (from the parse's
                # own tokens) matches bindings and keys the statement
                # summary, and SHOW PROCESSLIST prints it; a batch's
                # statements are digested by their kind, as in the JAX
                # package
                s._source_sql = sql
                s._source_toks = toks
            # the batch parses once: its parse is the first statement's
            res = self._run_top(s, parse_s if i == 0 else 0.0, t_parse if i == 0 else None)
        return res

    def close(self) -> None:
        """End the session: an open transaction rolls back, releasing
        its table locks and pins."""
        self._abort_txn()

    def _run_top(self, s, parse_s: float = 0.0, t_start: Optional[float] = None) -> Result:
        """One statement: the table locks it needs first, waiting
        outside the statement lock, then its execution inside it.
        Statement-scoped locks are released when it ends. EXECUTE binds
        first, so that the bound statement takes its own locks here. KILL
        and SHOW PROCESSLIST touch host state only and take no lock: a
        KILL must reach a statement that holds the statement lock.

        A top-level statement has a flight and an engine-watch record
        open on this thread while it runs (``parse_s`` is its parse,
        ``t_start`` when the parse began). Its session's resource group
        gates it before the table locks, with the killer armed, and bills
        it after. The statement summary, the slow log and the counters
        take it after the statement lock is let go, so that no other
        connection waits on them."""
        if self._killed_conn:
            raise ConnectionError(f"connection {self.conn_id} was killed")
        if isinstance(s, ast.ExecuteStmt):
            vals = []
            for v in s.using:
                if v not in self.user_vars:
                    raise ValueError(f"user variable @{v} is not set")
                vals.append(self.user_vars[v])
            return self.execute_prepared(s.name, vals, _source=(s, parse_s, t_start))
        inner = s.stmt if isinstance(s, ast.Trace) else s
        self._check_ported(inner)
        top = self._depth == 0
        t0 = time.perf_counter() if t_start is None else t_start
        if top:
            self._open_records(s, parse_s)
        waited = 0.0
        bill_t0 = t0 if top else None
        try:
            if isinstance(s, ast.Kill) or (isinstance(s, ast.Show) and s.what == "processlist"):
                res = self._execute_stmt(s)
            else:
                if top:
                    # armed and listed before the RU gate and the table
                    # locks: a KILL, the watchdog or the deadline ends a
                    # statement waiting on either, and SHOW PROCESSLIST
                    # shows it waiting
                    limit_ms = int(self.vars.get("max_execution_time") or 0)
                    self.killer.clear(
                        deadline=time.monotonic() + limit_ms / 1000.0 if limit_ms else 0.0)
                    self._current_stmt = (getattr(s, "_source_sql", type(s).__name__), time.time())
                try:
                    if top and self.resource_group != "default":
                        # RU governance: wait while the group's bucket is
                        # overdrawn; the wait is not billed
                        bill_t0 = None
                        waited = self.catalog.resource_groups.acquire(
                            self.resource_group, kill_check=self.killer.check)
                        bill_t0 = time.perf_counter()
                    release = self._take_locks(inner)
                    try:
                        with statement_lock(self.device):
                            t1 = time.perf_counter()
                            res = self._execute_stmt(s)
                            res.elapsed_s = time.perf_counter() - t1
                    finally:
                        release()
                finally:
                    if top:
                        self._current_stmt = None
        except Exception as e:
            if top:
                _C_ERRORS.inc()
                try:
                    # a killed statement is observed all the same: its
                    # latency and phases are what a max_execution_time
                    # is tuned by
                    self._close_records(s, time.perf_counter() - t0 - waited, None, bill_t0,
                                        observe=isinstance(e, _sk.QueryKilled))
                except Exception:
                    pass  # observation never masks the statement's error
            raise
        if top:
            self._close_records(s, time.perf_counter() - t0 - waited, res, bill_t0)
        return res

    def _open_records(self, s, parse_s: float) -> None:
        """Open the statement's engine-watch record and flight on this
        thread; the parse is the flight's first phase."""
        sql = getattr(s, "_source_sql", None) or type(s).__name__
        ENGINE_WATCH.begin_query(sql)
        FLIGHT.begin(sql, self.conn_id)
        if parse_s:
            FLIGHT.note_phase("parse", parse_s)

    def _close_records(self, s, elapsed_s: float, res, bill_t0, observe: bool = True) -> None:
        """The statement's end: its observation (none for a statement
        that raised, other than a killed one), its engine-watch record
        into the ring, an unobserved flight dropped, and its RU bill."""
        try:
            if observe:
                self._observe_stmt(s, elapsed_s, res)
        finally:
            ENGINE_WATCH.end_query(elapsed_s)
            FLIGHT.discard()
            if bill_t0 is not None:
                try:
                    self.catalog.resource_groups.debit(
                        self.resource_group, max(time.perf_counter() - bill_t0, 0.0))
                except Exception:
                    pass  # billing never fails the statement

    def _stmt_digest(self, s) -> str:
        """The statement's digest, made once: from the tokens its parse
        read, or (a batch's statement, a bound one with no text) from its
        kind's name."""
        d = getattr(s, "_digest", None)
        if d is None:
            toks = getattr(s, "_source_toks", None)
            d = s._digest = (digest_tokens(toks) if toks is not None else sql_digest(
                getattr(s, "_source_sql", None) or type(s).__name__))
        return d

    def _observe_stmt(self, s, elapsed_s: float, result=None) -> None:
        """The counters, the flight's close into the statement summary,
        and the slow log (the JAX session's ``_observe_stmt``): the slow
        log takes a statement of at least ``tidb_slow_log_threshold`` ms
        while ``slow_query_log`` is on, with its phases and, under
        ``tidb_record_plan_in_slow_log``, its plan."""
        _C_STATEMENTS.inc()
        _H_LATENCY.observe(elapsed_s)
        sql = getattr(s, "_source_sql", None) or type(s).__name__
        FLIGHT.note_engine(ENGINE_WATCH.current())
        if result is not None:
            FLIGHT.note_rows_sent(len(result.rows))
        flight = FLIGHT.finish(elapsed_s)
        digest = self._stmt_digest(s)
        STMT_SUMMARY.record(sql, elapsed_s, flight=flight, digest=digest)
        # the history's windows close at statement cadence (the JAX
        # package closes them from its time-series sampler's tick)
        STMT_HISTORY.maybe_rotate(STMT_SUMMARY)
        try:
            if not bool(self.vars.get("slow_query_log")):
                return
            thresh_ms = int(self.vars.get("tidb_slow_log_threshold"))
        except Exception:
            return
        if elapsed_s * 1000.0 < thresh_ms:  # 0 logs everything
            return
        phases = plan_text = ""
        if flight is not None:
            phases = " ".join(f"{p}={sec * 1e3:.3f}ms" for p, sec, _b, _r in flight.timeline())
            # the switch gates every capture, EXPLAIN ANALYZE's lines too
            if bool(self.vars.get("tidb_record_plan_in_slow_log")):
                plan_text = flight.plan_text or self._capture_slow_plan(s)
            flight.plan_text = plan_text
            if plan_text:
                c_slow_captures().inc()
        SLOW_LOG.record(sql, elapsed_s, digest=digest, conn_id=self.conn_id, phases=phases,
                        plan=plan_text, log_file=self._slow_log_file())

    def _slow_log_file(self) -> Optional[str]:
        """The tidb_slow_query_file sink, only where the variable was set
        (session or global): the default path is advertised, not
        written, so that an embedded engine writes no file of its own."""
        sv = self.vars
        if "tidb_slow_query_file" in sv._session or "tidb_slow_query_file" in sv._globals:
            return str(sv.get("tidb_slow_query_file")) or None
        return None

    def _capture_slow_plan(self, s) -> str:
        """A slow read's plan: the tree of the statement's last plan, as
        EXPLAIN renders it."""
        if not isinstance(s, _READS) or self._last_plan is None:
            return ""
        try:
            lines: List[str] = []
            _render_plan(self._last_plan, 0, lines, catalog=self.catalog,
                         resolver=self._resolve_table_for_read)
            return "\n".join(lines)
        except Exception:
            return ""  # plan capture never fails the statement

    def _execute_stmt(self, s) -> Result:
        top = self._depth == 0
        self._depth += 1
        try:
            if top:
                self._begin_statement(s)
            res = self._dispatch(s)
        finally:
            self._depth -= 1
            if top:
                self._current_stmt = None
        if self._depth == 0 and isinstance(s, _DML):
            self._maybe_auto_analyze(s)
        if self._depth == 0:
            # FOUND_ROWS()/ROW_COUNT() session state (builtin_info.go)
            if isinstance(s, _READS):
                self._found_rows = len(res.rows)
                self._last_affected = -1
            else:
                self._last_affected = int(res.affected)
        return res

    def _begin_statement(self, s) -> None:
        """A top-level statement's start (the JAX session's prologue):
        its counters, the diagnostics area, the current killer and the
        stale-read state; the processlist entry where ``_run_top`` did
        not set it before the table locks (KILL, SHOW PROCESSLIST).
        ``tidb_read_staleness`` applies to a read only; an AS OF inside a
        DML is refused rather than read fresh."""
        self.cte_log = []
        self._stmt_count += 1
        if isinstance(s, _READS):
            self._select_count += 1
        if not (isinstance(s, ast.Show) and s.what == "warnings"):
            self._warnings = []
        # SLEEP polls this session's killer through the thread-local, and
        # lets the statement lock go while it sleeps
        _sk.set_current(self.killer, statement_lock(self.device))
        if self._current_stmt is None:  # KILL and SHOW PROCESSLIST
            self._current_stmt = (getattr(s, "_source_sql", type(s).__name__), time.time())
        self._stale_ok = isinstance(s, _READS)
        inner = s
        while isinstance(inner, (ast.Explain, ast.PlanReplayer, ast.Trace)):
            inner = inner.stmt
        self._stmt_as_of = {}
        if isinstance(inner, _READS):
            self._stmt_as_of = self._collect_as_of(inner)
        elif any(r.as_of is not None
                 for r in ast.iter_table_refs(_without_literal_rows(inner))):
            raise ValueError("AS OF TIMESTAMP is only allowed in read-only statements")

    def _dispatch(self, s) -> Result:
        inject("session/stmt-start")
        self._enforce_privileges(s)
        self._apply_sysvars()
        if isinstance(s, _READS):
            return self._run_select(self._resolve_session_funcs(s))
        if isinstance(s, ast.Insert):
            return self._run_insert(s)
        if isinstance(s, ast.Delete):
            return self._run_delete(s)
        if isinstance(s, ast.Update):
            return self._run_update(s)
        if isinstance(s, ast.LoadData):
            return self._run_load_data(s)
        if isinstance(s, ast.ImportInto):
            return self._run_import_into(s)
        if isinstance(s, ast.AdminStmt):
            return self._run_admin(s)
        if isinstance(s, ast.TxnControl):
            return self._run_txn_control(s)
        if isinstance(s, ast.CreateTable):
            return self._run_create_table(s)
        if isinstance(s, ast.DropTable):
            # a temporary table first, then the shared one
            db = s.db or self.db
            t = self.catalog.table(db, s.name) if self.catalog.has_table(db, s.name) else None
            self.catalog.drop_table(db, s.name, s.if_exists, temporary_only=s.temporary)
            if t is not None:
                _scan.release(t)
            return Result([], [])
        if isinstance(s, ast.CreateSequence):
            seq = Sequence(s.name.lower(), start=s.start, increment=s.increment,
                           minvalue=s.minvalue, maxvalue=s.maxvalue, cycle=s.cycle,
                           cache=s.cache)
            self.catalog.create_sequence(s.db or self.db, s.name, seq, s.if_not_exists)
            return Result([], [])
        if isinstance(s, ast.DropSequence):
            self.catalog.drop_sequence(s.db or self.db, s.name, s.if_exists)
            return Result([], [])
        if isinstance(s, ast.TruncateTable):
            # the rows go first, then the children's ON DELETE actions
            # against empty sets; a RESTRICT restores every table
            t = self._resolve_table_for_write(s.db or self.db, s.name)
            self._clear_with_actions(t, s.db or self.db, s.name, t.nrows)
            t.autoinc_next = 1  # TRUNCATE resets AUTO_INCREMENT (DDL)
            return Result([], [])
        if isinstance(s, ast.CreateView):
            return self._run_create_view(s)
        if isinstance(s, ast.DropView):
            self.catalog.drop_view(s.db or self.db, s.name, s.if_exists)
            return Result([], [])
        if isinstance(s, ast.CreateDatabase):
            self.catalog.create_database(s.name, s.if_not_exists)
            return Result([], [])
        if isinstance(s, ast.DropDatabase):
            for name in self.catalog.tables(s.name):
                _scan.release(self.catalog.table(s.name, name))
            self.catalog.drop_database(s.name)
            return Result([], [])
        if isinstance(s, ast.AnalyzeTable):
            analyze_table(self.catalog.table(s.db or self.db, s.name), device=self.device)
            return Result([], [])
        if isinstance(s, ast.UseDatabase):
            name = s.name.lower()
            if name not in ("information_schema", "metrics_schema") and (
                    name not in self.catalog.databases()):
                raise ValueError(f"unknown database {s.name}")
            self.db = name
            return Result([], [])
        if isinstance(s, ast.Show):
            return self._run_show(s)
        if isinstance(s, ast.SetVariable):
            if s.scope == "user":
                self.user_vars[s.name.lstrip("@")] = s.value
            else:
                self.vars.set(s.name, s.value, s.scope)
                if s.name.lower() in _WATCHDOG_KNOBS:
                    # the instance watchdog starts at the first touch of
                    # one of its knobs (memoryusagealarm/servermemorylimit)
                    from tidb_tpu_torch.utils.watchdog import ensure_watchdog

                    ensure_watchdog(self.catalog)
                if s.name.lower() == "tidb_gc_life_time":
                    # the storage GC horizon is engine-wide; the variable
                    # is GLOBAL-only, so the global store holds the value
                    set_gc_life(float(self.vars._globals.get("tidb_gc_life_time", 0)))
                elif s.name.lower() == "tidb_stmt_summary_refresh_interval":
                    # the summary history closes a window per interval
                    try:
                        STMT_HISTORY.refresh_interval_s = max(
                            float(self.vars.get("tidb_stmt_summary_refresh_interval")), 0.001)
                    except (TypeError, ValueError):
                        pass  # a compatibility knob: only a number re-tunes
                elif s.name.lower() == "tidb_stmt_summary_history_size":
                    try:
                        STMT_HISTORY.set_capacity(int(self.vars.get("tidb_stmt_summary_history_size")))
                    except (TypeError, ValueError):
                        pass
            return Result([], [])
        if isinstance(s, ast.CreateUser):
            self.catalog.users.create_user(s.name, s.password, s.if_not_exists)
            return Result([], [])
        if isinstance(s, ast.DropUser):
            self.catalog.users.drop_user(s.name, s.if_exists)
            return Result([], [])
        if isinstance(s, ast.GrantStmt):
            db = s.db if s.db else self.db
            op = self.catalog.users.revoke if s.revoke else self.catalog.users.grant
            op(set(s.privs), db, s.table, s.user)
            return Result([], [])
        if isinstance(s, ast.CreateBinding):
            return self._run_binding(s)
        if isinstance(s, ast.BackupRestore):
            return self._run_backup_restore(s)
        if isinstance(s, ast.Kill):
            target = self.catalog._session_registry.get(s.conn_id)
            if target is None:
                raise ValueError(f"unknown connection id {s.conn_id}")
            # both forms stop the running statement at its next safepoint;
            # KILL CONNECTION also ends the session: every later statement
            # on it raises
            target.killer.kill()
            if not s.query_only:
                target._killed_conn = True
            return Result([], [])
        if isinstance(s, ast.Do):
            # evaluate and discard
            self._run_select(self._resolve_session_funcs(ast.Select(
                items=[ast.SelectItem(e, alias=f"_do{i}") for i, e in enumerate(s.exprs)],
                from_=None)))
            return Result([], [])
        if isinstance(s, ast.Noop):
            return Result([], [])  # FLUSH, LOCK TABLES, UNLOCK TABLES
        if isinstance(s, ast.OptimizeTable):
            rows = []
            for db, name in s.tables:
                db = db or self.db
                self.catalog.table(db, name)  # existence check
                self._dispatch(ast.AnalyzeTable(db, name))
                rows.append((f"{db}.{name}", "optimize", "note",
                             "Table does not support optimize, doing recreate + analyze instead"))
                rows.append((f"{db}.{name}", "optimize", "status", "OK"))
            return Result(["Table", "Op", "Msg_type", "Msg_text"], rows)
        if isinstance(s, ast.SetNames):
            # connector handshake (reference: pkg/executor/set.go
            # setCharset): latch the character_set_*/collation vars
            cs = s.charset.lower()
            coll = s.collation.lower() if s.collation else CHARSET_DEFAULTS.get(cs)
            if coll is None:
                raise ValueError(f"Unknown character set: '{cs}'")
            for v in ("character_set_client", "character_set_connection",
                      "character_set_results"):
                self.vars.set(v, cs, "session")
            self.vars.set("collation_connection", coll, "session")
            return Result([], [])
        if isinstance(s, ast.SetTransaction):
            if s.isolation is not None:
                self.vars.set("transaction_isolation", s.isolation, s.scope)
            if s.access == "only":
                self.vars.set("transaction_read_only", 1, s.scope)
            elif s.access == "write":
                self.vars.set("transaction_read_only", 0, s.scope)
            return Result([], [])
        if isinstance(s, ast.PrepareStmt):
            self.prepare(s.name, s.sql)
            return Result([], [])
        if isinstance(s, ast.DeallocateStmt):
            self.deallocate(s.name)
            return Result([], [])
        if isinstance(s, ast.Explain):
            return self._run_explain(s)
        if isinstance(s, ast.Trace):
            # the inner statement runs nested: it is the TRACE's, and the
            # TRACE is what the summary and the slow log record
            self.tracer.enabled = True
            self.tracer.reset()
            try:
                with self.tracer.span("execute"):
                    self._execute_stmt(s.stmt)
            finally:
                self.tracer.enabled = False
            return Result(["operation", "startTS", "duration"], self.tracer.rows())
        if isinstance(s, ast.PlanReplayer):
            return self._run_plan_replayer(s)
        if isinstance(s, ast.ResourceGroupDDL):
            rg = self.catalog.resource_groups
            if s.action == "create":
                rg.create(s.name, s.ru_per_sec, bool(s.burstable), if_not_exists=s.if_not_exists)
            elif s.action == "alter":
                rg.alter(s.name, s.ru_per_sec, s.burstable)
            else:
                rg.drop(s.name, if_exists=s.if_exists)
            return Result([], [])
        if isinstance(s, ast.SetResourceGroup):
            self.catalog.resource_groups.get(s.name)  # it must exist
            self.resource_group = s.name.lower()
            return Result([], [])
        if isinstance(s, ast.CreateIndex):
            self._run_create_index(s)
            return Result([], [])
        if isinstance(s, ast.DropIndex):
            self._run_drop_index(s)
            return Result([], [])
        if isinstance(s, ast.RenameTable):
            self._run_rename_table(s)
            return Result([], [])
        if isinstance(s, ast.AlterTable):
            self._run_alter_table(s)
            return Result([], [])
        if isinstance(s, ast.MultiAlter):
            self._run_multi_alter(s)
            return Result([], [])
        raise NotImplementedError(f"{type(s).__name__} statements are not ported yet")

    def _check_ported(self, s) -> None:
        """Refuse, before any lock is taken, a statement this slice
        leaves out, or a clause whose effect it does not port (one that
        would be read and then ignored), naming it."""
        what = _UNPORTED.get(type(s))
        if what is not None:
            raise NotImplementedError(f"{what} is not ported yet")
        if isinstance(s, _READS + _DML + (ast.CreateTable, ast.Explain)):
            why = self._unported_clause(s)
            if why is not None:
                raise NotImplementedError(why)

    def _unported_clause(self, s) -> Optional[str]:
        """Why `s` is refused, or None: a WITH RECURSIVE below the top of
        a read, or a virtual table whose feature is not ported (an
        information_schema table of views, sequences, partitions or
        foreign keys, a diagnostic table, metrics_schema)."""
        found = []
        # a WITH RECURSIVE runs where a statement's read starts (the JAX
        # package's _run_select); planned inside a subquery it would
        # expand itself without end
        top = {id(s), id(getattr(s, "query", None)), id(getattr(s, "as_query", None))}

        def see(n):
            if isinstance(n, ast.With) and n.recursive and id(n) not in top:
                found.append("EXPLAIN of a WITH RECURSIVE is not supported"
                             if isinstance(s, ast.Explain) else
                             "WITH RECURSIVE inside a subquery is not supported")
            elif isinstance(n, ast.TableRef):
                why = unported_virtual_table(n.db or self.db or "", n.name)
                if why is not None:
                    found.append(why)

        _walk_dataclasses(_without_literal_rows(s), see)
        return found[0] if found else None

    def _apply_sysvars(self) -> None:
        """``tidb_mem_quota_query`` and ``tidb_tpu_stream_rows`` onto the
        executor, read for every statement as the JAX session reads them.
        A value is written when it differs from the one last taken from
        the variables, so an executor attribute a caller set directly
        stands until the variable changes."""
        want = {
            "quota_bytes": int(self.vars.get("tidb_mem_quota_query") or 0) or None,
            "stream_rows": int(self.vars.get("tidb_tpu_stream_rows") or 0) or None,
        }
        for attr, v in want.items():
            if v != self._applied[attr]:
                setattr(self.executor, attr, v)
                self._applied[attr] = v

    # -- privileges ----------------------------------------------------
    def _check_priv(self, priv: str, db: str, table: str = "*") -> None:
        if not self.catalog.users.check(self.user, priv, db, table):
            raise PermissionError(
                f"{priv.upper()} command denied to user {self.user!r} "
                f"for table {db}.{table}"
            )

    def _require_super(self) -> None:
        if not self.catalog.users.is_super(self.user):
            raise PermissionError(f"user {self.user!r} lacks administrative privileges")

    def _require_some_table_priv(self, db: str, name: str, what: str, extra: tuple = ()) -> None:
        """MySQL's rule for metadata statements (SHOW CREATE / COLUMNS /
        INDEX): any privilege on the table suffices."""
        if self.catalog.users.is_super(self.user):
            return
        if not any(self.catalog.users.check(self.user, p, db.lower(), name.lower())
                   for p in ("select", "insert", "update", "delete") + extra):
            raise PermissionError(f"{what} denied to user {self.user!r} on {db}.{name}")

    def _enforce_privileges(self, s) -> None:
        """The JAX session's ``_enforce_privileges`` for the ported
        statements (reference: planbuilder's visitInfo, checked by
        pkg/privilege): SELECT on every catalog table a statement reads,
        INSERT / UPDATE / DELETE on a DML's target, CREATE and DROP for
        DDL (DROP for TRUNCATE); CREATE/DROP USER, GRANT, REVOKE and
        CREATE/DROP BINDING need a super user. Super users skip the walk;
        SET, SHOW, USE, PREPARE, KILL and transaction control are
        unrestricted (SHOW GRANTS FOR another user and the per-table SHOW
        forms check inside ``_run_show``), and EXECUTE checks the bound
        statement."""
        if self.catalog.users.is_super(self.user):
            return

        def reads(node):
            refs = []
            _walk_dataclasses(node, lambda n: refs.append(n) if isinstance(n, ast.TableRef) else None)
            for tr in refs:
                db = (tr.db or self.db).lower()
                # CTE names and derived tables are not catalog tables; a
                # view is checked by its own name (its tables were checked
                # against its creator at CREATE VIEW)
                if self.catalog.has_table(db, tr.name) or self.catalog.has_view(db, tr.name):
                    self._check_priv("select", db, tr.name.lower())

        if isinstance(s, _READS + (ast.Explain,)):
            reads(s)
        elif isinstance(s, _DML):
            priv = {ast.Insert: "insert", ast.Update: "update", ast.Delete: "delete",
                    ast.LoadData: "insert"}[type(s)]
            for db, name in self._dml_lock_tables(s):
                self._check_priv(priv, db.lower(), name.lower())
            # a table read inside the statement (INSERT ... SELECT, a
            # subquery in SET or WHERE) needs SELECT
            reads(s)
        elif isinstance(s, ast.CreateTable):
            self._check_priv("create", (s.db or self.db).lower())
            if s.as_query is not None:
                reads(s.as_query)
        elif isinstance(s, ast.CreateView):
            self._check_priv("create", (s.db or self.db).lower())
            # the creator must read every source now; bare names resolve
            # in the view's database, as the expansion resolves them
            refs = []
            _walk_dataclasses(s.query, lambda n: refs.append(n)
                              if isinstance(n, ast.TableRef) else None)
            for tr in refs:
                db = (tr.db or s.db or self.db).lower()
                if self.catalog.has_table(db, tr.name) or self.catalog.has_view(db, tr.name):
                    self._check_priv("select", db, tr.name.lower())
        elif isinstance(s, (ast.DropTable, ast.TruncateTable, ast.DropView)):
            # MySQL requires DROP for TRUNCATE (it is DDL)
            self._check_priv("drop", (s.db or self.db).lower(), s.name.lower())
        elif isinstance(s, (ast.CreateDatabase, ast.DropDatabase)):
            self._check_priv(
                "create" if isinstance(s, ast.CreateDatabase) else "drop", s.name.lower())
        elif isinstance(s, ast.AnalyzeTable):
            self._check_priv("select", (s.db or self.db).lower(), s.name.lower())
        elif isinstance(s, ast.AlterTable):
            self._check_priv("alter", (s.db or self.db).lower(), s.name.lower())
            if s.action == "rename":
                # the gate of RENAME TABLE: the operation is the same
                self._check_priv("drop", (s.db or self.db).lower(), s.name.lower())
                self._check_priv("create", (s.db or self.db).lower())
        elif isinstance(s, ast.RenameTable):
            for (sdb, sname), (ddb, _dname) in s.pairs:
                self._check_priv("alter", (sdb or self.db).lower(), sname.lower())
                self._check_priv("drop", (sdb or self.db).lower(), sname.lower())
                self._check_priv("create", (ddb or self.db).lower())
        elif isinstance(s, (ast.CreateIndex, ast.DropIndex)):
            self._check_priv("index", (s.db or self.db).lower(), s.table.lower())
        elif isinstance(s, (ast.CreateSequence, ast.DropSequence)):
            self._check_priv("create" if isinstance(s, ast.CreateSequence) else "drop",
                             (s.db or self.db).lower())
        elif isinstance(s, (ast.CreateUser, ast.DropUser, ast.GrantStmt, ast.CreateBinding,
                            ast.AdminStmt)):
            self._require_super()
        elif isinstance(s, ast.ImportInto):
            self._check_priv("insert", (s.db or self.db).lower(), s.table.lower())
        elif isinstance(s, ast.BackupRestore):
            self._require_super()

    # -- BACKUP / RESTORE ----------------------------------------------
    def _run_backup_restore(self, s) -> Result:
        """BACKUP DATABASE db|* TO 'uri' and RESTORE DATABASE db|* FROM
        'uri' (storage/persist.py over storage/external.py). Both act on
        the shared base catalog: the session's temporary tables neither
        ride into a backup nor shadow a restore. A BACKUP takes its
        tables' versions under the statement lock and writes them with
        it let go, and resumes from the checkpoint ledger an interrupted
        one left. A RESTORE publishes a
        new version of every table it writes (or a new table, where the
        backup's schema differs): the old versions' device columns go
        from the scan cache, pruned sets included, with the statistics
        of every table replaced in place."""
        from tidb_tpu_torch.storage.persist import (
            capture_catalog, load_catalog, write_snapshot,
        )

        inject("br/statement")
        dbs = [s.db] if s.db else None
        base = self.catalog._base
        if not s.restore:
            snap = capture_catalog(base, dbs)
            # the captured blocks are immutable: the concatenation, the
            # deflate and the writes run with the statement lock let go,
            # so that other sessions' statements run meanwhile
            with _sk.statement_lock_released():
                write_snapshot(snap, s.path, resume=True)
            return Result([], [])
        want = {d.lower() for d in dbs} if dbs else None
        before = {(db, n): base.table(db, n) for db in base.databases()
                  if want is None or db in want for n in base.tables(db)}
        try:
            load_catalog(s.path, base, dbs=dbs)
        finally:
            for (db, n), t in before.items():
                if base.has_table(db, n) and base.table(db, n) is t:
                    _scan.invalidate(t)
                    t.stats = {}
                else:
                    _scan.release(t)
        return Result([], [])

    # -- session functions ---------------------------------------------
    def _resolve_session_funcs(self, node):
        """Fold session-state functions (DATABASE(), CONNECTION_ID(),
        CURRENT_USER(), ...) and @user variables to constants before
        planning (the reference evaluates these against sessionVars,
        builtin_info.go)."""
        if isinstance(node, SQLType):
            return node
        if isinstance(node, ast.UserVarRef):
            return ast.Const(self.user_vars.get(node.name))
        op = node.op.lower() if isinstance(node, ast.Call) else None
        if op in ("nextval", "lastval", "setval"):
            # once per statement here: a SELECT over many rows gets one
            # value (INSERT ... VALUES advances per row, ``_const_value``)
            return ast.Const(self._seq_func(node))
        if op in _USER_LOCK_FUNCS:
            return ast.Const(self._user_lock_func(node))
        if op == "random_bytes":
            # once per statement, as the JAX session folds it
            n = node.args[0].value if node.args and isinstance(node.args[0], ast.Const) else 1
            if not (1 <= int(n) <= 1024):
                raise ValueError("Data length out of range for random_bytes (1..1024)")
            return ast.Const(os.urandom(int(n)).decode("latin-1"))
        if op in ("tidb_encode_sql_digest", "tidb_decode_sql_digests"):
            return ast.Const(self._digest_func(op, node.args[0] if node.args else None))
        if isinstance(node, ast.Call) and not node.args:
            op = node.op.lower()
            if op == "last_insert_id":
                return ast.Const(int(self.last_insert_id))
            if op in ("database", "schema"):
                return ast.Const(self.db)
            if op in ("current_user", "session_user", "user", "system_user"):
                return ast.Const(f"{self.user}@%")
            if op == "current_role":
                return ast.Const("NONE")
            if op == "tidb_version":
                return ast.Const(
                    f"tidb-tpu {self.vars.get('version')}\nEdition: cuda (torch)"
                )
            if op == "connection_id":
                return ast.Const(int(self.conn_id))
            if op == "found_rows":
                return ast.Const(int(self._found_rows))
            if op == "version":
                return ast.Const(str(self.vars.get("version")))
            if op == "row_count":
                return ast.Const(int(self._last_affected))
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            for f in dataclasses.fields(node):
                setattr(node, f.name, self._resolve_session_funcs(getattr(node, f.name)))
            return node
        if isinstance(node, list):
            return [self._resolve_session_funcs(x) for x in node]
        if isinstance(node, tuple):
            return tuple(self._resolve_session_funcs(x) for x in node)
        return node

    def _seq_func(self, e):
        """NEXTVAL, LASTVAL or SETVAL of a sequence; LASTVAL is this
        session's last NEXTVAL of it."""
        op = e.op.lower()
        a = e.args[0] if e.args else None
        if isinstance(a, ast.Name):
            db, name = (a.table or self.db), a.column
        elif isinstance(a, ast.Const) and isinstance(a.value, str):
            db, name = self.db, a.value
        else:
            raise ValueError(f"{op.upper()} needs a sequence name")
        seq = self.catalog.sequence(db, name)
        key = (db.lower(), name.lower())
        if op == "nextval":
            v = self._seq_lastval[key] = seq.nextval()
            return v
        if op == "lastval":
            return self._seq_lastval.get(key)
        if len(e.args) < 2:
            raise ValueError("SETVAL needs (sequence, value)")
        return seq.setval(self._const_value(e.args[1]))

    def _user_lock_func(self, e):
        """GET_LOCK, RELEASE_LOCK, IS_FREE_LOCK, IS_USED_LOCK and
        RELEASE_ALL_LOCKS: named advisory locks shared by every session
        of the catalog, re-entrant per session and released when the
        session is collected. A GET_LOCK wait ends at its timeout or at a
        KILL of its statement. It lets the device's statement lock go
        while it waits, so that the holder's RELEASE_LOCK can run."""
        op = e.op.lower()
        base = self.catalog._base
        reg, cv = base._user_locks, base._user_locks_cv

        def argval(i):
            a = e.args[i]
            if isinstance(a, ast.Const):
                return a.value
            if isinstance(a, ast.Name):
                return a.column
            raise ValueError(f"{op.upper()} needs literal arguments")

        if op == "release_all_locks":
            with cv:
                n = 0
                for name in [k for k, v in reg.items() if v[0] == self.conn_id]:
                    n += reg.pop(name)[1]
                cv.notify_all()
            return n
        name = str(argval(0)).lower()
        if op == "get_lock":
            timeout = float(argval(1)) if len(e.args) > 1 else 0.0
            deadline = time.monotonic() + max(timeout, 0.0)

            def take() -> bool:
                holder = reg.get(name)
                if holder is not None and holder[0] != self.conn_id:
                    return False
                if holder is None:
                    reg[name] = [self.conn_id, 1]
                else:
                    holder[1] += 1
                return True

            with cv:
                if take():
                    return 1
            # a wait: the statement lock is let go first and taken back
            # after the registry's (every statement takes it first)
            with _sk.statement_lock_released(), cv:
                while not take():
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return 0
                    self.killer.check()
                    cv.wait(min(remaining, 0.1))
                return 1
        with cv:
            holder = reg.get(name)
            if op == "release_lock":
                if holder is None:
                    return None  # never held
                if holder[0] != self.conn_id:
                    return 0  # another session's
                holder[1] -= 1
                if holder[1] <= 0:
                    del reg[name]
                    cv.notify_all()
                return 1
            if op == "is_free_lock":
                return 0 if holder is not None else 1
            return holder[0] if holder is not None else None  # is_used_lock

    def _digest_func(self, op: str, a0):
        """TIDB_ENCODE_SQL_DIGEST(text): the sha256 of the text's
        normalized form. TIDB_DECODE_SQL_DIGESTS(json list): each digest's
        normalized text in the statement summary, or NULL."""
        if not isinstance(a0, ast.Const):
            raise ValueError(f"{op.upper()} supports constant arguments only")
        if a0.value is None:
            return None
        if op == "tidb_encode_sql_digest":
            return hashlib.sha256(sql_digest(str(a0.value)).encode()).hexdigest()
        try:
            digests = json.loads(str(a0.value))
        except Exception:
            return None
        if not isinstance(digests, list):
            return None
        # the summary's keys are the normalized texts; a digest is their sha256
        by_digest = {hashlib.sha256(str(norm).encode()).hexdigest(): str(norm)
                     for norm, _n, _s, _mx, _sample in STMT_SUMMARY.rows()}
        return json.dumps([by_digest.get(str(d)) for d in digests])

    # -- SHOW ----------------------------------------------------------
    def _run_show(self, s: ast.Show) -> Result:
        """The JAX session's ``_run_show``. SHOW ENGINES names the port's
        engine in its comment (the JAX package names its XLA engine); every
        other column is the same."""
        pat = s.db or "%"
        if s.what == "tables":
            # base tables and views in one sorted listing
            return Result(["Tables"], [(t,) for t in sorted(
                self.catalog.tables(self.db) + self.catalog.views(self.db))])
        if s.what == "databases":
            return Result(["Databases"], [(d,) for d in self.catalog.databases()])
        if s.what == "warnings":
            return Result(["Level", "Code", "Message"], list(self._warnings))
        if s.what == "open_tables":
            return Result(["Database", "Table", "In_use", "Name_locked"], [])
        if s.what == "status":
            reg = self.catalog._session_registry
            alive = sum(1 for cid in list(reg) if reg.get(cid) is not None)
            stats = [
                ("Uptime", int(time.time() - self._start_ts)),
                ("Threads_connected", max(alive, 1)),
                ("Questions", self._stmt_count),
                ("Com_select", self._select_count),
                ("Ssl_cipher", ""),
            ]
            return Result(["Variable_name", "Value"],
                          [(k, str(v)) for k, v in stats if sql_like_match(k, pat, ci=True)])
        if s.what == "create_database":
            name = s.db.lower()
            if name not in self.catalog.databases() and name != "information_schema":
                raise ValueError(f"unknown database {s.db}")
            return Result(["Database", "Create Database"], [(
                name, f"CREATE DATABASE `{name}` /*!40100 DEFAULT CHARACTER SET utf8mb4 */")])
        if s.what == "table_status":
            cols = ["Name", "Engine", "Version", "Row_format", "Rows", "Avg_row_length",
                    "Data_length", "Auto_increment", "Collation", "Comment"]
            rows = []
            for tn in sorted(self.catalog.tables(self.db)):
                if not sql_like_match(tn, pat, ci=True):
                    continue
                t = self.catalog.table(self.db, tn)
                n = t.nrows
                width = sum(8 if ty.kind != Kind.STRING else 32 for _c, ty in t.schema.columns)
                rows.append((tn, "tidb_tpu", 10, "Fixed", n, width, n * width,
                             t.autoinc_next if t.autoinc_col else None, "utf8mb4_bin", ""))
            rows += [(vn, None, None, None, None, None, None, None, None, "VIEW")
                     for vn in self.catalog.views(self.db) if sql_like_match(vn, pat, ci=True)]
            return Result(cols, rows)
        if s.what == "collation":
            rows = [
                (name, name.split("_")[0], i,
                 "Yes" if name in CHARSET_DEFAULTS.values() else "", "Yes", 1,
                 "PAD SPACE" if name.endswith("_ci") else "NO PAD")
                for i, name in enumerate(sorted(_coll._REGISTRY), 1)
                if sql_like_match(name, pat, ci=True)
            ]
            return Result(["Collation", "Charset", "Id", "Default", "Compiled", "Sortlen",
                           "Pad_attribute"], rows)
        if s.what == "charset":
            maxlen = {"utf8mb4": 4, "utf8": 3, "utf8mb3": 3, "latin1": 1, "ascii": 1, "binary": 1}
            rows = [(cs, f"{cs} (utf8 internal)", dflt, maxlen.get(cs, 4))
                    for cs, dflt in sorted(CHARSET_DEFAULTS.items())
                    if sql_like_match(cs, pat, ci=True)]
            return Result(["Charset", "Description", "Default collation", "Maxlen"], rows)
        if s.what == "engines":
            return Result(
                ["Engine", "Support", "Comment", "Transactions", "XA", "Savepoints"],
                [("InnoDB", "DEFAULT",
                  "tidb_tpu columnar CUDA engine (InnoDB-compatible surface)",
                  "YES", "NO", "YES")])
        if s.what == "bindings":
            return Result(["Original_sql", "Bind_sql"],
                          [(e["for_sql"], e["using_sql"]) for e in self.catalog.bindings.values()])
        if s.what == "grants":
            user = (s.db or self.user).lower()
            if user != self.user.lower():
                self._require_super()
            return Result([f"Grants for {user}@%"],
                          [(g,) for g in self.catalog.users.show_grants(user)])
        if s.what == "processlist":
            rows = []
            reg = self.catalog._session_registry
            for cid in sorted(reg):
                other = reg.get(cid)  # weak: may vanish mid-walk
                if other is None:
                    continue
                cur = other._current_stmt
                rows.append((cid, other.user, other.db, "Query" if cur is not None else "Sleep",
                             int(time.time() - cur[1]) if cur else 0,
                             str(cur[0])[:100] if cur else None))
            return Result(["Id", "User", "db", "Command", "Time", "Info"], rows)
        if s.what == "variables":
            rows = []
            for name, val in self.vars.all().items():
                if s.db is None or sql_like_match(name, s.db, ci=True):
                    if isinstance(val, bool):
                        val = "ON" if val else "OFF"
                    rows.append((name, str(val)))
            return Result(["Variable_name", "Value"], rows)
        # the per-table forms: columns, create_table, create_view, index
        db, name = s.db.split(".", 1)
        db = db or self.db
        what = {"columns": "SHOW COLUMNS", "create_table": "SHOW CREATE",
                "create_view": "SHOW CREATE", "index": "SHOW INDEX"}[s.what]
        self._require_some_table_priv(db, name, what, extra=("index",) if s.what == "index" else ())
        if s.what == "create_view":
            vdef = self.catalog.view_def(db, name)
            if vdef is None:
                raise ValueError(f"unknown view {db}.{name}")
            sql_text, vcols = vdef
            collist = f" ({', '.join(vcols)})" if vcols else ""
            return Result(["View", "Create View"],
                          [(name.lower(), f"CREATE VIEW `{name.lower()}`{collist} AS {sql_text}")])
        t = self.catalog.table(db, name)
        if s.what == "create_table":
            return Result(["Table", "Create Table"],
                          [(name.lower(), create_table_sql(t).rstrip(";"))])
        pk = list(t.schema.primary_key or [])
        if s.what == "index":
            rows = [(name, "primary", i, cn, 0) for i, cn in enumerate(pk, 1)]
            rows += [(name, iname, i, cn, 0 if iname in t.unique_indexes else 1)
                     for iname in sorted(t.indexes)
                     for i, cn in enumerate(t.indexes[iname], 1)]
            return Result(["Table", "Key_name", "Seq_in_index", "Column_name", "Non_unique"],
                          rows)
        # a UNIQUE index's leading column is UNI, any other index's MUL
        uni = {t.indexes[i][0] for i in t.unique_indexes if t.indexes.get(i)}
        mul = {cols[0] for i, cols in t.indexes.items() if cols and i not in t.unique_indexes}
        return Result(["Field", "Type", "Null", "Key", "Default"], [
            (n, repr(ty).lower(), "NO" if n in pk else "YES",
             "PRI" if n in pk else "UNI" if n in uni else "MUL" if n in mul else "",
             None if t.defaults.get(n) is None else str(t.defaults[n]))
            for n, ty in t.schema.columns
        ])

    # -- prepared statements -------------------------------------------
    def prepare(self, name: str, sql: str) -> None:
        from tidb_tpu_torch.server.protocol import count_placeholders

        try:
            stmts = parse(sql)
        except ValueError:
            # placeholders where the grammar holds no expression (LIMIT
            # ? / OFFSET ?): EXECUTE renders literals into the text
            self._prepared[name.lower()] = {
                "textual": sql, "nparams": count_placeholders(sql),
            }
            return
        if len(stmts) != 1:
            raise ValueError("PREPARE expects exactly one statement")
        self._prepared[name.lower()] = {"ast": stmts[0], "nparams": _count_params(stmts[0])}

    def deallocate(self, name: str) -> None:
        if self._prepared.pop(name.lower(), None) is None:
            raise ValueError(f"unknown prepared statement {name}")

    def execute_prepared(self, name: str, values, _source=None) -> Result:
        """Bind `values` to a copy of the prepared statement and run it,
        planned anew (reference: plan_cache.go; the JAX package's
        runtime-slot fast path is not ported, ROADMAP.md). `_source`:
        the EXECUTE statement that asked, with its parse and start, whose
        text the bound statement is recorded under."""
        ent = self._prepared.get(name.lower())
        if ent is None:
            raise ValueError(f"unknown prepared statement {name}")
        values = list(values)
        inject("session/execute-prepared")
        if len(values) != ent["nparams"]:
            raise ValueError(
                f"statement expects {ent['nparams']} parameters, got {len(values)}"
            )
        if "textual" in ent:
            from tidb_tpu_torch.server.protocol import bind_placeholders

            return self.execute(bind_placeholders(ent["textual"], values))
        s = copy.deepcopy(ent["ast"])
        _bind_ast_params(s, values)
        if _source is None:
            return self._run_top(s)
        src, parse_s, t_start = _source
        for attr in ("_source_sql", "_source_toks"):
            if hasattr(src, attr):
                setattr(s, attr, getattr(src, attr))
        return self._run_top(s, parse_s, t_start)

    # -- bindings ------------------------------------------------------
    def _run_binding(self, s: ast.CreateBinding) -> Result:
        """CREATE / DROP BINDING: a plain SELECT's digest -> the hints of
        the USING statement (reference: pkg/bindinfo). A statement a
        binding matches counts in ``tidbtpu_session_binding_hits_total``."""
        digest = sql_digest(s.for_sql)
        if s.drop:
            self.catalog.bindings.pop(digest, None)
            return Result([], [])
        if not isinstance(parse(s.for_sql)[0], ast.Select):
            raise ValueError("bindings currently apply to plain SELECT statements only")
        hints = tuple(getattr(parse(s.using_sql)[0], "hints", ()) or ())
        if not hints:
            raise ValueError("CREATE BINDING: the USING statement carries no /*+ ... */ hints")
        self.catalog.bindings[digest] = {
            "for_sql": s.for_sql, "using_sql": s.using_sql, "hints": hints,
        }
        return Result([], [])

    def _apply_binding(self, s):
        """A binding whose digest matches this statement's text injects
        its hints."""
        src = getattr(s, "_source_sql", None)
        if not src or not self.catalog.bindings or not isinstance(s, ast.Select):
            return s
        entry = self.catalog.bindings.get(self._stmt_digest(s))
        if entry is not None:
            s.hints = tuple(entry["hints"]) or s.hints
            REGISTRY.counter("tidbtpu_session_binding_hits_total",
                             "statements matched to bindings").inc()
        return s

    # -- SELECT --------------------------------------------------------
    def _run_select(self, s, ctes=None) -> Result:
        """A read. Its hints hold for this statement only: STREAM_ROWS(n)
        streams any aggregate input past n rows, MAX_EXECUTION_TIME(ms)
        sets the statement's deadline from now."""
        if isinstance(s, ast.With) and s.recursive:
            return self._run_recursive_with(s, ctes)
        if isinstance(s, ast.Select) and s.from_ is None:
            return self._run_tableless(s)
        s = self._apply_binding(s)
        old_stream = self.executor.stream_rows
        for name, args in getattr(s, "hints", ()) or ():
            if name == "stream_rows" and args:
                try:
                    self.executor.stream_rows = int(args[0]) or None
                except ValueError:
                    pass
            elif name == "max_execution_time" and args:
                try:
                    self.killer.deadline = time.monotonic() + int(args[0]) / 1000
                except ValueError:
                    pass
        # the spans and phases of the JAX session's _run_select. A read
        # nested in this one's plan (a scalar subquery) charges no phase
        # of its own, and the plan builds inside a wall are the compile
        # phase's, not its: the phases stay additive
        phased = self._reads_open == 0
        self._reads_open += 1
        try:
            t_plan = time.perf_counter()
            c0 = FLIGHT.phase_seconds("compile")
            with self.tracer.span("session.plan"):
                plan = build_query(s, self.catalog, self.db, self._scalar_subquery, ctes)
            t_exec = time.perf_counter()
            c1 = FLIGHT.phase_seconds("compile")
            self._last_plan = plan
            names = [c.name for c in plan.schema]
            batch = None
            with self.tracer.span("executor.run"):
                rows = self._try_host_sorted(plan)
                if rows is None:
                    batch, dicts = self.executor.run(plan)
            t_mat = time.perf_counter()
            if batch is not None:
                with self.tracer.span("session.materialize"):
                    rows = materialize_rows(batch, list(plan.schema), dicts)
            if phased:
                c2 = FLIGHT.phase_seconds("compile")
                FLIGHT.note_phase("plan", t_exec - t_plan - (c1 - c0))
                FLIGHT.note_phase("execute", t_mat - t_exec - (c2 - c1))
                if batch is not None:
                    FLIGHT.note_phase("final-merge", time.perf_counter() - t_mat)
            return Result(names, rows, types=[c.type for c in plan.schema])
        finally:
            self._reads_open -= 1
            self.executor.stream_rows = old_stream

    # -- EXPLAIN -------------------------------------------------------
    def _run_explain(self, s: ast.Explain) -> Result:
        """EXPLAIN: the plan's nodes with their estimated rows. EXPLAIN
        ANALYZE: one instrumented run (``PhysicalExecutor.run_analyze``)
        with each node's rows, time and calls. The JAX package's
        XLACompile row (XLA's compile cost analysis) has no counterpart
        in eager torch and is not printed."""
        from tidb_tpu_torch.planner.cardinality import est_rows

        if not isinstance(s.stmt, (ast.Select, ast.Union, ast.With)):
            raise ValueError("EXPLAIN supports SELECT/UNION/WITH")
        plan = build_query(s.stmt, self.catalog, self.db, self._scalar_subquery)
        if s.analyze:
            _out, _dicts, lines = self.executor.run_analyze(plan)
            # the instrumented lines are the slow log's plan capture
            FLIGHT.note_plan_text("\n".join(lines))
            return Result(["plan"], [(line,) for line in lines])
        est_rows(plan, self.catalog)  # annotates .est on every node
        lines: List[str] = []
        # pruned with the versions the run would read (pins, stale reads)
        _render_plan(plan, 0, lines, self.catalog, resolver=self._resolve_table_for_read)
        return Result(["plan"], [(line,) for line in lines])

    def _run_plan_replayer(self, s: ast.PlanReplayer) -> Result:
        """PLAN REPLAYER DUMP EXPLAIN <stmt>: a zip of the schema DDL,
        statistics, variables, bindings, the SQL and its EXPLAIN
        (utils/planreplayer.py); returns the zip's path."""
        from tidb_tpu_torch.utils.planreplayer import dump_plan_replayer

        explain = self._run_explain(ast.Explain(s.stmt))
        tables: list = []
        for ref in ast.iter_table_refs(s.stmt):
            key = ((ref.db or self.db).lower(), ref.name.lower())
            if key not in tables and self.catalog.has_table(*key):
                tables.append(key)
        return Result(["File"], [(dump_plan_replayer(self, s.sql_text, tables, explain.rows),)])

    # -- recursive CTEs ------------------------------------------------
    # Iterative materialization (reference: CTEExec's seed and recursive
    # iteration, pkg/executor/cte.go:70): each recursive CTE is evaluated
    # to a fixpoint into a scratch table, and the body plans against a
    # plain SELECT over it; the `cte/iterate` failpoint fires at each step.
    @property
    def _CTE_MAX_RECURSION(self) -> int:
        # the cte_max_recursion_depth sysvar (MySQL's default 1000)
        return int(self.vars.get("cte_max_recursion_depth") or 1000)

    def _run_recursive_with(self, s, outer_ctes=None) -> Result:
        """A WITH RECURSIVE read: each CTE that references itself is
        materialized into a scratch table of the ``_cte_scratch``
        database, dropped when the statement ends, whether it raised or
        not. The scratch tables are written directly (no statement, no
        table lock): nothing else can name them."""
        merged = dict(outer_ctes or {})
        scratch: List[Tuple[str, str]] = []
        try:
            for name, q in s.ctes:
                if isinstance(q, ast.Union) and any(_refs_table(sel, name) for sel in q.selects):
                    merged[name] = self._materialize_recursive(name, q, merged, scratch)
                else:
                    merged[name] = q
            return self._run_select(s.body, merged)
        finally:
            dropped = [self.catalog.table(db, t) for db, t in scratch
                       if self.catalog.has_table(db, t)]
            self.executor.forget_tables([t.uid for t in dropped])
            for t in dropped:
                _scan.release(t)
            for db, t in scratch:
                self.catalog.drop_table(db, t, if_exists=True)

    def _materialize_recursive(self, name, q, scope, scratch):
        """Run the seed SELECTs, then the recursive ones over the working
        table (the rows the last step added) until a step adds none,
        appending each step's rows to the CTE's table. UNION (not ALL)
        drops rows seen before. A step past ``cte_max_recursion_depth``
        raises."""
        seeds = [sel for sel in q.selects if not _refs_table(sel, name)]
        steps = [sel for sel in q.selects if _refs_table(sel, name)]
        if not seeds:
            raise ValueError(f"recursive CTE {name!r} has no seed SELECT")
        seed_ast = seeds[0] if len(seeds) == 1 else ast.Union(seeds, q.all)
        r = self._run_select(seed_ast, dict(scope))
        col_names = list(r.columns)
        types = [
            t if (t is not None and t.kind != Kind.NULL) else INT64
            for t in (r.types or [INT64] * len(col_names))
        ]
        rows = list(r.rows)
        seen = None
        if not q.all:
            seen, uniq = set(), []
            for row in rows:
                if row not in seen:
                    seen.add(row)
                    uniq.append(row)
            rows = uniq

        db = "_cte_scratch"
        self.catalog.create_database(db, if_not_exists=True)
        tname = f"{name}_{next(_cte_scratch_seq)}"
        schema = TableSchema(list(zip(col_names, types)))
        tbl = self.catalog.create_table(db, tname, schema)
        scratch.append((db, tname))
        if rows:
            tbl.append_rows(rows)

        # one working table for every step, its content replaced each time
        wname = f"{tname}_w"
        scratch.append((db, wname))
        wt = self.catalog.create_table(db, wname, schema)
        working = rows
        ref_ast = ast.Select(
            items=[ast.SelectItem(ast.Name(None, c), alias=c) for c in col_names],
            from_=ast.TableRef(db, wname),
        )
        rec = {"cte": name, "steps": 0, "rows": len(rows), "seconds": 0.0,
               "first_step_s": 0.0, "max_step_s": 0.0}
        self.cte_log.append(rec)
        while working:
            t0 = time.perf_counter()
            rec["steps"] += 1
            if rec["steps"] > self._CTE_MAX_RECURSION:
                raise ValueError(
                    f"recursive CTE {name!r} exceeded {self._CTE_MAX_RECURSION} iterations")
            inject("cte/iterate")
            wt.clear_rows()
            wt.append_rows(working)
            # the last step's columns and plans over the working table
            # are never read again
            _scan.invalidate(wt)
            self.executor.forget_tables([wt.uid])
            scope2 = dict(scope)
            scope2[name] = ref_ast
            new_rows = []
            for st in steps:
                new_rows.extend(self._run_select(st, scope2).rows)
            if seen is not None:
                fresh = []
                for row in new_rows:
                    if row not in seen:
                        seen.add(row)
                        fresh.append(row)
                new_rows = fresh
            if new_rows:
                tbl.append_rows(new_rows)
            working = new_rows
            took = time.perf_counter() - t0
            rec["rows"] += len(new_rows)
            rec["seconds"] += took
            rec["first_step_s"] = rec["first_step_s"] or took
            rec["max_step_s"] = max(rec["max_step_s"], took)
        return ast.Select(
            items=[ast.SelectItem(ast.Name(None, c), alias=c) for c in col_names],
            from_=ast.TableRef(db, tname),
        )

    def _try_host_sorted(self, plan) -> Optional[List[Tuple]]:
        """A full ORDER BY too large for the device
        (``streamed.try_streamed_sort``): the rows, ordered in host RAM,
        or None. Stale compile-time assumptions retry once with none."""
        try:
            hs = try_streamed_sort(self.executor, plan)
        except StaleWidthsError:
            self.executor.evict_stale(self.executor._cache_key(plan))
            try:
                hs = try_streamed_sort(self.executor, plan, conservative=True)
            except StaleWidthsError:
                hs = None
        if hs is None:
            return None
        names, cols, n, dicts = hs
        types = {c.internal: c.type for c in plan.schema}
        block = HostBlock(
            {m: HostColumn(types[m], cols[m][0], cols[m][1], dicts.get(m)) for m in names}, n
        )
        return block_to_rows(block, list(plan.schema))

    def _scalar_subquery(self, q, ctes=None) -> Literal:
        """Run an uncorrelated scalar subquery as a statement of its own
        (one device->host fetch) and return its value as a Literal:
        NULL for no row, an error for more than one. ``ctes`` carries the
        enclosing WITH scope, if any."""
        r = self._run_select(q, ctes)
        if len(r.columns) != 1:
            raise ValueError("scalar subquery must return one column")
        if len(r.rows) == 0:
            return Literal(value=None)
        if len(r.rows) > 1:
            raise ValueError("scalar subquery returned more than one row")
        v = r.rows[0][0]
        t = r.types[0] if r.types else None
        if t is not None and isinstance(v, str):
            # temporal results present as strings; re-encode to the raw
            # typed form so the literal composes like a temporal column
            # (a string literal's numeric prefix would turn a datetime
            # into its year under arithmetic)
            if t.kind == Kind.DATE:
                return Literal(type=t, value=int(date_to_days(v)))
            if t.kind == Kind.DATETIME:
                return Literal(type=t, value=int(datetime_to_micros(v)))
            if t.kind == Kind.TIME:
                return Literal(type=t, value=int(time_to_micros(v)))
        return Literal(value=v)

    # -- FROM-less SELECT ----------------------------------------------
    def _run_tableless(self, s: ast.Select) -> Result:
        names = [it.alias or _display_name(it.expr) for it in s.items]
        rows = [tuple(self._eval_const_expr(it.expr) for it in s.items)]
        if s.where is not None and not self._eval_const_expr(s.where):
            rows = []
        if s.limit is not None:
            rows = rows[s.offset or 0 : (s.offset or 0) + s.limit]
        return Result(names, rows)

    def _eval_const_expr(self, e):
        """Host evaluation for tableless SELECTs (reference: expression
        folding in the projection over a one-row dual table); what the
        host does not fold runs on the device (``_device_const_eval``)."""
        if isinstance(e, ast.Const):
            return e.value
        if isinstance(e, ast.SysVarRef):
            v = self.vars.get(e.name)
            return ("ON" if v else "OFF") if isinstance(v, bool) else v
        if isinstance(e, ast.SubqueryExpr) and e.modifier is None:
            lit = self._scalar_subquery(e.query)
            return _present(lit.value, lit.type)
        if not isinstance(e, ast.Call) or e.op not in _CONST_HOST_OPS:
            return self._device_const_eval(e)
        args = [self._eval_const_expr(a) for a in e.args]
        if any(a is None for a in args) and e.op not in (
            "isnull", "isnotnull", "coalesce", "concat_ws",
        ):
            return None
        if any(isinstance(a, str) for a in args) and (
            e.op in ("add", "sub", "mul", "div")
            or (e.op in ("eq", "ne", "lt", "le", "gt", "ge")
                and any(isinstance(a, (int, float, bool)) for a in args))
        ):
            # MySQL coerces a string's numeric prefix in arithmetic and
            # in comparisons against a numeric operand
            args = [_mysql_numeric_prefix(a) if isinstance(a, str) else a for a in args]
        if e.op in _CONST_BINARY:
            return _CONST_BINARY[e.op](args[0], args[1])
        if e.op == "div":
            return None if args[1] in (0, None) else args[0] / args[1]
        if e.op == "neg":
            return -args[0]
        if e.op == "not":
            return not args[0]
        if e.op == "and":
            return bool(args[0]) and bool(args[1])
        if e.op == "or":
            return bool(args[0]) or bool(args[1])
        if e.op == "concat":
            return "".join(_concat_str(a) for a in args)
        if e.op == "concat_ws":
            if args[0] is None:
                return None
            return _concat_str(args[0]).join(_concat_str(a) for a in args[1:] if a is not None)
        if e.op == "coalesce":
            return next((a for a in args if a is not None), None)
        if e.op == "isnull":
            return args[0] is None
        if e.op == "isnotnull":
            return args[0] is not None
        # cast
        v, tgt = args[0], e.cast_type
        if tgt is not None and isinstance(v, str):
            if tgt.kind == Kind.INT:
                return _mysql_round(float(_mysql_numeric_prefix(v)))
            if tgt.kind == Kind.FLOAT:
                return float(_mysql_numeric_prefix(v))
        if tgt is not None and isinstance(v, float) and tgt.kind == Kind.INT:
            return _mysql_round(v)
        return v

    def _device_const_eval(self, e):
        """Evaluate a column-free expression through the engine's own
        kernels on a one-row batch on the session's device (the dual-table
        analog; reference: TableDual + expression folding)."""
        bound = ExprBinder(Schema([]), _scalar_subq(self._scalar_subquery)).bind(e)
        b = Batch({}, torch.ones(1, dtype=torch.bool, device=self.device))
        if bound.type is not None and bound.type.kind == Kind.STRING:
            fn, d = string_expr(bound, {})
            c = fn(b)
            if not bool(c.valid[0]) or not len(d):
                return None
            return str(d[int(c.data[0])])
        c = compile_expr(bound, {})(b)
        if not bool(c.valid[0]):
            return None
        v = c.data[0].item()
        t = bound.type
        if t is None:
            return v
        if t.kind == Kind.DECIMAL:
            return v / 10**t.scale
        if t.kind == Kind.BOOL:
            return bool(v)
        return _present(v, t)

    # -- transaction plumbing ------------------------------------------
    def _resolve_table_for_read(self, db: str, name: str):
        """(table, version) a scan reads. A stale read first: the
        statement's AS OF TIMESTAMP for the table, else ``tidb_snapshot``,
        else a non-zero ``tidb_read_staleness`` on a top-level read (which
        reads a table younger than its window at its oldest version);
        each is refused inside a transaction, and information_schema
        tables are never stale. Then the transaction's shadow of a table
        it wrote, else the snapshot pinned at the table's first read in
        the transaction (every statement's newest committed version under
        READ-COMMITTED), else the current version."""
        t = self.catalog.table(db, name)
        key = (db.lower(), name.lower())
        as_of_ts = self._stmt_as_of.get(key)
        if key[0] == "information_schema":
            if as_of_ts is not None:
                raise ValueError(f"AS OF TIMESTAMP is not supported on {key[0]} tables")
            return t, t.version
        clamp = False
        if as_of_ts is None and self._txn is None:
            as_of_ts = self._tidb_snapshot_ts()
        if as_of_ts is None and self._txn is None and self._stale_ok:
            staleness = int(self.vars.get("tidb_read_staleness") or 0)
            if staleness < 0:
                as_of_ts = time.time() + staleness
                clamp = True
        if as_of_ts is not None:
            if self._txn is not None:
                raise ValueError("stale read is not allowed inside a transaction")
            return t, t.version_at(as_of_ts, clamp_oldest=clamp)
        if self._txn is None:
            return t, t.version
        shadow = self._txn["shadows"].get(key)
        if shadow is not None:
            return shadow, shadow.version
        if self._rc_isolation():
            return t, t.version
        if key not in self._txn["pins"]:
            self._txn["pins"][key] = t.version
            t.pin(t.version)  # the snapshot survives writers' GC
            self._txn["pin_objs"].append((t, t.version))
        return t, self._txn["pins"][key]

    def _tidb_snapshot_ts(self) -> Optional[float]:
        """Epoch seconds of the session's ``tidb_snapshot``, or None: an
        epoch number, or a datetime literal in the session time zone."""
        raw = self.vars.get("tidb_snapshot")
        if raw in (None, "", 0):
            return None
        try:
            return float(raw)
        except (TypeError, ValueError):
            dt = datetime.datetime.fromisoformat(str(raw))
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=self._session_tzinfo())
            return dt.timestamp()

    def _session_tzinfo(self):
        """tzinfo of the ``time_zone`` variable: 'UTC' (the default),
        '+HH:MM' / '-HH:MM' offsets, IANA names, or 'SYSTEM' (the host's).
        Anything else raises: a literal read in the wrong zone would
        shift every stale read by the offset."""
        tz = str(self.vars.get("time_zone") or "UTC").strip()
        up = tz.upper()
        if up in ("UTC", "GMT"):
            return datetime.timezone.utc
        if up == "SYSTEM":
            return datetime.datetime.now().astimezone().tzinfo
        if tz and tz[0] in "+-":
            try:
                hh, _sep, mm = tz[1:].partition(":")
                off = datetime.timedelta(hours=int(hh), minutes=int(mm or 0))
                return datetime.timezone(-off if tz[0] == "-" else off)
            except ValueError:
                raise ValueError(f"Unknown or incorrect time zone: {tz!r}")
        try:
            import zoneinfo

            return zoneinfo.ZoneInfo(tz)
        except Exception:
            raise ValueError(f"Unknown or incorrect time zone: {tz!r}")

    def _collect_as_of(self, s) -> dict:
        """The statement's AS OF TIMESTAMP table references: {(db,
        table): epoch seconds}. A read resolves a table by name, so one
        statement that names a table both stale and current, or at two
        timestamps, is refused rather than read at one version."""
        out: dict = {}
        plain: set = set()

        def ts_of(expr) -> float:
            v = self._const_value(expr)
            if isinstance(v, (int, float)):
                return float(v)
            if isinstance(v, str):
                try:
                    return float(v)
                except ValueError:
                    dt = datetime.datetime.fromisoformat(v)
                    if dt.tzinfo is None:
                        # a naive literal is in the session time zone
                        # (version stamps are epoch seconds)
                        dt = dt.replace(tzinfo=self._session_tzinfo())
                    return dt.timestamp()
            raise ValueError(f"cannot evaluate AS OF TIMESTAMP expression: {expr!r}")

        for ref in ast.iter_table_refs(s):
            key = ((ref.db or self.db).lower(), ref.name.lower())
            if ref.as_of is None:
                plain.add(key)
            else:
                ts = ts_of(ref.as_of)
                if out.get(key, ts) != ts:
                    raise ValueError(
                        f"multiple AS OF TIMESTAMP values for table {key[1]!r} in one "
                        "statement are not supported")
                out[key] = ts
        conflict = plain & set(out)
        if conflict:
            raise ValueError(
                "mixing AS OF TIMESTAMP and current-version references to the same table "
                f"{sorted(conflict)[0][1]!r} in one statement is not supported")
        return out

    def _resolve_table_for_write(self, db: str, name: str) -> Table:
        """The table a write goes to: the catalog's under autocommit,
        else the transaction's shadow of it, made at its first write from
        the pinned snapshot. No write runs while ``tidb_snapshot`` is
        set."""
        if self._tidb_snapshot_ts() is not None:
            raise ValueError("can not execute write statement when 'tidb_snapshot' is set")
        t = self.catalog.table(db, name)
        if self._txn is None:
            return t
        if self._txn["read_only"]:
            raise ValueError("cannot execute statement in a READ ONLY transaction")
        key = (db.lower(), name.lower())
        shadow = self._txn["shadows"].get(key)
        if shadow is None:
            pinned = self._txn["pins"].get(key)
            if pinned is None:
                pinned = self._txn["pins"][key] = t.version
                t.pin(t.version)  # survive GC until commit/rollback
                self._txn["pin_objs"].append((t, t.version))
            shadow = Table(t.name, t.schema)
            shadow._versions = {0: list(t.blocks(pinned))}
            shadow.dictionaries = dict(t.dictionaries)
            shadow.indexes = dict(t.indexes)
            shadow.unique_indexes = set(t.unique_indexes)
            shadow.invisible_indexes = set(t.invisible_indexes)
            shadow.index_states = dict(t.index_states)
            shadow.autoinc_col = t.autoinc_col
            shadow.autoinc_next = t.autoinc_next
            shadow.defaults = dict(t.defaults)
            shadow.checks = list(t.checks)
            shadow.fks = list(t.fks)
            shadow.fk_actions = dict(t.fk_actions)
            shadow.fk_update_actions = dict(t.fk_update_actions)
            shadow.generated = list(t.generated)
            shadow.ttl = t.ttl
            # the snapshot's blocks were tagged under the snapshot's defs
            shadow.partition = t.partition_defs_at(pinned)
            # the uniqueness and range indexes are keyed by block uids:
            # the shadow's blocks are the snapshot's, so they carry over
            shadow._key_cache = dict(t._key_cache)
            shadow._idx_cache = dict(t._idx_cache)
            self._txn["shadows"][key] = shadow
            # conflict baseline = version at first touch: a shadow rebuilt
            # after ROLLBACK TO SAVEPOINT must not adopt a newer version
            self._txn["base_versions"].setdefault(key, pinned)
        return shadow

    def _rc_isolation(self) -> bool:
        return str(self.vars.get("transaction_isolation") or "").upper() == "READ-COMMITTED"

    def _pessimistic(self) -> bool:
        return str(self.vars.get("tidb_txn_mode") or "").lower() == "pessimistic"

    def _lock_timeout(self) -> float:
        return float(self.vars.get("innodb_lock_wait_timeout") or 50)

    def _take_locks(self, s):
        """Table locks a statement needs, taken before the statement lock
        (reference: LockKeys of the pessimistic path). Explicit
        pessimistic transaction: a DML's (or FOR UPDATE's) tables stay
        locked until it ends, and each one's snapshot advances to the
        committed version at first lock, so writers serialize instead of
        aborting. Autocommit: the lock spans the statement. COMMIT (and
        the implicit one of BEGIN) locks the written tables for its check
        and install. A deadlock rolls the transaction back and re-raises.
        Returns the release of what is statement-scoped."""
        if isinstance(s, ast.TxnControl) and (
            s.op == "commit" or (s.op == "begin" and self._txn is not None)
        ):
            self._lock_for_commit()
            return lambda: None
        if isinstance(s, _DML):
            tables = self._dml_lock_tables(s)
        elif isinstance(s, (ast.TruncateTable, ast.MultiAlter)):
            tables = [(s.db or self.db, s.name)]
        elif isinstance(s, ast.AlterTable) and s.action in PARTITION_WRITES:
            if self._txn is not None:
                return lambda: None  # refused by the statement itself
            tables = [(s.db or self.db, s.name)]
            if s.exchange is not None:
                tables.append((s.exchange[0] or s.db or self.db, s.exchange[1]))
        elif isinstance(s, _READS):
            tables = self._for_update_tables(s)
            if tables and self._txn is not None and self._txn["read_only"]:
                # locking reads count as writes
                raise ValueError("cannot execute statement in a READ ONLY transaction")
        else:
            return lambda: None
        if not tables:
            return lambda: None
        lm = self.catalog.lock_manager
        keys = [(d.lower(), n.lower()) for d, n in tables]
        if self._txn is not None:
            if not self._pessimistic():
                return lambda: None  # optimistic: buffered in shadows, lock-free
            txn_id = self._txn.setdefault("txn_id", next_txn_id())
            locked = self._txn.setdefault("locked", set())
            try:
                for k in keys:
                    if k in locked:
                        continue
                    lm.acquire(txn_id, k, timeout=self._lock_timeout(),
                               kill_check=self.killer.check)
                    locked.add(k)
                    self._advance_snapshot(k)
            except DeadlockError:
                self._abort_txn()
                raise
            return lambda: None
        sid = next_txn_id()
        try:
            for k in sorted(keys):
                lm.acquire(sid, k, timeout=self._lock_timeout(), kill_check=self.killer.check)
        except BaseException:
            lm.release_all(sid)
            raise
        return lambda: lm.release_all(sid)

    def _lock_for_commit(self) -> None:
        """Lock every table the transaction wrote (sorted: no lock-order
        cycles between committers; a pessimistic transaction holds its
        own already). Excludes autocommit writers and pessimistic holders
        from the commit's check and install. A failure rolls back."""
        txn = self._txn
        if txn is None or not txn["shadows"] or "commit_id" in txn:
            return
        cid = txn["commit_id"] = txn.get("txn_id") or next_txn_id()
        lm = self.catalog.lock_manager
        try:
            for k in sorted(txn["shadows"]):
                lm.acquire(cid, k, timeout=self._lock_timeout(), kill_check=self.killer.check)
        except BaseException:
            self._abort_txn()
            lm.release_all(cid)
            raise

    def _for_update_tables(self, s) -> list:
        """(db, table) of every base table under a FOR UPDATE block,
        searching every SELECT of a query."""
        out = []

        def from_tables(r):
            if isinstance(r, ast.TableRef):
                if self.catalog.has_table(r.db or self.db, r.name):
                    out.append((r.db or self.db, r.name))
            elif isinstance(r, ast.Join):
                from_tables(r.left)
                from_tables(r.right)
            elif isinstance(r, ast.SubqueryRef):
                from_tables(getattr(r.query, "from_", None))

        def walk(q):
            if isinstance(q, ast.Select):
                if q.for_update:
                    from_tables(q.from_)
            elif isinstance(q, ast.Union):
                for sub in q.selects:
                    walk(sub)
            elif isinstance(q, ast.SetOp):
                walk(q.left)
                walk(q.right)
            elif isinstance(q, ast.With):
                for _n, cq in q.ctes:
                    walk(cq)
                walk(q.body)

        walk(s)
        return out

    def _advance_snapshot(self, key) -> None:
        """After a pessimistic lock: read the table at its current
        committed version (nobody else can write it now). Skipped once a
        shadow exists: rewriting it would lose the transaction's own
        writes (the commit's version check still guards that case)."""
        if self._txn is None or key in self._txn["shadows"]:
            return
        t = self.catalog.table(*key)
        cur = t.version
        if self._txn["pins"].get(key) != cur:
            t.pin(cur)
            self._txn["pin_objs"].append((t, cur))
            self._txn["pins"][key] = cur
        self._txn["base_versions"][key] = cur

    def _abort_txn(self) -> None:
        """Roll back the open transaction: unpin, release its locks and
        drop its shadows' device columns."""
        txn, self._txn = self._txn, None
        if not txn:
            return
        for t, v in txn["pin_objs"]:
            t.unpin(v)
        if txn.get("txn_id"):
            self.catalog.lock_manager.release_all(txn["txn_id"])
        self._drop_cached(release=txn["shadows"].values())

    def _drop_cached(self, release=(), invalidate=()) -> None:
        """Scan-cache upkeep after a write: every column of the tables in
        `release` and the superseded versions of those in `invalidate`.
        The cache is shared, so this holds the statement lock."""
        with statement_lock(self.device):
            for t in release:
                _scan.release(t)
            for t in invalidate:
                _scan.invalidate(t)

    def _run_txn_control(self, s) -> Result:
        if s.op == "begin":
            inject("session/begin-txn")
            if self._txn is not None:
                self._commit_txn()  # MySQL: BEGIN implicitly commits
            self._txn = {
                "pins": {}, "shadows": {}, "base_versions": {}, "savepoints": [],
                "pin_objs": [], "read_only": bool(s.read_only),
            }
        elif s.op == "commit":
            self._commit_txn()
        elif s.op == "rollback":
            self._abort_txn()
        elif s.op == "savepoint":
            # outside a transaction a no-op, as MySQL under autocommit
            if self._txn is not None:
                sps = self._txn["savepoints"]
                name = s.name.lower()
                # re-declaring a name moves it
                sps[:] = [x for x in sps if x[0] != name]
                sps.append((name, self._txn_snapshot()))
        elif s.op == "rollback_to":
            self._rollback_to_savepoint(s.name.lower())
        elif s.op == "release":
            if self._txn is not None:
                sps = self._txn["savepoints"]
                idx = [i for i, (n, _) in enumerate(sps) if n == s.name.lower()]
                if not idx:
                    raise ValueError(f"SAVEPOINT {s.name} does not exist")
                # deletes the named savepoint and every later one
                del sps[idx[0]:]
        return Result([], [])

    def _txn_snapshot(self) -> dict:
        """Per-shadow restore state for a savepoint (block lists are
        immutable, so this is O(tables))."""
        return {
            key: (list(sh.blocks()), sh.modify_count, dict(sh.dictionaries), sh.autoinc_next)
            for key, sh in self._txn["shadows"].items()
        }

    def _rollback_to_savepoint(self, name: str) -> None:
        if self._txn is None:
            raise ValueError(f"SAVEPOINT {name} does not exist")
        sps = self._txn["savepoints"]
        idx = [i for i, (n, _) in enumerate(sps) if n == name]
        if not idx:
            raise ValueError(f"SAVEPOINT {name} does not exist")
        _, snap = sps[idx[0]]
        # the named savepoint survives; later ones are destroyed
        del sps[idx[0] + 1:]
        dropped, restored = [], []
        for key in list(self._txn["shadows"]):
            shadow = self._txn["shadows"][key]
            if key not in snap:
                # first written after the savepoint: reads fall back to
                # the pinned base; pins and base_versions stay
                del self._txn["shadows"][key]
                dropped.append(shadow)
                continue
            blocks, modify, dicts, autoinc = snap[key]
            shadow.replace_blocks(blocks)
            shadow.modify_count = modify
            shadow.dictionaries = dict(dicts)
            shadow.autoinc_next = autoinc
            restored.append(shadow)
        self._drop_cached(release=dropped, invalidate=restored)

    def _commit_txn(self) -> None:
        """Install the transaction's shadows, their tables locked
        beforehand (``_lock_for_commit``): under the commit mutex every
        written table must still be at its baseline version (first
        committer wins), then each is installed in one step."""
        if self._txn is None:
            return
        txn, self._txn = self._txn, None
        try:
            inject("session/before-commit")
            with self.catalog._commit_mu:
                for (db, name) in txn["shadows"]:
                    base = self.catalog.table(db, name)
                    inject("session/commit-conflict-check")
                    if base.version != txn["base_versions"][(db, name)]:
                        raise RuntimeError(
                            f"write conflict on {db}.{name}: table changed since transaction start"
                        )
                inject("session/commit-apply")
                for (db, name), shadow in txn["shadows"].items():
                    # direct allocator assign, not max: the check proved
                    # the base unchanged, so TRUNCATE's reset survives
                    self.catalog.table(db, name).install_commit(
                        shadow.blocks(), shadow.dictionaries, shadow.autoinc_next,
                        shadow.modify_count,
                    )
        finally:
            for t, v in txn["pin_objs"]:
                t.unpin(v)
            lock_id = txn.get("commit_id") or txn.get("txn_id")
            if lock_id is not None:
                self.catalog.lock_manager.release_all(lock_id)
            self._drop_cached(
                release=txn["shadows"].values(),
                invalidate=[self.catalog.table(*k) for k in txn["shadows"]
                            if self.catalog.has_table(*k)],
            )

    def _maybe_auto_analyze(self, s) -> None:
        """Statement-boundary auto-analyze after committed DML (inside a
        transaction the base table has not changed yet)."""
        if self._txn is not None or not self.vars.get("tidb_enable_auto_analyze"):
            return
        raw = self.vars.get("tidb_auto_analyze_ratio")
        ratio = 0.5 if raw is None else float(raw)
        db = s.db or self.db
        if not self.catalog.has_table(db, s.table or ""):
            return  # a multi-table UPDATE, or DELETE naming an alias
        maybe_auto_analyze(self.catalog.table(db, s.table), ratio, device=self.device)

    # -- DDL -----------------------------------------------------------
    def _run_create_table(self, s: ast.CreateTable) -> Result:
        db = s.db or self.db
        if s.as_query is not None:
            return self._run_ctas(s, db)
        if s.like is not None:
            src = self.catalog.table(s.like[0] or self.db, s.like[1])
            if s.if_not_exists and self.catalog.has_table(db, s.name):
                return Result([], [])
            # the definition, not the data or the FOREIGN KEYs;
            # AUTO_INCREMENT restarts. The JAX package clones through its
            # rendered DDL, which carries no ENUM, SET or JSON domain, so
            # neither does this
            pk = src.schema.primary_key
            schema = TableSchema(
                list(src.schema.columns), primary_key=list(pk) if pk else None,
                not_null=tuple(src.schema.not_null))
            if s.temporary:
                if src.partition is not None or src.ttl is not None:
                    raise ValueError("temporary tables do not support partitioning/TTL")
                t = self.catalog.create_temp_table(db, s.name, schema)
            else:
                t = self.catalog.create_table(db, s.name, schema)
                t.partition = src.partition
                t.ttl = src.ttl
            t.autoinc_col = src.autoinc_col
            t.defaults = dict(src.defaults)
            t.checks = list(src.checks)
            t.generated = list(src.generated)
            for iname, icols in sorted(src.indexes.items()):
                self._add_index(t, iname, icols, unique=iname in src.unique_indexes)
            return Result([], [])
        schema = TableSchema(
            [(c.name.lower(), c.type) for c in s.columns],
            primary_key=[c.lower() for c in s.primary_key] or None,
            enums={c.name.lower(): tuple(c.enum_members)
                   for c in s.columns if c.enum_members} or None,
            sets={c.name.lower(): tuple(c.set_members)
                  for c in s.columns if c.set_members} or None,
            json_cols=tuple(c.name.lower() for c in s.columns if c.is_json),
            not_null=tuple(c.name.lower() for c in s.columns if c.not_null),
        )
        # every clause is checked before the table exists: a DDL error
        # leaves nothing half created
        auto = [c for c in s.columns if c.auto_increment]
        if auto and (len(auto) > 1 or auto[0].type.kind != Kind.INT):
            raise ValueError("one integer AUTO_INCREMENT column per table")
        colnames = {c.name.lower() for c in s.columns}
        gen_meta = self._validate_generated(s, auto, colnames)
        for nm, _txt, expr in s.checks:
            missing = check_columns(expr) - colnames
            if missing:
                raise ValueError(f"CHECK {nm!r} references unknown columns {sorted(missing)}")
        fks = []
        for nm, col, rdb, rtbl, rcol in s.fks:
            rdb = (rdb or db).lower()
            rtbl, rcol, col = rtbl.lower(), rcol.lower(), col.lower()
            if col not in colnames:
                raise ValueError(f"FOREIGN KEY column {col!r} unknown")
            if rdb == db.lower() and rtbl == s.name.lower():
                if rcol not in colnames:
                    raise ValueError(f"FOREIGN KEY references unknown column {rcol!r}")
            else:
                pt = self.catalog.table(rdb, rtbl)  # raises when it is missing
                if rcol not in pt.schema.names:
                    raise ValueError(f"FOREIGN KEY references unknown column {rdb}.{rtbl}.{rcol}")
            fks.append((nm, col, rdb, rtbl, rcol))
        ttl_opt = None
        if s.ttl is not None:
            tcol, iv, unit = s.ttl
            ct = schema.types.get(tcol.lower())
            if ct is None or ct.kind not in (Kind.DATE, Kind.DATETIME):
                raise ValueError("TTL column must be an existing DATE/DATETIME column")
            if unit not in ("day", "week", "month", "hour", "minute", "second"):
                raise ValueError(f"unsupported TTL unit {unit!r}")
            ttl_opt = (tcol.lower(), int(iv), unit)
        part_meta = None
        if s.partition is not None:
            part_meta = self._encode_partition(schema, s.partition)
        if s.temporary:
            if ttl_opt is not None:
                raise ValueError("temporary tables do not support partitioning/TTL")
            return self._create_temporary(s, db, schema, auto, gen_meta, fks)
        # a temporary table shadowing the name neither blocks the shared
        # table nor lends it its identity
        base = self.catalog._base
        existed = s.if_not_exists and base.has_table(db, s.name)
        t = base.create_table(db, s.name, schema, s.if_not_exists)
        if not existed:
            t.partition = part_meta
            t.ttl = ttl_opt
            for iname, icols, *uq in s.indexes:
                self._add_index(t, iname, icols, unique=bool(uq and uq[0]))
            if auto:
                t.autoinc_col = auto[0].name.lower()
            t.checks = [(nm, txt) for nm, txt, _e in s.checks]
            t.fks = fks
            t.fk_actions = {nm.lower(): act for nm, act in (s.fk_actions or {}).items()
                            if act != "restrict"}
            t.fk_update_actions = {nm.lower(): act
                                   for nm, act in (s.fk_update_actions or {}).items()
                                   if act != "restrict"}
            t.defaults = {c.name.lower(): c.default for c in s.columns if c.default is not None}
            t.generated = gen_meta
            # the reverse FOREIGN KEY map is keyed by the schema version
            self.catalog.schema_version += 1
        return Result([], [])

    def _create_temporary(self, s: ast.CreateTable, db: str, schema, auto, gen_meta, fks) -> Result:
        """CREATE TEMPORARY TABLE: a table of this session only, which
        shadows a shared table of its name. No partitions or FOREIGN KEYs."""
        if s.partition is not None:
            raise ValueError("temporary tables do not support partitioning/TTL")
        if fks:
            raise ValueError("temporary tables do not support FOREIGN KEYs")
        db_l = db.lower()
        if db_l not in self.catalog._dbs:
            # IF NOT EXISTS never excuses an unknown database
            raise ValueError(f"unknown database {db_l!r}")
        if (db_l, s.name.lower()) in self.catalog._temp:
            if not s.if_not_exists:
                raise ValueError(f"temporary table {s.name!r} exists")
            return Result([], [])
        t = self.catalog.create_temp_table(db_l, s.name, schema)
        for iname, icols, *uq in s.indexes:
            self._add_index(t, iname, icols, unique=bool(uq and uq[0]))
        if auto:
            t.autoinc_col = auto[0].name.lower()
        t.checks = [(nm, txt) for nm, txt, _e in s.checks]
        t.defaults = {c.name.lower(): c.default for c in s.columns if c.default is not None}
        t.generated = gen_meta
        return Result([], [])

    def _run_create_view(self, s: ast.CreateView) -> Result:
        """CREATE [OR REPLACE] VIEW: the body is planned now, so an
        unknown table or column, a column list of the wrong length or a
        repeated name fails at CREATE; the text is stored and planned
        again at each use. Bare names are qualified with the view's
        database first, as the expansion qualifies them."""
        from tidb_tpu_torch.planner.logical import qualify_view_body

        db = (s.db or self.db).lower()
        if self.catalog.has_view(db, s.name) and not s.or_replace:
            raise ValueError(f"view {s.name} exists")
        qualify_view_body(s.query, db)
        plan = build_query(s.query, self.catalog, db, self._scalar_subquery)
        names = [c.lower() for c in (s.columns or [])] or [c.name for c in plan.schema.cols]
        if s.columns and len(s.columns) != len(plan.schema.cols):
            raise ValueError(
                f"view column list has {len(s.columns)} names but "
                f"SELECT yields {len(plan.schema.cols)} columns")
        if len(set(names)) != len(names):
            raise ValueError("duplicate column name in view")
        self.catalog.create_view(db, s.name, s.query_sql, s.columns, s.or_replace)
        return Result([], [])

    def _run_ctas(self, s: ast.CreateTable, db: str) -> Result:
        """CREATE [TEMPORARY] TABLE ... AS SELECT: the schema comes from
        the query. The existence check runs first, so a large query does
        not run only to be thrown away; a shared table's is made in the
        shared catalog (a temporary table of its name neither blocks it
        nor receives its rows)."""
        base = self.catalog._base
        if ((db.lower(), s.name.lower()) in self.catalog._temp if s.temporary
                else base.has_table(db, s.name)):
            if s.if_not_exists:
                return Result([], [])
            raise ValueError(f"table {s.name} exists")
        res = self._run_select(self._resolve_session_funcs(s.as_query))
        types = res.types
        if types is None:
            # a FROM-less SELECT: types from the first row
            first = res.rows[0] if res.rows else ()
            types = [literal_type(v) if v is not None else INT64 for v in first] or [
                INT64] * len(res.columns)
        cols, seen = [], set()
        for name, typ in zip(res.columns, types):
            n = name.lower()
            if n in seen or not n.isidentifier():
                n = f"col_{len(cols)}"
            seen.add(n)
            cols.append((n, typ if typ is not None else INT64))
        if s.temporary:
            t = self.catalog.create_temp_table(db, s.name, TableSchema(cols))
        else:
            t = base.create_table(db, s.name, TableSchema(cols))
        if res.rows:
            t.append_rows([list(r) for r in res.rows])
        return Result([], [], affected=len(res.rows))

    # -- INSERT --------------------------------------------------------
    def _run_insert(self, s: ast.Insert) -> Result:
        """INSERT [IGNORE] ... [ON DUPLICATE KEY UPDATE] and REPLACE, of
        VALUES or a SELECT. Affected rows count as MySQL's: each inserted
        row 1 and each row an ON DUPLICATE KEY UPDATE changed 2."""
        inject("dml/insert")
        t = self._resolve_table_for_write(s.db or self.db, s.table)
        names = t.schema.names
        cols = [c.lower() for c in s.columns] if s.columns else names
        unknown = set(cols) - set(names)
        if unknown:
            raise ValueError(f"unknown columns {sorted(unknown)}")
        dflt = t.defaults
        rows = []
        if s.query is not None:
            # INSERT ... SELECT: run the source query, map by position
            res = self._run_select(self._resolve_session_funcs(s.query))
            if res.columns and len(res.columns) != len(cols):
                raise ValueError(
                    f"INSERT ... SELECT arity mismatch: {len(res.columns)} "
                    f"columns for {len(cols)} targets"
                )
            for row in res.rows:
                vals = dict(zip(cols, row))
                rows.append([vals[n] if n in vals else dflt.get(n) for n in names])
        for row in s.rows:
            if len(row) != len(cols):
                raise ValueError("VALUES arity mismatch")
            vals = {c: self._const_value(v) for c, v in zip(cols, row)}
            rows.append([vals[n] if n in vals else dflt.get(n) for n in names])
        gen_cols = {c for c, _txt, _st in t.generated}
        if gen_cols:
            # a generated column takes DEFAULT or NULL only: it is computed
            tgt = [(names.index(c), c) for c in gen_cols if c in cols]
            for r in rows:
                for gi, gc in tgt:
                    if r[gi] is not None:
                        raise ValueError(
                            f"the value specified for generated column {gc!r} is not allowed")
            if s.on_dup:
                self._reject_generated_targets(t, [c.lower() for c, _e in s.on_dup], "assign")
        ac = t.autoinc_col
        if ac is not None:
            ai = names.index(ac)
            explicit = [r[ai] for r in rows if r[ai] is not None]
            if explicit:
                t.observe_autoid(max(explicit))
            missing = [r for r in rows if r[ai] is None]
            if missing:
                start = t.next_autoid(len(missing))
                for k, r in enumerate(missing):
                    r[ai] = start + k
                self.last_insert_id = start
        # generated columns over the final base values, before the key
        # matching of ON DUPLICATE KEY UPDATE and again after it; then the
        # constraints, before anything is written
        self._fill_generated(t, rows)
        db = s.db or self.db
        n_upd = 0
        if s.ignore:
            rows = self._fill_ignore_null_pk(t, names, rows)
        n_incoming = len(rows)
        origin: dict = {}
        if s.on_dup:
            rows, origin, n_upd = self._apply_on_dup(t, names, rows, s.on_dup)
            self._fill_generated(t, rows)
        if s.ignore:
            before = len(rows)
            rows = self._filter_ignore(t, db, names, rows, skip_unique=bool(s.on_dup))
            n_incoming -= before - len(rows)
        else:
            self._enforce_write_constraints(t, db, rows)
        # the stored rows an ON DUPLICATE KEY UPDATE rewrote, by their
        # keys, for the rewritten rows that survived IGNORE
        del_keys: dict = {}
        for r in rows:
            for kc, v in origin.get(id(r), ()):
                del_keys.setdefault(kc, {})[v.tobytes()] = v
        del_keys = {kc: list(d.values()) for kc, d in del_keys.items()}
        mutates = s.replace or any(del_keys.values())
        saved = (list(t.blocks()), dict(t.dictionaries)) if mutates else None
        children = self._fk_children(db, s.table) if mutates else []
        try:
            if s.replace:
                self._replace_conflicts(t, names, rows)
            if any(del_keys.values()):
                self._delete_rows_by_keys(t, del_keys)
            t.append_rows(rows)
            if children:
                # REPLACE and ON DUPLICATE KEY UPDATE remove or rewrite
                # stored rows: the children must still find their keys
                # in the post-statement rows (RESTRICT)
                self._enforce_parent_constraints(db, s.table, {
                    c: self._table_keyset(t, c) for c in self._parent_need(t, db, children)})
        except Exception:
            if saved is not None:
                t.replace_blocks(saved[0], modified_rows=len(rows))
                t.dictionaries = saved[1]
            raise
        finally:
            self._drop_cached(invalidate=[t])
        return Result([], [], affected=n_incoming + n_upd)

    def _run_load_data(self, s: ast.LoadData) -> Result:
        """LOAD DATA [LOCAL] INFILE (the path is read on the server, as in
        the JAX package). A table with CHECKs or FOREIGN KEYs is checked
        after the append over the loaded rows, and the append is rolled
        back on a violation; generated columns are computed again over
        the table."""
        inject("dml/load")
        db = s.db or self.db
        t = self._resolve_table_for_write(db, s.table)
        constrained = bool(t.checks or t.fks)
        # the append merges the file's strings into the table's sorted
        # dictionaries and re-maps the stored blocks' codes: a rollback
        # puts back the blocks and the dictionaries they were coded by
        saved = (list(t.blocks()), dict(t.dictionaries)) if constrained else None
        try:
            n = load_file(t, s.path, sep=s.sep)
            if constrained and n:
                names = t.schema.names
                loaded = []
                for b in t.blocks()[len(saved[0]):]:
                    dec = [b.columns[c].decode() for c in names]
                    loaded += [list(r) for r in zip(*dec)]
                try:
                    self._enforce_write_constraints(t, db, loaded)
                except Exception:
                    t.replace_blocks(saved[0], modified_rows=n)
                    t.dictionaries = saved[1]
                    raise
            if n and t.generated:
                # the file's values of generated columns are computed again
                self._recompute_generated(t)
        finally:
            self._drop_cached(invalidate=[t])
        return Result([], [], affected=n)

    #: IMPORT INTO's executors, and the most byte ranges it cuts a file
    #: into (of at least 1 MiB each, the DXF default): one per executor
    IMPORT_EXECUTORS = 4

    def _run_import_into(self, s: ast.ImportInto) -> Result:
        """IMPORT INTO: a DXF ``import`` task run to completion by four
        executors (the Lightning pipeline's analog). Its subtasks parse on
        the host; the finalize appends on this thread. The JAX statement
        takes 1 MiB ranges; here a large file is cut into one range per
        executor: each range's append merges its dictionaries into the
        table's and re-maps the blocks landed before it, so many small
        ranges cost time that grows with their count times the file (174
        ranges of TPC-H SF10's customer took 84 s on an H100 host, 16 took
        32 s). The rows are the same."""
        from tidb_tpu_torch.dxf import TaskManager
        import tidb_tpu_torch.dxf.tasks  # noqa: F401 (registers the task types)

        db = s.db or self.db
        target = self.catalog.table(db, s.table)
        before = target.nrows
        size = os.path.getsize(s.path) if os.path.isfile(s.path) else 0
        m = TaskManager(self.catalog)
        tid = m.submit("import", {"db": db, "table": s.table, "path": s.path, "sep": s.sep,
                                  "chunk_bytes": max(1 << 20, -(-size // self.IMPORT_EXECUTORS))})
        state = m.run_to_completion(tid, executors=self.IMPORT_EXECUTORS)
        if state != "succeed":
            raise RuntimeError(f"IMPORT INTO failed: {m.tasks[tid]['error']}")
        self._drop_cached(invalidate=[target])
        return Result([], [], affected=target.nrows - before)

    def _const_value(self, e):
        if isinstance(e, ast.Const):
            return e.value
        if isinstance(e, ast.Call) and e.op == "neg" and isinstance(e.args[0], ast.Const):
            return -e.args[0].value
        if isinstance(e, ast.Call) and e.op.lower() in ("nextval", "lastval", "setval"):
            # per row: INSERT ... VALUES (nextval(s)), (nextval(s)) advances twice
            return self._seq_func(e)
        raise ValueError("INSERT VALUES must be literals")

    # -- conflict keys: PRIMARY KEY and UNIQUE indexes -----------------
    @staticmethod
    def _unique_key_sets(t) -> list:
        """The conflict keys as column tuples: the PRIMARY KEY, then every
        UNIQUE index (by name), single- or multi-column."""
        out = []
        pk = t.schema.primary_key
        if pk:
            out.append(tuple(pk))
        for iname in sorted(t.unique_indexes):
            c = t.indexes.get(iname)
            if c and tuple(c) not in out:
                out.append(tuple(c))
        return out

    def _unique_key_cols(self, t) -> list:
        """Every column of any conflict key, once."""
        out = []
        for ks in self._unique_key_sets(t):
            out.extend(c for c in ks if c not in out)
        return out

    def _fill_ignore_null_pk(self, t, names, rows):
        """INSERT IGNORE: a NULL in a PRIMARY KEY column takes the
        column's implicit default (0, '', the zero date), as MySQL does
        under IGNORE, with a warning (SHOW WARNINGS); a kind with none
        drops the row. Runs before ON DUPLICATE KEY UPDATE's matching, so
        the filled key takes part in it."""
        pk = t.schema.primary_key
        if not pk or not rows:
            return rows
        zero = {
            Kind.INT: 0, Kind.FLOAT: 0.0, Kind.BOOL: False, Kind.DECIMAL: 0,
            Kind.STRING: "", Kind.DATE: 0, Kind.DATETIME: 0, Kind.TIME: 0,
        }
        pk_idx = [(names.index(c), zero.get(t.schema.types[c].kind)) for c in pk if c in names]
        fixed = []
        for r in rows:
            if any(r[i] is None and z is None for i, z in pk_idx):
                continue
            if any(r[i] is None for i, _z in pk_idx):
                r = list(r)
                for i, z in pk_idx:
                    if r[i] is None:
                        r[i] = z
                        self._warnings.append(
                            ("Warning", 1048, f"Column '{names[i]}' cannot be null"))
            fixed.append(r)
        return fixed

    def _incoming_key_matrix(self, t, cols, names, rows, ext_state=None):
        """Incoming rows' key columns in the table's encoded domain:
        (key matrix, all-valid mask) aligned to the rows. A string the
        table's dictionary lacks gets a provisional code above every real
        one, so it conflicts with its repeats but never with stored
        rows; `ext_state` keeps those codes, and each column's lookup,
        for one statement."""
        ext_state = {} if ext_state is None else ext_state
        columns = {}
        for c in cols:
            i = names.index(c)
            vals = [r[i] for r in rows]
            typ = t.schema.types[c]
            if typ.kind != Kind.STRING:
                columns[c] = column_from_values(vals, typ)
                continue
            lut = ext_state.get(("lut", c))
            if lut is None:
                d = t.dictionaries.get(c)
                lut = ext_state[("lut", c)] = (
                    {str(x): j for j, x in enumerate(d)} if d is not None else {})
            ext = ext_state.setdefault(c, {})
            codes = np.zeros(len(vals), dtype=np.int64)
            valid = np.zeros(len(vals), dtype=bool)
            for j, v in enumerate(vals):
                if v is None:
                    continue
                valid[j] = True
                code = lut.get(str(v))
                codes[j] = code if code is not None else ext.setdefault(str(v), (1 << 40) + len(ext))
            columns[c] = HostColumn(typ, codes, valid)
        return Table._key_matrix_full(columns, cols)

    def _incoming_key_views(self, t, key_sets, names, rows, ext_state):
        """Per key set: (per-row key view, all-valid mask, sorted valid
        keys for membership tests)."""
        out = {}
        for ks in key_sets:
            mat, allv = self._incoming_key_matrix(t, ks, names, rows, ext_state)
            view = Table._rows_view(mat)
            out[ks] = (view, allv, np.sort(view[allv]))
        return out

    @staticmethod
    def _block_key_hits(b, ks, sorted_keys):
        """(per-row hit mask, per-row key view, all-valid mask) of one
        stored block against sorted incoming keys."""
        if any(c not in b.columns for c in ks):
            z = np.zeros(b.nrows, dtype=bool)
            return z, None, z
        bmat, ballv = Table._key_matrix_full(b.columns, ks)
        bview = Table._rows_view(bmat)
        if not len(sorted_keys):
            return np.zeros(b.nrows, dtype=bool), bview, ballv
        pos = np.clip(np.searchsorted(sorted_keys, bview), 0, len(sorted_keys) - 1)
        return ballv & (sorted_keys[pos] == bview), bview, ballv

    def _filter_ignore(self, t, db, names, rows, skip_unique=False):
        """INSERT IGNORE: drop (instead of fail) rows that fail a CHECK or
        a FOREIGN KEY, or whose PRIMARY KEY or a UNIQUE key is already
        stored or repeats an earlier kept row of the statement.
        skip_unique: ON DUPLICATE KEY UPDATE already resolved the key
        conflicts."""
        if not rows:
            return rows
        passes = self._ignore_constraint_mask(t, db, names, rows) if t.checks or t.fks else None
        if skip_unique:
            return rows if passes is None else [r for r, ok in zip(rows, passes) if ok]
        return self._filter_ignore_keys(t, names, rows, passes)

    def _filter_ignore_keys(self, t, names, rows, passes):
        """`_filter_ignore`'s key conflicts over the rows that pass their
        constraints (`passes`, None: all): a dropped row claims no key."""
        key_state = []
        key_sets = self._unique_key_sets(t)
        inc = self._incoming_key_views(t, key_sets, names, rows, {})
        for ks in key_sets:
            view, allv, _sorted = inc[ks]
            stored = t._sorted_composite(tuple(ks))
            if stored is not None and len(stored):
                pos = np.clip(np.searchsorted(stored, view), 0, len(stored) - 1)
                in_table = allv & (stored[pos] == view)
            else:
                in_table = np.zeros(len(rows), dtype=bool)
            key_state.append((view, allv, in_table, set()))
        kept = []
        for j, r in enumerate(rows):
            if passes is not None and not passes[j]:
                continue
            if any(allv[j] and (in_table[j] or view[j].tobytes() in seen)
                   for view, allv, in_table, seen in key_state):
                continue
            for view, allv, _in_table, seen in key_state:
                if allv[j]:
                    seen.add(view[j].tobytes())
            kept.append(r)
        return kept

    @staticmethod
    def _eval_on_dup(assigns, names, old, incoming):
        """One ON DUPLICATE KEY UPDATE: the assignments evaluated over the
        stored row, VALUES(col) standing for the incoming row's value;
        later assignments see earlier results (MySQL's left to right)."""
        from tidb_tpu_torch.utils.checkeval import CheckEvalError, eval_check

        def subst(e):
            if (isinstance(e, ast.Call) and e.op == "values" and len(e.args) == 1
                    and isinstance(e.args[0], ast.Name)):
                return ast.Const(incoming[names.index(e.args[0].column.lower())])
            if isinstance(e, ast.Call):
                return dataclasses.replace(e, args=[subst(a) for a in e.args])
            return e

        new = list(old)
        env = dict(zip(names, old))
        for c, e in assigns:
            try:
                v = eval_check(subst(e), env)
            except CheckEvalError as err:
                raise ValueError(
                    "ON DUPLICATE KEY UPDATE supports literals, columns, "
                    f"VALUES(col), arithmetic and comparisons: {err}") from None
            new[names.index(c)] = v
            env[c] = v
        return new

    def _apply_on_dup(self, t, names, rows, assigns):
        """INSERT ... ON DUPLICATE KEY UPDATE -> (rows to append, the
        stored keys each rewritten row replaces, rows updated). A row
        whose key hits a stored row updates that row (which is deleted
        and appended again); one that hits an earlier row of the same
        statement updates it in place, so chains of duplicates apply in
        order."""
        key_sets = self._unique_key_sets(t)
        assigns = [(c.lower(), e) for c, e in assigns]
        for c, _e in assigns:
            if c not in names:
                raise ValueError(f"unknown column {c!r} in ON DUPLICATE KEY")
        if not key_sets:
            return list(rows), {}, 0
        ext_state: dict = {}
        inc = self._incoming_key_views(t, key_sets, names, rows, ext_state)

        def inc_key(j, ks):
            view, allv, _s = inc[ks]
            return view[j].tobytes() if allv[j] else None

        def row_keys(row):
            """{key set: (key bytes, key scalar) or (None, None)} of one row."""
            out = {}
            for ks in key_sets:
                mat, allv = self._incoming_key_matrix(t, ks, names, [row], ext_state)
                if allv[0]:
                    v = Table._rows_view(mat)[0]
                    out[ks] = (v.tobytes(), v)
                else:
                    out[ks] = (None, None)
            return out

        # stored rows that conflict with an incoming key: only hit rows
        # are decoded
        fetched = []
        existing = {ks: {} for ks in key_sets}
        for b in t.blocks():
            hit_any = np.zeros(b.nrows, dtype=bool)
            per_ks = {}
            for ks in key_sets:
                hit, bview, ballv = self._block_key_hits(b, ks, inc[ks][2])
                if bview is not None:
                    per_ks[ks] = (bview, ballv)
                hit_any |= hit
            hits = np.nonzero(hit_any)[0]
            if not len(hits):
                continue
            dec = {c: b.columns[c].decode() for c in names}
            ok = {c: b.columns[c].valid for c in names}
            for i in hits:
                idx = len(fetched)
                fetched.append([dec[c][i] if ok[c][i] else None for c in names])
                for ks, (bview, ballv) in per_ks.items():
                    if ballv[i]:
                        existing[ks][bview[i].tobytes()] = idx
        pending, pkey = [], {ks: {} for ks in key_sets}
        # id(pending row) -> [(key set, stored key)] of the stored row it
        # replaces: deleted only if the row is appended (IGNORE may drop it)
        origin: dict = {}
        n_upd = 0
        consumed = set()
        for j, row in enumerate(rows):
            target = None
            for ks in key_sets:
                v = inc_key(j, ks)
                if v is None:
                    continue
                if v in pkey[ks]:
                    target = ("p", pkey[ks][v])
                    break
                fi = existing[ks].get(v)
                if fi is not None and fi not in consumed:
                    target = ("e", fi)
                    break
            if target is None:
                for ks in key_sets:
                    v = inc_key(j, ks)
                    if v is not None:
                        pkey[ks][v] = len(pending)
                pending.append(row)
                continue
            n_upd += 1
            if target[0] == "e":
                consumed.add(target[1])
                old = fetched[target[1]]
                new = self._eval_on_dup(assigns, names, old, row)
                origin[id(new)] = [(ks, scalar) for ks, (kb, scalar) in row_keys(old).items()
                                   if kb is not None]
                for ks, (kb, _scalar) in row_keys(new).items():
                    if kb is not None:
                        pkey[ks][kb] = len(pending)
                pending.append(new)
            else:
                pi = target[1]
                old = pending[pi]
                new = self._eval_on_dup(assigns, names, old, row)
                if id(old) in origin:
                    origin[id(new)] = origin.pop(id(old))
                for ks, (kb, _scalar) in row_keys(old).items():
                    if kb is not None and pkey[ks].get(kb) == pi:
                        del pkey[ks][kb]
                pending[pi] = new
                for ks, (kb, _scalar) in row_keys(new).items():
                    if kb is not None:
                        pkey[ks][kb] = pi
        return pending, origin, n_upd

    def _delete_rows_by_keys(self, t, del_keys: dict) -> None:
        """Delete the stored rows whose key, per key set, is one of the
        given encoded key scalars."""
        for cols, values in del_keys.items():
            if not values:
                continue
            tgt = np.sort(np.array(list(values)))
            keep = [~self._block_key_hits(b, cols, tgt)[0] for b in t.blocks()]
            if any((~m).any() for m in keep):
                t.delete_where(keep)

    def _replace_conflicts(self, t, names, rows) -> None:
        """REPLACE: of incoming rows that repeat a key, the last one
        stays; then every stored row whose PRIMARY KEY or UNIQUE key
        collides with an incoming row is deleted, and the append inserts
        the replacements."""
        key_sets = self._unique_key_sets(t)
        if not key_sets or not rows:
            return
        ext_state: dict = {}
        for ks in key_sets:
            mat, allv = self._incoming_key_matrix(t, ks, names, rows, ext_state)
            view = Table._rows_view(mat)
            seen, kept = set(), []
            for j in range(len(rows) - 1, -1, -1):
                k = view[j].tobytes() if allv[j] else None
                if k is not None and k in seen:
                    continue
                if k is not None:
                    seen.add(k)
                kept.append(rows[j])
            rows[:] = kept[::-1]
        for ks in key_sets:
            mat, allv = self._incoming_key_matrix(t, ks, names, rows, ext_state)
            srt = np.sort(Table._rows_view(mat)[allv])
            if not len(srt):
                continue
            keep = [~self._block_key_hits(b, ks, srt)[0] for b in t.blocks()]
            if any((~m).any() for m in keep):
                t.delete_where(keep)

    # -- DELETE --------------------------------------------------------
    def _run_delete(self, s: ast.Delete) -> Result:
        inject("dml/delete")
        if s.targets is not None:
            return self._run_delete_multi(s)
        db = s.db or self.db
        t = self._resolve_table_for_write(db, s.table)
        if s.where is None and not (s.limit is not None or s.order_by):
            affected = t.nrows
            self._clear_with_actions(t, db, s.table, affected)
            return Result([], [], affected=affected)
        if s.where is None:
            masks = [np.ones(b.nrows, dtype=bool) for b in t.blocks()]
        else:
            masks, affected = self._eval_where_per_block(t, db, s.where)
        masks, affected = self._dml_order_limit_masks(t, masks, s.order_by, s.limit)
        return self._delete_masked(t, db, s.table, masks, affected)

    # -- UPDATE --------------------------------------------------------
    def _run_update(self, s: ast.Update) -> Result:
        inject("dml/update")
        if s.from_refs is not None:
            return self._run_update_multi(s)
        t = self._resolve_table_for_write(s.db or self.db, s.table)
        if s.limit is not None or s.order_by:
            # UPDATE ... [ORDER BY] LIMIT: choose the rows first, then run
            # a plain keyed UPDATE over them
            if s.where is not None:
                masks, _n = self._eval_where_per_block(t, s.db or self.db, s.where)
            else:
                masks = [np.ones(b.nrows, dtype=bool) for b in t.blocks()]
            before = sum(int(m.sum()) for m in masks)
            masks, affected = self._dml_order_limit_masks(t, masks, s.order_by, s.limit)
            if affected == before:
                # LIMIT did not bind: a plain UPDATE
                return self._run_update(dataclasses.replace(s, order_by=[], limit=None))
            pk = t.schema.primary_key
            if not (pk and len(pk) == 1):
                raise ValueError("UPDATE ... ORDER BY/LIMIT requires a single-column PRIMARY KEY")
            vals = []
            for b, m in zip(t.blocks(), masks):
                dec = b.columns[pk[0]].decode()
                vals.extend(dec[i] for i in np.nonzero(m)[0])
            if not vals:
                return Result([], [], affected=0)
            in_pred = ast.Call("in", [ast.Name(None, pk[0])] + [ast.Const(v) for v in vals])
            s = dataclasses.replace(s, where=in_pred, order_by=[], limit=None)
        sets = {c.lower(): e for c, e in s.sets}
        self._reject_generated_targets(t, sets, "SET")
        fast = self._try_columnar_update(t, s, sets)
        if fast is not None:
            return fast
        # the rewrite path: the whole table through a SELECT of every
        # column, SET columns as CASE WHEN <where> THEN <new> ELSE <old>
        items = []
        for n, _typ in t.schema.columns:
            expr = sets.get(n, ast.Name(None, n))
            if n in sets and s.where is not None:
                expr = ast.Call("case", [s.where, expr, ast.Name(None, n)])
            items.append(ast.SelectItem(expr, alias=n))
        r = self._run_select(ast.Select(items=items, from_=ast.TableRef(s.db, s.table, None)))
        rows = [list(row) for row in r.rows]
        db = s.db or self.db
        # `rows` is the table's whole post-image: generated columns,
        # CHECK and the child side of every FK over it, then the parent
        # side (each child's ON UPDATE action) against its value sets
        self._fill_generated(t, rows)
        self._enforce_write_constraints(t, db, rows)
        undo: list = []
        plans = self._rewrite_update_guard(t, db, s.table, t.schema.names, rows, undo)
        if s.where is None:
            affected = len(rows)
        else:
            _masks, affected = self._eval_where_per_block(t, db, s.where)
        saved_blocks, saved_dicts = list(t.blocks()), dict(t.dictionaries)
        t.replace_blocks([], modified_rows=affected)
        try:
            if rows:
                t.append_rows(rows)
            self._apply_fk_update_plans(plans, undo)
        except Exception:
            # e.g. the SET made duplicate keys, or a cascade failed: the
            # statement rolls back, children first (a self-referential
            # child's snapshot was taken after the append)
            self._fk_undo_restore(undo)
            t.replace_blocks(saved_blocks, modified_rows=affected)
            t.dictionaries = saved_dicts
            raise
        finally:
            self._drop_cached(invalidate=[t])
        return Result([], [], affected=affected)

    # -- multi-table UPDATE and DELETE ---------------------------------
    def _dml_lock_tables(self, s) -> list:
        """(db, table) of the tables a DML writes: its target, or the
        targets of a multi-table form resolved through its join."""
        if isinstance(s, ast.Update) and s.from_refs is not None:
            refs, per = self._update_targets(s)
            return [((refs[a].db or self.db), refs[a].name) for a in per]
        if isinstance(s, ast.Delete) and s.targets is not None:
            refs = self._refs_map(s.from_refs)
            out = []
            for tdb, name in s.targets:
                tr = refs.get(name.lower())
                out.append(((tr.db or self.db), tr.name) if tr is not None
                           else (tdb or self.db, name))
            return out
        return [(s.db or self.db, s.table)]

    @staticmethod
    def _refs_map(refs) -> dict:
        """alias (lower case) -> TableRef of every base table at the top
        of a join tree; derived tables are row sources, never targets."""
        out = {}

        def walk(node):
            if isinstance(node, ast.TableRef):
                out[(node.alias or node.name).lower()] = node
            elif isinstance(node, ast.Join):
                walk(node.left)
                walk(node.right)

        walk(refs)
        return out

    def _update_targets(self, s: ast.Update):
        """A multi-table UPDATE's SET list as {alias: [(column, expr)]};
        an unqualified column binds to the one base table that has it."""
        refs = self._refs_map(s.from_refs)
        per: dict = {}
        for col, e in s.sets:
            if "." in col:
                alias, c = col.split(".", 1)
                alias = alias.lower()
                if alias not in refs:
                    raise ValueError(f"unknown table {alias!r} in UPDATE SET")
            else:
                cands = []
                for a, tr in refs.items():
                    db = (tr.db or self.db).lower()
                    if self.catalog.has_table(db, tr.name) and (
                            col.lower() in self.catalog.table(db, tr.name).schema.types):
                        cands.append(a)
                if len(cands) != 1:
                    raise ValueError(
                        f"column {col!r} in UPDATE SET is " + ("ambiguous" if cands else "unknown"))
                alias, c = cands[0], col
            per.setdefault(alias, []).append((c.lower(), e))
        return refs, per

    def _run_update_multi(self, s: ast.Update) -> Result:
        """UPDATE over a join: one SELECT over the join computes, per
        matched row, each target's row handle (``_tidb_rowid``) and its
        SET values cast to the column types; each target row then takes
        the values of its first matching join row (MySQL's rule). A
        target whose SET touches no key or string column is rewritten in
        its columnar form, block by block; any other is rewritten from
        its rows, so its keys are checked again. A failure restores every
        target."""
        from tidb_tpu_torch.planner.logical import ROWID_NAME, expose_rowid

        refs, per = self._update_targets(s)
        aliases = list(per)
        items = []
        for i, alias in enumerate(aliases):
            tr = refs[alias]
            t = self.catalog.table((tr.db or self.db).lower(), tr.name)
            items.append(ast.SelectItem(ast.Name(alias, ROWID_NAME), alias=f"_h{i}"))
            for j, (c, e) in enumerate(per[alias]):
                typ = t.schema.types.get(c)
                if typ is None:
                    raise ValueError(f"unknown column {alias}.{c}")
                if typ.kind != Kind.STRING:
                    e = ast.Call("cast", [e], typ)
                items.append(ast.SelectItem(e, alias=f"_v{i}_{j}"))
        sel = ast.Select(items=items, from_=s.from_refs, where=s.where)
        with expose_rowid(aliases):
            plan = build_query(sel, self.catalog, self.db, self._scalar_subquery)
            batch, dicts = self.executor.run(plan)
        out_cols = list(plan.schema)
        live = np.nonzero(batch.row_valid.numpy())[0]
        affected = 0
        saved: list = []  # (table, blocks, dictionaries, modified rows)
        undo: list = []  # every table a referential action touched
        try:
            pos = 0
            for alias in aliases:
                tr = refs[alias]
                db = (tr.db or self.db).lower()
                t = self._resolve_table_for_write(db, tr.name)
                hcol = batch.cols[out_cols[pos].internal]
                h = hcol.data.numpy()[live]
                hv = hcol.valid.numpy()[live]
                vcols = out_cols[pos + 1: pos + 1 + len(per[alias])]
                pos += 1 + len(per[alias])
                # first matching join row wins; outer-join misses carry no handle
                handles, first = np.unique(h[hv], return_index=True)
                if not len(handles):
                    continue
                rows_at = np.flatnonzero(hv)[first]
                nrows = t.nrows
                if handles[0] < 0 or handles[-1] >= nrows:
                    raise ValueError("stale row handle in UPDATE")
                sets = [c for c, _e in per[alias]]
                self._reject_generated_targets(t, sets, "SET")
                saved.append((t, list(t.blocks()), dict(t.dictionaries), len(handles)))
                if set(sets) & set(self._unique_key_cols(t)) or any(
                        t.schema.types[c].kind == Kind.STRING for c in sets) or (
                        t.partition is not None and t.partition[1] in sets):
                    new = materialize_rows(
                        Batch({c.internal: batch.cols[c.internal] for c in vcols},
                              batch.row_valid),
                        vcols, dicts)
                    self._rewrite_by_handles(t, db, tr.name, handles, [new[i] for i in rows_at],
                                             sets, undo)
                else:
                    vals = {c: (batch.cols[vc.internal].data.numpy()[live[rows_at]],
                                batch.cols[vc.internal].valid.numpy()[live[rows_at]])
                            for c, vc in zip(sets, vcols)}
                    self._scatter_by_handles(t, db, tr.name, handles, vals, undo)
                affected += len(handles)
        except Exception:
            self._fk_undo_restore(undo)
            for t2, blocks2, dicts2, mod2 in reversed(saved):
                t2.replace_blocks(blocks2, modified_rows=mod2)
                t2.dictionaries = dicts2
            raise
        finally:
            self._drop_cached(invalidate=[x[0] for x in saved] + [u[0] for u in undo])
        return Result([], [], affected=affected)

    @staticmethod
    def _handle_positions(t, handles):
        """(block index, row in block) of ascending row handles."""
        starts = np.cumsum([0] + [b.nrows for b in t.blocks()])
        bi = np.searchsorted(starts, handles, side="right") - 1
        return bi, handles - starts[bi]

    def _scatter_by_handles(self, t, db, name, handles, vals, undo) -> None:
        """Write encoded new values {column: (data, valid)} at ascending
        row handles into copies of the touched blocks, with the checks of
        ``_install_columnar``. The modify count grows as the JAX
        package's row rewrite makes it grow (the rows updated plus the
        table's rows)."""
        bi, ri = self._handle_positions(t, handles)
        touched = [(i, ri[bi == i]) for i in np.unique(bi).tolist()]
        if not self._install_columnar(t, db, name, touched, dict(vals),
                                      len(handles) + t.nrows, undo):
            # a recomputed generated value needs the rewrite
            decs = {c: HostColumn(t.schema.types[c], d.astype(t.schema.types[c].np_dtype), v,
                                  t.dictionaries.get(c)).decode().tolist()
                    for c, (d, v) in vals.items()}
            new_vals = [[decs[c][k] for c in vals] for k in range(len(handles))]
            self._rewrite_by_handles(t, db, name, handles, new_vals, list(vals), undo)

    def _rewrite_by_handles(self, t, db, name, handles, new_vals, sets, undo) -> None:
        """Rewrite the whole table from its decoded rows with the new
        values of `sets` at ascending row handles, as the JAX session
        does: generated columns, CHECK and FOREIGN KEYs over the whole
        image, the append's key checks and dictionary merges, then the
        children's ON UPDATE actions."""
        names = t.schema.names
        cidx = [names.index(c) for c in sets]
        rows = []
        for b in t.blocks():
            decs = [b.columns[n].decode() for n in names]
            vals = [b.columns[n].valid for n in names]
            for k in range(b.nrows):
                rows.append([decs[c][k] if vals[c][k] else None for c in range(len(names))])
        for h, new in zip(handles.tolist(), new_vals):
            for ci, v in zip(cidx, new):
                rows[h][ci] = v
        self._fill_generated(t, rows)
        self._enforce_write_constraints(t, db, rows)
        plans = self._rewrite_update_guard(t, db, name, names, rows, undo)
        t.replace_blocks([], modified_rows=len(handles))
        if rows:
            t.append_rows(rows)
        self._apply_fk_update_plans(plans, undo)

    def _run_delete_multi(self, s: ast.Delete) -> Result:
        """DELETE t1[, t2] FROM <join> / DELETE FROM t USING <join>: one
        SELECT over the join collects each target's matched row handles;
        each target then deletes those rows. A table named twice is
        deleted from once."""
        from tidb_tpu_torch.planner.logical import ROWID_NAME, expose_rowid

        refs = self._refs_map(s.from_refs)
        resolved = []
        for tdb, name in s.targets:
            alias = name.lower()
            if alias not in refs:
                # a target named by its table while the join uses aliases
                cands = [a for a, tr in refs.items()
                         if tr.name.lower() == alias
                         and (tdb is None or (tr.db or self.db).lower() == tdb.lower())]
                if len(cands) != 1:
                    raise ValueError(f"unknown DELETE target {name!r}")
                alias = cands[0]
            if alias not in resolved:
                resolved.append(alias)
        items = [ast.SelectItem(ast.Name(a, ROWID_NAME), alias=f"_h{i}")
                 for i, a in enumerate(resolved)]
        sel = ast.Select(items=items, from_=s.from_refs, where=s.where)
        with expose_rowid(resolved):
            plan = build_query(sel, self.catalog, self.db, self._scalar_subquery)
            batch, _dicts = self.executor.run(plan)
        rv = batch.row_valid.numpy()
        # every target's rows go first, at the handles of the statement's
        # start; the referential actions run after all of them, so a
        # cascade never moves rows a later target's handles point at
        total = 0
        undo: list = []
        deferred: list = []
        try:
            for alias, col in zip(resolved, plan.schema):
                tr = refs[alias]
                db = (tr.db or self.db).lower()
                t = self._resolve_table_for_write(db, tr.name)
                c = batch.cols[col.internal]
                hs = np.unique(c.data.numpy()[rv & c.valid.numpy()])
                if not len(hs):
                    continue
                bi, ri = self._handle_positions(t, hs)
                masks = []
                for i, b in enumerate(t.blocks()):
                    m = np.zeros(b.nrows, dtype=bool)
                    m[ri[bi == i]] = True
                    masks.append(m)
                self._delete_masked(t, db, tr.name, masks, len(hs), undo=undo, deferred=deferred)
                total += len(hs)
            for act in deferred:
                act()
        except BaseException:
            self._fk_undo_restore(undo)
            raise
        finally:
            self._drop_cached(invalidate=[u[0] for u in undo])
        return Result([], [], affected=total)

    def _try_columnar_update(self, t, s: ast.Update, sets) -> Optional[Result]:
        """UPDATE that writes new values of the SET columns into copies
        of only the touched blocks, or None where the JAX session takes
        the rewrite path: a PRIMARY KEY or UNIQUE index column SET (its
        uniqueness needs whole rows), a string SET other than a constant already in the
        column's dictionary, no WHERE, or an empty table. New values come
        from ``SELECT CAST(<expr> AS <column type>) ... WHERE <where>``,
        in the blocks' row order.

        A SET of a CHECK column, an FK column, a referenced column or a
        generated column's input keeps this form, where the JAX session
        rewrites the whole table through Python rows: only the touched
        rows are decoded, their generated columns recomputed and their
        CHECKs and FOREIGN KEYs checked (``_install_columnar``). Every
        stored row passed those checks when it was written, so the rows
        and errors are the rewrite's. A SET of the partitioning column
        takes the rewrite, whose append routes each row to its new
        partition (the JAX session's columnar form keeps the old tag)."""
        types = t.schema.types
        if any(c not in types for c in sets):
            return None
        if t.partition is not None and t.partition[1] in sets:
            return None
        str_codes = {}
        for c, e in sets.items():
            if types[c].kind != Kind.STRING:
                continue
            try:
                v = self._const_value(e)
            except (ValueError, NotImplementedError):
                return None  # non-literal string SET: rewrite path
            d = t.dictionaries.get(c)
            if not isinstance(v, str) or d is None or not len(d):
                return None
            pos = int(np.searchsorted(d, v))
            if pos >= len(d) or str(d[pos]) != v:
                return None  # an unseen value needs a dictionary remap
            str_codes[c] = pos
        if s.where is None or not t.blocks():
            return None
        if set(self._unique_key_cols(t)) & set(sets):
            return None  # a key SET needs the append's uniqueness checks
        masks, affected = self._eval_where_per_block(t, s.db or self.db, s.where)
        if affected == 0:
            return Result([], [], affected=0)
        set_cols = [c for c in sets if c not in str_codes]
        new_data, new_valid = {}, {}
        if set_cols:
            sel = ast.Select(
                items=[ast.SelectItem(ast.Call("cast", [sets[c]], types[c]), alias=f"_s{i}")
                       for i, c in enumerate(set_cols)],
                from_=ast.TableRef(s.db, s.table, None),
                where=s.where,
            )
            plan = build_query(sel, self.catalog, s.db or self.db, self._scalar_subquery)
            batch, _dicts = self.executor.run(plan)
            order = np.nonzero(batch.row_valid.numpy())[0]
            for c, col in zip(set_cols, plan.schema):
                dc = batch.cols[col.internal]
                new_data[c] = dc.data.numpy()[order]
                new_valid[c] = dc.valid.numpy()[order]
            if len(order) != affected:
                raise RuntimeError(
                    f"UPDATE's new values ({len(order)} rows) lost their alignment "
                    f"with its WHERE ({affected} rows)")
        touched = [(i, np.nonzero(m)[0]) for i, m in enumerate(masks) if m.any()]
        updated = {c: (new_data[c], new_valid[c]) for c in set_cols}
        updated.update({c: (np.full(affected, code, dtype=np.int64), np.ones(affected, dtype=bool))
                        for c, code in str_codes.items()})
        db = s.db or self.db
        constrained = self._constrained_cols(t, db, s.table) & set(sets)
        undo: list = []
        try:
            done = self._install_columnar(
                t, db, s.table, touched, updated,
                # the JAX rewrite's count where it would rewrite
                affected + t.nrows if constrained else affected, undo)
        except Exception:
            self._fk_undo_restore(undo)
            raise
        finally:
            self._drop_cached(invalidate=[t] + [u[0] for u in undo])
        if not done:
            return None
        return Result([], [], affected=affected)

    def _constrained_cols(self, t, db: str, name: str) -> set:
        """The columns whose SET the JAX session sends to its rewrite
        path: CHECK, FK and referenced columns and generated inputs."""
        cols: set = set()
        for _nm, ex in self._check_exprs_for(t):
            cols |= check_columns(ex)
        cols |= {col for _nm, col, *_r in t.fks}
        cols |= {rc for _cd, _ct, _nm, _c, rc, _a in self._fk_children(db, name)}
        for _c, ex in self._gen_exprs_for(t):
            cols |= check_columns(ex)
        return cols

    def _install_columnar(self, t, db: str, name: str, touched, updated: dict,
                          modified_rows: int, undo) -> bool:
        """Write new encoded values into copies of the touched blocks.
        `touched`: (block index, ascending row positions) per touched
        block, in block order; `updated`: column -> (data, valid) aligned
        to the touched rows in that order. Before anything is written the
        generated columns that read an updated column are recomputed over
        the touched rows, the CHECKs that read an updated column are
        evaluated over them, the child side of each FK whose column
        changed is searched and the parent side of each FK that
        references a changed column is checked (RESTRICT) and planned
        (CASCADE, SET NULL, applied after the install). Returns False,
        having written nothing, when a recomputed generated value needs a
        new dictionary entry or lands on a key column: the rewrite path
        takes those."""
        from tidb_tpu_torch.chunk import present_temporals

        blocks = t.blocks()
        types = t.schema.types
        n = sum(len(p) for _i, p in touched)

        def old_column(c):
            parts = [blocks[i].columns[c] for i, _p in touched]
            return HostColumn(types[c], np.concatenate([
                pc.data[p] for pc, (_i, p) in zip(parts, touched)]) if parts else
                np.zeros(0, types[c].np_dtype),
                np.concatenate([pc.valid[p] for pc, (_i, p) in zip(parts, touched)])
                if parts else np.zeros(0, bool), t.dictionaries.get(c))

        gens = self._gen_exprs_for(t)
        gen_needed = bool(gens) and any(check_columns(ex) & set(updated) for _c, ex in gens)
        changed = set(updated) | ({c for c, _e in gens} if gen_needed else set())
        checks = [(nm, ex) for nm, ex in self._check_exprs_for(t) if check_columns(ex) & changed]
        fks = [fk for fk in t.fks if fk[1] in changed
               or (fk[2] == db.lower() and fk[3] == t.name and fk[4] in changed)]
        children = [c for c in self._fk_children(db, name)
                    if c[4] in changed or (c[0] == db.lower() and c[1] == t.name and c[3] in changed)]
        post: dict = {}  # column -> present-form values of the touched rows

        def post_values(c):
            if c not in post:
                if c in updated:
                    data, valid = updated[c]
                    col = HostColumn(types[c], data.astype(types[c].np_dtype), valid,
                                     t.dictionaries.get(c))
                else:
                    col = old_column(c)
                post[c] = present_temporals(col).tolist()
            return post[c]

        if gen_needed:
            if {c for c, _e in gens} & set(self._unique_key_cols(t)):
                return False
            reads: set = set()
            for c, ex in gens:
                reads |= check_columns(ex)
            reads = sorted(reads & set(types))
            rows = ([dict(zip(reads, vals)) for vals in zip(*[post_values(c) for c in reads])]
                    if reads else [{} for _ in range(n)])
            self._fill_generated(t, rows)
            for c, _ex in gens:
                vals = [rd[c] for rd in rows]
                col = column_from_values(vals, types[c])
                if types[c].kind == Kind.STRING:
                    # codes of the table's dictionary; a new string needs
                    # the rewrite's dictionary merge
                    d = np.asarray(t.dictionaries.get(c, []), dtype=object)
                    if not len(d):
                        return False
                    codes = np.clip(np.searchsorted(d, np.array(
                        [v if v is not None else "" for v in vals], dtype=object)), 0, len(d) - 1)
                    if any(v is not None and d[k] != v for v, k in zip(vals, codes.tolist())):
                        return False
                    col = HostColumn(types[c], codes.astype(np.int64), col.valid)
                updated[c] = (col.data, col.valid)
                post.pop(c, None)
        if checks:
            reads = set()
            for _nm, ex in checks:
                reads |= check_columns(ex)
            reads = sorted(reads & set(types))
            rows = [dict(zip(reads, vals)) for vals in zip(*[post_values(c) for c in reads])]
            self._check_rows_with(checks, rows)
        for nm, col, rdb, rtbl, rcol in fks:
            if col not in changed:
                continue
            vals = post_values(col)
            self_vals = post_values(rcol) if (rdb == db.lower() and rtbl == t.name) else None
            self._fk_child_check(t, db, nm, col, rdb, rtbl, rcol, vals, self_vals)
        plans = []
        if children:
            def old_new(c):
                oc = old_column(c)
                data, valid = updated[c]
                if types[c].kind == Kind.STRING:
                    d = np.asarray(t.dictionaries.get(c), dtype=object)
                    return (d[oc.data][oc.valid] if len(d) else oc.data[:0]), oc.valid, \
                        d[data] if len(d) else data, valid
                return oc.data[oc.valid], oc.valid, data.astype(oc.data.dtype), valid

            remaining = {}
            for c in self._parent_need(t, db, children):
                if c in updated:
                    olds, _ov, news, nv = old_new(c)
                    remaining[c] = self._keyset_after(t, c, olds, news[nv])
                else:
                    remaining[c] = self._table_keyset(t, c)

            def pairs(rcol):
                if rcol not in updated:
                    # a self-referential child whose own column changed:
                    # the unchanged parent key has nothing to cascade or null
                    none = old_column(rcol).data[:0]
                    return none, none, np.zeros(0, bool), None
                olds, ov, news, nv = old_new(rcol)
                base = self._table_keyset(t, rcol).base
                counts = {}
                for o in olds.tolist():
                    counts[o] = counts.get(o, 0) + 1

                def kept(old):
                    have = int(np.searchsorted(base, old, side="right")
                               - np.searchsorted(base, old, side="left"))
                    key = old.item() if hasattr(old, "item") else old
                    return have > counts.get(key, 0)

                return olds, news[ov], nv[ov], kept

            plans = self._fk_update_guard(t, db, name, children, remaining, pairs, undo)
        self._fk_undo_snapshot(undo, t)
        new_blocks = list(blocks)
        consumed = 0
        for i, pos in touched:
            block = blocks[i]
            k = len(pos)
            cols = dict(block.columns)
            for c, (data, valid) in updated.items():
                src = block.columns[c]
                d, v = src.data.copy(), src.valid.copy()
                d[pos] = data[consumed: consumed + k].astype(d.dtype)
                v[pos] = valid[consumed: consumed + k]
                cols[c] = dataclasses.replace(src, data=d, valid=v)
            consumed += k
            new_blocks[i] = HostBlock(cols, block.nrows, part_id=block.part_id)
        t.replace_blocks(new_blocks, modified_rows=modified_rows)
        self._apply_fk_update_plans(plans, undo)
        return True

    def _dml_order_limit_masks(self, t, masks, order_by, limit):
        """Restrict per-block DML masks (True = affected) to the first
        `limit` matching rows in `order_by` order (plain columns; NULLs
        first ascending, last descending, as MySQL). Returns (masks,
        affected)."""
        blocks = t.blocks()
        total = sum(int(m.sum()) for m in masks)
        if total == 0 or limit is None or total <= limit:
            return masks, total  # ORDER BY without a binding LIMIT changes nothing
        bi = np.concatenate([np.full(int(m.sum()), i, dtype=np.int64) for i, m in enumerate(masks)])
        ri = np.concatenate([np.nonzero(m)[0] for m in masks])
        if order_by:
            keys = []  # np.lexsort order: the last array is primary
            for ob in order_by:
                if not isinstance(ob.expr, ast.Name) or ob.expr.table:
                    raise ValueError("DELETE/UPDATE ... ORDER BY supports plain column names")
                cn = ob.expr.column.lower()
                if cn not in t.schema.types:
                    raise ValueError(f"unknown column {cn!r}")
                data = np.concatenate([
                    np.asarray(b.columns[cn].data, dtype=np.float64)[m] for b, m in zip(blocks, masks)
                ])
                valid = np.concatenate([b.columns[cn].valid[m] for b, m in zip(blocks, masks)])
                if ob.desc:
                    nullk = (~valid).astype(np.int8)  # NULLs last
                    valk = np.where(valid, -data, 0.0)
                else:
                    nullk = valid.astype(np.int8)  # NULLs first
                    valk = np.where(valid, data, 0.0)
                keys.append((nullk, valk))
            operands = []
            for nullk, valk in reversed(keys):
                operands.append(valk)
                operands.append(nullk)
            order = np.lexsort(operands)
        else:
            order = np.arange(len(bi))
        take = order[:limit]
        out = []
        for i, m in enumerate(masks):
            nm = np.zeros_like(m)
            nm[ri[take[bi[take] == i]]] = True
            out.append(nm)
        return out, int(len(take))

    def _eval_where_per_block(self, t, db: str, where):
        """WHERE over `db`'s table `t` on the device in one scan, fetched
        as one mask without compaction; returns per-block masks of the
        matching rows (the batch's rows follow the blocks' order) and
        their count. (The JAX session looks the table up by name in the
        first database that has one, which picks the wrong table when
        two databases hold the same name.)"""
        sel = ast.Select(
            items=[ast.SelectItem(where, alias="_m")],
            from_=ast.TableRef(None, t.name, None),
        )
        plan = build_query(sel, self.catalog, db, self._scalar_subquery)
        batch, _dicts = self.executor.run(plan)
        c = batch.cols[list(plan.schema)[0].internal]
        m = (c.data.to(torch.bool) & c.valid & batch.row_valid).numpy()
        masks, off = [], 0
        for b in t.blocks():
            masks.append(m[off: off + b.nrows])
            off += b.nrows
        return masks, int(m[:off].sum())
