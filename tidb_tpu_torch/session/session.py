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
``statistics``, ``table_constraints`` and ``key_column_usage``
(storage/catalog.py).

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
DEFAULT, AUTO_INCREMENT, IF NOT EXISTS, ... LIKE, ... AS SELECT), DROP
TABLE, TRUNCATE, INSERT (VALUES, column lists, defaults, ... SELECT,
IGNORE, AUTO_INCREMENT with LAST_INSERT_ID()), DELETE and single-table
UPDATE (WHERE, ORDER BY ... LIMIT; UPDATE takes the columnar path where
the JAX session does and rewrites the table otherwise), and
transactions: BEGIN / START TRANSACTION [READ ONLY], COMMIT, ROLLBACK,
SAVEPOINT, ROLLBACK TO, RELEASE and SELECT ... FOR UPDATE. A transaction
writes into shadow tables and reads pinned snapshots of the rest; COMMIT
installs the shadows after a version check (first committer wins).
``tidb_txn_mode = pessimistic`` (the default) takes table locks per DML
statement until the transaction ends; an autocommit writer takes them
for its statement. An autocommit DML that changed more than
``tidb_auto_analyze_ratio`` of a table re-analyzes it. REPLACE, ON
DUPLICATE KEY UPDATE, LOAD DATA, multi-table UPDATE/DELETE, FOREIGN
KEY, CHECK, generated columns, PARTITION BY, ALTER TABLE, indexes,
views (and SHOW CREATE VIEW), sequences and temporary tables raise
``NotImplementedError`` naming themselves, and so do the
information_schema tables of those features (``views``, ``sequences``,
``partitions``, ``referential_constraints``), its diagnostic tables and
metrics_schema.

WITH RECURSIVE materializes each recursive CTE step by step into a
scratch table (``_run_recursive_with``); EXPLAIN renders the plan with
estimated rows and EXPLAIN ANALYZE runs it once instrumented
(``_run_explain``).

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
import itertools
import math
import operator
import threading
import time
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
from tidb_tpu_torch.parser import ast, parse
from tidb_tpu_torch.planner import build_query
from tidb_tpu_torch.planner.logical import ExprBinder, Schema, _display_name, _scalar_subq
from tidb_tpu_torch.planner.physical import PhysicalExecutor, StaleWidthsError
from tidb_tpu_torch.planner.streamed import try_streamed_sort
from tidb_tpu_torch.stats import analyze_table
from tidb_tpu_torch.stats.handle import maybe_auto_analyze
from tidb_tpu_torch.storage import Catalog, Table, TableSchema
from tidb_tpu_torch.storage import scan as _scan
from tidb_tpu_torch.storage.catalog import unported_virtual_table
from tidb_tpu_torch.storage.locks import DeadlockError, next_txn_id
from tidb_tpu_torch.storage.table import set_gc_life
from tidb_tpu_torch.tools.dump import create_table_sql
from tidb_tpu_torch.utils import collate as _coll
from tidb_tpu_torch.utils.collate import CHARSET_DEFAULTS
from tidb_tpu_torch.utils.metrics import sql_digest
from tidb_tpu_torch.utils.sqlkiller import SQLKiller
from tidb_tpu_torch.utils.sysvar import SysVars

_READS = (ast.Select, ast.Union, ast.With, ast.SetOp)
_DML = (ast.Insert, ast.Update, ast.Delete)

#: statements this slice leaves out, by the name the error gives them
_UNPORTED = {
    ast.AlterTable: "ALTER TABLE",
    ast.MultiAlter: "ALTER TABLE",
    ast.CreateIndex: "CREATE INDEX",
    ast.DropIndex: "DROP INDEX",
    ast.CreateView: "views (CREATE VIEW)",
    ast.DropView: "views (DROP VIEW)",
    ast.CreateSequence: "sequences (CREATE SEQUENCE)",
    ast.DropSequence: "sequences (DROP SEQUENCE)",
    ast.LoadData: "LOAD DATA",
    ast.RenameTable: "RENAME TABLE",
}

# process-unique names of recursive CTEs' scratch tables: the scratch
# database is shared by every session of a catalog
_cte_scratch_seq = itertools.count(1)

_STATEMENT_LOCKS: Dict[str, threading.RLock] = {}
_STATEMENT_LOCKS_GUARD = threading.Lock()


def statement_lock(device) -> threading.RLock:
    """The process-wide lock under which one statement at a time runs on
    `device`. Re-entrant: EXECUTE of a statement prepared by text runs
    ``execute`` again inside it."""
    with _STATEMENT_LOCKS_GUARD:
        return _STATEMENT_LOCKS.setdefault(str(device), threading.RLock())


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


def _render_plan(plan, depth: int, out: List[str]) -> None:
    """EXPLAIN's lines: one per node, indented by depth, with the
    estimated rows ``est_rows`` annotated (the JAX package's
    ``_render_plan``). The JAX package also prints the access path it
    would take (a primary-key range, an index merge, pruned partitions);
    the port scans whole tables and prints none."""
    from tidb_tpu_torch.planner import logical as L

    pad = "  " * depth
    name = type(plan).__name__
    detail = ""
    if isinstance(plan, L.Scan):
        detail = f" table={plan.db}.{plan.table} cols={len(plan.columns)}"
    elif isinstance(plan, L.Selection):
        detail = f" pred={plan.predicate!r}"
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
            _render_plan(c, depth + 1, out)
    for c in getattr(plan, "children", []) or []:
        _render_plan(c, depth + 1, out)


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


class Session:
    def __init__(
        self,
        catalog: Optional[Catalog] = None,
        db: str = "test",
        device=None,
        user: str = "root",
    ):
        self.catalog = catalog if catalog is not None else Catalog()
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

    def execute(self, sql: str) -> Result:
        res = Result([], [])
        stmts = parse(sql)
        for s in stmts:
            if len(stmts) == 1:
                # a single statement's text: its digest matches bindings
                # and SHOW PROCESSLIST prints it
                s._source_sql = sql
            res = self._run_top(s)
        return res

    def close(self) -> None:
        """End the session: an open transaction rolls back, releasing
        its table locks and pins."""
        self._abort_txn()

    def _run_top(self, s) -> Result:
        """One statement: the table locks it needs first, waiting
        outside the statement lock, then its execution inside it.
        Statement-scoped locks are released when it ends. EXECUTE binds
        first, so that the bound statement takes its own locks here. KILL
        and SHOW PROCESSLIST touch host state only and take no lock: a
        KILL must reach a statement that holds the statement lock."""
        if self._killed_conn:
            raise ConnectionError(f"connection {self.conn_id} was killed")
        if isinstance(s, ast.ExecuteStmt):
            vals = []
            for v in s.using:
                if v not in self.user_vars:
                    raise ValueError(f"user variable @{v} is not set")
                vals.append(self.user_vars[v])
            return self.execute_prepared(s.name, vals)
        self._check_ported(s)
        if isinstance(s, ast.Kill) or (isinstance(s, ast.Show) and s.what == "processlist"):
            return self._execute_stmt(s)
        release = self._take_locks(s)
        try:
            with statement_lock(self.device):
                t0 = time.perf_counter()
                res = self._execute_stmt(s)
                res.elapsed_s = time.perf_counter() - t0
        finally:
            release()
        return res

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
        its counters, the diagnostics area, its processlist entry, the
        killer cleared with the statement's deadline, and the stale-read
        state. ``tidb_read_staleness`` applies to a read only; an AS OF
        inside a DML is refused rather than read fresh."""
        self.cte_log = []
        self._stmt_count += 1
        if isinstance(s, _READS):
            self._select_count += 1
        if not (isinstance(s, ast.Show) and s.what == "warnings"):
            self._warnings = []
        limit_ms = int(self.vars.get("max_execution_time") or 0)
        self.killer.clear(deadline=time.monotonic() + limit_ms / 1000.0 if limit_ms else 0.0)
        self._current_stmt = (getattr(s, "_source_sql", type(s).__name__), time.time())
        self._stale_ok = isinstance(s, _READS)
        inner = s.stmt if isinstance(s, ast.Explain) else s
        self._stmt_as_of = {}
        if isinstance(inner, _READS):
            self._stmt_as_of = self._collect_as_of(inner)
        elif any(r.as_of is not None for r in ast.iter_table_refs(inner)):
            raise ValueError("AS OF TIMESTAMP is only allowed in read-only statements")

    def _dispatch(self, s) -> Result:
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
        if isinstance(s, ast.TxnControl):
            return self._run_txn_control(s)
        if isinstance(s, ast.CreateTable):
            return self._run_create_table(s)
        if isinstance(s, ast.DropTable):
            if s.temporary:
                raise NotImplementedError("temporary tables are not ported yet")
            db = s.db or self.db
            t = self.catalog.table(db, s.name) if self.catalog.has_table(db, s.name) else None
            self.catalog.drop_table(db, s.name, s.if_exists)
            if t is not None:
                _scan.release(t)
            return Result([], [])
        if isinstance(s, ast.TruncateTable):
            t = self._resolve_table_for_write(s.db or self.db, s.name)
            t.replace_blocks([], modified_rows=t.nrows)
            t.autoinc_next = 1  # TRUNCATE resets AUTO_INCREMENT (DDL)
            _scan.invalidate(t)
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
                if s.name.lower() == "tidb_gc_life_time":
                    # the storage GC horizon is engine-wide; the variable
                    # is GLOBAL-only, so the global store holds the value
                    set_gc_life(float(self.vars._globals.get("tidb_gc_life_time", 0)))
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
        raise NotImplementedError(f"{type(s).__name__} statements are not ported yet")

    def _check_ported(self, s) -> None:
        """Refuse, before any lock is taken, a statement this slice
        leaves out, or a clause whose effect it does not port (one that
        would be read and then ignored), naming it."""
        what = _UNPORTED.get(type(s))
        if isinstance(s, ast.Insert):
            what = "REPLACE" if s.replace else (
                "INSERT ... ON DUPLICATE KEY UPDATE" if s.on_dup else None)
        elif isinstance(s, ast.Update) and s.from_refs is not None:
            what = "multi-table UPDATE"
        elif isinstance(s, ast.Delete) and s.targets is not None:
            what = "multi-table DELETE"
        elif isinstance(s, ast.Show) and s.what == "create_view":
            what = "views (SHOW CREATE VIEW)"
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

        _walk_dataclasses(s, see)
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
                # CTE names and derived tables are not catalog tables
                if self.catalog.has_table(db, tr.name):
                    self._check_priv("select", db, tr.name.lower())

        if isinstance(s, _READS + (ast.Explain,)):
            reads(s)
        elif isinstance(s, _DML):
            priv = {ast.Insert: "insert", ast.Update: "update", ast.Delete: "delete"}[type(s)]
            if s.table is not None:
                self._check_priv(priv, (s.db or self.db).lower(), s.table.lower())
            # a table read inside the statement (INSERT ... SELECT, a
            # subquery in SET or WHERE) needs SELECT
            reads(s)
        elif isinstance(s, ast.CreateTable):
            self._check_priv("create", (s.db or self.db).lower())
            if s.as_query is not None:
                reads(s.as_query)
        elif isinstance(s, (ast.DropTable, ast.TruncateTable)):
            # MySQL requires DROP for TRUNCATE (it is DDL)
            self._check_priv("drop", (s.db or self.db).lower(), s.name.lower())
        elif isinstance(s, (ast.CreateDatabase, ast.DropDatabase)):
            self._check_priv(
                "create" if isinstance(s, ast.CreateDatabase) else "drop", s.name.lower())
        elif isinstance(s, ast.AnalyzeTable):
            self._check_priv("select", (s.db or self.db).lower(), s.name.lower())
        elif isinstance(s, (ast.CreateUser, ast.DropUser, ast.GrantStmt, ast.CreateBinding)):
            self._require_super()

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

    # -- SHOW ----------------------------------------------------------
    def _run_show(self, s: ast.Show) -> Result:
        """The JAX session's ``_run_show``. SHOW ENGINES names the port's
        engine in its comment (the JAX package names its XLA engine); every
        other column is the same."""
        pat = s.db or "%"
        if s.what == "tables":
            return Result(["Tables"], [(t,) for t in self.catalog.tables(self.db)])
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
        # the per-table forms: columns, create_table, index
        db, name = s.db.split(".", 1)
        db = db or self.db
        what = {"columns": "SHOW COLUMNS", "create_table": "SHOW CREATE",
                "index": "SHOW INDEX"}[s.what]
        self._require_some_table_priv(db, name, what, extra=("index",) if s.what == "index" else ())
        t = self.catalog.table(db, name)
        if s.what == "create_table":
            return Result(["Table", "Create Table"],
                          [(name.lower(), create_table_sql(t).rstrip(";"))])
        pk = list(t.schema.primary_key or [])
        if s.what == "index":
            return Result(["Table", "Key_name", "Seq_in_index", "Column_name", "Non_unique"],
                          [(name, "primary", i, cn, 0) for i, cn in enumerate(pk, 1)])
        return Result(["Field", "Type", "Null", "Key", "Default"], [
            (n, repr(ty).lower(), "NO" if n in pk else "YES", "PRI" if n in pk else "",
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

    def execute_prepared(self, name: str, values) -> Result:
        """Bind `values` to a copy of the prepared statement and run it,
        planned anew (reference: plan_cache.go; the JAX package's
        runtime-slot fast path is not ported, ROADMAP.md)."""
        ent = self._prepared.get(name.lower())
        if ent is None:
            raise ValueError(f"unknown prepared statement {name}")
        values = list(values)
        if len(values) != ent["nparams"]:
            raise ValueError(
                f"statement expects {ent['nparams']} parameters, got {len(values)}"
            )
        if "textual" in ent:
            from tidb_tpu_torch.server.protocol import bind_placeholders

            return self.execute(bind_placeholders(ent["textual"], values))
        s = copy.deepcopy(ent["ast"])
        _bind_ast_params(s, values)
        return self._run_top(s)

    # -- bindings ------------------------------------------------------
    def _run_binding(self, s: ast.CreateBinding) -> Result:
        """CREATE / DROP BINDING: a plain SELECT's digest -> the hints of
        the USING statement (reference: pkg/bindinfo). The JAX package
        also counts binding hits in its metrics registry; the port has no
        registry yet."""
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
        entry = self.catalog.bindings.get(sql_digest(src))
        if entry is not None:
            s.hints = tuple(entry["hints"]) or s.hints
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
        try:
            plan = build_query(s, self.catalog, self.db, self._scalar_subquery, ctes)
            names = [c.name for c in plan.schema]
            rows = self._try_host_sorted(plan)
            if rows is None:
                batch, dicts = self.executor.run(plan)
                rows = materialize_rows(batch, list(plan.schema), dicts)
            return Result(names, rows, types=[c.type for c in plan.schema])
        finally:
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
            return Result(["plan"], [(line,) for line in lines])
        est_rows(plan, self.catalog)  # annotates .est on every node
        lines: List[str] = []
        _render_plan(plan, 0, lines)
        return Result(["plan"], [(line,) for line in lines])

    # -- recursive CTEs ------------------------------------------------
    # Iterative materialization (reference: CTEExec's seed and recursive
    # iteration, pkg/executor/cte.go:70): each recursive CTE is evaluated
    # to a fixpoint into a scratch table, and the body plans against a
    # plain SELECT over it. The JAX loop's `cte/iterate` failpoint is left
    # out: failpoints are not ported.
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
            shadow.autoinc_col = t.autoinc_col
            shadow.autoinc_next = t.autoinc_next
            shadow.defaults = dict(t.defaults)
            # the uniqueness index is keyed by block uids: the shadow's
            # blocks are the snapshot's, so it carries over
            shadow._key_cache = dict(t._key_cache)
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
        if isinstance(s, (*_DML, ast.TruncateTable)):
            name = s.name if isinstance(s, ast.TruncateTable) else s.table
            tables = [(s.db or self.db, name)]
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
                    lm.acquire(txn_id, k, timeout=self._lock_timeout())
                    locked.add(k)
                    self._advance_snapshot(k)
            except DeadlockError:
                self._abort_txn()
                raise
            return lambda: None
        sid = next_txn_id()
        try:
            for k in sorted(keys):
                lm.acquire(sid, k, timeout=self._lock_timeout())
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
                lm.acquire(cid, k, timeout=self._lock_timeout())
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
            with self.catalog._commit_mu:
                for (db, name) in txn["shadows"]:
                    base = self.catalog.table(db, name)
                    if base.version != txn["base_versions"][(db, name)]:
                        raise RuntimeError(
                            f"write conflict on {db}.{name}: table changed since transaction start"
                        )
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
        maybe_auto_analyze(self.catalog.table(s.db or self.db, s.table), ratio, device=self.device)

    # -- DDL -----------------------------------------------------------
    def _run_create_table(self, s: ast.CreateTable) -> Result:
        db = s.db or self.db
        for what, present in (
            ("temporary tables", s.temporary),
            ("FOREIGN KEY", s.fks),
            ("CHECK", s.checks),
            ("PARTITION BY", s.partition is not None),
            ("TTL", s.ttl is not None),
            ("indexes in CREATE TABLE", s.indexes),
            ("generated columns", any(c.generated is not None for c in s.columns)),
        ):
            if present:
                raise NotImplementedError(f"{what} is not ported yet")
        if s.as_query is not None:
            return self._run_ctas(s, db)
        if s.like is not None:
            src = self.catalog.table(s.like[0] or self.db, s.like[1])
            if s.if_not_exists and self.catalog.has_table(db, s.name):
                return Result([], [])
            # the definition, not the data; AUTO_INCREMENT restarts. The
            # JAX package clones through its rendered DDL, which carries
            # no ENUM, SET or JSON domain, so neither does this
            pk = src.schema.primary_key
            t = self.catalog.create_table(db, s.name, TableSchema(
                list(src.schema.columns), primary_key=list(pk) if pk else None,
                not_null=tuple(src.schema.not_null)))
            t.autoinc_col = src.autoinc_col
            t.defaults = dict(src.defaults)
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
        auto = [c for c in s.columns if c.auto_increment]
        if auto and (len(auto) > 1 or auto[0].type.kind != Kind.INT):
            raise ValueError("one integer AUTO_INCREMENT column per table")
        existed = s.if_not_exists and self.catalog.has_table(db, s.name)
        t = self.catalog.create_table(db, s.name, schema, s.if_not_exists)
        if not existed:
            if auto:
                t.autoinc_col = auto[0].name.lower()
            t.defaults = {c.name.lower(): c.default for c in s.columns if c.default is not None}
        return Result([], [])

    def _run_ctas(self, s: ast.CreateTable, db: str) -> Result:
        """CREATE TABLE ... AS SELECT: the schema comes from the query.
        The existence check runs first, so a large query does not run
        only to be thrown away."""
        if self.catalog.has_table(db, s.name):
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
        t = self.catalog.create_table(db, s.name, TableSchema(cols))
        if res.rows:
            t.append_rows([list(r) for r in res.rows])
        return Result([], [], affected=len(res.rows))

    # -- INSERT --------------------------------------------------------
    def _run_insert(self, s: ast.Insert) -> Result:
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
        if s.ignore:
            rows = self._filter_ignore(t, names, self._fill_ignore_null_pk(t, names, rows))
        t.append_rows(rows)
        self._drop_cached(invalidate=[t])
        return Result([], [], affected=len(rows))

    def _const_value(self, e):
        if isinstance(e, ast.Const):
            return e.value
        if isinstance(e, ast.Call) and e.op == "neg" and isinstance(e.args[0], ast.Const):
            return -e.args[0].value
        if isinstance(e, ast.Call) and e.op.lower() in ("nextval", "lastval", "setval"):
            raise NotImplementedError("sequences (NEXTVAL) are not ported yet")
        raise ValueError("INSERT VALUES must be literals")

    def _fill_ignore_null_pk(self, t, names, rows):
        """INSERT IGNORE: a NULL in a PRIMARY KEY column takes the
        column's implicit default (0, '', the zero date), as MySQL does
        under IGNORE, with a warning (SHOW WARNINGS); a kind with none
        drops the row."""
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

    def _incoming_key_matrix(self, t, cols, names, rows):
        """Incoming rows' key columns in the table's encoded domain:
        (key matrix, all-valid mask) aligned to the rows. A string the
        table's dictionary lacks gets a provisional code above every real
        one, so it conflicts with its repeats but never with stored
        rows."""
        columns = {}
        for c in cols:
            i = names.index(c)
            vals = [r[i] for r in rows]
            typ = t.schema.types[c]
            if typ.kind != Kind.STRING:
                columns[c] = column_from_values(vals, typ)
                continue
            d = t.dictionaries.get(c)
            lut = {str(x): j for j, x in enumerate(d)} if d is not None else {}
            ext: Dict[str, int] = {}
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

    def _filter_ignore(self, t, names, rows):
        """INSERT IGNORE: drop (instead of fail) rows whose PRIMARY KEY
        is already stored or repeats an earlier row of the statement."""
        pk = t.schema.primary_key
        if not pk or not rows:
            return rows
        mat, allv = self._incoming_key_matrix(t, list(pk), names, rows)
        view = Table._rows_view(mat)
        stored = t._sorted_composite(tuple(pk))
        if stored is not None and len(stored):
            pos = np.clip(np.searchsorted(stored, view), 0, len(stored) - 1)
            in_table = allv & (stored[pos] == view)
        else:
            in_table = np.zeros(len(rows), dtype=bool)
        kept, seen = [], set()
        for j, r in enumerate(rows):
            if allv[j]:
                k = view[j].tobytes()
                if in_table[j] or k in seen:
                    continue
                seen.add(k)
            kept.append(r)
        return kept

    # -- DELETE --------------------------------------------------------
    def _run_delete(self, s: ast.Delete) -> Result:
        t = self._resolve_table_for_write(s.db or self.db, s.table)
        if s.where is None and not (s.limit is not None or s.order_by):
            affected = t.nrows
            t.replace_blocks([], modified_rows=affected)
            self._drop_cached(invalidate=[t])
            return Result([], [], affected=affected)
        if s.where is None:
            masks = [np.ones(b.nrows, dtype=bool) for b in t.blocks()]
        else:
            masks, affected = self._eval_where_per_block(t, s.db or self.db, s.where)
        masks, affected = self._dml_order_limit_masks(t, masks, s.order_by, s.limit)
        t.delete_where([~m for m in masks])
        self._drop_cached(invalidate=[t])
        return Result([], [], affected=affected)

    # -- UPDATE --------------------------------------------------------
    def _run_update(self, s: ast.Update) -> Result:
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
        if s.where is None:
            affected = len(rows)
        else:
            _masks, affected = self._eval_where_per_block(t, s.db or self.db, s.where)
        saved_blocks, saved_dicts = list(t.blocks()), dict(t.dictionaries)
        t.replace_blocks([], modified_rows=affected)
        try:
            if rows:
                t.append_rows(rows)
        except Exception:
            # e.g. the SET made duplicate keys: the statement rolls back
            t.replace_blocks(saved_blocks, modified_rows=affected)
            t.dictionaries = saved_dicts
            raise
        finally:
            self._drop_cached(invalidate=[t])
        return Result([], [], affected=affected)

    def _try_columnar_update(self, t, s: ast.Update, sets) -> Optional[Result]:
        """UPDATE that writes new values of the SET columns into copies
        of only the touched blocks, or None where the JAX session takes
        the rewrite path: a PRIMARY KEY column SET (its uniqueness needs
        whole rows), a string SET other than a constant already in the
        column's dictionary, no WHERE, or an empty table. New values come
        from ``SELECT CAST(<expr> AS <column type>) ... WHERE <where>``,
        in the blocks' row order."""
        types = t.schema.types
        if any(c not in types for c in sets):
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
        if set(t.schema.primary_key or ()) & set(sets):
            return None
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
        new_blocks = []
        consumed = 0
        for block, m in zip(t.blocks(), masks):
            hit = int(m.sum())
            if hit == 0:
                new_blocks.append(block)
                continue
            pos = np.nonzero(m)[0]
            cols = dict(block.columns)
            for c in set_cols:
                src = block.columns[c]
                data, valid = src.data.copy(), src.valid.copy()
                data[pos] = new_data[c][consumed: consumed + hit].astype(data.dtype)
                valid[pos] = new_valid[c][consumed: consumed + hit]
                cols[c] = dataclasses.replace(src, data=data, valid=valid)
            for c, code in str_codes.items():
                src = block.columns[c]
                data, valid = src.data.copy(), src.valid.copy()
                data[pos] = np.asarray(code, dtype=data.dtype)
                valid[pos] = True
                cols[c] = dataclasses.replace(src, data=data, valid=valid)
            consumed += hit
            new_blocks.append(HostBlock(cols, block.nrows, part_id=block.part_id))
        t.replace_blocks(new_blocks, modified_rows=affected)
        self._drop_cached(invalidate=[t])
        return Result([], [], affected=affected)

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
