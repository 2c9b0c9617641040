"""AST -> logical plan: name resolution, aggregate extraction, pushdown.

Reference: pkg/planner/core/logical_plan_builder.go (AST -> logical ops),
expression_rewriter.go (subqueries), and the fixed-order logical rule list
(optimizer.go:98-123). This builder applies the high-value rules inline:

- column pruning (columnPruner): scans read only referenced columns
- predicate pushdown (ppdSolver): WHERE conjuncts sink below joins to the
  side whose columns they reference; equi-conjuncts in ON become join keys
- projection elimination: additive projections keep base columns so ORDER
  BY can reference non-selected columns (MySQL scoping)

Internal column names are ``qualifier.column`` — unique across the plan,
used directly as device Batch column names.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from tidb_tpu_torch.dtypes import BOOL, DATE, INT64, STRING, Kind, SQLType
from tidb_tpu_torch.expression.expr import ColumnRef, Expr, Func, Literal
from tidb_tpu_torch.parser import ast

# virtual row-handle column for multi-table DML (analog of _tidb_rowid):
# exposed only on scans whose alias is in the expose_rowid() scope's set
# (the DML's target tables), so joined read-only tables keep partition
# pruning / index-range access, and star expansion filters it by name
ROWID_NAME = "_tidb_rowid"
import contextlib as _contextlib
import contextvars as _contextvars

_EXPOSE_ROWID = _contextvars.ContextVar("expose_rowid", default=frozenset())


@_contextlib.contextmanager
def expose_rowid(aliases):
    tok = _EXPOSE_ROWID.set(frozenset(a.lower() for a in aliases))
    try:
        yield
    finally:
        _EXPOSE_ROWID.reset(tok)


class PlanError(ValueError):
    pass


@dataclasses.dataclass
class OutCol:
    """One column of a plan node's schema."""

    qualifier: Optional[str]  # table alias; None for computed columns
    name: str  # bare column name or output alias
    internal: str  # unique name used in device batches
    type: SQLType


class Schema:
    def __init__(self, cols: List[OutCol]):
        self.cols = cols

    def resolve(self, table: Optional[str], name: str) -> OutCol:
        name_l = name.lower()
        matches = [
            c
            for c in self.cols
            if c.name.lower() == name_l
            and (table is None or (c.qualifier or "").lower() == table.lower())
        ]
        if not matches:
            raise PlanError(f"unknown column {table + '.' if table else ''}{name}")
        if len(matches) > 1:
            # identical internal name means the same column seen twice
            if len({m.internal for m in matches}) > 1:
                raise PlanError(f"ambiguous column {name}")
        return matches[0]

    def types(self) -> Dict[str, SQLType]:
        return {c.internal: c.type for c in self.cols}

    def __iter__(self):
        return iter(self.cols)


class LayeredSchema(Schema):
    """MySQL ORDER BY scoping: select aliases shadow base columns of the
    same name; base columns remain reachable when no alias matches."""

    def __init__(self, *layers: Schema):
        super().__init__([c for l in layers for c in l.cols])
        self.layers = layers

    def resolve(self, table: Optional[str], name: str) -> OutCol:
        last_err = None
        for layer in self.layers:
            try:
                return layer.resolve(table, name)
            except PlanError as e:
                last_err = e
        raise last_err


# ---------------------------------------------------------------------------
# Logical operators
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LogicalPlan:
    schema: Schema


@dataclasses.dataclass
class OneRow(LogicalPlan):
    """Single-row, zero-column source — the dual table for tableless
    SELECTs (reference: TableDual plan)."""


@dataclasses.dataclass
class Scan(LogicalPlan):
    db: str
    table: str  # catalog table name
    alias: str  # qualifier
    columns: List[str]  # pruned, bare storage names (internal = alias.name)
    # cross-host fragment slice (planner/fragmenter.py): (idx, n) takes
    # every n-th row starting at idx of the version's block concatenation
    # — the per-host disjoint cover the DCN scheduler dispatches (the
    # region-partitioned MPP TableScan analog, pkg/store/copr/mpp.go:93).
    # None = whole-table scan.
    frag: Optional[Tuple[int, int]] = None


@dataclasses.dataclass
class Selection(LogicalPlan):
    child: LogicalPlan
    predicate: Expr  # bound


@dataclasses.dataclass
class Projection(LogicalPlan):
    child: LogicalPlan
    exprs: List[Tuple[str, Expr]]  # (internal out name, bound expr)
    additive: bool = False  # keep child columns too


@dataclasses.dataclass
class Aggregate(LogicalPlan):
    child: LogicalPlan
    group_exprs: List[Tuple[str, Expr]]  # (internal key name, bound expr)
    aggs: List[Tuple[str, str, Optional[Expr], bool]]  # (name, func, arg, distinct)
    # GROUP_CONCAT extras per agg name: (separator, ((bound expr, desc), ...)).
    # Presence of any entry routes the node through the host-assisted
    # aggregation stage (planner/hostagg.py) — string concatenation is
    # inherently host work (variable-length output).
    gc_meta: Optional[Dict[str, Tuple[str, tuple]]] = None


@dataclasses.dataclass
class JoinPlan(LogicalPlan):
    kind: str  # inner/left/semi/anti/cross
    left: LogicalPlan
    right: LogicalPlan
    # bound equi keys (left expr, right expr); may be empty for cross
    equi_keys: List[Tuple[Expr, Expr]]
    residual: Optional[Expr] = None
    null_aware: bool = False  # NOT IN semantics
    # cost-based mesh exchange choice ('left'/'right'/None): the named
    # side is estimated small enough to replicate (broadcast join)
    # instead of hash-repartitioning both sides. Set from ANALYZE stats
    # (cardinality.py); part of the plan fingerprint since it changes
    # the compiled exchange. Reference: broadcast-vs-shuffle MPP join in
    # pkg/planner/core/exhaust_physical_plans.go.
    broadcast: Optional[str] = None
    # mark join only: name of the boolean result column appended to the
    # probe schema (expression_rewriter.go LeftOuterSemiJoin analog)
    mark_name: Optional[str] = None


@dataclasses.dataclass
class Window(LogicalPlan):
    """One OVER spec; descs: (out name, func, bound arg, offset, running,
    frame) where frame is a (lo, hi) ROWS offset pair (None = unbounded
    side) or None for default framing."""

    child: LogicalPlan
    partition_exprs: List[Expr]
    order_exprs: List[Tuple[Expr, bool]]
    descs: List[Tuple[str, str, Optional[Expr], int, bool, Optional[tuple]]]


@dataclasses.dataclass
class Sort(LogicalPlan):
    child: LogicalPlan
    keys: List[Tuple[Expr, bool]]  # (bound expr, desc)


@dataclasses.dataclass
class Limit(LogicalPlan):
    child: LogicalPlan
    count: int
    offset: int = 0


@dataclasses.dataclass
class Staged(LogicalPlan):
    """A pre-computed device batch injected into a plan — the output of
    an out-of-band execution stage (streamed aggregation over a table
    too large for one device tile). The physical compiler treats it as
    a constant source; the nonce keeps plan-cache keys unique.

    With ``key`` set, the batch becomes a runtime INPUT instead of a
    baked constant, and the plan cache keys on (key, capacity, column
    dtypes, dictionary content hash) rather than the nonce — repeated
    executions of the same plan shape over fresh data (every shuffle
    stage's consumer) reuse one compiled program instead of paying a
    full XLA compile per stage. Dictionary content stays part of the
    cache key because string-key alignment bakes LUTs from it at
    compile time."""

    batch: object = None  # device Batch
    dicts: Optional[Dict] = None
    nonce: int = 0
    key: Optional[str] = None


@dataclasses.dataclass
class ShuffleRead(LogicalPlan):
    """Leaf standing for the receiving worker's shuffle partition of
    exchange side `tag` — the ExchangeReceiver of the cross-host
    shuffle service (parallel/shuffle.py). Serializable (unlike Staged:
    the node carries no data, only the wire schema); the worker
    substitutes a Staged batch built from its received partition before
    execution, so the physical compiler never sees it."""

    tag: int = 0


@dataclasses.dataclass
class StageInput(LogicalPlan):
    """Leaf standing for THIS worker's held output of an earlier
    shuffle-DAG stage (parallel/shuffle.py ShuffleWorker._held): the
    output partitions of stage N become the fragment-sliced producer
    input of stage N+1 — no re-scan, no re-exchange of what this host
    already owns. Serializable (the node carries only the wire schema
    and the source stage index); the worker substitutes the held
    HostBlock before execution, so like ShuffleRead the physical
    compiler never sees it."""

    stage: int = 0


@dataclasses.dataclass
class UnionAll(LogicalPlan):
    """Bag union by position; children are projections onto _u{i} names
    with casts to the common types (reference UnionExec,
    pkg/executor/unionexec)."""

    children: List[LogicalPlan] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# Expression binding (parser AST -> bound expression.Expr)
# ---------------------------------------------------------------------------


# Aggregate output columns use per-node-indexed names (_g0.., _a0..):
# deterministic across parses (the plan cache fingerprints plan reprs,
# pkg/planner/core/plan_cache.go analog) and collision-free because
# aggregate outputs are always re-projected before meeting another
# namespace (FROM-subqueries rename to alias.col; semi joins keep only
# probe columns).


class ExprBinder:
    """Lowers parser expression AST to bound expression trees against a
    schema. Aggregate calls and subqueries must have been rewritten out
    before binding (SelectBuilder does that)."""

    def __init__(self, schema: Schema, subquery_executor=None):
        self.schema = schema
        self.subquery_executor = subquery_executor

    def bind(self, e) -> Expr:
        from tidb_tpu_torch.expression.expr import bind_expr

        lowered = self.lower(e)
        return bind_expr(lowered, self.schema.types())

    def lower(self, e) -> Expr:
        if isinstance(e, ast.Name):
            c = self.schema.resolve(e.table, e.column)
            return ColumnRef(name=c.internal)
        if isinstance(e, ast.Const):
            t = e.type_hint
            return Literal(
                type=t, value=e.value,
                param_slot=getattr(e, "param_index", None),
            )
        if isinstance(e, ast.Interval):
            raise PlanError("INTERVAL outside date arithmetic")
        if isinstance(e, ast.SubqueryExpr):
            if self.subquery_executor is None:
                raise PlanError("subquery not supported in this context")
            return self.subquery_executor(e)
        if isinstance(e, ast.AggCall):
            raise PlanError(
                f"aggregate {e.func}() not allowed here (no GROUP BY context)"
            )
        if isinstance(e, ast.Call):
            return self.lower_call(e)
        raise PlanError(f"cannot bind {e!r}")

    # name aliases normalized before compilation (reference: the alias
    # rows in pkg/expression/builtin.go funcs registry)
    _FN_ALIASES = {
        "substr": "substring",
        "mid": "substring",
        "ucase": "upper",
        "lcase": "lower",
        "character_length": "char_length",
        "ceiling": "ceil",
        "power": "pow",
        "dayofmonth": "day",
        "lengthb": "length",
        "adddate": "date_add",
        "subdate": "date_sub",
        "rlike": "regexp",
        "insert": "insert_str",
        "octet_length": "length",
        "utc_timestamp": "now",
        "curtime": "current_time",
        "lastday": "last_day",
        "localtime": "now",
        "sha": "sha1",
        "mid": "substring",
    }

    @staticmethod
    def _const_arg(x):
        """ast.Const of x, folding a leading unary minus; None if not
        constant (pre-bind normalization for const-only builtins)."""
        if isinstance(x, ast.Const):
            return x
        if (
            isinstance(x, ast.Call)
            and x.op == "neg"
            and len(x.args) == 1
            and isinstance(x.args[0], ast.Const)
            and isinstance(x.args[0].value, (int, float))
        ):
            return ast.Const(-x.args[0].value)
        return None

    def lower_call(self, e: ast.Call) -> Expr:
        op = self._FN_ALIASES.get(e.op, e.op)
        if op in ("conv", "char"):
            consts = [self._const_arg(a) for a in e.args]
            if any(c is None for c in consts):
                raise PlanError(f"{op.upper()} supports constant arguments only")
            e = ast.Call(op, consts)
        if op in ("date_add", "date_sub") and len(e.args) == 2 and not isinstance(
            e.args[1], ast.Interval
        ):
            # ADDDATE(d, n) / SUBDATE(d, n): bare N means N days
            e = ast.Call(op, [e.args[0], ast.Interval(e.args[1], "day")])
        if op == "strcmp" and len(e.args) == 2:
            # STRCMP(a, b) -> CASE WHEN a < b THEN -1 WHEN a = b THEN 0
            # ELSE 1 (NULL propagation via the comparisons)
            a, b = e.args
            return self.lower(
                ast.Call(
                    "case",
                    [
                        ast.Call("lt", [a, b]), ast.Const(-1),
                        ast.Call("eq", [a, b]), ast.Const(0),
                        ast.Const(1),
                    ],
                )
            )
        if op == "space" and len(e.args) == 1 and isinstance(e.args[0], ast.Const):
            if e.args[0].value is None:
                return self.lower(ast.Const(None))
            n = max(int(e.args[0].value), 0)
            return self.lower(ast.Const(" " * n))
        if op == "elt" and len(e.args) >= 2:
            # ELT(n, s1, s2, ...) -> CASE WHEN n=1 THEN s1 ... ELSE NULL
            n = e.args[0]
            args = []
            for i, sv in enumerate(e.args[1:], 1):
                args.extend([ast.Call("eq", [n, ast.Const(i)]), sv])
            args.append(ast.Const(None))
            return self.lower(ast.Call("case", args))
        if op in ("hex", "bin", "oct") and len(e.args) == 1:
            a0 = e.args[0]
            if isinstance(a0, ast.Const) and a0.value is None:
                return self.lower(ast.Const(None))
            if isinstance(a0, ast.Const) and isinstance(a0.value, int):
                fmt = {"hex": "X", "bin": "b", "oct": "o"}[op]
                v = a0.value
                if v < 0:  # MySQL: 64-bit two's complement
                    v &= (1 << 64) - 1
                return self.lower(ast.Const(format(v, fmt)))
            # column args resolve by type at compile (string -> byte-hex
            # transform, bounded int -> range LUT)
        if op == "conv" and len(e.args) == 3 and all(
            isinstance(a, ast.Const) for a in e.args
        ):
            v, fb, tb = (a.value for a in e.args)
            if v is None or fb is None or tb is None:
                return self.lower(ast.Const(None))
            try:
                n = int(str(v), int(fb))
            except (TypeError, ValueError):
                return self.lower(ast.Const(None))
            if n < 0:  # MySQL: 64-bit two's complement
                n &= (1 << 64) - 1
            digs = "0123456789abcdefghijklmnopqrstuvwxyz"
            tb = int(tb)
            out = ""
            m = n
            while True:
                out = digs[m % tb] + out
                m //= tb
                if m == 0:
                    break
            return self.lower(ast.Const(out.upper()))
        if op == "char" and all(isinstance(a, ast.Const) for a in e.args):
            if any(a.value is None for a in e.args):
                return self.lower(ast.Const(None))
            return self.lower(
                ast.Const("".join(chr(int(a.value)) for a in e.args))
            )
        if op in ("date_add", "date_sub"):
            base, iv = e.args
            assert isinstance(iv, ast.Interval)
            sign = 1 if op == "date_add" else -1
            months = self._interval_months(iv)
            if months is not None:
                # calendar-exact month/year arithmetic (MySQL clamps the
                # day-of-month; the reference does exact calendar math in
                # pkg/types/time.go AddDate) — fold on host for constant
                # dates, device kernel otherwise
                lowered = self.lower(base)
                if isinstance(lowered, Literal) and isinstance(lowered.value, int):
                    return Literal(
                        type=lowered.type or DATE,
                        value=_add_months_host(lowered.value, sign * months),
                    )
                return Func(
                    op="add_months",
                    args=(lowered, Literal(type=INT64, value=sign * months)),
                )
            us = self._interval_micros(iv)
            if us is not None:
                # sub-day units always promote the result to DATETIME
                sign2 = 1 if op == "date_add" else -1
                return Func(
                    op="add_us",
                    args=(self.lower(base), Literal(type=INT64, value=sign2 * us)),
                )
            days = self._interval_days(iv)
            return Func(
                op="add" if op == "date_add" else "sub",
                args=(self.lower(base), Literal(type=INT64, value=days)),
            )
        if op == "cast":
            return Func(op="cast", args=(self.lower(e.args[0]),), type=e.cast_type)
        if op == "if":
            if len(e.args) != 3:
                raise PlanError("IF takes 3 arguments")
            return Func(op="case", args=tuple(self.lower(a) for a in e.args))
        if op == "nullif":
            a, bb = (self.lower(x) for x in e.args)
            return Func(op="case", args=(Func(op="eq", args=(a, bb)), Literal(value=None), a))
        if op in (
            "eq", "ne", "lt", "le", "gt", "ge", "like", "in", "between",
        ) and any(
            isinstance(a, ast.Call) and a.op == "_collate_ci" for a in e.args
        ):
            # a CI-collated operand makes the whole COMPARISON case-
            # insensitive (MySQL collation coercion): fold ALL sides.
            # String literals lower-case at plan time (LIKE patterns and
            # IN lists must stay literals for the kernel LUTs).
            def _strip(x):
                return (
                    x.args[0]
                    if isinstance(x, ast.Call) and x.op == "_collate_ci"
                    else x
                )

            def _fold(a):
                low = self.lower(_strip(a))
                if isinstance(low, Literal) and isinstance(low.value, str):
                    return Literal(type=low.type, value=low.value.lower())
                return Func(op="lower", args=(low,))

            return Func(op=op, args=tuple(_fold(a) for a in e.args))
        if op == "rand":
            # DIVERGENCE (like uuid below): folds ONCE at plan time, so
            # every row of a statement sees the same value — per-row
            # volatile functions would defeat whole-plan compilation.
            # ORDER BY rand() therefore does not shuffle; a seed column
            # argument is not supported.
            import random as _random

            args_l = [self.lower(a) for a in e.args]
            rng = (
                _random.Random(args_l[0].value)
                if args_l and isinstance(args_l[0], Literal)
                else _random
            )
            from tidb_tpu_torch.dtypes import FLOAT64 as _F64

            return Literal(type=_F64, value=rng.random())
        if op == "sleep":
            from tidb_tpu_torch.utils.sqlkiller import interruptible_sleep

            a = self.lower(e.args[0])
            if isinstance(a, Literal) and isinstance(a.value, (int, float)):
                # at most 300 s, and a KILL of the statement cuts it short
                interruptible_sleep(min(max(float(a.value), 0.0), 300.0))
            return Literal(type=INT64, value=0)
        if op == "benchmark":
            # evaluated-for-timing in MySQL; here the whole plan is one
            # compiled program — accept and return the 0 contract
            return Literal(type=INT64, value=0)
        if op in ("uuid", "uuid_short"):
            # volatile generators fold at plan time: statements re-plan
            # per parse, so each STATEMENT gets a fresh value (per-ROW
            # uuids over a table would defeat dictionary coding — the
            # reference's per-row semantics are deliberately relaxed)
            import uuid as _uuid

            if op == "uuid":
                return Literal(type=STRING, value=str(_uuid.uuid4()))
            return Literal(
                type=INT64, value=_uuid.uuid4().int & ((1 << 62) - 1)
            )
        if op in ("format", "inet_ntoa", "export_set", "make_set"):
            # constant-foldable presentation builtins (value-dependent
            # string output cannot ride a static dictionary over columns)
            args_l = [self.lower(a) for a in e.args]
            if all(isinstance(a, Literal) for a in args_l):
                from tidb_tpu_torch.expression.const_builtins import fold_const

                return Literal(
                    type=STRING, value=fold_const(op, [a.value for a in args_l])
                )
            raise PlanError(
                f"{op.upper()} supports constant arguments only (string "
                "results over columns need value-dependent dictionaries)"
            )
        if op in ("addtime", "subtime"):
            a0 = self.lower(e.args[0])
            a1 = self.lower(e.args[1])
            from tidb_tpu_torch.dtypes import time_to_micros

            if isinstance(a0, Literal) and isinstance(a0.value, str):
                from tidb_tpu_torch.dtypes import (
                    DATETIME as _DT, TIME as _TT, datetime_to_micros,
                )

                s0 = a0.value
                if " " in s0.strip() or "T" in s0:
                    a0 = Literal(
                        type=_DT, value=int(datetime_to_micros(s0))
                    )
                else:
                    a0 = Literal(type=_TT, value=int(time_to_micros(s0)))

            if isinstance(a1, Literal) and isinstance(a1.value, str):
                us = int(time_to_micros(a1.value))
            elif isinstance(a1, Literal) and a1.type is not None and a1.type.kind == Kind.TIME:
                us = int(a1.value)
            else:
                raise PlanError(
                    f"{op.upper()} needs a literal time as its second "
                    "argument"
                )
            if op == "subtime":
                us = -us
            return Func(
                op="add_us", args=(a0, Literal(type=INT64, value=us))
            )
        if op == "_collate_ci":
            # utf8mb4_general_ci ~ compare case-folded (explicit COLLATE)
            return Func(op="lower", args=(self.lower(e.args[0]),))
        if op == "_collate_bin":
            # explicit binary COLLATE: wrap in a passthrough whose
            # INFERRED type is collation-free STRING (bind_expr re-types
            # bare ColumnRefs from the schema, so a type-strip on the
            # ref itself would not survive binding)
            return Func(op="_force_bin", args=(self.lower(e.args[0]),))
        if op == "instr":
            s, sub = (self.lower(x) for x in e.args)
            return Func(op="locate", args=(s, sub))
        if op == "locate":
            sub, s = (self.lower(x) for x in e.args[:2])
            if len(e.args) > 2:
                raise PlanError("LOCATE with start position not supported")
            return Func(op="locate", args=(s, sub))
        if op == "concat_ws":
            # NULL arguments are skipped (not propagated), so this stays
            # a distinct op down to the kernel.
            return Func(op="concat_ws", args=tuple(self.lower(x) for x in e.args))
        if op == "date":
            # DATE(x): truncates DATETIME to its calendar day; identity on
            # DATE (kernel dispatches on the bound argument type)
            return Func(op="date_part_days", args=(self.lower(e.args[0]),))
        if op in ("curdate", "current_date"):
            import datetime

            from tidb_tpu_torch.dtypes import DATE as _DATE, date_to_days

            return Literal(
                type=_DATE, value=int(date_to_days(datetime.date.today().isoformat()))
            )
        if op in ("now", "current_timestamp", "sysdate", "localtimestamp"):
            import datetime

            from tidb_tpu_torch.dtypes import DATETIME as _DT, datetime_to_micros

            return Literal(
                type=_DT,
                value=int(
                    datetime_to_micros(
                        datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
                    )
                ),
            )
        if op in ("curtime", "current_time"):
            import datetime

            from tidb_tpu_torch.dtypes import TIME as _TIME, time_to_micros

            return Literal(
                type=_TIME,
                value=int(
                    time_to_micros(datetime.datetime.now().strftime("%H:%M:%S"))
                ),
            )
        if op == "utc_date":
            import datetime

            from tidb_tpu_torch.dtypes import DATE as _DATE, date_to_days

            return Literal(
                type=_DATE,
                value=int(date_to_days(
                    datetime.datetime.now(datetime.timezone.utc)
                    .date().isoformat()
                )),
            )
        if op == "utc_time":
            import datetime

            from tidb_tpu_torch.dtypes import TIME as _TIME, time_to_micros

            return Literal(
                type=_TIME,
                value=int(time_to_micros(
                    datetime.datetime.now(datetime.timezone.utc)
                    .strftime("%H:%M:%S")
                )),
            )
        if op == "timestamp" and len(e.args) == 1:
            # TIMESTAMP(x): cast to DATETIME
            from tidb_tpu_torch.dtypes import DATETIME as _DT

            return Func(
                op="cast", args=(self.lower(e.args[0]),), type=_DT
            )
        if op == "maketime" and len(e.args) == 3:
            consts = [self._const_arg(a) for a in e.args]
            if any(c is None for c in consts):
                raise PlanError("MAKETIME supports constant arguments only")
            from tidb_tpu_torch.dtypes import TIME as _TIME

            h, m, sec = (int(c.value) for c in consts)
            sign = -1 if h < 0 else 1
            total = abs(h) * 3600 + m * 60 + sec
            return Literal(type=_TIME, value=sign * total * 1_000_000)
        if op == "get_format" and len(e.args) == 2:
            kind = str(getattr(e.args[0], "column", e.args[0])).lower()
            if isinstance(e.args[0], ast.Const):
                kind = str(e.args[0].value).lower()
            elif isinstance(e.args[0], ast.Name):
                kind = e.args[0].column.lower()
            loc = (
                str(e.args[1].value).lower()
                if isinstance(e.args[1], ast.Const) else "iso"
            )
            fmts = {
                ("date", "iso"): "%Y-%m-%d", ("date", "usa"): "%m.%d.%Y",
                ("date", "eur"): "%d.%m.%Y", ("date", "jis"): "%Y-%m-%d",
                ("date", "internal"): "%Y%m%d",
                ("time", "iso"): "%H:%i:%s", ("time", "usa"): "%h:%i:%s %p",
                ("time", "eur"): "%H.%i.%s", ("time", "jis"): "%H:%i:%s",
                ("time", "internal"): "%H%i%s",
                ("datetime", "iso"): "%Y-%m-%d %H:%i:%s",
                ("datetime", "usa"): "%Y-%m-%d %H.%i.%s",
                ("datetime", "eur"): "%Y-%m-%d %H.%i.%s",
                ("datetime", "jis"): "%Y-%m-%d %H:%i:%s",
                ("datetime", "internal"): "%Y%m%d%H%i%s",
            }
            from tidb_tpu_torch.dtypes import STRING as _S

            v = fmts.get((kind, loc))
            return Literal(type=_S, value=v)
        if op == "to_seconds" and len(e.args) == 1:
            # TO_SECONDS(date) = TO_DAYS * 86400 (date-granular; the
            # DATETIME time-of-day component follows to_days semantics)
            return self.lower(
                ast.Call(
                    "add",
                    [
                        ast.Call(
                            "mul",
                            [ast.Call("to_days", [e.args[0]]),
                             ast.Const(86400)],
                        ),
                        ast.Const(0),
                    ],
                )
            )
        if op == "yearweek" and len(e.args) == 1:
            # YEARWEEK(d) = YEAR*100 + WEEK (mode-0 weeks; boundary
            # weeks where the week belongs to the adjacent year follow
            # WEEK()'s mode-0 result)
            return self.lower(
                ast.Call(
                    "add",
                    [
                        ast.Call("mul", [ast.Call("year", [e.args[0]]),
                                         ast.Const(100)]),
                        ast.Call("week", [e.args[0]]),
                    ],
                )
            )
        if op == "name_const" and len(e.args) == 2:
            return self.lower(e.args[1])
        if op == "time" and len(e.args) == 1:
            from tidb_tpu_torch.dtypes import TIME as _T

            return Func(op="cast", args=(self.lower(e.args[0]),), type=_T)
        from tidb_tpu_torch.expression.miscfuncs import CONST_FNS as _MISC

        if op in _MISC:
            # misc/info/legacy-crypto family (expression/miscfuncs.py):
            # const-folded like the rest of the connector-facing misc
            # functions below. Arguments lower first so nested foldable
            # calls (DECODE(ENCODE(x, p), p)) reduce to Literals.
            vals = []
            for a in e.args:
                c = self._const_arg(a)
                if c is not None:
                    vals.append(c.value)
                    continue
                low = self.lower(a)
                if isinstance(low, Literal):
                    vals.append(low.value)
                    continue
                raise PlanError(
                    f"{op.upper()} supports constant arguments only"
                )
            from tidb_tpu_torch.dtypes import INT64 as _I64, STRING as _S

            fn, kind = _MISC[op]
            # every function in this family NULL-propagates (MySQL misc
            # semantics) — short-circuit so impls skip per-arg checks
            try:
                v = None if any(x is None for x in vals) else fn(*vals)
            except (TypeError, ValueError, ArithmeticError) as ex:
                raise PlanError(
                    f"Incorrect arguments to {op.upper()}: {ex}"
                )
            if kind == "int":
                return Literal(
                    type=_I64, value=None if v is None else int(v)
                )
            return Literal(type=_S, value=None if v is None else str(v))
        if op in ("format_bytes", "format_nano_time", "password"):
            c = self._const_arg(e.args[0]) if e.args else None
            if c is None:
                raise PlanError(f"{op.upper()} supports constant arguments only")
            from tidb_tpu_torch.dtypes import STRING as _S

            v = c.value
            if v is None:
                return Literal(type=_S, value=None)
            if op == "password":
                # deprecated double-SHA1 (*hex) form
                import hashlib as _h

                d = _h.sha1(_h.sha1(str(v).encode()).digest()).hexdigest()
                return Literal(type=_S, value="*" + d.upper())
            units = (
                ["B", "KiB", "MiB", "GiB", "TiB", "PiB"]
                if op == "format_bytes"
                else ["ns", "µs", "ms", "s"]
            )
            step = 1024.0 if op == "format_bytes" else 1000.0
            x = float(v)
            i = 0
            while abs(x) >= step and i < len(units) - 1:
                x /= step
                i += 1
            return Literal(type=_S, value=f"{x:.2f} {units[i]}")
        if op in ("json_array", "json_object"):
            import json as _json

            consts = [self._const_arg(a) for a in e.args]
            if any(c is None for c in consts):
                raise PlanError(
                    f"{op.upper()} supports constant arguments only"
                )
            from tidb_tpu_torch.dtypes import STRING as _S

            vs = [c.value for c in consts]
            if op == "json_array":
                return Literal(type=_S, value=_json.dumps(vs))
            if len(vs) % 2:
                raise PlanError("JSON_OBJECT needs key/value pairs")
            if any(vs[i] is None for i in range(0, len(vs), 2)):
                raise PlanError(
                    "JSON documents may not contain NULL member names"
                )
            return Literal(
                type=_S,
                value=_json.dumps(
                    {str(vs[i]): vs[i + 1] for i in range(0, len(vs), 2)}
                ),
            )
        if op in ("charset", "collation", "coercibility"):
            # pre-binding: argument types are unknown here; report the
            # connection charset like the reference does for the
            # overwhelmingly common string case (connector handshakes
            # SELECT these on literals)
            from tidb_tpu_torch.dtypes import INT64 as _I64, STRING as _S

            a0 = e.args[0] if e.args else None
            is_num = isinstance(a0, ast.Const) and isinstance(
                a0.value, (int, float)
            ) and not isinstance(a0.value, bool)
            if op == "coercibility":
                return Literal(
                    type=_I64, value=4 if isinstance(a0, ast.Const) else 2
                )
            if op == "charset":
                return Literal(
                    type=_S, value="binary" if is_num else "utf8mb4"
                )
            return Literal(
                type=_S, value="binary" if is_num else "utf8mb4_bin"
            )
        args = tuple(self.lower(a) for a in e.args)
        return Func(op=op, args=args)

    @staticmethod
    def _interval_months(iv: ast.Interval) -> Optional[int]:
        """Months for month/year units (calendar-exact path); None for
        day-based units."""
        v = iv.value
        if isinstance(v, ast.Const):
            v = v.value
        v = int(v)
        if iv.unit == "month":
            return v
        if iv.unit == "year":
            return v * 12
        return None

    @staticmethod
    def _interval_days(iv: ast.Interval) -> int:
        v = iv.value
        if isinstance(v, ast.Const):
            v = v.value
        v = int(v)
        if iv.unit == "day":
            return v
        if iv.unit == "week":
            return v * 7
        raise PlanError(f"unsupported interval unit {iv.unit}")

    @staticmethod
    def _interval_micros(iv: ast.Interval):
        """Microseconds for sub-day units (hour/minute/second/microsecond);
        None for day-or-larger units."""
        from tidb_tpu_torch.dtypes import US_PER_SECOND

        v = iv.value
        if isinstance(v, ast.Const):
            v = v.value
        v = int(v)
        scale = {
            "hour": 3600 * US_PER_SECOND,
            "minute": 60 * US_PER_SECOND,
            "second": US_PER_SECOND,
            "microsecond": 1,
        }.get(iv.unit)
        return None if scale is None else v * scale


# ---------------------------------------------------------------------------
# SELECT builder
# ---------------------------------------------------------------------------


def _add_months_host(days: int, months: int) -> int:
    """MySQL ADDDATE month semantics on a days-since-epoch int: exact
    calendar shift with day-of-month clamped to the target month's
    length (1998-03-31 - 1 month = 1998-02-28)."""
    import datetime

    d = datetime.date(1970, 1, 1) + datetime.timedelta(days=days)
    total = d.year * 12 + (d.month - 1) + months
    y, m = divmod(total, 12)
    m += 1
    # clamp to month length via day-1-of-next-month minus one day
    if m == 12:
        nxt = datetime.date(y + 1, 1, 1)
    else:
        nxt = datetime.date(y, m + 1, 1)
    last = (nxt - datetime.timedelta(days=1)).day
    nd = datetime.date(y, m, min(d.day, last))
    return (nd - datetime.date(1970, 1, 1)).days


def _conjuncts(e):
    if isinstance(e, ast.Call) and e.op == "and":
        return _conjuncts(e.args[0]) + _conjuncts(e.args[1])
    f = _factor_dnf(e)
    if f is not None:
        return f
    return [e]


def _disjuncts(e):
    if isinstance(e, ast.Call) and e.op == "or":
        return _disjuncts(e.args[0]) + _disjuncts(e.args[1])
    return [e]


def _factor_dnf(e):
    """Common-conjunct extraction from a disjunction:
    (A and X) or (A and Y) -> [A, (X or Y)]. Surfaces equi-join
    conjuncts buried in every branch of a DNF predicate (TPC-H Q19's
    `p_partkey = l_partkey and ...` repeated per brand-group), so the
    planner sees a hash-joinable key instead of a cross join (reference:
    expression.ExtractFiltersFromDNF, pkg/expression/util.go). Returns
    None when nothing factors."""
    if not (isinstance(e, ast.Call) and e.op == "or"):
        return None
    branches = [_conjuncts_flat(b) for b in _disjuncts(e)]
    if len(branches) < 2:
        return None
    first = branches[0]
    common = [
        c for c in first if all(any(c == d for d in b) for b in branches[1:])
    ]
    if not common:
        return None
    rest_branches = []
    for b in branches:
        rest = [c for c in b if not any(c == k for k in common)]
        rest_branches.append(rest)
    out = list(common)
    if all(rest for rest in rest_branches):
        ors = [_and_all(rest) for rest in rest_branches]
        o = ors[0]
        for nxt in ors[1:]:
            o = ast.Call("or", [o, nxt])
        out.append(o)
    # else: some branch is exactly the common set -> the disjunction is
    # implied by `common` alone (A or (A and X) == A)
    return out


def _conjuncts_flat(e):
    """_conjuncts WITHOUT recursive DNF factoring (cycle guard)."""
    if isinstance(e, ast.Call) and e.op == "and":
        return _conjuncts_flat(e.args[0]) + _conjuncts_flat(e.args[1])
    return [e]


def _and_all(cs):
    out = cs[0]
    for c in cs[1:]:
        out = ast.Call("and", [out, c])
    return out


def _ast_columns(e, out: set):
    """Collect (table, column) names referenced by a parser expression."""
    if isinstance(e, ast.Name):
        out.add((e.table.lower() if e.table else None, e.column.lower()))
    elif isinstance(e, ast.Call):
        for a in e.args:
            _ast_columns(a, out)
    elif isinstance(e, ast.AggCall):
        if e.arg is not None:
            _ast_columns(e.arg, out)
    elif isinstance(e, ast.SubqueryExpr):
        if e.lhs is not None:
            _ast_columns(e.lhs, out)
        # correlated references inside subquery are handled separately
    elif isinstance(e, ast.Interval):
        pass
    return out


# per-thread stack of views currently being inlined (cycle/depth guard)
_VIEW_EXPANSION = threading.local()


def qualify_view_body(node, db: str, cte_names: frozenset = frozenset()):
    """Attach an explicit db qualifier to every bare TableRef in a view
    body, so the stored SELECT text resolves identically no matter which
    database the referencing session is in (scalar subqueries execute
    through the session executor against the session's CURRENT db —
    qualifiers anchor them to the view's db). CTE names are tracked
    scope-aware: a WITH's names shadow tables only inside that WITH's
    subtree, not across the whole body."""
    if isinstance(node, ast.With):
        inner = cte_names | {name.lower() for name, _q in node.ctes}
        for _name, q in node.ctes:
            qualify_view_body(q, db, inner)
        qualify_view_body(node.body, db, inner)
        return
    if isinstance(node, ast.TableRef):
        if node.db is None and node.name.lower() not in cte_names:
            node.db = db
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            qualify_view_body(getattr(node, f.name), db, cte_names)
    elif isinstance(node, (list, tuple)):
        for x in node:
            qualify_view_body(x, db, cte_names)


class SelectBuilder:
    """Builds a logical plan for one SELECT. ``ctes`` maps CTE names to
    their parser ASTs (resolved before catalog tables, like the
    reference's CTE name scope)."""

    def __init__(
        self, catalog, current_db: str, subquery_value_fn=None, ctes=None,
        hints=(),
    ):
        self.catalog = catalog
        self.db = current_db
        # subquery_value_fn(select_ast) -> Literal  (executes scalar subq)
        self.subquery_value_fn = subquery_value_fn
        self.ctes = ctes or {}
        # optimizer hints ((name, (args...)), ...) from /*+ ... */
        # (reference pkg/parser/hintparser.y + planner hint handling)
        self.hints = tuple(hints or ())
        # deterministic per-query naming for decorrelated scalar columns
        # (plan reprs key the jit cache, so names must be parse-stable)
        self._dsq_counter = 0

    # -- FROM --------------------------------------------------------------
    def build_from(self, node) -> LogicalPlan:
        if node is None:
            raise PlanError("SELECT without FROM not planned here")
        if isinstance(node, ast.TableRef):
            if node.db is None and node.name.lower() in self.ctes:
                inner = build_query(
                    self.ctes[node.name.lower()], self.catalog, self.db,
                    self.subquery_value_fn, self.ctes,
                )
                alias = (node.alias or node.name).lower()
                cols = [
                    OutCol(alias, c.name, f"{alias}.{c.name}", c.type)
                    for c in inner.schema
                ]
                return Projection(
                    Schema(cols),
                    inner,
                    [
                        (f"{alias}.{c.name}", ColumnRef(type=c.type, name=c.internal))
                        for c in inner.schema
                    ],
                )
            db = node.db or self.db
            vdef = self.catalog.view_def(db, node.name) if hasattr(
                self.catalog, "view_def"
            ) else None
            if vdef is not None:
                return self._expand_view(db, node, vdef)
            t = self.catalog.table(db, node.name)
            alias = (node.alias or node.name).lower()
            cols = [
                OutCol(alias, n, f"{alias}.{n}", typ)
                for n, typ in t.schema.columns
            ]
            names = [n for n, _ in t.schema.columns]
            if alias in _EXPOSE_ROWID.get():
                # virtual scan-order row handle for multi-table DML
                # (reference: _tidb_rowid, pkg/tablecodec). Only visible
                # inside session-built DML plans, never to star expansion.
                cols.append(OutCol(alias, ROWID_NAME, f"{alias}.{ROWID_NAME}", INT64))
                names.append(ROWID_NAME)
            return Scan(Schema(cols), db, node.name.lower(), alias, names)
        if isinstance(node, ast.SubqueryRef):
            inner = build_query(
                node.query, self.catalog, self.db, self.subquery_value_fn, self.ctes
            )
            alias = node.alias.lower()
            cols = [
                OutCol(alias, c.name, f"{alias}.{c.name}", c.type)
                for c in inner.schema
            ]
            ren = Projection(
                Schema(cols),
                inner,
                [(f"{alias}.{c.name}", ColumnRef(type=c.type, name=c.internal)) for c in inner.schema],
            )
            return ren
        if isinstance(node, ast.Join):
            left = self.build_from(node.left)
            right = self.build_from(node.right)
            schema = Schema(list(left.schema.cols) + list(right.schema.cols))
            if node.kind == "cross" or node.on is None:
                if node.kind in ("left", "full"):
                    raise PlanError(f"{node.kind.upper()} JOIN requires ON")
                return JoinPlan(schema, "cross", left, right, [], None)
            if node.kind == "full":
                return self._build_full_join(left, right, node.on, schema)
            return self._build_join(node.kind, left, right, node.on, schema)
        raise PlanError(f"unsupported FROM clause {node!r}")

    def _expand_view(self, db: str, node, vdef) -> LogicalPlan:
        """Inline a view reference: re-parse the stored SELECT text and
        plan it as a derived table under the view's (aliased) name.
        The body resolves against the VIEW's database and an empty CTE
        scope (a view cannot see the outer statement's CTEs), mirroring
        the reference's BuildDataSourceFromView
        (pkg/planner/core/logical_plan_builder.go). A thread-local
        expansion stack rejects definition cycles that OR REPLACE can
        introduce after creation."""
        from tidb_tpu_torch.parser.sqlparse import parse as _parse

        sql_text, vcols = vdef
        key = f"{db.lower()}.{node.name.lower()}"
        stack = getattr(_VIEW_EXPANSION, "stack", None)
        if stack is None:
            stack = _VIEW_EXPANSION.stack = []
        if key in stack:
            raise PlanError(f"view {key} is recursively defined")
        if len(stack) >= 16:
            raise PlanError("view nesting too deep (limit 16)")
        stack.append(key)
        try:
            stmts = _parse(sql_text)
            qualify_view_body(stmts[0], db)
            inner = build_query(
                stmts[0], self.catalog, db, self.subquery_value_fn, None
            )
        finally:
            stack.pop()
        alias = (node.alias or node.name).lower()
        names = (
            list(vcols) if vcols else [c.name for c in inner.schema]
        )
        if len(names) != len(inner.schema.cols):
            raise PlanError(
                f"view {key} declares {len(names)} columns but its "
                f"SELECT yields {len(inner.schema.cols)}"
            )
        cols = [
            OutCol(alias, n, f"{alias}.{n}", c.type)
            for n, c in zip(names, inner.schema)
        ]
        return Projection(
            Schema(cols),
            inner,
            [
                (f"{alias}.{n}", ColumnRef(type=c.type, name=c.internal))
                for n, c in zip(names, inner.schema)
            ],
        )

    def _build_full_join(self, left, right, on, schema):
        """FULL OUTER JOIN as LEFT JOIN ∪ (right ANTI left with NULL
        left columns). The reference emits both-unmatched rows from one
        hash join via its joiner strategies (pkg/executor/join/joiner.go);
        on TPU the two branches are two fused static-shape programs and
        the union is a concat — no per-row emit state machine. ON must be
        pure equi-conjuncts (single-side ON predicates gate matching
        without filtering rows, which the rewrite can't express)."""
        lj = self._build_join("left", left, right, on, schema)
        if lj.residual is not None or lj.left is not left or lj.right is not right:
            raise PlanError(
                "FULL OUTER JOIN supports only equality ON conditions "
                "between the two sides"
            )
        anti_keys = [(r, l) for (l, r) in lj.equi_keys]
        aj = JoinPlan(right.schema, "anti", right, left, anti_keys)
        nl = len(left.schema.cols)
        ucols, exprs_l, exprs_a = [], [], []
        for i, c in enumerate(schema.cols):
            ucols.append(OutCol(c.qualifier, c.name, f"_u{i}", c.type))
            exprs_l.append((f"_u{i}", ColumnRef(type=c.type, name=c.internal)))
            exprs_a.append(
                (
                    f"_u{i}",
                    Literal(type=c.type, value=None)
                    if i < nl
                    else ColumnRef(type=c.type, name=c.internal),
                )
            )
        psch = Schema(
            [
                OutCol(None, f"_u{i}", f"_u{i}", c.type)
                for i, c in enumerate(schema.cols)
            ]
        )
        return UnionAll(
            Schema(ucols),
            [Projection(psch, lj, exprs_l), Projection(psch, aj, exprs_a)],
        )

    def _apply_join_hints(self, left, right, bcast):
        """BROADCAST_JOIN(alias): force-replicate the named side;
        NO_BROADCAST_JOIN(): force hash repartition. Unknown hints are
        ignored (MySQL warns-and-continues)."""
        if not self.hints:
            return bcast
        lq = {(c.qualifier or "").lower() for c in left.schema}
        rq = {(c.qualifier or "").lower() for c in right.schema}
        for name, args in self.hints:
            if name == "no_broadcast_join":
                return None
            if name == "broadcast_join":
                for a in args:
                    a = a.lower()
                    if a in rq:
                        return "right"
                    if a in lq:
                        return "left"
        return bcast

    def _build_join(self, kind, left, right, on, schema) -> JoinPlan:
        lq = {(c.qualifier or "").lower() for c in left.schema}
        rq = {(c.qualifier or "").lower() for c in right.schema}

        def side_of(e) -> Optional[str]:
            cols = _ast_columns(e, set())
            quals = set()
            for tbl, col in cols:
                if tbl is not None:
                    quals.add("l" if tbl in lq else ("r" if tbl in rq else "?"))
                else:
                    inl = inr = False
                    try:
                        left.schema.resolve(None, col)
                        inl = True
                    except PlanError:
                        pass
                    try:
                        right.schema.resolve(None, col)
                        inr = True
                    except PlanError:
                        pass
                    if inl and inr:
                        quals.add("?")
                    elif inl:
                        quals.add("l")
                    elif inr:
                        quals.add("r")
                    else:
                        quals.add("?")
            if quals <= {"l"}:
                return "l"
            if quals <= {"r"}:
                return "r"
            return None

        equi: List[Tuple[Expr, Expr]] = []
        residual: List = []
        pushd_l: List = []
        pushd_r: List = []
        lb = ExprBinder(left.schema)
        rb = ExprBinder(right.schema)
        for c in _conjuncts(on):
            if isinstance(c, ast.Call) and c.op == "eq":
                s0, s1 = side_of(c.args[0]), side_of(c.args[1])
                if s0 == "l" and s1 == "r":
                    equi.append((lb.bind(c.args[0]), rb.bind(c.args[1])))
                    continue
                if s0 == "r" and s1 == "l":
                    equi.append((lb.bind(c.args[1]), rb.bind(c.args[0])))
                    continue
            s = side_of(c)
            if kind == "inner" and s == "l":
                pushd_l.append(c)
                continue
            if s == "r" and kind in ("inner", "left"):
                # left join: right-only ON conjunct filters the build side
                pushd_r.append(c)
                continue
            residual.append(c)

        if pushd_l:
            pred = _and_all(pushd_l)
            left = Selection(left.schema, left, ExprBinder(left.schema).bind(pred))
        if pushd_r:
            pred = _and_all(pushd_r)
            right = Selection(right.schema, right, ExprBinder(right.schema).bind(pred))
        schema = Schema(list(left.schema.cols) + list(right.schema.cols))
        if not equi:
            if kind == "inner":
                res = ExprBinder(schema).bind(on) if residual else None
                return JoinPlan(schema, "cross", left, right, [], res)
            raise PlanError("non-equi LEFT JOIN not supported")
        res_bound = ExprBinder(schema).bind(_and_all(residual)) if residual else None
        # cost-based broadcast pick (outer joins may only replicate the
        # build side — the probe side must stay sharded)
        from tidb_tpu_torch.planner import cardinality as C

        smap = C.StatsMap()
        smap.cols.update(C.gather_stats(left, self.catalog).cols)
        smap.cols.update(C.gather_stats(right, self.catalog).cols)
        el = C.est_rows(left, self.catalog, smap)
        er = C.est_rows(right, self.catalog, smap)
        bcast = _broadcast_choice(el, er)
        bcast = self._apply_join_hints(left, right, bcast)
        if kind != "inner" and bcast == "left":
            bcast = None
        return JoinPlan(schema, kind, left, right, equi, res_bound, broadcast=bcast)


def _and_all(conj: List):
    e = conj[0]
    for c in conj[1:]:
        e = ast.Call("and", [e, c])
    return e


def build_query(
    stmt, catalog, current_db: str, subquery_value_fn=None, ctes=None
) -> LogicalPlan:
    """Top-level query lowering: SELECT | UNION | WITH."""
    if isinstance(stmt, ast.With):
        merged = dict(ctes or {})
        for name, q in stmt.ctes:
            merged[name] = q
        if subquery_value_fn is not None:
            # Scalar subqueries under this WITH run through the session
            # executor in a fresh build; inject the CTE scope so they can
            # reference the views (e.g. TPC-H Q15's max over the CTE).
            inner_fn = subquery_value_fn

            def subquery_value_fn(q, _ctes=None, _inner=inner_fn, _m=merged):
                return _inner(q, _ctes if _ctes is not None else _m)

        return build_query(stmt.body, catalog, current_db, subquery_value_fn, merged)
    if isinstance(stmt, ast.Union):
        return _build_union(stmt, catalog, current_db, subquery_value_fn, ctes)
    if isinstance(stmt, ast.SetOp):
        return _build_setop(stmt, catalog, current_db, subquery_value_fn, ctes)
    return build_select(stmt, catalog, current_db, subquery_value_fn, ctes)


def _build_setop(so: ast.SetOp, catalog, db, subquery_value_fn, ctes) -> LogicalPlan:
    """INTERSECT / EXCEPT (DISTINCT set semantics) via the group-by
    kernel: tag each side, union, group by every column counting the
    side tags, filter. NULLs group together (SQL set semantics treats
    NULL rows as equal — the claim-loop group kernel already does),
    which a join-based rewrite would get wrong. Reference:
    pkg/parser grammar setOpr + the executor's hash-based set ops."""
    from tidb_tpu_torch.dtypes import INT64 as _I64, common_type

    plans = [
        build_query(so.left, catalog, db, subquery_value_fn, ctes),
        build_query(so.right, catalog, db, subquery_value_fn, ctes),
    ]
    arity = len(plans[0].schema.cols)
    if len(plans[1].schema.cols) != arity:
        raise PlanError(f"{so.op.upper()} branches have different column counts")
    names = [c.name for c in plans[0].schema.cols]
    targets = []
    for i in range(arity):
        t = plans[0].schema.cols[i].type
        u_t = plans[1].schema.cols[i].type
        targets.append(t if u_t == t else common_type(t, u_t))
    children = []
    for side, p in enumerate(plans):
        exprs = []
        for i, tgt in enumerate(targets):
            c = p.schema.cols[i]
            ref = ColumnRef(type=c.type, name=c.internal)
            e: Expr = ref if c.type == tgt else Func(type=tgt, op="cast", args=(ref,))
            exprs.append((f"_u{i}", e))
        exprs.append(("_sl", Literal(type=_I64, value=1 if side == 0 else 0)))
        exprs.append(("_sr", Literal(type=_I64, value=0 if side == 0 else 1)))
        sch = Schema(
            [OutCol(None, names[i], f"_u{i}", targets[i]) for i in range(arity)]
            + [OutCol(None, "_sl", "_sl", _I64), OutCol(None, "_sr", "_sr", _I64)]
        )
        children.append(Projection(sch, p, exprs))
    u_schema = children[0].schema
    plan: LogicalPlan = UnionAll(u_schema, children)
    groups = [
        (f"_u{i}", ColumnRef(type=targets[i], name=f"_u{i}"))
        for i in range(arity)
    ]
    aggs = [
        ("_cl", "sum", ColumnRef(type=_I64, name="_sl"), False),
        ("_cr", "sum", ColumnRef(type=_I64, name="_sr"), False),
    ]
    agg_schema = Schema(
        [OutCol(None, names[i], f"_u{i}", targets[i]) for i in range(arity)]
        + [OutCol(None, "_cl", "_cl", _I64), OutCol(None, "_cr", "_cr", _I64)]
    )
    plan = Aggregate(agg_schema, plan, groups, aggs)
    zero = Literal(type=_I64, value=0)
    left_present = Func(
        type=None, op="gt", args=(ColumnRef(type=_I64, name="_cl"), zero)
    )
    right_cond = Func(
        type=None,
        op="gt" if so.op == "intersect" else "eq",
        args=(ColumnRef(type=_I64, name="_cr"), zero),
    )
    pred = Func(type=None, op="and", args=(left_present, right_cond))
    from tidb_tpu_torch.expression.expr import bind_expr

    pred = bind_expr(pred, agg_schema.types())
    plan = Selection(agg_schema, plan, pred)
    out_schema = Schema(
        [OutCol(None, names[i], f"_u{i}", targets[i]) for i in range(arity)]
    )
    plan = Projection(
        out_schema, plan,
        [(f"_u{i}", ColumnRef(type=targets[i], name=f"_u{i}")) for i in range(arity)],
    )
    if so.order_by:
        ob = ExprBinder(out_schema)
        keys = []
        for oi in so.order_by:
            e = oi.expr
            if isinstance(e, ast.Const) and isinstance(e.value, int):
                e = ast.Name(None, names[e.value - 1])
            keys.append((ob.bind(e), oi.desc))
        plan = Sort(out_schema, plan, keys)
    if so.limit is not None:
        plan = Limit(out_schema, plan, so.limit, so.offset or 0)
    return plan


def _build_union(u: ast.Union, catalog, db, subquery_value_fn, ctes) -> LogicalPlan:
    from tidb_tpu_torch.dtypes import common_type

    plans = [build_query(s, catalog, db, subquery_value_fn, ctes) for s in u.selects]
    arity = len(plans[0].schema.cols)
    for p in plans[1:]:
        if len(p.schema.cols) != arity:
            raise PlanError("UNION branches have different column counts")
    names = [c.name for c in plans[0].schema.cols]
    targets = []
    for i in range(arity):
        t = plans[0].schema.cols[i].type
        for p in plans[1:]:
            u_t = p.schema.cols[i].type
            if u_t != t:
                t = common_type(t, u_t)
        targets.append(t)
    children = []
    for p in plans:
        exprs = []
        for i, tgt in enumerate(targets):
            c = p.schema.cols[i]
            ref = ColumnRef(type=c.type, name=c.internal)
            e: Expr = ref if c.type == tgt else Func(type=tgt, op="cast", args=(ref,))
            exprs.append((f"_u{i}", e))
        sch = Schema([OutCol(None, names[i], f"_u{i}", targets[i]) for i in range(arity)])
        children.append(Projection(sch, p, exprs))
    out_schema = Schema(
        [OutCol(None, names[i], f"_u{i}", targets[i]) for i in range(arity)]
    )
    plan: LogicalPlan = UnionAll(out_schema, children)
    if not u.all:
        plan = Aggregate(
            out_schema,
            plan,
            [(f"_u{i}", ColumnRef(type=targets[i], name=f"_u{i}")) for i in range(arity)],
            [],
        )
        # rename group keys back to _u names: Aggregate outputs use the
        # given key names, which are already _u{i}
    if u.order_by:
        ob = ExprBinder(out_schema)
        keys = []
        for oi in u.order_by:
            e = oi.expr
            if isinstance(e, ast.Const) and isinstance(e.value, int):
                e = ast.Name(None, names[e.value - 1])
            keys.append((ob.bind(e), oi.desc))
        plan = Sort(out_schema, plan, keys)
    if u.limit is not None:
        plan = Limit(out_schema, plan, u.limit, u.offset or 0)
    return plan


def _expr_has_modifier_subq(e) -> bool:
    if isinstance(e, ast.SubqueryExpr):
        return e.modifier is not None
    if isinstance(e, ast.Call):
        return any(_expr_has_modifier_subq(a) for a in e.args)
    if isinstance(e, ast.AggCall) and e.arg is not None:
        return _expr_has_modifier_subq(e.arg)
    return False


def _rewrite_derived_aggs(sel) -> None:
    """AST-level expansion of derived aggregates (reference: the
    var/stddev aggfuncs, pkg/executor/aggfuncs/func_varpop.go et al —
    there incremental accumulators, here algebraic rewrites over
    SUM/COUNT so the whole family rides the existing kernels):

      VAR_POP(x)    -> sum(x*x)/n - (sum(x)/n)^2
      VAR_SAMP(x)   -> (sum(x*x) - sum(x)^2/n) / (n-1)
      STDDEV_POP(x) -> sqrt(var_pop)   STDDEV_SAMP -> sqrt(var_samp)
      ANY_VALUE(x)  -> x when ungrouped, first-per-group when grouped

    n=0 (and n-1=0 for the sample forms) divides by zero, which is SQL
    NULL — matching MySQL's NULL over empty/singleton groups."""
    var_funcs = {
        "variance": "pop", "var_pop": "pop", "var_samp": "samp",
        "std": "pop_sqrt", "stddev": "pop_sqrt",
        "stddev_pop": "pop_sqrt", "stddev_samp": "samp_sqrt",
    }
    # grouped = explicit GROUP BY or implicit one-group aggregation
    # (ANY_VALUE(a) alongside COUNT(*) must aggregate, like MySQL)
    has_other_agg = [False]

    def scan(node):
        if isinstance(node, (ast.Select, ast.Union, ast.SubqueryExpr)):
            return
        if isinstance(node, ast.AggCall) and node.func not in (
            "any_value",
        ):
            has_other_agg[0] = True
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            for f in dataclasses.fields(node):
                scan(getattr(node, f.name))
        elif isinstance(node, (list, tuple)):
            for x in node:
                scan(x)

    for it in sel.items:
        scan(it.expr)
    if sel.having is not None:
        scan(sel.having)
    grouped = bool(sel.group_by) or has_other_agg[0]

    def rw(node):
        if isinstance(node, (ast.Select, ast.Union, ast.SubqueryExpr)):
            # subqueries rewrite against their OWN group-by context
            # when they are planned
            return node
        if isinstance(node, ast.AggCall) and node.func in var_funcs:
            kind = var_funcs[node.func]
            x = rw(node.arg)
            d = node.distinct
            sx = ast.AggCall("sum", x, d)
            sxx = ast.AggCall("sum", ast.Call("mul", [x, x]), d)
            n = ast.AggCall("count", x, d)
            if kind.startswith("pop"):
                mean = ast.Call("div", [sx, n])
                v = ast.Call(
                    "sub",
                    [ast.Call("div", [sxx, n]),
                     ast.Call("mul", [mean, mean])],
                )
            else:
                v = ast.Call(
                    "div",
                    [ast.Call(
                        "sub",
                        [sxx, ast.Call("div", [ast.Call("mul", [sx, sx]), n])],
                    ),
                     ast.Call("sub", [n, ast.Const(1)])],
                )
            if kind.endswith("sqrt"):
                # clamp tiny negative rounding residue before sqrt
                v = ast.Call("sqrt", [ast.Call("greatest", [v, ast.Const(0)])])
            return v
        if isinstance(node, ast.AggCall) and node.func == "any_value":
            inner = rw(node.arg)
            return (
                ast.AggCall("first", inner, False) if grouped else inner
            )
        if isinstance(node, ast.Call) and node.op == "any_value" and node.args:
            inner = rw(node.args[0])
            return (
                ast.AggCall("first", inner, False) if grouped else inner
            )
        if (
            dataclasses.is_dataclass(node)
            and not isinstance(node, type)
            and not node.__dataclass_params__.frozen  # SQLType et al
        ):
            for f in dataclasses.fields(node):
                setattr(node, f.name, rw(getattr(node, f.name)))
            return node
        if isinstance(node, list):
            return [rw(x) for x in node]
        if isinstance(node, tuple):
            return tuple(rw(x) for x in node)
        return node

    for it in sel.items:
        it.expr = rw(it.expr)
    if sel.having is not None:
        sel.having = rw(sel.having)
    if sel.order_by:
        sel.order_by = rw(list(sel.order_by))


def build_select(
    sel: ast.Select, catalog, current_db: str, subquery_value_fn=None, ctes=None
) -> LogicalPlan:
    """Full SELECT lowering: FROM -> WHERE (with pushdown + IN/EXISTS to
    semi/anti joins) -> AGG -> HAVING -> additive projection -> SORT ->
    LIMIT -> final projection."""
    # HAVING with IN/EXISTS subqueries: wrap as a derived table so the
    # subquery conjuncts run through the ordinary WHERE machinery over
    # the aggregated output (reference: HAVING lowers to a Selection
    # above the aggregation either way; the wrap reuses semi/mark joins
    # instead of a post-agg special case). Conjuncts must reference
    # select-list aliases, as MySQL HAVING requires for outer scoping.
    _rewrite_derived_aggs(sel)
    if sel.having is not None and _expr_has_modifier_subq(sel.having):
        subq_conjs, plain_conjs = [], []
        for c in _conjuncts(sel.having):
            (subq_conjs if _expr_has_modifier_subq(c) else plain_conjs).append(c)
        inner = dataclasses.replace(
            sel,
            having=_and_all(plain_conjs) if plain_conjs else None,
            order_by=[], limit=None, offset=None,
        )
        outer = ast.Select(
            items=[ast.SelectItem(ast.Star())],
            from_=ast.SubqueryRef(inner, "_hv"),
            where=_and_all(subq_conjs),
            order_by=sel.order_by, limit=sel.limit, offset=sel.offset,
        )
        return build_select(outer, catalog, current_db, subquery_value_fn, ctes)
    b = SelectBuilder(
        catalog, current_db, subquery_value_fn, ctes,
        hints=getattr(sel, "hints", ()),
    )

    if sel.from_ is None:
        plan = OneRow(Schema([]))
    else:
        plan = b.build_from(sel.from_)

    # ---- WHERE ----
    if sel.where is not None and not isinstance(plan, OneRow):
        plan = _apply_where(b, plan, sel.where, subquery_value_fn, catalog, current_db)
    elif sel.where is not None:
        binder0 = ExprBinder(plan.schema, _scalar_subq(subquery_value_fn))
        plan = Selection(plan.schema, plan, binder0.bind(sel.where))

    # ---- IN/EXISTS in value positions -> mark joins ----
    if not isinstance(plan, OneRow):
        _mk_counter = [0]
        new_items = []
        changed = False
        for it in sel.items:
            if isinstance(it.expr, ast.Star) or isinstance(it.expr, ast.Name):
                new_items.append(it)
                continue
            e2, plan = attach_value_subqueries(
                b, plan, it.expr, subquery_value_fn, catalog, current_db,
                _mk_counter,
            )
            if e2 is not it.expr:
                it = dataclasses.replace(it, expr=e2)
                changed = True
            new_items.append(it)
        if changed:
            sel = dataclasses.replace(sel, items=new_items)

    # ---- aggregate detection ----
    agg_calls: List[ast.AggCall] = []

    def find_aggs(e):
        if isinstance(e, ast.AggCall):
            agg_calls.append(e)
        elif isinstance(e, ast.Call):
            for a in e.args:
                find_aggs(a)
        elif isinstance(e, ast.WindowCall):
            # `sum(sum(x)) over (...)`: the inner AggCall forces grouping
            if e.arg is not None:
                find_aggs(e.arg)
            for p in e.partition_by:
                find_aggs(p)
            for oi in e.order_by:
                find_aggs(oi.expr)

    # expand stars first
    items: List[ast.SelectItem] = []
    for it in sel.items:
        if isinstance(it.expr, ast.Star):
            for c in plan.schema:
                if c.name == ROWID_NAME:
                    continue  # DML row handles are never star-visible
                if it.expr.table is None or (c.qualifier or "").lower() == it.expr.table.lower():
                    items.append(
                        ast.SelectItem(ast.Name(c.qualifier, c.name), None)
                    )
            continue
        items.append(it)

    for it in items:
        find_aggs(it.expr)
    if sel.having is not None:
        find_aggs(sel.having)
    for oi in sel.order_by:
        find_aggs(oi.expr)

    grouped = bool(sel.group_by) or bool(agg_calls)

    # resolve GROUP BY ordinals / aliases
    group_by = []
    for g in sel.group_by:
        if isinstance(g, ast.Const) and isinstance(g.value, int):
            idx = g.value - 1
            if not 0 <= idx < len(items):
                raise PlanError(f"GROUP BY position {g.value} out of range")
            group_by.append(items[idx].expr)
        elif isinstance(g, ast.Name) and g.table is None:
            alias_match = next(
                (it.expr for it in items if (it.alias or "").lower() == g.column.lower()),
                None,
            )
            group_by.append(alias_match if alias_match is not None else g)
        else:
            group_by.append(g)

    if grouped:
        plan, rewrite = _build_aggregate(
            b, plan, group_by, agg_calls,
            rollup=bool(getattr(sel, "rollup", False)),
        )
    else:
        rewrite = {}

    # ---- window functions (after aggregation, reference WindowExec) ----
    win_calls: List[ast.WindowCall] = []

    def find_wins(e):
        if isinstance(e, ast.WindowCall):
            win_calls.append(e)
        elif isinstance(e, ast.Call):
            for a in e.args:
                find_wins(a)

    for it in items:
        find_wins(it.expr)
    if win_calls:
        plan = _build_windows(plan, win_calls, rewrite)

    binder = ExprBinder(plan.schema, _scalar_subq(subquery_value_fn))

    def lower_item(e):
        e2 = _rewrite_aggs(e, rewrite) if rewrite else e
        return binder.bind(e2)

    # ---- additive projection: select outputs + hidden order keys ----
    out_names: List[str] = []
    proj_exprs: List[Tuple[str, Expr]] = []
    display: List[str] = []
    used = set()
    for i, it in enumerate(items):
        disp = it.alias or _display_name(it.expr)
        name = disp.lower()
        if name in used:
            name = f"{name}#{i}"
        used.add(name)
        bound = lower_item(it.expr)
        proj_exprs.append((name, bound))
        out_names.append(name)
        display.append(disp)

    # schema after additive projection: child cols + outputs
    add_cols = list(plan.schema.cols) + [
        OutCol(None, n, n, e.type) for n, e in proj_exprs
    ]
    # select aliases shadow child columns of the same bare name for ORDER BY
    proj = Projection(Schema(add_cols), plan, proj_exprs, additive=True)

    out_schema = Schema([OutCol(None, n, n, e.type) for n, e in proj_exprs])

    # ---- HAVING (after projection so select aliases are in scope) ----
    if sel.having is not None:
        hb = ExprBinder(
            LayeredSchema(out_schema, plan.schema), _scalar_subq(subquery_value_fn)
        )
        h = _rewrite_aggs(sel.having, rewrite) if rewrite else sel.having
        proj = Selection(proj.schema, proj, hb.bind(h))

    # ---- DISTINCT (group-by over outputs; applies before ORDER BY) ----
    if sel.distinct:
        dk = [(n, ColumnRef(type=e.type, name=n)) for n, e in proj_exprs]
        plan = Aggregate(out_schema, proj, dk, [])
        sort_schema = LayeredSchema(out_schema)
    else:
        plan = proj
        sort_schema = LayeredSchema(out_schema, plan.child.schema if isinstance(plan, Projection) else plan.schema)

    # ---- ORDER BY ----
    if sel.order_by:
        ob = ExprBinder(sort_schema, _scalar_subq(subquery_value_fn))
        keys = []
        for oi in sel.order_by:
            e = oi.expr
            if isinstance(e, ast.Const) and isinstance(e.value, int):
                e = ast.Name(None, out_names[e.value - 1])
            e2 = _rewrite_aggs(e, rewrite) if rewrite else e
            bound = ob.bind(e2)
            # per-column collation drives ORDER BY: a CI-collated string
            # key sorts by its dense collation rank (collate.go Key()
            # semantics), not by binary dictionary order
            if (
                bound.type is not None
                and bound.type.kind == Kind.STRING
                and bound.type.collation is not None
            ):
                from tidb_tpu_torch.utils import collate as _coll

                if not _coll.is_binary(bound.type.collation):
                    from tidb_tpu_torch.dtypes import INT64 as _I64

                    bound = Func(
                        op="_collation_rank", args=(bound,), type=_I64
                    )
            keys.append((bound, oi.desc))
        plan = Sort(plan.schema, plan, keys)

    # ---- LIMIT ----
    if sel.limit is not None:
        plan = Limit(plan.schema, plan, sel.limit, sel.offset or 0)

    # ---- final projection to the select list ----
    final_cols = [
        OutCol(None, disp, n, e.type)
        for disp, (n, e) in zip(display, proj_exprs)
    ]
    plan = Projection(
        Schema(final_cols),
        plan,
        [(n, ColumnRef(type=e.type, name=n)) for n, e in proj_exprs],
    )
    # aggregation pushdown through joins + post-agg selection sinking
    # (reference rule_aggregation_push_down.go; exactness conditions in
    # _try_push_agg) — before pruning so the narrowed sides prune harder
    plan = push_aggs_through_joins(plan, catalog)
    plan = sink_selections(plan)
    # column pruning over the finished tree (reference columnPruner)
    plan = prune_plan(plan, {c.internal for c in plan.schema.cols}, catalog)
    return plan


def _rebuild_children(plan: LogicalPlan, fn) -> LogicalPlan:
    """Apply fn to every direct child plan, rebuilding the node."""
    if isinstance(plan, (Scan, OneRow, Staged)):
        return plan
    if isinstance(plan, JoinPlan):
        return dataclasses.replace(plan, left=fn(plan.left), right=fn(plan.right))
    if isinstance(plan, UnionAll):
        return dataclasses.replace(plan, children=[fn(c) for c in plan.children])
    if hasattr(plan, "child"):
        return dataclasses.replace(plan, child=fn(plan.child))
    return plan


def _key_unique_on(plan: LogicalPlan, key_internals, catalog) -> bool:
    """True when `plan` provably yields at most one row per distinct
    value tuple of key_internals: a PK / public unique index on a scan
    (looked through Selections and renaming Projections), or an
    Aggregate whose full group-key set is covered. The join-side
    uniqueness proof behind aggregation pushdown (reference:
    rule_aggregation_push_down.go checkAnyCountAndSum preconditions)."""
    keys = list(key_internals)
    p = plan
    while True:
        if isinstance(p, Selection):
            p = p.child  # filtering can't break uniqueness
            continue
        if isinstance(p, Projection):
            m = {
                n: e.name for n, e in p.exprs if isinstance(e, ColumnRef)
            }
            nxt = []
            for k in keys:
                if k in m:
                    nxt.append(m[k])
                elif p.additive:
                    nxt.append(k)
                else:
                    return False
            keys = nxt
            p = p.child
            continue
        break
    if isinstance(p, Aggregate):
        gnames = {n for n, _ in p.group_exprs}
        return bool(gnames) and gnames.issubset(set(keys))
    if not isinstance(p, Scan):
        return False
    cols = []
    pre = f"{p.alias}."
    for k in keys:
        if not k.startswith(pre):
            return False
        cols.append(k[len(pre):])
    try:
        t = catalog.table(p.db, p.table)
    except Exception:
        return False
    pk = t.schema.primary_key
    if pk and set(pk).issubset(cols):
        return True
    for iname in getattr(t, "unique_indexes", ()):
        if hasattr(t, "index_state") and t.index_state(iname) != "public":
            continue
        icols = t.indexes.get(iname) or []
        if icols and set(icols).issubset(cols):
            return True
    return False


def _try_push_agg(agg: Aggregate, catalog) -> Optional[LogicalPlan]:
    """Aggregate over inner Join -> Join over Aggregate, EXACTLY, when:
      1. every agg argument references one join side only (the push
         side), and gc_meta is absent;
      2. every group expr references the push side, or is a ColumnRef
         equal (via an equi key) to a push-side key column;
      3. every push-side equi key appears among the (rewritten) group
         exprs — all rows of a group share one join key; and
      4. the other side is provably unique on its equi-key tuple — each
         group matches at most one row, so no contribution duplicates.
    Under 3+4 the join becomes a per-group existence filter + column
    extension, which commutes with the aggregation (including count(*):
    per-group joined-row count == push-side row count). Reference:
    rule_aggregation_push_down.go (TiDB pushes a PARTIAL agg and
    re-aggregates; with the uniqueness proof the single aggregate is
    exact, which suits whole-plan XLA compilation better)."""
    j = agg.child
    if (
        not isinstance(j, JoinPlan)
        or j.kind != "inner"
        or j.residual is not None
        or j.null_aware
        or j.mark_name is not None
        or not j.equi_keys
        or agg.gc_meta
    ):
        return None
    if not all(
        isinstance(l, ColumnRef) and isinstance(r, ColumnRef)
        for l, r in j.equi_keys
    ):
        return None
    from tidb_tpu_torch.expression.expr import walk_columns

    left_names = {c.internal for c in j.left.schema.cols}
    right_names = {c.internal for c in j.right.schema.cols}
    arg_cols: set = set()
    for _n, _f, a, _d in agg.aggs:
        if a is not None:
            arg_cols |= walk_columns(a)
    if arg_cols and arg_cols.issubset(left_names):
        sides = ["left"]
    elif arg_cols and arg_cols.issubset(right_names):
        sides = ["right"]
    elif not arg_cols:
        sides = ["left", "right"]  # COUNT(*)-only: either side may work
    else:
        return None

    for side in sides:
        push, other = (j.left, j.right) if side == "left" else (j.right, j.left)
        push_names = left_names if side == "left" else right_names
        pairs = [
            ((l, r) if side == "left" else (r, l)) for l, r in j.equi_keys
        ]  # (push key, other key)
        other_to_push = {ok.name: pk for pk, ok in pairs}
        new_groups = []
        ok = True
        for n, g in agg.group_exprs:
            gcols = walk_columns(g)
            if gcols.issubset(push_names):
                new_groups.append((n, g))
            elif isinstance(g, ColumnRef) and g.name in other_to_push:
                new_groups.append((n, other_to_push[g.name]))
            else:
                ok = False
                break
        if not ok:
            continue
        gmap = {
            g.name: n for n, g in new_groups if isinstance(g, ColumnRef)
        }
        if not all(pk.name in gmap for pk, _ok2 in pairs):
            continue
        if not _key_unique_on(other, [okk.name for _pk, okk in pairs], catalog):
            continue

        agg_cols = []
        agg_types = {c.internal: c.type for c in agg.schema.cols}
        for n, g in new_groups:
            agg_cols.append(OutCol(None, n, n, g.type))
        for n, _f, _a, _d in agg.aggs:
            agg_cols.append(OutCol(None, n, n, agg_types[n]))
        new_agg = Aggregate(Schema(agg_cols), push, new_groups, agg.aggs)
        new_keys = []
        for pk, okk in pairs:
            kref = ColumnRef(type=pk.type, name=gmap[pk.name])
            new_keys.append(
                (kref, okk) if side == "left" else (okk, kref)
            )
        nl, nr = (new_agg, other) if side == "left" else (other, new_agg)
        # broadcast choice reset: side sizes changed fundamentally
        return JoinPlan(
            Schema(list(nl.schema.cols) + list(nr.schema.cols)),
            "inner", nl, nr, new_keys, None,
        )
    return None


def _push_agg_cascade(agg: Aggregate, catalog) -> Optional[LogicalPlan]:
    """Push once, then re-try the pushed Aggregate against ITS join
    child — multi-join chains (fact ⨝ dim1 ⨝ dim2) push all the way
    down when every hop satisfies the exactness conditions."""
    pushed = _try_push_agg(agg, catalog)
    if pushed is None:
        return None
    for side in ("left", "right"):
        child = getattr(pushed, side)
        if isinstance(child, Aggregate):
            deeper = _push_agg_cascade(child, catalog)
            if deeper is not None:
                return dataclasses.replace(pushed, **{side: deeper})
    return pushed


def push_aggs_through_joins(plan: LogicalPlan, catalog) -> LogicalPlan:
    plan = _rebuild_children(
        plan, lambda c: push_aggs_through_joins(c, catalog)
    )
    if isinstance(plan, Aggregate):
        pushed = _push_agg_cascade(plan, catalog)
        if pushed is not None:
            return pushed
    return plan


def sink_selections(plan: LogicalPlan) -> LogicalPlan:
    """Post-build selection sinking: a Selection lands as low as its
    column footprint allows — through additive Projections and to one
    side of an inner join (the HAVING-below-join shape that aggregation
    pushdown exposes). WHERE conjuncts already sank during FROM build;
    this pass covers predicates created above joins afterwards."""
    plan = _rebuild_children(plan, sink_selections)
    if not isinstance(plan, Selection):
        return plan
    from tidb_tpu_torch.expression.expr import walk_columns

    pred_cols = walk_columns(plan.predicate)
    child = plan.child
    if isinstance(child, Projection) and child.additive:
        produced = {n for n, _ in child.exprs}
        if not (pred_cols & produced):
            inner = sink_selections(
                Selection(child.child.schema, child.child, plan.predicate)
            )
            return Projection(
                child.schema, inner, child.exprs, child.additive
            )
    if isinstance(child, JoinPlan) and child.kind == "inner":
        left_names = {c.internal for c in child.left.schema.cols}
        right_names = {c.internal for c in child.right.schema.cols}
        if pred_cols and pred_cols.issubset(left_names):
            nl = sink_selections(
                Selection(child.left.schema, child.left, plan.predicate)
            )
            return dataclasses.replace(child, left=nl)
        if pred_cols and pred_cols.issubset(right_names):
            nr = sink_selections(
                Selection(child.right.schema, child.right, plan.predicate)
            )
            return dataclasses.replace(child, right=nr)
    return plan


_SUBST_KINDS = {Kind.INT, Kind.BOOL, Kind.DATE, Kind.DATETIME, Kind.TIME}


def _try_join_narrow(plan, required, catalog):
    """Inner-join demotion / outer-join elimination at prune time
    (reference rule_join_elimination.go + the semi-join side of
    rule_semi_join_rewrite.go, applied in reverse): when one join side
    is provably unique on its equi-key tuple and the parent consumes
    NOTHING from it beyond those key columns, the join exists only to
    filter (inner) or for nothing at all (left outer):

      inner -> semi: the kept side's rows that match survive exactly
        once either way; parent references to the dropped side's key
        columns are satisfied by the kept side's key exprs (equal by
        the join predicate — restricted to exact-equality kinds so the
        substituted VALUE is identical, not merely comparing equal).
      left -> eliminated entirely when the parent consumes nothing from
        the inner side: every probe row survives exactly once.

    Returns a replacement plan (not yet pruned) or None. The payoff is
    architectural, not just planner cosmetics: a semi join compiles to
    one existence scatter + mask where inner-unique builds a row table
    and gathers the build key at every probe position (Q18's post-
    agg-pushdown join; Q5's region hop)."""
    if (
        plan.residual is not None
        or plan.null_aware
        or plan.mark_name is not None
        or not plan.equi_keys
        or catalog is None
        or not all(
            isinstance(l, ColumnRef) and isinstance(r, ColumnRef)
            for l, r in plan.equi_keys
        )
    ):
        return None
    lcols = {c.internal for c in plan.left.schema.cols}
    rcols = {c.internal for c in plan.right.schema.cols}
    sides = (
        ("right", "left") if plan.kind == "inner"
        else ("right",) if plan.kind == "left"
        else ()
    )
    for drop_side in sides:
        drop, keep = (
            (plan.right, plan.left) if drop_side == "right"
            else (plan.left, plan.right)
        )
        drop_names = rcols if drop_side == "right" else lcols
        pairs = [
            ((r, l) if drop_side == "right" else (l, r))
            for l, r in plan.equi_keys
        ]  # (dropped key, kept key)
        dkey_names = {d.name for d, _k in pairs}
        needed = {n for n in required if n in drop_names}
        if not needed <= dkey_names:
            continue
        if plan.kind == "left" and needed:
            continue  # NULL-extended rows would expose the substitution
        if needed and not all(
            d.type.kind == k.type.kind and d.type.kind in _SUBST_KINDS
            for d, k in pairs
        ):
            continue
        if not _key_unique_on(drop, [d.name for d, _k in pairs], catalog):
            continue
        if plan.kind == "left":
            return keep  # == plan.left
        if drop_side == "right":
            semi = JoinPlan(
                plan.left.schema, "semi", plan.left, plan.right,
                list(plan.equi_keys),
                broadcast="right" if plan.broadcast == "right" else None,
            )
        else:
            semi = JoinPlan(
                plan.right.schema, "semi", plan.right, plan.left,
                [(r, l) for l, r in plan.equi_keys],
                broadcast="right" if plan.broadcast == "left" else None,
            )
        if not needed:
            return semi
        alias = [
            (d.name, ColumnRef(type=k.type, name=k.name))
            for d, k in pairs
            if d.name in needed
        ]
        sch = Schema(
            list(semi.schema.cols)
            + [OutCol(None, n, n, e.type) for n, e in alias]
        )
        return Projection(sch, semi, alias, additive=True)
    return None


def prune_plan(plan: LogicalPlan, required: set, catalog=None) -> LogicalPlan:
    """Column pruning (reference rule columnPruner, optimizer.go:98):
    walk top-down with the set of internal names the parent needs; scans
    read only referenced columns. With a catalog, unique-side joins the
    parent doesn't otherwise consume narrow to semi joins or disappear
    (_try_join_narrow)."""
    from tidb_tpu_torch.expression.expr import walk_columns

    if isinstance(plan, Scan):
        keep = [
            n for n in plan.columns if f"{plan.alias}.{n}" in required
        ] or plan.columns[:1]  # keep one column for row count
        cols = [c for c in plan.schema.cols if c.name in keep]
        return Scan(Schema(cols), plan.db, plan.table, plan.alias, keep)
    if isinstance(plan, Selection):
        need = set(required) | walk_columns(plan.predicate)
        child = prune_plan(plan.child, need, catalog)
        return Selection(child.schema, child, plan.predicate)
    if isinstance(plan, Projection):
        exprs = [(n, e) for n, e in plan.exprs if n in required] or plan.exprs[:1]
        need = set()
        for _n, e in exprs:
            need |= walk_columns(e)
        if plan.additive:
            produced = {n for n, _ in plan.exprs}
            need |= {r for r in required if r not in produced}
        child = prune_plan(plan.child, need, catalog)
        sch = Schema([c for c in plan.schema.cols if c.internal in required or c.internal in {n for n, _ in exprs}])
        return Projection(sch, child, exprs, plan.additive)
    if isinstance(plan, Aggregate):
        need = set()
        for _n, e in plan.group_exprs:
            need |= walk_columns(e)
        for _n, _f, a, _d in plan.aggs:
            if a is not None:
                need |= walk_columns(a)
        for _sep, obs in (plan.gc_meta or {}).values():
            for e, _desc in obs:
                need |= walk_columns(e)
        child = prune_plan(plan.child, need, catalog)
        return dataclasses.replace(plan, child=child)
    if isinstance(plan, JoinPlan):
        narrowed = _try_join_narrow(plan, required, catalog)
        if narrowed is not None:
            return prune_plan(narrowed, required, catalog)
        lcols = {c.internal for c in plan.left.schema.cols}
        rcols = {c.internal for c in plan.right.schema.cols}
        lneed = {r for r in required if r in lcols}
        rneed = {r for r in required if r in rcols}
        for le, re_ in plan.equi_keys:
            lneed |= walk_columns(le)
            rneed |= walk_columns(re_)
        if plan.residual is not None:
            res_cols = walk_columns(plan.residual)
            lneed |= res_cols & lcols
            rneed |= res_cols & rcols
        left = prune_plan(plan.left, lneed, catalog)
        right = prune_plan(plan.right, rneed, catalog)
        if plan.kind in ("semi", "anti"):
            sch = left.schema
        elif plan.kind == "mark":
            sch = Schema(
                list(left.schema.cols)
                + [c for c in plan.schema.cols if c.internal == plan.mark_name]
            )
        else:
            sch = Schema(list(left.schema.cols) + list(right.schema.cols))
        return JoinPlan(
            sch, plan.kind, left, right, plan.equi_keys, plan.residual,
            plan.null_aware, plan.broadcast, plan.mark_name,
        )
    if isinstance(plan, Sort):
        need = set(required)
        for e, _d in plan.keys:
            need |= walk_columns(e)
        child = prune_plan(plan.child, need, catalog)
        return Sort(child.schema, child, plan.keys)
    if isinstance(plan, Window):
        need = {r for r in required if not r.startswith("_w")}
        for e in plan.partition_exprs:
            need |= walk_columns(e)
        for e, _d in plan.order_exprs:
            need |= walk_columns(e)
        for _n, _f, a, _o, _r, _fr in plan.descs:
            if a is not None:
                need |= walk_columns(a)
        child = prune_plan(plan.child, need, catalog)
        return Window(
            plan.schema, child, plan.partition_exprs, plan.order_exprs, plan.descs
        )
    if isinstance(plan, Limit):
        child = prune_plan(plan.child, required, catalog)
        return Limit(child.schema, child, plan.count, plan.offset)
    if isinstance(plan, UnionAll):
        # children always produce the full _u column set (positional union)
        all_u = {c.internal for c in plan.schema.cols}
        children = [prune_plan(c, all_u, catalog) for c in plan.children]
        return UnionAll(plan.schema, children)
    return plan


def _display_name(e) -> str:
    if isinstance(e, ast.Name):
        return e.column
    if isinstance(e, ast.AggCall):
        inner = "*" if e.arg is None else _display_name(e.arg)
        d = "distinct " if e.distinct else ""
        return f"{e.func}({d}{inner})"
    if isinstance(e, ast.Const):
        return repr(e.value)
    if isinstance(e, ast.Call):
        return f"{e.op}(...)" if len(e.args) > 2 else e.op
    return "expr"


def _scalar_subq(subquery_value_fn):
    if subquery_value_fn is None:
        return None

    def run(e: ast.SubqueryExpr):
        if e.modifier is None:
            return subquery_value_fn(e.query)
        if e.modifier in ("exists", "not exists"):
            # uncorrelated EXISTS in a scalar position (e.g. tableless
            # SELECT): COUNT over a derived table keeps GROUP BY /
            # HAVING / LIMIT semantics
            from tidb_tpu_torch.dtypes import BOOL as _BOOL

            cnt_q = ast.Select(
                items=[
                    ast.SelectItem(ast.AggCall("count", None), alias="_c")
                ],
                from_=ast.SubqueryRef(
                    dataclasses.replace(e.query, order_by=[]), "_ex"
                ),
            )
            n = subquery_value_fn(cnt_q).value
            hit = (n or 0) > 0
            return Literal(
                type=_BOOL, value=hit if e.modifier == "exists" else not hit
            )
        raise PlanError(
            "IN/EXISTS subquery not supported in this position"
        )

    return run


def _apply_where(b, plan, where, subquery_value_fn, catalog, db):
    """Split WHERE conjuncts: IN/EXISTS subqueries become semi/anti
    joins; conjuncts containing a correlated scalar subquery are
    decorrelated into a left join on the correlation keys (reference
    decorrelateSolver, optimizer.go:98-123); plain predicates run
    through cross-join elimination (ppdSolver + joinReOrderSolver):
    single-relation conjuncts sink onto their relation, eq-conjuncts
    linking two relations of a comma-join become inner-join keys, the
    rest filter on top."""
    plain: List = []
    subq: List = []
    corr_scalar: List = []
    for c in _conjuncts(where):
        if isinstance(c, ast.SubqueryExpr) and c.modifier in ("in", "not in", "exists", "not exists"):
            subq.append(c)
        elif isinstance(c, ast.Call) and c.op == "not" and isinstance(c.args[0], ast.SubqueryExpr):
            sq = c.args[0]
            mod = {"in": "not in", "exists": "not exists"}[sq.modifier]
            subq.append(ast.SubqueryExpr(sq.query, mod, sq.lhs))
        elif any(
            _is_correlated(s.query, plan.schema, b)
            for s in _scalar_subqs_in(c, [])
        ):
            corr_scalar.append(c)
        else:
            plain.append(c)
    if plain:
        plan = _reorder_joins(plan, plain, subquery_value_fn, catalog)
    for c in subq:
        plan = _subquery_semijoin(b, plan, c, subquery_value_fn, catalog, db)
    for c in corr_scalar:
        plan = _decorrelate_scalar(b, plan, c, subquery_value_fn, catalog, db)
    return plan


def _flatten_cross(p: LogicalPlan) -> List[LogicalPlan]:
    if isinstance(p, JoinPlan) and p.kind == "cross" and p.residual is None:
        return _flatten_cross(p.left) + _flatten_cross(p.right)
    return [p]


def _rels_of(conj, rels: List[LogicalPlan]) -> Optional[set]:
    """Which relations a conjunct's columns come from; None if a column
    is unresolvable (shouldn't happen for bound-checked input)."""
    cols = _ast_columns(conj, set())
    out = set()
    for tbl, col in cols:
        found = None
        for i, r in enumerate(rels):
            try:
                r.schema.resolve(tbl, col)
                found = i if found is None else found
                if found != i:
                    # ambiguous across relations: unqualified name in two
                    return None
            except PlanError:
                continue
        if found is None:
            return None
        out.add(found)
    return out


def _broadcast_choice(est_left: float, est_right: float) -> Optional[str]:
    """Mesh exchange pick: broadcast the side small enough that an
    all_gather of it beats an all_to_all of both sides (reference:
    broadcast-vs-shuffle MPP join cost in exhaust_physical_plans.go;
    our threshold plays the role of tidb_broadcast_join_threshold_count)."""
    from tidb_tpu_torch.planner.cardinality import BROADCAST_ROW_LIMIT

    if est_right <= BROADCAST_ROW_LIMIT and est_right * 4 <= est_left:
        return "right"
    if est_left <= BROADCAST_ROW_LIMIT and est_left * 4 <= est_right:
        return "left"
    return None


def _reorder_joins(plan, conjuncts, subquery_value_fn, catalog=None) -> LogicalPlan:
    rels = _flatten_cross(plan)
    if len(rels) == 1:
        binder = ExprBinder(plan.schema, _scalar_subq(subquery_value_fn))
        return Selection(plan.schema, plan, binder.bind(_and_all(conjuncts)))

    rel_filters: Dict[int, List] = {}
    edges: List[Tuple[int, int, object, object]] = []  # (ri, rj, ast_i, ast_j)
    post: List = []
    for c in conjuncts:
        rs = _rels_of(c, rels)
        if rs is not None and len(rs) == 1:
            rel_filters.setdefault(next(iter(rs)), []).append(c)
            continue
        if (
            isinstance(c, ast.Call)
            and c.op == "eq"
            and rs is not None
            and len(rs) == 2
        ):
            s0 = _rels_of(c.args[0], rels)
            s1 = _rels_of(c.args[1], rels)
            if s0 is not None and s1 is not None and len(s0) == 1 and len(s1) == 1 and s0 != s1:
                edges.append((next(iter(s0)), next(iter(s1)), c.args[0], c.args[1]))
                continue
        post.append(c)

    # sink single-relation filters (predicate pushdown)
    for i, fs in rel_filters.items():
        r = rels[i]
        binder = ExprBinder(r.schema, _scalar_subq(subquery_value_fn))
        rels[i] = Selection(r.schema, r, binder.bind(_and_all(fs)))

    # cost-driven greedy join tree (reference: join reorder consuming
    # cardinality estimates, pkg/planner/core/rule_join_reorder.go +
    # cardinality/selectivity.go): start from the smallest estimated
    # relation; at each step join the connected relation that minimizes
    # the estimated result size. Falls back to structural heuristics
    # when no stats exist (estimates then come from pseudo rates).
    from tidb_tpu_torch.planner import cardinality as C

    smap = C.StatsMap()
    rel_est: Dict[int, float] = {}
    for i, r in enumerate(rels):
        if catalog is not None:
            sub = C.gather_stats(r, catalog)
            smap.cols.update(sub.cols)
    for i, r in enumerate(rels):
        rel_est[i] = (
            C.est_rows(r, catalog, smap) if catalog is not None else 1000.0
        )

    start = min(range(len(rels)), key=lambda i: (rel_est[i], i))
    joined = {start}
    cur = rels[start]
    cur_est = rel_est[start]
    remaining = set(range(len(rels))) - joined
    while remaining:
        # all edges between the joined set and one new relation
        candidates: Dict[int, List[Tuple[object, object]]] = {}
        for (ri, rj, ei, ej) in edges:
            if ri in joined and rj in remaining:
                candidates.setdefault(rj, []).append((ei, ej))
            elif rj in joined and ri in remaining:
                candidates.setdefault(ri, []).append((ej, ei))
        if not candidates:
            nxt = min(remaining, key=lambda i: (rel_est[i], i))
            r = rels[nxt]
            schema = Schema(list(cur.schema.cols) + list(r.schema.cols))
            cur = JoinPlan(schema, "cross", cur, r, [], None)
            cur_est = cur_est * rel_est[nxt]
            joined.add(nxt)
            remaining.discard(nxt)
            continue
        # bind each candidate's keys and estimate its join size; pick min
        bound: Dict[int, List[Tuple[Expr, Expr]]] = {}
        cand_est: Dict[int, float] = {}
        for k, pairs in candidates.items():
            lb = ExprBinder(cur.schema)
            rb = ExprBinder(rels[k].schema)
            keys = [(lb.bind(ei), rb.bind(ej)) for ei, ej in pairs]
            bound[k] = keys
            cand_est[k] = C.est_join(cur_est, rel_est[k], keys, "inner", smap)
        nxt = min(
            candidates,
            key=lambda k: (cand_est[k], -len(candidates[k]), k),
        )
        r = rels[nxt]
        keys = bound[nxt]
        schema = Schema(list(cur.schema.cols) + list(r.schema.cols))
        bcast = _broadcast_choice(cur_est, rel_est[nxt])
        cur = JoinPlan(schema, "inner", cur, r, keys, None, broadcast=bcast)
        cur_est = cand_est[nxt]
        joined.add(nxt)
        remaining.discard(nxt)

    if post:
        binder = ExprBinder(cur.schema, _scalar_subq(subquery_value_fn))
        cur = Selection(cur.schema, cur, binder.bind(_and_all(post)))
    return cur


# -- correlated subquery support (reference: decorrelateSolver +
# expression_rewriter.go semi-join / scalar-agg rewrites) -------------------


def _scalar_subqs_in(e, out: List) -> List:
    """Collect scalar (modifier=None) SubqueryExprs one level deep."""
    if isinstance(e, ast.SubqueryExpr):
        if e.modifier is None:
            out.append(e)
        if e.lhs is not None:
            _scalar_subqs_in(e.lhs, out)
    elif isinstance(e, ast.Call):
        for a in e.args:
            _scalar_subqs_in(a, out)
    return out


def _replace_node(e, target, repl):
    """Rebuild expression AST with the (identity-matched) target node
    replaced."""
    if e is target:
        return repl
    if isinstance(e, ast.Call):
        return ast.Call(e.op, [_replace_node(a, target, repl) for a in e.args], e.cast_type)
    return e


def _has_agg(e) -> bool:
    if isinstance(e, ast.AggCall):
        return True
    if isinstance(e, ast.Call):
        return any(_has_agg(a) for a in e.args)
    return False


def _inner_from_schema(q: ast.Select, b) -> Optional[Schema]:
    if q.from_ is None:
        return None
    cache = getattr(b, "_ifs_cache", None)
    if cache is None:
        cache = b._ifs_cache = {}
    key = id(q)
    if key not in cache:
        inner_b = SelectBuilder(b.catalog, b.db, b.subquery_value_fn, b.ctes)
        cache[key] = inner_b.build_from(q.from_).schema
    return cache[key]


def _is_correlated(q: ast.Select, outer_schema: Schema, b) -> bool:
    """True if q.where references columns resolvable only in the outer
    scope (one level; inner scope shadows outer, standard SQL)."""
    if q.from_ is None or q.where is None:
        return False
    try:
        inner_schema = _inner_from_schema(q, b)
    except PlanError:
        return False
    for tbl, col in _ast_columns(q.where, set()):
        try:
            inner_schema.resolve(tbl, col)
        except PlanError:
            try:
                outer_schema.resolve(tbl, col)
                return True
            except PlanError:
                pass
    return False


def _corr_split(q: ast.Select, outer_schema: Schema, b):
    """Split q.where by correlation.

    Returns (corr_pairs, kept_where, residuals, extra_items):
    corr_pairs is a list of (outer_ast, inner_ast) from conjuncts of the
    form ``inner_expr = outer_expr``; kept_where is the AND of the
    purely inner conjuncts (or None); residuals are the remaining
    correlated conjuncts with their inner column references rewritten to
    ``_cr{j}`` names, and extra_items the (alias, inner Name) pairs the
    subquery must additionally project so those residuals can evaluate
    on the joined row (reference: other-conditions on semi joins,
    joiner.go)."""
    inner_schema = _inner_from_schema(q, b)

    def scope(e) -> str:
        has_inner = has_outer = False
        for tbl, col in _ast_columns(e, set()):
            try:
                inner_schema.resolve(tbl, col)
                has_inner = True
                continue
            except PlanError:
                pass
            try:
                outer_schema.resolve(tbl, col)
                has_outer = True
            except PlanError:
                raise PlanError(f"unknown column {col} in subquery")
        if has_inner and has_outer:
            return "mixed"
        if has_outer:
            return "outer"
        return "inner"  # includes constant-only

    extra_items: List[Tuple[str, ast.Name]] = []
    cr_map: Dict[Tuple[Optional[str], str], str] = {}

    def rewrite_inner(e):
        if isinstance(e, ast.Name):
            try:
                inner_schema.resolve(e.table, e.column)
            except PlanError:
                return e  # outer reference, binds over the joined schema
            key = (e.table.lower() if e.table else None, e.column.lower())
            if key not in cr_map:
                alias = f"_cr{len(cr_map)}"
                cr_map[key] = alias
                extra_items.append((alias, e))
            return ast.Name(None, cr_map[key])
        if isinstance(e, ast.Call):
            return ast.Call(e.op, [rewrite_inner(a) for a in e.args], e.cast_type)
        return e

    corr_pairs: List[Tuple[object, object]] = []
    kept: List = []
    residuals: List = []
    for c in _conjuncts(q.where) if q.where is not None else []:
        if _scalar_subqs_in(c, []) or isinstance(c, ast.SubqueryExpr):
            kept.append(c)  # nested subqueries resolve in their own pass
            continue
        s = scope(c)
        if s == "inner":
            kept.append(c)
            continue
        if isinstance(c, ast.Call) and c.op == "eq":
            s0, s1 = scope(c.args[0]), scope(c.args[1])
            if s0 == "inner" and s1 == "outer":
                corr_pairs.append((c.args[1], c.args[0]))
                continue
            if s0 == "outer" and s1 == "inner":
                corr_pairs.append((c.args[0], c.args[1]))
                continue
        residuals.append(rewrite_inner(c))
    return corr_pairs, (_and_all(kept) if kept else None), residuals, extra_items


def _check_simple_subquery(q: ast.Select, what: str) -> None:
    if q.group_by or q.having or q.order_by or q.limit is not None:
        raise PlanError(
            f"correlated {what} subquery with GROUP BY/HAVING/ORDER/LIMIT "
            "not supported"
        )


def _items_aggregate(q: ast.Select) -> bool:
    return any(
        not isinstance(it.expr, ast.Star) and _has_agg(it.expr)
        for it in q.items
    )


def _empty_group_value(e):
    """Value of an aggregate output expression over an EMPTY group:
    count -> 0, other aggs -> NULL, NULL propagating through arithmetic
    (MySQL scalar-subquery-with-no-rows semantics). Returns None for
    NULL or when the expression can't be folded."""
    if isinstance(e, ast.AggCall):
        return 0 if e.func == "count" else None
    if isinstance(e, ast.Const):
        return e.value
    if isinstance(e, ast.Call):
        args = [_empty_group_value(a) for a in e.args]
        if e.op == "coalesce":
            return next((a for a in args if a is not None), None)
        if any(a is None for a in args):
            return None
        if e.op == "add":
            return args[0] + args[1]
        if e.op == "sub":
            return args[0] - args[1]
        if e.op == "mul":
            return args[0] * args[1]
        if e.op == "div":
            return None if args[1] == 0 else args[0] / args[1]
        if e.op == "neg":
            return -args[0]
    return None


def _bind_corr_keys(ob: "ExprBinder", corr_pairs, inner_cols) -> List[Tuple[Expr, Expr]]:
    return [
        (ob.bind(oe), ColumnRef(type=c.type, name=c.internal))
        for (oe, _ie), c in zip(corr_pairs, inner_cols)
    ]


def _bind_residuals(outer_schema, inner_schema, residuals, subquery_value_fn):
    if not residuals:
        return None
    joined = Schema(list(outer_schema.cols) + list(inner_schema.cols))
    return ExprBinder(joined, _scalar_subq(subquery_value_fn)).bind(
        _and_all(residuals)
    )


def attach_value_subqueries(b, plan, node, subquery_value_fn, catalog, db, counter):
    """Rewrite IN/EXISTS subqueries appearing in VALUE positions (select
    items, CASE conditions, DML WHERE item evaluation) into mark joins:
    the probe keeps every row and gains a boolean (three-valued for IN)
    result column (reference: expression_rewriter.go building
    LeftOuterSemiJoin with a mark). Returns (rewritten ast node, plan).

    Uncorrelated EXISTS folds to a constant. NOT wrappers become NOT of
    the mark — the mark's validity carries the NULL semantics, so the
    3-valued negation is free."""
    if isinstance(node, ast.SubqueryExpr) and node.modifier in (
        "in", "not in", "exists", "not exists",
    ):
        plan, ref = _make_mark(
            b, plan, node, subquery_value_fn, catalog, db, counter
        )
        return ref, plan
    if (
        isinstance(node, ast.SubqueryExpr)
        and node.modifier is None
        and _is_correlated(node.query, plan.schema, b)
    ):
        # correlated SCALAR subquery in a value position: the same
        # agg-pull-up left join as the WHERE path, but the joined value
        # column replaces the expression directly
        plan, ref = _attach_corr_scalar(
            b, plan, node, subquery_value_fn, catalog, db
        )
        return ref, plan
    if isinstance(node, ast.Call):
        new_args = []
        for a in node.args:
            a2, plan = attach_value_subqueries(
                b, plan, a, subquery_value_fn, catalog, db, counter
            )
            new_args.append(a2)
        if new_args != list(node.args):
            node = dataclasses.replace(node, args=new_args)
        return node, plan
    if isinstance(node, ast.AggCall) and node.arg is not None:
        a2, plan = attach_value_subqueries(
            b, plan, node.arg, subquery_value_fn, catalog, db, counter
        )
        if a2 is not node.arg:
            node = dataclasses.replace(node, arg=a2)
        return node, plan
    return node, plan


def _make_mark(b, plan, sq: ast.SubqueryExpr, subquery_value_fn, catalog, db, counter):
    """One IN/EXISTS value-position subquery -> (plan with mark join,
    replacement ast node)."""
    q = sq.query
    negate = sq.modifier in ("not in", "not exists")
    exists = sq.modifier in ("exists", "not exists")
    correlated = _is_correlated(q, plan.schema, b)

    def maybe_not(e):
        return ast.Call("not", [e]) if negate else e

    if exists and not correlated:
        if (
            not q.group_by and _items_aggregate(q)
            and q.having is None and q.limit is None
        ):
            # bare aggregate: always exactly one row
            return plan, ast.Const(not negate)
        if subquery_value_fn is None:
            raise PlanError("EXISTS subquery needs a session context")
        cnt_q = ast.Select(
            items=[ast.SelectItem(ast.AggCall("count", None), alias="_c")],
            from_=ast.SubqueryRef(dataclasses.replace(q, order_by=[]), "_ex"),
        )
        n = subquery_value_fn(cnt_q).value
        return plan, ast.Const(((n or 0) > 0) != negate)

    counter[0] += 1
    mark = f"_mk{counter[0]}"
    from tidb_tpu_torch.dtypes import BOOL as _BOOL

    if exists:
        _check_simple_subquery(q, "EXISTS")
        corr_pairs, kept, residuals, extra = _corr_split(q, plan.schema, b)
        if not corr_pairs or residuals:
            raise PlanError(
                "correlated EXISTS in value position needs exactly "
                "equality correlations"
            )
        inner_q = dataclasses.replace(
            q,
            items=[
                ast.SelectItem(ie, alias=f"_ck{i}")
                for i, (_oe, ie) in enumerate(corr_pairs)
            ],
            where=kept,
            distinct=False,
        )
        inner = build_query(inner_q, catalog, db, subquery_value_fn, b.ctes)
        ob = ExprBinder(plan.schema, _scalar_subq(subquery_value_fn))
        keys = _bind_corr_keys(ob, corr_pairs, inner.schema.cols)
        three = False
    else:
        if correlated:
            raise PlanError(
                "correlated IN in value position not supported "
                "(rewrite as EXISTS)"
            )
        _check_simple_subquery(q, "IN")
        inner = build_query(q, catalog, db, subquery_value_fn, b.ctes)
        if len(inner.schema.cols) != 1:
            raise PlanError("IN subquery must return one column")
        ob = ExprBinder(plan.schema, _scalar_subq(subquery_value_fn))
        lhs = ob.bind(sq.lhs)
        c0 = inner.schema.cols[0]
        keys = [(lhs, ColumnRef(type=c0.type, name=c0.internal))]
        three = True
    if len(keys) != 1:
        raise PlanError(
            "value-position subqueries support one correlation key"
        )
    sch = Schema(
        list(plan.schema.cols) + [OutCol(None, mark, mark, _BOOL)]
    )
    plan = JoinPlan(
        sch, "mark", plan, inner, keys,
        null_aware=three, mark_name=mark,
    )
    return plan, maybe_not(ast.Name(None, mark))


def _subquery_semijoin(b, plan, sq: ast.SubqueryExpr, subquery_value_fn, catalog, db):
    """IN/EXISTS (correlated or not) -> semi/anti join (reference:
    decorrelation + semi-join rewrite in expression_rewriter.go)."""
    q = sq.query
    correlated = _is_correlated(q, plan.schema, b)

    if sq.modifier in ("exists", "not exists"):
        if (
            not q.group_by and _items_aggregate(q)
            and q.having is None and q.limit is None
        ):
            # A bare aggregate subquery (no GROUP BY/HAVING/LIMIT)
            # yields exactly one row regardless of its input (even an
            # empty, even a correlated one) -> EXISTS is always true.
            want = sq.modifier == "exists"
            return plan if want else Limit(plan.schema, plan, 0, 0)
        if not correlated:
            # Evaluate once: COUNT(*) over the subquery as a derived table
            # (keeps GROUP BY/HAVING/LIMIT semantics intact).
            if subquery_value_fn is None:
                raise PlanError("EXISTS subquery needs a session context")
            cnt_q = ast.Select(
                items=[ast.SelectItem(ast.AggCall("count", None), alias="_c")],
                from_=ast.SubqueryRef(dataclasses.replace(q, order_by=[]), "_ex"),
            )
            n = subquery_value_fn(cnt_q).value
            hit = (n or 0) > 0
            want = sq.modifier == "exists"
            return plan if hit == want else Limit(plan.schema, plan, 0, 0)
        _check_simple_subquery(q, "EXISTS")
        corr_pairs, kept, residuals, extra = _corr_split(q, plan.schema, b)
        if not corr_pairs:
            raise PlanError(
                "correlated EXISTS needs at least one equality correlation"
            )
        inner_q = dataclasses.replace(
            q,
            items=[
                ast.SelectItem(ie, alias=f"_ck{i}")
                for i, (_oe, ie) in enumerate(corr_pairs)
            ]
            + [ast.SelectItem(ie, alias=al) for al, ie in extra],
            where=kept,
            distinct=False,
        )
        inner = build_query(inner_q, catalog, db, subquery_value_fn, b.ctes)
        ob = ExprBinder(plan.schema, _scalar_subq(subquery_value_fn))
        keys = _bind_corr_keys(ob, corr_pairs, inner.schema.cols)
        res = _bind_residuals(plan.schema, inner.schema, residuals, subquery_value_fn)
        kind = "semi" if sq.modifier == "exists" else "anti"
        return JoinPlan(plan.schema, kind, plan, inner, keys, res)

    # IN: probe side = plan, build side = inner's single output column
    corr_pairs: List[Tuple[object, object]] = []
    inner_q = q
    if correlated:
        if isinstance(sq.lhs, ast.RowExpr):
            raise PlanError(
                "correlated row-value IN not supported (use EXISTS)"
            )
        if sq.modifier == "not in":
            raise PlanError(
                "correlated NOT IN not supported (use NOT EXISTS)"
            )
        _check_simple_subquery(q, "IN")
        if _items_aggregate(q):
            raise PlanError(
                "aggregate in correlated IN subquery not supported "
                "(rewrite as a comparison with the scalar subquery)"
            )
        corr_pairs, kept, residuals, extra = _corr_split(q, plan.schema, b)
        if len(q.items) != 1:
            raise PlanError("IN subquery must select exactly one column")
        inner_q = dataclasses.replace(
            q,
            items=list(q.items)
            + [
                ast.SelectItem(ie, alias=f"_ck{i}")
                for i, (_oe, ie) in enumerate(corr_pairs)
            ]
            + [ast.SelectItem(ie, alias=al) for al, ie in extra],
            where=kept,
            distinct=False,
        )
    else:
        residuals, extra = [], []
    inner = build_query(inner_q, catalog, db, subquery_value_fn, b.ctes)
    ob = ExprBinder(plan.schema, _scalar_subq(subquery_value_fn))
    kind = "semi" if sq.modifier == "in" else "anti"
    if isinstance(sq.lhs, ast.RowExpr):
        # (a, b) IN (SELECT x, y ...): one equality key per column
        if corr_pairs:
            raise PlanError("correlated row-value IN not supported")
        if sq.modifier == "not in":
            # row-value NOT IN needs per-column 3-valued NULL handling
            # the multi-key anti join can't express — refuse rather
            # than silently dropping NULL semantics
            raise PlanError(
                "row-value NOT IN is not supported (rewrite as NOT EXISTS)"
            )
        ncols = len(sq.lhs.items)
        if len(inner.schema.cols) != ncols + len(extra):
            raise PlanError("row-value IN subquery arity mismatch")
        keys = [
            (ob.bind(le), ColumnRef(type=c.type, name=c.internal))
            for le, c in zip(sq.lhs.items, inner.schema.cols[:ncols])
        ]
        res = _bind_residuals(
            plan.schema, inner.schema, residuals, subquery_value_fn
        )
        # NOT IN was rejected above: this is always a plain semi join
        return JoinPlan(plan.schema, "semi", plan, inner, keys, res)
    if len(inner.schema.cols) != 1 + len(corr_pairs) + len(extra):
        raise PlanError("IN subquery must select exactly one column")
    lhs_bound = ob.bind(sq.lhs)
    rhs_col = inner.schema.cols[0]
    keys = [(lhs_bound, ColumnRef(type=rhs_col.type, name=rhs_col.internal))]
    keys += _bind_corr_keys(ob, corr_pairs, inner.schema.cols[1 : 1 + len(corr_pairs)])
    res = _bind_residuals(plan.schema, inner.schema, residuals, subquery_value_fn)
    return JoinPlan(
        plan.schema,
        kind,
        plan,
        inner,
        keys,
        res,
        null_aware=(sq.modifier == "not in"),
    )


def _attach_corr_scalar(b, plan, sq, subquery_value_fn, catalog, db):
    """Correlated aggregate scalar subquery -> left join onto the
    grouped-by-correlation-keys derived table. Returns (joined plan,
    replacement ast) — the caller decides whether the value feeds a
    predicate (WHERE) or a projection (value position)."""
    q = sq.query
    _check_simple_subquery(q, "scalar")
    if len(q.items) != 1:
        raise PlanError("scalar subquery must select exactly one column")
    if not _has_agg(q.items[0].expr):
        raise PlanError(
            "correlated scalar subquery must aggregate (else it can "
            "return multiple rows per outer row)"
        )
    corr_pairs, kept, residuals, _extra = _corr_split(q, plan.schema, b)
    if not corr_pairs:
        raise PlanError("correlated scalar subquery has no correlation keys")
    if residuals:
        raise PlanError(
            "correlated scalar subquery supports only equality correlation"
        )
    n = b._dsq_counter
    b._dsq_counter += 1
    ck = [f"_dsq{n}_ck{i}" for i in range(len(corr_pairs))]
    sv = f"_dsq{n}_v"
    derived = ast.Select(
        items=[
            ast.SelectItem(ie, alias=ck[i])
            for i, (_oe, ie) in enumerate(corr_pairs)
        ]
        + [ast.SelectItem(q.items[0].expr, alias=sv)],
        from_=q.from_,
        where=kept,
        group_by=[ie for (_oe, ie) in corr_pairs],
    )
    inner = build_query(derived, catalog, db, subquery_value_fn, b.ctes)
    ob = ExprBinder(plan.schema, _scalar_subq(subquery_value_fn))
    keys = _bind_corr_keys(ob, corr_pairs, inner.schema.cols)
    joined = Schema(list(plan.schema.cols) + list(inner.schema.cols))
    jp = JoinPlan(joined, "left", plan, inner, keys, None)
    # An outer row with no matching group sees the aggregate's
    # empty-group value: NULL for most, but COUNT-driven expressions
    # fold to a non-NULL constant (count()=0) which the left join's NULL
    # must be coalesced to. Safe because such expressions are also
    # never NULL for matching groups.
    ref: object = ast.Name(None, sv)
    empty_v = _empty_group_value(q.items[0].expr)
    if empty_v is not None:
        ref = ast.Call("coalesce", [ref, ast.Const(empty_v)])
    return jp, ref


def _decorrelate_scalar(b, plan, conjunct, subquery_value_fn, catalog, db):
    """``expr CMP (SELECT agg(...) FROM t WHERE t.k = outer.k)`` ->
    left join onto ``SELECT k, agg(...) FROM t GROUP BY k`` and rewrite
    the comparison against the joined value column (reference:
    decorrelateSolver's agg-pull-up, logical Apply -> join conversion).

    An outer row with no matching group sees NULL (COUNT sees 0), which
    matches MySQL's empty-scalar-subquery semantics."""
    subqs = [
        s
        for s in _scalar_subqs_in(conjunct, [])
        if _is_correlated(s.query, plan.schema, b)
    ]
    if len(subqs) != 1:
        raise PlanError("only one correlated scalar subquery per predicate")
    sq = subqs[0]
    orig_schema = plan.schema
    jp, ref = _attach_corr_scalar(b, plan, sq, subquery_value_fn, catalog, db)
    new_pred = _replace_node(conjunct, sq, ref)
    jb = ExprBinder(jp.schema, _scalar_subq(subquery_value_fn))
    sel = Selection(jp.schema, jp, jb.bind(new_pred))
    return Projection(
        orig_schema,
        sel,
        [(c.internal, ColumnRef(type=c.type, name=c.internal)) for c in orig_schema],
    )


def _rewrite_aggs(e, rewrite: Dict):
    """Replace AggCall / WindowCall / group-expr subtrees with references
    to their computed output columns."""
    key = _ast_key(e)
    if key in rewrite:
        name, typ = rewrite[key]
        return ast.Name(None, name)
    if isinstance(e, ast.Call):
        if e.op == "grouping":
            raise PlanError(
                "GROUPING() requires GROUP BY ... WITH ROLLUP and its "
                "argument must be a single group-key expression"
            )
        return ast.Call(e.op, [_rewrite_aggs(a, rewrite) for a in e.args], e.cast_type)
    if isinstance(e, ast.AggCall):
        raise PlanError("aggregate expression not in rewrite map (nested aggs?)")
    if isinstance(e, ast.WindowCall):
        raise PlanError("window expression not in rewrite map")
    return e


def _build_windows(plan, win_calls: List[ast.WindowCall], rewrite: Dict) -> LogicalPlan:
    """Insert one Window node per distinct OVER spec; register outputs in
    the rewrite map (reference: logical window building in
    logical_plan_builder.go buildWindowFunctions)."""
    from tidb_tpu_torch.dtypes import FLOAT64, INT64

    specs: Dict[str, Tuple[ast.WindowCall, List[ast.WindowCall]]] = {}
    order: List[str] = []
    for call in win_calls:
        key = _ast_key(call)
        if key in rewrite:
            continue
        spec_key = repr(call.partition_by) + "||" + repr(call.order_by)
        if spec_key not in specs:
            specs[spec_key] = (call, [])
            order.append(spec_key)
        specs[spec_key][1].append(call)

    widx = 0
    for spec_key in order:
        proto, calls = specs[spec_key]
        binder = ExprBinder(plan.schema)

        def lower(e):
            e2 = _rewrite_aggs(e, rewrite) if rewrite else e
            return binder.bind(e2)

        part_exprs = [lower(p) for p in proto.partition_by]
        order_exprs = [(lower(oi.expr), oi.desc) for oi in proto.order_by]
        running = bool(proto.order_by)
        descs: List[Tuple[str, str, Optional[Expr], int, bool]] = []
        new_cols = list(plan.schema.cols)
        for call in calls:
            key = _ast_key(call)
            if key in rewrite:
                continue
            name = f"_w{widx}"
            widx += 1
            arg = lower(call.arg) if call.arg is not None else None
            if call.func in ("row_number", "rank", "dense_rank", "count", "ntile"):
                t = INT64
            elif call.func in ("avg", "percent_rank", "cume_dist"):
                t = FLOAT64
            elif call.func in (
                "sum", "min", "max", "lag", "lead",
                "first_value", "last_value", "nth_value",
            ):
                if arg is None:
                    raise PlanError(f"{call.func} window needs an argument")
                t = arg.type
            else:
                raise PlanError(f"unsupported window function {call.func}")
            if call.func in (
                "row_number", "rank", "dense_rank", "ntile",
                "percent_rank", "cume_dist",
            ) and not proto.order_by:
                raise PlanError(f"{call.func}() requires ORDER BY in its OVER clause")
            frame = call.frame
            call_running = running
            if (
                frame is not None
                and len(frame) == 3
                and frame[0] == "range"
                and call.func in ("sum", "avg", "count")
            ):
                frame = _encode_range_frame(call, frame, order_exprs)
            if frame is not None:
                if call.func in (
                    "row_number", "rank", "dense_rank", "lag", "lead",
                    "ntile", "percent_rank", "cume_dist",
                ):
                    frame = None  # frame clause is ignored for ranking funcs
                elif call.func in ("first_value", "last_value", "nth_value"):
                    raise PlanError(
                        f"{call.func} with an explicit frame is not "
                        "supported (default framing only)"
                    )
                elif frame == (None, 0):
                    frame, call_running = None, True  # running aggregate
                elif frame == (None, None):
                    frame, call_running = None, False  # whole partition
                elif call.func in ("min", "max"):
                    raise PlanError(
                        "MIN/MAX window frames support only UNBOUNDED "
                        "PRECEDING starts"
                    )
            descs.append((name, call.func, arg, call.offset, call_running, frame))
            rewrite[key] = (name, t)
            new_cols.append(OutCol(None, name, name, t))
        plan = Window(Schema(new_cols), plan, part_exprs, order_exprs, descs)
    return plan


def _encode_range_frame(call, frame, order_exprs):
    """Resolve a parsed RANGE frame against the (single) ORDER BY key:
    numeric offsets scale to the key's physical encoding (DECIMAL scaled
    ints), INTERVAL offsets to days (DATE) or micros (DATETIME/TIME).
    Variable-length units (MONTH/YEAR) are rejected — their width
    depends on the anchor date. Reference: pkg/executor/window.go range
    frame bound evaluation."""
    if call.func not in ("sum", "avg", "count"):
        raise PlanError(
            "RANGE offset frames support SUM/AVG/COUNT aggregates"
        )
    if len(order_exprs) != 1:
        raise PlanError("RANGE offset frames need exactly one ORDER BY key")
    ktype = order_exprs[0][0].type
    if ktype is None:
        raise PlanError("RANGE frame ORDER BY key has no type")

    _US = {
        "microsecond": 1, "second": 1_000_000, "minute": 60_000_000,
        "hour": 3_600_000_000, "day": 86_400_000_000,
        "week": 7 * 86_400_000_000,
    }

    def enc(bound):
        if bound is None or bound == "cur":
            return bound
        tag = bound[0]
        if tag == "num":
            v = float(bound[1])
            if ktype.kind == Kind.DECIMAL:
                return v * 10**ktype.scale
            if ktype.kind in (Kind.INT, Kind.FLOAT):
                return v
            if ktype.kind == Kind.DATE:
                return v  # bare N over a DATE key counts days (MySQL)
            raise PlanError(
                "numeric RANGE offsets need a numeric ORDER BY key"
            )
        _i, n, unit = bound
        if unit not in _US:
            raise PlanError(
                f"RANGE INTERVAL unit {unit!r} is variable-length; "
                "use DAY or smaller"
            )
        if ktype.kind == Kind.DATE:
            if unit not in ("day", "week"):
                raise PlanError("DATE keys take DAY/WEEK RANGE offsets")
            return float(n * (1 if unit == "day" else 7))
        if ktype.kind in (Kind.DATETIME, Kind.TIME):
            return float(n * _US[unit])
        raise PlanError("INTERVAL offsets need a temporal ORDER BY key")

    return ("range", enc(frame[1]), enc(frame[2]))


def _ast_key(e) -> str:
    return repr(e)


def _build_aggregate(b, plan, group_by, agg_calls, rollup=False):
    """Insert Aggregate node; return (plan, rewrite map ast-key ->
    (output internal name, type)). rollup=True (GROUP BY ... WITH
    ROLLUP, reference: pkg/planner/core expand for rollup /
    pkg/executor with TiFlash Expand): the result is the UNION ALL of
    the full grouping plus every group-key prefix, dropped keys
    presented as NULL — each level aggregates the base input
    independently, which is exact for every supported aggregate and
    lets common-subtree sharing compile the shared scan once."""
    binder = ExprBinder(plan.schema)
    rewrite: Dict[str, Tuple[str, SQLType]] = {}
    group_exprs: List[Tuple[str, Expr]] = []
    for i, g in enumerate(group_by):
        bound = binder.bind(g)
        name = f"_g{i}"
        group_exprs.append((name, bound))
        rewrite[_ast_key(g)] = (name, bound.type)

    aggs: List[Tuple[str, str, Optional[Expr], bool]] = []
    seen: Dict[str, str] = {}
    gc_meta: Dict[str, Tuple[str, tuple]] = {}
    from tidb_tpu_torch.dtypes import FLOAT64, DECIMAL, STRING

    for call in agg_calls:
        key = _ast_key(call)
        if key in rewrite:
            continue
        name = f"_a{len(aggs)}"
        arg = binder.bind(call.arg) if call.arg is not None else None
        if call.func == "count":
            t = INT64
        elif call.func == "avg":
            t = FLOAT64
        elif call.func in ("min", "max", "sum", "first"):
            t = arg.type
            if call.func == "sum" and t is not None and t.kind == Kind.BOOL:
                t = INT64  # MySQL: SUM over booleans counts (0/1 ints)
        elif call.func in (
            "group_concat", "json_arrayagg", "json_objectagg"
        ):
            # string-producing aggregates run host-assisted (hostagg.py);
            # json_objectagg carries its KEY expression in the order-by
            # slot (projected alongside, marker separator selects the
            # rendering)
            t = STRING
            gc_meta[name] = (
                call.separator,
                tuple((binder.bind(e), d) for e, d in call.order_by),
            )
        else:
            raise PlanError(f"unsupported aggregate {call.func}")
        aggs.append((name, call.func, arg, call.distinct))
        rewrite[key] = (name, t)

    out_cols = [OutCol(None, n, n, e.type) for n, e in group_exprs]
    for (n, f, a, d) in aggs:
        t = next(t for (nn, t) in rewrite.values() if nn == n)
        out_cols.append(OutCol(None, n, n, t))

    if gc_meta:
        # GROUP_CONCAT runs host-assisted (hostagg.py) which computes
        # every aggregate of the node in one pass — DISTINCT included, so
        # no stacked rewrite
        agg_plan = Aggregate(
            Schema(out_cols), plan, group_exprs, aggs, gc_meta=gc_meta
        )
    elif any(d for (_n, _f, _a, d) in aggs):
        d_args = {repr(a) for (_n, _f, a, d) in aggs if d}
        if len(d_args) > 1:
            # multiple different DISTINCT arguments: the stacked-rewrite
            # trick needs one shared dedup key, so fall through to the
            # kernel's per-agg representative-row dedup
            # (executor/aggregate._distinct_reps)
            agg_plan = Aggregate(Schema(out_cols), plan, group_exprs, aggs)
        else:
            agg_plan = _expand_distinct_aggs(plan, group_exprs, aggs, out_cols)
    else:
        agg_plan = Aggregate(Schema(out_cols), plan, group_exprs, aggs)
    if rollup and group_exprs:
        k = len(group_exprs)
        gnames = {n for n, _g in group_exprs}
        agg_refs = [
            (c.internal, ColumnRef(type=c.type, name=c.internal))
            for c in agg_plan.schema.cols
            if c.internal not in gnames
        ]
        # GROUPING(g): 1 on levels where g was rolled away, 0 where it
        # grouped — a per-child CONSTANT lane, referenced via the
        # rewrite map (reference: GROUPING under rollup expand)
        grp_cols = [
            OutCol(None, f"_grp{i}", f"_grp{i}", INT64) for i in range(k)
        ]
        u_schema = Schema(list(agg_plan.schema.cols) + grp_cols)
        for i, g_ast in enumerate(group_by):
            rewrite[_ast_key(ast.Call("grouping", [g_ast]))] = (
                f"_grp{i}", INT64,
            )

        def grp_lits(level):
            return [
                (
                    f"_grp{i}",
                    Literal(type=INT64, value=0 if i < level else 1),
                )
                for i in range(k)
            ]

        full_exprs = [
            (c.internal, ColumnRef(type=c.type, name=c.internal))
            for c in agg_plan.schema.cols
        ]
        children = [
            Projection(u_schema, agg_plan, full_exprs + grp_lits(k))
        ]
        for j in range(k - 1, -1, -1):
            # the grand-total level grouped by NOTHING would emit one
            # row even over empty input (scalar-aggregate semantics);
            # MySQL returns an empty set for rollup over no rows, so
            # group by a constant instead — zero groups when empty
            sub_groups = group_by[:j] if j else [ast.Const(1)]
            sub, _ = _build_aggregate(b, plan, sub_groups, agg_calls)
            exprs = []
            for i, (n, g) in enumerate(group_exprs):
                exprs.append((
                    n,
                    ColumnRef(type=g.type, name=n)
                    if i < j
                    else Literal(type=g.type, value=None),
                ))
            children.append(
                Projection(u_schema, sub, exprs + agg_refs + grp_lits(j))
            )
        agg_plan = UnionAll(u_schema, children)
    return agg_plan, rewrite


def _expand_distinct_aggs(plan, group_exprs, aggs, out_cols):
    """Rewrite Aggregate-with-DISTINCT into two stacked Aggregates:
    inner groups by (keys, distinct arg) — collapsing duplicates — and
    pre-aggregates the non-distinct functions; the outer re-aggregates.
    The reference evaluates DISTINCT inside each agg function's update
    path (pkg/executor/aggfuncs count_distinct); on TPU a second grouped
    pass is one more fused XLA reduction, so the rewrite is free of
    per-row set probes and reuses the scatter-free group-by kernels.
    """
    from tidb_tpu_torch.dtypes import FLOAT64
    from tidb_tpu_torch.expression.expr import ColumnRef

    d_args = {}
    for (_n, _f, a, d) in aggs:
        if d:
            d_args[repr(a)] = a
    assert len(d_args) == 1, "multi-distinct handled by the kernel path"
    dx = next(iter(d_args.values()))
    dname = "_dx"

    inner_groups = list(group_exprs) + [(dname, dx)]
    inner_aggs: List[Tuple[str, str, Optional[Expr], bool]] = []
    final_aggs: List[Tuple[str, str, Optional[Expr], bool]] = []
    # (out name, Σsum col, Σcount col, arg type) for non-distinct AVGs:
    # re-assembled as a division in a Projection above the outer agg
    avg_fixups: List[Tuple[str, str, str, SQLType]] = []
    for (name, func, arg, d) in aggs:
        if d:
            # duplicates are collapsed by the inner group-by; COUNT/SUM/AVG
            # over the (now unique, NULL-preserving) _dx column give the
            # DISTINCT semantics, NULLs skipped by the agg kernels.
            final_aggs.append((name, func, ColumnRef(dx.type, dname), False))
            continue
        pn = f"_p{len(inner_aggs)}"
        if func == "count":
            inner_aggs.append((pn, "count", arg, False))
            final_aggs.append((name, "sum", ColumnRef(INT64, pn), False))
        elif func in ("sum", "min", "max"):
            inner_aggs.append((pn, func, arg, False))
            final_aggs.append((name, func, ColumnRef(arg.type, pn), False))
        elif func == "avg":
            # AVG across the two stacked aggregates = Σ(partial sums) /
            # Σ(partial counts); the division happens in a Projection on
            # top (the reference's partial/final avg split,
            # pkg/executor/aggfuncs avg partial result)
            cn = f"_p{len(inner_aggs) + 1}"
            inner_aggs.append((pn, "sum", arg, False))
            inner_aggs.append((cn, "count", arg, False))
            fs, fc = f"_fs{name}", f"_fc{name}"
            final_aggs.append((fs, "sum", ColumnRef(arg.type, pn), False))
            final_aggs.append((fc, "sum", ColumnRef(INT64, cn), False))
            avg_fixups.append((name, fs, fc, arg.type))
        else:
            raise PlanError(
                f"{func.upper()} cannot be combined with DISTINCT aggregates"
            )

    inner_cols = [OutCol(None, n, n, e.type) for n, e in inner_groups]
    for (pn, f, a, _d) in inner_aggs:
        t = INT64 if f == "count" else a.type
        inner_cols.append(OutCol(None, pn, pn, t))
    inner = Aggregate(Schema(inner_cols), plan, inner_groups, inner_aggs)

    final_groups = [(n, ColumnRef(e.type, n)) for n, e in group_exprs]
    if not avg_fixups:
        return Aggregate(Schema(out_cols), inner, final_groups, final_aggs)

    outer_cols = [OutCol(None, n, n, e.type) for n, e in final_groups]
    for (n, f, a, _d) in final_aggs:
        t = INT64 if f == "count" else a.type
        outer_cols.append(OutCol(None, n, n, t))
    outer = Aggregate(Schema(outer_cols), inner, final_groups, final_aggs)

    fix = {name: (fs, fc, t) for name, fs, fc, t in avg_fixups}
    proj_exprs: List[Tuple[str, Expr]] = []
    for oc in out_cols:
        if oc.name in fix:
            fs, fc, at = fix[oc.name]
            proj_exprs.append(
                (
                    oc.name,
                    Func(
                        type=FLOAT64,
                        op="div",
                        args=(ColumnRef(at, fs), ColumnRef(INT64, fc)),
                    ),
                )
            )
        else:
            proj_exprs.append((oc.name, ColumnRef(oc.type, oc.name)))
    return Projection(Schema(out_cols), outer, proj_exprs)
