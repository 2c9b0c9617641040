"""Session: SQL text in, rows out.

Counterpart of tidb_tpu/session/session.py for two statement kinds: a
SELECT over stored tables and ANALYZE TABLE. ``execute`` parses, plans
(``build_query``), runs the plan on the session's device and
materializes rows, as the JAX session's ``_run_select`` does, and
returns the same ``Result``; a full ORDER BY too large for the device
is ordered in host RAM instead (``_try_host_sorted``). An uncorrelated
scalar subquery runs first, as a statement of its own, and enters the
plan as a literal. ANALYZE
stores per-column statistics that the planner's join ordering reads.
Other statements (DDL, DML, SET, FROM-less SELECT) and the MySQL server
belong to later slices and raise ``NotImplementedError``.

The session runs on CUDA unless the caller passes ``device="cpu"``; with
no card present, CUDA raises instead of moving to the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

from tidb_tpu_torch.chunk import (
    HostBlock,
    HostColumn,
    block_to_rows,
    materialize_rows,
    resolve_device,
)
from tidb_tpu_torch.dtypes import (
    Kind,
    SQLType,
    date_to_days,
    datetime_to_micros,
    time_to_micros,
)
from tidb_tpu_torch.expression.expr import Literal
from tidb_tpu_torch.parser import ast, parse
from tidb_tpu_torch.planner import build_query
from tidb_tpu_torch.planner.physical import PhysicalExecutor, StaleWidthsError
from tidb_tpu_torch.planner.streamed import try_streamed_sort
from tidb_tpu_torch.stats import analyze_table
from tidb_tpu_torch.storage import Catalog


@dataclasses.dataclass
class Result:
    columns: List[str]
    rows: List[Tuple]
    affected: int = 0
    elapsed_s: float = 0.0
    types: Optional[List[SQLType]] = None  # per-column, for wire encoding

    def sorted(self) -> List[Tuple]:
        return sorted(self.rows, key=lambda r: tuple((v is None, str(v)) for v in r))


class Session:
    def __init__(self, catalog: Optional[Catalog] = None, db: str = "test", device=None):
        self.catalog = catalog if catalog is not None else Catalog()
        self.db = db
        self.device = resolve_device(device)
        self.executor = PhysicalExecutor(self.catalog, device=self.device)

    def execute(self, sql: str) -> Result:
        res = Result([], [])
        for s in parse(sql):
            t0 = time.perf_counter()
            res = self._execute_stmt(s)
            res.elapsed_s = time.perf_counter() - t0
        return res

    def _execute_stmt(self, s) -> Result:
        if isinstance(s, ast.Select) and s.from_ is None:
            raise NotImplementedError("SELECT without FROM is not ported yet")
        if isinstance(s, (ast.Select, ast.Union, ast.With, ast.SetOp)):
            return self._run_select(s)
        if isinstance(s, ast.AnalyzeTable):
            analyze_table(self.catalog.table(s.db or self.db, s.name), device=self.device)
            return Result([], [])
        raise NotImplementedError(f"{type(s).__name__} statements are not ported yet")

    def _run_select(self, s, ctes=None) -> Result:
        plan = build_query(s, self.catalog, self.db, self._scalar_subquery, ctes)
        names = [c.name for c in plan.schema]
        rows = self._try_host_sorted(plan)
        if rows is None:
            batch, dicts = self.executor.run(plan)
            rows = materialize_rows(batch, list(plan.schema), dicts)
        return Result(names, rows, types=[c.type for c in plan.schema])

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
