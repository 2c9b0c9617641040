"""Physical compilation + execution of logical plans.

Counterpart of tidb_tpu/planner/physical.py. ``PlanCompiler`` lowers a
logical plan into one plan function ``fn(inputs, caps) -> (batch,
needs)`` over fixed-capacity tiles with ``row_valid`` masks, as the JAX
package does; ``PhysicalExecutor.run`` calls it eagerly on the device.

The JAX package needs a discovery pass and a pinned steady program
because XLA compiles one program per shape. Eager torch does not, so the
executor runs the plan function once with the capacity vector learned by
earlier runs of the same plan, reads the cardinality scalars and the
(compacted) output in ONE device->host fetch, and re-runs only when a
node overflowed its tile or a baked key width went stale. A warm run of
TPC-H Q1 therefore makes one fetch.

This slice compiles Scan, OneRow, Staged, Selection (with fused HAVING),
Projection, Aggregate, Join (cross, inner, left, semi, anti and mark),
Window, Sort, Limit, top-N (ORDER BY ... LIMIT) and UnionAll on one
device. With ``instrument=True`` every node is wrapped with a wall-time
and row-count probe: ``PhysicalExecutor.run_analyze`` is the engine side
of EXPLAIN ANALYZE. An aggregation whose input is too large for one tile
or for the device's free memory streams (``planner/streamed.py``) before the
compiled path is tried, and one holding a GROUP_CONCAT reduces on the host
(``planner/hostagg.py``). Keyed staged inputs, meshes and the plan-cache
sharing of the JAX package belong to later slices and raise
``NotImplementedError``.

Access paths: a Selection directly over a Scan whose predicate bounds the
one-column PRIMARY KEY or the leading column of a public index on both
sides narrows that scan to an index range (``ScanSite.pk_range``, the
narrowest one wins); an OR whose every disjunct is such a range narrows
it to their union (``ScanSite.merge_ranges``). The executor then gathers
only those rows on the host (``fetch_site_rows``) and copies that batch
to the device, past the scan cache; the predicate still filters it.

Partition pruning: a Selection over a Scan of a partitioned table keeps
the partitions its predicate can reach (``ScanSite.partitions``, from the
partition defs at the version the scan reads: ``_prune_partitions``), and
the scan copies only their blocks. A narrowed read searches the whole
table's index (its range lies inside the predicate), and a scan carrying
the row handle is never pruned.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tidb_tpu_torch.chunk import Batch, DevCol, fetch, pad_capacity, resolve_device
from tidb_tpu_torch.dtypes import Kind
from tidb_tpu_torch.executor.aggregate import WIDTH_STALE as _WIDTH_STALE
from tidb_tpu_torch.executor.aggregate import AggDesc, group_aggregate
from tidb_tpu_torch.executor.join import equi_join, lookup_build_rows
from tidb_tpu_torch.executor.project import compact, filter_batch
from tidb_tpu_torch.executor.sort import limit as limit_op
from tidb_tpu_torch.executor.sort import order_by
from tidb_tpu_torch.executor.window import WindowDesc, window_op
from tidb_tpu_torch.expression.expr import ColumnRef, Expr
from tidb_tpu_torch.expression.kernels import _DeviceLUT, compile_expr
from tidb_tpu_torch.obs.engine_watch import ENGINE_WATCH
from tidb_tpu_torch.obs.flight import FLIGHT
from tidb_tpu_torch.planner import logical as L
from tidb_tpu_torch.planner.logical import ROWID_NAME
from tidb_tpu_torch.storage.scan import scan_table
from tidb_tpu_torch.utils.failpoint import inject
from tidb_tpu_torch.utils.memtrack import MemoryTracker, QuotaExceeded, batch_bytes
from tidb_tpu_torch.utils.metrics import REGISTRY

Dicts = Dict[str, np.ndarray]
# node function: (inputs by scan id, caps by node id) -> (batch, needs dict)
PlanFn = Callable[[Dict[int, Batch], Dict[int, int]], Tuple[Batch, Dict[int, torch.Tensor]]]


class ExecError(RuntimeError):
    pass


class StaleWidthsError(RuntimeError):
    """A compiled plan's baked key-width bounds no longer cover the data.
    The executor recompiles the plan against fresh Table.col_bounds."""


# reserved dicts-map key prefix for integer-column value bounds (column
# names never contain NUL); see Table.col_bounds and _key_width
_BOUNDS_PREFIX = "\x00b\x00"
# reserved prefix marking a column as unique-valued (single-column PK /
# unique index at scan, GROUP BY key of a single-key aggregate). Joins
# use it to prove a 1:1 build side (dense unique join); it survives
# row-filtering operators and is stripped where rows can duplicate.
_UNIQ_PREFIX = "\x00u\x00"


def _strip_uniq(dicts: Dicts) -> Dicts:
    return {k: v for k, v in dicts.items() if not k.startswith(_UNIQ_PREFIX)}


def _merge_join_dicts(ldicts: Dicts, rdicts: Dicts, lu: bool, ru: bool) -> Dicts:
    """Join output dictionaries with SELECTIVE uniqueness survival: an
    inner join duplicates one side's rows only when the OTHER side's
    equi key repeats, so a provably-unique build key (ru for the left
    side's entries, lu for the right's) preserves that side's proofs.
    Keeps chained star joins (Q5's region->nation->supplier->lineitem)
    on the dense 1:1 path after the first hop."""
    out: Dicts = {}
    for k, v in ldicts.items():
        if k.startswith(_UNIQ_PREFIX) and not ru:
            continue
        out[k] = v
    for k, v in rdicts.items():
        if k.startswith(_UNIQ_PREFIX) and not lu:
            continue
        out[k] = v
    return out


class _LazyBounds:
    """Deferred Table.col_bounds lookup pinned to a (table, col, version):
    the min/max host pass only runs if a consumer needs the bounds."""

    __slots__ = ("table", "col", "version", "nid")

    def __init__(self, table, col, version, nid=None):
        self.table = table
        self.col = col
        self.version = version
        self.nid = nid

    def get(self):
        return self.table.col_bounds(self.col, self.version)


class _UnionBounds:
    """Bounds of a UNION ALL output column: the hull of its branches'
    bounds, resolved only if a consumer needs them. Every value of the
    column comes from one branch, so the hull holds it; consumers verify
    at run time, as with storage bounds."""

    __slots__ = ("entries",)

    def __init__(self, entries):
        self.entries = entries

    def get(self):
        bs = [_resolve_bounds(e) for e in self.entries]
        if any(b is None for b in bs):
            return None
        return (min(int(b[0]) for b in bs), max(int(b[1]) for b in bs))


def _resolve_bounds(entry):
    if entry is None:
        return None
    if isinstance(entry, (_LazyBounds, _UnionBounds)):
        return entry.get()
    return entry


def _stale_only(total):
    """Pass the WIDTH_STALE sentinel through a needs slot, 0 otherwise."""
    return torch.where(total >= _WIDTH_STALE, total, 0)


@dataclasses.dataclass
class ScanSite:
    node_id: int
    db: str
    table: str
    alias: str
    columns: List[str]
    # index range pushdown: (column, lo, hi) in raw encoded units; the
    # fetch gathers only the rows in range through the table's sorted
    # index instead of scanning it
    pk_range: Optional[Tuple[str, int, int]] = None
    # index merge (union): an OR of such ranges; the fetch gathers the
    # union of their rows once
    merge_ranges: Optional[Tuple[Tuple[str, int, int], ...]] = None
    # partition pruning: the partition ids the predicate can reach; None
    # scans every partition
    partitions: Optional[Tuple[int, ...]] = None

    @property
    def narrowed(self) -> bool:
        return self.pk_range is not None or self.merge_ranges is not None


@dataclasses.dataclass
class CompiledQuery:
    fn: PlanFn
    scans: List[ScanSite]
    default_caps: Dict[int, int]
    out_dicts: Dicts
    # (scan node id, column): validity folded into the row mask because
    # the column held no NULLs at compile time; re-checked at fetch
    nonnull: List[Tuple[int, str]] = dataclasses.field(default_factory=list)
    # (scan node id, column, lo, hi): bounds that proved a decimal SUM
    # safe for one int64 lane; re-checked at fetch
    bound_checks: List[Tuple[int, str, int, int]] = dataclasses.field(
        default_factory=list
    )
    # capacity vector learned by the last run (plus the output tile
    # under _OUT_NODE)
    caps: Optional[Dict[int, int]] = None
    # per ORDER BY ... LIMIT node, in build order: ("packed", total key
    # bits) or ("sorted", None)
    topn: List[Tuple[str, Optional[int]]] = dataclasses.field(default_factory=list)
    # bytes of one row of each sized node's output tile (joins,
    # aggregates, top-N sentinels, the output compaction): what quota
    # admission charges per unit of its capacity knob
    widths: Dict[int, int] = dataclasses.field(default_factory=dict)


def _schema_width(schema) -> int:
    """Bytes per row of a plan schema (data + validity per column, and
    the row mask)."""
    total = 1
    for c in schema:
        try:
            total += c.type.np_dtype.itemsize + 1
        except Exception:
            total += 9
    return total


# ---------------------------------------------------------------------------
# access paths (the JAX package's point get, IndexRangeScan and IndexMerge)
# ---------------------------------------------------------------------------


def _conjuncts(e, op: str = "and") -> list:
    from tidb_tpu_torch.expression.expr import Func

    if isinstance(e, Func) and e.op == op:
        return _conjuncts(e.args[0], op) + _conjuncts(e.args[1], op)
    return [e]


def _index_candidates(t) -> list:
    """Single-column access paths: the one-column PRIMARY KEY and the
    leading column of every public index."""
    candidates = []
    pk = t.schema.primary_key
    if pk and len(pk) == 1:
        candidates.append(pk[0])
    for icols in t.public_indexes().values():
        if icols and icols[0] not in candidates:
            candidates.append(icols[0])
    return candidates


def _prune_partitions(pred, scan: L.Scan, resolver):
    """The partition ids of `scan`'s table that `pred` can reach, or None
    (all of them): RANGE by comparing the predicate's range on the
    partition column with each partition's bounds, LIST by its values,
    HASH for a closed range narrower than the partition count. The defs
    are those at the version the scan reads."""
    if ROWID_NAME in scan.columns:
        return None  # row handles address the whole block concatenation
    try:
        t, v = resolver(scan.db, scan.table)
    except Exception:
        return None
    part = t.partition_defs_at(v)
    if part is None or pred is None:
        return None
    kind, pcol, spec = part
    r = _extract_col_range(pred, scan, t, pcol, open_ok=True)
    if r is None:
        return None
    _col, lo, hi = r
    if lo is not None and hi is not None and lo > hi:
        return ()
    if kind == "list":
        keep = tuple(i for i, (_n, vals) in enumerate(spec) if any(
            v is not None and (lo is None or v >= lo) and (hi is None or v <= hi)
            for v in vals))
        return None if len(keep) == len(spec) else keep
    if kind == "hash":
        n = int(spec)
        if lo is None or hi is None or hi - lo + 1 >= n:
            return None
        return tuple(sorted({(x % n + n) % n for x in range(lo, hi + 1)}))
    keep, lower = [], None
    for i, (_n, u) in enumerate(spec):
        # partition i holds [lower, u)
        if (lo is None or u is None or lo <= u - 1) and (hi is None or lower is None or hi >= lower):
            keep.append(i)
        lower = u
    return None if len(keep) == len(spec) else tuple(keep)


def partition_label(t, version, parts) -> str:
    """EXPLAIN's ``partitions=[...]`` of a pruned scan, by name."""
    names = t.partition_names(version)
    return " partitions=[" + ",".join(names[i] for i in parts) + "]"


def _extract_pk_range(pred, scan: L.Scan, resolver):
    """(column, lo, hi) in raw encoded units over the best access path:
    a candidate column bounded on both sides by the predicate's
    conjuncts; the narrowest range wins. A scan carrying the row handle
    is never narrowed (its handles address the full scan)."""
    if ROWID_NAME in scan.columns:
        return None
    try:
        t, _v = resolver(scan.db, scan.table)
    except Exception:
        return None
    best = None
    for col in _index_candidates(t):
        r = _extract_col_range(pred, scan, t, col)
        if r is not None and (best is None or r[2] - r[1] < best[0]):
            best = (r[2] - r[1], r)
    return best[1] if best else None


def _extract_index_merge(pred, scan: L.Scan, resolver):
    """An OR conjunct whose every disjunct is a range over a candidate
    column -> the tuple of those ranges, whose union covers every row the
    predicate accepts (open sides take the int64 extremes). None when any
    disjunct is not such a range."""
    if ROWID_NAME in scan.columns:
        return None
    try:
        t, _v = resolver(scan.db, scan.table)
    except Exception:
        return None
    candidates = _index_candidates(t)
    if not candidates:
        return None
    for c in _conjuncts(pred):
        ds = _conjuncts(c, "or")
        if len(ds) < 2:
            continue
        ranges = []
        for d in ds:
            best = None
            for col in candidates:
                r = _extract_col_range(d, scan, t, col, open_ok=True)
                if r is not None:
                    col_, lo, hi = r
                    lo = -(1 << 63) if lo is None else lo
                    hi = (1 << 63) - 1 if hi is None else hi
                    if best is None or hi - lo < best[0]:
                        best = (hi - lo, (col_, lo, hi))
            if best is None:
                ranges = None
                break
            ranges.append(best[1])
        if ranges:
            return tuple(ranges)
    return None


def _extract_col_range(pred, scan: L.Scan, t, pkcol: str, open_ok: bool = False):
    """The range the predicate's conjuncts put on `pkcol` (INT, DATE,
    DECIMAL or DATETIME) as (col, lo, hi) in raw encoded units, from
    comparisons and BETWEEN against literals; a side left open is None
    (allowed only with `open_ok`). Each bound is computed exactly, so the
    range holds every row the predicate accepts (the predicate still
    filters the rows the range fetches)."""
    import math
    from fractions import Fraction

    from tidb_tpu_torch.dtypes import date_to_days, datetime_to_micros
    from tidb_tpu_torch.expression.expr import Func, Literal

    typ = t.schema.types.get(pkcol)
    if typ is None or typ.kind not in (Kind.INT, Kind.DATE, Kind.DECIMAL, Kind.DATETIME):
        return None
    internal = f"{scan.alias}.{pkcol}"
    day_micros = 86_400_000_000

    def scaled(lit):
        """A literal's value in the column's raw encoded units, as
        (exact Fraction, slack): a double literal compares in doubles, so
        its bounds widen by its rounding error plus one unit. None where
        the literal's kind does not compare with the column's by value
        (a string, a number against a date)."""
        v, lk = lit.value, lit.type.kind if lit.type is not None else None
        if v is None or isinstance(v, bool):
            return None
        try:
            if typ.kind in (Kind.DATE, Kind.DATETIME):
                if lk == Kind.DATE:
                    x = Fraction(int(date_to_days(v) if isinstance(v, str) else v)) * day_micros
                elif lk == Kind.DATETIME:
                    x = Fraction(int(datetime_to_micros(v) if isinstance(v, str) else v))
                else:
                    return None
                return (x / day_micros if typ.kind == Kind.DATE else x), 0
            unit = 10**typ.scale if typ.kind == Kind.DECIMAL else 1
            if lk == Kind.INT and isinstance(v, int):
                return Fraction(v) * unit, 0
            if lk == Kind.DECIMAL and isinstance(v, (int, float)):
                # the literal's own encoding, as the expression compiles it
                return Fraction(round(float(v) * 10**lit.type.scale), 10**lit.type.scale) * unit, 0
            if lk == Kind.FLOAT and isinstance(v, (int, float)) and math.isfinite(v):
                x = Fraction(v) * unit
                return x, abs(x) * Fraction(1, 1 << 50) + 1
        except (ValueError, OverflowError):
            return None
        return None

    def bound_hi(x, strict):
        return math.ceil(x) - 1 if strict else math.floor(x)

    def bound_lo(x, strict):
        return math.floor(x) + 1 if strict else math.ceil(x)

    def tighten(lo_, hi_):
        nonlocal lo, hi
        if lo_ is not None:
            lo = lo_ if lo is None else max(lo, lo_)
        if hi_ is not None:
            hi = hi_ if hi is None else min(hi, hi_)

    lo = hi = None
    flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}
    for c in _conjuncts(pred):
        if not (isinstance(c, Func) and len(c.args) >= 2):
            continue
        op, a, b = c.op, c.args[0], c.args[1]
        if op == "between" and len(c.args) == 3:
            if (isinstance(a, ColumnRef) and a.name == internal
                    and isinstance(c.args[1], Literal) and isinstance(c.args[2], Literal)):
                x, y = scaled(c.args[1]), scaled(c.args[2])
                if x is not None and y is not None:
                    tighten(bound_lo(x[0] - x[1], False), bound_hi(y[0] + y[1], False))
            continue
        if op not in flip:
            continue
        if isinstance(a, ColumnRef) and a.name == internal and isinstance(b, Literal):
            pass
        elif isinstance(b, ColumnRef) and b.name == internal and isinstance(a, Literal):
            a, b, op = b, a, flip[op]
        else:
            continue
        xs = scaled(b)
        if xs is None:
            continue
        x, slack = xs
        if op == "eq" and not slack and x.denominator != 1:
            return (pkcol, 1, 0)  # no encoded value equals x: an empty range
        if op == "eq":
            tighten(bound_lo(x - slack, False), bound_hi(x + slack, False))
        elif op in ("lt", "le"):
            tighten(None, bound_hi(x + slack, op == "lt" and not slack))
        else:
            tighten(bound_lo(x - slack, op == "gt" and not slack), None)
    if not open_ok and (lo is None or hi is None):
        return None
    if lo is None and hi is None:
        return None
    return (pkcol, lo, hi)


#: narrowed fetches: reads, rows gathered and the host seconds of the
#: index search and the gather (the sort is ``table.INDEX_SORTS``);
#: their host->device bytes count in ``chunk.TRANSFERS``. ``declined``
#: counts ranges read by a full scan instead (``_narrow_pays``).
NARROWED = {"reads": 0, "rows": 0, "seconds": 0.0, "declined": 0}
#: the share of a table's rows past which a range is read by a full scan:
#: when the scan cache holds the site's columns (a full scan then copies
#: nothing and filters on the device, while a narrowed read gathers its
#: rows on the host and copies them), and when it does not (the full scan
#: copies the columns once and caches them for the next read)
NARROW_SHARE_CACHED = 1 / 64
NARROW_SHARE_UNCACHED = 1 / 2


def _narrow_pays(t, site: ScanSite, version: int, device, selected: int) -> bool:
    """Whether reading `selected` rows of the range (of a union, the sum
    of its ranges') beats a full scan (of the kept partitions)."""
    from tidb_tpu_torch.storage.scan import ROW_MASK, is_cached

    n = sum(b.nrows for b in t.blocks(version, partitions=site.partitions))
    cap, dev = pad_capacity(n), str(resolve_device(device))
    cached = all(is_cached(t, version, c, cap, dev, site.partitions)
                 for c in (*site.columns, ROW_MASK))
    return selected <= n * (NARROW_SHARE_CACHED if cached else NARROW_SHARE_UNCACHED)


def fetch_site_rows(t, site: ScanSite, version: int, device):
    """A narrowed scan site's batch: the rows of its index range, or of
    the union of its merge ranges, gathered on the host and copied to the
    device; None for a site that scans its whole table, and for a range
    that selects too many rows to pay (``_narrow_pays``). It bypasses the
    scan cache, so a range never evicts the table's whole columns nor
    serves another range."""
    from tidb_tpu_torch.chunk import block_to_batch
    from tidb_tpu_torch.storage.table import INDEX_SORTS

    if not site.narrowed:
        return None
    t0, sort0 = time.perf_counter(), INDEX_SORTS["seconds"]
    ranges = (site.pk_range,) if site.pk_range is not None else site.merge_ranges
    # the union's size is at most the sum of its ranges': decide before
    # gathering any position
    selected = sum(t.range_count(col, lo, hi, version=version) for col, lo, hi in ranges)
    if not _narrow_pays(t, site, version, device, selected):
        NARROWED["declined"] += 1
        return None
    if site.pk_range is not None:
        col, lo, hi = site.pk_range
        idx = t.range_rows(col, lo, hi, version=version)
    else:
        idx = np.unique(np.concatenate(
            [t.range_rows(col, lo, hi, version=version) for col, lo, hi in ranges]))
    block = t.gather_rows(idx, site.columns, version=version)
    NARROWED["reads"] += 1
    NARROWED["rows"] += len(idx)
    NARROWED["seconds"] += time.perf_counter() - t0 - (INDEX_SORTS["seconds"] - sort0)
    return block_to_batch(block, device=device)


def plan_fingerprint(plan: L.LogicalPlan) -> str:
    """Deterministic structural key for the plan cache."""
    parts: List[str] = []

    def walk(p):
        parts.append(type(p).__name__)
        if isinstance(p, L.Scan):
            parts.append(f"{p.db}.{p.table} as {p.alias} {sorted(p.columns)}")
        elif isinstance(p, L.Selection):
            parts.append(repr(p.predicate))
        elif isinstance(p, L.Projection):
            parts.append(repr(p.exprs) + str(p.additive))
        elif isinstance(p, L.Aggregate):
            parts.append(repr(p.group_exprs) + repr(p.aggs))
        elif isinstance(p, L.JoinPlan):
            parts.append(
                p.kind
                + repr(p.equi_keys)
                + repr(p.residual)
                + str(p.null_aware)
                + str(p.broadcast)
                + str(getattr(p, "mark_name", None))
            )
        elif isinstance(p, L.Sort):
            parts.append(repr(p.keys))
        elif isinstance(p, L.Window):
            parts.append(
                repr(p.partition_exprs) + repr(p.order_exprs) + repr(p.descs)
            )
        elif isinstance(p, L.Limit):
            parts.append(f"{p.count},{p.offset}")
        elif isinstance(p, L.Staged):
            # the batch is baked into the compiled closure: the nonce keeps
            # two batches from sharing one cache entry
            parts.append(f"staged#{p.nonce}")
        kids = _plan_children(p)
        parts.append(f"#{len(kids)}")
        for c in kids:
            walk(c)

    walk(plan)
    return "|".join(parts)


def _plan_children(p) -> List[L.LogicalPlan]:
    out = []
    for attr in ("child", "left", "right"):
        c = getattr(p, attr, None)
        if c is not None:
            out.append(c)
    out.extend(getattr(p, "children", []) or [])
    return out


def _expr_abs_bound(e: Expr, dicts: Dicts):
    """Max-abs of an expression's SCALED integer representation via
    interval arithmetic over storage column bounds, or None (unbounded /
    unsupported shape). Returns (bound, [contributing _LazyBounds]).
    Sound only while every referenced column stays inside its
    compile-time bounds — callers must register a fetch-time re-check
    for each returned entry (CompiledQuery.bound_checks)."""
    import math

    from tidb_tpu_torch.expression.expr import Func, Literal

    kind = e.type.kind if e.type is not None else None
    if kind not in (Kind.INT, Kind.DECIMAL, Kind.BOOL):
        return None
    scale = e.type.scale if kind == Kind.DECIMAL else 0
    if isinstance(e, ColumnRef):
        entry = dicts.get(_BOUNDS_PREFIX + e.name)
        cb = _resolve_bounds(entry)
        if cb is None or not isinstance(entry, _LazyBounds):
            return None
        return (max(abs(int(cb[0])), abs(int(cb[1]))), [entry])
    if isinstance(e, Literal):
        if e.param_slot is not None:
            return None  # value changes per EXECUTE; no static bound
        v = e.value
        if isinstance(v, bool):
            v = int(v)
        if not isinstance(v, (int, float)):
            return None
        return (int(math.ceil(abs(v) * 10 ** scale)) + 1, [])
    if isinstance(e, Func) and e.op in ("add", "sub", "mul", "neg"):
        subs = [_expr_abs_bound(a, dicts) for a in e.args]
        if any(s is None for s in subs):
            return None
        if e.op == "neg":
            return subs[0]
        (b1, c1), (b2, c2) = subs

        def sc(a):
            return (
                a.type.scale
                if a.type is not None and a.type.kind == Kind.DECIMAL
                else 0
            )

        s1, s2 = sc(e.args[0]), sc(e.args[1])
        if e.op == "mul":
            # scaled product == product of scaled operands at result
            # scale s1+s2; a result rescaled DOWN is only smaller
            return (b1 * b2, c1 + c2)
        if scale < max(s1, s2):
            return None  # add/sub never narrows scale; bail if odd
        return (b1 * 10 ** (scale - s1) + b2 * 10 ** (scale - s2), c1 + c2)
    return None


def build_agg_parts(plan: "L.Aggregate", dicts, compiler=None):
    """Compile an Aggregate node's pieces: (key fns, key names, packed key
    widths, AggDescs). With a compiler, wide decimal sums whose arguments
    are provably small (interval arithmetic over storage bounds) drop to
    single-lane int64 accumulation, and bounded integer sums pack their
    (sum, count) pair into one lane; the proof is re-checked at every
    fetch.

    A string key under a CI collation groups by its class in the
    collation (``_collation_rank``: equal-under-collation entries share
    a code; ``agg_out_dicts`` publishes the representatives), MIN/MAX
    over one order by the collation and COUNT(DISTINCT) dedupes by
    class, as the JAX package's."""
    key_fns = [compile_expr(e, dicts) for _, e in plan.group_exprs]
    key_names = [n for n, _ in plan.group_exprs]
    key_widths = [_key_width(e, dicts) for _, e in plan.group_exprs]
    for i, (_n, e) in enumerate(plan.group_exprs):
        lr = _collation_rank(e, dicts)
        if lr is None:
            continue
        key_fns[i] = _rank_wrap(key_fns[i], lr[0])
        key_widths[i] = (max(1, int(len(lr[1])).bit_length()), 0)
    descs = []
    for name, func, arg, distinct in plan.aggs:
        fn = compile_expr(arg, dicts) if arg is not None else None
        scale = (
            arg.type.scale
            if arg is not None and arg.type.kind == Kind.DECIMAL
            else 0
        )
        # scale-4+ decimal products (price*(1-disc)*(1+tax)) overflow
        # int64 accumulation at SF100 row counts: dual-lane wide sum
        wide = func in ("sum", "avg") and scale >= 4
        pack_bound = None
        if func in ("sum", "avg") and compiler is not None and arg is not None:
            r = _expr_abs_bound(arg, dicts)
            # bound * 2^31 rows < 2^62 proves no int64 wraparound
            if r is not None and r[0] < (1 << 31) and all(
                lb.nid is not None for lb in r[1]
            ):
                for lb in r[1]:
                    cb = lb.get()
                    compiler.bound_checks.append(
                        (lb.nid, lb.col, int(cb[0]), int(cb[1]))
                    )
                wide = False
                pack_bound = int(r[0])
        d = bool(distinct) and func in ("sum", "avg", "count") and arg is not None
        post = None
        if func in ("min", "max") and arg is not None:
            cw = _collation_compose(arg, dicts)
            if cw is not None:
                fn, post = cw[0](fn), cw[1]
        elif func == "count" and distinct and arg is not None:
            lr = _collation_rank(arg, dicts)
            if lr is not None:
                fn = _rank_wrap(fn, lr[0])
        descs.append(
            AggDesc(
                func, fn, name, distinct=d, arg_scale=scale, wide=wide,
                pack_bound=pack_bound, post=post,
            )
        )
    return key_fns, key_names, key_widths, descs


def _ci_dict(e: Expr, dicts):
    """(dictionary, collation) of a string expression under a non-binary
    collation, or None."""
    if e.type is None or e.type.kind != Kind.STRING or not e.type.collation:
        return None
    from tidb_tpu_torch.utils import collate as _coll

    if _coll.is_binary(e.type.collation):
        return None
    d = _expr_dict(e, dicts)
    return None if d is None else (d, e.type.collation)


def _collation_compose(e: Expr, dicts):
    """For a CI-collated string: (wrapper making its fn yield
    ``rank * D + code``, post decoding the code) so MIN/MAX pick the
    collation's extreme and still return a code of the dictionary."""
    dc = _ci_dict(e, dicts)
    if dc is None or not len(dc[0]):
        return None
    from tidb_tpu_torch.expression.kernels import _collation_rank_lut

    ranks = _DeviceLUT(_collation_rank_lut(dc[0], dc[1])[0])
    D = int(len(dc[0]))

    def wrap(fn):
        def composed(b: Batch) -> DevCol:
            c = fn(b)
            code = c.data.to(torch.int64).clamp(0, D - 1)
            return DevCol(ranks(code) * D + code, c.valid)

        return composed

    return wrap, (lambda v: torch.remainder(v, D))


def _collation_rank(e: Expr, dicts):
    """(rank LUT, representative dictionary) of a string under a
    non-binary collation (``collate.rank_lut``); None when binary or
    without a dictionary."""
    dc = _ci_dict(e, dicts)
    if dc is None:
        return None
    from tidb_tpu_torch.utils import collate as _coll

    lr = _coll.rank_lut(dc[0], dc[1])
    if lr is None or len(lr[0]) == 0:
        return None
    return _DeviceLUT(lr[0]), lr[1]


def _rank_wrap(fn, lut):
    def wrapped(b: Batch) -> DevCol:
        c = fn(b)
        return DevCol(lut(c.data), c.valid)

    return wrapped


def agg_out_dicts(plan: "L.Aggregate", dicts) -> Dicts:
    """Dictionaries surviving an aggregation: group keys and
    min/max/first outputs over dictionary-coded columns."""
    out_dicts: Dicts = {}
    for (kname, e) in plan.group_exprs:
        d = _expr_dict(e, dicts)
        if d is not None:
            # a CI-collated key groups (and emits codes) by class: publish
            # the class representatives (build_agg_parts maps the codes)
            lr = _collation_rank(e, dicts)
            out_dicts[kname] = d if lr is None else lr[1]
            if lr is not None:
                continue  # code bounds describe the codes before the map
        if isinstance(e, ColumnRef):
            cb = dicts.get(_BOUNDS_PREFIX + e.name)
            if cb is not None:
                out_dicts[_BOUNDS_PREFIX + kname] = cb
    if len(plan.group_exprs) == 1:
        # a single GROUP BY key is unique in the aggregate's output
        out_dicts[_UNIQ_PREFIX + plan.group_exprs[0][0]] = True
    for (name, func, arg, _d) in plan.aggs:
        if func in ("min", "max", "first") and arg is not None:
            d = _expr_dict(arg, dicts)
            if d is not None:
                out_dicts[name] = d
    return out_dicts


class PlanCompiler:
    """Builds the plan function; dictionaries and LUTs are resolved at
    build time (they change only with table versions).

    conservative=True drops every runtime-verified compile-time
    assumption (int-column bounds, NULL-free folding): the executor's
    stale-retry loop falls back to it when assumptions keep failing.

    instrument=True records each node's label and depth
    (``node_labels``) and wraps its function with a wall-time and
    row-count probe (``stats``), which waits for the device after every
    node: a diagnostic mode, the engine side of EXPLAIN ANALYZE
    (reference RuntimeStatsColl, pkg/util/execdetails/execdetails.go)."""

    def __init__(self, catalog, resolver=None, conservative: bool = False, device=None,
                 instrument: bool = False):
        self.conservative = conservative
        self.instrument = instrument
        # (label id, depth, label) in build order, and label id ->
        # {"time_s", "rows", "calls"}; filled in instrument mode only
        self.node_labels: List[Tuple[int, int, str]] = []
        self.stats: Dict[int, Dict[str, float]] = {}
        self._depth = 0
        self.catalog = catalog
        # where plan nodes without a scan (OneRow) make their tiles
        self.device = device
        self.resolver = resolver or (
            lambda db, tbl: (catalog.table(db, tbl), catalog.table(db, tbl).version)
        )
        self._next_id = 0
        self.scans: List[ScanSite] = []
        self.defaults: Dict[int, int] = {}
        self.nonnull: List[Tuple[int, str]] = []
        self.bound_checks: List[Tuple[int, str, int, int]] = []
        self.topn: List[Tuple[str, Optional[int]]] = []
        self.widths: Dict[int, int] = {}
        # the access path a Selection hands to the Scan right below it
        self._pending_range = None
        self._pending_merge = None
        self._pending_parts = None

    def fresh_id(self) -> int:
        self._next_id += 1
        return self._next_id

    def compile(self, plan: L.LogicalPlan) -> CompiledQuery:
        """Build the plan's function. A build is the engine watch's
        ``jit_compilations`` (another of a signature built before, its
        ``retraces``) and the flight's ``compile`` phase."""
        t0 = time.perf_counter()
        fn, dicts = self._build(plan)
        sig = (plan_fingerprint(plan),
               tuple((sc.db, sc.table, self.resolver(sc.db, sc.table)[0].uid) for sc in self.scans))
        ENGINE_WATCH.note_trace(sig)
        FLIGHT.note_phase("compile", time.perf_counter() - t0)
        # bounds/uniqueness entries are compile-time plumbing; result
        # consumers expect name -> dictionary only (reserved prefixes
        # start with NUL)
        out = {k: v for k, v in dicts.items() if not k.startswith("\x00")}
        return CompiledQuery(
            fn=fn,
            scans=self.scans,
            default_caps=dict(self.defaults),
            out_dicts=out,
            nonnull=list(self.nonnull),
            bound_checks=list(self.bound_checks),
            topn=list(self.topn),
            widths={**self.widths, _OUT_NODE: _schema_width(plan.schema)},
        )

    def _build(self, plan: L.LogicalPlan):
        if not self.instrument:
            return self._build_node(plan)
        lid = len(self.node_labels) + 1
        self.node_labels.append((lid, self._depth, _node_label(plan)))
        self._depth += 1
        try:
            fn, dicts = self._build_node(plan)
        finally:
            self._depth -= 1
        return self._wrap(lid, fn), dicts

    def _wrap(self, lid: int, fn):
        """`fn` timed to the device's completion (a node's time includes
        its children's), its output's live rows counted with one fetch."""
        stats = self.stats

        def timed(inputs, caps):
            t0 = time.perf_counter()
            batch, needs = fn(inputs, caps)
            if batch.row_valid.is_cuda:
                torch.cuda.synchronize(batch.row_valid.device)
            el = time.perf_counter() - t0
            rows = int(fetch([batch.row_valid.sum(dtype=torch.int64)])[0])
            st = stats.setdefault(lid, {"time_s": 0.0, "rows": 0, "calls": 0})
            st["time_s"] += el
            st["rows"] = rows
            st["calls"] += 1
            return batch, needs

        return timed

    def _build_node(self, plan: L.LogicalPlan):
        if isinstance(plan, L.Scan):
            return self._build_scan(plan)

        if isinstance(plan, L.OneRow):
            # a SELECT without FROM (a UNION branch): one valid row in a
            # 256-row tile, no columns

            def fn_one(inputs, caps):
                rv = torch.zeros(256, dtype=torch.bool, device=self.device)
                rv[0] = True
                return Batch({}, rv), {}

            return fn_one, {}

        if isinstance(plan, L.Staged):
            if plan.key is not None:
                raise NotImplementedError("keyed staged inputs are not ported yet")
            # a batch computed out of band (a streamed aggregate's result),
            # closed over as a constant source

            def fn_staged(inputs, caps, _b=plan.batch):
                return _b, {}

            return fn_staged, dict(plan.dicts or {})

        if isinstance(plan, L.Selection):
            if (
                isinstance(plan.child, L.Aggregate)
                and plan.child.group_exprs
                and not plan.child.gc_meta
            ):
                names = {n for n, _ in plan.child.group_exprs} | {
                    n for n, _f, _a, _d in plan.child.aggs
                }
                pc = _bound_pred_cols(plan.predicate)
                if pc is not None and pc <= names:
                    # HAVING fusion: evaluate the predicate inside the
                    # aggregation, so the dense path compacts only
                    # surviving groups
                    return self._build_aggregate(
                        plan.child, post_pred=plan.predicate
                    )
            if isinstance(plan.child, L.Scan):
                # the scan below takes the predicate's access path and
                # reads the partitions the predicate can reach
                self._pending_range = _extract_pk_range(
                    plan.predicate, plan.child, self.resolver)
                if self._pending_range is None:
                    self._pending_merge = _extract_index_merge(
                        plan.predicate, plan.child, self.resolver)
                self._pending_parts = _prune_partitions(plan.predicate, plan.child, self.resolver)
            try:
                child, dicts = self._build(plan.child)
            finally:
                self._pending_range = self._pending_merge = self._pending_parts = None
            pred = compile_expr(plan.predicate, dicts)

            def fn_sel(inputs, caps):
                b, needs = child(inputs, caps)
                return filter_batch(b, pred), needs

            return fn_sel, dicts

        if isinstance(plan, L.Projection):
            child, dicts = self._build(plan.child)
            exprs = [(n, compile_expr(e, dicts)) for n, e in plan.exprs]
            out_dicts: Dicts = dict(dicts) if plan.additive else {}
            for n, e in plan.exprs:
                d = _expr_dict(e, dicts)
                if d is not None:
                    out_dicts[n] = d
                if isinstance(e, ColumnRef):
                    cb = dicts.get(_BOUNDS_PREFIX + e.name)
                    if cb is not None:
                        out_dicts[_BOUNDS_PREFIX + n] = cb
                    if dicts.get(_UNIQ_PREFIX + e.name):
                        out_dicts[_UNIQ_PREFIX + n] = True
            additive = plan.additive

            def fn_proj(inputs, caps):
                b, needs = child(inputs, caps)
                cols = dict(b.cols) if additive else {}
                for n, f in exprs:
                    cols[n] = f(b)
                return Batch(cols, b.row_valid), needs

            return fn_proj, out_dicts

        if isinstance(plan, L.Aggregate):
            return self._build_aggregate(plan)

        if isinstance(plan, L.JoinPlan):
            return self._build_join(plan)

        if isinstance(plan, L.Sort):
            child, dicts = self._build(plan.child)
            key_fns = [compile_expr(e, dicts) for e, _ in plan.keys]
            descs = [d for _, d in plan.keys]

            def fn_sort(inputs, caps):
                b, needs = child(inputs, caps)
                return order_by(b, key_fns, descs), needs

            return fn_sort, dicts

        if isinstance(plan, L.Window):
            child, dicts = self._build(plan.child)
            part_fns = [compile_expr(e, dicts) for e in plan.partition_exprs]
            order_fns = [compile_expr(e, dicts) for e, _ in plan.order_exprs]
            order_descs = [d for _, d in plan.order_exprs]
            wdescs = []
            out_dicts = dict(dicts)
            for name, func, arg, offset, running, frame in plan.descs:
                fn = compile_expr(arg, dicts) if arg is not None else None
                scale = (
                    arg.type.scale
                    if arg is not None and arg.type.kind == Kind.DECIMAL
                    else 0
                )
                wdescs.append(WindowDesc(func, fn, name, offset, scale, running, frame))
                if func in ("lag", "lead", "min", "max") and arg is not None:
                    # a string argument's codes carry over, and so does
                    # its dictionary
                    d = _expr_dict(arg, dicts)
                    if d is not None:
                        out_dicts[name] = d

            def fn_win(inputs, caps):
                b, needs = child(inputs, caps)
                return window_op(b, part_fns, order_fns, order_descs, wdescs), needs

            return fn_win, out_dicts

        if isinstance(plan, L.Limit):
            if isinstance(plan.child, L.Sort) and plan.count is not None:
                return self._build_topn(plan)
            child, dicts = self._build(plan.child)
            k, off = plan.count, plan.offset

            def fn_lim(inputs, caps):
                b, needs = child(inputs, caps)
                if k is None:
                    return b, needs
                return limit_op(b, k, off or 0), needs

            return fn_lim, dicts

        if isinstance(plan, L.UnionAll):
            return self._build_union(plan)

        raise NotImplementedError(
            f"{type(plan).__name__} plans are not ported to torch yet"
        )

    def _build_scan(self, plan: L.Scan):
        nid = self.fresh_id()
        parts = self._pending_parts
        self.scans.append(ScanSite(nid, plan.db, plan.table, plan.alias, plan.columns,
                                   pk_range=self._pending_range,
                                   merge_ranges=self._pending_merge, partitions=parts))
        self._pending_range = self._pending_merge = self._pending_parts = None
        t, v = self.resolver(plan.db, plan.table)
        if parts is not None and self.node_labels:
            # EXPLAIN ANALYZE: the scan is a leaf, its label the newest;
            # the kept partitions by id, as the JAX package labels them
            lid, depth, text = self.node_labels[-1]
            self.node_labels[-1] = (lid, depth, text + f" partitions={list(parts)}")
        missing = [c for c in plan.columns if c not in t.schema.types and c != ROWID_NAME]
        if missing:
            raise NotImplementedError(f"virtual scan columns {missing} are not ported yet")
        dicts = {
            f"{plan.alias}.{n}": d
            for n, d in t.dictionaries.items()
            if n in plan.columns
        }
        # integer-column value bounds ride the dicts map under a reserved
        # key: they give the packed-aggregation paths sound static widths
        # (verified at run time by aggregate._pack_keys)
        if not self.conservative:
            for n in plan.columns:
                dicts[_BOUNDS_PREFIX + f"{plan.alias}.{n}"] = _LazyBounds(t, n, v, nid)
        # uniqueness proofs: a single-column primary key or public
        # single-column unique index (verified at run time by the joins
        # that use them)
        pk = t.schema.primary_key
        uniq_cols = set([pk[0]] if pk and len(pk) == 1 else [])
        for iname in t.unique_indexes:
            if t.index_state(iname) != "public":
                continue
            icols = t.indexes.get(iname) or []
            if len(icols) == 1:
                uniq_cols.add(icols[0])
        if not self.conservative:
            for n in plan.columns:
                if n in uniq_cols:
                    dicts[_UNIQ_PREFIX + f"{plan.alias}.{n}"] = True
        # NULL-free columns: fold the column validity into the row mask
        # (re-checked at every fetch; a violation recompiles)
        nonnull = [] if self.conservative else [
            n for n in plan.columns if not t.col_has_nulls(n, v)
        ]
        self.nonnull.extend((nid, n) for n in nonnull)
        nonnull_set = frozenset(nonnull)
        alias = plan.alias

        def fn_scan(inputs, caps, _nid=nid, _alias=alias, _nn=nonnull_set):
            raw = inputs[_nid]
            return (
                Batch(
                    {
                        f"{_alias}.{n}": (
                            DevCol(c.data, raw.row_valid) if n in _nn else c
                        )
                        for n, c in raw.cols.items()
                    },
                    raw.row_valid,
                ),
                {},
            )

        return fn_scan, dicts

    def _build_aggregate(self, plan: L.Aggregate, post_pred=None):
        child, dicts = self._build(plan.child)
        nid = self.fresh_id()
        scalar = not plan.group_exprs
        # a scalar aggregate always has exactly one group
        self.defaults[nid] = 16 if scalar else 1024
        self.widths[nid] = _schema_width(plan.schema)
        key_fns, key_names, key_widths, descs = build_agg_parts(
            plan, dicts, compiler=self
        )
        agg_names = [(n, f) for n, f, _a, _d in plan.aggs]
        post_fn = (
            compile_expr(post_pred, agg_out_dicts(plan, dicts))
            if post_pred is not None
            else None
        )

        def fn_agg(inputs, caps):
            b, needs = child(inputs, caps)
            out, ngroups = group_aggregate(
                b, key_fns, descs, caps[nid], key_names,
                key_widths=key_widths, post_filter=post_fn,
            )
            if scalar:
                # MySQL: scalar aggregation over empty input yields one
                # row: COUNT=0 valid, others NULL
                empty = ngroups == 0
                first = torch.zeros(out.capacity, dtype=torch.bool, device=out.device)
                first[0] = True
                rv = torch.where(empty, first, out.row_valid)
                cols = {}
                for name, func in agg_names:
                    c = out.cols[name]
                    if func == "count":
                        cols[name] = DevCol(
                            torch.where(empty, torch.zeros_like(c.data), c.data),
                            torch.where(empty, first, c.valid),
                        )
                    else:
                        cols[name] = DevCol(
                            c.data, torch.where(empty, torch.zeros_like(c.valid), c.valid)
                        )
                out = Batch(cols, rv)
            needs = dict(needs)
            needs[nid] = ngroups
            return out, needs

        return fn_agg, agg_out_dicts(plan, dicts)


    def _topn_widths(self, keys, dicts):
        """Per-key (bit width, bias) for the packed top-k encoding, or
        None when the keys don't pack into <= 62 bits. Unlike the
        aggregation widths, integer-typed keys WITHOUT bounds (e.g. SUM
        outputs) get an assumed 40-bit width: verified at run time, and
        dropped by the conservative recompile if values exceed it."""
        out = []
        total = 0
        for e, _d in keys:
            w = _key_width(e, dicts)
            if w is None and not self.conservative:
                kind = e.type.kind if e.type is not None else None
                if kind in (Kind.INT, Kind.DECIMAL, Kind.DATETIME, Kind.TIME):
                    w = (40, 1 << 39)  # covers |v| < 2^39
            if w is None:
                return None
            total += w[0]
            out.append(w)
        return out if total <= 62 else None

    def _build_topn(self, plan: L.Limit):
        """ORDER BY ... LIMIT n without sorting the dataset.

        Packed path: when every sort key packs into one int64 (dictionary
        codes, dates, bounded or assumed-width integers; a DESC key keeps
        its limb and an ASC key flips it, so a bigger packed value is an
        earlier row, and MySQL's NULL order falls out of the 0 limb), the
        first n + offset rows come from one top-k over the packed key.
        ``lax.top_k`` in the JAX package returns equal values in row
        order; ``torch.topk`` promises no order among them, so its k-th
        value is only the threshold: every row above it is kept, the rows
        equal to it fill the remaining places in row order, and the kept
        rows are then sorted stably.

        Sorted path (keys that do not pack, or n > 4096): a full sort and
        the head tile."""
        sort = plan.child
        inner, dicts = self._build(sort.child)
        key_fns = [compile_expr(e, dicts) for e, _ in sort.keys]
        descs = [d for _, d in sort.keys]
        n = plan.count + (plan.offset or 0)
        k, off = plan.count, plan.offset or 0

        widths = self._topn_widths(sort.keys, dicts) if n <= 4096 else None
        if widths is not None:
            total_bits = sum(w for w, _b in widths)
            self.topn.append(("packed", total_bits))
            snid = self.fresh_id()
            self.defaults[snid] = 16
            self.widths[snid] = 8

            def pack(b):
                packed = torch.zeros(b.capacity, dtype=torch.int64, device=b.device)
                stale = torch.zeros((), dtype=torch.bool, device=b.device)
                offb = total_bits
                for (w, bias), f, d in zip(widths, key_fns, descs):
                    offb -= w
                    kcol = f(b)
                    limb = kcol.data.to(torch.int64) + (bias + 1)
                    limb = torch.where(kcol.valid, limb, torch.zeros_like(limb))
                    bad = kcol.valid & ((limb < 1) | (limb > ((1 << w) - 1)))
                    stale = stale | (b.row_valid & bad).any()
                    enc = limb if d else ((1 << w) - 1) - limb
                    packed = packed | (enc << offb)
                # invalid rows sink below every real row (packed >= 0)
                return torch.where(b.row_valid, packed, torch.full_like(packed, -1)), stale

            def fn_topk(inputs, caps):
                b, needs = inner(inputs, caps)
                packed, stale = pack(b)
                head = _top_rows(b, packed, min(n, b.capacity))
                needs = dict(needs)
                needs[snid] = torch.where(stale, _WIDTH_STALE, 0)
                return limit_op(head, k, off), needs

            return fn_topk, dicts

        self.topn.append(("sorted", None))
        tile = pad_capacity(max(n, 1), floor=32)

        def fn_topn(inputs, caps):
            b, needs = inner(inputs, caps)
            b = order_by(b, key_fns, descs)
            # the sorted order puts valid rows first, so a static head
            # slice after masking rows past n is exact
            keep = torch.cumsum(b.row_valid.to(torch.int32), 0) <= n
            t = min(tile, b.capacity)
            head = Batch(
                {nm: DevCol(c.data[:t], c.valid[:t] & keep[:t]) for nm, c in b.cols.items()},
                b.row_valid[:t] & keep[:t],
            )
            return limit_op(head, k, off), needs

        return fn_topn, dicts

    def _build_union(self, plan: L.UnionAll):
        """Bag union by position: the children's tiles one after another
        (the output tile is the sum of theirs). Each string column gets
        the merged dictionary of its branches and one code LUT per
        branch; an integer column whose branches all carry bounds gets
        their hull."""
        built = [self._build(c) for c in plan.children]
        fns = [f for f, _ in built]
        child_dicts = [d for _, d in built]
        internals = [c.internal for c in plan.schema.cols]
        types = {c.internal: c.type for c in plan.schema.cols}
        out_dicts: Dicts = {}
        luts: Dict[str, List[_DeviceLUT]] = {}
        for name in internals:
            if types[name].kind != Kind.STRING:
                bs = [cd.get(_BOUNDS_PREFIX + name) for cd in child_dicts]
                if all(b is not None for b in bs):
                    out_dicts[_BOUNDS_PREFIX + name] = _UnionBounds(bs)
                continue
            ds = [cd.get(name) for cd in child_dicts]
            merged = np.array(
                sorted({s for d in ds if d is not None for s in d.tolist()}),
                dtype=object,
            )
            out_dicts[name] = merged
            luts[name] = [
                _DeviceLUT(
                    np.searchsorted(merged, d).astype(np.int32)
                    if d is not None and len(d)
                    else np.zeros(1, np.int32)
                )
                for d in ds
            ]

        def fn_union(inputs, caps):
            needs: Dict[int, torch.Tensor] = {}
            batches = []
            for f in fns:
                b, nd = f(inputs, caps)
                needs.update(nd)
                batches.append(b)
            cols = {}
            for name in internals:
                datas, valids = [], []
                for ci, b in enumerate(batches):
                    c = b.cols[name]
                    datas.append(luts[name][ci](c.data) if name in luts else c.data)
                    valids.append(c.valid)
                cols[name] = DevCol(torch.cat(datas), torch.cat(valids))
            rv = torch.cat([b.row_valid for b in batches])
            return Batch(cols, rv), needs

        return fn_union, out_dicts

    def _stale_sentinel_node(self, props) -> Optional[int]:
        """Semi/anti/mark joins have no output-capacity knob, so a dense
        build side gets a node of its own whose `needs` carries only the
        WIDTH_STALE sentinel (0 otherwise) back to the executor."""
        if props[0] is None:
            return None
        nid = self.fresh_id()
        self.defaults[nid] = 16
        self.widths[nid] = 8
        return nid

    def _sized_node(self, schema) -> int:
        """A join node whose output tile the executor discovers: it
        starts at the dominant input tile (_join_default). Its rows are
        `schema`'s."""
        nid = self.fresh_id()
        self.defaults[nid] = 0
        self.widths[nid] = _schema_width(schema)
        return nid

    def _build_join(self, plan: L.JoinPlan):
        left, ldicts = self._build(plan.left)
        right, rdicts = self._build(plan.right)
        dicts = {**ldicts, **rdicts}

        if plan.kind == "cross":
            res = compile_expr(plan.residual, dicts) if plan.residual is not None else None

            def fn_cross(inputs, caps):
                lb, n1 = left(inputs, caps)
                rb, n2 = right(inputs, caps)
                out, _total = _cross_join(lb, rb)
                if res is not None:
                    out = filter_batch(out, res)
                return out, {**n1, **n2}

            return fn_cross, _strip_uniq(dicts)

        lkeys, rkeys = [], []
        for le, re_ in plan.equi_keys:
            lf, rf = _align_key_fns(le, re_, ldicts, rdicts)
            lkeys.append(lf)
            rkeys.append(rf)
        lprops = rprops = (None, False)
        chosen = None
        if len(lkeys) == 1:
            lkey, rkey = lkeys[0], rkeys[0]
            verify = None
            le0, re0 = plan.equi_keys[0]
            lprops = _join_key_props(le0, ldicts)
            rprops = _join_key_props(re0, rdicts)
        else:
            if plan.kind not in ("inner", "semi", "anti", "left"):
                raise ExecError("multi-key outer join not yet supported")
            # when one pair's key is provably unique on its side, join on
            # THAT pair alone (1:1 path) and verify the remaining
            # equalities after the join (Q5's customer join: c_custkey
            # unique, c_nationkey = s_nationkey demoted). Semi/anti joins
            # cannot swap sides, so only BUILD-side (right) uniqueness
            # qualifies there.
            if plan.kind in ("inner", "semi", "anti"):
                for i, (le0, re0) in enumerate(plan.equi_keys):
                    lp = _join_key_props(le0, ldicts)
                    rp = _join_key_props(re0, rdicts)
                    if rp[1] or (plan.kind == "inner" and lp[1]):
                        chosen, lprops, rprops = i, lp, rp
                        break
            if chosen is not None:
                lkey, rkey = lkeys[chosen], rkeys[chosen]
                verify = (
                    [f for j, f in enumerate(lkeys) if j != chosen],
                    [f for j, f in enumerate(rkeys) if j != chosen],
                )
            else:
                lkey = _hash_combine(lkeys)
                rkey = _hash_combine(rkeys)
                verify = (lkeys, rkeys)

        kind = plan.kind
        null_aware = plan.null_aware
        res = compile_expr(plan.residual, dicts) if plan.residual is not None else None

        if kind == "mark":
            # probe rows survive and gain a boolean IN/EXISTS column
            # (three-valued under null_aware, the IN semantics)
            if verify is not None or res is not None:
                raise ExecError(
                    "mark join supports a single equality key and no "
                    "residual conditions"
                )
            mark = getattr(plan, "mark_name", None) or plan.schema.cols[-1].internal
            snid = self._stale_sentinel_node(rprops)

            def fn_mark(inputs, caps):
                lb, n1 = left(inputs, caps)
                rb, n2 = right(inputs, caps)
                out, t = equi_join(
                    rb, lb, rkey, lkey, 0, "mark",
                    mark_name=mark, mark_three_valued=null_aware,
                    build_bounds=rprops[0],
                )
                needs = {**n1, **n2}
                if snid is not None:
                    needs[snid] = _stale_only(t)
                return out, needs

            return fn_mark, {**ldicts}

        if kind in ("semi", "anti"):
            if verify is None and res is None:
                snid = self._stale_sentinel_node(rprops)

                def fn_semi(inputs, caps):
                    lb, n1 = left(inputs, caps)
                    rb, n2 = right(inputs, caps)
                    needs = {**n1, **n2}
                    out, t = equi_join(rb, lb, rkey, lkey, 0, kind, build_bounds=rprops[0])
                    if snid is not None:
                        needs[snid] = _stale_only(t)
                    if null_aware and kind == "anti":
                        # NOT IN: a NULL on the build side makes every
                        # non-match NULL, and a NULL probe key never passes
                        has_null = (~rkey(rb).valid & rb.row_valid).any()
                        pk = lkey(out)
                        out = Batch(out.cols, out.row_valid & ~has_null & pk.valid)
                    return out, needs

                return fn_semi, {**ldicts}

            # multi-key semi/anti with a provably-unique build pair (or a
            # single-key correlated EXISTS with a unique build key):
            # probe-aligned 1:1 lookup, the demoted equalities and the
            # residual checked on the gathered build row
            if (
                chosen is not None
                or (verify is None and res is not None and rprops[1])
            ) and not (null_aware and kind == "anti"):
                # the sorted lookup's stale source is a uniqueness
                # violation, not only outgrown bounds: the sentinel is
                # needed whenever either assumption is baked
                snid = self._stale_sentinel_node(
                    rprops if rprops[0] is not None else ((0, 0), True)
                )
                lks_rks = verify

                def fn_semi_lookup(inputs, caps):
                    lb, n1 = left(inputs, caps)
                    rb, n2 = right(inputs, caps)
                    needs = {**n1, **n2}
                    brow, matched, stale = lookup_build_rows(
                        rb, lb, rkey, lkey, build_bounds=rprops[0]
                    )
                    # joined namespace, probe-aligned: probe columns plus
                    # the matched build row's (junk where unmatched,
                    # masked right after)
                    bb = Batch(
                        {
                            **lb.cols,
                            **{
                                n: DevCol(c.data[brow], c.valid[brow] & matched)
                                for n, c in rb.cols.items()
                            },
                        },
                        lb.row_valid,
                    )
                    ok = matched
                    if lks_rks is not None:
                        for lf2, rf2 in zip(*lks_rks):
                            a, c = lf2(bb), rf2(bb)
                            ok = ok & (a.data == c.data) & a.valid & c.valid
                    if res is not None:
                        r = res(bb)
                        ok = ok & r.data.to(torch.bool) & r.valid
                    keep = ok if kind == "semi" else ~ok
                    out = Batch(lb.cols, lb.row_valid & keep)
                    if snid is not None:
                        needs[snid] = torch.where(stale, _WIDTH_STALE, 0)
                    return out, needs

                return fn_semi_lookup, {**ldicts}

            # multiple keys and/or a residual: expand through an inner
            # join carrying a probe row id, verify every key pair
            # exactly, apply the residual, then mask the probe batch by
            # the surviving row ids (an exact single-key semi join)
            if null_aware:
                raise ExecError("null-aware multi-key anti join not supported")
            nid = self._sized_node(plan.schema)
            lks_rks = verify

            def fn_semi_multi(inputs, caps):
                lb, n1 = left(inputs, caps)
                rb, n2 = right(inputs, caps)
                lb2 = _with_row_ids(lb, "_srowid")
                cap = caps[nid] or pad_capacity(max(lb.capacity, 1024))
                j, total = equi_join(rb, lb2, rkey, lkey, cap, "inner")
                if lks_rks is not None:
                    j = filter_batch(j, _verify_fn(*lks_rks))
                if res is not None:
                    j = filter_batch(j, res)
                ridc = lambda b: b.cols["_srowid"]  # noqa: E731
                out, _t = equi_join(j, lb2, ridc, ridc, 0, kind)
                out = Batch(
                    {k: v for k, v in out.cols.items() if k != "_srowid"}, out.row_valid
                )
                needs = {**n1, **n2}
                needs[nid] = total
                return out, needs

            return fn_semi_multi, {**ldicts}

        if kind == "left" and (verify is not None or res is not None):
            # LEFT join with several equi keys and/or an ON residual: (1)
            # inner join with a probe row id, every key pair verified and
            # the residual applied to matched pairs only, then (2) LEFT
            # join the probe against the survivors on the row id, so
            # unmatched probe rows NULL-extend (ON never filters the
            # outer side)
            nid = self._sized_node(plan.schema)
            nid2 = self._sized_node(plan.schema)
            lks_rks = verify

            def fn_left_multi(inputs, caps):
                lb, n1 = left(inputs, caps)
                rb, n2 = right(inputs, caps)
                lb2 = _with_row_ids(lb, "_lrowid")
                cap = caps[nid] or pad_capacity(max(lb.capacity, 1024))
                j, total = equi_join(rb, lb2, rkey, lkey, cap, "inner")
                if lks_rks is not None:
                    j = filter_batch(j, _verify_fn(*lks_rks))
                if res is not None:
                    j = filter_batch(j, res)
                rnames = set(rb.cols)
                j2 = Batch(
                    {k: v for k, v in j.cols.items() if k in rnames or k == "_lrowid"},
                    j.row_valid,
                )
                ridc = lambda b: b.cols["_lrowid"]  # noqa: E731
                cap2 = caps[nid2] or pad_capacity(max(lb.capacity, 1024))
                out, total2 = equi_join(j2, lb2, ridc, ridc, cap2, "left")
                out = Batch(
                    {k: v for k, v in out.cols.items() if k != "_lrowid"}, out.row_valid
                )
                needs = {**n1, **n2}
                needs[nid] = total
                needs[nid2] = total2
                return out, needs

            return fn_left_multi, _strip_uniq(dicts)

        nid = self._sized_node(plan.schema)

        def fn_join(inputs, caps):
            lb, n1 = left(inputs, caps)
            rb, n2 = right(inputs, caps)
            build_b, probe_b, build_k, probe_k = rb, lb, rkey, lkey
            build_props = rprops
            if kind == "inner" and lb.capacity < rb.capacity:
                # build on the smaller tile
                build_b, probe_b, build_k, probe_k = lb, rb, lkey, rkey
                build_props = lprops
            cap = caps[nid] or pad_capacity(max(probe_b.capacity, 1024))
            out, total = equi_join(
                build_b, probe_b, build_k, probe_k, cap, kind,
                build_bounds=build_props[0], build_unique=build_props[1],
            )
            if verify is not None:
                out = filter_batch(out, _verify_fn(*verify))
            if res is not None:
                out = filter_batch(out, res)
            needs = {**n1, **n2}
            needs[nid] = total
            return out, needs

        if kind == "inner" and (len(plan.equi_keys) == 1 or chosen is not None):
            # keyed (or chosen-keyed) on one pair: a unique build key
            # cannot duplicate the other side's rows, so that side's
            # uniqueness survives; the verify filter only drops rows
            return fn_join, _merge_join_dicts(ldicts, rdicts, lprops[1], rprops[1])
        return fn_join, _strip_uniq(dicts)


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

_MAX_CAP = 1 << 26
# pseudo node id for the final output's compaction capacity
_OUT_NODE = -1


def _cap_tile(n: int) -> int:
    """Power-of-two tile >= n for capacity knobs (floor 16)."""
    return pad_capacity(n, floor=16, pow2=True)


class PhysicalExecutor:
    """Runs compiled plans on one device, with an LRU plan cache keyed by
    plan fingerprint and table versions."""

    def __init__(self, catalog, device=None):
        self.catalog = catalog
        self.device = resolve_device(device)
        self._cache: "OrderedDict[tuple, CompiledQuery]" = OrderedDict()
        # the compiled plan of the last statement run (its top-N paths)
        self.last_compiled: Optional[CompiledQuery] = None
        # aggregate inputs stream chunk by chunk (planner/streamed.py):
        # -1 = auto (past the tile limit, or when the working set overruns
        # the device's free memory), >0 = explicit row threshold,
        # 0/None = never stream
        self.stream_rows = -1
        self._stream_plans: "OrderedDict[tuple, object]" = OrderedDict()
        # one record per streamed aggregate, grace-hash partitioned
        # pipeline or host-merged ORDER BY of the last statement
        self.stream_log: List[dict] = []
        # device bytes one statement may plan to hold (TiDB's
        # tidb_mem_quota_query): None = no quota. Admission checks every
        # launch against it; the spill paths size their chunks by it
        self.quota_bytes: Optional[int] = None
        # the bytes the last admitted launch holds (its scan batches and
        # operator tiles): the instance watchdog ranks sessions by it
        self.last_working_set = 0
        # (db, table) -> (table, version) of the session's transaction
        # view; None reads the catalog's current versions
        self.table_hook = None
        # the kill safepoint (utils/sqlkiller.SQLKiller.check): raises
        # QueryKilled at each capacity-discovery attempt and streamed
        # chunk once the statement is killed or past its deadline
        self.kill_check = None
        self._depth = 0

    def _resolve(self, db: str, table: str):
        """(table, version) a scan reads: the session's transaction view
        (``table_hook``: a shadow or a pinned snapshot) when it set one,
        else the catalog's current version."""
        if self.table_hook is not None:
            return self.table_hook(db, table)
        t = self.catalog.table(db, table)
        return t, t.version

    def check_killed(self) -> None:
        """A kill safepoint: a host test of the session's flag and
        deadline, with no device synchronization."""
        if self.kill_check is not None:
            self.kill_check()

    def _cache_key(self, plan: L.LogicalPlan) -> tuple:
        versions = []

        def walk(p):
            if isinstance(p, L.Scan):
                t, v = self._resolve(p.db, p.table)
                # compiled plans bake in dictionaries and bounds
                versions.append((p.db, p.table, t.uid, v))
            for c in _plan_children(p):
                walk(c)

        walk(plan)
        return (plan_fingerprint(plan), tuple(versions))

    def run(self, plan: L.LogicalPlan) -> Tuple[Batch, Dicts]:
        """Execute a plan. Returns (host batch of the plan schema's
        columns, output dictionaries); the batch's tensors are on the CPU
        after one device->host fetch. A streamed aggregate re-enters with
        the rest of the plan over its staged result."""
        from tidb_tpu_torch.planner.hostagg import try_host_agg
        from tidb_tpu_torch.planner.streamed import has_staged, try_partitioned, try_streamed

        if self._depth == 0:
            self.stream_log = []
        self._depth += 1
        try:
            # GROUP_CONCAT: the device projects the aggregate's inputs, the
            # host concatenates, the rest of the plan runs over the result
            hosted = try_host_agg(self, plan)
            if hosted is not None:
                return hosted
            names = [c.internal for c in plan.schema]
            # a plan over a staged batch bakes that batch in: it is
            # compiled for this statement only and never cached
            baked = has_staged(plan)
            for attempt in range(4):
                self.check_killed()
                # the last attempts compile with no runtime-verified
                # assumptions, so even a permanently violated one terminates
                conservative = attempt >= 2
                key = self._cache_key(plan)
                try:
                    streamed = try_streamed(self, plan, conservative=conservative)
                    if streamed is None:
                        streamed = try_partitioned(self, plan, conservative=conservative)
                    if streamed is not None:
                        return streamed
                    cq = None if conservative or baked else self._cache.get(key)
                    if not (conservative or baked):
                        FLIGHT.note_plan_cache(cq is not None, key=key)
                        if cq is not None:
                            REGISTRY.counter("tidbtpu_executor_plan_cache_hits_total").inc()
                        else:
                            REGISTRY.counter("tidbtpu_executor_plan_cache_misses_total").inc()
                    if cq is None:
                        cq = PlanCompiler(
                            self.catalog, resolver=self._resolve, conservative=conservative,
                            device=self.device,
                        ).compile(plan)
                        if not baked:
                            while len(self._cache) >= 256:
                                self._cache.popitem(last=False)
                            self._cache[key] = cq
                    else:
                        self._cache.move_to_end(key)
                    try:
                        out = self._run_compiled(cq, names), cq.out_dicts
                    except ExecError as e:
                        # admission rejected the unpaged plan: retry with
                        # streaming, then grace hash, forced (the whole
                        # plan's tiles, not its aggregate's input, passed
                        # the quota); when neither takes it, the
                        # rejection and its tracker report stand
                        if "memory quota exceeded" not in str(e):
                            raise
                        forced = try_streamed(self, plan, conservative=conservative, force=True)
                        if forced is None:
                            forced = try_partitioned(
                                self, plan, conservative=conservative, force=True
                            )
                        if forced is None:
                            raise
                        return forced
                    # keep the record, not the closure over a staged batch
                    self.last_compiled = dataclasses.replace(cq, fn=None) if baked else cq
                    return out
                except StaleWidthsError:
                    self.evict_stale(key)
            raise ExecError("packed key widths did not stabilize after recompiles")
        finally:
            self._depth -= 1

    def run_analyze(self, plan: L.LogicalPlan) -> Tuple[Batch, Dicts, List[str]]:
        """EXPLAIN ANALYZE: one instrumented run with per-node rows, time
        and calls, as plan lines. It starts from the capacities an earlier
        run of the same plan learned, so a warm plan runs each node once;
        a node that overflows its tile re-runs and counts a second call.
        A GROUP_CONCAT plan reduces on the host and reports the whole
        statement's time; a plan the sizing would spill
        (planner/streamed.py) is refused, since an instrumented whole-tile
        pass of it would not fit."""
        from tidb_tpu_torch.planner.hostagg import find_gc_agg, try_host_agg
        from tidb_tpu_torch.planner.streamed import spill_path

        if find_gc_agg(plan) is not None:
            t0 = time.perf_counter()
            out, dicts = try_host_agg(self, plan)
            dt = (time.perf_counter() - t0) * 1000
            lines = [
                f"HostAssistedAggregate(GROUP_CONCAT)  time={dt:.2f}ms "
                "(per-node stats unavailable on the host-assisted path)"
            ]
            return out, dicts, lines
        why = spill_path(self, plan)
        if why is not None:
            raise NotImplementedError(
                f"EXPLAIN ANALYZE of a statement that spills ({why}) is not ported yet")
        names = [c.internal for c in plan.schema]
        self.stream_log = []
        for conservative in (False, True):
            compiler = PlanCompiler(self.catalog, resolver=self._resolve,
                                    conservative=conservative, device=self.device,
                                    instrument=True)
            cq = compiler.compile(plan)
            known = self._cache.get(self._cache_key(plan))
            if known is not None and known.caps and not conservative:
                cq.caps = dict(known.caps)
            try:
                out = self._run_compiled(cq, names)
                break
            except StaleWidthsError:
                if conservative:
                    raise ExecError("packed key widths did not stabilize") from None
        lines = []
        for lid, depth, label in compiler.node_labels:
            st = compiler.stats.get(lid)
            suffix = (
                f"  rows={st['rows']} time={st['time_s'] * 1000:.2f}ms calls={st['calls']}"
                if st else ""
            )
            lines.append("  " * depth + label + suffix)
        return out, cq.out_dicts, lines

    def forget_tables(self, uids) -> None:
        """Drop the compiled plans that scan any table of `uids` (a
        recursive CTE's scratch tables, whose versions are never read
        again)."""
        uids = set(uids)
        for k in [k for k in self._cache if any(v[2] in uids for v in k[1])]:
            self._cache.pop(k, None)
        for k in [k for k in self._stream_plans if any(v[2] in uids for v in k[0][1])]:
            self._stream_plans.pop(k, None)

    def evict_stale(self, key: tuple) -> None:
        """Drop the compiled plan and every stream, partition and sort
        plan compiled for the plan under `key` (``_cache_key``): their
        baked widths or NULL-free assumptions no longer hold."""
        self._cache.pop(key, None)
        for k in [k for k in self._stream_plans if k[0] == key]:
            self._stream_plans.pop(k, None)

    def _admit(self, cq: CompiledQuery, inputs: Dict[int, Batch], caps: Dict[int, int]) -> None:
        """Quota admission: account every buffer the launch will hold
        (each scan batch at its tile, and twice each sized node's tile:
        keyed group tables take two slots a group) against
        ``quota_bytes`` before launching, and reject the launch with the
        tracker tree's report when they pass it. The total is kept in
        ``last_working_set`` with or without a quota."""
        scan_bytes = {nid: batch_bytes(b.capacity, {n: c.data.dtype for n, c in b.cols.items()})
                      for nid, b in inputs.items()}
        node_bytes = {nid: 2 * cap * cq.widths.get(nid, 64) for nid, cap in caps.items()}
        self.last_working_set = sum(scan_bytes.values()) + sum(node_bytes.values())
        ENGINE_WATCH.note_device_mem(self.last_working_set)
        if not self.quota_bytes:
            return
        inject("executor/admission")
        root = MemoryTracker("query", quota_bytes=int(self.quota_bytes))
        scans, nodes = root.child("scans"), root.child("operators")
        try:
            for nid, nbytes in scan_bytes.items():
                scans.child(f"scan#{nid}").consume(nbytes)
            for nid, nbytes in node_bytes.items():
                label = "output" if nid == _OUT_NODE else f"node#{nid}"
                nodes.child(label).consume(nbytes)
        except QuotaExceeded as e:
            report = "\n".join(root.report())
            raise ExecError(f"memory quota exceeded ({e}); tracker report:\n{report}") from None

    def _fetch_inputs(self, cq: CompiledQuery) -> Dict[int, Batch]:
        inputs, resolved = {}, {}
        for s in cq.scans:
            t, v = resolved[s.node_id] = self._resolve(s.db, s.table)
            narrowed = fetch_site_rows(t, s, v, self.device)
            inputs[s.node_id] = (
                narrowed if narrowed is not None
                else scan_table(t, s.columns, version=v, device=self.device,
                                partitions=s.partitions)[0])
        # compile-time assumptions must still hold at the fetched version
        for nid, col in cq.nonnull:
            t, v = resolved[nid]
            if t.col_has_nulls(col, v):
                raise StaleWidthsError()
        for nid, col, lo, hi in cq.bound_checks:
            t, v = resolved[nid]
            cb = t.col_bounds(col, v)
            if cb is not None and (cb[0] < lo or cb[1] > hi):
                raise StaleWidthsError()
        return inputs

    def _run_compiled(self, cq: CompiledQuery, names: List[str]) -> Batch:
        inputs = self._fetch_inputs(cq)
        inject("executor/before-discover")
        caps = dict(cq.caps or cq.default_caps)
        defaulted = [nid for nid, c in caps.items() if c == 0]
        for nid in defaulted:  # join knobs start at the dominant input tile
            caps[nid] = _join_default(inputs)
        if self.quota_bytes and defaulted:
            # under a quota a guessed tile must not fail admission on its
            # own: start each guessed join knob within a share of the
            # quota and let the overflow loop grow it as the data proves
            # (each growth is admitted again). Knobs an earlier run
            # discovered are known to be needed and stay.
            share = max(int(self.quota_bytes) // (4 * len(caps)), 1)
            for nid in defaulted:
                w = max(cq.widths.get(nid, 64), 1)
                caps[nid] = min(caps[nid], _cap_tile(max(share // (2 * w), 1024)))
        for _attempt in range(8):
            self.check_killed()
            self._admit(cq, inputs, caps)
            out, needs = cq.fn(inputs, caps)
            nids = sorted(needs)
            out_cap = caps.get(_OUT_NODE)
            shown = (
                compact(out.cols, out.row_valid, out_cap)
                if out_cap is not None and out_cap < out.capacity
                else out
            )
            present = [n for n in names if n in shown.cols]
            counts = torch.stack(
                [needs[n].to(torch.int64).reshape(()) for n in nids]
                + [out.row_valid.sum(dtype=torch.int64)]
            )
            host = fetch(
                [counts, shown.row_valid]
                + [t for n in present for t in (shown.cols[n].data, shown.cols[n].valid)]
            )
            true_n = dict(zip(nids, (int(x) for x in host[0][:-1])))
            nvalid = int(host[0][-1])
            if any(n >= _WIDTH_STALE for n in true_n.values()):
                raise StaleWidthsError()
            bumped = False
            for nid, n in true_n.items():
                if n > caps[nid]:
                    inject("executor/cap-overflow")
                    caps[nid] = _cap_tile(n)
                    if caps[nid] > _MAX_CAP:
                        raise ExecError(f"result too large at node {nid}: {n} rows")
                    bumped = True
            if out_cap is not None and nvalid > shown.capacity:
                caps.pop(_OUT_NODE)
                bumped = True
            if bumped:
                ENGINE_WATCH.note_resize()
                continue
            # shrink every knob to the tight tile of its true cardinality
            for nid, n in true_n.items():
                caps[nid] = min(caps[nid], _cap_tile(n))
            caps[_OUT_NODE] = min(_cap_tile(max(nvalid, 1)), out.capacity)
            cq.caps = caps
            cols = {
                n: DevCol(torch.from_numpy(host[2 + 2 * i]), torch.from_numpy(host[3 + 2 * i]))
                for i, n in enumerate(present)
            }
            return Batch(cols, torch.from_numpy(host[1]))
        raise ExecError("capacity discovery did not converge")


# ---------------------------------------------------------------------------
# shared helpers (also used by PlanCompiler)
# ---------------------------------------------------------------------------


def _node_label(plan: L.LogicalPlan) -> str:
    """A plan node as EXPLAIN ANALYZE names it (the JAX package's
    ``_node_label``)."""
    name = type(plan).__name__
    if isinstance(plan, L.Scan):
        return f"Scan table={plan.db}.{plan.table} cols={len(plan.columns)}"
    if isinstance(plan, L.Selection):
        return f"Selection pred={plan.predicate!r}"
    if isinstance(plan, L.Aggregate):
        return (
            f"Aggregate groups={[n for n, _ in plan.group_exprs]} "
            f"aggs={[f'{f}({n})' for n, f, _, _ in plan.aggs]}"
        )
    if isinstance(plan, L.JoinPlan):
        return f"Join kind={plan.kind} keys={len(plan.equi_keys)}"
    if isinstance(plan, L.Sort):
        return f"Sort keys={len(plan.keys)}"
    if isinstance(plan, L.Window):
        return f"Window funcs={[d[1] for d in plan.descs]} parts={len(plan.partition_exprs)}"
    if isinstance(plan, L.Limit):
        return f"Limit limit={plan.count} offset={plan.offset}"
    if isinstance(plan, L.Projection):
        return f"Projection exprs={[n for n, _ in plan.exprs]}" + (" +base" if plan.additive else "")
    if isinstance(plan, L.UnionAll):
        return f"UnionAll branches={len(plan.children)}"
    return name


def _top_rows(b: Batch, packed: torch.Tensor, kk: int) -> Batch:
    """The `kk` rows of largest `packed` value, in descending order, equal
    values in row order (``lax.top_k``'s order): the k-th value from
    ``torch.topk`` is a threshold; the rows above it and the first rows
    equal to it (a running count) are compacted in row order and sorted
    stably."""
    if kk == 0:
        return Batch({nm: DevCol(c.data[:0], c.valid[:0]) for nm, c in b.cols.items()},
                     b.row_valid[:0])
    thr = torch.topk(packed, kk, sorted=False).values.min()
    above = packed > thr
    eq = packed == thr
    room = kk - above.sum()
    keep = above | (eq & (torch.cumsum(eq.to(torch.int64), 0) <= room))
    # exactly kk rows are kept; reserved names start with NUL, as no
    # column's does
    sel = compact({**b.cols, "\x00p": DevCol(packed, keep), "\x00rv": DevCol(b.row_valid, keep)},
                  keep, kk)
    p = sel.cols.pop("\x00p").data
    rv = sel.cols.pop("\x00rv").data
    order = torch.sort(p, descending=True, stable=True).indices
    cols = {nm: DevCol(c.data[order], c.valid[order]) for nm, c in sel.cols.items()}
    return Batch(cols, rv[order])


def _bound_pred_cols(e):
    """Column names referenced by a bound predicate, or None when the
    tree contains nodes other than ColumnRef/Func/Literal (bail from
    HAVING fusion rather than guess)."""
    from tidb_tpu_torch.expression.expr import Func, Literal

    out: set = set()

    def walk(x):
        if isinstance(x, ColumnRef):
            out.add(x.name)
        elif isinstance(x, Func):
            for a in x.args:
                if isinstance(a, (ColumnRef, Func, Literal)):
                    walk(a)
                elif isinstance(a, Expr):
                    raise _PredBail
        elif not isinstance(x, Literal):
            raise _PredBail

    try:
        walk(e)
    except _PredBail:
        return None
    return out


class _PredBail(Exception):
    pass


def _key_width(e: Expr, dicts: Dicts):
    """(bit width, bias) of a group key's packed encoding when a sound
    static bound exists (enables the dense aggregation path); None
    otherwise. Integer-typed plain columns take their width from the
    storage layer's value bounds (Table.col_bounds, riding the dicts map)."""
    kind = e.type.kind if e.type is not None else None
    if kind == Kind.STRING:
        d = _expr_dict(e, dicts)
        if d is None:
            return None
        return (max(1, int(len(d)).bit_length()), 0)
    if isinstance(e, ColumnRef):
        cb = _resolve_bounds(dicts.get(_BOUNDS_PREFIX + e.name))
        if cb is not None:
            lo, hi = cb
            w = int(hi - lo + 1).bit_length()
            if w <= 40:
                return (w, -lo)
    if kind == Kind.DATE:
        return (33, 1 << 31)
    if kind == Kind.BOOL:
        return (2, 0)
    return None


def _expr_dict(e: Expr, dicts: Dicts) -> Optional[np.ndarray]:
    """Dictionary of a string-valued output expr (shared with the
    compiler's string_expr so codes and dictionary always agree)."""
    if e.type is None or e.type.kind != Kind.STRING:
        return None
    from tidb_tpu_torch.expression.kernels import expr_dictionary

    return expr_dictionary(e, dicts)


def _join_default(inputs: Dict[int, Batch]) -> int:
    """A join node's first output tile: the dominant input tile."""
    return pad_capacity(max([b.capacity for b in inputs.values()] + [1024]))


def _join_key_props(e: Expr, dicts: Dicts):
    """(bounds, unique) of a join key column for the dense join paths.
    STRING keys are excluded: _align_key_fns remaps their codes into a
    merged dictionary, so the storage code bounds no longer apply."""
    if not isinstance(e, ColumnRef):
        return (None, False)
    if e.type is not None and e.type.kind == Kind.STRING:
        return (None, False)
    return (
        _resolve_bounds(dicts.get(_BOUNDS_PREFIX + e.name)),
        bool(dicts.get(_UNIQ_PREFIX + e.name)),
    )


def _align_key_fns(le: Expr, re_: Expr, ldicts: Dicts, rdicts: Dicts):
    """Compile join key exprs; for STRING keys, remap both sides' codes
    into a merged dictionary so integer equality == string equality (in
    the collation's key space when either side is CI)."""
    if le.type is None or le.type.kind != Kind.STRING:
        return compile_expr(le, ldicts), compile_expr(re_, rdicts)
    if not isinstance(le, ColumnRef) or not isinstance(re_, ColumnRef):
        raise ExecError("string join keys must be plain columns")
    ld = ldicts.get(le.name)
    rd = rdicts.get(re_.name)
    if ld is None or rd is None:
        raise ExecError("string join keys need dictionaries")
    from tidb_tpu_torch.utils import collate as _coll

    coll = le.type.collation or (re_.type.collation if re_.type is not None else None)
    _m, ll, lr = _coll.merge_rank_luts(ld, rd, coll)
    luts: dict = {}

    def mapped(c: DevCol, arr, side) -> DevCol:
        key = (side, str(c.data.device))
        if key not in luts:
            luts[key] = torch.as_tensor(np.asarray(arr, dtype=np.int32), device=c.data.device)
        lut = luts[key]
        return DevCol(lut[c.data.to(torch.int64).clamp(0, lut.shape[0] - 1)], c.valid)

    lname, rname = le.name, re_.name
    return (
        lambda b: mapped(b.cols[lname], ll, "l"),
        lambda b: mapped(b.cols[rname], lr, "r"),
    )


def _hash_combine(key_fns):
    """One int64 key from several (collisions are possible: the join
    verifies every pair after it). Shifts are arithmetic and multiplies
    wrap, as the JAX package's int64 arithmetic."""

    def f(b: Batch) -> DevCol:
        h = torch.zeros(b.capacity, dtype=torch.int64, device=b.device)
        valid = torch.ones(b.capacity, dtype=torch.bool, device=b.device)
        for fn in key_fns:
            c = fn(b)
            k = c.data.to(torch.int64)
            h = (h * -7046029254386353131) ^ (
                k + -9061461749304837403 + (h << 6) + (h >> 2)
            )
            valid = valid & c.valid
        return DevCol(h, valid)

    return f


def _verify_fn(lks, rks):
    """Row predicate: every (left, right) key pair equal and non-NULL."""

    def vf(b: Batch) -> DevCol:
        ok = torch.ones(b.capacity, dtype=torch.bool, device=b.device)
        vv = torch.ones(b.capacity, dtype=torch.bool, device=b.device)
        for lf, rf in zip(lks, rks):
            a, c = lf(b), rf(b)
            ok = ok & (a.data == c.data)
            vv = vv & a.valid & c.valid
        return DevCol(ok, vv)

    return vf


def _with_row_ids(b: Batch, name: str) -> Batch:
    rid = torch.arange(b.capacity, dtype=torch.int64, device=b.device)
    return Batch({**b.cols, name: DevCol(rid, b.row_valid)}, b.row_valid)


def _cross_join(left: Batch, right: Batch):
    """Nested-loop cross join by broadcast (small sides only)."""
    lcap, rcap = left.capacity, right.capacity
    if lcap * rcap > (1 << 24):
        raise ExecError("cross join too large")
    dev = left.device
    li = torch.arange(lcap, device=dev).repeat_interleave(rcap)
    ri = torch.arange(rcap, device=dev).repeat(lcap)
    cols = {}
    for n, c in left.cols.items():
        cols[n] = DevCol(c.data[li], c.valid[li])
    for n, c in right.cols.items():
        cols[n] = DevCol(c.data[ri], c.valid[ri])
    rv = left.row_valid[li] & right.row_valid[ri]
    return Batch(cols, rv), rv.sum(dtype=torch.int64)
