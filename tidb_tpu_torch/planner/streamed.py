"""The spill paths: streamed aggregation, grace-hash partitioned
pipelines and the host-merged ORDER BY.

Counterpart of tidb_tpu/planner/streamed.py. Three paths, each taken
only when the plan's tables are too large for one device tile, for the
card's free memory or for the statement's memory quota
(``executor.quota_bytes``):

- ``try_streamed``: when an aggregation's largest input table is too
  large, the pre-aggregation pipeline (scan -> filter -> project ->
  equi-joins against resident sides) runs CHUNK BY CHUNK on the device,
  each chunk is partially aggregated, only the partial group rows stay
  on the device, and a final aggregation merges them (the partial/final
  split of ``parallel/fragment.py``). The merged result re-enters the
  plan as an ``L.Staged`` leaf and the rest of the plan (HAVING, joins,
  ORDER BY/LIMIT, a second aggregate that streams in turn) runs as usual.
- ``try_partitioned`` (grace hash): when a side that row chunks cannot
  split (the build of a semi, anti, left or mark join) is itself too
  large, every large scan is hash-partitioned on its equi-join key into
  K co-partitions, the whole pipeline and the partial aggregation run
  once per partition, and the partials merge as the streamed path's do.
- ``try_streamed_sort``: a full ORDER BY (no LIMIT) over a pipeline with
  a large scan runs the pipeline chunk by chunk, compacts each chunk's
  rows on the device, stages them in host RAM, and merges them on the
  host with one stable lexsort.

What differs from the JAX package:

- The plan functions run eagerly: there is no jit cache. The capacity
  knobs the chunks discover stick to the cached stream plan for the
  next run, as the JAX package's ``caps`` do.
- Sizing is this card's (``_stream_sizing``): the budget is the free
  device memory, the tile limit is the executor's ``_MAX_CAP``, and the
  multipliers come from the peaks measured on the H100.
- The final merge need not fit one tile: when the partial rows exceed
  ``_MAX_CAP`` they are hash-partitioned by group key into parts of at
  most one tile, and each part merges on its own. Keys are disjoint
  across parts, so the parts' finals together are the one merge's rows.
- Grace hash takes a pipeline by rows as well as by bytes: a chunk-proof
  side past the tile limit makes it a candidate, and K grows until every
  partition of every partitioned scan fits one tile. Partition ids are
  computed on the device from the cached key column when the columns fit
  (host blocks otherwise), once per (table, key column) in a run.
- The host-merged ORDER BY compacts each chunk's live rows on the device
  before fetching them: the JAX package fetches whole chunk tiles.
- Every spill leaves a record in ``executor.stream_log`` with its
  ``path`` ("streamed", "partitioned" or "sort"), why it was taken, its
  mode (device columns sliced, or host blocks copied per chunk), its
  sizes and its seconds per stage.

The JAX package's failpoint sites are here under their names:
``executor/stream-start``, ``executor/stream-sort``, ``executor/stream-chunk``
(each chunk fed, ``executor/stream-chunk-device`` too when the chunk slices
device columns), ``executor/partition-start`` once the grace-hash path is
committed and ``executor/partition-feed`` at each partition.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from tidb_tpu_torch.chunk import (
    Batch,
    DevCol,
    HostBlock,
    HostColumn,
    block_to_batch,
    fetch,
    pad_capacity,
)
from tidb_tpu_torch.executor.aggregate import WIDTH_STALE, _next_pow2, group_aggregate
from tidb_tpu_torch.executor.project import compact
from tidb_tpu_torch.expression.expr import ColumnRef
from tidb_tpu_torch.expression.kernels import compile_expr
from tidb_tpu_torch.parallel.fragment import (
    _partial_descs,
    apply_post_avg,
    build_final_stage,
    key_partition,
)
from tidb_tpu_torch.planner import logical as L
from tidb_tpu_torch.planner import physical as P
from tidb_tpu_torch.planner.physical import (
    _BOUNDS_PREFIX,
    ExecError,
    PlanCompiler,
    StaleWidthsError,
    _cap_tile,
    _plan_children,
    _resolve_bounds,
    agg_out_dicts,
    build_agg_parts,
)
from tidb_tpu_torch.storage import scan as _scan
from tidb_tpu_torch.utils.failpoint import inject

_STAGED_NONCE = [0]

# Sizing, from the peaks chip_smoke.py measured for TPC-H SF10 on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 5: device memory
# allocated above what was resident, over the bytes the plan's scans
# hold at their tiles).
#: single-scan pipelines: Q1 (16 accumulation lanes stacked for one
#: slot_sums call) peaked 15.6 GB above its 3.42 GB of columns, 4.6x
_MULT_SCAN = 5
#: pipelines with joins: Q18 12.4 GB over 1.76 GB (7.0x), Q10 6.7x, Q9 4.1x
_MULT_JOIN = 8
#: bytes a chunk row costs at least: Q18's claim loop over a 2^26-row
#: join output tile, the widest hash aggregation measured, took 12.4 GB,
#: 185 bytes a row
_ROW_FLOOR = 192
#: share of the budget a plan may plan to fill: the rest absorbs the
#: allocator's rounding and what the estimates miss
_BUDGET_FILL = 0.9
#: the CPU's budget (tests, a run on the host): the JAX package's
_HOST_BUDGET = 4 << 30
#: the fewest rows a chunk holds
_MIN_CHUNK = 1 << 10
#: the most hash partitions grace hash tries before it declines
_MAX_PARTS = 1024


def _collect_pipeline_scans(p, scans, flags, chunkable=True) -> bool:
    """Walk a streaming pipeline (Selection/Projection chains over Scans
    composed with equi-joins) collecting (scan, chunkable) pairs.

    A scan is CHUNKABLE when splitting it into row chunks and unioning
    the per-chunk pipeline outputs equals running the whole pipeline:
    either side of an inner join distributes over row-union, but only
    the probe (left) side of left/semi/anti/mark joins does. Returns
    False when the subtree holds anything else."""
    while isinstance(p, (L.Selection, L.Projection)):
        p = p.child
    if isinstance(p, L.Staged):
        # an already-staged (streamed lower aggregate) result: resident,
        # closed over by the pipeline, never the chunked side. Lets a
        # second aggregate above a staged one stream too (Q18's outer
        # GROUP BY over the HAVING subquery).
        return True
    if isinstance(p, L.Scan):
        if p.frag is not None:
            return False
        scans.append(p)
        flags.append(chunkable)
        return True
    if isinstance(p, L.JoinPlan):
        if p.kind == "inner":
            return _collect_pipeline_scans(
                p.left, scans, flags, chunkable
            ) and _collect_pipeline_scans(p.right, scans, flags, chunkable)
        if p.kind in ("left", "semi", "anti", "mark"):
            return _collect_pipeline_scans(
                p.left, scans, flags, chunkable
            ) and _collect_pipeline_scans(p.right, scans, flags, False)
    return False


def _pipeline_below(plan):
    """The lowest Aggregate whose input subtree is a streaming pipeline:
    (agg node, scans, chunkable flags), or None. Nodes are visited in
    post-order (a reversed pre-order that takes the last child first),
    with no recursive closure: one would hold the plan, and the staged
    batch in it, in a reference cycle past the statement."""
    order, stack = [], [plan]
    while stack:
        p = stack.pop()
        order.append(p)
        stack.extend(_plan_children(p))
    for p in reversed(order):
        if isinstance(p, L.Aggregate):
            scans, flags = [], []
            if _collect_pipeline_scans(p.child, scans, flags) and scans:
                return p, scans, flags
    return None


class _Read(NamedTuple):
    """What one scan reads: a table's version, and the partition ids it
    keeps (None: every partition; untagged blocks are always read)."""

    table: Any
    version: int
    partitions: Optional[tuple] = None

    def blocks(self):
        return self.table.blocks(self.version, partitions=self.partitions)

    @property
    def nrows(self) -> int:
        return sum(b.nrows for b in self.blocks())


def _resolve_sites(executor, sites) -> dict:
    """Scan site node id -> the ``_Read`` of the compiled site."""
    return {s.node_id: _Read(*executor._resolve(s.db, s.table), s.partitions) for s in sites}


def _resolve_scans(executor, scans, root) -> list:
    """The ``_Read`` of each logical scan under `root`. The sizing runs
    before the compiler, so a scan under a Selection is pruned here as
    the compiler will prune it (``_prune_partitions``)."""
    preds, stack = {}, [root]
    while stack:
        p = stack.pop()
        if isinstance(p, L.Selection) and isinstance(p.child, L.Scan):
            preds[id(p.child)] = p.predicate
        stack.extend(_plan_children(p))
    out = []
    for s in scans:
        parts = (P._prune_partitions(preds[id(s)], s, executor._resolve)
                 if id(s) in preds else None)
        out.append(_Read(*executor._resolve(s.db, s.table), parts))
    return out


def _pick_big_scan(executor, scans, flags, root):
    """(index, ``_Read`` list) of the largest chunkable scan."""
    resolved = _resolve_scans(executor, scans, root)
    big_i = None
    for i, ok in enumerate(flags):
        if ok and (big_i is None or resolved[i].nrows > resolved[big_i].nrows):
            big_i = i
    return big_i, resolved


def _device_budget(device) -> int:
    """Device bytes one statement's working set may take: the card's free
    memory plus what PyTorch's allocator holds unused (it hands that out
    before asking the card). The CPU stages past a fixed 4 GB."""
    if device.type != "cuda":
        return _HOST_BUDGET
    free, _total = torch.cuda.mem_get_info(device)
    return int(free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device))


def _budget(executor) -> int:
    """The device budget, capped at the statement's quota: spilling must
    start at the quota, not when the card runs out."""
    budget = _device_budget(executor.device)
    if executor.quota_bytes:
        budget = min(budget, int(executor.quota_bytes))
    return budget


def _budget_ceiling(executor) -> int:
    """What ``_budget`` can never exceed (the card's memory or the CPU's
    fixed budget, capped at the quota), known without a driver call: the
    grace-hash check runs before every plan with a pipeline, and most
    plans are no candidate even against this ceiling."""
    dev = executor.device
    top = torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda" else _HOST_BUDGET
    return min(top, int(executor.quota_bytes)) if executor.quota_bytes else top


def _row_bytes(r: _Read, columns) -> int:
    """Device bytes per scanned row: data + validity per column, and the
    row mask."""
    total = 1
    for b in r.table.blocks(r.version):
        for name in columns:
            c = b.columns.get(name)
            total += (c.data.dtype.itemsize if c is not None else 8) + 1
        break
    return max(total, 9)


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def _stream_sizing(executor, scans, resolved, big_i, threshold, max_cap, force=False):
    """(chunk_rows or None, sizing facts). Auto mode (-1) streams when the
    big scan's rows exceed the tile limit or when the unpaged working set
    (columns at their tiles times the measured multiplier) overruns the
    budget (the card's free memory, capped at the quota); an explicit
    threshold streams past that row count. `force` (admission rejected
    the unpaged plan) streams even when the aggregate's own input fits.
    Chunks are at most one tile, smaller when the budget left after the
    resident sides cannot hold a full tile's working set; under a quota
    a chunk's own columns count too, since the quota sends chunks from
    host RAM. When one minimal chunk already overruns the quota,
    streaming declines and admission's verdict stands."""
    nrows = resolved[big_i].nrows
    budget = _budget(executor)
    quota = executor.quota_bytes
    rb = _row_bytes(resolved[big_i], scans[big_i].columns)
    others_bytes = sum(pad_capacity(r.nrows) * _row_bytes(r, s.columns)
                       for i, (s, r) in enumerate(zip(scans, resolved)) if i != big_i)
    mult = _MULT_SCAN if len(scans) == 1 else _MULT_JOIN
    per_row = max(mult * rb, _ROW_FLOOR)
    facts = {"budget": budget, "others_bytes": others_bytes, "per_row": per_row}
    if threshold == -1 or force:
        whole = mult * (pad_capacity(nrows) * rb + others_bytes)
        if not force and nrows <= max_cap and whole <= budget:
            return None, facts
        if nrows <= max_cap and others_bytes * 4 > budget:
            # the resident sides alone do not fit: streaming cannot help,
            # and the unpaged plan still has its one tile
            return None, facts
        avail = max(budget - 2 * others_bytes, budget // 4)
        if quota:
            fit = int(avail * _BUDGET_FILL) // (per_row + rb)
        else:
            fit = avail // per_row
        chunk_rows = min(max_cap, max(_MIN_CHUNK, _pow2_floor(fit)))
        if nrows > max_cap:
            facts["why"] = f"{nrows} rows exceed the {max_cap}-row tile"
        elif force:
            facts["why"] = f"admission rejected the unpaged plan under a {quota} B quota"
        else:
            facts["why"] = f"unpaged working set ~{whole} B exceeds the {budget} B budget"
    else:
        if nrows <= threshold:
            return None, facts
        chunk_rows = max(int(threshold), 1)
        facts["why"] = f"{nrows} rows exceed stream_rows={threshold}"
    if quota and min(chunk_rows, _MIN_CHUNK) * per_row > budget:
        return None, facts
    return chunk_rows, facts


def _placed_bytes(executor, r: _Read, columns) -> int:
    """Device bytes a scan of `columns` places (data and validity per
    column at the read's tile, and the row mask). Without a quota only
    what the scan cache does not hold yet counts; under one every column
    counts, cached or not: the quota bounds what the statement holds."""
    tile = pad_capacity(r.nrows)
    dev = str(executor.device)
    counted = (lambda c: True) if executor.quota_bytes else (
        lambda c: not _scan.is_cached(r.table, r.version, c, tile, dev, r.partitions))
    n = tile if counted(_scan.ROW_MASK) else 0
    for c in columns:
        if counted(c):
            n += tile * (r.table.schema.types[c].np_dtype.itemsize + 1)
    return n


def _plan_columns(executor, plan) -> set:
    """(table uid, column) of every column the whole statement scans, and
    each scanned table's row mask: what a release must keep."""
    out, stack = set(), [plan]
    while stack:
        p = stack.pop()
        stack.extend(_plan_children(p))
        if isinstance(p, L.Scan):
            t, _v = executor._resolve(p.db, p.table)
            out |= {(t.uid, c) for c in p.columns} | {(t.uid, _scan.ROW_MASK)}
    return out


def _free_budget(executor) -> int:
    """The card's free memory once PyTorch's unused cached blocks are
    returned (the CPU's fixed budget), capped at the quota."""
    if executor.device.type == "cuda":
        torch.cuda.empty_cache()
        budget = int(torch.cuda.mem_get_info(executor.device)[0])
    else:
        budget = _HOST_BUDGET
    if executor.quota_bytes:
        budget = min(budget, int(executor.quota_bytes))
    return budget


def _release_for(executor, plan, need: int, budget: int):
    """(budget, note): when `need` bytes do not fit the free budget,
    release the cached columns the whole statement does not scan (above
    a streamed aggregate too) and count what that freed. Under a quota
    nothing is released: the quota bounds what the statement holds, and
    other statements' columns are not part of it."""
    if executor.quota_bytes or need <= budget * _BUDGET_FILL:
        return budget, ""
    freed = _scan.release(keep=_plan_columns(executor, plan))
    if not freed:
        return budget, ""
    return budget + freed, f", {freed} B of columns this plan does not scan released"


def _partial_bytes(sp, rows: int, chunks: int) -> int:
    """The partial rows a streamed aggregate may hold: at most a group
    per input row (or per slot of a dense key domain, per chunk), counted
    twice for the merge's partition ids, parts and finals."""
    bits = [kw[0] for kw in sp.key_widths or [] if kw is not None and kw[0] is not None]
    if not sp.key_names:
        groups = chunks
    elif len(bits) == len(sp.key_names) and sum(bits) <= 40:
        groups = min(rows, chunks << sum(bits))
    else:
        groups = rows
    return 2 * groups * (1 + 9 * (len(sp.key_names) + len(sp.partial)))


def _memory_plan(executor, plan, scans, resolved, big_i, chunk_tile, facts, partial_bytes):
    """(device_resident, why): whether the big scan's whole columns go to
    the device once and the chunks slice them there, or each chunk is
    copied from host RAM.

    Either mode holds the resident sides, a chunk's working set (and the
    chunk itself when it comes from host RAM) and `partial_bytes` of
    results. Cached columns that this plan does not scan are released
    when that worst case does not fit; the big columns then go to the
    device if they fit beside the working set. Under a quota the big
    columns count whether cached or not, so a quota smaller than them
    sends chunks from host RAM."""
    budget = _free_budget(executor)
    big_new = _placed_bytes(executor, resolved[big_i], scans[big_i].columns)
    others_new = 0 if executor.quota_bytes else sum(
        _placed_bytes(executor, r, s.columns)
        for i, (s, r) in enumerate(zip(scans, resolved)) if i != big_i
    )
    work = others_new + facts["others_bytes"] + chunk_tile * facts["per_row"]
    why = (f"columns to place {big_new} B, working set ~{work} B, results "
           f"<= {partial_bytes} B, budget {budget} B")
    budget, note = _release_for(executor, plan, big_new + work + partial_bytes, budget)
    facts["budget"] = budget
    return big_new + work <= budget * _BUDGET_FILL, why + note


def _fetch_resident(executor, site, r: _Read):
    """One resident (non-chunked) site's device batch: its index range's
    rows for a narrowed site, else its kept partitions (device-cached)."""
    narrowed = P.fetch_site_rows(r.table, site, r.version, executor.device)
    if narrowed is not None:
        return narrowed
    return _scan.scan_table(r.table, site.columns, version=r.version, device=executor.device,
                            partitions=r.partitions)[0]


def _chunkable(site) -> bool:
    """Whether a scan site may be the chunked one: a site narrowed to an
    index range is read whole (its rows are few), and a site reading the
    row handle addresses the full scan."""
    return site is not None and not site.narrowed and _scan.ROWID not in site.columns


def _replace_node(plan, target, repl):
    if plan is target:
        return repl
    kw = {}
    for attr in ("child", "left", "right"):
        c = getattr(plan, attr, None)
        if c is not None:
            kw[attr] = _replace_node(c, target, repl)
    ch = getattr(plan, "children", None)
    if ch:
        kw["children"] = [_replace_node(c, target, repl) for c in ch]
    if not kw:
        return plan
    return dataclasses.replace(plan, **kw)


def has_staged(plan) -> bool:
    """Whether the plan holds a Staged leaf (a batch baked into whatever
    is compiled from it)."""
    return isinstance(plan, L.Staged) or any(has_staged(c) for c in _plan_children(plan))


def _chunk_blocks(r: _Read, columns, chunk_rows: int):
    """Yield HostBlocks of <= chunk_rows rows over the read's blocks
    (numpy views: no copies until the device transfer)."""
    for b in r.blocks():
        n = b.nrows
        for a in range(0, n, chunk_rows):
            z = min(a + chunk_rows, n)
            cols = {
                name: dataclasses.replace(c, data=c.data[a:z], valid=c.valid[a:z])
                for name, c in b.columns.items()
                if name in columns
            }
            yield HostBlock(cols, z - a)


def _pad_rows(t: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return t
    return torch.cat([t, torch.zeros(pad, dtype=t.dtype, device=t.device)])


class _StreamPlan:
    """The compiled pre-aggregation pipeline of one streamed plan (the big
    scan's site is fed one chunk at a time, every other site its full
    batch), the partial and final aggregate descriptors, and the
    capacities earlier runs discovered."""

    def __init__(self, pipe_fn, dicts, big_site, other_sites, defaults, key_fns,
                 key_names, key_widths, partial, final, nonnull, bound_checks):
        self.pipe_fn = pipe_fn
        self.dicts = dicts
        self.big_site = big_site
        self.other_sites = other_sites
        self.defaults = dict(defaults)  # pipeline capacity knobs (joins)
        self.key_fns = key_fns
        self.key_names = key_names
        self.key_widths = key_widths
        self.partial = partial
        self.fkeys, self.fdescs, self.post_avg = build_final_stage(key_names, final)
        self.nonnull = list(nonnull)
        self.bound_checks = list(bound_checks)
        self.caps = None  # sticky discovered pipeline capacities
        self.agg_cap = None  # sticky partial group capacity

    def chunk_step(self, inputs, cap: int, caps: dict):
        piped, needs = self.pipe_fn(inputs, caps)
        out, ng = group_aggregate(
            piped, self.key_fns, self.partial, cap, self.key_names,
            key_widths=self.key_widths,
        )
        return out, ng, needs

    def final_step(self, combined: Batch, fcap: int):
        return group_aggregate(
            combined, self.fkeys, self.fdescs, fcap, self.key_names,
            key_widths=self.key_widths,
        )


def _stream_plan(executor, plan, agg, big_scan, conservative=False, path="streamed"):
    """The cached _StreamPlan of `plan`, or None when the aggregate cannot
    be split into partial and final stages. A pipeline that holds a
    Staged leaf bakes that batch into its closures: it is built for this
    run only, never cached. Each path keeps its own entry (its sticky
    capacities belong to its chunk or partition sizes)."""
    cache = executor._stream_plans
    key = (
        executor._cache_key(plan),
        (path, big_scan.db, big_scan.table, big_scan.alias),
        conservative,
    )
    if key in cache:
        cache.move_to_end(key)
        return cache[key]
    comp = PlanCompiler(
        executor.catalog, resolver=executor._resolve, conservative=conservative,
        device=executor.device,
    )
    pipe_fn, dicts = comp._build(agg.child)
    entry = None
    big_site = next(
        (s for s in comp.scans
         if (s.db, s.table, s.alias) == (big_scan.db, big_scan.table, big_scan.alias)),
        None,
    )
    if _chunkable(big_site) and not agg.gc_meta:
        key_fns, key_names, key_widths, descs = build_agg_parts(agg, dicts, compiler=comp)
        if not any(a.distinct for a in descs):
            # DISTINCT cannot be split into partial sums across chunks
            # (dedup must see all rows of a group at once): run unpaged
            partial, final = _partial_descs(descs)
            entry = _StreamPlan(
                pipe_fn, dicts, big_site, [s for s in comp.scans if s is not big_site],
                comp.defaults, key_fns, key_names, key_widths, partial, final,
                comp.nonnull, comp.bound_checks,
            )
    if not has_staged(agg.child):
        while len(cache) >= 32:
            cache.popitem(last=False)
        cache[key] = entry
    return entry


def _check_assumptions(sp, site_tables) -> None:
    """Compile-time assumptions (NULL-free columns, bounds that proved a
    decimal SUM safe) must hold at the versions scanned."""
    for nid, col in sp.nonnull:
        r = site_tables[nid]
        if r.table.col_has_nulls(col, r.version):
            raise StaleWidthsError()
    for nid, col, lo, hi in sp.bound_checks:
        r = site_tables[nid]
        cb = r.table.col_bounds(col, r.version)
        if cb is not None and (cb[0] < lo or cb[1] > hi):
            raise StaleWidthsError()


def _sync(device) -> None:
    """Wait for the card before reading the clock (stage seconds)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _chunk_feeds(executor, r: _Read, site, chunk_rows, chunk_tile, inputs_base, device_resident,
                 seconds):
    """Yield the pipeline's inputs chunk by chunk: every resident site's
    full batch and one chunk of the big scan's site, in a fixed tile (the
    last, shorter chunk pads up). Device-resident chunks slice the cached
    columns; host chunks copy their rows from the table's blocks, and
    the copies' seconds add up in seconds["h2d"]."""
    if device_resident:
        full = _scan.scan_table(r.table, site.columns, version=r.version,
                                device=executor.device, partitions=r.partitions)[0]
        for a in range(0, r.nrows, chunk_tile):
            inject("executor/stream-chunk")
            inject("executor/stream-chunk-device")
            z = min(a + chunk_tile, full.capacity)
            pad = chunk_tile - (z - a)
            cols = {
                n: DevCol(_pad_rows(c.data[a:z], pad), _pad_rows(c.valid[a:z], pad))
                for n, c in full.cols.items()
            }
            inputs = dict(inputs_base)
            inputs[site.node_id] = Batch(cols, _pad_rows(full.row_valid[a:z], pad))
            yield inputs
        return
    seconds["h2d"] = 0.0
    for hb in _chunk_blocks(r, site.columns, chunk_rows):
        inject("executor/stream-chunk")
        t0 = time.perf_counter()
        inputs = dict(inputs_base)
        inputs[site.node_id] = block_to_batch(hb, capacity=chunk_tile, device=executor.device)
        _sync(executor.device)
        seconds["h2d"] += time.perf_counter() - t0
        yield inputs


def spill_path(executor, plan) -> Optional[str]:
    """The spill path the executor's sizing would send `plan` down, named,
    or None: the decisions of ``try_partitioned``, ``try_streamed`` and
    ``try_streamed_sort`` taken without running anything."""
    if not executor.stream_rows:
        return None
    m = _pipeline_below(plan)
    if m is not None:
        agg, scans, flags = m
        big_i, resolved = _pick_big_scan(executor, scans, flags, agg.child)
        if _partition_spec(executor, agg, scans, flags, resolved) is not None:
            return "grace hash"
        if big_i is not None and _stream_sizing(
                executor, scans, resolved, big_i, executor.stream_rows, P._MAX_CAP)[0] is not None:
            return "a streamed aggregate"
    node = plan
    while isinstance(node, L.Projection):
        node = node.child
    if isinstance(node, L.Sort):
        scans, flags = [], []
        if _collect_pipeline_scans(node.child, scans, flags) and scans:
            big_i, resolved = _pick_big_scan(executor, scans, flags, node.child)
            if big_i is not None and _stream_sizing(
                    executor, scans, resolved, big_i, executor.stream_rows,
                    P._MAX_CAP)[0] is not None:
                return "the host-merged ORDER BY"
    return None


def try_streamed(executor, plan, conservative=False, force=False):
    """Execute `plan` with a streamed aggregate when it qualifies: the
    lowest Aggregate over a streaming pipeline, with its largest
    chunkable table too big for one tile, for the device budget or for
    the quota. The big scan streams through the whole pipeline chunk by
    chunk. A pipeline that grace hash takes (a side row chunks cannot
    split is itself too large) declines here. ``executor.stream_rows``:
    -1 = auto, >0 = explicit row threshold, 0/None = never stream.
    `force`: admission rejected the unpaged plan. Returns (host batch,
    dicts) or None."""
    threshold = executor.stream_rows
    if not threshold:
        return None
    m = _pipeline_below(plan)
    if m is None:
        return None
    agg, scans, flags = m
    big_i, resolved = _pick_big_scan(executor, scans, flags, agg.child)
    if big_i is None:
        return None
    spec = _partition_spec(executor, agg, scans, flags, resolved, force)
    if spec is not None and spec["unchunkable"]:
        return None
    big_scan = scans[big_i]
    chunk_rows, facts = _stream_sizing(
        executor, scans, resolved, big_i, threshold, P._MAX_CAP, force=force
    )
    if chunk_rows is None:
        return None
    inject("executor/stream-start")
    sp = _stream_plan(executor, plan, agg, big_scan, conservative=conservative)
    if sp is None:
        return None

    site_tables = _resolve_sites(executor, [sp.big_site] + sp.other_sites)
    _check_assumptions(sp, site_tables)
    big = site_tables[sp.big_site.node_id]
    nrows = big.nrows
    # one fixed tile for every chunk (the last, shorter one pads up)
    chunk_tile = pad_capacity(chunk_rows)
    chunks = -(-nrows // chunk_tile)
    device_resident, mode_why = _memory_plan(
        executor, plan, scans, resolved, big_i, chunk_tile, facts,
        _partial_bytes(sp, nrows, chunks),
    )
    inputs_base = {
        s.node_id: _fetch_resident(executor, s, site_tables[s.node_id]) for s in sp.other_sites
    }
    rec = {
        "path": "streamed", "table": big.table.name, "rows": nrows,
        "mode": "device" if device_resident else "host",
        "why": facts["why"], "mode_why": mode_why, "budget_bytes": facts["budget"],
        "quota_bytes": executor.quota_bytes, "chunk_rows": chunk_rows, "chunk_tile": chunk_tile,
    }
    executor.stream_log.append(rec)

    rec["seconds"] = {}
    t0 = time.perf_counter()
    feeds = _chunk_feeds(
        executor, big, sp.big_site, chunk_rows, chunk_tile, inputs_base, device_resident,
        rec["seconds"],
    )
    rec["chunk_s"] = []
    partials, cap = _drain_partials(executor, sp, feeds, chunk_tile, P._MAX_CAP, rec["chunk_s"])
    rec["chunks"] = len(partials)
    rec["partial_rows"] = sum(b.capacity for b in partials)
    rec["seconds"]["chunks"] = time.perf_counter() - t0
    return _finalize_partials(executor, plan, agg, sp, partials, cap, rec, P._MAX_CAP)


def _drain_partials(executor, sp, feeds, default_tile, max_cap, chunk_s):
    """Run the pipeline and the partial aggregation over each chunk,
    growing capacity knobs on overflow as the executor's discovery does
    (one device->host fetch per try), and compact each chunk's partial
    rows into a tile of their own. Each chunk starts at a kill safepoint;
    its host seconds, its feed included, are appended to `chunk_s`.
    Returns (partial batches, the partial group capacity)."""
    cap = sp.agg_cap or 1024
    caps = dict(sp.caps) if sp.caps else {
        nid: (default_tile if d == 0 else d) for nid, d in sp.defaults.items()
    }
    peak = {}
    partials: List[Batch] = []
    t_prev = time.perf_counter()
    for inputs in feeds:
        executor.check_killed()
        for _retry in range(24):
            out, ng, needs = sp.chunk_step(inputs, cap, caps)
            nids = sorted(needs)
            (got,) = fetch([torch.stack(
                [ng.to(torch.int64).reshape(())]
                + [needs[n].to(torch.int64).reshape(()) for n in nids]
            )])
            ngi = int(got[0])
            if ngi >= WIDTH_STALE:
                raise StaleWidthsError()
            bumped = False
            for nid, n in zip(nids, (int(x) for x in got[1:])):
                if n >= WIDTH_STALE:
                    raise StaleWidthsError()
                if nid in caps and n > caps[nid]:
                    caps[nid] = _cap_tile(n)
                    if caps[nid] > max_cap:
                        raise ExecError(f"streamed chunk too large at node {nid}: {n} rows")
                    bumped = True
            if bumped:
                continue
            if sp.key_fns and ngi > out.capacity:
                # the partial table overflowed: retry at the tile the
                # reported count asks for; a chunk holds no more groups
                # than rows
                grown = min(_cap_tile(ngi), _cap_tile(default_tile))
                if grown <= cap:
                    raise ExecError(f"streamed partial aggregate overflowed at {cap} groups")
                cap = grown
                continue
            for nid, n in zip(nids, (int(x) for x in got[1:])):
                if nid in caps and sp.defaults.get(nid) == 0:
                    peak[nid] = max(peak.get(nid, 0), n)
                    # later chunks start at twice the largest count seen
                    caps[nid] = min(caps[nid], _cap_tile(2 * peak[nid]))
            break
        else:
            raise StaleWidthsError()  # capacities never converged
        keep = max(ngi, 1)
        partials.append(out if keep >= out.capacity else compact(out.cols, out.row_valid, keep))
        del out
        now = time.perf_counter()
        chunk_s.append(now - t_prev)
        t_prev = now
    sp.caps = dict(caps)  # discovered capacities stick for reuse
    sp.agg_cap = cap
    return partials, cap


def _merge(sp, combined: Batch, fcap: int):
    """One final aggregation, its group capacity grown until it holds
    every group. Returns (final batch, group count)."""
    while True:
        fin, ng = sp.final_step(combined, fcap)
        ngi = int(fetch([ng.to(torch.int64).reshape(())])[0])
        if ngi >= WIDTH_STALE:
            raise StaleWidthsError()
        if sp.key_names and ngi > fin.capacity:
            grown = min(_cap_tile(ngi), _cap_tile(combined.capacity))
            if grown <= fcap:
                raise ExecError(f"streamed final aggregate overflowed at {fcap} groups")
            fcap = grown
            continue
        return fin, ngi


def _finalize_partials(executor, plan, agg, sp, partials, cap, rec, max_cap):
    """Merge the partial aggregates, inject the result as a Staged node,
    and run the rest of the plan.

    Partial rows within one tile merge in one final aggregation, as the
    JAX package's. More than that are hash-partitioned by group key into
    K parts of at most one tile (K a power of two): each part merges on
    its own and the parts' groups, disjoint by key, are the result."""
    t0 = time.perf_counter()
    total = sum(b.capacity for b in partials)
    fcap = max(cap, 1024)
    if not sp.key_names or total <= max_cap:
        rec["merge"], rec["parts"] = "single", 1
        rec["merge_why"] = f"{total} partial rows fit one {max_cap}-row tile"
        combined = _concat_batches(partials)
        partials.clear()
        fin, groups = _merge(sp, combined, fcap)
        del combined
    else:
        parts = _next_pow2(math.ceil(total / max_cap))
        while True:
            pids = [key_partition([b.cols[n] for n in sp.key_names], parts).to(torch.int16)
                    for b in partials]
            counts = fetch([torch.stack([
                torch.stack([(b.row_valid & (p == k)).sum() for k in range(parts)])
                for b, p in zip(partials, pids)
            ])])[0]
            if int(counts.sum(0).max()) <= max_cap:
                break
            parts *= 2
        rec["merge"], rec["parts"] = "partitioned", parts
        rec["merge_why"] = (
            f"{total} partial rows exceed the {max_cap}-row tile: {parts} parts by key "
            f"hash, at most {int(counts.sum(0).max())} rows each"
        )
        finals, groups = [], 0
        for k in range(parts):
            pieces = [
                compact(b.cols, b.row_valid & (p == k), int(counts[i, k]))
                for i, (b, p) in enumerate(zip(partials, pids)) if counts[i, k]
            ]
            if not pieces:
                continue
            part = _concat_batches(pieces)
            del pieces
            fin, ng = _merge(sp, part, max(1024, min(fcap, _cap_tile(part.capacity))))
            del part
            finals.append(compact(fin.cols, fin.row_valid, max(ng, 1)))
            groups += ng
            del fin
        partials.clear()
        del pids
        fin = _concat_batches(finals)
        del finals
    rec["groups"] = groups
    rec["seconds"]["merge"] = time.perf_counter() - t0

    cols = apply_post_avg(dict(fin.cols), sp.post_avg)
    result = Batch({n: cols[n] for n in [c.internal for c in agg.schema]}, fin.row_valid)
    if not sp.key_names:
        result = _one_row(result, agg)

    # staged column bounds come from the batch's source columns, resolved
    # now: a lazy entry would name a scan site of the stream's compile
    dicts = {}
    for k, val in agg_out_dicts(agg, sp.dicts).items():
        if k.startswith(_BOUNDS_PREFIX):
            val = _resolve_bounds(val)
            if val is None:
                continue
        dicts[k] = val
    _STAGED_NONCE[0] += 1
    staged = L.Staged(agg.schema, batch=result, dicts=dicts, nonce=_STAGED_NONCE[0])
    new_plan = staged if plan is agg else _replace_node(plan, agg, staged)
    del result, fin, cols
    t0 = time.perf_counter()
    out = executor.run(new_plan)
    rec["seconds"]["rest"] = time.perf_counter() - t0
    return out


def _one_row(result: Batch, agg) -> Batch:
    """A scalar aggregate over possibly-empty input yields one row (COUNT
    0, the others NULL), as the in-plan aggregation node does."""
    any_group = result.row_valid.any()
    first = torch.zeros(result.capacity, dtype=torch.bool, device=result.device)
    first[0] = True
    rv = torch.where(any_group, result.row_valid, first)
    funcs = {n: f for n, f, _a, _d in agg.aggs}
    cols = {}
    for n, c in result.cols.items():
        if funcs.get(n) == "count":
            cols[n] = DevCol(
                torch.where(any_group, c.data, torch.zeros_like(c.data)),
                torch.where(any_group, c.valid, first),
            )
        else:
            cols[n] = DevCol(c.data, c.valid & any_group)
    return Batch(cols, rv)


def _concat_batches(batches: List[Batch]) -> Batch:
    if len(batches) == 1:
        return batches[0]
    names = list(batches[0].cols)
    cols = {
        n: DevCol(
            torch.cat([b.cols[n].data for b in batches]),
            torch.cat([b.cols[n].valid for b in batches]),
        )
        for n in names
    }
    return Batch(cols, torch.cat([b.row_valid for b in batches]))


# ---------------------------------------------------------------------------
# grace hash: co-partitioned pipelines
# ---------------------------------------------------------------------------

#: 0x9E3779B97F4A7C15 (the JAX package's multiplicative hash) as an int64
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)


def _trace_col(p, name: str):
    """Descend Selection/Projection/Join chains to the Scan producing
    internal column `name`: (scan, bare column), or None when the column
    is computed rather than a bare scan column."""
    while True:
        if isinstance(p, L.Selection):
            p = p.child
            continue
        if isinstance(p, L.Projection):
            e = dict(p.exprs).get(name)
            if e is None:
                if p.additive:
                    p = p.child
                    continue
                return None
            if isinstance(e, ColumnRef):
                name = e.name
                p = p.child
                continue
            return None
        if isinstance(p, L.Scan):
            pref = p.alias + "."
            if name.startswith(pref) and name[len(pref):] in p.columns:
                return p, name[len(pref):]
            return None
        if isinstance(p, L.JoinPlan):
            hit = _trace_col(p.left, name)
            return hit if hit is not None else _trace_col(p.right, name)
        return None


#: join kinds whose equi key can co-partition both sides
_CO_PARTITIONED = ("inner", "left", "semi", "anti", "mark")


def _big_aliases_below(p, big_aliases: set, out: dict):
    """The big scans' aliases under `p`, assigning each one its partition
    column in `out` through the equi keys of every join whose BOTH sides
    hold big scans (the co-partitioning condition); None when a join
    cannot be co-partitioned: a non-equi or null-aware (NOT IN) join, a
    key that is not a bare column of a big scan, two columns for one
    scan, or big scans only on the build side of a left, anti or mark
    join over a resident probe (each partition would emit every
    unmatched probe row once)."""
    if isinstance(p, (L.Selection, L.Projection)):
        return _big_aliases_below(p.child, big_aliases, out)
    if isinstance(p, L.Scan):
        return {p.alias} if p.alias in big_aliases else set()
    if isinstance(p, L.Staged):
        return set()
    if not isinstance(p, L.JoinPlan):
        return None
    lb = _big_aliases_below(p.left, big_aliases, out)
    rb = _big_aliases_below(p.right, big_aliases, out)
    if lb is None or rb is None:
        return None
    if lb and rb:
        if p.null_aware or not p.equi_keys or p.kind not in _CO_PARTITIONED:
            return None
        lk, rk = p.equi_keys[0]
        if not (isinstance(lk, ColumnRef) and isinstance(rk, ColumnRef)):
            return None
        for key, side in ((lk, p.left), (rk, p.right)):
            hit = _trace_col(side, key.name)
            if hit is None or hit[0].alias not in big_aliases:
                return None
            scan, col = hit
            if out.get(scan.alias, col) != col:
                return None
            out[scan.alias] = col
    elif rb and not lb and p.kind in ("left", "anti", "mark"):
        return None
    return lb | rb


def _partition_spec(executor, agg, scans, flags, resolved, force=False):
    """The grace-hash plan of a pipeline, or None when it is no candidate.

    A scan is big when its rows pass the tile limit or its bytes pass a
    quarter of the budget (an eighth when admission forced this path):
    the JAX package's bar is bytes only, but on this card a scan past
    the tile limit can be far below a quarter of the free memory and
    still be too large for one tile. The pipeline is a candidate when a
    big scan is a side that row chunks cannot split (the build of a
    semi, anti, left or mark join), or, when forced, when two scans are
    big. Every big scan must then co-partition with the others on one
    equi-join key column, and all those columns must share one raw
    representation: the same (kind, scale), and no per-table dictionary
    codes across two tables."""
    max_cap, share = P._MAX_CAP, 8 if force else 4
    rows = [r.nrows for r in resolved]
    sizes = [n * _row_bytes(r, s.columns) for s, r, n in zip(scans, resolved, rows)]

    def big_below(limit):
        bigs = [i for i, (n, sz) in enumerate(zip(rows, sizes))
                if n > max_cap or sz > limit // share]
        unchunkable = [i for i in bigs if not flags[i]]
        return bigs, unchunkable, bool(unchunkable) or (force and len(bigs) >= 2)

    if not big_below(_budget_ceiling(executor))[2]:
        return None
    budget = _budget(executor)
    bar = budget // share
    bigs, unchunkable, candidate = big_below(budget)
    if not candidate:
        return None
    big_aliases = {scans[i].alias for i in bigs}
    if None in big_aliases or len(big_aliases) != len(bigs):
        return None
    cols: dict = {}
    if _big_aliases_below(agg.child, big_aliases, cols) is None or set(cols) != big_aliases:
        return None
    key_types = set()
    for i in bigs:
        t = resolved[i].table
        col = cols[scans[i].alias]
        ty = t.schema.types[col]
        key_types.add((ty.kind, ty.scale))
        if col in t.dictionaries and len({scans[j].table.lower() for j in bigs}) > 1:
            return None
    if len(key_types) > 1:
        return None
    why = "; ".join(
        f"{scans[i].alias}: {rows[i]} rows"
        + (f" exceed the {max_cap}-row tile" if rows[i] > max_cap
           else f", {sizes[i]} B exceed {bar} B of the {budget} B budget")
        + ("" if flags[i] else " (a build side row chunks cannot split)")
        for i in bigs
    )
    return {"bigs": bigs, "cols": cols, "budget": budget, "why": why,
            "big_bytes": sum(sizes[i] for i in bigs), "unchunkable": bool(unchunkable)}


def _part_ids(data: torch.Tensor, valid: torch.Tensor, rows: torch.Tensor, parts: int):
    """Each row's partition (int16): the top bits of a multiplicative
    hash of the key's raw 64-bit value, mod `parts` (a power of two). A
    NULL key goes to partition 0 (it never equi-matches, and a probe row
    must still appear once); -0.0 is folded into 0.0 first, since they
    equi-match; rows outside `rows` (the tile's padding) get `parts`.
    Runs in slices of one tile, so the int64 temporaries stay small."""
    out = torch.empty(data.shape[0], dtype=torch.int16, device=data.device)
    step = 1 << 26
    for a in range(0, data.shape[0], step):
        d = data[a:a + step]
        if d.is_floating_point():
            d = torch.where(d == 0, torch.zeros_like(d), d).to(torch.float64).view(torch.int64)
        h = d.to(torch.int64) * _GOLDEN
        p = ((h >> 33) & (parts - 1)).to(torch.int16)
        p = torch.where(valid[a:a + step], p, torch.zeros_like(p))
        out[a:a + step] = torch.where(rows[a:a + step], p, torch.full_like(p, parts))
    return out


def _take(cols: dict, idx: torch.Tensor, tile: int) -> Batch:
    """Rows `idx` of `cols` in the first slots of a `tile`-row batch (the
    rest zero and invalid)."""
    n = idx.shape[0]
    live = torch.arange(tile, device=idx.device) < n
    src = torch.zeros(tile, dtype=torch.int64, device=idx.device)
    src[:n] = idx
    out = {}
    for name, c in cols.items():
        d = c.data[src]
        out[name] = DevCol(torch.where(live, d, torch.zeros_like(d)), c.valid[src] & live)
    return Batch(out, live)


class _Assignment:
    """Partition ids of one (read, key column) for one run: on the
    device over the cached tile, or per host block."""

    def __init__(self, executor, table, version, col, parts, on_device, partitions=None):
        self.read = r = _Read(table, version, partitions)
        self.on_device, self.device = on_device, executor.device
        if on_device:
            full = self._scan([col])
            c = full.cols[col]
            self.ids = [_part_ids(c.data, c.valid, full.row_valid, parts)]
        else:
            self.ids = []
            for b in r.blocks():
                hc = b.columns.get(col)
                if hc is None:
                    ids = torch.zeros(b.nrows, dtype=torch.int16)
                else:
                    ids = _part_ids(torch.from_numpy(hc.data), torch.from_numpy(hc.valid),
                                    torch.ones(b.nrows, dtype=torch.bool), parts)
                self.ids.append(ids)
        self.counts = torch.stack([torch.bincount(i, minlength=parts + 1)[:parts]
                                   for i in self.ids]).sum(0)
        self._rows = {}

    def _scan(self, columns) -> Batch:
        r = self.read
        return _scan.scan_table(r.table, columns, version=r.version, device=self.device,
                                partitions=r.partitions)[0]

    @property
    def nbytes(self) -> int:
        return sum(i.nbytes for i in self.ids)

    def rows(self, k: int):
        """Row indices of partition k: one index tensor over the device
        tile, or one numpy array per host block. Shared by every site
        scanning this (table, column)."""
        if k not in self._rows:
            self._rows = {k: [torch.nonzero(i == k).squeeze(1) for i in self.ids]}
        return self._rows[k]

    def batch(self, columns, k: int, tile: int) -> Batch:
        """Partition k of `columns` in a `tile`-row batch on the device."""
        idx = self.rows(k)
        if self.on_device:
            return _take(self._scan(columns).cols, idx[0], tile)
        types = self.read.table.schema.types
        cols = {c: ([], []) for c in columns}
        n = 0
        for b, ix in zip(self.read.blocks(), idx):
            ix = ix.numpy()
            n += len(ix)
            for c in columns:
                hc = b.columns.get(c)
                cols[c][0].append(
                    hc.data[ix] if hc is not None else np.zeros(len(ix), dtype=types[c].np_dtype))
                cols[c][1].append(hc.valid[ix] if hc is not None else np.zeros(len(ix), bool))
        hb = HostBlock({c: HostColumn(types[c], np.concatenate(d), np.concatenate(vm))
                        for c, (d, vm) in cols.items()}, n)
        return block_to_batch(hb, capacity=tile, device=self.device)


def try_partitioned(executor, plan, conservative=False, force=False):
    """Grace hash: execute `plan` with its big scans hash-partitioned on
    their equi-join key into K co-partitions when it qualifies
    (``_partition_spec``): the whole pipeline and the partial aggregation
    run once per partition, every other scan resident, and the partials
    merge as the streamed path's do.

    K starts from the JAX package's rule (the smallest power of two from
    2 for which the big scans' bytes x4 / K fit the budget, at most 64)
    and doubles until every partition of every partitioned scan fits one
    tile. It declines on key skew: when the partitions' tiles x4 pass
    twice the budget. Partition ids come from the device when the
    partitioned scans' columns fit it (each partition's rows then
    gathered from the cached tiles), else from host blocks. `force`:
    admission rejected the unpaged plan. Returns (host batch, dicts) or
    None."""
    if not executor.stream_rows:
        return None
    m = _pipeline_below(plan)
    if m is None:
        return None
    agg, scans, flags = m
    resolved = _resolve_scans(executor, scans, agg.child)
    spec = _partition_spec(executor, agg, scans, flags, resolved, force)
    if spec is None:
        return None
    sp = _stream_plan(executor, plan, agg, scans[spec["bigs"][0]], conservative=conservative,
                      path="partitioned")
    if sp is None:
        return None
    sites = [sp.big_site] + sp.other_sites
    cols = spec["cols"]
    parted = [s for s in sites if s.alias in cols]
    if any(s.narrowed for s in parted):
        return None  # an index range on a partitioned site
    site_tables = _resolve_sites(executor, sites)
    _check_assumptions(sp, site_tables)
    budget, max_cap = spec["budget"], P._MAX_CAP
    parts = 2
    while parts < 64 and (spec["big_bytes"] * 4) // parts > budget:
        parts *= 2
    rows = {s.node_id: site_tables[s.node_id].nrows for s in sites}
    most = max(rows[s.node_id] for s in parted)
    parts = max(parts, _next_pow2(-(-most // max_cap)))

    # device or host partitions: the partitioned scans' columns, their
    # partition ids and a partition's working set must fit beside the
    # resident sides
    keys = {}  # (table uid, version, column, partitions) -> sites
    for s in parted:
        r = site_tables[s.node_id]
        keys.setdefault((r.table.uid, r.version, cols[s.alias], r.partitions), []).append(s)
    residents = [s for s in sites if s.alias not in cols]
    rb = {s.node_id: _row_bytes(site_tables[s.node_id], s.columns) for s in sites}
    resident_bytes = sum(pad_capacity(rows[s.node_id]) * rb[s.node_id] for s in residents)
    # (table uid, version, partitions) -> (read, the columns its
    # partitioned sites read)
    scanned = {}
    for s in parted:
        r = site_tables[s.node_id]
        scanned.setdefault((r.table.uid, r.version, r.partitions), (r, set()))[1].update(s.columns)
    placed = sum(_placed_bytes(executor, r, sorted(c)) for r, c in scanned.values())
    placed += sum(2 * pad_capacity(rows[ss[0].node_id]) for ss in keys.values())
    work = sum(pad_capacity(rows[s.node_id] // parts)
               * max(_MULT_JOIN * rb[s.node_id], _ROW_FLOOR) for s in parted)
    free = _free_budget(executor)
    free, note = _release_for(executor, plan, placed + work + resident_bytes, free)
    on_device = placed + work + resident_bytes <= free * _BUDGET_FILL

    t0 = time.perf_counter()
    while True:
        assigns = {}
        for k, ss in keys.items():
            r = site_tables[ss[0].node_id]
            assigns[k] = _Assignment(executor, r.table, r.version, k[2], parts, on_device,
                                     r.partitions)
        counts = fetch([torch.stack([a.counts for a in assigns.values()])])[0]
        if int(counts.max()) <= max_cap:
            break
        if parts >= _MAX_PARTS:
            return None  # one key holds more rows than a tile
        parts *= 2
    tiles = {key: pad_capacity(int(c.max()) or 1) for key, c in zip(assigns, counts)}
    part_bytes = sum(tiles[k] * rb[s.node_id] for k, ss in keys.items() for s in ss)
    if part_bytes * 4 > budget * 2:
        return None  # key skew: a hot key fills one partition
    _sync(executor.device)
    assign_s = time.perf_counter() - t0
    inputs_base = {s.node_id: _fetch_resident(executor, s, site_tables[s.node_id])
                   for s in residents}
    labels = {k: f"{ss[0].table}.{k[2]}" for k, ss in keys.items()}
    rec = {
        "path": "partitioned", "K": parts, "mode": "device" if on_device else "host",
        "partitioned": {s.alias: f"{s.table}.{cols[s.alias]}" for s in parted},
        "largest_partition_rows": {labels[k]: int(c.max()) for k, c in zip(keys, counts)},
        "partition_tiles": {labels[k]: tiles[k] for k in keys},
        "resident": [s.alias for s in residents],
        "why": spec["why"],
        "mode_why": (f"partitioned columns to place {placed} B, partition working set ~{work} B,"
                     f" resident {resident_bytes} B, budget {free} B{note}"),
        "budget_bytes": budget, "quota_bytes": executor.quota_bytes,
        "assignment_bytes": sum(a.nbytes for a in assigns.values()),
    }
    executor.stream_log.append(rec)
    gather_s = [0.0]
    inject("executor/partition-start")  # the path is committed

    def feeds():
        for k in range(parts):
            inject("executor/partition-feed")
            t1 = time.perf_counter()
            inputs = dict(inputs_base)
            for key, ss in keys.items():
                for s in ss:
                    inputs[s.node_id] = assigns[key].batch(s.columns, k, tiles[key])
            _sync(executor.device)
            gather_s[0] += time.perf_counter() - t1
            yield inputs

    t0 = time.perf_counter()
    rec["chunk_s"] = []
    partials, cap = _drain_partials(executor, sp, feeds(), max(tiles.values()), max_cap,
                                    rec["chunk_s"])
    del assigns
    rec["chunks"] = len(partials)
    rec["partial_rows"] = sum(b.capacity for b in partials)
    rec["seconds"] = {"assignment": assign_s, "gathers": gather_s[0],
                      "pipeline": time.perf_counter() - t0 - gather_s[0]}
    return _finalize_partials(executor, plan, agg, sp, partials, cap, rec, max_cap)


# ---------------------------------------------------------------------------
# the host-merged ORDER BY
# ---------------------------------------------------------------------------


def _expr_column_refs(e, out: set) -> None:
    """The ColumnRef names in an expression tree."""
    if isinstance(e, ColumnRef):
        out.add(e.name)
        return
    if dataclasses.is_dataclass(e):
        for f in dataclasses.fields(e):
            val = getattr(e, f.name)
            for item in val if isinstance(val, (list, tuple)) else [val]:
                if dataclasses.is_dataclass(item):
                    _expr_column_refs(item, out)


class _SortStreamPlan:
    """The compiled pipeline of one streamed ORDER BY (the plan without
    its Sort: projections above it apply per chunk), its sort-key
    functions, and the capacities earlier runs discovered."""

    def __init__(self, pipe_fn, dicts, big_site, other_sites, defaults, key_fns,
                 nonnull, bound_checks):
        self.pipe_fn = pipe_fn
        self.dicts = dicts
        self.big_site = big_site
        self.other_sites = other_sites
        self.defaults = dict(defaults)
        self.key_fns = key_fns
        self.nonnull = list(nonnull)
        self.bound_checks = list(bound_checks)
        self.caps = None


def _sort_stream_plan(executor, plan, sort, big_scan, conservative=False):
    """The cached _SortStreamPlan of `plan`, or None when a sort key is
    not computable on the pipeline's output (a projection above the Sort
    pruned a hidden ORDER BY column)."""
    cache = executor._stream_plans
    key = (
        executor._cache_key(plan),
        ("sort", big_scan.db, big_scan.table, big_scan.alias),
        conservative,
    )
    if key in cache:
        cache.move_to_end(key)
        return cache[key]
    entry = None
    inner = _replace_node(plan, sort, sort.child)
    refs: set = set()
    for e, _d in sort.keys:
        _expr_column_refs(e, refs)
    if refs <= {c.internal for c in inner.schema}:
        comp = PlanCompiler(
            executor.catalog, resolver=executor._resolve, conservative=conservative,
            device=executor.device,
        )
        pipe_fn, dicts = comp._build(inner)
        big_site = next(
            (s for s in comp.scans
             if (s.db, s.table, s.alias) == (big_scan.db, big_scan.table, big_scan.alias)),
            None,
        )
        if _chunkable(big_site):
            entry = _SortStreamPlan(
                pipe_fn, dicts, big_site, [s for s in comp.scans if s is not big_site],
                comp.defaults, [compile_expr(e, dicts) for e, _d in sort.keys],
                comp.nonnull, comp.bound_checks,
            )
    if not has_staged(plan):
        while len(cache) >= 32:
            cache.popitem(last=False)
        cache[key] = entry
    return entry


def host_order(keys, descs) -> np.ndarray:
    """The stable order of rows under ORDER BY `keys` ((data, valid)
    numpy pairs) with MySQL's NULL order: NULLs first ascending, last
    descending, through an explicit rank per key (no sentinel value
    that real data could hold). ``np.lexsort`` sorts by its last array
    first, so the arrays go [value_kN, rank_kN, ..., value_k0, rank_k0]."""
    lex = []
    for (kdat, kval), desc in zip(keys, descs):
        if desc:
            rank = np.where(kval, 0, 1)
            val = (-kdat.astype(np.float64) if np.issubdtype(kdat.dtype, np.floating)
                   else -kdat.astype(np.int64))
        else:
            rank = np.where(kval, 1, 0)
            val = kdat
        lex = [np.where(kval, val, 0), rank] + lex
    return np.lexsort(lex)


def try_streamed_sort(executor, plan, conservative=False):
    """A full ORDER BY over a pipeline whose big scan is too large (the
    streamed aggregate's sizing): when the plan's root is a Sort (under
    optional Projections) over a streaming pipeline, the pipeline runs
    chunk by chunk on the device, each chunk's live rows are compacted
    on the device and fetched with their sort keys into host RAM, and
    one stable lexsort on the host orders them. LIMIT shapes never come
    here: they keep the top-N on the device.

    Returns (column internal names, {name: (data, valid)} in order, row
    count, dicts) or None."""
    threshold = executor.stream_rows
    if not threshold:
        return None
    node = plan
    while isinstance(node, L.Projection):
        node = node.child
    if not isinstance(node, L.Sort):
        return None
    sort = node
    scans, flags = [], []
    if not _collect_pipeline_scans(sort.child, scans, flags) or not scans:
        return None
    big_i, resolved = _pick_big_scan(executor, scans, flags, sort.child)
    if big_i is None:
        return None
    chunk_rows, facts = _stream_sizing(executor, scans, resolved, big_i, threshold, P._MAX_CAP)
    if chunk_rows is None:
        return None
    inject("executor/stream-sort")
    sp = _sort_stream_plan(executor, plan, sort, scans[big_i], conservative=conservative)
    if sp is None:
        return None
    site_tables = _resolve_sites(executor, [sp.big_site] + sp.other_sites)
    _check_assumptions(sp, site_tables)
    big = site_tables[sp.big_site.node_id]
    chunk_tile = pad_capacity(chunk_rows)
    device_resident, mode_why = _memory_plan(
        executor, plan, scans, resolved, big_i, chunk_tile, facts, 0
    )
    inputs_base = {
        s.node_id: _fetch_resident(executor, s, site_tables[s.node_id]) for s in sp.other_sites
    }
    out_names = [c.internal for c in plan.schema]
    executor.stream_log = []
    executor.last_compiled = None
    rec = {
        "path": "sort", "table": big.table.name, "rows": big.nrows,
        "mode": "device" if device_resident else "host",
        "why": facts["why"], "mode_why": mode_why, "budget_bytes": facts["budget"],
        "quota_bytes": executor.quota_bytes, "chunk_rows": chunk_rows, "chunk_tile": chunk_tile,
    }
    executor.stream_log.append(rec)

    caps = dict(sp.caps) if sp.caps else {
        nid: (chunk_tile if d == 0 else d) for nid, d in sp.defaults.items()
    }
    peak = {}
    runs = []
    staged_rows = chunks = 0
    fetch_s = 0.0
    rec["seconds"] = {}
    t0 = time.perf_counter()
    feeds = _chunk_feeds(
        executor, big, sp.big_site, chunk_rows, chunk_tile, inputs_base, device_resident,
        rec["seconds"],
    )
    for inputs in feeds:
        executor.check_killed()
        for _retry in range(24):
            b, needs = sp.pipe_fn(inputs, caps)
            nids = sorted(needs)
            (got,) = fetch([torch.stack(
                [needs[n].to(torch.int64).reshape(()) for n in nids]
                + [b.row_valid.sum(dtype=torch.int64)]
            )])
            true_n = dict(zip(nids, (int(x) for x in got[:-1])))
            if any(n >= WIDTH_STALE for n in true_n.values()):
                raise StaleWidthsError()
            bumped = False
            for nid, n in true_n.items():
                if nid in caps and n > caps[nid]:
                    caps[nid] = _cap_tile(n)
                    if caps[nid] > P._MAX_CAP:
                        raise ExecError(f"streamed chunk too large at node {nid}: {n} rows")
                    bumped = True
            if not bumped:
                break
        else:
            raise StaleWidthsError()  # capacities never converged
        for nid, n in true_n.items():
            if nid in caps and sp.defaults.get(nid) == 0:
                peak[nid] = max(peak.get(nid, 0), n)
                caps[nid] = min(caps[nid], _cap_tile(2 * peak[nid]))
        n = int(got[-1])
        staged_rows += n
        chunks += 1
        if n:
            cols = {f"\x00key{i}": f(b) for i, f in enumerate(sp.key_fns)}
            cols.update((name, b.cols[name]) for name in out_names)
            live = compact(cols, b.row_valid, n)
            t1 = time.perf_counter()
            arrays = fetch([x for c in live.cols.values() for x in (c.data, c.valid)])
            fetch_s += time.perf_counter() - t1
            runs.append({name: (arrays[2 * i], arrays[2 * i + 1])
                         for i, name in enumerate(live.cols)})
            del live, cols
        del b
    sp.caps = dict(caps)
    rec["chunks"] = chunks
    rec["rows_staged"] = staged_rows
    rec["seconds"].update(chunks=time.perf_counter() - t0 - fetch_s, fetches=fetch_s)

    t0 = time.perf_counter()
    names = [f"\x00key{i}" for i in range(len(sp.key_fns))] + out_names

    def joined(name):
        parts = [r[name] for r in runs]
        if not parts:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool)
        return np.concatenate([d for d, _v in parts]), np.concatenate([v for _d, v in parts])

    staged = {name: joined(name) for name in names}
    runs.clear()
    order = host_order([staged[f"\x00key{i}"] for i in range(len(sp.key_fns))],
                       [d for _e, d in sort.keys])
    out = {name: (staged[name][0][order], staged[name][1][order]) for name in out_names}
    rec["seconds"]["merge"] = time.perf_counter() - t0
    return out_names, out, len(order), sp.dicts
