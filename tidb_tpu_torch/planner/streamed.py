"""Streamed (paged) aggregation: the spill path.

Counterpart of tidb_tpu/planner/streamed.py (``try_streamed``). When an
aggregation's largest input table is too large for one device tile or
for the card's free memory, the pre-aggregation pipeline (scan ->
filter -> project -> equi-joins against resident sides) runs CHUNK BY
CHUNK on the device, each chunk is partially aggregated, only the
partial group rows stay on the device, and a final aggregation merges
them (the partial/final split of ``parallel/fragment.py``). The merged
result re-enters the plan as an ``L.Staged`` leaf and the rest of the
plan (HAVING, joins, ORDER BY/LIMIT, a second aggregate that streams in
turn) runs as usual.

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
- Every streamed aggregate leaves a record in ``executor.stream_log``
  (mode, chunking, partial and merge sizes, seconds per stage).

There are no DML pins, failpoints, kill checks or prepared-statement
parameters in the port.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional

import torch

from tidb_tpu_torch.chunk import Batch, DevCol, HostBlock, block_to_batch, fetch, pad_capacity
from tidb_tpu_torch.executor.aggregate import WIDTH_STALE, _next_pow2, group_aggregate
from tidb_tpu_torch.executor.project import compact
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


def _pick_big_scan(executor, scans, flags):
    """(index, (table, version) list) of the largest chunkable scan."""
    resolved = [executor._resolve(s.db, s.table) for s in scans]
    big_i = None
    for i, ok in enumerate(flags):
        if ok and (big_i is None or resolved[i][0].nrows > resolved[big_i][0].nrows):
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


def _row_bytes(table, version, columns) -> int:
    """Device bytes per scanned row: data + validity per column, and the
    row mask."""
    total = 1
    for b in table.blocks(version):
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


def _stream_sizing(executor, scans, resolved, big_i, threshold, max_cap):
    """(chunk_rows or None, sizing facts). Auto mode (-1) streams when the
    big scan's rows exceed the tile limit or when the unpaged working set
    (columns at their tiles times the measured multiplier) overruns the
    device budget; an explicit threshold streams past that row count.
    Chunks are at most one tile, smaller when the budget left after the
    resident sides cannot hold a full tile's working set."""
    t, v = resolved[big_i]
    big = scans[big_i]
    budget = _device_budget(executor.device)
    rb = _row_bytes(t, v, big.columns)
    others = [(s, ot, ov) for i, (s, (ot, ov)) in enumerate(zip(scans, resolved)) if i != big_i]
    others_bytes = sum(pad_capacity(ot.nrows) * _row_bytes(ot, ov, s.columns) for s, ot, ov in others)
    mult = _MULT_SCAN if len(scans) == 1 else _MULT_JOIN
    facts = {"budget": budget, "others_bytes": others_bytes, "per_row": max(mult * rb, _ROW_FLOOR)}
    if threshold == -1:
        whole = mult * (pad_capacity(t.nrows) * rb + others_bytes)
        if t.nrows <= max_cap and whole <= budget:
            return None, facts
        if t.nrows <= max_cap and others_bytes * 4 > budget:
            # the resident sides alone do not fit: streaming cannot help,
            # and the unpaged plan still has its one tile
            return None, facts
        avail = max(budget - 2 * others_bytes, budget // 4)
        chunk_rows = min(max_cap, max(1 << 14, _pow2_floor(avail // facts["per_row"])))
        facts["why"] = (
            f"{t.nrows} rows exceed the {max_cap}-row tile" if t.nrows > max_cap
            else f"unpaged working set ~{whole} B exceeds the {budget} B budget"
        )
    else:
        if t.nrows <= threshold:
            return None, facts
        chunk_rows = max(int(threshold), 1)
        facts["why"] = f"{t.nrows} rows exceed stream_rows={threshold}"
    return chunk_rows, facts


def _uncached_bytes(executor, table, version, columns, row_mask=False) -> int:
    """Device bytes a scan of `columns` would place that the scan cache
    does not hold yet (data and validity per column at the table's tile)."""
    tile = pad_capacity(table.nrows)
    dev = str(executor.device)
    n = tile if row_mask and not _scan.is_cached(table, version, _scan.ROW_MASK, tile, dev) else 0
    for c in columns:
        if not _scan.is_cached(table, version, c, tile, dev):
            n += tile * (table.schema.types[c].np_dtype.itemsize + 1)
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


def _memory_plan(executor, plan, sp, scans, resolved, big_i, chunk_tile, facts):
    """(device_resident, why): whether the big scan's whole columns go to
    the device once and the chunks slice them there, or each chunk is
    copied from host RAM.

    Either mode holds the resident sides, the larger of a chunk's and a
    merge part's working set, and the partial rows: at most a group per
    chunk row (or per slot of a dense key domain), counted twice for the
    merge's partition ids, parts and finals. Cached columns that this
    plan does not scan are released when that worst case does not fit;
    the big columns then go to the device if they fit beside the working
    set. The budget is the card's free memory once PyTorch's unused
    cached blocks are returned. A release keeps every column the whole
    statement scans, above the streamed aggregate too."""
    t, v = resolved[big_i]
    if executor.device.type == "cuda":
        torch.cuda.empty_cache()
        budget = int(torch.cuda.mem_get_info(executor.device)[0])
    else:
        budget = facts["budget"]
    big_new = _uncached_bytes(executor, t, v, scans[big_i].columns, row_mask=True)
    others_new = sum(
        _uncached_bytes(executor, ot, ov, s.columns, row_mask=True)
        for i, (s, (ot, ov)) in enumerate(zip(scans, resolved)) if i != big_i
    )
    chunks = -(-t.nrows // chunk_tile)
    bits = [w for w, _b in sp.key_widths if w is not None] if sp.key_names else []
    if not sp.key_names:
        groups = chunks
    elif len(bits) == len(sp.key_names) and sum(bits) <= 40:
        groups = min(t.nrows, chunks << sum(bits))
    else:
        groups = t.nrows
    partial_bytes = 2 * groups * (1 + 9 * (len(sp.key_names) + len(sp.partial)))
    work = others_new + facts["others_bytes"] + chunk_tile * facts["per_row"]
    keep = _plan_columns(executor, plan)
    why = (f"columns to place {big_new} B, working set ~{work} B, partials "
           f"<= {partial_bytes} B, free {budget} B")
    if big_new + work + partial_bytes > budget * _BUDGET_FILL:
        freed = _scan.release(keep=keep)
        if freed:
            budget += freed
            why += f", {freed} B of columns this plan does not scan released"
    facts["budget"] = budget
    return big_new + work <= budget * _BUDGET_FILL, why


def _fetch_resident(executor, site, st, sv):
    """One resident (non-chunked) site's device batch (device-cached)."""
    return _scan.scan_table(st, site.columns, version=sv, device=executor.device)[0]


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


def _chunk_blocks(table, version, columns, chunk_rows: int):
    """Yield HostBlocks of <= chunk_rows rows over the table's blocks
    (numpy views: no copies until the device transfer)."""
    for b in table.blocks(version):
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


def _stream_plan(executor, plan, agg, big_scan, conservative=False):
    """The cached _StreamPlan of `plan`, or None when the aggregate cannot
    be split into partial and final stages. A pipeline that holds a
    Staged leaf bakes that batch into its closures: it is built for this
    run only, never cached."""
    cache = executor._stream_plans
    key = (
        executor._cache_key(plan),
        (big_scan.db, big_scan.table, big_scan.alias),
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
    if big_site is not None and not agg.gc_meta:
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


def try_streamed(executor, plan, conservative=False):
    """Execute `plan` with a streamed aggregate when it qualifies: the
    lowest Aggregate over a streaming pipeline, with its largest
    chunkable table too big for one tile or for the device budget. The
    big scan streams through the whole pipeline chunk by chunk.
    ``executor.stream_rows``: -1 = auto, >0 = explicit row threshold,
    0/None = never stream. Returns (host batch, dicts) or None."""
    threshold = executor.stream_rows
    if not threshold:
        return None
    m = _pipeline_below(plan)
    if m is None:
        return None
    agg, scans, flags = m
    big_i, resolved = _pick_big_scan(executor, scans, flags)
    if big_i is None:
        return None
    big_scan = scans[big_i]
    chunk_rows, facts = _stream_sizing(executor, scans, resolved, big_i, threshold, P._MAX_CAP)
    if chunk_rows is None:
        return None
    sp = _stream_plan(executor, plan, agg, big_scan, conservative=conservative)
    if sp is None:
        return None

    site_tables = {
        s.node_id: executor._resolve(s.db, s.table) for s in [sp.big_site] + sp.other_sites
    }
    # compile-time assumptions must hold at the versions scanned
    for nid, col in sp.nonnull:
        st, sv = site_tables[nid]
        if st.col_has_nulls(col, sv):
            raise StaleWidthsError()
    for nid, col, lo, hi in sp.bound_checks:
        st, sv = site_tables[nid]
        cb = st.col_bounds(col, sv)
        if cb is not None and (cb[0] < lo or cb[1] > hi):
            raise StaleWidthsError()
    t, v = site_tables[sp.big_site.node_id]
    # one fixed tile for every chunk (the last, shorter one pads up)
    chunk_tile = pad_capacity(chunk_rows)
    device_resident, mode_why = _memory_plan(
        executor, plan, sp, scans, resolved, big_i, chunk_tile, facts
    )
    inputs_base = {
        s.node_id: _fetch_resident(executor, s, *site_tables[s.node_id]) for s in sp.other_sites
    }
    rec = {
        "table": t.name, "rows": t.nrows, "mode": "device" if device_resident else "host",
        "why": facts["why"], "mode_why": mode_why, "budget_bytes": facts["budget"],
        "chunk_rows": chunk_rows, "chunk_tile": chunk_tile,
    }
    executor.stream_log.append(rec)

    def feeds():
        if device_resident:
            full = _scan.scan_table(
                t, sp.big_site.columns, version=v, device=executor.device
            )[0]
            for a in range(0, t.nrows, chunk_tile):
                z = min(a + chunk_tile, full.capacity)
                pad = chunk_tile - (z - a)
                cols = {
                    n: DevCol(_pad_rows(c.data[a:z], pad), _pad_rows(c.valid[a:z], pad))
                    for n, c in full.cols.items()
                }
                inputs = dict(inputs_base)
                inputs[sp.big_site.node_id] = Batch(cols, _pad_rows(full.row_valid[a:z], pad))
                yield inputs
            return
        for hb in _chunk_blocks(t, v, sp.big_site.columns, chunk_rows):
            inputs = dict(inputs_base)
            inputs[sp.big_site.node_id] = block_to_batch(
                hb, capacity=chunk_tile, device=executor.device
            )
            yield inputs

    t0 = time.perf_counter()
    partials, cap = _drain_partials(sp, feeds(), chunk_tile, P._MAX_CAP)
    rec["chunks"] = len(partials)
    rec["partial_rows"] = sum(b.capacity for b in partials)
    rec["seconds"] = {"chunks": time.perf_counter() - t0}
    return _finalize_partials(executor, plan, agg, sp, partials, cap, rec, P._MAX_CAP)


def _drain_partials(sp, feeds, default_tile, max_cap):
    """Run the pipeline and the partial aggregation over each chunk,
    growing capacity knobs on overflow as the executor's discovery does
    (one device->host fetch per try), and compact each chunk's partial
    rows into a tile of their own. Returns (partial batches, the
    partial group capacity)."""
    cap = sp.agg_cap or 1024
    caps = dict(sp.caps) if sp.caps else {
        nid: (default_tile if d == 0 else d) for nid, d in sp.defaults.items()
    }
    peak = {}
    partials: List[Batch] = []
    for inputs in feeds:
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
