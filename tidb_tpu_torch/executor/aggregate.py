"""Group aggregation with static shapes.

Counterpart of tidb_tpu/executor/aggregate.py, with its off-TPU paths:

- the **dense-compact** path: when every group key has a sound static
  (bit width, bias), the keys pack into one int64 whose value IS the slot
  of a dense table over the whole packed domain; one segment reduction
  per lane fills the table and a prefix sum over the occupied slots
  compacts it into the output tile (the prefix_sum kernel on CUDA);
- the **packed** path (``_packed_group_assign``): packable keys whose
  domain is too large for a dense table, at small group capacities: the
  sorted distinct packed values are the slot table;
- the **claim loop** (``group_assign``): any other keys hash into a
  power-of-two slot table of twice the group capacity, and each group
  claims one slot by linear probing;
- the **scalar** path (no GROUP BY): one group at slot 0.

``_run_aggs`` implements the MySQL aggregate semantics (NULL rules, AVG
decimal scale, wide and packed lanes, DISTINCT representative rows) over
every path. Its sum/count reductions on slot tables of at most 128 slots
go through the slot_sums kernel on CUDA, stacked per accumulation dtype
into one call; wider tables use ``index_add_``. The kernel accumulates
int64 lanes in int64 and float64 lanes in float64, the JAX package's
default numerics.

The JAX package's sort-formulated lowering for the TPU (sortops,
``_SortedReducer``) belongs to a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from tidb_tpu_torch.chunk import Batch, DevCol, fetch, pad_capacity
from tidb_tpu_torch.executor.kernels import (
    SLOT_SUMS_MAX_SLOTS,
    prefix_sum,
    slot_sums,
)

ExprFn = Callable[[Batch], DevCol]

# reported in place of the group count when a row's key falls outside the
# compile-time-baked packed-key bounds: the executor recompiles the plan
# with fresh bounds instead of bumping capacity tiles
WIDTH_STALE = 1 << 60

# linear-probe bound per table size; beyond this the table is declared
# full and the executor retries at the next tile
_MAX_PROBES = 64
#: claim-loop iterations between two host checks of the loop condition.
#: An iteration after every row has its slot changes nothing, so
#: checking less often than the JAX package's while_loop only trades
#: idle iterations for device->host fetches; the outputs are the same.
_CLAIM_CHECK_EVERY = 8
# splitmix64 finalizer constants as signed int64 (the same 64 bits)
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)
_GOLDEN = -7046029254386353131  # 0x9E3779B97F4A7C15


@dataclasses.dataclass(frozen=True)
class AggDesc:
    """An aggregate: func in {sum,count,avg,min,max,first}, over arg_fn
    (see tidb_tpu/executor/aggregate.py AggDesc for each field).

    count with arg_fn=None is COUNT(*). ``wide`` splits an overflow-prone
    scaled-decimal sum into 30-bit limbs summed exactly in int64;
    ``pack_bound`` packs a bounded integer (sum, count) pair into one
    biased int64 lane."""

    func: str
    arg: Optional[ExprFn]
    out_name: str
    distinct: bool = False
    arg_scale: int = 0
    wide: bool = False
    pack_bound: Optional[int] = None
    # decodes a MIN/MAX result (a CI-collated string's ``rank * D + code``
    # back to its code); the partial stage of a split aggregation keeps
    # the encoded values and only the final stage decodes
    post: Optional[Callable] = None


def _next_pow2(n: int) -> int:
    return pad_capacity(n, floor=1, pow2=True)


def _pack_keys(keys, key_widths, row_valid):
    """Pack key columns into one int64 (biased limbs, 0 = NULL) and
    verify every valid row's limb fits its baked width. Returns
    (packed [cap] int64, stale bool scalar)."""
    packed = torch.zeros(row_valid.shape[0], dtype=torch.int64, device=row_valid.device)
    stale = torch.zeros((), dtype=torch.bool, device=row_valid.device)
    off = 0
    for (w, b), k in zip(key_widths, keys):
        limb = torch.where(
            k.valid, k.data.to(torch.int64) + (b + 1), torch.zeros_like(packed)
        )
        bad = k.valid & ((limb < 1) | (limb > ((1 << w) - 1)))
        stale = stale | (row_valid & bad).any()
        packed = packed | (limb << off)
        off += w
    return packed, stale


def _key_components(k: DevCol):
    """(comparison components, hash int64) of one group key column, as
    the JAX package's: components compare with ``==`` in the claim loop
    (NULL data zeroed, -0.0 folded to +0.0, NaN zeroed and carried as a
    flag, so every comparison terminates); floats hash through a clipped
    fixed-point projection and approximate mantissa/exponent
    projections. Hash collisions only lengthen probe chains, so a last-ulp
    difference from the JAX package's log2/exp2 can move a float key's
    slot but never merges or splits groups."""
    d = k.data
    if d.is_floating_point():
        dd = torch.where(d == 0, torch.zeros_like(d), d)  # -0.0 -> +0.0
        nanf = torch.isnan(dd) & k.valid
        dd = torch.where(nanf | ~k.valid, torch.zeros_like(dd), dd)
        lim = 9.0e15  # stays exactly convertible to int64 after *1024
        hv = (dd.clamp(-lim, lim) * 1024.0).to(torch.int64)
        a = dd.abs()
        e = torch.log2(torch.where(a > 0, a, torch.ones_like(a)))
        ef = torch.floor(torch.where(torch.isfinite(e), e, torch.zeros_like(e)))
        m = dd * torch.exp2(-ef)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        hm = (m.clamp(-4.0, 4.0) * (2.0**40)).to(torch.int64)
        he = ef.to(torch.int64)
        h = hv ^ _mix64(hm) ^ (he * _GOLDEN)
        return [dd, nanf], h + nanf.to(torch.int64)
    vbd = torch.where(k.valid, d.to(torch.int64), torch.zeros((), dtype=torch.int64, device=d.device))
    return [vbd], vbd


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits, as uint64's ``>>``."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer (public-domain constant mix) on int64 holding
    uint64 bits: multiplies wrap mod 2^64 and shifts are logical, so the
    bits equal the JAX package's uint64 ``_mix64``."""
    x = x.to(torch.int64)
    x = (x ^ _lsr(x, 30)) * _MIX1
    x = (x ^ _lsr(x, 27)) * _MIX2
    return x ^ _lsr(x, 31)


def group_assign(
    keys: Sequence[DevCol], row_valid: torch.Tensor, slots: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assign each valid row a slot in a `slots`-entry table by group key
    (the JAX package's claim loop): every row hashes its key to a slot;
    unassigned rows scatter-min (iteration, row id) into their slot;
    rows whose key equals the claimer's adopt it, the rest probe the next
    slot. All rows of one key follow one probe sequence, so each group
    settles on exactly one slot.

    Returns (seg [cap] int32: slot per row, `slots` for dropped/invalid
    rows; claimer [slots] int32: first (min) row id per occupied slot,
    cap for empty; ngroups int64 scalar; overflow bool scalar)."""
    cap = row_valid.shape[0]
    dev = row_valid.device
    vbs = []
    h = torch.zeros(cap, dtype=torch.int64, device=dev)
    for k in keys:
        comps, hash_int = _key_components(k)
        vbs.append((comps, k.valid))
        h = _mix64(h + hash_int * 2 + k.valid.to(torch.int64))
    slot0 = h & (slots - 1)
    row_id = torch.arange(cap, dtype=torch.int64, device=dev)
    max_iters = min(slots, _MAX_PROBES)
    # claim values encode (iteration, row id) as it*cap + row_id, so a
    # group reaching a slot in a LATER iteration never steals a slot an
    # earlier group settled on
    sentinel = (max_iters + 1) * cap
    # row i's claim while it sits an iteration out goes to entry
    # slots + i, never read back (the JAX package sends them all to one
    # dropped index; on a card, updates to one address serialize)
    idle = slots + row_id
    claim = torch.full((slots + cap,), sentinel, dtype=torch.int64, device=dev)
    assigned = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    probe = torch.zeros(cap, dtype=torch.int64, device=dev)
    it = 0
    while it < max_iters:
        # one counted device->host fetch per check
        if it and not bool(fetch([(row_valid & (assigned < 0)).any()])[0]):
            break
        for _ in range(min(_CLAIM_CHECK_EVERY, max_iters - it)):
            unassigned = row_valid & (assigned < 0)
            slot = (slot0 + probe) & (slots - 1)
            target = torch.where(unassigned, slot, idle)
            claim.scatter_reduce_(0, target, it * cap + row_id, "amin")
            claimer_v = claim[slot]
            cl = (claimer_v % cap).clamp(max=cap - 1)
            same = claimer_v < sentinel
            for comps, kvalid in vbs:
                for c in comps:
                    same = same & (c[cl] == c)
                same = same & (kvalid[cl] == kvalid)
            assigned = torch.where(unassigned & same, slot, assigned)
            probe = torch.where(unassigned & ~same, probe + 1, probe)
            it += 1
    claimer_v = claim[:slots]
    occupied = claimer_v < sentinel
    claimer = torch.where(occupied, claimer_v % cap, cap).to(torch.int32)
    ngroups = occupied.sum(dtype=torch.int64)
    overflow = (row_valid & (assigned < 0)).any()
    seg = torch.where(row_valid & (assigned >= 0), assigned, slots).to(torch.int32)
    return seg, claimer, ngroups, overflow


def _packed_group_assign(
    keys: Sequence[DevCol],
    key_widths: Sequence[Tuple[int, int]],
    row_valid: torch.Tensor,
    slots: int,
):
    """Group assignment for keys that pack losslessly into one int64,
    with the JAX package's outputs: the first `slots` distinct packed
    values in ascending order are the slot table. The JAX package finds
    them with one full reduction per group in a while_loop and matches
    rows with a [cap, slots] comparison; here one sort, an
    adjacent-difference mask, a cumsum and a searchsorted give the same
    table in static shapes with no host round trip.

    Returns (seg [cap] int32, uniq [slots] int64 sorted packed values
    (int64 max past the count), count int32 scalar, overflow bool
    scalar, stale bool scalar)."""
    dev = row_valid.device
    sent = torch.iinfo(torch.int64).max
    packed, stale = _pack_keys(keys, key_widths, row_valid)
    packed = torch.where(row_valid, packed, sent)
    s, _ = torch.sort(packed)
    new = s != sent
    new[1:] &= s[1:] != s[:-1]
    rank = torch.cumsum(new, 0) - 1
    ndistinct = new.sum(dtype=torch.int64)
    uniq = torch.full((slots + 1,), sent, dtype=torch.int64, device=dev)
    # distinct values past the table land in the overflow entry
    uniq.scatter_(0, torch.where(new & (rank < slots), rank, slots), s)
    uniq = uniq[:slots]
    pos = torch.searchsorted(uniq, packed)
    hit = row_valid & (pos < slots) & (uniq[pos.clamp(max=slots - 1)] == packed)
    seg = torch.where(hit, pos, slots).to(torch.int32)
    count = torch.clamp(ndistinct, max=slots).to(torch.int32)
    return seg, uniq, count, ndistinct > slots, stale


def _packs(a: AggDesc, col, cap: int) -> bool:
    """Whether a sum/avg lane qualifies for the packed (sum, count)
    single reduction: proven per-row bound, integer data, and the
    biased sum + count bits fit int64 at this batch capacity."""
    return (
        a.pack_bound is not None
        and not a.wide
        and col is not None
        and not col.data.is_floating_point()
        and (2 * a.pack_bound).bit_length() + 2 * int(cap).bit_length() <= 62
    )


def _dense_compact_group_aggregate(
    batch, keys, key_widths, aggs, arg_cols, slots, dense_bits, key_names,
    reps, fold_distinct_overflow, post_filter=None,
):
    """Aggregation over the full dense packed-key domain followed by a
    prefix-sum compaction of occupied slots into the `slots` output tile,
    in slot-id (ascending key) order. Reports the true group count; when
    it exceeds `slots` the executor bumps the capacity knob and re-runs."""
    dev = batch.device
    dense = 1 << dense_bits
    packed, stale = _pack_keys(keys, key_widths, batch.row_valid)
    # invalid / stale-width rows -> `dense`: the overflow slot of every
    # dense-domain reduction below
    seg = torch.where(
        batch.row_valid & (packed < dense), packed, torch.full_like(packed, dense)
    ).to(torch.int32)
    # occupancy: a row count per slot, through the same sum path as the
    # aggregate lanes (the slot_sums kernel on small domains)
    (occ_n,) = _segment_sums(
        [(batch.row_valid.to(torch.int64), batch.row_valid)], seg, dense
    )
    occupied = occ_n > 0
    ngroups = occupied.sum(dtype=torch.int64)

    # dense-domain key reconstruction
    sid = torch.arange(dense, dtype=torch.int64, device=dev)
    out_cols = {}
    off = 0
    for name, k, (w, b) in zip(key_names, keys, key_widths):
        limb = (sid >> off) & ((1 << w) - 1)
        off += w
        kv = (limb != 0) & occupied
        kd = (limb - (b + 1)).to(k.data.dtype)
        out_cols[name] = DevCol(torch.where(kv, kd, torch.zeros_like(kd)), kv)

    cl = torch.zeros(dense, dtype=torch.int64, device=dev)
    if any(a.func == "first" for a in aggs):
        cap = batch.capacity
        claimer = torch.full((dense + _OVERFLOW_SPREAD,), cap, dtype=torch.int64, device=dev)
        claimer.scatter_reduce_(
            0, _overflow_slot(seg, dense),
            torch.arange(cap, dtype=torch.int64, device=dev), "amin",
        )
        cl = claimer[:dense].clamp(max=cap - 1)

    wide = _run_aggs(batch, aggs, arg_cols, seg, dense, occupied, cl, out_cols, reps)

    if post_filter is not None:
        # fused HAVING: evaluate over the dense domain and compact only
        # surviving groups
        c = post_filter(wide)
        occupied = wide.row_valid & c.valid & c.data.to(torch.bool)
        ngroups = occupied.sum(dtype=torch.int64)
        wide = Batch(wide.cols, occupied)
    ngroups = torch.where(stale, torch.full_like(ngroups, WIDTH_STALE), ngroups)

    # compaction writes each occupied slot to its position; positions past
    # the tile (too many groups) and unoccupied slots land in the entries
    # past it
    pos = _overflow_slot(torch.where(occupied, prefix_sum(occupied) - 1, -1), slots)
    cols = {}
    for name, c in wide.cols.items():
        nd = torch.zeros(slots + _OVERFLOW_SPREAD, dtype=c.data.dtype, device=dev)
        nv = torch.zeros(slots + _OVERFLOW_SPREAD, dtype=torch.bool, device=dev)
        nd[pos] = c.data
        nv[pos] = c.valid
        cols[name] = DevCol(nd[:slots], nv[:slots])
    row_valid = torch.arange(slots, dtype=torch.int64, device=dev) < torch.minimum(
        ngroups, torch.tensor(slots, dtype=torch.int64, device=dev)
    )
    return Batch(cols, row_valid), fold_distinct_overflow(ngroups)


def _needs_rep(a: AggDesc) -> bool:
    """DISTINCT changes the result only for sum/avg/count (min/max/first
    are duplicate-insensitive)."""
    return a.distinct and a.func in ("sum", "avg", "count") and a.arg is not None


def _distinct_reps(keys, aggs, arg_cols, row_valid, slots):
    """Per-DISTINCT-agg representative-row masks: one more claim loop per
    distinct argument over (group keys + argument) dedupes the
    (group, value) pairs, and the pair slot's claiming row is its one
    contributor. Returns ({agg index: bool mask}, overflow or None)."""
    reps = {}
    over = None
    cap = row_valid.shape[0]
    rid = torch.arange(cap, dtype=torch.int32, device=row_valid.device)
    for i, (a, col) in enumerate(zip(aggs, arg_cols)):
        if not _needs_rep(a) or col is None:
            continue
        pseg, pclaimer, _png, pover = group_assign(list(keys) + [col], row_valid, slots)
        cl = pclaimer[pseg.clamp(max=slots - 1).to(torch.int64)]
        reps[i] = (pseg < slots) & (cl == rid)
        over = pover if over is None else (over | pover)
    return reps, over


def group_aggregate(
    batch: Batch,
    key_fns: Sequence[ExprFn],
    aggs: Sequence[AggDesc],
    group_capacity: int,
    key_names: Optional[Sequence[str]] = None,
    key_widths: Optional[Sequence[Optional[Tuple[int, int]]]] = None,
    post_filter: Optional[Callable[[Batch], DevCol]] = None,
) -> Tuple[Batch, torch.Tensor]:
    """Returns (group batch, reported group count), as the JAX package's
    ``group_aggregate``: key columns first (named key_names or k0..kn),
    then one column per aggregate. The batch holds one row per group; its
    capacity is the path's slot table (twice the group capacity on the
    packed and claim-loop paths), so callers size overflow checks from
    the returned batch. The reported count is the true group count, a
    value above the output capacity when the tile overflowed, or
    WIDTH_STALE when baked key bounds no longer cover the data."""
    cap = batch.capacity
    dev = batch.device
    key_names = list(key_names or [f"k{i}" for i in range(len(key_fns))])

    # fused HAVING: the dense path compacts only surviving groups; every
    # other path masks the output rows (its reported count stays the
    # pre-filter one, since its slot table must still hold every group)
    def _mask_post(out, ng):
        if post_filter is None:
            return out, ng
        c = post_filter(out)
        return Batch(out.cols, out.row_valid & c.valid & c.data.to(torch.bool)), ng

    keys = [fn(batch) for fn in key_fns]
    arg_cols = [a.arg(batch) if a.arg is not None else None for a in aggs]

    # DISTINCT representative rows; their pair table shares the group
    # capacity knob, and its overflow folds into the reported count so
    # the executor retries at a larger tile
    reps: dict = {}
    dover = None
    pair_slots = _next_pow2(max(2 * group_capacity, 16))
    if any(_needs_rep(a) for a in aggs):
        reps, dover = _distinct_reps(keys, aggs, arg_cols, batch.row_valid, pair_slots)

    def fold_distinct_overflow(ngroups):
        if dover is None:
            return ngroups
        return torch.maximum(
            ngroups, torch.where(dover, pair_slots + 1, 0).to(torch.int64)
        )

    widths_ok = (
        keys
        and key_widths is not None
        and all(w is not None for w in key_widths)
        and sum(w for w, _b in key_widths) <= 62
    )
    dense_bits = sum(w for w, _b in key_widths) if widths_ok else 99
    packable = widths_ok and group_capacity <= 256
    dense_ok = (
        widths_ok
        and dense_bits <= 26
        and (1 << dense_bits) <= max(4 * cap, 1 << 16)
    )
    if dense_ok:
        slots = _next_pow2(max(group_capacity, 16))
        return _dense_compact_group_aggregate(
            batch, keys, key_widths, aggs, arg_cols, slots, dense_bits,
            key_names, reps, fold_distinct_overflow, post_filter=post_filter,
        )

    if packable:
        slots = _next_pow2(max(2 * group_capacity, 16))
        seg, uniq, count, over, stale = _packed_group_assign(
            keys, key_widths, batch.row_valid, slots
        )
        ngroups = torch.where(over, slots + 1, count.to(torch.int64))
        ngroups = torch.where(stale, WIDTH_STALE, ngroups)
        occupied = torch.arange(slots, device=dev) < count
        # key columns arithmetically from the packed table
        out_cols = {}
        off = 0
        for name, k, (w, b) in zip(key_names, keys, key_widths):
            limb = (uniq >> off) & ((1 << w) - 1)
            off += w
            kv = (limb != 0) & occupied
            kd = (limb - (b + 1)).to(k.data.dtype)
            out_cols[name] = DevCol(torch.where(kv, kd, torch.zeros_like(kd)), kv)
        cl = torch.zeros(slots, dtype=torch.int64, device=dev)
        if any(a.func == "first" for a in aggs):
            # a representative row per group: min row id per slot
            claimer = torch.full((slots + _OVERFLOW_SPREAD,), cap, dtype=torch.int64, device=dev)
            claimer.scatter_reduce_(
                0, _overflow_slot(seg, slots),
                torch.arange(cap, dtype=torch.int64, device=dev), "amin",
            )
            cl = claimer[:slots].clamp(max=cap - 1)
        out = _run_aggs(batch, aggs, arg_cols, seg, slots, occupied, cl, out_cols, reps)
        return _mask_post(out, fold_distinct_overflow(ngroups))

    if keys:
        slots = _next_pow2(max(2 * group_capacity, 16))
        seg, claimer, true_ng, overflow = group_assign(keys, batch.row_valid, slots)
        ngroups = torch.where(overflow, slots + 1, true_ng)
    else:
        # scalar aggregation: one group at slot 0
        slots = group_capacity
        any_valid = batch.row_valid.any()
        seg = torch.where(
            batch.row_valid,
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.full((), slots, dtype=torch.int32, device=dev),
        )
        first_valid = torch.argmax(batch.row_valid.to(torch.uint8))
        claimer = torch.full((slots,), cap, dtype=torch.int64, device=dev)
        claimer[0] = torch.where(any_valid, first_valid, torch.full_like(first_valid, cap))
        ngroups = (claimer < cap).sum(dtype=torch.int64)
    group_valid = claimer < cap
    cl = claimer.to(torch.int64).clamp(max=cap - 1)

    # group key columns: the value at the claiming row
    out_cols = {}
    for name, k in zip(key_names, keys):
        kd = k.data[cl]
        out_cols[name] = DevCol(
            torch.where(group_valid, kd, torch.zeros_like(kd)), k.valid[cl] & group_valid
        )
    out = _run_aggs(batch, aggs, arg_cols, seg, slots, group_valid, cl, out_cols, reps)
    return _mask_post(out, fold_distinct_overflow(ngroups))


def _segment_sums(reqs, seg, slots):
    """Sum requests (vals, contrib) into a `slots`-slot table; rows with
    seg outside [0, slots) are dropped. Tables of at most
    SLOT_SUMS_MAX_SLOTS slots go through the slot_sums kernel, one call
    per accumulation dtype; wider ones use index_add_ over an overflow
    slot."""
    out: List[Optional[torch.Tensor]] = [None] * len(reqs)
    if slots <= SLOT_SUMS_MAX_SLOTS:
        by_acc: dict = {}
        for i, (vals, contrib) in enumerate(reqs):
            acc = torch.float64 if vals.is_floating_point() else torch.int64
            by_acc.setdefault(acc, []).append(i)
        for acc, idx in by_acc.items():
            values = torch.stack([reqs[i][0].to(acc) for i in idx])
            contribs = torch.stack([reqs[i][1] for i in idx])
            sums = slot_sums(values, contribs, seg, slots)
            for j, i in enumerate(idx):
                out[i] = sums[j].to(reqs[i][0].dtype)
        return out
    seg64 = _overflow_slot(seg, slots)
    for i, (vals, contrib) in enumerate(reqs):
        t = torch.zeros(slots + _OVERFLOW_SPREAD, dtype=vals.dtype, device=vals.device)
        t.index_add_(0, seg64, torch.where(contrib, vals, torch.zeros_like(vals)))
        out[i] = t[:slots]
    return out


#: overflow entries past a slot table. Rows outside the table (filtered
#: out, or padding) are spread over them by position: on a card, atomic
#: updates of one address serialize, and a selective filter sends most
#: of a 2^26-row tile there (TPC-H Q15 at SF10: 58M rows, 48 ms a lane)
_OVERFLOW_SPREAD = 1024


def _overflow_slot(seg, slots):
    """int64 slot ids with each row outside [0, slots) sent to one of the
    _OVERFLOW_SPREAD entries from `slots` on (torch scatters raise on
    out-of-range ids where jax drops them)."""
    spill = slots + (torch.arange(seg.shape[0], device=seg.device) & (_OVERFLOW_SPREAD - 1))
    return torch.where((seg >= 0) & (seg < slots), seg.to(torch.int64), spill)


def _segment_extreme(op, vals, contrib, ident, seg, slots):
    seg64 = _overflow_slot(seg, slots)
    t = torch.full((slots + _OVERFLOW_SPREAD,), ident, dtype=vals.dtype, device=vals.device)
    src = torch.where(contrib, vals, torch.full_like(vals, ident))
    t.scatter_reduce_(0, seg64, src, "amin" if op == "min" else "amax")
    return t[:slots]


def _exec_reqs(reqs, seg, slots):
    """Execute (op, vals, contrib, ident) reduction requests: sums batched
    through _segment_sums, min/max as scatter reductions."""
    sums = [(v, c) for (op, v, c, _i) in reqs if op == "sum"]
    sum_out = iter(_segment_sums(sums, seg, slots) if sums else [])
    return [
        next(sum_out) if op == "sum"
        else _segment_extreme(op, v, c, ident, seg, slots)
        for (op, v, c, ident) in reqs
    ]


def _run_aggs(batch, aggs, arg_cols, seg, slots, group_valid, cl, out_cols, reps=None):
    """Compute all aggregates into the slot table: collect reduction
    requests, execute them (batched), then assemble output columns.
    `reps` maps an agg index to its DISTINCT representative-row mask."""
    srow_valid = seg < slots
    ones = torch.ones_like(seg, dtype=torch.int64)
    reqs = []

    def req(op, vals, contrib, ident=0):
        reqs.append((op, vals, contrib, ident))
        return len(reqs) - 1

    assemble = []  # (name, fn of the executed results list)

    def emit(name, fn):
        assemble.append((name, fn))

    def avg_of(s, cnt, scale):
        denom = torch.where(cnt == 0, torch.ones_like(cnt), cnt).to(torch.float64)
        if scale:
            # DECIMAL data is in scaled units: descale by 10^scale
            denom = denom * (10**scale)
        return s.to(torch.float64) / denom

    for i, (a, col) in enumerate(zip(aggs, arg_cols)):
        if a.func == "count" and col is None:
            rid = req("sum", ones, srow_valid)
            emit(a.out_name, lambda R, rid=rid: DevCol(R[rid], group_valid))
            continue

        data = col.data
        if data.dtype == torch.bool and a.func in ("sum", "avg", "min", "max"):
            # SUM(bool_expr) etc.: MySQL treats booleans as 0/1 ints
            data = data.to(torch.int64)
        valid = col.valid & srow_valid
        if reps and i in reps:
            valid = valid & reps[i]
        if a.func == "count":
            rid = req("sum", ones, valid)
            emit(a.out_name, lambda R, rid=rid: DevCol(R[rid], group_valid))
        elif a.func in ("sum", "avg"):
            if a.wide and not data.is_floating_point():
                d64 = data.to(torch.int64)
                lo = d64 & ((1 << 30) - 1)
                hi = d64 >> 30  # arithmetic shift: hi*2^30 + lo == d64
                rlo = req("sum", lo, valid)
                rhi = req("sum", hi, valid)

                def mk_s(R, rlo=rlo, rhi=rhi):
                    return R[rhi].to(torch.float64) * float(1 << 30) + R[
                        rlo
                    ].to(torch.float64)

            elif _packs(a, col, batch.capacity):
                # packed (sum, count) single reduction: values biased
                # non-negative so the count rides the low bits
                cb = int(batch.capacity).bit_length()
                bias = int(a.pack_bound)
                rp = req("sum", ((data.to(torch.int64) + bias) << cb) | 1, valid)
                mask = (1 << cb) - 1

                def mk_s(R, rp=rp, cb=cb, bias=bias, mask=mask):
                    return (R[rp] >> cb) - bias * (R[rp] & mask)

                def mk_cnt(R, rp=rp, mask=mask):
                    return R[rp] & mask

                if a.func == "sum":

                    def fin(R, mk_s=mk_s, mk_cnt=mk_cnt):
                        return DevCol(mk_s(R), (mk_cnt(R) > 0) & group_valid)

                else:

                    def fin(R, mk_s=mk_s, mk_cnt=mk_cnt, scale=a.arg_scale):
                        cnt = mk_cnt(R)
                        return DevCol(
                            avg_of(mk_s(R), cnt, scale), (cnt > 0) & group_valid
                        )

                emit(a.out_name, fin)
                continue
            else:
                rs = req("sum", data, valid)

                def mk_s(R, rs=rs):
                    return R[rs]

            rc = req("sum", ones, valid)

            def mk_cnt(R, rc=rc):
                return R[rc]

            if a.func == "sum":

                def fin(R, mk_s=mk_s, mk_cnt=mk_cnt):
                    # SUM over an all-NULL / empty group is NULL (MySQL)
                    return DevCol(mk_s(R), (mk_cnt(R) > 0) & group_valid)

            else:

                def fin(R, mk_s=mk_s, mk_cnt=mk_cnt, scale=a.arg_scale):
                    cnt = mk_cnt(R)
                    return DevCol(
                        avg_of(mk_s(R), cnt, scale), (cnt > 0) & group_valid
                    )

            emit(a.out_name, fin)
        elif a.func in ("min", "max"):
            ident = _type_max(data.dtype) if a.func == "min" else _type_min(data.dtype)
            rs = req(a.func, data, valid, ident)
            rc = req("sum", ones, valid)
            emit(
                a.out_name,
                lambda R, rs=rs, rc=rc, p=a.post: DevCol(
                    R[rs] if p is None else p(R[rs]), (R[rc] > 0) & group_valid
                ),
            )
        elif a.func == "first":
            out_cols[a.out_name] = DevCol(data[cl], col.valid[cl] & group_valid)
        else:
            raise NotImplementedError(f"agg func {a.func!r}")

    results = _exec_reqs(reqs, seg, slots)
    for name, fn in assemble:
        out_cols[name] = fn(results)
    return Batch(out_cols, group_valid)


def _type_max(dtype):
    return float("inf") if dtype.is_floating_point else torch.iinfo(dtype).max


def _type_min(dtype):
    return float("-inf") if dtype.is_floating_point else torch.iinfo(dtype).min
