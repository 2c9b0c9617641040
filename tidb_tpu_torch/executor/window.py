"""Window functions with static shapes.

Counterpart of tidb_tpu/executor/window.py. One sort by (valid,
partition keys, order keys) makes every partition a contiguous run of
rows; each window function is then a prefix operation, a gather or a
reduction over those runs, for every partition at once.

The JAX package finds each partition's first and last row, and each
peer group's last row, by scattering row positions into a table with
one entry per partition plus one overflow entry for every invalid row.
Here each run's first and last row come from a binary search of the
running count of run starts (``torch.searchsorted``): no scatter, so no
row waits on another's atomic update. (``torch.cummax`` of the start
positions gives the same, far slower on the card: PERF.md, section 6.)
Whole-partition sums of integers are differences of one prefix sum,
exact in int64; float sums stay segment reductions, as in the JAX
package, with invalid rows spread over the overflow entries. Running
and whole-partition MIN/MAX are one segmented scan (log-step doubling).

Supported: row_number, rank, dense_rank, ntile, percent_rank,
cume_dist, lag, lead, first_value, last_value, nth_value, and
sum/count/avg/min/max over the whole partition, as a running aggregate,
or over an explicit ROWS or RANGE frame.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from tidb_tpu_torch.chunk import Batch, DevCol
from tidb_tpu_torch.executor.aggregate import _OVERFLOW_SPREAD, _overflow_slot
from tidb_tpu_torch.executor.sort import lex_permutation

ExprFn = Callable[[Batch], DevCol]


@dataclasses.dataclass(frozen=True)
class WindowDesc:
    func: str  # row_number|rank|dense_rank|ntile|...|lag|lead|sum|count|avg|min|max
    arg: Optional[ExprFn]
    out_name: str
    offset: int = 1  # lag/lead offset, ntile buckets, nth_value's n
    arg_scale: int = 0
    # True when the OVER clause has ORDER BY: an aggregate becomes a
    # running (rows unbounded-preceding..current) computation, else
    # whole-partition.
    running: bool = False
    # explicit frame: (lo, hi) ROWS offsets relative to the current row,
    # or ("range", lo, hi) value offsets of the ORDER BY key ("cur" for
    # CURRENT ROW); None = unbounded side. Overrides `running`.
    frame: Optional[tuple] = None


def _shift_changes(arrs: Sequence[torch.Tensor], cap: int, dev) -> torch.Tensor:
    """Rows whose value differs from the previous row's in any of `arrs`
    (row 0 always)."""
    ch = torch.zeros(cap, dtype=torch.bool, device=dev)
    for a in arrs:
        ch[1:] |= a[1:] != a[:-1]
    ch[0] = True
    return ch


def _run_bounds(change: torch.Tensor):
    """Per row, the positions of the first and the last row of its run
    (the rows from one change up to the next): the running count of
    changes numbers the runs, and a binary search of each row's number in
    that count finds where its run begins and ends."""
    run = torch.cumsum(change, 0)
    return (
        torch.searchsorted(run, run),
        torch.searchsorted(run, run, right=True) - 1,
    )


def _segmented_scan(vals: torch.Tensor, start: torch.Tensor, op) -> torch.Tensor:
    """Inclusive scan of `op` (min or max) within runs that start at
    `start`: log-step doubling, each step folding in the value 2^k rows
    back when that row lies in the same run."""
    cap = vals.shape[0]
    idx = torch.arange(cap, dtype=torch.int64, device=vals.device)
    out = vals
    step = 1
    while step < cap:
        src = idx - step
        prev = out[src.clamp(min=0)]
        out = torch.where(src >= start, op(out, prev), out)
        step *= 2
    return out


def _lex_searchsorted(S, K, s_t, k_t, side: str):
    """Vectorized binary search over rows sorted lexicographically by
    (S, K): per-target insertion points for (s_t, k_t), the JAX
    package's ladder of gathers (``torch.searchsorted`` takes one key)."""
    n = S.shape[0]
    lo = torch.zeros(s_t.shape, dtype=torch.int64, device=S.device)
    hi = torch.full(s_t.shape, n, dtype=torch.int64, device=S.device)
    for _ in range(max(int(n).bit_length(), 1)):
        mid = (lo + hi) // 2
        midc = mid.clamp(0, n - 1)
        sm, km = S[midc], K[midc]
        if side == "left":
            go = (sm < s_t) | ((sm == s_t) & (km < k_t))
        else:
            go = (sm < s_t) | ((sm == s_t) & (km <= k_t))
        go = go & (lo < hi)
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go, hi, mid)
    return lo


def window_op(
    batch: Batch,
    part_fns: Sequence[ExprFn],
    order_fns: Sequence[ExprFn],
    order_descs: Sequence[bool],
    descs: Sequence[WindowDesc],
) -> Batch:
    cap = batch.capacity
    dev = batch.device

    # ---- one sort by (valid, partition keys, order keys) ----
    operands: List[torch.Tensor] = [~batch.row_valid]
    for fn in part_fns:
        k = fn(batch)
        operands.append(~k.valid)
        operands.append(torch.where(k.valid, k.data, torch.zeros_like(k.data)))
    n_part_ops = 2 * len(part_fns)
    for fn, desc in zip(order_fns, order_descs):
        k = fn(batch)
        valid = k.valid
        nullk = ~valid if desc else valid
        data = k.data
        if data.is_floating_point():
            d = -data if desc else data
        elif data.dtype == torch.bool:
            d = data ^ desc
        else:
            d = -data.to(torch.int64) if desc else data.to(torch.int64)
        operands.append(nullk)
        operands.append(torch.where(valid, d, torch.zeros_like(d)))
    perm = lex_permutation(operands)
    sops = [op[perm] for op in operands]
    srow_valid = ~sops[0]
    idx = torch.arange(cap, dtype=torch.int64, device=dev)

    # partitions: runs of equal partition keys; the valid rows come first,
    # and the invalid ones form a run of their own after them
    part_change = _shift_changes(sops[: 1 + n_part_ops], cap, dev)
    seg = torch.cumsum((part_change & srow_valid).to(torch.int64), 0) - 1
    seg = torch.where(srow_valid, seg, torch.full_like(seg, cap))
    peer_change = part_change | _shift_changes(sops[1 + n_part_ops:], cap, dev)

    start, last = _run_bounds(part_change)
    peer_start, peer_last = _run_bounds(peer_change)
    aux = {
        "start": start, "last": last,
        "peer_start": peer_start, "peer_last": peer_last,
        "peer_change": peer_change, "seg": seg,
    }
    if len(order_fns) == 1:
        # normalized (ascending-monotone) order key for RANGE value
        # frames: DESC keys were negated above, so value deltas keep their
        # sign; NULL keys collapse to an infinity at the end where NULLs
        # sort (first under ASC, last under DESC)
        base = 1 + n_part_ops
        nullk_s = sops[base].to(torch.bool)
        kvalid = ~nullk_s if order_descs[0] else nullk_s
        kv = sops[base + 1].to(torch.float64)
        ninf = float("inf") if order_descs[0] else float("-inf")
        aux["range_key"] = torch.where(kvalid, kv, torch.full_like(kv, ninf))

    inv = torch.empty_like(perm)
    inv[perm] = idx
    cols = dict(batch.cols)
    for d in descs:
        col = _compute(d, batch, perm, srow_valid, idx, aux)
        # back to the original row positions
        cols[d.out_name] = DevCol(col.data[inv], col.valid[inv])
    return Batch(cols, batch.row_valid)


def _prefix_range(pref: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over sorted rows [a, b] from the inclusive prefix sums `pref`."""
    cap = pref.shape[0]
    left = torch.where(a > 0, pref[(a - 1).clamp(0, cap - 1)], torch.zeros_like(pref[:1]))
    return pref[b.clamp(0, cap - 1)] - left


def _compute(d: WindowDesc, batch, perm, srow_valid, idx, aux) -> DevCol:
    cap = idx.shape[0]
    start, last = aux["start"], aux["last"]
    pos = idx - start
    if d.func == "row_number":
        return DevCol(pos + 1, srow_valid)
    if d.func == "rank":
        return DevCol(aux["peer_start"] - start + 1, srow_valid)
    if d.func == "dense_rank":
        c = torch.cumsum(aux["peer_change"].to(torch.int64), 0)
        return DevCol(c - c[start] + 1, srow_valid)

    if d.func in ("ntile", "percent_rank", "cume_dist"):
        nrows = last - start + 1
        if d.func == "ntile":
            n = d.offset
            # MySQL: the first (rows % n) buckets get one extra row
            base = nrows // n
            rem = nrows % n
            big = rem * (base + 1)
            bucket = torch.where(
                pos < big,
                pos // (base + 1).clamp(min=1),
                rem + (pos - big) // base.clamp(min=1),
            )
            return DevCol(bucket + 1, srow_valid)
        if d.func == "percent_rank":
            rank = aux["peer_start"] - start + 1
            denom = (nrows - 1).clamp(min=1).to(torch.float64)
            return DevCol((rank - 1).to(torch.float64) / denom, srow_valid)
        # cume_dist: the peers' LAST position over the partition's rows
        return DevCol(
            (aux["peer_last"] - start + 1).to(torch.float64)
            / nrows.clamp(min=1).to(torch.float64),
            srow_valid,
        )

    if d.arg is None:  # COUNT(*) OVER ...
        data = torch.ones(cap, dtype=torch.int64, device=idx.device)
        valid = srow_valid
    else:
        arg = d.arg(batch)
        data = arg.data[perm]
        valid = arg.valid[perm] & srow_valid

    if d.func in ("lag", "lead"):
        off = d.offset if d.func == "lag" else -d.offset
        src = idx - off
        srcc = src.clamp(0, cap - 1)
        seg = aux["seg"]
        ok = (seg[srcc] == seg) & (src >= 0) & (src < cap) & srow_valid
        v = data[srcc]
        return DevCol(torch.where(ok, v, torch.zeros_like(v)), ok & valid[srcc])

    if d.func in ("first_value", "last_value", "nth_value"):
        # MySQL's default frame is RANGE UNBOUNDED PRECEDING..CURRENT ROW:
        # the frame ends at the current row's LAST PEER
        peer_last = aux["peer_last"]
        if d.func == "first_value":
            src = start
        elif d.func == "nth_value":
            # NULL until the nth row has entered the frame
            src = start + (d.offset - 1)
        else:
            src = peer_last
        ok = srow_valid & (src <= peer_last) & (src >= 0)
        srcc = src.clamp(0, cap - 1)
        v = data[srcc]
        return DevCol(torch.where(ok, v, torch.zeros_like(v)), ok & valid[srcc])

    cnt_c = torch.cumsum(valid.to(torch.int64), 0)
    if d.func in ("sum", "avg", "count"):
        contrib = (
            valid.to(torch.int64)
            if d.func == "count"
            else torch.where(valid, data, torch.zeros_like(data))
        )
        if d.frame is not None:
            if len(d.frame) == 3:
                # RANGE value frame: the rows whose ORDER BY key falls in
                # [key + lo, key + hi], found by a (partition, key) binary
                # search over the sorted rows
                _tag, flo, fhi = d.frame
                k = aux["range_key"]
                seg = aux["seg"]
                if flo is None:
                    loi = start
                else:
                    t_lo = k if flo == "cur" else k + flo
                    loi = _lex_searchsorted(seg, k, seg, t_lo, side="left")
                if fhi is None:
                    hii = last
                else:
                    t_hi = k if fhi == "cur" else k + fhi
                    hii = _lex_searchsorted(seg, k, seg, t_hi, side="right") - 1
                loi = torch.maximum(loi, start)
                hii = torch.minimum(hii, last)
            else:
                lo, hi = d.frame
                loi = start if lo is None else torch.maximum(idx + lo, start)
                hii = last if hi is None else torch.minimum(idx + hi, last)
            empty = hii < loi
            c = torch.cumsum(contrib, 0)
            run = torch.where(empty, torch.zeros_like(c), _prefix_range(c, loi, hii))
            cnt = torch.where(empty, torch.zeros_like(cnt_c), _prefix_range(cnt_c, loi, hii))
        elif d.running:
            run = _prefix_range(torch.cumsum(contrib, 0), start, idx)
            cnt = _prefix_range(cnt_c, start, idx)
        else:
            cnt = _prefix_range(cnt_c, start, last)
            if contrib.is_floating_point():
                # a float segment sum, as in the JAX package: differences
                # of one prefix sum would lose a small partition's digits
                # to the large sums before it
                seg = aux["seg"]
                t = torch.zeros(cap + _OVERFLOW_SPREAD, dtype=contrib.dtype, device=idx.device)
                t.index_add_(0, _overflow_slot(seg, cap), contrib)
                run = t[seg]
            else:
                # integer sums wrap exactly: one prefix sum serves every
                # partition, with no scatter
                run = _prefix_range(torch.cumsum(contrib, 0), start, last)
        if d.func == "count":
            return DevCol(cnt if d.running else run, srow_valid)
        if d.func == "sum":
            return DevCol(run, srow_valid & (cnt > 0))
        denom = torch.where(cnt == 0, torch.ones_like(cnt), cnt).to(torch.float64)
        if d.arg_scale:
            denom = denom * (10**d.arg_scale)
        return DevCol(run.to(torch.float64) / denom, srow_valid & (cnt > 0))
    if d.func in ("min", "max"):
        big = _sentinel(data.dtype, d.func == "min")
        masked = torch.where(valid, data, torch.full_like(data, big))
        op = torch.minimum if d.func == "min" else torch.maximum
        scanned = _segmented_scan(masked, start, op)
        if d.running:
            run = scanned
            cnt = _prefix_range(cnt_c, start, idx)
        else:
            run = scanned[last]
            cnt = _prefix_range(cnt_c, start, last)
        return DevCol(run, srow_valid & (cnt > 0))
    raise NotImplementedError(f"window func {d.func}")


def _sentinel(dtype, is_min: bool):
    if dtype.is_floating_point:
        return float("inf") if is_min else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min
