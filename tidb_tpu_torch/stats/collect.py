"""ANALYZE TABLE: per-column statistics for the cost-based planner.

Counterpart of tidb_tpu/stats/collect.py. One sort of a column on the
device gives its NDV (change flags), an equal-depth histogram (quantile
bounds) and its TopN (segment counts); ``planner/cardinality.py`` reads
them to order joins. Above ``SAMPLE_CAP`` rows the pass runs on one
uniform sample of row positions shared by all columns (seeded by the
table and version, as in the JAX package) and scales the NDV up by the
first-order Haas-Stokes estimator.

Without these stats the greedy join order assumes every equi join is
key-to-foreign-key; TPC-H Q5 then joins customer to supplier on the
nation key, a quadratic intermediate (about 1.2e9 rows at SF10).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tidb_tpu_torch.chunk import fetch, resolve_device, to_device
from tidb_tpu_torch.dtypes import Kind
from tidb_tpu_torch.storage.scan import scan_table
from tidb_tpu_torch.utils.failpoint import inject

N_BUCKETS = 64
N_TOPN = 16

#: above this many rows ANALYZE samples instead of sorting the full
#: column (the JAX package's default)
SAMPLE_CAP = 2 << 20


@dataclasses.dataclass
class ColumnStats:
    row_count: int
    null_count: int
    ndv: int
    # equal-depth histogram: upper bounds per bucket + per-bucket count
    bounds: np.ndarray
    bucket_counts: np.ndarray
    topn: List[Tuple[object, int]]  # decoded (value, count)
    min_val: Optional[object] = None
    max_val: Optional[object] = None


def _column_stats(data, valid, row_valid):
    """(nulls, count, ndv, bounds, bucket counts, top frequencies, top
    values, min, max, singletons) of one column, fetched in one copy."""
    cap = data.shape[0]
    dev = data.device
    ok = valid & row_valid
    nulls = (row_valid & ~valid).sum()
    count = ok.sum()
    if data.is_floating_point():
        key = torch.where(ok, data.to(torch.float64), float("inf"))
    else:
        key = torch.where(ok, data.to(torch.int64), torch.iinfo(torch.int64).max)
    s = torch.sort(key).values
    idx = torch.arange(cap, device=dev)
    is_valid_pos = idx < count
    changed = (s != torch.roll(s, 1)) | (idx == 0)
    ndv = (changed & is_valid_pos).sum()
    # equal-depth bounds: the value at ceil((b+1)*count/N)-1
    steps = (torch.arange(N_BUCKETS, device=dev) + 1) * count // N_BUCKETS
    bounds = s[(steps - 1).clamp(0, cap - 1)]
    bcounts = torch.diff(steps, prepend=torch.zeros(1, dtype=steps.dtype, device=dev))
    # TopN by frequency over the sorted values' segments
    seg = torch.where(is_valid_pos, torch.cumsum(changed, 0) - 1, cap)
    freq = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    freq.index_add_(0, seg, is_valid_pos.to(torch.int64))
    freq = freq[:cap]
    # values seen exactly once: the Haas-Stokes scale-up of a sample
    f1 = (freq == 1).sum()
    first_idx = torch.full((cap + 1,), cap - 1, dtype=torch.int64, device=dev)
    first_idx.scatter_reduce_(0, seg, idx, "amin")
    # stable descending sort: equal frequencies keep the lower index
    # first, as lax.top_k does
    topf, topi = torch.sort(freq, descending=True, stable=True)
    topf, topi = topf[:N_TOPN], topi[:N_TOPN]
    top_vals = s[first_idx[topi]]
    mn = s[0]
    mx = s[(count - 1).clamp(0, cap - 1)]
    scalars = torch.stack([nulls, count, ndv, f1]).to(torch.int64)
    ends = torch.stack([mn, mx])
    return fetch([scalars, bounds, bcounts, topf, top_vals, ends])


def analyze_table(table, device=None, columns=None) -> Dict[str, ColumnStats]:
    """ANALYZE TABLE: per-column stats of the current version, stored on
    the table (``table.stats``). The column pass runs on `device` (CUDA
    unless the caller names another). `columns` restricts the pass, and
    its stats then merge into the table's (the DXF analyze task's
    subtasks, one column each)."""
    inject("stats/analyze")
    device = resolve_device(device)
    if columns is not None and not columns:
        return dict(table.stats or {})
    # one version for the whole pass: a concurrent write must not change
    # the rows under it
    version = table.pin_current()
    try:
        return _analyze_at_version(table, version, device, columns)
    finally:
        table.unpin(version)


def _analyze_at_version(table, version: int, device, columns=None) -> Dict[str, ColumnStats]:
    blocks = table.blocks(version)
    nrows = sum(b.nrows for b in blocks)
    sampled = nrows > SAMPLE_CAP
    if sampled:
        # one shared uniform sample of row positions across all columns
        # (deterministic per table version, so repeat ANALYZE agrees)
        rng = np.random.default_rng((table.uid * 1_000_003 + version) & 0x7FFFFFFF)
        sample_idx = np.sort(rng.choice(nrows, SAMPLE_CAP, replace=False))
        ratio = nrows / SAMPLE_CAP
    stats: Dict[str, ColumnStats] = {}
    for name, typ in table.schema.columns:
        if columns is not None and name not in columns:
            continue
        dictionary = table.dictionaries.get(name)
        if sampled:
            data_parts, valid_parts = [], []
            off = lo = 0
            for b in blocks:
                hi = np.searchsorted(sample_idx, off + b.nrows)
                local = sample_idx[lo:hi] - off
                hc = b.columns.get(name)
                if hc is None:  # a block without the column reads as NULL
                    data_parts.append(np.zeros(len(local), dtype=np.int64))
                    valid_parts.append(np.zeros(len(local), dtype=bool))
                else:
                    data_parts.append(hc.data[local])
                    valid_parts.append(hc.valid[local])
                off += b.nrows
                lo = hi
            data = to_device(np.concatenate(data_parts), device)
            valid = to_device(np.concatenate(valid_parts), device)
            got = _column_stats(data, valid, torch.ones_like(valid))
        else:
            batch, _d = scan_table(table, [name], version=version, device=device)
            col = batch.cols[name]
            got = _column_stats(col.data, col.valid, batch.row_valid)
        (nulls, count, ndv, f1), bounds, bcounts, topf, top_vals, (mn, mx) = (
            got[0].tolist(), got[1], got[2], got[3], got[4], got[5]
        )

        def decode(v, count=count, typ=typ, dictionary=dictionary):
            if count == 0:
                return None
            if typ.kind == Kind.STRING and dictionary is not None and len(dictionary):
                code = int(v)
                if 0 <= code < len(dictionary):
                    return str(dictionary[code])
                return None
            if typ.kind == Kind.DECIMAL:
                return int(v) / 10**typ.scale
            if typ.kind == Kind.FLOAT:
                return float(v)
            return int(v)

        if sampled:
            # scale sample counts to the table; NDV by first-order
            # Haas-Stokes: D = d + (N/n - 1) * f1, clamped to [d, N]
            est_ndv = min(max(ndv, int(ndv + (ratio - 1.0) * f1)), nrows)
            stats[name] = ColumnStats(
                row_count=nrows,
                null_count=int(round(nulls * ratio)),
                ndv=est_ndv,
                bounds=bounds,
                bucket_counts=(bcounts.astype(np.float64) * ratio).astype(np.int64),
                topn=[(decode(v), int(round(int(f) * ratio)))
                      for v, f in zip(top_vals, topf) if int(f) > 0],
                min_val=decode(mn),
                max_val=decode(mx),
            )
        else:
            stats[name] = ColumnStats(
                row_count=count + nulls,
                null_count=nulls,
                ndv=ndv,
                bounds=bounds,
                bucket_counts=bcounts,
                topn=[(decode(v), int(f)) for v, f in zip(top_vals, topf) if int(f) > 0],
                min_val=decode(mn),
                max_val=decode(mx),
            )
    # merged under the table lock: concurrent one-column passes must not
    # lose each other's columns
    with table._lock:
        table.stats = stats if columns is None else {**(table.stats or {}), **stats}
        # the auto-analyze counter restarts (a manual ANALYZE counts too)
        table.analyzed_modify = table.modify_count
    return stats
