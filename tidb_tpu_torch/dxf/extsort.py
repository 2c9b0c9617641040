"""External-sort runs and vectorized k-way merge for DXF backfill and
IMPORT INTO sorted ingest.

Counterpart of tidb_tpu/dxf/extsort.py. The runs, their files and the
merges are the JAX package's; the install targets are the port's own
index structures: a single column's merge becomes the range index entry
``Table._idx_cache[(block uids, column)]`` (valid values in value order,
then the NULL rows in row order, as ``Table._sorted_index`` builds it),
and a composite key's merged row views the uniqueness index entry
``Table._key_cache[("rows", columns)]``. The ``extsort/merge-round``
failpoint fires at each round of a merge, ``extsort/merge-views`` at each
merge of row views.

Reference: lightning's external backend — EncodeAndSort writes per-chunk
sorted KV files, MergeOverlappingFiles k-way merges them, Ingest
installs (br/pkg/lightning/backend/external/merge.go:39,
pkg/disttask/importinto steps). The columnar analog: every subtask
sorts ITS block(s) into a run file (sorted values + permutation), and
the finalizer merges K sorted runs with a vectorized pairwise stable
merge — O(n log k) searchsorted passes, no Python per-row heap — then
installs the result as the table's derived sorted-index cache entry, so
the first query after the DDL/IMPORT pays no argsort.

Sort key = (null-rank, value): NULLs rank last, as in
Table._sorted_index.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from tidb_tpu_torch.utils.failpoint import inject


def _rows_view(m: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(m).view([("", m.dtype)] * m.shape[1]).ravel()


def _key_matrix(svals: np.ndarray, rank: np.ndarray) -> np.ndarray:
    """[n, 2] (rank, value) in one dtype so the void row-view compares
    lexicographically — rank first, value second, like the lexsort."""
    dt = np.result_type(svals.dtype, np.int8)
    return np.column_stack([rank.astype(dt), svals.astype(dt)])


def sort_run(
    data: np.ndarray, valid: np.ndarray, row_offset: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort one block's column: (sorted values, null-rank per sorted
    element, GLOBAL row ids). The distributed EncodeAndSort step."""
    rank = np.where(valid, 0, 1).astype(np.int8)
    perm = np.lexsort((data, rank))
    return data[perm], rank[perm], (perm + row_offset).astype(np.int64)


def write_run(path: str, data, valid, row_offset: int) -> dict:
    """Spill one sorted run to disk; returns its manifest entry."""
    svals, rank, rows = sort_run(
        np.asarray(data), np.asarray(valid), row_offset
    )
    np.savez(path, svals=svals, rank=rank, rows=rows)
    return {"run": path, "n": int(len(svals)), "nvalid": int((rank == 0).sum())}


def read_run(path: str):
    with np.load(path) as z:
        return z["svals"], z["rank"], z["rows"]


def merge_two(a, b):
    """Stable vectorized merge of two sorted runs (a precedes b: a wins
    ties, preserving global row order for equal keys)."""
    (sa, ra, pa), (sb, rb, pb) = a, b
    ka = _rows_view(_key_matrix(sa, ra))
    kb = _rows_view(_key_matrix(sb, rb))
    pos_a = np.arange(len(ka)) + np.searchsorted(kb, ka, side="left")
    pos_b = np.arange(len(kb)) + np.searchsorted(ka, kb, side="right")
    n = len(ka) + len(kb)
    svals = np.empty(n, dtype=np.result_type(sa.dtype, sb.dtype))
    rank = np.empty(n, dtype=np.int8)
    rows = np.empty(n, dtype=np.int64)
    svals[pos_a], svals[pos_b] = sa, sb
    rank[pos_a], rank[pos_b] = ra, rb
    rows[pos_a], rows[pos_b] = pa, pb
    return svals, rank, rows


def merge_runs(runs: List[tuple]) -> Optional[tuple]:
    """K-way merge by pairwise rounds: log2(k) vectorized passes.
    Runs must be in global row order (run i's rows precede run i+1's)
    for tie stability."""
    runs = [r for r in runs if r is not None and len(r[0])]
    if not runs:
        return None
    while len(runs) > 1:
        inject("extsort/merge-round")
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            nxt.append(merge_two(runs[i], runs[i + 1]))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


def install_sorted_index(
    table, col: str, merged, version: int, bump: bool = False
) -> bool:
    """Install a merged run as the range index entry of (the version's
    blocks, col): the Ingest step. Returns False when the table has moved
    past `version` (the caller plans again) or the merged row count does
    not match the blocks (stale runs). bump=True also publishes a
    schema-barrier version (the same blocks, so the entry serves it) in
    the same lock hold: the backfill's flip to public."""
    with table._lock:
        if table.version != version:
            return False
        blocks = table.blocks(version)
        total = sum(b.nrows for b in blocks)
        if merged is None:
            if total:
                return False
            entry = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64), 0)
        else:
            svals, rank, perm = merged
            if len(svals) != total:
                return False
            nvalid = int((rank == 0).sum())
            svals = svals.astype(blocks[0].columns[col].data.dtype, copy=False)
            if nvalid < total:
                # the NULL rows in row order, as Table._sorted_index
                # keeps them
                data = np.concatenate([b.columns[col].data for b in blocks])
                valid = np.concatenate([b.columns[col].valid for b in blocks])
                nulls = np.flatnonzero(~valid)
                perm = np.concatenate([perm[:nvalid], nulls])
                svals = np.concatenate([svals[:nvalid], data[nulls]])
            entry = (svals, perm, nvalid)
        if bump:
            table._publish(list(table._versions[version]))
        table._idx_cache[(tuple(b.uid for b in blocks), col)] = entry
        return True


def cleanup_runs(manifests: List[dict]) -> None:
    for m in manifests or []:
        p = (m or {}).get("run")
        if p:
            try:
                os.unlink(p)
            except OSError:
                pass


# -- dict columns, composite keys, partitions ---------------------------------
# (reference: br/pkg/lightning/backend/external/merge.go:39 — the merge
# step handles arbitrary encoded keys; here dictionary codes remap
# MONOTONICALLY on alignment — merged dictionaries stay sorted — so
# chunk-sorted runs remain sorted after the code remap, and
# lexicographic composite order is invariant under per-field monotone
# maps.)


def _dict_lut(local_dict, table_dict) -> np.ndarray:
    """local-code -> table-code LUT (both dictionaries sorted, so the
    map is monotone and sorted runs stay sorted). The ONE place the
    remap is built — remap_codes and remap_comp_fields share it."""
    loc = np.array([str(x) for x in local_dict], dtype=object)
    tab = np.asarray(table_dict, dtype=object)
    return np.searchsorted(tab, loc).astype(np.int64)


def remap_codes(svals, rank, local_dict, table_dict):
    """Remap a dict-coded run's LOCAL codes to the table-global
    dictionary; NULL entries (rank != 0) carry arbitrary values and are
    clipped, never looked up meaningfully."""
    if local_dict is None or not len(local_dict):
        return svals
    lut = _dict_lut(local_dict, table_dict)
    clipped = np.clip(svals, 0, len(lut) - 1)
    return np.where(rank == 0, lut[clipped], svals)


def write_comp_run(path: str, mat: np.ndarray) -> dict:
    """Spill one chunk's SORTED composite key matrix ([m, k] int64,
    valid-only rows, lexicographically sorted)."""
    order = np.lexsort(mat.T[::-1]) if len(mat) else np.zeros(0, np.int64)
    np.savez(path, mat=mat[order])
    return {"run": path, "n": int(len(mat))}


def read_comp_run(path: str) -> np.ndarray:
    with np.load(path) as z:
        return z["mat"]


def remap_comp_fields(mat: np.ndarray, dict_fields: dict, table_dicts):
    """Per-field monotone code remap of a composite key matrix
    (dict_fields: field index -> local dictionary entries)."""
    if not dict_fields:
        return mat
    mat = mat.copy()
    for fi, local in dict_fields.items():
        fi = int(fi)
        lut = _dict_lut(local, table_dicts[fi])
        mat[:, fi] = lut[np.clip(mat[:, fi], 0, len(lut) - 1)]
    return mat


def merge_sorted_views(views) -> Optional[np.ndarray]:
    """Merge sorted structured row views: one stable sort of the
    concatenation — numpy's timsort exploits the pre-sorted runs."""
    inject("extsort/merge-views")
    views = [v for v in views if v is not None and len(v)]
    if not views:
        return None
    if len(views) == 1:
        return views[0]
    return np.sort(np.concatenate(views), kind="stable")


def install_composite_index(table, cols: tuple, merged_view, version: int) -> bool:
    """Install a merged composite key view as the uniqueness index entry
    of `cols` (the structure ``Table._check_unique_composite`` searches),
    keyed by the version's covering block uids. Returns False when the
    table moved."""
    with table._lock:
        if table.version != version:
            return False
        blocks = [b for b in table._versions[version] if all(c in b.columns for c in cols)]
        table._key_cache[("rows", tuple(cols))] = (
            tuple(b.uid for b in blocks),
            merged_view if merged_view is not None
            else _rows_view(np.zeros((0, len(cols)), np.int64)),
        )
        return True
