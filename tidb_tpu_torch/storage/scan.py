"""Table scan: host blocks -> device Batch, with a device-resident cache.

Counterpart of tidb_tpu/storage/scan.py. Only the referenced columns are
copied to the device, each padded to the table's capacity tile, and each
is cached there keyed by (table, version, column, capacity, device): a
warm run copies nothing host->device, and queries over overlapping
column sets share one copy of each column. Host->device bytes are
counted in ``chunk.TRANSFERS``. The cache holds at most
``_SCAN_CACHE_MAX`` entries; ``release`` drops columns whose room a
larger statement needs (the streamed aggregation's sizing) or that no
later statement reads.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tidb_tpu_torch.chunk import TRANSFERS, Batch, DevCol, pad_capacity, resolve_device
from tidb_tpu_torch.storage.table import Table

# (table uid, version, column, capacity, device) -> DevCol, plus one
# row-validity mask per (table uid, version, capacity, device).
_scan_cache: "OrderedDict[tuple, DevCol]" = OrderedDict()
_SCAN_CACHE_MAX = 256
#: the cache's column name for a table's row-validity mask
ROW_MASK = "\x00rows"


def _cached(table: Table, key: tuple, make):
    """Cache lookup keyed by (table uid, version, ...); inserting a new
    version's entry evicts the table's older versions."""
    hit = _scan_cache.get(key)
    if hit is not None:
        _scan_cache.move_to_end(key)
        return hit
    value = make()
    for k in [k for k in _scan_cache if k[0] == table.uid and k[1] != key[1]]:
        del _scan_cache[k]
    while len(_scan_cache) >= _SCAN_CACHE_MAX:
        _scan_cache.popitem(last=False)
    _scan_cache[key] = value
    return value


def _column(table: Table, v: int, name: str, cap: int, device) -> DevCol:
    """One column of a version, padded to `cap` rows, on the device. Each
    block is copied into its rows of a zeroed device tile: no padded host
    copy (6.4 GB per int64 column at TPC-H SF100)."""
    typ = table.schema.types[name]
    dtype = torch.from_numpy(np.zeros(0, dtype=typ.np_dtype)).dtype
    data = torch.zeros(cap, dtype=dtype, device=device)
    valid = torch.zeros(cap, dtype=torch.bool, device=device)
    off = 0
    for b in table.blocks(v):
        c = b.columns.get(name)
        if c is not None:  # a block without the column reads as NULL
            for dst, src in ((data, c.data), (valid, c.valid)):
                dst[off: off + b.nrows].copy_(torch.from_numpy(np.ascontiguousarray(src)))
                TRANSFERS["h2d_bytes"] += src.nbytes
        off += b.nrows
    return DevCol(data, valid)


def _nbytes(value) -> int:
    if isinstance(value, DevCol):
        return value.data.nbytes + value.valid.nbytes
    return value.nbytes


def is_cached(table: Table, version: int, column: str, capacity: int, device: str) -> bool:
    """Whether a column's tile already lies in the device cache."""
    return (table.uid, version, column, capacity, device) in _scan_cache


def device_bytes(keep=()) -> int:
    """Bytes of the cached device columns (row masks included) outside
    `keep`, a set of (table uid, column); a row mask's column is
    ``ROW_MASK``."""
    return sum(_nbytes(val) for k, val in _scan_cache.items() if (k[0], k[2]) not in keep)


def release(table: Optional[Table] = None, keep=()) -> int:
    """Drop the cached device columns of `table` (of every table when
    None), except those in `keep` (a set of (table uid, column)). Their
    memory returns once no batch holds them. Returns the bytes dropped."""
    drop = [
        k for k in _scan_cache
        if (table is None or k[0] == table.uid) and (k[0], k[2]) not in keep
    ]
    freed = sum(_nbytes(_scan_cache[k]) for k in drop)
    for k in drop:
        del _scan_cache[k]
    return freed


def scan_table(
    table: Table,
    columns: Sequence[str],
    capacity: Optional[int] = None,
    version: Optional[int] = None,
    device=None,
) -> Tuple[Batch, Dict[str, np.ndarray]]:
    """Returns (device batch, dictionaries of the scanned columns). The
    batch lies on CUDA unless the caller names another device."""
    device = resolve_device(device)
    v = table.version if version is None else version
    n = sum(b.nrows for b in table.blocks(v))
    cap = capacity or pad_capacity(n)
    dev = str(device)
    cols = {
        c: _cached(table, (table.uid, v, c, cap, dev),
                   lambda c=c: _column(table, v, c, cap, device))
        for c in columns
    }
    rv = _cached(
        table, (table.uid, v, ROW_MASK, cap, dev),
        lambda: torch.arange(cap, dtype=torch.int64, device=device) < n,
    )
    dicts = {c: table.dictionaries[c] for c in columns if c in table.dictionaries}
    return Batch(cols, rv), dicts
