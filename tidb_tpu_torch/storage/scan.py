"""Table scan: host blocks -> device Batch, with a device-resident cache.

Counterpart of tidb_tpu/storage/scan.py. Only the referenced columns are
copied to the device, each padded to the table's capacity tile, and each
is cached there keyed by (table, version, column, capacity, device,
partitions): a warm run copies nothing host->device, and queries over
overlapping column sets share one copy of each column. A pruned scan
copies only the kept partitions' blocks (``partitions``); each pruned set
is an entry of its own beside the whole table's, and the sets of one
version never evict each other. Host->device bytes are
counted in ``chunk.TRANSFERS``. The cache holds at most
``_SCAN_CACHE_MAX`` entries; ``release`` drops columns whose room a
larger statement needs (the streamed aggregation's sizing) or that no
later statement reads, and ``invalidate`` a written table's superseded
versions. Where the JAX package clears the whole cache after every
write, the port drops only the written table's entries: a key names its
table's version, so an older version's entry could never be hit.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tidb_tpu_torch.chunk import Batch, DevCol, count_h2d, pad_capacity, resolve_device
from tidb_tpu_torch.storage.table import Table
from tidb_tpu_torch.utils.failpoint import inject

# (table uid, version, column, capacity, device, partitions) -> DevCol,
# plus one row-validity mask per (table uid, version, capacity, device,
# partitions); partitions is the sorted tuple of kept ids, None for all.
_scan_cache: "OrderedDict[tuple, DevCol]" = OrderedDict()
_SCAN_CACHE_MAX = 256
#: the cache's column name for a table's row-validity mask
ROW_MASK = "\x00rows"
#: the virtual row handle multi-table DML reads (a row's position in the
#: version's block concatenation, the coordinates its masks address)
ROWID = "_tidb_rowid"


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


def _column(table: Table, v: int, name: str, cap: int, device, partitions=None) -> DevCol:
    """One column of a version (of its kept partitions' blocks), padded to
    `cap` rows, on the device. Each block is copied into its rows of a
    zeroed device tile: no padded host copy (6.4 GB per int64 column at
    TPC-H SF100)."""
    blocks = table.blocks(v, partitions=partitions)
    if name == ROWID:
        n = sum(b.nrows for b in blocks)
        idx = torch.arange(cap, dtype=torch.int64, device=device)
        return DevCol(idx, idx < n)
    typ = table.schema.types[name]
    dtype = torch.from_numpy(np.zeros(0, dtype=typ.np_dtype)).dtype
    data = torch.zeros(cap, dtype=dtype, device=device)
    valid = torch.zeros(cap, dtype=torch.bool, device=device)
    off = 0
    for b in blocks:
        c = b.columns.get(name)
        if c is not None:  # a block without the column reads as NULL
            for dst, src in ((data, c.data), (valid, c.valid)):
                dst[off: off + b.nrows].copy_(torch.from_numpy(np.ascontiguousarray(src)))
                count_h2d(src.nbytes)
        off += b.nrows
    return DevCol(data, valid)


def _nbytes(value) -> int:
    if isinstance(value, DevCol):
        return value.data.nbytes + value.valid.nbytes
    return value.nbytes


def _pkey(partitions):
    """The cache's partition key: the kept ids sorted, None for the whole
    table."""
    return tuple(sorted(partitions)) if partitions is not None else None


def is_cached(table: Table, version: int, column: str, capacity: int, device: str,
              partitions=None) -> bool:
    """Whether a column's tile (of the kept partitions) already lies in
    the device cache."""
    return (table.uid, version, column, capacity, device, _pkey(partitions)) in _scan_cache


def device_bytes(keep=()) -> int:
    """Bytes of the cached device columns (row masks included) outside
    `keep`, a set of (table uid, column); a row mask's column is
    ``ROW_MASK``."""
    return sum(_nbytes(val) for k, val in _scan_cache.items() if (k[0], k[2]) not in keep)


def device_bytes_by_table() -> Dict[int, int]:
    """Table uid -> bytes of its cached device columns."""
    out: Dict[int, int] = {}
    for k, val in _scan_cache.items():
        out[k[0]] = out.get(k[0], 0) + _nbytes(val)
    return out


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


def invalidate(table: Table) -> int:
    """Drop the cached columns of `table`'s versions other than its
    current one (after a write). Returns the bytes dropped."""
    drop = [k for k in _scan_cache if k[0] == table.uid and k[1] != table.version]
    freed = sum(_nbytes(_scan_cache[k]) for k in drop)
    for k in drop:
        del _scan_cache[k]
    return freed


def cached_partition_sets() -> Dict[int, Dict[object, int]]:
    """Table uid -> {kept partition ids (None: the whole table) -> bytes
    of its cached device columns}."""
    out: Dict[int, Dict[object, int]] = {}
    for k, val in _scan_cache.items():
        per = out.setdefault(k[0], {})
        per[k[5]] = per.get(k[5], 0) + _nbytes(val)
    return out


def cached_versions() -> Dict[int, set]:
    """Table uid -> the versions the cache holds columns of."""
    out: Dict[int, set] = {}
    for k in _scan_cache:
        out.setdefault(k[0], set()).add(k[1])
    return out


def scan_table(
    table: Table,
    columns: Sequence[str],
    capacity: Optional[int] = None,
    version: Optional[int] = None,
    device=None,
    partitions=None,
) -> Tuple[Batch, Dict[str, np.ndarray]]:
    """Returns (device batch, dictionaries of the scanned columns). The
    batch lies on CUDA unless the caller names another device.
    `partitions`: the partition ids whose blocks the scan reads (with the
    untagged blocks); None reads every block."""
    inject("storage/scan")
    device = resolve_device(device)
    v = table.version if version is None else version
    pkey = _pkey(partitions)
    n = sum(b.nrows for b in table.blocks(v, partitions=pkey))
    cap = capacity or pad_capacity(n)
    dev = str(device)
    cols = {
        c: _cached(table, (table.uid, v, c, cap, dev, pkey),
                   lambda c=c: _column(table, v, c, cap, device, pkey))
        for c in columns
    }
    rv = _cached(
        table, (table.uid, v, ROW_MASK, cap, dev, pkey),
        lambda: torch.arange(cap, dtype=torch.int64, device=device) < n,
    )
    dicts = {c: table.dictionaries[c] for c in columns if c in table.dictionaries}
    return Batch(cols, rv), dicts
