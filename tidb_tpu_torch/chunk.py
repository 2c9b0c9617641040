"""Columnar batches: host side (numpy) and device side (torch tensors).

Counterpart of tidb_tpu/chunk.py. The host half (``HostColumn``,
``HostBlock`` and their helpers) is the same numpy code. The device half
keeps the JAX package's static-shape model: a ``Batch`` is a dict of
``DevCol`` (data + validity tensors) plus ``row_valid``, the sel vector;
filters mask rows instead of compacting them, and row capacity is padded
to the same tile ladder (``pad_capacity``) so results match the JAX
package row for row.

Every tensor factory names its dtype and device: the JAX package runs
with x64 on, while torch defaults to float32.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tidb_tpu_torch.dtypes import Kind, SQLType
from tidb_tpu_torch.obs.engine_watch import ENGINE_WATCH

# Fixed tile ladder (rows). Mirrors the reference's paging growth
# 128 -> 50k (pkg/util/paging/paging.go:25-28) but with powers of two so a
# handful of compiled programs cover all sizes.
_MIN_CAPACITY = 256


def pad_capacity(n: int, floor: int = _MIN_CAPACITY, pow2: bool = False) -> int:
    """Smallest tile >= n on the engine's tiling ladder (>= floor).

    Batch tiles use half-steps (.., 2^k, 3*2^(k-1), 2^(k+1), ..): pure
    power-of-two padding wastes up to 50% of every full-array pass (TPC-H
    SF1 lineitem is 6.0M rows — 8.39M padded vs 6.29M with half-steps).
    pow2=True restricts to powers of two for sizes used as bitmask moduli
    (hash-table slot counts, exchange buckets)."""
    cap = floor
    while cap < n:
        half = cap + cap // 2
        if not pow2 and cap % 2 == 0 and half >= n:
            return half
        cap *= 2
    return cap


@dataclasses.dataclass
class HostColumn:
    """Numpy-backed column. ``dictionary`` is present iff type is STRING;
    it is sorted, so code order == binary collation order."""

    type: SQLType
    data: np.ndarray
    valid: np.ndarray
    dictionary: Optional[np.ndarray] = None  # np.array of str objects

    def __post_init__(self) -> None:
        assert self.data.shape == self.valid.shape

    def __len__(self) -> int:
        return len(self.data)

    def decode(self) -> np.ndarray:
        """Materialize logical values (object array with None for NULL).
        Vectorized — the reference streams chunks to the wire without a
        per-row interpreter (pkg/server/conn.go writeChunks:2286); a
        Python per-row loop here dominated large result sets."""
        n = len(self.data)
        out = np.empty(n, dtype=object)
        if self.type.kind == Kind.STRING:
            if self.dictionary is not None and len(self.dictionary):
                codes = np.clip(self.data, 0, len(self.dictionary) - 1)
                out[:] = self.dictionary[codes]
            else:
                out[:] = ""
        elif self.type.kind == Kind.DECIMAL:
            out[:] = (self.data / (10 ** self.type.scale)).tolist()
        elif self.type.kind == Kind.BOOL:
            out[:] = self.data.astype(bool).tolist()
        elif self.type.kind == Kind.FLOAT:
            out[:] = self.data.astype(np.float64).tolist()
        else:
            out[:] = self.data.astype(np.int64).tolist()
        out[~self.valid] = None
        return out


def encode_strings(values: List[Optional[str]]) -> HostColumn:
    """Dictionary-encode a string column. The dictionary is sorted so that
    integer code comparisons implement binary-collation string comparisons
    on device (reference collation engine: pkg/util/collate)."""
    valid = np.array([v is not None for v in values], dtype=bool)
    present = sorted({v for v in values if v is not None})
    dictionary = np.array(present, dtype=object)
    lookup = {v: i for i, v in enumerate(present)}
    codes = np.array([lookup[v] if v is not None else 0 for v in values], dtype=np.int32)
    from tidb_tpu_torch.dtypes import STRING

    return HostColumn(STRING, codes, valid, dictionary)


def column_from_values(values: List, typ: SQLType) -> HostColumn:
    if typ.kind == Kind.STRING:
        return encode_strings(values)
    valid = np.array([v is not None for v in values], dtype=bool)
    if typ.kind == Kind.DECIMAL:
        data = np.array(
            [round(float(v) * 10**typ.scale) if v is not None else 0 for v in values],
            dtype=np.int64,
        )
    elif typ.kind == Kind.DATE:
        from tidb_tpu_torch.dtypes import date_to_days

        data = np.array(
            [date_to_days(v) if isinstance(v, str) else (v or 0) for v in values],
            dtype=np.int32,
        )
    elif typ.kind == Kind.DATETIME:
        from tidb_tpu_torch.dtypes import datetime_to_micros

        data = np.array(
            [
                datetime_to_micros(v) if isinstance(v, str) else (v or 0)
                for v in values
            ],
            dtype=np.int64,
        )
    elif typ.kind == Kind.TIME:
        from tidb_tpu_torch.dtypes import time_to_micros

        data = np.array(
            [
                time_to_micros(v) if isinstance(v, str) else (v or 0)
                for v in values
            ],
            dtype=np.int64,
        )
    else:
        data = np.array([v if v is not None else 0 for v in values], dtype=typ.np_dtype)
    return HostColumn(typ, data, valid)


_block_uid = itertools.count(1)


@dataclasses.dataclass
class HostBlock:
    """A batch of rows on the host: the storage unit of a table partition."""

    columns: Dict[str, HostColumn]
    nrows: int
    # partition id for blocks of a partitioned table (Table.split_by_
    # partition tags appends); None = unpartitioned
    part_id: Optional[int] = None
    # process-unique immutable-block identity: version deltas (log
    # backup) diff block lists by uid instead of object identity, which
    # GC could recycle
    uid: int = dataclasses.field(default_factory=lambda: next(_block_uid))

    @staticmethod
    def from_columns(columns: Dict[str, HostColumn]) -> "HostBlock":
        n = len(next(iter(columns.values()))) if columns else 0
        for c in columns.values():
            assert len(c) == n
        return HostBlock(columns, n)


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------

#: bytes copied host->device and device->host, and the number of
#: device->host fetches (each one waits for the device to finish); copies
#: between CPU tensors are not counted
TRANSFERS = {"h2d_bytes": 0, "d2h_bytes": 0, "d2h_fetches": 0}


def reset_transfers() -> None:
    for k in TRANSFERS:
        TRANSFERS[k] = 0


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for and no card is present; the
    port never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


@dataclasses.dataclass
class DevCol:
    data: torch.Tensor
    valid: torch.Tensor  # bool, True = not NULL


@dataclasses.dataclass
class Batch:
    """Device-side batch: dict of columns + row validity (the sel vector)."""

    cols: Dict[str, DevCol]
    row_valid: torch.Tensor  # bool [capacity]

    @property
    def capacity(self) -> int:
        return self.row_valid.shape[0]

    @property
    def device(self) -> torch.device:
        return self.row_valid.device


def count_h2d(nbytes: int) -> None:
    """Host->device bytes: TRANSFERS and the engine watch's statement
    record, at the same sites, so the two agree to the byte."""
    TRANSFERS["h2d_bytes"] += nbytes
    ENGINE_WATCH.note_h2d(nbytes)


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """One host array -> device tensor, counted in TRANSFERS."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    count_h2d(arr.nbytes)
    return t.to(device)


def block_to_batch(
    block: HostBlock, capacity: Optional[int] = None, device=None
) -> Batch:
    """Pad a host block to a static tile and move it to the device (CUDA
    unless the caller names another)."""
    device = resolve_device(device)
    cap = capacity or pad_capacity(block.nrows)
    pad = cap - block.nrows
    # a block that fills its tile goes to the card as it is, with no padded
    # host copy; on the CPU the copy keeps the batch off the table's arrays
    copy = pad or device.type == "cpu"
    cols = {}
    for name, col in block.columns.items():
        cols[name] = DevCol(
            to_device(np.pad(col.data, (0, pad)) if copy else col.data, device),
            to_device(np.pad(col.valid, (0, pad)) if copy else col.valid, device),
        )
    row_valid = np.zeros(cap, dtype=bool)
    row_valid[: block.nrows] = True
    return Batch(cols, to_device(row_valid, device))


def fetch(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Device tensors -> numpy arrays in ONE device->host copy: the
    tensors are packed as raw bytes into one buffer on the device, copied
    once, and split again on the host (the JAX package's single
    ``jax.device_get`` per run)."""
    tensors = [t.contiguous() for t in tensors]
    if all(t.device.type == "cpu" for t in tensors):
        return [t.numpy().copy() for t in tensors]
    TRANSFERS["d2h_fetches"] += 1
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])
    host = flat.cpu().numpy()
    TRANSFERS["d2h_bytes"] += host.nbytes
    ENGINE_WATCH.note_d2h(host.nbytes)
    out, off = [], 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        np_dt = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(host[off: off + nb].view(np_dt).reshape(tuple(t.shape)))
        off += nb
    return out


def present_temporals(col: "HostColumn"):
    """decode() + MySQL string presentation for temporal kinds — the
    user-facing result seam (decode() itself stays raw ints for
    internal consumers). Vectorized via numpy datetime64 for
    DATE/DATETIME; TIME (rare in results) loops only over its rows."""
    k = col.type.kind
    if k not in (Kind.DATE, Kind.DATETIME, Kind.TIME):
        return col.decode()
    n = len(col.data)
    out = np.empty(n, dtype=object)
    if n == 0:
        # np.datetime_as_string rejects zero-size arrays; a 0-row
        # shuffle partition legitimately presents an empty column
        return out
    if k == Kind.DATE:
        out[:] = np.datetime_as_string(
            col.data.astype("datetime64[D]"), unit="D"
        )
    elif k == Kind.DATETIME:
        micros = col.data.astype(np.int64)
        secs = np.datetime_as_string(
            (micros // 1_000_000).astype("datetime64[s]"), unit="s"
        )
        secs = np.char.replace(secs, "T", " ")
        frac = micros % 1_000_000
        out[:] = secs
        nz = frac != 0
        if nz.any():
            from tidb_tpu_torch.dtypes import micros_to_datetime

            idx = np.nonzero(nz)[0]
            for i in idx:
                out[i] = micros_to_datetime(int(micros[i]))
    else:
        from tidb_tpu_torch.dtypes import micros_to_time

        out[:] = [micros_to_time(int(v)) for v in col.data]
    out[~col.valid] = None
    return out


def block_to_rows(block: HostBlock, schema_cols) -> List[tuple]:
    """Host block -> presented python row tuples (the row half of
    materialize_rows), zipped from whole decoded columns rather than
    built row by row."""
    decoded = [present_temporals(block.columns[c.internal]) for c in schema_cols]
    return list(zip(*[d.tolist() for d in decoded]))


def materialize_rows(batch, schema_cols, dicts):
    """Device batch -> python row tuples for a plan schema (one fetch,
    vectorized decode). Temporal columns present as MySQL-formatted
    strings, as in the JAX package."""
    types = {c.internal: c.type for c in schema_cols}
    return block_to_rows(batch_to_block(batch, types, dicts), schema_cols)


def batch_to_block(
    batch: Batch, types: Dict[str, SQLType], dicts: Dict[str, Optional[np.ndarray]]
) -> HostBlock:
    """Pull a device batch back to the host in one fetch and compact out
    invalid rows. Columns outside ``types`` stay on the device."""
    names = [n for n in batch.cols if n in types]
    arrays = fetch(
        [batch.row_valid]
        + [t for n in names for t in (batch.cols[n].data, batch.cols[n].valid)]
    )
    idx = np.nonzero(arrays[0])[0]
    cols = {}
    for i, name in enumerate(names):
        data, valid = arrays[1 + 2 * i], arrays[2 + 2 * i]
        cols[name] = HostColumn(types[name], data[idx], valid[idx], dicts.get(name))
    return HostBlock(cols, len(idx))
