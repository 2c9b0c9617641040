"""Tables: versioned lists of immutable host blocks.

Counterpart of tidb_tpu/storage/table.py. Every write publishes a new
version (copy-on-write block lists); a transaction pins the version it
reads, and ``_gc_versions`` drops versions nobody can read any more (the
current one, the one before it and pinned ones stay). String columns
share one sorted dictionary per table: an append merges its strings in
and remaps the codes of existing blocks when the dictionary grows.
The PRIMARY KEY and every UNIQUE index are enforced on every append
(single-column and composite), NOT NULL and the ENUM, SET and JSON value
domains on every block install (once per dictionary entry a block uses).
The plan compiler bakes per-version column facts into a program
(``col_bounds``, ``col_has_nulls``).

Secondary and UNIQUE indexes are names over columns with a schema state
(``index_states``: write_only, write_reorg, public); their physical form
is a per-(version, column) argsort permutation built on first use
(``_sorted_index``), which ``range_rows`` searches and ``gather_rows``
reads through. ALTER TABLE's column forms publish a new version
(``alter_add_column``, ``alter_drop_column``, ``alter_modify_column``,
``alter_rename_column``).

A table also carries its constraint and generated-column metadata
(``checks``, ``fks``, ``fk_actions``, ``fk_update_actions``,
``generated``), which the session enforces on its write path.

Partitioning (RANGE, HASH or LIST over one integer-encoded column) is
table metadata, versioned with the table (``partition_defs_at``): an
append splits its block by partition (``split_by_partition``, each block
tagged with its ``part_id``), a pruned read keeps only the blocks of the
partitions it names (``blocks(version, partitions=)``; an untagged block
always scans), and ADD, DROP and TRUNCATE PARTITION publish a new
version (``alter_add_partitions``, ``alter_drop_partitions``).

TTL: ``ttl`` is (column, interval, unit) or None, and ``purge_expired``
drops the rows whose TTL column is older than a cutoff in one step
(utils/ttl.py computes the cutoff). Commit observers and the fleet's
delta capture are not ported.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tidb_tpu_torch.chunk import HostBlock, HostColumn, column_from_values
from tidb_tpu_torch.dtypes import Kind, SQLType
from tidb_tpu_torch.utils import racecheck
from tidb_tpu_torch.utils.failpoint import inject

_table_uid_counter = itertools.count(1)

#: MVCC history retention in seconds (the ``tidb_gc_life_time`` analog).
#: 0 keeps only what pins and the current version require.
GC_LIFE_S: float = 0.0

#: blocks at least this many rows long are copied one column per thread
_PARALLEL_ROWS = 1 << 20

#: the range index's host sorts: how many ran and their seconds; what a
#: narrowed read pays after each write
INDEX_SORTS = {"sorts": 0, "rows": 0, "seconds": 0.0}


def set_gc_life(seconds: float) -> None:
    global GC_LIFE_S
    GC_LIFE_S = max(0.0, float(seconds))


@dataclasses.dataclass
class TableSchema:
    # ordered (name, type); names stored lowercase
    columns: List[Tuple[str, SQLType]]
    primary_key: Optional[List[str]] = None
    # value-domain constraints riding on the schema (the device type of
    # all three is a dictionary-coded STRING): enums: column -> allowed
    # values; sets: column -> allowed members (comma-joined subsets);
    # json_cols: columns whose values must parse as JSON
    enums: Optional[Dict[str, tuple]] = None
    sets: Optional[Dict[str, tuple]] = None
    json_cols: tuple = ()
    # columns declared NOT NULL (MySQL strict-mode write rejection; PK
    # columns are enforced separately on the key path)
    not_null: tuple = ()

    @property
    def names(self) -> List[str]:
        return [n for n, _ in self.columns]

    @property
    def types(self) -> Dict[str, SQLType]:
        return dict(self.columns)


def _strictly_sorted(d: np.ndarray) -> bool:
    return all(d[i] < d[i + 1] for i in range(len(d) - 1))


def _merge_dictionaries(
    old: Optional[np.ndarray], new: Optional[np.ndarray]
) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """Merge a sorted dictionary with a block's; returns (merged,
    old_remap, new_remap) as the JAX package's set-based merge does, by
    binary search: the cost is the new strings' searches plus integer
    work over the old dictionary, not a sort of it."""
    old = old if old is not None else np.array([], dtype=object)
    new = new if new is not None else np.array([], dtype=object)
    inverse = None
    if len(new) > 1 and not _strictly_sorted(new):
        new, inverse = np.unique(new, return_inverse=True)
    if len(old) == 0:
        merged = np.array(new, dtype=object)
        new_remap = np.arange(len(new), dtype=np.int32) if len(new) else None
        old_remap = None
    else:
        pos = np.searchsorted(old, new)
        present = np.zeros(len(new), dtype=bool)
        inb = pos < len(old)
        present[inb] = old[pos[inb]] == new[inb]
        fresh = new[~present]
        ins = pos[~present]
        old_remap = np.arange(len(old), dtype=np.int64)
        if len(fresh):
            old_remap += np.searchsorted(ins, np.arange(len(old)), side="right")
            merged = np.insert(old, ins, fresh)
        else:
            merged = old
        new_remap = np.empty(len(new), dtype=np.int64)
        new_remap[present] = old_remap[pos[present]]
        new_remap[~present] = ins + np.arange(len(fresh))
        old_remap = old_remap.astype(np.int32)
        new_remap = new_remap.astype(np.int32) if len(new) else None
    if inverse is not None and new_remap is not None:
        new_remap = new_remap[inverse.reshape(-1)]
    return merged, old_remap, new_remap


def _take_block(block: HostBlock, idx: np.ndarray) -> HostBlock:
    """The rows `idx` of a block; a long block's columns are gathered
    one per thread (numpy releases the GIL in ``take``)."""

    def take(c: HostColumn) -> HostColumn:
        return HostColumn(c.type, np.take(c.data, idx), np.take(c.valid, idx), c.dictionary)

    names = list(block.columns)
    if block.nrows >= _PARALLEL_ROWS and len(names) > 1:
        with ThreadPoolExecutor(min(len(names), 8), thread_name_prefix="storage-take") as ex:
            cols = list(ex.map(take, [block.columns[n] for n in names]))
    else:
        cols = [take(block.columns[n]) for n in names]
    return HostBlock(dict(zip(names, cols)), len(idx), part_id=block.part_id)


class Table:
    def __init__(self, name: str, schema: TableSchema):
        self.name = name
        self.schema = schema
        self._lock = racecheck.make_lock("table")
        # process-unique id: device-cache keys must not alias a new table
        # onto a freed one's address
        self.uid = next(_table_uid_counter)
        self.version = 0
        self._versions: Dict[int, List[HostBlock]] = {0: []}
        # version -> publish wall-clock ts
        self.version_ts: Dict[int, float] = {0: time.time()}
        # snapshot pins: version -> refcount; GC never drops a pinned one
        self._pins: Dict[int, int] = {}
        # table-global sorted dictionary per string column
        self.dictionaries: Dict[str, np.ndarray] = {
            n: np.array([], dtype=object)
            for n, t in schema.columns
            if t.kind == Kind.STRING
        }
        # named secondary indexes: name -> ordered column list; the names
        # that carry a UNIQUE constraint; the names ALTER INDEX ...
        # INVISIBLE hid from the planner (still maintained and checked);
        # and each index's schema state (a missing entry is public):
        # writers check an index in any state, readers use public ones
        self.indexes: Dict[str, List[str]] = {}
        self.unique_indexes: set = set()
        self.invisible_indexes: set = set()
        self.index_states: Dict[str, str] = {}
        self.stats: dict = {}
        # rows changed since the last ANALYZE (auto-analyze's counter)
        self.modify_count = 0
        self.analyzed_modify = 0
        # AUTO_INCREMENT allocator
        self.autoinc_col: Optional[str] = None
        self.autoinc_next = 1
        # column -> DEFAULT value for INSERTs that omit the column
        self.defaults: Dict[str, object] = {}
        # CHECK constraints [(name, expression SQL text)]
        self.checks: list = []
        # FOREIGN KEYs [(name, column, ref db, ref table, ref column)];
        # fk_actions: name -> ON DELETE action ("cascade" / "set_null"),
        # fk_update_actions the same for ON UPDATE; a missing name is
        # RESTRICT
        self.fks: list = []
        self.fk_actions: Dict[str, str] = {}
        self.fk_update_actions: Dict[str, str] = {}
        # generated columns [(column, expression SQL text, stored)], in
        # definition order (an evaluation order)
        self.generated: list = []
        self._bounds_cache: dict = {}
        self._nulls_cache: dict = {}
        # key columns -> (block uids covered, sorted key values): the
        # uniqueness check's index, extended by appends
        self._key_cache: dict = {}
        # (block uids, column) -> (sorted values, argsort permutation,
        # valid count): the range index, at most a few entries
        self._idx_cache: dict = {}
        # partitioning: ("range", column, [(name, upper or None)]),
        # ("hash", column, count) or ("list", column, [(name, values)]),
        # bounds and values raw-encoded; None = unpartitioned. The defs
        # are versioned: a reader pinned before a partition DDL prunes
        # with the defs its blocks were tagged under
        self._partition: Optional[tuple] = None
        self._partition_history: List[Tuple[int, Optional[tuple]]] = []
        # TTL option (column, interval value, unit); None: rows never expire
        self.ttl: Optional[tuple] = None

    @property
    def partition(self) -> Optional[tuple]:
        return self._partition

    @partition.setter
    def partition(self, defs: Optional[tuple]) -> None:
        self._partition = defs
        hist = self._partition_history
        if not hist or hist[-1][1] != defs:
            hist.append((self.version, defs))

    def partition_defs_at(self, version: Optional[int]) -> Optional[tuple]:
        """The partition defs in force at `version` (None: the current)."""
        hist = self._partition_history
        if version is None or not hist:
            return self._partition
        defs = hist[0][1]
        for v, p in hist:
            if v > version:
                break
            defs = p
        return defs

    def index_state(self, name: str) -> str:
        return self.index_states.get(name.lower(), "public")

    def public_indexes(self) -> Dict[str, List[str]]:
        """Indexes the planner may read: public and not INVISIBLE."""
        return {
            n: cols
            for n, cols in self.indexes.items()
            if self.index_state(n) == "public" and n not in self.invisible_indexes
        }

    def blocks(self, version: Optional[int] = None, partitions=None) -> List[HostBlock]:
        """A version's blocks; `partitions` (partition ids) keeps only
        theirs, and the untagged blocks, which may hold any partition's
        rows."""
        bs = self._versions[self.version if version is None else version]
        if partitions is None:
            return bs
        keep = set(partitions)
        return [b for b in bs if b.part_id is None or b.part_id in keep]

    # -- partitioning ----------------------------------------------------
    def partition_names(self, version: Optional[int] = None) -> list:
        """The partitions' names, by id, under the defs at `version`."""
        defs = self.partition_defs_at(version)
        if defs is None:
            return []
        if defs[0] == "hash":
            return [f"p{i}" for i in range(int(defs[2]))]
        return [n for n, _u in defs[2]]

    def null_partition(self) -> Optional[int]:
        """Where NULL keys go: the lowest partition of RANGE and HASH, the
        LIST partition listing NULL (None when none does: NULL rows are
        refused)."""
        if self.partition is None:
            return None
        if self.partition[0] != "list":
            return 0
        for i, (_n, vals) in enumerate(self.partition[2]):
            if any(v is None for v in vals):
                return i
        return None

    def partition_of(self, values: np.ndarray) -> np.ndarray:
        """The partition id of each raw-encoded partition-column value."""
        kind = self.partition[0]
        v64 = values.astype(np.int64)
        if kind == "hash":
            n = int(self.partition[2])
            return (v64 % n + n) % n
        if kind == "list":
            flat = [(v, i) for i, (_n, vals) in enumerate(self.partition[2])
                    for v in vals if v is not None]
            fv = np.array([v for v, _i in flat], dtype=np.int64)
            order = np.argsort(fv)
            fv, fp = fv[order], np.array([i for _v, i in flat], dtype=np.int64)[order]
            pos = np.searchsorted(fv, v64)
            pos_c = np.minimum(pos, max(len(fv) - 1, 0))
            ok = (pos < len(fv)) & (fv[pos_c] == v64) if len(fv) else np.zeros(len(v64), bool)
            if not ok.all():
                raise ValueError(f"Table has no partition for value {int(v64[~ok][0])}")
            return fp[pos_c]
        uppers = [u for _n, u in self.partition[2]]
        bounds = np.array([u for u in uppers if u is not None], dtype=np.int64)
        pid = np.searchsorted(bounds, v64, side="right")
        if uppers and uppers[-1] is None:
            return np.minimum(pid, len(uppers) - 1)
        if (pid >= len(uppers)).any():
            raise ValueError(f"Table has no partition for value {int(values[pid.argmax()])}")
        return pid

    def split_by_partition(self, block: HostBlock) -> List[HostBlock]:
        """An incoming block as one block per partition it reaches, each
        tagged with its ``part_id``; an unpartitioned table's block passes
        through."""
        if self.partition is None or block.nrows == 0:
            return [block]
        pcol = self.partition[1]
        c = block.columns.get(pcol)
        if c is None:
            raise ValueError(f"partition column {pcol!r} missing")
        np_id = 0
        if not c.valid.all():
            np_id = self.null_partition()
            if np_id is None:
                raise ValueError(
                    "Table has no partition for NULL "
                    f"(no LIST partition lists NULL in {pcol!r})")
        pid = np.full(block.nrows, np_id, dtype=np.int64)
        if c.valid.any():
            pid[c.valid] = self.partition_of(c.data[c.valid])
        first = int(pid[0])
        if (pid == first).all():
            return [HostBlock(dict(block.columns), block.nrows, part_id=first)]
        out = []
        for p in np.unique(pid).tolist():
            nb = _take_block(block, np.flatnonzero(pid == p))
            nb.part_id = int(p)
            out.append(nb)
        return out

    @property
    def nrows(self) -> int:
        return sum(b.nrows for b in self.blocks())

    # -- versions and pins ----------------------------------------------
    def pin(self, version: int) -> None:
        with self._lock:
            self._pins[version] = self._pins.get(version, 0) + 1

    def unpin(self, version: int) -> None:
        with self._lock:
            n = self._pins.get(version, 0) - 1
            if n <= 0:
                self._pins.pop(version, None)
            else:
                self._pins[version] = n

    def pin_current(self) -> int:
        """Pin and return the current version in one step."""
        with self._lock:
            v = self.version
            self._pins[v] = self._pins.get(v, 0) + 1
            return v

    def _gc_versions(self) -> None:
        """Drop versions nobody can read: keep the current one, the one
        before it (a statement resolves its version before it fetches),
        every pinned one and those published inside ``GC_LIFE_S``.
        Caller holds the lock."""
        inject("storage/gc-versions")
        self.version_ts.setdefault(self.version, time.time())
        keep = {self.version, self.version - 1} | set(self._pins)
        if GC_LIFE_S > 0:
            horizon = time.time() - GC_LIFE_S
            keep |= {v for v, ts in self.version_ts.items() if ts >= horizon}
        for v in [v for v in self._versions if v not in keep]:
            inject("storage/gc-drop-version")
            del self._versions[v]
        for v in [v for v in self.version_ts if v not in self._versions]:
            del self.version_ts[v]

    def version_at(self, ts: float, clamp_oldest: bool = False) -> int:
        """Newest version published at or before `ts` that is still
        readable (a stale read's version). Raises when that snapshot was
        collected or predates the table, as the reference's 'GC life time
        is shorter than transaction duration'. clamp_oldest: resolve to
        the oldest retained version instead of raising, as
        ``tidb_read_staleness`` does for a table younger than its window;
        an explicit AS OF stays strict."""
        with self._lock:
            cands = [v for v, t0 in self.version_ts.items() if t0 <= ts and v in self._versions]
            if not cands:
                if clamp_oldest and self._versions:
                    return min(self._versions)
                raise ValueError(
                    f"snapshot of {self.name!r} at ts {ts:.3f} is "
                    "unavailable: older than the GC safepoint (raise "
                    "tidb_gc_life_time) or before table creation"
                )
            return max(cands)

    def _publish(self, blocks: List[HostBlock]) -> int:
        """Install `blocks` as a new version. Caller holds the lock."""
        self.version += 1
        self._versions[self.version] = blocks
        self._gc_versions()
        return self.version

    def bump_version(self) -> int:
        """Republish the same blocks under a new version: transactions
        whose shadow predates a schema change then fail their commit's
        conflict check."""
        with self._lock:
            return self._publish(list(self._versions[self.version]))

    # -- write -----------------------------------------------------------
    def append_block(self, block: HostBlock) -> int:
        """Append rows; returns the new version id."""
        v, _uids = self.append_block_uids(block)
        return v

    def append_block_uids(self, block: HostBlock):
        """Append rows; returns (new version id, uids of the landed
        blocks)."""
        with self._lock:
            self._check_domains(block)
            block = self._align_dictionaries(block)
            # failpoint: a write path that skips unique maintenance, the
            # corruption ADMIN CHECK TABLE must catch
            if not inject("storage/append-skip-unique", False):
                self._check_unique(block)
            landed = self.split_by_partition(block)
            self.modify_count += block.nrows
            v = self._publish(list(self._versions[self.version]) + landed)
            return v, [b.uid for b in landed]

    def _check_not_null(self, block: HostBlock) -> None:
        """NOT NULL enforcement on every block-install path (append,
        UPDATE rewrite, txn commit): MySQL strict mode."""
        for name in self.schema.not_null or ():
            c = block.columns.get(name)
            if c is not None and not bool(c.valid.all()):
                raise ValueError(f"Column {name!r} cannot be null")

    def _check_domains(self, block: HostBlock) -> None:
        """NOT NULL, then ENUM/SET membership and JSON validity of every
        dictionary entry the block's rows use (the JAX package's
        ``_check_domains``, with its error text). NULL always passes."""
        self._check_not_null(block)
        sch = self.schema
        if not (sch.enums or sch.sets or sch.json_cols):
            return

        def col_values(name):
            c = block.columns.get(name)
            if c is None or c.dictionary is None:
                return []
            used = np.unique(c.data[c.valid])
            return [str(c.dictionary[i]) for i in used.tolist() if i < len(c.dictionary)]

        for name, allowed in (sch.enums or {}).items():
            for v in col_values(name):
                if v not in allowed:
                    raise ValueError(f"invalid ENUM value {v!r} for column {name}")
        for name, allowed in (sch.sets or {}).items():
            for v in col_values(name):
                members = [m for m in v.split(",") if m]
                if set(members) - set(allowed) or len(members) != len(set(members)):
                    raise ValueError(f"invalid SET value {v!r} for column {name}")
        for name in sch.json_cols:
            for v in col_values(name):
                try:
                    json.loads(v)
                except Exception:
                    raise ValueError(
                        f"invalid JSON value for column {name}: {v[:60]!r}") from None

    def _check_unique(self, block: HostBlock) -> None:
        """Duplicate-key check of every UNIQUE index (in any schema
        state, write_only included) and the PRIMARY KEY, single- or
        multi-column, in the encoded domain (values that encode equal
        collide). A NULL in a UNIQUE key component exempts the row; a
        NULL in a PRIMARY KEY column is rejected. Caller holds the lock."""
        keys = [
            (f"unique index {i!r}", list(self.indexes[i]))
            for i in self.unique_indexes
            if self.indexes.get(i)
        ]
        pk = self.schema.primary_key
        if pk:
            keys.append(("primary key", list(pk)))
            for c in pk:
                hc = block.columns.get(c)
                if hc is not None and not hc.valid.all():
                    raise ValueError(f"column {c!r} cannot be null (primary key)")
        for label, cols in keys:
            if any(c not in block.columns for c in cols):
                continue
            if len(cols) == 1:
                self._check_unique_single(label, cols[0], block)
            else:
                self._check_unique_composite(label, cols, block)

    def _check_unique_single(self, label: str, col: str, block) -> None:
        c = block.columns[col]
        vals = c.data[c.valid]
        if len(vals) != len(np.unique(vals)):
            raise ValueError(f"duplicate entry for {label} ({col})")
        if len(vals):
            svals = self._sorted_values(col)
            if len(svals):
                pos = np.searchsorted(svals, vals)
                hit = (pos < len(svals)) & (svals[np.minimum(pos, len(svals) - 1)] == vals)
                if hit.any():
                    raise ValueError(f"duplicate entry for {label} ({col})")

    @staticmethod
    def _key_part(d: np.ndarray) -> np.ndarray:
        """One key component as int64: floats through their bit pattern
        (-0.0 folded to +0.0)."""
        if np.issubdtype(d.dtype, np.floating):
            d64 = d.astype(np.float64, copy=True)
            d64[d64 == 0.0] = 0.0
            return d64.view(np.int64)
        return d.astype(np.int64, copy=False)

    @staticmethod
    def _key_matrix_full(columns: dict, cols):
        """([n, k] int64 key matrix, [n] all-components-valid mask) over
        every row. Floats go through their bit pattern (-0.0 folded to
        +0.0); NULL components are zeroed."""
        n = len(next(iter(columns.values())).data)
        allv = np.ones(n, dtype=bool)
        parts = []
        for c in cols:
            allv &= columns[c].valid
            parts.append(Table._key_part(columns[c].data))
        mat = np.stack(parts, axis=1)
        mat = np.where(allv[:, None], mat, 0)
        return mat, allv

    @staticmethod
    def _key_matrix(columns: dict, cols) -> np.ndarray:
        """[m, k] key matrix over the rows whose key is fully valid."""
        mat, allv = Table._key_matrix_full(columns, cols)
        return mat[allv]

    @staticmethod
    def _rows_view(m: np.ndarray) -> np.ndarray:
        """One sortable scalar per row of a [n, k] key matrix."""
        return np.ascontiguousarray(m).view([("", m.dtype)] * m.shape[1]).ravel()

    @staticmethod
    def _key_columns(columns: dict, cols) -> np.ndarray:
        """[k, m] int64: a composite key's components over the rows whose
        key is fully valid, one contiguous row of the array each."""
        allv = np.logical_and.reduce([columns[c].valid for c in cols])
        return np.stack([Table._key_part(columns[c].data)[allv] for c in cols])

    @staticmethod
    def _sorted_rows(kc: np.ndarray) -> np.ndarray:
        """The row views of a composite key's [k, n] components
        (``_key_columns``), sorted. Where the components' ranges fit in 63
        bits together, the rows sort as one packed int64 each (offset from
        each component's minimum, so the signed order holds); otherwise
        ``np.lexsort`` orders them. Both give the views' order, in a
        fraction of a sort of the views."""
        if not kc.shape[1]:
            return Table._rows_view(kc.T)
        lo, hi = kc.min(axis=1), kc.max(axis=1)
        spans = [int(h) - int(l) + 1 for l, h in zip(lo.tolist(), hi.tolist())]
        if math.prod(spans) >= 1 << 63:
            return Table._rows_view(kc.T[np.lexsort(kc[::-1])])
        packed = kc[0] - lo[0]
        for j in range(1, len(spans)):
            packed *= spans[j]
            packed += kc[j] - lo[j]
        packed.sort()
        out = np.empty_like(kc)
        for j in range(len(spans) - 1, 0, -1):
            np.divmod(packed, spans[j], out=(packed, out[j]))
        out[0] = packed
        out += lo[:, None]
        return Table._rows_view(out.T)

    def _check_unique_composite(self, label: str, cols, block) -> None:
        new = self._key_matrix(block.columns, cols)
        if not len(new):
            return
        new_v = self._rows_view(new)
        if len(np.unique(new_v)) != len(new_v):
            raise ValueError(f"duplicate entry for {label} ({', '.join(cols)})")
        old_v = self._sorted_composite(tuple(cols))
        if len(old_v):
            pos = np.searchsorted(old_v, new_v)
            if ((pos < len(old_v)) & (old_v[np.minimum(pos, len(old_v) - 1)] == new_v)).any():
                raise ValueError(f"duplicate entry for {label} ({', '.join(cols)})")

    def _sorted_keys(self, kind: str, cols: tuple, keys_of, sort):
        """Sorted keys over the current version's blocks (``sort`` of the
        list of each block's ``keys_of(block)``), cached with the uids of
        the blocks they cover. Appends only add blocks, so a later
        version whose block list extends the cached one sorts only the
        new blocks' keys and inserts them at their places in the cached
        ones (one linear pass) instead of sorting the whole table again."""
        blocks = [b for b in self._versions[self.version] if all(c in b.columns for c in cols)]
        uids = tuple(b.uid for b in blocks)
        hit = self._key_cache.get((kind, cols))
        if hit is not None and hit[0] == uids:
            return hit[1]
        if hit is not None and hit[0] == uids[: len(hit[0])]:
            base, fresh = hit[1], blocks[len(hit[0]):]
        else:
            base, fresh = None, blocks
        parts = [k for b in fresh if len(k := keys_of(b))]
        if parts:
            add = sort(parts)
            out = add if base is None or not len(base) else np.insert(
                base, np.searchsorted(base, add, side="right"), add)
        else:
            out = base if base is not None else np.zeros(0, dtype=np.int64)
        if len(self._key_cache) > 8:
            self._key_cache.clear()
        self._key_cache[(kind, cols)] = (uids, out)
        return out

    def _sorted_values(self, col: str) -> np.ndarray:
        """Sorted valid values of one key column over the current
        version, kept incrementally (the uniqueness check's index)."""
        return self._sorted_keys(
            "values", (col,), lambda b: b.columns[col].data[b.columns[col].valid],
            lambda parts: np.sort(np.concatenate(parts)))

    def _sorted_composite(self, cols: tuple):
        """Sorted row views of a composite key over the current version
        (the uniqueness index of a composite key, kept incrementally)."""
        # each block's keys as an [m, k] view of its [k, m] components
        return self._sorted_keys(
            "rows", tuple(cols), lambda b: self._key_columns(b.columns, cols).T,
            lambda parts: self._sorted_rows(np.concatenate([p.T for p in parts], axis=1)))

    def next_autoid(self, n: int = 1) -> int:
        """Allocate n consecutive AUTO_INCREMENT ids; returns the first."""
        with self._lock:
            start = self.autoinc_next
            self.autoinc_next += n
            return start

    def observe_autoid(self, maxval: int) -> None:
        """Explicitly inserted ids move the allocator past them."""
        with self._lock:
            if maxval >= self.autoinc_next:
                self.autoinc_next = int(maxval) + 1

    def append_rows(self, rows: Sequence[Sequence]) -> int:
        cols = {}
        for i, (name, typ) in enumerate(self.schema.columns):
            cols[name] = column_from_values([r[i] for r in rows], typ)
        return self.append_block(HostBlock.from_columns(cols))

    def delete_where(self, keep_mask_per_block: List[np.ndarray]) -> int:
        """Replace the current version with masked blocks (DELETE).
        Blocks past the mask list are kept whole."""
        with self._lock:
            self.modify_count += sum(int((~k).sum()) for k in keep_mask_per_block)
            new_blocks = []
            for i, block in enumerate(self._versions[self.version]):
                keep = keep_mask_per_block[i] if i < len(keep_mask_per_block) else None
                if keep is None or keep.all():
                    new_blocks.append(block)
                    continue
                idx = np.flatnonzero(keep)
                if len(idx):
                    new_blocks.append(_take_block(block, idx))
            return self._publish(new_blocks)

    def purge_expired(self, col: str, cutoff: int) -> int:
        """TTL expiry: delete the rows whose `col` is below `cutoff` (raw
        encoded; NULLs survive). Snapshot, mask and swap happen under one
        lock hold, so a concurrent INSERT neither loses its block nor is
        masked by stale positions. A purged partitioned block keeps its
        ``part_id``. Returns the rows removed."""
        with self._lock:
            removed = 0
            new_blocks = []
            for block in self._versions[self.version]:
                c = block.columns.get(col)
                expired = None if c is None else c.valid & (c.data.astype(np.int64) < cutoff)
                n = 0 if expired is None else int(expired.sum())
                if not n:
                    new_blocks.append(block)
                    continue
                removed += n
                idx = np.flatnonzero(~expired)
                if len(idx):
                    new_blocks.append(_take_block(block, idx))
            if removed:
                self.modify_count += removed
                self._publish(new_blocks)
        return removed

    def install_commit(
        self,
        blocks: List[HostBlock],
        dictionaries: dict,
        autoinc_next: int,
        modified_rows: int,
    ) -> int:
        """Install a transaction's committed state (blocks, dictionaries
        and the AUTO_INCREMENT allocator) under one lock acquisition."""
        inject("storage/install-commit")
        for b in blocks:
            self._check_domains(b)
        with self._lock:
            self.modify_count += int(modified_rows)
            self.dictionaries = dict(dictionaries)
            self.autoinc_next = int(autoinc_next)
            return self._publish(list(blocks))

    def replace_blocks(self, blocks: List[HostBlock], modified_rows: Optional[int] = None) -> int:
        """Publish a new version holding exactly ``blocks``.
        `modified_rows`: the rows this replacement changed; None counts
        max(old, new)."""
        for b in blocks:
            self._check_domains(b)
        with self._lock:
            if modified_rows is None:
                old = sum(b.nrows for b in self._versions[self.version])
                modified_rows = max(old, sum(b.nrows for b in blocks))
            self.modify_count += int(modified_rows)
            return self._publish(list(blocks))

    def clear_rows(self) -> int:
        """Truncate (a new empty version); dictionaries are kept."""
        with self._lock:
            return self._publish([])

    # -- partition DDL -------------------------------------------------------
    def alter_add_partitions(self, new_parts) -> int:
        """Append RANGE partitions (encoded uppers, None = MAXVALUE) or
        LIST partitions (encoded value tuples): metadata only, under a
        new version."""
        with self._lock:
            if self.partition is None or self.partition[0] not in ("range", "list"):
                raise ValueError("ADD PARTITION requires a RANGE- or LIST-partitioned table")
            kind, pcol, parts = self.partition
            parts = list(parts)
            names = {n for n, _v in parts}
            if kind == "list":
                owned = {v for _n, vals in parts for v in vals}
                for n, vals in new_parts:
                    n = n.lower()
                    if not isinstance(vals, tuple):
                        raise ValueError("LIST partitions need VALUES IN (...)")
                    if n in names:
                        raise ValueError(f"duplicate partition name {n!r}")
                    clash = owned & set(vals)
                    if clash:
                        raise ValueError(
                            f"list value {sorted(clash, key=repr)[0]!r} "
                            "already belongs to another partition")
                    parts.append((n, tuple(vals)))
                    names.add(n)
                    owned |= set(vals)
            else:
                if parts and parts[-1][1] is None:
                    raise ValueError("cannot ADD PARTITION after a MAXVALUE partition")
                last = parts[-1][1] if parts else None
                for i, (n, u) in enumerate(new_parts):
                    n = n.lower()
                    if n in names:
                        raise ValueError(f"duplicate partition name {n!r}")
                    if u is None and i != len(new_parts) - 1:
                        raise ValueError("MAXVALUE must be the last partition")
                    if u is not None and last is not None and u <= last:
                        raise ValueError("VALUES LESS THAN must be strictly increasing")
                    parts.append((n, u))
                    names.add(n)
                    last = u if u is not None else last
            v = self._publish(list(self._versions[self.version]))
            self.partition = (kind, pcol, parts)
            return v

    def alter_drop_partitions(self, names: Sequence[str], truncate_only: bool = False) -> int:
        """DROP PARTITION (the defs go and later partitions' ids shift
        down) or TRUNCATE PARTITION (the rows go, the defs stay), under a
        new version. Returns the rows removed."""
        with self._lock:
            if self.partition is None or self.partition[0] not in ("range", "list"):
                raise ValueError(
                    "DROP/TRUNCATE PARTITION requires a RANGE- or LIST-partitioned table")
            kind, pcol, parts = self.partition
            all_names = [n for n, _u in parts]
            drop = set()
            for n in names:
                n = n.lower()
                if n not in all_names:
                    raise ValueError(f"unknown partition {n!r}")
                drop.add(all_names.index(n))
            if not truncate_only and len(drop) >= len(parts):
                raise ValueError("cannot drop all partitions")
            removed = 0
            new_blocks = []
            for b in self._versions[self.version]:
                if b.part_id in drop:
                    removed += b.nrows
                    continue
                if not truncate_only and b.part_id is not None:
                    shift = sum(1 for j in drop if j < b.part_id)
                    if shift:
                        b = dataclasses.replace(b, part_id=b.part_id - shift)
                new_blocks.append(b)
            self.modify_count += removed
            self._publish(new_blocks)
            if not truncate_only:
                self.partition = (kind, pcol, [p for i, p in enumerate(parts) if i not in drop])
            return removed

    # -- per-version column facts ----------------------------------------
    def col_bounds(self, col: str, version: Optional[int] = None):
        """(min, max) of a column's valid integer values at a version,
        or None (no valid rows / non-integer column). The plan compiler
        bakes these as packed-key widths; the kernels verify them."""
        v = self.version if version is None else version
        key = (v, col)
        if key in self._bounds_cache:
            return self._bounds_cache[key]
        lo = hi = None
        for b in self.blocks(v):
            c = b.columns.get(col)
            if c is None or not np.issubdtype(c.data.dtype, np.integer):
                lo = hi = None
                break
            vals = c.data[c.valid]
            if len(vals):
                blo, bhi = int(vals.min()), int(vals.max())
                lo = blo if lo is None else min(lo, blo)
                hi = bhi if hi is None else max(hi, bhi)
        out = None if lo is None else (lo, hi)
        if len(self._bounds_cache) > 64:
            self._bounds_cache.clear()
        self._bounds_cache[key] = out
        return out

    def col_has_nulls(self, col: str, version: Optional[int] = None) -> bool:
        """Whether the column holds any NULL at a version. The plan
        compiler folds the validity of NULL-free columns into the row
        mask; the executor re-checks this at every fetch."""
        v = self.version if version is None else version
        key = (v, col)
        if key not in self._nulls_cache:
            if len(self._nulls_cache) > 64:
                self._nulls_cache.clear()
            self._nulls_cache[key] = any(
                col not in b.columns or not bool(b.columns[col].valid.all())
                for b in self.blocks(v)
            )
        return self._nulls_cache[key]

    # -- point and range access --------------------------------------------
    def _sorted_index(self, col: str, version: Optional[int] = None):
        """(sorted values, argsort permutation, valid count) of a column
        over a version's concatenated blocks, NULLs after every value.
        Point and range reads search it instead of scanning the table.
        Cached per (blocks, column): a version that republishes the same
        blocks (a schema change's barrier) finds it built."""
        blocks = self.blocks(version)
        key = (tuple(b.uid for b in blocks), col)
        hit = self._idx_cache.get(key)
        if hit is not None:
            return hit
        t0 = time.perf_counter()
        if blocks:
            data = np.concatenate([b.columns[col].data for b in blocks])
            valid = np.concatenate([b.columns[col].valid for b in blocks])
        else:
            data = np.zeros(0, dtype=np.int64)
            valid = np.zeros(0, dtype=bool)
        if valid.all():
            perm = np.argsort(data, kind="stable")
        else:
            live = np.flatnonzero(valid)
            perm = np.concatenate([
                live[np.argsort(data[live], kind="stable")], np.flatnonzero(~valid)])
        out = (data[perm], perm, int(valid.sum()))
        INDEX_SORTS["sorts"] += 1
        INDEX_SORTS["rows"] += len(data)
        INDEX_SORTS["seconds"] += time.perf_counter() - t0
        if len(self._idx_cache) > 8:
            self._idx_cache.clear()
        self._idx_cache[key] = out
        return out

    def range_rows(self, col: str, lo, hi, version: Optional[int] = None) -> np.ndarray:
        """Row positions (in the blocks' concatenated order, ascending)
        whose `col` lies in [lo, hi], NULLs excluded."""
        perm, a, b = self._range_span(col, lo, hi, version)
        return np.sort(perm[a:b])

    def range_count(self, col: str, lo, hi, version: Optional[int] = None) -> int:
        """How many rows ``range_rows`` would return, without gathering
        their positions."""
        _perm, a, b = self._range_span(col, lo, hi, version)
        return max(int(b - a), 0)

    def _range_span(self, col: str, lo, hi, version: Optional[int]):
        """(argsort permutation, first, end) of [lo, hi] in the sorted
        index of `col`."""
        svals, perm, nvalid = self._sorted_index(col, version)
        live = svals[:nvalid]
        if np.issubdtype(live.dtype, np.integer):
            # bounds in the column's own dtype, clipped to its range: a
            # Python int against an int32 array makes numpy convert the
            # whole array (~40 ms at 15M rows) before it searches
            info = np.iinfo(live.dtype)
            if int(hi) < info.min or int(lo) > info.max:
                return perm, 0, 0
            lo = live.dtype.type(max(int(lo), int(info.min)))
            hi = live.dtype.type(min(int(hi), int(info.max)))
        a = np.searchsorted(live, lo, side="left")
        b = np.searchsorted(live, hi, side="right")
        return perm, a, max(a, b)

    def gather_rows(self, idx: np.ndarray, columns, version: Optional[int] = None) -> HostBlock:
        """The rows at ascending positions `idx` (concatenated order) of
        `columns` as one block, gathered block by block."""
        blocks = self.blocks(version)
        starts = np.cumsum([0] + [b.nrows for b in blocks])
        cut = np.searchsorted(idx, starts)
        cols = {}
        for name in columns:
            if not blocks:
                t = self.schema.types[name]
                cols[name] = HostColumn(t, np.zeros(0, dtype=t.np_dtype),
                                        np.zeros(0, dtype=bool), self.dictionaries.get(name))
                continue
            first = blocks[0].columns[name]
            parts = [(b.columns[name], idx[cut[i]: cut[i + 1]] - starts[i])
                     for i, b in enumerate(blocks) if cut[i + 1] > cut[i]]
            data = np.concatenate([c.data[j] for c, j in parts] or [first.data[:0]])
            valid = np.concatenate([c.valid[j] for c, j in parts] or [first.valid[:0]])
            cols[name] = HostColumn(first.type, data, valid, first.dictionary)
        return HostBlock(cols, len(idx))

    # -- schema changes (ALTER TABLE) ----------------------------------------
    def alter_add_column(self, name: str, typ: SQLType, default=None) -> int:
        """A new last column holding `default` in every stored row."""
        name = name.lower()
        with self._lock:
            if name in self.schema.names:
                raise ValueError(f"column {name!r} exists")
            new_schema = dataclasses.replace(self.schema, columns=self.schema.columns + [(name, typ)])
            new_blocks = []
            for b in self._versions[self.version]:
                cols = dict(b.columns)
                cols[name] = column_from_values([default] * b.nrows, typ)
                new_blocks.append(HostBlock(cols, b.nrows, part_id=b.part_id))
            self.schema = new_schema
            if typ.kind == Kind.STRING:
                d = new_blocks[0].columns[name].dictionary if new_blocks else None
                self.dictionaries[name] = d if d is not None else np.array([], dtype=object)
            return self._publish(new_blocks)

    def alter_drop_column(self, name: str) -> int:
        """Drop a column from the schema. The blocks keep it physically
        (scans never read it) until a rewrite drops it."""
        name = name.lower()
        with self._lock:
            if name not in self.schema.names:
                raise ValueError(f"unknown column {name!r}")
            pk = self.schema.primary_key
            if pk and name in pk:
                raise ValueError("cannot drop a primary key column")
            sch = self.schema
            self.schema = dataclasses.replace(
                sch,
                columns=[(n, t) for n, t in sch.columns if n != name],
                enums={k: v for k, v in (sch.enums or {}).items() if k != name} or None,
                sets={k: v for k, v in (sch.sets or {}).items() if k != name} or None,
                json_cols=tuple(c for c in sch.json_cols if c != name),
            )
            self.dictionaries.pop(name, None)
            return self._publish(list(self._versions[self.version]))

    def alter_modify_column(self, name: str, new_type: SQLType, convert, rename_to=None,
                            validate=None) -> int:
        """Change a column's type (and name): every block of the current
        version converts through `convert(HostColumn, table dictionary)`
        outside the lock, results cached by block uid; if a write
        published a newer version meanwhile, its new blocks convert and
        the swap retries. `validate(new_blocks)` runs before the publish
        (a raise leaves no visible state); schema and data then change
        in one version."""
        name = name.lower()
        new_name = (rename_to or name).lower()
        converted: Dict[int, HostColumn] = {}
        while True:
            with self._lock:
                v = self.version
                blocks = list(self._versions[v])
                src_dict = self.dictionaries.get(name)
            for b in blocks:
                if b.uid not in converted:
                    converted[b.uid] = convert(b.columns[name], src_dict)
            with self._lock:
                if self.version != v:
                    continue
                if new_type.kind == Kind.STRING:
                    # one table-wide dictionary: merge every block's
                    allv: set = set()
                    for b in blocks:
                        d = converted[b.uid].dictionary
                        if d is not None:
                            allv.update(d.tolist())
                    merged = np.array(sorted(allv), dtype=object)
                    lookup = {s: i for i, s in enumerate(merged.tolist())}
                    for b in blocks:
                        c = converted[b.uid]
                        if c.dictionary is None or not len(c.dictionary):
                            converted[b.uid] = HostColumn(c.type, c.data, c.valid, merged)
                            continue
                        remap = np.array([lookup[s] for s in c.dictionary.tolist()],
                                         dtype=np.int64)
                        codes = np.clip(c.data, 0, len(c.dictionary) - 1)
                        converted[b.uid] = HostColumn(c.type, remap[codes], c.valid, merged)
                new_blocks = [
                    HostBlock({(new_name if n == name else n): (converted[b.uid] if n == name else c)
                               for n, c in b.columns.items()}, b.nrows, part_id=b.part_id)
                    for b in blocks
                ]
                if validate is not None:
                    validate(new_blocks)
                self.schema = dataclasses.replace(
                    self.schema,
                    columns=[(new_name, new_type) if n == name else (n, t)
                             for n, t in self.schema.columns],
                    primary_key=([new_name if c == name else c for c in self.schema.primary_key]
                                 if self.schema.primary_key else None),
                    not_null=tuple(new_name if c == name else c for c in self.schema.not_null),
                )
                self.dictionaries.pop(name, None)
                if new_type.kind == Kind.STRING:
                    self.dictionaries[new_name] = (
                        new_blocks[0].columns[new_name].dictionary
                        if new_blocks else np.array([], dtype=object))
                for iname, icols in list(self.indexes.items()):
                    self.indexes[iname] = [new_name if c == name else c for c in icols]
                if self.autoinc_col == name:
                    self.autoinc_col = new_name
                return self._publish(new_blocks)

    def alter_rename_column(self, old: str, new: str) -> int:
        """Rename a column: schema, blocks' column maps, dictionary,
        index column lists, PRIMARY KEY and default, in one version and
        without moving data."""
        old, new = old.lower(), new.lower()
        with self._lock:
            names = self.schema.names
            if old not in names:
                raise ValueError(f"unknown column {old!r}")
            if new in names:
                raise ValueError(f"column {new!r} exists")

            def ren(n):
                return new if n == old else n

            sch = self.schema
            self.schema = dataclasses.replace(
                sch,
                columns=[(ren(n), t) for n, t in sch.columns],
                primary_key=[ren(c) for c in sch.primary_key] if sch.primary_key else None,
                enums={ren(k): v for k, v in sch.enums.items()} if sch.enums else None,
                sets={ren(k): v for k, v in sch.sets.items()} if sch.sets else None,
                json_cols=tuple(ren(c) for c in sch.json_cols),
                not_null=tuple(ren(c) for c in sch.not_null),
            )
            if old in self.dictionaries:
                self.dictionaries[new] = self.dictionaries.pop(old)
            for iname, icols in list(self.indexes.items()):
                self.indexes[iname] = [ren(c) for c in icols]
            if old in self.defaults:
                self.defaults[new] = self.defaults.pop(old)
            if self.autoinc_col == old:
                self.autoinc_col = new
            new_blocks = [HostBlock({ren(n): c for n, c in b.columns.items()}, b.nrows,
                                    part_id=b.part_id)
                          for b in self._versions[self.version]]
            return self._publish(new_blocks)

    # -- dictionary maintenance ------------------------------------------
    def _align_dictionaries(self, block: HostBlock) -> HostBlock:
        """Merge the block's dictionaries into the table's, remapping the
        codes of the new block and, when the table's dictionary grows
        inside its range, of the current version's blocks (copy on
        write). Caller holds the lock."""
        out_cols = dict(block.columns)
        for name, t in self.schema.columns:
            if t.kind != Kind.STRING:
                continue
            col = block.columns[name]
            merged, old_remap, new_remap = _merge_dictionaries(
                self.dictionaries.get(name), col.dictionary
            )
            if (
                old_remap is not None
                and len(self.dictionaries[name])
                and not np.array_equal(old_remap, np.arange(len(old_remap), dtype=np.int32))
            ):
                remapped = []
                for b in self._versions[self.version]:
                    c = b.columns[name]
                    cols = dict(b.columns)
                    cols[name] = HostColumn(c.type, old_remap[c.data], c.valid, merged)
                    remapped.append(HostBlock(cols, b.nrows, part_id=b.part_id))
                self._versions[self.version] = remapped
            else:
                for b in self._versions[self.version]:
                    c = b.columns[name]
                    b.columns[name] = HostColumn(c.type, c.data, c.valid, merged)
            data = new_remap[col.data] if new_remap is not None else col.data
            out_cols[name] = HostColumn(col.type, data.astype(np.int32), col.valid, merged)
            self.dictionaries[name] = merged
        return HostBlock(out_cols, block.nrows, part_id=block.part_id)
