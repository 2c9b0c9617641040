"""ADMIN CHECK TABLE / CHECK INDEX / CHECKSUM TABLE / SHOW DDL JOBS and
MySQL's CHECK TABLE.

Counterpart of the JAX session's ``_run_admin``, ``_admin_check_key``,
``_admin_checksum`` and ``_admin_check_table`` (reference:
pkg/executor/admin.go:46, CheckTableExec and CheckIndexRangeExec). A
mixin of ``Session``: every method runs in a session's context.

ADMIN CHECK recomputes what the write path guards from the raw blocks of
the version the session reads: PRIMARY KEY and UNIQUE key sets (no NULL
in a primary key, no duplicate), the FOREIGN KEY closure, the partition
tags and the dictionary code ranges; and it validates the port's own
cached bookkeeping against the recompute (the range index
``Table._idx_cache`` and the uniqueness index ``Table._key_cache``). A
problem raises with the JAX package's text; a clean table returns no
row. The verdicts are the JAX package's, the algorithms are not:
- A key set's duplicates are found by one sort on the session's device:
  the key columns are packed into one int64 where their ranges fit, else
  sorted lexicographically (``sort.lex_permutation``). The JAX package
  sorts a structured row view on the host, minutes at TPC-H SF10.
- The FOREIGN KEY closure probes the parent's key set (``KeySet``, the
  write path's structure) instead of decoding each child block into a
  Python set; numeric keys are probed on the device by a binary search.

ADMIN CHECKSUM TABLE is the JAX package's checksum bit for bit: per row a
splitmix64 mix of every column's logical value (a string's crc32 through
its dictionary), folded by XOR over rows, on the host in numpy; the
dictionaries' crc32s are computed on the device (``crc32_strings``).
"""

from __future__ import annotations

import numpy as np
import torch

from tidb_tpu_torch.chunk import to_device
from tidb_tpu_torch.dtypes import Kind
from tidb_tpu_torch.executor.sort import lex_permutation
from tidb_tpu_torch.parser import ast
from tidb_tpu_torch.session.constraints import domain_values, fk_domain, member_mask


def _mix(x):
    """splitmix64's finalizer over uint64 arrays (wrapping)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _crc_table() -> np.ndarray:
    """The byte table of CRC-32 (zlib's: reflected, polynomial 0xEDB88320)."""
    t = np.arange(256, dtype=np.int64)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ 0xEDB88320, t >> 1)
    return t


_CRC_TABLE = _crc_table()


def crc32_strings(values, device) -> np.ndarray:
    """``zlib.crc32(str(v).encode())`` of every value, as uint64: the bytes
    go to `device` once and each byte position is one table step over the
    strings that long (longest first, so those are a prefix)."""
    strs = list(map(str, np.asarray(values, dtype=object).tolist()))
    joined = "".join(strs)
    if joined.isascii():  # one encode, and a string's length is its bytes'
        buf = joined.encode("ascii")
    else:
        strs = [v.encode() for v in strs]
        buf = b"".join(strs)
    lens = np.fromiter(map(len, strs), dtype=np.int64, count=len(strs))
    if not len(strs) or not lens.max(initial=0):
        return np.zeros(len(strs), dtype=np.uint64)
    order = np.argsort(-lens, kind="stable")
    offs = (np.cumsum(lens) - lens)[order]
    # strings longer than j, for each byte position j
    active = len(lens) - np.searchsorted(np.sort(lens), np.arange(int(lens.max())), side="right")
    flat = to_device(np.frombuffer(bytearray(buf), dtype=np.uint8), device).to(torch.int64)
    table = to_device(_CRC_TABLE, device)
    offs = to_device(offs, device)
    crc = torch.full((len(strs),), 0xFFFFFFFF, dtype=torch.int64, device=device)
    for j, m in enumerate(active.tolist()):
        c = crc[:m]
        crc[:m] = table[(c ^ flat[offs[:m] + j]) & 0xFF] ^ (c >> 8)
    out = np.empty(len(strs), dtype=np.uint64)
    out[order] = (crc ^ 0xFFFFFFFF).cpu().numpy().astype(np.uint64)
    return out


def _key_operand(data: torch.Tensor) -> torch.Tensor:
    """A key column as int64 in the uniqueness index's encoding: a
    float's bit pattern with -0.0 folded into +0.0."""
    if data.is_floating_point():
        d = data.to(torch.float64)
        return torch.where(d == 0, torch.zeros_like(d), d).view(torch.int64)
    return data.to(torch.int64)


def _same(host: np.ndarray, dev: torch.Tensor) -> bool:
    """A host array equal, element for element, to a device tensor (the
    comparison runs on the device)."""
    return len(host) == len(dev) and bool(torch.equal(
        to_device(np.ascontiguousarray(host), dev.device).to(dev.dtype), dev))


def _sorted_key_rows(parts):
    """The key rows (one int64 tensor a column) sorted lexicographically:
    one sort of a packed int64 where the columns' ranges fit 63 bits."""
    if len(parts) == 1:
        return [torch.sort(parts[0]).values]
    lows = [int(p.min()) for p in parts]
    spans = [int(p.max()) - lo for p, lo in zip(parts, lows)]
    bits = [max(s, 1).bit_length() for s in spans]
    if sum(bits) <= 63:
        packed = torch.zeros_like(parts[0])
        for p, lo, b in zip(parts, lows, bits):
            packed = (packed << b) | (p - lo)
        packed = torch.sort(packed).values
        out = []
        for lo, b in reversed(list(zip(lows, bits))):
            out.append((packed & ((1 << b) - 1)) + lo)
            packed = packed >> b
        return out[::-1]
    perm = lex_permutation(parts)
    return [p[perm] for p in parts]


class AdminMixin:
    def _run_admin(self, s):
        from tidb_tpu_torch.session.session import Result

        if s.op == "show_ddl":
            # DDL runs synchronously in the process: the job queue is
            # always empty; the schema version is reported
            return Result(["SCHEMA_VER", "RUNNING_JOBS", "SELF_ID"],
                          [(self.catalog.schema_version, "", "tidb-tpu-0")])
        if s.op == "checksum_table":
            return self._admin_checksum(s)
        if s.op == "check_table_status":
            # MySQL CHECK TABLE: status rows instead of ADMIN CHECK's raise
            rows = []
            for db0, name in s.tables:
                db = (db0 or self.db).lower()
                full = f"{db}.{name.lower()}"
                if not self.catalog.has_table(db, name):
                    rows.append((full, "check", "Error", f"Table '{full}' doesn't exist"))
                    continue
                try:
                    self._run_admin(ast.AdminStmt("check_table", [(db, name)]))
                    rows.append((full, "check", "status", "OK"))
                except Exception as e:
                    rows.append((full, "check", "error", str(e)[:200]))
                    rows.append((full, "check", "error", "Corrupt"))
            return Result(["Table", "Op", "Msg_type", "Msg_text"], rows)
        problems: list = []
        for db0, name in s.tables:
            db = (db0 or self.db).lower()
            # the session's read snapshot: the FK closure compares child
            # and parent at one consistent point
            t, ver = self._resolve_table_for_read(db, name)
            if s.op == "check_index":
                iname = s.index.lower()
                if iname == "primary":
                    cols = list(t.schema.primary_key or [])
                    if not cols:
                        raise ValueError(f"table {name} has no PRIMARY KEY")
                elif iname in t.indexes:
                    if t.index_state(iname) != "public":
                        raise ValueError(f"index {s.index} is not public yet")
                    cols = t.indexes[iname]
                else:
                    raise ValueError(f"index {s.index} does not exist")
                unique = iname == "primary" or iname in t.unique_indexes
                problems += self._admin_check_key(t, f"{db}.{name}", iname, cols, unique, ver)
            else:
                problems += self._admin_check_table(t, db, name, ver)
        if problems:
            raise ValueError("admin check failed: " + "; ".join(problems[:5]))
        return Result([], [])

    def _admin_check_key(self, t, qname, iname, cols, unique, ver) -> list:
        """One key set: NULL and duplicate detection recomputed from the
        raw blocks on the device, and the cached indexes over the same
        blocks checked against it."""
        problems = []
        dev = self.device
        blocks = [b for b in t.blocks(ver) if all(c in b.columns for c in cols)]
        if iname == "primary":
            for b in blocks:
                for c in cols:
                    if not bool(b.columns[c].valid.all()):
                        problems.append(f"{qname}: NULL in PRIMARY KEY column {c}")
                        break
        host = {c: (np.concatenate([b.columns[c].data for b in blocks]),
                    np.concatenate([b.columns[c].valid for b in blocks])) for c in cols} \
            if blocks else {}
        rows = None
        if blocks and sum(b.nrows for b in blocks):
            parts, allv = [], None
            for c in cols:
                data, valid = host[c]
                v = to_device(valid, dev)
                parts.append(_key_operand(to_device(data, dev)))
                allv = v if allv is None else allv & v
            if not bool(allv.all()):
                parts = [p[allv] for p in parts]
            if len(parts[0]):
                rows = _sorted_key_rows(parts)
        if unique and rows is not None and len(rows[0]) > 1:
            same = torch.ones(len(rows[0]) - 1, dtype=torch.bool, device=dev)
            for r in rows:
                same &= r[1:] == r[:-1]
            if bool(same.any()):
                problems.append(f"{qname}: duplicate entries under {iname} ({', '.join(cols)})")
        uids = tuple(b.uid for b in blocks)
        if len(cols) == 1:
            c = cols[0]
            ent = t._idx_cache.get((tuple(b.uid for b in t.blocks(ver)), c))
            hit = t._key_cache.get(("values", (c,)))
            if (ent is not None or (hit is not None and hit[0] == uids)) and blocks:
                data, valid = host[c]
                by_value = torch.sort(to_device(data, dev)[to_device(valid, dev)]).values
                if ent is not None and not self._idx_entry_agrees(ent, data, valid, by_value):
                    problems.append(f"{qname}: cached index {iname} disagrees with block data")
                elif hit is not None and hit[0] == uids and not _same(hit[1], by_value):
                    problems.append(f"{qname}: cached index {iname} disagrees with block data")
        else:
            hit = t._key_cache.get(("rows", tuple(cols)))
            if hit is not None and hit[0] == uids:
                cached = hit[1]
                if rows is None:
                    bad = len(cached) > 0
                else:
                    mat = np.ascontiguousarray(cached).view(np.int64).reshape(-1, len(cols))
                    bad = len(mat) != len(rows[0]) or not all(
                        _same(mat[:, j], r) for j, r in enumerate(rows))
                if bad:
                    problems.append(
                        f"{qname}: cached composite view {iname} disagrees with block data")
        return problems

    @staticmethod
    def _idx_entry_agrees(ent, data, valid, by_value) -> bool:
        """A range-index entry (sorted values, permutation, valid count)
        against the column: the valid values in value order, then the
        NULL rows in row order, and the permutation gathering them."""
        svals, perm, nvalid = ent
        return (int(valid.sum()) == nvalid and len(svals) == len(data) == len(perm)
                and _same(svals[:nvalid], by_value)
                and np.array_equal(perm[nvalid:], np.flatnonzero(~valid))
                and np.array_equal(data[perm], svals))

    def _admin_checksum(self, s):
        """ADMIN CHECKSUM TABLE t[, ...]: an order-independent 64-bit
        checksum per table over logical values (a string hashes through
        its dictionary's bytes, so the sum survives dictionary remaps)."""
        from tidb_tpu_torch.session.session import Result

        rows = []
        for db0, name in s.tables:
            db = (db0 or self.db).lower()
            t, ver = self._resolve_table_for_read(db, name)
            total = np.uint64(0)
            nrows = nbytes = 0
            crcs: dict = {}  # id(dictionary) -> crc32 of each entry
            with np.errstate(over="ignore", invalid="ignore"):
                for b in t.blocks(ver):
                    if b.nrows == 0:
                        continue
                    acc = np.zeros(b.nrows, dtype=np.uint64)
                    for ci, cname in enumerate(t.schema.names):
                        c = b.columns.get(cname)
                        if c is None:
                            continue
                        nbytes += c.data.nbytes
                        if c.dictionary is not None:
                            dh = crcs.get(id(c.dictionary))
                            if dh is None:
                                dh = crcs[id(c.dictionary)] = crc32_strings(
                                    c.dictionary, self.device,
                                ) if len(c.dictionary) else np.zeros(1, dtype=np.uint64)
                            codes = np.clip(c.data.astype(np.int64), 0,
                                            max(len(c.dictionary) - 1, 0))
                            vals = dh[codes]
                        elif c.data.dtype.itemsize == 8:
                            # 8-byte ints and floats by their bits
                            vals = c.data.view(np.uint64)
                        else:
                            vals = c.data.astype(np.int64).astype(np.uint64)
                        h = _mix(vals + np.uint64((ci + 1) * 0x9E3779B9))
                        # NULL contributes a fixed marker, not the data
                        h = np.where(c.valid, h, np.uint64(0xDEADBEEF) + np.uint64(ci))
                        acc = _mix(acc ^ h)
                    total ^= np.bitwise_xor.reduce(acc)
                    nrows += b.nrows
            rows.append((db, name.lower(), int(total), nrows, nbytes))
        return Result(["Db_name", "Table_name", "Checksum_crc64_xor", "Total_kvs", "Total_bytes"],
                      rows)

    def _admin_check_table(self, t, db, name, ver) -> list:
        problems = []
        qname = f"{db}.{name}"
        pk = t.schema.primary_key
        if pk:
            problems += self._admin_check_key(t, qname, "primary", list(pk), True, ver)
        for iname, cols in t.indexes.items():
            if t.index_state(iname) != "public":
                continue
            problems += self._admin_check_key(t, qname, iname, cols, iname in t.unique_indexes,
                                              ver)
        # dictionary code ranges
        types = t.schema.types
        for b in t.blocks(ver):
            for cn, c in b.columns.items():
                typ = types.get(cn)
                if typ is None or typ.kind != Kind.STRING:
                    continue
                d = t.dictionaries.get(cn)
                nd = len(d) if d is not None else 0
                codes = c.data if c.valid.all() else c.data[c.valid]
                if len(codes) and (int(codes.min()) < 0 or int(codes.max()) >= nd):
                    problems.append(f"{qname}: string codes out of dictionary range in column {cn}")
        # FOREIGN KEY closure: every non-NULL child value has a parent
        for nm, col, rdb, rtbl, rcol in t.fks:
            try:
                keys = self._column_keyset(rdb, rtbl, rcol)
                ptype = self._parent_type(rdb, rtbl, rcol)
            except Exception:
                problems.append(f"{qname}: FK {nm} parent {rdb}.{rtbl} missing")
                continue
            domain = fk_domain(t.schema.types[col], ptype)
            keys = keys.to_domain(ptype, domain)
            blocks = [b for b in t.blocks(ver) if b.columns.get(col) is not None]
            if keys.base.dtype.kind in "iuf" and blocks:
                # numeric keys: the child column against the parent's
                # sorted distinct values, in one search on the device
                members = torch.unique(to_device(keys.base, self.device)) \
                    if not (len(keys.minus) or len(keys.plus)) \
                    else to_device(keys.values(), self.device)
                cs = [b.columns[col] for b in blocks]
                vals = to_device(np.concatenate([domain_values(c, domain) for c in cs]),
                                 self.device)
                valid = to_device(np.concatenate([c.valid for c in cs]), self.device)
                if len(members):
                    pos = torch.searchsorted(members, vals).clamp_(max=len(members) - 1)
                    valid &= members[pos] != vals
                orphan = bool(valid.any())
            else:
                orphan = any(bool((b.columns[col].valid
                                   & ~member_mask(b.columns[col], keys, domain)).any())
                             for b in blocks)
            if orphan:
                problems.append(f"{qname}: FK {nm} value without parent in {rdb}.{rtbl}.{rcol}")
        # partition tagging: every row sits in the block its tag claims;
        # an untagged block (an UPDATE's rewrite) is legitimate
        if t.partition is not None:
            pcol = t.partition[1]
            for b in t.blocks(ver):
                c = b.columns.get(pcol)
                if c is None:
                    continue
                vals = c.data[c.valid]
                if not len(vals):
                    continue
                try:
                    pids = t.partition_of(vals)
                except ValueError:
                    problems.append(f"{qname}: row outside every partition range")
                    continue
                if b.part_id is not None and bool((pids != b.part_id).any()):
                    problems.append(f"{qname}: rows tagged partition {b.part_id} belong elsewhere")
        return problems
