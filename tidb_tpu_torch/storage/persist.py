"""Catalog persistence: snapshot the store to disk and reload on start.

Counterpart of tidb_tpu/storage/persist.py, in its format letter for
letter (``manifest.json``'s keys, one ``<db>.<table>.npz`` per table
written by ``np.savez_compressed``, the members ``<col>.data``,
``.valid``, ``.dictbuf`` and ``.dictoff``, no pickle on either side), so
that each package restores the other's backup. The port keeps only the
table's current version, as the JAX package does; a restore publishes a
new version of every table it touches (its blocks routed through
``split_by_partition``), so no cache keyed by version serves the old
rows, and the caller drops the old versions' device columns.

Reference: nothing survives restart in round 1; the reference persists
everything through TiKV/badger (pkg/store/mockstore/unistore over
badger) and backs up via BR (br/pkg/task/backup.go). The store is
columnar host RAM, so persistence is a columnar snapshot: one .npz per
table (data + validity per column, dictionaries as UTF-8 bytes and
offsets) plus a JSON manifest of schemas — the moral analog of a BR
full backup of the current snapshot version (historical MVCC versions
are not persisted, matching BR's snapshot semantics).
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np

from tidb_tpu_torch.chunk import HostBlock, HostColumn
from tidb_tpu_torch.dtypes import Kind, SQLType
from tidb_tpu_torch.storage.catalog import Catalog
from tidb_tpu_torch.storage.table import TableSchema

_MANIFEST = "manifest.json"


def _type_to_json(t: SQLType) -> Dict:
    return {"kind": t.kind.value, "scale": t.scale}


def _type_from_json(d: Dict) -> SQLType:
    return SQLType(Kind(d["kind"]), scale=d.get("scale", 0))


def encode_dict_arrays(dictionary, prefix: str, arrays: Dict) -> None:
    """Store a string dictionary as UTF-8 bytes + offsets under
    `{prefix}.dictbuf` / `{prefix}.dictoff` — NOT an object array: object
    arrays pickle inside the npz, and unpickling a crafted snapshot
    executes arbitrary code; the reference BR format (protobuf + SST)
    never deserializes executable payloads either. (Offsets rather than
    fixed-width unicode: numpy 'U' arrays silently strip trailing NULs,
    corrupting values.) The bytes are the JAX package's; an all-ASCII
    dictionary (TPC-H's) is encoded in one pass over its joined text, the
    per-value loop costing ~1.4 us a value (2.1 s for SF10's customer)."""
    text = "".join(dictionary)
    buf = text.encode("utf-8")
    if len(buf) == len(text):  # ASCII: a value's bytes are its characters
        lengths = np.fromiter(map(len, dictionary), dtype=np.int64, count=len(dictionary))
    else:
        lengths = np.array([len(x.encode("utf-8")) for x in dictionary], dtype=np.int64)
    arrays[f"{prefix}.dictbuf"] = np.frombuffer(buf or b"\x00", dtype=np.uint8)
    arrays[f"{prefix}.dictoff"] = np.concatenate(
        [np.zeros(1, dtype=np.int64), np.cumsum(lengths, dtype=np.int64)])


def decode_dict_arrays(data, prefix: str):
    """Inverse of encode_dict_arrays; None when the prefix has no
    dictionary. An ASCII buffer is decoded once and sliced."""
    if f"{prefix}.dictbuf" not in data:
        return None
    buf = data[f"{prefix}.dictbuf"].tobytes()
    off = data[f"{prefix}.dictoff"].tolist()
    if buf.isascii():
        text = buf.decode("ascii")
        vals = [text[a:b] for a, b in zip(off[:-1], off[1:])]
    else:
        vals = [buf[a:b].decode("utf-8") for a, b in zip(off[:-1], off[1:])]
    out = np.empty(len(vals), dtype=object)
    out[:] = vals
    return out


def concat_blocks(blocks, columns, schema) -> HostBlock:
    """The blocks as one (the JAX package's ``scan.concat_blocks``): each
    column's dictionary is the first block's, which is the table's (an
    append re-maps the current version's blocks onto the merged one); no
    blocks: empty columns, a string column with an empty dictionary."""
    types = schema.types
    cols = {}
    for name in columns:
        typ = types[name]
        if not blocks:
            cols[name] = HostColumn(
                typ, np.zeros(0, dtype=typ.np_dtype), np.zeros(0, dtype=bool),
                np.array([], dtype=object) if typ.kind == Kind.STRING else None)
            continue
        first = blocks[0].columns[name]
        cols[name] = HostColumn(
            first.type,
            np.concatenate([b.columns[name].data for b in blocks]),
            np.concatenate([b.columns[name].valid for b in blocks]),
            first.dictionary,
        )
    return HostBlock(cols, sum(b.nrows for b in blocks))


def table_meta_to_json(t) -> Dict:
    """Full table metadata as a JSON-safe dict: columns/PK plus the
    state a restore must reconstruct (indexes, AUTO_INCREMENT, TTL,
    partitioning, CHECKs, FKs, domains), under the JAX package's keys so
    that a manifest written by either package reads in the other."""
    return {
        "columns": [[n, _type_to_json(ty)] for n, ty in t.schema.columns],
        "primary_key": t.schema.primary_key,
        "indexes": t.indexes,
        "unique_indexes": sorted(t.unique_indexes),
        "invisible_indexes": sorted(
            getattr(t, "invisible_indexes", ()) or ()
        ),
        "autoinc": [t.autoinc_col, t.autoinc_next],
        "ttl": list(t.ttl) if t.ttl else None,
        "partition": (
            [t.partition[0], t.partition[1],
             t.partition[2] if t.partition[0] == "hash"
             else [list(x) for x in t.partition[2]]]
            if getattr(t, "partition", None) else None
        ),
        "checks": [list(c) for c in t.checks] or None,
        "fks": [list(f) for f in t.fks] or None,
        "fk_actions": dict(getattr(t, "fk_actions", {})) or None,
        "fk_update_actions": dict(
            getattr(t, "fk_update_actions", {})
        ) or None,
        "enums": {k: list(v) for k, v in (t.schema.enums or {}).items()} or None,
        "not_null": list(t.schema.not_null or ()) or None,
        "sets": {k: list(v) for k, v in (t.schema.sets or {}).items()} or None,
        "json_cols": list(t.schema.json_cols),
        "defaults": dict(getattr(t, "defaults", None) or {}) or None,
        "generated": [
            list(g) for g in (getattr(t, "generated", None) or [])
        ] or None,
    }


def schema_from_meta(meta: Dict) -> TableSchema:
    return TableSchema(
        [(n, _type_from_json(tj)) for n, tj in meta["columns"]],
        primary_key=meta.get("primary_key"),
        not_null=tuple(meta.get("not_null") or ()),
        enums={
            k: tuple(v) for k, v in (meta.get("enums") or {}).items()
        } or None,
        sets={
            k: tuple(v) for k, v in (meta.get("sets") or {}).items()
        } or None,
        json_cols=tuple(meta.get("json_cols") or ()),
    )


def apply_table_meta(t, meta: Dict) -> None:
    """Reapply the non-schema table state from table_meta_to_json. The
    backup's state wins wholesale: state ABSENT from the meta is
    cleared, not kept — a live TTL surviving a restore from a TTL-less
    backup would silently delete restored rows."""
    t.indexes = {
        k: list(v) for k, v in (meta.get("indexes") or {}).items()
    }
    t.unique_indexes = set(meta.get("unique_indexes") or [])
    t.invisible_indexes = set(meta.get("invisible_indexes") or [])
    ai = meta.get("autoinc")
    if ai:
        t.autoinc_col, t.autoinc_next = ai[0], int(ai[1])
    t.ttl = tuple(meta["ttl"]) if meta.get("ttl") else None
    if meta.get("partition"):
        pk_, pc_, spec_ = meta["partition"]
        t.partition = (
            pk_, pc_,
            int(spec_) if pk_ == "hash"
            else [
                (x[0], tuple(x[1])) if pk_ == "list" else tuple(x)
                for x in spec_
            ],
        )
    else:
        t.partition = None
    t.checks = [tuple(c) for c in (meta.get("checks") or [])]
    t.fks = [tuple(f) for f in (meta.get("fks") or [])]
    t.fk_actions = dict(meta.get("fk_actions") or {})
    t.fk_update_actions = dict(meta.get("fk_update_actions") or {})
    t.defaults = dict(meta.get("defaults") or {})
    t.generated = [
        (g[0], g[1], bool(g[2])) for g in (meta.get("generated") or [])
    ]
    t._gen_exprs = None
    # every index the backup names is public in it
    t.index_states = {}


def schemas_equivalent(a, b) -> bool:
    """Whether two TableSchemas describe the same physical shape AND
    constraint identity (columns, PK, domains) — the restore-in-place
    guard: anything short of full equivalence drops + recreates, since
    installing backup-shaped blocks under a diverged live schema
    corrupts reads (and a diverged PK can make restored rows violate
    constraints the backup's engine never enforced)."""

    def norm(s):
        return (
            [(n, ty.kind, ty.scale) for n, ty in s.columns],
            tuple(s.primary_key or ()),
            {k: tuple(v) for k, v in (s.enums or {}).items()},
            {k: tuple(v) for k, v in (s.sets or {}).items()},
            tuple(s.json_cols or ()),
        )

    return norm(a) == norm(b)


def capture_catalog(catalog: Catalog, dbs=None) -> Dict:
    """What a snapshot of `catalog` (optionally only `dbs`) writes,
    taken in one step: the users, views and sequences, and each table's
    metadata, current version and block list. Blocks are immutable, so
    ``write_snapshot`` may concatenate, encode and deflate them while
    other statements run (BACKUP lets the statement lock go for that)."""
    users = getattr(catalog, "users", None)
    want = {d.lower() for d in dbs} if dbs else None
    snap = {"users": users.to_manifest() if users is not None else None,
            "views": {}, "sequences": {}, "dbs": {}}
    for db in catalog.databases():
        # scratch schemas (recursive CTE temps)
        if db.startswith("_") or (want is not None and db.lower() not in want):
            continue
        snap["views"][db] = {}
        for vn in catalog.views(db):
            vsql, vcols = catalog.view_def(db, vn)
            snap["views"][db][vn] = [vsql, list(vcols) if vcols else None]
        snap["sequences"][db] = {
            sn: catalog.sequence(db, sn).meta()
            for sn in catalog.sequences(db)
        }
        snap["dbs"][db] = [
            (name, t.version, table_meta_to_json(t), t.blocks(), t.schema)
            for name, t in ((n, catalog.table(db, n)) for n in catalog.tables(db))
        ]
    return snap


def write_snapshot(snap: Dict, path: str, resume: bool = False) -> int:
    """Write what ``capture_catalog`` took. With resume=True, tables
    recorded complete in the checkpoint ledger are skipped — an
    interrupted backup picks up where it stopped (reference: BR backup
    checkpoints, br/pkg/checkpoint/backup.go). Returns tables written
    this run."""
    from tidb_tpu_torch.storage.external import open_storage
    from tidb_tpu_torch.utils.failpoint import inject

    store = open_storage(path)
    done = {}
    if resume and store.exists("checkpoint.json"):
        # ledger entries carry the table VERSION a file was written
        # at: a table that changed after its checkpoint re-writes,
        # so manifest metadata and npz data can't diverge
        done = {
            (d, n): v
            for d, n, v in json.loads(store.read_file("checkpoint.json"))
        }
    written = 0
    manifest = {"dbs": {}}
    if store.exists(_MANIFEST):
        # a subset backup into a directory holding a broader one must
        # not orphan the other databases' data files
        manifest = json.loads(store.read_file(_MANIFEST))
        manifest.setdefault("dbs", {})
    if snap["users"] is not None:
        manifest["users"] = snap["users"]
    manifest.setdefault("views", {}).update(snap["views"])
    manifest.setdefault("sequences", {}).update(snap["sequences"])
    for db, tables in snap["dbs"].items():
        manifest["dbs"][db] = {}
        for name, version, meta, blocks, schema in tables:
            manifest["dbs"][db][name] = meta
            cols = schema.names
            block = concat_blocks(blocks, cols, schema)
            arrays = {}
            for c in cols:
                hc = block.columns[c]
                arrays[f"{c}.data"] = hc.data
                arrays[f"{c}.valid"] = hc.valid
                if hc.dictionary is not None:
                    encode_dict_arrays(hc.dictionary, c, arrays)
            fn = f"{db}.{name}.npz"
            if done.get((db, name)) == version and store.exists(fn):
                continue  # checkpointed at this exact version
            inject("persist/backup-table")
            store.write_npz(fn, **arrays)
            written += 1
            done[(db, name)] = version
            store.write_file(
                "checkpoint.json",
                json.dumps(
                    [[d, n, v] for (d, n), v in sorted(done.items())]
                ).encode("utf-8"),
            )
    inject("persist/before-manifest")
    store.write_file(_MANIFEST, json.dumps(manifest).encode("utf-8"))
    # a completed backup needs no checkpoint ledger
    store.delete("checkpoint.json")
    return written


def save_catalog(
    catalog: Catalog, path: str, dbs=None, resume: bool = False
) -> int:
    """Write a snapshot of every table's current version (optionally
    restricted to `dbs`); see ``write_snapshot``."""
    return write_snapshot(capture_catalog(catalog, dbs), path, resume=resume)


def load_catalog(path: str, catalog: Catalog = None, dbs=None) -> Catalog:
    """Rebuild a catalog from a snapshot directory (optionally only the
    named databases — the RESTORE DATABASE path)."""
    from tidb_tpu_torch.storage.external import open_storage
    from tidb_tpu_torch.storage.sequence import Sequence
    from tidb_tpu_torch.utils.failpoint import inject
    from tidb_tpu_torch.utils.privilege import UserStore

    inject("persist/restore-start")
    store = open_storage(path)
    catalog = catalog or Catalog()
    manifest = json.loads(store.read_file(_MANIFEST))
    if manifest.get("users") and dbs is None:
        catalog.users = UserStore.from_manifest(manifest["users"])
    want = {d.lower() for d in dbs} if dbs else None
    for db, tables in manifest["dbs"].items():
        if want is not None and db.lower() not in want:
            continue
        catalog.create_database(db, if_not_exists=True)
        for name, meta in tables.items():
            schema = schema_from_meta(meta)
            if catalog.has_table(db, name) and not schemas_equivalent(
                catalog.table(db, name).schema, schema
            ):
                # restoring over a table whose schema has since diverged
                # (e.g. ALTER after the backup): the snapshot's schema
                # wins — keeping the live schema while installing
                # snapshot-shaped blocks would corrupt the table
                catalog.drop_table(db, name)
            t = catalog.create_table(db, name, schema, if_not_exists=True)
            apply_table_meta(t, meta)
            # allow_pickle stays OFF: a snapshot directory is data, and
            # must never be able to execute code on RESTORE
            data = store.read_npz(f"{db}.{name}.npz")
            cols = {}
            for n, ty in schema.columns:
                d = data[f"{n}.data"]
                v = data[f"{n}.valid"]
                dic = decode_dict_arrays(data, n)
                if dic is not None:
                    t.dictionaries[n] = dic
                elif f"{n}.dict" in data:
                    # snapshots from before the offsets format stored a
                    # pickled object array; np.load without allow_pickle
                    # rejects those at access time — surface a clear
                    # re-export message instead of a numpy internals
                    # error
                    raise ValueError(
                        f"snapshot {path} uses the old pickled dictionary "
                        "format; re-export it with BACKUP from the "
                        "version that wrote it"
                    )
                cols[n] = HostColumn(ty, d, v, dic)
            block = HostBlock.from_columns(cols)
            # always replace — restoring an empty snapshot over a live
            # table must clear it, not silently keep the newer rows
            t.replace_blocks(
                t.split_by_partition(block) if block.nrows else []
            )
    for db, views in manifest.get("views", {}).items():
        if want is not None and db.lower() not in want:
            continue
        catalog.create_database(db, if_not_exists=True)
        for vn, (vsql, vcols) in views.items():
            catalog.create_view(db, vn, vsql, vcols, or_replace=True)
    for db, seqs in manifest.get("sequences", {}).items():
        if want is not None and db.lower() not in want:
            continue
        catalog.create_database(db, if_not_exists=True)
        for sn, meta in seqs.items():
            catalog.drop_sequence(db, sn, if_exists=True)
            catalog.create_sequence(db, sn, Sequence.from_meta(sn, meta))
    return catalog
