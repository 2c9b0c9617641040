"""Built-in DXF task types: distributed ANALYZE, chunked IMPORT, and
index backfill.

Counterpart of tidb_tpu/dxf/tasks.py. Where device work runs: only the
``analyze`` subtasks touch the card, each under its device's statement
lock (``meta["device"]``, CUDA unless named), since executors are
threads other than a statement's. The ``import`` subtasks parse and sort
on the host, each range in one of the task's staging processes (the
parse is Python, and the executor threads share one interpreter); its
finalize, which appends, runs on the thread that drives the task
(IMPORT INTO's statement thread). The merged runs are
installed into the port's index structures (dxf/extsort.py). The spill
files go to ``meta["spill_dir"]``, by default under
``tempfile.gettempdir()``.

Reference mappings:
- "analyze": ANALYZE pushdown split per column (the reference splits
  per region/column group; pkg/executor/analyze.go workers).
- "import": IMPORT INTO through the lightning external-backend shape
  (pkg/disttask/importinto Init -> EncodeAndSort -> MergeSort ->
  Ingest): each subtask parses its byte range into a STAGED block file
  plus sorted runs for indexed columns (dxf/extsort.py); the finalizer
  appends the staged blocks and k-way merges the runs into installed
  sorted-index caches — no post-hoc argsort. Crash-resume re-stages
  unfinished chunks from the subtask ledger with no double-append.
- "index_backfill": CREATE INDEX backfill split per block
  (pkg/ddl/backfilling_dist_scheduler.go): subtasks spill per-block
  sorted runs, the finalizer k-way merges them into the derived
  sorted-index cache under the F1 state ladder.
"""

from __future__ import annotations

import dataclasses
import os
import uuid
from typing import List

from tidb_tpu_torch.dxf.framework import register_task_type
from tidb_tpu_torch.utils import racecheck


# -- distributed ANALYZE ----------------------------------------------------


def _analyze_plan(meta, catalog) -> List[dict]:
    t = catalog.table(meta["db"], meta["table"])
    return [
        {"db": meta["db"], "table": meta["table"], "column": c,
         "device": meta.get("device")}
        for c in t.schema.names
    ]


def _analyze_run(meta, catalog) -> dict:
    from tidb_tpu_torch.chunk import resolve_device
    from tidb_tpu_torch.session.session import statement_lock
    from tidb_tpu_torch.stats.collect import analyze_table

    t = catalog.table(meta["db"], meta["table"])
    device = resolve_device(meta.get("device"))
    with statement_lock(device):
        stats = analyze_table(t, device=device, columns=[meta["column"]])
    cs = stats[meta["column"]]
    return {
        "column": meta["column"],
        "row_count": int(cs.row_count),
        "ndv": int(cs.ndv),
    }


def _analyze_finalize(meta, results, catalog) -> None:
    t = catalog.table(meta["db"], meta["table"])
    t.analyzed_modify = t.modify_count


# -- chunked IMPORT (lightning-lite) ----------------------------------------


def _import_plan(meta, catalog) -> List[dict]:
    """Split the file into ~chunk_bytes ranges aligned to line breaks
    (mydump chunking: every subtask owns a self-contained byte range)."""
    path = meta["path"]
    # per-task nonce: spill files of concurrent tasks over same-named
    # tables (or the same table twice) must never collide
    nonce = meta.setdefault("nonce", uuid.uuid4().hex[:12])
    chunk = int(meta.get("chunk_bytes", 1 << 20))
    size = os.path.getsize(path)
    subtasks = []
    with open(path, "rb") as f:
        start = 0
        while start < size:
            end = min(start + chunk, size)
            if end < size:
                f.seek(end)
                f.readline()  # advance to the next line boundary
                end = f.tell()
            subtasks.append(
                {
                    "db": meta["db"], "table": meta["table"],
                    "path": path, "start": start, "end": end,
                    "sep": meta.get("sep", "\t"),
                    "spill_dir": meta.get("spill_dir"),
                    "nonce": nonce,
                }
            )
            start = end
    return subtasks


#: each IMPORT task's staging processes, by the task's nonce: the parse is
#: Python, and the executors are threads of one interpreter
_STAGERS: dict = {}
_STAGERS_LOCK = racecheck.make_lock("dxf.stagers")


def _stager(nonce: str):
    """The task's pool of staging processes, started on demand (at most
    one for each executor waiting on it). They are forked from the
    multiprocessing fork server, a clean process that has imported this
    module once (never a fork of a process that holds the card), so a
    process starts in milliseconds where a spawned one imports torch
    again."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with _STAGERS_LOCK:
        pool = _STAGERS.get(nonce)
        if pool is None:
            ctx = multiprocessing.get_context("forkserver")
            ctx.set_forkserver_preload([__name__])
            pool = _STAGERS[nonce] = ProcessPoolExecutor(
                max_workers=os.cpu_count() or 1, mp_context=ctx)
        return pool


def _close_stager(nonce: str) -> None:
    with _STAGERS_LOCK:
        pool = _STAGERS.pop(nonce, None)
    if pool is not None:
        pool.shutdown(wait=True, cancel_futures=True)


def _import_run(meta, catalog) -> dict:
    """EncodeAndSort: parse one byte range into a STAGED block file
    (never appended here — re-runs after a crash just re-stage, the
    lightning chunk-checkpoint property without double-append risk),
    plus a sorted run per single-column numeric/temporal index so the
    finalizer's Ingest needs no post-hoc argsort. The range is staged by
    one of the task's processes (``_stager``), which touch no device;
    this thread waits for it. A range that fails closes the task's
    processes: the task fails with it."""
    t = catalog.table(meta["db"], meta["table"])
    spec = {"name": t.name, "schema": t.schema, "partition": t.partition,
            "indexes": dict(t.indexes)}
    nonce = meta.get("nonce", "0")
    try:
        return _stager(nonce).submit(_stage_range, meta, spec).result()
    except BaseException:
        _close_stager(nonce)
        raise


def _stage_range(meta, spec) -> dict:
    """``_import_run``'s work over the table's definition `spec` (name,
    schema, partition defs, indexes): picklable, for a process."""
    import numpy as np

    from tidb_tpu_torch.dxf import extsort
    from tidb_tpu_torch.storage.loader import parse_block
    from tidb_tpu_torch.storage.table import Table

    t = Table(spec["name"], spec["schema"])
    t.partition = spec["partition"]
    t.indexes = spec["indexes"]
    # binary seek/read: start/end are BYTE offsets (text-mode seek on
    # arbitrary ints corrupts multi-byte sequences and read() counts
    # characters, overlapping the next chunk)
    with open(meta["path"], "rb") as f:
        f.seek(meta["start"])
        data = f.read(meta["end"] - meta["start"])
    lines = [
        ln for ln in data.decode("utf-8", errors="replace").splitlines() if ln
    ]
    block = parse_block(t, lines, meta["sep"])
    if block is None:
        return {"rows": 0, "staged": None}
    d = _spill_dir(meta)
    tag = f"im_{meta['db']}_{meta['table']}_{meta.get('nonce', '0')}_{meta['start']}"
    staged = os.path.join(d, f"{tag}.npz")
    arrs = {}
    for name, c in block.columns.items():
        arrs[f"d_{name}"] = c.data
        arrs[f"v_{name}"] = c.valid
        if c.dictionary is not None:
            # not object arrays: the file loads without allow_pickle. A
            # dictionary is one UTF-8 blob of its values joined by NUL
            # (a fifth of a fixed-width unicode array's bytes), or, where
            # a value holds a NUL, that unicode array
            joined = "\x00".join(c.dictionary.tolist())
            if len(c.dictionary) and joined.count("\x00") == len(c.dictionary) - 1:
                arrs[f"j_{name}"] = np.frombuffer(joined.encode(), dtype=np.uint8)
            else:
                arrs[f"s_{name}"] = c.dictionary.astype(str)
    np.savez(staged, **arrs)
    # EncodeAndSort covers every index shape:
    # - partitioned tables split runs per partition AT STAGE TIME,
    #   mirroring split_by_partition's masks so each run matches one
    #   landed block (ascending pid order, within-partition row order
    #   preserved by boolean masking);
    # - dict-coded (string) columns stage LOCAL codes + the local
    #   dictionary; the finalizer remaps monotonically to the aligned
    #   table dictionary (sorted-dict merges keep code order);
    # - composite keys stage the sorted [m, k] key matrix (the
    #   uniqueness index's structure), remapped per dict field at ingest.
    if t.partition is not None:
        pcol = t.partition[1]
        pc = block.columns.get(pcol)
        if pc is None or pc.dictionary is not None:
            # dict-coded partition column: stage-time LOCAL codes and
            # append-time ALIGNED codes can route rows to different
            # partitions, so per-partition runs could be matched to the
            # wrong landed blocks — stage the block only, indexes fall
            # back to the on-demand delta sort
            return {"rows": block.nrows, "staged": staged, "runs": [],
                    "start": meta["start"]}
        # NULL keys route exactly where split_by_partition routes them
        # (pid 0 for RANGE/HASH, the NULL-listing LIST partition) — a
        # divergence here pairs staged runs with the WRONG landed blocks
        np_id = t.null_partition() if not pc.valid.all() else 0
        if np_id is None:
            # no partition accepts NULL: the append will reject this
            # block anyway; stage without runs
            return {"rows": block.nrows, "staged": staged, "runs": [],
                    "start": meta["start"]}
        pid = np.full(block.nrows, np_id, dtype=np.int64)
        if pc.valid.any():
            pid[pc.valid] = t.partition_of(pc.data[pc.valid])
        masks = [(int(p), pid == p) for p in sorted(set(pid.tolist()))]
    else:
        masks = [(0, np.ones(block.nrows, dtype=bool))]
    runs = []
    for iname, cols in t.indexes.items():
        if any(block.columns.get(c) is None for c in cols):
            continue
        for pi, (_p, m) in enumerate(masks):
            if len(cols) == 1:
                c = block.columns[cols[0]]
                rp = os.path.join(d, f"{tag}_p{pi}_{cols[0]}.npz")
                man = extsort.write_run(rp, c.data[m], c.valid[m], 0)
                man["col"] = cols[0]
                man["part_index"] = pi
                if c.dictionary is not None:
                    man["local_dict"] = [
                        str(x) for x in c.dictionary.tolist()
                    ]
                runs.append(man)
            else:
                from tidb_tpu_torch.storage.table import Table as _T

                sub = {
                    n: dataclasses.replace(
                        cc, data=cc.data[m], valid=cc.valid[m]
                    )
                    for n, cc in block.columns.items()
                }
                mat = _T._key_matrix(sub, cols)
                rp = os.path.join(
                    d, f"{tag}_p{pi}_c_{'_'.join(cols)}.npz"
                )
                man = extsort.write_comp_run(rp, mat)
                man["comp"] = list(cols)
                man["part_index"] = pi
                man["block_rows"] = int(m.sum())
                dfields = {
                    str(fi): [str(x) for x in sub[c].dictionary.tolist()]
                    for fi, c in enumerate(cols)
                    if sub[c].dictionary is not None
                }
                if dfields:
                    man["dict_fields"] = dfields
                runs.append(man)
    return {"rows": block.nrows, "staged": staged, "runs": runs,
            "start": meta["start"]}


def _import_finalize(meta, results, catalog) -> None:
    """Ingest: append staged blocks in chunk order, then k-way merge the
    per-chunk sorted runs with runs over pre-existing blocks and install
    each index's derived cache (MergeOverlappingFiles -> ingest,
    br/pkg/lightning/backend/external/merge.go:39)."""
    import numpy as np

    from tidb_tpu_torch.chunk import HostBlock, HostColumn
    from tidb_tpu_torch.dxf import extsort

    _close_stager(meta.get("nonce", "0"))  # every range is staged
    t = catalog.table(meta["db"], meta["table"])
    staged = sorted(
        (r for r in results if r and r.get("staged")),
        key=lambda r: r.get("start", 0),
    )
    types = t.schema.types
    appended = []  # (chunk result, landed uids)
    for r in staged:
        # idempotence fence for owner-failover re-runs: a staged file
        # that no longer exists was ingested by a previous finalize
        # attempt — append THEN unlink, per chunk (the same
        # crash-window contract as the old per-subtask append ledger)
        if not os.path.exists(r["staged"]):
            continue
        with np.load(r["staged"]) as z:
            cols = {}
            for name in t.schema.names:
                if f"d_{name}" not in z:
                    continue
                if f"j_{name}" in z:
                    dic = np.array(z[f"j_{name}"].tobytes().decode().split("\x00"),
                                   dtype=object)
                elif f"s_{name}" in z:
                    dic = z[f"s_{name}"].astype(object)
                else:
                    dic = None
                cols[name] = HostColumn(
                    types[name], z[f"d_{name}"], z[f"v_{name}"], dic
                )
        if cols:
            b = HostBlock.from_columns(cols)
            _v, uids = t.append_block_uids(b)
            appended.append((r, uids))
        try:
            os.unlink(r["staged"])
        except OSError:
            pass
    # Ingest the merged sorted indexes: dict-coded
    # columns remap run codes monotonically to the aligned table
    # dictionary, composite keys merge sorted key-matrix views into the
    # uniqueness index's structure, and partitioned tables match per-partition
    # runs to their landed blocks by split order.
    run_by_uid: dict = {}   # (col, uid) -> single-col run manifest
    comp_by_uid: dict = {}  # (cols tuple, uid) -> composite manifest
    for r, uids in appended:
        for man in r.get("runs") or []:
            pi = man.get("part_index", 0)
            if pi >= len(uids):
                continue  # stage/append split disagreed: fall back
            uid = uids[pi]
            if "comp" in man:
                comp_by_uid[(tuple(man["comp"]), uid)] = man
            else:
                run_by_uid[(man["col"], uid)] = man
    cols_with_runs = {c for (c, _u) in run_by_uid}
    for col in cols_with_runs:
        tdict = t.dictionaries.get(col)
        while True:
            version = t.version
            blocks = list(t.blocks(version))
            runs = []
            off = 0
            for b in blocks:
                c = b.columns.get(col)
                if c is None:
                    runs = None
                    break
                man = run_by_uid.get((col, b.uid))
                if (
                    man is not None
                    and man["n"] == b.nrows
                    and os.path.exists(man["run"])
                ):
                    # the staged run IS this block's sort: re-offset
                    # (and remap local dict codes to the table dict —
                    # monotone, so the run stays sorted)
                    svals, rank, rows = extsort.read_run(man["run"])
                    if man.get("local_dict") is not None:
                        svals = extsort.remap_codes(
                            svals, rank, man["local_dict"], tdict
                        )
                    runs.append((svals, rank, rows + off))
                else:
                    # pre-existing or concurrent block: delta sort
                    runs.append(extsort.sort_run(c.data, c.valid, off))
                off += b.nrows
            if runs is None:
                break
            merged = extsort.merge_runs(runs)
            if extsort.install_sorted_index(t, col, merged, version):
                break
    comp_keys = {ck for (ck, _u) in comp_by_uid}
    for cols in comp_keys:
        tdicts = [t.dictionaries.get(c) for c in cols]
        while True:
            version = t.version
            views = []
            for b in t.blocks(version):
                if any(c not in b.columns for c in cols):
                    continue
                man = comp_by_uid.get((cols, b.uid))
                if (
                    man is not None
                    and man.get("block_rows") == b.nrows
                    and os.path.exists(man["run"])
                ):
                    mat = extsort.read_comp_run(man["run"])
                    mat = extsort.remap_comp_fields(
                        mat, man.get("dict_fields") or {}, tdicts
                    )
                    views.append(extsort._rows_view(mat))
                else:
                    from tidb_tpu_torch.storage.table import Table as _T

                    views.append(
                        np.sort(
                            extsort._rows_view(
                                _T._key_matrix(b.columns, cols)
                            )
                        )
                    )
            merged_view = extsort.merge_sorted_views(views)
            if extsort.install_composite_index(
                t, cols, merged_view, version
            ):
                break
    for r, _u in appended:
        extsort.cleanup_runs(r.get("runs"))


# -- index backfill ---------------------------------------------------------


def _spill_dir(meta) -> str:
    import tempfile

    d = meta.get("spill_dir") or os.path.join(
        tempfile.gettempdir(), "tidb_tpu_torch_extsort"
    )
    os.makedirs(d, exist_ok=True)
    return d


def _backfill_plan(meta, catalog) -> List[dict]:
    """One subtask per block, pinned to the planning snapshot: each
    carries its block uid + global row offset so run files merge in
    global row order (pkg/ddl/backfilling_dist_scheduler.go splits by
    region range the same way)."""
    t = catalog.table(meta["db"], meta["table"])
    col = meta["column"].lower()
    if col not in t.schema.names:
        raise ValueError(f"unknown column {col!r}")
    name = meta.get("index", f"idx_{col}").lower()
    # per-task nonce: another task's runs of the same column in the same
    # spill directory are neither overwritten nor swept by this one
    nonce = meta.setdefault("nonce", uuid.uuid4().hex[:12])
    # register WRITE_ONLY before planning: every writer from this
    # instant maintains the (derived) index; readers ignore it.
    # An existing index (any state) must never be demoted/stomped.
    with t._lock:
        if name in t.indexes:
            raise ValueError(f"index {name} already exists")
        t.indexes[name] = [col]
        t.index_states[name] = "write_only"
    version = t.version
    subtasks = []
    off = 0
    for i, b in enumerate(t.blocks(version)):
        subtasks.append({
            "db": meta["db"], "table": meta["table"], "column": col,
            "block_uid": b.uid, "block": i, "offset": off,
            "version": version, "spill_dir": meta.get("spill_dir"), "nonce": nonce,
        })
        off += b.nrows
    return subtasks or [{
        "db": meta["db"], "table": meta["table"], "column": col,
        "block_uid": -1, "block": 0, "offset": 0, "version": version,
        "spill_dir": meta.get("spill_dir"), "nonce": nonce,
    }]


def _backfill_run(meta, catalog) -> dict:
    """EncodeAndSort: sort THIS block's column into a spilled run file
    (dxf/extsort.py). The real distributed work — wall time scales with
    executor count because each run sorts independently."""
    from tidb_tpu_torch.dxf import extsort

    t = catalog.table(meta["db"], meta["table"])
    blocks = {b.uid: b for b in t.blocks(meta["version"])} if (
        meta["version"] in t._versions
    ) else {}
    b = blocks.get(meta["block_uid"])
    if b is None:
        return {"rows": 0, "run": None}
    c = b.columns.get(meta["column"])
    if c is None:
        return {"rows": 0, "run": None}
    path = os.path.join(
        _spill_dir(meta),
        f"bf_{meta['db']}_{meta['table']}_{meta['column']}_{meta['nonce']}_"
        f"{meta['block_uid']}.npz",
    )
    man = extsort.write_run(path, c.data, c.valid, meta["offset"])
    man["rows"] = man["n"]
    man["uid"] = meta["block_uid"]
    return man


def _backfill_finalize(meta, results, catalog) -> None:
    """MergeSort + Ingest: k-way merge the spilled runs (global row
    order) and install the result as the derived sorted-index cache for
    the snapshot version; blocks appended since the snapshot (WRITE_ONLY
    writers) sort as delta runs here. Then flip PUBLIC."""
    from tidb_tpu_torch.dxf import extsort

    t = catalog.table(meta["db"], meta["table"])
    name = meta.get("index", f"idx_{meta['column']}").lower()
    col = meta["column"].lower()
    t.index_states[name] = "write_reorg"
    try:
        for _attempt in range(64):
            version = t.version
            blocks = list(t.blocks(version))
            have = {
                r["uid"]: r for r in results
                if r and r.get("run") and os.path.exists(r["run"])
            }
            runs = []
            off = 0
            for b in blocks:
                r = have.get(b.uid)
                if r is not None and r.get("n") == b.nrows:
                    svals, rank, rows = extsort.read_run(r["run"])
                    # re-offset: the block may have shifted position
                    rows = rows - (rows.min() if len(rows) else 0) + off
                    runs.append((svals, rank, rows))
                else:
                    # delta block (WRITE_ONLY-era append or rewrite):
                    # sort it here — small next to the planned snapshot
                    c = b.columns.get(col)
                    if c is not None:
                        runs.append(extsort.sort_run(c.data, c.valid, off))
                off += b.nrows
            merged = extsort.merge_runs(runs)
            # install + schema-barrier bump in ONE lock acquisition:
            # the public flip must not orphan the merge on a version it
            # immediately supersedes
            if extsort.install_sorted_index(t, col, merged, version, bump=True):
                break  # version held: ingest landed
        else:
            raise RuntimeError(
                f"backfill of {col!r} did not converge (column dropped "
                "mid-reorg or version churn)"
            )
        t.index_states[name] = "public"
    except BaseException:
        with t._lock:  # roll the registration back
            t.indexes.pop(name, None)
            t.index_states.pop(name, None)
        raise
    finally:
        extsort.cleanup_runs(results)


register_task_type("analyze", _analyze_plan, _analyze_run, _analyze_finalize)
register_task_type("import", _import_plan, _import_run, _import_finalize)
def _backfill_revert(meta, catalog) -> None:
    """Failed/reverting backfill: drop the WRITE_ONLY registration the
    planner installed (finalize never ran, so nothing went public) and
    sweep any spilled run files."""
    import glob

    try:
        t = catalog.table(meta["db"], meta["table"])
        name = meta.get(
            "index", f"idx_{meta['column'].lower()}"
        ).lower()
        with t._lock:
            if t.index_states.get(name) in ("write_only", "write_reorg"):
                t.indexes.pop(name, None)
                t.index_states.pop(name, None)
    except Exception:
        pass
    if "nonce" not in meta:
        return  # never planned: no runs spilled
    for p in glob.glob(os.path.join(
        _spill_dir(meta),
        f"bf_{meta['db']}_{meta['table']}_{meta['column'].lower()}_{meta['nonce']}_*.npz",
    )):
        try:
            os.unlink(p)
        except OSError:
            pass


register_task_type(
    "index_backfill", _backfill_plan, _backfill_run, _backfill_finalize,
    reverter=_backfill_revert,
)
