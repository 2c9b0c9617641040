"""The port's bulk loads against the JAX package's: LOAD DATA (the native
splitter and the Python parser), IMPORT INTO over the DXF, the DXF
framework and its task types, and the external sort.

Shapes: tests/test_aux.py's LOAD DATA and native-loader cases (:140-190),
tests/test_tools.py's IMPORT INTO cases and tests/test_dxf.py. Both
Sessions load the same files; rows, affected counts, error texts and the
stored state (``same_state``: data, validity, dictionaries, modify
counts) must be equal. Where the reference arms a failpoint the port's
case patches the function instead (the port has no failpoints). The
import's index caches are compared with what the port's own
``Table._sorted_index`` and uniqueness index build from the landed
blocks. Every wait on a task has a timeout.
"""

import os
import time

import numpy as np
import pytest

import tidb_tpu.dxf.tasks  # noqa: F401 (registers the JAX task types)
from tidb_tpu.dxf import TaskManager as JaxTaskManager
from tidb_tpu.session import Session as JaxSession
from tidb_tpu_torch import _build
from tidb_tpu_torch.dxf import (
    SubtaskState,
    TaskExecutor,
    TaskManager,
    TaskState,
    extsort,
    framework,
    register_task_type,
)
import tidb_tpu_torch.dxf.tasks as tasks  # noqa: F401 (registers the port's task types)
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import loader, native

from _torch_parity import one_thread, WritePair  # noqa: F401 (one_thread)


@pytest.fixture()
def pair():
    return WritePair(JaxSession(), Session(device="cpu"))


def write(path, text):
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return str(path)


# ---------------------------------------------------------------------------
# LOAD DATA (tests/test_aux.py :140-190)
# ---------------------------------------------------------------------------


def test_load_tsv_and_pipe(pair, tmp_path):
    tsv = write(tmp_path / "a.tsv", "10\thello\n11\tworld\n\\N\tnullrow\n")
    tbl = write(tmp_path / "b.tbl", "20|pipe|\n")  # dbgen's trailing separator
    pair.runs("create table t (a bigint, b varchar(10))",
              "insert into t values (1, 'x'), (2, 'y'), (2, 'z')",
              f"load data infile '{tsv}' into table t",
              "select a, b from t where b in ('hello','world','nullrow') order by b",
              f"load data local infile '{tbl}' into table t fields terminated by '|'",
              "select a from t where b = 'pipe'")
    pair.state("t")


NATIVE_TYPES = "i bigint, f double, s varchar(20), d date, m decimal(10,2), b boolean"
NATIVE_ROWS = ("1|1.5|abc|1994-01-01|12.345|1|\n-2|\\N|x y|2024-02-29|-0.5|0|\n"
               "\\N|2e3||1970-01-01|99999999.99|\\N|\n7|x|é中|1999-13-01|1.2.3|yes|\n"
               "3.7|-0.0|\\N|\\N|-7|0|extra\n")
PYTHON_TYPES = "i int, dt datetime, tm time, s varchar(8)"
PYTHON_ROWS = ("1|2024-01-02 03:04:05|10:11:12|a|\n\\N|\\N|\\N|\\N\n"
               "-3|1999-12-31 23:59:59.5|-01:00:00|é\n")


@pytest.mark.parametrize("types,rows,parser", [
    (NATIVE_TYPES, NATIVE_ROWS, "native"),
    (PYTHON_TYPES, PYTHON_ROWS, "python"),
], ids=["native", "python"])
def test_native_and_python_parsers(pair, tmp_path, monkeypatch, types, rows, parser):
    """Each SQL type through the parser the JAX package takes for the
    table: the splitter (bad values become NULL there, extra fields are
    ignored) or the Python parser (DATETIME and TIME)."""
    path = write(tmp_path / "n.tbl", rows)
    took = []
    real = native.parse_file
    monkeypatch.setattr(native, "parse_file", lambda *a: took.append(1) or real(*a))
    pair.runs(f"create table n ({types})",
              f"load data infile '{path}' into table n fields terminated by '|'")
    assert bool(took) == (parser == "native")
    pair.state("n")


@pytest.mark.parametrize("types", [NATIVE_TYPES, PYTHON_TYPES], ids=["native", "python"])
def test_field_count_and_missing_file_errors(pair, tmp_path, types):
    short = write(tmp_path / "s.tbl", "1|2|\n1\n")
    pair.runs(f"create table n ({types})",
              f"load data infile '{short}' into table n fields terminated by '|'",
              f"load data infile '{tmp_path / 'absent.tbl'}' into table n fields terminated by '|'",
              "select count(*) from n")
    pair.state("n")


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A splitter that does not compile raises with g++'s output; nothing
    falls back to the Python parser."""
    (tmp_path / "loader.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(native, "_lib", None)
    s = Session(device="cpu")
    s.execute("create table t (a bigint)")
    path = write(tmp_path / "a.tsv", "1\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for loader.cpp:\n.*error"):
        s.execute(f"load data infile '{path}' into table t")
    assert s.execute("select count(*) from t").rows == [(0,)]


def test_constrained_load_rolls_back(pair, tmp_path):
    good = write(tmp_path / "g.tsv", "1\t10\n2\t20\n")
    bad_check = write(tmp_path / "c.tsv", "3\t30\n4\t-1\n")
    bad_fk = write(tmp_path / "f.tsv", "5\t99\n")
    pair.runs("create table p (id int primary key, v int)",
              "insert into p values (10, 1), (20, 2), (30, 3)",
              "create table c (k int, pid int, constraint nonneg check (pid >= 0), "
              "constraint fk foreign key (pid) references p (id))",
              f"load data infile '{good}' into table c",
              f"load data infile '{bad_check}' into table c",
              f"load data infile '{bad_fk}' into table c",
              "select k, pid from c order by k")
    pair.state("c")


def test_constrained_load_rollback_keeps_stored_strings(pair, tmp_path):
    """A refused file whose string sorts between the stored ones: the
    append re-maps the stored codes into the merged dictionary, and the
    rollback restores the blocks with the dictionary they were coded by.
    The JAX package restores the blocks only (its stored 'c' then reads
    back as 'b'; ROADMAP section 3), so the rows after the refusal are
    held against the values written."""
    good = write(tmp_path / "g.tsv", "1\ta\n3\tc\n")
    bad = write(tmp_path / "b.tsv", "2\tb\n4\tbb\n9\td\n")
    after = write(tmp_path / "a.tsv", "5\tab\n")
    pair.runs("create table s (k int, v varchar(4), constraint small check (k < 9))",
              f"load data infile '{good}' into table s", "select k, v from s order by k")
    with pytest.raises(Exception, match="small"):
        pair.ts.execute(f"load data infile '{bad}' into table s")
    assert pair.ts.execute("select k, v from s order by k").rows == [(1, "a"), (3, "c")]
    pair.ts.execute(f"load data infile '{after}' into table s")
    assert pair.ts.execute("select k, v from s order by k").rows == [
        (1, "a"), (3, "c"), (5, "ab")]
    assert pair.ts.execute("select count(*) from s where v = 'c'").rows == [(1,)]


def test_load_routes_partitions(pair, tmp_path):
    path = write(tmp_path / "r.tsv", "".join(f"{i}\t{i % 25}\n" for i in range(60)) + "\\N\t1\n")
    pair.runs("create table r (a int, v int) partition by range (a) ("
              "partition p0 values less than (20), partition p1 values less than (40), "
              "partition p2 values less than maxvalue)",
              "create table h (a int, v int) partition by hash (v) partitions 4",
              f"load data infile '{path}' into table r", f"load data infile '{path}' into table h",
              "select count(*) from r where a < 20", "admin check table r, h")
    for name in ("r", "h"):
        pair.state(name)
        jt, tt = (x.catalog.table("test", name) for x in (pair.js, pair.ts))
        assert [b.part_id for b in jt.blocks()] == [b.part_id for b in tt.blocks()]


def test_load_data_needs_insert_privilege(tmp_path):
    from tidb_tpu_torch.storage import Catalog

    cat = Catalog()
    root = Session(cat, device="cpu")
    root.execute("create table t (a int)")
    root.execute("create user reader")
    s = Session(cat, device="cpu", user="reader")
    path = write(tmp_path / "a.tsv", "1\n")
    with pytest.raises(PermissionError):
        s.execute(f"load data infile '{path}' into table t")


# ---------------------------------------------------------------------------
# IMPORT INTO (tests/test_tools.py :90-110)
# ---------------------------------------------------------------------------


def test_import_into_statements(pair, tmp_path):
    rows = write(tmp_path / "rows.tsv", "".join(f"{i}\tz{i % 3}\n" for i in range(1000)))
    csv = write(tmp_path / "rows.csv", "1,a\n2,b\n")
    pair.runs("create database app", "create table app.big (id int, v varchar(8))",
              f"import into app.big from '{rows}'", "select count(*), sum(id) from app.big",
              "create table app.c (id int, v varchar(4))",
              f"import into app.c from '{csv}' fields terminated by ','",
              "select * from app.c order by id",
              f"import into app.c from '{tmp_path / 'absent.tsv'}'")
    pair.state("big", db="app")
    pair.state("c", db="app")


# ---------------------------------------------------------------------------
# the DXF import task (tests/test_dxf.py): both packages' managers
# ---------------------------------------------------------------------------


def run_import(pair, table, path, tmp_path, **meta):
    """The same import task through both packages' managers."""
    for m in (JaxTaskManager(pair.js.catalog), TaskManager(pair.ts.catalog)):
        tid = m.submit("import", {"db": "test", "table": table, "path": path,
                                  "spill_dir": str(tmp_path), **meta})
        assert m.run_to_completion(tid, executors=4, timeout_s=60) == "succeed"


def assert_caches_fresh(t, col=None, comp=None):
    """The installed index caches equal what the port builds itself."""
    if col is not None:
        key = (tuple(b.uid for b in t.blocks()), col)
        ent = t._idx_cache.pop(key)
        fresh = t._sorted_index(col)
        assert ent[2] == fresh[2]
        assert np.array_equal(ent[0], fresh[0]) and np.array_equal(ent[1], fresh[1])
    if comp is not None:
        uids, view = t._key_cache.pop(("rows", comp))
        assert uids == tuple(b.uid for b in t.blocks() if all(c in b.columns for c in comp))
        assert np.array_equal(view, t._sorted_composite(comp))


def test_chunked_import_multibyte_and_empty(pair, tmp_path):
    a = write(tmp_path / "a.tsv", "".join(f"{i}\tx{i % 7}\n" for i in range(5000)))
    # a NUL inside a value stages the dictionary as a unicode array
    u = write(tmp_path / "u.tsv", "".join(f"{i}\té中{i % 5}\n" for i in range(2000))
              + "2000\ta\x00b\n")
    e = write(tmp_path / "e.tsv", "")
    pair.runs("create table imp (a int, b varchar(8))", "create table uni (a int, b varchar(16))",
              "create table emp (a int)")
    run_import(pair, "imp", a, tmp_path, chunk_bytes=8192)
    run_import(pair, "uni", u, tmp_path, chunk_bytes=4096)
    run_import(pair, "emp", e, tmp_path)
    for name in ("imp", "uni", "emp"):
        pair.state(name)
    pair.run("select count(*), sum(a) from uni")
    assert "a\x00b" in pair.ts.catalog.table("test", "uni").dictionaries["b"]


def test_import_ingests_numeric_and_string_indexes(pair, tmp_path):
    k = write(tmp_path / "k.tsv", "".join(f"{(i * 37) % 9991}\t{i}\n" for i in range(6000)))
    s = write(tmp_path / "s.tsv", "".join(f"w{(i * 13) % 997:04d}\t{i}\n" for i in range(4000)))
    pair.runs("create table si (k int, v int)", "create index ik on si (k)",
              "create table ss (s varchar(10), v int)", "create index isx on ss (s)")
    run_import(pair, "si", k, tmp_path, chunk_bytes=8192)
    run_import(pair, "ss", s, tmp_path, chunk_bytes=8192)
    pair.state("si")
    pair.state("ss")
    pair.runs("admin check index si ik", "admin check index ss isx")
    assert_caches_fresh(pair.ts.catalog.table("test", "si"), "k")
    assert_caches_fresh(pair.ts.catalog.table("test", "ss"), "s")


def test_import_partitioned_composite_string_index(pair, tmp_path):
    path = write(tmp_path / "p.tsv",
                 "".join(f"{i % 1000}\tk{(i * 7) % 313:03d}\t{i}\n" for i in range(5000)))
    pair.runs("create table pc (r int, s varchar(8), v int) partition by range (r) ("
              "partition p0 values less than (300), partition p1 values less than (700), "
              "partition p2 values less than maxvalue)",
              "create unique index ic on pc (s, v)", "create index ir on pc (v)")
    run_import(pair, "pc", path, tmp_path, chunk_bytes=16384)
    pair.state("pc")
    pair.run("admin check table pc")
    assert_caches_fresh(pair.ts.catalog.table("test", "pc"), "v", ("s", "v"))


def test_import_string_index_into_prepopulated_table(pair, tmp_path):
    path = write(tmp_path / "pp.tsv", "".join(f"b{(i * 11) % 577:03d}\t{i}\n" for i in range(3000)))
    pair.runs("create table pp (s varchar(10), v int)", "create index ip on pp (s)",
              "insert into pp values ('zz', -1), ('mm', -2), ('aa', -3)")
    run_import(pair, "pp", path, tmp_path, chunk_bytes=8192)
    pair.state("pp")
    assert_caches_fresh(pair.ts.catalog.table("test", "pp"), "s")


def test_import_list_partition_null_routing(pair, tmp_path):
    path = write(tmp_path / "l.tsv",
                 "".join(f"{['1', '2', chr(92) + 'N'][i % 3]}\t{i}\n" for i in range(300)))
    pair.runs("create table lt (r int, v int) partition by list (r) ("
              "partition a values in (1), partition b values in (2), "
              "partition nulls values in (null))", "create index iv on lt (v)")
    run_import(pair, "lt", path, tmp_path, chunk_bytes=2048)
    pair.state("lt")
    pair.run("admin check table lt")
    assert_caches_fresh(pair.ts.catalog.table("test", "lt"), "v")


# ---------------------------------------------------------------------------
# the DXF manager (tests/test_dxf.py)
# ---------------------------------------------------------------------------


@pytest.fixture()
def sess():
    s = Session(device="cpu")
    s.execute("create table t (a int, b varchar(8))")
    s.execute("insert into t values " + ",".join(f"({i % 9},'v{i % 4}')" for i in range(500)))
    return s


def test_distributed_analyze_matches_analyze_table(sess):
    m = TaskManager(sess.catalog)
    tid = m.submit("analyze", {"db": "test", "table": "t", "device": "cpu"})
    assert m.run_to_completion(tid, executors=3, timeout_s=60) == "succeed"
    t = sess.catalog.table("test", "t")
    got = dict(t.stats)
    assert sorted(got) == ["a", "b"] and got["a"].ndv == 9
    assert t.analyzed_modify == t.modify_count
    sess.execute("analyze table t")
    for c in ("a", "b"):
        a, b = got[c], t.stats[c]
        assert (a.row_count, a.null_count, a.ndv, a.topn, a.min_val, a.max_val) == \
            (b.row_count, b.null_count, b.ndv, b.topn, b.min_val, b.max_val)
        assert np.array_equal(a.bounds, b.bounds)


def test_owner_failover_resume(sess, tmp_path):
    path = write(tmp_path / "d.tsv", "".join(f"{i}\ty\n" for i in range(3000)))
    sess.execute("create table imp2 (a int, b varchar(8))")
    m = TaskManager(sess.catalog)
    tid = m.submit("import", {"db": "test", "table": "imp2", "path": path,
                              "chunk_bytes": 8192, "spill_dir": str(tmp_path)})
    m.schedule_once()  # plan the subtasks
    TaskExecutor(m, "solo").run_one()  # run one, then the owner "crashes"
    m2 = TaskManager(sess.catalog)  # a new owner over the same system tables
    assert m2.task_state(tid) == TaskState.RUNNING.value
    assert m2.run_to_completion(tid, executors=2, timeout_s=60) == "succeed"
    assert sess.execute("select count(*), sum(a) from imp2").rows == [(3000, sum(range(3000)))]


def test_failed_subtask_and_bad_planner(sess):
    register_task_type("always_fails", lambda m, c: [{"i": 1}, {"i": 2}],
                       lambda m, c: (_ for _ in ()).throw(RuntimeError("boom")))
    m = TaskManager(sess.catalog)
    tid = m.submit("always_fails", {})
    assert m.run_to_completion(tid, timeout_s=60) == "failed"
    assert "boom" in m.tasks[tid]["error"]
    bad = m.submit("import", {"db": "test", "table": "t", "path": "/no/such/file"})
    good = m.submit("analyze", {"db": "test", "table": "t", "device": "cpu"})
    assert m.run_to_completion(good, executors=2, timeout_s=60) == "succeed"
    assert m.task_state(bad) == TaskState.FAILED.value
    assert "planner" in m.tasks[bad]["error"]
    with pytest.raises(ValueError, match="unknown task type"):
        m.submit("nope", {})


def test_dead_executor_rebalance(sess, monkeypatch):
    monkeypatch.setattr(framework, "HEARTBEAT_TTL_S", 0.05)
    done = []
    register_task_type("rebal", lambda m, c: [{"i": 0}],
                       lambda m, c: (done.append(m["i"]), {"ok": 1})[1])
    m = TaskManager(sess.catalog)
    tid = m.submit("rebal", {})
    m.schedule_once()
    claimed = m.claim_subtask("dead-node")  # claims and never reports
    assert claimed is not None
    time.sleep(0.1)
    m.schedule_once()  # the heartbeat expired: back to pending
    assert m.subtasks[claimed["id"]]["state"] == SubtaskState.PENDING.value
    assert m.run_to_completion(tid, timeout_s=60) == "succeed"
    assert done == [0]
    # the late report of the superseded owner is fenced off
    m.finish_subtask(claimed["id"], {"late": 1}, executor_id="dead-node")
    assert "late" not in m.subtasks[claimed["id"]]["result"]


def test_slow_subtask_not_double_executed(sess, monkeypatch):
    monkeypatch.setattr(framework, "HEARTBEAT_TTL_S", 0.2)
    runs = []

    def slow_run(meta, catalog):
        runs.append(meta["i"])
        time.sleep(0.5)
        return {"ok": 1}

    register_task_type("slow", lambda m, c: [{"i": 0}], slow_run)
    m = TaskManager(sess.catalog)
    tid = m.submit("slow", {})
    assert m.run_to_completion(tid, executors=2, timeout_s=30) == "succeed"
    assert runs == [0]


def test_system_tables_queryable(sess):
    m = TaskManager(sess.catalog)
    tid = m.submit("analyze", {"db": "test", "table": "t", "device": "cpu"})
    assert m.run_to_completion(tid, executors=2, timeout_s=60) == "succeed"
    assert ("analyze", "succeed") in sess.execute(
        "select type, state from mysql.tidb_global_task").rows
    assert sess.execute("select count(*) from mysql.tidb_background_subtask "
                        "where state = 'succeed'").rows[0][0] >= 2


def test_index_backfill_merges_runs(sess, tmp_path):
    sess.execute("create table bf (k int, v int)")
    for lo in (300, 0, 600):
        sess.execute("insert into bf values "
                     + ", ".join(f"({(lo + i) % 701}, {i})" for i in range(250)))
    sess.execute("insert into bf values (null, 1), (null, 2)")
    m = TaskManager(sess.catalog)
    tid = m.submit("index_backfill", {"db": "test", "table": "bf", "column": "k", "index": "ik",
                                      "spill_dir": str(tmp_path)})
    assert m.run_to_completion(tid, executors=3, timeout_s=60) == "succeed"
    t = sess.catalog.table("test", "bf")
    assert t.indexes["ik"] == ["k"] and t.index_state("ik") == "public"
    assert_caches_fresh(t, "k")
    sess.execute("admin check index bf ik")
    assert sess.execute("select v from bf where k = 700").rows != []
    assert not [f for f in os.listdir(tmp_path) if f.startswith("bf_")]


def test_backfill_refusals_revert(sess, tmp_path, monkeypatch):
    sess.execute("create table bfe (a int)")
    sess.execute("create index ia on bfe (a)")
    m = TaskManager(sess.catalog)
    for meta in ({"table": "bfe", "column": "a", "index": "ia"},
                 {"table": "t", "column": "nope", "index": "ix"}):
        tid = m.submit("index_backfill", {"db": "test", "spill_dir": str(tmp_path), **meta})
        assert m.run_to_completion(tid, executors=1, timeout_s=60) in ("failed", "reverted")
    t = sess.catalog.table("test", "bfe")
    assert t.indexes["ia"] == ["a"] and t.index_state("ia") == "public"
    assert "ix" not in sess.catalog.table("test", "t").indexes

    def bad_run(meta, catalog):
        raise OSError("disk full")

    monkeypatch.setitem(framework._TASK_TYPES["index_backfill"], "runner", bad_run)
    tid = m.submit("index_backfill", {"db": "test", "table": "t", "column": "a", "index": "iz",
                                      "spill_dir": str(tmp_path)})
    assert m.run_to_completion(tid, executors=1, timeout_s=60) in ("failed", "reverted")
    t = sess.catalog.table("test", "t")
    assert "iz" not in t.indexes and "iz" not in t.index_states


def test_backfill_revert_keeps_other_tasks_runs(sess, tmp_path, monkeypatch):
    """Backfill runs carry their task's nonce: a reverting task sweeps its
    own runs and leaves another task's runs of the same column alone."""
    other = tmp_path / "bf_test_t_a_0123456789ab_1.npz"
    other.write_bytes(b"another task's run")
    real, calls = framework._TASK_TYPES["index_backfill"]["runner"], []

    def second_fails(meta, catalog):
        calls.append(1)
        if len(calls) > 1:
            raise OSError("disk full")
        return real(meta, catalog)

    monkeypatch.setitem(framework._TASK_TYPES["index_backfill"], "runner", second_fails)
    sess.execute("insert into t values (1, 'x')")  # a second block: two subtasks
    m = TaskManager(sess.catalog)
    tid = m.submit("index_backfill", {"db": "test", "table": "t", "column": "a", "index": "ia",
                                      "spill_dir": str(tmp_path)})
    assert m.run_to_completion(tid, executors=1, timeout_s=60) == "reverted"
    assert len(calls) == 2 and other.exists()
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("bf_")) == [other.name]


def test_extsort_merge_matches_lexsort():
    rng = np.random.default_rng(7)
    chunks, all_data, all_valid, off = [], [], [], 0
    for n in (17, 1, 64, 33, 0):
        data = rng.integers(0, 9, n)
        valid = rng.random(n) > 0.2
        chunks.append(extsort.sort_run(data, valid, off))
        all_data.append(data)
        all_valid.append(valid)
        off += n
    svals, rank, rows = extsort.merge_runs(chunks)
    data, valid = np.concatenate(all_data), np.concatenate(all_valid)
    ref = np.lexsort((data, np.where(valid, 0, 1)))
    assert np.array_equal(rows, ref) and np.array_equal(svals, data[ref])
    assert extsort.merge_runs([None]) is None


def test_loader_functions_match(tmp_path):
    """``parse_block`` and ``load_file`` straight, against the JAX ones."""
    from tidb_tpu.storage import loader as jloader

    js, ts = JaxSession(), Session(device="cpu")
    for s in (js, ts):
        s.execute("create table l (a int, b varchar(4), c datetime)")
    lines = ["1|x|2020-01-01 00:00:00|", "\\N||\\N", "", "3|é|1999-01-01 10:00:00\r"]
    jb = jloader.parse_block(js.catalog.table("test", "l"), lines, "|")
    tb = loader.parse_block(ts.catalog.table("test", "l"), lines, "|")
    for n in ("a", "b", "c"):
        assert np.array_equal(jb.columns[n].valid, tb.columns[n].valid)
        assert list(jb.columns[n].decode()) == list(tb.columns[n].decode())
    assert loader.parse_block(ts.catalog.table("test", "l"), ["", "\n"], "|") is None
    path = write(tmp_path / "x.tbl", "\n".join(lines) + "\n")
    assert loader.load_file(ts.catalog.table("test", "l"), path, "|") == 3
    assert loader.load_rows_python(ts.catalog.table("test", "l"), lines, "|") == 3


def test_composite_key_probe_matches_the_index(pair, tmp_path):
    """A composite key's uniqueness index (``Table._sorted_composite``):
    built by one packed int64 sort where the components' ranges fit in
    63 bits and by ``np.lexsort`` where they do not, kept by inserting
    each append's sorted keys. The same duplicates are refused as by the
    JAX package, floats by value (-0.0 is 0.0), and the index equals a
    sort of the stored keys' row views."""
    from tidb_tpu_torch.storage.table import Table

    path = write(tmp_path / "k.tsv", "1\t2\t0.5\n3\t4\t\\N\n")
    wide = write(tmp_path / "w.tsv", f"{-(1 << 62)}\t{1 << 62}\n{1 << 62}\t{-(1 << 62)}\n")
    pair.runs("create table k (a int, b int, c double, primary key (a, b))",
              "create unique index ac on k (a, c)",
              "insert into k values (1, 1, 1.5), (2, 2, -0.0), (5, 5, null)",
              "insert into k values (1, 1, 9.0)", "insert into k values (2, 9, 0.0)",
              f"load data infile '{path}' into table k", "insert into k values (5, 6, null)",
              f"load data infile '{path}' into table k", "select count(*) from k",
              "create table w (a bigint, b bigint, primary key (a, b))",
              "insert into w values (0, 0), (-5, 7)",
              f"load data infile '{wide}' into table w",
              f"load data infile '{wide}' into table w", "insert into w values (-5, 7)",
              "insert into w values (-5, 8)", "select a, b from w order by a, b")
    pair.state("k")
    pair.state("w")
    for name, cols in (("k", ("a", "b")), ("k", ("a", "c")), ("w", ("a", "b"))):
        t = pair.ts.catalog.table("test", name)
        stored = np.concatenate([Table._key_matrix(b.columns, cols) for b in t.blocks()])
        assert np.array_equal(t._sorted_composite(cols), np.sort(Table._rows_view(stored)))


def test_import_ranges_staged_by_processes(pair, tmp_path):
    """Every range is staged by one of the task's processes: the
    same rows, partition routing and index caches, and no staging
    process outlives the task."""
    import multiprocessing

    path = write(tmp_path / "p.tsv",
                 "".join(f"{i % 1000}\tk{(i * 7) % 313:03d}\t{i}\n" for i in range(1200)))
    pair.runs("create table pc (r int, s varchar(8), v int) partition by range (r) ("
              "partition p0 values less than (300), partition p1 values less than maxvalue)",
              "create unique index ic on pc (s, v)", "create index ir on pc (v)")
    run_import(pair, "pc", path, tmp_path, chunk_bytes=9000)
    assert not tasks._STAGERS and not multiprocessing.active_children()
    pair.state("pc")
    assert_caches_fresh(pair.ts.catalog.table("test", "pc"), "v", ("s", "v"))
