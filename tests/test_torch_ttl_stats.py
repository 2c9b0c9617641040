"""The port's TTL tables and background workers against the JAX package.

Shapes: tests/test_ttl_autoinc.py's TTL cases (:53-79) and its
concurrent-insert race (:145), SHOW CREATE TABLE's TTL clause,
tests/test_cbo.py's ``StatsHandle`` and disable-sysvar case (:205-222),
and the server starting and stopping both workers. The persistence
round trip (:81) waits for the port's persistence. Every thread join has
a timeout.
"""

import threading

import numpy as np
import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu.stats.handle import StatsHandle as JaxStatsHandle
from tidb_tpu.utils.ttl import TTLWorker as JaxTTLWorker, expire_table as jax_expire_table
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.stats.handle import StatsHandle
from tidb_tpu_torch.storage import scan
from tidb_tpu_torch.utils.ttl import TTLWorker, expire_table

from _torch_parity import one_thread, WritePair  # noqa: F401 (one_thread)

#: 2024-06-01 00:00 UTC: a fixed "now" for both packages' sweeps
NOW = 1717200000.0


@pytest.fixture()
def pair():
    return WritePair(JaxSession(), Session(device="cpu"))


def test_expire_datetime_and_date(pair):
    pair.runs("create table ev (id int, ts datetime) ttl = ts + interval 1 day",
              "insert into ev values (1,'2020-01-01 00:00:00'),(2,'2999-01-01 00:00:00'),(3,null),"
              "(4,'2024-05-30 23:59:59'),(5,'2024-05-31 00:00:01')",
              "create table ed (id int, d date) ttl = d + interval 1 week",
              "insert into ed values (1,'2000-01-01'),(2,'2999-01-01'),(3,'2024-05-25')",
              "create table em (id int, d date) ttl = d + interval 2 month",
              "insert into em values (1,'2024-04-01'),(2,'2024-04-03')",
              "create table keep (id int)", "insert into keep values (1)")
    jw, tw = JaxTTLWorker(pair.js.catalog), TTLWorker(pair.ts.catalog, device="cpu")
    assert jw.tick(now_unix=NOW) == tw.tick(now_unix=NOW) == 4
    for name in ("ev", "ed", "em", "keep"):
        pair.state(name)
    assert jw.tick(now_unix=NOW) == tw.tick(now_unix=NOW) == 0
    pair.runs("select id from ev order by id", "select id from ed order by id",
              "select id from em order by id")


def test_purge_keeps_partition_tags_and_drops_the_tables_cache(pair):
    pair.runs("create table pe (id int, d date) partition by hash (id) partitions 3 "
              "ttl = d + interval 10 day",
              "insert into pe values " + ", ".join(
                  f"({i}, '2024-0{1 + i % 5}-1{i % 10}')" for i in range(40)),
              "select count(*) from pe")
    t = pair.ts.catalog.table("test", "pe")
    assert scan.cached_versions().get(t.uid)
    assert jax_expire_table(pair.js.catalog.table("test", "pe"), NOW) == \
        expire_table(t, NOW, device="cpu") > 0
    pair.state("pe")
    assert [b.part_id for b in t.blocks()] == \
        [b.part_id for b in pair.js.catalog.table("test", "pe").blocks()]
    assert not scan.cached_versions().get(t.uid)  # only its old version went
    pair.runs("select count(*) from pe", "admin check table pe")


def test_ttl_ddl_errors_and_show_create(pair):
    pair.runs("create table bad (id int) ttl = id + interval 1 day",
              "create table bad2 (d date) ttl = d + interval 1 year",
              "create temporary table tmp (d date) ttl = d + interval 1 day",
              "create table ok (id int, d datetime) ttl = d + interval 3 hour",
              "show create table ok", "create table ok2 like ok", "show create table ok2",
              "create temporary table tmp2 like ok")
    assert pair.ts.catalog.table("test", "ok").ttl == ("d", 3, "hour")
    assert pair.ts.catalog.table("test", "ok2").ttl == ("d", 3, "hour")


def test_ttl_in_a_transaction_shadow(pair):
    pair.runs("create table ev (id int, ts datetime) ttl = ts + interval 1 day", "begin",
              "insert into ev values (1, '2020-01-01 00:00:00')", "commit")
    assert pair.ts.catalog.table("test", "ev").ttl == ("ts", 1, "day")
    pair.ts.execute("begin")
    pair.ts.execute("insert into ev values (2, '2021-01-01 00:00:00')")
    assert pair.ts._txn["shadows"][("test", "ev")].ttl == ("ts", 1, "day")
    pair.ts.execute("rollback")


def test_ttl_concurrent_insert_race():
    """A sweep racing an inserter loses no inserted row."""
    s = Session(device="cpu")
    s.execute("create table ev (id int, ts datetime) ttl = ts + interval 1 day")
    t = s.catalog.table("test", "ev")
    stop, n = threading.Event(), [0]

    def inserter():
        s2 = Session(s.catalog, device="cpu")
        while not stop.is_set():
            s2.execute(f"insert into ev values ({n[0]}, '2999-01-01 00:00:00')")
            n[0] += 1

    th = threading.Thread(target=inserter)
    th.start()
    try:
        for _ in range(25):
            expire_table(t, device="cpu")
    finally:
        stop.set()
        th.join(timeout=30)
    assert not th.is_alive()
    assert s.execute("select count(*) from ev").rows == [(n[0],)]


def test_stats_handle_honours_the_sysvars(pair):
    """tests/test_cbo.py :205-222: the worker ticks nothing while auto-
    analyze is off globally, then analyzes what the JAX worker does."""
    pair.runs("set global tidb_enable_auto_analyze = 0", "create table aa (a int)",
              "insert into aa values " + ",".join(f"({i})" for i in range(100)),
              "create table small (a int)", "insert into small values (1)")
    jh, th = JaxStatsHandle(pair.js.catalog), StatsHandle(pair.ts.catalog, device="cpu")
    assert not pair.ts.catalog.table("test", "aa").stats
    assert jh.tick() == th.tick() == 0
    pair.run("set global tidb_enable_auto_analyze = 1")
    assert jh.tick() == th.tick() == 1
    t = pair.ts.catalog.table("test", "aa")
    got = dict(t.stats)
    pair.ts.execute("analyze table aa")
    assert got["a"].ndv == t.stats["a"].ndv == 100
    assert np.array_equal(got["a"].bounds, t.stats["a"].bounds)
    assert jh.tick() == th.tick() == 0
    # a committed transaction's rows: no statement-boundary analyze ran
    pair.runs("set global tidb_auto_analyze_ratio = 0.001", "begin",
              "insert into aa values (7)", "commit")
    assert jh.tick() == th.tick() == 1


def test_a_failing_table_does_not_stop_either_sweep(monkeypatch):
    """One table whose ANALYZE or purge raises is logged and skipped: the
    tick goes on to the other tables, and the loop goes on ticking (as
    the JAX package's ticks catch each table's exception)."""
    from tidb_tpu_torch.stats import handle
    from tidb_tpu_torch.storage.table import Table

    s = Session(device="cpu")
    for name in ("a1", "a2"):
        s.execute(f"create table {name} (id int, ts datetime) ttl = ts + interval 1 day")
        s.execute(f"insert into {name} values " + ",".join(
            f"({i}, '{2000 + i % 2}-01-01 00:00:00')" for i in range(100)))
        t = s.catalog.table("test", name)
        t.stats, t.analyzed_modify = {}, 0  # as if the statements' own analyze had not run
    real_analyze, real_purge = handle.analyze_table, Table.purge_expired

    def analyze(t, **kw):
        if t.name == "a1":
            raise MemoryError("out of device memory")
        return real_analyze(t, **kw)

    def purge(t, col, cutoff):
        if t.name == "a1":
            raise RuntimeError("column dropped")
        return real_purge(t, col, cutoff)

    monkeypatch.setattr(handle, "analyze_table", analyze)
    monkeypatch.setattr(Table, "purge_expired", purge)
    h = StatsHandle(s.catalog, interval_s=0.01, device="cpu")
    w = TTLWorker(s.catalog, interval_s=0.01, device="cpu")
    assert h.tick() == 1 and w.tick(NOW) == 100
    assert s.catalog.table("test", "a2").stats and not s.catalog.table("test", "a1").stats
    s.execute("insert into a2 values " + ",".join(f"({i}, null)" for i in range(100)))
    h.start()
    w.start()
    try:
        t2 = s.catalog.table("test", "a2")
        for _ in range(500):
            if t2.analyzed_modify == t2.modify_count:
                break
            threading.Event().wait(0.01)
        assert t2.analyzed_modify == t2.modify_count
        assert h._thread.is_alive() and w._thread.is_alive()
    finally:
        h.stop()
        w.stop()
    assert s.execute("select count(*) from a1").rows == [(100,)]


def test_workers_start_stop_and_run_in_the_background():
    s = Session(device="cpu")
    s.execute("create table ev (id int, ts datetime) ttl = ts + interval 1 day")
    s.execute("insert into ev values (1, '2000-01-01 00:00:00'), (2, '2999-01-01 00:00:00')")
    s.execute("create table aa (a int)")
    s.execute("insert into aa values " + ",".join(f"({i})" for i in range(100)))
    w, h = TTLWorker(s.catalog, interval_s=0.02, device="cpu"), \
        StatsHandle(s.catalog, interval_s=0.02, device="cpu")
    w.start()
    h.start()
    try:
        t = s.catalog.table("test", "aa")
        for _ in range(500):
            if t.stats and s.catalog.table("test", "ev").nrows == 1:
                break
            threading.Event().wait(0.01)
    finally:
        w.stop()
        h.stop()
    assert w._thread is None and h._thread is None
    assert t.stats and s.execute("select id from ev").rows == [(2,)]


def test_server_starts_and_stops_both_workers():
    from tidb_tpu_torch.server import Server

    srv = Server(port=0, device="cpu")
    assert srv.stats_handle.interval_s == 30.0 and srv.ttl_worker.interval_s == 60.0
    th = srv.start_background()
    try:
        for _ in range(500):
            if srv.stats_handle._thread is not None and srv.ttl_worker._thread is not None:
                break
            threading.Event().wait(0.01)
        workers = [srv.stats_handle._thread, srv.ttl_worker._thread]
        assert all(x is not None and x.is_alive() for x in workers)
    finally:
        srv.shutdown()
        th.join(timeout=10)
    assert not th.is_alive()
    assert srv.stats_handle._thread is None and srv.ttl_worker._thread is None
    assert not any(x.is_alive() for x in workers)


def test_workers_refuse_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTLWorker(Session(device="cpu").catalog)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StatsHandle(Session(device="cpu").catalog)
