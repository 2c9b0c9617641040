"""Stale reads in the port against the JAX package: ``tidb_snapshot``,
AS OF TIMESTAMP, ``tidb_read_staleness`` and ``tidb_gc_life_time``
retention, with the refusals inside a transaction and in DML, prepared
``AS OF TIMESTAMP ?`` and the session time zone (the shapes of
tests/test_staleread.py). Every statement runs through both Sessions,
each over its own catalog (``WritePair``): rows, affected counts and
errors must be equal."""

import datetime
import time

import pytest

import tidb_tpu  # noqa: F401
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu.storage import table as jax_table
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog
from tidb_tpu_torch.storage import table as port_table

from _torch_parity import WritePair


def _pair(gc_life=None):
    pair = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    if gc_life is not None:
        pair.run(f"set global tidb_gc_life_time = {gc_life}")
    return pair


@pytest.fixture()
def pair():
    p = _pair(600)
    yield p
    p.run("set global tidb_gc_life_time = 0")
    jax_table.set_gc_life(0)
    port_table.set_gc_life(0)


def _mid(pair, before, after):
    """Run `before`, take a timestamp between two short sleeps, run
    `after`; returns the timestamp."""
    pair.runs(*before)
    time.sleep(0.02)
    ts = time.time()
    time.sleep(0.02)
    pair.runs(*after)
    return ts


def test_tidb_snapshot_reads_the_snapshot_and_refuses_writes():
    """The port once ignored tidb_snapshot: it read the current rows
    (3, 6) and took the write. Both now read the snapshot, refuse the
    write, and read current rows once it is cleared. No GC life is set:
    the snapshot is the version before the current one, which is kept."""
    p = _pair()
    ts = _mid(p, ["create table t (a int primary key, b int)", "insert into t values (1,1),(2,2)"],
              ["insert into t values (3,3)"])
    p.run(f"set tidb_snapshot = '{ts}'")
    assert p.run("select count(*), sum(b) from t").rows == [(2, 3)]
    err = p.run("insert into t values (4,4)")
    assert str(err) == "can not execute write statement when 'tidb_snapshot' is set"
    p.run("delete from t where a = 1")  # refused too
    p.run("set tidb_snapshot = ''")
    assert p.run("select count(*), sum(b) from t").rows == [(3, 6)]


def test_as_of_timestamp_reads_history(pair):
    ts = _mid(pair, ["create table t (a int)", "insert into t values (1)"],
              ["insert into t values (2)"])
    assert pair.run(f"select count(*) from t as of timestamp {ts}").rows == [(1,)]
    pair.runs(
        f"select a from t as of timestamp {ts} order by a",
        f"select count(*) from t as of timestamp '{ts}'",
        "select count(*) from t",
        "select * from t as of timestamp 1.0",  # before the table: refused
        # one table at two versions in one statement: refused
        f"select count(*) from t as of timestamp {ts} where a in (select a from t)",
        f"select count(*) from t as of timestamp {ts} "
        f"where a in (select a from t as of timestamp {ts + 0.01})",
    )


def test_stale_reads_are_refused_in_a_transaction_and_in_dml(pair):
    ts = _mid(pair, ["create table t (a int)", "create table dst (a int)",
                     "insert into t values (1)"], ["insert into t values (2)"])
    pair.runs(
        f"insert into dst select a from t as of timestamp {ts}",
        "begin",
        f"select * from t as of timestamp {ts}",
        "rollback",
        f"set tidb_snapshot = '{ts}'",
        "begin",
        "select count(*) from t",  # tidb_snapshot does not apply in a txn
        "rollback",
        "set tidb_snapshot = ''",
        "select count(*) from dst",
    )


def test_read_staleness_goes_back_its_window_and_clamps_young_tables(pair):
    pair.runs("create table t (a int)", "create table dst (a int)",
              "insert into t values (1)")
    time.sleep(1.1)
    pair.runs(
        "insert into t values (2)",
        "create table fresh (a int)",
        "insert into fresh values (1)",
        "set tidb_read_staleness = -1",
        "select count(*) from t",  # now - 1 s predates the second insert
        # INSERT ... SELECT reads fresh data
        "insert into dst select a from t",
        "set tidb_read_staleness = -3600",
        # younger than the window: its oldest retained state, no error
        "select count(*) from fresh",
        # information_schema is never stale
        "select table_name from information_schema.tables where table_name = 'fresh'",
        "set tidb_read_staleness = 0",
        "select count(*) from dst",
        "select count(*) from t",
    )
    assert pair.run("select count(*) from dst").rows == [(2,)]


def test_gc_life_time_bounds_what_a_stale_read_reaches():
    """With no GC life only the current version and the one before it
    survive a write; with one, every version inside it does."""
    p = _pair(0)
    try:
        ts = _mid(p, ["create table t (a int)", "insert into t values (1)"],
                  ["insert into t values (2)", "insert into t values (3)"])
        err = p.run(f"select count(*) from t as of timestamp {ts}")
        assert "older than the GC safepoint" in str(err)
        p.run("set global tidb_gc_life_time = 600")
        ts = _mid(p, ["insert into t values (4)"],
                  ["insert into t values (5)", "insert into t values (6)"])
        assert p.run(f"select count(*) from t as of timestamp {ts}").rows == [(4,)]
        assert port_table.GC_LIFE_S == 600.0
    finally:
        p.run("set global tidb_gc_life_time = 0")
        jax_table.set_gc_life(0)
        port_table.set_gc_life(0)


def test_prepared_as_of_timestamp(pair):
    """EXECUTE is a top-level read: its AS OF resolves history. The port
    binds and replans every EXECUTE, so a new value reads a new version."""
    ts1 = _mid(pair, ["create table t (a int)", "insert into t values (1)"],
               ["insert into t values (2)"])
    ts2 = _mid(pair, [], ["insert into t values (3)"])
    pair.runs(
        f"prepare lit from 'select count(*) from t as of timestamp {ts1}'",
        "execute lit", "execute lit",
        "prepare p from 'select count(*) from t as of timestamp ?'",
        f"set @a = {ts1}", f"set @b = {ts2}",
    )
    assert pair.run("execute p using @a").rows == [(1,)]
    assert pair.run("execute p using @b").rows == [(2,)]
    assert pair.run("execute p using @a").rows == [(1,)]
    pair.runs(
        f"prepare w from 'insert into t select a from t as of timestamp {ts1}'",
        "execute w",  # AS OF in a DML: refused
        "select count(*) from t",
    )
    # the port's API binds the same way
    assert pair.ts.execute_prepared("p", [ts2]).rows == [(2,)]


def test_prepared_read_staleness_applies(pair):
    pair.runs("create table t (a int)", "insert into t values (1)")
    tabs = [pair.js.catalog.table("test", "t"), pair.ts.catalog.table("test", "t")]
    old = [t.version for t in tabs]
    pair.run("insert into t values (2)")
    # backdate every version up to the first insert, so that now - 60 s
    # resolves to it whatever the host's speed
    for t, v0 in zip(tabs, old):
        for v in list(t.version_ts):
            if v <= v0:
                t.version_ts[v] = time.time() - 120
        assert t.version_at(time.time() - 60, clamp_oldest=True) == v0
    pair.runs("prepare p from 'select count(*) from t'", "set tidb_read_staleness = -60")
    assert pair.run("execute p").rows == [(1,)]
    pair.run("set tidb_read_staleness = 0")
    assert pair.run("execute p").rows == [(2,)]


@pytest.mark.parametrize("zone,hours", [("+02:00", 2), ("-05:30", -5.5), ("UTC", 0)])
def test_naive_literals_use_the_session_time_zone(pair, zone, hours):
    ts = _mid(pair, ["create table t (a int)", "insert into t values (1)"],
              ["insert into t values (2)"])
    lit = datetime.datetime.fromtimestamp(
        ts, datetime.timezone(datetime.timedelta(hours=hours))
    ).replace(tzinfo=None).isoformat()
    pair.run(f"set time_zone = '{zone}'")
    assert pair.run(f"select count(*) from t as of timestamp '{lit}'").rows == [(1,)]
    pair.run(f"set tidb_snapshot = '{lit}'")
    assert pair.run("select count(*) from t").rows == [(1,)]
    pair.runs("set tidb_snapshot = ''", "set time_zone = 'UTC'")


def test_an_unknown_time_zone_raises(pair):
    pair.runs("create table t (a int)", "insert into t values (1)",
              "set time_zone = 'No/Such_Zone'")
    err = pair.run("select * from t as of timestamp '2026-01-01 00:00:00'")
    assert "time zone" in str(err)
    pair.run("set time_zone = 'UTC'")
