"""The clauses the port once parsed and then ignored (or refused without
naming them), and that it refused by name until it ported them: stale
reads (AS OF TIMESTAMP, tidb_read_staleness), max_execution_time and the
MAX_EXECUTION_TIME hint, the information_schema tables (F1, F3, F4) and
WITH RECURSIVE (F2). Each test keeps the name of the refusal it held and
now holds the port's Session against the JAX package's on the shape of
its reference test file (test_staleread.py,
test_ttl_autoinc.py::TestMaxExecutionTime, test_ddl_infoschema.py,
test_round2_features.py). The information_schema tables that stay refused
are in tests/test_torch_show_infoschema.py."""

import time

import pytest

import tidb_tpu  # noqa: F401
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu.storage import table as jax_table
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog


@pytest.fixture()
def sessions():
    js, ts = JaxSession(JaxCatalog()), Session(Catalog(), device="cpu")
    js.execute("set global tidb_gc_life_time = 600")
    for s in (js, ts):
        s.execute("create table t (a int)")
        s.execute("insert into t values (1)")
    yield js, ts
    js.execute("set global tidb_gc_life_time = 0")
    jax_table.set_gc_life(0)


def test_as_of_timestamp_is_refused(sessions):
    """F1 is ported: AS OF TIMESTAMP reads the version of its time."""
    js, ts = sessions
    time.sleep(0.02)
    mid = time.time()
    time.sleep(0.02)
    for s in (js, ts):
        s.execute("insert into t values (2)")
    for sql in (f"select count(*) from t as of timestamp {mid}",
                f"select count(*) from t as of timestamp '{mid}'"):
        assert js.execute(sql).rows == ts.execute(sql).rows == [(1,)]
    # the subquery's reference and the outer one name one table at two
    # versions: both packages refuse it rather than read one of them
    sql = f"select a from t where a in (select a from t as of timestamp {mid})"
    with pytest.raises(ValueError) as want:
        js.execute(sql)
    with pytest.raises(ValueError) as got:
        ts.execute(sql)
    assert str(got.value) == str(want.value)
    assert "mixing AS OF TIMESTAMP" in str(got.value)


def test_read_staleness_is_refused(sessions):
    """tidb_read_staleness is ported: a top-level read goes back its
    window; INSERT ... SELECT reads fresh data in both packages."""
    js, ts = sessions
    time.sleep(1.1)
    for s in (js, ts):
        s.execute("insert into t values (2)")
        s.execute("create table dst (a int)")
        s.execute("set tidb_read_staleness = -1")
    assert js.execute("select count(*) from t").rows == [(1,)]
    assert ts.execute("select count(*) from t").rows == [(1,)]
    for s in (js, ts):
        s.execute("insert into dst select a from t")
        s.execute("set tidb_read_staleness = 0")
        assert s.execute("select count(*) from dst").rows == [(2,)]
        assert s.execute("select count(*) from t").rows == [(2,)]


@pytest.mark.parametrize("sql,want", [
    ("with recursive nums(n) as (select 1 union all select n + 1 from nums where n < 10) "
     "select sum(n), count(*), max(n) from nums", [(55, 10, 10)]),
    ("with recursive sub(n) as (select a from t union all select n + 1 from sub where n < 3) "
     "select n from sub order by n", [(1,), (2,), (3,)]),
])
def test_with_recursive_is_refused(sessions, sql, want):
    """F2 is ported: the test keeps the name of the refusal it held and
    now holds the port's rows against the JAX Session's (the other
    recursive shapes: tests/test_torch_recursive_explain.py)."""
    js, ts = sessions
    assert js.execute(sql).rows == want
    assert ts.execute(sql).rows == want


def test_max_execution_time_is_refused(sessions):
    """F3 is ported: a statement within its limit runs in both packages."""
    js, ts = sessions
    hinted = "select /*+ MAX_EXECUTION_TIME(60000) */ count(*), sum(a) from t where a > 0"
    assert js.execute(hinted).rows == ts.execute(hinted).rows == [(1, 1)]
    for s in (js, ts):
        s.execute("set max_execution_time = 60000")
    for s in (js, ts):
        assert s.execute("select count(*), sum(a) from t where a > 0").rows == [(1, 1)]
        s.execute("insert into t values (3)")
        s.execute("set max_execution_time = 0")  # limit cleared: statements run
        assert s.execute("select count(*) from t").rows == [(2,)]


def test_runaway_statement_is_killed_by_the_jax_package(sessions, monkeypatch):
    """TestMaxExecutionTime.test_runaway_killed's shape: both packages
    kill a statement past its deadline with the same error. The JAX side
    slows its scan with its failpoint, the port's with a patched scan
    (failpoints are not ported)."""
    from tidb_tpu.utils import failpoint
    from tidb_tpu.utils.sqlkiller import QueryKilled as JaxKilled
    from tidb_tpu_torch.planner import physical
    from tidb_tpu_torch.utils.sqlkiller import QueryKilled

    js, ts = sessions
    for s in (js, ts):
        s.execute("set max_execution_time = 1")
    failpoint.enable("storage/scan", lambda: time.sleep(0.05))
    try:
        with pytest.raises(JaxKilled) as want:
            js.execute("select count(*), sum(a) from t where a > 1")
    finally:
        failpoint.disable("storage/scan")
    scan = physical.scan_table

    def slow(*a, **k):
        time.sleep(0.05)
        return scan(*a, **k)

    monkeypatch.setattr(physical, "scan_table", slow)
    with pytest.raises(QueryKilled) as got:
        ts.execute("select count(*), sum(a) from t where a > 1")
    assert str(got.value) == str(want.value) == "query interrupted (max_execution_time exceeded)"
    monkeypatch.setattr(physical, "scan_table", scan)
    for s in (js, ts):  # the session recovers
        s.execute("set max_execution_time = 0")
        assert s.execute("select count(*), sum(a) from t").rows == [(1, 1)]


@pytest.mark.parametrize("sql", [
    "select table_name, table_rows from information_schema.tables where table_schema = 'app'",
    "select count(*) from information_schema.schemata where schema_name = 'app'",
])
def test_information_schema_is_refused(sql):
    """F4 is ported for the tables whose sources the port has."""
    js, ts = JaxSession(JaxCatalog()), Session(Catalog(), device="cpu")
    for s in (js, ts):
        s.execute("create database app")
        s.execute("create table app.users (id bigint primary key, nm varchar(8))")
        s.execute("insert into app.users values (1, 'a'), (2, 'b')")
    want = js.execute(sql).rows
    assert want in ([("users", 2)], [(1,)])
    assert ts.execute(sql).rows == want
