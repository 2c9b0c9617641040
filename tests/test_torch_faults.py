"""The clauses the port parsed and then ignored (or refused without naming
them), now refused by name until a later slice ports them: stale reads
(AS OF TIMESTAMP, tidb_read_staleness), max_execution_time and the
MAX_EXECUTION_TIME hint, and the information_schema tables. For each, the
JAX package's Session answers the shape of its reference test file
(test_staleread.py, test_ttl_autoinc.py::TestMaxExecutionTime,
test_ddl_infoschema.py) and the port's raises ``NotImplementedError``
naming the construct. WITH RECURSIVE (test_round2_features.py) is ported:
its shapes here give the JAX package's rows in the port. Setting either
variable succeeds in the port, and a statement the JAX package does not
apply the clause to runs."""

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
    js, ts = sessions
    time.sleep(0.02)
    mid = time.time()
    time.sleep(0.02)
    for s in (js, ts):
        s.execute("insert into t values (2)")
    assert js.execute(f"select count(*) from t as of timestamp {mid}").rows == [(1,)]
    with pytest.raises(NotImplementedError, match="AS OF TIMESTAMP is not ported"):
        ts.execute(f"select count(*) from t as of timestamp {mid}")
    with pytest.raises(NotImplementedError, match="AS OF TIMESTAMP is not ported"):
        ts.execute(f"select a from t where a in (select a from t as of timestamp {mid})")


def test_read_staleness_is_refused(sessions):
    js, ts = sessions
    time.sleep(1.1)
    for s in (js, ts):
        s.execute("insert into t values (2)")
        s.execute("create table dst (a int)")
        s.execute("set tidb_read_staleness = -1")
    assert js.execute("select count(*) from t").rows == [(1,)]
    with pytest.raises(NotImplementedError, match="tidb_read_staleness"):
        ts.execute("select count(*) from t")
    # the SELECT half of INSERT ... SELECT reads fresh data in the JAX
    # package: no staleness to ignore, so the port runs it
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
    js, ts = sessions
    hinted = "select /*+ MAX_EXECUTION_TIME(60000) */ count(*), sum(a) from t where a > 0"
    assert js.execute(hinted).rows == [(1, 1)]
    with pytest.raises(NotImplementedError, match="MAX_EXECUTION_TIME hint is not ported"):
        ts.execute(hinted)
    for s in (js, ts):
        s.execute("set max_execution_time = 60000")
    assert js.execute("select count(*), sum(a) from t where a > 0").rows == [(1, 1)]
    for sql in ("select count(*), sum(a) from t where a > 0", "insert into t values (3)"):
        with pytest.raises(NotImplementedError, match="max_execution_time is not ported"):
            ts.execute(sql)
    for s in (js, ts):
        s.execute("set max_execution_time = 0")  # limit cleared: statements run
        assert s.execute("select count(*) from t").rows == [(1,)]


def test_runaway_statement_is_killed_by_the_jax_package(sessions):
    """TestMaxExecutionTime.test_runaway_killed's shape: the JAX package
    kills a statement past its deadline; the port refuses to run it at
    all rather than run it unbounded."""
    from tidb_tpu.utils import failpoint
    from tidb_tpu.utils.sqlkiller import QueryKilled

    js, ts = sessions
    for s in (js, ts):
        s.execute("set max_execution_time = 1")
    failpoint.enable("storage/scan", lambda: time.sleep(0.05))
    try:
        with pytest.raises(QueryKilled):
            js.execute("select count(*), sum(a) from t where a > 1")
    finally:
        failpoint.disable("storage/scan")
    with pytest.raises(NotImplementedError, match="max_execution_time"):
        ts.execute("select count(*), sum(a) from t where a > 1")


@pytest.mark.parametrize("sql", [
    "select table_name, table_rows from information_schema.tables where table_schema = 'app'",
    "select count(*) from information_schema.schemata where schema_name = 'app'",
])
def test_information_schema_is_refused(sql):
    js, ts = JaxSession(JaxCatalog()), Session(Catalog(), device="cpu")
    for s in (js, ts):
        s.execute("create database app")
        s.execute("create table app.users (id bigint primary key, nm varchar(8))")
        s.execute("insert into app.users values (1, 'a'), (2, 'b')")
    assert js.execute(sql).rows in ([("users", 2)], [(1,)])
    with pytest.raises(NotImplementedError, match="information_schema tables are not ported"):
        ts.execute(sql)
