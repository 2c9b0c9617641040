"""Stopping a statement in the port against the JAX package:
``max_execution_time`` and the MAX_EXECUTION_TIME hint, KILL QUERY and
KILL CONNECTION from another session and thread, KILL of an unknown id,
SHOW PROCESSLIST, and a killed session's next statement (the shapes of
tests/test_governance.py and test_ttl_autoinc.py::TestMaxExecutionTime).
Failpoints are not ported: the JAX side holds a statement with its
failpoints, the port's side with a patched scan. Every wait has a
timeout, so a hang fails the test instead of the run."""

import threading
import time

import pytest

import tidb_tpu  # noqa: F401
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu.utils import failpoint
from tidb_tpu.utils.sqlkiller import QueryKilled as JaxKilled
from tidb_tpu_torch.bench.oracles import TPCH_QUERIES
from tidb_tpu_torch.planner import physical
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.session.session import statement_lock
from tidb_tpu_torch.storage import Catalog
from tidb_tpu_torch.utils.sqlkiller import QueryKilled

from _torch_parity import port_catalog, same_rows

SF = 0.002
TABLES = ["orders", "lineitem", "customer"]
Q18 = TPCH_QUERIES["q18"].sql.format(**TPCH_QUERIES["q18"].test_params)
#: Q18 streamed in chunks of 3,000 lineitem rows (about 4 at this sf)
Q18_STREAMED = Q18.replace("select ", "select /*+ STREAM_ROWS(3000) */ ", 1)
#: one aggregate per test, each new to the JAX package's plan cache: a
#: warm plan there skips the discovery safepoint its failpoints hold
AGGS = {k: f"select {k}, count(*), sum(l_quantity) from lineitem group by {k}"
        for k in ("l_returnflag", "l_linestatus", "l_shipmode", "l_shipinstruct")}
WAIT_S = 60


@pytest.fixture(scope="module")
def both():
    from tidb_tpu.bench import load_tpch as jax_load_tpch

    jcat = JaxCatalog()
    jax_load_tpch(jcat, sf=SF, seed=3, tables=TABLES)
    js = JaxSession(jcat, db="tpch")
    ts = Session(port_catalog(jcat, "tpch", TABLES), db="tpch", device="cpu")
    return js, ts


def _slow_scan(monkeypatch, seconds=0.05):
    scan = physical.scan_table

    def slow(*a, **k):
        time.sleep(seconds)
        return scan(*a, **k)

    monkeypatch.setattr(physical, "scan_table", slow)


def _same_error(js_call, ts_call):
    with pytest.raises(JaxKilled) as want:
        js_call()
    with pytest.raises(QueryKilled) as got:
        ts_call()
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_max_execution_time_and_its_hint(both, monkeypatch):
    js, ts = both
    agg, hinted = AGGS["l_returnflag"], AGGS["l_linestatus"]
    hinted = hinted.replace("select ", "select /*+ MAX_EXECUTION_TIME(1) */ ", 1)
    failpoint.enable("executor/before-discover", lambda: time.sleep(0.05))
    _slow_scan(monkeypatch)
    try:
        for s in (js, ts):
            s.execute("set max_execution_time = 1")
        msg = _same_error(lambda: js.execute(agg), lambda: ts.execute(agg))
        assert msg == "query interrupted (max_execution_time exceeded)"
        for s in (js, ts):
            s.execute("set max_execution_time = 0")
        assert _same_error(lambda: js.execute(hinted), lambda: ts.execute(hinted)) == msg
        # a generous limit lets the statement finish
        roomy = hinted.replace("(1)", "(60000)")
        assert same_rows(ts.execute(roomy).rows, js.execute(roomy).rows, False)
    finally:
        failpoint.disable("executor/before-discover")
        for s in (js, ts):
            s.execute("set max_execution_time = 0")
    monkeypatch.undo()
    # the deadline was the statement's: the next one runs unbounded
    assert same_rows(ts.execute(agg).rows, js.execute(agg).rows, False)


def test_kill_query_returns_while_the_target_holds_the_statement_lock(both, monkeypatch):
    js, ts = both
    agg = AGGS["l_shipmode"]
    other = Session(ts.catalog, db="tpch", device="cpu")
    jother = JaxSession(js.catalog, db="tpch")

    # the JAX package: the other session kills at the statement's
    # discovery safepoint (tests/test_governance.py's shape)
    failpoint.enable("executor/before-discover",
                     lambda: jother.execute(f"kill query {js.conn_id}"))
    try:
        with pytest.raises(JaxKilled) as want:
            js.execute(agg)
    finally:
        failpoint.disable("executor/before-discover")

    # the port: a thread runs the statement, held inside its scan (under
    # the statement lock) until the other session's KILL has returned
    in_scan, go = threading.Event(), threading.Event()
    scan = physical.scan_table

    def held(*a, **k):
        in_scan.set()
        assert go.wait(WAIT_S)
        return scan(*a, **k)

    monkeypatch.setattr(physical, "scan_table", held)
    ts.executor._cache.clear()
    out = {}

    def run():
        try:
            out["rows"] = ts.execute(agg).rows
        except Exception as e:  # the test reads it below
            out["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        assert in_scan.wait(WAIT_S)
        lock = statement_lock(ts.device)
        assert not lock.acquire(blocking=False)  # the target holds it
        rows = {r[0]: r for r in other.execute("show processlist").rows}
        assert rows[ts.conn_id][3:6:2] == ("Query", agg), rows[ts.conn_id]
        assert rows[other.conn_id][5] == "show processlist"
        other.execute(f"kill query {ts.conn_id}")
        assert th.is_alive()  # KILL returned before the statement ended
    finally:
        go.set()
        th.join(WAIT_S)
    assert not th.is_alive()
    assert isinstance(out.get("error"), QueryKilled), out
    assert str(out["error"]) == str(want.value) == "query interrupted (killed)"
    monkeypatch.undo()
    # the killed session recovers, and nothing of the statement stays
    assert lock.acquire(blocking=False)
    lock.release()
    assert ts._current_stmt is None and ts._txn is None
    assert same_rows(ts.execute(agg).rows, js.execute(agg).rows, False)


def test_kill_connection_and_unknown_ids():
    """Sessions made in the same order get the same ids in both packages,
    so the errors' texts are equal."""
    from _torch_parity import WritePair

    jcat, tcat = JaxCatalog(), Catalog()
    sess = [(JaxSession(jcat), Session(tcat, device="cpu")) for _ in range(3)]
    assert [j.conn_id for j, _t in sess] == [t.conn_id for _j, t in sess]
    (j1, t1), (j2, t2), (j3, t3) = sess
    p1 = WritePair(j1, t1)
    p1.runs(f"kill connection {t2.conn_id}", "kill 999999", "kill query 999999",
            f"kill query {t3.conn_id}")
    for p in (WritePair(j2, t2), WritePair(j3, t3)):
        p.run("select 1")
    with pytest.raises(ConnectionError, match=f"connection {t2.conn_id} was killed"):
        t2.execute("select 1")
    # KILL QUERY does not close: the session keeps working
    assert t3.execute("select 1").rows == [(1,)]


def test_show_processlist():
    jcat, tcat = JaxCatalog(), Catalog()
    j1, t1 = JaxSession(jcat), Session(tcat, device="cpu")
    j2, t2 = JaxSession(jcat), Session(tcat, device="cpu")
    for s in (j2, t2):
        s.execute("create database d2")
        s.execute("use d2")
    want = j1.execute("show processlist")
    got = t1.execute("show processlist")
    assert got.columns == want.columns
    assert got.rows == want.rows, (got.rows, want.rows)
    by_id = {r[0]: r for r in got.rows}
    assert by_id[t1.conn_id][3] == "Query" and by_id[t2.conn_id][3:] == ("Sleep", 0, None)
    assert by_id[t2.conn_id][2] == "d2"


def test_a_killed_streamed_statement_leaves_nothing_behind(both):
    """A kill at a streamed chunk's safepoint: the statement raises, and
    its session's next statement streams again with the JAX package's
    rows. No lock, pin or processlist entry stays."""
    js, ts = both
    want = js.execute(Q18_STREAMED).rows
    check, calls = ts.killer.check, []

    def kill_at_the_second_chunk():
        calls.append(1)
        if len(calls) == 3:  # the run's first check, then one per chunk
            ts.killer.kill()
        check()

    ts.executor.kill_check = kill_at_the_second_chunk
    try:
        with pytest.raises(QueryKilled, match="killed"):
            ts.execute(Q18_STREAMED)
    finally:
        ts.executor.kill_check = check
    assert [r["path"] for r in ts.executor.stream_log] == ["streamed"]
    assert "chunks" not in ts.executor.stream_log[0]  # stopped inside its chunks
    assert ts._current_stmt is None and ts._txn is None
    assert not any(t._pins for t in (ts.catalog.table("tpch", n) for n in TABLES))
    for _ in range(2):
        got = ts.execute(Q18_STREAMED).rows
        assert same_rows(got, want, True), (got[:3], want[:3])
        log = ts.executor.stream_log
        assert log and log[0]["path"] == "streamed" and log[0]["chunks"] > 1, log
