"""Resource groups, PLAN REPLAYER and /metrics in the port against the
JAX package: resource-group DDL, information_schema.resource_groups and
the errors (tests/test_governance.py::TestResourceGroups), the RU
throttle (its wait is unbilled, a KILL ends it, and it holds no lock
another connection needs), the replayer zip's members, and the families
the port's /metrics serves, each under the JAX package's name and kind."""

import re
import threading
import time
import urllib.request
import zipfile

import tidb_tpu  # noqa: F401
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu_torch.server import Server
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog
from tidb_tpu_torch.utils.sqlkiller import QueryKilled

from _torch_parity import one_thread, WritePair  # noqa: F401 (one_thread)

ROOT = __file__.rsplit("/tests/", 1)[0]


def _pair():
    return WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))


def test_resource_group_ddl_rows_and_errors_match_jax():
    p = _pair()
    p.runs(
        "create resource group rg1 ru_per_sec = 1000",
        "create resource group rg2 ru_per_sec = 50 burstable",
        "create resource group rg1 ru_per_sec = 1",
        "create resource group if not exists rg1 ru_per_sec = 1",
        "select name, ru_per_sec, burstable, queries from information_schema.resource_groups "
        "order by name",
        "alter resource group rg1 ru_per_sec = 2000",
        "alter resource group rg2 burstable = false",
        "alter resource group nope ru_per_sec = 5",
        "create resource group z ru_per_sec = 0",
        "drop resource group rg2",
        "drop resource group rg2",
        "drop resource group if exists rg2",
        "drop resource group default",
        "set resource group nope",
        "select name, ru_per_sec, burstable from information_schema.resource_groups order by name",
    )


def test_bound_group_dropped_runs_unthrottled_as_jax():
    p = _pair()
    p.runs("create resource group g1 ru_per_sec = 100", "set resource group g1",
           "drop resource group g1", "select 1", "set resource group default",
           "select name, queries from information_schema.resource_groups")


def test_throttle_waits_unbilled_and_counts():
    s = Session(Catalog(), device="cpu")
    s.execute("create table t (a int)")
    s.execute("insert into t values (1)")
    s.execute("select * from t")
    s.execute("create resource group slow ru_per_sec = 1000")
    s.execute("set resource group slow")
    s.execute("select * from t")
    g = s.catalog.resource_groups.get("slow")
    # overdraw the bucket: a 2 s statement's 2,000 RU against 1,000 RU/s
    s.catalog.resource_groups.debit("slow", elapsed_s=2.0)
    ru0, t0 = g.consumed_ru, time.monotonic()
    s.execute("select * from t")
    waited = time.monotonic() - t0
    assert 0.2 < waited < 20, waited
    # the ~1 s wait is not billed: the statement's own milliseconds are
    assert g.consumed_ru - ru0 < 100, g.consumed_ru - ru0
    rows = s.execute("select consumed_ru, queries from information_schema.resource_groups "
                     "where name = 'slow'").rows
    assert rows[0][0] > 2000 and rows[0][1] == 4


def test_burstable_group_never_waits():
    s = Session(Catalog(), device="cpu")
    s.execute("create resource group b ru_per_sec = 1 burstable")
    s.execute("set resource group b")
    s.catalog.resource_groups.debit("b", elapsed_s=60.0)
    t0 = time.monotonic()
    for _ in range(5):
        s.execute("select 1")
    assert time.monotonic() - t0 < 1.0


def test_throttled_session_holds_no_lock_and_a_kill_ends_its_wait():
    """The RU wait comes before the table locks and outside the device's
    statement lock, with the killer armed: another connection's write to
    the same table runs meanwhile, and a KILL ends the wait."""
    cat = Catalog()
    a, b = Session(cat, device="cpu"), Session(cat, device="cpu")
    a.execute("create table t (a int primary key)")
    a.execute("insert into t values (1)")
    a.execute("create resource group slow ru_per_sec = 1")
    a.execute("set resource group slow")
    cat.resource_groups.debit("slow", elapsed_s=3600.0)
    errors = []

    def run():
        try:
            a.execute("insert into t values (2)")
        except Exception as e:  # noqa: BLE001 - the test reads it
            errors.append(e)

    th = threading.Thread(target=run, name="mysql-throttled")
    th.start()
    time.sleep(0.2)
    t0 = time.perf_counter()
    b.execute("insert into t values (3)")
    assert b.execute("select count(*) from t").rows == [(2,)]
    assert time.perf_counter() - t0 < 1.0
    assert [r[0] for r in b.execute("show processlist").rows].count(a.conn_id) == 1
    b.execute(f"kill query {a.conn_id}")
    th.join(timeout=10)
    assert not th.is_alive() and len(errors) == 1 and isinstance(errors[0], QueryKilled)
    assert b.execute("select a from t order by a").rows == [(1,), (3,)]


def test_plan_replayer_members_match_jax(tmp_path, monkeypatch):
    got = []
    for name, sess in (("jax", JaxSession(JaxCatalog())), ("port", Session(Catalog(), device="cpu"))):
        monkeypatch.setenv("TIDB_TPU_PLAN_REPLAYER_DIR", str(tmp_path / name))
        for q in ("create database d", "use d", "create table t (a int, b int)",
                  "create table u (b int primary key, c varchar(8))",
                  "insert into t values (1, 2), (3, 4), (5, null)",
                  "insert into u values (2, 'x'), (4, 'y')", "analyze table t", "analyze table u",
                  "create binding for select a from t where b > 1 using "
                  "select /*+ stream_rows(10) */ a from t where b > 1"):
            sess.execute(q)
        fn = sess.execute("plan replayer dump explain select a, c from t, u "
                          "where t.b = u.b and a > 1").rows[0][0]
        assert fn.startswith(str(tmp_path / name)) and fn.endswith(".zip")
        with zipfile.ZipFile(fn) as z:
            import json

            st = {m: json.loads(z.read(m)) for m in z.namelist() if m.startswith("stats/")}
            got.append((sorted(z.namelist()), z.read("sql/sql0.sql"),
                        {m: {c: v["row_count"] for c, v in cols.items()} for m, cols in st.items()},
                        len(z.read("explain.txt").splitlines()) > 0))
    assert got[0] == got[1], got
    assert got[1][2]["stats/d.t.json"]["a"] == 3


def test_metrics_endpoint_serves_the_jax_families():
    """Every family the port's /metrics serves is one the JAX package
    registers (a literal name in its source), with the same kind; and the
    statement counters move by the statements run."""
    import pathlib

    kinds = {}
    for path in pathlib.Path(ROOT, "tidb_tpu").rglob("*.py"):
        for kind, name in re.findall(
                r"(?:REGISTRY|_REG)\s*\.\s*(counter|gauge|histogram)\(\s*[\"']([^\"']+)",
                path.read_text()):
            kinds[name] = kind
    srv = Server(Catalog(), port=0, device="cpu", status_port=0)
    th = srv.start_background()
    try:
        s = Session(srv.catalog, device="cpu")
        s.execute("create table m (a int)")

        def scrape():
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.status_server.port}/metrics", timeout=30) as r:
                return r.read().decode()

        def stmts(text):
            return float(re.search(r"^tidbtpu_session_statements_total (\S+)$", text,
                                   re.M).group(1))

        before = stmts(scrape())
        for q in ("insert into m values (1), (2)", "select sum(a) from m", "select sum(a) from m"):
            s.execute(q)
        text = scrape()
        fams = dict(ln.split()[2:4] for ln in text.splitlines() if ln.startswith("# TYPE "))
        assert {f: k for f, k in fams.items() if kinds.get(f) != k} == {}
        assert stmts(text) == before + 3
        for f in ("tidbtpu_session_query_duration_seconds", "tidbtpu_flight_query_seconds"):
            counts = [int(v) for v in re.findall(rf"^{f}_bucket\S* (\d+)$", text, re.M)]
            assert counts == sorted(counts) and counts[-1] > 0, f
        rows = dict((n, v) for n, _k, v in s.execute(
            "select name, kind, value from information_schema.metrics").rows)
        assert rows["tidbtpu_executor_plan_cache_hits_total"] >= 1
    finally:
        srv.shutdown()
        th.join(timeout=10)
