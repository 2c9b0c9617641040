"""The statement's record in the port against the JAX package: the
metrics registry (render, rows, label errors: tests/test_observability.py
:85-170), statements_summary (digests, exec counts, rows sent, the IN
list's collapse), slow_query under slow_query_log,
tidb_slow_log_threshold and tidb_record_plan_in_slow_log and its file
sink, the flight recorder's phases and its discard on error, the engine
watch (tests/test_engine_watch.py's behaviour) and TRACE's rows. Both
Sessions take the same statements over the same tiny TPC-H tables; each
package reads its own stores, which the tests reset first. A separate
test holds the digest built from the parse's tokens equal to
``sql_digest`` of the text."""

import pytest

import tidb_tpu  # noqa: F401
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu.utils import metrics as jm
from tidb_tpu_torch.obs.engine_watch import ENGINE_WATCH
from tidb_tpu_torch.obs.flight import FLIGHT
from tidb_tpu_torch.parser import parse_tokens
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog
from tidb_tpu_torch.utils import metrics as tm

from _torch_parity import one_thread, port_catalog  # noqa: F401 (one_thread)

TABLES = ["lineitem", "orders", "customer", "supplier", "nation", "region"]


@pytest.fixture(scope="module")
def cats():
    from tidb_tpu.bench import load_tpch as jax_load_tpch

    jcat = JaxCatalog()
    jax_load_tpch(jcat, sf=0.002, seed=1, tables=TABLES)
    return jcat, port_catalog(jcat, "tpch", TABLES)


def _sessions(cats):
    """A fresh Session of each package over the shared tables, with both
    packages' stores reset."""
    jcat, tcat = cats
    for m in (jm, tm):
        m.STMT_SUMMARY.reset()
        m.STMT_HISTORY.reset()
        m.SLOW_LOG._buf.clear()
    FLIGHT.reset()
    ENGINE_WATCH.reset()
    return JaxSession(jcat, db="tpch"), Session(tcat, db="tpch", device="cpu")


def _both(sessions, sqls):
    for s in sessions:
        for q in sqls:
            s.execute(q)


# -- the registry ------------------------------------------------------------------


def _registry_ops(m):
    """The same operations on a fresh registry of package `m`: its
    render, its rows, and the error texts of its refused uses."""
    reg = m.Registry()
    g = reg.gauge("tidbtpu_test_pool_size", "g")
    g.set(5)
    g.inc(2)
    g.dec(3)
    g.set_max(2)
    g.set_max(9)
    c = reg.counter("tidbtpu_test_dispatches", "d", labels=("host",))
    c.labels(host="h1").inc()
    c.labels(host="h1").inc()
    c.labels(host='we"ird\\h\nx').inc()
    h = reg.histogram("tidbtpu_test_lat_seconds", "h", labels=("op",))
    for v in (0.003, 0.004, 5.0, 50.0):
        h.labels(op="scan").observe(v)
    reg.histogram("tidbtpu_test_h", "h").observe(0.5)
    b = reg.counter("tidbtpu_test_bytes", "b")
    b.inc(10_737_418_240)
    b.inc(65_536)
    reg.counter("tidbtpu_test_frac", "f").inc(0.25)
    errors = []
    for bad in (lambda: c.labels(host="h1", port=8080), lambda: c.labels(),
                lambda: c.labels("a", host="b"), lambda: reg.gauge("tidbtpu_test_bytes"),
                lambda: reg.counter("tidbtpu_test_bytes", labels=("x",))):
        with pytest.raises(ValueError) as e:
            bad()
        errors.append(str(e.value))
    return reg.render(), reg.rows(), m.sample_rows(reg), errors, g.value


def test_registry_render_rows_and_errors_match_jax():
    got, want = _registry_ops(tm), _registry_ops(jm)
    assert got == want
    text = got[0]
    assert 'tidbtpu_test_dispatches{host="we\\"ird\\\\h\\nx"} 1' in text
    assert 'tidbtpu_test_lat_seconds_bucket{op="scan",le="0.005"} 2' in text
    assert 'tidbtpu_test_lat_seconds_bucket{op="scan",le="+Inf"} 4' in text
    assert "tidbtpu_test_bytes 10737483776" in text and got[4] == 9.0


def test_streaming_quantiles_match_jax():
    import random

    rnd = random.Random(7)
    vals = [rnd.uniform(0.0005, 15.0) for _ in range(300)]
    out = []
    for m in (tm, jm):
        h = m.StreamingHistogram("t")
        empty = h.quantile(0.5)
        for v in vals:
            h.observe(v)
        out.append((empty, [h.quantile(q) for q in (0.0, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0)]))
    assert out[0] == out[1] and out[0][1] == sorted(out[0][1])


# -- statements_summary ------------------------------------------------------------

SUMMARY_SQLS = [
    "select count(*) from nation where n_regionkey in (1)",
    "select count(*) from nation where n_regionkey in (1, 2)",
    "select count(*) from nation where n_regionkey in (1, 2, 3)",
    "select n_name from nation where n_nationkey < 5 order by n_name",
    "select n_name from nation where n_nationkey < 7 order by n_name",
    "select /*+ stream_rows(100) */ count(*) from orders where o_totalprice > 1000",
    "select count(*) from orders where o_totalprice > 2000;",
    "select o_orderstatus, count(*) from orders group by o_orderstatus",
]


def test_statements_summary_matches_jax(cats):
    sessions = _sessions(cats)
    _both(sessions, SUMMARY_SQLS)
    q = ("select digest_text, exec_count, rows_sent from information_schema.statements_summary "
         "where digest_text like '%from nation%' or digest_text like '%from orders%' "
         "order by digest_text")
    got = [s.execute(q).rows for s in sessions]
    assert got[0] == got[1], got
    digests = {r[0]: r[1] for r in got[1]}
    # one IN-list digest for three lengths; hints and ';' do not fork
    assert digests["select count ( * ) from nation where n_regionkey in ( ... )"] == 3
    assert digests["select count ( * ) from orders where o_totalprice > ?"] == 2


def test_summary_phases_percentiles_and_decode(cats):
    js, ts = _sessions(cats)
    sql = "select sum(l_quantity) from lineitem where l_discount > 0.02"
    for _ in range(3):
        ts.execute(sql)
    ent = next(e for e in tm.STMT_SUMMARY.rows_full() if e["digest_text"] == tm.sql_digest(sql))
    assert ent["exec_count"] == 3 and ent["rows_sent"] == 3
    assert 0 < ent["p50_latency"] <= ent["p95_latency"] <= ent["p99_latency"]
    assert ent["plan_cache_hits"] == 2 and ent["plan_cache_misses"] == 1
    assert ent["jit_compilations"] == 1 and ent["plan_digest"]
    mean = {p: v[0] / 3 for p, v in ent["phases"].items()}
    assert set(mean) == {"parse", "plan", "compile", "execute", "final-merge"}, mean
    assert sum(mean.values()) <= ent["sum_latency"] / 3
    (d,) = ts.execute(f"select tidb_encode_sql_digest('{sql}')").rows[0]
    js.execute(sql)
    for s in (js, ts):
        assert s.execute(f"select tidb_decode_sql_digests('[\"{d}\"]')").rows == [
            (f'["{tm.sql_digest(sql)}"]',)]


# -- slow_query -------------------------------------------------------------------


def test_slow_query_under_the_three_sysvars_matches_jax(cats):
    sessions = _sessions(cats)
    _both(sessions, [
        "set tidb_slow_log_threshold = 0",
        "select count(*) from region where r_regionkey > 0",
        "set slow_query_log = 0",
        "select count(*) from region where r_regionkey > 1",
        "set slow_query_log = 1",
        "set tidb_record_plan_in_slow_log = 0",
        "select count(*) from region where r_regionkey > 2",
        "set tidb_record_plan_in_slow_log = 1",
        "explain analyze select count(*) from region where r_regionkey > 3",
        "set tidb_slow_log_threshold = 2000000",
        "select count(*) from region where r_regionkey > 4",
    ])
    q = ("select query, digest, conn_id, plan = '' from information_schema.slow_query "
         "where query like '%from region%' order by time")
    got = [s.execute(q).rows for s in sessions]
    assert got[0] == got[1], got
    assert [r[0][-1] for r in got[1]] == ["0", "2", "3"] and [r[3] for r in got[1]] == [0, 1, 0]
    phases, plan = sessions[1].execute(
        "select phases, plan from information_schema.slow_query "
        "where query like '%r_regionkey > 0'").rows[0]
    assert "parse=" in phases and "plan=" in phases and "execute=" in phases
    assert "table=tpch.region" in plan
    (plan,) = sessions[1].execute("select plan from information_schema.slow_query "
                                  "where query like 'explain analyze%'").rows[0]
    assert "Aggregate" in plan and "time=" in plan


def test_slow_query_file_sink_matches_jax(cats, tmp_path):
    sessions = _sessions(cats)
    texts = []
    for s, name in zip(sessions, ("jax", "port")):
        (tmp_path / name).mkdir()
        path = tmp_path / name / "slow.log"
        for q in ("set tidb_slow_log_threshold = 0", f"set tidb_slow_query_file = '{path}'",
                  "select count(*) from nation where n_nationkey > 3",
                  "select n_name from nation where n_nationkey = 7"):
            s.execute(q)
        texts.append(path.read_text())
    shapes = [[ln.split(":")[0] if ln.startswith("#") else ln.replace(n, "")
               for ln in t.splitlines()] for t, n in zip(texts, ("jax", "port"))]
    assert shapes[0] == shapes[1], texts
    assert "select count(*) from nation where n_nationkey > 3;" in texts[1]
    assert "# Phases" in shapes[1] and "# Plan" in shapes[1]


# -- the flight recorder ----------------------------------------------------------


def test_flight_phases_cold_and_warm_match_jax(cats):
    sessions = _sessions(cats)
    sql = "select c_mktsegment, count(*) from customer group by c_mktsegment"
    got = []
    for s, rows in ((sessions[0], jm_flights), (sessions[1], FLIGHT.rows)):
        s.execute(sql)
        s.execute(sql)
        cold, warm = [r for r in rows() if r["sql"] == sql][-2:]
        got.append((sorted(cold["phases"]), sorted(warm["phases"]), cold["rows_sent"]))
    assert got[0] == got[1], got
    assert "compile" in got[1][0] and "compile" not in got[1][1]


def jm_flights():
    from tidb_tpu.obs.flight import FLIGHT as JF

    return JF.rows()


def test_error_path_discards_the_flight_and_counts(cats):
    _js, ts = _sessions(cats)
    errors = tm.REGISTRY.counter("tidbtpu_session_statement_errors_total")
    before, n = errors.value, len(FLIGHT.rows())
    with pytest.raises(ValueError):
        ts.execute("select * from no_such_table_obs")
    assert FLIGHT.current() is None and ENGINE_WATCH.current() is None
    assert len(FLIGHT.rows()) == n and errors.value == before + 1
    assert not [e for e in tm.STMT_SUMMARY.rows() if "no_such_table_obs" in e[0]]
    with pytest.raises(ValueError, match="undeclared flight phase"):
        FLIGHT.note_phase("".join(["par", "sing"]), 0.1)


# -- the engine watch -------------------------------------------------------------


def _counter(name):
    return tm.REGISTRY.counter(name).value


def test_engine_watch_builds_retraces_and_bytes():
    """tests/test_engine_watch.py's behaviour: a build counted, a warm
    repeat adds none, growth past the tile adds a retrace; h2d and d2h
    bytes agree with ``chunk.TRANSFERS``."""
    from tidb_tpu_torch.chunk import TRANSFERS

    s = Session(Catalog(), device="cpu")
    s.execute("create table ew (a bigint)")
    s.execute("insert into ew values " + ",".join(f"({i})" for i in range(10)))
    b0 = _counter("tidbtpu_engine_jit_compilations")
    s.execute("select sum(a) from ew where a > 1")
    assert _counter("tidbtpu_engine_jit_compilations") == b0 + 1
    s.execute("select sum(a) from ew where a > 1")
    assert _counter("tidbtpu_engine_jit_compilations") == b0 + 1
    r0 = _counter("tidbtpu_engine_retraces")
    for lo in range(0, 9000, 1000):
        s.execute("insert into ew values " + ",".join(f"({i})" for i in range(lo, lo + 1000)))
    h0 = TRANSFERS["h2d_bytes"]
    assert s.execute("select sum(a) from ew where a > 1").rows == [
        (sum(range(2, 10)) + sum(range(2, 9000)),)]
    assert _counter("tidbtpu_engine_retraces") > r0
    rec = ENGINE_WATCH.rows()[-1]
    assert rec[1] == "select sum(a) from ew where a > 1" and rec[2] == 1 and rec[3] >= 1
    assert rec[4] == TRANSFERS["h2d_bytes"] - h0 > 0 and rec[6] > 0 and rec[8:] == (0.0,) * 3
    assert tm.REGISTRY.gauge("tidbtpu_engine_device_mem_highwater_bytes").value >= rec[6]
    r = s.execute("select query, jit_compilations, h2d_bytes, device_mem_peak_bytes "
                  "from information_schema.tpu_engine where query like '%from ew where%'").rows
    assert r[-1] == rec[1:3] + (rec[4], rec[6])


def test_tpu_engine_columns_match_jax():
    got = []
    for s in (JaxSession(JaxCatalog()), Session(Catalog(), device="cpu")):
        s.execute("create table ew4 (a bigint)")
        s.execute("insert into ew4 values (41), (42)")
        s.execute("select max(a) from ew4 where a > 40")
        r = s.execute("select * from information_schema.tpu_engine where query like '%ew4 where%'")
        got.append((r.columns, [row[1] for row in r.rows], r.rows[-1][2] >= 1))
    assert got[0] == got[1]


# -- TRACE ------------------------------------------------------------------------


def test_trace_rows_match_jax(cats):
    sessions = _sessions(cats)
    sql = ("trace select n_name, count(*) from nation, region where n_regionkey = r_regionkey "
           "group by n_name")
    got = []
    for s in sessions:
        s.execute(sql[len("trace "):])  # planned once: the TRACE is warm
        r = s.execute(sql)
        got.append((r.columns, [row[0] for row in r.rows]))
        spans = s.tracer.totals_by_name()
        assert spans["session.plan"] + spans["executor.run"] <= spans["execute"]
    assert got[0] == got[1], got
    assert got[1][1] == ["execute", "  session.plan", "  executor.run", "  session.materialize"]


# -- the digest from the parse's tokens -------------------------------------------


def _digest_cases():
    from tidb_tpu_torch.bench.oracles import Q1_SQL, Q3_SQL, Q5_SQL, Q6_SQL, TPCH_QUERIES, spec_params

    cases = [Q1_SQL, Q3_SQL, Q5_SQL, Q6_SQL]
    cases += [q.sql.format(**spec_params(n, 10.0)) for n, q in sorted(TPCH_QUERIES.items())]
    cases += [
        "insert into lineitem values " + ", ".join(
            f"({i}, {i % 7}, 3, 1, 17.00, 2.5e3, 0.04, 0.02, 'N', 'O', '1996-03-13', "
            f"'1996-02-12', '1996-03-22', 'DELIVER IN PERSON', 'TRUCK')" for i in range(1000)),
        "select /*+ stream_rows(10) */ count(*) from t where a > 1",
        "select count(*) /* a comment */ from t -- trailing\nwhere a > 1",
        "select * from t where a in (1, 2, 3) and b not in ('x', 'y') and c in (select c from u)",
        "select * from t where a in (1, b) and s = 'it''s' and e = 'a\\'b\\n'",
        "select count(*) from t where a > 1;",
        "update t set a = a + 1 where b = 'x'",
    ]
    return cases


def test_digest_from_tokens_equals_sql_digest():
    """Every case: the digest made from the tokens the parse read equals
    ``sql_digest`` of the text, in the port and in the JAX package."""
    for sql in _digest_cases():
        _stmts, toks = parse_tokens(sql)
        d = tm.digest_tokens(toks)
        assert d == tm.sql_digest(sql) == jm.sql_digest(sql), sql[:80]


def test_session_digest_of_a_batch_and_a_hint_match_jax(cats):
    sessions = _sessions(cats)
    _both(sessions, ["select count(*) from region; select count(*) from nation",
                     "select /*+ stream_rows(5) */ count(*) from region where r_regionkey > 1"])
    q = ("select digest_text, exec_count from information_schema.statements_summary "
         "where digest_text = 'select' or digest_text like '%region where%' "
         "order by digest_text")
    got = [s.execute(q).rows for s in sessions]
    assert got[0] == got[1] == [("select", 2), (
        "select count ( * ) from region where r_regionkey > ?", 1)], got
