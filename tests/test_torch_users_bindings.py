"""Users, grants and SQL bindings in the port against the JAX package:
CREATE/DROP USER, GRANT/REVOKE and SHOW GRANTS with their effect on reads
and writes, a password login through the port's server (byte for byte
against the JAX server), bindings that match a statement with other
literals and their refusals, and the STREAM_ROWS hint, which sends a read
down the streamed path (the shapes of tests/test_privilege.py and
test_hints_bindings.py)."""

import pytest

import tidb_tpu  # noqa: F401
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog

from _torch_parity import WritePair, port_catalog, same_rows

SF = 0.002
TABLES = ["orders", "lineitem", "customer", "region"]
Q_AGG = ("select l_returnflag, count(*), sum(l_quantity) from lineitem "
         "where l_quantity > {q} group by l_returnflag")
HINT = "/*+ STREAM_ROWS(3000) */"


@pytest.fixture(scope="module")
def both():
    from tidb_tpu.bench import load_tpch as jax_load_tpch

    jcat = JaxCatalog()
    jax_load_tpch(jcat, sf=SF, seed=9, tables=TABLES)
    return JaxSession(jcat, db="tpch"), Session(port_catalog(jcat, "tpch", TABLES), db="tpch",
                                                device="cpu")


def _as(pair, user):
    return WritePair(JaxSession(pair.js.catalog, db=pair.js.db, user=user),
                     Session(pair.ts.catalog, db=pair.ts.db, device="cpu", user=user))


def test_users_grants_and_their_effect():
    root = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    root.runs("create table t (a int primary key, b int)", "insert into t values (1, 10)",
              "create table s (a int)",
              "create user u1 identified by 'pw'", "create user u1", "create user if not exists u1",
              "show grants for u1")
    u1 = _as(root, "u1")
    u1.runs("select count(*) from t", "show grants", "show grants for root",
            "create user u2", "insert into t values (2, 20)")
    root.run("grant select on test.* to u1")
    u1.runs("select count(*), sum(b) from t", "insert into t values (2, 20)",
            "show grants", "show columns from t", "show create table t", "show index from t",
            # reading another table inside a write needs SELECT on it
            "insert into s select a from t")
    root.runs("grant insert on test.s to u1", "grant bogus on test.* to u1", "show grants for u1")
    u1.runs("insert into s select a from t", "select count(*) from s",
            "delete from s", "drop table s")
    root.runs("revoke select on test.* from u1", "show grants for u1",
              "grant all on test.t to u1", "revoke update on test.t from u1", "show grants for u1")
    u1.runs("select count(*) from s", "select count(*) from t", "update t set b = 0",
            "delete from t where a = 99")
    root.runs("drop user u1", "show grants for u1", "drop user u1", "drop user if exists u1",
              "drop user root", "revoke select on test.* from nobody")


def test_a_created_user_logs_in_through_the_server():
    """CREATE USER, GRANT, REVOKE and DROP USER over the wire, and a login
    with the password: every response equal to the JAX server's."""
    from tidb_tpu.server import Server as JaxServer
    from tidb_tpu_torch.server import Server

    from test_torch_server import Wire, same_response

    jcat = JaxCatalog()
    tcat = Catalog()
    js, ts = JaxServer(jcat, port=0), Server(tcat, port=0, device="cpu")
    js.start_background()
    ts.start_background()
    try:
        jr, tr = Wire(js.port), Wire(ts.port)
        for sql in ("create database app", "create table app.r (r_id int primary key, r_name "
                    "varchar(10))", "insert into app.r values (1, 'asia'), (2, 'europe')",
                    "create user analyst identified by 'secret'",
                    "grant select on app.* to analyst"):
            same_response(jr.query(sql), tr.query(sql))

        def login(**kw):
            jc, tc = Wire(js.port, **kw), Wire(ts.port, **kw)
            assert jc.auth_reply == tc.auth_reply, kw
            return jc, tc

        jc, tc = login(user="analyst", password="secret", db="app")
        assert tc.auth_reply[0] == 0x00
        for sql in ("select r_name from app.r order by r_id", "show grants",
                    "insert into app.r values (3, 'africa')", "show grants for root"):
            same_response(jc.query(sql), tc.query(sql))
        jw, tw = login(user="analyst", password="wrong")
        assert tw.auth_reply[0] == 0xFF
        for sql in ("revoke select on app.* from analyst", "show grants for analyst"):
            same_response(jr.query(sql), tr.query(sql))
        same_response(jc.query("select count(*) from app.r"), tc.query("select count(*) from app.r"))
        same_response(jr.query("drop user analyst"), tr.query("drop user analyst"))
        jg, tg = login(user="analyst", password="secret")
        assert tg.auth_reply[0] == 0xFF
        assert int.from_bytes(tg.auth_reply[1:3], "little") == 1045
        for c in (jr, tr, jc, tc):
            c.close()
    finally:
        js.shutdown()
        ts.shutdown()


def test_a_binding_matches_other_literals_and_streams(both):
    js, ts = both
    pair = WritePair(js, ts)
    base = Q_AGG.format(q=10)
    pair.runs(f"create binding for {base} using {base.replace('select ', 'select ' + HINT + ' ', 1)}",
              "show bindings")
    # other literals, other spacing: the same digest
    for q in (10, 30):
        sql = "  " + Q_AGG.format(q=q).replace(" from ", "  from ")
        want = js.execute(sql).rows
        got = ts.execute(sql).rows
        assert same_rows(got, want, False), (got, want)
        (rec,) = ts.executor.stream_log
        assert rec["path"] == "streamed" and rec["chunks"] > 1, rec
    # inside a batch of statements no text is the statement's own: no match
    ts.execute(f"select 1; {Q_AGG.format(q=10)}")
    assert ts.executor.stream_log == []
    pair.runs(f"drop binding for {base}", "show bindings")
    assert same_rows(ts.execute(base).rows, js.execute(base).rows, False)
    assert ts.executor.stream_log == []


def test_binding_refusals(both):
    js, ts = both
    pair = WritePair(js, ts)
    base = Q_AGG.format(q=10)
    pair.runs(
        f"create binding for {base} using {base}",  # no hints
        # not a plain SELECT
        "create binding for select 1 union select 2 using select /*+ STREAM_ROWS(1) */ 1 "
        "union select 2",
        "show bindings",
    )
    pair.run(f"create binding for {base} using {base.replace('select ', 'select ' + HINT + ' ', 1)}")
    for cat in (js.catalog, ts.catalog):
        cat.users.create_user("nosuper")
    other = _as(pair, "nosuper")
    other.runs(f"drop binding for {base}", "show bindings")
    pair.runs(f"drop binding for {base}", "show bindings")


def test_the_stream_rows_hint_streams_with_equal_rows(both):
    js, ts = both
    for sql, ordered, hint in (
            (Q_AGG.format(q=5), False, HINT),
            ("select o_orderpriority, count(*) from orders group by o_orderpriority "
             "order by o_orderpriority", True, "/*+ STREAM_ROWS(1000) */")):
        hinted = sql.replace("select ", f"select {hint} ", 1)
        want = js.execute(hinted).rows
        got = ts.execute(hinted).rows
        assert same_rows(got, want, ordered), (got, want)
        log = ts.executor.stream_log
        assert log and log[0]["path"] == "streamed" and log[0]["chunks"] > 1, log
        # the hint is the statement's: the next read is unpaged
        assert same_rows(ts.execute(sql).rows, want, ordered)
        assert ts.executor.stream_log == [] and ts.executor.stream_rows == -1
