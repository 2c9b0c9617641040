"""The session-state builtins in the port against the JAX package: SLEEP
(at most 300 s, cut short by KILL), the advisory locks GET_LOCK,
RELEASE_LOCK, IS_FREE_LOCK, IS_USED_LOCK and RELEASE_ALL_LOCKS (shared by
the sessions of a catalog, re-entrant, released when a session is
collected, waits ended by their timeout or a KILL), RANDOM_BYTES and
TIDB_ENCODE_SQL_DIGEST / TIDB_DECODE_SQL_DIGESTS, each folded before
planning as the JAX session folds them."""

import gc
import threading
import time

import pytest

import tidb_tpu  # noqa: F401
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog

from _torch_parity import one_thread, WritePair  # noqa: F401 (one_thread)

#: ROADMAP queue 1 item 1's oracle statements (RANDOM_BYTES' byte length
#: varies with its bytes, so the statement bounds it)
ORACLE = [
    "select sleep(0)", "select get_lock('x', 1)", "select is_free_lock('a')",
    "select release_all_locks()", "select length(random_bytes(4)) between 4 and 8",
    "select char_length(random_bytes(4))", "select tidb_encode_sql_digest('select 1')",
]


def _pairs():
    jcat, tcat = JaxCatalog(), Catalog()
    return (WritePair(JaxSession(jcat), Session(tcat, device="cpu")),
            WritePair(JaxSession(jcat), Session(tcat, device="cpu")))


@pytest.mark.parametrize("sql", ORACLE)
def test_oracle_statements_match_jax(sql):
    a, _b = _pairs()
    a.run(sql)


def test_locks_across_two_sessions_match_jax():
    a, b = _pairs()
    a.runs("select get_lock('x', 1)", "select get_lock('x', 0)", "select is_used_lock('x')")
    b.runs("select get_lock('x', 0)", "select is_free_lock('x')", "select is_used_lock('x')",
           "select release_lock('x')", "select release_lock('never')",
           "select get_lock('y', 0), get_lock('y', 0)", "select release_all_locks()")
    a.runs("select release_lock('x')", "select is_free_lock('x')", "select release_lock('x')",
           "select release_lock('x')", "select get_lock('y', 0)")
    b.runs("select get_lock('x', 0)", "select is_used_lock('x')", "select release_all_locks()",
           "select is_free_lock('x'), is_free_lock('y')")


def test_random_bytes_and_digests_match_jax():
    a, _b = _pairs()
    a.runs("select random_bytes(0)", "select random_bytes(1025)",
           "select char_length(random_bytes(1024))",
           "select tidb_encode_sql_digest('select  1 '), tidb_encode_sql_digest(null)",
           "select 1", "select tidb_decode_sql_digests('not json')",
           "select tidb_decode_sql_digests(concat('[', ']'))")
    (d,) = a.ts.execute("select tidb_encode_sql_digest('select 42')").rows[0]
    a.run(f"select tidb_decode_sql_digests('[\"{d}\", \"nope\"]')")
    r = a.ts.execute("select random_bytes(8) = random_bytes(8)").rows
    assert r in ([(0,)], [(1,)])


def test_a_collected_session_releases_its_locks():
    for cat, make in ((JaxCatalog(), JaxSession),
                      (Catalog(), lambda c: Session(c, device="cpu"))):
        s, other = make(cat), make(cat)
        assert s.execute("select get_lock('held', 0)").rows == [(1,)]
        assert other.execute("select is_free_lock('held')").rows == [(0,)]
        del s
        gc.collect()
        assert other.execute("select is_free_lock('held')").rows == [(1,)]


def _killed(run, kill):
    """Start `run` on a thread, KILL it after 0.3 s; (seconds from the
    KILL to the statement's end, its error)."""
    done = {}

    def body():
        try:
            run()
            done["error"] = None
        except Exception as e:
            done["error"] = e
        done["t"] = time.perf_counter()

    th = threading.Thread(target=body)
    th.start()
    time.sleep(0.3)
    t0 = time.perf_counter()
    kill()
    th.join(timeout=10)
    assert not th.is_alive()
    return done["t"] - t0, done["error"]


def test_sleep_and_lock_waits_end_at_a_kill():
    """SLEEP(5) and a GET_LOCK wait of 5 s each stop within half a second
    of a KILL QUERY from another session; a wait ends at its timeout."""
    cat = Catalog()
    a, b = Session(cat, device="cpu"), Session(cat, device="cpu")
    assert a.execute("select sleep(-1), sleep(0.05)").rows == [(0, 0)]
    stop, err = _killed(lambda: b.execute("select sleep(5)"),
                        lambda: a.execute(f"kill query {b.conn_id}"))
    assert err is not None and stop < 0.5, (stop, err)
    assert a.execute("select get_lock('w', 0)").rows == [(1,)]
    t0 = time.perf_counter()
    assert b.execute("select get_lock('w', 0.2)").rows == [(0,)]
    assert 0.15 < time.perf_counter() - t0 < 2
    stop, err = _killed(lambda: b.execute("select get_lock('w', 5)"),
                        lambda: a.execute(f"kill query {b.conn_id}"))
    assert err is not None and stop < 0.5, (stop, err)
    assert b.execute("select sleep(0)").rows == [(0,)]  # the session lives on


def _both_catalogs():
    return ((JaxCatalog(), JaxSession),
            (Catalog(), lambda c: Session(c, device="cpu")))


def test_a_contended_get_lock_succeeds_when_its_holder_releases():
    """Session A holds 'x'; B's GET_LOCK('x', 5) waits, and A's
    RELEASE_LOCK 0.2 s later gives it the lock within half a second, in
    both packages: the port's wait lets the statement lock go."""
    got = []
    for cat, make in _both_catalogs():
        a, b = make(cat), make(cat)
        assert a.execute("select get_lock('x', 0)").rows == [(1,)]
        done = {}

        def body():
            done["rows"] = b.execute("select get_lock('x', 5)").rows
            done["t"] = time.perf_counter()

        th = threading.Thread(target=body)
        th.start()
        time.sleep(0.2)
        t0 = time.perf_counter()
        assert a.execute("select release_lock('x')").rows == [(1,)]
        th.join(timeout=10)
        assert not th.is_alive()
        assert done["t"] - t0 < 0.5, done
        assert a.execute("select is_used_lock('x')").rows == [(b.conn_id,)]
        got.append(done["rows"])
    assert got == [[(1,)], [(1,)]]


def test_other_sessions_run_while_a_sleep_waits():
    """While B's SLEEP(2) runs, A's SELECT over a table ends within a
    second, in both packages, with the same rows."""
    got = []
    for cat, make in _both_catalogs():
        a, b = make(cat), make(cat)
        a.execute("create table t (k int primary key, v int)")
        a.execute("insert into t values (1, 10), (2, 20), (3, 30)")
        a.execute("select sum(v) from t")  # planned once, outside the timing
        th = threading.Thread(target=lambda: b.execute("select sleep(2)"))
        th.start()
        time.sleep(0.2)
        t0 = time.perf_counter()
        rows = a.execute("select sum(v), count(*) from t where k > 1").rows
        took = time.perf_counter() - t0
        assert th.is_alive(), "the SLEEP ended before the SELECT"
        th.join(timeout=10)
        assert took < 1.0, took
        got.append([tuple(int(x) for x in r) for r in rows])
    assert got[0] == got[1] == [(50, 2)]
