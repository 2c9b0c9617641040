"""The port's lock-order checker (utils/racecheck.py).

The detector's core cases of tests/test_race.py (:32-300) on the port's
checker and lock classes; a static check that the port builds every
mutex through the checker's factories under a declared class and names
every thread it starts with a declared prefix; and a port server under
the checker (two connections, the TTL and auto-analyze workers, the
instance watchdog and a DXF ``analyze`` task) with no inversion. Every
join has a timeout.
"""

import ast
import pathlib
import threading
import time

import pytest

from tidb_tpu_torch.utils import racecheck
from tidb_tpu_torch.utils.racecheck import LockOrderError, TrackedLock

from _torch_parity import one_thread  # noqa: F401

PORT = pathlib.Path(__file__).resolve().parent.parent / "tidb_tpu_torch"


@pytest.fixture()
def racecheck_on():
    racecheck.enable()
    racecheck.reset()
    try:
        yield
    finally:
        racecheck.disable()
        racecheck.reset()


def test_inversion_detected(racecheck_on):
    a, b = TrackedLock("A"), TrackedLock("B")
    with a:
        with b:
            pass
    with pytest.raises(LockOrderError, match="inversion"):
        with b:
            with a:
                pass


def test_three_cycle_detected(racecheck_on):
    a, b, c = TrackedLock("A"), TrackedLock("B"), TrackedLock("C")
    with a, b:
        pass
    with b, c:
        pass
    with pytest.raises(LockOrderError, match="inversion"):
        with c:
            with a:
                pass


def test_consistent_order_is_silent(racecheck_on):
    a, b, c = TrackedLock("A"), TrackedLock("B"), TrackedLock("C")
    for _ in range(3):
        with a, b, c:
            pass
    assert racecheck.edge_graph()["A"] == {"B", "C"}


def test_self_deadlock_detected(racecheck_on):
    a, a2 = TrackedLock("A"), TrackedLock("A")
    with pytest.raises(LockOrderError, match="self-deadlock"):
        with a:
            with a2:
                pass


def test_cross_thread_inversion(racecheck_on):
    a, b = TrackedLock("A"), TrackedLock("B")
    t = threading.Thread(target=lambda: a.acquire() and b.acquire(), name="mysql-test")
    t.start()
    t.join(timeout=10)
    b._lk.release()
    a._lk.release()
    errs = []

    def inverted():
        try:
            with b:
                with a:
                    pass
        except LockOrderError as e:
            errs.append(e)

    t2 = threading.Thread(target=inverted, name="mysql-test")
    t2.start()
    t2.join(timeout=10)
    assert errs, "cross-thread inversion must be detected"


def test_disabled_returns_plain_primitives():
    racecheck.disable()
    assert isinstance(racecheck.make_lock("table"), type(threading.Lock()))
    assert isinstance(racecheck.make_rlock("session.statement"), type(threading.RLock()))
    assert isinstance(racecheck.make_condition("storage.txn_wait"), threading.Condition)


def test_undeclared_class_rejected():
    racecheck.disable()
    for make in (racecheck.make_lock, racecheck.make_rlock, racecheck.make_condition):
        with pytest.raises(ValueError, match="undeclared lock class"):
            make("no-such-class")


def test_rlock_reentry_and_same_class_instances(racecheck_on):
    lk = racecheck.make_rlock("session.statement")
    with lk:
        with lk:  # the same instance: legal
            pass
    lk2 = racecheck.make_rlock("session.statement")
    with pytest.raises(LockOrderError, match="self-deadlock"):
        with lk:
            with lk2:
                pass


def test_rlock_and_condition_inversions(racecheck_on):
    st = racecheck.make_rlock("session.statement")
    tb = racecheck.make_lock("table")
    with st:
        with tb:
            pass
    with pytest.raises(LockOrderError, match="inversion"):
        with tb:
            with st:
                pass
    cv = racecheck.make_condition("storage.txn_wait")
    with cv:
        with tb:
            pass
    with pytest.raises(LockOrderError, match="inversion"):
        with tb:
            with cv:
                pass


def test_condition_wait_notify_roundtrip(racecheck_on):
    cv = racecheck.make_condition("session.user_locks")
    hits = []

    def consumer():
        with cv:
            while not hits:
                cv.wait(0.5)
            hits.append("consumed")

    t = threading.Thread(target=consumer, daemon=True, name="mysql-test")
    t.start()
    time.sleep(0.05)
    with cv:
        hits.append("produced")
        cv.notify_all()
    t.join(timeout=5)
    assert hits == ["produced", "consumed"]


def test_statement_lock_released_keeps_the_stack(racecheck_on):
    """SLEEP and GET_LOCK let the tracked statement lock go at every
    level and take it back (utils/sqlkiller.statement_lock_released): the
    lock is free meanwhile, and the held stack is whole after."""
    from tidb_tpu_torch.utils import sqlkiller

    st = racecheck.make_rlock("session.statement")
    sqlkiller.set_current(None, st)
    try:
        with st:
            with st:
                with sqlkiller.statement_lock_released():
                    assert not st._is_owned()
                    got = []
                    t = threading.Thread(target=lambda: got.append(st.acquire(timeout=5)) or
                                         st.release(), name="mysql-test")
                    t.start()
                    t.join(timeout=10)
                    assert got == [True]
                assert st._is_owned()
            assert st._is_owned()
        assert not st._is_owned()
        assert racecheck._held_stack() == []
    finally:
        sqlkiller.set_current(None, None)


def test_origin_is_the_callers_with_line(racecheck_on):
    a, b = TrackedLock("A"), TrackedLock("B")

    def nest():
        def lvl():
            with a:
                with b:  # <- the A->B edge records HERE
                    pass
        lvl()

    nest()
    origin = racecheck.edge_origins()[("A", "B")]
    fname, lineno = origin.rsplit(":", 1)
    assert fname.endswith("test_torch_racecheck.py"), origin
    src = open(__file__, encoding="utf-8").readlines()
    assert "with b:" in src[int(lineno) - 1], origin


# -- the static check ------------------------------------------------------

def _calls(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
            owner = f.value.id if isinstance(f, ast.Attribute) and isinstance(
                f.value, ast.Name) else None
            yield node, owner, name


def test_the_port_builds_every_lock_and_thread_by_the_registry():
    raw, undeclared, unnamed, used = [], [], [], set()
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT).as_posix()
        text = path.read_text(encoding="utf-8")
        if not any(w in text for w in ("threading", "make_", "ThreadPoolExecutor", "Thread")):
            continue
        tree = ast.parse(text)
        for node, owner, name in _calls(tree):
            where = f"{rel}:{node.lineno}"
            if owner == "threading" and name in ("Lock", "RLock", "Condition") \
                    and rel != "utils/racecheck.py":
                raw.append(where)
            if name in ("make_lock", "make_rlock", "make_condition") and node.args:
                arg = node.args[0]
                if not (isinstance(arg, ast.Constant) and arg.value in racecheck.LOCK_CLASSES):
                    if rel != "utils/racecheck.py":
                        undeclared.append(where)
                else:
                    used.add(arg.value)
            if (owner == "threading" and name == "Thread") or name == "ThreadPoolExecutor":
                key = "name" if name == "Thread" else "thread_name_prefix"
                kw = {k.arg: k.value for k in node.keywords}
                val = kw.get(key)
                text = None
                if isinstance(val, ast.Constant):
                    text = val.value
                elif isinstance(val, ast.JoinedStr) and val.values and isinstance(
                        val.values[0], ast.Constant):
                    text = val.values[0].value
                if text is None or text.split("-")[0] not in racecheck.THREAD_NAME_PREFIXES:
                    unnamed.append(where)
            if name == "__init__" and owner is None and isinstance(node.func, ast.Attribute):
                kw = {k.arg: k.value for k in node.keywords}
                if "daemon" in kw and "name" in kw:
                    n = kw["name"]
                    if not (isinstance(n, ast.Constant)
                            and n.value.split("-")[0] in racecheck.THREAD_NAME_PREFIXES):
                        unnamed.append(where)
    assert not raw, f"raw threading primitives outside utils/racecheck.py: {raw}"
    assert not undeclared, f"undeclared or computed lock classes: {undeclared}"
    assert not unnamed, f"threads without a declared name prefix: {unnamed}"
    assert used == set(racecheck.LOCK_CLASSES), sorted(set(racecheck.LOCK_CLASSES) - used)


# -- a server under the checker ----------------------------------------------

def test_server_workers_watchdog_and_dxf_keep_one_lock_order(racecheck_on, monkeypatch):
    import chip_smoke
    from tidb_tpu_torch.dxf import tasks  # noqa: F401 (registers the task types)
    from tidb_tpu_torch.dxf.framework import TaskManager
    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.session import session as session_mod
    from tidb_tpu_torch.storage import Catalog
    from tidb_tpu_torch.utils.watchdog import ensure_watchdog

    # the device's statement lock is built anew, tracked
    monkeypatch.setattr(session_mod, "_STATEMENT_LOCKS", {})
    cat = Catalog()
    srv = Server(cat, port=0, device="cpu", status_port=0)
    srv.stats_handle.interval_s = 0.05
    srv.ttl_worker.interval_s = 0.05
    th = srv.start_background()
    wd = ensure_watchdog(cat, interval=0.05)
    errors = []
    try:
        setup = chip_smoke.MysqlWire(srv.port)
        setup.query("create database d")
        setup.query("create table d.t (id int primary key, v int, ts datetime) "
                    "ttl = ts + interval 1 day")
        setup.query("create table d.u (id int primary key, v int)")
        setup.query("insert into d.u values " + ", ".join(f"({i}, {i})" for i in range(200)))

        def client(table, base):
            try:
                c = chip_smoke.MysqlWire(srv.port, db="d")
                for i in range(15):
                    c.query(f"insert into {table} (id, v) values ({base + i}, {i})")
                    c.query(f"select count(*), sum(v) from {table}")
                    c.query(f"update {table} set v = v + 1 where id = {base}")
                    c.query("begin")
                    c.query(f"delete from {table} where id = {base + i}")
                    c.query("commit")
            except Exception as e:  # noqa: BLE001 - collected and asserted below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(t, b), name="mysql-client")
                   for t, b in (("t", 0), ("u", 1000))]
        for t in threads:
            t.start()
        m = TaskManager(cat)
        tid = m.submit("analyze", {"db": "d", "table": "u", "device": "cpu"})
        assert m.run_to_completion(tid, executors=2, timeout_s=60) == "succeed"
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        wd.stop()
        srv.shutdown()
        th.join(timeout=10)
    assert not errors, errors
    assert not th.is_alive() and not wd.is_alive()
    seen = racecheck.seen_classes()
    assert {"session.statement", "table", "catalog", "storage.txn_wait", "server.conns",
            "stats.handle", "ttl.worker", "dxf.manager"} <= seen, seen
