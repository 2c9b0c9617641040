"""The port's config, server binary, status API and instance watchdog.

Shapes: tests/test_config.py's four ``Config`` cases and its binary
round trip (the port's binary with ``--store cpu``, ``--config``,
``--path`` and ``--status-port``: loaded on boot, written over the wire,
snapshotted on SIGTERM); the status endpoints against the JAX
``StatusServer`` (``/metrics``' families) and the named refusals;
tests/test_watchdog.py's cases; and a KILL that ends a statement waiting
on a table lock. Every join, wait and subprocess has a timeout.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from tidb_tpu.server.http_status import StatusServer as JaxStatusServer
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu_torch.server import Server
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog
from tidb_tpu_torch.storage.persist import load_catalog, save_catalog
from tidb_tpu_torch.utils.config import Config
from tidb_tpu_torch.utils.sqlkiller import QueryKilled
from tidb_tpu_torch.utils.watchdog import InstanceWatchdog, host_memory, parse_mem_limit

from _torch_parity import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- Config ------------------------------------------------------------------

def test_config_defaults():
    c = Config()
    assert c.port == 4000 and c.host == "127.0.0.1" and c.store == "cuda"
    assert c.device == "cuda" and Config(store="cpu").device == "cpu"


def test_config_from_toml_and_override(tmp_path):
    f = tmp_path / "c.toml"
    f.write_text('port = 4407\nhost = "0.0.0.0"\n[variables]\ntidb_slow_log_threshold = 5\n')
    c = Config.from_toml(str(f))
    assert c.port == 4407 and c.host == "0.0.0.0"
    assert c.variables == {"tidb_slow_log_threshold": 5}
    c2 = c.override(port=4500, host=None)
    assert c2.port == 4500 and c2.host == "0.0.0.0"


def test_config_unknown_key_and_unported_values_rejected(tmp_path):
    f = tmp_path / "c.toml"
    f.write_text("prot = 1\n")
    with pytest.raises(ValueError, match="unknown config keys"):
        Config.from_toml(str(f))
    f.write_text('store = "tpu"\n')
    with pytest.raises(ValueError, match="unknown store 'tpu'"):
        Config.from_toml(str(f))
    f.write_text("mesh_devices = 4\n")
    with pytest.raises(NotImplementedError, match="multi-device exchange"):
        Config.from_toml(str(f))
    with pytest.raises(ValueError, match="unknown store"):
        Config().override(store="gpu")
    assert Config(mesh_devices=1).mesh_devices == 1


def test_config_variables_seed_globals():
    cat = Catalog()
    Config(variables={"tidb_slow_log_threshold": 7}).apply_variables(cat)
    assert int(Session(cat, device="cpu").vars.get("tidb_slow_log_threshold")) == 7


# -- the binary ----------------------------------------------------------------

def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            body = r.read()
            if r.headers.get_content_type() == "text/plain":
                return r.status, body.decode()
            return r.status, json.loads(body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _families(text):
    """{family: kind} of a Prometheus text exposition."""
    return dict(ln.split()[2:4] for ln in text.splitlines() if ln.startswith("# TYPE "))


def test_binary_persistence_roundtrip_config_and_status(tmp_path):
    """The binary on the CPU: it loads --path's snapshot on boot, takes
    its [variables] from --config, serves the status API and the MySQL
    port, and writes the catalog back on SIGTERM, exiting 0."""
    import chip_smoke

    data = tmp_path / "data"
    s = Session(Catalog(), device="cpu")
    s.execute("create table cfg_t (a int primary key)")
    s.execute("insert into cfg_t values (11), (22)")
    save_catalog(s.catalog._base, str(data))
    cfgf = tmp_path / "server.toml"
    cfgf.write_text("auto_analyze_interval_s = 0.5\n[variables]\ntidb_slow_log_threshold = 9\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch.tidb_server", "--store", "cpu", "--config",
         str(cfgf), "-P", "0", "--path", str(data), "--status-port", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        status_port = port = None
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line, "".join(lines)
            lines.append(line)
            if line.startswith("status on "):
                status_port = int(line.rsplit(":", 1)[1])
            if "listening on" in line:
                port = int(line.split("listening on ")[1].split()[0].rsplit(":", 1)[1])
        assert port and status_port, lines
        c = chip_smoke.MysqlWire(port)
        assert c.query("select a from cfg_t order by a")[1] == [(11,), (22,)]
        c.query("insert into cfg_t values (33)")
        code, st = _get(status_port, "/status")
        assert code == 200 and st["connections"] == 1, st
        assert _get(status_port, "/schema/test/cfg_t")[1]["rows"] == 3
        assert _get(status_port, "/settings")[1]["tidb_slow_log_threshold"] == "9"
        code, text = _get(status_port, "/metrics")
        assert code == 200 and _families(text)["tidbtpu_session_statements_total"] == "counter"
        c.sock.close()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        lines.append(out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 0, "".join(lines)
    assert "snapshot of 1 tables" in "".join(lines), "".join(lines)
    cat = load_catalog(str(data))
    assert Session(cat, device="cpu").execute("select a from cfg_t order by a").rows == [
        (11,), (22,), (33,)]


def test_binary_without_a_card_raises_before_loading(monkeypatch):
    """With no card and no ``--store cpu`` the binary raises naming CUDA
    before it reads its ``--path``."""
    import torch

    from tidb_tpu_torch import tidb_server
    from tidb_tpu_torch.storage import persist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(persist, "load_catalog", lambda *a, **k: pytest.fail("loaded"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tidb_server.main(["-P", "0", "--path", ROOT])


# -- the status API ------------------------------------------------------------

def test_status_endpoints_match_jax_and_refuse_by_name():
    sqls = ("create database app", "create table app.t (id bigint primary key, nm varchar(8), "
            "d decimal(10, 2))", "insert into app.t values (1, 'a', 1.5), (2, null, null)",
            "create index i_nm on app.t (nm)")
    js, ts = JaxSession(JaxCatalog()), Session(Catalog(), device="cpu")
    for q in sqls:
        js.execute(q)
        ts.execute(q)
    jst = JaxStatusServer(js.catalog, port=0)
    srv = Server(ts.catalog._base, port=0, device="cpu", status_port=0)
    jth, th = jst.start_background(), srv.start_background()
    try:
        for path in ("/schema", "/schema/app", "/schema/app/t", "/nope"):
            assert _get(srv.status_server.port, path) == _get(jst.port, path), path
        code, st = _get(srv.status_server.port, "/")
        assert code == 200 and st["connections"] == 0 and st["version"].startswith("8.0.11")
        code, err = _get(srv.status_server.port, "/schema/app/nope")
        assert code == 500 and "unknown table" in err["error"]
        # /metrics serves the registry as the JAX endpoint does: both
        # render the same families with the same kinds where both have them
        code, text = _get(srv.status_server.port, "/metrics")
        jcode, jtext = _get(jst.port, "/metrics")
        fams, jfams = _families(text), _families(jtext)
        assert code == jcode == 200 and fams["tidbtpu_session_statements_total"] == "counter"
        assert all(jfams[f] == k for f, k in fams.items() if f in jfams), (fams, jfams)
        for path, item in (("/tsdb", "item 6"), ("/profile", "item 6"),
                           ("/timeline", "item 6"), ("/inspection", "item 6"),
                           ("/dcn", "item 8"), ("/links", "item 8")):
            code, err = _get(srv.status_server.port, path)
            assert code == 500 and f"{path} is not ported yet" in err["error"] \
                and item in err["error"], (path, err)
    finally:
        jst.shutdown()
        srv.shutdown()
        jth.join(timeout=10)
        th.join(timeout=10)
    assert not th.is_alive()


def test_status_port_in_use_raises():
    """A status port that cannot be bound raises, and the MySQL port the
    failed server had bound is closed again."""
    srv = Server(Catalog(), port=0, device="cpu", status_port=0)
    th = srv.start_background()
    try:
        with pytest.raises(OSError):
            Server(Catalog(), port=0, device="cpu", status_port=srv.status_server.port)
    finally:
        srv.shutdown()
        th.join(timeout=10)


# -- the watchdog ----------------------------------------------------------------

def test_host_memory_and_limit_parse():
    rss, total = host_memory()
    assert rss > 0 and total > rss
    assert parse_mem_limit("0", total) == 0
    assert parse_mem_limit("50%", 1000) == 500
    assert parse_mem_limit("12345", total) == 12345
    assert parse_mem_limit("", total) == 0


def _sleeper(s, seconds, errors):
    def run():
        try:
            s.execute(f"select sleep({seconds})")
        except Exception as e:  # noqa: BLE001 - the test reads it
            errors.append(str(e))

    t = threading.Thread(target=run, name="mysql-sleeper")
    t.start()
    return t


@pytest.mark.parametrize("slow_log", ["1", "0"])
def test_expensive_query_flagged(slow_log):
    """The expensive-query flag fires past the threshold with the slow
    log on or off; its ``[expensive_query]`` entry lands in the slow log
    only while ``slow_query_log`` is on (tests/test_watchdog.py)."""
    from tidb_tpu_torch.utils.metrics import SLOW_LOG

    SLOW_LOG.reset()
    cat = Catalog()
    s = Session(cat, device="cpu")
    s.execute(f"set global slow_query_log = {slow_log}")
    s.catalog.global_sysvars["tidb_expensive_query_time_threshold"] = 0
    wd = InstanceWatchdog(cat, interval=0.05)
    t = _sleeper(s, 0.3, [])
    for _ in range(40):
        time.sleep(0.02)
        wd.sample()
        if wd.expensive_seen:
            break
    t.join(timeout=10)
    assert not t.is_alive() and wd.expensive_seen
    assert {k[0] for k in wd.expensive_seen} == {s.conn_id}
    entries = [r for r in SLOW_LOG.rows() if r[1].startswith(f"[expensive_query] conn={s.conn_id} ")]
    assert len(entries) == (1 if slow_log == "1" else 0), entries


def test_memory_limit_kills_top_consumer_as_jax():
    jcat, cat = JaxCatalog(), Catalog()
    texts = []
    for c, sess in ((jcat, JaxSession(jcat)), (cat, Session(cat, device="cpu"))):
        from tidb_tpu.utils.watchdog import InstanceWatchdog as JaxWatchdog

        sess.catalog.global_sysvars["tidb_server_memory_limit"] = 1  # always breached
        wd = (JaxWatchdog if c is jcat else InstanceWatchdog)(c, interval=0.05)
        c._watchdog = wd
        errors = []
        t = _sleeper(sess, 5, errors)
        for _ in range(60):
            time.sleep(0.05)
            if wd.kill_records:
                break
            wd.sample()
        t.join(timeout=10)
        assert not t.is_alive()
        assert wd.kill_records and wd.kill_records[0]["conn_id"] == sess.conn_id
        texts.append(errors[0])
        sess.killer.clear()
        rows = sess.execute(
            "select op, conn_id from information_schema.memory_usage_ops_history").rows
        assert ("kill", sess.conn_id) in rows
    assert texts[0] == texts[1] and "interrupted" in texts[1], texts


def test_set_knob_starts_daemon_and_kill_ends_sleep():
    cat = Catalog()
    s = Session(cat, device="cpu")
    s.execute("set global tidb_memory_usage_alarm_ratio = 0.9")
    wd = cat._watchdog
    assert wd.is_alive()
    wd.stop()
    assert not wd.is_alive()
    errors = []
    t = _sleeper(s, 10, errors)
    time.sleep(0.1)
    s.killer.kill()
    t.join(timeout=5)
    assert not t.is_alive() and errors and "interrupted" in errors[0]


def test_kill_ends_a_statement_waiting_on_a_table_lock():
    """A pessimistic transaction holds t's lock; another session's INSERT
    waits for it; KILL QUERY from a third ends the wait with the killed
    error, and the holder's COMMIT goes through."""
    cat = Catalog()
    holder, waiter, killer = (Session(cat, device="cpu") for _ in range(3))
    holder.execute("create table t (a int)")
    for s in (holder, waiter):
        s.execute("set tidb_txn_mode = 'pessimistic'")
    holder.execute("begin")
    holder.execute("insert into t values (1)")
    errors = []

    def run():
        try:
            waiter.execute("insert into t values (2)")
        except Exception as e:  # noqa: BLE001 - the test reads it
            errors.append(e)

    t = threading.Thread(target=run, name="mysql-waiter")
    t.start()
    time.sleep(0.3)
    assert t.is_alive()
    t0 = time.monotonic()
    killer.execute(f"kill query {waiter.conn_id}")
    t.join(timeout=10)
    assert not t.is_alive() and time.monotonic() - t0 < 2
    assert len(errors) == 1 and isinstance(errors[0], QueryKilled), errors
    holder.execute("commit")
    assert waiter.execute("select a from t").rows == [(1,)]
    waiter.execute("insert into t values (2)")
    assert sorted(waiter.execute("select a from t").rows) == [(1,), (2,)]


def test_memory_limit_kills_a_statement_waiting_on_a_table_lock():
    """A statement waiting on a pessimistic holder's table lock is listed
    by SHOW PROCESSLIST and is the watchdog's top consumer: past the
    memory limit it is killed in its wait, and the idle holder is not."""
    cat = Catalog()
    holder, waiter, other = (Session(cat, device="cpu") for _ in range(3))
    holder.execute("create table t (a int)")
    for s in (holder, waiter):
        s.execute("set tidb_txn_mode = 'pessimistic'")
    holder.execute("begin")
    holder.execute("insert into t values (1)")
    errors = []

    def run():
        try:
            waiter.execute("insert into t values (2)")
        except Exception as e:  # noqa: BLE001 - the test reads it
            errors.append(e)

    t = threading.Thread(target=run, name="mysql-waiter")
    t.start()
    time.sleep(0.3)
    assert t.is_alive()
    listed = {r[0]: r for r in other.execute("show processlist").rows}
    assert waiter.conn_id in listed and "insert into t values (2)" in listed[waiter.conn_id]
    cat.global_sysvars["tidb_server_memory_limit"] = 1  # always breached
    wd = InstanceWatchdog(cat, interval=0.05)
    cat._watchdog = wd
    wd.sample()
    t.join(timeout=10)
    assert not t.is_alive()
    assert len(errors) == 1 and isinstance(errors[0], QueryKilled), errors
    assert [r["conn_id"] for r in wd.kill_records] == [waiter.conn_id]
    cat.global_sysvars["tidb_server_memory_limit"] = "0"
    holder.execute("commit")
    assert waiter.execute("select a from t").rows == [(1,)]
