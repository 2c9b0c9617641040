"""The port's failpoints against the JAX package's.

The registry and its actions (tests/test_failpoint*.py's shapes); the
port's sites are JAX sites, each with an ``inject`` call in the port; and
each site a reference test arms (tests/test_governance.py,
test_streamed.py, test_aux.py, test_constraints.py, test_tools.py) armed
alike in both packages over the same statements: the same rows, the same
errors and the same table state after.
"""

import pathlib
import re

import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu.utils import failpoint as jfp
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog
from tidb_tpu_torch.utils import failpoint as tfp

from _torch_parity import one_thread, WritePair  # noqa: F401 (one_thread)

PORT = pathlib.Path(__file__).resolve().parent.parent / "tidb_tpu_torch"


@pytest.fixture(autouse=True)
def disarmed():
    yield
    jfp.disable_all()
    tfp.disable_all()


# -- the registry ------------------------------------------------------------

def test_unknown_site_is_refused_and_declare_admits_it():
    name = "typod" + "/site"  # built at run time: the repo's lint reads literals
    with pytest.raises(ValueError, match="unknown failpoint site"):
        tfp.enable(name, RuntimeError)
    tfp.declare(name)
    tfp.enable(name, 7)
    assert tfp.is_enabled(name) and tfp.inject(name) == 7
    tfp.disable(name)
    assert not tfp.is_enabled(name) and tfp.inject(name, "dflt") == "dflt"


def test_the_four_actions():
    site = "storage/scan"
    tfp.enable(site, RuntimeError)
    with pytest.raises(RuntimeError, match="failpoint storage/scan"):
        tfp.inject(site)
    tfp.enable(site, KeyError("inst"))
    with pytest.raises(KeyError, match="inst"):
        tfp.inject(site)
    hits = []
    tfp.enable(site, lambda: hits.append(1) or "hooked")
    assert tfp.inject(site) == "hooked" and hits == [1]
    tfp.enable(site, 42)
    assert tfp.inject(site) == 42
    tfp.disable_all()
    assert tfp.inject(site) is None


def _schedule(fp):
    """Six hits of a times, an after_n and a seeded action."""
    return [[act() for _ in range(6)]
            for act in (fp.times(2, "x"), fp.after_n(3, "y"), fp.seeded(11, 0.5, "z"))]


def test_times_after_n_and_seeded_match_jax():
    want = _schedule(jfp)
    assert _schedule(tfp) == want
    assert want[0] == ["x", "x", None, None, None, None]
    assert want[1] == [None, None, "y", None, None, None]
    act = tfp.after_n(1, tfp.FailpointError)
    with pytest.raises(tfp.FailpointError, match="failpoint after_n"):
        act()


def test_port_sites_are_jax_sites_with_inject_calls():
    assert tfp.SITES <= jfp.SITES, sorted(tfp.SITES - jfp.SITES)
    text = "\n".join(p.read_text(encoding="utf-8") for p in PORT.rglob("*.py"))
    injected = set(re.findall(r"\binject\(\s*[\"']([^\"']+)[\"']", text))
    assert tfp.SITES <= injected, sorted(tfp.SITES - injected)
    assert injected <= tfp.SITES, sorted(injected - tfp.SITES)
    # the deliberate differences: no online-DDL ladder sites
    assert not any(s.startswith(("ddl/index-", "ddl/modify-column")) for s in tfp.SITES)


# -- armed alike in both packages -----------------------------------------------

def _arm(site, action):
    """Arm `site` in both packages; `action(fp)` builds each package's."""
    jfp.enable(site, action(jfp))
    tfp.enable(site, action(tfp))


def _pair(*sqls):
    p = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    p.runs(*sqls)
    return p


T = ("create table t (a int, b int)",
     "insert into t values " + ", ".join(f"({i}, {i % 5})" for i in range(300)))


@pytest.fixture(scope="module")
def scan_pair():
    return _pair(*T)


@pytest.mark.parametrize("site,sql", [
    ("storage/scan", "select count(*), sum(a) from t"),
    ("executor/before-discover", "select sum(a) from t where b = 3"),
])
def test_read_sites(scan_pair, site, sql):
    _arm(site, lambda fp: RuntimeError)
    scan_pair.run(sql)
    jfp.disable(site)
    tfp.disable(site)
    scan_pair.run(sql)
    scan_pair.state("t")


@pytest.mark.parametrize("site,sql", [
    ("executor/stream-chunk", "select b, count(*), sum(a) from t group by b order by b"),
    ("executor/stream-sort", "select a, b from t order by b, a"),
])
def test_stream_sites(scan_pair, site, sql):
    """The streamed aggregate fails at its second chunk and the streamed
    ORDER BY as it starts, in both; disarmed, both give the rows."""
    scan_pair.run("set tidb_tpu_stream_rows = 64")
    try:
        _arm(site, lambda fp: fp.after_n(2, RuntimeError) if site.endswith("chunk")
             else RuntimeError)
        scan_pair.run(sql)
        jfp.disable(site)
        tfp.disable(site)
        scan_pair.run(sql)
        assert [r["path"] for r in scan_pair.ts.executor.stream_log] == [
            "streamed" if site.endswith("chunk") else "sort"]
    finally:
        scan_pair.run("set tidb_tpu_stream_rows = -1")


def test_partition_sites(monkeypatch):
    """The grace-hash path (the semi join of test_streamed.py) fails once
    committed and at its second partition in both packages."""
    from tidb_tpu.planner import streamed as jax_streamed
    from tidb_tpu_torch.planner import physical

    monkeypatch.setattr(jax_streamed, "_device_budget", lambda: 1 << 16)
    monkeypatch.setattr(physical, "_MAX_CAP", 256)
    rows = ", ".join(f"({i}, {i % 40}, {(i * 13) % 997}, {i % 400})" for i in range(1500))
    p = _pair("create table a (id int, d int, v int, k int)", f"insert into a values {rows}",
              "create table b like a", "insert into b select * from a")
    sql = "select count(*), sum(v) from a where exists (select 1 from b where b.k = a.k and b.d >= 20)"
    _arm("executor/partition-start", lambda fp: RuntimeError)
    p.run(sql)
    jfp.disable_all()
    tfp.disable_all()
    _arm("executor/partition-feed", lambda fp: fp.after_n(2, RuntimeError))
    p.run(sql)
    jfp.disable_all()
    tfp.disable_all()
    p.run(sql)
    assert [r["path"] for r in p.ts.executor.stream_log] == ["partitioned"]


FK = ("create table p (id int primary key)",
      "create table c (id int, pid int, constraint fc foreign key (pid) references p (id) "
      "on delete cascade on update cascade)",
      "insert into p values (1), (2)", "insert into c values (10, 1), (20, 2)")


@pytest.mark.parametrize("site,sql", [
    ("fk/cascade-delete", "delete from p where id = 1"),
    ("fk/cascade-update", "update p set id = 3 where id = 1"),
])
def test_cascade_sites_restore_every_table(site, sql):
    p = _pair(*FK)
    _arm(site, lambda fp: RuntimeError("crash mid-cascade"))
    p.run(sql)
    p.state("p")
    p.state("c")
    jfp.disable(site)
    tfp.disable(site)
    p.runs(sql, "select id, pid from c order by id")


@pytest.mark.parametrize("site", ["session/before-commit", "session/commit-apply"])
def test_commit_sites_leave_the_table_unchanged(site):
    p = _pair(*T[:1], "insert into t values (1, 1)")
    _arm(site, lambda fp: RuntimeError)
    p.runs("begin", "insert into t values (1000, 0)", "commit")
    p.state("t")
    jfp.disable(site)
    tfp.disable(site)
    p.runs("select count(*) from t", "begin", "insert into t values (7, 7)", "commit",
           "select count(*) from t")


def test_dml_insert_site():
    p = _pair(*T[:1])
    _arm("dml/insert", lambda fp: RuntimeError)
    p.run("insert into t values (9, 9)")
    p.state("t")


@pytest.mark.parametrize("site,sqls", [
    ("locks/acquire", ["insert into t values (1, 1)"]),
    ("storage/gc-drop-version", [f"insert into t values ({i}, 0)" for i in range(5)]),
])
def test_counting_sites(site, sqls):
    """A hook counts its site's hits: autocommit DML passes the lock
    manager, and repeated writes run the version GC, in both packages; a
    pinned version survives the GC."""
    p = _pair(*T[:1], "insert into t values (-1, 0)")
    pinned = {}
    for s in (p.js, p.ts):
        t = s.catalog.table("test", "t")
        pinned[id(s)] = t.version
        t.pin(t.version)
    hits = {"j": 0, "t": 0}
    jfp.enable(site, lambda: hits.__setitem__("j", hits["j"] + 1))
    tfp.enable(site, lambda: hits.__setitem__("t", hits["t"] + 1))
    p.runs(*sqls)
    jfp.disable(site)
    tfp.disable(site)
    assert hits["j"] > 0 and hits["t"] > 0, hits
    for s in (p.js, p.ts):
        t = s.catalog.table("test", "t")
        assert pinned[id(s)] in t._versions
        t.unpin(pinned[id(s)])
    p.state("t")


def test_backup_table_site(tmp_path):
    p = _pair(*T, "create table u (x int)", "insert into u values (1)")
    _arm("persist/backup-table", lambda fp: fp.after_n(2, RuntimeError))
    for s, d in ((p.js, "j"), (p.ts, "t")):
        with pytest.raises(RuntimeError, match="failpoint after_n"):
            s.execute(f"backup database test to '{tmp_path / d}'")
    assert sorted(x.name for x in (tmp_path / "j").iterdir()) == sorted(
        x.name for x in (tmp_path / "t").iterdir())
