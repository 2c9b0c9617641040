"""Persistence and BACKUP / RESTORE in the port against the JAX package.

Shapes: tests/test_tools.py's four BR cases (:34-88, :155),
tests/test_persist_gc.py's snapshot round trip and its pickle-free format
(:15, :114), and tests/test_ttl_autoinc.py's TTL round trip (:81). Both
packages write the same format: a JAX BACKUP restored by the port and a
port BACKUP restored by the JAX Session give equal tables, and the two
packages' manifests and npz members over the same statements are equal.
RESTORE over a table whose schema diverged, and a read after RESTORE
past the scan cache, are the port's own cases.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu.storage.persist import (
    load_catalog as jax_load_catalog, save_catalog as jax_save_catalog,
    table_meta_to_json as jax_meta,
)
from tidb_tpu.utils import failpoint as jax_failpoint
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog, scan, table_state
from tidb_tpu_torch.storage.persist import (
    load_catalog, save_catalog, schemas_equivalent, table_meta_to_json,
)
from tidb_tpu_torch.utils import failpoint

from _torch_parity import one_thread, WritePair  # noqa: F401 (one_thread)

APP = (
    "create database app",
    "create table app.t (id int primary key auto_increment, v varchar(8), ts datetime)",
    "insert into app.t (v, ts) values ('a','2024-01-01 10:00:00'),('b','2024-02-02 11:30:45')",
)

#: every kind of table state a manifest carries
WIDE = (
    "create database br", "use br",
    "create table r (k int primary key, name varchar(10))",
    "create table c (id int primary key auto_increment, rk int, amt decimal(10,2), "
    "note varchar(20) default 'none', "
    "constraint c_fk foreign key (rk) references r (k) on delete cascade on update set null, "
    "constraint amt_pos check (amt >= 0))",
    "create table g (a int, b int, s int as (a + b) stored, v int as (a * 2) virtual)",
    "create table dom (id int, e enum('x','y','z'), st set('a','b','c'), j json)",
    "create table pr (k int, v int) partition by range (k) "
    "(partition p0 values less than (10), partition p1 values less than maxvalue)",
    "create table ph (k int, v int) partition by hash (k) partitions 3",
    "create table pl (k int, v int) partition by list (k) "
    "(partition pa values in (1, 2), partition pb values in (3, 4))",
    "create table ev (id bigint primary key, ts datetime) ttl = ts + interval 90 day",
    "create index c_amt on c (amt)",
    "create unique index r_name on r (name)",
    "create view vw as select id, amt from c",
    "create sequence sq start with 5 increment by 2",
    "create user br_reader",
    "grant select on br.* to br_reader",
    "insert into r values (1, 'one'), (2, 'two'), (3, null)",
    "insert into c (rk, amt) values (1, 1.50), (2, 2.25), (null, 0)",
    "insert into g (a, b) values (1, 2), (3, null)",
    "insert into dom values (1, 'y', 'a,c', '{\"k\": [1, 2]}'), (2, null, '', null)",
    "insert into pr values (1, 1), (20, 2), (5, null)",
    "insert into ph values (1, 1), (2, 2), (7, 7)",
    "insert into pl values (1, 1), (3, 3), (4, 4)",
    "insert into ev values (1, '2999-01-01 00:00:00'), (2, null)",
    "select nextval(sq)",
)


def _pair(*sqls):
    p = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    p.runs(*sqls)
    return p


def _same_tables(jcat, tcat, db):
    """Every table of `db` equal in both catalogs: rows, dictionaries,
    AUTO_INCREMENT and the metadata a manifest carries."""
    assert jcat.tables(db) == tcat.tables(db)
    for name in jcat.tables(db):
        jt, tt = jcat.table(db, name), tcat.table(db, name)
        a, b = table_state(jt), table_state(tt)
        assert a["autoinc_next"] == b["autoinc_next"], name
        for c, (jd, jv, jdict) in a["columns"].items():
            td, tv, tdict = b["columns"][c]
            assert np.array_equal(jv, tv), (name, c)
            assert np.array_equal(np.where(jv, jd, 0), np.where(tv, td, 0)), (name, c)
            assert (jdict is None) == (tdict is None), (name, c)
            if jdict is not None:
                assert list(jdict) == list(tdict), (name, c)
        assert json.dumps(jax_meta(jt), sort_keys=True) == json.dumps(
            table_meta_to_json(tt), sort_keys=True), name
        assert [b.part_id for b in jt.blocks()] == [b.part_id for b in tt.blocks()], name


def test_backup_restore_single_db(tmp_path):
    p = _pair(*APP, "create table other (x int)")
    for s, d in ((p.js, "j"), (p.ts, "t")):
        s.execute(f"backup database app to '{tmp_path / d}'")
    p2 = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    p2.js.execute(f"restore database app from '{tmp_path / 'j'}'")
    p2.ts.execute(f"restore database app from '{tmp_path / 't'}'")
    assert not p2.ts.catalog.has_table("test", "other")
    # schema extras survive: the key and AUTO_INCREMENT go on allocating
    p2.runs("insert into app.t (v, ts) values ('c', null)",
            "select id, v from app.t order by id")
    p2.state("t", db="app", modify_base=(0, 0))


def test_backup_all_databases(tmp_path):
    p = _pair(*APP, "create table other (x int)", "insert into other values (9)")
    p.js.execute(f"backup database * to '{tmp_path / 'j'}'")
    p.ts.execute(f"backup database * to '{tmp_path / 't'}'")
    p2 = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    p2.js.execute(f"restore database * from '{tmp_path / 'j'}'")
    p2.ts.execute(f"restore database * from '{tmp_path / 't'}'")
    p2.runs("select x from other", "select count(*) from app.t")


def test_backup_checkpoint_resume(tmp_path):
    """An interrupted BACKUP leaves its checkpoint ledger; the resume
    writes only the table the crash interrupted."""
    p = _pair(*APP, "create table app.u (x int)", "insert into app.u values (1)")
    for s, fp, d, save in ((p.js, jax_failpoint, "j", jax_save_catalog),
                           (p.ts, failpoint, "t", save_catalog)):
        path = str(tmp_path / d)
        calls = [0]

        def boom():
            calls[0] += 1
            if calls[0] == 2:
                raise RuntimeError("simulated crash mid-backup")

        fp.enable("persist/backup-table", boom)
        try:
            with pytest.raises(RuntimeError, match="simulated crash mid-backup"):
                s.execute(f"backup database app to '{path}'")
        finally:
            fp.disable("persist/backup-table")
        assert os.path.exists(os.path.join(path, "checkpoint.json"))
        assert save(s.catalog._base if hasattr(s.catalog, "_base") else s.catalog,
                    path, dbs=["app"], resume=True) == 1
        assert not os.path.exists(os.path.join(path, "checkpoint.json"))
    p2 = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    p2.js.execute(f"restore database app from '{tmp_path / 'j'}'")
    p2.ts.execute(f"restore database app from '{tmp_path / 't'}'")
    p2.runs("select count(*) from app.t", "select x from app.u")


def test_backup_requires_super(tmp_path):
    p = _pair(*APP, "create user pleb")
    pleb = WritePair(JaxSession(catalog=p.js.catalog, user="pleb"),
                     Session(p.ts.catalog._base, user="pleb", device="cpu"))
    pleb.run(f"backup database app to '{tmp_path / 'x'}'")
    pleb.run(f"restore database app from '{tmp_path / 'x'}'")
    assert not (tmp_path / "x").exists()


def test_save_load_roundtrip_and_no_pickle(tmp_path):
    """test_persist_gc.py's round trip and pickle-free format: the port's
    snapshot loads with allow_pickle off in both packages."""
    p = _pair("create database shop", "use shop",
              "create table items (id bigint, name varchar(32), price decimal(10,2), "
              "added date, score double)",
              "insert into items values (1,'apple',1.25,'2024-01-31',0.5),"
              "(2,'pear',null,'2023-06-01',null),(3,null,3.5,null,2.25)")
    save_catalog(p.ts.catalog._base, str(tmp_path / "snap"))
    for fn in (tmp_path / "snap").glob("*.npz"):
        data = np.load(fn)  # allow_pickle off: must not raise
        assert all(data[k].dtype != object for k in data.files)
    p2 = WritePair(JaxSession(jax_load_catalog(str(tmp_path / "snap")), db="shop"),
                   Session(load_catalog(str(tmp_path / "snap")), db="shop", device="cpu"))
    p2.runs("select id, name, price, added, score from items order by id",
            "insert into items values (4,'fig',9.99,'2025-05-05',1.0)",
            "select count(*) from items")


def test_ttl_persist_roundtrip(tmp_path):
    s = Session(device="cpu")
    s.execute("create table ev (id int, ts datetime) ttl = ts + interval 2 hour")
    save_catalog(s.catalog._base, str(tmp_path / "snap"))
    assert load_catalog(str(tmp_path / "snap")).table("test", "ev").ttl == ("ts", 2, "hour")


def test_each_package_restores_the_others_backup(tmp_path):
    """The same statements through both packages: their BACKUPs are
    equal file for file, and the JAX backup restored by the port and the
    port backup restored by the JAX Session hold the same tables, views,
    sequences and users as the other side's originals."""
    p = _pair(*WIDE)
    p.js.execute(f"backup database br to '{tmp_path / 'j'}'")
    p.ts.execute(f"backup database br to '{tmp_path / 't'}'")
    mj = json.loads((tmp_path / "j" / "manifest.json").read_text())
    mt = json.loads((tmp_path / "t" / "manifest.json").read_text())
    assert mj == mt
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "t"))
    for fn in files:
        if fn.endswith(".npz"):
            a, b = np.load(tmp_path / "j" / fn), np.load(tmp_path / "t" / fn)
            assert sorted(a.files) == sorted(b.files), fn
            for m in a.files:
                assert a[m].dtype == b[m].dtype and np.array_equal(a[m], b[m]), (fn, m)
    tcat, jcat = load_catalog(str(tmp_path / "j")), jax_load_catalog(str(tmp_path / "t"))
    _same_tables(p.js.catalog, tcat, "br")
    _same_tables(jcat, p.ts.catalog._base, "br")
    for cat in (tcat, jcat):
        assert cat.view_def("br", "vw")[0] == p.js.catalog.view_def("br", "vw")[0]
        assert cat.sequence("br", "sq").meta() == p.js.catalog.sequence("br", "sq").meta()
        assert cat.users.to_manifest() == p.js.catalog.users.to_manifest()
    # the restored port catalog goes on as the original does
    p2 = WritePair(JaxSession(p.js.catalog, db="br"), Session(tcat, db="br", device="cpu"))
    p2.runs("select nextval(sq)", "select k, v from pr order by k",
            "delete from r where k = 1", "select id, rk from c order by id",
            "insert into c (rk, amt) values (2, -1)", "select * from vw order by id")


def test_restore_over_a_diverged_schema(tmp_path):
    """RESTORE over a table ALTERed since the backup: the backup's schema
    wins, the table is dropped and created again."""
    p = _pair(*APP)
    p.js.execute(f"backup database app to '{tmp_path / 'j'}'")
    p.ts.execute(f"backup database app to '{tmp_path / 't'}'")
    p.runs("alter table app.t add column extra int", "insert into app.t (v, extra) values ('x', 1)")
    old = p.ts.catalog.table("app", "t")
    p.js.execute(f"restore database app from '{tmp_path / 'j'}'")
    p.ts.execute(f"restore database app from '{tmp_path / 't'}'")
    assert p.ts.catalog.table("app", "t") is not old
    assert schemas_equivalent(p.ts.catalog.table("app", "t").schema,
                              load_catalog(str(tmp_path / "t")).table("app", "t").schema)
    p.runs("select * from app.t order by id", "select count(*) from app.t")


def test_read_after_restore_sees_no_cached_rows(tmp_path):
    """A table read (its columns cached on the device) and written after
    the backup: RESTORE publishes a new version, drops the old versions'
    cached columns, and the next read gives the backup's rows."""
    s = Session(Catalog(), device="cpu")
    for q in APP:
        s.execute(q)
    s.execute(f"backup database app to '{tmp_path}'")
    s.execute("insert into app.t (v) values ('late')")
    assert s.execute("select count(*), max(id) from app.t").rows == [(3, 3)]
    t = s.catalog.table("app", "t")
    v_before = t.version
    assert t.uid in scan.cached_versions()
    s.execute("analyze table app.t")
    s.execute(f"restore database app from '{tmp_path}'")
    assert s.catalog.table("app", "t") is t and t.version > v_before
    assert v_before not in scan.cached_versions().get(t.uid, set())
    assert t.stats == {}
    assert s.execute("select count(*), max(id) from app.t").rows == [(2, 2)]
    assert s.execute("select v from app.t where id = 2").rows == [("b",)]


def test_other_sessions_run_while_a_backup_writes(tmp_path):
    """BACKUP takes its tables under the statement lock and writes them
    with it let go: held at its first table's write, another session's
    read ends meanwhile, and the backup then restores the rows it took."""
    cat = Catalog()
    a, b = Session(cat, device="cpu"), Session(cat, device="cpu")
    for q in APP:
        a.execute(q)
    writing, go, errors = threading.Event(), threading.Event(), []

    def hold():
        writing.set()
        assert go.wait(timeout=10)

    def backup():
        try:
            a.execute(f"backup database app to '{tmp_path}'")
        except Exception as e:  # noqa: BLE001 - the test reads it
            errors.append(e)

    failpoint.enable("persist/backup-table", hold)
    try:
        th = threading.Thread(target=backup, name="mysql-backup")
        th.start()
        assert writing.wait(timeout=10)
        got = []
        reader = threading.Thread(
            target=lambda: got.append(b.execute("select count(*) from app.t").rows),
            name="mysql-reader")
        t0 = time.perf_counter()
        reader.start()
        reader.join(timeout=5)
        took = time.perf_counter() - t0
        assert not reader.is_alive() and th.is_alive(), took
        b.execute("insert into app.t (v) values ('late')")
        go.set()
        th.join(timeout=10)
    finally:
        go.set()
        failpoint.disable("persist/backup-table")
    assert not th.is_alive() and not errors, errors
    assert got == [[(2,)]]
    assert load_catalog(str(tmp_path)).table("app", "t").nrows == 2
