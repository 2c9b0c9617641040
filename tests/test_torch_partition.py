"""Partitioned tables in the port against the JAX package: PARTITION BY
RANGE, HASH and LIST, the routing of rows to partitions (``part_id``),
pruning shown in EXPLAIN, ALTER TABLE ... ADD, DROP, TRUNCATE and
EXCHANGE PARTITION with their refusals, pruning at a pinned snapshot,
information_schema.partitions and SHOW CREATE TABLE (the shapes of
tests/test_partition.py but persistence, BR and the mesh). Every statement
goes through both Sessions (``_torch_parity.WritePair``): the same rows,
errors, stored state and partition tags. The partition phase's
partition lists over TPC-H are pinned here too, and a pruned read's
rows and host->device bytes against an unpruned one's."""

import numpy as np
import pytest

import tidb_tpu  # noqa: F401
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu_torch.chunk import TRANSFERS
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog

from _torch_parity import one_thread, port_catalog, same_rows, WritePair  # noqa: F401

SALES = (
    "create table sales (id int, amt int, d date) partition by range (d) ("
    "partition p22 values less than (date '2023-01-01'), "
    "partition p23 values less than (date '2024-01-01'), "
    "partition pmax values less than maxvalue)",
    "insert into sales values (1, 10, date '2022-06-01'), (2, 20, date '2023-06-01'), "
    "(3, 30, date '2024-06-01'), (4, 40, date '2023-01-15'), (5, 50, NULL)",
)
M = (
    "create table m (id int, d int) partition by range (d) (partition p0 values less than (10), "
    "partition p1 values less than (20), partition p2 values less than (30))",
    "insert into m values (1, 5), (2, 15), (3, 25), (4, 16)",
)
R = (
    "create table r (id int, region int) partition by list (region) ("
    "partition east values in (1, 3), partition west values in (2, 4), "
    "partition other values in (9, null))",
    "insert into r values (1, 1), (2, 2), (3, 3), (4, 9), (5, NULL)",
)

CASES = {
    "range_route_and_prune": SALES + (
        "select sum(amt) from sales where d < date '2023-01-01'",
        "explain select sum(amt) from sales where d < date '2023-01-01'",
        "select sum(amt) from sales where d >= date '2023-01-01' and d < date '2024-01-01'",
        "explain select sum(amt) from sales where d >= date '2023-01-01' and d < date '2024-01-01'",
        "select sum(amt) from sales where d >= date '2024-06-01'",
        "explain select sum(amt) from sales where d >= date '2024-06-01'",
        "explain select sum(amt) from sales where amt > 0",
        "explain select id from sales where d between '2022-01-01' and '2022-12-31' and id > 0",
        "explain select id from sales where d > '2030-01-01' and d < '2020-01-01'",
        "select id from sales where d is null", "show create table sales",
        "create table bounded (a int) partition by range (a) (partition p0 values less than (10))",
        "insert into bounded values (10)", "insert into bounded values (9), (-4)",
        "update sales set amt = amt + 1 where id = 2",
        "select sum(amt) from sales where d >= date '2023-01-01' and d < date '2024-01-01'",
        "delete from sales where d < date '2023-01-01' and amt > 20",
        "select id from sales order by id",
        "select * from information_schema.partitions order by table_name, "
        "partition_ordinal_position",
    ),
    "hash": (
        "create table h (k int, v int) partition by hash (k) partitions 4",
        "insert into h values (0,1),(1,2),(2,3),(3,4),(4,5),(5,6)",
        "explain select v from h where k = 5", "select v from h where k = 5",
        "explain select v from h where k between 4 and 5",
        "explain select v from h where k between 1 and 9",
        "insert into h values (-3, 99)", "select v from h where k = -3",
        "explain select v from h where k = -3", "show create table h",
        "select partition_name, table_rows from information_schema.partitions "
        "where table_name = 'h' order by partition_name",
    ),
    "list": R + (
        "insert into r values (9, 7)",
        "explain select id from r where region = 3", "select id from r where region = 3",
        "select id from r where region in (2, 9) order by id",
        "explain select id from r where region > 3", "show create table r",
        "alter table r add partition (partition north values in (5, 6))",
        "insert into r values (6, 5)",
        "alter table r add partition (partition dup values in (3))",
        "alter table r truncate partition west", "select count(*) from r",
        "alter table r drop partition east", "select id from r order by id",
        "select id from r where region = 5", "explain select id from r where region = 5",
        "create table q (id int, k int) partition by list (k) (partition a values in (1))",
        "insert into q values (1, NULL)",
        "select * from information_schema.partitions where table_name in ('r', 'q') "
        "order by table_name, partition_ordinal_position",
    ),
    "add_partition": M + (
        "alter table m add partition (partition p3 values less than (40), "
        "partition pmax values less than maxvalue)",
        "insert into m values (5, 35), (6, 99)", "select count(*) from m",
        "select id from m where d >= 30 order by id",
        "explain select id from m where d between 30 and 39",
        "alter table m add partition (partition bad values less than (25))",
    ),
    "add_validation": M + (
        "alter table m add partition (partition bad values less than (25))",
        "alter table m add partition (partition p1 values less than (40))",
        "alter table m add partition (partition pmax values less than maxvalue)",
        "alter table m add partition (partition p9 values less than (99))",
        "alter table m add partition (partition x values in (1))",
    ),
    "drop_partition": M + (
        "alter table m drop partition p1", "select id from m order by id",
        "insert into m values (7, 8), (8, 27)", "select id from m where d >= 20 order by id",
        "explain select id from m where d >= 20", "alter table m drop partition nope",
        "alter table m drop partition p0, p2",
    ),
    "truncate_partition": M + (
        "alter table m truncate partition p1", "select id from m order by id",
        "insert into m values (9, 12)", "select id from m where d between 10 and 19",
        "alter table m truncate partition p0, p2", "select count(*) from m",
    ),
    "hash_refusals": (
        "create table h (id int) partition by hash (id) partitions 4",
        "alter table h add partition (partition p9 values less than (10))",
        "alter table h drop partition p0", "alter table h truncate partition p0",
    ),
    "show_create_after_ddl": M + (
        "alter table m drop partition p0",
        "alter table m add partition (partition p3 values less than (40))",
        "show create table m",
    ),
    "update_then_drop": M + (
        "update m set id = id + 10 where d = 16", "delete from m where d = 5",
        "alter table m drop partition p1", "select id, d from m order by id",
    ),
    "fk_restrict_and_cascade": (
        "create table parent (pk int primary key, d int) partition by range (d) ("
        "partition p0 values less than (10), partition p1 values less than (20))",
        "insert into parent values (1, 5), (2, 15)",
        "create table child (id int, ref int, foreign key (ref) references parent (pk))",
        "insert into child values (100, 2)",
        "alter table parent drop partition p1", "select count(*) from parent",
        "drop table child",
        "create table child (id int, ref int, foreign key (ref) references parent (pk) "
        "on delete cascade)",
        "insert into child values (100, 2), (101, 1)",
        "alter table parent drop partition p1", "select id from child order by id",
        "alter table parent truncate partition p0", "select count(*) from child",
    ),
    "ddl_in_transaction": M + (
        "begin", "alter table m drop partition p1", "alter table m truncate partition p1",
        "insert into m values (10, 11)", "select id from m where d between 10 and 19 order by id",
        "rollback", "select count(*) from m",
        "begin", "insert into m values (11, 28)",
        "select id from m where d >= 20 order by id", "commit",
        "select id from m where d >= 20 order by id",
    ),
    "exchange": M + (
        "create table stage (id int, d int)", "insert into stage values (50, 11), (51, 19)",
        "alter table m exchange partition p1 with table stage",
        "select id from m order by id", "select id from stage order by id",
        "explain select id from m where d between 10 and 19",
        "select id from m where d between 10 and 19 order by id",
    ),
    "exchange_validation": M + (
        "create table stage (id int, d int)", "insert into stage values (50, 25)",
        "alter table m exchange partition p1 with table stage",
        "alter table m exchange partition p1 with table stage without validation",
        "select id from stage order by id", "alter table m exchange partition p7 with table stage",
        "alter table stage exchange partition p1 with table m",
    ),
    "exchange_mismatch": M + (
        "create table bad1 (id int, d varchar(10))",
        "alter table m exchange partition p1 with table bad1",
        "create table bad2 (id int, d int) partition by range (d) "
        "(partition q values less than (99))",
        "alter table m exchange partition p1 with table bad2",
        "create table bad3 (id int primary key, d int)",
        "alter table m exchange partition p1 with table bad3",
    ),
    "exchange_strings": (
        "create table logs (d int, msg varchar(40)) partition by range (d) ("
        "partition a values less than (10), partition b values less than (20))",
        "insert into logs values (1, 'alpha'), (15, 'kappa'), (16, 'zeta')",
        "create table stage (d int, msg varchar(40))",
        "insert into stage values (12, 'omega'), (13, 'alpha')",
        "alter table logs exchange partition b with table stage",
        "select msg from logs order by d", "select msg from stage order by d",
        "select count(*) from logs where msg = 'alpha'",
    ),
    "exchange_unique_conflict": (
        "create table m (id int primary key, d int) partition by range (d) ("
        "partition p0 values less than (10), partition p1 values less than (20))",
        "insert into m values (5, 1), (6, 15)",
        "create table stage (id int primary key, d int)", "insert into stage values (5, 15)",
        "alter table m exchange partition p1 with table stage",
        "select count(*) from m", "select count(*) from stage",
    ),
    "exchange_multiblock_dictionary": (
        "create table t (d int, w varchar(10)) partition by range (d) ("
        "partition a values less than (10), partition b values less than (20))",
        "insert into t values (1, 'mmm'), (15, 'zzz')", "create table stage (d int, w varchar(10))",
        "insert into stage values (11, 'omega')", "insert into stage values (12, 'beta')",
        "alter table t exchange partition b with table stage",
        "select w from t order by d", "select w from stage order by d",
        "select count(*) from t where w = 'omega'",
    ),
    "exchange_list": R + (
        "create table stage (id int, region int)", "insert into stage values (70, 2), (71, 4)",
        "alter table r exchange partition west with table stage",
        "select id from r where region in (2, 4) order by id", "select id from stage",
        "create table bad (id int, region int)", "insert into bad values (9, 1)",
        "alter table r exchange partition west with table bad",
    ),
    "encodings": (
        "create table dp (k decimal(10, 2), v int) partition by range (k) ("
        "partition lo values less than (10.5), partition hi values less than (100.25))",
        "insert into dp values (1.25, 1), (10.5, 2), (99.99, 3)",
        "explain select v from dp where k < 10", "explain select v from dp where k >= 11",
        "select v from dp where k >= 10.5 order by v",
        "show create table dp",
        "create table tp (ts datetime, v int) partition by range (ts) ("
        "partition a values less than ('2024-01-01 12:00:00'), "
        "partition b values less than maxvalue)",
        "insert into tp values ('2024-01-01 11:59:59', 1), ('2024-01-01 12:00:00', 2)",
        "explain select v from tp where ts >= '2024-01-02'", "show create table tp",
        "select partition_name, partition_description, table_rows from "
        "information_schema.partitions where table_name in ('dp', 'tp') "
        "order by table_name, partition_name",
    ),
    "ddl_refusals": (
        "create table s1 (a varchar(5)) partition by hash (a) partitions 2",
        "create table s2 (a int) partition by range (b) (partition p values less than (1))",
        "create table s3 (a int) partition by range (a) (partition p0 values less than maxvalue, "
        "partition p1 values less than (5))",
        "create table s4 (a int) partition by range (a) (partition p0 values less than (5), "
        "partition p1 values less than (5))",
        "create table s5 (a int) partition by list (a) (partition p0 values in (1), "
        "partition p1 values in (1))",
        "create table s6 (a int) partition by hash (a) partitions 0",
        "create table s7 (a int) partition by range (a) (partition p0 values in (1))",
        "create temporary table s8 (a int) partition by hash (a) partitions 2",
        "create table s9 (a int, b int) partition by hash (a) partitions 2",
        "alter table s9 add column z int, drop partition p0",
        "alter table s9 add column z int, exchange partition p0 with table s9",
        "create table s10 like s9", "show create table s10", "insert into s10 values (1, 2)",
        "select partition_name, table_rows from information_schema.partitions "
        "where table_name = 's10' order by partition_name",
    ),
}


def _part_counts(t):
    out = {}
    for b in t.blocks():
        out[b.part_id] = out.get(b.part_id, 0) + b.nrows
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_partition_statements_match_jax(case):
    """Rows, errors and stored state as the JAX Session's, and every
    table's partition defs and rows per partition id."""
    pair = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    for sql in CASES[case]:
        pair.run(sql)
    for name in pair.ts.catalog.tables("test"):
        jt, tt = pair.js.catalog.table("test", name), pair.ts.catalog.table("test", name)
        assert tt.partition == jt.partition, (name, tt.partition, jt.partition)
        assert _part_counts(tt) == _part_counts(jt), (name, _part_counts(tt), _part_counts(jt))
        pair.state(name)


def test_rows_carry_their_partition_ids():
    """RANGE routes NULL to the lowest partition, LIST to the one listing
    NULL; each block holds one partition's rows."""
    s = Session(Catalog(), device="cpu")
    s.execute(SALES[0])
    s.execute(SALES[1])
    assert _part_counts(s.catalog.table("test", "sales")) == {0: 2, 1: 2, 2: 1}
    s.execute(R[0])
    s.execute(R[1])
    t = s.catalog.table("test", "r")
    assert _part_counts(t) == {0: 2, 1: 1, 2: 2}
    for b in t.blocks():
        c = b.columns["region"]
        got = t.partition_of(c.data[c.valid]) if c.valid.any() else np.array([2])
        assert (got == b.part_id).all()


def _two_sessions():
    jcat, tcat = JaxCatalog(), Catalog()
    return (WritePair(JaxSession(jcat), Session(tcat, device="cpu")),
            WritePair(JaxSession(jcat), Session(tcat, device="cpu")))


def test_pinned_snapshot_prunes_with_the_old_defs():
    """A transaction pinned before DROP PARTITION reads the old rows,
    pruned (and shown in EXPLAIN) with the old defs; after COMMIT the new
    defs apply."""
    a, b = _two_sessions()
    a.runs(*M)
    b.runs("begin", "select id from m where d >= 20 order by id")
    a.run("alter table m drop partition p0")
    b.runs("select id from m where d < 10 order by id",
           "select id from m where d >= 20 order by id",
           "explain select id from m where d < 10",
           "explain select id from m where d >= 20", "commit",
           "select id from m order by id", "explain select id from m where d < 10")


def test_stale_read_prunes_with_the_old_defs():
    """A reader pinned by tidb_snapshot before DROP and TRUNCATE PARTITION
    reads the old rows through the old defs' pruning; the current reader
    the new ones."""
    import time

    def plan(sql):
        return "\n".join(r[0] for r in s.execute("explain " + sql).rows)

    s = Session(Catalog(), device="cpu")
    s.execute(M[0])
    s.execute(M[1])
    s.execute("alter table m truncate partition p2")
    time.sleep(0.02)
    ts = time.time()
    time.sleep(0.02)
    s.execute("alter table m drop partition p0")
    assert s.execute("select id from m order by id").rows == [(2,), (4,)]
    s.execute(f"set tidb_snapshot = '{ts}'")
    assert s.execute("select id from m where d < 10").rows == [(1,)]
    assert s.executor.last_compiled.scans[0].partitions == (0,)
    assert "partitions=[p0]" in plan("select id from m where d < 10")
    assert s.execute("select id from m order by id").rows == [(1,), (2,), (4,)]
    s.execute("set tidb_snapshot = ''")
    assert s.execute("select id from m where d < 10").rows == []
    assert s.executor.last_compiled.scans[0].partitions == (0,)
    assert "partitions=[p1]" in plan("select id from m where d < 10")


def test_setting_the_partition_column_moves_rows():
    """An UPDATE of the partitioning column routes each row to its new
    partition (the rewrite path), so pruned reads still find it; rows
    equal a full scan's. (The JAX session's columnar UPDATE keeps the old
    tag, and its pruned read then misses the row.)"""
    s = Session(Catalog(), device="cpu")
    s.execute(M[0])
    s.execute(M[1])
    assert s.execute("update m set d = 27 where id = 1").affected == 1
    t = s.catalog.table("test", "m")
    assert _part_counts(t) == {1: 2, 2: 2}
    assert s.execute("select id from m where d >= 20 order by id").rows == [(1,), (3,)]
    assert s.execute("select id from m where d < 10").rows == []
    s.execute("update m join m as m2 on m.id = m2.id set m.d = 3 where m.id = 4")
    assert _part_counts(t) == {0: 1, 1: 1, 2: 2}
    assert s.execute("select id from m where d < 10").rows == [(4,)]


def test_pruned_read_copies_fewer_bytes():
    """A pruned scan copies only its partitions' blocks to the device:
    the same rows as the unpartitioned table's read, fewer host->device
    bytes, and its cached set sits beside the whole table's without
    evicting it."""
    from tidb_tpu_torch.storage import scan as _scan

    s = Session(Catalog(), device="cpu")
    rows = ", ".join(f"({i}, {i % 40}, {i * 3})" for i in range(4000))
    s.execute("create table flat (id int, d int, v int)")
    s.execute("create table part (id int, d int, v int) partition by range (d) ("
              + ", ".join(f"partition p{k} values less than ({10 * (k + 1)})" for k in range(4))
              + ")")
    for t in ("flat", "part"):
        s.execute(f"insert into {t} values {rows}")
        _scan.release(s.catalog.table("test", t))  # the auto-analyze's scan
    q = "select sum(v), count(*) from {} where d >= 10 and d < 20"
    h0 = TRANSFERS["h2d_bytes"]
    want = s.execute(q.format("flat")).rows
    flat_bytes = TRANSFERS["h2d_bytes"] - h0
    h0 = TRANSFERS["h2d_bytes"]
    got = s.execute(q.format("part")).rows
    part_bytes = TRANSFERS["h2d_bytes"] - h0
    assert got == want and s.executor.last_compiled.scans[0].partitions == (1,)
    assert 0 < part_bytes < flat_bytes / 2, (part_bytes, flat_bytes)
    assert s.execute("select sum(v) from part").rows == s.execute("select sum(v) from flat").rows
    t = s.catalog.table("test", "part")
    sets = _scan.cached_partition_sets()[t.uid]
    assert set(sets) == {(1,), None}, sets
    h0 = TRANSFERS["h2d_bytes"]
    assert s.execute(q.format("part")).rows == want
    assert TRANSFERS["h2d_bytes"] == h0  # warm: the pruned set stayed cached


@pytest.fixture(scope="module")
def tpch_p():
    """tpch_p under the partition phase's DDL at sf 0.002 in both
    packages, loaded from the tpch tables' blocks."""
    import chip_smoke
    from tidb_tpu.bench.tpch import load_tpch as jax_load_tpch

    names = ["lineitem", "orders", "customer", "supplier", "nation", "region", "part",
             "partsupp"]
    jcat = JaxCatalog()
    jax_load_tpch(jcat, sf=0.002, seed=1, tables=names)
    tcat = port_catalog(jcat, "tpch", names)
    js, ts = JaxSession(jcat, db="tpch"), Session(tcat, db="tpch", device="cpu")
    for sess, cat in ((js, jcat), (ts, tcat)):
        for sql in chip_smoke.partition_ddl(cat):
            sess.execute(sql)
        chip_smoke.partition_load(cat)
    return WritePair(js, ts)


def test_partition_phase_lists_match_jax(tpch_p):
    """Each read of the partition phase (P2) prunes to the partitions the
    JAX package's pruning keeps, under the same DDL (the EXPLAIN lines
    equal the JAX Session's); the lists are pinned (Q6 keeps p1994, the
    controls every partition), and each query's rows over tpch_p equal
    its rows over the unpartitioned tables."""
    import chip_smoke

    lists = {}
    for name, sql in chip_smoke.partition_reads(0.002):
        tpch_p.run("use tpch_p")
        got = tpch_p.run("explain " + sql).rows
        lists[name] = sorted(r[0].split("partitions=")[1].split(" ")[0]
                             for r in got if "partitions=" in r[0])
        rows = tpch_p.ts.execute(sql).rows
        tpch_p.run("use tpch")
        flat = tpch_p.ts.execute(sql).rows
        assert same_rows(rows, flat, " order by " in sql.lower()), name
    assert lists == chip_smoke.PARTITION_LISTS, lists


def test_partition_phase_routing(tpch_p):
    """The loaded partitions hold what numpy counts per year, per hash
    bucket and per region, and information_schema.partitions says so."""
    import chip_smoke

    tpch_p.run("select table_name, partition_name, table_rows from "
               "information_schema.partitions where table_schema = 'tpch_p' "
               "order by table_name, partition_ordinal_position")
    chip_smoke.partition_prove(tpch_p.ts.catalog, tpch_p.ts)


def test_pruned_scans_stream_sort_and_partition(monkeypatch):
    """A pruned scan that streams, takes the host-merged ORDER BY or grace
    hash reads only its kept partitions: each spill record counts the
    kept rows, and every result equals the unpartitioned table's and the
    JAX Session's over the same partitioned tables (with the same
    tidb_tpu_stream_rows)."""
    from tidb_tpu_torch.planner import physical

    s, js = Session(Catalog(), device="cpu"), JaxSession(JaxCatalog())
    rows = ", ".join(f"({i}, {i % 40}, {i % 7}, {(i * 13) % 997}, {i % 1500})"
                     for i in range(6000))
    for t, part in (("flat", ""), ("pa", " partition by range (d) ("
                    + ", ".join(f"partition p{k} values less than ({10 * (k + 1)})"
                                for k in range(4)) + ")")):
        for sess in (s, js):
            sess.execute(f"create table {t} (id int, d int, g int, v int, k int){part}")
            sess.execute(f"insert into {t} values {rows}")
    for sess in (s, js):
        sess.execute("create table pb like pa")
        sess.execute("insert into pb select * from pa")
    s.execute("create table fb like flat")
    s.execute("insert into fb select * from flat")
    kept = 3000  # d in [10, 30): two of the four partitions

    def both(sql, path, **kw):
        stream_rows = kw.get("stream_rows", -1)
        s.executor.stream_rows = stream_rows
        got = s.execute(sql.format(a="pa", b="pb")).rows
        recs = list(s.executor.stream_log)
        want = s.execute(sql.format(a="flat", b="fb")).rows
        assert got == want, (sql, got, want)
        js.execute(f"set tidb_tpu_stream_rows = {stream_rows}")
        jrows = js.execute(sql.format(a="pa", b="pb")).rows
        assert same_rows(got, jrows, " order by " in sql), (sql, got, jrows)
        assert [r["path"] for r in recs] == [path], recs
        return recs[0]

    rec = both("select g, count(*), sum(v) from {a} where d >= 10 and d < 30 group by g "
               "order by g", "streamed", stream_rows=500)
    assert rec["rows"] == kept and rec["chunks"] == 6, rec
    rec = both("select id, v from {a} where d >= 10 and d < 30 order by v, id",
               "sort", stream_rows=500)
    assert rec["rows"] == kept, rec
    monkeypatch.setattr(physical, "_MAX_CAP", 1024)
    rec = both("select count(*), sum(v) from {a} where d >= 10 and d < 30 and exists "
               "(select 1 from {b} where {b}.k = {a}.k and {b}.d >= 20)", "partitioned")
    assert rec["K"] >= 2, rec


@pytest.mark.parametrize("sql,what", [
    ("backup log to 'bk'", "BACKUP LOG"),
    ("restore point from 'bk' until 5", "RESTORE POINT"),
])
def test_what_stays_unported_names_itself(sql, what):
    """The log backup and point-in-time recovery beside BACKUP / RESTORE
    stay refused, by name, before any lock."""
    s = Session(Catalog(), device="cpu")
    s.execute("create table t (a int, d date) partition by hash (a) partitions 2")
    with pytest.raises(NotImplementedError, match=what):
        s.execute(sql)


@pytest.mark.parametrize("kind", ["backup", "restore"])
def test_partition_backup_restore_match_jax(kind, tmp_path):
    """Partitioned tables through BACKUP and RESTORE (once refused): a
    RANGE and a HASH table, backed up by each package and restored into a
    fresh catalog of the same package (``backup``) or of the other
    (``restore``), keep their rows, their partition defs and each block's
    partition, and prune as before."""
    stmts = ("create database pb",
             "create table pb.r (a int, d date) partition by range (a) "
             "(partition p0 values less than (10), partition p1 values less than maxvalue)",
             "create table pb.h (a int, d date) partition by hash (a) partitions 3",
             "insert into pb.r values (1, '2024-01-01'), (15, null), (9, '2023-05-05')",
             "insert into pb.h values (1, null), (2, '2024-02-02'), (5, '2022-01-01')")
    p = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    p.runs(*stmts)
    p.js.execute(f"backup database pb to '{tmp_path / 'j'}'")
    p.ts.execute(f"backup database pb to '{tmp_path / 't'}'")
    src = {"backup": ("j", "t"), "restore": ("t", "j")}[kind]
    q = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    q.js.execute(f"restore database pb from '{tmp_path / src[0]}'")
    q.ts.execute(f"restore database pb from '{tmp_path / src[1]}'")
    for name in ("r", "h"):
        q.state(name, db="pb")
        jt, tt = q.js.catalog.table("pb", name), q.ts.catalog.table("pb", name)
        assert [b.part_id for b in jt.blocks()] == [b.part_id for b in tt.blocks()]
        assert tt.partition == p.ts.catalog.table("pb", name).partition
    q.runs("select a, d from pb.r where a < 10 order by a", "select count(*) from pb.h where a = 2")
    assert tuple(q.ts.executor.last_compiled.scans[0].partitions) == (2,)


@pytest.mark.parametrize("sql", [
    "create table tt (a int, d date) ttl = d + interval 1 day",
    "admin check table t",
    "load data infile 'rows.txt' into table t",
], ids=["TTL", "ADMIN statements", "LOAD DATA"])
def test_once_refused_construct_matches_jax(sql):
    """TTL, ADMIN CHECK (with its partition tagging) and LOAD DATA, once
    refused here, give the JAX Session's answer over a partitioned table."""
    pair = WritePair(JaxSession(), Session(Catalog(), device="cpu"))
    pair.runs("create table t (a int, d date) partition by hash (a) partitions 2",
              "insert into t values (1, '2020-01-01'), (2, null), (3, '2021-02-03')",
              sql, "admin check table t", "select count(*) from t")
    pair.state("t")
