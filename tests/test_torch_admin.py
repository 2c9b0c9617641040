"""The port's ADMIN statements against the JAX package's Session.

Every case of tests/test_admin_check.py through both Sessions
(``WritePair``: rows, affected counts and error texts equal), the
corruption cases mapped onto each package's own structures: a write path
that skips its uniqueness check (the JAX failpoint
``storage/append-skip-unique``, the port's ``Table._check_unique``
patched out), a tampered range index (the JAX ``_idx_cache`` keyed by
version, the port's keyed by block uids), a tampered composite
uniqueness index (the JAX ``_comp_cache``, the port's ``_key_cache``),
a vanished parent, a flipped partition tag and a dangling dictionary
code. ADMIN CHECKSUM TABLE's values are compared bit for bit.
"""

import dataclasses

import numpy as np
import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu.utils import failpoint
from tidb_tpu_torch.session import Session

from _torch_parity import one_thread, WritePair  # noqa: F401 (one_thread)


@pytest.fixture()
def pair():
    p = WritePair(JaxSession(), Session(device="cpu"))
    p.runs("create database adm", "use adm")
    yield p
    failpoint.disable_all()


def tables(pair, name):
    return pair.js.catalog.table("adm", name), pair.ts.catalog.table("adm", name)


# ---------------------------------------------------------------------------
# tests/test_admin_check.py TestAdminCheckClean
# ---------------------------------------------------------------------------


def test_clean_table_passes(pair):
    pair.runs("create table t (id int primary key, v varchar(8), k int)",
              "create unique index uk on t (k)", "create index iv on t (v)",
              "insert into t values (1, 'a', 10), (2, 'b', 20), (3, null, 30)",
              "select * from t where k = 20",
              "admin check table t", "admin check index t uk", "admin check index t primary",
              "admin check index t iv", "check table t")


def test_clean_partitioned_and_fk(pair):
    pair.runs("create table p (id int primary key)",
              "create table c (x int, pid int, constraint f foreign key (pid) references p (id))",
              "create table r (a int, b int) partition by range (a) ("
              "partition p0 values less than (10), partition p1 values less than maxvalue)",
              "insert into p values (1), (2)", "insert into c values (5, 1), (6, null)",
              "insert into r values (3, 1), (15, 2)",
              "admin check table p, c, r", "check table p, c, r, nope")


def test_unknown_index_and_table_errors(pair):
    pair.runs("create table t (a int)", "admin check index t nope",
              "admin check index t primary", "admin check table nope")


def test_show_ddl(pair):
    r = pair.run("admin show ddl jobs")
    assert r.rows and r.rows[0][1] == ""


def test_composite_keys_both_sort_paths(pair):
    """A composite key packed into one int64 and one whose ranges do not
    fit (sorted lexicographically), clean and then duplicated."""
    pair.runs("create table w (a bigint, b bigint, c double, primary key (a, b))",
              "create unique index uc on w (a, c)",
              "insert into w values (1, 1, 0.5), (1, 2, -0.0), "
              "(9223372036854775000, -9223372036854775000, 2.5)",
              "admin check table w", "admin check index w uc")
    jt, tt = tables(pair, "w")
    failpoint.enable("storage/append-skip-unique", True)
    tt._check_unique = lambda block: None
    pair.run("insert into w values (1, 1, 0.0)")
    failpoint.disable("storage/append-skip-unique")
    pair.runs("admin check table w", "admin check index w primary", "admin check index w uc",
              "check table w")


# ---------------------------------------------------------------------------
# tests/test_admin_check.py TestAdminCheckDetectsCorruption
# ---------------------------------------------------------------------------


def test_skipped_unique_detected(pair):
    pair.runs("create table t (id int primary key, v int)", "insert into t values (1, 10)")
    failpoint.enable("storage/append-skip-unique", True)
    tables(pair, "t")[1]._check_unique = lambda block: None
    pair.run("insert into t values (1, 99)")
    failpoint.disable("storage/append-skip-unique")
    for sql in ("admin check table t", "admin check index t primary"):
        e = pair.run(sql)
        assert isinstance(e, ValueError) and "duplicate" in str(e), e


def test_tampered_index_cache_detected(pair):
    pair.runs("create table t (id int primary key, v int)",
              "insert into t values (3, 1), (1, 2), (2, 3)", "select * from t where id = 2")
    jt, tt = tables(pair, "t")
    key = (jt.version, "id")
    svals, perm, nvalid = jt._idx_cache[key]
    bad = svals.copy()
    bad[0] = 999  # a flipped value in the sorted bookkeeping
    jt._idx_cache[key] = (bad, perm, nvalid)
    tt._sorted_index("id")
    key = (tuple(b.uid for b in tt.blocks()), "id")
    svals, perm, nvalid = tt._idx_cache[key]
    bad = svals.copy()
    bad[0] = 999
    tt._idx_cache[key] = (bad, perm, nvalid)
    e = pair.run("admin check index t primary")
    assert isinstance(e, ValueError) and "disagrees" in str(e), e


def test_tampered_composite_cache_detected(pair):
    pair.runs("create table t (a int, b int)", "create unique index ab on t (a, b)",
              "insert into t values (1, 1), (1, 2)", "insert into t values (2, 1)",
              # a refused duplicate brings each uniqueness index up to date
              "insert into t values (1, 2)", "admin check index t ab")
    jt, tt = tables(pair, "t")
    uids, view = jt._comp_cache[("a", "b")]
    jt._comp_cache[("a", "b")] = (uids, view[:-1])
    uids, view = tt._key_cache[("rows", ("a", "b"))]
    tt._key_cache[("rows", ("a", "b"))] = (uids, view[:-1])
    e = pair.run("admin check index t ab")
    assert isinstance(e, ValueError) and "composite view" in str(e), e


def test_fk_closure_violation_detected(pair):
    pair.runs("create table p (id int primary key)",
              "create table c (pid int, constraint f foreign key (pid) references p (id))",
              "insert into p values (1)", "insert into c values (1)")
    for t in tables(pair, "p"):
        t.replace_blocks([], modified_rows=1)  # a partial restore: the parent row vanishes
    e = pair.run("admin check table c")
    assert isinstance(e, ValueError) and "without parent" in str(e), e
    pair.run("check table c")


def test_string_fk_closure(pair):
    pair.runs("create table p (code varchar(4) primary key)",
              "create table c (code varchar(4), constraint f foreign key (code) "
              "references p (code))",
              "insert into p values ('a'), ('b')", "insert into c values ('a'), (null)",
              "admin check table c")
    for t in tables(pair, "p"):
        t.replace_blocks([], modified_rows=2)
    pair.run("admin check table c")


def test_partition_mistag_detected(pair):
    pair.runs("create table r (a int) partition by range (a) ("
              "partition p0 values less than (10), partition p1 values less than maxvalue)",
              "insert into r values (3), (15)")
    for t in tables(pair, "r"):
        # flip each block's tag: its rows now sit in the wrong partition
        t._versions[t.version] = [dataclasses.replace(b, part_id=1 - b.part_id)
                                  for b in t._versions[t.version]]
    e = pair.run("admin check table r")
    assert isinstance(e, ValueError) and "belong elsewhere" in str(e), e


def test_dictionary_code_range_detected(pair):
    pair.runs("create table t (v varchar(8))", "insert into t values ('a'), ('b')")
    for t in tables(pair, "t"):
        t._versions[t.version][0].columns["v"].data[0] = 99  # a dangling code
    e = pair.run("admin check table t")
    assert isinstance(e, ValueError) and "dictionary range" in str(e), e
    pair.run("check table t")


def test_update_fast_path_untagged_block_is_clean(pair):
    pair.runs("create table r2 (a int, v int) partition by range (a) ("
              "partition p0 values less than (10), partition p1 values less than maxvalue)",
              "insert into r2 values (3, 1), (15, 2)", "update r2 set v = 9 where a = 3",
              "admin check table r2")


def test_null_in_primary_key_detected(pair):
    pair.runs("create table t (id int primary key, v int)", "insert into t values (1, 1)")
    for t in tables(pair, "t"):
        t._versions[t.version][0].columns["id"].valid[0] = False
    pair.run("admin check table t")


# ---------------------------------------------------------------------------
# tests/test_admin_check.py TestAdminChecksum, the values bit for bit
# ---------------------------------------------------------------------------


def test_checksum_deterministic_and_order_independent(pair):
    pair.runs("create table c1 (a int primary key, v varchar(8))",
              "insert into c1 values (1, 'x'), (2, 'y')",
              "create table c2 (a int primary key, v varchar(8))",
              "insert into c2 values (2, 'y')", "insert into c2 values (1, 'x')")
    r1 = pair.run("admin checksum table c1").rows
    r2 = pair.run("admin checksum table c2").rows
    assert r1[0][0:2] == ("adm", "c1") and r1[0][3] == 2
    assert r1[0][2] == r2[0][2]


def test_checksum_tracks_changes(pair):
    pair.runs("create table c (a int primary key, v int)", "insert into c values (1, 10)")
    before = pair.run("admin checksum table c").rows[0][2]
    pair.run("update c set v = 11 where a = 1")
    assert pair.run("admin checksum table c").rows[0][2] != before
    pair.run("update c set v = 10 where a = 1")
    assert pair.run("admin checksum table c").rows[0][2] == before


def test_checksum_multi_table_and_null_vs_zero(pair):
    pair.runs("create table m1 (a int)", "create table m2 (a int)",
              "create table z1 (a int, v int)", "insert into z1 values (1, 0)",
              "create table z2 (a int, v int)", "insert into z2 values (1, NULL)")
    r = pair.run("admin checksum table m1, m2").rows
    assert [row[1] for row in r] == ["m1", "m2"]
    r = pair.run("admin checksum table z1, z2").rows
    assert r[0][2] != r[1][2]


def test_checksum_every_type_bit_for_bit(pair):
    """Every column kind, NULLs, -0.0, a dictionary merged over three
    appends and a deleted row: the JAX package's value exactly."""
    rng = np.random.default_rng(17)
    pair.run("create table k (i bigint, s int, f double, d date, dt datetime, tm time, "
             "m decimal(12,3), b boolean, v varchar(16), e enum('x','y'))")
    for batch in range(3):
        vals = []
        for j in range(20):
            r = rng.integers(0, 1000)
            vals.append(
                f"({r - 500}, {r % 7}, {(r - 500) / 8 if r % 5 else 'null'}, "
                f"'20{10 + r % 15}-0{1 + r % 9}-1{r % 9}', '2021-03-0{1 + r % 9} 1{r % 9}:30:00', "
                f"'0{r % 9}:1{r % 6}:00', {r / 7:.3f}, {'true' if r % 2 else 'false'}, "
                f"'w{(r * 13 + batch) % 97}', '{'xy'[r % 2]}')")
        pair.run("insert into k values " + ", ".join(vals))
    pair.runs("insert into k values (0, 0, -0.0, null, null, null, null, null, null, null)",
              "delete from k where s = 3")
    (row,) = pair.run("admin checksum table k").rows
    assert row[3] > 0


def test_crc32_of_dictionary_strings_is_zlibs():
    """The checksum's string hashes, computed on the device, are zlib's."""
    import zlib

    from tidb_tpu_torch.session.admin import crc32_strings

    rng = np.random.default_rng(5)
    alphabet = list("abcXYZ09 |\\'é中\x00\n")
    vals = ["", "a", "\x00", "x" * 300] + [
        "".join(rng.choice(alphabet, size=int(rng.integers(0, 40)))) for _ in range(500)]
    d = np.array(vals, dtype=object)
    want = np.array([zlib.crc32(v.encode()) for v in vals], dtype=np.uint64)
    assert np.array_equal(crc32_strings(d, "cpu"), want)
    assert len(crc32_strings(np.array([], dtype=object), "cpu")) == 0
