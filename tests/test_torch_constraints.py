"""CHECK and FOREIGN KEY constraints with their ON DELETE / ON UPDATE
actions in the port against the JAX package: the literal statements of
tests/test_constraints.py through both Sessions (rows, affected counts,
error texts and the stored state of every table), the vectorized key
sets against the JAX package's Python-set algorithm, and the constrained
columnar UPDATE against the JAX rewrite."""

import numpy as np
import pytest

import tidb_tpu  # noqa: F401
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu_torch.chunk import HostColumn
from tidb_tpu_torch.dtypes import DATE, INT64, STRING, Kind, SQLType
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.session.constraints import (
    KeySet, domain_values, fk_domain, member_mask, natural_domain,
)
from tidb_tpu_torch.storage import Catalog

from _torch_parity import one_thread, WritePair  # noqa: F401 (one_thread)


@pytest.fixture()
def pair():
    """A fresh catalog pair for each case: the JAX session plans a DML's
    WHERE against the first database holding a table of its name
    (ROADMAP section 3), so cases must not share a catalog."""
    return WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))


FK = ["create table parent (id int primary key, v int)",
      "insert into parent values (1, 10), (2, 20)",
      "create table child (id int, pid int, foreign key (pid) references parent (id))"]
ACTIONS = [
    "create table p (id int primary key, v int)",
    "create table c (id int, pid int, constraint fc foreign key "
    "(pid) references p (id) on delete cascade)",
    "create table g (id int, cid int, constraint fg foreign key "
    "(cid) references c (id) on delete cascade)",
    "create table n (id int, pid int, constraint fn foreign key "
    "(pid) references p (id) on delete set null)",
    "insert into p values (1, 10), (2, 20)",
    "insert into c values (100, 1), (101, 1), (102, 2)",
    "insert into g values (1000, 100), (1001, 102)",
    "insert into n values (5, 1), (6, 2)",
]

CASES = {
    # TestCheck
    "basic_check": ["create table t (a int, b int, check (a > 0))",
                    "insert into t values (1, 2)", "insert into t values (0, 5)"],
    "null_passes": ["create table t (a int, check (a > 0))", "insert into t values (null)"],
    "named_multi_column": ["create table t (lo int, hi int, constraint ordered check (lo <= hi))",
                           "insert into t values (1, 5)", "insert into t values (9, 5)"],
    "column_level_check": ["create table t (pct int check (pct between 0 and 100))",
                           "insert into t values (50)", "insert into t values (101)"],
    "check_on_update": ["create table t (a int, check (a < 10))", "insert into t values (5)",
                        "update t set a = 20 where a = 5"],
    "check_strings_in": ["create table t (s varchar(10), check (s in ('a', 'b')))",
                         "insert into t values ('a')", "insert into t values ('c')"],
    "unknown_column_at_create": ["create table t (a int, check (b > 0))"],
    "atomic_multi_row_insert": ["create table t (a int, check (a > 0))",
                                "insert into t values (1), (2), (-1)"],
    "drop_column_guard": ["create table t (a int, b int, check (a > 0))",
                          "alter table t drop column a", "alter table t drop column b",
                          "show create table t"],
    "bare_numeric_check": ["create table t (a int, check (a))", "insert into t values (1)",
                           "insert into t values (0)"],
    # TestForeignKey
    "child_insert": FK + ["insert into child values (100, 1)",
                          "insert into child values (101, 99)",
                          "insert into child values (102, null)"],
    "parent_delete_restricted": FK + [
        "insert into child values (100, 1)", "delete from parent where id = 1",
        "delete from parent where id = 2", "delete from child where id = 100",
        "delete from parent where id = 1"],
    "parent_update_restricted": FK + [
        "insert into child values (100, 1)", "update parent set id = 5 where id = 1",
        "update parent set v = 99 where id = 1"],
    "child_update_checked": FK + [
        "insert into child values (100, 1)", "update child set pid = 42 where id = 100",
        "update child set pid = 2 where id = 100"],
    "drop_parent_blocked": FK + ["drop table parent", "drop table child", "drop table parent"],
    "self_referential": [
        "create table emp (id int primary key, mgr int, foreign key (mgr) references emp (id))",
        "insert into emp values (1, null), (2, 1)", "insert into emp values (3, 77)",
        "delete from emp where id = 1", "delete from emp"],
    "column_level_references": [
        "create table p (id int primary key)", "insert into p values (7)",
        "create table c (pid int references p (id))", "insert into c values (7)",
        "insert into c values (8)"],
    "unknown_parent_at_create": [
        "create table c (pid int, foreign key (pid) references ghost (id))"],
    "replace_cannot_orphan": [
        "create table p (id int primary key, code int)", "insert into p values (1, 10)",
        "create table c (x int, foreign key (x) references p (code))",
        "insert into c values (10)", "replace into p values (1, 20)",
        "replace into p values (1, 10)"],
    "show_create_lists_constraints": FK + ["show create table child",
                                           "insert into child values (101, 99)",
                                           "delete from parent where id = 1"],
    # TestFKReferentialActions
    "cascade_transitive_and_set_null": ACTIONS + [
        "delete from p where id = 1"],
    "truncate_cascades": ACTIONS + [
        "truncate table p"],
    "update_stays_restrict": ACTIONS + ["update p set id = 9 where id = 1"],
    "on_update_cascade_accepted": ACTIONS + [
        "create table okc (id int, pid int, constraint fb foreign "
        "key (pid) references p (id) on update cascade)",
        "select * from information_schema.referential_constraints"],
    "show_create_on_delete": ACTIONS + ["show create table c", "delete from p where id = 1"],
    # TestCompositeKeys
    "composite_pk": ["create table t (a int, b int, c int, primary key (a, b))",
                     "insert into t values (1, 1, 10), (1, 2, 20)",
                     "insert into t values (1, 2, 99)", "insert into t values (1, 3, 30)"],
    "composite_unique_index": [
        "create table t (a int, b int, v int)", "create unique index uab on t (a, b)",
        "insert into t values (1, 1, 10), (1, 2, 20), (2, 1, 30)",
        "insert into t values (2, 1, 99)", "insert into t values (2, null, 1), (2, null, 2)"],
    "composite_ignore_odku_replace": [
        "create table t (a int, b int, v int, primary key (a, b))",
        "insert into t values (1, 1, 10)",
        "insert ignore into t values (1, 1, 99), (1, 2, 20)",
        "insert into t values (1, 1, 99), (3, 3, 30) on duplicate key update v = values(v)",
        "create table u (a int, b int, v int)", "create unique index uab on u (a, b)",
        "insert into u values (1, 1, 10), (1, 2, 20)", "replace into u values (1, 1, 99)",
        "replace into u values (5, 5, 1), (5, 5, 2)"],
    "composite_typed_components": [
        "create table t (dt date, n int, v int, primary key (dt, n))",
        "insert into t values ('1994-01-01', 1, 10)",
        "replace into t values ('1994-01-01', 1, 99)",
        "insert ignore into t values ('1994-01-01', 1, 50)",
        "insert into t values ('1994-01-01', 1, 77) on duplicate key update v = values(v)",
        "create table d (d decimal(6,2), n int, v int, primary key (d, n))",
        "insert into d values (1.25, 1, 10)", "insert into d values (1.25, 1, 20)",
        "replace into d values (1.25, 1, 30)",
        "create table k (k varchar(8), n int, v int, primary key (k, n))",
        "replace into k values ('aa', 1, 1), ('bb', 1, 2)",
        "replace into k values ('cc', 1, 3), ('cc', 1, 4)"],
    "null_pk_ignore": [
        "create table t (a int, b int, v int, primary key (a, b))",
        "insert ignore into t values (1, null, 9), (2, 2, 8)",
        "insert ignore into t values (1, null, 7)",
        "create table u (a int, b int, primary key (a, b))", "insert into u values (1, null)"],
    # TestFKOnUpdateActions
    "on_update_cascade": [
        "create table p (id int primary key, v int)",
        "create table c (x int, pid int, constraint f foreign key "
        "(pid) references p (id) on update cascade)",
        "insert into p values (1, 10), (2, 20)",
        "insert into c values (100, 1), (101, 1), (102, 2)",
        "update p set id = 7 where id = 1",
        "update p set id = id + 100"],
    "on_update_set_null": [
        "create table p (id int primary key)",
        "create table c (x int, pid int, constraint f foreign key "
        "(pid) references p (id) on update set null)",
        "insert into p values (1), (2)", "insert into c values (100, 1), (101, 2)",
        "update p set id = 9 where id = 1"],
    "on_update_restrict_default": [
        "create table p (id int primary key)",
        "create table c (pid int, constraint f foreign key (pid) references p (id))",
        "insert into p values (1)", "insert into c values (1)",
        "update p set id = 2 where id = 1"],
    "self_fk_on_update_set_null": [
        "create table e (id int primary key, mgr int, constraint fm "
        "foreign key (mgr) references e (id) on update set null)",
        "insert into e values (1, null), (2, 1)", "update e set id = 9 where id = 1"],
    "set_null_not_leaked": [
        "create table p (id int primary key)",
        "create table c1 (pid int, constraint f1 foreign key (pid) "
        "references p (id) on update set null)",
        "create table c2 (pid int, constraint f2 foreign key (pid) references p (id))",
        "insert into p values (1)", "insert into c1 values (1)", "insert into c2 values (1)",
        "update p set id = 2 where id = 1"],
    "cascade_to_null": [
        "create table p (id int primary key, r int)",
        "create table c (rid int, constraint f foreign key (rid) "
        "references p (r) on update cascade)",
        "insert into p values (1, 5)", "insert into c values (5)",
        "update p set r = null where id = 1"],
    "nonunique_partial_rewrite_ambiguous": [
        "create table p (pk int primary key, r int)",
        "create table c (rid int, constraint f foreign key (rid) "
        "references p (r) on update cascade)",
        "insert into p values (1, 7), (2, 7)", "insert into c values (7)",
        "update p set r = 8 where pk = 1"],
    "mixed_case_constraint_name": [
        "create table p (id int primary key)",
        "create table c (pid int, constraint MyFK foreign key (pid) "
        "references p (id) on update cascade)",
        "insert into p values (1)", "insert into c values (1)",
        "update p set id = 3 where id = 1"],
    # beyond the reference file: IGNORE over CHECK and FOREIGN KEY, a
    # multi-table DELETE through a cascade, information_schema's rows,
    # the DDL guards, RENAME and LIKE
    "ignore_drops_violations": FK + [
        "alter table child add column q int",
        "create table chk (a int primary key, b int, check (b >= 0))",
        "insert ignore into child values (1, 1, 0), (2, 99, 0), (3, null, 0), (4, 2, 0)",
        "insert ignore into chk values (1, 5), (2, -1), (1, 7), (3, 0)", "show warnings"],
    "multi_table_delete_cascades": ACTIONS + [
        "create table pick (id int)", "insert into pick values (1)",
        "delete p from p join pick on p.id = pick.id"],
    "information_schema_rows": ACTIONS + [
        "create table k (a int, constraint pos check (a > 0))",
        "select * from information_schema.table_constraints where table_name in ('c', 'k')",
        "select * from information_schema.key_column_usage where table_name in ('c', 'n')",
        "select * from information_schema.referential_constraints"],
    "column_ddl_guards": ACTIONS + [
        "alter table c drop column pid", "alter table p drop column id",
        "alter table p rename column id to pid", "alter table c modify pid decimal(10,2)",
        "alter table p drop column v"],
    "rename_and_like": ACTIONS + [
        "create table k (a int, constraint pos check (a > 0))",
        "rename table p to p2", "show create table c", "delete from p2 where id = 2", "create table k2 like k", "insert into k2 values (-1)",
        "create table c2 like c", "show create table c2", "insert into c2 values (1, 999)"],
    "self_referential_ignore": [
        "create table emp (id int primary key, mgr int, foreign key (mgr) references emp (id))",
        "insert ignore into emp values (1, null), (2, 1), (3, 9), (4, 2)"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_constraint_statements_match_jax(pair, case):
    for sql in CASES[case]:
        pair.run(sql)
    for name in pair.ts.catalog.tables("test"):
        pair.state(name)


def test_drop_database_blocked_by_external_child(pair):
    pair.runs("create database pdb",
              "create table pdb.p (id int primary key)",
              "create table c (x int, foreign key (x) references pdb.p (id))",
              "drop database pdb", "drop table c", "drop database pdb")


def test_savepoints_match_jax():
    """The TestSavepoint statements of the reference file."""
    p = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    p.runs("create table t (a int)", "begin", "insert into t values (1)", "savepoint s1",
           "insert into t values (2)", "select count(*) from t", "rollback to savepoint s1",
           "select count(*) from t", "commit", "select a from t",
           "begin", "savepoint s1", "insert into t values (3)", "savepoint s2",
           "insert into t values (4)", "rollback to s1", "select count(*) from t",
           "rollback to s2", "rollback",
           "begin", "savepoint s1", "insert into t values (5)", "release savepoint s1",
           "rollback to s1", "commit", "select count(*) from t", "savepoint sx")


def test_cascade_failure_rolls_the_statement_back(monkeypatch):
    """A failure inside ON UPDATE CASCADE restores parent and child: the
    JAX package's failpoint `fk/cascade-update`, the port's cascade
    raising the same error."""
    from tidb_tpu.utils import failpoint
    from tidb_tpu_torch.session import constraints

    p = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    p.runs("create table p (id int primary key)",
           "create table c (pid int, constraint f foreign key (pid) "
           "references p (id) on update cascade)",
           "insert into p values (1)", "insert into c values (1)")

    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(constraints.ConstraintMixin, "_cascade_update_child", boom)
    failpoint.enable("fk/cascade-update", RuntimeError("boom"))
    try:
        p.run("update p set id = 2 where id = 1")
    finally:
        failpoint.disable("fk/cascade-update")
    p.runs("select id from p", "select pid from c")
    p.state("p")
    p.state("c")


# ---------------------------------------------------------------------------
# the vectorized key sets against the JAX package's set algorithm
# ---------------------------------------------------------------------------

def _column(rng, typ, n, pool, dictionary=None, nulls=0.2):
    valid = rng.random(n) >= nulls
    if typ.kind.name == "STRING":
        codes = rng.integers(0, len(dictionary), n)
        return HostColumn(typ, codes.astype(np.int32), valid, np.array(dictionary, dtype=object))
    return HostColumn(typ, rng.choice(pool, n).astype(typ.np_dtype), valid)


@pytest.mark.parametrize("kind", ["int", "decimal", "date", "string", "int_child_decimal_parent"])
def test_fk_membership_matches_the_set_algorithm(kind):
    """Per child row, "its key is among the parent's", and the dangling
    set (child values the parent lacks), computed over encoded keys,
    equal the JAX package's sets of decoded values (``_column_values``
    and the set differences of ``_enforce_parent_constraints``). Strings
    come with two different dictionaries."""
    from tidb_tpu.chunk import HostColumn as JaxColumn
    from tidb_tpu.dtypes import DATE as JDATE, INT64 as JINT, STRING as JSTR
    from tidb_tpu.dtypes import Kind as JKind, SQLType as JSQLType

    def decimal(scale):
        return SQLType(Kind.DECIMAL, scale)

    def jdec(scale):
        return JSQLType(JKind.DECIMAL, scale)

    rng = np.random.default_rng({"int": 1, "decimal": 2, "date": 3, "string": 4,
                                 "int_child_decimal_parent": 5}[kind])
    if kind == "string":
        words = [f"w{i:03d}" for i in range(60)]
        pd_ = sorted(rng.choice(words, 40, replace=False).tolist())
        cd_ = sorted(rng.choice(words, 45, replace=False).tolist())
        ptype = ctype = STRING
        parent = _column(rng, STRING, 300, None, pd_)
        child = _column(rng, STRING, 500, None, cd_)
        jp, jc = JSTR, JSTR
    else:
        pool = np.arange(-50, 400)
        ptype, jp = {"int": (INT64, JINT), "decimal": (decimal(2), jdec(2)),
                     "date": (DATE, JDATE), "int_child_decimal_parent": (decimal(2), jdec(2))}[kind]
        ctype, jc = (INT64, JINT) if kind == "int_child_decimal_parent" else (ptype, jp)
        ppool = pool * 100 if kind == "int_child_decimal_parent" else pool
        parent = _column(rng, ptype, 300, ppool[:300])
        child = _column(rng, ctype, 500, pool)

    def jax_values(col, jt):
        jcol = JaxColumn(jt, col.data, col.valid, col.dictionary)
        return {v for ok, v in zip(jcol.valid, jcol.decode()) if ok}

    pset, cset = jax_values(parent, jp), jax_values(child, jc)
    jcol = JaxColumn(jc, child.data, child.valid, child.dictionary)
    want_hit = np.array([bool(ok) and v in pset for ok, v in zip(jcol.valid, jcol.decode())])
    want_dangling = sorted(cset - pset)

    domain = fk_domain(ctype, ptype)
    nat = natural_domain(ptype)
    pv = domain_values(parent, nat)[parent.valid]
    keys = KeySet(np.sort(pv)).to_domain(ptype, domain)
    got_hit = member_mask(child, keys, domain)
    assert np.array_equal(got_hit, want_hit)
    dv = domain_values(child, domain)[child.valid & ~got_hit]
    got = np.unique(dv).tolist()
    if domain == "num":
        got = [int(v) for v in got]
    elif domain == "enc":
        got = HostColumn(ctype, np.array(got, dtype=ctype.np_dtype),
                         np.ones(len(got), bool)).decode().tolist()
    assert got == want_dangling
    # a KeySet less some values and plus others: the post-statement set
    drop, add = pv[: len(pv) // 3], np.unique(domain_values(child, nat)[child.valid][:7])
    from tidb_tpu_torch.session.constraints import multiset_removed
    post = KeySet(np.sort(pv), multiset_removed(np.sort(pv), np.sort(drop)), np.sort(add))
    want_post = (set(pv.tolist()) - (set(drop.tolist()) - set(pv[len(pv) // 3:].tolist()))) \
        | set(add.tolist())
    probe = np.concatenate([pv, add, np.unique(domain_values(child, nat))])
    assert post.contains(probe).tolist() == [v in want_post for v in probe.tolist()]


# ---------------------------------------------------------------------------
# the constrained UPDATE on the columnar path against the JAX rewrite
# ---------------------------------------------------------------------------

UPDATE_CASES = {
    "check": (["create table t (k int primary key, a int, b int, check (a <= b))",
               "insert into t values (1, 1, 5), (2, 2, 2), (3, 0, 9)"],
              ["update t set a = a + 1 where k <= 2", "update t set a = a + 1 where k = 3",
               "update t set b = b - 5 where k >= 2"]),
    "fk_child": (["create table p (id int primary key)", "insert into p values (1), (2), (3)",
                  "create table c (k int primary key, pid int, foreign key (pid) references p (id))",
                  "insert into c values (10, 1), (11, 2), (12, null)"],
                 ["update c set pid = pid + 1 where k = 10", "update c set pid = 9 where k >= 11",
                  "update c set pid = 3 where k = 12"]),
    "fk_parent_on_update_cascade": (
        ["create table p (id int primary key, r int)",
         "insert into p values (1, 5), (2, 6), (3, 7)",
         "create table c (k int, rid int, constraint f foreign key (rid) references p (r) "
         "on update cascade)",
         "create table d (k int, rid int, constraint g foreign key (rid) references p (r) "
         "on update set null)",
         "insert into c values (1, 5), (2, 6), (3, 6)", "insert into d values (1, 7)"],
        ["update p set r = r * 10 where id <= 2", "update p set r = 70 where id = 3"]),
    "fk_parent_restrict": (
        ["create table p (id int primary key, r int)", "insert into p values (1, 5), (2, 6)",
         "create table c (k int, rid int, foreign key (rid) references p (r))",
         "insert into c values (1, 5)"],
        ["update p set r = 9 where id = 1", "update p set r = 9 where id = 2"]),
    "generated_input": (
        ["create table t (k int primary key, a int, b int as (a * 2) stored, "
         "c varchar(4) as (case when b > 10 then 'big' else 'sm' end) stored, check (b < 100))",
         "insert into t (k, a) values (1, 1), (2, 4), (3, 9)"],
        ["update t set a = a + 3 where k <= 2", "update t set a = 60 where k = 3"]),
    "self_fk_child_on_update_set_null": (
        ["create table e (id int primary key, mgr int, constraint fm foreign key (mgr) "
         "references e (id) on update set null)",
         "insert into e values (1, null), (2, 1), (3, 1)"],
        ["update e set mgr = 2 where id = 1", "update e set mgr = 9 where id = 3",
         "update e set mgr = null where id = 2"]),
    "self_fk_child_on_update_cascade": (
        ["create table e (id int primary key, mgr int, constraint fm foreign key (mgr) "
         "references e (id) on update cascade)",
         "insert into e values (1, null), (2, 1), (3, 1)"],
        ["update e set mgr = 2 where id = 1", "update e set mgr = 9 where id = 3",
         "update e set mgr = 3 where id >= 2"]),
}


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_constrained_columnar_update_matches_the_rewrite(pair, case):
    """A SET of a CHECK column, an FK child column, a referenced column
    (ON UPDATE CASCADE and SET NULL) or a generated input: the port keeps
    its columnar path, touching only the matched rows, where the JAX
    session rewrites the whole table; rows, errors and the stored state
    are the same."""
    setup, updates = UPDATE_CASES[case]
    pair.runs(*setup)
    ts = pair.ts
    paths = []
    orig = type(ts)._try_columnar_update

    def spy(self, t, s, sets):
        r = orig(self, t, s, sets)
        paths.append(r is not None)
        return r

    type(ts)._try_columnar_update = spy
    try:
        for sql in updates:
            res = pair.run(sql)
            if sql.startswith("update") and not isinstance(res, Exception):
                assert paths[-1], f"{sql} left the columnar path"
    finally:
        type(ts)._try_columnar_update = orig
    for name in ts.catalog.tables("test"):
        pair.state(name)


def test_date_fk_compares_by_value():
    """A DATE FOREIGN KEY compares by value in the port: a child date
    present in the parent is admitted and an absent one refused with the
    JAX error text. (The JAX session tests the incoming string against
    the parent's decoded day numbers and refuses both, ROADMAP section
    3.)"""
    ts = Session(Catalog(), device="cpu")
    for sql in ("create table p (d date primary key)",
                "insert into p values ('1995-01-01'), ('1995-01-03')",
                "create table c (k int, d date, foreign key (d) references p (d))",
                "insert into c values (1, '1995-01-01'), (2, null), (3, '1995-01-03')"):
        ts.execute(sql)
    with pytest.raises(ValueError) as info:
        ts.execute("insert into c values (4, '1995-01-02')")
    assert str(info.value) == "FOREIGN KEY 'fk_1' violated: ['1995-01-02'] not in test.p.d"
    with pytest.raises(ValueError, match=r"restricts this statement: \[9131\] still"):
        ts.execute("delete from p where d = '1995-01-01'")
    assert ts.execute("select k, d from c order by k").rows == [
        (1, "1995-01-01"), (2, None), (3, "1995-01-03")]
