"""Generated columns (STORED and VIRTUAL) in the port against the JAX
package: the literal statements of tests/test_generated.py through both
Sessions (INSERT, INSERT ... SELECT, ON DUPLICATE KEY UPDATE, UPDATE,
transactions, indexes over a generated column, the DDL validation,
ALTER TABLE ... ADD ... AS with its backfill, MODIFY of an input, the
guards and SHOW CREATE TABLE), and the logical export's INSERTs, which
leave generated columns out."""

import pytest

import tidb_tpu  # noqa: F401
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog

from _torch_parity import one_thread, WritePair  # noqa: F401 (one_thread)


@pytest.fixture()
def pair():
    p = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    p.runs("create database gentest", "use gentest")
    return p


CASES = {
    # TestCreateInsert
    "stored_computes": ["create table t (a int, b int, c int generated always as (a + b) stored)",
                        "insert into t (a, b) values (1, 2), (10, 20)",
                        "select c from t order by a"],
    "virtual_computes": ["create table t (a int, b int, c int as (a * b) virtual)",
                         "insert into t (a, b) values (3, 4)"],
    "string_expr": ["create table p (first varchar(8), last varchar(8), "
                    "fullname varchar(20) as (concat(first, ' ', last)) stored)",
                    "insert into p (first, last) values ('Ada', 'Byron')",
                    "select fullname from p"],
    "case_and_chained": ["create table t (a int, b int as (a * 2) stored, "
                         "big varchar(4) as (case when b > 10 then 'yes' else 'no' end) stored)",
                         "insert into t (a) values (3), (30)"],
    "null_propagation": ["create table t (a int, b int, c int as (a + b) stored)",
                         "insert into t (a, b) values (1, null)"],
    "explicit_value_rejected": ["create table t (a int, c int as (a + 1) stored)",
                                "insert into t (a, c) values (1, 99)",
                                "insert into t values (1, null)"],
    "insert_select": ["create table src (x int)", "insert into src values (5), (6)",
                      "create table t (a int, c int as (a * 10) stored)",
                      "insert into t (a) select x from src", "select sum(c) from t"],
    # TestDDLValidation
    "unknown_dep": ["create table t (a int, c int as (zz + 1) stored)"],
    "later_generated_dep": ["create table t (a int, c int as (d + 1) stored, "
                            "d int as (a + 1) stored)"],
    "autoinc_dep": ["create table t (id int primary key auto_increment, "
                    "c int as (id + 1) stored)"],
    "default_on_generated": ["create table t (a int, c int as (a + 1) stored default 5)"],
    "unsupported_function": ["create table t (a int, c double as (rand() + a) stored)"],
    "virtual_pk": ["create table t (a int, c int as (a + 1) virtual, primary key (c))"],
    # TestDML
    "update_recomputes": ["create table t (a int, b int, c int as (a + b) stored)",
                          "insert into t (a, b) values (1, 2)",
                          "update t set a = 100 where b = 2"],
    "set_generated_rejected": ["create table t (a int, c int as (a + 1) stored)",
                               "insert into t (a) values (1)", "update t set c = 5"],
    "on_duplicate_recomputes": ["create table t (a int primary key, b int, "
                                "c int as (a + b) stored)",
                                "insert into t (a, b) values (1, 10)",
                                "insert into t (a, b) values (1, 99) "
                                "on duplicate key update b = 20",
                                "insert into t (a, b) values (1, 5) "
                                "on duplicate key update c = 20"],
    "txn_insert_commit": ["create table t (a int, c int as (a * 3) stored)", "begin",
                          "insert into t (a) values (7)", "select c from t", "commit"],
    "where_on_generated": ["create table t (a int, c int as (a * 2) stored)",
                           "insert into t (a) values (1), (5), (9)",
                           "select a from t where c >= 10 order by a"],
    "index_on_generated": ["create table t (a int, c int as (a * 2) stored)",
                           "create index ic on t (c)", "insert into t (a) values (1), (5), (9)",
                           "select a from t where c = 10"],
    # TestAlter
    "alter_add_backfills": ["create table t (a int, b int)", "insert into t values (1, 2), (3, 4)",
                            "alter table t add column s int generated always as (a + b) stored",
                            "select s from t order by a",
                            "insert into t (a, b) values (10, 20)"],
    "modify_dep_recomputes": ["create table t (a varchar(8), c varchar(16) "
                              "as (concat(a, '!')) stored)",
                              "insert into t (a) values ('7'), ('8')",
                              "alter table t modify column a int",
                              "select c from t order by a"],
    "drop_dep_blocked": ["create table t (a int, c int as (a + 1) stored)",
                         "alter table t drop column a"],
    "drop_generated_ok": ["create table t (a int, c int as (a + 1) stored)",
                          "insert into t (a) values (1)", "alter table t drop column c",
                          "insert into t values (2)", "show create table t"],
    "rename_dep_blocked": ["create table t (a int, c int as (a + 1) stored)",
                           "alter table t rename column a to z"],
    "change_rename_dep_blocked": ["create table t (a varchar(10), "
                                  "g int as (char_length(a)) stored)",
                                  "insert into t (a) values ('123')",
                                  "alter table t change a b int",
                                  "insert into t (a) values ('4567')"],
    "modify_to_generated": ["create table t (a int, c int)",
                            "alter table t modify c int as (a + 1) stored"],
    "alter_add_with_default": ["create table t (a int)",
                               "alter table t add column g int default 9 as (a * 2) stored"],
    "show_create_clause": ["create table t (a int, c int generated always as (a + 1) virtual)",
                           "show create table t", "create table t2 like t",
                           "insert into t2 (a) values (4)", "show create table t2"],
    "multi_alter_rolls_back_rule": ["create table t (a int, b int)", "insert into t values (1, 2)",
                                    "alter table t add column s int as (a + b) stored, "
                                    "add column z int, drop column nosuch",
                                    "show create table t", "insert into t values (3, 4)"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_generated_statements_match_jax(pair, case):
    for sql in CASES[case]:
        pair.run(sql)
    for name in pair.ts.catalog.tables("gentest"):
        pair.state(name, db="gentest")


def test_dump_leaves_generated_columns_out(pair, tmp_path):
    """The logical export writes the DDL with the generated clause and
    INSERTs that name only the base columns, as the JAX package's."""
    from tidb_tpu.tools.dump import dump_table_sql as jax_dump
    from tidb_tpu_torch.tools.dump import dump_table_sql

    pair.runs("create table t (a int, b varchar(4), c int as (a * 2) stored, "
              "check (a >= 0))", "insert into t (a, b) values (1, 'x'), (2, null)")
    jax_dump(pair.js.catalog.table("gentest", "t"), str(tmp_path / "j.sql"))
    dump_table_sql(pair.ts.catalog.table("gentest", "t"), str(tmp_path / "p.sql"))
    want = (tmp_path / "j.sql").read_text()
    assert (tmp_path / "p.sql").read_text() == want
    assert "INSERT INTO `t` (`a`, `b`) VALUES" in want
