"""Views in the port against the JAX package: the literal statements of
tests/test_views.py through both Sessions (CREATE [OR REPLACE] VIEW,
DROP VIEW, expansion in queries, the errors, SHOW TABLES / SHOW CREATE
VIEW / SHOW TABLE STATUS, information_schema and the privilege rules of
a view's definer)."""

import pytest

import tidb_tpu  # noqa: F401
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog

from _torch_parity import one_thread, WritePair  # noqa: F401 (one_thread)

BASE = ["create table t (a int, b int, c varchar(20))",
        "insert into t values (1, 10, 'x'), (2, 20, 'y'), (3, 30, 'x'), (4, 40, 'z')"]


@pytest.fixture()
def pair():
    p = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    p.runs(*BASE)
    return p


CASES = {
    "select_from_view": ["create view v as select a, b from t where b >= 20",
                         "select * from v order by a"],
    "column_list": ["create view v (x, y) as select a, b * 2 from t",
                    "select x, y from v where x <= 2 order by x"],
    "alias_and_join": ["create view v as select a, c from t",
                       "select v1.a, v2.a from v v1 join v v2 on v1.c = v2.c "
                       "where v1.a < v2.a order by v1.a"],
    "aggregate_over_view": ["create view v as select a, b, c from t",
                            "select c, sum(b) s from v group by c order by c"],
    "view_over_view": ["create view v1 as select a, b from t where a > 1",
                       "create view v2 as select a from v1 where b < 40",
                       "select * from v2 order by a"],
    "sees_fresh_data": ["create view v as select count(*) n from t", "select n from v",
                        "insert into t values (5, 50, 'w')", "select n from v"],
    "or_replace": ["create view v as select a from t", "create view v as select b from t",
                   "create or replace view v as select b from t", "select * from v order by b"],
    "cte_shadows_view": ["create view v as select a from t",
                         "with v as (select 99 a) select a from v"],
    "unknown_source_at_create": ["create view v as select * from nosuch"],
    "column_list_arity": ["create view v (x) as select a, b from t"],
    "duplicate_output_names": ["create view v as select a, a from t"],
    "recursive_definition": ["create view v1 as select a from t",
                             "create view v2 as select a from v1",
                             "create or replace view v1 as select a from v2"],
    "dml_on_view": ["create view v as select a from t", "insert into v values (9)",
                    "delete from v where a = 1", "update v set a = 2"],
    "drop_table_on_view": ["create view v as select a from t", "drop table v", "drop view v",
                           "drop view v", "drop view if exists v"],
    "create_table_name_collision": ["create view v as select a from t",
                                    "create table v (x int)"],
    "show_and_information_schema": [
        "create view v as select a from t", "show tables", "show full tables",
        "show create view v", "show create table t", "show table status",
        "select table_name, table_rows from information_schema.tables "
        "where table_schema = 'test' order by table_name",
        "select table_schema, table_name, view_definition, definer "
        "from information_schema.views"],
    "column_list_kept": ["create view v (x) as select a from t where b > 15",
                         "select x from v order by x", "show create view v"],
    "infoschema_columns": ["create view v (x, y) as select a, c from t",
                           "select column_name, data_type from information_schema.columns "
                           "where table_name = 'v' order by ordinal_position"],
    "cross_db_scalar_subquery": [
        "create database other", "create table other.t (a int)",
        "insert into other.t values (7), (8)",
        "create view other.vmax as select a from t where a = (select max(a) from t)",
        "select * from other.vmax"],
    "cte_name_shadowing_scoped": [
        "create database db2", "create table db2.t2 (a int)",
        "insert into db2.t2 values (5), (6)",
        "create view db2.vx as select (select max(a) from t2) m, q "
        "from (with t2 as (select 1 q) select q from t2) d",
        "select * from db2.vx"],
    "drop_database_drops_views": ["create database dv", "create view dv.w as select a from t",
                                  "drop database dv", "create database dv",
                                  "select * from dv.w"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_view_statements_match_jax(pair, case):
    for sql in CASES[case]:
        pair.run(sql)
    if case == "recursive_definition":
        # each package raises its own planner's PlanError, with one text
        errs = []
        for s in (pair.js, pair.ts):
            with pytest.raises(Exception, match="recursively defined") as info:
                s.execute("select * from v1")
            errs.append(str(info.value))
        assert errs[0] == errs[1], errs


def _as(pair, user):
    return WritePair(JaxSession(pair.js.catalog, user=user),
                     Session(pair.ts.catalog, user=user, device="cpu"))


@pytest.mark.parametrize("case", ["definer", "denied", "insert_select", "create_needs_select"])
def test_view_privileges_match_jax(pair, case):
    """A view is read with SELECT on the view alone; CREATE VIEW needs
    SELECT on its sources; a view is a read like a table inside a DML."""
    if case == "definer":
        pair.runs("create user u1 identified by ''", "create view v as select a from t",
                  "grant select on test.v to u1")
        _as(pair, "u1").runs("select * from v order by a", "select * from t")
    elif case == "denied":
        pair.runs("create user u2 identified by ''", "create view v as select a from t")
        _as(pair, "u2").run("select * from v")
    elif case == "insert_select":
        pair.runs("create user u4 identified by ''", "create view v as select a from t",
                  "create table sink (a int)", "grant insert on test.sink to u4",
                  "grant select on test.sink to u4")
        _as(pair, "u4").run("insert into sink select a from v")
    else:
        pair.runs("create user u3 identified by ''", "grant create on test.* to u3")
        _as(pair, "u3").run("create view leak as select a from t")
