"""Sequences and LOCAL TEMPORARY tables in the port against the JAX
package (the shapes of tests/test_seq_temptable.py but persistence and
BR): CREATE / DROP SEQUENCE with START, INCREMENT, MINVALUE, MAXVALUE and
CYCLE, NEXTVAL / LASTVAL / SETVAL (per row in INSERT ... VALUES, LASTVAL
per session), information_schema.sequences and the namespace shared with
tables and views; temporary tables invisible to other sessions and to
SHOW TABLES, shadowing a shared table of their name, preferred by DROP,
under CREATE ... AS SELECT and inside transactions. Each statement goes
through both Sessions (``_torch_parity.WritePair``), a second session of
each package over the same catalog where the case needs one."""

import pytest

import tidb_tpu  # noqa: F401
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog

from _torch_parity import one_thread, same_rows, WritePair  # noqa: F401 (one_thread)


class NamedPair(WritePair):
    """WritePair, with errors compared by class name and text: each
    package raises its own SequenceExhausted and ParseError."""

    def run(self, sql):
        try:
            want = self.js.execute(sql)
        except Exception as e:
            with pytest.raises(Exception) as info:
                self.ts.execute(sql)
            got = (type(info.value).__name__, str(info.value))
            assert got == (type(e).__name__, str(e)), (sql, got, str(e))
            return e
        got = self.ts.execute(sql)
        assert (got.affected, got.columns) == (want.affected, want.columns), sql
        assert same_rows(got.rows, want.rows, " order by " in sql.lower()), (sql, got.rows,
                                                                             want.rows)
        return got


def _pairs():
    """Two sessions of each package over one catalog each, in database
    sq: (this session, another session)."""
    jcat, tcat = JaxCatalog(), Catalog()
    a = NamedPair(JaxSession(jcat), Session(tcat, device="cpu"))
    a.runs("create database sq", "use sq")
    b = NamedPair(JaxSession(jcat, db="sq"), Session(tcat, db="sq", device="cpu"))
    return a, b


SEQUENCES = {
    "nextval_lastval": ["create sequence s1", "select nextval(s1)", "select nextval(s1)",
                        "select lastval(s1)", "select nextval(sq.s1), lastval(s1)"],
    "lastval_before_nextval": ["create sequence s2", "select lastval(s2)"],
    "start_increment": ["create sequence s3 start with 10 increment by 5",
                        "select nextval(s3)", "select nextval(s3)"],
    "setval": ["create sequence s4", "select setval(s4, 100)", "select nextval(s4)",
               "select lastval(s4)"],
    "exhaustion": ["create sequence s5 start with 1 maxvalue 2", "select nextval(s5)",
                   "select nextval(s5)", "select nextval(s5)"],
    "cycle": ["create sequence s6 start with 2 minvalue 1 maxvalue 3 cycle"]
    + ["select nextval(s6)"] * 4,
    "descending": ["create sequence sd increment by -2 start with 0 maxvalue 0",
                   "select nextval(sd)", "select nextval(sd)"],
    "bad_definitions": ["create sequence b1 increment by 0",
                        "create sequence b2 minvalue 10 maxvalue 5",
                        "create sequence b3 start with 50 maxvalue 10",
                        "create sequence if not exists b4", "create sequence if not exists b4",
                        "create sequence b4", "select nextval(nosuch)"],
    "insert_values_per_row": ["create sequence sid", "create table t (id int, v int)",
                              "insert into t values (nextval(sid), 10), (nextval(sid), 20)",
                              "select id, v from t order by id", "select lastval(sid)",
                              "insert into t select nextval(sid), v from t",
                              "select id, v from t order by id, v"],
    "drop": ["create sequence sg", "drop sequence sg", "select nextval(sg)",
             "drop sequence if exists sg", "drop sequence sg"],
    "namespace": ["create table nt (a int)", "create sequence nt", "create sequence ns1",
                  "create table ns1 (a int)", "create view ns1 as select 1",
                  "create view vv as select 1", "create sequence vv"],
    "information_schema": [
        "create sequence si start with 7 increment by 3 maxvalue 99",
        "create sequence sc minvalue 1 maxvalue 3 cycle cache 10",
        "select sequence_name, start_value, increment, max_value from "
        "information_schema.sequences where sequence_schema = 'sq' and sequence_name = 'si'",
        "select * from information_schema.sequences order by sequence_name",
        "drop sequence sc", "select count(*) from information_schema.sequences"],
}

TEMPORARY = {
    "basic": ["create temporary table tt (a int, b varchar(8))",
              "insert into tt values (1, 'x'), (2, 'y')", "select b from tt where a = 2",
              "show create table tt", "create temporary table tt (a int)",
              "create temporary table if not exists tt (a int)"],
    "not_in_show_tables": ["create table perm (a int)", "create temporary table th (a int)",
                           "show tables", "select table_name from information_schema.tables "
                           "where table_schema = 'sq'"],
    "shadows_and_drop": ["create table sh (a int)", "insert into sh values (100)",
                         "create temporary table sh (a int)", "insert into sh values (1)",
                         "select a from sh", "drop temporary table sh", "select a from sh"],
    "drop_prefers_temp": ["create table dp (a int)", "create temporary table dp (a int)",
                          "insert into dp values (5)", "drop table dp",
                          "select count(*) from dp", "drop table dp", "select * from dp"],
    "drop_temporary_only": ["create table od (a int)", "drop temporary table od",
                            "drop temporary table if exists od", "select count(*) from od"],
    "join_with_permanent": ["create table base (k int, v varchar(8))",
                            "insert into base values (1, 'one'), (2, 'two')",
                            "create temporary table pick (k int)", "insert into pick values (2)",
                            "select v from base join pick on base.k = pick.k"],
    "generated_and_autoinc": ["create temporary table tg (id int primary key auto_increment, "
                              "a int, d int as (a * 2) stored)", "insert into tg (a) values (5)",
                              "insert into tg (a) values (7)", "select id, d from tg order by id"],
    "transaction": ["create temporary table tx (a int)", "begin", "insert into tx values (1)",
                    "select a from tx", "commit", "select a from tx", "begin",
                    "insert into tx values (2)", "rollback", "select a from tx"],
    "update_delete": ["create temporary table ud (a int, b int)",
                      "insert into ud values (1, 10), (2, 20)", "update ud set b = 99 where a = 1",
                      "delete from ud where a = 2", "select a, b from ud"],
    "ctas_ignores_shadow": ["create temporary table cx (y int)", "insert into cx values (7)",
                            "create table cx as select 1 as z", "select y from cx",
                            "create table cx as select 2 as z"],
    "temporary_as_select": ["create table src2 (v int)", "insert into src2 values (3), (4)",
                            "create temporary table tsel as select v * 10 as w from src2",
                            "select w from tsel order by w", "show tables",
                            "create temporary table tsel as select 1"],
    "like": ["create table src3 (a int primary key, b varchar(4))",
             "create temporary table t3 like src3", "insert into t3 values (1, 'a')",
             "insert into t3 values (1, 'b')", "select * from t3", "show tables"],
    "refusals": ["create temporary table if not exists nosuchdb.tt (a int)",
                 "create table parent (k int primary key)",
                 "create temporary table c (x int, foreign key (x) references parent (k))",
                 "create temporary table p (a int) partition by hash (a) partitions 2"],
}


@pytest.mark.parametrize("case", list(SEQUENCES))
def test_sequence_statements_match_jax(case):
    a, _b = _pairs()
    a.runs(*SEQUENCES[case])


@pytest.mark.parametrize("case", list(TEMPORARY))
def test_temporary_table_statements_match_jax(case):
    a, _b = _pairs()
    a.runs(*TEMPORARY[case])


def test_lastval_is_per_session_and_the_allocator_shared():
    a, b = _pairs()
    a.runs("create sequence sl", "select nextval(sl)")
    b.runs("select lastval(sl)", "select nextval(sl)", "select lastval(sl)")
    a.run("select lastval(sl)")


def test_temporary_tables_are_invisible_to_other_sessions():
    a, b = _pairs()
    a.runs("create table sh (a int)", "insert into sh values (100)",
           "create temporary table sh (a int)", "insert into sh values (1)",
           "create temporary table tp (a int)", "insert into tp values (1)")
    b.runs("select * from tp", "select a from sh", "insert into sh values (200)",
           "create temporary table tp (z int)", "insert into tp values (9)", "select z from tp")
    a.runs("select a from sh", "select a from tp", "drop temporary table sh",
           "select a from sh order by a", "create table cx2 as select 1 as z")
    b.run("select z from cx2")
