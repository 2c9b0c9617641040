"""SHOW, DO, the no-op statements and information_schema in the port
against the JAX package: every SHOW form and every ported
information_schema table gives the JAX Session's rows (the diagnostic
tables on their stable columns), and each table or form that stays
refused raises ``NotImplementedError`` naming itself (the shapes of
tests/test_aux.py and test_ddl_infoschema.py)."""

import pytest

import tidb_tpu  # noqa: F401
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog
from tidb_tpu_torch.storage.catalog import IS_UNPORTED

from _torch_parity import WritePair

SCHEMA = (
    "create database app",
    "create table app.users (id bigint primary key, nm varchar(8) not null, "
    "score double default 1.5, joined date)",
    "create table app.visits (uid bigint, day date, n int default 0, primary key (uid, day))",
    "create table app.log (id int primary key auto_increment, msg varchar(20))",
    "create table app.nokey (a int, b decimal(10, 2))",
    "insert into app.users values (1, 'a', 2.5, '2024-01-02'), (2, 'b', null, null)",
    "insert into app.visits values (1, '2024-01-02', 3), (2, '2024-01-03', 4)",
    "insert into app.log (msg) values ('x'), ('y'), ('z')",
    "use app",
)


@pytest.fixture(scope="module")
def pair():
    p = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    p.runs(*SCHEMA)
    return p


@pytest.mark.parametrize("sql", [
    "select table_schema, table_name, table_rows from information_schema.tables "
    "order by table_schema, table_name",
    "select table_name from information_schema.tables where table_schema = 'app' "
    "and table_rows > 2",
    "select * from information_schema.columns where table_schema = 'app' "
    "order by table_name, ordinal_position",
    "select column_name, data_type from information_schema.columns "
    "where table_name = 'users' order by ordinal_position",
    "select * from information_schema.schemata order by schema_name",
    "select * from information_schema.statistics order by table_name, seq_in_index",
    "select * from information_schema.table_constraints order by table_name",
    "select * from information_schema.key_column_usage order by table_name, ordinal_position",
    "select t.table_name, count(*) from information_schema.tables t join "
    "information_schema.columns c on t.table_name = c.table_name "
    "where t.table_schema = 'app' group by t.table_name order by t.table_name",
    "select count(*) from information_schema.tables as of timestamp 1.0",
    "select * from information_schema.no_such_table",
])
def test_information_schema_tables(pair, sql):
    pair.run(sql)


@pytest.mark.parametrize("sql", [
    "show columns from users", "show columns from app.visits", "show full columns from log",
    "describe nokey",
    "show index from visits", "show keys from nokey",
    "show create table users", "show create table visits", "show create table log",
    "show create table nokey",
    "show create database app", "show create database information_schema",
    "show create database nosuch",
    "show table status", "show table status like 'u%'",
    "show collation", "show collation like 'utf8mb4%'",
    "show charset", "show character set like 'utf8%'",
    "show open tables", "show tables", "show databases",
    "show status like 'Threads_connected'", "show status like 'Com_select'",
    "show variables like 'max_execution_time'",
    "show columns from nosuch",
])
def test_show_forms(pair, sql):
    pair.run(sql)


@pytest.mark.parametrize("sql", ["show columns from keyed", "show columns from test.keyed",
                                 "show full columns from keyed", "describe keyed"])
def test_show_columns_marks_unique_and_multiple_keys(sql):
    """A UNIQUE index's leading column shows UNI, any other index's MUL,
    the PRIMARY KEY's PRI, as the JAX Session shows them."""
    p = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    p.runs("create table keyed (id int primary key, g varchar(5), v int, d date)",
           "create unique index ug on keyed (g)", "create index iv on keyed (v, d)", sql)


def test_show_status_counts_statements():
    p = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    p.runs("select 1", "create table t (a int)", "select count(*) from t",
           "show status like 'Questions'", "show session status like 'Com_%'",
           "show global status like 'Ssl%'")


def test_show_engines_differs_only_in_its_comment(pair):
    want, got = pair.js.execute("show engines"), pair.ts.execute("show engines")
    assert got.columns == want.columns
    ((w,), (g,)) = want.rows, got.rows
    assert g[:2] == w[:2] and g[3:] == w[3:]
    assert "XLA" in w[2] and g[2] == "tidb_tpu columnar CUDA engine (InnoDB-compatible surface)"


def test_show_warnings_and_the_diagnostics_area(pair):
    pair.runs(
        "create table w (k int primary key, v int)",
        "insert ignore into w values (null, 1), (null, 2)",
        "show warnings",
        "show warnings",  # SHOW WARNINGS keeps the area
        "select count(*) from w",
        "show warnings",  # any other statement clears it
        "insert ignore into w (v) values (3)",
        "show errors",
        "drop table w",
    )
    assert pair.ts.execute("show warnings").rows == []


def test_do_flush_lock_and_optimize(pair):
    pair.runs(
        "do 1 + 1", "do 1, 'a', null", "flush tables", "lock tables users read",
        "unlock tables", "optimize table users", "optimize table users, app.visits",
        "optimize table nosuch",
    )
    assert pair.ts.catalog.table("app", "users").stats is not None  # re-analyzed


def test_use_information_schema(pair):
    pair.runs(
        "use information_schema",
        "select schema_name from schemata order by schema_name",
        "select table_name from tables where table_schema = 'app' order by table_name",
        "show tables",
        "use nosuch",
        "use app",
        "select count(*) from users",
    )


def test_information_schema_is_memoized_per_catalog_state(pair):
    """A virtual table is built once per schema version and data
    fingerprint: a read in between keeps its uid (its plan and columns
    stay cached); a write or DDL builds it anew."""
    cat = pair.ts.catalog
    a = cat.table("information_schema", "tables")
    pair.run("select count(*) from users")
    assert cat.table("information_schema", "tables") is a
    pair.run("insert into users values (9, 'z', 0, null)")
    b = cat.table("information_schema", "tables")
    assert b is not a
    pair.run("create table app.more (x int)")
    assert cat.table("information_schema", "tables") is not b
    pair.runs("select table_name, table_rows from information_schema.tables "
              "where table_schema = 'app' order by table_name",
              "delete from users where id = 9", "drop table app.more")


@pytest.mark.parametrize("name", ["sequences", "partitions"])
def test_information_schema_tables_once_refused_match_jax(name):
    """``sequences`` and ``partitions`` were refused by name until their
    features were ported; each now gives the JAX Session's rows."""
    p = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    p.runs("create table h (k int, v int) partition by hash (k) partitions 3",
           "insert into h values (1, 1), (2, 2), (4, 4), (5, null)",
           "create table plain (a int)", "create sequence sq start with 7 increment by 3",
           f"select * from information_schema.{name}",
           "use information_schema", f"select count(*) from {name}")


@pytest.mark.parametrize("name", ["memory_usage", "memory_usage_ops_history"])
def test_memory_usage_tables_match_jax(name):
    """The watchdog's tables, once refused by name, give the JAX
    Session's columns and, on their stable columns, its rows."""
    stable = {"memory_usage": "memory_total, memory_limit, memory_usage_alarm_ratio, "
                              "alarm_records, watchdog_samples",
              "memory_usage_ops_history": "op, conn_id, memory_limit, sql_text"}[name]
    got = []
    for sess in (JaxSession(JaxCatalog()), Session(Catalog(), device="cpu")):
        sess.catalog.global_sysvars["tidb_server_memory_limit"] = "50%"
        cols = sess.execute(f"select * from information_schema.{name}").columns
        got.append((cols, sess.execute(f"select {stable} from information_schema.{name}").rows))
    assert got[0] == got[1], got


#: the diagnostic tables refused by name until the statement's record
#: (the metrics registry, the flight recorder, the engine watch and
#: resource groups) was ported, each with a read of its stable columns
ONCE_REFUSED = {
    "metrics": "select name, kind from information_schema.metrics "
               "where name = 'tidbtpu_session_statements_total'",
    "resource_groups": "select name, ru_per_sec, burstable, queries "
                       "from information_schema.resource_groups order by name",
    "slow_query": "select query, digest, conn_id from information_schema.slow_query "
                  "where query like '%is_marker%' order by time",
    "statements_summary": "select digest_text, exec_count, rows_sent "
                          "from information_schema.statements_summary "
                          "where digest_text like '%is_marker%' order by digest_text",
    "statements_summary_history": "select digest_text, exec_count "
                                  "from information_schema.statements_summary_history "
                                  "where digest_text like '%is_marker%' order by digest_text",
    "tpu_engine": "select query from information_schema.tpu_engine "
                  "where query like '%is_marker%' order by qid",
}


@pytest.mark.parametrize("name", sorted(ONCE_REFUSED))
def test_diagnostic_tables_once_refused_match_jax(name):
    """Each gives the JAX Session's columns, and its stable columns'
    rows after the same statements (each package reads its own stores)."""
    from tidb_tpu.utils import metrics as jm
    from tidb_tpu_torch.utils import metrics as tm

    got = []
    for sess, m in ((JaxSession(JaxCatalog()), jm), (Session(Catalog(), device="cpu"), tm)):
        sess.execute(f"create table is_marker_{name} (a int)")
        sess.execute(f"insert into is_marker_{name} values (1), (2), (3)")
        sess.execute("create resource group rg_is ru_per_sec = 500")
        sess.execute("set tidb_slow_log_threshold = 0")
        for k in (1, 2):
            sess.execute(f"select count(*) from is_marker_{name} where a > {k}")
        m.STMT_HISTORY.rotate(m.STMT_SUMMARY)
        cols = sess.execute(f"select * from information_schema.{name}").columns
        rows = sess.execute(ONCE_REFUSED[name]).rows
        sess.execute("use information_schema")
        n = sess.execute(f"select count(*) from {name}").rows[0][0]
        got.append((cols, rows, n > 0))
    assert got[0] == got[1] and got[1][1] and got[1][2], got


@pytest.mark.parametrize("name", sorted(IS_UNPORTED))
def test_refused_information_schema_tables_name_themselves(name):
    ts = Session(Catalog(), device="cpu")
    with pytest.raises(NotImplementedError, match=f"information_schema.{name} is not ported"):
        ts.execute(f"select * from information_schema.{name}")
    ts.execute("use information_schema")
    with pytest.raises(NotImplementedError, match=f"information_schema.{name} is not ported"):
        ts.execute(f"select count(*) from {name}")


def test_refused_forms_name_themselves():
    ts = Session(Catalog(), device="cpu")
    ts.execute("create table t (a int)")
    for sql, what in (
        ("select * from metrics_schema.tidbtpu_session_statements_total",
         "metrics_schema.tidbtpu_session_statements_total is not ported"),
    ):
        with pytest.raises(NotImplementedError, match=what):
            ts.execute(sql)
