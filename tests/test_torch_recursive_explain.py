"""WITH RECURSIVE and EXPLAIN through the JAX package's
Session and the port's.

Recursive CTEs: the cases of tests/test_round2_features.py, a date spine
left-joined to a table (the statements phase's X9 shape), a CTE past
``cte_max_recursion_depth`` (the JAX error), CREATE ... AS and INSERT ...
over one, rows equal; a WITH RECURSIVE inside a subquery, which the JAX
package expands without end, refused by name; the scratch tables gone
after the statement, even after one that raised.

EXPLAIN: tests/test_sql.py's test_explain_renders, line for line (EXPLAIN
of the TPC-H queries and EXPLAIN ANALYZE:
tests/test_torch_explain_analyze.py). On a card: X6's and X9's shapes of
the statements phase, and EXPLAIN ANALYZE, against the port's CPU
Session."""

import re

import pytest

from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog

from _torch_parity import WritePair


def _jax_session():
    """A JAX package Session, imported here: the card's machine, where
    this file's gpu test runs, has no JAX."""
    import tidb_tpu  # noqa: F401
    from tidb_tpu.session import Session as JaxSession
    from tidb_tpu.storage import Catalog as JaxCatalog

    return JaxSession(JaxCatalog())


@pytest.fixture()
def pair():
    w = WritePair(_jax_session(), Session(Catalog(), device="cpu"))
    w.runs(
        "create table emp (id bigint, mgr bigint)",
        "insert into emp values (1, null), (2, 1), (3, 1), (4, 2), (5, 4), (6, 3)",
        "create table g (src bigint, dst bigint)",
        "insert into g values (1,2),(2,3),(3,1),(3,4)",
        "create table o (k bigint, d date, p decimal(10,2))",
        "insert into o values (1, '1995-01-01', 10.5), (2, '1995-01-03', 3.25), "
        "(3, '1995-01-03', 1.00), (4, '1996-01-01', 2)",
        "create table r (k bigint)", "insert into r values (0), (1)",
    )
    return w


RECURSIVE = [
    "with recursive nums(n) as (select 1 union all select n + 1 from nums where n < 10) "
    "select sum(n), count(*), max(n) from nums",
    "with recursive fib(a, b) as (select 1, 1 union all select b, a + b from fib where b < 100) "
    "select max(b) from fib",
    "with recursive sub(id) as (select id from emp where id = 2 "
    "union all select e.id from emp e, sub where e.mgr = sub.id) select id from sub order by id",
    "with recursive reach(node) as (select 1 union "
    "select g.dst from g, reach where g.src = reach.node) select node from reach order by node",
    "with recursive inf(n) as (select 1 union all select n + 1 from inf) select count(*) from inf",
    # the statements phase's date spine (X9), seeded from a table: the
    # JAX package's FROM-less seed carries no column types
    "with recursive d(day) as (select date '1995-01-01' from r where k = 0 "
    "union all select day + interval 1 day from d where day < date '1995-01-05') "
    "select d.day, count(o.k), sum(o.p) from d left join o on o.d = d.day "
    "group by d.day order by d.day",
    "with recursive d(day) as (select min(d) from o union all "
    "select day + interval 1 day from d where day < date '1995-01-03') select day from d order by day",
    "with recursive a(n) as (select 1 union all select n + 1 from a where n < 3), "
    "b(m) as (select n * 10 from a) select m from b order by m",
]


@pytest.mark.parametrize("sql", RECURSIVE, ids=range(len(RECURSIVE)))
def test_recursive_matches_jax(pair, sql):
    pair.run(sql)
    assert pair.ts.catalog.tables("_cte_scratch") == []


def test_recursion_depth_sysvar(pair):
    pair.runs(
        "set cte_max_recursion_depth = 5",
        "with recursive nums(n) as (select 1 union all select n + 1 from nums where n < 5) "
        "select count(*) from nums",
    )
    err = pair.run("with recursive nums(n) as (select 1 union all select n + 1 from nums "
                   "where n < 10) select count(*) from nums")
    assert str(err) == "recursive CTE 'nums' exceeded 5 iterations"
    assert pair.ts.catalog.tables("_cte_scratch") == []


def test_recursive_under_create_and_insert(pair):
    pair.runs(
        "create table ct as with recursive q(n) as (select 1 union all "
        "select n + 1 from q where n < 3) select n from q",
        "insert into ct with recursive q(n) as (select 5 union all "
        "select n + 1 from q where n < 6) select n from q",
        "select n from ct order by n",
    )
    pair.state("ct")


def test_recursive_in_a_subquery_is_refused(pair):
    sql = ("select * from (with recursive q(n) as (select 1 union all "
           "select n + 1 from q where n < 3) select n from q) x")
    with pytest.raises(RecursionError):
        pair.js.execute(sql)
    with pytest.raises(NotImplementedError, match="WITH RECURSIVE inside a subquery"):
        pair.ts.execute(sql)
    with pytest.raises(NotImplementedError, match="EXPLAIN of a WITH RECURSIVE"):
        pair.ts.execute("explain with recursive q(n) as (select 1 union all "
                        "select n + 1 from q where n < 3) select n from q")


def test_scratch_tables_are_private_and_dropped(pair):
    """Another connection's SHOW TABLES never lists them; a step that
    raises still drops them, and the statement's plans over them leave
    the plan cache."""
    ts = pair.ts
    other = Session(ts.catalog, device="cpu")
    before = len(ts.executor._cache)
    ts.execute("with recursive q(n) as (select 1 union all select n + 1 from q where n < 50) "
               "select count(*) from q")
    assert ts.cte_log[0]["steps"] == 50 and ts.cte_log[0]["rows"] == 50
    assert other.execute("show tables").rows == ts.execute("show tables").rows
    assert ts.catalog.tables("_cte_scratch") == []
    assert len(ts.executor._cache) <= before + 3
    with pytest.raises(ValueError, match="exceeded 1000 iterations"):
        ts.execute("with recursive q(n) as (select 1 union all select n + 1 from q) "
                   "select count(*) from q")
    assert ts.catalog.tables("_cte_scratch") == []


def test_explain_renders():
    """tests/test_sql.py's TestExplain, line for line."""
    w = WritePair(_jax_session(), Session(Catalog(), device="cpu"))
    w.runs("create table t (a bigint, b bigint, c varchar(10))",
           "insert into t values (1, 10, 'x'), (2, 20, 'y'), (3, 30, 'x'), (4, null, 'z'), "
           "(null, 50, null)")
    sql = "explain select c, count(*) from t where a > 1 group by c"
    rows = w.ts.execute(sql).rows
    assert rows == w.js.execute(sql).rows
    text = "\n".join(row[0] for row in rows)
    assert "Aggregate" in text and "Scan" in text and "Selection" in text
    assert isinstance(w.run("explain insert into t values (1, 2, 'q')"), ValueError)


@pytest.mark.gpu
def test_statement_shapes_on_the_card():
    """X6's REGEXP keys and X9's recursive date spine, at sf 0.01 on the
    card against the port's CPU Session over the same tables, and each
    EXPLAIN ANALYZE's rows."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tidb_tpu_torch.bench import load_tpch
    from tidb_tpu_torch.bench.oracles import X6_SQL, X9_SQL, check_rows

    cat = Catalog()
    load_tpch(cat, sf=0.01, seed=1)
    cuda, cpu = Session(cat, db="tpch"), Session(cat, db="tpch", device="cpu")
    for sql in (X6_SQL, X9_SQL):
        check_rows(cuda.execute(sql).rows, cpu.execute(sql).rows, (0,))
    sql = "explain analyze " + X6_SQL
    got, want = ([re.sub(r" time=[0-9.]+ms", "", r[0]) for r in s.execute(sql).rows]
                 for s in (cuda, cpu))
    assert got == want


def test_statements_phase_checks_on_the_cpu(monkeypatch):
    """chip_smoke.statements_phase over the port's Session on the CPU at
    sf 0.01: every run of X1-X9 passes its oracle check, X7's writes are
    refused, and X10's EXPLAIN ANALYZE roots and calls check out."""
    import os
    import sys

    import torch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke

    from tidb_tpu_torch.bench import load_tpch

    for fn in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    for fn in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu")
    monkeypatch.setattr(chip_smoke, "SF", 0.01)
    cat = Catalog()
    load_tpch(cat, sf=0.01, seed=1)
    report = {}
    # the phase's many small ops: with torch's intra-op threads they take
    # ~50x longer while the other test workers load every core
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        chip_smoke.statements_phase(cat, Session(cat, db="tpch", device="cpu"), report)
    finally:
        torch.set_num_threads(threads)
    assert {f"stmt_x{i}" for i in range(1, 11)} == set(report)
    assert report["stmt_x9"]["cte"][0]["steps"] == 365
    assert not cat.has_table("tpch", "cust_profile") and not cat.has_table("tpch", "access_log")
