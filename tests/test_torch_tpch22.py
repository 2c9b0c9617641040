"""All of TPC-H through the port: the 23 queries of tests/test_tpch_sql.py
(its text, read from that file) through the JAX package's Session and
the port's ``Session(device="cpu")`` over the same sf 0.002 data after
ANALYZE of the eight tables, rows equal (in order under ORDER BY, as
multisets without it, floats within 1e-12 relative). Each numpy oracle of
``tidb_tpu_torch.bench.oracles.TPCH_QUERIES`` is held equal to the JAX
session's rows at that file's parameter values. Where a query finds no
rows in this data (Q11, Q20, Q22), a variant with other constants that
finds some runs too. Each query runs once per session."""

import ast
import os

import pytest

from tidb_tpu.bench import load_tpch as jax_load_tpch
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu_torch.bench.oracles import TPCH_QUERIES, check_rows
from tidb_tpu_torch.session import Session

from _torch_parity import port_catalog, same_rows

HERE = os.path.dirname(os.path.abspath(__file__))
SF = 0.002
TABLES = ["orders", "lineitem", "customer", "supplier", "nation", "region", "part", "partsupp"]


def _test_file_queries():
    """{query name: SQL} of tests/test_tpch_sql.py: the text passed to
    each test's first must_query, with the test's own constants bound."""
    tree = ast.parse(open(os.path.join(HERE, "test_tpch_sql.py")).read())
    out = {}
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_q")):
            continue
        env = {}
        for st in fn.body:
            if not isinstance(st, ast.Assign):
                continue
            if isinstance(st.value, ast.Constant):
                env[st.targets[0].id] = st.value.value
            elif isinstance(st.value, ast.Call) and getattr(st.value.func, "attr", "") == "must_query":
                expr = ast.Expression(st.value.args[0])
                out[fn.name[len("test_"):]] = eval(compile(expr, fn.name, "eval"), env)
                break
    return out


QUERIES = _test_file_queries()

# (query, replacements in its text, oracle parameters): constants under
# which the queries that find no rows at sf 0.002 find some
VARIANTS = {
    "q11_rows": ("q11", [("'GERMANY'", "'JAPAN'"), ("0.005", "0.01")],
                 {"fraction": "0.01", "nation": "JAPAN"}),
    "q20_rows": ("q20", [("'CANADA'", "'JAPAN'")], {"nation": "JAPAN"}),
    # every customer has orders at this scale: only early orders count
    "q22_rows": ("q22", [("where o_custkey = c_custkey", "where o_custkey = c_custkey "
                          "and o_orderdate < date '1992-06-01'")], None),
}


def _variant_sql(name):
    base, repl, _params = VARIANTS[name]
    sql = QUERIES[base]
    for a, b in repl:
        assert a in sql, (name, a)
        sql = sql.replace(a, b)
    return sql


ALL = {**QUERIES, **{n: _variant_sql(n) for n in VARIANTS}}


@pytest.fixture(scope="module")
def tpch():
    jcat = JaxCatalog()
    jax_load_tpch(jcat, sf=SF, seed=11)
    tcat = port_catalog(jcat, "tpch", TABLES)
    jsess, tsess = JaxSession(jcat, db="tpch"), Session(tcat, db="tpch", device="cpu")
    for t in TABLES:
        jsess.execute(f"analyze table {t}")
        tsess.execute(f"analyze table {t}")
    return jsess, tsess, tcat, {}


def _rows(tpch, name):
    """(JAX result, port result) of a query, each run once per module."""
    jsess, tsess, _tcat, done = tpch
    if name not in done:
        done[name] = (jsess.execute(ALL[name]), tsess.execute(ALL[name]))
    return done[name]


def test_test_file_holds_23_queries():
    assert len(QUERIES) == 23, sorted(QUERIES)
    assert set(TPCH_QUERIES) <= set(QUERIES)


@pytest.mark.parametrize("name", list(ALL))
def test_query_matches_jax_session(tpch, name):
    want, got = _rows(tpch, name)
    assert got.columns == want.columns
    assert [repr(t) for t in got.types] == [repr(t) for t in want.types]
    ordered = " order by " in ALL[name]
    assert same_rows(got.rows, want.rows, ordered), (got.rows[:3], want.rows[:3])
    if name in VARIANTS:
        assert len(want.rows) > 0


@pytest.mark.parametrize("name", list(TPCH_QUERIES))
def test_oracle_text_is_the_test_files(name):
    q = TPCH_QUERIES[name]
    assert q.sql.format(**q.test_params) == QUERIES[name]


@pytest.mark.parametrize("name", list(TPCH_QUERIES) + [n for n, v in VARIANTS.items() if v[2] is not None])
def test_oracle_matches_jax_session(tpch, name):
    base, params = (VARIANTS[name][0], VARIANTS[name][2]) if name in VARIANTS else (name, None)
    q = TPCH_QUERIES[base]
    want, _got = _rows(tpch, name)
    check_rows(want.rows, q.oracle(tpch[2], **(q.test_params if params is None else params)),
               q.order, q.limit)
