"""The builtins the rest of TPC-H needs, through both ``compile_expr``s on
the same batch: [NOT] LIKE, IN, numeric CASE, the EXTRACT family and
SUBSTRING, each bound by its own package's planner over one seeded table
with NULLs, compared exactly (same dtype, equal validity, equal data where
valid). Uncorrelated scalar subqueries run through both Sessions."""

import numpy as np
import pytest

import tidb_tpu  # noqa: F401
import tidb_tpu.chunk as JC
from tidb_tpu.dtypes import DATE, DATETIME, DECIMAL, INT64, STRING, US_PER_DAY
from tidb_tpu.expression.kernels import compile_expr as jax_compile
from tidb_tpu.expression.kernels import string_expr as jax_string_expr
from tidb_tpu.parser import parse as jax_parse
from tidb_tpu.planner import build_query as jax_build
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog, TableSchema
import tidb_tpu_torch.chunk as TC
from tidb_tpu_torch.dtypes import Kind, SQLType
from tidb_tpu_torch.expression.kernels import compile_expr as torch_compile
from tidb_tpu_torch.expression.kernels import string_expr as torch_string_expr
from tidb_tpu_torch.parser import parse as torch_parse
from tidb_tpu_torch.planner import build_query as torch_build
from tidb_tpu_torch.session import Session

from _torch_parity import port_catalog, same_rows

N = 600
# leap days, both sides of the epoch, and century years (1600 and 2000
# leap, 1700 and 1900 not)
EDGE_DATES = [
    "1600-02-29", "1700-02-28", "1700-03-01", "1900-02-28", "1900-03-01",
    "1968-02-29", "1969-12-31", "1970-01-01", "1972-02-29", "1999-12-31",
    "2000-02-29", "2000-03-01", "2000-12-31", "2024-02-29", "2100-03-01",
]
STRINGS = np.array(sorted([
    "", "a", "abc", "ABC", "a.b", "a%b", "x_y", "(z)*", "a+b?", "[q]",
    "ab\ncd", "forest green", "green forest", "MEDIUM POLISHED TIN",
    "13-555-1234", "31-999-0000", "^$|\\",
]), dtype=object)

LIKE = [
    "s like 'a%'", "s like '%b'", "s like 'a_b'", "s like 'a.b'", "s like '(z)*'",
    "s like '%+%'", "s like '_'", "s like '%'", "s like ''", "s like '[q]'",
    "s like '^$|\\\\'", "s like 'ab%cd'", "s like '%green%'", "s like 'forest%'",
    "s not like 'MEDIUM POLISHED%'", "s not like '%a%b%'", "e like 'a%'",
    "e not like '%'",
]
IN = [
    "i in (1, 5, -3)", "i in (7)", "i in (1, null)", "i not in (2, 3, null)",
    "i in (null)", "d in (1.50, 2.25, -0.75)", "d in (2.25, null)",
    "dt in (date '2000-02-29', date '1969-12-31', date '1600-02-29')",
    "dt not in (date '1970-01-01')", "s in ('abc', 'a.b', 'nope')",
    "s in ('abc', null)", "s not in ('', 'a')", "e in ('a')",
]
CASE = [
    "case when i > 0 then d else 0 end",
    "case when i > 0 then d end",
    "case when i > 10 then 1.5 when i < -10 then 2 else d end",
    "case when i > 0 then d / 3 else 1 end",
    "case when i > 0 then d / 3 end",
    "case when s like 'a%' then d * 2 when i is null then 7 else -d end",
    "case when i > 0 then 1 else 0 end",
]
EXTRACT = [f"{p}(dt)" for p in (
    "year", "month", "day", "quarter", "dayofweek", "weekday", "dayofyear",
)] + ["extract(year from dt)", "extract(month from dt)", "year(ts)", "dayofyear(ts)"]
SUBSTRING = [
    "substring(s, 1)", "substring(s, 1, 2)", "substring(s, -2)",
    "substring(s, -2, 1)", "substring(s, 0)", "substring(s, 0, 3)",
    "substring(s, 3, 0)", "substring(e, 1, 2)",
]


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(5)

    def nulls(p=0.1):
        return rng.random(N) >= p

    days = rng.integers(-150_000, 150_000, N).astype(np.int32)
    edge = np.array([np.datetime64(s, "D").astype(np.int64) for s in EDGE_DATES], np.int32)
    days[: len(edge)] = edge
    micros = (rng.integers(-150_000, 150_000, N).astype(np.int64) * US_PER_DAY
              + rng.integers(0, US_PER_DAY, N))
    cols = {
        "i": JC.HostColumn(INT64, rng.integers(-20, 21, N).astype(np.int64), nulls()),
        "d": JC.HostColumn(DECIMAL(2), rng.choice([150, 225, -75, 0, 1234], N).astype(np.int64), nulls()),
        "dt": JC.HostColumn(DATE, days, nulls()),
        "ts": JC.HostColumn(DATETIME, micros, nulls()),
        "s": JC.HostColumn(STRING, rng.integers(0, len(STRINGS), N).astype(np.int32), nulls(0.15), STRINGS),
        # all NULL: an empty dictionary
        "e": JC.HostColumn(STRING, np.zeros(N, np.int32), np.zeros(N, bool), np.array([], dtype=object)),
    }
    jcat = Catalog()
    t = jcat.create_table("test", "t", TableSchema([(n, c.type) for n, c in cols.items()]))
    t.dictionaries.update({n: c.dictionary for n, c in cols.items() if c.dictionary is not None})
    t.replace_blocks([JC.HostBlock.from_columns(cols)])
    tcat = port_catalog(jcat, "test", ["t"])
    dicts = {f"t.{n}": c.dictionary for n, c in cols.items() if c.dictionary is not None}
    named = {f"t.{n}": c for n, c in cols.items()}
    jbatch = JC.block_to_batch(JC.HostBlock.from_columns(named))
    tcols = {
        n: TC.HostColumn(SQLType(Kind(c.type.kind.value), c.type.scale, c.type.collation),
                         c.data, c.valid, c.dictionary)
        for n, c in named.items()
    }
    tbatch = TC.block_to_batch(TC.HostBlock.from_columns(tcols), device="cpu")
    return jcat, tcat, dicts, jbatch, tbatch


def _bound(plan_root):
    """The select-list expression of `select <e> as c from t`."""
    p = plan_root
    while p is not None:
        for name, e in getattr(p, "exprs", None) or []:
            if name == "c" and type(e).__name__ != "ColumnRef":
                return e
        p = getattr(p, "child", None)
    raise AssertionError("no bound expression found")


def _both(engines, expr):
    jcat, tcat, *_ = engines
    sql = f"select {expr} as c from t"
    je = _bound(jax_build(jax_parse(sql)[0], jcat, "test"))
    te = _bound(torch_build(torch_parse(sql)[0], tcat, "test"))
    assert repr(je) == repr(te)
    assert repr(je.type) == repr(te.type)
    return je, te


def _same(jc, tc, rows):
    jd, jv = np.asarray(jc.data), np.asarray(jc.valid)
    td, tv = tc.data.numpy(), tc.valid.numpy()
    assert td.dtype == jd.dtype, (td.dtype, jd.dtype)
    assert (tv[rows] == jv[rows]).all()
    keep = rows & jv
    assert (td[keep] == jd[keep]).all()
    return keep


@pytest.mark.parametrize("expr", LIKE + IN + CASE + EXTRACT)
def test_builtin_matches_jax_package(engines, expr):
    _jcat, _tcat, dicts, jbatch, tbatch = engines
    je, te = _both(engines, expr)
    keep = _same(jax_compile(je, dicts)(jbatch), torch_compile(te, dicts)(tbatch),
                 np.asarray(jbatch.row_valid))
    assert keep.any() or "e " in expr or "null)" in expr


@pytest.mark.parametrize("expr", SUBSTRING)
def test_substring_matches_jax_package(engines, expr):
    _jcat, _tcat, dicts, jbatch, tbatch = engines
    je, te = _both(engines, expr)
    jfn, jdict = jax_string_expr(je, dicts)
    tfn, tdict = torch_string_expr(te, dicts)
    assert tdict.tolist() == jdict.tolist()
    _same(jfn(jbatch), tfn(tbatch), np.asarray(jbatch.row_valid))


def test_string_case_raises_naming_it(engines):
    _jcat, _tcat, dicts, _jb, tbatch = engines
    _je, te = _both(engines, "case when i > 0 then s else 'x' end")
    with pytest.raises(NotImplementedError, match="CASE"):
        torch_compile(te, dicts)(tbatch)


@pytest.fixture(scope="module")
def sessions(engines):
    jcat, tcat, *_ = engines
    return JaxSession(jcat, db="test"), Session(tcat, db="test", device="cpu")


SUBQUERIES = {
    "no_row": "select count(*) from t where i > (select i from t where i > 1000)",
    "no_row_is_null": "select count(*) from t where (select i from t where i > 1000) is null",
    "one_row": "select count(*), sum(d) from t where d > (select avg(d) from t where i > 0)",
    "in_having": (
        "select i, count(*) from t group by i "
        "having count(*) > (select count(*) from t where i = 3) order by i"
    ),
    "date": "select count(*) from t where dt > (select min(dt) from t where i = 4)",
    "datetime": "select count(*) from t where ts >= (select max(ts) from t where i < 0)",
}


@pytest.mark.parametrize("name", list(SUBQUERIES))
def test_scalar_subquery_matches_jax_session(sessions, name):
    jsess, tsess = sessions
    sql = SUBQUERIES[name]
    want = jsess.execute(sql)
    got = tsess.execute(sql)
    assert got.columns == want.columns
    assert same_rows(got.rows, want.rows, ordered=" order by " in sql), (got.rows, want.rows)


@pytest.mark.parametrize("sql", [
    "select i from t where i > 1000",
    "select avg(d) from t",
    "select min(dt) from t",
    "select max(ts) from t where i < 0",
    "select count(*) from t",
])
def test_scalar_subquery_literal_matches_jax_session(sessions, sql):
    jsess, tsess = sessions
    want = jsess._scalar_subquery(jax_parse(sql)[0])
    got = tsess._scalar_subquery(torch_parse(sql)[0])
    assert got.value == want.value and type(got.value) is type(want.value)
    assert repr(got.type) == repr(want.type)


def test_scalar_subquery_of_many_rows_raises(sessions):
    jsess, tsess = sessions
    sql = "select count(*) from t where i > (select i from t where i > 5)"
    with pytest.raises(ValueError, match="more than one row"):
        jsess.execute(sql)
    with pytest.raises(ValueError, match="more than one row"):
        tsess.execute(sql)
