"""Top-N (ORDER BY ... LIMIT) and set operations through the port
against the JAX package.

Top-N: the packed path (every key packs into one int64), the sorted
path (keys over 62 bits, and n > 4096) and the stale-width recompile (a
SUM key past the assumed 2^39), each with ties at the LIMIT boundary:
the rows kept and their order must equal the JAX package's exactly
(``lax.top_k`` keeps the lowest row index among equal values). The path
each statement took is read from the port's compiled plan.

Set operations: UNION ALL with string columns whose dictionaries differ,
UNION, INTERSECT, EXCEPT, branches without FROM (the shapes of
tests/test_sql.py's TestUnionCte), and the chip run's reports U1-U3 at
TPC-H sf 0.002, each also held equal to its numpy oracle. A branch that
needs CAST is refused, naming it.

Rows compare with ``same_rows``: in order under ORDER BY, as multisets
without it; floats within 1e-12 relative, everything else exactly.

The JAX package is imported in the fixtures that use it, so the card's
machine, which has no JAX, can run this file's gpu test.
"""

import numpy as np
import pytest
import torch

from tidb_tpu_torch.bench.oracles import REPORT_QUERIES, check_rows
from tidb_tpu_torch.chunk import Batch, DevCol
from tidb_tpu_torch.planner.physical import _top_rows
from tidb_tpu_torch.session import Session

from _torch_parity import port_catalog, same_rows

REL = 1e-12
N_ROWS = 6000


def _values(rng):
    """Rows of tn: a (4 values), b (5 strings), c (two values 2^45 apart:
    past the 40 bits a top-N key may take from its bounds), d (a 20-bit
    range), e (unique), x (a DECIMAL), dt (3 dates), y (two values 2^39
    apart: 40 bits from its bounds), NULLs in a, b, x and dt."""
    names = np.array(["ant", "bee", "cat", "dog", "eel"])
    dates = np.array(["1995-03-01", "1996-07-15", "1999-12-31"])
    a = rng.integers(0, 4, N_ROWS)
    b = names[rng.integers(0, 5, N_ROWS)]
    c = rng.integers(0, 2, N_ROWS) * (1 << 45) + rng.integers(0, 3, N_ROWS)
    d = rng.integers(0, 1 << 20, N_ROWS) // 65536 * 65536
    e = rng.permutation(N_ROWS)
    x = rng.integers(-20, 20, N_ROWS) * 1234
    dt = dates[rng.integers(0, 3, N_ROWS)]
    y = rng.integers(0, 2, N_ROWS) * (1 << 39) + rng.integers(0, 3, N_ROWS)
    rows = []
    for i in range(N_ROWS):
        av = "null" if i % 97 == 0 else str(a[i])
        bv = "null" if i % 89 == 0 else f"'{b[i]}'"
        xv = "null" if i % 83 == 0 else f"{x[i] / 100:.2f}"
        dv = "null" if i % 79 == 0 else f"date '{dt[i]}'"
        rows.append(f"({av}, {bv}, {c[i]}, {d[i]}, {e[i]}, {xv}, {dv}, {y[i]})")
    return ", ".join(rows)


SETUP = [
    "create table tn (a int, b varchar(8), c bigint, d bigint, e bigint, x decimal(10,2), "
    "dt date, y bigint)",
    None,  # the rows of tn
    "create table s1 (k int, name varchar(8))",
    "insert into s1 values (1, 'ant'), (2, 'bee'), (3, 'cat'), (3, 'cat'), (null, 'dog'), "
    "(5, null)",
    "create table s2 (k int, name varchar(8))",
    "insert into s2 values (3, 'cat'), (4, 'cow'), (5, 'ant'), (6, 'yak'), (null, null)",
    # tests/test_sql.py's table for the TestUnionCte shapes
    "create table t (a bigint, b bigint, c varchar(10))",
    "insert into t values (1, 10, 'x'), (2, 20, 'y'), (3, 30, 'x'), (4, null, 'z'), "
    "(null, 50, null)",
]


def _jax_session():
    pytest.importorskip("jax")
    from tidb_tpu.session import Session as JaxSession

    return JaxSession()


@pytest.fixture(scope="module")
def sessions():
    js = _jax_session()
    rows = _values(np.random.default_rng(5))
    for st in SETUP:
        js.execute(st if st is not None else f"insert into tn values {rows}")
    ts = Session(port_catalog(js.catalog, "test", ["tn", "s1", "s2", "t"]), device="cpu")
    return js, ts


def _same(js, ts, sql, ordered=True):
    want = js.execute(sql).rows
    got = ts.execute(sql).rows
    assert want, sql
    assert same_rows(got, want, ordered, REL), (sql, got[:8], want[:8])
    return ts.executor.last_compiled.topn


#: (statement, the port's top-N path): every LIMIT cuts through a run of
#: rows equal on the ORDER BY keys
TOPN = [
    # packed: widths from bounds (a 3 bits, b 3, x 16, dt 11), assumed 40
    # for a COUNT
    ("select a, b, c, e from tn order by a desc, b limit 7", [("packed", 6)]),
    ("select a, b, e from tn order by b, a limit 5 offset 3", [("packed", 6)]),
    ("select a, x, e from tn order by x desc limit 4", [("packed", 16)]),
    ("select a, x, e from tn order by a desc, x limit 9", [("packed", 19)]),
    ("select e, count(*) n from tn group by e order by n desc limit 2", [("packed", 40)]),
    ("select dt, a, e from tn order by dt desc, a limit 5", [("packed", 14)]),
    # sorted: keys over 62 bits (y 40, d 20 and b 3; d, the assumed 40
    # bits of c, and b), and n > 4096
    ("select y, d, b, e from tn order by y, d desc, b limit 8", [("sorted", None)]),
    ("select c, d, b, e from tn order by d desc, c, b limit 11 offset 2", [("sorted", None)]),
    ("select a, b, e from tn order by a, b limit 4500", [("sorted", None)]),
    # stale: a key past the assumed 2^39 (c, or a window SUM of it) makes
    # the packed plan recompile without the assumption, and it sorts
    ("select a, c, e from tn order by c desc, a limit 6", [("sorted", None)]),
    ("select c, d, e from tn order by c, d limit 8", [("sorted", None)]),
    ("select e, a, sum(c) over (partition by e) s from tn order by s desc limit 3",
     [("sorted", None)]),
]


@pytest.mark.parametrize("sql,path", TOPN, ids=range(len(TOPN)))
def test_topn_matches_jax(sessions, sql, path):
    js, ts = sessions
    assert _same(js, ts, sql) == path


@pytest.mark.parametrize("kk", [1, 5, 64, 300])
def test_top_rows_tie_rule(kk):
    """The kk rows of largest packed value, equal values in row order (a
    stable descending sort's head), invalid rows (packed -1) last."""
    b, packed = _tie_input(torch.device("cpu"))
    got = _top_rows(b, packed, kk)
    want = np.argsort(-packed.numpy(), kind="stable")[:kk]
    assert got.cols["r"].data.tolist() == want.tolist()
    assert got.row_valid.tolist() == (packed.numpy()[want] >= 0).tolist()


def _tie_input(dev):
    rng = np.random.default_rng(3)
    n = 4000
    p = rng.integers(0, 6, n).astype(np.int64)
    rv = rng.random(n) > 0.2
    p = np.where(rv, p, -1)
    b = Batch({"r": DevCol(torch.arange(n, device=dev), torch.ones(n, dtype=torch.bool, device=dev))},
              torch.as_tensor(rv, device=dev))
    return b, torch.as_tensor(p, device=dev)


@pytest.mark.gpu
def test_top_rows_tie_rule_on_cuda():
    """The tie rule on CUDA tensors (torch.topk there returns equal values
    in no promised order) gives the CPU's rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for kk in (1, 5, 64, 300, 4000):
        bc, pc = _tie_input(torch.device("cuda"))
        bh, ph = _tie_input(torch.device("cpu"))
        got, want = _top_rows(bc, pc, kk), _top_rows(bh, ph, kk)
        assert got.cols["r"].data.cpu().tolist() == want.cols["r"].data.tolist(), kk
        assert got.row_valid.cpu().tolist() == want.row_valid.tolist(), kk


# ---------------------------------------------------------------------------
# set operations
# ---------------------------------------------------------------------------

SETOPS = [
    ("select k, name from s1 union all select k, name from s2 order by name, k", True),
    ("select name, k from s1 union all select name, k from s2", False),
    ("select name from s1 union select name from s2 order by name", True),
    ("select k, name from s1 union select k, name from s2", False),
    ("select k from s1 intersect select k from s2", False),
    ("select name from s1 intersect select name from s2 order by name", True),
    ("select k, name from s1 except select k, name from s2", False),
    ("select name from s2 except select name from s1 order by 1", True),
    ("select count(*), sum(k) from (select k from s1 union all select k from s2 "
     "union all select k from s1) u", False),
    ("select name, count(*) from (select name from s1 union all select name from s2) u "
     "group by name order by name", True),
    # FROM-less branches
    ("select name from s1 where k = 1 union all select 'yak' order by 1", True),
    ("select k from s1 union all select 7 union all select 8 order by 1 desc limit 3", True),
    # tests/test_sql.py's TestUnionCte shapes
    ("select a from t where a <= 1 union all select b from t where a = 1 order by 1", True),
    ("select a from t union select a from t order by a", True),
    ("select c from t where c = 'x' union all select 'new' order by 1", True),
]


@pytest.mark.parametrize("sql,ordered", SETOPS, ids=range(len(SETOPS)))
def test_setop_matches_jax(sessions, sql, ordered):
    js, ts = sessions
    _same(js, ts, sql, ordered)


def test_union_branch_needing_cast_names_it(sessions):
    js, ts = sessions
    sql = "select a from t where a = 1 union all select 2.5"
    assert sorted(v for v, in js.execute(sql).rows) == [1.0, 2.5]
    with pytest.raises(NotImplementedError, match="cast"):
        ts.execute(sql)


# ---------------------------------------------------------------------------
# the chip run's set-operation reports at sf 0.002
# ---------------------------------------------------------------------------

TPCH_TABLES = ["orders", "lineitem", "customer", "partsupp"]


@pytest.fixture(scope="module")
def tpch():
    js = _jax_session()
    from tidb_tpu.bench import load_tpch as jax_load_tpch

    jax_load_tpch(js.catalog, sf=0.002, seed=1, tables=TPCH_TABLES)
    js.execute("use tpch")
    ts = Session(port_catalog(js.catalog, "tpch", TPCH_TABLES), db="tpch", device="cpu")
    return js, ts


@pytest.mark.parametrize("name", [n for n in REPORT_QUERIES if n.startswith("u")])
def test_setop_reports(tpch, name):
    js, ts = tpch
    q = REPORT_QUERIES[name]
    want = js.execute(q.sql).rows
    got = ts.execute(q.sql).rows
    assert same_rows(got, want, q.order is not None, REL), (got, want)
    check_rows(got, q.oracle(ts.catalog), q.order, q.limit, REL)
