"""Window functions through the port against the JAX package.

Every statement of tests/test_window.py runs through the JAX package's
Session and the port's ``Session(device="cpu")`` over the same tables
(made with the JAX Session's DDL and DML, carried across with
``port_catalog``); a statement the JAX package refuses must be refused
by the port too. The chip run's window reports W1-W5 run the same way
over TPC-H at sf 0.002, and each is held equal to its numpy oracle.
``window_op`` itself is held against the JAX ``window_op`` on seeded
input with NULL keys, DESC order keys, one partition spanning the whole
tile, and an empty input.

Rows compare with ``same_rows``: in order under ORDER BY, as multisets
without it; floats within 1e-12 relative, everything else exactly.
``window_op``'s outputs compare the same way, but for float sums over a
running or explicit frame: both packages take those as differences of
prefix sums over the whole tile, so they agree within 1e-12 of the sum
of |values| in the tile (see ``_check``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tidb_tpu.bench import load_tpch as jax_load_tpch
from tidb_tpu.chunk import Batch as JaxBatch
from tidb_tpu.chunk import DevCol as JaxDevCol
from tidb_tpu.executor.window import WindowDesc as JaxWindowDesc
from tidb_tpu.executor.window import window_op as jax_window_op
from tidb_tpu.session import Session as JaxSession
from tidb_tpu_torch.bench.oracles import REPORT_QUERIES, check_rows
from tidb_tpu_torch.chunk import Batch, DevCol
from tidb_tpu_torch.executor.window import WindowDesc, window_op
from tidb_tpu_torch.session import Session

from _torch_parity import port_catalog, same_rows

REL = 1e-12

#: (database, DDL/DML) of each fixture table set of tests/test_window.py
SETUPS = {
    "emp": ("test", [
        "create table e (dept varchar(10), name varchar(10), sal bigint)",
        "insert into e values ('eng', 'a', 100), ('eng', 'b', 200), ('eng', 'c', 200), "
        "('ops', 'd', 50), ('ops', 'e', 150), ('hr', 'f', 75)",
    ]),
    "vals": ("test", [
        "create table w (g int, v int)",
        "insert into w values (1,10),(1,20),(1,20),(1,40),(2,5),(2,7),(2,7)",
    ]),
    "range": ("test", [
        "create table t (g int, v int)",
        "insert into t values (1,1),(1,2),(1,4),(1,8),(2,10),(2,11),(2,20)",
        "insert into t values (3, 5), (3, 5), (3, 6)",
        "create table e (d date, x int)",
        "insert into e values (date '2024-01-01', 1), (date '2024-01-03', 2), "
        "(date '2024-01-10', 4)",
        "create table e2 (d date, x int)",
    ]),
    "named": ("nw", [
        "create database nw",
        "use nw",
        "create table t (g int, v int)",
        "insert into t values (1,10),(1,20),(2,5),(2,15),(2,25)",
    ]),
}

#: (setup, statement, ordered) for every statement of tests/test_window.py
STATEMENTS = [
    ("emp", "select dept, name, row_number() over (partition by dept order by sal desc, name) "
            "from e order by dept, 3", True),
    ("emp", "select name, rank() over (partition by dept order by sal desc), "
            "dense_rank() over (partition by dept order by sal desc) "
            "from e where dept = 'eng' order by sal desc, name", True),
    ("emp", "select name, sum(sal) over (partition by dept), count(*) over (partition by dept), "
            "avg(sal) over (partition by dept), max(sal) over (partition by dept) "
            "from e order by dept, name", True),
    ("emp", "select name, sum(sal) over (partition by dept order by name) "
            "from e where dept = 'eng' order by name", True),
    ("emp", "select name, lag(sal) over (partition by dept order by name), "
            "lead(sal) over (partition by dept order by name) "
            "from e where dept = 'eng' order by name", True),
    ("emp", "select name, sum(sal) over () from e order by name limit 2", True),
    ("emp", "select dept, sum(sal) as total, rank() over (order by sum(sal) desc) as rnk "
            "from e group by dept order by rnk", True),
    ("vals", "select g, v, ntile(2) over (partition by g order by v) from w order by g, v", True),
    ("vals", "select g, first_value(v) over (partition by g order by v), "
             "last_value(v) over (partition by g order by v) from w order by g, v", True),
    ("vals", "select g, v, nth_value(v, 2) over (partition by g order by v) "
             "from w order by g, v", True),
    ("vals", "select g, v, percent_rank() over (partition by g order by v), "
             "cume_dist() over (partition by g order by v) from w order by g, v", True),
    ("vals", "select ntile(2) over (partition by g) from w", False),
    ("vals", "select first_value(v) over (partition by g order by v "
             "rows between 1 preceding and current row) from w", False),
    ("range", "select g, v, sum(v) over (partition by g order by v "
              "range between 2 preceding and 2 following) from t order by g, v", True),
    ("range", "select v, sum(v) over (order by v desc range between 1 preceding and 1 following) "
              "from t where g = 2 order by v", True),
    ("range", "select v, sum(v) over (order by v range between unbounded preceding and "
              "current row) from t where g = 3 order by v", True),
    ("range", "select d, sum(x) over (order by d range between interval 2 day preceding and "
              "current row) from e order by d", True),
    ("range", "select v, count(*) over (order by v range between 1 preceding and 1 following), "
              "avg(v) over (order by v range between 1 preceding and 1 following) "
              "from t where g = 2 order by v", True),
    ("range", "select sum(x) over (order by d range between interval 1 month preceding and "
              "current row) from e2", False),
    ("named", "select g, v, sum(v) over w, rank() over w, count(*) over w2 from t "
              "window w as (partition by g order by v), w2 as (partition by g) order by g, v", True),
    ("named", "select g, v, sum(v) over w from t window w as (partition by g order by v "
              "rows between 1 preceding and current row) order by g, v", True),
    ("named", "select sum(v) over nope from t", False),
    ("named", "select w.v from t w where w.g = 1 order by w.v", True),
    ("named", "select sum(v) over w from t window w as (partition by g), w as (order by v)",
     False),
    ("named", "select g, sum(v) over w, (select max(v) from t) from t "
              "window w as (partition by g) order by g, v", True),
    ("named", "select sum(v) over user from t window user as (partition by g) order by g, v",
     True),
]


@pytest.fixture(scope="module")
def sessions():
    out = {}
    for name, (db, stmts) in SETUPS.items():
        js = JaxSession()
        for st in stmts:
            js.execute(st)
        tables = [t for t in ("e", "w", "t", "e2") if any(f"table {t} " in st for st in stmts)]
        out[name] = (js, Session(port_catalog(js.catalog, db, tables), db=db, device="cpu"))
    return out


@pytest.mark.parametrize("setup,sql,ordered", STATEMENTS, ids=range(len(STATEMENTS)))
def test_window_statement(sessions, setup, sql, ordered):
    js, ts = sessions[setup]
    try:
        want = js.execute(sql).rows
    except Exception:  # the JAX package refuses it: so must the port
        with pytest.raises(Exception):
            ts.execute(sql)
        return
    got = ts.execute(sql).rows
    assert same_rows(got, want, ordered, REL), (got, want)


# ---------------------------------------------------------------------------
# the chip run's window reports at sf 0.002
# ---------------------------------------------------------------------------

TPCH_TABLES = ["orders", "lineitem", "customer", "partsupp"]


@pytest.fixture(scope="module")
def tpch():
    js = JaxSession()
    jax_load_tpch(js.catalog, sf=0.002, seed=1, tables=TPCH_TABLES)
    js.execute("use tpch")
    ts = Session(port_catalog(js.catalog, "tpch", TPCH_TABLES), db="tpch", device="cpu")
    return js, ts


@pytest.mark.parametrize("name", [n for n in REPORT_QUERIES if n.startswith("w")])
def test_window_reports(tpch, name):
    js, ts = tpch
    q = REPORT_QUERIES[name]
    want = js.execute(q.sql).rows
    got = ts.execute(q.sql).rows
    assert want, name
    assert same_rows(got, want, q.order is not None, REL), (got, want)
    check_rows(got, q.oracle(ts.catalog), q.order, q.limit, REL)


# ---------------------------------------------------------------------------
# window_op against the JAX window_op
# ---------------------------------------------------------------------------

CAP = 512


def _inputs(seed, n_valid, n_parts):
    """Columns of a CAP-row tile: partition key p (NULL in some rows),
    order key k with ties and NULLs, a unique row id r, an int value x and
    a float value f (both sometimes NULL)."""
    rng = np.random.default_rng(seed)
    rv = np.zeros(CAP, bool)
    rv[:n_valid] = True
    rng.shuffle(rv)
    cols = {
        "p": (rng.integers(0, n_parts, CAP), rng.random(CAP) > 0.05),
        "k": (rng.integers(-20, 20, CAP), rng.random(CAP) > 0.1),
        "r": (rng.permutation(CAP).astype(np.int64), np.ones(CAP, bool)),
        "x": (rng.integers(-1000, 1000, CAP), rng.random(CAP) > 0.15),
        "f": (rng.normal(0, 100, CAP), rng.random(CAP) > 0.15),
    }
    return cols, rv


def _both(cols, rv, parts, orders, descs):
    """Run the same window descriptors through both packages; yield each
    output column as (name, jax data, jax valid, port data, port valid)."""
    jb = JaxBatch({n: JaxDevCol(jnp.asarray(d), jnp.asarray(v)) for n, (d, v) in cols.items()},
                  jnp.asarray(rv))
    tb = Batch({n: DevCol(torch.as_tensor(d), torch.as_tensor(v)) for n, (d, v) in cols.items()},
               torch.as_tensor(rv))

    def ref(n):
        return lambda b: b.cols[n]

    part_fns = [ref(n) for n in parts]
    order_fns = [ref(n) for n in orders]
    jd = [JaxWindowDesc(f, ref(a) if a else None, out, off, sc, run, fr)
          for (f, a, out, off, sc, run, fr) in descs]
    td = [WindowDesc(f, ref(a) if a else None, out, off, sc, run, fr)
          for (f, a, out, off, sc, run, fr) in descs]
    jo = jax_window_op(jb, part_fns, order_fns, list(orders.values()), jd)
    to = window_op(tb, part_fns, order_fns, list(orders.values()), td)
    for d in descs:
        out = d[2]
        yield (out, np.asarray(jo.cols[out].data), np.asarray(jo.cols[out].valid),
               to.cols[out].data.numpy(), to.cols[out].valid.numpy())


def _check(cols, rv, parts, orders, descs):
    # both packages take a float frame sum as a difference of two prefix
    # sums over the whole sorted tile, each in its own summation order: the
    # difference is then good to 1e-12 of the prefix sums' magnitude, not
    # of the (smaller) window sum
    f, fv = cols["f"]
    prefix_scale = float(np.abs(f[fv & rv]).sum())
    for (func, arg, _o, _off, _sc, running, frame), (out, jd, jv, td, tv) in zip(
            descs, _both(cols, rv, parts, orders, descs)):
        assert np.array_equal(jv & rv, tv & rv), out
        m = jv & rv
        if jd.dtype.kind == "f":
            prefix = func in ("sum", "avg") and arg == "f" and (running or frame)
            atol = REL * prefix_scale if prefix else 0
            np.testing.assert_allclose(td[m], jd[m], rtol=REL, atol=atol, err_msg=out)
        else:
            assert np.array_equal(td[m], jd[m]), out


def _d(func, arg=None, offset=1, scale=0, running=False, frame=None, out=None):
    return (func, arg, out or f"{func}_{arg}_{offset}_{running}_{frame}", offset, scale,
            running, frame)


#: functions whose value depends on each row's position among its peers:
#: the order keys end in the unique row id, so no two rows are peers
POSITIONAL = [
    _d("row_number"), _d("ntile", offset=3), _d("ntile", offset=7),
    _d("lag", "x"), _d("lag", "f", offset=3), _d("lead", "x", offset=2),
    _d("first_value", "x"), _d("last_value", "f"), _d("nth_value", "x", offset=2),
    _d("sum", "x", running=True), _d("count", "x", running=True), _d("count", None, running=True),
    _d("avg", "x", scale=2, running=True), _d("min", "x", running=True),
    _d("max", "f", running=True), _d("min", "f", running=True),
    _d("sum", "x", frame=(-2, 1)), _d("count", "f", frame=(None, 0)),
    _d("avg", "x", frame=(0, None)), _d("sum", "x", frame=(1, 3)),
]
#: functions that see peers as one: any order among them gives the same
PEER = [
    _d("rank"), _d("dense_rank"), _d("percent_rank"), _d("cume_dist"),
    _d("sum", "x"), _d("sum", "f"), _d("count", "x"), _d("count", None), _d("avg", "x"),
    _d("min", "x"), _d("max", "x"), _d("min", "f"), _d("max", "f"),
    _d("sum", "x", frame=("range", -3, 2)), _d("count", "x", frame=("range", None, "cur")),
    _d("avg", "f", frame=("range", "cur", 5)), _d("sum", "f", frame=("range", -1, None)),
]


@pytest.mark.parametrize("seed,n_valid,n_parts", [
    (0, 400, 7),      # several partitions, padding rows
    (1, CAP, 1),      # one partition over the whole tile
    (2, 300, 60),     # many small partitions
    (3, 0, 5),        # an empty input
])
@pytest.mark.parametrize("desc", [False, True])
def test_window_op_matches_jax(seed, n_valid, n_parts, desc):
    cols, rv = _inputs(seed, n_valid, n_parts)
    _check(cols, rv, ["p"], {"k": desc, "r": False}, POSITIONAL)
    _check(cols, rv, ["p"], {"k": desc}, PEER)
    # no partition and no order: every aggregate over the whole tile
    _check(cols, rv, [], {}, [_d("sum", "x"), _d("count", None), _d("max", "f"),
                              _d("sum", "f")])
