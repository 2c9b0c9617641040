"""EXPLAIN and EXPLAIN ANALYZE through the JAX package's Session and the
port's, over the same TPC-H tables at sf 0.002 after ANALYZE of lineitem
and orders: EXPLAIN of the 23 queries of tests/test_tpch_sql.py line for
line; EXPLAIN ANALYZE of Q1, Q3 and a GROUP_CONCAT query equal on every
node's label and rows= (the times differ), each node of a warm plan run
once; a plan the executor's sizing would spill is refused by
name."""

import re

import pytest

import tidb_tpu  # noqa: F401
from tidb_tpu.bench import load_tpch as jax_load_tpch
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu_torch.session import Session

from _torch_parity import port_catalog
from test_torch_tpch22 import QUERIES, SF, TABLES


@pytest.fixture(scope="module")
def tpch():
    jcat = JaxCatalog()
    jax_load_tpch(jcat, sf=SF, seed=11)
    tcat = port_catalog(jcat, "tpch", TABLES)
    js, ts = JaxSession(jcat, db="tpch"), Session(tcat, db="tpch", device="cpu")
    # statistics where the estimates and join orders read them most
    for t in ("lineitem", "orders"):
        js.execute(f"analyze table {t}")
        ts.execute(f"analyze table {t}")
    return js, ts


@pytest.mark.parametrize("name", list(QUERIES))
def test_explain_matches_jax(tpch, name):
    js, ts = tpch
    sql = "explain " + QUERIES[name]
    assert ts.execute(sql).rows == js.execute(sql).rows


_TIME = re.compile(r" time=[0-9.]+ms")


def _labels_and_rows(lines):
    return [_TIME.sub("", line).rsplit(" calls=", 1)[0] for line in lines]


@pytest.mark.parametrize("name", ["q1", "q3"])
def test_explain_analyze_matches_jax(tpch, name):
    js, ts = tpch
    sql = "explain analyze " + QUERIES[name]
    want = [r[0] for r in js.execute(sql).rows]
    ts.execute(QUERIES[name])  # a warm plan: every node runs once
    got = [r[0] for r in ts.execute(sql).rows]
    assert _labels_and_rows(got) == _labels_and_rows(want)
    assert all(line.endswith("calls=1") for line in got), got
    root = int(re.search(r" rows=(\d+)", got[0]).group(1))
    assert root == len(ts.execute(QUERIES[name]).rows)


def test_explain_analyze_group_concat(tpch):
    js, ts = tpch
    sql = ("explain analyze select n_regionkey, group_concat(n_name order by n_name) "
           "from nation group by n_regionkey")
    got, want = ts.execute(sql).rows, js.execute(sql).rows
    assert len(got) == len(want) == 1
    assert _TIME.sub("", got[0][0]) == _TIME.sub("", want[0][0])
    assert got[0][0].startswith("HostAssistedAggregate(GROUP_CONCAT)  time=")


def test_explain_analyze_of_a_spill_is_refused(tpch):
    _js, ts = tpch
    ts.executor.stream_rows = 1000
    try:
        with pytest.raises(NotImplementedError, match="spills .a streamed aggregate"):
            ts.execute("explain analyze " + QUERIES["q1"])
        assert ts.execute("explain " + QUERIES["q1"]).rows
    finally:
        ts.executor.stream_rows = -1
