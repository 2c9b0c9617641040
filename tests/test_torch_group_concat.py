"""GROUP_CONCAT through the JAX package's Session and the port's, each over
its own catalog (tests/_torch_parity.py ``WritePair``): the shapes of
tests/test_distinct_agg.py's TestGroupConcat (DISTINCT, ORDER BY inside
the call, SEPARATOR, numeric and DECIMAL arguments, the scalar form, beside
device aggregates and HAVING, an empty table) and over joins and dates.
The device scans, filters and projects the aggregate's inputs; the host
concatenates (planner/hostagg.py)."""

import pytest

import tidb_tpu  # noqa: F401
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog

from _torch_parity import WritePair

SETUP = [
    "create table g (a int, b int, c varchar(10), d decimal(10,2), dt date)",
    "insert into g values (1,1,'x',2.50,'1999-12-31'),(1,2,'y',1.00,'2000-02-29'),"
    "(1,1,'x',3.25,null),(2,3,'z',4.00,'1970-01-01'),(2,null,'w',5.00,'1969-12-31'),"
    "(1,null,null,6.00,'2000-01-01'),(3,7,null,null,null)",
    "create table h (a int, label varchar(10))",
    "insert into h values (1, 'one'), (2, 'two'), (4, 'four')",
    "create table e (a int, c varchar(10))",
]

QUERIES = {
    "basic": "select a, group_concat(c) from g group by a order by a",
    "distinct": "select a, group_concat(distinct c) from g group by a order by a",
    "separator": "select a, group_concat(c separator '|') from g group by a order by a",
    "order_inside": "select a, group_concat(c order by b desc) from g group by a order by a",
    "order_two_keys": "select a, group_concat(c order by b, d desc separator '') "
                      "from g group by a order by a",
    "distinct_ordered": "select a, group_concat(distinct c order by c desc) from g "
                        "group by a order by a",
    "int_arg": "select a, group_concat(b) from g group by a order by a",
    "decimal_arg": "select a, group_concat(d) from g group by a order by a",
    "date_arg": "select a, group_concat(dt order by dt) from g group by a order by a",
    "scalar": "select group_concat(c) from g",
    "with_device_aggs": "select a, group_concat(c), count(distinct b), sum(d) from g "
                        "group by a order by a",
    "having": "select a, group_concat(c) from g group by a having count(*) > 2 order by a",
    "empty": "select group_concat(c) from e",
    "empty_grouped": "select a, group_concat(c) from e group by a",
    "join": "select label, group_concat(c order by b) from g join h on g.a = h.a "
            "group by label order by label",
    "filtered": "select a, group_concat(upper(c) separator '+'), count(*) from g "
                "where b is not null group by a order by a",
    "computed_key": "select a % 2 as p, group_concat(c order by c) from g group by p order by p",
    "order_by_concat": "select a, group_concat(c order by c) as gc from g group by a "
                       "order by gc desc",
}


@pytest.fixture(scope="module")
def pair():
    p = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    p.runs("create database gcat", "use gcat", *SETUP)
    return p


@pytest.mark.parametrize("name", list(QUERIES))
def test_group_concat_matches_jax_session(pair, name):
    pair.run(QUERIES[name])


def test_device_projects_the_inputs(pair, monkeypatch):
    """The aggregate's inputs come from one run of the compiled plan below
    it (the filter and UPPER on the device, a projection of the key and
    argument columns); the rest of the plan runs over the staged result."""
    ex = pair.ts.executor
    roots = []
    run = ex.run

    def recording(plan):
        roots.append(plan)
        return run(plan)

    monkeypatch.setattr(ex, "run", recording)
    pair.run(QUERIES["filtered"])
    sub = roots[1]
    assert type(sub).__name__ == "Projection"
    assert [c.internal for c in sub.schema][1:] == ["_x0"]  # COUNT(*) reads no column
    assert any(type(p).__name__ == "Staged" for p in _nodes(roots[-1]))


def _nodes(p):
    yield p
    for attr in ("child", "left", "right"):
        c = getattr(p, attr, None)
        if c is not None:
            yield from _nodes(c)
