"""The rest of spill through the port against the JAX package: the
host-merged ORDER BY, grace-hash partitioned pipelines and the memory
quota.

The shapes of tests/test_streamed.py (the full ORDER BY, the ORDER BY
over NULL keys, ``TestGraceHashPartitioned``, the quota that forces
host chunking) and tests/test_governance.py's over-quota rejection run
through the JAX Session (``set tidb_tpu_stream_rows``, ``set
tidb_mem_quota_query``) and the port's Session on the CPU
(``executor.stream_rows``, ``executor.quota_bytes``). Rows equal the JAX
package's and the port's own unpaged rows: integers and decimals
exactly, floats (AVG) within 1e-9 relative, the reference test's own
tolerance. Each path shows itself in the port's ``executor.stream_log``
record.

Beyond those: the rows-past-the-tile rule (a small tile limit sends
TPC-H Q21 to grace hash and keeps Q18 streaming), the TPC-H queries and
the late-receipt report R1 under a small quota against their numpy
oracles (after tests/test_scale_tpch22.py's small-quota tier), the host
merge's NULL order, and the partition hash.
"""

import numpy as np
import pytest
import torch

from tidb_tpu_torch.bench import load_tpch
from tidb_tpu_torch.bench import oracles
from tidb_tpu_torch.bench.oracles import (
    Q1_SQL,
    Q3_SQL,
    Q5_SQL,
    Q6_SQL,
    SPILL_REPORTS,
    TPCH_QUERIES,
    check_rows,
)
from tidb_tpu_torch.planner import physical, streamed
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog, catalog_from_numpy, scan

from _torch_parity import port_catalog, same_rows

SF = 0.005
TABLES = ["orders", "lineitem"]
#: 30,000 lineitem rows: 5 chunks (the reference test's 9 at its sf 0.01)
CHUNK = 7000
FULL = 2_000_000
REL = 1e-9
#: the quota sysvar's floor, which the reference's grace-hash tests set
QUOTA_16M = 16 << 20

ORDER_BY = {
    # tests/test_streamed.py:150
    "full_order_by": (
        "select l_orderkey, l_extendedprice from lineitem, orders "
        "where o_orderkey = l_orderkey order by l_extendedprice desc, l_orderkey"),
    # tests/test_streamed.py:172
    "null_keys": (
        "select l_orderkey, nullif(l_linenumber, 3) k from lineitem "
        "order by k desc, l_orderkey"),
}
GROUP_Q1 = (
    "select l_returnflag, l_linestatus, sum(l_quantity), avg(l_extendedprice), count(*) "
    "from lineitem where l_shipdate <= date '1998-09-02' "
    "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"
)
GRACE_SEMI = (
    "select g, count(*) from e a "
    "where exists (select * from e b where b.k = a.k and b.v <> a.v) "
    "group by g order by g"
)
GRACE_ANTI = (
    "select count(*) from small s where not exists "
    "(select * from e a, e b where a.k = b.k and a.g = s.g)"
)


@pytest.fixture(scope="module")
def both():
    from tidb_tpu.bench import load_tpch as jax_load_tpch
    from tidb_tpu.session import Session as JaxSession
    from tidb_tpu.storage import Catalog as JaxCatalog

    jcat = JaxCatalog()
    jax_load_tpch(jcat, sf=SF, seed=5, tables=TABLES)
    js = JaxSession(jcat, db="tpch")
    ts = Session(port_catalog(jcat, "tpch", TABLES), db="tpch", device="cpu")
    return js, ts


def _jax_rows(js, sql, rows):
    js.execute(f"set tidb_tpu_stream_rows = {rows}")
    try:
        return js.must_query(sql).rows
    finally:
        js.execute(f"set tidb_tpu_stream_rows = {FULL}")


def _port_rows(ts, sql, rows, quota=None):
    ts.executor.stream_rows = rows
    ts.executor.quota_bytes = quota
    try:
        return ts.execute(sql).rows
    finally:
        ts.executor.stream_rows = -1
        ts.executor.quota_bytes = None


@pytest.mark.parametrize("shape", sorted(ORDER_BY))
def test_streamed_order_by_matches_jax_and_unpaged(both, shape):
    js, ts = both
    sql = ORDER_BY[shape]
    want = _jax_rows(js, sql, CHUNK)
    got = _port_rows(ts, sql, CHUNK)
    (rec,) = ts.executor.stream_log
    assert rec["path"] == "sort" and rec["chunks"] > 1, rec
    assert rec["rows_staged"] == len(got)
    assert got == want
    unpaged = _port_rows(ts, sql, 0)
    assert ts.executor.stream_log == []
    assert got == unpaged


def test_order_by_with_limit_keeps_the_top_n(both):
    """LIMIT shapes never take the host merge: they keep the top-N."""
    _js, ts = both
    sql = ORDER_BY["full_order_by"] + " limit 5"
    got = _port_rows(ts, sql, CHUNK)
    assert all(r["path"] != "sort" for r in ts.executor.stream_log)
    assert got == _port_rows(ts, ORDER_BY["full_order_by"], 0)[:5]


def test_quota_still_forces_host_chunking():
    """tests/test_streamed.py:306: under a quota smaller than the big
    scan's columns the chunks come from host RAM, even when those columns
    already lie in the device cache from an unquota'd run."""
    from tidb_tpu.bench import load_tpch as jax_load_tpch
    from tidb_tpu.session import Session as JaxSession
    from tidb_tpu.storage import Catalog as JaxCatalog

    jcat = JaxCatalog()
    jax_load_tpch(jcat, sf=0.05, seed=6, tables=["lineitem"])
    js = JaxSession(jcat, db="tpch")
    js.execute("set tidb_tpu_stream_rows = 20000")
    js.execute(f"set tidb_mem_quota_query = {QUOTA_16M}")
    want = js.must_query(GROUP_Q1).rows
    ts = Session(port_catalog(jcat, "tpch", ["lineitem"]), db="tpch", device="cpu")
    cached = _port_rows(ts, GROUP_Q1, 20000)
    (rec,) = ts.executor.stream_log
    assert rec["mode"] == "device" and rec["quota_bytes"] is None, rec
    got = _port_rows(ts, GROUP_Q1, 20000, quota=QUOTA_16M)
    (rec,) = ts.executor.stream_log
    assert rec["mode"] == "host" and rec["quota_bytes"] == QUOTA_16M and rec["chunks"] > 1, rec
    assert same_rows(got, want, True, REL) and same_rows(got, cached, True, REL)


def test_over_quota_query_rejected_with_report():
    """tests/test_governance.py:34: a plan whose tiles pass the quota and
    that no spill path can take fails admission with the tracker report."""
    n = 512
    spec = {"test": {"t": {
        "columns": [("a", ("int", 0, None)), ("b", ("int", 0, None))],
        "primary_key": None,
        "data": {"a": (np.arange(n), np.ones(n, bool), None),
                 "b": (np.arange(n) % 7, np.ones(n, bool), None)},
    }}}
    ts = Session(catalog_from_numpy(spec), db="test", device="cpu")
    ts.executor.quota_bytes = QUOTA_16M
    assert ts.execute("select count(*) from t").rows == [(n,)]
    ts.executor.quota_bytes = 20_000
    from tidb_tpu_torch.parser import parse
    from tidb_tpu_torch.planner import build_query

    plan = build_query(parse("select a, count(*) from t group by a")[0], ts.catalog, ts.db,
                       ts._scalar_subquery)
    with pytest.raises(physical.ExecError, match="tracker report"):
        ts.executor.run(plan)
    assert ts.executor.stream_log == []


@pytest.fixture(scope="module")
def grace():
    """tests/test_streamed.py:189's table e (400,000 rows of k, g, v) and
    a four-row table small, the same numpy data in both packages."""
    from tidb_tpu.chunk import HostBlock, column_from_values
    from tidb_tpu.dtypes import INT64
    from tidb_tpu.session import Session as JaxSession

    n = 400_000
    rng = np.random.default_rng(5)
    cols = {"k": rng.integers(0, 40_000, n), "g": rng.integers(0, 7, n), "v": np.arange(n)}
    js = JaxSession()
    js.execute("create table e (k int, g int, v int)")
    js.catalog.table("test", "e").replace_blocks([HostBlock.from_columns(
        {c: column_from_values(a.tolist(), INT64) for c, a in cols.items()})])
    js.execute("create table small (g int)")
    js.execute("insert into small values (0), (1), (2), (99)")
    small = np.array([0, 1, 2, 99])
    ones = lambda a: np.ones(len(a), bool)  # noqa: E731
    spec = {"test": {
        "e": {"columns": [(c, ("int", 0, None)) for c in cols], "primary_key": None,
              "data": {c: (a, ones(a), None) for c, a in cols.items()}},
        "small": {"columns": [("g", ("int", 0, None))], "primary_key": None,
                  "data": {"g": (small, ones(small), None)}},
    }}
    ts = Session(catalog_from_numpy(spec), db="test", device="cpu")
    return js, ts


def _jax_quota_rows(js, sql):
    js.execute(f"set tidb_mem_quota_query = {QUOTA_16M}")
    try:
        return js.execute(sql).rows
    finally:
        js.execute(f"set tidb_mem_quota_query = {64 << 30}")


def test_grace_hash_semi_join_matches_jax(grace):
    """Both self-join sides are big against the 16 MiB quota, and the
    EXISTS side is a semi-join build that row chunks cannot split: the
    port takes grace hash, with host partitions (the columns alone pass
    the quota)."""
    js, ts = grace
    want = _jax_quota_rows(js, GRACE_SEMI)
    unpaged = _port_rows(ts, GRACE_SEMI, -1)
    assert ts.executor.stream_log == []
    got = _port_rows(ts, GRACE_SEMI, -1, quota=QUOTA_16M)
    (rec,) = ts.executor.stream_log
    assert rec["path"] == "partitioned" and rec["K"] >= 2 and rec["chunks"] == rec["K"], rec
    assert rec["mode"] == "host" and set(rec["partitioned"]) == {"a", "b"}, rec
    assert got == want == unpaged


def test_grace_hash_declines_resident_probe_anti_join(grace):
    """Partitioned scans only on the build side of an anti join over a
    resident probe would emit each unmatched probe row once per
    partition: no partitioned path. If the statement runs under the
    quota at all, its rows are right; an over-quota error is allowed."""
    js, ts = grace
    want = js.execute(GRACE_ANTI).rows
    assert _port_rows(ts, GRACE_ANTI, -1) == want
    try:
        got = _port_rows(ts, GRACE_ANTI, -1, quota=QUOTA_16M)
    except physical.ExecError as e:
        assert "memory quota exceeded" in str(e)
    else:
        assert got == want
    assert all(r["path"] != "partitioned" for r in ts.executor.stream_log)


@pytest.fixture(scope="module")
def tpch():
    cat = Catalog()
    load_tpch(cat, sf=SF, seed=1)
    return Session(cat, db="tpch", device="cpu")


def test_rows_past_the_tile_take_grace_hash(tpch, monkeypatch):
    """Past the tile limit a semi or anti build side that row chunks
    cannot split sends TPC-H Q21 to grace hash, every partition within
    the tile; Q18's only big build is an inner-join side, so both its
    aggregates keep streaming."""
    ts = tpch
    q21, q18 = TPCH_QUERIES["q21"], TPCH_QUERIES["q18"]
    want21 = q21.oracle(ts.catalog)
    want18 = q18.oracle(ts.catalog, **q18.test_params)
    tile = 8192
    monkeypatch.setattr(physical, "_MAX_CAP", tile)
    check_rows(ts.execute(q21.sql).rows, want21, q21.order, q21.limit)
    (rec,) = ts.executor.stream_log
    assert rec["path"] == "partitioned" and rec["K"] >= 4, rec
    assert set(rec["partitioned"]) == {"l1", "l2", "l3"}, rec
    assert all(n <= tile for n in rec["largest_partition_rows"].values()), rec
    assert "tile" in rec["why"], rec
    check_rows(ts.execute(q18.sql.format(**q18.test_params)).rows, want18, q18.order, q18.limit)
    assert [r["path"] for r in ts.executor.stream_log] == ["streamed", "streamed"]


def test_sort_path_chosen_by_the_sizing(tpch, monkeypatch):
    """R1 with no explicit stream_rows: past the tile limit the sizing
    alone sends it to the host merge."""
    ts = tpch
    r1 = SPILL_REPORTS["r1"]
    monkeypatch.setattr(physical, "_MAX_CAP", 8192)
    got = ts.execute(r1.sql).rows
    (rec,) = ts.executor.stream_log
    assert rec["path"] == "sort" and rec["chunks"] > 1 and "tile" in rec["why"], rec
    check_rows(got, r1.oracle(ts.catalog), r1.order)


#: the quota of the 22-query tier at sf 0.002: small enough that lineitem
#: streams, Q21's EXISTS sides take grace hash and R1 the host merge
TIER_QUOTA = 1 << 20
#: queries the tier's quota rejects with a tracker report (none)
UNSPILLABLE: list = []


def test_tpch_under_a_small_quota():
    """All 22 TPC-H queries and R1 at sf 0.002 under a 1 MiB quota, the
    port alone, each against its numpy oracle."""
    cat = Catalog()
    load_tpch(cat, sf=0.002, seed=1)
    ts = Session(cat, db="tpch", device="cpu")
    ts.executor.quota_bytes = TIER_QUOTA
    queries = {name: (q.sql.format(**q.test_params), q) for name, q in TPCH_QUERIES.items()}
    queries["r1"] = (SPILL_REPORTS["r1"].sql, SPILL_REPORTS["r1"])
    paths = {}
    for name, (sql, q) in sorted(queries.items()):
        if name in UNSPILLABLE:
            continue
        got = ts.execute(sql).rows
        paths[name] = [r["path"] for r in ts.executor.stream_log]
        check_rows(got, q.oracle(cat, **q.test_params), q.order, q.limit)
    for name, sql in (("q1", Q1_SQL), ("q3", Q3_SQL), ("q5", Q5_SQL), ("q6", Q6_SQL)):
        ts.execute(sql)
        paths[name] = [r["path"] for r in ts.executor.stream_log]
    taken = {p for ps in paths.values() for p in ps}
    assert {"streamed", "partitioned", "sort"} <= taken, paths
    assert paths["q21"] == ["partitioned"] and paths["r1"] == ["sort"], paths


def test_host_order_puts_nulls_first_ascending_last_descending():
    rng = np.random.default_rng(3)
    a = rng.integers(-3, 3, 200)
    av = rng.random(200) > 0.2
    b = rng.normal(size=200).round(1)
    bv = rng.random(200) > 0.2
    for da, db in ((False, False), (True, False), (False, True), (True, True)):
        order = streamed.host_order([(a, av), (b, bv)], [da, db])

        def key(i, da=da, db=db):
            ka = (1, -a[i] if da else a[i]) if av[i] else ((2, 0) if da else (0, 0))
            kb = (1, -b[i] if db else b[i]) if bv[i] else ((2, 0) if db else (0, 0))
            return ka, kb, i

        assert order.tolist() == sorted(range(200), key=key)


def test_partition_ids_keep_equal_keys_together():
    """Equal keys share a partition whatever their integer width; -0.0
    and 0.0 share one; a NULL key goes to partition 0; padding rows get
    none."""
    parts = 8
    k = torch.tensor([5, -7, 1 << 40, 0, 5, 3], dtype=torch.int64)
    rows = torch.tensor([True] * 5 + [False])
    ids64 = streamed._part_ids(k, torch.ones(6, dtype=torch.bool), rows, parts)
    ids32 = streamed._part_ids(k[:2].to(torch.int32), torch.ones(2, dtype=torch.bool),
                               torch.ones(2, dtype=torch.bool), parts)
    assert ids64[0] == ids64[4] and ids64[:2].tolist() == ids32.tolist()
    assert ids64[5] == parts and 0 <= int(ids64[:5].min()) and int(ids64[:5].max()) < parts
    f = torch.tensor([0.0, -0.0, 2.5, 7.0])
    fid = streamed._part_ids(f, torch.tensor([True, True, True, False]),
                             torch.ones(4, dtype=torch.bool), parts)
    assert fid[0] == fid[1] and fid[3] == 0
    # a spread over the partitions, as the JAX package's hash gives
    many = streamed._part_ids(torch.arange(1 << 14), torch.ones(1 << 14, dtype=torch.bool),
                              torch.ones(1 << 14, dtype=torch.bool), parts)
    counts = torch.bincount(many.to(torch.int64), minlength=parts)
    assert int(counts.min()) > (1 << 14) // parts // 2


def test_device_and_host_assignments_agree(tpch):
    """Partition ids over the cached device tile equal those computed per
    host block, and each partition gathers the same rows either way."""
    ts = tpch
    t = ts.catalog.table("tpch", "lineitem")
    dev = streamed._Assignment(ts.executor, t, t.version, "l_orderkey", 4, on_device=True)
    host = streamed._Assignment(ts.executor, t, t.version, "l_orderkey", 4, on_device=False)
    assert dev.counts.tolist() == host.counts.tolist() and int(dev.counts.sum()) == t.nrows
    tile = max(int(dev.counts.max()), 1)
    for k in range(4):
        a = dev.batch(["l_orderkey", "l_quantity"], k, tile)
        b = host.batch(["l_orderkey", "l_quantity"], k, tile)
        assert torch.equal(a.row_valid, b.row_valid)
        for c in a.cols:
            assert torch.equal(a.cols[c].data, b.cols[c].data)
            assert torch.equal(a.cols[c].valid, b.cols[c].valid)
    scan.release(t)


def test_r1_oracle_matches_a_direct_join(tpch):
    """numpy_r1 against a plain dictionary join of the same rows."""
    cat = tpch.catalog
    li = {n: c.data for n, c in cat.table("tpch", "lineitem").blocks()[0].columns.items()}
    od = dict(zip(*[cat.table("tpch", "orders").blocks()[0].columns[n].data.tolist()
                    for n in ("o_orderkey", "o_orderdate")]))
    lo, hi = oracles._days("1995-03-01"), oracles._days("1995-03-07")
    want = sorted(
        ((int(k), int(s), int(od[k]), int(r), int(r) - int(c))
         for k, s, r, c in zip(li["l_orderkey"], li["l_suppkey"], li["l_receiptdate"],
                               li["l_commitdate"])
         if lo <= r <= hi and r > c and k in od),
        key=lambda x: (-x[4], x[0]))
    got = oracles.numpy_r1(cat)
    assert [(g[0], g[4]) for g in got] == [(w[0], w[4]) for w in want]
    assert sorted(got) == sorted(
        (k, s, oracles._dates(np.array([o]))[0], oracles._dates(np.array([r]))[0], d)
        for k, s, o, r, d in want)
