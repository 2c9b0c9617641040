"""Streamed (paged) aggregation through the port against the JAX package.

The shapes of tests/test_streamed.py (a dense GROUP BY, a scalar
aggregate, an aggregate under HAVING behind a semi join, DISTINCT, a
join pipeline, a LEFT JOIN scalar, a chunked semi-join probe) run at
TPC-H sf 0.004 through the JAX Session (``set tidb_tpu_stream_rows``)
and the port's Session on the CPU (``executor.stream_rows``) at a row
threshold that makes several chunks. Rows equal the JAX package's
streamed rows and the port's own unpaged rows: integers and decimals
exactly, floats (AVG) within 1e-9 relative, the reference test's own
tolerance. Each streamed case shows more than one chunk in the port's
record (``executor.stream_log``).

Beyond those: the auto rule (a small tile limit and ``stream_rows=-1``),
the final merge split into parts by key hash, host-chunk mode, TPC-H
Q18's full text with both aggregates streaming, staged batches kept out
of every cache, the partial/final split against the JAX package's, the
scan cache's release, and the generator's column filter.
"""

import numpy as np
import pytest
import torch

from tidb_tpu_torch.bench import load_tpch
from tidb_tpu_torch.chunk import pad_capacity
from tidb_tpu_torch.bench import oracles
from tidb_tpu_torch.bench.oracles import TPCH_QUERIES, check_rows, exact_bincount, numpy_q1
from tidb_tpu_torch.planner import physical, streamed
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog, scan

from _torch_parity import port_catalog, same_rows

SF = 0.004
TABLES = ["orders", "lineitem", "customer"]
#: 24,000 lineitem rows: 4 chunks (the reference test's 9 at its sf 0.01)
CHUNK = 7000
FULL = 2_000_000
REL = 1e-9

SHAPES = {
    "group_agg_q1": (
        "select l_returnflag, l_linestatus, sum(l_quantity), avg(l_extendedprice), count(*) "
        "from lineitem where l_shipdate <= date '1998-09-02' "
        "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus", True),
    "scalar": (
        "select sum(l_extendedprice * l_discount), count(*), min(l_shipdate), max(l_shipdate) "
        "from lineitem where l_discount between 0.05 and 0.07", True),
    "having_semi": (
        "select count(*) from orders where o_orderkey in (select l_orderkey from lineitem "
        "group by l_orderkey having sum(l_quantity) > 150)", True),
    "join_pipeline": (
        "select o_orderkey, sum(l_quantity) q from lineitem, orders where o_orderkey = l_orderkey "
        "group by o_orderkey having sum(l_quantity) > 100 order by q desc, o_orderkey limit 7", True),
    "left_join_scalar": (
        "select count(*), sum(l_quantity) from lineitem left join orders on o_orderkey = l_orderkey",
        True),
    "semi_probe_chunked": (
        "select l_returnflag, count(*) from lineitem where l_orderkey in (select o_orderkey "
        "from orders where o_orderdate >= date '1995-01-01') group by l_returnflag "
        "order by l_returnflag", True),
}
DISTINCT = (
    "select l_returnflag, count(distinct l_shipmode) from lineitem group by l_returnflag "
    "order by l_returnflag"
)
#: two DISTINCT arguments stay DISTINCT aggregates in the plan
TWO_DISTINCT = "select count(distinct l_shipmode), count(distinct l_linestatus) from lineitem"
Q18 = TPCH_QUERIES["q18"].sql.format(**TPCH_QUERIES["q18"].test_params)


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


def _port_rows(ts, sql, rows):
    ts.executor.stream_rows = rows
    try:
        return ts.execute(sql).rows
    finally:
        ts.executor.stream_rows = -1


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_streamed_shape_matches_jax_and_unpaged(both, shape):
    js, ts = both
    sql, ordered = SHAPES[shape]
    want = _jax_rows(js, sql, CHUNK)
    got = _port_rows(ts, sql, CHUNK)
    log = ts.executor.stream_log
    assert log and all(r["chunks"] > 1 for r in log), log
    assert same_rows(got, want, ordered, REL), (got[:5], want[:5])
    unpaged = _port_rows(ts, sql, 0)
    assert ts.executor.stream_log == []
    assert same_rows(got, unpaged, ordered, REL), (got[:5], unpaged[:5])


def test_distinct_aggregates(both):
    """The reference shape's one DISTINCT argument is planned as a GROUP
    BY over (key, argument) under a plain COUNT: that lower aggregate
    streams. A DISTINCT aggregate itself cannot be split into partial
    sums: it declines and runs unpaged."""
    js, ts = both
    want = _jax_rows(js, DISTINCT, CHUNK)
    got = _port_rows(ts, DISTINCT, CHUNK)
    (rec,) = ts.executor.stream_log
    assert rec["chunks"] > 1 and rec["groups"] > len(got)
    assert same_rows(got, want, True)
    want = _jax_rows(js, TWO_DISTINCT, CHUNK)
    got = _port_rows(ts, TWO_DISTINCT, CHUNK)
    assert ts.executor.stream_log == []
    assert same_rows(got, want, False)


def test_q18_streams_both_aggregates(both):
    """Q18's IN subquery (lineitem GROUP BY l_orderkey) streams; its
    result enters as a Staged leaf, and the outer GROUP BY over
    customer, orders, the staged semi join and lineitem streams lineitem
    again."""
    js, ts = both
    q = TPCH_QUERIES["q18"]
    want = _jax_rows(js, Q18, CHUNK)
    got = _port_rows(ts, Q18, CHUNK)
    log = ts.executor.stream_log
    assert [r["table"] for r in log] == ["lineitem", "lineitem"], log
    assert all(r["chunks"] > 1 for r in log)
    assert same_rows(got, want, True)
    check_rows(got, q.oracle(ts.catalog, **q.test_params), q.order, q.limit)


def test_staged_batches_stay_out_of_the_caches(both, monkeypatch):
    """Each run stages a fresh batch: no compiled plan or stream plan
    that closes over one survives its statement (not even in a reference
    cycle left for the garbage collector), and two staged leaves never
    share a fingerprint."""
    import gc
    import weakref

    _js, ts = both
    staged = []
    post = streamed.apply_post_avg

    def record(cols, post_avg):
        staged.extend(weakref.ref(c.data) for c in cols.values())
        return post(cols, post_avg)

    monkeypatch.setattr(streamed, "apply_post_avg", record)
    gc.collect()
    gc.disable()
    try:
        first = _port_rows(ts, Q18, CHUNK)
        assert len(staged) >= 4 and all(r() is None for r in staged)
    finally:
        gc.enable()
    again = _port_rows(ts, Q18, CHUNK)
    assert first == again
    ex = ts.executor
    assert not any("staged#" in k[0] for k in ex._cache)
    assert not any("staged#" in k[0][0] for k in ex._stream_plans)
    assert ex.last_compiled.fn is None
    from tidb_tpu_torch.planner import logical as L

    a = L.Staged(None, batch=None, dicts={}, nonce=1)
    b = L.Staged(None, batch=None, dicts={}, nonce=2)
    assert physical.plan_fingerprint(a) != physical.plan_fingerprint(b)


def test_staged_bounds_are_resolved(both):
    """A staged leaf's bounds come from its source columns as plain
    values: no lazy entry naming a scan site of another compile."""
    _js, ts = both
    seen = []
    orig = physical.PhysicalExecutor.run

    def spy(self, plan):
        if streamed.has_staged(plan):
            seen.append(plan)
        return orig(self, plan)

    physical.PhysicalExecutor.run = spy
    try:
        _port_rows(ts, SHAPES["having_semi"][0], CHUNK)
    finally:
        physical.PhysicalExecutor.run = orig
    leaves = []

    def walk(p):
        if isinstance(p, streamed.L.Staged):
            leaves.append(p)
        for c in physical._plan_children(p):
            walk(c)

    walk(seen[0])
    (leaf,) = leaves
    bounds = {k: v for k, v in leaf.dicts.items() if k.startswith(physical._BOUNDS_PREFIX)}
    assert bounds and all(isinstance(v, tuple) for v in bounds.values()), bounds


def test_auto_rule_streams_past_the_tile_limit(both, monkeypatch):
    js, ts = both
    sql, ordered = SHAPES["group_agg_q1"]
    want = _jax_rows(js, sql, CHUNK)
    monkeypatch.setattr(physical, "_MAX_CAP", 8192)
    got = ts.execute(sql).rows
    (rec,) = ts.executor.stream_log
    assert rec["chunks"] > 1 and rec["chunk_tile"] <= 8192 and "tile" in rec["why"], rec
    assert same_rows(got, want, ordered, REL)


def test_final_merge_in_parts(both, monkeypatch):
    """Partial rows past one tile merge in parts by key hash; the rows
    equal the one merge's."""
    js, ts = both
    sql = ("select l_orderkey, count(*), sum(l_quantity), avg(l_extendedprice), "
           "min(l_shipdate), max(l_discount) from lineitem group by l_orderkey")
    want = _jax_rows(js, sql, CHUNK)
    monkeypatch.setattr(physical, "_MAX_CAP", 4096)
    got = ts.execute(sql).rows
    (rec,) = ts.executor.stream_log
    assert rec["merge"] == "partitioned" and rec["parts"] > 1, rec
    assert rec["partial_rows"] > 4096 and rec["groups"] == len(want)
    assert same_rows(got, want, False, REL)


def test_host_chunk_mode(both, monkeypatch):
    """A budget too small for the resident columns streams each chunk
    from host RAM; the rows do not change."""
    js, ts = both
    sql, ordered = SHAPES["join_pipeline"]
    want = _jax_rows(js, sql, CHUNK)
    scan.release()
    monkeypatch.setattr(streamed, "_HOST_BUDGET", 1 << 20)
    got = _port_rows(ts, sql, CHUNK)
    (rec,) = ts.executor.stream_log
    assert rec["mode"] == "host" and rec["chunks"] == 4, rec
    assert same_rows(got, want, ordered, REL)


def test_release_keeps_the_statements_columns(both, monkeypatch):
    """When the worst case does not fit, cached columns the statement does
    not scan are released; those it scans above the streamed aggregate
    (orders, beside the IN subquery over lineitem) are kept."""
    js, ts = both
    sql, ordered = SHAPES["having_semi"]
    want = _jax_rows(js, sql, CHUNK)
    ts.execute("select count(*) from customer where c_acctbal > 0")
    cust, orders = ts.catalog.table("tpch", "customer"), ts.catalog.table("tpch", "orders")
    keeps = []
    release = scan.release

    def spy(table=None, keep=()):
        keeps.append(set(keep))
        return release(table, keep)

    monkeypatch.setattr(scan, "release", spy)
    monkeypatch.setattr(streamed, "_HOST_BUDGET", 1 << 16)
    got = _port_rows(ts, sql, CHUNK)
    assert same_rows(got, want, ordered, REL)
    assert keeps and all((orders.uid, "o_orderkey") in k for k in keeps)
    assert not scan.is_cached(cust, cust.version, "c_acctbal", pad_capacity(cust.nrows), "cpu")


def test_partial_final_split_matches_jax():
    """_partial_descs, build_final_stage and apply_post_avg against the
    JAX package's on the same descriptors and partial sums."""
    import jax.numpy as jnp

    from tidb_tpu.chunk import DevCol as JDevCol
    from tidb_tpu.executor.aggregate import AggDesc as JAggDesc
    from tidb_tpu.parallel import fragment as jf
    from tidb_tpu_torch.chunk import DevCol
    from tidb_tpu_torch.executor.aggregate import AggDesc
    from tidb_tpu_torch.parallel import fragment as tf

    spec = [("count", None, "c", 0, False, None), ("sum", 1, "s", 2, True, None),
            ("avg", 2, "a", 2, False, 1000), ("min", 3, "mn", 0, False, None),
            ("max", 4, "mx", 0, False, None), ("first", 5, "f", 0, False, None)]

    def descs(cls):
        return [cls(f, a, o, arg_scale=sc, wide=w, pack_bound=pb) for f, a, o, sc, w, pb in spec]

    jp, jfin = jf._partial_descs(descs(JAggDesc))
    tp, tfin = tf._partial_descs(descs(AggDesc))
    fields = ("func", "arg", "out_name", "distinct", "arg_scale", "wide", "pack_bound")
    assert [[getattr(a, f) for f in fields] for a in jp] == [[getattr(a, f) for f in fields] for a in tp]
    assert [x[:4] for x in jfin] == [x[:4] for x in tfin]
    jk, jd, jpost = jf.build_final_stage(["g"], jfin)
    tk, td, tpost = tf.build_final_stage(["g"], tfin)
    assert jpost == tpost and len(jk) == len(tk)
    assert [(d.func, d.out_name) for d in jd] == [(d.func, d.out_name) for d in td]

    rng = np.random.default_rng(3)
    sums = rng.integers(-10**9, 10**9, 64)
    counts = rng.integers(0, 5, 64)
    valid = rng.random(64) < 0.9
    out_name, sname, cname, _scale = tpost[0]
    jcols = jf.apply_post_avg({sname: JDevCol(jnp.asarray(sums), jnp.asarray(valid)),
                               cname: JDevCol(jnp.asarray(counts), jnp.asarray(valid))}, jpost)
    tcols = tf.apply_post_avg({sname: DevCol(torch.from_numpy(sums), torch.from_numpy(valid)),
                               cname: DevCol(torch.from_numpy(counts), torch.from_numpy(valid))},
                              tpost)
    assert set(jcols) == set(tcols) == {out_name}
    assert np.array_equal(np.asarray(jcols[out_name].valid), tcols[out_name].valid.numpy())
    assert np.array_equal(np.asarray(jcols[out_name].data), tcols[out_name].data.numpy())


def test_key_partition_keeps_equal_keys_together():
    from tidb_tpu_torch.chunk import DevCol
    from tidb_tpu_torch.parallel.fragment import key_partition

    rng = np.random.default_rng(1)
    k = torch.from_numpy(rng.integers(0, 50, 4000))
    v = torch.from_numpy(rng.random(4000) < 0.9)
    junk = torch.from_numpy(rng.integers(-5, 5, 4000))
    # NULL keys carry junk data: they still land together
    data = torch.where(v, k, junk)
    p = key_partition([DevCol(data, v), DevCol(k % 3, torch.ones_like(v))], 8)
    assert int(p.min()) >= 0 and int(p.max()) < 8 and len(set(p.tolist())) > 4
    groups = {}
    for d, ok, k3, part in zip(data.tolist(), v.tolist(), (k % 3).tolist(), p.tolist()):
        groups.setdefault((d if ok else None, k3), set()).add(part)
    assert all(len(s) == 1 for s in groups.values())


def test_scan_release_drops_device_columns():
    cat = Catalog()
    load_tpch(cat, sf=0.002, seed=2, tables=["orders"])
    t = cat.table("tpch", "orders")
    tile = pad_capacity(t.nrows)
    scan.scan_table(t, ["o_orderkey", "o_totalprice"], device="cpu")
    assert scan.is_cached(t, t.version, "o_orderkey", tile, "cpu")
    keep = {(t.uid, "o_orderkey"), (t.uid, scan.ROW_MASK)}
    before = scan.device_bytes()
    assert scan.device_bytes(keep=keep) < before
    freed = scan.release(t, keep=keep)
    assert freed > 0 and not scan.is_cached(t, t.version, "o_totalprice", tile, "cpu")
    assert scan.is_cached(t, t.version, "o_orderkey", tile, "cpu")
    assert scan.release(t) > 0 and not scan.is_cached(t, t.version, "o_orderkey", tile, "cpu")


def test_generator_column_filter_keeps_full_draw_values():
    full, cut = Catalog(), Catalog()
    load_tpch(full, sf=0.003, seed=4, tables=TABLES)
    keep = {"lineitem": ["l_orderkey", "l_quantity", "l_suppkey", "l_tax", "l_shipinstruct"],
            "orders": ["o_custkey", "o_orderdate"], "customer": ["c_custkey", "c_acctbal"]}
    load_tpch(cut, sf=0.003, seed=4, tables=TABLES, columns=keep)
    for name, cols in keep.items():
        (a,), (b,) = full.table("tpch", name).blocks(), cut.table("tpch", name).blocks()
        assert list(b.columns) == [c for c in a.columns if c in cols] and b.nrows == a.nrows
        for c in cols:
            x, y = a.columns[c], b.columns[c]
            assert x.data.dtype == y.data.dtype and np.array_equal(x.data, y.data), (name, c)
            assert (x.dictionary is None) == (y.dictionary is None)
            if x.dictionary is not None:
                assert list(x.dictionary) == list(y.dictionary)


def test_oracle_sums_exact_past_float_precision(monkeypatch):
    rng = np.random.default_rng(9)
    key = rng.integers(0, 3, 5000)
    w = rng.integers(-(1 << 50), 1 << 50, 5000)
    want = np.zeros(3, dtype=np.int64)
    np.add.at(want, key, w)
    assert np.array_equal(exact_bincount(key, w, 3), want)
    cat = Catalog()
    load_tpch(cat, sf=0.003, seed=4, tables=["orders", "lineitem"])
    (b,) = cat.table("tpch", "lineitem").blocks()
    blk = {n: c.data for n, c in b.columns.items()}
    whole = numpy_q1(blk)
    monkeypatch.setattr(oracles, "Q1_ROWS_PER_PASS", 1000)
    sliced = numpy_q1(blk)
    assert all(np.array_equal(whole[k], sliced[k]) for k in whole)
