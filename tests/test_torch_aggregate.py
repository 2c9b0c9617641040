"""``group_aggregate`` of the port against the JAX package's on the dense
and scalar paths: plain, wide (30-bit limb) and packed (sum, count)
lanes, NULL group keys, filtered rows (the overflow slot), a group tile
too small for the groups, and every aggregate function."""

import numpy as np
import pytest
import torch

import tidb_tpu  # noqa: F401
import tidb_tpu.chunk as JC
import tidb_tpu.executor.aggregate as JA
from tidb_tpu.dtypes import DECIMAL, FLOAT64, INT64, STRING
import tidb_tpu_torch.chunk as TC
import tidb_tpu_torch.executor.aggregate as TA
from tidb_tpu_torch.dtypes import Kind, SQLType

N = 3000
STR_DICT = np.array(["a", "b", "c", "d", "e"], dtype=object)
# (function, argument column, arg_scale, wide, pack_bound)
AGGS = [
    ("count", None, 0, False, None),
    ("count", "v_dec", 0, False, None),
    ("sum", "v_int", 0, False, None),
    ("sum", "v_int", 0, False, 1000),  # packed (sum, count) lane
    ("avg", "v_int", 0, False, 1000),
    ("sum", "v_dec", 2, True, None),  # wide lanes
    ("avg", "v_dec", 2, True, None),
    ("avg", "v_dec", 2, False, None),
    ("sum", "v_flt", 0, False, None),
    ("avg", "v_flt", 0, False, None),
    ("min", "v_flt", 0, False, None),
    ("max", "v_int", 0, False, None),
    ("min", "v_dec", 0, False, None),
    ("first", "v_int", 0, False, None),
]
FLOAT_SUMS = {"a8", "a9"}  # float64 sums: summation order differs


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(3)
    cols = {
        "g_str": JC.HostColumn(STRING, rng.integers(0, 5, N).astype(np.int32), rng.random(N) > 0.1, STR_DICT),
        "g_int": JC.HostColumn(INT64, rng.integers(10, 21, N).astype(np.int64), rng.random(N) > 0.1),
        "v_int": JC.HostColumn(INT64, rng.integers(-1000, 1000, N).astype(np.int64), rng.random(N) > 0.2),
        "v_dec": JC.HostColumn(DECIMAL(2), rng.integers(-10**12, 10**12, N).astype(np.int64), rng.random(N) > 0.2),
        "v_flt": JC.HostColumn(FLOAT64, rng.normal(size=N) * 1e3, rng.random(N) > 0.2),
    }
    filt = rng.random(N) > 0.1  # filtered rows go to the overflow slot
    jb = JC.block_to_batch(JC.HostBlock.from_columns(cols))
    tb = TC.block_to_batch(
        TC.HostBlock.from_columns({
            n: TC.HostColumn(SQLType(Kind(c.type.kind.value), c.type.scale), c.data, c.valid, c.dictionary)
            for n, c in cols.items()
        }),
        device="cpu",
    )
    pad = jb.capacity - N
    keep = np.concatenate([filt, np.zeros(pad, bool)])
    jb = JC.Batch(jb.cols, jb.row_valid & keep)
    tb = TC.Batch(tb.cols, tb.row_valid & torch.from_numpy(keep))
    return jb, tb


def _col(name):
    return lambda b: b.cols[name]


def _descs(mod, aggs):
    return [
        mod.AggDesc(f, _col(c) if c else None, f"a{i}", arg_scale=s, wide=w, pack_bound=p)
        for i, (f, c, s, w, p) in enumerate(aggs)
    ]


KEYS = {
    "str": (["g_str"], [(3, 0)]),
    "str_int": (["g_str", "g_int"], [(3, 0), (4, -10)]),
    "scalar": ([], None),
}


def _run(jb, tb, keys, widths, cap):
    jout, jn = JA.group_aggregate(
        jb, [_col(k) for k in keys], _descs(JA, AGGS), cap, keys, key_widths=widths,
    )
    tout, tn = TA.group_aggregate(
        tb, [_col(k) for k in keys], _descs(TA, AGGS), cap, keys, key_widths=widths,
    )
    return jout, int(jn), tout, int(tn)


def _compare(jout, tout, names):
    jrv = np.asarray(jout.row_valid)
    assert tout.capacity == jout.capacity
    assert (tout.row_valid.numpy() == jrv).all()
    for n in names:
        jd, jv = np.asarray(jout.cols[n].data), np.asarray(jout.cols[n].valid)
        td, tv = tout.cols[n].data.numpy(), tout.cols[n].valid.numpy()
        assert td.dtype == jd.dtype, n
        assert (tv[jrv] == jv[jrv]).all(), n
        m = jrv & jv
        if n in FLOAT_SUMS:
            np.testing.assert_allclose(td[m], jd[m], rtol=1e-12, err_msg=n)
        else:
            assert (td[m] == jd[m]).all(), n


@pytest.mark.parametrize("keyset", list(KEYS))
def test_group_aggregate_matches_jax_package(batches, keyset):
    jb, tb = batches
    keys, widths = KEYS[keyset]
    jout, jn, tout, tn = _run(jb, tb, keys, widths, 1024 if keys else 16)
    assert tn == jn
    _compare(jout, tout, keys + [f"a{i}" for i in range(len(AGGS))])


def test_group_tile_too_small_reports_true_count(batches):
    """60+ groups into a 16-slot tile: the reported count exceeds the
    tile (the executor re-runs with a larger one), and the tile holds the
    first groups in key order."""
    jb, tb = batches
    keys, widths = KEYS["str_int"]
    jout, jn, tout, tn = _run(jb, tb, keys, widths, 16)
    assert tn == jn > tout.capacity == 16
    _compare(jout, tout, keys + [f"a{i}" for i in range(len(AGGS))])


def test_stale_key_width_is_reported(batches):
    """A baked width that no longer covers the data reports WIDTH_STALE."""
    jb, tb = batches
    _jo, jn, _to, tn = _run(jb, tb, ["g_int"], [(3, -10)], 1024)
    assert tn == jn == TA.WIDTH_STALE


def test_scalar_over_no_rows(batches):
    jb, tb = batches
    jb = JC.Batch(jb.cols, jb.row_valid & False)
    tb = TC.Batch(tb.cols, torch.zeros_like(tb.row_valid))
    jout, jn, tout, tn = _run(jb, tb, [], None, 16)
    assert tn == jn == 0
    _compare(jout, tout, [f"a{i}" for i in range(len(AGGS))])


def test_unported_paths_raise(batches):
    """The claim loop, DISTINCT and CI-collated keys are ported now (their
    parity tests are in test_torch_hashagg.py and test_torch_collation.py);
    what the device aggregation still refuses by name is a string-making
    aggregate, which runs on the host (planner/hostagg.py) in both
    packages. A CI-collated key's rank table and representatives equal
    the JAX package's."""
    from tidb_tpu.dtypes import SQLType as JSQLType
    from tidb_tpu.dtypes import Kind as JKind
    from tidb_tpu.expression.expr import ColumnRef as JRef
    from tidb_tpu.planner import physical as JP
    from tidb_tpu_torch.expression.expr import ColumnRef
    from tidb_tpu_torch.planner import physical as TP

    _jb, tb = batches
    with pytest.raises(NotImplementedError, match="group_concat"):
        TA.group_aggregate(tb, [lambda b: b.cols["g_int"]],
                           [TA.AggDesc("group_concat", lambda b: b.cols["g_str"], "gc")],
                           1024, ["k"])
    d = np.array(["A", "B", "a", "b", "c ", "c"], dtype=object)
    coll = "utf8mb4_general_ci"
    jl, jrep = JP._collation_rank(JRef(type=JSQLType(JKind.STRING, 0, coll), name="s"), {"s": d})
    tl, trep = TP._collation_rank(ColumnRef(type=SQLType(Kind.STRING, 0, coll), name="s"), {"s": d})
    assert np.asarray(jl).tolist() == tl.table.tolist() and list(jrep) == list(trep)
    assert TP._collation_rank(ColumnRef(type=SQLType(Kind.STRING), name="s"), {"s": d}) is None


@pytest.mark.parametrize("slots", [16, 300])
def test_rows_outside_the_table_spread_over_overflow_entries(slots):
    """Rows outside the slot table go to _OVERFLOW_SPREAD entries past it
    (one address would serialize a card's atomics), and the table's sums,
    extremes and occupancy are those of the rows inside it."""
    rng = np.random.default_rng(3)
    n = 5000
    seg = torch.from_numpy(rng.integers(-3, slots + 40, n).astype(np.int32))
    vals = torch.from_numpy(rng.integers(-1000, 1000, n).astype(np.int64))
    contrib = torch.from_numpy(rng.random(n) < 0.7)
    ids = TA._overflow_slot(seg, slots)
    inside = (seg >= 0) & (seg < slots)
    assert torch.equal(ids[inside], seg[inside].to(torch.int64))
    out = ids[~inside]
    assert bool(((out >= slots) & (out < slots + TA._OVERFLOW_SPREAD)).all())
    # by row position: one entry per position modulo the spread
    pos = np.flatnonzero(~inside.numpy()) % TA._OVERFLOW_SPREAD
    assert torch.equal(out, torch.from_numpy(slots + pos))
    keep = (inside & contrib).numpy()
    want = np.zeros(slots, dtype=np.int64)
    np.add.at(want, seg.numpy()[keep], vals.numpy()[keep])
    (got,) = TA._segment_sums([(vals, contrib)], seg, slots)
    assert got.tolist() == want.tolist()
    big = np.full(slots, np.iinfo(np.int64).min)
    np.maximum.at(big, seg.numpy()[keep], vals.numpy()[keep])
    ident = torch.iinfo(torch.int64).min
    got = TA._segment_extreme("max", vals, contrib, ident, seg, slots)
    assert got.tolist() == big.tolist()
