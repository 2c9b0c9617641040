"""The TPC-H Q1/Q6 expression subset through both ``compile_expr``s on
the same batch: bound by each package's own planner, evaluated over one
seeded table with NULLs, compared exactly (scaled decimals are integers;
float division is the same IEEE operation in both)."""

import numpy as np
import pytest
import torch

import tidb_tpu  # noqa: F401
import tidb_tpu.chunk as JC
from tidb_tpu.dtypes import DATE, DECIMAL, INT64, STRING
from tidb_tpu.expression.kernels import compile_expr as jax_compile
from tidb_tpu.parser import parse as jax_parse
from tidb_tpu.planner import build_query as jax_build
from tidb_tpu.storage import Catalog, TableSchema
import tidb_tpu_torch.chunk as TC
from tidb_tpu_torch.expression.kernels import compile_expr as torch_compile
from tidb_tpu_torch.parser import parse as torch_parse
from tidb_tpu_torch.planner import build_query as torch_build

from _torch_parity import port_catalog

N = 700

EXPRS = [
    "l_extendedprice * (1 - l_discount)",
    "l_extendedprice * (1 - l_discount) * (1 + l_tax)",
    "l_quantity + l_tax - l_discount",
    "-l_quantity",
    "l_extendedprice / l_quantity",
    "l_orderkey div 3",
    "l_orderkey % 7",
    "l_orderkey - 2 * l_orderkey",
    "l_shipdate <= date '1998-12-01' - interval '90' day",
    "l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01'",
    "l_discount between 0.05 and 0.07",
    "l_quantity < 24",
    "l_quantity is null",
    "l_tax is not null",
    "not (l_quantity < 24) or l_discount > 0.05",
    "l_quantity <=> l_tax",
    "l_returnflag = 'R'",
    "l_returnflag <> 'N'",
    "l_returnflag < 'N'",
    "l_linestatus >= 'O'",
    "'B' < l_returnflag",
    "l_returnflag = 'Z'",
    "l_returnflag = l_linestatus",
]


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(42)

    def nulls(p=0.1):
        return rng.random(N) >= p

    cols = {
        "l_orderkey": JC.HostColumn(INT64, rng.integers(-50, 1000, N).astype(np.int64), nulls()),
        "l_quantity": JC.HostColumn(DECIMAL(2), rng.integers(0, 51, N).astype(np.int64) * 100, nulls()),
        "l_extendedprice": JC.HostColumn(DECIMAL(2), rng.integers(90_000, 10_500_000, N).astype(np.int64), nulls()),
        "l_discount": JC.HostColumn(DECIMAL(2), rng.integers(0, 11, N).astype(np.int64), nulls()),
        "l_tax": JC.HostColumn(DECIMAL(2), rng.integers(0, 9, N).astype(np.int64), nulls()),
        "l_shipdate": JC.HostColumn(DATE, rng.integers(8000, 10600, N).astype(np.int32), nulls()),
        "l_returnflag": JC.HostColumn(STRING, rng.integers(0, 3, N).astype(np.int32), nulls(), np.array(["A", "N", "R"], dtype=object)),
        "l_linestatus": JC.HostColumn(STRING, rng.integers(0, 2, N).astype(np.int32), nulls(), np.array(["F", "O"], dtype=object)),
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
        n: TC.HostColumn(_port_type(c.type), c.data, c.valid, c.dictionary)
        for n, c in named.items()
    }
    tbatch = TC.block_to_batch(TC.HostBlock.from_columns(tcols), device="cpu")
    return jcat, tcat, dicts, jbatch, tbatch


def _port_type(t):
    from tidb_tpu_torch.dtypes import Kind, SQLType

    return SQLType(Kind(t.kind.value), t.scale, t.collation)


def _bound(plan_root):
    """The select-list expression of `select <e> as c from t`."""
    p = plan_root
    while p is not None:
        for name, e in getattr(p, "exprs", None) or []:
            if name == "c" and type(e).__name__ != "ColumnRef":
                return e
        p = getattr(p, "child", None)
    raise AssertionError("no bound expression found")


@pytest.mark.parametrize("expr", EXPRS)
def test_expression_matches_jax_package(engines, expr):
    jcat, tcat, dicts, jbatch, tbatch = engines
    sql = f"select {expr} as c from t"
    je = _bound(jax_build(jax_parse(sql)[0], jcat, "test"))
    te = _bound(torch_build(torch_parse(sql)[0], tcat, "test"))
    assert repr(je) == repr(te)
    jc = jax_compile(je, dicts)(jbatch)
    tc = torch_compile(te, dicts)(tbatch)
    jd, jv = np.asarray(jc.data), np.asarray(jc.valid)
    td, tv = tc.data.numpy(), tc.valid.numpy()
    assert td.dtype == jd.dtype, (td.dtype, jd.dtype)
    rows = np.asarray(jbatch.row_valid)
    assert (tv[rows] == jv[rows]).all()
    keep = rows & jv
    assert (td[keep] == jd[keep]).all()


@pytest.mark.parametrize("expr,name", [
    ("regexp_like(l_returnflag, 'A')", "regexp_like"),
    ("json_extract(l_returnflag, '$.a')", "json_extract"),
    ("inet_aton(l_returnflag)", "inet_aton"),
])
def test_unported_functions_raise_naming_them(engines, expr, name):
    """These functions are ported: the test keeps the name of the refusal
    it held and now holds each against the JAX package's (the family's
    cases: tests/test_torch_builtins_rest.py)."""
    jcat, tcat, dicts, jbatch, tbatch = engines
    sql = f"select {expr} as c from t"
    je = _bound(jax_build(jax_parse(sql)[0], jcat, "test"))
    te = _bound(torch_build(torch_parse(sql)[0], tcat, "test"))
    assert name in repr(te) and repr(je) == repr(te)
    jc, tc = jax_compile(je, dicts)(jbatch), torch_compile(te, dicts)(tbatch)
    rows = np.asarray(jbatch.row_valid)
    assert (tc.valid.numpy()[rows] == np.asarray(jc.valid)[rows]).all()
    keep = rows & np.asarray(jc.valid)
    assert (tc.data.numpy()[keep] == np.asarray(jc.data)[keep]).all()


def test_compiled_expressions_follow_the_batch_device(engines):
    *_rest, tbatch = engines
    te = _bound(torch_build(torch_parse("select l_quantity < 24 as c from t")[0], engines[1], "test"))
    out = torch_compile(te, engines[2])(tbatch)
    assert out.data.device == torch.device("cpu") and out.data.dtype == torch.bool
