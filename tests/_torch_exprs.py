"""The two-engine harness of the tests/test_torch_builtins_*.py files: one
seeded table with NULLs, edge dates and edge strings, each expression bound
by its own package's planner (``select <expr> as c from t``) and compiled
by each package's ``compile_expr`` on the same batch, eager, with no
Session.

Results compare with the same dtype and validity. DOUBLE values match
within 1e-12 relative (1e-15 absolute near zero: XLA:CPU's exp, log and
trig functions are approximations of their own); every other type, and a
string result's dictionary and codes, match exactly."""

import numpy as np

import tidb_tpu  # noqa: F401
import tidb_tpu.chunk as JC
from tidb_tpu.dtypes import (DATE, DATETIME, DECIMAL, FLOAT64, INT64, STRING, TIME,
                             US_PER_DAY, SQLType as JSQLType)
from tidb_tpu.dtypes import Kind as JKind
from tidb_tpu.expression.kernels import compile_expr as jax_compile
from tidb_tpu.expression.kernels import string_expr as jax_string_expr
from tidb_tpu.parser import parse as jax_parse
from tidb_tpu.planner import build_query as jax_build
from tidb_tpu.storage import Catalog, TableSchema
import tidb_tpu_torch.chunk as TC
from tidb_tpu_torch.dtypes import Kind, SQLType
from tidb_tpu_torch.expression.kernels import compile_expr as torch_compile
from tidb_tpu_torch.expression.kernels import string_expr as torch_string_expr
from tidb_tpu_torch.parser import parse as torch_parse
from tidb_tpu_torch.planner import build_query as torch_build

from _torch_parity import port_catalog

N = 512
REL, ABS = 1e-12, 1e-15
# leap days, both sides of the epoch, century years (1600 and 2000 leap,
# 1700 and 1900 not), year ends (week 0/52/53 edges) and the DATE_FORMAT
# table's ends (1900-01-01, 2155-12-31)
EDGE_DATES = [
    "1600-02-29", "1700-02-28", "1700-03-01", "1900-01-01", "1900-02-28",
    "1900-03-01", "1968-02-29", "1969-12-31", "1970-01-01", "1972-02-29",
    "1998-12-31", "1999-01-01", "1999-12-31", "2000-01-01", "2000-01-02",
    "2000-02-29", "2000-03-01", "2000-12-31", "2004-01-04", "2008-12-29",
    "2010-01-03", "2024-02-29", "2100-03-01", "2155-12-31", "2156-01-01",
]
STRINGS = np.array(sorted([
    "", " ", "a", "abc", "ABC", "Abc ", "  pad  ", "a.b", "a,b,c", "b,a", "x_y",
    "13-555-1234", "31-999-0000", "1-URGENT", "2-HIGH", "5-LOW", "MAIL", "TRUCK",
    "forest green", "Brand#13", "naïve café", "ß", "日本語", "Straße", "ABCDEF",
    "414243", "zz", "QUJD", "bad!", "2024-02-29", "1999-12-31 23:59:58",
    "31/12/1999", "not a date", "42abc", "-7", "3.5", "Robert", "Rupert",
]), dtype=object)
CI = "utf8mb4_general_ci"


def build_engines(seed=7, strings=STRINGS):
    """(jax catalog, port catalog, dicts, jax batch, port batch) of table
    `t`: i, j INT; k INT bounded to [-40, 300] (its bounds ride the dicts
    map, as the planner sends them); d DECIMAL(2); f DOUBLE; dt DATE; ts
    DATETIME; tm TIME; s, s2 strings drawn from `strings` (a sorted object
    array); ci a utf8mb4_general_ci string; e an all-NULL string (an empty
    dictionary)."""
    rng = np.random.default_rng(seed)

    def nulls(p=0.1):
        return rng.random(N) >= p

    days = rng.integers(-150_000, 150_000, N).astype(np.int32)
    edge = np.array([np.datetime64(s, "D").astype(np.int64) for s in EDGE_DATES], np.int32)
    days[: len(edge)] = edge
    micros = (rng.integers(-20_000, 70_000, N).astype(np.int64) * US_PER_DAY
              + rng.integers(0, US_PER_DAY, N))
    micros[: len(edge)] = edge.astype(np.int64) * US_PER_DAY + rng.integers(0, US_PER_DAY, len(edge))
    i = rng.integers(-20, 21, N).astype(np.int64)
    i[:6] = [0, 1, -1, 63, 64, -64]
    j = rng.integers(-(1 << 40), 1 << 40, N).astype(np.int64)
    j[:4] = [0, -1, (1 << 62), -(1 << 62)]
    f = rng.normal(0, 50, N)
    f[:10] = [0.0, -0.0, 0.5, -0.5, 1.5, 2.5, -2.5, 1e-300, 123.456, 1e15]
    d = rng.choice([150, 225, -75, 0, 1234, -1250, 5, -5, 99999, 250], N).astype(np.int64)
    cols = {
        "i": JC.HostColumn(INT64, i, nulls()),
        "j": JC.HostColumn(INT64, j, nulls()),
        "k": JC.HostColumn(INT64, rng.integers(-40, 301, N).astype(np.int64), nulls()),
        "d": JC.HostColumn(DECIMAL(2), d, nulls()),
        "f": JC.HostColumn(FLOAT64, f, nulls()),
        "dt": JC.HostColumn(DATE, days, nulls()),
        "ts": JC.HostColumn(DATETIME, micros, nulls()),
        "tm": JC.HostColumn(TIME, rng.integers(-400, 400, N).astype(np.int64) * 3_600_000_000
                            + rng.integers(0, 3_600_000_000, N), nulls()),
        "s": JC.HostColumn(STRING, rng.integers(0, len(strings), N).astype(np.int32), nulls(0.15),
                           strings),
        "s2": JC.HostColumn(STRING, rng.integers(0, len(strings), N).astype(np.int32), nulls(),
                            strings),
        "ci": JC.HostColumn(JSQLType(JKind.STRING, 0, CI),
                            rng.integers(0, len(strings), N).astype(np.int32), nulls(), strings),
        "e": JC.HostColumn(STRING, np.zeros(N, np.int32), np.zeros(N, bool),
                           np.array([], dtype=object)),
    }
    jcat = Catalog()
    t = jcat.create_table("test", "t", TableSchema([(n, c.type) for n, c in cols.items()]))
    t.dictionaries.update({n: c.dictionary for n, c in cols.items() if c.dictionary is not None})
    t.replace_blocks([JC.HostBlock.from_columns(cols)])
    tcat = port_catalog(jcat, "test", ["t"])
    dicts = {f"t.{n}": c.dictionary for n, c in cols.items() if c.dictionary is not None}
    dicts["\x00b\x00t.k"] = (-40, 300)
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


def both(engines, expr):
    """The expression bound by each package's planner; the trees print
    alike and carry the same type."""
    jcat, tcat, *_ = engines
    sql = f"select {expr} as c from t"
    je = _bound(jax_build(jax_parse(sql)[0], jcat, "test"))
    te = _bound(torch_build(torch_parse(sql)[0], tcat, "test"))
    assert repr(je) == repr(te)
    assert repr(je.type) == repr(te.type)
    return je, te


def same_cols(jc, tc, rows):
    """Same dtype and validity; data equal where valid (DOUBLE within
    REL relative or ABS absolute, NaN equal to NaN). Returns the rows
    compared."""
    jd, jv = np.asarray(jc.data), np.asarray(jc.valid)
    td, tv = tc.data.numpy(), tc.valid.numpy()
    assert td.dtype == jd.dtype, (td.dtype, jd.dtype)
    assert (tv[rows] == jv[rows]).all(), np.flatnonzero(tv[rows] != jv[rows])
    keep = rows & jv
    a, b = td[keep], jd[keep]
    if a.dtype.kind == "f":
        with np.errstate(invalid="ignore"):  # inf - inf: equal infinities pass a == b
            ok = (a == b) | (np.isnan(a) & np.isnan(b)) | (
                np.abs(a - b) <= np.maximum(REL * np.maximum(np.abs(a), np.abs(b)), ABS))
    else:
        ok = a == b
    assert ok.all(), list(zip(a[~ok][:5], b[~ok][:5]))
    return keep


def check_expr(engines, expr):
    """One expression through both compile_exprs: values, or for a string
    result the dictionary and codes."""
    _jcat, _tcat, dicts, jbatch, tbatch = engines
    je, te = both(engines, expr)
    rows = np.asarray(jbatch.row_valid)
    if je.type is not None and je.type.kind == JKind.STRING:
        jfn, jdict = jax_string_expr(je, dicts)
        tfn, tdict = torch_string_expr(te, dicts)
        assert tdict.tolist() == jdict.tolist()
        return same_cols(jfn(jbatch), tfn(tbatch), rows)
    return same_cols(jax_compile(je, dicts)(jbatch), torch_compile(te, dicts)(tbatch), rows)


def refused_alike(engines, expr):
    """Both packages refuse the expression with NotImplementedError."""
    import pytest

    _jcat, _tcat, dicts, jbatch, tbatch = engines
    je, te = both(engines, expr)
    for compile_, e, b in ((jax_compile, je, jbatch), (torch_compile, te, tbatch)):
        with pytest.raises(NotImplementedError):
            compile_(e, dicts)(b)
