"""Compile expression trees into torch functions over Batches.

Counterpart of tidb_tpu/expression/kernels.py, limited to what the 22
TPC-H queries need: column refs and literals, scaled-int DECIMAL ``+ - *``
(``_rescale``/``_numeric_align``), ``/``, DIV and MOD, comparisons (BETWEEN
lowers to two of them), three-valued AND/OR/NOT, IS [NOT] NULL, date
compares against folded constants, dictionary-coded string columns
compared with literals or with each other, [NOT] LIKE and IN (string
predicates are one LUT over the dictionary, built once per compile), a
numeric CASE, the EXTRACT family (YEAR ... DAYOFYEAR), DATEDIFF and
SUBSTRING as a dictionary transform. Any other function raises
``NotImplementedError`` naming it.

Null semantics are MySQL three-valued logic carried in validity masks.
Strings are dictionary codes; each dictionary is sorted, so order
comparisons against a literal become integer-code comparisons, with the
literal's position found by binary search at compile time.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tidb_tpu_torch.chunk import Batch, DevCol
from tidb_tpu_torch.dtypes import Kind, SQLType
from tidb_tpu_torch.expression.expr import (
    ARITH,
    COMPARE,
    ColumnRef,
    Expr,
    Func,
    Literal,
)

# column name -> sorted dictionary (np object array) for STRING columns.
DictContext = Dict[str, np.ndarray]

_CompiledExpr = Callable[[Batch], DevCol]

_TORCH_DTYPES = {
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.bool_): torch.bool,
}


def torch_dtype(t: SQLType) -> torch.dtype:
    """Device dtype of a SQL type's physical encoding."""
    return _TORCH_DTYPES[t.np_dtype]


def _rescale(data, diff: int):
    if diff > 0:
        return data * (10**diff)
    if diff < 0:
        return torch.div(data, 10**-diff, rounding_mode="floor")
    return data


def _to_float(data, t: SQLType):
    if t.kind == Kind.DECIMAL:
        return data.to(torch.float64) / (10**t.scale)
    return data.to(torch.float64)


def _numeric_align(a, ta: SQLType, b, tb: SQLType, target: SQLType):
    """Bring two physical arrays to the target type's representation."""
    if target.kind == Kind.FLOAT:
        return _to_float(a, ta), _to_float(b, tb)
    if target.kind == Kind.DECIMAL:
        a = a.to(torch.int64) if ta.kind != Kind.DECIMAL else a
        b = b.to(torch.int64) if tb.kind != Kind.DECIMAL else b
        sa = ta.scale if ta.kind == Kind.DECIMAL else 0
        sb = tb.scale if tb.kind == Kind.DECIMAL else 0
        return _rescale(a, target.scale - sa), _rescale(b, target.scale - sb)
    if target.kind == Kind.DATETIME:
        # DATE promotes to midnight micros; an INT operand is a day count
        from tidb_tpu_torch.dtypes import US_PER_DAY

        def _cv(x, t):
            x = x.to(torch.int64)
            return x if t.kind == Kind.DATETIME else x * US_PER_DAY

        return _cv(a, ta), _cv(b, tb)
    # INT-ish: keep 64-bit (DATE int32 promotes)
    return a.to(torch.int64), b.to(torch.int64)


def _like_to_regex(pattern: str) -> "re.Pattern":
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def literal_phys(v, t: Optional[SQLType]):
    """Literal -> the column's physical encoding (scaled decimals, epoch
    days/micros, MySQL double coercion of string-vs-numeric)."""
    from tidb_tpu_torch.dtypes import date_to_days, datetime_to_micros, time_to_micros

    if t is not None and t.kind == Kind.DECIMAL:
        return round(float(v) * 10**t.scale)
    if t is not None and t.kind == Kind.DATE:
        return date_to_days(v) if isinstance(v, str) else int(v)
    if t is not None and t.kind == Kind.DATETIME:
        return datetime_to_micros(v) if isinstance(v, str) else int(v)
    if t is not None and t.kind == Kind.TIME:
        return time_to_micros(v) if isinstance(v, str) else int(v)
    if isinstance(v, str):
        try:
            return float(v)  # MySQL double coercion
        except ValueError:
            return 0.0
    return v


class _DeviceLUT:
    """A host table built once per compile, copied to each device it is
    gathered on (once) and indexed by clamped codes."""

    def __init__(self, table: np.ndarray):
        self.table = table
        self._on: Dict[str, torch.Tensor] = {}

    def __call__(self, codes: torch.Tensor) -> torch.Tensor:
        key = str(codes.device)
        t = self._on.get(key)
        if t is None:
            t = self._on[key] = torch.as_tensor(self.table, device=codes.device)
        return t[codes.to(torch.int64).clamp(0, t.shape[0] - 1)]


def _string_literal_code(dictionary: np.ndarray, value: str):
    """(code position, exact_match) for a literal against a sorted dict."""
    pos = int(np.searchsorted(dictionary, value))
    exact = pos < len(dictionary) and dictionary[pos] == value
    return pos, exact


def compile_expr(e: Expr, dicts: Optional[DictContext] = None) -> _CompiledExpr:
    return _compile(e, dicts or {})


def expr_dictionary(e: Expr, dicts: DictContext) -> np.ndarray:
    """The dictionary a string-typed expression's output codes refer to."""
    return string_expr(e, dicts)[1]


def string_expr(e: Expr, dicts: DictContext):
    """A string-typed expression as (fn yielding codes, dictionary)."""
    if isinstance(e, ColumnRef):
        if e.name not in dicts:
            raise NotImplementedError(f"string column {e.name} has no dictionary")
        return _compile(e, dicts), dicts[e.name]
    if isinstance(e, Literal):
        if e.value is None:
            return _null_col(torch.int32), np.array([], dtype=object)

        def _lit(b):
            return DevCol(
                torch.zeros(b.capacity, dtype=torch.int32, device=b.device),
                torch.ones(b.capacity, dtype=torch.bool, device=b.device),
            )

        return _lit, np.array([str(e.value)], dtype=object)
    if isinstance(e, Func) and e.op == "_force_bin":
        return string_expr(e.args[0], dicts)  # passthrough marker
    if isinstance(e, Func) and e.op == "substring":
        return _substring_expr(e, dicts)
    if isinstance(e, Func) and e.op in ("case", "coalesce", "ifnull"):
        raise NotImplementedError(f"string-valued {e.op.upper()} is not ported yet")
    name = e.op if isinstance(e, Func) else type(e).__name__
    raise NotImplementedError(f"string expression {name!r} is not ported yet")


def _substring(pos: int, ln: Optional[int]):
    """MySQL SUBSTRING(s, pos[, ln]) of one string (pos 1-based, negative
    from the end, 0 gives '')."""

    def _sub(s):
        if pos > 0:
            i = pos - 1
        elif pos < 0:
            i = max(len(s) + pos, 0)
        else:
            return ""
        if ln is None:
            return s[i:]
        return s[i : i + max(ln, 0)]

    return _sub


# recent SUBSTRING tables, keyed by (pos, len, id of the input
# dictionary); each entry holds its dictionary, so the id stays its own.
# TPC-H Q22 takes one SUBSTRING in a filter, a subquery and its GROUP BY:
# the dictionary (1.5M phone numbers at SF10) is mapped once.
_SUBSTRINGS: "OrderedDict[tuple, tuple]" = OrderedDict()


def _substring_tables(pos: int, ln: Optional[int], d: np.ndarray):
    """(code LUT, new sorted dictionary) of a SUBSTRING over `d`."""
    key = (pos, ln, id(d))
    hit = _SUBSTRINGS.get(key)
    if hit is not None and hit[0] is d:
        _SUBSTRINGS.move_to_end(key)
        return hit[1]
    outs = list(map(_substring(pos, ln), (str(v) for v in d.tolist())))
    new_dict = sorted(set(outs))
    index = {v: i for i, v in enumerate(new_dict)}
    codes = np.fromiter((index[o] for o in outs), dtype=np.int32, count=len(outs))
    tables = (_DeviceLUT(codes if len(codes) else np.zeros(1, np.int32)),
              np.array(new_dict, dtype=object))
    _SUBSTRINGS[key] = (d, tables)
    while len(_SUBSTRINGS) > 16:
        _SUBSTRINGS.popitem(last=False)
    return tables


def _substring_expr(e: Func, dicts: DictContext):
    """SUBSTRING as a dictionary transform: (fn yielding codes, new sorted
    dictionary). The dictionary is mapped once on the host; the rows'
    codes go through the resulting code LUT on the device."""
    extra = e.args[1:]
    if not all(isinstance(a, Literal) and a.param_slot is None for a in extra):
        raise NotImplementedError("SUBSTRING: only literal positions and lengths are ported")
    pos = int(extra[0].value)
    ln = int(extra[1].value) if len(extra) > 1 else None
    fn, d = string_expr(e.args[0], dicts)
    lut, new_dict = _substring_tables(pos, ln, d)

    def _sub(b):
        c = fn(b)
        return DevCol(lut(c.data), c.valid)

    return _sub, new_dict


def _null_col(dtype):
    def _f(b):
        return DevCol(
            torch.zeros(b.capacity, dtype=dtype, device=b.device),
            torch.zeros(b.capacity, dtype=torch.bool, device=b.device),
        )

    return _f


def _compile(e: Expr, dicts: DictContext) -> _CompiledExpr:
    if isinstance(e, ColumnRef):
        name = e.name
        return lambda b: b.cols[name]
    if isinstance(e, Literal):
        return _compile_literal(e)
    if not isinstance(e, Func):
        raise NotImplementedError(f"expression {type(e).__name__!r} is not ported yet")
    op = e.op
    if op in ARITH or op in COMPARE or op == "nulleq":
        return _compile_binary(e, dicts)
    if op in ("and", "or"):
        return _compile_logic(e, dicts)
    if op == "not":
        (a,) = [_compile(x, dicts) for x in e.args]

        def _not(b):
            c = a(b)
            return DevCol(~c.data.to(torch.bool), c.valid)

        return _not
    if op == "neg":
        (a,) = [_compile(x, dicts) for x in e.args]

        def _neg(b):
            c = a(b)
            return DevCol(-c.data, c.valid)

        return _neg
    if op in ("isnull", "isnotnull"):
        (a,) = [_compile(x, dicts) for x in e.args]
        want_null = op == "isnull"

        def _isnull(b):
            v = a(b).valid
            return DevCol(~v if want_null else v, torch.ones_like(v))

        return _isnull
    if op == "case":
        if _is_string_col(e):
            return string_expr(e, dicts)[0]
        return _compile_case(e, dicts)
    if op == "like":
        return _compile_like(e, dicts)
    if op == "in":
        return _compile_in(e, dicts)
    if op in _EXTRACT_PARTS:
        return _compile_extract(e, dicts)
    if op == "substring":
        return string_expr(e, dicts)[0]
    if op == "datediff":
        fa, fb = (_compile(a, dicts) for a in e.args)
        ta, tb = (a.type for a in e.args)

        def _dd(b):
            a, c = fa(b), fb(b)
            return DevCol(_to_days(a.data, ta) - _to_days(c.data, tb), a.valid & c.valid)

        return _dd
    raise NotImplementedError(f"function {op!r} is not ported yet")


def _compile_literal(e: Literal) -> _CompiledExpr:
    if e.param_slot is not None:
        raise NotImplementedError("prepared-statement parameters are not ported yet")
    t, v = e.type, e.value
    if v is None:
        dtype = torch.int64 if t is None or t.kind == Kind.NULL else torch_dtype(t)
        return _null_col(dtype)
    if t.kind == Kind.DECIMAL:
        phys, dtype = round(float(v) * 10**t.scale), torch.int64
    elif t.kind == Kind.FLOAT:
        phys, dtype = float(v), torch.float64
    elif t.kind == Kind.BOOL:
        phys, dtype = bool(v), torch.bool
    elif t.kind == Kind.DATE:
        from tidb_tpu_torch.dtypes import date_to_days

        phys = date_to_days(v) if isinstance(v, str) else int(v)
        dtype = torch.int32
    elif t.kind == Kind.DATETIME:
        from tidb_tpu_torch.dtypes import datetime_to_micros

        phys = datetime_to_micros(v) if isinstance(v, str) else int(v)
        dtype = torch.int64
    elif t.kind == Kind.TIME:
        from tidb_tpu_torch.dtypes import time_to_micros

        phys = time_to_micros(v) if isinstance(v, str) else int(v)
        dtype = torch.int64
    elif t.kind == Kind.STRING:
        return string_expr(e, {})[0]
    else:
        phys, dtype = int(v), torch.int64

    def _lit(b):
        return DevCol(
            torch.full((b.capacity,), phys, dtype=dtype, device=b.device),
            torch.ones(b.capacity, dtype=torch.bool, device=b.device),
        )

    return _lit


def _is_string_col(e: Expr) -> bool:
    return e.type is not None and e.type.kind == Kind.STRING


def _cmp(op: str, x, y):
    if op in ("eq", "nulleq"):
        return x == y
    return {"ne": torch.ne, "lt": torch.lt, "le": torch.le,
            "gt": torch.gt, "ge": torch.ge}[op](x, y)


def _compile_binary(e: Func, dicts: DictContext) -> _CompiledExpr:
    op, (ea, eb) = e.op, e.args
    is_cmp = op in COMPARE or op == "nulleq"
    if is_cmp and _is_string_col(ea) and isinstance(eb, Literal):
        return _compile_strcmp(e, dicts, flipped=False)
    if is_cmp and _is_string_col(eb) and isinstance(ea, Literal):
        return _compile_strcmp(e, dicts, flipped=True)
    if is_cmp and _is_string_col(ea) and _is_string_col(eb):
        return _compile_strstr(e, dicts)

    fa, fb = _compile(ea, dicts), _compile(eb, dicts)
    ta, tb = ea.type, eb.type
    from tidb_tpu_torch.dtypes import common_type

    if is_cmp or op in ("intdiv", "mod"):
        target = common_type(ta, tb)
    else:
        target = e.type

    def _bin(b):
        a, c = fa(b), fb(b)
        valid = a.valid & c.valid
        if op == "div":
            x, y = _to_float(a.data, ta), _to_float(c.data, tb)
        elif op == "mul" and target.kind == Kind.DECIMAL:
            x, y = a.data.to(torch.int64), c.data.to(torch.int64)
        else:
            x, y = _numeric_align(a.data, ta, c.data, tb, target)
        if op == "add":
            d = x + y
        elif op == "sub":
            d = x - y
        elif op == "mul":
            d = x * y
        elif op == "div":
            valid = valid & (y != 0)  # MySQL: division by zero -> NULL
            d = x / torch.where(y == 0, torch.ones_like(y), y)
        elif op in ("intdiv", "mod"):
            valid = valid & (y != 0)
            ys = torch.where(y == 0, torch.ones_like(y), y)
            if x.is_floating_point():
                q = torch.trunc(x / ys)
                d = q.to(torch.int64) if op == "intdiv" else x - q * ys
            else:
                # MySQL DIV truncates toward zero; the remainder's sign
                # follows the dividend
                q = torch.div(x, ys, rounding_mode="trunc")
                d = q if op == "intdiv" else x - q * ys
        else:
            d = _cmp(op, x, y)
        if op in ("add", "sub") and e.type and e.type.kind == Kind.DATE:
            d = d.to(torch.int32)
        if op == "nulleq":
            # null-safe equality (<=>): never NULL
            d = (valid & d) | (~a.valid & ~c.valid)
            valid = torch.ones_like(valid)
        return DevCol(d, valid)

    return _bin


def _compile_strcmp(e: Func, dicts: DictContext, flipped: bool) -> _CompiledExpr:
    op = e.op
    col, lit = (e.args[1], e.args[0]) if flipped else (e.args[0], e.args[1])
    if flipped:
        op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}.get(op, op)
    f, dictionary = string_expr(col, dicts)
    from tidb_tpu_torch.utils import collate as _coll

    if not _coll.is_binary(col.type.collation if col.type is not None else None):
        raise NotImplementedError("string comparison under a CI collation is not ported yet")
    if lit.value is None:

        def _nullcmp(b):
            c = f(b)
            if op == "nulleq":  # col <=> NULL: TRUE exactly where NULL
                return DevCol(~c.valid, torch.ones_like(c.valid))
            z = torch.zeros_like(c.valid)
            return DevCol(z, z)

        return _nullcmp
    pos, exact = _string_literal_code(dictionary, str(lit.value))

    def _cmp_code(b):
        c = f(b)
        code = c.data
        if op in ("eq", "nulleq"):
            d = (code == pos) if exact else torch.zeros_like(c.valid)
        elif op == "ne":
            d = (code != pos) if exact else torch.ones_like(c.valid)
        elif op == "lt":
            d = code < pos
        elif op == "le":
            d = code < (pos + 1 if exact else pos)
        elif op == "gt":
            d = code >= (pos + 1 if exact else pos)
        else:  # ge
            d = code >= pos
        if op == "nulleq":
            return DevCol(d & c.valid, torch.ones_like(c.valid))
        return DevCol(d, c.valid)

    return _cmp_code


def _compile_strstr(e: Func, dicts: DictContext) -> _CompiledExpr:
    """String column vs string column: remap both sides into a merged
    sorted dictionary, then compare codes as integers."""
    from tidb_tpu_torch.utils import collate as _coll

    op, (ea, eb) = e.op, e.args
    coll = (ea.type.collation if ea.type is not None else None) or (
        eb.type.collation if eb.type is not None else None
    )
    fa, da = string_expr(ea, dicts)
    fb, db = string_expr(eb, dicts)
    _m, la, lb = _coll.merge_rank_luts(da, db, coll)
    lut_a = _DeviceLUT(np.asarray(la, dtype=np.int64))
    lut_b = _DeviceLUT(np.asarray(lb, dtype=np.int64))

    def _strstr(b):
        a, c = fa(b), fb(b)
        x, y = lut_a(a.data), lut_b(c.data)
        valid = a.valid & c.valid
        d = _cmp(op, x, y)
        if op == "nulleq":
            return DevCol((valid & d) | (~a.valid & ~c.valid), torch.ones_like(valid))
        return DevCol(d, valid)

    return _strstr


def _compile_logic(e: Func, dicts: DictContext) -> _CompiledExpr:
    op = e.op
    fa, fb = (_compile(a, dicts) for a in e.args)

    def _logic(b):
        a, c = fa(b), fb(b)
        at, ct = a.data.to(torch.bool), c.data.to(torch.bool)
        if op == "and":
            true = (a.valid & at) & (c.valid & ct)
            false = (a.valid & ~at) | (c.valid & ~ct)
        else:
            true = (a.valid & at) | (c.valid & ct)
            false = (a.valid & ~at) & (c.valid & ~ct)
        return DevCol(true, true | false)

    return _logic


def _compile_case(e: Func, dicts: DictContext) -> _CompiledExpr:
    """CASE WHEN c1 THEN v1 ... [ELSE v] END into a numeric target: the
    first true condition's value, the ELSE value otherwise (NULL with
    no ELSE), each value brought to the target's representation."""
    from tidb_tpu_torch.dtypes import FLOAT64

    args = list(e.args)
    has_else = len(args) % 2 == 1
    else_e = args.pop() if has_else else None
    pairs = [(args[i], args[i + 1]) for i in range(0, len(args), 2)]
    cond_fns = [_compile(c, dicts) for c, _ in pairs]
    val_fns = [_compile(v, dicts) for _, v in pairs]
    val_ts = [v.type for _, v in pairs]
    else_fn = _compile(else_e, dicts) if else_e is not None else None
    else_t = else_e.type if else_e is not None else None
    target = e.type

    def _conv(data, t):
        if target.kind == Kind.FLOAT:
            return _to_float(data, t)
        if target.kind == Kind.DECIMAL:
            s = t.scale if t.kind == Kind.DECIMAL else 0
            return _rescale(data.to(torch.int64), target.scale - s)
        return data

    def _case(b):
        if else_fn is not None:
            ec = else_fn(b)
            out_d, out_v = _conv(ec.data, else_t), ec.valid
        else:
            zeros = torch.zeros(b.capacity, dtype=torch.int64, device=b.device)
            out_d = _conv(zeros, FLOAT64 if target.kind == Kind.FLOAT else target)
            out_v = torch.zeros(b.capacity, dtype=torch.bool, device=b.device)
        for cf, vf, vt in zip(reversed(cond_fns), reversed(val_fns), reversed(val_ts)):
            c, v = cf(b), vf(b)
            take = c.valid & c.data.to(torch.bool)
            out_d = torch.where(take, _conv(v.data, vt), out_d)
            out_v = torch.where(take, v.valid, out_v)
        return DevCol(out_d, out_v)

    return _case


def _compile_strlut(col: Expr, dicts: DictContext, pyfn, out_dtype) -> _CompiledExpr:
    """A per-value function of a string column as one gather: the LUT is
    `pyfn` over the column's dictionary, built here once per compile."""
    f, dictionary = string_expr(col, dicts)
    table = (
        np.array([pyfn(str(s)) for s in dictionary.tolist()]).astype(out_dtype)
        if len(dictionary)
        else np.zeros(1, dtype=out_dtype)
    )
    lut = _DeviceLUT(table)

    def _lutf(b):
        c = f(b)
        return DevCol(lut(c.data), c.valid)

    return _lutf


def _compile_like(e: Func, dicts: DictContext) -> _CompiledExpr:
    col, pat = e.args
    if not isinstance(pat, Literal) or pat.param_slot is not None:
        raise NotImplementedError("LIKE: only a literal pattern is ported")
    rx = _like_to_regex(str(pat.value))
    return _compile_strlut(col, dicts, lambda s: bool(rx.match(s)), np.bool_)


def _compile_in(e: Func, dicts: DictContext) -> _CompiledExpr:
    """x IN (literals). MySQL: x IN (a, b, NULL) is TRUE on a match and
    NULL otherwise. A string column is one LUT gather; a numeric column
    is one equality pass per listed value, OR-ed (no [N, k] matrix)."""
    col, *lits = e.args
    if any(not isinstance(x, Literal) or x.param_slot is not None for x in lits):
        raise NotImplementedError("IN list must hold plain literals")
    has_null = any(x.value is None for x in lits)
    lits = [x for x in lits if x.value is not None]
    if _is_string_col(col):
        vals = set(str(x.value) for x in lits)
        match_fn = _compile_strlut(col, dicts, lambda s: s in vals, np.bool_)
    else:
        f = _compile(col, dicts)
        phys = np.array([literal_phys(x.value, col.type) for x in lits])
        as_float = phys.dtype.kind == "f" or (col.type is not None and col.type.kind == Kind.FLOAT)
        consts = phys.tolist()

        def match_fn(b):
            c = f(b)
            x = c.data.to(torch.float64 if as_float else torch.int64)
            d = torch.zeros(b.capacity, dtype=torch.bool, device=b.device)
            for v in consts:
                d |= x == v
            return DevCol(d, c.valid)

    def _in(b):
        m = match_fn(b)
        valid = m.valid & m.data if has_null else m.valid
        return DevCol(m.data, valid)

    return _in


_EXTRACT_PARTS = ("year", "month", "day", "quarter", "dayofweek", "weekday", "dayofyear")


def _to_days(data, t: Optional[SQLType]):
    """Temporal value -> days since the epoch (DATETIME truncates micros)."""
    if t is not None and t.kind == Kind.DATETIME:
        from tidb_tpu_torch.dtypes import US_PER_DAY

        return _floordiv(data.to(torch.int64), US_PER_DAY)
    return data.to(torch.int64)


def _floordiv(x, k: int):
    return torch.div(x, k, rounding_mode="floor")


def _compile_extract(e: Func, dicts: DictContext) -> _CompiledExpr:
    """YEAR/MONTH/DAY/QUARTER/DAYOFWEEK/WEEKDAY/DAYOFYEAR from days since
    the epoch: the branchless integer civil-calendar algorithm (Howard
    Hinnant's days_from_civil inverse), which needs flooring division for
    days before 1970."""
    part = e.op
    (col,) = e.args
    f = _compile(col, dicts)

    def _ext(b):
        c = f(b)
        days = _to_days(c.data, col.type)
        z = days + 719468
        era = _floordiv(z, 146097)
        doe = z - era * 146097
        yoe = _floordiv(
            doe - _floordiv(doe, 1460) + _floordiv(doe, 36524) - _floordiv(doe, 146096), 365
        )
        y = yoe + era * 400
        doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
        mp = _floordiv(5 * doy + 2, 153)
        d = doy - _floordiv(153 * mp + 2, 5) + 1
        m = torch.where(mp < 10, mp + 3, mp - 9)
        y = torch.where(m <= 2, y + 1, y)
        if part == "year":
            out = y
        elif part == "month":
            out = m
        elif part == "day":
            out = d
        elif part == "quarter":
            out = _floordiv(m + 2, 3)
        elif part == "dayofweek":
            # 1970-01-01 was a Thursday; MySQL numbers Sunday=1..Saturday=7
            out = torch.remainder(days + 4, 7) + 1
        elif part == "weekday":
            # MySQL WEEKDAY: Monday=0..Sunday=6
            out = torch.remainder(days + 3, 7)
        else:  # dayofyear: days since Jan 1 of the civil year y
            y2 = y - 1
            era2 = _floordiv(y2, 400)
            yoe2 = y2 - era2 * 400
            doe2 = yoe2 * 365 + _floordiv(yoe2, 4) - _floordiv(yoe2, 100) + 306
            jan1 = era2 * 146097 + doe2 - 719468
            out = days - jan1 + 1
        return DevCol(out.to(torch.int64), c.valid)

    return _ext
