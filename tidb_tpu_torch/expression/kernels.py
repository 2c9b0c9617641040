"""Compile expression trees into torch functions over Batches.

Counterpart of tidb_tpu/expression/kernels.py: column refs and literals,
scaled-int DECIMAL arithmetic (``_rescale``/``_numeric_align``), ``/``, DIV,
MOD and the bit operators, comparisons, three-valued AND/OR/NOT, IS [NOT]
NULL, numeric and string CASE / COALESCE / IFNULL, [NOT] LIKE and IN, the
math builtins (ABS ... ROUND, TRUNCATE, the float functions, GREATEST,
LEAST, INTERVAL), the date and time builtins (the EXTRACT family, HOUR ...
MICROSECOND, DATE_ADD's month and microsecond forms, DATE_FORMAT, WEEK,
LAST_DAY, TIMESTAMPDIFF, STR_TO_DATE, ...), numeric CAST with the JAX
package's rounding, CAST of a string to a date, time or number, and the
string builtins, the regexp family, the JSON functions, INET/UUID and
AES/compress (their per-value functions in ``expression/hostfns.py``).
Comparison and ORDER BY under a CI collation go through dense collation
ranks.

String functions are transforms over the sorted dictionary: a Python
function runs once per distinct value on the host (built once per input
dictionary and cached, ``LUT_BUILD`` counts the seconds), and the rows'
codes go through the resulting LUT on the device; a function of a string
that yields an integer or a bool (REGEXP, JSON_LENGTH, INET_ATON, ...) is
one such table gathered by code. A CAST of a column to a string raises
``NotImplementedError``, as in the JAX package.

Null semantics are MySQL three-valued logic carried in validity masks.
Strings are dictionary codes; each dictionary is sorted, so order
comparisons against a literal become integer-code comparisons, with the
literal's position found by binary search at compile time.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tidb_tpu_torch.chunk import Batch, DevCol
from tidb_tpu_torch.dtypes import FLOAT64, US_PER_DAY, US_PER_SECOND, Kind, SQLType
from tidb_tpu_torch.expression import hostfns as H
from tidb_tpu_torch.expression.expr import (
    ARITH,
    BITOPS,
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

#: host seconds spent building dictionary tables (string transforms,
#: per-value LUTs, collation ranks, DATE_FORMAT's day table) and how many
#: were built; a cached table costs nothing again. ``reset_lut_stats``
#: zeroes both.
LUT_BUILD = {"seconds": 0.0, "tables": 0}


def reset_lut_stats() -> None:
    LUT_BUILD["seconds"] = 0.0
    LUT_BUILD["tables"] = 0


def torch_dtype(t: SQLType) -> torch.dtype:
    """Device dtype of a SQL type's physical encoding."""
    return _TORCH_DTYPES[t.np_dtype]


def _rescale(data, diff: int):
    if diff > 0:
        return data * (10**diff)
    if diff < 0:
        return torch.div(data, 10**-diff, rounding_mode="floor")
    return data


def _div_scalar(x, k: float):
    """x / k with the divisor on the device: CUDA divides by a host scalar
    through its reciprocal, which can land one ulp off the quotient and
    round a half case the other way than the CPU does."""
    return x / torch.full((), float(k), dtype=x.dtype, device=x.device)


def _to_float(data, t: SQLType):
    if t.kind == Kind.DECIMAL:
        return _div_scalar(data.to(torch.float64), 10**t.scale)
    return data.to(torch.float64)


def _to_bigint(data, t: Optional[SQLType]):
    """One operand of a bit operator as BIGINT, as MySQL coerces it:
    decimals and floats round half away from zero (decimals in exact
    integer math)."""
    if t is not None and t.kind == Kind.DECIMAL and t.scale:
        d = data.to(torch.int64)
        q = 10**t.scale
        return torch.sign(d) * _floordiv(torch.abs(d) + q // 2, q)
    if data.is_floating_point():
        return (torch.sign(data) * torch.floor(torch.abs(data) + 0.5)).to(torch.int64)
    return data.to(torch.int64)


def _lsr(x, s):
    """Logical right shift of int64 bits (uint64's ``>>``) by a count or a
    tensor of counts in [0, 63]."""
    if isinstance(s, int):
        return x if s == 0 else (x >> s) & ((1 << (64 - s)) - 1)
    sc = s.clamp(1, 63)
    return torch.where(s == 0, x, (x >> sc) & ((torch.ones_like(x) << (64 - sc)) - 1))


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


# keep in sync with planner.physical._BOUNDS_PREFIX (defined there; not
# imported to avoid a kernels <- physical cycle)
_BOUNDS_PREFIX_K = "\x00b\x00"


def _int_bounds(e, dicts):
    """(lo, hi) bounds of a plain integer column from the dicts map's
    reserved entries (Table.col_bounds via the planner), or None."""
    if not isinstance(e, ColumnRef):
        return None
    ent = dicts.get(_BOUNDS_PREFIX_K + e.name)
    if ent is None:
        return None
    get = getattr(ent, "get", None)
    return get() if callable(get) else ent


class _DeviceLUT:
    """A host table built once per compile, copied to each device it is
    gathered on (once) and indexed by clamped codes."""

    def __init__(self, table: np.ndarray):
        self.table = table
        self._on: Dict[str, torch.Tensor] = {}

    def on(self, device) -> torch.Tensor:
        key = str(device)
        t = self._on.get(key)
        if t is None:
            t = self._on[key] = torch.as_tensor(self.table, device=device)
        return t

    def __call__(self, codes: torch.Tensor) -> torch.Tensor:
        t = self.on(codes.device)
        return t[codes.to(torch.int64).clamp(0, t.shape[0] - 1)]


# dictionary tables by (what, input dictionaries). A dictionary of more
# than _BY_VALUE entries is keyed by its identity and held by the entry,
# so its id stays its own; a smaller one (a literal's) by its content.
# The planner asks for one expression's dictionary from several sites
# (key fns, key widths, output dictionaries), and TPC-H Q22 takes one
# SUBSTRING in a filter, a subquery and its GROUP BY: each table is
# built once (1.5M phone numbers at SF10).
_TABLES: "OrderedDict[tuple, tuple]" = OrderedDict()
_BY_VALUE = 64


def _dict_key(d: np.ndarray):
    return ("v", tuple(d.tolist())) if len(d) <= _BY_VALUE else ("id", id(d))


def _cached_table(what: tuple, ds, build):
    """build() once per (what, dictionaries ds), timed into LUT_BUILD."""
    key = (what, tuple(_dict_key(d) for d in ds))
    hit = _TABLES.get(key)
    if hit is not None:
        _TABLES.move_to_end(key)
        return hit[1]
    t0 = time.perf_counter()
    out = build()
    LUT_BUILD["seconds"] += time.perf_counter() - t0
    LUT_BUILD["tables"] += 1
    _TABLES[key] = (tuple(ds), out)
    while len(_TABLES) > 64:
        _TABLES.popitem(last=False)
    return out


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


def _null_codes(b):
    return DevCol(
        torch.zeros(b.capacity, dtype=torch.int32, device=b.device),
        torch.zeros(b.capacity, dtype=torch.bool, device=b.device),
    )


_EMPTY = np.array([], dtype=object)


def string_expr(e: Expr, dicts: DictContext):
    """A string-typed expression as (fn yielding codes, dictionary).

    Computed strings get a new sorted dictionary (the JAX package's, entry
    for entry), and each row's codes are remapped through a table built
    on the host over the input dictionaries."""
    if isinstance(e, ColumnRef):
        if e.name not in dicts:
            raise NotImplementedError(f"string column {e.name} has no dictionary")
        return _compile(e, dicts), dicts[e.name]
    if isinstance(e, Literal):
        if e.value is None:
            return _null_codes, _EMPTY

        def _lit(b):
            return DevCol(
                torch.zeros(b.capacity, dtype=torch.int32, device=b.device),
                torch.ones(b.capacity, dtype=torch.bool, device=b.device),
            )

        return _lit, np.array([str(e.value)], dtype=object)
    if not isinstance(e, Func):
        raise NotImplementedError(f"string expression {type(e).__name__!r} is not ported yet")
    op = e.op
    if op == "_force_bin":
        return string_expr(e.args[0], dicts)  # passthrough marker
    if op in _STR_TRANSFORMS or op in H.JSON_STR_FUNCS:
        return _transform_expr(e, dicts)
    if op in ("dayname", "monthname"):
        return _dayname_expr(e, dicts)
    if op in ("hex", "bin", "oct"):
        return _radix_expr(e, dicts)
    if op == "date_format":
        return _date_format_expr(e, dicts)
    if op == "concat":
        return _concat_expr(e, dicts)
    if op == "concat_ws":
        return _concat_ws_expr(e, dicts)
    if op in ("case", "coalesce", "ifnull"):
        return _string_case(e, dicts)
    raise NotImplementedError(f"string expression {op!r} is not ported yet")


def _string_case(e: Func, dicts: DictContext):
    """String-valued CASE / COALESCE / IFNULL: every branch's codes are
    remapped into the sorted union of the branches' dictionaries (a LUT
    per branch), then selected as a numeric CASE selects."""
    if e.op == "case":
        args = list(e.args)
        else_e = args.pop() if len(args) % 2 == 1 else None
        conds, vals = args[0::2], args[1::2]
    else:
        conds, vals, else_e = None, list(e.args), None
    branches = vals + ([else_e] if else_e is not None else [])
    compiled = [string_expr(v, dicts) for v in branches]
    ds = [d for _, d in compiled]

    def build():
        merged = np.array(sorted({x for d in ds for x in d.tolist()}), dtype=object)
        luts = [
            _DeviceLUT(np.searchsorted(merged, d).astype(np.int32) if len(d)
                       else np.zeros(1, np.int32))
            for d in ds
        ]
        return merged, luts

    merged, luts = _cached_table(("case",), ds, build)

    def remap(fn, lut):
        def g(b):
            c = fn(b)
            return DevCol(lut(c.data), c.valid)

        return g

    rfns = [remap(fn, lut) for (fn, _), lut in zip(compiled, luts)]
    if e.op == "case":
        cond_fns = [_compile(c, dicts) for c in conds]
        else_fn = rfns[-1] if else_e is not None else None
        val_fns = rfns[: len(vals)]

        def _case(b):
            if else_fn is not None:
                ec = else_fn(b)
                out_d, out_v = ec.data, ec.valid
            else:
                out_d = torch.zeros(b.capacity, dtype=torch.int32, device=b.device)
                out_v = torch.zeros(b.capacity, dtype=torch.bool, device=b.device)
            for cf, vf in zip(reversed(cond_fns), reversed(val_fns)):
                c, v = cf(b), vf(b)
                take = c.valid & c.data.to(torch.bool)
                out_d = torch.where(take, v.data, out_d)
                out_v = torch.where(take, v.valid, out_v)
            return DevCol(out_d, out_v)

        return _case, merged

    def _coal(b):
        cols = [f(b) for f in rfns]
        out_d, out_v = cols[-1].data, cols[-1].valid
        for c in reversed(cols[:-1]):
            out_d = torch.where(c.valid, c.data, out_d)
            out_v = c.valid | out_v
        return DevCol(out_d, out_v)

    return _coal, merged


# string -> string builtins run over the dictionary (the JAX package's
# _STR_TRANSFORMS)
_STR_TRANSFORMS = {
    "upper", "lower", "trim", "ltrim", "rtrim", "replace", "substring",
    "left", "right", "reverse", "lpad", "rpad", "repeat", "quote",
    "insert_str", "md5", "sha1", "sha2", "hex_str", "substring_index",
    "soundex", "to_base64", "from_base64", "weight_string", "unhex",
} | H.BINARY_TRANSFORMS

_SOUNDEX = {"b": "1", "f": "1", "p": "1", "v": "1",
            "c": "2", "g": "2", "j": "2", "k": "2", "q": "2", "s": "2", "x": "2", "z": "2",
            "d": "3", "t": "3", "l": "4", "m": "5", "n": "5", "r": "6"}


def _soundex(s):
    # classic Soundex: letter + 3 digits, adjacent duplicates collapsed,
    # vowels dropped
    letters = [c for c in s.lower() if c.isalpha()]
    if not letters:
        return ""
    out = letters[0].upper()
    prev = _SOUNDEX.get(letters[0], "")
    for c in letters[1:]:
        d = _SOUNDEX.get(c, "")
        if d and d != prev:
            out += d
        prev = d
    return (out + "000")[:4]


def _str_transform_pyfn(e: Func):
    """The per-value Python function of a string transform or a
    string-valued JSON function (the JAX package's ``_str_transform_pyfn``
    and ``_json_pyfn``); None from it is SQL NULL."""
    import base64
    import hashlib

    op = e.op
    ex = [a.value for a in e.args[1:]]
    if op in H.JSON_STR_FUNCS:
        return H.json_str_fn(op, ex)
    if op in H.BINARY_TRANSFORMS:
        return H.binary_transform_fn(op, ex)
    if op == "upper":
        return lambda s: s.upper()
    if op == "lower":
        return lambda s: s.lower()
    if op == "trim":
        return lambda s: s.strip()
    if op == "ltrim":
        return lambda s: s.lstrip()
    if op == "rtrim":
        return lambda s: s.rstrip()
    if op == "reverse":
        return lambda s: s[::-1]
    if op == "soundex":
        return _soundex
    if op == "unhex":
        def _unhex(s):
            try:
                return bytes.fromhex(s).decode("utf-8", errors="replace")
            except ValueError:
                return ""

        return _unhex
    if op == "to_base64":
        return lambda s: base64.b64encode(s.encode()).decode()
    if op == "from_base64":
        def _fb64(s):
            try:
                return base64.b64decode(s.encode(), validate=True).decode("utf-8", errors="replace")
            except Exception:
                return ""  # as the JAX package: '' where MySQL gives NULL

        return _fb64
    if op == "weight_string":
        from tidb_tpu_torch.utils import collate as _coll

        return _coll.key_fn(e.args[0].type.collation if e.args[0].type is not None else None)
    if op == "replace":
        frm, to = str(ex[0]), str(ex[1])
        return lambda s: s.replace(frm, to) if frm else s
    if op == "left":
        n = max(int(ex[0]), 0)
        return lambda s: s[:n]
    if op == "right":
        n = max(int(ex[0]), 0)
        return lambda s: s[-n:] if n else ""
    if op == "repeat":
        n = max(int(ex[0]), 0)
        return lambda s: s * n
    if op in ("lpad", "rpad"):
        n, pad = int(ex[0]), str(ex[1])
        left = op == "lpad"

        def _pad(s):
            if len(s) >= n or not pad:
                return s[:n]
            fill = (pad * n)[: n - len(s)]
            return fill + s if left else s + fill

        return _pad
    if op == "substring":
        pos = int(ex[0])
        ln = int(ex[1]) if len(ex) > 1 else None

        def _sub(s):
            if pos > 0:
                i = pos - 1
            elif pos < 0:
                i = max(len(s) + pos, 0)
            else:
                return ""  # MySQL: SUBSTRING(s, 0) = ''
            if ln is None:
                return s[i:]
            return s[i : i + max(ln, 0)]

        return _sub
    if op == "substring_index":
        delim, cnt = str(ex[0]), int(ex[1])

        def _si(s):
            if cnt == 0 or not delim:
                return ""
            parts = s.split(delim)
            return delim.join(parts[:cnt] if cnt > 0 else parts[cnt:])

        return _si
    if op == "quote":
        return lambda s: "'" + s.replace("\\", "\\\\").replace("'", "\\'") + "'"
    if op == "insert_str":
        pos, ln, repl = int(ex[0]), int(ex[1]), str(ex[2])

        def _ins(s):
            if pos < 1 or pos > len(s):
                return s
            if ln < 0 or pos - 1 + ln >= len(s):
                return s[: pos - 1] + repl  # MySQL: replace to the end
            return s[: pos - 1] + repl + s[pos - 1 + ln:]

        return _ins
    if op == "md5":
        return lambda s: hashlib.md5(s.encode()).hexdigest()
    if op == "sha1":
        return lambda s: hashlib.sha1(s.encode()).hexdigest()
    if op == "sha2":
        bits = int(ex[0]) if ex else 256
        algo = {224: "sha224", 256: "sha256", 384: "sha384", 512: "sha512", 0: "sha256"}.get(bits)
        if algo is None:
            return lambda s: None  # MySQL: invalid hash length -> NULL
        return lambda s: getattr(hashlib, algo)(s.encode()).hexdigest()
    if op == "hex_str":
        return lambda s: s.encode().hex().upper()
    raise AssertionError(op)


def _transform_expr(e: Func, dicts: DictContext):
    """A string transform: (fn yielding codes, new sorted dictionary). The
    input dictionary is mapped once on the host; the rows' codes go
    through the resulting code LUT on the device, with a validity LUT
    where the function yields NULL."""
    for a in e.args[1:]:
        if not isinstance(a, Literal) or a.param_slot is not None:
            raise NotImplementedError(f"{e.op}: only literal extra arguments are ported")
    fn, d = string_expr(e.args[0], dicts)
    coll = e.args[0].type.collation if e.args[0].type is not None else None
    what = (e.op, tuple(repr(a.value) for a in e.args[1:]), coll if e.op == "weight_string" else None)

    def build():
        pyfn = _str_transform_pyfn(e)
        many = getattr(pyfn, "many", None)
        vals = [str(v) for v in d.tolist()]
        outs = many(vals) if many is not None else list(map(pyfn, vals))
        present = sorted({o for o in outs if o is not None})
        index = {v: i for i, v in enumerate(present)}
        codes = np.fromiter((index.get(o, 0) for o in outs), dtype=np.int32, count=len(outs))
        ok = None
        if any(o is None for o in outs):
            ok = _DeviceLUT(np.array([o is not None for o in outs], dtype=bool))
        return (_DeviceLUT(codes if len(codes) else np.zeros(1, np.int32)), ok,
                np.array(present, dtype=object))

    lut, ok, new_dict = _cached_table(what, (d,), build)

    def _tf(b):
        c = fn(b)
        valid = c.valid if ok is None else c.valid & ok(c.data)
        return DevCol(lut(c.data), valid)

    return _tf, new_dict


_DAY_NAMES = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday", "Sunday"]
_MONTH_NAMES = ["January", "February", "March", "April", "May", "June", "July",
                "August", "September", "October", "November", "December"]


def _dayname_expr(e: Func, dicts: DictContext):
    """DAYNAME / MONTHNAME: index math on the device into a fixed sorted
    dictionary of the names."""
    names = _DAY_NAMES if e.op == "dayname" else _MONTH_NAMES
    new_dict = np.array(sorted(names), dtype=object)
    idx_to_code = _DeviceLUT(np.searchsorted(new_dict, np.array(names, dtype=object)).astype(np.int32))
    f = _compile(e.args[0], dicts)
    t0 = e.args[0].type
    is_day = e.op == "dayname"

    def _dn(b):
        c = f(b)
        days = _to_days(c.data, t0)
        idx = torch.remainder(days + 3, 7) if is_day else _civil_from_days(days)[1] - 1
        return DevCol(idx_to_code(idx), c.valid)

    return _dn, new_dict


def _radix_expr(e: Func, dicts: DictContext):
    """HEX / BIN / OCT: of a string, the bytes' hex (a transform); of a
    literal, its folded text; of an integer column whose storage bounds
    span at most 2^16 values, a LUT over that range (negatives render as
    64-bit two's complement, as MySQL does)."""
    t0 = e.args[0].type
    fmt = {"hex": "X", "bin": "b", "oct": "o"}[e.op]
    if t0 is not None and t0.kind == Kind.STRING:
        if e.op != "hex":
            raise NotImplementedError(f"{e.op.upper()} of a string")
        return string_expr(Func(type=e.type, op="hex_str", args=e.args), dicts)
    if isinstance(e.args[0], Literal):
        v = e.args[0].value
        if v is None:
            return string_expr(Literal(type=e.type, value=None), dicts)
        iv = int(v)
        if iv < 0:
            iv &= (1 << 64) - 1
        return string_expr(Literal(type=e.type, value=format(iv, fmt)), dicts)
    cb = _int_bounds(e.args[0], dicts)
    if cb is None or cb[1] - cb[0] > (1 << 16):
        raise NotImplementedError(
            f"{e.op.upper()} needs a string or narrowly-bounded integer column"
        )
    lo, hi = int(cb[0]), int(cb[1])

    def build():
        outs = [format(v & ((1 << 64) - 1) if v < 0 else v, fmt) for v in range(lo, hi + 1)]
        new_dict = np.array(sorted(set(outs)), dtype=object)
        codes = np.searchsorted(new_dict, np.array(outs, dtype=object)).astype(np.int32)
        return _DeviceLUT(codes), new_dict

    lut, new_dict = _cached_table((e.op, lo, hi), (), build)
    f = _compile(e.args[0], dicts)

    def _i2s(b):
        c = f(b)
        return DevCol(lut(c.data.to(torch.int64) - lo), c.valid)

    return _i2s, new_dict


_MYSQL_FMT = {
    "%Y": "%Y", "%y": "%y", "%m": "%m", "%d": "%d", "%H": "%H",
    "%i": "%M", "%s": "%S", "%S": "%S", "%M": "%B", "%b": "%b",
    "%a": "%a", "%W": "%A", "%p": "%p", "%f": "%f", "%j": "%j",
    "%T": "%H:%M:%S", "%r": "%I:%M:%S %p", "%%": "%%", "%h": "%I",
    "%I": "%I", "%e": "%d", "%c": "%m", "%k": "%H", "%l": "%I",
}

_TIME_TOKENS = ("%H", "%i", "%s", "%S", "%T", "%r", "%f", "%h", "%I", "%k", "%l", "%p")


def _mysql_fmt_to_py(fmt: str) -> str:
    out = []
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "%" and i + 1 < len(fmt):
            tok = fmt[i:i + 2]
            py = _MYSQL_FMT.get(tok)
            if py is None:
                raise NotImplementedError(f"date format token {tok}")
            out.append(py)
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _date_format_expr(e: Func, dicts: DictContext):
    """DATE_FORMAT: a day -> string table over 1900-01-01..2155-12-31
    (values outside clamp), as the JAX package's; built once per format."""
    import datetime as _dt

    if not isinstance(e.args[1], Literal):
        raise NotImplementedError("DATE_FORMAT: only a literal format is ported")
    raw = e.args[1].value
    if raw is None:
        return string_expr(Literal(type=e.type, value=None), dicts)
    raw = str(raw)
    t0 = e.args[0].type
    if t0 is not None and t0.kind == Kind.DATETIME and any(tok in raw for tok in _TIME_TOKENS):
        # the table is day-granular; time-of-day tokens would render midnight
        raise NotImplementedError("DATE_FORMAT with time tokens over DATETIME")
    fmt = _mysql_fmt_to_py(raw)
    epoch = _dt.date(1970, 1, 1).toordinal()
    lo = _dt.date(1900, 1, 1).toordinal() - epoch
    hi = _dt.date(2155, 12, 31).toordinal() - epoch

    def build():
        outs = [_dt.date.fromordinal(epoch + d).strftime(fmt) for d in range(lo, hi + 1)]
        new_dict = np.array(sorted(set(outs)), dtype=object)
        codes = np.searchsorted(new_dict, np.array(outs, dtype=object)).astype(np.int32)
        return _DeviceLUT(codes), new_dict

    lut, new_dict = _cached_table(("date_format", fmt), (), build)
    f = _compile(e.args[0], dicts)

    def _df(b):
        c = f(b)
        return DevCol(lut(torch.clamp(_to_days(c.data, t0), lo, hi) - lo), c.valid)

    return _df, new_dict


def _fmt_scalar(v) -> str:
    if isinstance(v, float) and v == int(v):
        return str(int(v)) if abs(v) < 1e15 else repr(v)
    return str(v)


def _string_parts(args, dicts: DictContext, what: str):
    """(fn, dictionary) per argument; non-string literals coerce to text,
    non-string columns are refused (no per-row host work)."""
    parts = []
    for a in args:
        if a.type is not None and a.type.kind == Kind.STRING:
            parts.append(string_expr(a, dicts))
        elif isinstance(a, Literal):
            v = a.value
            parts.append(string_expr(Literal(type=None, value=None if v is None else _fmt_scalar(v)), {}))
        else:
            raise NotImplementedError(f"{what} over non-string columns: CAST ... AS CHAR first")
    return parts


def _mixed_radix(sizes):
    strides, acc = [], 1
    for s in reversed(sizes):
        strides.append(acc)
        acc *= s
    strides.reverse()
    return strides, acc


#: the largest dictionary product CONCAT and CONCAT_WS map (the JAX
#: package's limit)
_CONCAT_COMBOS = 1 << 20


def _concat_expr(e: Func, dicts: DictContext):
    """CONCAT over string expressions and literals: the output dictionary
    is the deduplicated mixed-radix product of the input dictionaries;
    codes combine arithmetically on the device and remap through one LUT."""
    parts = _string_parts(e.args, dicts, "CONCAT")
    ds = [d for _, d in parts]
    sizes = [max(len(d), 1) for d in ds]
    strides, total = _mixed_radix(sizes)
    if total > _CONCAT_COMBOS:
        raise NotImplementedError(f"CONCAT dictionary product too large ({total} combos)")

    def build():
        combos = [""]
        for d in ds:
            ss = [str(x) for x in d.tolist()] or [""]
            combos = [c + s for c in combos for s in ss]
        merged = np.array(sorted(set(combos)), dtype=object)
        lut = np.searchsorted(merged, np.array(combos, dtype=object)).astype(np.int32)
        return _DeviceLUT(lut), merged

    lut, merged = _cached_table(("concat",), ds, build)

    def _cc(b):
        idx = torch.zeros(b.capacity, dtype=torch.int64, device=b.device)
        valid = torch.ones(b.capacity, dtype=torch.bool, device=b.device)
        for (fn, _d), size, stride in zip(parts, sizes, strides):
            c = fn(b)
            idx = idx + torch.clamp(c.data.to(torch.int64), 0, size - 1) * stride
            valid = valid & c.valid
        return DevCol(lut(idx), valid)

    return _cc, merged


def _concat_ws_expr(e: Func, dicts: DictContext):
    """CONCAT_WS(sep, ...): NULL arguments are skipped, not propagated;
    each argument gets an extra slot meaning NULL, and the combo table
    joins the non-NULL values."""
    sep_e = e.args[0]
    if not isinstance(sep_e, Literal):
        raise NotImplementedError("CONCAT_WS separator must be a literal")
    if sep_e.value is None:
        return _null_codes, _EMPTY
    sep = str(sep_e.value)
    parts = _string_parts(e.args[1:], dicts, "CONCAT_WS")
    ds = [d for _, d in parts]
    sizes = [len(d) + 1 for d in ds]  # last slot = NULL
    strides, total = _mixed_radix(sizes)
    if total > _CONCAT_COMBOS:
        raise NotImplementedError(f"CONCAT_WS dictionary product too large ({total} combos)")

    def build():
        combos: list = [[]]
        for d in ds:
            opts = [str(x) for x in d.tolist()] + [None]
            combos = [c + [o] for c in combos for o in opts]
        joined = [sep.join(v for v in c if v is not None) for c in combos]
        merged = np.array(sorted(set(joined)), dtype=object)
        lut = np.searchsorted(merged, np.array(joined, dtype=object)).astype(np.int32)
        return _DeviceLUT(lut), merged

    lut, merged = _cached_table(("concat_ws", sep), ds, build)

    def _cw(b):
        idx = torch.zeros(b.capacity, dtype=torch.int64, device=b.device)
        for (fn, _d), size, stride in zip(parts, sizes, strides):
            c = fn(b)
            null_slot = size - 1
            code = torch.where(
                c.valid, torch.clamp(c.data.to(torch.int64), 0, max(null_slot - 1, 0)),
                torch.full_like(idx, null_slot),
            )
            idx = idx + code * stride
        return DevCol(lut(idx), torch.ones(b.capacity, dtype=torch.bool, device=b.device))

    return _cw, merged


def _null_col(dtype):
    def _f(b):
        return DevCol(
            torch.zeros(b.capacity, dtype=dtype, device=b.device),
            torch.zeros(b.capacity, dtype=torch.bool, device=b.device),
        )

    return _f


def _unary(fn, f):
    """Row function of one compiled argument: fn(data) keeps its validity."""

    def _u(b):
        c = f(b)
        return DevCol(fn(c.data), c.valid)

    return _u


def _compile(e: Expr, dicts: DictContext) -> _CompiledExpr:
    if isinstance(e, ColumnRef):
        name = e.name
        return lambda b: b.cols[name]
    if isinstance(e, Literal):
        return _compile_literal(e)
    if not isinstance(e, Func):
        raise NotImplementedError(f"expression {type(e).__name__!r} is not ported yet")
    op = e.op
    if op in ARITH or op in COMPARE or op in BITOPS or op == "nulleq":
        return _compile_binary(e, dicts)
    if op == "bit_neg":
        ta = e.args[0].type
        return _unary(lambda d: ~_to_bigint(d, ta), _compile(e.args[0], dicts))
    if op == "bit_count":
        ta = e.args[0].type
        return _unary(lambda d: _popcount(_to_bigint(d, ta)), _compile(e.args[0], dicts))
    if op in ("and", "or"):
        return _compile_logic(e, dicts)
    if op == "not":
        return _unary(lambda d: ~d.to(torch.bool), _compile(e.args[0], dicts))
    if op == "neg":
        return _unary(lambda d: -d, _compile(e.args[0], dicts))
    if op in ("isnull", "isnotnull"):
        (a,) = [_compile(x, dicts) for x in e.args]
        want_null = op == "isnull"

        def _isnull(b):
            v = a(b).valid
            return DevCol(~v if want_null else v, torch.ones_like(v))

        return _isnull
    if op in ("case", "coalesce", "ifnull"):
        if _is_string_col(e):
            return string_expr(e, dicts)[0]
        return _compile_case(e, dicts) if op == "case" else _compile_coalesce(e, dicts)
    if op == "like":
        return _compile_like(e, dicts)
    if op == "in":
        return _compile_in(e, dicts)
    if op in _EXTRACT_PARTS:
        return _compile_extract(e, dicts)
    if op in ("hour", "minute", "second", "microsecond"):
        return _compile_time_part(e, dicts)
    if op == "add_months":
        return _compile_add_months(e, dicts)
    if op == "add_us":
        # DATETIME/TIME +/- a microsecond count (sub-day INTERVAL units
        # lower to this; DATE operands promote to midnight)
        fa, fb = (_compile(a, dicts) for a in e.args)
        ta = e.args[0].type

        def _aus(b):
            a, c = fa(b), fb(b)
            return DevCol(_to_micros(a.data, ta) + c.data.to(torch.int64), a.valid & c.valid)

        return _aus
    if op == "date_part_days":
        # DATE(datetime_expr): truncate micros to days
        f = _compile(e.args[0], dicts)
        if e.args[0].type is not None and e.args[0].type.kind == Kind.DATETIME:
            return _unary(lambda d: _floordiv(d, US_PER_DAY).to(torch.int32), f)
        return f
    if op == "cast":
        return _compile_cast(e, dicts)
    if op == "datediff":
        fa, fb = (_compile(a, dicts) for a in e.args)
        ta, tb = (a.type for a in e.args)

        def _dd(b):
            a, c = fa(b), fb(b)
            return DevCol(_to_days(a.data, ta) - _to_days(c.data, tb), a.valid & c.valid)

        return _dd
    if op == "field":
        return _compile_field(e, dicts)
    if op == "_force_bin":
        return _compile(e.args[0], dicts)  # passthrough marker
    if op == "_collation_rank":
        # ORDER BY on a CI-collated string: sort by the dense collation
        # rank of each value (equal-under-collation values tie; the stable
        # sort keeps their stored order)
        f, dictionary = string_expr(e.args[0], dicts)
        coll = e.args[0].type.collation if e.args[0].type is not None else None
        lut = _DeviceLUT(_collation_rank_lut(dictionary, coll)[0])
        return _unary(lut, f)
    if op in ("period_add", "period_diff"):
        fa, fb = (_compile(a, dicts) for a in e.args)

        def _period(b, _op=op):
            a, c = fa(b), fb(b)
            ad, cd = a.data.to(torch.int64), c.data.to(torch.int64)
            months1 = _floordiv(ad, 100) * 12 + (torch.remainder(ad, 100) - 1)
            if _op == "period_add":
                t = months1 + cd
                d = _floordiv(t, 12) * 100 + torch.remainder(t, 12) + 1
            else:
                d = months1 - (_floordiv(cd, 100) * 12 + (torch.remainder(cd, 100) - 1))
            return DevCol(d, a.valid & c.valid)

        return _period
    if op in _STRLUT_FNS:
        return _compile_strlut(e.args[0], dicts, _STRLUT_FNS[op], np.int64, key=(op,))
    if op == "find_in_set":
        needle_e, setcol = e.args
        if not isinstance(needle_e, Literal):
            raise NotImplementedError("FIND_IN_SET needle must be a literal")
        if needle_e.value is None:
            return _null_col(torch.int64)
        nv = str(needle_e.value)

        def _fis(s):
            parts = s.split(",")
            return parts.index(nv) + 1 if nv in parts else 0

        return _compile_strlut(setcol, dicts, _fis, np.int64, key=(op, nv))
    if op == "interval_fn":
        # INTERVAL(N, a, b, ...): index of the last arg <= N (args assumed
        # ascending, per MySQL); NULL N -> -1
        fns = [_compile(a, dicts) for a in e.args]

        def _ivl(b):
            n = fns[0](b)
            cnt = torch.zeros(b.capacity, dtype=torch.int64, device=b.device)
            nd = n.data.to(torch.float64)
            for f in fns[1:]:
                c = f(b)
                cnt = cnt + (c.valid & (c.data.to(torch.float64) <= nd)).to(torch.int64)
            return DevCol(torch.where(n.valid, cnt, -1),
                          torch.ones(b.capacity, dtype=torch.bool, device=b.device))

        return _ivl
    if op == "locate":
        s, sub = e.args
        if not isinstance(sub, Literal):
            raise NotImplementedError("LOCATE needle must be a literal")
        if sub.value is None:
            return _null_col(torch.int64)
        needle = str(sub.value)
        return _compile_strlut(s, dicts, lambda v: v.find(needle) + 1, np.int64, key=(op, needle))
    if op in _STR_VALUED_FNS:
        return _compile_str_valued(e, dicts)
    if op in _STR_TRANSFORMS or op in H.JSON_STR_FUNCS or op in (
        "concat", "concat_ws", "dayname", "monthname", "date_format", "hex", "bin", "oct",
    ):
        return string_expr(e, dicts)[0]
    if op in _MATH_UNARY_FLOAT or op in ("abs", "sign", "floor", "ceil", "round", "truncate"):
        return _compile_math(e, dicts)
    if op in ("pow", "atan2", "log"):
        return _compile_math2(e, dicts)
    if op == "pi":
        return lambda b: DevCol(
            torch.full((b.capacity,), np.pi, dtype=torch.float64, device=b.device),
            torch.ones(b.capacity, dtype=torch.bool, device=b.device),
        )
    if op in ("greatest", "least"):
        return _compile_extremum(e, dicts)
    if op in _DATE_MISC:
        return _compile_date_misc(e, dicts)
    if op == "str_to_date":
        return _compile_str_to_date(e, dicts)
    raise NotImplementedError(f"function {op!r} is not ported yet")


def _popcount(x):
    """SWAR popcount of int64 bits (as uint64), shifts logical."""
    u = x - (_lsr(x, 1) & 0x5555555555555555)
    u = (u & 0x3333333333333333) + (_lsr(u, 2) & 0x3333333333333333)
    u = (u + _lsr(u, 4)) & 0x0F0F0F0F0F0F0F0F
    return _lsr(u * 0x0101010101010101, 56)


def _ord(s):
    # MySQL ORD: the leading character's byte sequence as a number
    if not s:
        return 0
    v = 0
    for byte in s[0].encode():
        v = v * 256 + byte
    return v


def _crc32(s):
    import zlib

    return zlib.crc32(s.encode())


_STRLUT_FNS = {
    "length": lambda s: len(s.encode()),
    "char_length": len,
    "bit_length": lambda s: len(s.encode()) * 8,
    "ascii": lambda s: s.encode()[0] if s else 0,
    "ord": _ord,
    "crc32": _crc32,
}


#: functions of a string that yield an integer or a bool, one table over
#: the input dictionary each (the JAX package's kernels.py:1448-1824)
_STR_VALUED_FNS = {
    "regexp", "regexp_like", "regexp_instr", "json_contains", "json_valid", "json_length",
    "json_depth", "json_contains_path", "json_overlaps", "json_storage_size", "is_uuid",
    "is_ipv4", "is_ipv6", "is_ipv4_compat", "is_ipv4_mapped", "uncompressed_length",
    "inet_aton",
}


def _literal_args(e: Func, first: int, what: str) -> list:
    """The values of e.args[first:], each a literal, or the JAX package's
    refusal naming `what`."""
    for a in e.args[first:]:
        if not isinstance(a, Literal) or a.param_slot is not None:
            raise NotImplementedError(what)
    return [a.value for a in e.args[first:]]


def _compile_str_valued(e: Func, dicts: DictContext) -> _CompiledExpr:
    """REGEXP / REGEXP_LIKE / REGEXP_INSTR, the JSON predicates and
    measures, IS_UUID, IS_IPV4 and kin, UNCOMPRESSED_LENGTH and INET_ATON:
    `pyfn` over the first argument's dictionary on the host, one gather on
    the device. A pattern, path or candidate is a literal, as in the JAX
    package."""
    op = e.op
    col = e.args[0]
    if op in ("regexp", "regexp_like", "regexp_instr"):
        pat = e.args[1]
        if not isinstance(pat, Literal) or pat.param_slot is not None:
            raise NotImplementedError("REGEXP pattern must be a literal")
        pv = pat.value
        out_dtype = np.int64 if op == "regexp_instr" else np.bool_
        if pv is None:
            return _null_col(torch.int64 if op == "regexp_instr" else torch.bool)
        rx = re.compile(str(pv))
        if op == "regexp_instr":
            def pyfn(s):
                m = rx.search(s)
                return (m.start() + 1) if m else 0
        else:
            def pyfn(s):
                return rx.search(s) is not None
        return _compile_strlut(col, dicts, pyfn, out_dtype, key=(op, str(pv)))
    if op == "json_contains":
        ex = _literal_args(e, 1, "JSON_CONTAINS candidate/path must be literals")
        pyfn, out_dtype = H.json_contains_fn(ex[0], ex[1] if len(ex) > 1 else None), np.bool_
    elif op == "json_length":
        ex = _literal_args(e, 1, "json_length path must be literal")
        pyfn, out_dtype = H.json_length_fn(str(ex[0]) if ex else None), np.int64
    elif op == "json_contains_path":
        ex = _literal_args(e, 1, "json_contains_path mode and paths must be literals")
        pyfn, out_dtype = H.json_contains_path_fn(ex[0], ex[1:]), np.bool_
    elif op == "json_overlaps":
        ex = _literal_args(e, 1, "json_overlaps candidate must be a literal")
        pyfn, out_dtype = H.json_overlaps_fn(ex[0]), np.bool_
    elif op in ("is_ipv4", "is_ipv6", "is_ipv4_compat", "is_ipv4_mapped"):
        ex, pyfn, out_dtype = [], H.ip_predicate(op), np.bool_
    else:
        ex = []
        pyfn, out_dtype = {
            "json_valid": (H.json_valid, np.int64),
            "json_depth": (H.json_depth, np.int64),
            "json_storage_size": (H.json_storage_size, np.int64),
            "is_uuid": (H.is_uuid, np.bool_),
            "uncompressed_length": (H.uncompressed_length, np.int64),
            "inet_aton": (H.inet_aton, np.int64),
        }[op]
    return _compile_strlut(col, dicts, pyfn, out_dtype, key=(op, repr(ex)))


def _compile_field(e: Func, dicts: DictContext) -> _CompiledExpr:
    """FIELD(x, v1, v2, ...): the 1-based index of x among the values, 0
    when absent or when x is NULL; NULL values never match."""
    x = e.args[0]
    needles = []  # (1-based position, value)
    for pos, a in enumerate(e.args[1:], 1):
        if not isinstance(a, Literal):
            raise NotImplementedError("FIELD values must be literals")
        if a.value is not None:
            needles.append((pos, a.value))
    if _is_string_col(x):
        if all(isinstance(v, str) for _p, v in needles):
            sn = {str(v): pos for pos, v in reversed(needles)}

            def lut_fn(s):
                return sn.get(s, 0)
        else:
            # mixed string/numeric arguments compare as doubles (MySQL)
            def _f(xv):
                try:
                    return float(xv)
                except (TypeError, ValueError):
                    return 0.0

            def lut_fn(sv):
                for pos, v in needles:
                    if (isinstance(v, str) and v == sv) or (not isinstance(v, str) and _f(sv) == _f(v)):
                        return pos
                return 0

        inner = _compile_strlut(x, dicts, lut_fn, np.int64, key=("field", repr(needles)))

        def _sfield(b):
            c = inner(b)
            # FIELD(NULL, ...) is 0, not NULL
            return DevCol(torch.where(c.valid, c.data, 0), torch.ones_like(c.valid))

        return _sfield
    fx = _compile(x, dicts)
    pneedles = [(pos, literal_phys(v, x.type)) for pos, v in needles]

    def _field(b):
        c = fx(b)
        out = torch.zeros(b.capacity, dtype=torch.int64, device=b.device)
        for pos, v in reversed(pneedles):
            out = torch.where(c.valid & (c.data == v), pos, out)
        return DevCol(out, torch.ones(b.capacity, dtype=torch.bool, device=b.device))

    return _field


def _compile_cast(e: Func, dicts: DictContext) -> _CompiledExpr:
    """CAST between numeric and date types, as the JAX package's
    ``_compile_cast`` rounds: DECIMAL to fewer places and to INT floors
    (the scaled integer's floor division), DOUBLE to INT or DECIMAL
    rounds half to even, DOUBLE to DATE truncates."""
    (a,) = e.args
    src, dst = a.type, e.type
    if dst.kind == Kind.STRING:
        raise NotImplementedError(f"CAST from {src.kind.value} to string is not ported yet")
    if src.kind == Kind.STRING:
        return _cast_from_string(a, dst, dicts)
    f = _compile(a, dicts)
    if {src.kind, dst.kind} == {Kind.DATE, Kind.DATETIME}:

        def _cast_dt(b):
            c = f(b)
            if dst.kind == Kind.DATETIME:
                return DevCol(c.data.to(torch.int64) * US_PER_DAY, c.valid)
            return DevCol(torch.div(c.data, US_PER_DAY, rounding_mode="floor").to(torch.int32),
                          c.valid)

        return _cast_dt
    if dst.kind not in (Kind.FLOAT, Kind.INT, Kind.DECIMAL, Kind.DATE, Kind.BOOL):
        raise NotImplementedError(f"CAST to {dst.kind.value} is not ported yet")

    def _cast(b):
        c = f(b)
        d = c.data
        if dst.kind == Kind.FLOAT:
            d = _to_float(d, src)
        elif dst.kind == Kind.INT:
            if src.kind == Kind.DECIMAL:
                d = _rescale(d, -src.scale)
            elif src.kind == Kind.FLOAT:
                d = torch.round(d).to(torch.int64)
            else:
                d = d.to(torch.int64)
        elif dst.kind == Kind.DECIMAL:
            if src.kind == Kind.DECIMAL:
                d = _rescale(d, dst.scale - src.scale)
            elif src.kind == Kind.FLOAT:
                d = torch.round(d * 10**dst.scale).to(torch.int64)
            else:
                d = d.to(torch.int64) * (10**dst.scale)
        elif dst.kind == Kind.DATE:
            d = d.to(torch.int32)
        else:
            d = d.to(torch.bool)
        return DevCol(d, c.valid)

    return _cast


def _cast_from_string(a: Expr, dst: SQLType, dicts: DictContext) -> _CompiledExpr:
    """CAST of a string to a date, time or number: each dictionary entry
    is parsed once on the host into a LUT the codes gather from (an
    unparsable date or time is NULL; a number takes the string's numeric
    prefix, 0 without one), as the JAX package does."""
    from tidb_tpu_torch.dtypes import date_to_days, datetime_to_micros, time_to_micros

    f, dictionary = string_expr(a, dicts)
    strs = [str(x) for x in dictionary.tolist()] or [""]
    if dst.kind in (Kind.DATE, Kind.DATETIME, Kind.TIME):
        parse = {Kind.DATE: date_to_days, Kind.DATETIME: datetime_to_micros,
                 Kind.TIME: time_to_micros}[dst.kind]
        vals = np.zeros(len(strs), dtype=np.int32 if dst.kind == Kind.DATE else np.int64)
        ok = np.zeros(len(strs), dtype=bool)
        for i, x in enumerate(strs):
            try:
                vals[i] = parse(x)
                ok[i] = True
            except Exception:
                pass
    elif dst.kind in (Kind.FLOAT, Kind.INT, Kind.DECIMAL):

        def tonum(x):
            try:
                return float(x)
            except ValueError:
                m = re.match(r"\s*-?\d+(\.\d+)?", x)
                return float(m.group(0)) if m else 0.0

        lut = np.array([tonum(x) for x in strs], dtype=np.float64)
        if dst.kind == Kind.INT:
            vals = np.round(lut).astype(np.int64)
        elif dst.kind == Kind.DECIMAL:
            vals = np.round(lut * 10**dst.scale).astype(np.int64)
        else:
            vals = lut
        ok = None
    else:
        raise NotImplementedError(f"CAST from string to {dst.kind.value} is not ported yet")
    vals_t = _DeviceLUT(vals)
    ok_t = None if ok is None else _DeviceLUT(ok)

    def _cast_s(b):
        c = f(b)
        valid = c.valid if ok_t is None else c.valid & ok_t(c.data)
        return DevCol(vals_t(c.data), valid)

    return _cast_s


def _compile_literal(e: Literal) -> _CompiledExpr:
    if e.param_slot is not None:
        # EXECUTE binds every parameter as a plain literal first
        raise ValueError(f"parameter {e.param_slot + 1} has no value: bind it with EXECUTE")
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
        if op in BITOPS:
            # each operand coerces to BIGINT on its own
            x, y = _to_bigint(a.data, ta), _to_bigint(c.data, tb)
        elif op == "div":
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
        elif op == "bit_and":
            d = x & y
        elif op == "bit_or":
            d = x | y
        elif op == "bit_xor":
            d = x ^ y
        elif op in ("shl", "shr"):
            # MySQL: shift counts outside [0, 63] yield 0; >> is logical
            inrange = (y >= 0) & (y < 64)
            ys = torch.where(inrange, y, 0)
            d = torch.where(inrange, x << ys if op == "shl" else _lsr(x, ys), 0)
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


def _collation_rank_lut(dictionary, coll):
    """(rank LUT, sorted distinct keys, key fn) for a collated dictionary:
    rank[code] is the dense rank of the entry's collation sort key, so
    equal keys share a rank and comparing ranks is the collation's
    comparison. Built once per dictionary."""
    from tidb_tpu_torch.utils import collate as _coll

    kf = _coll.key_fn(coll)

    def build():
        if not len(dictionary):
            return np.zeros(1, np.int64), []
        ks = [kf(str(s)) for s in dictionary.tolist()]
        keys = sorted(set(ks))
        pos = {k: i for i, k in enumerate(keys)}
        return np.array([pos[k] for k in ks], dtype=np.int64), keys

    ranks, keys = _cached_table(("rank", (coll or "").lower()), (dictionary,), build)
    return ranks, keys, kf


def _compile_strcmp(e: Func, dicts: DictContext, flipped: bool) -> _CompiledExpr:
    op = e.op
    col, lit = (e.args[1], e.args[0]) if flipped else (e.args[0], e.args[1])
    if flipped:
        op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}.get(op, op)
    f, dictionary = string_expr(col, dicts)
    if lit.value is None:

        def _nullcmp(b):
            c = f(b)
            if op == "nulleq":  # col <=> NULL: TRUE exactly where NULL
                return DevCol(~c.valid, torch.ones_like(c.valid))
            z = torch.zeros_like(c.valid)
            return DevCol(z, z)

        return _nullcmp
    from tidb_tpu_torch.utils import collate as _coll

    coll = col.type.collation if col.type is not None else None
    rank = None
    if not _coll.is_binary(coll):
        # CI column: compare dense collation ranks, not raw codes
        ranks, keys, kf = _collation_rank_lut(dictionary, coll)
        rank = _DeviceLUT(ranks)
        kl = kf(str(lit.value))
        pos = bisect.bisect_left(keys, kl)
        exact = pos < len(keys) and keys[pos] == kl
    else:
        pos, exact = _string_literal_code(dictionary, str(lit.value))

    def _cmp_code(b):
        c = f(b)
        code = c.data if rank is None else rank(c.data)
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
    """String vs string: remap both sides into a merged sorted dictionary
    (in the collation's key space when either side is CI), then compare
    codes as integers."""
    from tidb_tpu_torch.utils import collate as _coll

    op, (ea, eb) = e.op, e.args
    coll = (ea.type.collation if ea.type is not None else None) or (
        eb.type.collation if eb.type is not None else None
    )
    fa, da = string_expr(ea, dicts)
    fb, db = string_expr(eb, dicts)

    def build():
        _m, la, lb = _coll.merge_rank_luts(da, db, coll)
        return _DeviceLUT(np.asarray(la, dtype=np.int64)), _DeviceLUT(np.asarray(lb, dtype=np.int64))

    lut_a, lut_b = _cached_table(("strstr", coll), (da, db), build)

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


def _compile_coalesce(e: Func, dicts: DictContext) -> _CompiledExpr:
    """Numeric COALESCE / IFNULL: the first non-NULL argument, each brought
    to the target's representation."""
    fns = [_compile(a, dicts) for a in e.args]
    types = [a.type for a in e.args]
    target = e.type

    def _coal(b):
        cols = [f(b) for f in fns]
        datas = []
        for c, t in zip(cols, types):
            if target.kind == Kind.FLOAT:
                datas.append(_to_float(c.data, t))
            elif target.kind == Kind.DECIMAL and t.kind in (Kind.DECIMAL, Kind.INT):
                datas.append(_rescale(c.data.to(torch.int64),
                                      target.scale - (t.scale if t.kind == Kind.DECIMAL else 0)))
            else:
                datas.append(c.data)
        out_d, out_v = datas[-1], cols[-1].valid
        for d, c in zip(reversed(datas[:-1]), reversed(cols[:-1])):
            out_d = torch.where(c.valid, d, out_d)
            out_v = c.valid | out_v
        return DevCol(out_d, out_v)

    return _coal


def _compile_case(e: Func, dicts: DictContext) -> _CompiledExpr:
    """CASE WHEN c1 THEN v1 ... [ELSE v] END into a numeric target: the
    first true condition's value, the ELSE value otherwise (NULL with
    no ELSE), each value brought to the target's representation."""
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


def _compile_strlut(col: Expr, dicts: DictContext, pyfn, out_dtype, key=None) -> _CompiledExpr:
    """A per-value function of a string column as one gather: the LUT is
    `pyfn` over the column's dictionary, built on the host (once per
    dictionary when `key` names the function)."""
    f, dictionary = string_expr(col, dicts)

    def build():
        return _DeviceLUT(
            np.array([pyfn(str(s)) for s in dictionary.tolist()]).astype(out_dtype)
            if len(dictionary)
            else np.zeros(1, dtype=out_dtype)
        )

    lut = build() if key is None else _cached_table(("lut",) + key, (dictionary,), build)
    return _unary(lut, f)


def _compile_like(e: Func, dicts: DictContext) -> _CompiledExpr:
    col, pat = e.args
    if not isinstance(pat, Literal) or pat.param_slot is not None:
        raise NotImplementedError("LIKE: only a literal pattern is ported")
    rx = _like_to_regex(str(pat.value))
    return _compile_strlut(col, dicts, lambda s: bool(rx.match(s)), np.bool_,
                           key=("like", str(pat.value)))


#: numeric IN lists up to this many values take one equality pass per
#: value; longer ones a binary search in the sorted list. Over 60M int64
#: rows on "NVIDIA H100 80GB HBM3, 700.00 W" a pass takes 0.24-0.27 ms a value
#: and the search 1.40-1.70 ms for 1 to 1,000 values
#: (scripts/torch_dml_paths.py)
_IN_PASSES = 4


def _compile_in(e: Func, dicts: DictContext) -> _CompiledExpr:
    """x IN (literals). MySQL: x IN (a, b, NULL) is TRUE on a match and
    NULL otherwise. A string column is one LUT gather; a numeric column
    is one equality pass per listed value, OR-ed, or for a longer list
    a binary search of each row in the sorted values (no [N, k]
    matrix either way)."""
    col, *lits = e.args
    if any(not isinstance(x, Literal) or x.param_slot is not None for x in lits):
        raise NotImplementedError("IN list must hold plain literals")
    has_null = any(x.value is None for x in lits)
    lits = [x for x in lits if x.value is not None]
    if _is_string_col(col):
        vals = set(str(x.value) for x in lits)
        match_fn = _compile_strlut(col, dicts, lambda s: s in vals, np.bool_,
                                   key=("in", tuple(sorted(vals))))
    else:
        f = _compile(col, dicts)
        phys = np.array([literal_phys(x.value, col.type) for x in lits])
        as_float = phys.dtype.kind == "f" or (col.type is not None and col.type.kind == Kind.FLOAT)
        consts = sorted(phys.tolist())

        def match_fn(b):
            c = f(b)
            x = c.data.to(torch.float64 if as_float else torch.int64)
            if len(consts) > _IN_PASSES:
                s = torch.tensor(consts, dtype=x.dtype, device=x.device)
                pos = torch.searchsorted(s, x).clamp_(max=len(consts) - 1)
                return DevCol(s[pos] == x, c.valid)
            d = torch.zeros(b.capacity, dtype=torch.bool, device=b.device)
            for v in consts:
                d |= x == v
            return DevCol(d, c.valid)

    def _in(b):
        m = match_fn(b)
        valid = m.valid & m.data if has_null else m.valid
        return DevCol(m.data, valid)

    return _in


# math builtins (reference: pkg/expression/builtin_math_vec.go)
_MATH_UNARY_FLOAT = {
    "sqrt", "exp", "ln", "log2", "log10", "radians", "degrees",
    "sin", "cos", "tan", "asin", "acos", "atan", "cot",
}


def _compile_math(e: Func, dicts: DictContext) -> _CompiledExpr:
    op = e.op
    a0 = e.args[0]
    f = _compile(a0, dicts)
    src = a0.type

    if op in _MATH_UNARY_FLOAT:
        def _mf(b):
            c = f(b)
            x = _to_float(c.data, src)
            valid = c.valid
            if op == "sqrt":
                valid = valid & (x >= 0)  # MySQL: SQRT(neg) -> NULL
                d = torch.sqrt(torch.clamp(x, min=0.0))
            elif op in ("ln", "log2", "log10"):
                valid = valid & (x > 0)
                xs = torch.where(x > 0, x, 1.0)
                d = {"ln": torch.log, "log2": torch.log2, "log10": torch.log10}[op](xs)
            elif op == "radians":
                d = x * (np.pi / 180.0)
            elif op == "degrees":
                d = x * (180.0 / np.pi)
            elif op == "cot":
                d = 1.0 / torch.tan(x)
            else:
                d = getattr(torch, op)(x)
            return DevCol(d, valid)

        return _mf

    if op == "abs":
        return _unary(torch.abs, f)
    if op == "sign":
        return _unary(lambda d: torch.sign(d).to(torch.int64), f)
    if op in ("floor", "ceil"):
        def _fc(d):
            if src.kind == Kind.FLOAT:
                return (torch.floor(d) if op == "floor" else torch.ceil(d)).to(torch.int64)
            if src.kind == Kind.DECIMAL:
                q = 10**src.scale
                return _floordiv(d, q) if op == "floor" else -_floordiv(-d, q)
            return d.to(torch.int64)

        return _unary(_fc, f)

    # ROUND / TRUNCATE with an optional digits literal (default 0); exact
    # types round half away from zero, as MySQL's DECIMAL rules
    digits = 0
    if len(e.args) > 1:
        if not isinstance(e.args[1], Literal):
            raise NotImplementedError(f"{op.upper()} digits must be a literal")
        if e.args[1].value is None:
            # MySQL: ROUND(x, NULL) is NULL for every row
            return _null_col(torch.float64 if e.type.kind == Kind.FLOAT else torch.int64)
        digits = int(e.args[1].value)
    trunc = op == "truncate"

    def _round(d):
        if src.kind == Kind.FLOAT:
            factor = 10.0**digits
            x = d * factor
            if trunc:
                x = torch.trunc(x)
            else:
                x = torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))
            return _div_scalar(x, factor)
        s = src.scale if src.kind == Kind.DECIMAL else 0
        if digits >= s:
            return _rescale(d.to(torch.int64), max(digits, 0) - s if src.kind == Kind.DECIMAL else 0)
        q = 10 ** (s - digits)
        av = torch.abs(d.to(torch.int64))
        mag = _floordiv(av, q) if trunc else _floordiv(av + q // 2, q)
        out = torch.sign(d).to(torch.int64) * mag
        # out is at scale `digits`: DECIMAL(digits) for digits > 0, else
        # INT64 (scale 0), so negative digits scale back up
        if digits < 0:
            out = out * (10**-digits)
        return out

    return _unary(_round, f)


def _compile_math2(e: Func, dicts: DictContext) -> _CompiledExpr:
    op = e.op
    if op == "log" and len(e.args) == 1:
        return _compile_math(Func(op="ln", args=e.args, type=e.type), dicts)
    fa, fb = (_compile(a, dicts) for a in e.args)
    ta, tb = e.args[0].type, e.args[1].type

    def _m2(b):
        a, c = fa(b), fb(b)
        x, y = _to_float(a.data, ta), _to_float(c.data, tb)
        valid = a.valid & c.valid
        if op == "pow":
            d = torch.pow(x, y)
        elif op == "atan2":
            d = torch.atan2(x, y)
        else:  # log(base, x) = ln(x) / ln(base)
            valid = valid & (x > 0) & (x != 1.0) & (y > 0)
            d = torch.log(torch.where(y > 0, y, 1.0)) / torch.log(
                torch.where((x > 0) & (x != 1.0), x, 2.0)
            )
        return DevCol(d, valid)

    return _m2


def _compile_extremum(e: Func, dicts: DictContext) -> _CompiledExpr:
    """GREATEST / LEAST: every argument aligned at the inferred common
    type; NULL if any argument is NULL."""
    fns = [_compile(a, dicts) for a in e.args]
    types = [a.type for a in e.args]
    target = e.type
    pick = torch.maximum if e.op == "greatest" else torch.minimum

    def _conv(data, t):
        if target.kind == Kind.FLOAT:
            return _to_float(data, t)
        if target.kind == Kind.DECIMAL:
            s = t.scale if t.kind == Kind.DECIMAL else 0
            return _rescale(data.to(torch.int64), target.scale - s)
        return data.to(torch.int64)

    def _ext(b):
        cols = [f(b) for f in fns]
        out = _conv(cols[0].data, types[0])
        valid = cols[0].valid
        for c, t in zip(cols[1:], types[1:]):
            out = pick(out, _conv(c.data, t))
            valid = valid & c.valid
        return DevCol(out, valid)

    return _ext


_EXTRACT_PARTS = ("year", "month", "day", "quarter", "dayofweek", "weekday", "dayofyear")


def _floordiv(x, k):
    return torch.div(x, k, rounding_mode="floor")


def _to_days(data, t: Optional[SQLType]):
    """Temporal value -> days since the epoch (DATETIME truncates micros)."""
    if t is not None and t.kind == Kind.DATETIME:
        return _floordiv(data.to(torch.int64), US_PER_DAY)
    return data.to(torch.int64)


def _to_micros(data, t: Optional[SQLType]):
    """Temporal value -> micros since the epoch (DATE promotes to midnight)."""
    if t is not None and t.kind == Kind.DATE:
        return data.to(torch.int64) * US_PER_DAY
    return data.to(torch.int64)


def _civil_from_days(days):
    """Days since the epoch -> (y, m, d): the branchless integer civil
    calendar (Howard Hinnant's days_from_civil inverse), which needs
    flooring division for days before 1970."""
    z = days + 719468
    era = _floordiv(z, 146097)
    doe = z - era * 146097
    yoe = _floordiv(doe - _floordiv(doe, 1460) + _floordiv(doe, 36524) - _floordiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y, m, d):
    """(y, m, d) -> days since the epoch (inverse of _civil_from_days)."""
    y = y - (m <= 2).to(y.dtype)
    era = _floordiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _floordiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _floordiv(yoe, 4) - _floordiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _compile_extract(e: Func, dicts: DictContext) -> _CompiledExpr:
    """YEAR/MONTH/DAY/QUARTER/DAYOFWEEK/WEEKDAY/DAYOFYEAR from days since
    the epoch through the civil calendar."""
    part = e.op
    (col,) = e.args
    f = _compile(col, dicts)

    def _ext(b):
        c = f(b)
        days = _to_days(c.data, col.type)
        y, m, d = _civil_from_days(days)
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


def _compile_time_part(e: Func, dicts: DictContext) -> _CompiledExpr:
    """HOUR/MINUTE/SECOND/MICROSECOND of a DATETIME (time of day) or TIME
    (duration components, sign dropped as MySQL's HOUR() drops it); a DATE
    has none and gives 0."""
    part = e.op
    (col,) = e.args
    t = col.type

    def _tp(d):
        us = d.to(torch.int64)
        if t is not None and t.kind == Kind.DATETIME:
            us = torch.remainder(us, US_PER_DAY)  # time of day, also before 1970
        elif t is not None and t.kind == Kind.TIME:
            us = torch.abs(us)
        else:
            us = torch.zeros_like(us)
        if part == "hour":
            return _floordiv(us, 3600 * US_PER_SECOND)
        if part == "minute":
            return torch.remainder(_floordiv(us, 60 * US_PER_SECOND), 60)
        if part == "second":
            return torch.remainder(_floordiv(us, US_PER_SECOND), 60)
        return torch.remainder(us, US_PER_SECOND)

    return _unary(_tp, _compile(col, dicts))


_MONTH_DAYS = _DeviceLUT(np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31], dtype=np.int64))


def _compile_add_months(e: Func, dicts: DictContext) -> _CompiledExpr:
    """Month arithmetic as MySQL's: shift by N months and clamp the day of
    month to the target month's length; a DATETIME keeps its time of day."""
    col, nexpr = e.args
    f = _compile(col, dicts)
    fn = _compile(nexpr, dicts)
    is_dt = col.type is not None and col.type.kind == Kind.DATETIME

    def _am(b):
        c, n = f(b), fn(b)
        raw = c.data.to(torch.int64)
        days = _floordiv(raw, US_PER_DAY) if is_dt else raw
        y, m, d = _civil_from_days(days)
        total = y * 12 + (m - 1) + n.data.to(torch.int64)
        y2 = _floordiv(total, 12)
        m2 = torch.remainder(total, 12) + 1
        leap = (torch.remainder(y2, 4) == 0) & (
            (torch.remainder(y2, 100) != 0) | (torch.remainder(y2, 400) == 0))
        mlen = _MONTH_DAYS(m2 - 1) + ((m2 == 2) & leap).to(torch.int64)
        out = _days_from_civil(y2, m2, torch.minimum(d, mlen))
        if is_dt:
            out = out * US_PER_DAY + torch.remainder(raw, US_PER_DAY)
        return DevCol(out.to(c.data.dtype), c.valid & n.valid)

    return _am


# MySQL day 0 of TO_DAYS/FROM_DAYS is year 0; the epoch 1970-01-01 is
# day 719528 in that reckoning
_MYSQL_DAY0 = 719528

_DATE_MISC = {
    "to_days", "from_days", "last_day", "week", "weekofyear", "makedate",
    "unix_timestamp", "from_unixtime", "time_to_sec", "sec_to_time", "timestampdiff",
}

_TSD_UNITS = {
    "microsecond": 1, "second": US_PER_SECOND, "minute": 60 * US_PER_SECOND,
    "hour": 3600 * US_PER_SECOND, "day": US_PER_DAY, "week": 7 * US_PER_DAY,
}


def _jan1(y):
    one = torch.ones_like(y)
    return _days_from_civil(y, one, one)


def _compile_date_misc(e: Func, dicts: DictContext) -> _CompiledExpr:
    """Calendar builtins that reduce to civil-date arithmetic on the
    device (the JAX package's ``_compile_date_misc``)."""
    op = e.op
    fns = [_compile(a, dicts) for a in e.args]
    t0 = e.args[0].type if e.args else None
    if op == "to_days":
        return _unary(lambda d: _to_days(d, t0) + _MYSQL_DAY0, fns[0])
    if op == "from_days":
        return _unary(lambda d: (d.to(torch.int64) - _MYSQL_DAY0).to(torch.int32), fns[0])
    if op == "last_day":
        def _ld(d):
            y, m, _d = _civil_from_days(_to_days(d, t0))
            y2 = torch.where(m == 12, y + 1, y)
            m2 = torch.where(m == 12, 1, m + 1)
            return (_days_from_civil(y2, m2, torch.ones_like(m2)) - 1).to(torch.int32)

        return _unary(_ld, fns[0])
    if op in ("week", "weekofyear"):
        # WEEKOFYEAR is WEEK(d, 3), the ISO 8601 week; WEEK(d) is mode 0
        # (weeks start Sunday, days before the first Sunday are week 0);
        # other modes are refused, as in the JAX package
        iso = op == "weekofyear"
        if op == "week" and len(e.args) > 1:
            if not isinstance(e.args[1], Literal):
                raise NotImplementedError("WEEK mode must be a literal")
            mode = e.args[1].value
            if mode is None:
                return _null_col(torch.int64)  # MySQL: NULL mode -> NULL
            if mode == 3:
                iso = True
            elif mode != 0:
                raise NotImplementedError(f"WEEK mode {mode}")

        def _week(d):
            days = _to_days(d, t0)
            if iso:
                # the week holding the year's first Thursday is week 1
                thursday = days - torch.remainder(days + 3, 7) + 3
                return _floordiv(thursday - _jan1(_civil_from_days(thursday)[0]), 7) + 1
            jan1 = _jan1(_civil_from_days(days)[0])
            first_sunday = jan1 + torch.remainder(7 - torch.remainder(jan1 + 4, 7), 7)
            return torch.where(days < first_sunday, 0, _floordiv(days - first_sunday, 7) + 1)

        return _unary(_week, fns[0])
    if op == "makedate":
        def _md(b):
            cy, cn = fns[0](b), fns[1](b)
            y, n = cy.data.to(torch.int64), cn.data.to(torch.int64)
            return DevCol((_jan1(y) + n - 1).to(torch.int32), cy.valid & cn.valid & (n >= 1))

        return _md
    if op == "unix_timestamp":
        # UTC, as in the JAX package
        return _unary(lambda d: _floordiv(_to_micros(d, t0), US_PER_SECOND), fns[0])
    if op in ("from_unixtime", "sec_to_time"):
        return _unary(lambda d: d.to(torch.int64) * US_PER_SECOND, fns[0])
    if op == "time_to_sec":
        return _unary(lambda d: _floordiv(d.to(torch.int64), US_PER_SECOND), fns[0])
    # timestampdiff
    unit = str(e.args[0].value).lower()
    if unit not in _TSD_UNITS and unit not in ("month", "quarter", "year"):
        raise NotImplementedError(f"TIMESTAMPDIFF unit {unit}")
    fa, fb = fns[1], fns[2]
    ta, tb = e.args[1].type, e.args[2].type

    def _tsd(b):
        a, c = fa(b), fb(b)
        ua, ub = _to_micros(a.data, ta), _to_micros(c.data, tb)
        if unit in _TSD_UNITS:
            div = _TSD_UNITS[unit]
            # MySQL truncates toward zero
            out = torch.div(ub - ua, div, rounding_mode="trunc")
        else:
            # civil month distance, less one where the last month is partial
            ya, ma, dda = _civil_from_days(_floordiv(ua, US_PER_DAY))
            yb, mb, ddb = _civil_from_days(_floordiv(ub, US_PER_DAY))
            months = (yb - ya) * 12 + (mb - ma)
            toa, tob = torch.remainder(ua, US_PER_DAY), torch.remainder(ub, US_PER_DAY)
            fwd = (ddb < dda) | ((ddb == dda) & (tob < toa))
            bwd = (ddb > dda) | ((ddb == dda) & (tob > toa))
            months = torch.where((months > 0) & fwd, months - 1,
                                 torch.where((months < 0) & bwd, months + 1, months))
            out = months if unit == "month" else torch.div(
                months, 3 if unit == "quarter" else 12, rounding_mode="trunc")
        return DevCol(out.to(torch.int64), a.valid & c.valid)

    return _tsd


def _compile_str_to_date(e: Func, dicts: DictContext) -> _CompiledExpr:
    """STR_TO_DATE over a string: strptime once per dictionary entry on the
    host, gathered by code on the device; an entry that does not parse is
    NULL."""
    import datetime as _dt

    from tidb_tpu_torch.dtypes import date_to_days, datetime_to_micros

    col, fmt_e = e.args
    is_dt = e.type is not None and e.type.kind == Kind.DATETIME
    if not isinstance(fmt_e, Literal):
        raise NotImplementedError("STR_TO_DATE: only a literal format is ported")
    if fmt_e.value is None:
        return _null_col(torch.int64 if is_dt else torch.int32)
    pyfmt = _mysql_fmt_to_py(str(fmt_e.value))
    bad = np.iinfo(np.int64).min

    def _parse(s):
        try:
            d = _dt.datetime.strptime(s, pyfmt)
        except ValueError:
            return bad
        if is_dt:
            return int(datetime_to_micros(d.strftime("%Y-%m-%d %H:%M:%S.%f")))
        return int(date_to_days(d.strftime("%Y-%m-%d")))

    f, dictionary = string_expr(col, dicts)

    def build():
        vals = (np.array([_parse(str(s)) for s in dictionary.tolist()], dtype=np.int64)
                if len(dictionary) else np.zeros(1, dtype=np.int64))
        return _DeviceLUT(vals.astype(np.int64 if is_dt else np.int32)), _DeviceLUT(vals != bad)

    lut, ok = _cached_table(("str_to_date", pyfmt, is_dt), (dictionary,), build)

    def _std(b):
        c = f(b)
        return DevCol(lut(c.data), c.valid & ok(c.data))

    return _std
