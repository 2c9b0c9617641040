"""ctypes bindings for the native splitter (csrc/loader.cpp).

Counterpart of tidb_tpu/storage/native.py. The shared library is built
with g++ at first use into ``_build/`` (``_build.load_host``: hash-named,
compiled under a name of its own and renamed into place, so two
processes may build at once). The columns come back as numpy views over
the C++ vectors and are copied once into HostColumns.

Which parser runs is the JAX package's rule (``applies``): the splitter
when every column's kind has a type code below and the separator is one
character. Unlike the JAX package, a failed build or load raises with
the compiler's output instead of falling back to the Python parser. A
row with too few fields raises the Python parser's text, which is what
the JAX package reports (its ``load_file`` parses again in Python after
the splitter's error); a missing file raises as ``open`` does.
"""

from __future__ import annotations

import ctypes
import re
from typing import Optional

import numpy as np

from tidb_tpu_torch import _build
from tidb_tpu_torch.chunk import HostBlock, HostColumn, encode_strings
from tidb_tpu_torch.dtypes import Kind
from tidb_tpu_torch.utils import racecheck

_TYPECODE = {
    Kind.INT: 0,
    Kind.FLOAT: 1,
    Kind.STRING: 2,
    Kind.DATE: 3,
    Kind.DECIMAL: 4,
    Kind.BOOL: 5,
}

_lock = racecheck.make_lock("storage.native")
_lib: Optional[ctypes.CDLL] = None
_FIELDS_ERROR = re.compile(r"row \d+ has (\d+) fields, want (\d+)")


def _load() -> ctypes.CDLL:
    """The splitter's library, built if needed (raises if it cannot be)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = _build.load_host("loader")
        lib.tt_parse_file.restype = ctypes.c_void_p
        lib.tt_parse_file.argtypes = [
            ctypes.c_char_p, ctypes.c_char, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.tt_error.restype = ctypes.c_char_p
        lib.tt_error.argtypes = [ctypes.c_void_p]
        lib.tt_nrows.restype = ctypes.c_int64
        lib.tt_nrows.argtypes = [ctypes.c_void_p]
        for name in ("tt_col_i64", "tt_col_stroffsets"):
            getattr(lib, name).restype = ctypes.POINTER(ctypes.c_int64)
            getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tt_col_f64.restype = ctypes.POINTER(ctypes.c_double)
        lib.tt_col_f64.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tt_col_valid.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.tt_col_valid.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tt_col_strbytes.restype = ctypes.POINTER(ctypes.c_char)
        lib.tt_col_strbytes.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int64)]
        lib.tt_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def applies(table, sep: str) -> bool:
    """Whether the splitter parses files for `table` (the JAX rule)."""
    return len(sep) == 1 and all(t.kind in _TYPECODE for _n, t in table.schema.columns)


def parse_file(table, path: str, sep: str) -> Optional[HostBlock]:
    """Parse a delimited file with the splitter into one unappended block
    (None when it holds no row)."""
    lib = _load()
    open(path, "rb").close()  # a missing file raises as the Python parser's open
    names = table.schema.names
    types = [t for _, t in table.schema.columns]
    n = len(names)
    codes = (ctypes.c_int * n)(*[_TYPECODE[t.kind] for t in types])
    scales = (ctypes.c_int * n)(*[t.scale for t in types])
    h = lib.tt_parse_file(path.encode(), sep.encode(), n, codes, scales)
    try:
        err = lib.tt_error(h)
        if err:
            m = _FIELDS_ERROR.fullmatch(err.decode())
            if m is None:
                raise ValueError(f"native load: {err.decode()}")
            raise ValueError(f"row has {m.group(1)} fields, table {table.name} has {m.group(2)}")
        nrows = lib.tt_nrows(h)
        if nrows == 0:
            return None
        cols = {}
        for i, (name, typ) in enumerate(zip(names, types)):
            valid = np.ctypeslib.as_array(lib.tt_col_valid(h, i), (nrows,)).astype(bool)
            if typ.kind == Kind.STRING:
                blen = ctypes.c_int64()
                bptr = lib.tt_col_strbytes(h, i, ctypes.byref(blen))
                raw = ctypes.string_at(bptr, blen.value)
                offs = np.ctypeslib.as_array(lib.tt_col_stroffsets(h, i), (nrows + 1,)).tolist()
                vl = valid.tolist()
                cols[name] = encode_strings([
                    raw[offs[r]: offs[r + 1]].decode("utf-8", "replace") if vl[r] else None
                    for r in range(nrows)])
            elif typ.kind == Kind.FLOAT:
                data = np.ctypeslib.as_array(lib.tt_col_f64(h, i), (nrows,)).copy()
                cols[name] = HostColumn(typ, data, valid)
            else:
                data = np.ctypeslib.as_array(lib.tt_col_i64(h, i), (nrows,)).astype(typ.np_dtype)
                cols[name] = HostColumn(typ, data, valid)
        return HostBlock.from_columns(cols)
    finally:
        lib.tt_free(h)
