"""The string builtins through both ``compile_expr``s on one seeded batch
(tests/_torch_exprs.py): the transforms over the sorted dictionary (UPPER
... WEIGHT_STRING), CONCAT and CONCAT_WS, HEX/BIN/OCT (of a string, a
literal and a narrowly bounded integer column), and the functions that
yield numbers from strings (LENGTH ... FIELD). A string result must carry
the JAX package's dictionary entry for entry and the same codes; numbers
match exactly. One case per expression; cases from tests/test_builtins.py
and test_builtins_r3/r4/r5/r5b.py."""

import pytest

from _torch_exprs import build_engines, check_expr, refused_alike

TRANSFORMS = [
    "upper(s)", "lower(s)", "upper(ci)", "lower(e)", "trim(s)", "ltrim(s)", "rtrim(s)",
    "replace(s, 'a', 'X')", "replace(s, '', 'X')", "replace(s, '-', ' ')", "left(s, 3)",
    "left(s, 0)", "right(s, 2)", "right(s, 0)", "reverse(s)", "lpad(s, 6, '*')",
    "lpad(s, 2, 'ab')", "rpad(s, 5, 'xy')", "rpad(s, 3, '')", "repeat(s, 2)", "repeat(s, 0)",
    "quote(s)", "insert(s, 2, 3, 'Q')", "insert(s, 0, 1, 'Q')", "insert(s, 2, -1, 'Q')",
    "substring_index(s, ',', 1)", "substring_index(s, ',', -1)", "substring_index(s, '-', 2)",
    "substring_index(s, '', 1)", "substring_index(s, ',', 0)", "soundex(s)", "to_base64(s)",
    "from_base64(s)", "unhex(s)", "hex(s)", "md5(s)", "sha1(s)", "sha2(s, 256)", "sha2(s, 512)",
    "sha2(s, 7)", "weight_string(ci)", "weight_string(s)", "upper(left(s, 3))",
    "trim(lower(s))", "substring(upper(s), 2, 3)",
]
CONCAT = [
    "concat(s, '-', s2)", "concat('+', substring_index(s, '-', 1))", "concat(s, null)",
    "concat(s, 12)", "concat(s, 1.5)", "concat_ws('/', s, s2)", "concat_ws('/', s, null, s2)",
    "concat_ws(null, s)", "concat_ws(',', e, s)", "concat(upper(s), lower(s2))",
]
RADIX = ["hex(k)", "bin(k)", "oct(k)", "hex(-5)", "hex(255)", "bin(null)", "oct(8)"]
NUMBERS = [
    "length(s)", "char_length(s)", "character_length(ci)", "bit_length(s)", "ascii(s)",
    "ord(s)", "crc32(s)", "find_in_set('a', s)", "find_in_set('c', s)", "find_in_set(null, s)",
    "locate('a', s)", "locate('', s)", "locate(null, s)", "locate('URGENT', s)",
    "field(s, 'abc', 'a', 'zz')", "field(s, 'a', 3)", "field(i, 1, 2, 3)", "field(s, null, 'a')",
    "length(e)", "char_length(upper(s))",
]

CASES = TRANSFORMS + CONCAT + RADIX + NUMBERS

#: refused by both packages alike, by name (JAX kernels.py :304, :1229,
#: :370, :391)
REFUSED = ["left(s, i)", "concat(s, i)", "bin(s)", "hex(i)", "lpad(s, k, '*')"]


@pytest.fixture(scope="module")
def engines():
    return build_engines()


@pytest.mark.parametrize("expr", CASES)
def test_string_builtin_matches_jax_package(engines, expr):
    check_expr(engines, expr)


@pytest.mark.parametrize("expr", REFUSED)
def test_refused_by_both(engines, expr):
    refused_alike(engines, expr)
