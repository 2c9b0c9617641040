"""The numeric builtins through both ``compile_expr``s on one seeded batch
(tests/_torch_exprs.py): COALESCE and IFNULL over numbers, ABS ... ROUND
and TRUNCATE (half away from zero on exact types, a digits literal, NULL
digits), the float functions and PI, POW, ATAN2 and two-argument LOG,
GREATEST and LEAST, the bit operators, shifts, ~ and BIT_COUNT, and
INTERVAL. One case per expression; DOUBLE results within 1e-12 relative
(1e-15 absolute near zero), every other type exactly, validity included.
Cases from tests/test_builtins.py and test_builtins_r3/r4/r5.py."""

import pytest

from _torch_exprs import build_engines, check_expr, refused_alike

COALESCE = [
    "coalesce(i, 7)", "coalesce(d, i)", "coalesce(f, d)", "ifnull(i, d)",
    "coalesce(i, j, 3)", "ifnull(f, 0)", "coalesce(null, d)",
]
MATH = [
    "abs(i)", "abs(d)", "abs(f)", "sign(i)", "sign(d)", "sign(f)",
    "floor(d)", "ceil(d)", "floor(f)", "ceil(f)", "floor(i)", "ceiling(d)",
    "floor(d / 3)", "ceil(i / 4)",
]
ROUND = [
    "round(d)", "round(d, 1)", "round(d, 2)", "round(d, 3)", "round(d, -1)",
    "round(d, -2)", "round(i, -1)", "round(i, 1)", "round(f)", "round(f, 2)", "round(f, -1)",
    "round(d, null)", "round(f, null)", "truncate(d, 1)", "truncate(d, 0)", "truncate(d, -1)",
    "truncate(f, 2)", "truncate(f, 0)", "truncate(i, -1)", "round(d / 7, 4)",
]
FLOAT = [
    "sqrt(f)", "sqrt(d)", "sqrt(i)", "exp(d)", "exp(i)", "ln(f)", "ln(d)", "log2(f)",
    "log10(d)", "log(f)", "radians(f)", "degrees(d)", "sin(f)", "cos(d)", "tan(i)",
    "asin(f / 100)", "acos(d / 100)", "atan(f)", "cot(f)", "pi()", "pi() * i",
    "pow(d, 2)", "power(i, 3)", "pow(f, i)", "atan2(f, d)", "log(2, f)", "log(d, i)",
]
EXTREMA = [
    "greatest(i, d)", "least(i, d, f)", "greatest(i, 3)", "least(i, null)",
    "greatest(dt, date '1999-01-01')", "least(d, 1.5)", "greatest(j, i, k)",
]
BITS = [
    "i & j", "i | 5", "j ^ i", "i << 3", "j >> 2", "i << 70", "j >> i", "1 << i",
    "d & 7", "f | 1", "~i", "~d", "bit_count(j)", "bit_count(i)", "bit_count(f)",
    "bit_count(d)", "j & -1",
]
INTERVAL = ["interval(i, 0, 5, 10)", "interval(d, 1, 2)", "interval(f, -10, 0, 10, 20)"]

CASES = COALESCE + MATH + ROUND + FLOAT + EXTREMA + BITS + INTERVAL


@pytest.fixture(scope="module")
def engines():
    return build_engines()


@pytest.mark.parametrize("expr", CASES)
def test_numeric_builtin_matches_jax_package(engines, expr):
    check_expr(engines, expr)


@pytest.mark.parametrize("expr", ["round(d, i)", "truncate(f, i)"])
def test_non_literal_digits_are_refused_by_both(engines, expr):
    refused_alike(engines, expr)
