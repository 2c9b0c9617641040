"""The date and time builtins through both ``compile_expr``s on one seeded
batch (tests/_torch_exprs.py), edge dates included (leap days, both sides
of the epoch, century years, year ends, the DATE_FORMAT table's ends):
HOUR ... MICROSECOND, DATE_ADD / DATE_SUB by months (``add_months``) and by
time units (``add_us``), DATE_FORMAT, DAYNAME and MONTHNAME, TO_DAYS ...
TIMESTAMPDIFF, STR_TO_DATE, PERIOD_ADD and PERIOD_DIFF. Every result
matches exactly; a string result carries the JAX package's dictionary.
One case per expression; cases from tests/test_datetime.py and
test_builtins_r3/r4/r5.py."""

import pytest

from _torch_exprs import build_engines, check_expr, refused_alike

PARTS = [
    "hour(ts)", "minute(ts)", "second(ts)", "microsecond(ts)", "hour(tm)", "minute(tm)",
    "second(tm)", "microsecond(tm)", "hour(dt)", "date(ts)",
]
ADD = [
    "date_add(dt, interval 1 month)", "date_add(ts, interval 13 month)",
    "date_add(dt, interval 1 year)", "date_sub(dt, interval 2 month)",
    "date_sub(ts, interval 1 year)", "date_add(ts, interval 90 minute)",
    "date_add(dt, interval 3 hour)", "date_sub(ts, interval 5 second)",
    "date_add(ts, interval 7 microsecond)", "dt + interval 1 month",
]
FORMAT = [
    "date_format(dt, '%Y-%m')", "date_format(dt, '%W %M %e %j')",
    "date_format(dt, '%a %b %c %y %%')", "date_format(ts, '%Y-%m-%d')",
    "date_format(dt, '%H:%i')", "date_format(dt, null)", "dayname(dt)", "monthname(dt)",
    "dayname(ts)", "monthname(ts)",
]
MISC = [
    "to_days(dt)", "to_days(ts)", "from_days(to_days(dt))", "from_days(i + 730000)",
    "last_day(dt)", "last_day(ts)", "week(dt)", "week(dt, 0)", "week(dt, 3)",
    "weekofyear(dt)", "week(ts)", "week(dt, null)", "makedate(i + 2000, i + 30)",
    "makedate(2024, 60)", "unix_timestamp(ts)", "unix_timestamp(dt)",
    "from_unixtime(i * 100000)", "time_to_sec(tm)", "sec_to_time(i * 1000)",
    "timestampdiff(day, dt, ts)", "timestampdiff(second, ts, dt)",
    "timestampdiff(month, dt, ts)", "timestampdiff(quarter, ts, dt)",
    "timestampdiff(year, dt, ts)", "timestampdiff(week, dt, ts)",
    "timestampdiff(hour, ts, dt)", "timestampdiff(minute, dt, ts)",
    "timestampdiff(microsecond, ts, dt)",
]
PARSE = [
    "str_to_date(s, '%Y-%m-%d')", "str_to_date(s, '%d/%m/%Y')",
    "str_to_date(s, '%Y-%m-%d %H:%i:%s')", "str_to_date(s, null)",
    "period_add(199912, i)", "period_diff(200003, 199911 + i)", "period_add(i + 200001, 3)",
]

CASES = PARTS + ADD + FORMAT + MISC + PARSE

#: refused by both packages alike (JAX kernels.py :430, :2732)
REFUSED = ["date_format(ts, '%H')", "week(dt, 1)", "date_format(ts, '%Y %T')"]


@pytest.fixture(scope="module")
def engines():
    return build_engines()


@pytest.mark.parametrize("expr", CASES)
def test_datetime_builtin_matches_jax_package(engines, expr):
    check_expr(engines, expr)


@pytest.mark.parametrize("expr", REFUSED)
def test_refused_by_both(engines, expr):
    refused_alike(engines, expr)
