"""Comparison, GROUP BY, DISTINCT, MIN/MAX, COUNT(DISTINCT) and ORDER BY
under CI collations through the JAX package's Session and the port's, each
over its own catalog (tests/_torch_parity.py ``WritePair``): the shapes of
tests/test_collation.py. Rows equal exactly; with ORDER BY in order, ties
under the collation in stored order; a CI group shows the JAX package's
representative value."""

import pytest

import tidb_tpu  # noqa: F401
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog

from _torch_parity import WritePair

SETUP = [
    "create table t (s varchar(16) collate utf8mb4_general_ci, k int)",
    "insert into t values ('Apple', 1), ('apple', 2), ('BANANA', 3), ('banana', 4), "
    "('_under', 5), ('Zebra', 6)",
    "create table g (s varchar(16) collate utf8mb4_general_ci, k int)",
    "insert into g values ('Ann', 1), ('ANN', 2), ('ann', 4), ('Bob', 8), ('BOB', 16), "
    "('carl', 32), ('_z', 64), (null, 128)",
    "create table a (x varchar(8) collate utf8mb4_general_ci)",
    "create table b (y varchar(8))",
    "insert into a values ('HELLO'), ('world')",
    "insert into b values ('hello'), ('WORLD'), ('zzz')",
    "create table eb (s varchar(8) collate utf8mb4_general_ci)",
    "insert into eb values ('A'), ('a')",
    "create table u (s varchar(8) collate utf8mb4_unicode_ci, k int)",
    "insert into u values ('café', 1), ('CAFE', 2), ('other', 4), ('tea', 8)",
    "create table bz (s varchar(8), k int)",
    "insert into bz values ('A', 1), ('a', 2)",
    "create table gc (s varchar(8) collate utf8mb4_general_ci, k int)",
    "insert into gc values ('B', 1), ('a', 2)",
]

QUERIES = {
    "eq_literal": "select k from t where s = 'APPLE' order by k",
    "ne_literal": "select count(*) from t where s <> 'banana'",
    "lt_literal": "select count(*) from t where s < 'b'",
    "ge_literal": "select k from t where s >= 'BANANA' order by k",
    "null_safe": "select count(*) from t where s <=> 'apple'",
    "in_binary": "select count(*) from t where s in ('apple')",
    "order_by_rank": "select s from t order by s, k",
    "order_by_desc": "select s, k from t order by s desc",
    "order_limit": "select s from t order by s limit 3",
    "column_vs_column": "select count(*) from a, b where x = y",
    "collate_bin": "select count(*) from eb where s collate utf8mb4_bin = 'a'",
    "collate_ci_literal": "select count(*) from eb where s = 'a'",
    "unicode_accents": "select count(*) from u where s = 'cafe'",
    "binary_column": "select count(*) from bz where s = 'a'",
    "group_by": "select s, sum(k), count(*) from g group by s order by s",
    "distinct": "select distinct s from g order by s",
    "count_distinct": "select count(distinct s) from g",
    "min_max": "select min(s), max(s) from g",
    "group_binary": "select s, sum(k) from bz group by s order by s",
    "group_having": "select s, count(*) from g group by s having count(*) > 1 order by s",
    "group_output_bin_compare": "select * from (select s, sum(k) sk from gc group by s) t "
                                "where s collate utf8mb4_bin = 'B'",
    "group_output_bin_order": "select s from (select s from gc group by s) t "
                              "order by s collate utf8mb4_bin",
    "min_max_real_member": "select * from (select max(s) m from g) t where m = '_z'",
    "group_min_max": "select s, min(s), max(s), sum(k) from g group by s order by s",
    "unicode_group": "select s, sum(k) from u group by s order by s",
    "expr_collate_group": "select (case when k % 2 = 0 then lower(s) else s end) "
                          "collate utf8mb4_general_ci as c, count(*) from g group by c order by c",
    "upper_filter": "select count(*) from t where upper(s) = 'APPLE'",
}


@pytest.fixture(scope="module")
def pair():
    js, ts = JaxSession(JaxCatalog()), Session(Catalog(), device="cpu")
    p = WritePair(js, ts)
    p.runs("create database coll", "use coll", *SETUP)
    return p


@pytest.mark.parametrize("name", list(QUERIES))
def test_collation_matches_jax_session(pair, name):
    got = pair.run(QUERIES[name])
    assert got.rows, name


def test_ci_group_min_max_streamed(pair):
    """The partial/final split keeps MIN/MAX's rank-composed values across
    chunks and decodes them at the final stage only (the JAX package's
    test_ci_group_minmax_streamed, streamed every 2 rows)."""
    q = QUERIES["group_min_max"]
    full = pair.run(q).rows
    pair.runs("set tidb_tpu_stream_rows = 2")
    try:
        streamed = pair.run(q).rows
    finally:
        pair.runs("set tidb_tpu_stream_rows = 0")
    assert streamed == full
    assert pair.ts.executor.stream_log, "the port did not stream"
