"""Plain numpy answers to the port's queries over the raw columns of
``load_tpch`` data: the port's copies of ``numpy_q6``/``numpy_q5`` from
the repo's bench.py, ``numpy_q1`` (exact and a few seconds per 100M rows,
for TPC-H SF100), a ``np.bincount`` oracle for the l_suppkey
aggregation, a vectorized ``numpy_q3``, and ``TPCH_QUERIES``:
the other 18 TPC-H queries of tests/test_tpch_sql.py, each with its SQL
text and a vectorized oracle, checked by ``check_rows``;
``REPORT_QUERIES``, window and set-operation reports over the TPC-H
tables; ``SPILL_REPORTS``, the late-receipt report R1 (a full ORDER BY
without LIMIT); ``STATEMENT_QUERIES``, the statements phase's X1-X9
(REGEXP restatements of TPC-H queries, a revenue report keyed by
REGEXP_SUBSTR and REGEXP_REPLACE, a CRM profile table with ENUM, SET and
JSON columns, a web access log with INET and UUID values, a recursive
date spine) with ``access_log`` generating the log; and a vectorized
``numpy_q95`` over ``tpcds.load_tpcds`` data
(the JAX package's loops over every row). They check
results where no JAX is installed. String predicates are evaluated on
each dictionary with plain ``str`` methods, independent of the engine's
LIKE.

Columns are the physical encodings: dates as epoch days, decimals as
scaled int64, strings as dictionary codes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from tidb_tpu_torch.dtypes import date_to_days

Q1_SQL = (
    "select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty, "
    "sum(l_extendedprice) as sum_base_price, "
    "sum(l_extendedprice * (1 - l_discount)) as sum_disc_price, "
    "sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge, "
    "avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price, "
    "avg(l_discount) as avg_disc, count(*) as count_order "
    "from lineitem where l_shipdate <= date '1998-12-01' - interval '90' day "
    "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"
)
Q6_SQL = (
    "select sum(l_extendedprice * l_discount) as revenue from lineitem "
    "where l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01' "
    "and l_discount between 0.05 and 0.07 and l_quantity < 24"
)
SUPPKEY_SQL = (
    "select l_suppkey, count(*), sum(l_quantity) from lineitem "
    "where l_shipdate <= date '1998-09-02' group by l_suppkey"
)

Q3_SQL = (
    "select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue, "
    "o_orderdate, o_shippriority "
    "from customer, orders, lineitem "
    "where c_mktsegment = 'BUILDING' and c_custkey = o_custkey "
    "and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15' "
    "and l_shipdate > date '1995-03-15' "
    "group by l_orderkey, o_orderdate, o_shippriority "
    "order by revenue desc, o_orderdate limit 10"
)
Q5_SQL = (
    "select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue "
    "from customer, orders, lineitem, supplier, nation, region "
    "where c_custkey = o_custkey and l_orderkey = o_orderkey "
    "and l_suppkey = s_suppkey and c_nationkey = s_nationkey "
    "and s_nationkey = n_nationkey and n_regionkey = r_regionkey "
    "and r_name = 'ASIA' "
    "and o_orderdate >= date '1994-01-01' and o_orderdate < date '1995-01-01' "
    "group by n_name order by revenue desc"
)

Q1_CUTOFF = int(date_to_days("1998-12-01")) - 90
Q6_D0 = int(date_to_days("1994-01-01"))
Q6_D1 = int(date_to_days("1995-01-01"))
SUPPKEY_CUTOFF = int(date_to_days("1998-09-02"))
Q3_DATE = int(date_to_days("1995-03-15"))
Q5_D0 = int(date_to_days("1994-01-01"))
Q5_D1 = int(date_to_days("1995-01-01"))


def exact_bincount(key: np.ndarray, weights: np.ndarray, n: int) -> np.ndarray:
    """Exact int64 sums of integer `weights` per key in [0, n): float64
    ``np.bincount`` over row slices short enough that every partial sum
    stays an integer below 2^53, added up in int64 (``np.add.at`` is
    exact too, but slow at TPC-H SF100's 600M rows)."""
    out = np.zeros(n, dtype=np.int64)
    if len(key) == 0:
        return out
    top = max(abs(int(weights.max())), abs(int(weights.min())), 1)
    step = max(1, (1 << 53) // top)
    for a in range(0, len(key), step):
        out += np.bincount(key[a:a + step], weights=weights[a:a + step], minlength=n).astype(np.int64)
    return out


#: rows numpy_q1 takes at a time: its temporaries stay small (at SF100 a
#: whole-table pass would hold tens of GB) and the allocator reuses them
#: instead of faulting in fresh pages
Q1_ROWS_PER_PASS = 1 << 18


def numpy_q1(blk, cutoff: int = Q1_CUTOFF):
    """Per (returnflag code * 2 + linestatus code) group: exact scaled
    sums, counts and float averages. The discount and tax take a few
    values each, so one count and one price sum per (group, discount,
    tax) give every price-derived sum as exact int64 arithmetic on those
    totals, taken ``Q1_ROWS_PER_PASS`` rows at a time."""
    nk = 6
    nd = int(blk["l_discount"].max(initial=0)) + 1
    nt = int(blk["l_tax"].max(initial=0)) + 1
    assert blk["l_discount"].min(initial=0) >= 0 and blk["l_tax"].min(initial=0) >= 0
    cells = nk * nd * nt
    cnt3 = np.zeros(cells + 1, dtype=np.int64)
    price3 = np.zeros(cells + 1, dtype=np.int64)
    qty = np.zeros(nk + 1, dtype=np.int64)
    for a in range(0, len(blk["l_shipdate"]), Q1_ROWS_PER_PASS):
        z = a + Q1_ROWS_PER_PASS
        g = blk["l_returnflag"][a:z].astype(np.int64) * 2 + blk["l_linestatus"][a:z]
        # rows the WHERE drops count in an extra cell, left out below
        keep = blk["l_shipdate"][a:z] <= cutoff
        cell = np.where(keep, (g * nd + blk["l_discount"][a:z]) * nt + blk["l_tax"][a:z], cells)
        cnt3 += np.bincount(cell, minlength=cells + 1)
        price3 += exact_bincount(cell, blk["l_extendedprice"][a:z], cells + 1)
        qty += exact_bincount(np.where(keep, g, nk), blk["l_quantity"][a:z], nk + 1)
    c = cnt3[:cells].reshape(nk, nd, nt)
    p = price3[:cells].reshape(nk, nd, nt)
    d = np.arange(nd, dtype=np.int64)[None, :, None]
    t = np.arange(nt, dtype=np.int64)[None, None, :]
    out = {
        "sum_qty": qty[:nk],
        "sum_base": p.sum(axis=(1, 2)),
        "sum_disc": (p * (100 - d)).sum(axis=(1, 2)),
        "sum_charge": (p * ((100 - d) * (100 + t))).sum(axis=(1, 2)),
        "sum_disc_rate": (c * d).sum(axis=(1, 2)),
        "cnt": c.sum(axis=(1, 2)),
    }
    den = np.maximum(out["cnt"], 1)
    out["avg_qty"] = out["sum_qty"] / den
    out["avg_base"] = out["sum_base"] / den
    out["avg_disc"] = out["sum_disc_rate"] / den
    return out


def numpy_q6(blk, d0: int = Q6_D0, d1: int = Q6_D1, discount: int = 6, quantity: int = 24) -> int:
    """Q6 revenue as a scale-4 integer, at the substitution parameters
    DATE (days: [d0, d1)), DISCOUNT (hundredths: DISCOUNT +- 0.01) and
    QUANTITY; the defaults are the specification's validation values."""
    ship = blk["l_shipdate"]
    m = (
        (ship >= d0)
        & (ship < d1)
        & (blk["l_discount"] >= discount - 1)
        & (blk["l_discount"] <= discount + 1)
        & (blk["l_quantity"] < quantity * 100)
    )
    return int((blk["l_extendedprice"][m] * blk["l_discount"][m]).sum())


def numpy_suppkey(blk, cutoff: int = SUPPKEY_CUTOFF):
    """(suppkeys present, row counts, scaled l_quantity sums)."""
    m = blk["l_shipdate"] <= cutoff
    sk = blk["l_suppkey"][m]
    cnt = np.bincount(sk)
    qty = np.zeros(len(cnt), dtype=np.int64)
    np.add.at(qty, sk, blk["l_quantity"][m])
    keys = np.nonzero(cnt)[0]
    return keys, cnt[keys], qty[keys]


def _cols(cat, name):
    (b,) = cat.table("tpch", name).blocks()
    return b.columns


def numpy_q3(cat, d: int = Q3_DATE, limit: int = 10):
    """Q3's answer: (rows, tied) where rows are the top `limit` groups as
    (l_orderkey, revenue as a scale-4 integer, o_orderdate epoch days,
    o_shippriority), ordered by revenue desc, o_orderdate; `tied` holds
    every group that ties the last row on (revenue, o_orderdate), whose
    order and membership ORDER BY leaves open. Revenue is summed in
    int64, exactly as the engine's decimals are."""
    cust, orders, li = _cols(cat, "customer"), _cols(cat, "orders"), _cols(cat, "lineitem")
    seg = cust["c_mktsegment"]
    code = int(np.searchsorted(np.asarray(seg.dictionary, dtype=object), "BUILDING"))
    cust_ok = np.zeros(int(cust["c_custkey"].data.max()) + 1, dtype=bool)
    cust_ok[cust["c_custkey"].data[seg.data == code]] = True
    ok_ = orders["o_custkey"].data
    om = (orders["o_orderdate"].data < d) & cust_ok[np.clip(ok_, 0, len(cust_ok) - 1)] & (
        ok_ < len(cust_ok))
    nord = int(orders["o_orderkey"].data.max()) + 1
    ord_ok = np.zeros(nord, dtype=bool)
    ord_date = np.zeros(nord, dtype=np.int64)
    ord_prio = np.zeros(nord, dtype=np.int64)
    keys = orders["o_orderkey"].data[om]
    ord_ok[keys] = True
    ord_date[keys] = orders["o_orderdate"].data[om]
    ord_prio[keys] = orders["o_shippriority"].data[om]
    lok = li["l_orderkey"].data
    m = (li["l_shipdate"].data > d) & ord_ok[np.clip(lok, 0, nord - 1)] & (lok < nord)
    k = lok[m]
    rev = li["l_extendedprice"].data[m] * (100 - li["l_discount"].data[m])
    order = np.argsort(k, kind="stable")
    k, rev = k[order], rev[order]
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]]) if len(k) else np.zeros(0, np.int64)
    gk = k[starts]
    grev = np.add.reduceat(rev, starts) if len(k) else np.zeros(0, np.int64)
    gdate = ord_date[gk]
    top = np.lexsort((gk, gdate, -grev))
    rows = [(int(gk[i]), int(grev[i]), int(gdate[i]), int(ord_prio[gk[i]])) for i in top[:limit]]
    tied = []
    if rows:
        last = (rows[-1][1], rows[-1][2])
        tied = [
            (int(gk[i]), int(grev[i]), int(gdate[i]), int(ord_prio[gk[i]]))
            for i in np.flatnonzero((grev == last[0]) & (gdate == last[1]))
        ]
    return rows, tied


def numpy_q5(cat, d0: int = Q5_D0, d1: int = Q5_D1):
    """Vectorized Q5 over raw columns (dense 1..N keys -> array lookups):
    revenue (scale 4) per nation key, as bench.py's ``numpy_q5``."""

    def cols(t):
        return dict(_cols(cat, t))

    reg = cols("region")
    nat = cols("nation")
    cust = cols("customer")
    supp = cols("supplier")
    orders = cols("orders")
    li = cols("lineitem")
    asia_code = np.searchsorted(
        np.asarray(reg["r_name"].dictionary, dtype=object), "ASIA"
    )
    asia = set(reg["r_regionkey"].data[reg["r_name"].data == asia_code].tolist())
    nat_in = np.array([rk in asia for rk in nat["n_regionkey"].data])
    n_nat = len(nat_in)
    cust_nation = np.zeros(int(cust["c_custkey"].data.max()) + 1, dtype=np.int64)
    cust_nation[cust["c_custkey"].data] = cust["c_nationkey"].data
    supp_nation = np.zeros(int(supp["s_suppkey"].data.max()) + 1, dtype=np.int64)
    supp_nation[supp["s_suppkey"].data] = supp["s_nationkey"].data
    om = (orders["o_orderdate"].data >= d0) & (orders["o_orderdate"].data < d1)
    ord_cust = np.zeros(int(orders["o_orderkey"].data.max()) + 2, dtype=np.int64)
    ord_ok = np.zeros(int(orders["o_orderkey"].data.max()) + 2, dtype=bool)
    ord_cust[orders["o_orderkey"].data[om]] = orders["o_custkey"].data[om]
    ord_ok[orders["o_orderkey"].data[om]] = True
    lo = li["l_orderkey"].data
    ls = li["l_suppkey"].data
    cn = cust_nation[ord_cust[lo]]
    sn = supp_nation[ls]
    m = ord_ok[lo] & (cn == sn) & nat_in[np.clip(sn, 0, n_nat - 1)]
    rev = li["l_extendedprice"].data[m] * (100 - li["l_discount"].data[m])
    return np.bincount(sn[m], rev, minlength=n_nat)


# ---------------------------------------------------------------------------
# the rest of TPC-H: the text of tests/test_tpch_sql.py, with the
# substitution parameters that file scales down for sf 0.002 as
# placeholders (Q11's fraction, Q18's quantity)
# ---------------------------------------------------------------------------

Q2_SQL = (
    "select s_acctbal, s_name, n_name, p_partkey, p_mfgr "
    "from part, supplier, partsupp, nation, region "
    "where p_partkey = ps_partkey and s_suppkey = ps_suppkey "
    "and p_size = 15 and p_type like '%BRASS' "
    "and s_nationkey = n_nationkey and n_regionkey = r_regionkey "
    "and r_name = 'EUROPE' "
    "and ps_supplycost = (select min(ps_supplycost) from partsupp, supplier, "
    "nation, region where p_partkey = ps_partkey and s_suppkey = ps_suppkey "
    "and s_nationkey = n_nationkey and n_regionkey = r_regionkey "
    "and r_name = 'EUROPE') "
    "order by s_acctbal desc, n_name, s_name, p_partkey limit 100"
)
Q4_SQL = (
    "select o_orderpriority, count(*) as order_count from orders "
    "where o_orderdate >= date '1993-07-01' "
    "and o_orderdate < date '1993-10-01' "
    "and exists (select * from lineitem where l_orderkey = o_orderkey "
    "and l_commitdate < l_receiptdate) "
    "group by o_orderpriority order by o_orderpriority"
)
Q7_SQL = (
    "select supp_nation, cust_nation, l_year, sum(volume) as revenue "
    "from (select n1.n_name as supp_nation, n2.n_name as cust_nation, "
    "extract(year from l_shipdate) as l_year, "
    "l_extendedprice * (1 - l_discount) as volume "
    "from supplier, lineitem, orders, customer, nation n1, nation n2 "
    "where s_suppkey = l_suppkey and o_orderkey = l_orderkey "
    "and c_custkey = o_custkey and s_nationkey = n1.n_nationkey "
    "and c_nationkey = n2.n_nationkey "
    "and ((n1.n_name = 'FRANCE' and n2.n_name = 'GERMANY') "
    "or (n1.n_name = 'GERMANY' and n2.n_name = 'FRANCE')) "
    "and l_shipdate between date '1995-01-01' and date '1996-12-31'"
    ") as shipping "
    "group by supp_nation, cust_nation, l_year "
    "order by supp_nation, cust_nation, l_year"
)
Q8_SQL = (
    "select o_year, sum(case when nation = 'BRAZIL' then volume else 0 end) "
    "/ sum(volume) as mkt_share "
    "from (select extract(year from o_orderdate) as o_year, "
    "l_extendedprice * (1 - l_discount) as volume, n2.n_name as nation "
    "from part, supplier, lineitem, orders, customer, nation n1, nation n2, region "
    "where p_partkey = l_partkey and s_suppkey = l_suppkey "
    "and l_orderkey = o_orderkey and o_custkey = c_custkey "
    "and c_nationkey = n1.n_nationkey and n1.n_regionkey = r_regionkey "
    "and r_name = 'AMERICA' and s_nationkey = n2.n_nationkey "
    "and o_orderdate between date '1995-01-01' and date '1996-12-31' "
    "and p_type = 'ECONOMY ANODIZED STEEL') as all_nations "
    "group by o_year order by o_year"
)
Q9_SQL = (
    "select nation, o_year, sum(amount) as sum_profit "
    "from (select n_name as nation, "
    "extract(year from o_orderdate) as o_year, "
    "l_extendedprice * (1 - l_discount) - ps_supplycost * l_quantity as amount "
    "from part, supplier, lineitem, partsupp, orders, nation "
    "where s_suppkey = l_suppkey and ps_suppkey = l_suppkey "
    "and ps_partkey = l_partkey and p_partkey = l_partkey "
    "and o_orderkey = l_orderkey and s_nationkey = n_nationkey "
    "and p_name like '%green%') as profit "
    "group by nation, o_year order by nation, o_year desc"
)
Q10_SQL = (
    "select c_custkey, c_name, "
    "sum(l_extendedprice * (1 - l_discount)) as revenue, c_acctbal, "
    "n_name, c_address, c_phone, c_comment "
    "from customer, orders, lineitem, nation "
    "where c_custkey = o_custkey and l_orderkey = o_orderkey "
    "and o_orderdate >= date '1993-10-01' "
    "and o_orderdate < date '1994-01-01' "
    "and l_returnflag = 'R' and c_nationkey = n_nationkey "
    "group by c_custkey, c_name, c_acctbal, c_phone, n_name, c_address, c_comment "
    "order by revenue desc, c_custkey limit 20"
)
Q11_SQL = (
    "select ps_partkey, sum(ps_supplycost * ps_availqty) as value "
    "from partsupp, supplier, nation "
    "where ps_suppkey = s_suppkey and s_nationkey = n_nationkey "
    "and n_name = 'GERMANY' "
    "group by ps_partkey having "
    "sum(ps_supplycost * ps_availqty) > ("
    "select sum(ps_supplycost * ps_availqty) * {fraction} "
    "from partsupp, supplier, nation "
    "where ps_suppkey = s_suppkey and s_nationkey = n_nationkey "
    "and n_name = 'GERMANY') "
    "order by value desc, ps_partkey"
)
Q12_SQL = (
    "select l_shipmode, "
    "sum(case when o_orderpriority = '1-URGENT' or o_orderpriority = '2-HIGH' "
    "then 1 else 0 end) as high_line_count, "
    "sum(case when o_orderpriority <> '1-URGENT' and o_orderpriority <> '2-HIGH' "
    "then 1 else 0 end) as low_line_count "
    "from orders, lineitem where o_orderkey = l_orderkey "
    "and l_shipmode in ('MAIL', 'SHIP') "
    "and l_commitdate < l_receiptdate and l_shipdate < l_commitdate "
    "and l_receiptdate >= date '1994-01-01' and l_receiptdate < date '1995-01-01' "
    "group by l_shipmode order by l_shipmode"
)
Q13_SQL = (
    "select c_count, count(*) as custdist from "
    "(select c_custkey, count(o_orderkey) as c_count "
    "from customer left outer join orders on "
    "c_custkey = o_custkey and o_comment not like '%special%requests%' "
    "group by c_custkey) as c_orders "
    "group by c_count order by custdist desc, c_count desc"
)
Q14_SQL = (
    "select 100.00 * sum(case when p_type like 'PROMO%' "
    "then l_extendedprice * (1 - l_discount) else 0 end) "
    "/ sum(l_extendedprice * (1 - l_discount)) as promo_revenue "
    "from lineitem, part where l_partkey = p_partkey "
    "and l_shipdate >= date '1995-09-01' and l_shipdate < date '1995-10-01'"
)
Q15_SQL = (
    "with revenue as (select l_suppkey as supplier_no, "
    "sum(l_extendedprice * (1 - l_discount)) as total_revenue "
    "from lineitem where l_shipdate >= date '1996-01-01' "
    "and l_shipdate < date '1996-04-01' group by l_suppkey) "
    "select s_suppkey, s_name, total_revenue "
    "from supplier, revenue where s_suppkey = supplier_no "
    "and total_revenue = (select max(total_revenue) from revenue) "
    "order by s_suppkey"
)
Q16_SQL = (
    "select p_brand, p_type, p_size, count(distinct ps_suppkey) as supplier_cnt "
    "from partsupp, part where p_partkey = ps_partkey "
    "and p_brand <> 'Brand#45' and p_type not like 'MEDIUM POLISHED%' "
    "and p_size in (49, 14, 23, 45, 19, 3, 36, 9) "
    "and ps_suppkey not in (select s_suppkey from supplier where "
    "s_comment like '%Customer%Complaints%') "
    "group by p_brand, p_type, p_size "
    "order by supplier_cnt desc, p_brand, p_type, p_size"
)
Q17_SQL = (
    "select sum(l_extendedprice) / 7.0 as avg_yearly "
    "from lineitem, part "
    "where p_partkey = l_partkey and p_brand = 'Brand#23' "
    "and p_container = 'MED BAG' "
    "and l_quantity < (select 0.2 * avg(l_quantity) from lineitem "
    "where l_partkey = p_partkey)"
)
Q18_SQL = (
    "select c_custkey, o_orderkey, o_orderdate, o_totalprice, sum(l_quantity) "
    "from customer, orders, lineitem "
    "where o_orderkey in (select l_orderkey from lineitem group by l_orderkey "
    "having sum(l_quantity) > {quantity}) "
    "and c_custkey = o_custkey and o_orderkey = l_orderkey "
    "group by c_custkey, o_orderkey, o_orderdate, o_totalprice "
    "order by o_totalprice desc, o_orderdate limit 100"
)
Q19_SQL = (
    "select sum(l_extendedprice * (1 - l_discount)) as revenue "
    "from lineitem, part where "
    "(p_partkey = l_partkey and p_brand = 'Brand#12' "
    "and p_container in ('SM CASE', 'SM BOX', 'SM PACK') "
    "and l_quantity >= 1 and l_quantity <= 11 "
    "and p_size between 1 and 5 "
    "and l_shipmode in ('AIR', 'REG AIR') "
    "and l_shipinstruct = 'DELIVER IN PERSON') "
    "or (p_partkey = l_partkey and p_brand = 'Brand#23' "
    "and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK') "
    "and l_quantity >= 10 and l_quantity <= 20 "
    "and p_size between 1 and 10 "
    "and l_shipmode in ('AIR', 'REG AIR') "
    "and l_shipinstruct = 'DELIVER IN PERSON') "
    "or (p_partkey = l_partkey and p_brand = 'Brand#34' "
    "and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG') "
    "and l_quantity >= 20 and l_quantity <= 30 "
    "and p_size between 1 and 15 "
    "and l_shipmode in ('AIR', 'REG AIR') "
    "and l_shipinstruct = 'DELIVER IN PERSON')"
)
Q20_SQL = (
    "select s_name, s_address from supplier, nation "
    "where s_suppkey in (select ps_suppkey from partsupp where "
    "ps_partkey in (select p_partkey from part where p_name like 'forest%') "
    "and ps_availqty > (select 0.5 * sum(l_quantity) from lineitem "
    "where l_partkey = ps_partkey and l_suppkey = ps_suppkey "
    "and l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01')) "
    "and s_nationkey = n_nationkey and n_name = 'CANADA' "
    "order by s_name"
)
Q21_SQL = (
    "select s_suppkey, count(*) as numwait "
    "from supplier, lineitem l1, orders, nation "
    "where s_suppkey = l1.l_suppkey and o_orderkey = l1.l_orderkey "
    "and o_orderstatus = 'F' and l1.l_receiptdate > l1.l_commitdate "
    "and s_nationkey = n_nationkey and n_name = 'SAUDI ARABIA' "
    "and exists (select * from lineitem l2 where "
    "l2.l_orderkey = l1.l_orderkey and l2.l_suppkey <> l1.l_suppkey) "
    "and not exists (select * from lineitem l3 where "
    "l3.l_orderkey = l1.l_orderkey and l3.l_suppkey <> l1.l_suppkey "
    "and l3.l_receiptdate > l3.l_commitdate) "
    "group by s_suppkey order by numwait desc, s_suppkey limit 100"
)
Q22_SQL = (
    "select cntrycode, count(*) as numcust, sum(c_acctbal) as totacctbal "
    "from (select substring(c_phone, 1, 2) as cntrycode, c_acctbal "
    "from customer where substring(c_phone, 1, 2) in "
    "('13', '31', '23', '29', '30', '18', '17') "
    "and c_acctbal > (select avg(c_acctbal) from customer "
    "where c_acctbal > 0.00 and substring(c_phone, 1, 2) in "
    "('13', '31', '23', '29', '30', '18', '17')) "
    "and not exists (select * from orders where o_custkey = c_custkey)"
    ") as custsale group by cntrycode order by cntrycode"
)


def _days(s: str) -> int:
    return int(date_to_days(s))


def _year(days: np.ndarray) -> np.ndarray:
    return days.astype("datetime64[D]").astype("datetime64[Y]").astype(np.int64) + 1970


def _dates(days: np.ndarray) -> list:
    if len(days) == 0:
        return []
    return np.datetime_as_string(np.asarray(days).astype("datetime64[D]"), unit="D").tolist()


def _str_mask(col, pred) -> np.ndarray:
    """Rows whose string satisfies `pred`, evaluated once per dictionary
    value with plain str methods."""
    lut = np.array([bool(pred(s)) for s in col.dictionary.tolist()] or [False])
    return lut[col.data]


def _code(col, value: str) -> int:
    """Dictionary code of `value`, or -1 where the column never holds it."""
    d = col.dictionary
    i = int(np.searchsorted(d, value))
    return i if i < len(d) and d[i] == value else -1


def _strs(col, rows) -> list:
    return col.dictionary[col.data[rows]].tolist()


def _lookup(keys: np.ndarray, values: np.ndarray, fill, dtype=None) -> np.ndarray:
    """Dense key -> value table over keys 0..max (the TPC-H keys are
    small positive integers); absent keys hold `fill`."""
    out = np.full(int(keys.max(initial=0)) + 1, fill, dtype=dtype or values.dtype)
    out[keys] = values
    return out


def _at(table: np.ndarray, keys: np.ndarray, fill):
    """table[keys] with keys past the table reading `fill`."""
    if len(keys) == 0 or (keys.min() >= 0 and keys.max() < len(table)):
        return table[keys]  # every key inside: no clipped copy of the keys
    inside = (keys >= 0) & (keys < len(table))
    return np.where(inside, table[np.clip(keys, 0, len(table) - 1)], fill)


def _sums(inverse: np.ndarray, values: np.ndarray, n: int) -> np.ndarray:
    """Exact int64 sums per group (np.bincount would round via float64)."""
    out = np.zeros(n, dtype=np.int64)
    np.add.at(out, inverse, values.astype(np.int64))
    return out


def _dec(v, scale: int):
    """A scaled DECIMAL as the engine presents it (float of v / 10^s)."""
    return (np.asarray(v, dtype=np.int64) / (10**scale)).tolist()


def _nation_codes(cat, names) -> np.ndarray:
    """Nation keys -> whether the nation's name is in `names`."""
    nat = _cols(cat, "nation")
    return _lookup(nat["n_nationkey"].data, _str_mask(nat["n_name"], lambda s: s in names), False)


def _region_nations(cat, region: str) -> np.ndarray:
    """Nation keys -> whether the nation lies in `region`."""
    reg, nat = _cols(cat, "region"), _cols(cat, "nation")
    rk = reg["r_regionkey"].data[_str_mask(reg["r_name"], lambda s: s == region)]
    return _lookup(nat["n_nationkey"].data, np.isin(nat["n_regionkey"].data, rk), False)


def _nation_names(cat) -> np.ndarray:
    nat = _cols(cat, "nation")
    names = nat["n_name"].dictionary[nat["n_name"].data]
    return _lookup(nat["n_nationkey"].data, names.astype(object), None, dtype=object)


def numpy_q2(cat, size: int = 15, type_suffix: str = "BRASS", region: str = "EUROPE"):
    part, supp, ps = _cols(cat, "part"), _cols(cat, "supplier"), _cols(cat, "partsupp")
    in_region = _region_nations(cat, region)
    s_nat = _lookup(supp["s_suppkey"].data, supp["s_nationkey"].data, -1)
    s_row = _lookup(supp["s_suppkey"].data, np.arange(len(supp["s_suppkey"].data)), -1)
    pk, sk, cost = ps["ps_partkey"].data, ps["ps_suppkey"].data, ps["ps_supplycost"].data
    sn = _at(s_nat, sk, -1)
    eu = (sn >= 0) & _at(in_region, sn, False)
    min_cost = np.full(int(pk.max(initial=0)) + 1, np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(min_cost, pk[eu], cost[eu])
    p_ok = _lookup(
        part["p_partkey"].data,
        (part["p_size"].data == size) & _str_mask(part["p_type"], lambda s: s.endswith(type_suffix)),
        False,
    )
    p_row = _lookup(part["p_partkey"].data, np.arange(len(part["p_partkey"].data)), -1)
    m = eu & _at(p_ok, pk, False) & (cost == _at(min_cost, pk, -1))
    srow, prow = s_row[sk[m]], p_row[pk[m]]
    names = _nation_names(cat)
    rows = list(zip(
        _dec(supp["s_acctbal"].data[srow], 2), _strs(supp["s_name"], srow),
        names[sn[m]].tolist(), pk[m].tolist(), _strs(part["p_mfgr"], prow),
    ))
    return sorted(rows, key=lambda r: (-r[0], r[2], r[1], r[3]))


def numpy_q4(cat, d0: str = "1993-07-01", d1: str = "1993-10-01"):
    orders, li = _cols(cat, "orders"), _cols(cat, "lineitem")
    late = li["l_orderkey"].data[li["l_commitdate"].data < li["l_receiptdate"].data]
    has_late = np.zeros(int(orders["o_orderkey"].data.max()) + 1, dtype=bool)
    has_late[late[late < len(has_late)]] = True
    od = orders["o_orderdate"].data
    m = (od >= _days(d0)) & (od < _days(d1)) & has_late[orders["o_orderkey"].data]
    pri = orders["o_orderpriority"]
    cnt = np.bincount(pri.data[m], minlength=len(pri.dictionary))
    return [(pri.dictionary[k], int(cnt[k])) for k in np.flatnonzero(cnt)]


def _volume(li, m):
    """l_extendedprice * (1 - l_discount) as a scale-4 integer."""
    return li["l_extendedprice"].data[m] * (100 - li["l_discount"].data[m])


def _order_custs(cat):
    orders, cust = _cols(cat, "orders"), _cols(cat, "customer")
    o_cust = _lookup(orders["o_orderkey"].data, orders["o_custkey"].data, -1)
    c_nat = _lookup(cust["c_custkey"].data, cust["c_nationkey"].data, -1)
    return o_cust, c_nat


def numpy_q7(cat, n1: str = "FRANCE", n2: str = "GERMANY",
             d0: str = "1995-01-01", d1: str = "1996-12-31"):
    li, supp = _cols(cat, "lineitem"), _cols(cat, "supplier")
    o_cust, c_nat = _order_custs(cat)
    s_nat = _lookup(supp["s_suppkey"].data, supp["s_nationkey"].data, -1)
    names = _nation_names(cat)
    nat = _cols(cat, "nation")
    k1 = int(nat["n_nationkey"].data[_str_mask(nat["n_name"], lambda s: s == n1)][0])
    k2 = int(nat["n_nationkey"].data[_str_mask(nat["n_name"], lambda s: s == n2)][0])
    ship = li["l_shipdate"].data
    m = (ship >= _days(d0)) & (ship <= _days(d1))
    sn = _at(s_nat, li["l_suppkey"].data[m], -1)
    ck = _at(o_cust, li["l_orderkey"].data[m], -1)
    cn = np.where(ck >= 0, _at(c_nat, ck, -1), -1)
    pair = ((sn == k1) & (cn == k2)) | ((sn == k2) & (cn == k1))
    idx = np.flatnonzero(m)[pair]
    year = _year(ship[idx])
    keys, inv = np.unique((sn[pair] * 32 + cn[pair]) * 4096 + year, return_inverse=True)
    rev = _sums(inv, _volume(li, idx), len(keys))
    rows = [(names[k // 4096 // 32], names[k // 4096 % 32], int(k % 4096), v)
            for k, v in zip(keys.tolist(), _dec(rev, 4))]
    return sorted(rows, key=lambda r: r[:3])


def numpy_q8(cat, nation: str = "BRAZIL", region: str = "AMERICA",
             ptype: str = "ECONOMY ANODIZED STEEL",
             d0: str = "1995-01-01", d1: str = "1996-12-31"):
    li, orders, supp, part = (_cols(cat, t) for t in ("lineitem", "orders", "supplier", "part"))
    o_cust, c_nat = _order_custs(cat)
    in_region = _region_nations(cat, region)
    is_nation = _nation_codes(cat, {nation})
    s_nat = _lookup(supp["s_suppkey"].data, supp["s_nationkey"].data, -1)
    p_ok = _lookup(part["p_partkey"].data, _str_mask(part["p_type"], lambda s: s == ptype), False)
    od = orders["o_orderdate"].data
    o_date = _lookup(orders["o_orderkey"].data, np.where((od >= _days(d0)) & (od <= _days(d1)), od, -1), -1)
    lk = li["l_orderkey"].data
    date = _at(o_date, lk, -1)
    ck = _at(o_cust, lk, -1)
    cn = np.where(ck >= 0, _at(c_nat, ck, -1), -1)
    sn = _at(s_nat, li["l_suppkey"].data, -1)
    m = (_at(p_ok, li["l_partkey"].data, False) & (date >= 0) & (cn >= 0)
         & _at(in_region, cn, False) & (sn >= 0))
    idx = np.flatnonzero(m)
    years, inv = np.unique(_year(date[idx]), return_inverse=True)
    vol = _volume(li, idx)
    den = _sums(inv, vol, len(years))
    num = _sums(inv, np.where(_at(is_nation, sn[idx], False), vol, 0), len(years))
    share = (num.astype(np.float64) / 10**4) / (den.astype(np.float64) / 10**4)
    return list(zip(years.tolist(), share.tolist()))


def numpy_q9(cat, color: str = "green"):
    li, orders, supp, part, ps = (
        _cols(cat, t) for t in ("lineitem", "orders", "supplier", "part", "partsupp"))
    p_ok = _lookup(part["p_partkey"].data, _str_mask(part["p_name"], lambda s: color in s), False)
    s_nat = _lookup(supp["s_suppkey"].data, supp["s_nationkey"].data, -1)
    o_date = _lookup(orders["o_orderkey"].data, orders["o_orderdate"].data, -1)
    width = int(max(ps["ps_suppkey"].data.max(), li["l_suppkey"].data.max())) + 1
    ps_key = ps["ps_partkey"].data * width + ps["ps_suppkey"].data
    order = np.argsort(ps_key, kind="stable")
    ps_sorted = ps_key[order]
    pk, sk = li["l_partkey"].data, li["l_suppkey"].data
    m = _at(p_ok, pk, False)
    idx = np.flatnonzero(m)
    key = pk[idx] * width + sk[idx]
    pos = np.clip(np.searchsorted(ps_sorted, key), 0, len(ps_sorted) - 1)
    hit = ps_sorted[pos] == key
    date = _at(o_date, li["l_orderkey"].data[idx], -1)
    sn = _at(s_nat, sk[idx], -1)
    names = _nation_names(cat)
    ok = hit & (date >= 0) & (sn >= 0)
    idx, pos, date, sn = idx[ok], pos[ok], date[ok], sn[ok]
    cost = ps["ps_supplycost"].data[order[pos]]
    amount = _volume(li, idx) - cost * li["l_quantity"].data[idx]
    keys, inv = np.unique(sn * 4096 + _year(date), return_inverse=True)
    total = _sums(inv, amount, len(keys))
    rows = [(names[k // 4096], int(k % 4096), v) for k, v in zip(keys.tolist(), _dec(total, 4))]
    return sorted(rows, key=lambda r: (r[0], -r[1]))


def numpy_q10(cat, d0: str = "1993-10-01", d1: str = "1994-01-01", flag: str = "R",
              limit: int = 20):
    li, orders, cust = _cols(cat, "lineitem"), _cols(cat, "orders"), _cols(cat, "customer")
    od = orders["o_orderdate"].data
    om = (od >= _days(d0)) & (od < _days(d1))
    o_cust = _lookup(orders["o_orderkey"].data, np.where(om, orders["o_custkey"].data, -1), -1)
    m = li["l_returnflag"].data == _code(li["l_returnflag"], flag)
    idx = np.flatnonzero(m)
    ck = _at(o_cust, li["l_orderkey"].data[idx], -1)
    idx, ck = idx[ck >= 0], ck[ck >= 0]
    keys, inv = np.unique(ck, return_inverse=True)
    rev = _sums(inv, _volume(li, idx), len(keys))
    c_row = _lookup(cust["c_custkey"].data, np.arange(len(cust["c_custkey"].data)), -1)
    rows_ = _at(c_row, keys, -1)
    keys, rev, rows_ = keys[rows_ >= 0], rev[rows_ >= 0], rows_[rows_ >= 0]
    top = np.lexsort((keys, -rev))
    top = _with_ties(top, (rev,), limit)
    keys, rev, r = keys[top], rev[top], rows_[top]
    names = _nation_names(cat)
    return list(zip(
        keys.tolist(), _strs(cust["c_name"], r), _dec(rev, 4),
        _dec(cust["c_acctbal"].data[r], 2), names[cust["c_nationkey"].data[r]].tolist(),
        _strs(cust["c_address"], r), _strs(cust["c_phone"], r), _strs(cust["c_comment"], r),
    ))


def _with_ties(order: np.ndarray, keys, limit: int) -> np.ndarray:
    """The first `limit` positions of `order`, plus every later one that
    ties the last of them on all ORDER BY `keys` (which a LIMIT may take
    in any order)."""
    if len(order) <= limit:
        return order
    last = order[limit - 1]
    tie = np.ones(len(order), dtype=bool)
    for k in keys:
        tie &= k[order] == k[last]
    tie[:limit] = True
    return order[tie]


def _fraction(text: str):
    """A DECIMAL literal's (physical value, scale)."""
    scale = len(text.split(".")[1]) if "." in text else 0
    return int(round(float(text) * 10**scale)), scale


def numpy_q11(cat, fraction: str = "0.0001", nation: str = "GERMANY"):
    ps, supp = _cols(cat, "partsupp"), _cols(cat, "supplier")
    is_nation = _nation_codes(cat, {nation})
    s_nat = _lookup(supp["s_suppkey"].data, supp["s_nationkey"].data, -1)
    sn = _at(s_nat, ps["ps_suppkey"].data, -1)
    m = (sn >= 0) & _at(is_nation, sn, False)
    value = ps["ps_supplycost"].data[m] * ps["ps_availqty"].data[m]
    keys, inv = np.unique(ps["ps_partkey"].data[m], return_inverse=True)
    per_part = _sums(inv, value, len(keys))
    # the subquery's DECIMAL product comes back as a float literal, and
    # HAVING compares the scale-2 sums with it as floats
    phys, scale = _fraction(fraction)
    thresh = (np.int64(value.sum()) * phys) / 10 ** (2 + scale)
    keep = per_part.astype(np.float64) / 100 > thresh
    rows = list(zip(keys[keep].tolist(), _dec(per_part[keep], 2)))
    return sorted(rows, key=lambda r: (-r[1], r[0]))


def numpy_q12(cat, modes=("MAIL", "SHIP"), d0: str = "1994-01-01", d1: str = "1995-01-01"):
    li, orders = _cols(cat, "lineitem"), _cols(cat, "orders")
    pri = orders["o_orderpriority"]
    high = _str_mask(pri, lambda s: s in ("1-URGENT", "2-HIGH"))
    o_high = _lookup(orders["o_orderkey"].data, high.astype(np.int8), -1)
    commit, receipt = li["l_commitdate"].data, li["l_receiptdate"].data
    mode = li["l_shipmode"]
    m = (_str_mask(mode, lambda s: s in modes) & (commit < receipt)
         & (li["l_shipdate"].data < commit) & (receipt >= _days(d0)) & (receipt < _days(d1)))
    idx = np.flatnonzero(m)
    h = _at(o_high, li["l_orderkey"].data[idx], -1)
    idx, h = idx[h >= 0], h[h >= 0]
    code = mode.data[idx]
    hi = np.bincount(code, weights=None, minlength=len(mode.dictionary))
    n_hi = np.bincount(code[h == 1], minlength=len(mode.dictionary))
    return [(mode.dictionary[k], int(n_hi[k]), int(hi[k] - n_hi[k])) for k in np.flatnonzero(hi)]


def _like_in_order(s: str, words) -> bool:
    """Whether `words` occur in `s` one after another (LIKE '%a%b%')."""
    at = 0
    for w in words:
        i = s.find(w, at)
        if i < 0:
            return False
        at = i + len(w)
    return True


def numpy_q13(cat, words=("special", "requests")):
    orders, cust = _cols(cat, "orders"), _cols(cat, "customer")
    ok = ~_str_mask(orders["o_comment"], lambda s: _like_in_order(s, words))
    ck = cust["c_custkey"].data
    per_cust = np.bincount(orders["o_custkey"].data[ok], minlength=int(ck.max()) + 1)
    counts = _at(per_cust, ck, 0)
    dist = np.bincount(counts)
    rows = [(int(c), int(dist[c])) for c in np.flatnonzero(dist)]
    return sorted(rows, key=lambda r: (-r[1], -r[0]))


def numpy_q14(cat, d0: str = "1995-09-01", d1: str = "1995-10-01", prefix: str = "PROMO"):
    li, part = _cols(cat, "lineitem"), _cols(cat, "part")
    promo = _lookup(part["p_partkey"].data, _str_mask(part["p_type"], lambda s: s.startswith(prefix)).astype(np.int8), -1)
    ship = li["l_shipdate"].data
    idx = np.flatnonzero((ship >= _days(d0)) & (ship < _days(d1)))
    p = _at(promo, li["l_partkey"].data[idx], -1)
    idx, p = idx[p >= 0], p[p >= 0]
    if len(idx) == 0:
        return [(None,)]
    vol = _volume(li, idx)
    num, den = int(vol[p == 1].sum()), int(vol.sum())
    # 100.00 * (scale-4 sum) is a scale-6 DECIMAL; the division is in floats
    return [((np.float64(100 * 100 * num) / 10**6) / (np.float64(den) / 10**4),)]


def numpy_q15(cat, d0: str = "1996-01-01", d1: str = "1996-04-01"):
    li, supp = _cols(cat, "lineitem"), _cols(cat, "supplier")
    ship = li["l_shipdate"].data
    idx = np.flatnonzero((ship >= _days(d0)) & (ship < _days(d1)))
    keys, inv = np.unique(li["l_suppkey"].data[idx], return_inverse=True)
    rev = _sums(inv, _volume(li, idx), len(keys))
    s_row = _lookup(supp["s_suppkey"].data, np.arange(len(supp["s_suppkey"].data)), -1)
    top = keys[rev == rev.max()] if len(rev) else keys
    r = _at(s_row, top, -1)
    top, r = top[r >= 0], r[r >= 0]
    return list(zip(top.tolist(), _strs(supp["s_name"], r), _dec(np.full(len(r), rev.max() if len(rev) else 0), 4)))


def numpy_q16(cat, brand: str = "Brand#45", type_prefix: str = "MEDIUM POLISHED",
              sizes=(49, 14, 23, 45, 19, 3, 36, 9), words=("Customer", "Complaints")):
    ps, part, supp = _cols(cat, "partsupp"), _cols(cat, "part"), _cols(cat, "supplier")
    bad = supp["s_suppkey"].data[_str_mask(supp["s_comment"], lambda s: _like_in_order(s, words))]
    p_ok = (_str_mask(part["p_brand"], lambda s: s != brand)
            & _str_mask(part["p_type"], lambda s: not s.startswith(type_prefix))
            & np.isin(part["p_size"].data, sizes))
    p_row = _lookup(part["p_partkey"].data, np.where(p_ok, np.arange(len(p_ok)), -1), -1)
    r = _at(p_row, ps["ps_partkey"].data, -1)
    m = (r >= 0) & ~np.isin(ps["ps_suppkey"].data, bad)
    r, sk = r[m], ps["ps_suppkey"].data[m]
    b, t, z = part["p_brand"].data[r], part["p_type"].data[r], part["p_size"].data[r]
    group = (b.astype(np.int64) * 4096 + t) * 4096 + z
    pairs = np.unique(np.stack([group, sk]), axis=1)
    keys, cnt = np.unique(pairs[0], return_counts=True)
    bd, td = part["p_brand"].dictionary, part["p_type"].dictionary
    rows = [(bd[k // 4096 // 4096], td[k // 4096 % 4096], int(k % 4096), int(c))
            for k, c in zip(keys.tolist(), cnt.tolist())]
    return sorted(rows, key=lambda r: (-r[3], r[0], r[1], r[2]))


def numpy_q17(cat, brand: str = "Brand#23", container: str = "MED BAG"):
    li, part = _cols(cat, "lineitem"), _cols(cat, "part")
    pk, qty = li["l_partkey"].data, li["l_quantity"].data
    n = int(pk.max()) + 1
    cnt = np.bincount(pk, minlength=n)
    tot = np.zeros(n, dtype=np.int64)
    np.add.at(tot, pk, qty)
    p_ok = _lookup(part["p_partkey"].data, _str_mask(part["p_brand"], lambda s: s == brand)
                   & _str_mask(part["p_container"], lambda s: s == container), False)
    idx = np.flatnonzero(_at(p_ok, pk, False))
    k = pk[idx]
    # the engine's float compare: l_quantity / 100 < 0.2 * (sum / (count * 100))
    avg = tot[k].astype(np.float64) / (cnt[k].astype(np.float64) * 100)
    m = qty[idx].astype(np.float64) / 100 < (2 / 10) * avg
    if not m.any():
        return [(None,)]
    total = int(li["l_extendedprice"].data[idx[m]].sum())
    return [((np.float64(total) / 100) / (70 / 10),)]


def numpy_q18(cat, quantity: int = 300, limit: int = 100):
    li, orders = _cols(cat, "lineitem"), _cols(cat, "orders")
    lk, qty = li["l_orderkey"].data, li["l_quantity"].data
    tot = exact_bincount(lk, qty, int(lk.max()) + 1)
    ok = orders["o_orderkey"].data
    ck = _cols(cat, "customer")["c_custkey"].data
    cust_ok = _at(_lookup(ck, np.ones(len(ck), dtype=bool), False), orders["o_custkey"].data, False)
    r = np.flatnonzero((_at(tot, ok, 0) > quantity * 100) & cust_ok)
    price, date = orders["o_totalprice"].data[r], orders["o_orderdate"].data[r]
    order = _with_ties(np.lexsort((date, -price)), (price, date), limit)
    r = r[order]
    return list(zip(
        orders["o_custkey"].data[r].tolist(), ok[r].tolist(), _dates(orders["o_orderdate"].data[r]),
        _dec(orders["o_totalprice"].data[r], 2), _dec(tot[ok[r]], 2),
    ))


def numpy_q19(cat):
    li, part = _cols(cat, "lineitem"), _cols(cat, "part")
    groups = [("Brand#12", ("SM CASE", "SM BOX", "SM PACK"), 1, 11, 5),
              ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10, 20, 10),
              ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20, 30, 15)]
    p_row = _lookup(part["p_partkey"].data, np.arange(len(part["p_partkey"].data)), -1)
    base = (_str_mask(li["l_shipmode"], lambda s: s in ("AIR", "REG AIR"))
            & _str_mask(li["l_shipinstruct"], lambda s: s == "DELIVER IN PERSON"))
    idx = np.flatnonzero(base)
    r = _at(p_row, li["l_partkey"].data[idx], -1)
    idx, r = idx[r >= 0], r[r >= 0]
    qty, size = li["l_quantity"].data[idx], part["p_size"].data[r]
    hit = np.zeros(len(idx), dtype=bool)
    for brand, containers, q0, q1, s1 in groups:
        hit |= (_str_mask(part["p_brand"], lambda s: s == brand)[r]
                & _str_mask(part["p_container"], lambda s: s in containers)[r]
                & (qty >= q0 * 100) & (qty <= q1 * 100) & (size >= 1) & (size <= s1))
    if not hit.any():
        return [(None,)]
    return [(_dec(_volume(li, idx[hit]).sum(), 4),)]


def numpy_q20(cat, prefix: str = "forest", nation: str = "CANADA",
              d0: str = "1994-01-01", d1: str = "1995-01-01"):
    li, supp, part, ps = (_cols(cat, t) for t in ("lineitem", "supplier", "part", "partsupp"))
    forest = _lookup(part["p_partkey"].data, _str_mask(part["p_name"], lambda s: s.startswith(prefix)), False)
    ship = li["l_shipdate"].data
    lm = (ship >= _days(d0)) & (ship < _days(d1)) & _at(forest, li["l_partkey"].data, False)
    width = int(max(ps["ps_suppkey"].data.max(), li["l_suppkey"].data.max())) + 1
    keys, inv = np.unique(li["l_partkey"].data[lm] * width + li["l_suppkey"].data[lm], return_inverse=True)
    shipped = _sums(inv, li["l_quantity"].data[lm], len(keys))
    pm = _at(forest, ps["ps_partkey"].data, False)
    pkey = ps["ps_partkey"].data[pm] * width + ps["ps_suppkey"].data[pm]
    pos = np.clip(np.searchsorted(keys, pkey), 0, max(len(keys) - 1, 0))
    hit = (keys[pos] == pkey) if len(keys) else np.zeros(len(pkey), dtype=bool)
    # ps_availqty > 0.5 * sum(l_quantity): scale-3 integers, 1000 * a > 5 * s
    good = hit & (1000 * ps["ps_availqty"].data[pm] > 5 * np.where(hit, shipped[pos], 0))
    good_supp = np.unique(ps["ps_suppkey"].data[pm][good])
    is_nation = _nation_codes(cat, {nation})
    r = np.flatnonzero(np.isin(supp["s_suppkey"].data, good_supp)
                       & _at(is_nation, supp["s_nationkey"].data, False))
    return sorted(zip(_strs(supp["s_name"], r), _strs(supp["s_address"], r)))


def numpy_q21(cat, nation: str = "SAUDI ARABIA", status: str = "F", limit: int = 100):
    li, orders, supp = _cols(cat, "lineitem"), _cols(cat, "orders"), _cols(cat, "supplier")
    is_nation = _nation_codes(cat, {nation})
    s_in = _lookup(supp["s_suppkey"].data, _at(is_nation, supp["s_nationkey"].data, False), False)
    st = orders["o_orderstatus"]
    o_ok = _lookup(orders["o_orderkey"].data, st.data == _code(st, status), False)
    lk, sk = li["l_orderkey"].data, li["l_suppkey"].data
    late = li["l_receiptdate"].data > li["l_commitdate"].data
    # the cheap tests first (a late line of the nation's supplier, ~2% of
    # the rows), then the order's status on those alone
    c = np.flatnonzero(late & _at(s_in, sk, False))
    c = c[_at(o_ok, lk[c], False)]
    cand = np.zeros(len(lk), dtype=bool)
    cand[c] = True
    # only the orders holding a candidate row matter: count, per order and
    # per (order, supplier), all rows and late rows
    held = np.zeros(int(lk.max()) + 1, dtype=bool)
    held[lk[c]] = True
    rows = np.flatnonzero(held[lk])
    width = int(sk.max()) + 1
    okeys, oinv = np.unique(lk[rows], return_inverse=True)
    n_all = np.bincount(oinv, minlength=len(okeys))
    n_late = np.bincount(oinv, weights=late[rows], minlength=len(okeys)).astype(np.int64)
    pkeys, pinv = np.unique(lk[rows] * width + sk[rows], return_inverse=True)
    p_all = np.bincount(pinv, minlength=len(pkeys))
    p_late = np.bincount(pinv, weights=late[rows], minlength=len(pkeys)).astype(np.int64)
    c = cand[rows]
    other = n_all[oinv[c]] - p_all[pinv[c]] > 0
    other_late = n_late[oinv[c]] - p_late[pinv[c]] > 0
    keys, cnt = np.unique(sk[rows][c][other & ~other_late], return_counts=True)
    order = _with_ties(np.lexsort((keys, -cnt)), (cnt, keys), limit)
    return list(zip(keys[order].tolist(), cnt[order].tolist()))


def numpy_q22(cat, codes=("13", "31", "23", "29", "30", "18", "17")):
    cust, orders = _cols(cat, "customer"), _cols(cat, "orders")
    phone = cust["c_phone"]
    code_of = np.array([s[:2] for s in phone.dictionary.tolist()] or [""], dtype=object)
    in_codes = _str_mask(phone, lambda s: s[:2] in codes)
    bal = cust["c_acctbal"].data
    pos = in_codes & (bal > 0)
    if not pos.any():
        return []
    # the subquery's AVG comes back as a float literal; the compare is in floats
    avg = np.float64(bal[pos].sum()) / (np.float64(pos.sum()) * 100)
    ck = cust["c_custkey"].data
    n_orders = np.bincount(orders["o_custkey"].data, minlength=int(ck.max()) + 1)
    m = in_codes & (bal.astype(np.float64) / 100 > avg) & (_at(n_orders, ck, 0) == 0)
    cc = code_of[phone.data[m]]
    keys, inv = np.unique(cc, return_inverse=True)
    cnt = np.bincount(inv, minlength=len(keys))
    tot = _sums(inv, bal[m], len(keys))
    return list(zip(keys.tolist(), cnt.tolist(), _dec(tot, 2)))


@dataclasses.dataclass(frozen=True)
class TpchQuery:
    """A query with its numpy oracle: a TPC-H query of
    tests/test_tpch_sql.py, or a report of REPORT_QUERIES. ``sql`` holds
    ``{name}`` placeholders (``str.format``) for the substitution
    parameters that file scales down; the oracle takes the
    same names as keywords, after the catalog. ``order`` are the result
    columns ORDER BY sorts on (None: no ORDER BY)."""

    sql: str
    oracle: Callable
    order: Optional[Tuple[int, ...]] = None
    limit: Optional[int] = None
    #: the values tests/test_tpch_sql.py uses at sf 0.002
    test_params: Dict[str, object] = dataclasses.field(default_factory=dict)


def spec_params(name: str, sf: float) -> Dict[str, object]:
    """The TPC-H specification's substitution values at scale `sf` for
    the parameters tests/test_tpch_sql.py scales down."""
    if name == "q11":
        return {"fraction": f"{0.0001 / sf:.12f}".rstrip("0")}
    if name == "q18":
        return {"quantity": 300}
    return {}


TPCH_QUERIES: Dict[str, TpchQuery] = {
    "q2": TpchQuery(Q2_SQL, numpy_q2, (0, 2, 1, 3), 100),
    "q4": TpchQuery(Q4_SQL, numpy_q4, (0,)),
    "q7": TpchQuery(Q7_SQL, numpy_q7, (0, 1, 2)),
    "q8": TpchQuery(Q8_SQL, numpy_q8, (0,)),
    "q9": TpchQuery(Q9_SQL, numpy_q9, (0, 1)),
    "q10": TpchQuery(Q10_SQL, numpy_q10, (2, 0), 20),
    "q11": TpchQuery(Q11_SQL, numpy_q11, (1, 0), test_params={"fraction": "0.005"}),
    "q12": TpchQuery(Q12_SQL, numpy_q12, (0,)),
    "q13": TpchQuery(Q13_SQL, numpy_q13, (1, 0)),
    "q14": TpchQuery(Q14_SQL, numpy_q14),
    "q15": TpchQuery(Q15_SQL, numpy_q15, (0,)),
    "q16": TpchQuery(Q16_SQL, numpy_q16, (3, 0, 1, 2)),
    "q17": TpchQuery(Q17_SQL, numpy_q17),
    "q18": TpchQuery(Q18_SQL, numpy_q18, (3, 2), 100, test_params={"quantity": 120}),
    "q19": TpchQuery(Q19_SQL, numpy_q19),
    "q20": TpchQuery(Q20_SQL, numpy_q20, (0,)),
    "q21": TpchQuery(Q21_SQL, numpy_q21, (1, 0), 100),
    "q22": TpchQuery(Q22_SQL, numpy_q22, (0,)),
}


# ---------------------------------------------------------------------------
# window and set-operation reports over TPC-H tables, and TPC-DS Q95
# ---------------------------------------------------------------------------

W1_SQL = (
    "select count(*), sum(o_totalprice) from (select o_custkey, o_totalprice, "
    "row_number() over (partition by o_custkey order by o_totalprice desc, o_orderkey) rn "
    "from orders) t where rn <= 3"
)
W2_SQL = (
    "select o_orderpriority, max(rs) from (select o_orderpriority, sum(o_totalprice) over "
    "(partition by o_orderpriority order by o_orderdate, o_orderkey rows between unbounded "
    "preceding and current row) rs from orders) t group by o_orderpriority "
    "order by o_orderpriority"
)
W3_SQL = (
    "select count(*) from (select o_custkey, o_orderdate, lag(o_orderdate) over "
    "(partition by o_custkey order by o_orderdate, o_orderkey) prev from orders) t "
    "where prev is not null and datediff(o_orderdate, prev) < 30"
)
W4_SQL = (
    "select l_suppkey, sum(l_extendedprice) rev, sum(l_extendedprice) * 100 / "
    "sum(sum(l_extendedprice)) over () pct, rank() over (order by sum(l_extendedprice) desc) rk "
    "from lineitem where l_shipdate >= date '1995-01-01' and l_shipdate < date '1995-04-01' "
    "group by l_suppkey order by rk, l_suppkey limit 10"
)
W5_SQL = (
    "select o_orderpriority, count(*), avg(o_totalprice) from (select o_orderpriority, "
    "o_totalprice, ntile(4) over (partition by o_orderpriority order by o_totalprice, "
    "o_orderkey) q, cume_dist() over (partition by o_orderpriority order by o_totalprice) cd "
    "from orders) t where q = 4 group by o_orderpriority order by o_orderpriority"
)
U1_SQL = (
    "select k, count(*), sum(v) from (select l_suppkey k, l_extendedprice v from lineitem "
    "where l_shipdate < date '1993-01-01' union all select ps_suppkey k, ps_supplycost v "
    "from partsupp) u group by k order by 3 desc, k limit 10"
)
U2_SQL = (
    "select count(*) from (select o_custkey from orders where o_orderdate < date '1995-01-01' "
    "union select c_custkey from customer where c_acctbal > 9000) u"
)
U3_SQL = (
    "select count(*) from (select o_custkey from orders where o_orderdate < date '1995-01-01' "
    "except select c_custkey from customer where c_mktsegment = 'BUILDING') t"
)


def _run_pos(sorted_keys) -> np.ndarray:
    """Each row's position within its run of equal `sorted_keys` (a tuple
    of arrays in the rows' sorted order)."""
    n = len(sorted_keys[0])
    change = np.zeros(n, dtype=bool)
    if n:
        change[0] = True
    for k in sorted_keys:
        change[1:] |= k[1:] != k[:-1]
    idx = np.arange(n)
    return idx - np.maximum.accumulate(np.where(change, idx, 0))


def _priority_rows(o, per_code):
    """(o_orderpriority, value) per priority code present, in ORDER BY
    o_orderpriority order (dictionary codes are in string order)."""
    d = o["o_orderpriority"].dictionary
    return [(str(d[c]), v) for c, v in per_code]


def numpy_w1(cat, n: int = 3):
    o = _cols(cat, "orders")
    cust, price, key = o["o_custkey"].data, o["o_totalprice"].data, o["o_orderkey"].data
    order = np.lexsort((key, -price, cust))
    top = order[_run_pos((cust[order],)) < n]
    if len(top) == 0:
        return [(0, None)]
    return [(len(top), int(price[top].sum()) / 100)]


def numpy_w2(cat):
    o = _cols(cat, "orders")
    pr, price = o["o_orderpriority"].data, o["o_totalprice"].data
    order = np.lexsort((o["o_orderkey"].data, o["o_orderdate"].data, pr))
    p, c = pr[order], np.cumsum(price[order])
    start = np.flatnonzero(np.r_[True, p[1:] != p[:-1]]) if len(p) else np.zeros(0, np.int64)
    base = np.r_[0, c][start]
    rows = []
    for i, s in enumerate(start):
        e = start[i + 1] if i + 1 < len(start) else len(p)
        rows.append((int(p[s]), int((c[s:e] - base[i]).max()) / 100))
    return _priority_rows(o, rows)


def numpy_w3(cat, days: int = 30):
    o = _cols(cat, "orders")
    cust, date = o["o_custkey"].data, o["o_orderdate"].data.astype(np.int64)
    order = np.lexsort((o["o_orderkey"].data, date, cust))
    c, d = cust[order], date[order]
    ok = (c[1:] == c[:-1]) & (d[1:] - d[:-1] < days)
    return [(int(ok.sum()),)]


def numpy_w4(cat, d0: str = "1995-01-01", d1: str = "1995-04-01"):
    li = _cols(cat, "lineitem")
    ship = li["l_shipdate"].data
    idx = np.flatnonzero((ship >= _days(d0)) & (ship < _days(d1)))
    keys, inv = np.unique(li["l_suppkey"].data[idx], return_inverse=True)
    rev = _sums(inv, li["l_extendedprice"].data[idx], len(keys))
    total = np.float64(int(rev.sum())) / 100
    # rank: one more than the groups with a larger sum
    rank = len(rev) - np.searchsorted(np.sort(rev), rev, side="right") + 1
    order = np.lexsort((keys, rank))
    return [
        (int(keys[i]), int(rev[i]) / 100, (np.float64(int(rev[i]) * 100) / 100) / total,
         int(rank[i]))
        for i in order
    ]


def numpy_w5(cat, buckets: int = 4):
    o = _cols(cat, "orders")
    pr, price = o["o_orderpriority"].data, o["o_totalprice"].data
    order = np.lexsort((o["o_orderkey"].data, price, pr))
    p = pr[order]
    pos = _run_pos((p,))
    nrows = np.bincount(p, minlength=int(p.max(initial=0)) + 1)[p]
    # MySQL NTILE: the first (rows % n) buckets get one extra row
    base, rem = nrows // buckets, nrows % buckets
    big = rem * (base + 1)
    bucket = np.where(pos < big, pos // np.maximum(base + 1, 1),
                      rem + (pos - big) // np.maximum(base, 1)) + 1
    last = order[bucket == buckets]
    rows = []
    for code in np.unique(pr[last]):
        m = last[pr[last] == code]
        s, cnt = int(price[m].sum()), len(m)
        rows.append((int(code), (cnt, np.float64(s) / (np.float64(cnt) * 100))))
    return [(name, *v) for name, v in _priority_rows(o, rows)]


def numpy_u1(cat, d: str = "1993-01-01"):
    li, ps = _cols(cat, "lineitem"), _cols(cat, "partsupp")
    m = li["l_shipdate"].data < _days(d)
    k = np.concatenate([li["l_suppkey"].data[m], ps["ps_suppkey"].data])
    v = np.concatenate([li["l_extendedprice"].data[m], ps["ps_supplycost"].data])
    keys, inv = np.unique(k, return_inverse=True)
    sums = _sums(inv, v, len(keys))
    cnt = np.bincount(inv, minlength=len(keys))
    order = np.lexsort((keys, -sums))
    return [(int(keys[i]), int(cnt[i]), int(sums[i]) / 100) for i in order]


def _early_custs(cat, d: str = "1995-01-01"):
    o = _cols(cat, "orders")
    return np.unique(o["o_custkey"].data[o["o_orderdate"].data < _days(d)])


def numpy_u2(cat, acctbal: int = 900000):
    c = _cols(cat, "customer")
    rich = c["c_custkey"].data[c["c_acctbal"].data > acctbal]
    return [(len(np.union1d(_early_custs(cat), rich)),)]


def numpy_u3(cat, segment: str = "BUILDING"):
    c = _cols(cat, "customer")
    seg = c["c_custkey"].data[c["c_mktsegment"].data == _code(c["c_mktsegment"], segment)]
    return [(len(np.setdiff1d(_early_custs(cat), seg)),)]


#: the chip run's window and set-operation reports over TPC-H, with the
#: table whose rows each one's rows/s counts
REPORT_QUERIES: Dict[str, TpchQuery] = {
    "w1": TpchQuery(W1_SQL, numpy_w1),
    "w2": TpchQuery(W2_SQL, numpy_w2, (0,)),
    "w3": TpchQuery(W3_SQL, numpy_w3),
    "w4": TpchQuery(W4_SQL, numpy_w4, (3, 0), 10),
    "w5": TpchQuery(W5_SQL, numpy_w5, (0,)),
    "u1": TpchQuery(U1_SQL, numpy_u1, (2, 0), 10),
    "u2": TpchQuery(U2_SQL, numpy_u2),
    "u3": TpchQuery(U3_SQL, numpy_u3),
}
REPORT_BASE_TABLE = {"w1": "orders", "w2": "orders", "w3": "orders", "w4": "lineitem",
                     "w5": "orders", "u1": "lineitem", "u2": "orders", "u3": "orders"}

#: R1, a late-receipt report: every line item received late in one week,
#: worst first (a full ORDER BY over lineitem x orders, no aggregate, no
#: LIMIT)
R1_SQL = (
    "select l_orderkey, l_suppkey, o_orderdate, l_receiptdate, "
    "datediff(l_receiptdate, l_commitdate) as delay "
    "from lineitem, orders "
    "where o_orderkey = l_orderkey "
    "and l_receiptdate between date '1995-03-01' and date '1995-03-07' "
    "and l_receiptdate > l_commitdate "
    "order by delay desc, l_orderkey"
)


def numpy_r1(cat, d0: str = "1995-03-01", d1: str = "1995-03-07"):
    li, orders = _cols(cat, "lineitem"), _cols(cat, "orders")
    rd, cd = li["l_receiptdate"].data, li["l_commitdate"].data
    rows = np.flatnonzero((rd >= _days(d0)) & (rd <= _days(d1)) & (rd > cd))
    lk = li["l_orderkey"].data[rows]
    odate = _at(_lookup(orders["o_orderkey"].data, orders["o_orderdate"].data, -1), lk, -1)
    keep = odate >= 0
    rows, lk, odate = rows[keep], lk[keep], odate[keep]
    delay = rd[rows].astype(np.int64) - cd[rows]
    order = np.lexsort((lk, -delay))
    return list(zip(lk[order].tolist(), li["l_suppkey"].data[rows][order].tolist(),
                    _dates(odate[order]), _dates(rd[rows][order]), delay[order].tolist()))


#: the spill phase's reports over the TPC-H SF100 tables, beside the
#: TPC-H queries it runs
SPILL_REPORTS: Dict[str, TpchQuery] = {
    "r1": TpchQuery(R1_SQL, numpy_r1, (4, 0)),
}


# -- B1-B9: one everyday BI report per family of builtins ----------------

B1_SQL = (
    "select date_format(l_shipdate, '%Y-%m') as ym, lower(l_shipmode) as m, "
    "round(sum(l_extendedprice * (1 - l_discount)), 2) as rev, count(*) as n "
    "from lineitem where l_shipdate >= date '1995-01-01' group by ym, m order by ym, m"
)
B2_SQL = (
    "select upper(left(c_mktsegment, 3)) as seg, concat('+', substring_index(c_phone, '-', 1)) "
    "as cc, count(*) as n, round(avg(c_acctbal), 2) as bal, max(char_length(c_name)) as ln "
    "from customer group by seg, cc order by seg, cc"
)
B3_SQL = (
    "select year(o_orderdate) as y, week(o_orderdate) as wk, dayname(o_orderdate) as dn, "
    "count(*) as n, round(sum(abs(o_totalprice - 150000)), 2) as dev from orders "
    "where o_orderdate >= date '1996-01-01' and o_orderdate < date '1997-01-01' "
    "group by y, wk, dn order by y, wk, dn"
)
B4_SQL = (
    "select l_returnflag, least(greatest(timestampdiff(day, l_commitdate, l_receiptdate), -30), "
    "30) as late, count(*) as n, round(sum(coalesce(nullif(l_discount, 0), 0.01) * "
    "l_extendedprice), 2) as v from lineitem group by l_returnflag, late "
    "order by l_returnflag, late"
)
B5_SQL = (
    "select floor(p_retailprice / 100) as band, trim(lower(p_brand)) as b, "
    "ceil(avg(p_size)) as sz, truncate(max(p_retailprice), -1) as hi, "
    "sqrt(sum(p_size * p_size)) as rms, count(*) as n from part group by band, b "
    "order by band, b"
)
B6_SQL = (
    "select o_orderkey, monthname(o_orderdate) as mn, last_day(o_orderdate) as ld, "
    "group_concat(l_shipmode order by l_linenumber separator ',') as modes, count(*) as n "
    "from orders join lineitem on l_orderkey = o_orderkey "
    "where o_orderdate = date '1995-03-15' group by o_orderkey, mn, ld order by o_orderkey"
)
B7_SQL = (
    "select r_name, group_concat(n_name order by n_name separator ', ') as nations, count(*) "
    "from nation join region on n_regionkey = r_regionkey group by r_name order by r_name"
)
B8_SQL = (
    "select replace(o_orderpriority, '-', ' ') as p, locate('URGENT', o_orderpriority) as u, "
    "lpad(o_orderstatus, 3, '*') as st, concat_ws('/', o_orderstatus, o_orderpriority) as k, "
    "count(*) from orders group by p, u, st, k order by p, st"
)
B9_SQL = (
    "select (case when c_custkey % 2 = 0 then lower(c_mktsegment) else c_mktsegment end) "
    "collate utf8mb4_general_ci as s, count(*) as n, round(sum(c_acctbal), 2) as bal "
    "from customer group by s order by s"
)


class Tie:
    """Either of two values: the ROUND of a DOUBLE sum whose exact value
    lies within the comparison's 1e-12 relative tolerance of a rounding
    boundary, where float summation can land on either side (the port and
    the JAX package sum in different orders). ``same_value`` accepts
    either option; use it in ORDER BY results with unique keys."""

    def __init__(self, *options):
        self.options = options

    def __repr__(self) -> str:
        return "Tie" + repr(self.options)


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """The engine's ROUND of a DOUBLE to 0 places, as float64."""
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def _round2(x: np.ndarray) -> list:
    """ROUND(x, 2) of DOUBLEs as the engine computes it (x * 100, half away
    from zero, divided by 100)."""
    return (_round_half_away(np.asarray(x, np.float64) * 100.0) / 100.0).tolist()


def _dict_map(col, fn):
    """(codes of fn over the column's dictionary, sorted distinct outputs):
    fn runs once per dictionary entry."""
    out = np.array([fn(s) for s in col.dictionary.tolist()], dtype=object)
    uniq, code = np.unique(out, return_inverse=True)
    return code.astype(np.int64)[col.data], uniq


def _dense(keys_sizes):
    """Mixed-radix group index of integer keys each in [0, size)."""
    idx = np.zeros(len(keys_sizes[0][0]), dtype=np.int64)
    for k, size in keys_sizes:
        idx = idx * size + k
    return idx


def _month_names(days: np.ndarray) -> np.ndarray:
    return np.asarray(days).astype("datetime64[D]").astype("datetime64[M]").astype(np.int64) % 12


def numpy_b1(cat):
    li = _cols(cat, "lineitem")
    m = li["l_shipdate"].data >= _days("1995-01-01")
    month = li["l_shipdate"].data[m].astype("datetime64[D]").astype("datetime64[M]").astype(np.int64)
    mode, modes = _dict_map(li["l_shipmode"], str.lower)
    m0 = int(month.min(initial=0))
    nm = int(month.max(initial=m0)) - m0 + 1
    key = _dense([(month - m0, nm), (mode[m], len(modes))])
    n = nm * len(modes)
    v = li["l_extendedprice"].data[m] * (100 - li["l_discount"].data[m])  # scale 4
    rev, cnt = exact_bincount(key, v, n), np.bincount(key, minlength=n)
    g = np.flatnonzero(cnt)
    ym = np.datetime_as_string((g // len(modes) + m0).astype("datetime64[M]"), unit="M")
    return list(zip(ym.tolist(), modes[g % len(modes)].tolist(),
                    _dec((rev[g] + 50) // 100, 2), cnt[g].tolist()))


def numpy_b2(cat):
    c = _cols(cat, "customer")
    seg, segs = _dict_map(c["c_mktsegment"], lambda s: s[:3].upper())
    cc, ccs = _dict_map(c["c_phone"], lambda s: "+" + s.split("-")[0])
    key = _dense([(seg, len(segs)), (cc, len(ccs))])
    n = len(segs) * len(ccs)
    cnt = np.bincount(key, minlength=n)
    bal = exact_bincount(key, c["c_acctbal"].data, n)
    lens = np.array([len(s) for s in c["c_name"].dictionary.tolist()], np.int64)[c["c_name"].data]
    ln = np.zeros(n, np.int64)
    np.maximum.at(ln, key, lens)
    g = np.flatnonzero(cnt)
    avg = bal[g].astype(np.float64) / (cnt[g].astype(np.float64) * 100)
    return list(zip(segs[g // len(ccs)].tolist(), ccs[g % len(ccs)].tolist(), cnt[g].tolist(),
                    _round2(avg), ln[g].tolist()))


_DAYNAMES = np.array(["Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday",
                      "Sunday"], dtype=object)


def _week0(days: np.ndarray) -> np.ndarray:
    """MySQL WEEK(d) (mode 0): weeks start on Sunday, days before the
    year's first Sunday are week 0."""
    jan1 = days.astype("datetime64[D]").astype("datetime64[Y]").astype("datetime64[D]").astype(
        np.int64)
    first_sunday = jan1 + (7 - (jan1 + 4) % 7) % 7
    return np.where(days < first_sunday, 0, (days - first_sunday) // 7 + 1)


def numpy_b3(cat):
    o = _cols(cat, "orders")
    d = o["o_orderdate"].data.astype(np.int64)
    m = (d >= _days("1996-01-01")) & (d < _days("1997-01-01"))
    d = d[m]
    y = _year(d)
    wk = _week0(d)
    dn_sorted = np.sort(_DAYNAMES)
    dn = np.searchsorted(dn_sorted, _DAYNAMES[(d + 3) % 7])
    y0 = int(y.min(initial=0))
    ny = int(y.max(initial=y0)) - y0 + 1
    key = _dense([(y - y0, ny), (wk, 54), (dn, 7)])
    n = ny * 54 * 7
    cnt = np.bincount(key, minlength=n)
    dev = exact_bincount(key, np.abs(o["o_totalprice"].data[m] - 15_000_000), n)
    g = np.flatnonzero(cnt)
    return list(zip((g // (54 * 7) + y0).tolist(), (g // 7 % 54).tolist(),
                    dn_sorted[g % 7].tolist(), cnt[g].tolist(), _dec(dev[g], 2)))


def numpy_b4(cat):
    """The v column is ROUND(DOUBLE sum, 2): exact where the exact sum (in
    integers, scale 4) is away from a half cent, a ``Tie`` of both
    neighbours where it lies within 1e-12 relative of one."""
    li = _cols(cat, "lineitem")
    late = np.clip(li["l_receiptdate"].data.astype(np.int64) - li["l_commitdate"].data, -30, 30)
    rf = li["l_returnflag"]
    key = _dense([(rf.data.astype(np.int64), len(rf.dictionary)), (late + 30, 61)])
    n = len(rf.dictionary) * 61
    cnt = np.bincount(key, minlength=n)
    disc = li["l_discount"].data
    s4 = exact_bincount(key, np.where(disc != 0, disc, 1) * li["l_extendedprice"].data, n)
    g = np.flatnonzero(cnt)
    rows = []
    for gi, c in zip(g.tolist(), cnt[g].tolist()):
        s = int(s4[gi])
        lo, rem = divmod(s, 100)  # floor cents, and the rest at scale 4
        if abs(rem - 50) <= 1e-12 * abs(s):
            v = Tie(lo / 100, (lo + 1) / 100)
        else:
            v = (lo + (rem > 50)) / 100
        rows.append((rf.dictionary[gi // 61], gi % 61 - 30, c, v))
    return rows


def numpy_b5(cat):
    p = _cols(cat, "part")
    price, size = p["p_retailprice"].data, p["p_size"].data.astype(np.int64)
    band = np.floor((price / 100.0) / 100.0).astype(np.int64)
    b, bs = _dict_map(p["p_brand"], lambda s: s.lower().strip())
    b0 = int(band.min(initial=0))
    nb = int(band.max(initial=b0)) - b0 + 1
    key = _dense([(band - b0, nb), (b, len(bs))])
    n = nb * len(bs)
    cnt = np.bincount(key, minlength=n)
    ssum, sq = exact_bincount(key, size, n), exact_bincount(key, size * size, n)
    hi = np.full(n, np.iinfo(np.int64).min, np.int64)
    np.maximum.at(hi, key, price)
    g = np.flatnonzero(cnt)
    avg = ssum[g].astype(np.float64) / cnt[g].astype(np.float64)
    trunc = np.sign(hi[g]) * (np.abs(hi[g]) // 1000) * 10  # TRUNCATE(DECIMAL(2), -1)
    return list(zip((g // len(bs) + b0).tolist(), bs[g % len(bs)].tolist(),
                    np.ceil(avg).astype(np.int64).tolist(), trunc.tolist(),
                    np.sqrt(sq[g].astype(np.float64)).tolist(), cnt[g].tolist()))


_MONTHS = ["January", "February", "March", "April", "May", "June", "July", "August",
           "September", "October", "November", "December"]


def numpy_b6(cat, day: str = "1995-03-15"):
    o, li = _cols(cat, "orders"), _cols(cat, "lineitem")
    keys = np.sort(o["o_orderkey"].data[o["o_orderdate"].data == _days(day)])
    rows = np.flatnonzero(np.isin(li["l_orderkey"].data, keys))
    lk = li["l_orderkey"].data[rows]
    order = np.lexsort((li["l_linenumber"].data[rows], lk))
    rows, lk = rows[order], lk[order]
    modes = li["l_shipmode"].dictionary[li["l_shipmode"].data[rows]]
    starts = np.flatnonzero(np.r_[True, lk[1:] != lk[:-1]]) if len(lk) else np.zeros(0, np.int64)
    ends = np.r_[starts[1:], len(lk)]
    d = np.datetime64(day, "D")
    last = (d.astype("datetime64[M]") + 1).astype("datetime64[D]") - 1
    mn, ld = _MONTHS[int(_month_names(np.array([_days(day)]))[0])], str(last)
    return [(int(lk[a]), mn, ld, ",".join(modes[a:z].tolist()), int(z - a))
            for a, z in zip(starts.tolist(), ends.tolist())]


def numpy_b7(cat):
    n, r = _cols(cat, "nation"), _cols(cat, "region")
    rname = _lookup(r["r_regionkey"].data, r["r_name"].data, -1)
    names = n["n_name"].dictionary[n["n_name"].data]
    regions = r["r_name"].dictionary[rname[n["n_regionkey"].data]]
    out = []
    for reg in sorted(set(regions.tolist())):
        members = sorted(names[regions == reg].tolist())
        out.append((reg, ", ".join(members), len(members)))
    return out


def numpy_b8(cat):
    o = _cols(cat, "orders")
    pr, st = o["o_orderpriority"], o["o_orderstatus"]
    key = _dense([(pr.data.astype(np.int64), len(pr.dictionary)),
                  (st.data.astype(np.int64), len(st.dictionary))])
    cnt = np.bincount(key, minlength=len(pr.dictionary) * len(st.dictionary))
    rows = []
    for gi in np.flatnonzero(cnt).tolist():
        p, s = pr.dictionary[gi // len(st.dictionary)], st.dictionary[gi % len(st.dictionary)]
        rows.append((p.replace("-", " "), p.find("URGENT") + 1, s.rjust(3, "*")[:3], f"{s}/{p}",
                     int(cnt[gi])))
    rows.sort(key=lambda r: (r[0], r[2]))
    return rows


def numpy_b9(cat):
    """The CI-collated CASE groups by its lower-cased value (the planner
    folds the collation into LOWER in both packages)."""
    c = _cols(cat, "customer")
    seg, segs = _dict_map(c["c_mktsegment"], str.lower)
    cnt = np.bincount(seg, minlength=len(segs))
    bal = exact_bincount(seg, c["c_acctbal"].data, len(segs))
    g = np.flatnonzero(cnt)
    return list(zip(segs[g].tolist(), cnt[g].tolist(), _dec(bal[g], 2)))


#: B1-B9, the builtins phase's reports over the TPC-H tables: one everyday
#: BI report per family of builtins (dates, strings, weeks, lateness,
#: price bands, GROUP_CONCAT twice, relabelled priorities, a CI collation)
BUILTIN_REPORTS: Dict[str, TpchQuery] = {
    "b1": TpchQuery(B1_SQL, numpy_b1, (0, 1)),
    "b2": TpchQuery(B2_SQL, numpy_b2, (0, 1)),
    "b3": TpchQuery(B3_SQL, numpy_b3, (0, 1, 2)),
    "b4": TpchQuery(B4_SQL, numpy_b4, (0, 1)),
    "b5": TpchQuery(B5_SQL, numpy_b5, (0, 1)),
    "b6": TpchQuery(B6_SQL, numpy_b6, (0,)),
    "b7": TpchQuery(B7_SQL, numpy_b7, (0,)),
    "b8": TpchQuery(B8_SQL, numpy_b8, (0, 2)),
    "b9": TpchQuery(B9_SQL, numpy_b9, (0,)),
}
BUILTIN_BASE_TABLE = {"b1": "lineitem", "b2": "customer", "b3": "orders", "b4": "lineitem",
                      "b5": "part", "b6": "lineitem", "b7": "nation", "b8": "orders",
                      "b9": "customer"}


# -- the statements phase: X1-X9 -------------------------------------------

#: X1-X5: TPC-H queries with each LIKE restated as the REGEXP it equals,
#: each checked against the oracle of the query it restates
REGEXP_RESTATED = {
    "x1": ("q2", [("p_type like '%BRASS'", "p_type regexp 'BRASS$'")]),
    "x2": ("q9", [("p_name like '%green%'", "p_name regexp 'green'")]),
    "x3": ("q14", [("p_type like 'PROMO%'", "p_type regexp '^PROMO'")]),
    "x4": ("q16", [("p_type not like 'MEDIUM POLISHED%'", "p_type not regexp '^MEDIUM POLISHED'"),
                   ("s_comment like '%Customer%Complaints%'",
                    "s_comment regexp 'Customer.*Complaints'")]),
    "x5": ("q20", [("p_name like 'forest%'", "p_name regexp '^forest'")]),
}


def _restated(name: str) -> TpchQuery:
    base, repl = REGEXP_RESTATED[name]
    q = TPCH_QUERIES[base]
    sql = q.sql
    for a, b in repl:
        assert a in sql, (name, a)
        sql = sql.replace(a, b)
    return dataclasses.replace(q, sql=sql)


X6_SQL = (
    "select regexp_substr(p_type, '[A-Z]+$') as metal, "
    "regexp_replace(p_container, '^(SM|MED|LG|JUMBO|WRAP) ', '') as container, "
    "count(*) as line_count, sum(l_extendedprice * (1 - l_discount)) as revenue "
    "from lineitem, part where l_partkey = p_partkey "
    "group by metal, container order by metal, container"
)


def numpy_x6(cat):
    """Revenue by a part's metal (the last word of p_type) and container
    kind (p_container without its size word)."""
    li, part = _cols(cat, "lineitem"), _cols(cat, "part")
    metal, metals = _dict_map(part["p_type"], lambda s: s.rsplit(" ", 1)[-1])
    cont, conts = _dict_map(part["p_container"], lambda s: s.split(" ", 1)[1])
    pkey = _lookup(part["p_partkey"].data, metal * len(conts) + cont, -1)
    g = _at(pkey, li["l_partkey"].data, -1)
    keep = g >= 0
    n = len(metals) * len(conts)
    cnt = np.bincount(g[keep], minlength=n)
    rev = exact_bincount(g[keep], _volume(li, keep), n)
    return [(metals[i // len(conts)], conts[i % len(conts)], int(cnt[i]), rev[i] / 10**4)
            for i in np.flatnonzero(cnt).tolist()]


X7_SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
X7_DDL = (
    "create table cust_profile (c_custkey bigint primary key, segment enum("
    + ",".join(f"'{s}'" for s in X7_SEGMENTS)
    + "), flags set('intl','vip'), profile json)"
)
X7_FILL = (
    "insert into cust_profile select c_custkey, c_mktsegment, "
    "case when c_acctbal > 9000 then 'intl,vip' when c_acctbal > 5000 then 'vip' "
    "when c_acctbal < 0 then 'intl' else '' end, "
    "concat('{\"nation\":\"', n_name, '\",\"region\":\"', r_name, '\"}') "
    "from customer, nation, region "
    "where c_nationkey = n_nationkey and n_regionkey = r_regionkey"
)
X7_SQL = (
    "select json_unquote(json_extract(profile, '$.region')) as region, segment, "
    "find_in_set('vip', flags) > 0 as vip, max(json_length(profile)) as doc_fields, "
    "count(*) as order_count, sum(o_totalprice) as total "
    "from orders, cust_profile where o_custkey = c_custkey "
    "group by region, segment, vip order by region, segment, vip"
)
#: writes X7's domains refuse, each with the JAX package's error text
X7_REFUSED = [
    ("insert into cust_profile values (0, 'RETAIL', '', '{}')",
     "invalid ENUM value 'RETAIL' for column segment"),
    ("insert into cust_profile values (0, 'BUILDING', 'vip', '{\"nation\": ')",
     "invalid JSON value for column profile: '{\"nation\": '"),
]


def numpy_x7(cat):
    """Orders by their customer's region, segment and VIP flag (an
    account balance above 5,000), from the TPC-H columns."""
    cust, orders, nat, reg = (_cols(cat, t) for t in ("customer", "orders", "nation", "region"))
    r_name = _lookup(reg["r_regionkey"].data, reg["r_name"].dictionary[reg["r_name"].data]
                     .astype(object), None, dtype=object)
    n_region = _lookup(nat["n_nationkey"].data, nat["n_regionkey"].data, -1)
    region = r_name[n_region[cust["c_nationkey"].data]]
    regions, rcode = np.unique(region.astype(str), return_inverse=True)
    seg = cust["c_mktsegment"]
    vip = (cust["c_acctbal"].data > 500000).astype(np.int64)
    ckey = _dense([(rcode.astype(np.int64), len(regions)),
                   (seg.data.astype(np.int64), len(seg.dictionary)), (vip, 2)])
    per_cust = _lookup(cust["c_custkey"].data, ckey, -1)
    g = _at(per_cust, orders["o_custkey"].data, -1)
    keep = g >= 0
    n = len(regions) * len(seg.dictionary) * 2
    cnt = np.bincount(g[keep], minlength=n)
    tot = exact_bincount(g[keep], orders["o_totalprice"].data[keep], n)
    rows = []
    for i in np.flatnonzero(cnt).tolist():
        r, rest = divmod(i, len(seg.dictionary) * 2)
        s, v = divmod(rest, 2)
        rows.append((str(regions[r]), str(seg.dictionary[s]), bool(v), 2, int(cnt[i]),
                     int(tot[i]) / 100))
    return rows


#: the web access log at TPC-H SF10: orders' 15M rows, 1M IPv4 and 50k
#: IPv6 addresses, 1M session ids (scaled with sf below SF10)
ACCESS_LOG_ROWS_PER_SF = 1_500_000
ACCESS_LOG_IPV4_PER_SF = 100_000
ACCESS_LOG_IPV6_PER_SF = 5_000
ACCESS_LOG_SESSIONS_PER_SF = 100_000
ACCESS_LOG_FROM = "2024-01-01"
ACCESS_LOG_DAYS = 91


def _sorted_codes(values: list, picks: np.ndarray):
    """(sorted dictionary, codes): `picks` index `values`."""
    d = np.array(values, dtype=object)
    order = np.argsort(d, kind="stable")
    rank = np.empty(len(d), dtype=np.int32)
    rank[order] = np.arange(len(d), dtype=np.int32)
    return d[order], rank[picks]


def access_log(sf: float, seed: int = 1) -> dict:
    """A web access log as ``storage.catalog_from_numpy``'s table spec:
    ts DATETIME (uniform over ACCESS_LOG_DAYS days), ip VARCHAR (distinct
    IPv4 addresses in dotted form and IPv6 addresses in their canonical
    text, 1 row in 20 IPv6) and sid VARCHAR (session UUIDs, 1 in 10 in
    upper case), made from `seed` with numpy."""
    import ipaddress

    rng = np.random.default_rng(seed)
    rows = int(ACCESS_LOG_ROWS_PER_SF * sf)
    n4 = max(int(ACCESS_LOG_IPV4_PER_SF * sf), 16)
    n6 = max(int(ACCESS_LOG_IPV6_PER_SF * sf), 4)
    ns = max(int(ACCESS_LOG_SESSIONS_PER_SF * sf), 16)
    v4 = np.unique(rng.integers(0, 1 << 32, int(n4 * 1.1) + 64, dtype=np.int64))
    v4 = rng.permutation(v4)[:n4]
    o = [(v4 >> s) & 255 for s in (24, 16, 8, 0)]
    ips = [f"{a}.{b}.{c}.{d}" for a, b, c, d in zip(*(x.tolist() for x in o))]
    hi = rng.integers(0, 1 << 63, n6, dtype=np.int64).tolist()
    lo = rng.integers(0, 1 << 63, n6, dtype=np.int64).tolist()
    ips += sorted({str(ipaddress.IPv6Address((h << 65) | (l_ << 1) | 1))
                   for h, l_ in zip(hi, lo)})
    n6 = len(ips) - n4
    v6_row = rng.random(rows) < 0.05
    pick = np.where(v6_row, n4 + rng.integers(0, n6, rows), rng.integers(0, n4, rows))
    ip_dict, ip_codes = _sorted_codes(ips, pick)
    raw = rng.integers(0, 256, (ns, 16), dtype=np.uint8)
    hexes = [bytes(r).hex() for r in raw]
    sids = [f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}" for h in hexes]
    sids = [x.upper() if i % 10 == 0 else x for i, x in enumerate(sids)]
    sid_dict, sid_codes = _sorted_codes(sids, rng.integers(0, ns, rows))
    t0 = _days(ACCESS_LOG_FROM) * 86_400_000_000
    ts = t0 + rng.integers(0, ACCESS_LOG_DAYS * 86_400, rows, dtype=np.int64) * 1_000_000
    ones = np.ones(rows, dtype=bool)
    return {
        "columns": [("ts", ("datetime", 0, None)), ("ip", ("string", 0, None)),
                    ("sid", ("string", 0, None))],
        "primary_key": None,
        "data": {"ts": (ts, ones, None), "ip": (ip_codes, ones, ip_dict),
                 "sid": (sid_codes, ones, sid_dict)},
    }


X8_FROM = "2024-02-01 00:00:00"
X8_SQL = (
    "select inet_aton(ip) >> 24 as net, count(*) as hits, "
    "sum(case when is_ipv6(ip) then 1 else 0 end) as v6, "
    "sum(case when bin_to_uuid(uuid_to_bin(sid)) = sid then 1 else 0 end) as sid_ok, "
    "sum(case when uncompressed_length(compress(ip)) = length(ip) then 1 else 0 end) as zip_ok, "
    "sum(case when aes_decrypt(aes_encrypt(ip, 'k'), 'k') = ip then 1 else 0 end) as aes_ok "
    f"from access_log where ts >= '{X8_FROM}' group by net order by net"
)


def numpy_x8(cat):
    """Hits per first octet (IPv6 addresses count under 0, where
    INET_ATON gives 0), the IPv6 hits, and the hits whose session id is
    in lower case (BIN_TO_UUID writes lower case); every address
    survives COMPRESS and AES_ENCRYPT round trips."""
    log_ = _cols(cat, "access_log")
    ip, sid = log_["ip"], log_["sid"]
    m = log_["ts"].data >= (_days(X8_FROM[:10]) * 86_400_000_000)
    is6 = np.array([":" in s for s in ip.dictionary.tolist()] or [False])
    net = np.array([0 if ":" in s else int(s.split(".")[0]) for s in ip.dictionary.tolist()]
                   or [0], dtype=np.int64)
    lower = np.array([s == s.lower() for s in sid.dictionary.tolist()] or [False])
    g = net[ip.data[m]]
    cnt = np.bincount(g, minlength=256)
    v6 = np.bincount(g, weights=is6[ip.data[m]], minlength=256).astype(np.int64)
    ok = np.bincount(g, weights=lower[sid.data[m]], minlength=256).astype(np.int64)
    return [(i, int(cnt[i]), int(v6[i]), int(ok[i]), int(cnt[i]), int(cnt[i]))
            for i in np.flatnonzero(cnt).tolist()]


X9_SQL = (
    "with recursive d(day) as (select date '1995-01-01' from region where r_regionkey = 0 "
    "union all select day + interval 1 day from d where day < date '1995-12-31') "
    "select d.day, count(o_orderkey) as order_count, sum(o_totalprice) as total "
    "from d left join orders on o_orderdate = d.day group by d.day order by d.day"
)


def numpy_x9(cat):
    """Orders and their total per day of 1995, every day present."""
    o = _cols(cat, "orders")
    d0, d1 = _days("1995-01-01"), _days("1995-12-31")
    od = o["o_orderdate"].data.astype(np.int64)
    m = (od >= d0) & (od <= d1)
    n = d1 - d0 + 1
    cnt = np.bincount(od[m] - d0, minlength=n)
    tot = exact_bincount(od[m] - d0, o["o_totalprice"].data[m], n)
    days = _dates(np.arange(d0, d1 + 1))
    return [(days[i], int(cnt[i]), tot[i] / 100 if cnt[i] else None) for i in range(n)]


#: X1-X9, the statements phase's queries (X7's table is made by X7_DDL
#: and X7_FILL, X8's by ``access_log``)
STATEMENT_QUERIES: Dict[str, TpchQuery] = {
    **{n: _restated(n) for n in REGEXP_RESTATED},
    "x6": TpchQuery(X6_SQL, numpy_x6, (0, 1)),
    "x7": TpchQuery(X7_SQL, numpy_x7, (0, 1, 2)),
    "x8": TpchQuery(X8_SQL, numpy_x8, (0,)),
    "x9": TpchQuery(X9_SQL, numpy_x9, (0,)),
}
STATEMENT_BASE_TABLE = {"x1": "partsupp", "x2": "lineitem", "x3": "lineitem", "x4": "partsupp",
                        "x5": "lineitem", "x6": "lineitem", "x7": "orders", "x8": "access_log",
                        "x9": "orders"}


def numpy_q95(cat, db: str = "test"):
    """TPC-DS Q95 over ``tpcds.load_tpcds`` data, vectorized: the same
    answer as the JAX package's row-by-row oracle, (order_count,
    total_shipping_cost, total_net_profit) with the sums rounded to
    cents, or (0, None, None)."""

    def col(table, name):
        (b,) = cat.table(db, table).blocks()
        return b.columns[name]

    order = col("web_sales", "ws_order_number").data.astype(np.int64)
    wh = col("web_sales", "ws_warehouse_sk").data.astype(np.int64)
    n_keys = int(order.max(initial=0)) + 1
    # ws_wh: orders shipping from more than one warehouse
    pairs = np.unique(order * (int(wh.max(initial=0)) + 1) + wh)
    per_order = np.bincount(pairs // (int(wh.max(initial=0)) + 1), minlength=n_keys)
    multi = per_order > 1
    wr = col("web_returns", "wr_order_number").data.astype(np.int64)
    returned = np.zeros(n_keys, dtype=bool)
    returned[wr[(wr >= 0) & (wr < n_keys)]] = True

    def keys_where(table, key, mask):
        return col(table, key).data.astype(np.int64)[mask]

    d_date = col("date_dim", "d_date").data.astype(np.int64)
    lo = int(date_to_days("1999-02-01"))
    ok_dates = keys_where("date_dim", "d_date_sk", (d_date >= lo) & (d_date <= lo + 60))
    state = col("customer_address", "ca_state")
    il = keys_where("customer_address", "ca_address_sk", state.data == _code(state, "IL"))
    company = col("web_site", "web_company_name")
    pri = keys_where("web_site", "web_site_sk", company.data == _code(company, "pri"))

    mask = (
        np.isin(col("web_sales", "ws_ship_date_sk").data, ok_dates)
        & np.isin(col("web_sales", "ws_ship_addr_sk").data, il)
        & np.isin(col("web_sales", "ws_web_site_sk").data, pri)
        & multi[order] & returned[order]
    )
    if not mask.any():
        return (0, None, None)
    cost = col("web_sales", "ws_ext_ship_cost").data.astype(np.int64)
    profit = col("web_sales", "ws_net_profit").data.astype(np.int64)
    return (
        len(np.unique(order[mask])),
        round(float(cost[mask].sum()) / 100, 2),
        round(float(profit[mask].sum()) / 100, 2),
    )


def same_value(a, b, rel: float = 1e-12) -> bool:
    """Exact equality of value and type, except floats within `rel`
    relative."""
    if isinstance(b, Tie):
        return any(same_value(a, o, rel) for o in b.options)
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b or abs(a - b) <= rel * max(abs(a), abs(b))
    return a == b and type(a) is type(b)


def _same_row(g, w, rel) -> bool:
    return len(g) == len(w) and all(same_value(x, y, rel) for x, y in zip(g, w))


def _canon(r):
    """A sort key that lines up equal rows (floats by value)."""
    return (tuple((v is None, str(v)) for v in r if not isinstance(v, float)),
            tuple(v for v in r if isinstance(v, float)))


def _identical(got, want) -> bool:
    """Equal row for row, value for value and type for type."""
    return got == want and all(
        type(x) is type(y) for g, w in zip(got, want) for x, y in zip(g, w)
    )


def _same_multiset(got, want, rel) -> bool:
    if len(got) != len(want):
        return False
    return all(_same_row(g, w, rel) for g, w in zip(sorted(got, key=_canon), sorted(want, key=_canon)))


def check_rows(got, want, order=None, limit=None, rel: float = 1e-12) -> None:
    """Raise AssertionError unless `got` are the rows `want` allows.

    Without ORDER BY (`order` None), the rows are equal as multisets.
    With it, `want` is the oracle's whole result in ORDER BY order (or its
    first `limit` rows and every row tying the last of them): the ORDER
    BY columns of `got` equal `want`'s row for row, the rows of each run
    of equal ORDER BY values are equal as multisets, and where LIMIT cuts
    a run, the rows kept come from that run."""
    got, want = [tuple(r) for r in got], [tuple(r) for r in want]
    if order is None:
        assert _same_multiset(got, want, rel), (got[:5], want[:5])
        return
    n = len(want) if limit is None else min(limit, len(want))
    assert len(got) == n, (len(got), n, got[:3], want[:3])
    if _identical(got, want[:n]):
        return  # every check below holds, checked at C speed (R1's 1M rows)

    def key(r):
        return tuple(r[c] for c in order)

    for i, (g, w) in enumerate(zip(got, want)):
        assert _same_row(key(g), key(w), rel), (i, g, w)
    i = 0
    while i < n:
        j = i
        while j < len(want) and key(want[j]) == key(want[i]):
            j += 1
        run_got, run_want = got[i:min(j, n)], want[i:j]
        if j <= n:
            assert _identical(run_got, run_want) or _same_multiset(run_got, run_want, rel), (
                i, run_got, run_want)
        else:
            pool = list(run_want)
            for g in run_got:
                k = next((x for x, w in enumerate(pool) if _same_row(g, w, rel)), None)
                assert k is not None, (g, run_want)
                pool.pop(k)
        i = j
