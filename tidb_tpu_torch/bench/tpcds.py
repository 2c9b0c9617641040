"""TPC-DS subset: the tables Q95 reads, a synthetic generator and Q95.

Counterpart of tidb_tpu/bench/tpcds.py (BASELINE config #5: TPC-DS Q95,
a self-join CTE, two IN subqueries, COUNT(DISTINCT), a date window and a
four-way join over web_sales, web_returns, date_dim, customer_address
and web_site). For one seed, ``load_tpcds`` makes the same tables as the
JAX package's: the same draws from the same generator, in the same
order. String columns are encoded with ``np.unique`` rather than a
Python loop (5M addresses at SF100); the dictionary and codes are the
same. The oracle is ``oracles.numpy_q95``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from tidb_tpu_torch.chunk import HostBlock, HostColumn
from tidb_tpu_torch.dtypes import DATE, DECIMAL, INT64, STRING, date_to_days
from tidb_tpu_torch.storage import Catalog, TableSchema

_STATES = ["IL", "CA", "TX", "NY", "WA", "GA", "OH", "MI"]
_COMPANIES = ["pri", "ese", "anti", "ought", "able", "cally"]


def _col_i(vals):
    a = np.asarray(vals, dtype=np.int64)
    return HostColumn(INT64, a, np.ones(len(a), dtype=bool))


def _col_dec(vals, scale=2):
    a = np.round(np.asarray(vals, dtype=np.float64) * 10**scale).astype(np.int64)
    return HostColumn(DECIMAL(scale), a, np.ones(len(a), dtype=bool))


def _col_s(vals):
    """A STRING column: sorted distinct values as the dictionary."""
    uni, codes = np.unique(np.asarray(vals).astype(str), return_inverse=True)
    return HostColumn(
        STRING, codes.astype(np.int32), np.ones(len(codes), dtype=bool),
        np.array(uni.tolist(), dtype=object),
    )


def _col_d(days):
    a = np.asarray(days, dtype=np.int32)
    return HostColumn(DATE, a, np.ones(len(a), dtype=bool))


def load_tpcds(catalog: Catalog, sf: float = 0.01, seed: int = 7, db: str = "test") -> Dict[str, int]:
    """Populate the Q95 table subset at roughly `sf` scale (web_sales
    ~ 72k rows/sf). Returns per-table row counts."""
    rng = np.random.default_rng(seed)
    n_sales = max(int(72_000 * sf), 500)
    n_orders = max(n_sales // 3, 50)  # ~3 line items per order
    n_addr = max(int(1000 * sf * 50), 100)
    n_sites = 12
    n_dates = 400  # covers 1999 H1 + slack
    d0 = int(date_to_days("1999-01-01"))

    catalog.create_database(db, if_not_exists=True)
    counts = {}

    def put(name, schema_cols, cols, pk=None):
        t = catalog.create_table(db, name, TableSchema(schema_cols, primary_key=pk))
        t.dictionaries.update(
            {n: c.dictionary for n, c in cols.items() if c.dictionary is not None}
        )
        t.replace_blocks([HostBlock.from_columns(cols)])
        counts[name] = t.nrows

    # date_dim: d_date_sk is days since a base; d_date the DATE value
    put(
        "date_dim",
        [("d_date_sk", INT64), ("d_date", DATE)],
        {
            "d_date_sk": _col_i(np.arange(n_dates) + 1000),
            "d_date": _col_d(d0 - 30 + np.arange(n_dates)),
        },
        pk=["d_date_sk"],
    )

    put(
        "customer_address",
        [("ca_address_sk", INT64), ("ca_state", STRING)],
        {
            "ca_address_sk": _col_i(np.arange(n_addr)),
            "ca_state": _col_s(rng.choice(_STATES, n_addr)),
        },
        pk=["ca_address_sk"],
    )

    put(
        "web_site",
        [("web_site_sk", INT64), ("web_company_name", STRING)],
        {
            "web_site_sk": _col_i(np.arange(n_sites)),
            "web_company_name": _col_s(
                [_COMPANIES[i % len(_COMPANIES)] for i in range(n_sites)]
            ),
        },
        pk=["web_site_sk"],
    )

    order_no = rng.integers(0, n_orders, n_sales)
    # most orders ship from one warehouse; ~25% of rows get a second
    wh_of_order = rng.integers(0, 5, n_orders)
    warehouse = wh_of_order[order_no].copy()
    multi = rng.random(n_sales) < 0.25
    warehouse[multi] = (warehouse[multi] + 1 + rng.integers(0, 3, multi.sum())) % 6
    put(
        "web_sales",
        [
            ("ws_order_number", INT64), ("ws_warehouse_sk", INT64),
            ("ws_ship_date_sk", INT64), ("ws_ship_addr_sk", INT64),
            ("ws_web_site_sk", INT64), ("ws_ext_ship_cost", DECIMAL(2)),
            ("ws_net_profit", DECIMAL(2)),
        ],
        {
            "ws_order_number": _col_i(order_no),
            "ws_warehouse_sk": _col_i(warehouse),
            "ws_ship_date_sk": _col_i(rng.integers(1000, 1000 + n_dates, n_sales)),
            "ws_ship_addr_sk": _col_i(rng.integers(0, n_addr, n_sales)),
            "ws_web_site_sk": _col_i(rng.integers(0, n_sites, n_sales)),
            "ws_ext_ship_cost": _col_dec(rng.uniform(1, 200, n_sales)),
            "ws_net_profit": _col_dec(rng.uniform(-100, 300, n_sales)),
        },
    )

    n_ret = max(n_sales // 6, 30)
    put(
        "web_returns",
        [("wr_order_number", INT64)],
        {"wr_order_number": _col_i(rng.integers(0, n_orders, n_ret))},
    )
    return counts


#: Q95 in this engine's dialect (quoted aliases and `+ N days` replaced
#: with standard forms; otherwise the official query shape: self-join
#: CTE + two IN subqueries + COUNT(DISTINCT) + date window)
Q95_SQL = """
with ws_wh as (
  select ws1.ws_order_number wh1, ws2.ws_warehouse_sk wh2
  from web_sales ws1, web_sales ws2
  where ws1.ws_order_number = ws2.ws_order_number
    and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk
)
select count(distinct ws_order_number) as order_count,
       sum(ws_ext_ship_cost) as total_shipping_cost,
       sum(ws_net_profit) as total_net_profit
from web_sales ws1, date_dim, customer_address, web_site
where d_date between '1999-02-01' and date '1999-02-01' + interval 60 day
  and ws1.ws_ship_date_sk = d_date_sk
  and ws1.ws_ship_addr_sk = ca_address_sk
  and ca_state = 'IL'
  and ws1.ws_web_site_sk = web_site_sk
  and web_company_name = 'pri'
  and ws1.ws_order_number in (select wh1 from ws_wh)
  and ws1.ws_order_number in (
    select wr_order_number from web_returns, ws_wh
    where wr_order_number = wh1
  )
order by order_count
limit 100
"""
