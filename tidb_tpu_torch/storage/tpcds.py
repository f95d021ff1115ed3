"""TPC-DS subset for the Q95 eval config (BASELINE.md: "TPC-DS Q95
SF100 — semi-join / correlated subquery, MPP exchange").

Q95 counts web orders shipped from more than one warehouse AND
returned (both IN-subqueries must hold), within a date window and
shipping state. It needs four base
tables (web_sales, web_returns, date_dim, customer_address, web_site)
and exercises exactly the shapes the config names: a self-join
duplicate-detection CTE, two IN-subquery semi-joins over it, and
COUNT(DISTINCT)."""

from __future__ import annotations

import datetime
from typing import Dict

import numpy as np

from tidb_tpu_torch.storage.catalog import Catalog
from tidb_tpu_torch.storage.table import ColumnInfo, TableSchema
from tidb_tpu_torch.types import DATE, INT64, STRING, date_to_days, decimal_type

__all__ = ["load_tpcds_q95", "TPCDS_SCHEMAS", "Q95", "Q95_SQLITE"]

D72 = decimal_type(7, 2)

TPCDS_SCHEMAS = {
    "date_dim": [
        ("d_date_sk", INT64, True),
        ("d_date", DATE, True),
    ],
    "customer_address": [
        ("ca_address_sk", INT64, True),
        ("ca_state", STRING, True),
    ],
    "web_site": [
        ("web_site_sk", INT64, True),
        ("web_company_name", STRING, True),
    ],
    "web_sales": [
        ("ws_order_number", INT64, True),
        ("ws_item_sk", INT64, True),
        ("ws_warehouse_sk", INT64, True),
        ("ws_ship_date_sk", INT64, True),
        ("ws_ship_addr_sk", INT64, True),
        ("ws_web_site_sk", INT64, True),
        ("ws_ext_ship_cost", D72, True),
        ("ws_net_profit", D72, True),
    ],
    "web_returns": [
        ("wr_order_number", INT64, True),
        ("wr_item_sk", INT64, True),
    ],
}

_STATES = ["CA", "GA", "IL", "NY", "TX"]


def load_tpcds_q95(catalog: Catalog, sf: float = 0.01, db: str = "test",
                   seed: int = 13) -> Dict[str, int]:
    rng = np.random.default_rng(seed)
    counts = {}

    def make_table(name, pk=None):
        cols = [ColumnInfo(n, t, not_null=nn) for n, t, nn in TPCDS_SCHEMAS[name]]
        return catalog.create_table(db, TableSchema(name, cols, primary_key=pk))

    first = datetime.date(1999, 1, 1)
    ndates = 730
    t = make_table("date_dim", ["d_date_sk"])
    counts["date_dim"] = t.insert_columns({
        "d_date_sk": np.arange(1, ndates + 1),
        "d_date": np.array(
            [date_to_days(first + datetime.timedelta(days=i)) for i in range(ndates)],
            dtype=np.int32),
    })

    naddr = max(5, int(1000 * sf))
    t = make_table("customer_address", ["ca_address_sk"])
    counts["customer_address"] = t.insert_columns(
        {"ca_address_sk": np.arange(1, naddr + 1)},
        strings={"ca_state": [_STATES[i] for i in rng.integers(0, 5, naddr)]},
    )

    t = make_table("web_site", ["web_site_sk"])
    counts["web_site"] = t.insert_columns(
        {"web_site_sk": np.arange(1, 7)},
        strings={"web_company_name": ["pri", "pri", "ally", "ought", "eing", "able"]},
    )

    # web_sales: multiple line items per order; 30% of MULTI-LINE orders
    # ship from two warehouses (single-line orders can't — the ws_wh
    # self-join needs two rows), so ~22% of all orders qualify
    norders = max(10, int(60_000 * sf))
    lines = rng.integers(1, 5, norders)
    n = int(lines.sum())
    okey = np.repeat(np.arange(1, norders + 1), lines)
    two_wh = (rng.random(norders) < 0.3) & (lines >= 2)
    wh_base = rng.integers(1, 6, norders)
    # first line of a two-warehouse order ships from a second warehouse
    wh = np.repeat(wh_base, lines)
    firsts = np.cumsum(np.concatenate([[0], lines[:-1]]))
    wh[firsts[two_wh]] = (wh_base[two_wh] % 5) + 1 + 5
    t = make_table("web_sales")
    counts["web_sales"] = t.insert_columns({
        "ws_order_number": okey,
        "ws_item_sk": rng.integers(1, 1000, n),
        "ws_warehouse_sk": wh,
        "ws_ship_date_sk": np.repeat(rng.integers(1, ndates + 1, norders), lines),
        "ws_ship_addr_sk": np.repeat(rng.integers(1, naddr + 1, norders), lines),
        "ws_web_site_sk": np.repeat(rng.integers(1, 7, norders), lines),
        "ws_ext_ship_cost": rng.integers(100, 100_00, n),
        "ws_net_profit": rng.integers(-50_00, 200_00, n),
    })

    # a quarter of orders returned (high vs the spec's ~8% so the full
    # filter chain keeps survivors at test scale factors)
    returned = np.nonzero(rng.random(norders) < 0.25)[0] + 1
    t = make_table("web_returns")
    counts["web_returns"] = t.insert_columns({
        "wr_order_number": returned,
        "wr_item_sk": rng.integers(1, 1000, len(returned)),
    })
    return counts


# the official Q95 shape (60-day window, one state, one company) ------------
Q95 = """with ws_wh as (
    select ws1.ws_order_number as wswh_order_number
    from web_sales ws1, web_sales ws2
    where ws1.ws_order_number = ws2.ws_order_number
      and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk
)
select count(distinct ws_order_number) as order_count,
       sum(ws_ext_ship_cost) as total_shipping_cost,
       sum(ws_net_profit) as total_net_profit
from web_sales ws1, date_dim, customer_address, web_site
where d_date between date '1999-02-01' and date '1999-04-02'
  and ws1.ws_ship_date_sk = d_date_sk
  and ws1.ws_ship_addr_sk = ca_address_sk and ca_state = 'IL'
  and ws1.ws_web_site_sk = web_site_sk and web_company_name = 'pri'
  and ws1.ws_order_number in (select wswh_order_number from ws_wh)
  and ws1.ws_order_number in (select wr_order_number
                              from web_returns, ws_wh
                              where wr_order_number = wswh_order_number)
order by order_count"""

# sqlite mirror variant: sqlite has no DATE '...' literal syntax; the
# mirror stores dates as ISO text, which compares correctly as strings
Q95_SQLITE = Q95.replace("date '1999-02-01'", "'1999-02-01'").replace(
    "date '1999-04-02'", "'1999-04-02'")
