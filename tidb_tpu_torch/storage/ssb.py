"""Star Schema Benchmark: schema, generator, and the 13 queries
(BASELINE.md eval config "SSB Q3.x SF100 — 4-way star hash join").

SSB is TPC-H refactored into one fact table (lineorder) plus four
dimensions (customer, supplier, part, date), specifically to exercise
star joins. The generator follows the official dbgen distributions at
the same order of magnitude (lineorder ~ 6M rows/SF) using the columnar
bulk-ingest path — date dimension is the standard 7-year 1992-1998
calendar."""

from __future__ import annotations

import datetime
from typing import Dict

import numpy as np

from tidb_tpu_torch.storage.catalog import Catalog
from tidb_tpu_torch.storage.table import ColumnInfo, TableSchema
from tidb_tpu_torch.types import DATE, INT64, STRING, date_to_days, decimal_type

__all__ = ["load_ssb", "SSB_SCHEMAS", "SSB_QUERIES"]

D152 = decimal_type(15, 2)

SSB_SCHEMAS = {
    "ssb_date": [
        ("d_datekey", INT64, True),        # yyyymmdd int, the SSB convention
        ("d_date", DATE, True),
        ("d_dayofweek", STRING, True),
        ("d_month", STRING, True),
        ("d_year", INT64, True),
        ("d_yearmonthnum", INT64, True),   # yyyymm
        ("d_yearmonth", STRING, True),     # e.g. Dec1997
        ("d_weeknuminyear", INT64, True),
    ],
    "ssb_customer": [
        ("c_custkey", INT64, True),
        ("c_name", STRING, True),
        ("c_city", STRING, True),
        ("c_nation", STRING, True),
        ("c_region", STRING, True),
        ("c_mktsegment", STRING, True),
    ],
    "ssb_supplier": [
        ("s_suppkey", INT64, True),
        ("s_name", STRING, True),
        ("s_city", STRING, True),
        ("s_nation", STRING, True),
        ("s_region", STRING, True),
    ],
    "ssb_part": [
        ("p_partkey", INT64, True),
        ("p_name", STRING, True),
        ("p_mfgr", STRING, True),
        ("p_category", STRING, True),
        ("p_brand1", STRING, True),
        ("p_color", STRING, True),
    ],
    "lineorder": [
        ("lo_orderkey", INT64, True),
        ("lo_linenumber", INT64, True),
        ("lo_custkey", INT64, True),
        ("lo_partkey", INT64, True),
        ("lo_suppkey", INT64, True),
        ("lo_orderdate", INT64, True),     # d_datekey ref (yyyymmdd)
        ("lo_quantity", INT64, True),
        ("lo_extendedprice", D152, True),
        ("lo_discount", INT64, True),      # whole percent 0..10, SSB style
        ("lo_revenue", D152, True),
        ("lo_supplycost", D152, True),
    ],
}

_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_NATIONS = {  # 5 nations per region, the SSB reduction
    "AFRICA": ["ALGERIA", "ETHIOPIA", "KENYA", "MOROCCO", "MOZAMBIQUE"],
    "AMERICA": ["ARGENTINA", "BRAZIL", "CANADA", "PERU", "UNITED STATES"],
    "ASIA": ["CHINA", "INDIA", "INDONESIA", "JAPAN", "VIETNAM"],
    "EUROPE": ["FRANCE", "GERMANY", "ROMANIA", "RUSSIA", "UNITED KINGDOM"],
    "MIDDLE EAST": ["EGYPT", "IRAN", "IRAQ", "JORDAN", "SAUDI ARABIA"],
}
_MONTHS = ["Jan", "Feb", "Mar", "Apr", "May", "Jun",
           "Jul", "Aug", "Sep", "Oct", "Nov", "Dec"]
_DOW = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
        "Saturday", "Sunday"]
_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
_COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
           "black", "blanched", "blue", "blush", "brown", "burlywood"]


def _nation_region(rng, n):
    """(region, nation, city) triples. A deterministic 80-row prefix
    guarantees coverage at tiny test scale factors: rows 0-49 cover
    every nation once with city digit 1 and once with digit 5, rows
    50-79 are all UNITED KINGDOM with digits 1/5 so the city-specific
    q3.3/q3.4 flights (incl. q3.4's additional one-month date filter)
    keep a non-vacuous result. At real scale factors the prefix is
    noise-level skew."""
    regions = rng.integers(0, 5, n)
    nation_idx = rng.integers(0, 5, n)
    digits = rng.integers(0, 10, n)
    uk_region = _REGIONS.index("EUROPE")
    uk_idx = _NATIONS["EUROPE"].index("UNITED KINGDOM")
    for i in range(min(n, 80)):
        if i < 50:
            regions[i] = (i % 25) // 5
            nation_idx[i] = i % 5
            digits[i] = 1 if i < 25 else 5
        else:
            regions[i] = uk_region
            nation_idx[i] = uk_idx
            digits[i] = 1 if i % 2 else 5
    rnames = [_REGIONS[r] for r in regions]
    nnames = [_NATIONS[_REGIONS[r]][i] for r, i in zip(regions, nation_idx)]
    cities = [f"{nm[:9]:<9}{d}" for nm, d in zip(nnames, digits)]
    return rnames, nnames, cities


def load_ssb(catalog: Catalog, sf: float = 0.01, db: str = "test",
             seed: int = 11) -> Dict[str, int]:
    """Generate and ingest the five SSB tables at scale factor sf."""
    rng = np.random.default_rng(seed)
    counts = {}

    def make_table(name, pk):
        cols = [ColumnInfo(n, t, not_null=nn) for n, t, nn in SSB_SCHEMAS[name]]
        return catalog.create_table(db, TableSchema(name, cols, primary_key=pk))

    # date dimension: fixed 1992-01-01 .. 1998-12-31 -------------------------
    first = datetime.date(1992, 1, 1)
    ndays = (datetime.date(1998, 12, 31) - first).days + 1
    days = [first + datetime.timedelta(days=i) for i in range(ndays)]
    t = make_table("ssb_date", ["d_datekey"])
    counts["ssb_date"] = t.insert_columns(
        {
            "d_datekey": np.array([d.year * 10000 + d.month * 100 + d.day for d in days]),
            "d_date": np.array([date_to_days(d) for d in days], dtype=np.int32),
            "d_year": np.array([d.year for d in days]),
            "d_yearmonthnum": np.array([d.year * 100 + d.month for d in days]),
            "d_weeknuminyear": np.array([d.isocalendar()[1] for d in days]),
        },
        strings={
            "d_dayofweek": [_DOW[d.weekday()] for d in days],
            "d_month": [_MONTHS[d.month - 1] for d in days],
            "d_yearmonth": [f"{_MONTHS[d.month - 1]}{d.year}" for d in days],
        },
    )

    # customer ---------------------------------------------------------------
    # floors keep every region/nation populated at tiny test SFs
    nc = max(80, int(30_000 * sf))
    keys = np.arange(1, nc + 1)
    creg, cnat, ccity = _nation_region(rng, nc)
    t = make_table("ssb_customer", ["c_custkey"])
    counts["ssb_customer"] = t.insert_columns(
        {"c_custkey": keys},
        strings={
            "c_name": [f"Customer#{k:09d}" for k in keys],
            "c_city": ccity, "c_nation": cnat, "c_region": creg,
            "c_mktsegment": [_SEGMENTS[i] for i in rng.integers(0, 5, nc)],
        },
    )

    # supplier ---------------------------------------------------------------
    ns = max(80, int(2_000 * sf))
    keys = np.arange(1, ns + 1)
    sreg, snat, scity = _nation_region(rng, ns)
    t = make_table("ssb_supplier", ["s_suppkey"])
    counts["ssb_supplier"] = t.insert_columns(
        {"s_suppkey": keys},
        strings={
            "s_name": [f"Supplier#{k:09d}" for k in keys],
            "s_city": scity, "s_nation": snat, "s_region": sreg,
        },
    )

    # part -------------------------------------------------------------------
    npart = max(1, int(200_000 * sf))
    keys = np.arange(1, npart + 1)
    mfgr = rng.integers(1, 6, npart)
    cat = rng.integers(1, 6, npart)
    brand = rng.integers(1, 41, npart)
    t = make_table("ssb_part", ["p_partkey"])
    counts["ssb_part"] = t.insert_columns(
        {"p_partkey": keys},
        strings={
            "p_name": [f"{_COLORS[int(k) % len(_COLORS)]} part" for k in keys],
            "p_mfgr": [f"MFGR#{m}" for m in mfgr],
            "p_category": [f"MFGR#{m}{c}" for m, c in zip(mfgr, cat)],
            "p_brand1": [f"MFGR#{m}{c}{b}" for m, c, b in zip(mfgr, cat, brand)],
            "p_color": [_COLORS[i] for i in rng.integers(0, len(_COLORS), npart)],
        },
    )

    # lineorder (the fact table) --------------------------------------------
    norders = max(1, int(1_500_000 * sf))
    lines_per = rng.integers(1, 8, norders)
    n = int(lines_per.sum())
    okey = np.repeat(np.arange(1, norders + 1), lines_per)
    lnum = np.concatenate([np.arange(1, c + 1) for c in lines_per])
    datekeys = np.array([d.year * 10000 + d.month * 100 + d.day for d in days])
    odate = datekeys[rng.integers(0, ndays, norders)]
    qty = rng.integers(1, 51, n)
    price = rng.integers(90000, 10_000_000, n)  # cents
    disc = rng.integers(0, 11, n)
    t = make_table("lineorder", ["lo_orderkey", "lo_linenumber"])
    counts["lineorder"] = t.insert_columns({
        "lo_orderkey": okey,
        "lo_linenumber": lnum,
        "lo_custkey": rng.integers(1, nc + 1, n),
        "lo_partkey": rng.integers(1, npart + 1, n),
        "lo_suppkey": rng.integers(1, ns + 1, n),
        "lo_orderdate": np.repeat(odate, lines_per),
        "lo_quantity": qty,
        "lo_extendedprice": price,
        "lo_discount": disc,
        "lo_revenue": price * (100 - disc) // 100,
        "lo_supplycost": price * 6 // 10,
    })
    return counts


# the 13 SSB queries (4 flights), official shapes ---------------------------
SSB_QUERIES = {
    "q1.1": """select sum(lo_extendedprice * lo_discount) as revenue
        from lineorder, ssb_date
        where lo_orderdate = d_datekey and d_year = 1993
          and lo_discount between 1 and 3 and lo_quantity < 25""",
    "q1.2": """select sum(lo_extendedprice * lo_discount) as revenue
        from lineorder, ssb_date
        where lo_orderdate = d_datekey and d_yearmonthnum = 199401
          and lo_discount between 4 and 6 and lo_quantity between 26 and 35""",
    "q1.3": """select sum(lo_extendedprice * lo_discount) as revenue
        from lineorder, ssb_date
        where lo_orderdate = d_datekey and d_weeknuminyear = 6 and d_year = 1994
          and lo_discount between 5 and 7 and lo_quantity between 26 and 35""",
    "q2.1": """select sum(lo_revenue) as lo_revenue, d_year, p_brand1
        from lineorder, ssb_date, ssb_part, ssb_supplier
        where lo_orderdate = d_datekey and lo_partkey = p_partkey
          and lo_suppkey = s_suppkey and p_category = 'MFGR#12'
          and s_region = 'AMERICA'
        group by d_year, p_brand1 order by d_year, p_brand1""",
    "q2.2": """select sum(lo_revenue) as lo_revenue, d_year, p_brand1
        from lineorder, ssb_date, ssb_part, ssb_supplier
        where lo_orderdate = d_datekey and lo_partkey = p_partkey
          and lo_suppkey = s_suppkey
          and p_brand1 between 'MFGR#2221' and 'MFGR#2228'
          and s_region = 'ASIA'
        group by d_year, p_brand1 order by d_year, p_brand1""",
    "q2.3": """select sum(lo_revenue) as lo_revenue, d_year, p_brand1
        from lineorder, ssb_date, ssb_part, ssb_supplier
        where lo_orderdate = d_datekey and lo_partkey = p_partkey
          and lo_suppkey = s_suppkey and p_brand1 = 'MFGR#2239'
          and s_region = 'EUROPE'
        group by d_year, p_brand1 order by d_year, p_brand1""",
    "q3.1": """select c_nation, s_nation, d_year, sum(lo_revenue) as revenue
        from ssb_customer, lineorder, ssb_supplier, ssb_date
        where lo_custkey = c_custkey and lo_suppkey = s_suppkey
          and lo_orderdate = d_datekey and c_region = 'ASIA'
          and s_region = 'ASIA' and d_year >= 1992 and d_year <= 1997
        group by c_nation, s_nation, d_year
        order by d_year asc, revenue desc""",
    "q3.2": """select c_city, s_city, d_year, sum(lo_revenue) as revenue
        from ssb_customer, lineorder, ssb_supplier, ssb_date
        where lo_custkey = c_custkey and lo_suppkey = s_suppkey
          and lo_orderdate = d_datekey and c_nation = 'UNITED STATES'
          and s_nation = 'UNITED STATES' and d_year >= 1992 and d_year <= 1997
        group by c_city, s_city, d_year
        order by d_year asc, revenue desc""",
    "q3.3": """select c_city, s_city, d_year, sum(lo_revenue) as revenue
        from ssb_customer, lineorder, ssb_supplier, ssb_date
        where lo_custkey = c_custkey and lo_suppkey = s_suppkey
          and lo_orderdate = d_datekey
          and (c_city = 'UNITED KI1' or c_city = 'UNITED KI5')
          and (s_city = 'UNITED KI1' or s_city = 'UNITED KI5')
          and d_year >= 1992 and d_year <= 1997
        group by c_city, s_city, d_year
        order by d_year asc, revenue desc""",
    "q3.4": """select c_city, s_city, d_year, sum(lo_revenue) as revenue
        from ssb_customer, lineorder, ssb_supplier, ssb_date
        where lo_custkey = c_custkey and lo_suppkey = s_suppkey
          and lo_orderdate = d_datekey
          and (c_city = 'UNITED KI1' or c_city = 'UNITED KI5')
          and (s_city = 'UNITED KI1' or s_city = 'UNITED KI5')
          and d_yearmonth = 'Dec1997'
        group by c_city, s_city, d_year
        order by d_year asc, revenue desc""",
    "q4.1": """select d_year, c_nation,
               sum(lo_revenue - lo_supplycost) as profit
        from ssb_date, ssb_customer, ssb_supplier, ssb_part, lineorder
        where lo_custkey = c_custkey and lo_suppkey = s_suppkey
          and lo_partkey = p_partkey and lo_orderdate = d_datekey
          and c_region = 'AMERICA' and s_region = 'AMERICA'
          and (p_mfgr = 'MFGR#1' or p_mfgr = 'MFGR#2')
        group by d_year, c_nation order by d_year, c_nation""",
    "q4.2": """select d_year, s_nation, p_category,
               sum(lo_revenue - lo_supplycost) as profit
        from ssb_date, ssb_customer, ssb_supplier, ssb_part, lineorder
        where lo_custkey = c_custkey and lo_suppkey = s_suppkey
          and lo_partkey = p_partkey and lo_orderdate = d_datekey
          and c_region = 'AMERICA' and s_region = 'AMERICA'
          and (d_year = 1997 or d_year = 1998)
          and (p_mfgr = 'MFGR#1' or p_mfgr = 'MFGR#2')
        group by d_year, s_nation, p_category
        order by d_year, s_nation, p_category""",
    "q4.3": """select d_year, s_city, p_brand1,
               sum(lo_revenue - lo_supplycost) as profit
        from ssb_date, ssb_customer, ssb_supplier, ssb_part, lineorder
        where lo_custkey = c_custkey and lo_suppkey = s_suppkey
          and lo_partkey = p_partkey and lo_orderdate = d_datekey
          and s_nation = 'UNITED STATES' and (d_year = 1997 or d_year = 1998)
          and p_category = 'MFGR#14'
        group by d_year, s_city, p_brand1
        order by d_year, s_city, p_brand1""",
}
