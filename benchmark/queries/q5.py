"""TPC-H Q5 (local supplier volume): the plain NumPy reference.

Substitution parameters (TPC-H 2.4.5.3): REGION, one of the five
regions; DATE, January 1st of a year in [1993, 1997].
Work: orders (year) with lineitem on the order key, the result with
customer on the customer key, and that with the region's suppliers on
the supplier key and nation; each join's build and probe keys read once
and its matches written once. The matching rows then reach the grouped
aggregation with one argument value and the nation's group id.
"""

import numpy as np

from harness import refkit as K

COLUMNS = ("str", "dec4")
ORDER_BY = ((1, True),)
LIMIT = None


def draw(rng) -> dict:
    regions = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
    return {"region": regions[int(rng.integers(0, 5))],
            "date": f"{int(rng.integers(1993, 1998))}-01-01"}


def reference(data, p, exact=True):
    c, o, li, su, na, re = (data[n] for n in (
        "customer", "orders", "lineitem", "supplier", "nation", "region"))
    rkey = re.arrays["r_regionkey"][re.arrays["r_name"] == re.pools["r_name"].index(p["region"])]
    nkey, nreg = na.arrays["n_nationkey"], na.arrays["n_regionkey"]
    in_region = np.zeros(int(nkey.max()) + 1, dtype=bool)
    in_region[nkey[np.isin(nreg, rkey)]] = True
    ckey, cnat = c.arrays["c_custkey"], c.arrays["c_nationkey"]
    cnat_of = np.full(int(ckey.max()) + 1, -1)
    cnat_of[ckey] = cnat
    skey, snat = su.arrays["s_suppkey"], su.arrays["s_nationkey"]
    snat_of = np.full(int(skey.max()) + 1, -2)
    snat_of[skey] = snat
    okey, ocust, odate = o.arrays["o_orderkey"], o.arrays["o_custkey"], o.arrays["o_orderdate"]
    in_year = (odate >= K.days(p["date"])) & (odate < K.days(K.add_years(p["date"], 1)))
    opos = K.lookup(okey)
    lkey, lsupp = li.arrays["l_orderkey"], li.arrays["l_suppkey"]
    row = np.maximum(opos[lkey], 0)
    l_in_year = (opos[lkey] >= 0) & in_year[row]
    sn = snat_of[lsupp]
    s_in_region = in_region[np.maximum(sn, 0)] & (sn >= 0)
    m = l_in_year & (cnat_of[ocust[row]] == sn) & s_in_region
    ext, disc = K.money(li.arrays["l_extendedprice"][m], exact), K.money(li.arrays["l_discount"][m], exact)
    nat, gid = np.unique(sn[m], return_inverse=True)
    rev = K.group_sum(gid, ext * (100 - disc), len(nat), exact)
    names = na.pools["n_name"]
    name_of = {int(k): names[int(n)] for k, n in zip(nkey, na.arrays["n_name"])}
    rows = sorted(((name_of[int(k)], v) for k, v in zip(nat, rev)),
                  key=lambda r: (-r[1], r[0]))
    rows = [(n, K.dec(v, 4, exact)) for n, v in rows]
    n_li = int(l_in_year.sum())
    s_region = int(in_region[snat].sum())
    work = {"agg": {"rows": int(m.sum()), "values": 2, "outputs": len(rows)},
            "joins": [
                {"build": int(in_year.sum()), "probe": len(lkey), "out": n_li},
                {"build": len(ckey), "probe": n_li, "out": n_li},
                {"build": s_region, "probe": n_li, "out": int(m.sum())}]}
    return rows, work
