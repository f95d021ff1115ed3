"""TPC-H Q3 (shipping priority): the plain NumPy reference.

Substitution parameters (TPC-H 2.4.3.3): SEGMENT, one of the five
market segments; DATE, a day in [1995-03-01, 1995-03-31].
Work: two joins, customer (segment) with orders (date) on the customer
key, then those orders with lineitem (date) on the order key; each
join's build and probe keys read once and its matches written once.
"""

import numpy as np

from harness import refkit as K

COLUMNS = ("int", "dec4", "date", "int")
ORDER_BY = ((1, True), (2, False))
LIMIT = 10


def draw(rng) -> dict:
    segments = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
    return {"segment": segments[int(rng.integers(0, 5))],
            "date": f"1995-03-{int(rng.integers(1, 32)):02d}"}


def reference(data, p, exact=True):
    c, o, li = data["customer"], data["orders"], data["lineitem"]
    d0 = K.days(p["date"])
    ckey = c.arrays["c_custkey"]
    in_seg = c.arrays["c_mktsegment"] == c.pools["c_mktsegment"].index(p["segment"])
    chosen = np.zeros(int(ckey.max()) + 1, dtype=bool)
    chosen[ckey[in_seg]] = True
    okey, ocust = o.arrays["o_orderkey"], o.arrays["o_custkey"]
    odate, oprio = o.arrays["o_orderdate"], o.arrays["o_shippriority"]
    o_dated = odate < d0
    keep_o = o_dated & chosen[ocust]
    opos = K.lookup(okey)
    lkey = li.arrays["l_orderkey"]
    l_dated = li.arrays["l_shipdate"] > d0
    row = opos[lkey]
    m = l_dated & (row >= 0) & keep_o[np.maximum(row, 0)]
    uniq, gid = np.unique(lkey[m], return_inverse=True)
    ext, disc = K.money(li.arrays["l_extendedprice"][m], exact), K.money(li.arrays["l_discount"][m], exact)
    rev = K.group_sum(gid, ext * (100 - disc), len(uniq), exact)
    revs = np.array(rev, dtype=object)
    od = odate[opos[uniq]]
    # revenue descending, then order date, then the order key (ties)
    order = sorted(range(len(uniq)), key=lambda i: (-revs[i], od[i], uniq[i]))[:10]
    rows = [(int(uniq[i]), K.dec(revs[i], 4, exact), K.iso(od[i]), int(oprio[opos[uniq[i]]]))
            for i in order]
    work = {"agg": None, "joins": [
        {"build": int(in_seg.sum()), "probe": int(o_dated.sum()), "out": int(keep_o.sum())},
        {"build": int(keep_o.sum()), "probe": int(l_dated.sum()), "out": int(m.sum())}]}
    return rows, work
