"""TPC-H Q18 (large volume customer): the plain NumPy reference.

Substitution parameter (TPC-H 2.4.18.3): QUANTITY in [312, 315].
Work: the IN subquery's large orders against orders (semi join), those
orders with customer on the customer key and with lineitem on the
order key; each join's build and probe keys read once and its matches
written once. Its grouped aggregations are sort-based (no `tidb_segagg`).
"""

import numpy as np

from harness import refkit as K

COLUMNS = ("str", "int", "int", "date", "dec2", "dec2")
ORDER_BY = ((4, True), (3, False))
LIMIT = 100


def draw(rng) -> dict:
    return {"quantity": int(rng.integers(312, 316))}


def reference(data, p, exact=True):
    c, o, li = data["customer"], data["orders"], data["lineitem"]
    lkey, qty = li.arrays["l_orderkey"], li.arrays["l_quantity"]
    n = int(lkey.max()) + 1
    # quantities are at most 5,000 a line at scale 2: float64 sums are exact
    tot = np.bincount(lkey, weights=qty.astype(np.float64), minlength=n).astype(np.int64)
    big = np.flatnonzero(tot > p["quantity"] * 100)
    okey, ocust = o.arrays["o_orderkey"], o.arrays["o_custkey"]
    odate, oprice = o.arrays["o_orderdate"], o.arrays["o_totalprice"]
    opos = K.lookup(okey)
    ckey = c.arrays["c_custkey"]
    cpos = K.lookup(ckey)
    rows = []
    for k in big:
        r = opos[k] if k < len(opos) else -1
        if r < 0 or cpos[ocust[r]] < 0:
            continue
        name = c.pools["c_name"][int(c.arrays["c_name"][cpos[ocust[r]]])]
        price = int(oprice[r]) if exact else float(np.float32(oprice[r]))
        q = int(tot[k]) if exact else float(np.float32(tot[k]))
        rows.append((name, int(ocust[r]), int(k), int(odate[r]), price, q))
    rows.sort(key=lambda x: (-x[4], x[3], x[2]))
    rows = [(a, b, k, K.iso(d), K.dec(pr, 2, exact), K.dec(q, 2, exact))
            for a, b, k, d, pr, q in rows[:100]]
    n_big = int(len(big))
    n_ord = int(np.isin(okey, big).sum())
    n_lines = int(np.isin(lkey, big).sum())
    work = {"agg": None, "joins": [
        {"build": n_big, "probe": len(okey), "out": n_ord},
        {"build": len(ckey), "probe": n_ord, "out": n_ord},
        {"build": n_ord, "probe": len(lkey), "out": n_lines}]}
    return rows, work
