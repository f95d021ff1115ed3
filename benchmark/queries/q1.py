"""TPC-H Q1 (pricing summary report): the plain NumPy reference.

Substitution parameter (TPC-H 2.4.1.3): DELTA, days in [60, 120].
Work: every lineitem row passing the date filter reaches the grouped
aggregation with five argument values (quantity, price, discounted
price, charge, discount) and its group id; 8 aggregates per group out.

The exact sums are taken once per (group, ship date) over the whole
table and added up to each cutoff, so the parameter sets of a run share
one pass over lineitem (integer sums do not depend on their order). The
control (exact=False) sums the filtered rows of each group in float32
directly, in row order, as a device kernel summing the column would.
"""

import numpy as np

from harness import refkit as K

COLUMNS = ("str", "str", "dec2", "dec2", "dec4", "dec6", "float", "float", "float", "int")
ORDER_BY = ((0, False), (1, False))
LIMIT = None
_DAILY = []  # [(lineitem's l_shipdate array, its per (group, day) sums)], the last one


def draw(rng) -> dict:
    return {"delta": int(rng.integers(60, 121))}


def _daily(li):
    # the cache holds the array itself, so a later table cannot reuse its id
    if not (_DAILY and _DAILY[0][0] is li.arrays["l_shipdate"]):
        a = li.arrays
        ship = a["l_shipdate"]
        day0, ndays = int(ship.min()), int(ship.max() - ship.min()) + 1
        nls = len(li.pools["l_linestatus"])
        n_groups = len(li.pools["l_returnflag"]) * nls
        cell = (a["l_returnflag"] * nls + a["l_linestatus"]) * ndays + (ship - day0)
        qty, ext, disc, tax = (a[c].astype(np.int64) for c in (
            "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
        disc_price = ext * (100 - disc)             # scale 4
        charge = disc_price * (100 + tax)           # scale 6
        n = n_groups * ndays
        sums = {name: np.array(K.group_sum(cell, v, n), dtype=object).reshape(n_groups, ndays)
                for name, v in (("qty", qty), ("ext", ext), ("dp", disc_price),
                                ("ch", charge), ("disc", disc))}
        sums["cnt"] = np.bincount(cell, minlength=n).reshape(n_groups, ndays)
        _DAILY[:] = [(ship, (day0, nls, n_groups, sums))]
    return _DAILY[0][1]


def _direct_float32(li, cutoff: int):
    a = li.arrays
    m = a["l_shipdate"] <= cutoff
    nls = len(li.pools["l_linestatus"])
    n_groups = len(li.pools["l_returnflag"]) * nls
    gid = a["l_returnflag"][m] * nls + a["l_linestatus"][m]
    qty, ext, disc, tax = (K.money(a[c][m], False) for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    disc_price = ext * (100 - disc)
    charge = disc_price * (100 + tax)
    tot = {k: K.group_sum(gid, v, n_groups, False) for k, v in (
        ("qty", qty), ("ext", ext), ("dp", disc_price), ("ch", charge), ("disc", disc))}
    tot["cnt"] = np.bincount(gid, minlength=n_groups)
    return nls, n_groups, tot


def reference(data, p, exact=True):
    li = data["lineitem"]
    cutoff = K.days("1998-12-01") - p["delta"]
    if exact:
        day0, nls, n_groups, sums = _daily(li)
        upto = max(cutoff - day0 + 1, 0)  # days at or before the cutoff
        tot = {k: [v[g, :upto].sum() for g in range(n_groups)] for k, v in sums.items()}
    else:
        nls, n_groups, tot = _direct_float32(li, cutoff)
    rows = []
    for g in range(n_groups):
        c = int(tot["cnt"][g])
        if not c:
            continue
        rows.append((li.pools["l_returnflag"][g // nls], li.pools["l_linestatus"][g % nls],
                     K.dec(tot["qty"][g], 2, exact), K.dec(tot["ext"][g], 2, exact),
                     K.dec(tot["dp"][g], 4, exact), K.dec(tot["ch"][g], 6, exact),
                     float(tot["qty"][g]) / 100 / c, float(tot["ext"][g]) / 100 / c,
                     float(tot["disc"][g]) / 100 / c, c))
    n = int(sum(tot["cnt"]))
    work = {"agg": {"rows": n, "values": 6, "outputs": len(rows) * 8}, "joins": []}
    return rows, work
