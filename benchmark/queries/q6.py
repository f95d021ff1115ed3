"""TPC-H Q6 (forecasting revenue change): the plain NumPy reference.

Substitution parameters (TPC-H 2.4.6.3): DATE, January 1st of a year in
[1993, 1997]; DISCOUNT in [0.02, 0.09]; QUANTITY in [24, 25].
Work: each row passing the filter reaches the (single-group)
aggregation with one argument value; one output.
"""

from harness import refkit as K

COLUMNS = ("dec4",)
ORDER_BY = ()
LIMIT = None


def draw(rng) -> dict:
    return {"date": f"{int(rng.integers(1993, 1998))}-01-01",
            "discount": f"0.0{int(rng.integers(2, 10))}",
            "quantity": int(rng.integers(24, 26))}


def reference(data, p, exact=True):
    a = data["lineitem"].arrays
    d = int(round(float(p["discount"]) * 100))
    ship, disc = a["l_shipdate"], a["l_discount"]
    m = ((ship >= K.days(p["date"])) & (ship < K.days(K.add_years(p["date"], 1)))
         & (disc >= d - 1) & (disc <= d + 1) & (a["l_quantity"] < p["quantity"] * 100))
    rev = K.money(a["l_extendedprice"][m], exact) * K.money(disc[m], exact)  # scale 4
    n = int(m.sum())
    rows = [(K.dec(K.total(rev, exact), 4, exact) if n else None,)]
    work = {"agg": {"rows": n, "values": 1, "outputs": 1}, "joins": []}
    return rows, work
