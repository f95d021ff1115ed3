"""TPC-H's refresh functions (TPC-H Standard Specification, clause 2.5):
RF1 inserts new sales, RF2 deletes old sales.

Each function touches SF * 1,500 orders and their lineitems (1-7 per
order, about 6,000 at SF1), over tables loaded by `storage/tpch.py`.

- `rf1(catalog, sf, seed)` makes the new sales: order keys continue above
  the current maximum, and every other value of a new order or lineitem
  is copied from a live row of the loaded table, drawn with the seed. The
  new rows so follow the loaded data's distributions, and every string
  they hold is one the table's dictionary already has (an RF1 never
  rewrites existing codes).
- `rf2_keys(catalog, sf)` picks the old sales: the SF * 1,500 smallest
  live order keys.

Rows come back as column arrays in the tables' device representation
(what a numpy model of the tables appends), and `insert_statements`
renders them as multi-row INSERT ... VALUES texts (what a session runs).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from tidb_tpu_torch.types import TypeKind, days_to_date, scaled_to_decimal_str

__all__ = ["rf1", "rf2_keys", "insert_statements", "refresh_size"]


def refresh_size(sf: float) -> int:
    """Orders one refresh function touches (clause 2.5: SF * 1,500)."""
    return max(1, int(round(1500 * sf)))


def _live_rows(table) -> np.ndarray:
    return np.nonzero(table.live_mask(0, table.n))[0]


def rf1(catalog, sf: float, seed: int = 7, db: str = "test") -> Dict[str, Dict[str, np.ndarray]]:
    """New sales: {"orders": {col: array}, "lineitem": {col: array}} in
    device representation (dictionary codes of the tables' current
    dictionaries)."""
    rng = np.random.default_rng(seed)
    o = catalog.table(db, "orders")
    li = catalog.table(db, "lineitem")
    n_new = refresh_size(sf)
    live_o, live_l = _live_rows(o), _live_rows(li)
    kmax = int(o.data["o_orderkey"][live_o].max())
    okeys = kmax + 1 + np.arange(n_new, dtype=np.int64)
    src_o = rng.choice(live_o, n_new)
    orders = {c: o.data[c][src_o].copy() for c in o.schema.names()}
    orders["o_orderkey"] = okeys
    per_order = rng.integers(1, 8, n_new)
    src_l = rng.choice(live_l, int(per_order.sum()))
    lines = {c: li.data[c][src_l].copy() for c in li.schema.names()}
    lines["l_orderkey"] = np.repeat(okeys, per_order)
    starts = np.repeat(np.cumsum(per_order) - per_order, per_order)
    lines["l_linenumber"] = (np.arange(len(src_l)) - starts + 1).astype(np.int64)
    return {"orders": orders, "lineitem": lines}


def rf2_keys(catalog, sf: float, db: str = "test") -> np.ndarray:
    """Old sales: the refresh size's smallest live order keys, sorted."""
    o = catalog.table(db, "orders")
    keys = np.sort(o.data["o_orderkey"][_live_rows(o)])
    return keys[:refresh_size(sf)].astype(np.int64)


def _literal(table, col, v) -> str:
    k = col.type_.kind
    if k == TypeKind.STRING:
        s = table.dicts[col.name].values[int(v)]
        return "'" + s.replace("\\", "\\\\").replace("'", "''") + "'"
    if k == TypeKind.DECIMAL:
        return scaled_to_decimal_str(int(v), col.type_.scale)
    if k == TypeKind.DATE:
        return f"'{days_to_date(int(v)).isoformat()}'"
    return str(int(v))


def insert_statements(table, arrays: Dict[str, np.ndarray], batch: int = 500) -> List[str]:
    """Multi-row INSERT ... VALUES texts for `arrays` (every column of
    `table`, device representation), `batch` rows a statement."""
    cols = table.schema.columns
    n = len(arrays[cols[0].name])
    rows = []
    for i in range(n):
        rows.append("(" + ", ".join(_literal(table, c, arrays[c.name][i])
                                    for c in cols) + ")")
    name = table.schema.name
    return [f"insert into {name} values " + ", ".join(rows[s:s + batch])
            for s in range(0, n, batch)]
