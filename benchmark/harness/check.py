"""The comparison that decides `correct`: every statement sent in the
window, judged by the rows the client received against the plain
reference's rows for the same query and parameter set.

Numbers compared, each with its limit (set from the readings in
PERF.md: sound runs of the program against the float32 control):
  wrong     statements whose rows differ from the reference in a key,
            string, date, count or decimal (decimals compared exactly),
            in number, or in the ORDER BY order; limit 0
  failed    statements sent in the window that returned an error or no
            answer by the close plus the drain; limit 0
  avg_gap   the largest relative gap of an average (float64) against
            the reference's; limit AVG_GAP_LIMIT
  judged    statements judged; at least 1
"""

from __future__ import annotations

import math
from decimal import Decimal, InvalidOperation
from typing import List, Optional, Tuple

AVG_GAP_LIMIT = 1e-6
LIMITS = {"wrong": 0, "failed": 0, "avg_gap": AVG_GAP_LIMIT}


def _parse(kind: str, s: Optional[str]):
    if s is None:
        return None
    if kind.startswith("dec"):
        return Decimal(s)
    if kind == "int":
        return int(s)
    if kind == "float":
        return float(s)
    return s


def _cmp_key(row, order_by):
    key = []
    for i, desc in order_by:
        v = row[i]
        key.append((v is None, -v if desc and v is not None else v))
    return key


def _ordered(rows, order_by) -> bool:
    keys = [_cmp_key(r, order_by) for r in rows]
    return all(keys[i] <= keys[i + 1] for i in range(len(keys) - 1))


def _canon(rows, order_by, columns):
    # ties under ORDER BY may come in any order: sort them by the row
    exact = [i for i, k in enumerate(columns) if k != "float"]
    return sorted(rows, key=lambda r: (_cmp_key(r, order_by),
                                       [(r[i] is None, str(r[i])) for i in exact]))


def judge(got: List[tuple], want: List[tuple], columns, order_by) -> Tuple[bool, float, str]:
    """(rows wrong, largest relative gap of a float column, why)."""
    try:
        rows = [tuple(_parse(k, v) for k, v in zip(columns, r)) for r in got]
    except (InvalidOperation, ValueError) as e:
        return True, 0.0, f"unparsable row: {e}"
    if any(len(r) != len(columns) for r in got):
        return True, 0.0, "wrong number of columns"
    if len(rows) != len(want):
        return True, 0.0, f"{len(rows)} rows, reference {len(want)}"
    if not _ordered(rows, order_by):
        return True, 0.0, "rows out of ORDER BY order"
    gap, why = 0.0, ""
    for g, w in zip(_canon(rows, order_by, columns), _canon(want, order_by, columns)):
        for i, k in enumerate(columns):
            a, b = g[i], w[i]
            if k == "float" and a is not None and b is not None and math.isfinite(a):
                gap = max(gap, abs(a - b) / max(abs(b), 1e-300))
            elif a != b and not why:
                why = f"column {i}: {a!r} vs reference {b!r}"
    return bool(why), gap, why


def as_wire(rows: List[tuple], columns) -> List[tuple]:
    """Reference rows as the text protocol carries them (the control's
    rows, put in the program's place)."""
    out = []
    for r in rows:
        out.append(tuple(None if v is None else (repr(v) if k == "float" else str(v))
                         for k, v in zip(columns, r)))
    return out


def readings(verdicts) -> dict:
    """verdicts: (failed, wrong, gap) per statement judged."""
    return {"wrong": sum(1 for f, w, _ in verdicts if not f and w),
            "failed": sum(1 for f, _, _ in verdicts if f),
            "avg_gap": max([g for f, _, g in verdicts if not f] or [0.0]),
            "judged": len(verdicts)}


def compared(has_floats: bool) -> Tuple[str, ...]:
    """The numbers a cell compares: avg_gap only where a query of its mix
    returns averages (elsewhere it has nothing to read)."""
    return ("wrong", "failed", "avg_gap") if has_floats else ("wrong", "failed")


def passes(r: dict, names) -> bool:
    return r["judged"] >= 1 and all(r[k] <= LIMITS[k] for k in names)


def lines(r: dict, names) -> List[str]:
    return [f"check {k} {r[k]!r} limit {LIMITS[k]!r}" for k in names] \
        + [f"check judged {r['judged']} limit >=1"]


def as_json(r: dict, names) -> dict:
    out = {k: {"value": r[k], "limit": LIMITS[k]} for k in names}
    out["judged"] = {"value": r["judged"], "limit": 1}
    return out
