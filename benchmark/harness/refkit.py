"""Helpers of the plain NumPy reference (benchmark/queries/*.py).

Decimals stay scaled integers and are summed exactly; `exact=False`
gives the control: the same arithmetic in float32, the precision a
later change might be tempted to compute money in.
"""

from __future__ import annotations

import datetime
from decimal import Decimal

import numpy as np

EPOCH = datetime.date(1970, 1, 1)


def days(iso: str) -> int:
    return (datetime.date.fromisoformat(iso) - EPOCH).days


def iso(d: int) -> str:
    return (EPOCH + datetime.timedelta(days=int(d))).isoformat()


def add_years(iso_date: str, n: int) -> str:
    d = datetime.date.fromisoformat(iso_date)
    return d.replace(year=d.year + n).isoformat()


def lookup(keys: np.ndarray) -> np.ndarray:
    """key -> row position (-1 where absent), over keys in [0, max]."""
    pos = np.full(int(keys.max()) + 1 if len(keys) else 1, -1, dtype=np.int64)
    pos[keys] = np.arange(len(keys))
    return pos


def group_sum(gid: np.ndarray, vals: np.ndarray, n: int, exact: bool = True):
    """Per-group sums of `vals` over group ids in [0, n): exact Python
    ints from int64 values (split into 26-bit halves, each summed in
    float64 without rounding), or float32 sums for the control."""
    if not exact:
        out = np.zeros(n, dtype=np.float32)
        np.add.at(out, gid, vals.astype(np.float32))
        return [float(v) for v in out]
    vals = vals.astype(np.int64)
    if len(vals) and vals.min() < 0:
        raise ValueError("group_sum takes non-negative values")
    lo = np.bincount(gid, weights=(vals & 0x3FFFFFF).astype(np.float64), minlength=n)
    hi = np.bincount(gid, weights=(vals >> 26).astype(np.float64), minlength=n)
    return [int(h) * (1 << 26) + int(lw) for h, lw in zip(hi, lo)]


def total(vals: np.ndarray, exact: bool = True):
    return group_sum(np.zeros(len(vals), dtype=np.int64), vals, 1, exact)[0]


def dec(v, scale: int, exact: bool = True) -> Decimal:
    """A sum at `scale` as the exact Decimal, or, for the control, the
    float32 result in units (v / 10**scale computed in float32) rounded
    to the column's scale."""
    if exact:
        return Decimal(int(v)).scaleb(-scale)
    unit = np.float32(v) / np.float32(10 ** scale)
    return Decimal(float(unit)).quantize(Decimal(1).scaleb(-scale))


def money(vals: np.ndarray, exact: bool):
    """Scaled integers as they enter the arithmetic: exact int64, or
    float32 for the control."""
    return vals.astype(np.int64) if exact else vals.astype(np.float32)
