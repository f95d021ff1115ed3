"""Zone maps: per-segment, per-column min/max/null_count/NDV (a copy
of tidb_tpu/columnar/zonemap.py).

Built once at segment build time over ALL physical rows of the
segment's range (live and dead MVCC versions alike), so they bound any
visibility subset a scan can see — a pruned segment is provably
row-free for the predicate under every read timestamp, delta overlay,
or delete pattern. NULL rows never satisfy a comparison (SQL UNKNOWN is
filtered), so min/max over the valid slots is sufficient.

Bound collection (`collect_prune_bounds`) mirrors the comparison
semantics of `expression/compiler.py` exactly:

  * non-DECIMAL kinds compare raw device reprs (dates as day counts,
    strings as dictionary codes — the binder already lowered string
    predicates to integer code compares), so literal values apply to
    zone min/max directly;
  * DECIMAL comparisons happen at the max of both scales; the bound
    carries the exact python-int rescale factors for each side, so an
    18-digit decimal prunes without a float round trip;
  * FLOAT literals compare exactly (python int-vs-float comparison is
    exact, no 2^53 truncation).

Anything the collector does not understand contributes no bound —
pruning degrades to "scan it", never to a wrong skip.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from tidb_tpu_torch.types import TypeKind

__all__ = ["ZoneMap", "Bound", "build_zone_map", "collect_prune_bounds",
           "segment_pruned"]


@dataclass(frozen=True)
class ZoneMap:
    rows: int
    null_count: int
    min: Optional[object] = None   # python int/float over valid slots
    max: Optional[object] = None
    ndv: int = 0                   # exact distinct count at build time


# an integer column whose values span at most this many counts its
# distinct values in a bitmap, not a sort
_BITMAP_SPAN = 1 << 20


def build_zone_map(data: np.ndarray, valid: np.ndarray) -> ZoneMap:
    n = len(data)
    vals = data if valid.all() else data[valid]
    if len(vals) == 0:
        return ZoneMap(rows=n, null_count=n)
    if data.dtype.kind == "f":
        mn, mx = float(vals.min()), float(vals.max())
    else:
        mn, mx = int(vals.min()), int(vals.max())
    if data.dtype.kind == "f":
        ndv = int(len(np.unique(vals)))
    elif mx - mn < _BITMAP_SPAN:
        seen = np.zeros(mx - mn + 1, dtype=np.bool_)
        seen[np.subtract(vals, mn, dtype=np.int64)] = True
        ndv = int(np.count_nonzero(seen))
    else:  # a sort: numpy's hashed unique takes 2-3x longer on 65,536 keys
        srt = np.sort(vals)
        ndv = 1 + int(np.count_nonzero(srt[1:] != srt[:-1]))
    return ZoneMap(rows=n, null_count=n - len(vals), min=mn, max=mx, ndv=ndv)


@dataclass(frozen=True)
class Bound:
    """One zone-consultable conjunct of a pushed-down filter.

    kind: "eq" | "lt" | "le" | "gt" | "ge" | "in" | "isnull"
        | "notnull" | "never" ("never" = the conjunct is statically
        row-free, e.g. a NULL literal comparison: every segment prunes).
    `col_scale_mul` rescales zone min/max into the comparison space
    (DECIMAL alignment); `value` is already in that space.
    """

    col: str
    kind: str
    value: object = None
    values: Tuple = ()
    col_scale_mul: int = 1


_CMP_OPS = {"eq", "lt", "le", "gt", "ge"}
_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}


def _literal_in_cmp_space(col_type, lit_type, value):
    """(value in comparison space, column rescale factor), or None when
    the pair doesn't compare by plain device-repr order.

    Float literals against int64-backed columns (INT and DECIMAL alike)
    contribute NO bound: the device compares those in float64 (lossy
    past 2^53) while zone maps hold exact python ints — and a DECIMAL
    rescale can push even a small literal past 2^53 — so the two
    orderings can disagree, and a bound that disagrees with the
    executor is a wrong skip. Float-vs-float stays: both sides are the
    same float64s the device compares."""
    ck, lk = col_type.kind, lit_type.kind
    if ck == TypeKind.FLOAT:
        if lk == TypeKind.DECIMAL:
            # DECIMAL literal vs FLOAT column: the compiler aligns on
            # the decimal scale (float side multiplied by 10**scale,
            # literal stays the scaled int, compared in float64) — the
            # bound must live in that same space, so the zone min/max
            # get the 10**scale factor and the scaled literal is cast
            # to the float64 the device promotes it to
            return float(value), 10 ** lit_type.scale
        return float(value), 1
    if isinstance(value, (float, np.floating)):
        return None
    if ck == TypeKind.DECIMAL or lk == TypeKind.DECIMAL:
        cs = col_type.scale if ck == TypeKind.DECIMAL else 0
        ls = lit_type.scale if lk == TypeKind.DECIMAL else 0
        s = max(cs, ls)
        return int(value) * (10 ** (s - ls)), 10 ** (s - cs)
    if isinstance(value, (bool, np.bool_)):
        return int(value), 1
    if isinstance(value, (int, np.integer, float)):
        v = int(value)
        if not (-(1 << 63) <= v < (1 << 63)):
            # the executor can't even build such a literal (int64
            # overflow at compile); pruning must not silently answer a
            # query whose raw path errors — no bound, same behavior
            # either way
            return None
        return v, 1
    return None


def collect_prune_bounds(cond, uid_map) -> Tuple[Bound, ...]:
    """Extract zone-consultable bounds from the AND-tree of a pushed
    filter. `uid_map`: ColumnRef name -> (storage column name, SQLType).
    Conjuncts that aren't simple col-vs-literal shapes are skipped."""
    from tidb_tpu_torch.expression.expr import Call, ColumnRef, InList, Literal

    out = []

    def col_of(e):
        hit = uid_map.get(e.name) if isinstance(e, ColumnRef) else None
        return hit

    def visit(e):
        if isinstance(e, Call) and e.op == "and":
            for a in e.args:
                visit(a)
            return
        if isinstance(e, Call) and e.op in _CMP_OPS and len(e.args) == 2:
            a, b = e.args
            op = e.op
            if isinstance(a, Literal) and isinstance(b, ColumnRef):
                a, b = b, a
                op = _FLIP[op]
            hit = col_of(a)
            if hit is None or not isinstance(b, Literal):
                return
            name, ctype = hit
            if b.value is None:
                # col <op> NULL is UNKNOWN for every row: statically
                # row-free, prune everything (the delta path still
                # scans and yields nothing)
                out.append(Bound(col=name, kind="never"))
                return
            conv = _literal_in_cmp_space(ctype, b.type_, b.value)
            if conv is None:
                return
            v, mul = conv
            out.append(Bound(col=name, kind=op, value=v, col_scale_mul=mul))
            return
        if isinstance(e, InList) and not e.negated:
            hit = col_of(e.arg)
            if hit is None:
                return
            name, ctype = hit
            # mirror the compiler exactly: it casts the literal list to
            # the column's dtype before comparing (np.asarray(values,
            # dtype=arg.np_dtype)), so the bound must hold the CAST
            # values, not the raw python ones
            vals = [v for v in e.values if v is not None]
            if not vals or not all(
                    isinstance(v, (int, np.integer, float, np.floating))
                    for v in vals):
                return
            try:
                cast = np.asarray(vals, dtype=e.arg.type_.np_dtype)
            except (OverflowError, ValueError):
                return
            out.append(Bound(col=name, kind="in",
                             values=tuple(cast.tolist())))
            return
        if isinstance(e, Call) and e.op in ("is_null", "is_not_null") \
                and len(e.args) == 1:
            hit = col_of(e.args[0])
            if hit is not None:
                out.append(Bound(
                    col=hit[0],
                    kind="isnull" if e.op == "is_null" else "notnull"))

    if cond is not None:
        visit(cond)
    return tuple(out)


def segment_pruned(zmaps: Dict[str, ZoneMap], bounds) -> bool:
    """True when at least one bound proves the segment row-free for the
    whole AND of the pushed filter."""
    for b in bounds:
        if b.kind == "never":
            return True
        z = zmaps.get(b.col)
        if z is None:
            continue
        if b.kind == "isnull":
            if z.null_count == 0:
                return True
            continue
        if z.min is None:  # every row NULL: no comparison ever passes
            return True    # (notnull included: there is no non-NULL row)
        if b.kind == "notnull":
            continue
        mn, mx = z.min * b.col_scale_mul, z.max * b.col_scale_mul
        if b.kind == "in":
            if all(v < mn or v > mx for v in b.values):
                return True
            continue
        v = b.value
        if ((b.kind == "eq" and (v < mn or v > mx))
                or (b.kind == "ge" and mx < v)
                or (b.kind == "gt" and mx <= v)
                or (b.kind == "le" and mn > v)
                or (b.kind == "lt" and mn >= v)):
            return True
    return False
