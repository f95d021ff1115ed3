"""Table/column statistics feeding the cost model.

Ref counterpart: statistics/ (histograms, CMSketch+TopN, NDV,
auto-analyze feeding planner/core's cost-based search). Here ANALYZE
TABLE collects, per column: NDV, null count, min/max, an equi-depth
histogram, and a most-common-values (MCV/TopN) list over the live rows;
the planner consumes them for scan selectivity and join cardinality
(planner/physical.py, planner/rules.py join reordering). The MCV list
is the skew signal the reference keeps in its TopN sketch: equi-join
selectivity matches heavy hitters across both sides instead of assuming
uniform key frequency (`eq_join_selectivity`).

Stats are version-stamped: a table mutation bumps table.version and
histogram/MCV estimates degrade to heuristics until the next ANALYZE —
the reference's stale-stats freshness model. NDV degrades more
gracefully: a per-column KMV sketch (`NDVSketch`, the analogue of the
reference's sketch-based NDV maintenance between analyzes) is seeded at
ANALYZE and updated on every insert, so join-key distinct counts track
DML churn without a full re-collection. A table with no fresh stats but
a columnar segment store estimates from its zone maps (`zone_map_stats`).

`analyze_table` is the reference's collection over the table's host
arrays, so a port table and a reference table holding the same rows get
field-by-field equal `TableStats`. Like the reference's, it resets the
plan-feedback store (planner/feedback.py): recorded actuals belong to the
old statistics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from tidb_tpu_torch.types import TypeKind

__all__ = ["ColumnStats", "TableStats", "analyze_table", "table_stats",
           "zone_map_stats", "scan_selectivity", "column_ndv",
           "eq_join_selectivity", "NDVSketch", "HIST_BUCKETS", "MCV_SIZE"]

HIST_BUCKETS = 64
MCV_SIZE = 16


@dataclass
class ColumnStats:
    ndv: int
    null_count: int
    min: Optional[float] = None
    max: Optional[float] = None
    # equi-depth histogram: `bounds` are the sorted values at the bucket
    # quantiles (len <= HIST_BUCKETS+1); each bucket holds ~equal rows
    bounds: Optional[np.ndarray] = None
    # most-common values: up to MCV_SIZE (value, count) pairs with
    # count >= 2, by descending count. Values are in comparable logical
    # form across tables: floats for numerics, python strings for
    # dict-encoded columns (codes are table-local and can't be matched
    # across tables).
    mcv: Optional[Dict[object, int]] = None


@dataclass
class TableStats:
    n_rows: int
    version: int
    cols: Dict[str, ColumnStats] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# NDV sketch (stats maintenance between analyzes)
# ---------------------------------------------------------------------------


from tidb_tpu_torch.utils.hashutil import splitmix64 as _splitmix64


def _hash_reprs(arr: np.ndarray) -> np.ndarray:
    """Hash device-representation values (ints/floats) to uint64."""
    a = np.asarray(arr)
    if a.dtype.kind == "f":
        u = a.astype(np.float64).view(np.uint64)
    elif a.dtype.kind == "b":
        u = a.astype(np.uint64)
    else:
        u = a.astype(np.int64).view(np.uint64)
    return _splitmix64(u)


def _hash_strings(vals) -> np.ndarray:
    """Hash python strings to uint64 (CPython string hash is 64-bit and
    stable within a process — sketches are in-memory state, never
    persisted)."""
    return _splitmix64(np.array([hash(v) for v in vals],
                                dtype=np.int64).view(np.uint64))


class NDVSketch:
    """K-minimum-values distinct-count sketch.

    Keeps the K smallest distinct 64-bit hashes seen; NDV is estimated
    as (K-1) / kth_min_normalized. Inserts only — deletes are ignored,
    so between analyzes the estimate is an (approximate) upper bound on
    live NDV, which is the safe direction for join estimates. Ref
    counterpart: the sketch-based NDV the reference maintains between
    full analyzes (statistics/ CMSketch family)."""

    __slots__ = ("mins",)
    K = 256

    def __init__(self, mins: Optional[np.ndarray] = None):
        self.mins = (np.empty(0, dtype=np.uint64)
                     if mins is None else mins.astype(np.uint64))

    def update(self, hashes: np.ndarray) -> None:
        if len(hashes) == 0:
            return
        h = hashes.astype(np.uint64)
        if len(self.mins) >= self.K:
            # saturated: only hashes below the current kth-min can enter;
            # pre-filter before the O(B log B) merge (expected survivors
            # ~ K*B/2^64, i.e. none)
            h = h[h < self.mins[-1]]
            if len(h) == 0:
                return
        merged = np.union1d(self.mins, h)
        self.mins = merged[: self.K]

    def estimate(self) -> float:
        k = len(self.mins)
        if k < self.K:
            return float(k)
        return (self.K - 1) * (2.0 ** 64) / float(max(self.mins[-1], 1))


def hash_column_values(vals: np.ndarray, dic) -> np.ndarray:
    """Hash a column's device-representation values for the NDV sketch.
    Dict-encoded columns hash the decoded strings — codes shift when the
    sorted dictionary grows, so they are not stable identities over
    time. The ONE definition shared by ANALYZE seeding and the insert
    hook (desynchronized hashing would corrupt estimates)."""
    if dic is not None:
        codes = np.unique(np.asarray(vals).astype(np.int64))
        return _hash_strings([dic.values[int(c)] for c in codes])
    return _hash_reprs(vals)


def _seed_sketch(table, col_name: str, vals: np.ndarray) -> None:
    """Seed the per-column NDV sketch from ANALYZE's value pass."""
    sk = NDVSketch()
    if len(vals):
        sk.update(hash_column_values(vals, table.dicts.get(col_name)))
    table.ndv_sketch[col_name] = sk


def analyze_table(table) -> TableStats:
    """Collect stats over the live rows of a host table.

    Also invalidates the plan-feedback store: recorded est-vs-actual
    truth was measured against the old statistics and the plans they
    produced, so ANALYZE (manual or auto) resets the baseline. One choke
    point here covers both the ANALYZE statement and auto-analyze."""
    from tidb_tpu_torch.planner import feedback as _feedback

    _feedback.STORE.on_schema_change()
    n = table.n
    live = np.asarray(table.live_mask(0, n)) if n else np.zeros(0, dtype=bool)
    n_live = int(live.sum())
    stats = TableStats(n_rows=n_live, version=table.version)
    if not hasattr(table, "ndv_sketch"):
        table.ndv_sketch = {}
    for c in table.schema.columns:
        data, valid = table.column_slice(c.name, 0, n)
        data, valid = np.asarray(data)[live], np.asarray(valid)[live]
        vals = data[valid]
        null_count = n_live - len(vals)
        _seed_sketch(table, c.name, vals)
        if len(vals) == 0:
            stats.cols[c.name] = ColumnStats(ndv=0, null_count=null_count)
            continue
        sv = np.sort(vals.astype(np.float64, copy=False))
        boundaries = np.flatnonzero(np.diff(sv))  # last index of each run
        starts = np.concatenate(([0], boundaries + 1))
        counts = np.diff(np.concatenate((starts, [len(sv)])))
        ndv = len(starts)
        idx = np.linspace(0, len(sv) - 1, min(HIST_BUCKETS + 1, len(sv))).astype(np.int64)
        # MCV/TopN: heaviest values with count >= 2, decoded to a
        # cross-table-comparable form
        mcv = None
        heavy = np.flatnonzero(counts >= 2)
        if len(heavy):
            top = heavy[np.argsort(counts[heavy])[::-1][:MCV_SIZE]]
            dic = table.dicts.get(c.name)
            mcv = {}
            for i in top:
                v = sv[starts[i]]
                key = dic.values[int(v)] if dic is not None else float(v)
                mcv[key] = int(counts[i])
        stats.cols[c.name] = ColumnStats(
            ndv=ndv, null_count=null_count,
            min=float(sv[0]), max=float(sv[-1]),
            bounds=sv[idx], mcv=mcv,
        )
    table.stats = stats
    return stats


def table_stats(table) -> Optional[TableStats]:
    """Current stats if fresh (collected at this table version)."""
    s = getattr(table, "stats", None)
    if s is not None and s.version == table.version:
        return s
    return None


def zone_map_stats(table) -> Optional[TableStats]:
    """Fallback stats derived from the columnar segment store's zone
    maps (ISSUE 8): per-column min/max as a two-point histogram,
    null counts, and a summed per-segment NDV upper bound. Only
    consulted when no fresh ANALYZE stats exist, and never stored on
    `table.stats` (the plan cache keys entry freshness on that object's
    identity). Reads an EXISTING store only — estimation must not
    trigger a segment build."""
    store = getattr(table, "_segment_store", None)
    if store is None:
        return None
    try:
        return store.stats_view()
    except Exception:  # noqa: BLE001 — estimation must never fail a plan
        return None


# ---------------------------------------------------------------------------
# estimation
# ---------------------------------------------------------------------------


def column_ndv(table, col_name: str) -> Optional[float]:
    """Distinct-count estimate for a column. Fresh stats give the exact
    ANALYZE-time NDV; between analyzes the insert-maintained KMV sketch
    keeps tracking churn (a table that doubled its key domain since
    ANALYZE is estimated near its new NDV, not its stale one)."""
    s = table_stats(table)
    if s is not None and col_name in s.cols:
        # fresh stats imply the sketch hasn't moved since ANALYZE (any
        # insert bumps table.version first): the exact count wins
        return max(float(s.cols[col_name].ndv), 1.0)
    sk = getattr(table, "ndv_sketch", {}).get(col_name)
    if sk is not None:
        return max(sk.estimate(), 1.0)
    # never analyzed: the segment store's zone maps still carry a
    # per-segment exact NDV whose sum upper-bounds the table's
    zs = zone_map_stats(table)
    if zs is not None and col_name in zs.cols and zs.cols[col_name].ndv:
        return max(float(zs.cols[col_name].ndv), 1.0)
    return None


def eq_join_selectivity(sl: TableStats, cl: ColumnStats,
                        sr: TableStats, cr: ColumnStats) -> float:
    """P(random left row key == random right row key) for an equi-join,
    MCV-aware (ref: the TopN-matched join estimation in the reference's
    planner; same shape as PostgreSQL's eqjoinsel). Heavy hitters are
    matched value-by-value across both MCV lists; the residual mass is
    assumed uniform over the residual distinct values. NULLs never
    match. Captures skew the 1/max(ndv) uniformity rule misses: two
    columns 90%-concentrated on one shared value join at sel ~0.81, not
    1/ndv."""
    n_l, n_r = max(sl.n_rows, 1), max(sr.n_rows, 1)
    nn_l = 1.0 - cl.null_count / n_l
    nn_r = 1.0 - cr.null_count / n_r
    pl = {v: c / n_l for v, c in (cl.mcv or {}).items()}
    pr = {v: c / n_r for v, c in (cr.mcv or {}).items()}
    dl = max(cl.ndv - len(pl), 1)
    dr = max(cr.ndv - len(pr), 1)
    rl = max(nn_l - sum(pl.values()), 0.0)  # residual (non-MCV) mass
    rr = max(nn_r - sum(pr.values()), 0.0)
    sel = 0.0
    for v, p in pl.items():
        if v in pr:
            sel += p * pr[v]          # heavy hitter on both sides
        else:
            sel += p * rr / dr        # matches one residual right value
    for v, p in pr.items():
        if v not in pl:
            sel += p * rl / dl
    sel += rl * rr / max(dl, dr)      # residual-residual, uniform
    return min(max(sel, 0.0), 1.0)


def _range_fraction(cs: ColumnStats, lo: float, hi: float) -> float:
    """Fraction of non-null rows with lo <= value <= hi (equi-depth
    interpolation)."""
    b = cs.bounds
    if b is None or len(b) < 2 or cs.min is None:
        return 0.33
    if hi < cs.min or lo > cs.max:
        return 0.0
    # position of a value in row-fraction space: bucket index + linear
    # interpolation inside the bucket
    nb = len(b) - 1

    def frac(x: float, side: str) -> float:
        i = int(np.searchsorted(b, x, side="left" if side == "lo" else "right"))
        if i <= 0:
            return 0.0
        if i > nb:
            return 1.0
        lo_b, hi_b = b[i - 1], b[min(i, nb)]
        inner = 0.0 if hi_b <= lo_b else (x - lo_b) / (hi_b - lo_b)
        return ((i - 1) + min(max(inner, 0.0), 1.0)) / nb

    f = frac(hi, "hi") - frac(lo, "lo")
    return min(max(f, 0.0), 1.0)


def _conjuncts(cond):
    from tidb_tpu_torch.expression.expr import Call

    if isinstance(cond, Call) and cond.op == "and":
        for a in cond.args:
            yield from _conjuncts(a)
    else:
        yield cond


_CMP = {"eq", "ne", "lt", "le", "gt", "ge"}


def _pred_selectivity(stats: TableStats, pred, uid_to_col: Dict[str, str]) -> float:
    from tidb_tpu_torch.expression.expr import Call, ColumnRef, InList, Literal

    if isinstance(pred, Call) and pred.op in _CMP and len(pred.args) == 2:
        a, b = pred.args
        if isinstance(b, ColumnRef) and isinstance(a, Literal):
            a, b = b, a
            flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}
            op = flip.get(pred.op, pred.op)
        else:
            op = pred.op
        if isinstance(a, ColumnRef) and isinstance(b, Literal) and b.value is not None:
            col = uid_to_col.get(a.name)
            cs = stats.cols.get(col) if col else None
            if cs is None:
                return {"eq": 0.1, "ne": 0.9}.get(op, 0.33)
            nn = max(stats.n_rows - cs.null_count, 1)
            v = float(b.value)
            if op == "eq":
                return min(1.0 / max(cs.ndv, 1), 1.0) * (nn / max(stats.n_rows, 1))
            if op == "ne":
                return (1.0 - 1.0 / max(cs.ndv, 1)) * (nn / max(stats.n_rows, 1))
            if op in ("lt", "le"):
                f = _range_fraction(cs, -np.inf, v)
            else:
                f = _range_fraction(cs, v, np.inf)
            return f * (nn / max(stats.n_rows, 1))
    if isinstance(pred, InList) and isinstance(pred.arg, ColumnRef):
        col = uid_to_col.get(pred.arg.name)
        cs = stats.cols.get(col) if col else None
        if cs is not None:
            f = min(len(pred.values) / max(cs.ndv, 1), 1.0)
            return 1.0 - f if pred.negated else f
    if isinstance(pred, Call) and pred.op == "or":
        s = 0.0
        for a in pred.args:
            s = s + _pred_selectivity(stats, a, uid_to_col) * (1 - s)
        return min(s, 1.0)
    if isinstance(pred, Call) and pred.op == "is_null":
        arg = pred.args[0]
        if isinstance(arg, ColumnRef):
            col = uid_to_col.get(arg.name)
            cs = stats.cols.get(col) if col else None
            if cs is not None:
                return cs.null_count / max(stats.n_rows, 1)
    return 0.33


def scan_selectivity(table, cond, uid_to_col: Dict[str, str]) -> float:
    """Estimated fraction of rows passing `cond` (compiled IR over scan
    uids); falls back to fixed heuristics without fresh stats."""
    stats = table_stats(table)
    if stats is None or stats.n_rows == 0:
        # between analyzes the segment store's zone maps still give
        # per-column min/max + null counts — range predicates estimate
        # against real bounds instead of the 0.25-per-conjunct guess
        stats = zone_map_stats(table)
    if stats is None or stats.n_rows == 0:
        n = sum(1 for _ in _conjuncts(cond))
        return 0.25 ** min(n, 2)
    sel = 1.0
    for pred in _conjuncts(cond):
        sel *= _pred_selectivity(stats, pred, uid_to_col)
    return min(max(sel, 1.0 / max(stats.n_rows, 1)), 1.0)
