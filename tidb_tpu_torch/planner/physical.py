"""Physical plan (ref: planner/core Physical* operators + EXPLAIN).

Lowering is algorithm selection: aggregation picks a device strategy
(packed-code segment-sum vs generic), joins pick a build side from row
estimates, Sort+Limit fuses to TopN. Every node is annotated with `task`:
"device" operators run inside jitted fragments on TPU; "root" operators
run host-side on materialized (small) results — mirroring the reference's
coprocessor-vs-root split.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from tidb_tpu_torch.planner.binder import PlanCol
from tidb_tpu_torch.planner.logical import (
    AggSpec,
    LAggregate,
    LJoin,
    LLimit,
    LProjection,
    LScan,
    LSelection,
    LSort,
    LUnion,
    LWindow,
    LogicalPlan,
)

__all__ = [
    "PhysicalPlan", "PScan", "PSelection", "PProjection", "PHashAgg",
    "PHashJoin", "PSort", "PTopN", "PLimit", "PUnion", "PWindow",
    "PPointGet", "PIndexRangeScan", "PPartitionScan", "PIndexJoin",
    "lower", "explain_text",
]


@dataclass
class PhysicalPlan:
    schema: List[PlanCol] = field(default_factory=list)
    children: List["PhysicalPlan"] = field(default_factory=list)
    est_rows: float = 0.0
    task: str = "device"

    @property
    def child(self) -> "PhysicalPlan":
        return self.children[0]

    def op_name(self) -> str:
        return type(self).__name__[1:]

    def op_info(self) -> str:
        return ""


@dataclass
class PScan(PhysicalPlan):
    db: str = ""
    table_name: str = ""
    table: object = None
    pushed_cond: object = None

    def op_name(self):
        return "TableFullScan"

    def op_info(self):
        info = f"table:{self.table_name}"
        if self.pushed_cond is not None:
            info += ", pushed_filter"
        return info


@dataclass
class PPointGet(PScan):
    """Unique-index point access (ref: planner/core point_get_plan.go →
    PointGetExecutor; SURVEY.md:91 IndexLookUp's index→row path). The
    full pushed_cond is retained, so every execution path — including
    ones that treat this as a plain scan — stays correct; the point
    executor is the O(log n) fast path."""

    index_name: str = ""
    key_values: Tuple = ()
    # the pushed filter is EXACTLY the key equalities: the unique-index
    # probe already enforces it, so the executor skips the residual
    # evaluation (ref: PointGetExecutor reads by key, no Selection)
    cond_covered: bool = False

    def op_name(self):
        return "PointGet"

    def op_info(self):
        return (f"table:{self.table_name}, index:{self.index_name}, "
                f"key:{tuple(self.key_values)!r}"
                + (", key_only" if self.cond_covered else ""))


@dataclass
class PIndexRangeScan(PScan):
    """Index range access (ref: planner/core's IndexRangeScan feeding
    IndexLookUpExecutor, SURVEY.md:91): equality literals pin a prefix
    of the index key, an optional [lo, hi] interval bounds the next key
    column, and the executor binary-searches the sorted index cache
    (storage/table.py index_range_lookup) into a compact row-id set.
    The full pushed_cond is retained so residual conjuncts compose and
    plain-scan fallback paths stay correct."""

    index_name: str = ""
    eq_values: Tuple = ()
    range_lo: object = None
    range_hi: object = None
    lo_incl: bool = True
    hi_incl: bool = True

    def op_name(self):
        return "IndexRangeScan"

    def op_info(self):
        parts = [f"table:{self.table_name}", f"index:{self.index_name}"]
        if self.eq_values:
            parts.append(f"eq:{tuple(self.eq_values)!r}")
        if self.range_lo is not None or self.range_hi is not None:
            lo = "-inf" if self.range_lo is None else str(self.range_lo)
            hi = "+inf" if self.range_hi is None else str(self.range_hi)
            lb = "[" if self.lo_incl else "("
            rb = "]" if self.hi_incl else ")"
            parts.append(f"range:{lb}{lo},{hi}{rb}")
        return ", ".join(parts)


@dataclass
class PPartitionScan(PScan):
    """Pruned access over a partitioned table (ref: the planner's
    partition pruning feeding per-partition scans): the WHERE's bounds
    on the partition column keep only matching partitions; the executor
    reads those partitions' cached row-id sets (storage/table.py
    partition_rows) instead of the full table."""

    part_ids: Tuple[int, ...] = ()
    part_names: Tuple[str, ...] = ()

    def op_name(self):
        return "PartitionScan"

    def op_info(self):
        return (f"table:{self.table_name}, "
                f"partitions:{','.join(self.part_names)}")


# a gathered index row costs more than a streamed scan row (random access
# + eager residual eval); range access must be selective enough to pay it
_RANGE_ROW_COST = 4.0


def inject_point_get(plan: PhysicalPlan) -> PhysicalPlan:
    """Access-path selection over base scans: replace full scans with
    PPointGet where the pushed filter pins a unique index with
    integer-typed equality literals, else with PIndexRangeScan where
    equalities pin an index prefix (plus an optional interval on the
    next key column) selectively enough to beat the scan."""
    from tidb_tpu_torch.expression.expr import Call, ColumnRef, Literal
    from tidb_tpu_torch.statistics import table_stats, _range_fraction
    from tidb_tpu_torch.types import TypeKind
    import numpy as np

    def _int_col_lit(a, b, uid_to_col):
        """Resolved (PlanCol, int literal) for an int-typed
        col-vs-literal compare, else None. Plain INT columns compared
        to INT literals only: other int64-backed kinds (DECIMAL scale,
        DATE epoch days, ...) store RESCALED encodings that a raw
        literal does not match — the compiler rescales at eval time,
        but an index key probe built from the literal would miss."""
        if not (isinstance(a, ColumnRef) and isinstance(b, Literal)
                and b.value is not None):
            return None
        col = uid_to_col.get(a.name)
        if col is None:
            return None
        if (col.type_.kind != TypeKind.INT or b.type_.kind != TypeKind.INT
                or not isinstance(b.value, (int, np.integer))):
            return None
        return col, b

    def collect_bounds(cond, uid_to_col):
        """Per column name: equality literal and/or accumulated range
        bounds from the AND-tree of the pushed filter."""
        eqs, los, his = {}, {}, {}

        def visit(e):
            if isinstance(e, Call) and e.op == "and":
                for a in e.args:
                    visit(a)
                return
            if isinstance(e, Call) and e.op in ("eq", "lt", "le", "gt", "ge") \
                    and len(e.args) == 2:
                a, b = e.args
                op = e.op
                if isinstance(a, Literal):
                    a, b = b, a
                    op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
                          "eq": "eq"}[op]
                hit = _int_col_lit(a, b, uid_to_col)
                if hit is None:
                    return
                col, lit = hit
                v = int(lit.value)
                name = col.name
                if op == "eq":
                    if name not in eqs:
                        eqs[name] = v
                elif op in ("gt", "ge"):
                    cur = los.get(name)
                    cand = (v, op == "ge")
                    # tightest lower bound wins; exclusivity breaks ties
                    if cur is None or cand[0] > cur[0] or (
                            cand[0] == cur[0] and not cand[1]):
                        los[name] = cand
                else:
                    cur = his.get(name)
                    cand = (v, op == "le")
                    if cur is None or cand[0] < cur[0] or (
                            cand[0] == cur[0] and not cand[1]):
                        his[name] = cand

        visit(cond)
        return eqs, los, his

    def cond_covered_by_key(cond, key_cols, eqs, uid_to_col):
        """True when EVERY conjunct of the pushed filter is an integer
        equality on a key column matching the probe value — then the
        unique-index lookup subsumes the filter and the executor can
        skip the residual evaluation. A conjunct on a key column with a
        DIFFERENT value (`a = 5 AND a = 6`) fails the check, and the
        plan cache's sentinel diff turns the same situation with
        parameters (`a = ? AND a = ?`) into a shape change, so a
        covered plan can never be rebound into an uncovered one."""
        keyset = set(key_cols)

        def ok(e):
            if isinstance(e, Call) and e.op == "and":
                return all(ok(a) for a in e.args)
            if not (isinstance(e, Call) and e.op == "eq"
                    and len(e.args) == 2):
                return False
            a, b = e.args
            if isinstance(a, Literal):
                a, b = b, a
            hit = _int_col_lit(a, b, uid_to_col)
            if hit is None:
                return False
            col, lit = hit
            return col.name in keyset and int(lit.value) == eqs.get(col.name)

        return ok(cond)

    def best_access(node):
        uid_to_col = {c.uid: c for c in node.schema}
        eqs, los, his = collect_bounds(node.pushed_cond, uid_to_col)
        if not eqs and not los and not his:
            return None
        table = node.table
        stats = table_stats(table)
        n_rows = float(stats.n_rows) if stats is not None \
            else float(table.live_rows)
        best = None  # (est, node)
        for idx in getattr(table, "indexes", {}).values():
            if not idx.columns:
                continue
            if getattr(idx, "state", "public") != "public":
                continue  # online-DDL write_only: not readable yet
            prefix = []
            for cname in idx.columns:
                if cname in eqs:
                    prefix.append(eqs[cname])
                else:
                    break
            if idx.unique and len(prefix) == len(idx.columns):
                return (0.0, PPointGet(
                    schema=node.schema, est_rows=1.0, db=node.db,
                    table_name=node.table_name, table=node.table,
                    pushed_cond=node.pushed_cond,
                    index_name=idx.name, key_values=tuple(prefix),
                    cond_covered=cond_covered_by_key(
                        node.pushed_cond, idx.columns, eqs, uid_to_col)))
            # range access: eq prefix plus optional interval on the
            # next key column
            lo = hi = None
            lo_incl = hi_incl = True
            if len(prefix) < len(idx.columns):
                nxt = idx.columns[len(prefix)]
                if nxt in los:
                    lo, lo_incl = los[nxt]
                if nxt in his:
                    hi, hi_incl = his[nxt]
            if not prefix and lo is None and hi is None:
                continue
            # selectivity: product of 1/ndv per eq column, times the
            # histogram fraction of the interval
            sel = 1.0
            for i, _ in enumerate(prefix):
                cs = stats.cols.get(idx.columns[i]) if stats else None
                sel *= 1.0 / max(cs.ndv, 1) if cs is not None else 0.1
            if lo is not None or hi is not None:
                nxt = idx.columns[len(prefix)]
                cs = stats.cols.get(nxt) if stats else None
                if cs is not None:
                    sel *= _range_fraction(
                        cs, -np.inf if lo is None else float(lo),
                        np.inf if hi is None else float(hi))
                else:
                    sel *= 0.33
            est = max(n_rows * sel, 1.0)
            if est * _RANGE_ROW_COST >= n_rows:
                continue  # not selective enough: the full scan wins
            if best is None or est < best[0]:
                best = (est, PIndexRangeScan(
                    schema=node.schema, est_rows=est, db=node.db,
                    table_name=node.table_name, table=node.table,
                    pushed_cond=node.pushed_cond,
                    index_name=idx.name, eq_values=tuple(prefix),
                    range_lo=lo, range_hi=hi,
                    lo_incl=lo_incl, hi_incl=hi_incl))
        return best

    def prune_partitions(node):
        """Matching partition ids for the scan's pushed bounds on the
        partition column, or None when nothing prunes."""
        import bisect

        pi = getattr(node.table.schema, "partition", None)
        if pi is None:
            return None
        uid_to_col = {c.uid: c for c in node.schema}
        eqs, los, his = collect_bounds(node.pushed_cond, uid_to_col)
        name = pi.column
        total = pi.count()
        if name in eqs:
            v = eqs[name]
            if pi.kind == "hash":
                return [v % max(pi.n_parts, 1)]
            pid = int(pi.ids_of_values(
                np.array([v]), np.array([True]))[0])
            return [pid] if pid < total else []
        if pi.kind == "hash":
            return None  # hash prunes on equality only
        lo, hi = los.get(name), his.get(name)
        if lo is None and hi is None:
            return None
        bounds = [u for u in pi.uppers if u is not None]
        lo_pid, hi_pid = 0, total - 1
        if lo is not None:
            v, incl = lo
            lo_pid = bisect.bisect_right(bounds, v if incl else v + 1)
        if hi is not None:
            v, incl = hi
            hi_pid = min(bisect.bisect_right(bounds, v if incl else v - 1),
                         total - 1)
        if lo_pid > hi_pid or lo_pid >= total:
            return []
        return list(range(lo_pid, hi_pid + 1))

    def rewrite(node):
        node.children = [rewrite(c) for c in node.children]
        if (type(node) is PScan and node.table is not None
                and node.pushed_cond is not None):
            best = best_access(node)
            if best is not None:
                return best[1]
            kept = prune_partitions(node)
            pi = getattr(node.table.schema, "partition", None)
            if kept is not None and pi is not None \
                    and len(kept) < pi.count():
                frac = max(len(kept), 0) / max(pi.count(), 1)
                return PPartitionScan(
                    schema=node.schema,
                    est_rows=max(node.est_rows * frac, 0.0),
                    db=node.db, table_name=node.table_name,
                    table=node.table, pushed_cond=node.pushed_cond,
                    part_ids=tuple(kept),
                    part_names=tuple(pi.part_name(p) for p in kept))
        return node

    return rewrite(plan)


@dataclass
class PSelection(PhysicalPlan):
    cond: object = None


@dataclass
class PProjection(PhysicalPlan):
    exprs: List = field(default_factory=list)
    n_visible: Optional[int] = None


@dataclass
class PHashAgg(PhysicalPlan):
    group_exprs: List = field(default_factory=list)
    group_uids: List[str] = field(default_factory=list)
    aggs: List[AggSpec] = field(default_factory=list)
    strategy: str = "generic"  # "segment" (packed small key space) | "generic"

    def op_name(self):
        return "HashAgg"

    def op_info(self):
        funcs = ", ".join(
            f"{a.func}({'distinct ' if a.distinct else ''}{'*' if a.arg is None else '...'})"
            for a in self.aggs
        )
        return f"group:{len(self.group_exprs)} [{funcs}] strategy:{self.strategy}"


@dataclass
class PHashJoin(PhysicalPlan):
    kind: str = "inner"
    eq_left: List = field(default_factory=list)   # exprs over probe child
    eq_right: List = field(default_factory=list)  # exprs over build child
    other_cond: object = None
    build_side: int = 1  # child index used as build side
    exists_sem: bool = False  # see LJoin.exists_sem

    def op_name(self):
        return "HashJoin"

    def op_info(self):
        return f"{self.kind} join, build:child[{self.build_side}], keys:{len(self.eq_left)}"


@dataclass
class PIndexJoin(PhysicalPlan):
    """Index-lookup join (ref: executor's IndexLookUpJoin / the memo's
    access-path alternative, SURVEY.md:88-89): ONE child — the outer —
    plus a static inner base-table scan probed through the sorted index
    cache, O(log n) per outer row. Chosen by the cascades memo when the
    probe cost beats the hash join's exchange + local work."""

    kind: str = "inner"
    eq_outer: List = field(default_factory=list)   # exprs over the outer
    index_name: str = ""
    inner_table: object = None
    inner_table_name: str = ""
    inner_schema: List[PlanCol] = field(default_factory=list)
    inner_key_cols: List[str] = field(default_factory=list)  # index order
    inner_cond: object = None        # inner scan's pushed filter (residual)
    other_cond: object = None
    task: str = "root"

    def op_name(self):
        return "IndexJoin"

    def op_info(self):
        return (f"inner table:{self.inner_table_name}, "
                f"index:{self.index_name}, keys:{len(self.eq_outer)}")


def _lower_index_join(plan, l, est):
    """LJoin annotated by the memo -> PIndexJoin; None if the shape
    drifted since annotation (falls back to the hash join)."""
    from tidb_tpu_torch.expression.expr import ColumnRef

    inner = plan.children[1]
    if not isinstance(inner, LScan) or inner.table is None:
        return None
    idx = getattr(inner.table, "indexes", {}).get(plan.index_join)
    if idx is None:
        return None
    uid_to_name = {c.uid: c.name for c in inner.schema}
    by_col = {}
    for oe, ie in plan.eq_conds:
        if not isinstance(ie, ColumnRef):
            return None
        name = uid_to_name.get(ie.name)
        if name is None or name in by_col:
            return None
        by_col[name] = oe
    key_cols = list(idx.columns[: len(by_col)])
    if set(key_cols) != set(by_col):
        return None
    return PIndexJoin(
        schema=plan.schema, children=[l], est_rows=est,
        kind=plan.kind, eq_outer=[by_col[c] for c in key_cols],
        index_name=idx.name, inner_table=inner.table,
        inner_table_name=inner.table_name, inner_schema=list(inner.schema),
        inner_key_cols=key_cols, inner_cond=inner.pushed_cond,
        other_cond=plan.other_cond)


@dataclass
class PSort(PhysicalPlan):
    items: List[Tuple[object, bool]] = field(default_factory=list)
    task: str = "root"


@dataclass
class PWindow(PhysicalPlan):
    func: str = "row_number"
    args: List[object] = field(default_factory=list)
    partition_by: List[object] = field(default_factory=list)
    order_by: List[Tuple[object, bool]] = field(default_factory=list)
    out_uid: str = ""
    out_type: object = None
    params: tuple = ()
    frame: object = None
    task: str = "root"

    def op_info(self):
        return (f"{self.func} over(partition:{len(self.partition_by)} "
                f"order:{len(self.order_by)})")


@dataclass
class PTopN(PhysicalPlan):
    items: List[Tuple[object, bool]] = field(default_factory=list)
    count: int = 0
    offset: int = 0
    task: str = "root"
    # per-shard partial top-k descriptor (resolve_topn_pushdown): each
    # sort item mapped onto the distributed agg's group-key/state slots
    pushdown: object = None

    def op_info(self):
        info = f"limit:{self.count} offset:{self.offset}"
        if self.pushdown is not None:
            info += ", partial_topn:device"
        return info


def resolve_topn_pushdown(topn: PTopN):
    """Map a TopN's sort items onto the group-key/agg-state slots of a
    generic-strategy HashAgg reached through pass-through projections —
    the mesh analogue of the reference's TopN-into-coprocessor pushdown
    (SURVEY.md:93). Returns (agg, [(kind, index, desc), ...]) with kind
    in {key, cnt, sum, min, max, avg}, or None when any item fails to
    resolve (a Selection/HAVING between TopN and agg, a computed sort
    expression, DISTINCT aggregates). The per-shard top-k is a superset
    filter: the root TopNExec still applies the exact host ordering."""
    from tidb_tpu_torch.expression.expr import ColumnRef

    k = topn.count + topn.offset
    if k <= 0 or k > (1 << 18):
        return None  # a huge k gains nothing over fetching every group
    node = topn.child
    # walk pass-through projections, accumulating uid -> expr maps;
    # projections are 1:1 on rows so they never change which groups
    # belong in the top k — a Selection (HAVING) would, so it bails
    maps = []
    while isinstance(node, PProjection):
        maps.append({c.uid: e for c, e in zip(node.schema, node.exprs)})
        node = node.child
    if not isinstance(node, PHashAgg) or node.strategy != "generic":
        return None
    if not node.group_exprs or any(a.distinct for a in node.aggs):
        return None
    key_of = {uid: i for i, uid in enumerate(node.group_uids)}
    agg_of = {a.uid: j for j, a in enumerate(node.aggs)}
    resolved = []
    for expr, desc in topn.items:
        e = expr
        for m in maps:  # outermost projection first
            if not isinstance(e, ColumnRef):
                return None
            e = m.get(e.name)
            if e is None:
                return None
        if not isinstance(e, ColumnRef):
            return None
        if e.name in key_of:
            resolved.append(("key", key_of[e.name], desc))
        elif e.name in agg_of:
            j = agg_of[e.name]
            func = node.aggs[j].func
            kind = {"count": "cnt", "sum": "sum", "min": "min",
                    "max": "max", "avg": "avg"}.get(func)
            if kind is None:
                return None
            resolved.append((kind, j, desc))
        else:
            return None
    return node, resolved


@dataclass
class PLimit(PhysicalPlan):
    count: int = 0
    offset: int = 0
    task: str = "root"


@dataclass
class PUnion(PhysicalPlan):
    all: bool = True


# ---------------------------------------------------------------------------
# row estimation (ref: statistics feeding the cost model; here: live row
# counts + fixed selectivities — ANALYZE histograms can refine later)
# ---------------------------------------------------------------------------

_SEL_FILTER = 0.25


def resolve_scan_col(plan: LogicalPlan, uid: str):
    """Trace a column uid to its defining base-table column (through
    pass-through projections). Returns (table, column_name) or None."""
    from tidb_tpu_torch.expression.expr import ColumnRef

    if isinstance(plan, LScan):
        for c in plan.schema:
            if c.uid == uid:
                return (plan.table, c.name) if plan.table is not None else None
        return None
    if isinstance(plan, LProjection):
        for c, e in zip(plan.schema, plan.exprs):
            if c.uid == uid:
                if isinstance(e, ColumnRef):
                    return resolve_scan_col(plan.child, e.name)
                return None
    for ch in plan.children:
        r = resolve_scan_col(ch, uid)
        if r is not None:
            return r
    return None


def _eq_ndv(child: LogicalPlan, expr, child_rows: float) -> Optional[float]:
    """NDV of a join-key expression over `child`, clamped by the child's
    estimated rows (filters reduce distinct counts)."""
    from tidb_tpu_torch.expression.expr import ColumnRef, Lookup

    from tidb_tpu_torch.statistics import column_ndv

    # a collation-canon (or other dictionary) gather cannot raise the
    # distinct count: estimate through to the underlying column
    while isinstance(expr, Lookup):
        expr = expr.arg
    if not isinstance(expr, ColumnRef):
        return None
    r = resolve_scan_col(child, expr.name)
    if r is None:
        return None
    ndv = column_ndv(r[0], r[1])
    if ndv is None:
        return None
    return max(min(ndv, child_rows), 1.0)


def _equated_uids(plan: LogicalPlan, uid: str) -> set:
    """`uid` and every column an inner join inside `plan` equates with it."""
    from tidb_tpu_torch.expression.expr import ColumnRef, Lookup

    pairs = []
    stack = [plan]
    while stack:
        p = stack.pop()
        if isinstance(p, LJoin) and p.kind == "inner":
            for a, b in p.eq_conds:
                while isinstance(a, Lookup):
                    a = a.arg
                while isinstance(b, Lookup):
                    b = b.arg
                if isinstance(a, ColumnRef) and isinstance(b, ColumnRef):
                    pairs.append((a.name, b.name))
        stack.extend(p.children)
    out = {uid}
    grew = True
    while grew:
        grew = False
        for a, b in pairs:
            if (a in out) != (b in out):
                out |= {a, b}
                grew = True
    return out


def _key_domain(child: LogicalPlan, expr) -> Optional[float]:
    """Distinct values a join key can take where no statistic counts them:
    a single-column PRIMARY or UNIQUE key holds each value of its table
    once, so its domain is that table's live rows, and a column an inner
    join inside `child` equates with such a key shares the domain (TPC-H
    Q5's s_nationkey, joined to nation, ranges over nation's 25 keys).
    Not clamped to `child`'s estimated rows: a filter drops key values
    but not the domain the other side's values are drawn from."""
    from tidb_tpu_torch.expression.expr import ColumnRef, Lookup

    while isinstance(expr, Lookup):
        expr = expr.arg
    if not isinstance(expr, ColumnRef):
        return None
    best = None
    for uid in _equated_uids(child, expr.name):
        r = resolve_scan_col(child, uid)
        if r is None:
            continue
        table, col = r
        indexes = getattr(table, "indexes", None) or {}
        if any(ix.unique and list(ix.columns) == [col]
               and getattr(ix, "state", "public") == "public"
               for ix in indexes.values()):
            n = float(table.live_rows)
            best = n if best is None else min(best, n)
    return None if best is None else max(best, 1.0)


def _key_col_stats(child: LogicalPlan, expr):
    """(TableStats, ColumnStats) for a join-key column with FRESH stats,
    else None. Fresh matters: MCV values are only meaningful against the
    analyzed snapshot."""
    from tidb_tpu_torch.expression.expr import ColumnRef

    from tidb_tpu_torch.statistics import table_stats

    if not isinstance(expr, ColumnRef):
        return None
    r = resolve_scan_col(child, expr.name)
    if r is None:
        return None
    s = table_stats(r[0])
    if s is None:
        return None
    cs = s.cols.get(r[1])
    return (s, cs) if cs is not None else None


def eq_join_rows(left: LogicalPlan, right: LogicalPlan, eq_conds,
                 l: float, r: float, kind: str = "inner") -> float:
    """Equi-join output estimate shared by the cost display (_estimate)
    and both join orderers (rules._greedy_order, cascades).

    Per key pair, in preference order: MCV-matched selectivity when both
    sides have fresh analyzed stats (statistics.eq_join_selectivity —
    catches skewed keys the uniformity rule misestimates by orders of
    magnitude), else |L|*|R| / max(ndv_l, ndv_r) from whichever side has
    an NDV (sketch-maintained under churn), a side without one counting
    its key's unique-key domain (_key_domain), else skipped. With no
    usable key the estimate falls back to max(|L|,|R|), which holds only
    where one side's key is unique there: a key that both sides repeat
    (Q5's nation keys) must reach the NDV rule through its domain, or
    its SF^2-sized product is estimated at one side's rows. A LEFT join emits every
    left row at least once, so its estimate floors at |L|.

    Plan feedback (ISSUE 15): when a previous execution RECORDED this
    join's actual output cardinality (keyed by the base-table columns
    its equalities resolve to) and planning runs with
    tidb_tpu_plan_feedback hints installed, the observed count
    overrides the heuristic — runtime truth beats any selectivity
    model (correlated filters shift key distributions no per-column
    statistic can see)."""
    from tidb_tpu_torch.statistics import eq_join_selectivity

    from tidb_tpu_torch.planner import feedback as _fb

    hints = _fb.current_hints()
    if hints is not None:
        got = hints.join_rows(left, right, eq_conds)
        if got is not None:
            out = max(min(float(got), l * r), 1.0)
            return max(out, l) if kind == "left" else out

    sel = None
    for le, re_ in eq_conds:
        kl = _key_col_stats(left, le)
        kr = _key_col_stats(right, re_)
        if kl is not None and kr is not None and (
                kl[1].mcv is not None or kr[1].mcv is not None):
            s = eq_join_selectivity(kl[0], kl[1], kr[0], kr[1])
            sel = (sel if sel is not None else 1.0) * max(s, 1e-18)
            continue
        nl = _eq_ndv(left, le, l)
        nr = _eq_ndv(right, re_, r)
        if nl is None:
            nl = _key_domain(left, le)
        if nr is None:
            nr = _key_domain(right, re_)
        if nl is None and nr is None:
            continue
        d = max(nl or 1.0, nr or 1.0)
        sel = (sel if sel is not None else 1.0) / d
    out = max(l, r) if sel is None else max(l * r * sel, 1.0)
    if kind == "left":
        out = max(out, l)
    return out


def _estimate(plan: LogicalPlan) -> float:
    from tidb_tpu_torch.statistics import scan_selectivity, table_stats

    if isinstance(plan, LScan):
        if plan.table is None:
            return 1.0
        s = table_stats(plan.table)
        n = float(s.n_rows) if s is not None else float(plan.table.live_rows)
        if plan.pushed_cond is not None:
            # plan feedback (ISSUE 15): an observed selectivity for this
            # (table, filter) shape — recorded where a past execution
            # knew the actual — beats the histogram guess
            from tidb_tpu_torch.planner import feedback as _fb

            hints = _fb.current_hints()
            if hints is not None:
                uid_to_name = {c.uid: c.name for c in plan.schema}
                got = hints.scan_rows(plan.table, plan.table_name,
                                      plan.pushed_cond, uid_to_name, n)
                if got is not None:
                    return max(min(got, n), 1.0)
            if s is not None:
                uid_to_col = {c.uid: c.name for c in plan.schema}
                n *= scan_selectivity(plan.table, plan.pushed_cond, uid_to_col)
            else:
                n *= _SEL_FILTER
        return max(n, 1.0)
    if isinstance(plan, LSelection):
        return max(_estimate(plan.child) * _SEL_FILTER, 1.0)
    if isinstance(plan, LAggregate):
        n = _estimate(plan.child)
        if not plan.group_exprs:
            return 1.0
        # with stats: groups bounded by the product of key NDVs
        prod = 1.0
        known = True
        for g in plan.group_exprs:
            ndv = _eq_ndv(plan.child, g, n)
            if ndv is None:
                known = False
                break
            prod = min(prod * ndv, 1e18)
        if known:
            return max(min(n, prod), 1.0)
        return max(min(n, n ** 0.75), 1.0)
    if isinstance(plan, LJoin):
        l = _estimate(plan.children[0])
        r = _estimate(plan.children[1])
        if plan.kind in ("semi", "anti"):
            return max(l * 0.5, 1.0)
        if plan.eq_conds:
            return eq_join_rows(plan.children[0], plan.children[1],
                                plan.eq_conds, l, r, plan.kind)
        return l * r
    if isinstance(plan, LUnion):
        return sum(_estimate(c) for c in plan.children)
    if isinstance(plan, LLimit):
        return float(plan.count)
    if plan.children:
        return _estimate(plan.children[0])
    return 1.0


# packed-code segment aggregation applies when every group key is a dict
# code or bool with known small cardinality; bound on the packed domain:
SEGMENT_DOMAIN_LIMIT = 1 << 22  # 4M accumulator slots


def _segment_domain(agg: LAggregate) -> Optional[List[int]]:
    """If all group keys have small known domains, return their sizes."""
    from tidb_tpu_torch.expression.expr import ColumnRef, Lookup
    from tidb_tpu_torch.types import TypeKind

    sizes = []
    child_cols = {c.uid: c for c in agg.child.schema}
    for g in agg.group_exprs:
        d = getattr(g, "_dict", None)
        if d is None and isinstance(g, ColumnRef):
            c = child_cols.get(g.name)
            d = c.dict_ if c else None
        if d is not None:
            sizes.append(max(len(d), 1))
        elif (isinstance(g, Lookup) and g.type_.kind == TypeKind.STRING
                and g.table):
            # a string-typed gather (collation canon, UPPER, ...) maps
            # into code space bounded by its LUT's largest output —
            # plan rewrites drop attached _dict objects, so read the
            # domain off the table itself
            sizes.append(int(max(g.table)) + 1)
        elif g.type_.kind == TypeKind.BOOL:
            sizes.append(2)
        else:
            return None
    prod = 1
    for s in sizes:
        prod *= s
    if prod == 0 or prod > SEGMENT_DOMAIN_LIMIT:
        return None
    return sizes


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------

def lower(plan: LogicalPlan) -> PhysicalPlan:
    est = _estimate(plan)

    if isinstance(plan, LScan):
        return PScan(
            schema=plan.schema, est_rows=est, db=plan.db,
            table_name=plan.table_name, table=plan.table,
            pushed_cond=plan.pushed_cond,
        )
    if isinstance(plan, LSelection):
        return PSelection(
            schema=plan.schema, children=[lower(plan.child)], est_rows=est,
            cond=plan.cond,
        )
    if isinstance(plan, LProjection):
        return PProjection(
            schema=plan.schema, children=[lower(plan.child)], est_rows=est,
            exprs=plan.exprs, n_visible=plan.n_visible,
        )
    if isinstance(plan, LAggregate):
        from tidb_tpu_torch.planner.logical import CORE_AGGS

        sizes = _segment_domain(plan)
        has_distinct = any(a.distinct for a in plan.aggs)
        # extended aggregates (bit_*, group_concat) only have host
        # generic-path implementations
        core_only = all(a.func in CORE_AGGS for a in plan.aggs)
        strategy = ("segment" if sizes is not None and not has_distinct
                    and core_only else "generic")
        node = PHashAgg(
            schema=plan.schema, children=[lower(plan.child)], est_rows=est,
            group_exprs=plan.group_exprs, group_uids=plan.group_uids,
            aggs=plan.aggs, strategy=strategy,
        )
        if sizes is not None:
            node.segment_sizes = sizes
        return node
    if isinstance(plan, LJoin):
        l = lower(plan.children[0])
        if plan.index_join is not None and plan.kind == "inner":
            ij = _lower_index_join(plan, l, est)
            if ij is not None:
                return ij
        r = lower(plan.children[1])
        eq_l = [lc for lc, _ in plan.eq_conds]
        eq_r = [rc for _, rc in plan.eq_conds]
        build = 1
        if plan.kind == "inner" and l.est_rows < r.est_rows:
            # probe the bigger side; semi/anti/left must build the inner side
            build = 0
        return PHashJoin(
            schema=plan.schema, children=[l, r], est_rows=est, kind=plan.kind,
            eq_left=eq_l, eq_right=eq_r, other_cond=plan.other_cond,
            build_side=build, exists_sem=plan.exists_sem,
        )
    if isinstance(plan, LSort):
        return PSort(schema=plan.schema, children=[lower(plan.child)], est_rows=est, items=plan.items)
    if isinstance(plan, LWindow):
        return PWindow(
            schema=plan.schema, children=[lower(plan.child)], est_rows=est,
            func=plan.func, args=plan.args, partition_by=plan.partition_by,
            order_by=plan.order_by, out_uid=plan.out_uid, out_type=plan.out_type,
            params=plan.params, frame=plan.frame)
    if isinstance(plan, LLimit):
        c = lower(plan.child)
        if isinstance(c, PSort):
            return PTopN(
                schema=plan.schema, children=c.children, est_rows=min(est, float(plan.count)),
                items=c.items, count=plan.count, offset=plan.offset,
            )
        return PLimit(schema=plan.schema, children=[c], est_rows=min(est, float(plan.count)), count=plan.count, offset=plan.offset)
    if isinstance(plan, LUnion):
        return PUnion(schema=plan.schema, children=[lower(c) for c in plan.children], est_rows=est, all=plan.all)

    raise NotImplementedError(f"lower: {type(plan).__name__}")


# ---------------------------------------------------------------------------
# EXPLAIN
# ---------------------------------------------------------------------------

def explain_text(plan: PhysicalPlan) -> str:
    """TiDB-style EXPLAIN table: id, estRows, task, operator info."""
    rows: List[Tuple[str, str, str, str]] = []

    def visit(p: PhysicalPlan, depth: int, last: bool):
        indent = ""
        if depth:
            indent = "  " * (depth - 1) + ("└─" if last else "├─")
        rows.append((indent + p.op_name(), f"{p.est_rows:.2f}", p.task, p.op_info()))
        for i, c in enumerate(p.children):
            visit(c, depth + 1, i == len(p.children) - 1)

    visit(plan, 0, True)
    w0 = max(len(r[0]) for r in rows) + 2
    w1 = max(len(r[1]) for r in rows) + 2
    w2 = max(len(r[2]) for r in rows) + 2
    lines = [f"{'id':<{w0}}{'estRows':<{w1}}{'task':<{w2}}operator info"]
    for r in rows:
        lines.append(f"{r[0]:<{w0}}{r[1]:<{w1}}{r[2]:<{w2}}{r[3]}")
    return "\n".join(lines)
