"""Memo-based join-order search (a copy of tidb_tpu/planner/cascades.py;
ref: planner/cascades — the memo/
group/group-expression machinery, applied here to the rule set that
matters most at this engine's scale: join commutativity/associativity).

The cascades engine's core is a memo of *groups* of logically equivalent
expressions, explored by transformation rules and costed bottom-up. For
inner-join trees every equivalent expression is characterized by the set
of base leaves it joins, so the memo groups are keyed by leaf subsets
(a bitmask) and exploration enumerates every connected split of each
group — exhaustive join ordering, guaranteed no worse than the greedy
orderer under the same cost model. Enabled per session via
tidb_enable_cascades_planner (the reference's sysvar of the same name);
falls back to greedy beyond MAX_LEAVES (memo size is exponential).

Cost model: shared with the greedy orderer (statistics-driven row
estimates; cost = sum over join steps of output cardinality + the
exchange volume the mesh executor would pay — hash-shuffle of both
sides vs broadcast of the smaller side, whichever is cheaper; see
rules._join_step_cost)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from tidb_tpu_torch.planner.logical import LJoin, LogicalPlan

__all__ = ["memo_join_search", "MAX_LEAVES"]

MAX_LEAVES = 10  # 2^10 groups tops; greedy handles wider joins

# memo-only local-work factor: every hash join step touches both inputs
# locally (sort/build) on top of the exchange _join_step_cost charges;
# an index join touches only outer * log2(inner) probe work. Charging
# the term uniformly keeps memo costs comparable across splits while
# letting access-path and join-order choice trade off (SURVEY.md:88-89).
LOCAL_WORK = 0.25


def _index_path(leaf, inner_exprs) -> Optional[str]:
    """Name of an index on `leaf`'s base table whose key prefix equals
    the inner-side join key columns, or None. Mirrors the PointGet
    restrictions: plain INT key columns only (other int64-backed kinds
    store rescaled encodings, and float bit patterns do not sort
    numerically, so the sorted-cache binary search would miss)."""
    from tidb_tpu_torch.expression.expr import ColumnRef
    from tidb_tpu_torch.planner.logical import LScan
    from tidb_tpu_torch.types import TypeKind

    if not isinstance(leaf, LScan) or leaf.table is None or not inner_exprs:
        return None
    uid_to_col = {c.uid: c for c in leaf.schema}
    cols = set()
    for e in inner_exprs:
        if not isinstance(e, ColumnRef):
            return None
        col = uid_to_col.get(e.name)
        if col is None or col.type_.kind != TypeKind.INT:
            return None
        cols.add(col.name)
    for idx in getattr(leaf.table, "indexes", {}).values():
        if getattr(idx, "state", "public") != "public":
            continue  # online-DDL write_only: not an access path yet
        if len(idx.columns) >= len(cols) and set(
                idx.columns[:len(cols)]) == cols:
            return idx.name
    return None


@dataclass
class GroupExpr:
    """One explored expression of a group: a join of two child groups
    (or a leaf)."""

    plan: LogicalPlan
    cost: float
    rows: float


class Memo:
    """Groups keyed by the bitmask of base leaves they cover; each group
    keeps only its winner (pruned memo — dominated expressions are
    discarded immediately, which is safe because cost is monotone in
    child cost for this rule set)."""

    def __init__(self):
        self.groups: Dict[int, GroupExpr] = {}

    def offer(self, mask: int, expr: GroupExpr) -> None:
        cur = self.groups.get(mask)
        if cur is None or expr.cost < cur.cost:
            self.groups[mask] = expr

    def best(self, mask: int) -> Optional[GroupExpr]:
        return self.groups.get(mask)


def _splits(mask: int):
    """All (s1, s2) partitions of mask into two non-empty halves,
    each pair once (s1 contains mask's lowest set bit)."""
    lowest = mask & -mask
    sub = (mask - 1) & mask
    while sub:
        if sub & lowest:
            yield sub, mask ^ sub
        sub = (sub - 1) & mask

def memo_join_search(leaves: List[LogicalPlan], eqs, others,
                     classify_edges, conj_join, pushdown_rule,
                     n_parts: int = 1):
    """Exhaustive join-order search over the memo. Returns the best
    plan, or None when the search doesn't apply (too many leaves).

    classify_edges/conj_join/pushdown_rule are the shared helpers from
    rules.py (passed in to avoid a circular import)."""
    from tidb_tpu_torch.planner.logical import LSelection
    from tidb_tpu_torch.planner.physical import _estimate, eq_join_rows

    n = len(leaves)
    if n < 2:
        return None
    if n > MAX_LEAVES:
        return _idp_search(leaves, eqs, others, classify_edges,
                           conj_join, pushdown_rule, n_parts)
    edges, leftover = classify_edges(leaves, eqs, others)

    memo = Memo()
    for i, leaf in enumerate(leaves):
        memo.offer(1 << i, GroupExpr(leaf, 0.0, float(_estimate(leaf))))

    full = (1 << n) - 1
    # bottom-up by subset size; Python ints as masks
    by_size: List[List[int]] = [[] for _ in range(n + 1)]
    for mask in range(1, full + 1):
        by_size[mask.bit_count()].append(mask)

    for size in range(2, n + 1):
        for mask in by_size[size]:
            # EVERY split is enumerated, cross splits included: the best
            # plan for a disconnected graph may require crossing late
            # ((a JOIN b) x c beats (a x c) JOIN b when ab is tiny), and
            # the cost model already penalizes cartesian blowups — a
            # "connected splits only" gate would wrongly prune them
            for s1, s2 in _splits(mask):
                g1, g2 = memo.best(s1), memo.best(s2)
                if g1 is None or g2 is None:
                    continue
                conds = []
                for ia, ib, a, b in edges:
                    if (mask >> ia & 1) and (mask >> ib & 1):
                        if (s1 >> ia & 1) and (s2 >> ib & 1):
                            conds.append((a, b))
                        elif (s1 >> ib & 1) and (s2 >> ia & 1):
                            conds.append((b, a))
                if conds:
                    rows = float(eq_join_rows(
                        g1.plan, g2.plan, conds, g1.rows, g2.rows))
                else:
                    rows = g1.rows * g2.rows
                from tidb_tpu_torch.planner.rules import _join_step_cost

                hash_cost = (_join_step_cost(g1.rows, g2.rows, rows, n_parts)
                             + LOCAL_WORK * (g1.rows + g2.rows))
                step = hash_cost
                idx_name = None
                idx_children = None
                if conds:
                    # access-path alternative: a single-leaf side whose
                    # base table indexes the join key set can be probed
                    # O(log n) per outer row on the host — no exchange,
                    # no touch of unmatched inner rows
                    import math

                    for outer_g, inner_g, inner_mask, oriented in (
                            (g1, g2, s2, conds),
                            (g2, g1, s1, [(b, a) for a, b in conds])):
                        if inner_mask.bit_count() != 1:
                            continue
                        name = _index_path(inner_g.plan,
                                           [b for _, b in oriented])
                        if name is None:
                            continue
                        idx_cost = (LOCAL_WORK * outer_g.rows
                                    * math.log2(max(inner_g.rows, 2.0))
                                    + rows)
                        if idx_cost < step:
                            step = idx_cost
                            idx_name = name
                            idx_children = (outer_g, inner_g, oriented)
                cost = g1.cost + g2.cost + step
                cur = memo.best(mask)
                if cur is not None and cost >= cur.cost:
                    continue
                # build-side choice is lower()'s job (it compares
                # post-pushdown estimates and sets build_side)
                # kind stays "inner" even with no conds — the lowering
                # treats empty eq_conds as the cross join, matching the
                # greedy orderer's convention
                if idx_name is not None:
                    og, ig, oriented = idx_children
                    plan = LJoin(
                        schema=list(og.plan.schema) + list(ig.plan.schema),
                        children=[og.plan, ig.plan],
                        kind="inner", eq_conds=oriented,
                        index_join=idx_name,
                    )
                else:
                    plan = LJoin(
                        schema=list(g1.plan.schema) + list(g2.plan.schema),
                        children=[g1.plan, g2.plan],
                        kind="inner", eq_conds=conds,
                    )
                memo.offer(mask, GroupExpr(plan, cost, rows))

    win = memo.best(full)
    if win is None:  # disconnected graph with no cross pass hit (unreachable)
        return None
    tree = win.plan
    if leftover:
        sel = LSelection(schema=list(tree.schema), children=[tree],
                         cond=conj_join(leftover))
        return pushdown_rule(sel)
    return tree


def _idp_search(leaves, eqs, others, classify_edges, conj_join,
                pushdown_rule, n_parts):
    """Iterative dynamic programming beyond MAX_LEAVES (IDP-1, the
    standard widening of exhaustive join DP): memo-optimize a CONNECTED
    window of MAX_LEAVES leaves (BFS over join edges from the
    smallest-estimate leaf), collapse the winner into one composite
    leaf, and repeat until the remaining graph fits the memo. Each
    window is exhaustively ordered under the shared cost model; only
    cross-window orderings are approximated — an 11+-table query still
    optimizes instead of falling back to greedy wholesale."""
    from tidb_tpu_torch.planner.physical import _estimate
    from tidb_tpu_torch.planner.rules import _refs

    leaves, eqs, others = list(leaves), list(eqs), list(others)
    while len(leaves) > MAX_LEAVES:
        edges, _leftover = classify_edges(leaves, eqs, others)
        adj = {i: set() for i in range(len(leaves))}
        for ia, ib, _a, _b in edges:
            adj[ia].add(ib)
            adj[ib].add(ia)
        est = [float(_estimate(l)) for l in leaves]  # once per round
        window, seen = [], set()
        # BFS whole components smallest-estimate-first: padding must
        # stay connectivity-aware — a leaf windowed without its join
        # partners would force a REAL cartesian product inside the
        # collapsed composite
        while len(window) < MAX_LEAVES and len(seen) < len(leaves):
            start = min((i for i in range(len(leaves)) if i not in seen),
                        key=est.__getitem__)
            frontier = [start]
            while frontier and len(window) < MAX_LEAVES:
                i = frontier.pop(0)
                if i in seen:
                    continue
                seen.add(i)
                window.append(i)
                frontier.extend(sorted(adj[i] - seen, key=est.__getitem__))
        uid_w = set()
        for i in window:
            uid_w |= {c.uid for c in leaves[i].schema}
        in_eqs = [p for p in eqs if (_refs(p[0]) | _refs(p[1])) <= uid_w]
        in_others = [o for o in others if _refs(o) <= uid_w]
        sub = memo_join_search([leaves[i] for i in window], in_eqs,
                               in_others, classify_edges, conj_join,
                               pushdown_rule, n_parts=n_parts)
        if sub is None:
            return None
        wset = set(window)
        in_ids = {id(p) for p in in_eqs} | {id(o) for o in in_others}
        leaves = [l for i, l in enumerate(leaves) if i not in wset] + [sub]
        eqs = [p for p in eqs if id(p) not in in_ids]
        others = [o for o in others if id(o) not in in_ids]
    return memo_join_search(leaves, eqs, others, classify_edges,
                            conj_join, pushdown_rule, n_parts=n_parts)
