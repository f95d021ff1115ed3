"""Rule-based logical optimization (ref: planner/core logicalOptimize's
rule list: constant folding, predicate pushdown, column pruning, ...).

Rules here are functions LogicalPlan -> LogicalPlan, applied in a fixed
order. The set matters for the TPU backend: pushing predicates into the
scan means the filter mask is computed inside the same jitted fragment
that stages the columns (the coprocessor-pushdown analogue), and pruning
decides which columns get staged to HBM at all.
"""

from __future__ import annotations

from typing import List, Optional, Set

from tidb_tpu_torch.expression.compiler import eval_expr
from tidb_tpu_torch.expression.expr import (
    AggRef,
    Call,
    Case,
    Cast,
    ColumnRef,
    Expr,
    InList,
    Literal,
    Lookup,
    walk,
)
from tidb_tpu_torch.planner.logical import (
    AggSpec,
    LAggregate,
    LJoin,
    LLimit,
    LProjection,
    LScan,
    LSelection,
    LSort,
    LWindow,
    LUnion,
    LogicalPlan,
)
from tidb_tpu_torch.types import BOOL, TypeKind

__all__ = ["optimize_logical", "fold_constants"]

# ---------------------------------------------------------------------------
# constant folding
# ---------------------------------------------------------------------------

def fold_constants(e: Expr) -> Expr:
    """Bottom-up folding of all-literal subtrees via the real compiler on a
    1-row chunk — semantics identical to runtime by construction."""
    if isinstance(e, Call):
        args = tuple(fold_constants(a) for a in e.args)
        e = Call(type_=e.type_, op=e.op, args=args)
        # Kleene shortcuts with literal TRUE/FALSE
        if e.op == "and":
            lits = [a for a in args if isinstance(a, Literal)]
            if any(a.value is False for a in lits):
                return Literal(type_=BOOL, value=False)
            non = [a for a in args if not (isinstance(a, Literal) and a.value is True)]
            if not non:
                return Literal(type_=BOOL, value=True)
            if len(non) == 1 and not any(isinstance(a, Literal) and a.value is None for a in args):
                return non[0]
        if e.op == "or":
            lits = [a for a in args if isinstance(a, Literal)]
            if any(a.value is True for a in lits):
                return Literal(type_=BOOL, value=True)
            non = [a for a in args if not (isinstance(a, Literal) and a.value is False)]
            if not non:
                return Literal(type_=BOOL, value=False)
            if len(non) == 1 and not any(isinstance(a, Literal) and a.value is None for a in args):
                return non[0]
        if all(isinstance(a, Literal) for a in args):
            return _eval_const(e)
        return e
    if isinstance(e, Cast):
        arg = fold_constants(e.arg)
        e = Cast(type_=e.type_, arg=arg)
        if isinstance(arg, Literal):
            return _eval_const(e)
        return e
    if isinstance(e, Case):
        whens = tuple((fold_constants(c), fold_constants(r)) for c, r in e.whens)
        else_ = fold_constants(e.else_) if e.else_ is not None else None
        return Case(type_=e.type_, whens=whens, else_=else_)
    if isinstance(e, Lookup):
        return Lookup(type_=e.type_, arg=fold_constants(e.arg), table=e.table,
                      table_valid=e.table_valid)
    if isinstance(e, InList):
        return InList(type_=e.type_, arg=fold_constants(e.arg), values=e.values,
                      negated=e.negated)
    return e


def _eval_const(e: Expr) -> Literal:
    import torch

    from tidb_tpu_torch.chunk.chunk import Chunk

    dummy = Chunk({}, torch.ones(1, dtype=torch.bool))
    data, valid = eval_expr(e, dummy)
    if not bool(valid[0]):
        return Literal(type_=e.type_, value=None)
    v = data[0].item()
    if e.type_.kind == TypeKind.BOOL:
        return Literal(type_=e.type_, value=bool(v))
    if e.type_.kind == TypeKind.FLOAT:
        return Literal(type_=e.type_, value=float(v))
    return Literal(type_=e.type_, value=int(v))


def _rule_fold(plan: LogicalPlan) -> LogicalPlan:
    for i, c in enumerate(plan.children):
        plan.children[i] = _rule_fold(c)
    if isinstance(plan, LSelection):
        plan.cond = fold_constants(plan.cond)
        if isinstance(plan.cond, Literal) and plan.cond.value is True:
            return plan.child
    elif isinstance(plan, LProjection):
        plan.exprs = [fold_constants(x) for x in plan.exprs]
    elif isinstance(plan, LAggregate):
        plan.group_exprs = [fold_constants(x) for x in plan.group_exprs]
        for a in plan.aggs:
            if a.arg is not None:
                a.arg = fold_constants(a.arg)
    elif isinstance(plan, LJoin):
        plan.eq_conds = [(fold_constants(l), fold_constants(r)) for l, r in plan.eq_conds]
        if plan.other_cond is not None:
            plan.other_cond = fold_constants(plan.other_cond)
    elif isinstance(plan, LSort):
        plan.items = [(fold_constants(x), d) for x, d in plan.items]
    return plan


# ---------------------------------------------------------------------------
# predicate pushdown
# ---------------------------------------------------------------------------

def _conj_split(e: Expr) -> List[Expr]:
    if isinstance(e, Call) and e.op == "and":
        return _conj_split(e.args[0]) + _conj_split(e.args[1])
    return [e]


def _conj_join(parts: List[Expr]) -> Optional[Expr]:
    out = None
    for p in parts:
        out = p if out is None else Call(type_=BOOL, op="and", args=(out, p))
    return out


def _refs(e: Expr) -> Set[str]:
    return {n.name for n in walk(e) if isinstance(n, (ColumnRef, AggRef))}


def _subst_proj(e: Expr, mapping) -> Expr:
    """Rewrite uids through a projection (uid -> defining expr)."""
    if isinstance(e, ColumnRef):
        return mapping.get(e.name, e)
    if isinstance(e, Call):
        return Call(type_=e.type_, op=e.op, args=tuple(_subst_proj(a, mapping) for a in e.args))
    if isinstance(e, Cast):
        return Cast(type_=e.type_, arg=_subst_proj(e.arg, mapping))
    if isinstance(e, Lookup):
        return Lookup(type_=e.type_, arg=_subst_proj(e.arg, mapping), table=e.table, table_valid=e.table_valid)
    if isinstance(e, InList):
        return InList(type_=e.type_, arg=_subst_proj(e.arg, mapping), values=e.values, negated=e.negated)
    if isinstance(e, Case):
        return Case(
            type_=e.type_,
            whens=tuple((_subst_proj(c, mapping), _subst_proj(r, mapping)) for c, r in e.whens),
            else_=_subst_proj(e.else_, mapping) if e.else_ is not None else None,
        )
    return e


def _push_cond(plan: LogicalPlan, conds: List[Expr]) -> LogicalPlan:
    """Push conjuncts as far down as they can go; returns new plan."""
    if not conds:
        return _rule_pushdown(plan)

    if isinstance(plan, LScan) and plan.table is not None:
        plan.pushed_cond = _conj_join(
            ([plan.pushed_cond] if plan.pushed_cond is not None else []) + conds
        )
        return plan

    if isinstance(plan, LSelection):
        return _push_cond(plan.child, conds + _conj_split(plan.cond))

    if isinstance(plan, LProjection):
        mapping = {c.uid: x for c, x in zip(plan.schema, plan.exprs)}
        # only push through simple (non-volatile) projections
        rewritten = [_subst_proj(c, mapping) for c in conds]
        plan.children[0] = _push_cond(plan.child, rewritten)
        return plan

    if isinstance(plan, LJoin):
        left_uids = {c.uid for c in plan.children[0].schema}
        right_uids = {c.uid for c in plan.children[1].schema}
        lconds, rconds, keep = [], [], []
        for c in conds:
            r = _refs(c)
            if r <= left_uids:
                lconds.append(c)
            elif r <= right_uids and plan.kind == "inner":
                rconds.append(c)
            elif r <= right_uids and plan.kind in ("semi", "anti"):
                rconds.append(c)
            elif plan.kind in ("inner", "cross"):
                # equi conjunct across the two sides becomes a join key
                # (this is what turns comma joins into hash joins)
                if isinstance(c, Call) and c.op == "eq":
                    a, b = c.args
                    ra, rb = _refs(a), _refs(b)
                    if ra <= left_uids and rb <= right_uids:
                        plan.eq_conds.append((a, b))
                        plan.kind = "inner"
                        continue
                    if ra <= right_uids and rb <= left_uids:
                        plan.eq_conds.append((b, a))
                        plan.kind = "inner"
                        continue
                keep.append(c)
            else:
                keep.append(c)
        plan.children[0] = _push_cond(plan.children[0], lconds)
        plan.children[1] = _push_cond(plan.children[1], rconds)
        plan.children[0] = _rule_pushdown(plan.children[0]) if not lconds else plan.children[0]
        if keep and plan.kind in ("inner", "cross"):
            # cross-side non-equi conjuncts: for an inner join a post-join
            # filter and a WHERE above are identical — fuse into the join
            plan.other_cond = _conj_join(
                ([plan.other_cond] if plan.other_cond is not None else []) + keep)
            keep = []
        if keep:
            return LSelection(schema=plan.schema, children=[plan], cond=_conj_join(keep))
        return plan

    if isinstance(plan, LAggregate):
        # conds referencing only group uids could push below; round 1: stop
        plan.children[0] = _rule_pushdown(plan.child)
        return LSelection(schema=plan.schema, children=[plan], cond=_conj_join(conds))

    # default: stop here
    plan.children = [_rule_pushdown(c) for c in plan.children]
    return LSelection(schema=plan.schema, children=[plan], cond=_conj_join(conds))


def _rule_pushdown(plan: LogicalPlan) -> LogicalPlan:
    if isinstance(plan, LSelection):
        child = plan.child
        return _push_cond(child, _conj_split(plan.cond))
    plan.children = [_rule_pushdown(c) for c in plan.children]
    return plan


# ---------------------------------------------------------------------------
# column pruning
# ---------------------------------------------------------------------------

def _rule_prune(plan: LogicalPlan, required: Optional[Set[str]]) -> LogicalPlan:
    """required=None means 'all visible outputs required' (root)."""
    if isinstance(plan, LScan):
        if required is not None and plan.table is not None:
            need = set(required)
            if plan.pushed_cond is not None:
                need |= _refs(plan.pushed_cond)
            keep = [c for c in plan.schema if c.uid in need]
            if not keep and plan.schema:
                keep = [plan.schema[0]]  # COUNT(*): one column for liveness
            plan.schema = keep
        return plan

    if isinstance(plan, LSelection):
        child_req = None
        if required is not None:
            child_req = set(required) | _refs(plan.cond)
        plan.children[0] = _rule_prune(plan.child, child_req)
        if required is not None:
            plan.schema = [c for c in plan.schema if c.uid in required or c.uid in {s.uid for s in plan.child.schema}]
        plan.schema = list(plan.child.schema)
        return plan

    if isinstance(plan, LProjection):
        if required is not None:
            keep = [
                (c, x)
                for c, x in zip(plan.schema, plan.exprs)
                if c.uid in required
            ]
            # keep at least one column so COUNT(*) style plans have a stream
            if not keep:
                keep = [(plan.schema[0], plan.exprs[0])]
            plan.schema = [c for c, _ in keep]
            plan.exprs = [x for _, x in keep]
            plan.n_visible = len(plan.schema)
        child_req = set()
        for x in plan.exprs:
            child_req |= _refs(x)
        plan.children[0] = _rule_prune(plan.child, child_req)
        return plan

    if isinstance(plan, LAggregate):
        if required is not None:
            keep_aggs = [a for a in plan.aggs if a.uid in required]
            plan.aggs = keep_aggs
            plan.schema = [
                c for c in plan.schema
                if c.uid in required or c.uid in plan.group_uids
            ]
        child_req = set()
        for g in plan.group_exprs:
            child_req |= _refs(g)
        for a in plan.aggs:
            if a.arg is not None:
                child_req |= _refs(a.arg)
        # an EMPTY set is meaningful ("only structural needs below" —
        # COUNT(*) over a join must still prune to the join keys);
        # widening it to None would disable pruning entirely
        plan.children[0] = _rule_prune(plan.child, child_req)
        return plan

    if isinstance(plan, LJoin):
        if required is None:
            # 'everything required' propagates as-is: a Selection above
            # this join may reference ANY child column — pruning down to
            # the eq keys here dropped columns the parent still reads
            plan.children[0] = _rule_prune(plan.children[0], None)
            plan.children[1] = _rule_prune(plan.children[1], None)
            if plan.kind in ("semi", "anti"):
                plan.schema = list(plan.children[0].schema)
            else:
                plan.schema = (list(plan.children[0].schema)
                               + list(plan.children[1].schema))
            return plan
        child_req_l, child_req_r = set(), set()
        left_uids = {c.uid for c in plan.children[0].schema}
        right_uids = {c.uid for c in plan.children[1].schema}
        for uid in required:
            if uid in left_uids:
                child_req_l.add(uid)
            elif uid in right_uids:
                child_req_r.add(uid)
        for l, r in plan.eq_conds:
            child_req_l |= _refs(l)
            child_req_r |= _refs(r)
        if plan.other_cond is not None:
            lu = {c.uid for c in plan.children[0].schema}
            for uid in _refs(plan.other_cond):
                (child_req_l if uid in lu else child_req_r).add(uid)
        plan.children[0] = _rule_prune(plan.children[0], child_req_l or None)
        plan.children[1] = _rule_prune(plan.children[1], child_req_r or None)
        if plan.kind in ("semi", "anti"):
            plan.schema = list(plan.children[0].schema)
        else:
            plan.schema = list(plan.children[0].schema) + list(plan.children[1].schema)
        if required is not None:
            plan.schema = [c for c in plan.schema if c.uid in required or c.uid in child_req_l | child_req_r]
        return plan

    if isinstance(plan, (LSort,)):
        child_req = None
        if required is not None:
            child_req = set(required)
            for x, _ in plan.items:
                child_req |= _refs(x)
        plan.children[0] = _rule_prune(plan.child, child_req)
        plan.schema = list(plan.child.schema)
        return plan

    if isinstance(plan, LWindow):
        child_req = None
        if required is not None:
            child_req = set(required) - {plan.out_uid}
            for x in plan.args:
                child_req |= _refs(x)
            for x in plan.partition_by:
                child_req |= _refs(x)
            for x, _ in plan.order_by:
                child_req |= _refs(x)
        plan.children[0] = _rule_prune(plan.child, child_req)
        out_col = plan.schema[-1]
        plan.schema = list(plan.child.schema) + [out_col]
        return plan

    if isinstance(plan, (LLimit,)):
        plan.children[0] = _rule_prune(plan.child, required)
        plan.schema = list(plan.child.schema)
        return plan

    if isinstance(plan, LUnion):
        # all sides share output uids; prune positionally
        plan.children = [_rule_prune(c, set(required) if required is not None else None) for c in plan.children]
        plan.schema = list(plan.children[0].schema)
        return plan

    plan.children = [_rule_prune(c, None) for c in plan.children]
    return plan


# ---------------------------------------------------------------------------
# join reordering (ref: planner/core's join-reorder rule — greedy over
# statistics-driven cardinality estimates; FROM-order joins are a 10-100x
# perf cliff at scale, and a cross join blocks the distributed tier)
# ---------------------------------------------------------------------------


def _flatten_inner(plan: LogicalPlan, leaves, eqs, others):
    """Collect the maximal contiguous inner/cross-join tree."""
    if isinstance(plan, LJoin) and plan.kind in ("inner", "cross"):
        _flatten_inner(plan.children[0], leaves, eqs, others)
        _flatten_inner(plan.children[1], leaves, eqs, others)
        eqs.extend(plan.eq_conds)
        if plan.other_cond is not None:
            others.append(plan.other_cond)
    else:
        leaves.append(plan)


def _classify_edges(leaves, eqs, others):
    """Split equi-conds into cross-leaf join edges vs leftovers that
    must re-apply as a post-join filter. Shared by the greedy and
    LEADING-forced orderers."""
    uidsets = [{c.uid for c in l.schema} for l in leaves]

    def owner(refs: Set[str]) -> Optional[int]:
        for i, s in enumerate(uidsets):
            if refs and refs <= s:
                return i
        return None

    edges = []  # (leaf_i, leaf_j, expr_i, expr_j)
    leftover = list(others)
    for a, b in eqs:
        ia, ib = owner(_refs(a)), owner(_refs(b))
        if ia is None or ib is None or ia == ib:
            leftover.append(Call(type_=BOOL, op="eq", args=(a, b)))
        else:
            edges.append((ia, ib, a, b))
    return edges, leftover


def _join_step_cost(l_rows: float, r_rows: float, out_rows: float,
                    n_parts: int) -> float:
    """Mesh-aware cost of one join step: output cardinality plus the
    exchange volume the executor will pay. A hash shuffle repartitions
    BOTH sides over ICI (l + r rows); broadcasting the smaller side
    replicates it to every shard (small * n_parts) and skips the
    repartition — charge whichever the executor would pick (ref:
    planner/core's cop/mpp cost factors for exchange types)."""
    from tidb_tpu_torch.parallel.fragment import BROADCAST_LIMIT

    shuffle = l_rows + r_rows
    small = min(l_rows, r_rows)
    exch = shuffle
    if small <= BROADCAST_LIMIT:
        exch = min(exch, small * n_parts)
    return out_rows + exch


def _greedy_order(leaves, eqs, others, n_parts: int = 1) -> LogicalPlan:
    from tidb_tpu_torch.planner.physical import _estimate, eq_join_rows

    n = len(leaves)
    edges, leftover = _classify_edges(leaves, eqs, others)

    est = [_estimate(l) for l in leaves]
    start = min(range(n), key=lambda i: est[i])
    cur_set = {start}
    tree, cur_rows = leaves[start], est[start]
    remaining = set(range(n)) - cur_set

    while remaining:
        def conn_edges(c):
            out = []
            for ia, ib, a, b in edges:
                if ia in cur_set and ib == c:
                    out.append((a, b))
                elif ib in cur_set and ia == c:
                    out.append((b, a))
            return out

        def join_rows(c, conds):
            if not conds:
                return cur_rows * est[c]  # forced cross join
            return eq_join_rows(tree, leaves[c], conds, cur_rows, est[c])

        def step_cost(c, conds):
            return _join_step_cost(cur_rows, est[c], join_rows(c, conds),
                                   n_parts)

        cands = [(c, conn_edges(c)) for c in remaining]
        connected = [(c, e) for c, e in cands if e]
        pool = connected or cands  # avoid cross joins whenever possible
        best, conds = min(pool, key=lambda ce: step_cost(*ce))
        cur_rows = join_rows(best, conds)
        tree = LJoin(
            schema=list(tree.schema) + list(leaves[best].schema),
            children=[tree, leaves[best]],
            kind="inner", eq_conds=conds,
        )
        cur_set.add(best)
        remaining.discard(best)

    if leftover:
        sel = LSelection(schema=list(tree.schema), children=[tree],
                         cond=_conj_join(leftover))
        return _rule_pushdown(sel)  # re-extract eq keys / push filters
    return tree


def _leaf_name(leaf: LogicalPlan) -> Optional[str]:
    """Dominant table alias of a join leaf (for LEADING hint matching)."""
    for c in leaf.schema:
        if c.qualifier:
            return c.qualifier.lower()
    return None


def _forced_order(leaves, eqs, others, leading) -> LogicalPlan:
    """LEADING(a, b, ...) hint: join in exactly the given order (a
    prefix — unmentioned leaves follow in source order), using whatever
    equi-edges connect at each step. Mirrors the reference's
    leading-hint override of the join-reorder rule. Callers check the
    hint matches at least one leaf (_match_leading) first."""
    matched = _match_leading(leaves, leading)
    seq = matched + [i for i in range(len(leaves)) if i not in matched]

    edges, leftover = _classify_edges(leaves, eqs, others)

    cur_set = {seq[0]}
    tree = leaves[seq[0]]
    for c in seq[1:]:
        conds = []
        for ia, ib, a, b in edges:
            if ia in cur_set and ib == c:
                conds.append((a, b))
            elif ib in cur_set and ia == c:
                conds.append((b, a))
        tree = LJoin(
            schema=list(tree.schema) + list(leaves[c].schema),
            children=[tree, leaves[c]],
            kind="inner", eq_conds=conds,
        )
        cur_set.add(c)
    if leftover:
        sel = LSelection(schema=list(tree.schema), children=[tree],
                         cond=_conj_join(leftover))
        return _rule_pushdown(sel)
    return tree


def _match_leading(leaves, leading):
    """Leaf indices the LEADING names resolve to, in hint order."""
    by_name = {}
    for i, l in enumerate(leaves):
        nm = _leaf_name(l)
        if nm is not None and nm not in by_name:
            by_name[nm] = i
    # dict.fromkeys: a repeated alias in the hint must not join a leaf twice
    return list(dict.fromkeys(
        by_name[n.lower()] for n in leading if n.lower() in by_name))


def _rule_reorder(plan: LogicalPlan, leading=None, cascades=False,
                  n_parts: int = 1) -> LogicalPlan:
    if getattr(plan, "_block_boundary", False):
        leading = None  # hints don't cross into derived query blocks
    if isinstance(plan, LJoin) and plan.kind in ("inner", "cross"):
        leaves, eqs, others = [], [], []
        _flatten_inner(plan, leaves, eqs, others)
        # the hint applies to ITS query block — the topmost join group
        # here — not to derived tables / subquery joins below. A hint
        # matching no leaf (typo'd alias) is ignored entirely.
        if leading and len(leaves) >= 2 and _match_leading(leaves, leading):
            # the hint pins THIS block's order; subtrees keep the
            # session's planner mode
            leaves = [_rule_reorder(l, cascades=cascades, n_parts=n_parts)
                      for l in leaves]
            return _forced_order(leaves, eqs, others, leading)
        if len(leaves) > 2:
            leaves = [_rule_reorder(l, cascades=cascades, n_parts=n_parts)
                      for l in leaves]
            if cascades:
                from tidb_tpu_torch.planner.cascades import memo_join_search

                best = memo_join_search(leaves, eqs, others, _classify_edges,
                                        _conj_join, _rule_pushdown,
                                        n_parts=n_parts)
                if best is not None:
                    return best
            return _greedy_order(leaves, eqs, others, n_parts=n_parts)
    plan.children = [_rule_reorder(c, leading, cascades, n_parts)
                     for c in plan.children]
    return plan


# ---------------------------------------------------------------------------

def _rule_distinct_two_phase(plan: LogicalPlan) -> LogicalPlan:
    """Rewrite DISTINCT aggregates into two stacked aggregations (ref:
    the reference planner's distinct-agg-to-two-phase transform):

        Agg[G; f(DISTINCT d), sum(x), ...]
          -> Agg[G; count(d)/sum(d), sum(sx), ...]      (outer, small)
               Agg[G + d; sum(x) AS sx, ...]            (inner)

    The inner agg has no DISTINCT, so it is distributable as a mesh
    fragment; the outer agg reduces one row per (G, d) group. Applies
    when every DISTINCT agg shares one argument and the remaining aggs
    are sum/count/min/max (each re-aggregates losslessly from the
    inner's per-group value). NULL semantics hold: the NULL-d group's
    key column is NULL, which outer count()/sum() skip."""
    from tidb_tpu_torch.planner.binder import PlanCol

    plan.children = [_rule_distinct_two_phase(c) for c in plan.children]
    if not isinstance(plan, LAggregate) or not any(a.distinct for a in plan.aggs):
        return plan
    d_args = [a.arg for a in plan.aggs if a.distinct]
    if any(a is None for a in d_args) or len({repr(a) for a in d_args}) != 1:
        return plan
    if any(a.func not in ("count", "sum", "avg")
           for a in plan.aggs if a.distinct):
        return plan
    if any(a.func not in ("sum", "count", "min", "max")
           for a in plan.aggs if not a.distinct):
        return plan
    if not plan.group_uids and any(
            a.func == "count" and not a.distinct for a in plan.aggs):
        # a global COUNT re-aggregates as sum(inner counts), which is
        # NULL over an empty inner — SQL requires 0; keep the direct path
        return plan
    d_arg = d_args[0]

    child = plan.children[0]
    group_cols = list(plan.schema[:len(plan.group_uids)])
    # uids derive from the original agg uids: re-planning the same query
    # must produce identical fragment signatures or every execution pays
    # a fresh XLA compile (fragment/growth caches key on the plan repr)
    d_uid = "d2p_" + next(a.uid for a in plan.aggs if a.distinct)
    d_col = PlanCol(uid=d_uid, name="d2p", type_=d_arg.type_,
                    dict_=getattr(d_arg, "_dict", None))

    inner_aggs, inner_cols, outer_aggs = [], [], []
    outer_func = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}
    for a in plan.aggs:
        if a.distinct:
            # d is unique per outer group in the inner output
            f = "count" if a.func == "count" else a.func
            outer_aggs.append(AggSpec(
                uid=a.uid, func=f,
                arg=ColumnRef(type_=d_arg.type_, name=d_uid), type_=a.type_))
        else:
            iuid = "d2p_" + a.uid
            inner_aggs.append(AggSpec(uid=iuid, func=a.func, arg=a.arg,
                                      type_=a.type_))
            inner_cols.append(PlanCol(uid=iuid, name="d2p", type_=a.type_))
            outer_aggs.append(AggSpec(
                uid=a.uid, func=outer_func[a.func],
                arg=ColumnRef(type_=a.type_, name=iuid), type_=a.type_))

    inner = LAggregate(
        schema=group_cols + [d_col] + inner_cols,
        children=[child],
        group_exprs=list(plan.group_exprs) + [d_arg],
        group_uids=list(plan.group_uids) + [d_uid],
        aggs=inner_aggs,
    )
    return LAggregate(
        schema=plan.schema,
        children=[inner],
        group_exprs=[c.ref() for c in group_cols],
        group_uids=list(plan.group_uids),
        aggs=outer_aggs,
    )




def _rule_eager_agg(plan: LogicalPlan, cost_based: bool = False,
                    n_parts: int = 1) -> LogicalPlan:
    """Eager aggregation: push a partial aggregate below a join when
    every aggregate argument comes from one join side (ref: planner/
    core's aggregation-pushdown rule; the canonical win is Q18's
    lineitem pre-aggregated by l_orderkey before joining orders — the
    join input shrinks by the average group size BEFORE the expensive
    exchange/build).

    For inner joins, grouping side S by (its join-key exprs on the path
    + the upper group keys it supplies) and summing partials upstream
    is exact: all rows of one partial group share their join keys, so
    each partial joins to the same match set, and SUM/COUNT partials
    multiplied out by matches reproduce the row-level totals (MIN/MAX
    are duplicate-insensitive). Gated on fresh-stats evidence that the
    partial actually shrinks its side (<70%); bails on DISTINCT / AVG /
    non-inner joins on the path / expressions straddling both sides /
    global COUNT (an empty join must still report 0, not NULL)."""
    if plan.children:
        plan.children[:] = [_rule_eager_agg(c, cost_based, n_parts)
                            for c in plan.children]
    if not (isinstance(plan, LAggregate) and isinstance(plan.children[0], LJoin)):
        return plan
    agg = plan
    if any(a.distinct or a.func not in ("sum", "count", "min", "max")
           for a in agg.aggs):
        return plan
    if not agg.group_exprs and any(a.func == "count" for a in agg.aggs):
        return plan  # global COUNT over an empty join must be 0
    arg_refs: Set[str] = set()
    for a in agg.aggs:
        if a.arg is not None:
            arg_refs |= _refs(a.arg)
    if not arg_refs:
        return plan  # COUNT(*) only: no side owns it more than another

    # descend the join tree to the unique subtree S holding every agg
    # argument; every join on the path must be inner, and its conds must
    # not mix S columns with the other side inside one expression
    path = []  # (join, side) from top to S's parent
    node = agg.child if hasattr(agg, "child") else agg.children[0]
    while isinstance(node, LJoin):
        luids = {c.uid for c in node.children[0].schema}
        ruids = {c.uid for c in node.children[1].schema}
        if arg_refs <= luids:
            side = 0
        elif arg_refs <= ruids:
            side = 1
        else:
            return plan
        # inner joins preserve the multiplicity math on either side;
        # left/semi/anti joins never DUPLICATE their left rows (they
        # filter or NULL-pad), so descending their left side is exact —
        # their right side would change partial-group membership
        if node.kind != "inner" and not (
                side == 0 and node.kind in ("left", "semi", "anti")):
            return plan
        path.append((node, side))
        node = node.children[side]
    if not path:
        return plan
    S = node
    s_uids = {c.uid for c in S.schema}

    # collect S-side join-key exprs along the path and upper group keys
    # that S supplies; anything else touching S bails
    key_exprs: List[Expr] = []  # identity-ordered

    def add_key(e: Expr) -> int:
        for i, k in enumerate(key_exprs):
            if k is e or (isinstance(k, ColumnRef) and isinstance(e, ColumnRef)
                          and k.name == e.name):
                return i
        key_exprs.append(e)
        return len(key_exprs) - 1

    join_key_slots = []  # (join, side-expr index in eq_conds, key slot)
    for join, side in path:
        if join.other_cond is not None and _refs(join.other_cond) & s_uids:
            return plan
        for ci, (le, re_) in enumerate(join.eq_conds):
            se = le if side == 0 else re_
            oe = re_ if side == 0 else le
            if _refs(oe) & s_uids:
                return plan
            if _refs(se) & s_uids:
                if not _refs(se) <= s_uids:
                    return plan
                join_key_slots.append((join, ci, add_key(se)))
    group_slots = []  # (upper group index, key slot)
    for gi, g in enumerate(agg.group_exprs):
        r = _refs(g)
        if r & s_uids:
            if not r <= s_uids:
                return plan
            group_slots.append((gi, add_key(g)))

    # first half of the shrink gate: every key must be a ColumnRef with
    # a known NDV (heuristic fallbacks would fire the rewrite blind) —
    # checked BEFORE construction so uid derivation below can rely on it
    from tidb_tpu_torch.planner.physical import _eq_ndv, _estimate

    s_rows = _estimate(S)
    if not all(isinstance(e, ColumnRef)
               and _eq_ndv(S, e, s_rows) is not None for e in key_exprs):
        return plan

    # build the partial aggregate over S. Uids derive from the inputs
    # (NOT a global counter): re-planning the same SQL must produce the
    # same uids, or the fragment/JIT caches — keyed on expr reprs — miss
    # on every execution (the _rule_distinct_two_phase invariant)
    from tidb_tpu_torch.planner.binder import PlanCol

    key_uids = [f"eaggk.{e.name}" for e in key_exprs]
    key_cols = [PlanCol(uid=u, name=u, type_=e.type_,
                        dict_=getattr(e, "_dict", None))
                for u, e in zip(key_uids, key_exprs)]
    p_aggs: List[AggSpec] = []
    p_cols: List[PlanCol] = []
    upper_aggs: List[AggSpec] = []
    for a in agg.aggs:
        u = f"eagg.{a.uid}"
        p_aggs.append(AggSpec(uid=u, func=a.func, arg=a.arg, type_=a.type_))
        p_cols.append(PlanCol(uid=u, name=u, type_=a.type_,
                              dict_=(getattr(a.arg, "_dict", None)
                                     if a.func in ("min", "max") and a.arg is not None
                                     else None)))
        ref = ColumnRef(type_=a.type_, name=u)
        if getattr(a.arg, "_dict", None) is not None and a.func in ("min", "max"):
            object.__setattr__(ref, "_dict", a.arg._dict)
        # partials combine upstream: SUM/COUNT re-sum (each partial row
        # re-counts once per join match — the multiplicity the original
        # row-level aggregation saw), MIN/MAX re-extremize
        upper_func = "sum" if a.func in ("sum", "count") else a.func
        upper_aggs.append(AggSpec(uid=a.uid, func=upper_func, arg=ref,
                                  type_=a.type_))
    partial = LAggregate(
        schema=key_cols + p_cols, children=[S],
        group_exprs=list(key_exprs), group_uids=list(key_uids),
        aggs=p_aggs,
    )

    # placement decision. Cascades mode prices BOTH alternatives with
    # the memo's shared cost model (_join_step_cost + LOCAL_WORK, the
    # terms the join-order search itself minimizes) over the join path
    # the partial would ride — pre-agg vs post-agg trades off against
    # the same units as join order and access paths (SURVEY.md:88-89).
    # The heuristic mode keeps the fresh-stats 70% shrink gate.
    p_rows = _estimate(partial)
    if cost_based:
        from tidb_tpu_torch.planner.cascades import LOCAL_WORK

        def path_cost(side_rows: float) -> float:
            # join outputs scale linearly in the S-side cardinality
            # under the key-join model the estimator already assumes
            cost, cur = 0.0, side_rows
            scale = side_rows / max(s_rows, 1.0)
            for join, side in reversed(path):
                o_rows = float(_estimate(join.children[1 - side]))
                out = float(_estimate(join)) * scale
                cost += (_join_step_cost(cur, o_rows, out, n_parts)
                         + LOCAL_WORK * (cur + o_rows))
                cur = out
            return cost

        build = LOCAL_WORK * s_rows + p_rows  # partial's own pass
        if build + path_cost(p_rows) >= path_cost(s_rows):
            return plan
    elif not (p_rows < 0.7 * s_rows):
        return plan

    # splice: replace S, rebuild path joins bottom-up with rewritten
    # S-side key exprs and recomposed schemas
    child: LogicalPlan = partial

    def key_ref(slot: int) -> Expr:
        e = key_exprs[slot]
        ref = ColumnRef(type_=e.type_, name=key_uids[slot])
        d = getattr(e, "_dict", None)
        if d is not None:
            object.__setattr__(ref, "_dict", d)
        return ref

    for join, side in reversed(path):
        new_eq = list(join.eq_conds)
        for j, ci, slot in join_key_slots:
            if j is join:
                le, re_ = new_eq[ci]
                new_eq[ci] = (key_ref(slot), re_) if side == 0 \
                    else (le, key_ref(slot))
        kids = list(join.children)
        kids[side] = child
        child = LJoin(
            schema=list(kids[0].schema) + list(kids[1].schema),
            children=kids, kind=join.kind, eq_conds=new_eq,
            other_cond=join.other_cond, exists_sem=join.exists_sem,
            index_join=getattr(join, "index_join", None),
        )

    new_groups = list(agg.group_exprs)
    for gi, slot in group_slots:
        new_groups[gi] = key_ref(slot)
    return LAggregate(
        schema=agg.schema, children=[child],
        group_exprs=new_groups, group_uids=list(agg.group_uids),
        aggs=upper_aggs,
    )


def optimize_logical(plan: LogicalPlan, hints=(), cascades=False,
                     n_parts: int = 1, agg_push_down: bool = True) -> LogicalPlan:
    plan = _rule_distinct_two_phase(plan)
    plan = _rule_fold(plan)
    plan = _rule_pushdown(plan)
    leading = next((args for name, args in hints if name == "leading"), None)
    plan = _rule_reorder(plan, leading, cascades, n_parts)
    if agg_push_down:
        plan = _rule_eager_agg(plan, cost_based=cascades, n_parts=n_parts)
    plan = _rule_prune(plan, None)
    return plan
