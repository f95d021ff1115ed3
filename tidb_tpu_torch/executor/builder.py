"""executorBuilder (ref: executor/builder.go): physical plan -> executors.

The builder performs pipeline fusion: chains of Selection/Projection above
a table scan collapse into the scan's stage list, so a scan+filter+project
runs as one pass over each staged chunk. An aggregation whose child peels
to a plain table scan becomes FusedScanAggExec, an inner or LEFT hash join
whose probe side does becomes FusedScanProbeExec, and an ORDER BY [LIMIT]
over one becomes FusedScanTopNExec (executor/pipeline.py), with the
reference's plan-static gates; the context-dependent gates (the sysvars,
the top-k state's capacity) decide at open() and fall back to the classic
tree through each fused executor's `fallback_build` delegate. Index
joins, window functions and the index/partition access paths are not yet
ported and raise UnsupportedError or take the classic tree.
"""

from __future__ import annotations

from tidb_tpu_torch.errors import UnsupportedError
from tidb_tpu_torch.executor.aggregate import HashAggExec
from tidb_tpu_torch.executor.base import Executor
from tidb_tpu_torch.executor.join import HashJoinExec
from tidb_tpu_torch.executor.scan import ProjectionExec, SelectionExec, TableScanExec
from tidb_tpu_torch.executor.sort import LimitExec, SortExec, TopNExec, UnionExec
from tidb_tpu_torch.planner.physical import (
    PHashAgg,
    PHashJoin,
    PIndexJoin,
    PLimit,
    PProjection,
    PScan,
    PSelection,
    PSort,
    PTopN,
    PUnion,
    PhysicalPlan,
)

__all__ = ["build_executor", "peel_stages", "scan_stages_for", "scan_prune_bounds"]


def peel_stages(plan: PhysicalPlan):
    """Strip the fusible Selection/Projection chain off `plan`.

    Returns (stages, base): stages in execution order, base the first
    non-fusible node."""
    rev, base = [], plan
    while True:
        if isinstance(base, PSelection):
            rev.append(("filter", base.cond))
            base = base.child
        elif isinstance(base, PProjection):
            rev.append(("project", list(zip([c.uid for c in base.schema], base.exprs))))
            base = base.child
        else:
            break
    return list(reversed(rev)), base


def scan_stages_for(scan: PScan, stages) -> list:
    """Prepend the scan's pushed filter to a fused stage list."""
    out = []
    if scan.pushed_cond is not None:
        out.append(("filter", scan.pushed_cond))
    out.extend(stages)
    return out


def scan_prune_bounds(scan: PScan):
    """Zone-consultable bounds from the scan's pushed filter: the columnar
    segment store prunes whole segments against these before any
    host->device staging. Computed at executor-build time, so bounds
    always come from the current literals."""
    if scan.pushed_cond is None or scan.table is None:
        return ()
    from tidb_tpu_torch.columnar.zonemap import collect_prune_bounds

    uid_map = {c.uid: (c.name, c.type_) for c in scan.schema}
    return collect_prune_bounds(scan.pushed_cond, uid_map)


def _try_fused_scan_agg(plan: PHashAgg):
    """HashAgg whose child peels to a PLAIN table scan pipeline runs as one
    fused scan->filter->project->partial-agg fragment. Anything the
    context later rules out falls back through `fallback_build` at open(),
    so the routing decision needing ExecContext state doesn't have to
    happen here."""
    from tidb_tpu_torch.executor.pipeline import FusedScanAggExec

    stages, base = peel_stages(plan.child)
    if type(base) is not PScan or base.table is None:
        return None
    if plan.strategy != "segment":
        # plan-static generic-strategy gates decide here so permanently
        # unfusible shapes (DISTINCT, non-core funcs, global generic) keep
        # the classic tree; ctx-dependent gates defer to open()
        from tidb_tpu_torch.planner.logical import core_generic_agg

        if not core_generic_agg(plan.group_exprs, plan.aggs):
            return None

    def fallback(plan=plan):
        return HashAggExec(
            plan.schema, build_executor(plan.child), plan.group_exprs,
            plan.group_uids, plan.aggs, plan.strategy,
            segment_sizes=getattr(plan, "segment_sizes", None))

    return FusedScanAggExec(
        plan.schema, base.schema, base.table,
        scan_stages_for(base, stages), scan_prune_bounds(base),
        plan.group_exprs, plan.group_uids, plan.aggs, plan.strategy,
        segment_sizes=getattr(plan, "segment_sizes", None),
        fallback_build=fallback)


def _build_hash_join(plan: PHashJoin) -> HashJoinExec:
    """The classic pull-based hash-join tree (also the fused path's
    open()-time fallback delegate)."""
    probe_idx = 1 - plan.build_side
    probe_plan = plan.children[probe_idx]
    build_plan = plan.children[plan.build_side]
    probe_keys = plan.eq_left if probe_idx == 0 else plan.eq_right
    build_keys = plan.eq_right if plan.build_side == 1 else plan.eq_left
    # semi/anti joins need no build payload, unless an other_cond must
    # evaluate build columns during the probe, and then only those
    if plan.kind in ("semi", "anti"):
        if plan.other_cond is None:
            build_payload_schema = []
        else:
            from tidb_tpu_torch.expression.expr import ColumnRef, walk

            refs = {n.name for n in walk(plan.other_cond)
                    if isinstance(n, ColumnRef)}
            build_payload_schema = [c for c in build_plan.schema
                                    if c.uid in refs]
    else:
        build_payload_schema = list(build_plan.schema)
    return HashJoinExec(
        plan.schema,
        build_executor(probe_plan),
        build_executor(build_plan),
        plan.kind,
        probe_keys,
        build_keys,
        other_cond=plan.other_cond,
        probe_schema=list(probe_plan.schema),
        build_schema=build_payload_schema,
        exists_sem=plan.exists_sem,
    )


def _try_fused_scan_probe(plan: PHashJoin):
    """Inner or LEFT OUTER hash join whose probe side peels to a PLAIN
    table scan pipeline runs as a fused scan->probe fragment, the build
    side device-resident (and device-buffer-cached when it is itself a
    plain scan over a stored table). Plan-static gates decide here:
    semi/anti kinds and other_cond keep the classic tree; ctx-dependent
    gates (sysvars) defer to the open()-time delegate, as does the
    data-dependent hash-mode packing escape (composite key ranges
    overflowing int64 need the classic probe's exact re-verification,
    known only after the build drain)."""
    from tidb_tpu_torch.executor.pipeline import FusedScanProbeExec

    if plan.kind not in ("inner", "left") or plan.other_cond is not None:
        return None
    if plan.exists_sem:
        return None
    if plan.kind == "left" and plan.build_side != 1:
        # the fused probe streams the PRESERVED side; a left join built on
        # the left would pad the wrong side
        return None
    probe_idx = 1 - plan.build_side
    probe_plan = plan.children[probe_idx]
    build_plan = plan.children[plan.build_side]
    probe_keys = plan.eq_left if probe_idx == 0 else plan.eq_right
    build_keys = plan.eq_right if plan.build_side == 1 else plan.eq_left
    if len(probe_keys) != len(build_keys) or not probe_keys:
        return None
    stages, base = peel_stages(probe_plan)
    if type(base) is not PScan or base.table is None:
        return None
    # build-side cache eligibility: only a plain scan pipeline over a
    # stored table proves a parked build current via table_ident; the tag
    # carries the peeled plan's full shape (literal values included)
    bstages, bbase = peel_stages(build_plan)
    build_table = bbase.table if type(bbase) is PScan else None
    build_tag = None
    if build_table is not None:
        build_tag = repr((bstages, getattr(bbase, "pushed_cond", None),
                          build_keys,
                          tuple(c.uid for c in build_plan.schema)))

    def fallback(plan=plan):
        return _build_hash_join(plan)

    return FusedScanProbeExec(
        plan.schema, base.schema, base.table,
        scan_stages_for(base, stages), scan_prune_bounds(base),
        list(probe_plan.schema), probe_keys, build_keys,
        list(build_plan.schema),
        build_child_build=lambda: build_executor(build_plan),
        build_table=build_table, build_tag=build_tag,
        kind=plan.kind, fallback_build=fallback)


def _try_fused_scan_topn(plan):
    """ORDER BY [LIMIT] root whose child peels to a PLAIN table scan
    pipeline runs as a fused scan->top-k fragment: a bounded device state of
    the current winners, one fetch at finalize. Plan-static gates only
    reject shapes with no scan pipeline to fuse; the capacity gates (LIMIT
    + offset against the chunk capacity, the table's size for a full ORDER
    BY) depend on the context and the data and defer to the open()-time
    delegate."""
    from tidb_tpu_torch.executor.pipeline import FusedScanTopNExec

    if not plan.items:
        return None
    stages, base = peel_stages(plan.child)
    if type(base) is not PScan or base.table is None:
        return None
    topn = isinstance(plan, PTopN)

    def fallback(plan=plan):
        if isinstance(plan, PTopN):
            return TopNExec(plan.schema, build_executor(plan.child), plan.items,
                            plan.count, plan.offset)
        return SortExec(plan.schema, build_executor(plan.child), plan.items)

    return FusedScanTopNExec(
        plan.schema, base.schema, base.table,
        scan_stages_for(base, stages), scan_prune_bounds(base),
        plan.items, plan.count if topn else None, plan.offset if topn else 0,
        full_sort=not topn, fallback_build=fallback)


def build_executor(plan: PhysicalPlan) -> Executor:
    # pipeline fusion: Selection/Projection chains over a scan
    stages, base = peel_stages(plan)
    if type(base) is PScan:
        return TableScanExec(
            schema=base.schema,
            table=base.table,
            stages=scan_stages_for(base, stages),
            out_schema=plan.schema,
            prune_bounds=scan_prune_bounds(base),
        )

    if isinstance(plan, PSelection):
        return SelectionExec(plan.schema, build_executor(plan.child), plan.cond)
    if isinstance(plan, PProjection):
        return ProjectionExec(plan.schema, build_executor(plan.child), plan.exprs)
    if isinstance(plan, PHashAgg):
        fused = _try_fused_scan_agg(plan)
        if fused is not None:
            return fused
        return HashAggExec(
            plan.schema,
            build_executor(plan.child),
            plan.group_exprs,
            plan.group_uids,
            plan.aggs,
            plan.strategy,
            segment_sizes=getattr(plan, "segment_sizes", None),
        )
    if isinstance(plan, PHashJoin):
        fused = _try_fused_scan_probe(plan)
        if fused is not None:
            return fused
        return _build_hash_join(plan)
    if isinstance(plan, PIndexJoin):
        raise UnsupportedError("IndexJoinExec is not yet ported")
    if isinstance(plan, PSort):
        fused = _try_fused_scan_topn(plan)
        if fused is not None:
            return fused
        return SortExec(plan.schema, build_executor(plan.child), plan.items)
    if isinstance(plan, PTopN):
        fused = _try_fused_scan_topn(plan)
        if fused is not None:
            return fused
        return TopNExec(plan.schema, build_executor(plan.child), plan.items,
                        plan.count, plan.offset)
    if isinstance(plan, PLimit):
        return LimitExec(plan.schema, build_executor(plan.child), plan.count, plan.offset)
    if isinstance(plan, PUnion):
        return UnionExec(plan.schema, [build_executor(c) for c in plan.children])

    raise UnsupportedError(f"{type(plan).__name__} is not yet ported")
