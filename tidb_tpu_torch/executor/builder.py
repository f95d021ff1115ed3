"""executorBuilder (ref: executor/builder.go): physical plan -> executors.

The builder performs pipeline fusion: chains of Selection/Projection above
a table scan collapse into the scan's stage list, so a scan+filter+project
runs as one pass over each staged chunk.

This slice builds the classic operator tree only. `_try_fused_scan_agg`
and `_try_fused_scan_probe` return None until executor/pipeline.py
(FusedScanAggExec, FusedScanProbeExec) is ported, so every aggregation
runs as TableScanExec -> HashAggExec and every hash join as HashJoinExec
over its two child trees. Index joins, window functions and the
index/partition access paths are not yet ported and raise
UnsupportedError.
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

__all__ = ["build_executor", "peel_stages", "scan_stages_for"]


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


def _try_fused_scan_agg(plan: PHashAgg):
    """The fused scan->filter->project->partial-agg pipeline
    (FusedScanAggExec in tidb_tpu/executor/pipeline.py) is not yet
    ported: every aggregation takes the classic tree."""
    return None


def _build_hash_join(plan: PHashJoin) -> HashJoinExec:
    """The classic pull-based hash-join tree."""
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
    """The fused scan->probe fragment (FusedScanProbeExec in
    tidb_tpu/executor/pipeline.py) is not yet ported: every hash join
    takes the classic tree."""
    return None


def build_executor(plan: PhysicalPlan) -> Executor:
    # pipeline fusion: Selection/Projection chains over a scan
    stages, base = peel_stages(plan)
    if type(base) is PScan:
        return TableScanExec(
            schema=base.schema,
            table=base.table,
            stages=scan_stages_for(base, stages),
            out_schema=plan.schema,
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
        return SortExec(plan.schema, build_executor(plan.child), plan.items)
    if isinstance(plan, PTopN):
        return TopNExec(plan.schema, build_executor(plan.child), plan.items,
                        plan.count, plan.offset)
    if isinstance(plan, PLimit):
        return LimitExec(plan.schema, build_executor(plan.child), plan.count, plan.offset)
    if isinstance(plan, PUnion):
        return UnionExec(plan.schema, [build_executor(c) for c in plan.children])

    raise UnsupportedError(f"{type(plan).__name__} is not yet ported")
