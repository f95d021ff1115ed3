"""Executor protocol and execution context."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional

import torch

from tidb_tpu_torch.chunk.chunk import Chunk
from tidb_tpu_torch.planner.binder import PlanCol

__all__ = ["ExecContext", "Executor", "ResultSet", "RuntimeStats",
           "run_plan", "raise_if_cancelled"]


def raise_if_cancelled(ctx: "ExecContext") -> None:
    """Poll the context's cancel hook (KILL flags + statement deadline).

    The hook may return a bool or an exception instance carrying the
    cancellation reason (a deadline expiry surfaces as the timeout
    error, not as a generic KILL). Every long executor loop polls through
    this one function; sessions wire their `cancel_reason` into it."""
    if ctx.cancel_check is None:
        return
    r = ctx.cancel_check()
    if not r:
        return
    if isinstance(r, BaseException):
        raise r
    from tidb_tpu_torch.errors import QueryKilledError

    raise QueryKilledError("Query execution was interrupted (KILL)")


@dataclass
class RuntimeStats:
    """Per-operator stats surfaced by EXPLAIN ANALYZE
    (ref: util/execdetails RuntimeStats)."""

    rows: int = 0
    chunks: int = 0
    open_wall: float = 0.0
    next_wall: float = 0.0
    # kernel launches issued while this operator (incl. its children)
    # ran — utils.dispatch deltas; EXPLAIN ANALYZE shows own =
    # cumulative - children's
    dispatches: int = 0
    # kernel library builds (nvcc at first use) while this operator ran
    recompiles: int = 0
    # perf_counter of this operator's first open/next activity
    first_ts: Optional[float] = None
    # the planner's row estimate for the plan node this executor answers
    # for (-1 = unannotated); `measured` marks `rows` as exact (the
    # instrument() wrapper counted every emitted chunk)
    est_rows: float = -1.0
    measured: bool = False
    # columnar segment store: segments a scan skipped through zone-map
    # pruning and segments it staged
    segs_pruned: int = 0
    segs_scanned: int = 0
    # pipelined execution: batches whose staged device buffers were in
    # place when the compute loop asked (prefetch hits plus device
    # buffer cache hits)
    staged: int = 0
    # host-known output rows (-1 = unknown): the fused probe fills it
    # from its batched match-total fetches
    out_rows: int = -1
    # fused scan->probe tiles: chunks probed, chunks whose expansion
    # overflowed the first tile, the worst ceil(overflow / tile) seen
    tile_chunks: int = 0
    tile_overflows: int = 0
    tile_max_need: int = 0

    def add_out_rows(self, n: int) -> None:
        """Fold a host-known output count into out_rows."""
        self.out_rows = n if self.out_rows < 0 else self.out_rows + n


@dataclass
class ExecContext:
    chunk_capacity: int = 1 << 16
    # where scans stage their chunks and device state lives
    device: torch.device = torch.device("cpu")
    # GROUP_CONCAT result truncation (group_concat_max_len sysvar)
    group_concat_max_len: int = 1024
    # hash-join build packs and sorts on the device; False sorts on the
    # host and stages the sorted keys (tidb_tpu_join_device_build sysvar)
    join_device_build: bool = True
    # output tiles one join expand call may emit; bounds the [T, C] buffer
    # of a many-to-many join (tidb_tpu_join_tiles_per_dispatch sysvar)
    join_tiles: int = 8
    # probe route of the hash join: off = searchsorted, auto = the
    # open-addressing table on the card and searchsorted on the CPU,
    # xla/pallas = the table (tidb_tpu_join_probe_mode sysvar)
    join_probe_mode: str = "auto"
    # MVCC snapshot: None reads committed-latest; inside a transaction
    # the session sets its snapshot ts and its marker (its own
    # provisional rows are visible)
    read_ts: Optional[int] = None
    txn_marker: int = 0
    # KILL/deadline hook polled between chunks (the session's
    # cancel_reason); see raise_if_cancelled
    cancel_check: Optional[object] = None
    # statement memory accounting root (tidb_mem_quota_query); None
    # makes an unbudgeted tracker
    mem_tracker: "object" = None
    # device engine routing (tidb_enable_tpu_exec): False keeps every
    # fused pipeline on its classic delegate
    device_agg: bool = True
    # columnar segment store: scans of stored tables read encoded,
    # zone-mapped segments (tidb_tpu_columnar_enable)
    columnar_enable: bool = True
    # fixed segment capacity in rows (tidb_tpu_segment_rows); the first
    # store built for a table pins its value
    segment_rows: int = 1 << 16
    # appended delta rows that fold into segments at the next scan
    # (tidb_tpu_segment_delta_rows)
    segment_delta_rows: int = 1 << 16
    # directory for spilled segment files (tidb_tpu_columnar_spill_dir;
    # empty = system tmp)
    columnar_spill_dir: str = ""
    # background delta->segment compaction: delta-depth rebuilds run on
    # the compaction worker instead of inline at the next scan
    # (tidb_tpu_compaction)
    compaction_enable: bool = True
    # fused scan->aggregate, scan->probe and scan->top-k fragments
    # (tidb_tpu_pipeline_fuse); False runs the classic operator tree
    pipeline_fuse: bool = True
    # the fused scan->top-k root; False keeps ORDER BY [LIMIT] on the
    # classic sort (plan feedback clears it for a digest whose LIMIT
    # overflowed the state)
    fused_topn: bool = True
    # staged batches kept in flight ahead of compute by the prefetch
    # thread; 0 = stage inline (tidb_tpu_pipeline_prefetch_depth)
    prefetch_depth: int = 2
    # byte budget of the cross-statement device buffer cache; 0 = off
    # (tidb_tpu_device_buffer_cache_bytes)
    device_buffer_cache_bytes: int = 256 << 20
    # byte quota of the fused batches' CUDA graphs (utils/jitcache.py;
    # tidb_tpu_graph_cache_bytes)
    graph_cache_bytes: int = 4 << 30
    # the mesh tier (parallel/): a table above this many device bytes
    # streams through a fragment in fixed batches instead of staying
    # resident (tidb_device_cache_bytes); a broadcast build side above
    # this many rows takes the single-device path
    # (tidb_broadcast_join_threshold_count); a streamed source stages its
    # integer columns FoR-encoded (tidb_tpu_stage_encoded)
    device_cache_bytes: int = 8 << 30
    broadcast_rows_limit: int = 1 << 21
    stage_encoded: bool = True

    def __post_init__(self):
        if self.mem_tracker is None:
            from tidb_tpu_torch.utils.memory import MemTracker

            self.mem_tracker = MemTracker("query")


class Executor:
    """Open/Next/Close — the same operator boundary as the reference's
    executor.Executor, pulling device Chunks."""

    schema: List[PlanCol]

    def __init__(self, schema: List[PlanCol], children: List["Executor"]):
        self.schema = schema
        self.children = children
        self.stats = RuntimeStats()

    def open(self, ctx: ExecContext) -> None:
        for c in self.children:
            c.open(ctx)

    def next(self) -> Optional[Chunk]:
        raise NotImplementedError

    def close(self) -> None:
        for c in self.children:
            c.close()

    def chunks(self) -> Iterator[Chunk]:
        while True:
            ch = self.next()
            if ch is None:
                return
            yield ch


@dataclass
class ResultSet:
    names: List[str]
    rows: List[tuple]
    # column type kinds (tidb_tpu_torch.types.TypeKind) for the wire
    # protocol's column metadata; None for synthetic result sets
    # (SHOW/EXPLAIN)
    types: Optional[list] = None
    # full SQLTypes (precision/scale preserved) when produced by a plan
    sql_types: Optional[list] = None
    # per-column string collation (from the plan column's dictionary);
    # None entries = non-string
    collations: Optional[list] = None

    def __len__(self):
        return len(self.rows)


def run_plan(root: Executor, ctx: ExecContext, n_visible: Optional[int] = None) -> ResultSet:
    """Drive an executor tree to completion and materialize host rows."""
    opened = False
    try:
        root.open(ctx)  # inside try: open() can raise after acquiring
        opened = True
        visible = root.schema if n_visible is None else root.schema[:n_visible]
        uids = [c.uid for c in visible]
        dicts = {c.uid: c.dict_ for c in visible if c.dict_ is not None}
        rows: List[tuple] = []
        for ch in root.chunks():
            raise_if_cancelled(ctx)
            rows.extend(ch.to_pylist(dicts=dicts, names=uids))
        return ResultSet(
            names=[c.name for c in visible],
            rows=rows,
            types=[c.type_.kind for c in visible],
            sql_types=[c.type_ for c in visible],
            collations=[getattr(c.dict_, "collation", None)
                        for c in visible],
        )
    finally:
        try:
            root.close()
        except Exception:
            if opened:
                raise
