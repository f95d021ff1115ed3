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
    this one function. The port has no KILL or deadline yet, so its
    sessions leave `cancel_check` None."""
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
    """Per-operator counters (ref: util/execdetails RuntimeStats); the
    subset the scan and the fused pipelines bump."""

    chunks: int = 0
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
    # MVCC snapshot: None reads committed-latest (the port runs
    # autocommit statements only, so its sessions leave both unset)
    read_ts: Optional[int] = None
    txn_marker: int = 0
    # KILL/deadline hook polled between chunks (None until KILL is
    # ported); see raise_if_cancelled
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
    # fused scan->aggregate, scan->probe and scan->top-k fragments
    # (tidb_tpu_pipeline_fuse); False runs the classic operator tree
    pipeline_fuse: bool = True
    # the fused scan->top-k root; False keeps ORDER BY [LIMIT] on the
    # classic sort (the reference's plan feedback clears it for a digest
    # whose LIMIT overflowed the state; the port has no plan feedback yet)
    fused_topn: bool = True
    # staged batches kept in flight ahead of compute by the prefetch
    # thread; 0 = stage inline (tidb_tpu_pipeline_prefetch_depth)
    prefetch_depth: int = 2
    # byte budget of the cross-statement device buffer cache; 0 = off
    # (tidb_tpu_device_buffer_cache_bytes)
    device_buffer_cache_bytes: int = 256 << 20

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
        return ResultSet(names=[c.name for c in visible], rows=rows)
    finally:
        try:
            root.close()
        except Exception:
            if opened:
                raise
