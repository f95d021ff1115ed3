"""TableScanExec: stream table slices to the device through a fused
filter/project pipeline.

The distsql/coprocessor boundary of the reference collapsed onto
host->device staging: each slice of the table's host buffers is copied
into a fixed-capacity Chunk on the context's device, and the pushed
filter plus any stacked Selection/Projection stages run over it.

With tidb_tpu_columnar_enable (the default) a table that has grown past
one segment reads through its columnar segment store (`_open_segments`):
zone maps prune whole segments before any staging, each segment's narrow
frame-of-reference payload is what crosses to the device, and the decode
runs there before the pipeline (ops/segment_scan.py). Rows past the
store's coverage (the delta) stage as raw slices. This is the classic,
unfused scan: build sides and the `tidb_tpu_pipeline_fuse = 0` path read
through it, with one pageable copy per column and chunk; the fused
pipelines (executor/pipeline.py) stage through pinned buffers instead.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from tidb_tpu_torch.chunk.chunk import Chunk
from tidb_tpu_torch.chunk.column import Column
from tidb_tpu_torch.executor.base import ExecContext, Executor
from tidb_tpu_torch.expression.compiler import compile_expr, compile_predicate
from tidb_tpu_torch.planner.binder import PlanCol
from tidb_tpu_torch.utils import dispatch
from tidb_tpu_torch.utils.device import torch_dtype

__all__ = ["TableScanExec", "make_pipeline_fn", "SelectionExec",
           "ProjectionExec", "stage", "PointGetExec", "RowIdScanExec",
           "IndexRangeScanExec", "PartitionScanExec"]


def make_pipeline_fn(stages: List) -> Callable:
    """Compose stages into one Chunk->Chunk function.

    Each stage is ("filter", ir) or ("project", [(uid, ir)])."""
    compiled = []
    for kind, payload in stages:
        if kind == "filter":
            compiled.append(("filter", compile_predicate(payload)))
        else:
            exprs = [(uid, compile_expr(ir)) for uid, ir in payload]
            compiled.append(("project", exprs))

    def run(chunk: Chunk) -> Chunk:
        for kind, fn in compiled:
            if kind == "filter":
                chunk = chunk.filter(fn(chunk))
            else:
                chunk = chunk.project({uid: f(chunk) for uid, f in fn})
        return chunk

    return run


def stage(host: np.ndarray, cap: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Copy `host` (n <= cap rows) into a zero-padded [cap] tensor on
    `device`: one host->device copy of the live rows."""
    out = torch.zeros(cap, dtype=dtype, device=device)
    n = len(host)
    if n:
        src = np.ascontiguousarray(host)
        out[:n].copy_(torch.from_numpy(src))
        if out.is_cuda:
            dispatch.record_xfer(src.nbytes)
    return out


class TableScanExec(Executor):
    def __init__(self, schema: List[PlanCol], table, stages: List,
                 out_schema: Optional[List[PlanCol]] = None,
                 prune_bounds=()):
        super().__init__(out_schema or schema, [])
        self.scan_schema = schema  # storage columns staged (pre-pipeline)
        self.table = table
        self.stages = stages
        self.prune_bounds = prune_bounds  # zone-consultable pushed bounds
        self._fn = None
        self._slices = []
        self._i = 0
        self._seg_chunks = []   # (Segment, rel_start, rel_end) to stage
        self._seg_i = 0
        self._seg_fn = None
        self._pin = None
        self._scan_counted = False

    def _count_scan(self) -> None:
        """Register as a lock-free reader of the table's live arrays for
        the scan's whole lifetime (point/index paths hold physical row
        ids): a CLUSTER BY permute refuses while any scan is counted."""
        guard = getattr(self.table, "txn_guard", None)
        if guard is not None and not self._scan_counted:
            guard.scan_enter()
            self._scan_counted = True

    def open(self, ctx: ExecContext) -> None:
        self.ctx = ctx
        cap = ctx.chunk_capacity
        self._count_scan()
        self._fn = make_pipeline_fn(self.stages) if self.stages else None
        self._seg_chunks = []
        self._seg_i = 0
        self._seg_fn = None
        self._pin = None
        if self.table is not None:
            tail_start = 0
            if ctx.columnar_enable:
                tail_start = self._open_segments(ctx, cap)
            n = self.table.n
            self._slices = [(s, min(s + cap, n)) for s in range(tail_start, n, cap)]
        else:
            # dual table: one empty-schema row (SELECT without FROM)
            self._slices = [None]
        self._i = 0

    def _open_segments(self, ctx: ExecContext, cap: int) -> int:
        """Plan the segment portion of the scan: consult zone maps to skip
        whole segments before any staging, pick the decode+pipeline
        closure, and register the spill pin on the statement tracker.
        Returns the first delta (uncovered) row."""
        from tidb_tpu_torch.columnar.store import ScanPin, store_for
        from tidb_tpu_torch.ops.segment_scan import scan_fn

        store = store_for(
            self.table, segment_rows=ctx.segment_rows,
            delta_rows=ctx.segment_delta_rows,
            spill_dir=ctx.columnar_spill_dir or None,
            compaction=ctx.compaction_enable)
        if store is None:
            return 0
        # the pin exists BEFORE planning so every snapshot segment is
        # reference-counted against a concurrent store invalidation
        self._pin = ScanPin(store, ctx.mem_tracker)
        segs, pruned, covered = store.plan_scan(self.prune_bounds, pin=self._pin)
        self.stats.segs_scanned += len(segs)
        self.stats.segs_pruned += pruned
        # segment chunks size to the segment, not the plan's chunk
        # capacity (padding a small segment into a large buffer would
        # stage mostly zeros); one power-of-two capacity for all of them
        seg_cap = 1
        while seg_cap < min(store.segment_rows, cap):
            seg_cap *= 2
        self._seg_cap = seg_cap
        for seg in segs:
            for s in range(0, seg.rows, seg_cap):
                self._seg_chunks.append((seg, s, min(s + seg_cap, seg.rows)))
        if self._seg_chunks:
            self._seg_fn = scan_fn(self.stages, [(c.uid, c.type_) for c in self.scan_schema])
        else:
            self._pin.close()  # nothing to stage: drop the refs now
            self._pin = None
        return covered

    def _stage_segment(self, seg, s: int, e: int) -> Chunk:
        """Stage one segment sub-range and run the decode+pipeline
        closure. The narrow encoded bytes are what crosses to the device;
        live-row visibility is read fresh from the table's MVCC arrays."""
        self._pin.touch(seg)
        cap = self._seg_cap
        dev = self.ctx.device
        data, valid, refs = {}, {}, {}
        for c in self.scan_schema:
            if c.name == "__rowid__":
                d = np.arange(seg.start + s, seg.start + e, dtype=np.int64)
                v = np.ones(e - s, dtype=np.bool_)
            else:
                enc, sd, sv = seg.col(c.name)
                d, v = sd[s:e], sv[s:e]
                if enc.kind == "for":
                    refs[c.uid] = enc.ref
            data[c.uid] = stage(d, cap, torch_dtype(d.dtype), dev)
            valid[c.uid] = stage(v, cap, torch.bool, dev)
        live = self.table.live_mask(seg.start + s, seg.start + e,
                                    read_ts=self.ctx.read_ts, marker=self.ctx.txn_marker)
        return self._seg_fn(data, valid, refs, stage(live, cap, torch.bool, dev))

    def close(self) -> None:
        if self._pin is not None:
            self._pin.close()
            self._pin = None
        if self._scan_counted:
            self._scan_counted = False
            self.table.txn_guard.scan_exit()
        super().close()

    def next(self) -> Optional[Chunk]:
        if self._seg_i < len(self._seg_chunks):
            seg, s, e = self._seg_chunks[self._seg_i]
            self._seg_i += 1
            self.stats.chunks += 1
            return self._stage_segment(seg, s, e)
        if self._i >= len(self._slices):
            return None
        sl = self._slices[self._i]
        self._i += 1
        cap = self.ctx.chunk_capacity
        dev = self.ctx.device
        if sl is None:
            sel = torch.zeros(cap, dtype=torch.bool, device=dev)
            sel[0] = True
            chunk = Chunk({}, sel)
        else:
            start, end = sl
            cols = {}
            for c in self.scan_schema:
                if c.name == "__rowid__":
                    # physical-rowid pseudo-column
                    data = np.arange(start, end, dtype=np.int64)
                    valid = np.ones(end - start, dtype=np.bool_)
                else:
                    data, valid = self.table.column_slice(c.name, start, end)
                cols[c.uid] = Column(
                    stage(data, cap, torch_dtype(c.type_.np_dtype), dev),
                    stage(valid, cap, torch.bool, dev), c.type_)
            live = self.table.live_mask(start, end, read_ts=self.ctx.read_ts,
                                        marker=self.ctx.txn_marker)
            chunk = Chunk(cols, stage(live, cap, torch.bool, dev))
        if self._fn is not None:
            chunk = self._fn(chunk)
        self.stats.chunks += 1
        return chunk


def _pow2_capacity(n: int) -> int:
    cap = 8
    while cap < n:
        cap *= 2
    return cap


class PointGetExec(TableScanExec):
    """O(log n) unique-index point lookup feeding one small chunk (ref:
    executor/point_get.go PointGetExecutor). The row ids come from the
    host index (`Table.index_lookup`, which also applies MVCC
    visibility); the full pushed filter still runs over the fetched rows,
    so residual conjuncts compose, unless the planner proved the key
    probe covers it (`cond_covered`)."""

    def __init__(self, schema, table, stages, index_name, key_values,
                 out_schema=None):
        super().__init__(schema, table, stages, out_schema)
        self.index_name = index_name
        self.key_values = key_values

    def open(self, ctx: ExecContext) -> None:
        # deliberately NOT TableScanExec.open(): no segment store and no
        # slice plan, only the looked-up rows
        Executor.open(self, ctx)
        self.ctx = ctx
        self._count_scan()
        self._fn = make_pipeline_fn(self.stages) if self.stages else None
        self._rows = self.table.index_lookup(
            self.index_name, self.key_values,
            read_ts=ctx.read_ts, marker=ctx.txn_marker)
        self._slices = [(0, len(self._rows))]  # one emission
        self._i = 0

    def next(self) -> Optional[Chunk]:
        if self._i >= len(self._slices):
            return None
        start, end = self._slices[self._i]
        self._i += 1
        return self._emit_rows(self._rows[start:end])

    def _emit_rows(self, rows: np.ndarray) -> Chunk:
        """Gather a physical row-id set into one pow2-capacity chunk on
        the context's device and run the residual pipeline. The host
        gathers every column (data, then validity) into one byte buffer,
        8-byte aligned per array, which crosses to the device in ONE
        copy; the chunk's columns are typed views of it."""
        n = len(rows)
        cap = _pow2_capacity(n)
        parts = []  # (uid, type_, data, valid) host arrays of length n
        for c in self.scan_schema:
            if c.name == "__rowid__":
                d = np.asarray(rows, dtype=np.int64)
                v = np.ones(n, dtype=np.bool_)
            else:
                d = self.table.data[c.name][rows]
                v = self.table.valid[c.name][rows]
            parts.append((c.uid, c.type_, d, v))
        layout, off = [], 0
        for _uid, t, _d, _v in parts:
            dsz = cap * np.dtype(t.np_dtype).itemsize
            layout.append((off, off + dsz))
            off += (dsz + 7) // 8 * 8
            off += (cap + 7) // 8 * 8
        host = np.zeros(max(off, 8), dtype=np.uint8)
        for (uid, t, d, v), (ds, vs) in zip(parts, layout):
            host[ds:vs].view(t.np_dtype)[:n] = d.astype(t.np_dtype, copy=False)
            vo = (vs + 7) // 8 * 8
            host[vo:vo + n] = v
        buf = torch.from_numpy(host).to(self.ctx.device)
        if buf.is_cuda:
            dispatch.record_xfer(host.nbytes)
        cols = {}
        for (uid, t, _d, _v), (ds, vs) in zip(parts, layout):
            vo = (vs + 7) // 8 * 8
            cols[uid] = Column(buf[ds:vs].view(torch_dtype(t.np_dtype)),
                               buf[vo:vo + cap].view(torch.bool), t)
        sel = torch.arange(cap, device=self.ctx.device) < n
        chunk = Chunk(cols, sel)
        if self._fn is not None:
            chunk = self._fn(chunk)
        self.stats.chunks += 1
        return chunk


class RowIdScanExec(PointGetExec):
    """Base for access paths that resolve to a compact row-id set
    (index ranges, pruned partitions) and stage only those rows (ref:
    executor's IndexLookUpExecutor index->table double read). Rows
    stream in chunk_capacity batches, so a wide set behaves like a
    pre-filtered scan, not one giant gather."""

    def __init__(self, schema, table, stages, out_schema=None):
        super().__init__(schema, table, stages, None, (), out_schema)

    def _row_ids(self, ctx: ExecContext) -> np.ndarray:
        raise NotImplementedError

    def open(self, ctx: ExecContext) -> None:
        Executor.open(self, ctx)
        self.ctx = ctx
        self._count_scan()
        self._fn = make_pipeline_fn(self.stages) if self.stages else None
        rows = self._row_ids(ctx)
        self._rows = rows
        cap = ctx.chunk_capacity
        self._slices = [(s, min(s + cap, len(rows)))
                        for s in range(0, len(rows), cap)] or [(0, 0)]
        self._i = 0


class IndexRangeScanExec(RowIdScanExec):
    """Index range access: binary-search the sorted index cache into a
    compact row-id set."""

    def __init__(self, schema, table, stages, index_name, eq_values,
                 range_lo, range_hi, lo_incl, hi_incl, out_schema=None):
        super().__init__(schema, table, stages, out_schema)
        self.index_name = index_name
        self.eq_values = eq_values
        self.range_lo = range_lo
        self.range_hi = range_hi
        self.lo_incl = lo_incl
        self.hi_incl = hi_incl

    def _row_ids(self, ctx: ExecContext) -> np.ndarray:
        return self.table.index_range_lookup(
            self.index_name, self.eq_values, self.range_lo, self.range_hi,
            self.lo_incl, self.hi_incl,
            read_ts=ctx.read_ts, marker=ctx.txn_marker)


class PartitionScanExec(RowIdScanExec):
    """Pruned partitioned-table access: reads only the matching
    partitions' cached row ids (storage/table.py partition_rows)."""

    def __init__(self, schema, table, stages, part_ids, out_schema=None):
        super().__init__(schema, table, stages, out_schema)
        self.part_ids = part_ids

    def _row_ids(self, ctx: ExecContext) -> np.ndarray:
        return self.table.partition_rows(
            self.part_ids, read_ts=ctx.read_ts, marker=ctx.txn_marker)


class SelectionExec(Executor):
    """Standalone filter for positions where fusion into a scan pipeline
    wasn't possible (e.g. above an aggregate for HAVING)."""

    def __init__(self, schema, child: Executor, cond):
        super().__init__(schema, [child])
        self.cond = cond
        self._fn = None

    def open(self, ctx: ExecContext) -> None:
        super().open(ctx)
        pred = compile_predicate(self.cond)
        self._fn = lambda ch: ch.filter(pred(ch))

    def next(self) -> Optional[Chunk]:
        ch = self.children[0].next()
        if ch is None:
            return None
        return self._fn(ch)


class ProjectionExec(Executor):
    def __init__(self, schema, child: Executor, exprs):
        super().__init__(schema, [child])
        self.exprs = exprs
        self._fn = None

    def open(self, ctx: ExecContext) -> None:
        super().open(ctx)
        pairs = [(c.uid, compile_expr(e)) for c, e in zip(self.schema, self.exprs)]
        self._fn = lambda ch: ch.project({uid: f(ch) for uid, f in pairs})

    def next(self) -> Optional[Chunk]:
        ch = self.children[0].next()
        if ch is None:
            return None
        return self._fn(ch)
