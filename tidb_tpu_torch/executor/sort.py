"""Root-task operators: Sort / TopN / Limit / Union
(ref: executor/sort.go, topn, limit; these sit at the plan root over small
results, so they run host-side — the reference similarly runs root
executors on the SQL node while coprocessors do the heavy scans).

Sort and TopN drain into SpillableRuns under the query's memory tracker:
past the budget the runs spill to disk, the sort keys are gathered back to
the host and the payload is gathered from the (mmap-backed) runs in
output order, as in tidb_tpu/executor/sort.py.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from tidb_tpu_torch.chunk.chunk import Chunk
from tidb_tpu_torch.chunk.column import Column
from tidb_tpu_torch.executor.base import ExecContext, Executor
from tidb_tpu_torch.expression.compiler import compile_expr
from tidb_tpu_torch.utils import dispatch

__all__ = ["SortExec", "TopNExec", "LimitExec", "UnionExec"]


class _Materializing(Executor):
    """Shared: drain the child to host-compacted runs (spillable under the
    query memory budget: the RowContainer + SpillDiskAction shape), order
    them, emit output chunks."""

    _runs = None

    def _drain_to_runs(self, sort_items: List[Tuple[object, bool]]):
        from tidb_tpu_torch.utils.memory import SpillableRuns

        key_fns = [compile_expr(e) for e, _ in sort_items]
        runs = SpillableRuns(self.ctx.mem_tracker.child("sort"), "sort")
        self._runs = runs
        for ch in self.children[0].chunks():
            # the sort materializes host runs, so each chunk's live rows
            # cross to the host once
            live = torch.nonzero(ch.sel).squeeze(1)
            named = {}
            for c in self.schema:
                col = ch.columns[c.uid]
                named[f"c.{c.uid}.d"] = col.data[live]
                named[f"c.{c.uid}.v"] = col.valid[live]
            for i, f in enumerate(key_fns):
                kc = f(ch)
                named[f"k.{i}.d"] = kc.data[live]
                named[f"k.{i}.v"] = kc.valid[live]
            # host-sync: the sort materializes host runs; one batched
            # fetch per chunk (was one copy per column)
            runs.append(dispatch.device_get(named))
        return runs

    def _global_keys(self, runs, n_keys: int):
        """Concatenate sort keys across runs (keys stay in host memory;
        only the payload gather is mmap-backed)."""
        host_keys = []
        for i in range(n_keys):
            ds, vs = [], []
            for loader, _rows in runs.all_runs():
                ds.append(np.asarray(loader(f"k.{i}.d")))
                vs.append(np.asarray(loader(f"k.{i}.v")))
            host_keys.append(
                (ds[0] if len(ds) == 1 else np.concatenate(ds) if ds else np.zeros(0),
                 vs[0] if len(vs) == 1 else np.concatenate(vs) if vs else np.zeros(0, dtype=np.bool_))
            )
        return host_keys

    def _emit(self, runs, order: Optional[np.ndarray], n: int):
        """Emit output chunks by gathering `order` rows from the runs."""
        cap = self.ctx.chunk_capacity
        self._chunks = []
        idx = order if order is not None else np.arange(n)
        run_list = runs.all_runs()
        bases = np.cumsum([0] + [rows for _, rows in run_list])
        handles = {}

        def col_of(ri, name):
            key = (ri, name)
            if key not in handles:
                handles[key] = run_list[ri][0](name)
            return handles[key]

        for s in range(0, len(idx), cap):
            part = idx[s : s + cap]
            cols = {}
            for c in self.schema:
                d_out = v_out = None
                for ri in range(len(run_list)):
                    m = (part >= bases[ri]) & (part < bases[ri + 1])
                    if not m.any():
                        continue
                    local = part[m] - bases[ri]
                    d = col_of(ri, f"c.{c.uid}.d")
                    if d_out is None:
                        d_out = np.empty(len(part), dtype=d.dtype)
                        v_out = np.empty(len(part), dtype=np.bool_)
                    d_out[m] = d[local]
                    v_out[m] = col_of(ri, f"c.{c.uid}.v")[local]
                if d_out is None:
                    d_out = np.zeros(len(part), dtype=c.type_.np_dtype)
                    v_out = np.zeros(len(part), dtype=np.bool_)
                cols[c.uid] = Column.from_numpy(d_out, c.type_, valid=v_out,
                                                capacity=cap)
            sel = torch.zeros(cap, dtype=torch.bool)
            sel[: len(part)] = True
            self._chunks.append(Chunk(cols, sel))

    def _close_runs(self) -> None:
        if self._runs is not None:
            self._runs.close()
            self._runs = None

    def close(self) -> None:
        self._close_runs()
        super().close()

    def next(self) -> Optional[Chunk]:
        if self._chunks:
            return self._chunks.pop(0)
        return None


def _sort_order(host_keys, items) -> np.ndarray:
    """np.lexsort with MySQL NULL ordering (NULLs first ASC, last DESC)."""
    lex = []
    for (data, valid), (_, desc) in zip(host_keys, items):
        d = data
        if np.issubdtype(d.dtype, np.bool_):
            d = d.astype(np.int64)
        if desc:
            d = -d.astype(np.float64) if np.issubdtype(d.dtype, np.floating) else -d.astype(np.int64)
            nullrank = (~valid).astype(np.int64)  # nulls last on desc
        else:
            d = d.astype(np.float64) if np.issubdtype(d.dtype, np.floating) else d.astype(np.int64)
            nullrank = valid.astype(np.int64)  # nulls (0) first on asc
        d = np.where(valid, d, 0)
        # within one sort key, null-rank dominates the value
        lex.append(nullrank)
        lex.append(d)
    # np.lexsort: last key is primary; our items[0] is primary
    return np.lexsort(lex[::-1]) if lex else np.arange(len(host_keys[0][0]) if host_keys else 0)


class SortExec(_Materializing):
    def __init__(self, schema, child, items):
        super().__init__(schema, [child])
        self.items = items

    def open(self, ctx: ExecContext) -> None:
        super().open(ctx)
        self.ctx = ctx
        runs = self._drain_to_runs(self.items)
        n = sum(rows for _, rows in runs.all_runs())
        order = None
        if self.items:
            host_keys = self._global_keys(runs, len(self.items))
            order = _sort_order(host_keys, self.items)
        self._emit(runs, order, n)
        self._close_runs()  # output chunks own copies; free the charge now


class TopNExec(_Materializing):
    def __init__(self, schema, child, items, count: int, offset: int):
        super().__init__(schema, [child])
        self.items = items
        self.count = count
        self.offset = offset

    def open(self, ctx: ExecContext) -> None:
        super().open(ctx)
        self.ctx = ctx
        runs = self._drain_to_runs(self.items)
        n = sum(rows for _, rows in runs.all_runs())
        host_keys = self._global_keys(runs, len(self.items))
        order = _sort_order(host_keys, self.items)
        order = order[self.offset : self.offset + self.count]
        self._emit(runs, order, n)
        self._close_runs()


class LimitExec(Executor):
    def __init__(self, schema, child, count: int, offset: int):
        super().__init__(schema, [child])
        self.count = count
        self.offset = offset

    def open(self, ctx: ExecContext) -> None:
        super().open(ctx)
        self.ctx = ctx
        self._skipped = 0
        self._taken = 0

    def next(self) -> Optional[Chunk]:
        while self._taken < self.count:
            ch = self.children[0].next()
            if ch is None:
                return None
            # host-sync: LIMIT counts live rows on the host, one small
            # fetch per chunk until the count is reached
            sel = dispatch.device_get(ch.sel)
            live = np.nonzero(sel)[0]
            m = len(live)
            if m == 0:
                continue
            drop = min(self._skipped_remaining(), m)
            take = min(self.count - self._taken, m - drop)
            self._skipped += drop
            self._taken += take
            if take <= 0:
                continue
            keep = np.zeros_like(sel)
            keep[live[drop : drop + take]] = True
            return ch.with_sel(ch.sel & torch.from_numpy(keep).to(ch.device))
        return None

    def _skipped_remaining(self) -> int:
        return max(0, self.offset - self._skipped)


class UnionExec(Executor):
    """UNION ALL: chain child streams (children project onto shared uids)."""

    def open(self, ctx: ExecContext) -> None:
        super().open(ctx)
        self._i = 0

    def next(self) -> Optional[Chunk]:
        while self._i < len(self.children):
            ch = self.children[self._i].next()
            if ch is not None:
                return ch
            self._i += 1
        return None
