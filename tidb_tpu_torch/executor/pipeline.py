"""Pipelined device-resident fragment execution (counterpart of
tidb_tpu/executor/pipeline.py).

Five pieces take the per-chunk host ping-pong out of the executor tree:

  * ``FusedScanAggExec``: scan -> filter -> project -> aggregation as one
    fragment. Each staged batch is decoded, filtered and projected on the
    device and folded into state that stays there across batches: the
    segment strategy's [G]-shaped accumulators (one ``tidb_segagg`` launch
    per batch on the card), or the generic strategy's sort-based group
    tables (executor/agg_device.py, merged on the device in a binary
    counter). The state visits the host once, at finalize. Columnar
    segments pack several per batch at a fixed ``seg_cap`` stride, so a
    scan over small segments still takes ~n / chunk_capacity batches.

  * ``FusedScanTopNExec``: an ORDER BY [LIMIT] root over a plain scan
    pipeline. Each staged batch is merged into a bounded device top-k
    state (ops/topk.py) of the current offset + count winners, which the
    host fetches once at finalize.

  * ``FusedScanProbeExec``: an inner or LEFT hash join whose probe side
    is a plain scan pipeline. Each staged probe batch runs decode +
    filter + project + key pack + probe (one ``tidb_probe_count`` launch
    on the card) + the first output tile's expansion before its match
    total is known; the totals are fetched once per window of
    PROBE_SYNC_CHUNKS batches, and only batches whose matches overflow
    the first tile expand further. The build side runs the classic
    HashJoinExec build and, when it is itself a plain scan over a stored
    table, is parked in the ``DeviceBufferCache``.

  * ``ChunkPrefetcher``: staging ahead of compute. A thread builds each
    batch's host buffers in ONE pinned buffer (``HostArena``), copies it
    to the card with one non-blocking copy on a dedicated copy stream and
    records an event; the consumer makes its compute stream wait on that
    event and marks the device buffer as used by the compute stream
    (``record_stream``), so the caching allocator cannot hand the block
    to the copy stream while a kernel still reads it. The in-flight
    window is ``tidb_tpu_pipeline_prefetch_depth`` batches, charged to
    the statement MemTracker; depth 0 stages inline (chosen by that
    sysvar only). KILL/deadline is polled inside the thread.

  * ``DeviceBufferCache``: staged scan inputs kept on the device across
    statements, keyed like the plan cache. A catalog ``schema_version``
    bump clears it (storage/catalog.py), and each entry pins
    ``Table.version``, ``Table.data_epoch`` and the segment store's
    generation and coverage (``table_ident``), so INSERT, the dictionary
    re-encode and DDL all invalidate. A warm TPC-H Q1/Q6 re-run stages
    nothing.

The reference runs each fragment as one jitted XLA program per batch;
here each fused batch goes through ``utils.jitcache.cached_jit`` at the
reference's four sites (segment and generic aggregation, scan->probe,
top-k), which on the card captures the batch's launches once per input
signature into a CUDA graph and replays it for every later batch: one
replay, a copy in and a clone out a batch instead of tens of launches.

The reference's metrics are plain module-level counters here, under its
label names: ``DEVICE_CACHE_TOTAL`` (hit, miss, invalidate, evict),
``PIPELINE_PREFETCH_TOTAL`` (hit, wait, inline, cancelled, error) and
``PIPELINE_PREFETCH_BYTES`` (h2d bytes and copies the prefetcher issued);
``PIPELINE_STAGE_SECONDS`` the host time it spent building and copying;
``PIPELINE_FUSED_TOTAL`` counts fragments that ran fused, by kind, and
those that took their classic delegate.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from tidb_tpu_torch.chunk.chunk import Chunk
from tidb_tpu_torch.chunk.column import Column
from tidb_tpu_torch.executor import aggregate as _agg
from tidb_tpu_torch.executor.aggregate import HashAggExec
from tidb_tpu_torch.executor.base import ExecContext, Executor, raise_if_cancelled
from tidb_tpu_torch.executor.join import HashJoinExec, _pad, tile_row_bytes
from tidb_tpu_torch.expression.compiler import eval_expr
from tidb_tpu_torch.ops import hash_probe as hp
from tidb_tpu_torch.ops import join_kernels as jk
from tidb_tpu_torch.utils import dispatch, jitcache
from tidb_tpu_torch.utils.device import torch_dtype
from tidb_tpu_torch.utils.jitcache import cached_jit
from tidb_tpu_torch.utils.memory import QueryOOMError

__all__ = ["DEVICE_CACHE", "DeviceBufferCache", "ChunkPrefetcher", "HostArena",
           "FusedScanAggExec", "FusedScanProbeExec", "FusedScanTopNExec", "table_ident",
           "DEVICE_CACHE_TOTAL", "PIPELINE_PREFETCH_TOTAL",
           "PIPELINE_PREFETCH_BYTES", "PIPELINE_STAGE_SECONDS", "PIPELINE_FUSED_TOTAL",
           "reset_counters"]

DEVICE_CACHE_TOTAL = {"hit": 0, "miss": 0, "invalidate": 0, "evict": 0}
PIPELINE_PREFETCH_TOTAL = {"hit": 0, "wait": 0, "inline": 0, "cancelled": 0,
                           "error": 0}
# bytes the prefetcher moved host->device and the copies it issued (one
# per staged batch)
PIPELINE_PREFETCH_BYTES = {"h2d": 0, "copies": 0}
# host seconds the prefetcher spent building batches ("job": the staging
# job, arena included) and handing them to the device ("copy")
PIPELINE_STAGE_SECONDS = {"job": 0.0, "copy": 0.0}
# fused fragments by how they ran: "agg" (segment strategy), "generic"
# (the generic strategy's device group tables), "probe" and "topn" ran
# fused, "delegate" fell back to the classic tree at open()
PIPELINE_FUSED_TOTAL = {"agg": 0, "generic": 0, "probe": 0, "topn": 0, "delegate": 0}
_COUNT_LOCK = threading.Lock()


def _count(counter: dict, key: str, n: int = 1) -> None:
    with _COUNT_LOCK:
        counter[key] += n


def reset_counters() -> None:
    with _COUNT_LOCK:
        for counter in (DEVICE_CACHE_TOTAL, PIPELINE_PREFETCH_TOTAL,
                        PIPELINE_PREFETCH_BYTES, PIPELINE_STAGE_SECONDS,
                        PIPELINE_FUSED_TOTAL):
            for k in counter:
                counter[k] = 0


def table_ident(table) -> tuple:
    """Everything a cached staged buffer's validity depends on: ``version``
    moves on every DML, ``data_epoch`` on in-place rewrites (the
    dictionary re-encode), the stats identity on ANALYZE, and the segment
    store's generation/coverage on columnar rebuilds. Schema-version
    bumps clear the whole cache eagerly through the catalog hook."""
    base = getattr(table, "_base", table)
    stats = getattr(base, "stats", None)
    store = getattr(base, "_segment_store", None)
    return (
        getattr(base, "version", None),
        getattr(base, "data_epoch", None),
        None if stats is None else (id(stats), stats.version),
        None if store is None else (store.generation, store.covered),
        getattr(table, "n", None),
    )


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _pytree_nbytes(tree) -> int:
    return int(sum(getattr(leaf, "nbytes", 0) for leaf in _leaves(tree)))


class DeviceBufferCache:
    """Process-global LRU of staged device scan inputs.

    One entry = one (table, staging layout) pair holding the full list of
    staged per-batch pytrees a fused fragment consumed, plus the identity
    tuple that proves them current. The entry pins the table object so a
    recycled ``id()`` can never alias a different table; the byte budget
    (``tidb_tpu_device_buffer_cache_bytes``) bounds resident bytes with
    LRU eviction."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, dict]" = OrderedDict()
        self._bytes = 0

    def get(self, table, tag, ident) -> Optional[List]:
        key = (id(table), tag)
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e["table"] is table and e["ident"] == ident:
                self._entries.move_to_end(key)
                _count(DEVICE_CACHE_TOTAL, "hit")
                return e["chunks"]
            if e is not None:
                # same statement shape, stale data
                self._bytes -= e["nbytes"]
                del self._entries[key]
                _count(DEVICE_CACHE_TOTAL, "invalidate")
        _count(DEVICE_CACHE_TOTAL, "miss")
        return None

    def put(self, table, tag, ident, chunks: List, nbytes: int, budget: int) -> None:
        if budget <= 0 or nbytes > budget:
            return
        key = (id(table), tag)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old["nbytes"]
            self._entries[key] = {"table": table, "ident": ident,
                                  "chunks": chunks, "nbytes": int(nbytes)}
            self._bytes += int(nbytes)
            while self._bytes > budget and len(self._entries) > 1:
                _k, ev = self._entries.popitem(last=False)
                self._bytes -= ev["nbytes"]
                _count(DEVICE_CACHE_TOTAL, "evict")

    def on_schema_change(self) -> None:
        """Eager clear on any catalog.schema_version bump (DDL)."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._bytes = 0
        if n:
            _count(DEVICE_CACHE_TOTAL, "invalidate", n)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def drop_table(self, table) -> int:
        """Drop every entry staged from `table`: a dropped temporary table,
        whose DDL bumps no schema_version. Returns the entries dropped."""
        with self._lock:
            keys = [k for k, e in self._entries.items() if e["table"] is table]
            for k in keys:
                self._bytes -= self._entries.pop(k)["nbytes"]
        return len(keys)

    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


DEVICE_CACHE = DeviceBufferCache()


_ALIGN = 64  # every view of an arena starts on a 64-byte boundary


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


class HostArena:
    """One staging job's host buffers: zeroed numpy views carved from a
    single byte buffer, pinned when the batch goes to a card, so a staged
    batch crosses host->device in one copy. Size it with `nbytes_for`."""

    def __init__(self, nbytes: int, pin: bool):
        self.buf = torch.empty(max(int(nbytes), 1), dtype=torch.uint8, pin_memory=pin)
        self._np = self.buf.numpy()
        self._base = self._np.ctypes.data
        self.used = 0

    @staticmethod
    def nbytes_for(specs) -> int:
        """Arena bytes for (rows, dtype) pairs."""
        return sum(_aligned(n * np.dtype(dt).itemsize) for n, dt in specs)

    def zeros(self, n: int, dtype) -> np.ndarray:
        dt = np.dtype(dtype)
        end = self.used + n * dt.itemsize
        if end > self._np.shape[0]:
            raise ValueError(f"arena of {self._np.shape[0]} B cannot hold {end} B")
        a = self._np[self.used:end].view(dt)
        a[...] = 0
        self.used = _aligned(end)
        return a

    def view_of(self, buf: torch.Tensor, a: np.ndarray) -> torch.Tensor:
        """The tensor over `buf` (this arena's buffer or its device copy)
        that holds what the host view `a` holds."""
        off = a.ctypes.data - self._base
        return buf[off:off + a.nbytes].view(torch_dtype(a.dtype))


def _on_buffer(host, arena: HostArena, buf):
    """The host pytree `host`, carved from `arena`, as views of `buf` (the
    arena's buffer or its device copy); a scan batch, (data, valid, refs,
    sel), as a jitcache.PackedTuple over `buf`, so a fused batch program
    copies it in at once."""
    tree = _tree_map(lambda a: arena.view_of(buf, a), host)
    return jitcache.packed_view(buf, tree) if isinstance(tree, tuple) else tree


class ChunkPrefetcher:
    """Staging ahead of the compute loop.

    ``jobs`` is an ordered list of callables ``job(arena_for)``, each
    returning one batch's host pytree of numpy arrays carved from the one
    ``HostArena`` it asks ``arena_for(nbytes)`` for. A daemon thread runs
    them in order and stages each arena onto ``ctx.device``, parking when
    ``depth`` batches sit staged but unconsumed. In-flight staged bytes
    are charged to the statement MemTracker: a tight
    ``tidb_mem_quota_query`` surfaces as the typed ``QueryOOMError``.
    KILL and statement deadlines are polled before every job and while
    parked. An error in the thread reaches the consumer unchanged from
    ``get``; nothing falls back to inline or pageable staging.

    On a card, each arena is pinned, copied with one ``non_blocking``
    copy on this prefetcher's copy stream (the staging thread enters the
    context's device and that stream: both are thread-local in torch),
    and an event recorded after the copy. ``get`` makes the consumer's
    current stream wait on the event and calls ``record_stream`` on the
    device buffer. The pinned arena is released after ``get``; torch's
    pinned-memory allocator recorded the copy's event on the block, so
    it hands the block out again only once the copy is done. The staged
    bytes are charged to the statement's thread (utils/dispatch's
    ``Account``), not to the staging thread, and ``close`` joins the
    staging thread."""

    POLL_S = 0.05

    def __init__(self, jobs: List[Callable], ctx: ExecContext, stats=None):
        self.jobs = jobs
        self.ctx = ctx
        self.stats = stats
        self.depth = max(int(getattr(ctx, "prefetch_depth", 0) or 0), 0)
        self.tracker = ctx.mem_tracker.child("pipeline.prefetch")
        self.device = torch.device(ctx.device)
        self._cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(device=self.device) if self._cuda else None
        # the statement's dispatch account: the bytes this prefetcher
        # stages (on its own thread too) are the statement's transfer
        self._account = dispatch.account()
        self._staged: Dict[int, tuple] = {}
        self._err: Optional[BaseException] = None
        self._next_get = 0
        self._cv = threading.Condition()
        self._stop = False
        self._thread = None
        if self.depth > 0 and len(jobs) > 1:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="tidb-torch-prefetch")
            self._thread.start()

    # -- staging -----------------------------------------------------------

    def _stage(self, job) -> tuple:
        """Run one job and stage its arena: (device pytree, nbytes, copy
        event or None, device buffer or None)."""
        arenas: List[HostArena] = []

        def arena_for(nbytes: int) -> HostArena:
            arenas.append(HostArena(nbytes, pin=self._cuda))
            return arenas[-1]

        t0 = time.perf_counter()
        host = job(arena_for)
        t1 = time.perf_counter()
        _count(PIPELINE_STAGE_SECONDS, "job", t1 - t0)
        if len(arenas) != 1:
            raise RuntimeError(f"a staging job made {len(arenas)} arenas, not one")
        arena = arenas[0]
        nbytes = arena.used
        if not self._cuda:
            # the CPU is the device: the arena's own buffer is the batch
            return _on_buffer(host, arena, arena.buf[:nbytes]), nbytes, None, None
        with torch.cuda.stream(self._copy_stream):
            dev_buf = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            dev_buf.copy_(arena.buf[:nbytes], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        _count(PIPELINE_STAGE_SECONDS, "copy", time.perf_counter() - t1)
        _count(PIPELINE_PREFETCH_BYTES, "h2d", nbytes)
        _count(PIPELINE_PREFETCH_BYTES, "copies")
        dispatch.record_xfer(nbytes, into=self._account)
        return _on_buffer(host, arena, dev_buf), nbytes, event, dev_buf

    def _run(self) -> None:
        try:
            with torch.cuda.device(self.device) if self._cuda else nullcontext():
                for i, job in enumerate(self.jobs):
                    with self._cv:
                        while not self._stop and i - self._next_get >= self.depth:
                            # parked on a full window: keep honoring
                            # KILL/deadline while the consumer computes
                            raise_if_cancelled(self.ctx)
                            self._cv.wait(self.POLL_S)
                        if self._stop:
                            return
                    raise_if_cancelled(self.ctx)
                    entry = self._stage(job)
                    try:
                        self.tracker.consume(entry[1])  # typed OOM propagates below
                    except BaseException:
                        # the charge was recorded before the budget check
                        # raised, and the entry is never handed over
                        self.tracker.release(entry[1])
                        raise
                    with self._cv:
                        if self._stop:
                            self.tracker.release(entry[1])
                            return
                        self._staged[i] = entry
                        self._cv.notify_all()
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            # thread verbatim through get(); the typed kill/deadline/OOM
            # classification must survive the hop
            from tidb_tpu_torch.errors import QueryKilledError, QueryTimeoutError

            cancelled = isinstance(e, (QueryKilledError, QueryTimeoutError))
            _count(PIPELINE_PREFETCH_TOTAL, "cancelled" if cancelled else "error")
            with self._cv:
                self._err = e
                self._cv.notify_all()

    # -- consumption -------------------------------------------------------

    def _hand_over(self, entry):
        """Order the consumer's stream after the batch's copy and tie the
        device buffer's lifetime to that stream."""
        staged, _nbytes, event, dev_buf = entry
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            dev_buf.record_stream(stream)
        return staged

    def get(self, i: int):
        """Batch i's staged device pytree, blocking on in-flight staging."""
        if self._thread is None:
            entry = self._stage(self.jobs[i])
            _count(PIPELINE_PREFETCH_TOTAL, "inline")
            return self._hand_over(entry)
        with self._cv:
            self._next_get = max(self._next_get, i + 1)
            self._cv.notify_all()
            ready = i in self._staged
            while i not in self._staged and self._err is None:
                raise_if_cancelled(self.ctx)
                self._cv.wait(self.POLL_S)
            if i not in self._staged:
                raise self._err
            entry = self._staged.pop(i)
            self._cv.notify_all()
        self.tracker.release(entry[1])
        _count(PIPELINE_PREFETCH_TOTAL, "hit" if ready else "wait")
        if ready and self.stats is not None:
            self.stats.staged += 1
        return self._hand_over(entry)

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
            leftover = sum(e[1] for e in self._staged.values())
            self._staged.clear()
        if self._thread is not None:
            # joined, not abandoned: the thread stops at its next job or
            # poll, and a statement's end leaves no staging behind it
            self._thread.join()
            self._thread = None
        if leftover:
            self.tracker.release(leftover)


# ---------------------------------------------------------------------------
# the scan side of a fused fragment
# ---------------------------------------------------------------------------


class _StagedScanMixin:
    """The scan side of a fused fragment, shared by ``FusedScanAggExec`` and
    ``FusedScanProbeExec``: plan the ordered staging schedule (packed
    columnar segments with zone-map pruning, raw slices for the uncovered
    tail), stream the staged device pytrees through the prefetcher, and
    ride the cross-statement ``DeviceBufferCache``. Requires ``table``,
    ``scan_schema``, ``prune_bounds``, ``ctx``, ``stats``, and the
    ``_pin``/``_prefetcher``/``_seg_cap`` slots.

    The reference puts an XLA optimization barrier (``_barrier_chunk``)
    between the scan pipeline and its consumer inside the fused program,
    so XLA computes the decoded chunk once; eager torch computes every
    intermediate once anyway, so the port has no barrier."""

    def _release_staging(self) -> None:
        it = getattr(self, "_staged_iter", None)
        if it is not None:
            it.close()  # runs the generator's finally (fill release)
            self._staged_iter = None
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None
        if self._pin is not None:
            self._pin.close()
            self._pin = None
        if getattr(self, "_staged_scan_counted", False):
            self._staged_scan_counted = False
            self.table.txn_guard.scan_exit()

    # -- staging plan ------------------------------------------------------

    def _plan_staging(self, ctx: ExecContext):
        """The ordered staging schedule (a list of jobs). Columnar segments
        pack ``k = capacity // seg_cap`` per batch at a fixed stride; the
        uncovered delta tail stages as raw capacity-sized slices. Zone maps
        prune segments before anything is staged, as in the unfused scan."""
        cap = ctx.chunk_capacity
        table = self.table
        # count as an open scan for the staging window: raw-tail slices
        # and live_mask reads hit the table's live arrays lock-free, so
        # a CLUSTER BY permute must refuse until _release_staging runs
        guard = getattr(table, "txn_guard", None)
        if guard is not None and not getattr(
                self, "_staged_scan_counted", False):
            guard.scan_enter()
            self._staged_scan_counted = True
        jobs = []
        tail_start = 0
        self._seg_cap = None
        if ctx.columnar_enable:
            from tidb_tpu_torch.columnar.store import ScanPin, store_for

            store = store_for(
                table, segment_rows=ctx.segment_rows,
                delta_rows=ctx.segment_delta_rows,
                spill_dir=ctx.columnar_spill_dir or None,
                compaction=ctx.compaction_enable)
            if store is not None:
                self._pin = ScanPin(store, ctx.mem_tracker)
                segs, pruned, covered = store.plan_scan(self.prune_bounds, pin=self._pin)
                self.stats.segs_scanned += len(segs)
                self.stats.segs_pruned += pruned
                tail_start = covered
                seg_cap = 1
                while seg_cap < min(store.segment_rows, cap):
                    seg_cap *= 2
                self._seg_cap = seg_cap
                k = max(cap // seg_cap, 1)
                slots = []
                for seg in segs:
                    for s in range(0, seg.rows, seg_cap):
                        slots.append((seg, s, min(s + seg_cap, seg.rows)))
                for i in range(0, len(slots), k):
                    batch = slots[i:i + k]
                    # the tail batch sizes to ITS slot count: padding it to
                    # k segments would decode and aggregate dead blocks
                    jobs.append(self._seg_batch_job(batch, len(batch), seg_cap))
                if not slots:
                    self._pin.close()  # nothing to stage: drop refs now
                    self._pin = None
        n = table.n
        for s in range(tail_start, n, cap):
            jobs.append(self._raw_slice_job(s, min(s + cap, n), cap))
        return jobs

    def _seg_batch_job(self, batch, k: int, seg_cap: int):
        """Stage up to k encoded segments into ONE [k * seg_cap] buffer
        set. Payloads keep their narrow encoded dtypes (promoted to the
        widest within the batch); per-segment FoR bases travel as [k]
        vectors, decoded on the device against each row's segment id.
        MVCC visibility is read fresh from the table's arrays."""
        table, pin, schema, ctx = self.table, self._pin, self.scan_schema, self.ctx

        def job(arena_for):
            bcap = k * seg_cap
            per_col: Dict[str, list] = {c.uid: [] for c in schema}
            lives = []
            for seg, s, e in batch:
                pin.touch(seg)
                for c in schema:
                    if c.name == "__rowid__":
                        per_col[c.uid].append(("rowid", seg.start + s, e - s))
                    else:
                        enc, sd, sv = seg.col(c.name)
                        # slices VIEW the (immutable) payload arrays; the
                        # views keep them alive past an eviction
                        per_col[c.uid].append((enc, sd[s:e], sv[s:e]))
                lives.append(table.live_mask(seg.start + s, seg.start + e,
                                             read_ts=ctx.read_ts, marker=ctx.txn_marker))
            layout = []  # (uid, payload dtype, any FoR)
            for c in schema:
                entries = per_col[c.uid]
                if c.name == "__rowid__":
                    layout.append((c.uid, np.dtype(np.int64), False))
                    continue
                dt = entries[0][1].dtype
                for _enc, sd, _sv in entries[1:]:
                    dt = np.promote_types(dt, sd.dtype)
                layout.append((c.uid, np.dtype(dt),
                               any(enc.kind == "for" for enc, _d, _v in entries)))
            specs = [(bcap, np.bool_)]
            for _uid, dt, any_for in layout:
                specs += [(bcap, dt), (bcap, np.bool_)] + ([(k, np.int64)] if any_for else [])
            arena = arena_for(HostArena.nbytes_for(specs))
            sel = arena.zeros(bcap, np.bool_)
            for j, live in enumerate(lives):
                sel[j * seg_cap:j * seg_cap + len(live)] = live
            data, valid, refs = {}, {}, {}
            for uid, dt, any_for in layout:
                d = arena.zeros(bcap, dt)
                v = arena.zeros(bcap, np.bool_)
                rv = arena.zeros(k, np.int64) if any_for else None
                for j, entry in enumerate(per_col[uid]):
                    off = j * seg_cap
                    if entry[0] == "rowid":
                        _tag, start0, n = entry
                        d[off:off + n] = np.arange(start0, start0 + n, dtype=np.int64)
                        v[off:off + n] = True
                        continue
                    enc, sd, sv = entry
                    d[off:off + len(sd)] = sd
                    v[off:off + len(sd)] = sv
                    if enc.kind == "for":
                        rv[j] = enc.ref
                data[uid], valid[uid] = d, v
                if any_for:
                    refs[uid] = rv
            return data, valid, refs, sel

        return job

    def _raw_slice_job(self, s: int, e: int, cap: int):
        table, schema, ctx = self.table, self.scan_schema, self.ctx

        def job(arena_for):
            n = e - s
            cols = []
            for c in schema:
                if c.name == "__rowid__":
                    cols.append((c.uid, np.arange(s, e, dtype=np.int64),
                                 np.ones(n, dtype=np.bool_)))
                else:
                    cd, cv = table.column_slice(c.name, s, e)
                    cols.append((c.uid, cd, cv))
            specs = [(cap, np.bool_)]
            for _uid, cd, _cv in cols:
                specs += [(cap, cd.dtype), (cap, np.bool_)]
            arena = arena_for(HostArena.nbytes_for(specs))
            sel = arena.zeros(cap, np.bool_)
            sel[:n] = table.live_mask(s, e, read_ts=ctx.read_ts, marker=ctx.txn_marker)
            data, valid = {}, {}
            for uid, cd, cv in cols:
                d = arena.zeros(cap, cd.dtype)
                d[:n] = cd
                v = arena.zeros(cap, np.bool_)
                v[:n] = cv
                data[uid], valid[uid] = d, v
            return data, valid, {}, sel

        return job

    # -- staged chunk stream (prefetch + device buffer cache) --------------

    def _staged_chunks(self, jobs):
        """Yield staged device pytrees in batch order: from the device
        buffer cache when a warm identical statement already staged them,
        else through the prefetcher, filling the cache on the way out when
        everything fits the budget."""
        ctx = self.ctx
        budget = int(getattr(ctx, "device_buffer_cache_bytes", 0) or 0)
        cacheable = (budget > 0 and jobs
                     and ctx.read_ts is None and ctx.txn_marker == 0)
        tag = ident = None
        if cacheable:
            # the batch set itself is a deterministic function of (table
            # identity, bounds, capacities): folding it into the key would
            # turn every DML into a silent key change instead of a counted
            # invalidation
            tag = ("scanstage", str(ctx.device),
                   tuple((c.uid, c.name) for c in self.scan_schema),
                   ctx.chunk_capacity, self._seg_cap, repr(self.prune_bounds))
            ident = table_ident(self.table)
            hit = DEVICE_CACHE.get(self.table, tag, ident)
            if hit is not None:
                self.stats.staged += len(hit)
                for staged in hit:
                    yield staged
                return
        pf = ChunkPrefetcher(jobs, ctx, stats=self.stats)
        self._prefetcher = pf
        collect: Optional[list] = [] if cacheable else None
        # the fill holds every staged buffer alive until put(): charged to
        # the statement tracker while the fragment runs. Quota pressure
        # abandons the fill, never the query, and the fill stops past half
        # the statement's headroom so the other consumers (prefetch
        # window, segment pins) keep theirs
        fill_tracker = ctx.mem_tracker.child("pipeline.cache_fill")
        stmt_budget = getattr(ctx.mem_tracker, "budget", None)
        nbytes = 0

        def abandon():
            nonlocal collect, nbytes
            collect = None
            fill_tracker.release(nbytes)
            nbytes = 0

        try:
            for i in range(len(jobs)):
                staged = pf.get(i)
                if collect is not None:
                    b = _pytree_nbytes(staged)
                    if nbytes + b > budget:
                        abandon()  # too big to pin: stream through
                    elif stmt_budget and (ctx.mem_tracker.consumed + b > stmt_budget // 2):
                        abandon()  # leave the quota to the real work
                    else:
                        try:
                            fill_tracker.consume(b)
                        except QueryOOMError:
                            fill_tracker.release(b)  # charged before it raised
                            abandon()
                        else:
                            nbytes += b
                            collect.append(staged)
                yield staged
            if collect is not None:
                DEVICE_CACHE.put(self.table, tag, ident, collect, nbytes, budget)
        finally:
            fill_tracker.release(nbytes)


def _collect_feedback_pairs(root) -> list:
    """(plan_node, actual_out_rows) pairs of every annotated exec in a
    transient subtree whose actual is host-known, taken before the subtree
    is dropped, so plan feedback still sees e.g. the build-side join a
    fused probe drained inside its own open()."""
    out = []
    stack = [root]
    while stack:
        e = stack.pop()
        if e is None:
            continue
        p = getattr(e, "_feedback_plan", None)
        rows = getattr(getattr(e, "stats", None), "out_rows", -1)
        if p is not None and rows >= 0:
            out.append((p, int(rows)))
        out.extend(getattr(e, "_fb_build_pairs", ()))
        stack.extend(getattr(e, "children", ()))
        stack.append(getattr(e, "_delegate", None))
    return out


def _close_delegate(outer) -> None:
    """Close a fused exec's open()-time fallback delegate and keep the
    feedback truth its subtree learned: the delegate's host-known output
    count folds onto the outer exec's stats (both answer for the same plan
    node), and its annotated children's pairs park on _fb_build_pairs, as
    plan feedback harvests after the tree is closed."""
    d, outer._delegate = outer._delegate, None
    if d is None:
        return
    d.close()  # first: nested fused execs fold their own delegates
    # EXPLAIN ANALYZE renders after the tree is closed: keep the delegate
    # that ran reachable for its [classic] subtree
    outer._fallback_taken = d
    st = getattr(d, "stats", None)
    if st is not None and st.out_rows >= 0:
        outer.stats.add_out_rows(st.out_rows)
    outer._fb_build_pairs = (tuple(outer._fb_build_pairs)
                             + tuple(_collect_feedback_pairs(d)))


# ---------------------------------------------------------------------------
# fused scan -> filter -> project -> segment aggregation
# ---------------------------------------------------------------------------


class FusedScanAggExec(_StagedScanMixin, HashAggExec):
    """HashAgg whose child is a fusible scan pipeline, run as a push-based
    device-resident fragment: staged batches stream through decode,
    pipeline and the aggregation (the segment update, or the generic
    strategy's partial group table pushed onto a GroupTableStack), and the
    state never visits the host until finalize. Falls back to the classic
    pull-based tree (``fallback_build``) when the context disables fusion
    or, for the generic strategy, the device engine (``device_agg``)."""

    def __init__(self, schema, scan_schema, table, stages, prune_bounds,
                 group_exprs, group_uids, aggs, strategy,
                 segment_sizes=None, fallback_build=None):
        super().__init__(schema, None, group_exprs, group_uids, aggs,
                         strategy, segment_sizes=segment_sizes)
        self.children = []
        self.scan_schema = scan_schema
        self.table = table
        self.scan_stages = stages
        self.prune_bounds = prune_bounds
        self._fallback_build = fallback_build
        self._delegate = None
        self._ran_fused = False
        self._fb_build_pairs = ()
        self._pin = None
        self._prefetcher = None
        self._staged_iter = None
        self._seg_cap = None

    def open(self, ctx: ExecContext) -> None:
        self.ctx = ctx
        self._out = []
        self._delegate = None
        if not self._fuse_eligible(ctx):
            self._ran_fused = False
            _count(PIPELINE_FUSED_TOTAL, "delegate")
            # held before open(): a delegate whose open() raises still gets
            # its close() (spill files, tracked bytes) through _close_delegate
            d = self._delegate = self._fallback_build()
            d.open(ctx)
            return
        self._ran_fused = True
        try:
            if self.strategy == "segment":
                _count(PIPELINE_FUSED_TOTAL, "agg")
                self._run_segment_fused()
            else:
                _count(PIPELINE_FUSED_TOTAL, "generic")
                self._run_generic_fused()
        finally:
            self._release_staging()

    def next(self):
        if self._delegate is not None:
            return self._delegate.next()
        return super().next()

    def close(self) -> None:
        _close_delegate(self)
        self._release_staging()
        super().close()

    def _fuse_eligible(self, ctx: ExecContext) -> bool:
        if not getattr(ctx, "pipeline_fuse", True) or self.table is None:
            return False
        if self.strategy == "segment":
            return True
        from tidb_tpu_torch.planner.logical import core_generic_agg

        return ctx.device_agg and core_generic_agg(self.group_exprs, self.aggs)

    def _run_segment_fused(self):
        from tidb_tpu_torch.ops.segment_scan import segment_scan_key

        ctx = self.ctx
        domains = [s + 1 for s in (self.segment_sizes or [])]
        jobs = self._plan_staging(ctx)
        col_types = [(c.uid, c.type_) for c in self.scan_schema]
        stages, seg_cap = self.scan_stages, self._seg_cap
        key = ("seg|" + segment_scan_key(stages, col_types, seg_cap)
               + "|" + repr((self.group_exprs, self.aggs, domains)))
        # the update works in place on the state: the counterpart of the
        # reference's donate_argnums=0
        fused = cached_jit(
            "fusedagg", key,
            lambda: _make_fused_segment_fn(stages, col_types, self.group_exprs,
                                           self.aggs, domains, seg_cap),
            donate_argnums=(0,), max_bytes=_graph_quota(ctx))
        # looked up on the module at call time, like HashAggExec's own call
        init_state, _u, _g = _agg.make_segment_kernel(
            self.group_exprs, self.aggs, domains)
        # one buffer: a batch program copies the state in at once
        state = jitcache.packed(init_state(ctx.device))
        self._staged_iter = self._staged_chunks(jobs)
        for staged in self._staged_iter:
            # KILL/deadline polls between batches: fusion must not turn a
            # chunked fragment into an uninterruptible run
            raise_if_cancelled(ctx)
            state = fused(state, staged)
        self._finalize_segment_state(state, domains)

    def _run_generic_fused(self):
        from tidb_tpu_torch.executor.agg_device import GroupTableStack
        from tidb_tpu_torch.ops.segment_scan import segment_scan_key

        _agg.DEVICE_GENERIC_TOTAL["fused"] += 1
        jobs = self._plan_staging(self.ctx)
        col_types = [(c.uid, c.type_) for c in self.scan_schema]
        stages, seg_cap = self.scan_stages, self._seg_cap
        key = ("gen|" + segment_scan_key(stages, col_types, seg_cap)
               + "|" + repr((self.group_exprs, self.aggs)))
        fused = cached_jit(
            "fusedagg", key,
            lambda: _make_fused_generic_fn(stages, col_types, self.group_exprs,
                                           self.aggs, seg_cap),
            max_bytes=_graph_quota(self.ctx))
        stack = GroupTableStack(len(self.group_exprs), self.aggs)
        self._staged_iter = self._staged_chunks(jobs)
        for staged in self._staged_iter:
            raise_if_cancelled(self.ctx)  # see _run_segment_fused
            # a replay's table is a fresh clone: the stack may keep it
            stack.push(fused(staged))
        self._finalize_group_tables(stack.tables())


def _graph_quota(ctx) -> int:
    """The statement's quota on the bytes the fused batches' CUDA graphs
    hold (tidb_tpu_graph_cache_bytes)."""
    return int(getattr(ctx, "graph_cache_bytes", jitcache.MAX_BYTES))


def _make_fused_segment_fn(stages, col_types, group_exprs, aggs, domains, seg_cap):
    """(state, staged batch) -> state: decode + pipeline + the
    segment update of one staged batch (one tidb_segagg launch on the
    card), in place on the state."""
    from tidb_tpu_torch.ops.segment_scan import scan_fn

    scan = scan_fn(stages, col_types, seg_cap)
    # looked up on the module at build time: chip_smoke wraps it
    _init, update, _g = _agg.make_segment_kernel(group_exprs, aggs, domains)

    def run(state, staged):
        return update(state, scan(*staged))

    return run


def _make_fused_generic_fn(stages, col_types, group_exprs, aggs, seg_cap):
    """(staged batch) -> group table: decode + pipeline +
    sort-based partial grouping of one staged batch. No blocking inside the
    batch: the partial is a whole-batch sort, and its table has the batch's
    capacity (per-block tables would redo the stack's merges here)."""
    # looked up on the module at build time, like HashAggExec's own call
    from tidb_tpu_torch.executor import agg_device
    from tidb_tpu_torch.ops.segment_scan import scan_fn

    scan = scan_fn(stages, col_types, seg_cap)
    partial = agg_device.make_partial_kernel(group_exprs, aggs)

    def run(staged):
        return partial(scan(*staged))

    return run


# ---------------------------------------------------------------------------
# fused scan -> probe
# ---------------------------------------------------------------------------


class FusedScanProbeExec(_StagedScanMixin, HashJoinExec):
    """Inner or LEFT OUTER hash join (single or composite keys) whose probe
    side is a plain scan pipeline, run as a push-based device fragment:
    each staged probe batch goes through decode + pipeline + key pack +
    probe (``jk.probe_count``: one ``tidb_probe_count`` launch on the
    card) + the first output tile's expansion at the batch's capacity,
    against a device-resident build. The batch's match total stays on the
    device in its deferral token and doubles as the overflow flag: the
    totals of a window of PROBE_SYNC_CHUNKS batches are fetched in one
    read, and only batches whose expansion overflowed the first tile pay
    further ``expand_tiles`` calls.

    The build side runs the classic ``HashJoinExec`` build (drain + pack +
    sort + index) and, when the build child is itself a plain scan over a
    stored table, parks the finished device arrays in the cross-statement
    ``DeviceBufferCache`` keyed by the build plan's shape and the resolved
    probe mode, proven current by ``table_ident``. Ineligible contexts
    (fusion or the device engine off) and a composite key whose ranges
    overflow int64 packing (hash mode, known after the build drain) fall
    back to the classic tree through the open()-time ``fallback_build``
    delegate."""

    def __init__(self, schema, scan_schema, table, stages, prune_bounds,
                 probe_schema, probe_keys, build_keys, build_schema,
                 build_child_build, build_table=None, build_tag=None,
                 kind="inner", fallback_build=None):
        Executor.__init__(self, schema, [])
        self.kind = kind
        self.probe_keys = probe_keys
        self.build_keys = build_keys
        self.other_cond = None
        self.probe_schema = probe_schema
        self.build_schema = build_schema
        self.exists_sem = False
        self.scan_schema = scan_schema
        self.table = table
        self.scan_stages = stages
        self.prune_bounds = prune_bounds
        self._build_child_build = build_child_build
        self._build_cache_table = build_table
        self._build_cache_tag = build_tag
        self._fallback_build = fallback_build
        self._delegate = None
        self._ran_fused = False
        self._fb_build_pairs = ()
        self._pin = None
        self._prefetcher = None
        self._staged_iter = None
        self._seg_cap = None

    def open(self, ctx: ExecContext) -> None:
        self.ctx = ctx
        self._delegate = None
        self._pending: list = []
        self._drained = False
        self._filter_fn = None
        self._held = 0
        self._probe_tracker = None
        if not self._fuse_eligible(ctx):
            self._open_delegate(ctx)
            return
        self._ran_fused = True
        try:
            self._open_build(ctx)
            if self._hash_mode:
                # composite-key ranges overflowed int64 range packing
                # (known only after the build drain): hash candidates need
                # the classic probe's exact per-key re-verification
                self._open_delegate(ctx)
                return
            jobs = self._plan_staging(ctx)
            self._fused = self._make_fused()
            self._staged_iter = self._staged_chunks(jobs)
            _count(PIPELINE_FUSED_TOTAL, "probe")
        except BaseException:
            self._release_staging()
            raise

    def _open_delegate(self, ctx: ExecContext) -> None:
        self._ran_fused = False
        _count(PIPELINE_FUSED_TOTAL, "delegate")
        # held before open(): a delegate whose open() raises still gets
        # its close() (spill files, tracked bytes) through _close_delegate
        d = self._delegate = self._fallback_build()
        d.open(ctx)

    def next(self) -> Optional[Chunk]:
        if self._delegate is not None:
            return self._delegate.next()
        while True:
            out = self._pop_pending()
            if out is not None:
                return out
            if self._drained:
                return None
            self._fill_pending_fused()

    def close(self) -> None:
        _close_delegate(self)
        self._release_staging()
        super().close()

    def _fuse_eligible(self, ctx: ExecContext) -> bool:
        if not getattr(ctx, "pipeline_fuse", True) or self.table is None:
            return False
        # host-engine routing (device_agg off) keeps the classic tree
        return bool(getattr(ctx, "device_agg", True))

    # -- build side (classic build + cross-statement device cache) ---------

    # everything a warm statement needs to probe without re-draining the
    # build child: the device arrays and the host-side pack/index
    # decisions derived from the drained build data
    _BUILD_STATE_FIELDS = (
        "_sorted_keys", "_n_build_dev", "_firsts", "_build_payload",
        "_build_keyvals", "_payload_uids", "_pack_info", "_hash_mode",
        "_modes", "_los", "_strides", "_rngs", "_direct", "_direct_lo",
        "_direct_rng", "_n_build", "_build_had_null", "_has_filter",
        "_probe_table", "_build_schema_by_uid")

    def _open_build(self, ctx: ExecContext) -> None:
        budget = int(getattr(ctx, "device_buffer_cache_bytes", 0) or 0)
        bt = self._build_cache_table
        cacheable = (budget > 0 and bt is not None
                     and ctx.read_ts is None and ctx.txn_marker == 0)
        tag = ident = None
        if cacheable:
            # the RESOLVED probe mode joins the tag: the parked state bakes
            # in the mode's table/index decision
            tag = ("joinbuild", str(ctx.device), self._build_cache_tag,
                   hp.resolve_mode(ctx.join_probe_mode, ctx.device))
            ident = table_ident(bt)
            hit = DEVICE_CACHE.get(bt, tag, ident)
            if hit is not None:
                self._restore_build(hit[0])
                self.stats.staged += 1
                return
        child = self._build_child_build()
        child.open(ctx)
        try:
            self._build_from(child)
        finally:
            child.close()
            # the transient build subtree is gone after this open(): park
            # its host-known actuals for the feedback harvest
            self._fb_build_pairs = _collect_feedback_pairs(child)
        if cacheable:
            # the identity as the drain left it: the build's own scan may
            # have made or extended the table's segment store, and the next
            # statement's lookup sees that state
            state = self._snapshot_build()
            DEVICE_CACHE.put(bt, tag, table_ident(bt), [state], _pytree_nbytes(state),
                             budget)

    def _snapshot_build(self) -> dict:
        return {f: getattr(self, f) for f in self._BUILD_STATE_FIELDS}

    def _restore_build(self, state: dict) -> None:
        for f, v in state.items():
            setattr(self, f, v)
        # the resident bytes are owned (and budgeted) by the process cache
        # on a hit: close() must not release them
        self._build_bytes = 0

    # -- fused probe loop --------------------------------------------------

    def _fill_pending_fused(self) -> None:
        """Pull staged probe batches until output lands in _pending or the
        scan drains. Each batch's match total stays a device scalar in its
        deferral token; ONE read per window resolves the window."""
        deferred: List[dict] = []
        dbytes = 0
        while not self._pending and not self._drained:
            raise_if_cancelled(self.ctx)
            staged = next(self._staged_iter, None)
            if staged is None:
                self._drained = True
                break
            tok = self._probe_chunk_fused(staged)
            deferred.append(tok)
            dbytes += tok["nbytes"]
            if (len(deferred) >= self.PROBE_SYNC_CHUNKS
                    or dbytes >= self.PROBE_DEFER_BYTES):
                self._finish_fused_batch(deferred)
                deferred = []
                dbytes = 0
        if deferred:
            self._finish_fused_batch(deferred)

    def _make_fused(self):
        """The batch program of this join (cached_jit "fusedprobe"), and the
        build side's arguments it takes, fixed once the build is done."""
        from tidb_tpu_torch.ops.segment_scan import segment_scan_key

        col_types = [(c.uid, c.type_) for c in self.scan_schema]
        probe_uids = tuple(c.uid for c in self.probe_schema)
        stages, seg_cap = self.scan_stages, self._seg_cap
        self._build_args = (
            self._sorted_keys, self._n_build_dev, self._firsts, tuple(self._los),
            tuple(self._strides), tuple(self._rngs), self._direct_lo, self._direct_rng,
            self._probe_table,
            tuple(self._build_payload[u][0] for u in self._payload_uids),
            tuple(self._build_payload[u][1] for u in self._payload_uids))
        key = ("probe|" + segment_scan_key(stages, col_types, seg_cap)
               + "|" + repr((self.probe_keys, self._modes, self._direct,
                             probe_uids, self.kind)))
        def build():
            from tidb_tpu_torch.utils.metrics import JOIN_COMPILE_TOTAL

            JOIN_COMPILE_TOTAL.inc(kernel="fusedprobe")
            return _make_fused_probe_fn(stages, col_types, seg_cap,
                                        tuple(self.probe_keys), tuple(self._modes),
                                        self._direct, probe_uids, self.kind == "left")

        return cached_jit("fusedprobe", key, build, max_bytes=_graph_quota(self.ctx))

    def _probe_chunk_fused(self, staged) -> dict:
        """Decode, filter, project and probe one staged batch and expand its
        first output tile (one program, cached_jit "fusedprobe"); returns
        the deferral token pinning its device results, which a replay
        hands over as fresh tensors."""
        t0 = time.perf_counter()
        tok = dict(self._fused(staged, self._build_args))
        tok["t0"] = t0
        # the window pins the batch's first tile AND the probe state an
        # overflow re-expansion needs
        tok["nbytes"] = _pytree_nbytes(
            (tok["out_p"], tok["out_b"], tok["sel_tile"], tok["start"], tok["count"],
             tok["real_count"], tok["cum"], tok["p_cols"]))
        return tok

    def _finish_fused_batch(self, tokens: List[dict]) -> None:
        """One device->host read of the window's match totals; the totals
        double as overflow flags."""
        totals = [int(t) for t in dispatch.device_get(
            torch.stack([t["total_dev"] for t in tokens])).tolist()]
        self.stats.add_out_rows(sum(totals))
        for tok, total in zip(tokens, totals):
            self.stats.tile_chunks += 1
            if total > tok["cap"]:
                self.stats.tile_overflows += 1
                need = -(-(total - tok["cap"]) // tok["cap"])
                self.stats.tile_max_need = max(self.stats.tile_max_need, need)
        for tok, total in zip(tokens, totals):
            if total:
                self._pending.append(self._emit_fused(tok, total))
            self._observe_probe(tok["t0"])

    def _emit_fused(self, tok: dict, total: int):
        """Complete one batch with its host-known total, as the consumer
        pulls (a generator in _pending, see HashJoinExec._pop_pending):
        the first tile, then any overflow past it through the classic
        fixed-capacity tile calls, at most ctx.join_tiles tiles at a
        time, charged to the statement's tracker while they are out."""
        cap = tok["cap"]
        by_uid = self._build_schema_by_uid
        cols = {}
        for c, (d, v) in zip(self.probe_schema, tok["out_p"]):
            cols[c.uid] = Column(d[0], v[0], c.type_)
        for uid, (d, v) in zip(self._payload_uids, tok["out_b"]):
            cols[uid] = Column(d[0], v[0], by_uid[uid].type_)
        self.stats.chunks += 1
        yield Chunk(cols, tok["sel_tile"][0])
        if total <= cap:
            return
        # dup-heavy overflow: slots [cap, total) expand through
        # expand_tiles against the same device arrays
        p_datas = tuple(d for d, _v in tok["p_cols"])
        p_valids = tuple(v for _d, v in tok["p_cols"])
        b_datas = tuple(self._build_payload[u][0] for u in self._payload_uids)
        b_valids = tuple(self._build_payload[u][1] for u in self._payload_uids)
        max_tiles = max(1, self.ctx.join_tiles)
        row_bytes = tile_row_bytes(p_datas, b_datas)
        w0 = cap
        while w0 < total:
            rem = -(-(total - w0) // cap)  # ceil-div: tiles still needed
            T = min(jk.shape_bucket(rem, floor=1), max_tiles)
            held = T * cap * row_bytes
            self._hold(held)  # before the call: over the quota, nothing is made
            try:
                out_p, out_b, sel_t, _pr, _bp = jk.expand_tiles(
                    tok["start"], tok["count"], tok["real_count"], tok["cum"], w0,
                    p_datas, p_valids, b_datas, b_valids, n_tiles=T, tile_cap=cap,
                    build_cap=self._sorted_keys.shape[0], left=self.kind == "left")
                for i in range(min(T, rem)):
                    cols = {}
                    for c, (d2, v2) in zip(self.probe_schema, out_p):
                        cols[c.uid] = Column(d2[i], v2[i], c.type_)
                    for uid, (d2, v2) in zip(self._payload_uids, out_b):
                        cols[uid] = Column(d2[i], v2[i], by_uid[uid].type_)
                    self.stats.chunks += 1
                    yield Chunk(cols, sel_t[i])
            finally:
                self._unhold(held)
            w0 += T * cap


def _make_fused_probe_fn(stages, col_types, seg_cap, probe_keys, modes, direct,
                         probe_uids, left: bool):
    """(staged batch, build) -> token tensors: decode + pipeline +
    key pack + probe (one tidb_probe_count launch on the card) + the first
    output tile's expansion at the batch's capacity. `build` is the join's
    build side (sorted keys, n_build, direct index, pack ranges, direct
    domain, probe table, payload datas and valids)."""
    from tidb_tpu_torch.ops.segment_scan import scan_fn

    scan = scan_fn(stages, col_types, seg_cap)

    def run(staged, build):
        (sorted_keys, n_build, firsts, los, strides, rngs, direct_lo, direct_rng,
         table, b_datas, b_valids) = build
        ch = scan(*staged)
        cap = ch.capacity
        outs = [eval_expr(k, ch) for k in probe_keys]
        key_datas = tuple(d for d, _ in outs)
        key_valids = tuple(v for _, v in outs)
        Rp = jk.shape_bucket(cap)
        csel = ch.sel
        if Rp != cap:  # shape-bucket the probe: pad keys and sel to pow2
            key_datas = tuple(_pad(d, Rp) for d in key_datas)
            key_valids = tuple(_pad(v, Rp, False) for v in key_valids)
            csel = _pad(csel, Rp, False)
        start, count, real_count, cum, total_dev, _ok, _matched = jk.probe_count(
            sorted_keys, n_build, key_datas, key_valids, csel, los, strides, rngs,
            firsts, direct_lo, direct_rng, modes=modes, hash_mode=False,
            left_pad=left, direct=direct, table=table)
        p_cols = tuple((ch.columns[u].data, ch.columns[u].valid) for u in probe_uids)
        # the first tile at the batch's capacity, expanded before the total
        # is known: a PK-FK batch (every probe row matching at most once)
        # completes here, with no expansion after the window's fetch
        out_p, out_b, sel_t, _pr, _bp = jk.expand_tiles(
            start, count, real_count, cum, 0,
            tuple(d for d, _ in p_cols), tuple(v for _, v in p_cols),
            b_datas, b_valids, n_tiles=1, tile_cap=cap,
            build_cap=sorted_keys.shape[0], left=left)
        return {"out_p": out_p, "out_b": out_b, "sel_tile": sel_t,
                "total_dev": total_dev, "start": start, "count": count,
                "real_count": real_count, "cum": cum, "p_cols": p_cols,
                "cap": cap}

    return run


# ---------------------------------------------------------------------------
# fused scan -> top-k
# ---------------------------------------------------------------------------


def _make_fused_topn_fn(stages, col_types, seg_cap, sort_irs, descs, out_cols):
    """(state, staged batch) -> state: decode + filter + project + the
    batch's top-k merge, copied back into the packed state in place. The
    bounded top-k state (ops/topk.py layout) is the only thing carried
    between batches, so the scan never materializes on the host and the
    winners are fetched once at finalize."""
    from tidb_tpu_torch.ops import topk as tk
    from tidb_tpu_torch.ops.segment_scan import scan_fn

    scan = scan_fn(stages, col_types, seg_cap)

    def run(state, staged):
        ch = scan(*staged)
        pairs = tuple(tk.rank_operands(*eval_expr(ir, ch), desc)
                      for ir, desc in zip(sort_irs, descs))
        payload = tuple((ch.columns[c.uid].data.to(torch_dtype(c.type_.np_dtype)),
                         ch.columns[c.uid].valid) for c in out_cols)
        return jitcache.update_packed(state, tk.topk_merge(state, pairs, payload,
                                                           ch.sel, descs))

    return run


class FusedScanTopNExec(_StagedScanMixin, Executor):
    """ORDER BY [LIMIT] root whose child is a plain scan pipeline, run as a
    push-based device fragment: each staged batch is folded into a bounded
    device state of the current ``offset + count`` winners (ops/topk.py),
    and the host fetches the winners once at finalize. The classic
    ``TopNExec`` brings every child row to the host before ``np.lexsort``
    keeps k of them.

    A full ORDER BY (no LIMIT) takes the same path when every live row fits
    the state (``table.n <= capacity``): the "top n" is then the complete
    sort. Larger inputs, and a LIMIT whose ``offset + count`` exceeds the
    chunk capacity, fall back to the classic materializing sort through the
    open()-time ``fallback_build`` delegate; the LIMIT case records the
    k-overflow on the exec, and plan feedback harvests it, so the digest's
    second execution routes to the classic plan up front.

    Ordering is exact against the classic path: ops/topk.py replicates
    ``_sort_order``'s null-rank and negation, and ties resolve by global
    drain position, the device analogue of np.lexsort's stability."""

    def __init__(self, schema, scan_schema, table, stages, prune_bounds,
                 items, count, offset, full_sort=False, fallback_build=None):
        Executor.__init__(self, schema, [])
        self.scan_schema = scan_schema
        self.table = table
        self.scan_stages = stages
        self.prune_bounds = prune_bounds
        self.items = items
        self.count = count
        self.offset = offset
        self.full_sort = full_sort
        self._fallback_build = fallback_build
        self._delegate = None
        self._ran_fused = False
        self._topn_overflow = 0
        self._fb_build_pairs = ()
        self._pin = None
        self._prefetcher = None
        self._staged_iter = None
        self._seg_cap = None

    def open(self, ctx: ExecContext) -> None:
        self.ctx = ctx
        self._chunks: List[Chunk] = []
        self._delegate = None
        self._topn_overflow = 0
        k, eligible = self._state_rows(ctx)
        if not eligible:
            self._ran_fused = False
            _count(PIPELINE_FUSED_TOTAL, "delegate")
            # held before open(): a delegate whose open() raises still gets
            # its close() (spill files, tracked bytes) through _close_delegate
            d = self._delegate = self._fallback_build()
            d.open(ctx)
            return
        self._ran_fused = True
        _count(PIPELINE_FUSED_TOTAL, "topn")
        try:
            self._run_fused(ctx, k)
        finally:
            self._release_staging()

    def next(self) -> Optional[Chunk]:
        if self._delegate is not None:
            return self._delegate.next()
        if self._chunks:
            return self._chunks.pop(0)
        return None

    def close(self) -> None:
        _close_delegate(self)
        self._release_staging()
        super().close()

    def _state_rows(self, ctx: ExecContext):
        """(k, fuse?): k the live-row bound the device state must hold
        (offset + count, or the whole table for a full sort). The gate is
        the chunk capacity: each merge sorts C + capacity rows, so a state
        larger than one chunk loses the win over the classic path anyway.
        No device_agg gate, as in the reference (like the segment-strategy
        fused aggregation). An overflow is recorded on the exec for the
        feedback harvest: a digest whose LIMIT + offset proved too big
        plans classic on its next execution."""
        if not getattr(ctx, "pipeline_fuse", True) or self.table is None:
            return 0, False
        if not getattr(ctx, "fused_topn", True):
            return 0, False  # plan feedback routed this digest classic
        if not self.items:
            return 0, False
        k = int(self.table.n) if self.full_sort else int(self.count) + int(self.offset)
        if k > int(ctx.chunk_capacity):
            self._topn_overflow = k
            return k, False
        return k, True

    def _run_fused(self, ctx: ExecContext, k: int) -> None:
        from tidb_tpu_torch.ops import topk as tk
        from tidb_tpu_torch.ops.segment_scan import segment_scan_key

        jobs = self._plan_staging(ctx)
        col_types = [(c.uid, c.type_) for c in self.scan_schema]
        stages, seg_cap = self.scan_stages, self._seg_cap
        cap_state = jk.shape_bucket(k, floor=64)
        sort_irs = tuple(e for e, _ in self.items)
        descs = tuple(bool(d) for _, d in self.items)
        out_cols = tuple(self.schema)
        key = ("topn|" + segment_scan_key(stages, col_types, seg_cap)
               + "|" + repr((self.items, out_cols, cap_state)))
        # the merge's new state is copied back into the state in place,
        # the counterpart of the reference's donated state: one buffer,
        # copied in and cloned out once a batch
        fused = cached_jit(
            "fusedtopk", key,
            lambda: _make_fused_topn_fn(stages, col_types, seg_cap, sort_irs, descs,
                                        out_cols),
            donate_argnums=(0,), max_bytes=_graph_quota(ctx))
        state = jitcache.packed(tk.topk_init(
            cap_state, tuple(tk.key_spec(e.type_) for e in sort_irs),
            tuple(torch_dtype(c.type_.np_dtype) for c in self.schema), ctx.device))
        self._staged_iter = self._staged_chunks(jobs)
        for staged in self._staged_iter:
            # KILL/deadline polls between batches: fusion must not turn a
            # chunked fragment into an uninterruptible run
            raise_if_cancelled(ctx)
            state = fused(state, staged)
        # the one fetch of the C winners at finalize
        dead, _ranks, _pos, _next, payload = state
        host = dispatch.device_get([dead] + [t for pair in payload for t in pair])
        self._emit_winners(host[0], list(zip(host[1::2], host[2::2])))

    def _emit_winners(self, dead, payload) -> None:
        """Slice [offset, offset + count) of the live winners (the state is
        already in final sort order: dead slots sort last) into
        capacity-sized host chunks."""
        n_live = int((dead == 0).sum())
        lo = 0 if self.full_sort else min(int(self.offset), n_live)
        hi = n_live if self.full_sort else min(int(self.offset) + int(self.count), n_live)
        self.stats.add_out_rows(hi - lo)
        cap = self.ctx.chunk_capacity
        for s in range(lo, hi, cap):
            e = min(s + cap, hi)
            cols = {c.uid: Column.from_numpy(d[s:e], c.type_, valid=v[s:e], capacity=cap)
                    for c, (d, v) in zip(self.schema, payload)}
            sel = torch.zeros(cap, dtype=torch.bool)
            sel[:e - s] = True
            self._chunks.append(Chunk(cols, sel))
            self.stats.chunks += 1
