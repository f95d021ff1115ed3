"""The per-table segment store and its scan/spill lifecycle (a copy of
tidb_tpu/columnar/store.py).

One `SegmentStore` hangs off each `storage.table.Table` that has grown
past one segment of rows. It owns an ordered list of immutable
`Segment`s covering physical rows ``[0, covered)``; rows past `covered`
are the delta, scanned through the raw slice path and merged at scan
time. Stale stores rebuild lazily:

  * ``table.data_epoch`` moved (dictionary re-encode, GC compaction,
    column DDL, TRUNCATE, a CLUSTER BY re-sort): every segment is
    discarded and rebuilt;
  * appended delta reached ``tidb_tpu_segment_delta_rows``: coverage
    extends (the trailing partial segment, if any, is rebuilt to full
    size) with fresh zone maps, on the background compaction worker
    (`compaction.py`) when ``tidb_tpu_compaction`` is on, inline at the
    next scan when it is off. The first segmentation is always inline.

CLUSTER BY ordered compaction: when the fold cadence makes a re-sort
worthwhile, the scan that notices only QUEUES it on the owning catalog
(`_maybe_recluster`); the session performs it at a quiescent statement
boundary (`Catalog.run_pending_reclusters` -> `recluster_now` ->
`Table.recluster`), and the data_epoch bump rebuilds every segment in
the new order.

Memory protocol (the statement-anchored MemTracker contract): scans
charge each segment's encoded bytes to their statement tracker as they
touch it, through a `ScanPin` registered as a spillable on the
statement's spill root. Under pressure the tracker calls back into
``ScanPin.spill``, which evicts this statement's least-recently-touched
unpinned segment to a `SegmentSpillFile`; re-materialization reloads it
from disk on the next touch.

Locking: ONE leaf lock (`SegmentStore._lock`, a plain `threading.Lock`)
guards the segment list and residency state. It is never held across
tracker.consume() (which can re-enter ScanPin.spill): touch pins under
the lock, releases it, then charges.

The reference's metrics are plain module-level counters here:
`SCAN_SEGMENTS_TOTAL` (scanned, pruned), `SPILL_SEGMENT_BYTES` (in,
out), `COMPACTION_TOTAL` (rebuilds by outcome), `COMPACTION_BYTES` and
`COMPACTION_WAIT` (seconds statements waited on a rebuild or a re-sort).
"""

from __future__ import annotations

import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from tidb_tpu_torch.analysis import sanitizer as _san
from tidb_tpu_torch.columnar.encoding import Encoding, encode_column
from tidb_tpu_torch.columnar.spillfile import SegmentSpillFile, make_spill_dir
from tidb_tpu_torch.columnar.zonemap import ZoneMap, build_zone_map, segment_pruned

__all__ = ["Segment", "SegmentStore", "ScanPin", "store_for",
           "build_for_result", "SCAN_SEGMENTS_TOTAL",
           "SPILL_SEGMENT_BYTES", "COMPACTION_TOTAL", "COMPACTION_BYTES",
           "COMPACTION_WAIT", "scan_counts", "compact_counts"]

# smallest table (rows) that earns a store at all; matches the sysvar
# floor so tiny unit-test tables stay on the raw path with zero overhead
MIN_STORE_ROWS = 1024

# -- scan counters -----------------------------------------------------------

# segments scans staged and segments zone maps pruned, process-wide
# (the reference's SCAN_SEGMENTS_SCANNED_TOTAL / _PRUNED_TOTAL)
SCAN_SEGMENTS_TOTAL = {"scanned": 0, "pruned": 0}
# segment payload bytes spilled to disk ("out") and reloaded ("in")
SPILL_SEGMENT_BYTES = {"in": 0, "out": 0}
# segment rebuilds by outcome (the reference's tidb_tpu_compaction_total):
# inline (statement path), background (the worker installed it),
# inline_fallback (worker refused), discarded / failed (worker builds not
# installed) and recluster (a CLUSTER BY permute); and rebuilt bytes
COMPACTION_TOTAL = {"inline": 0, "background": 0, "inline_fallback": 0,
                    "discarded": 0, "failed": 0, "recluster": 0}
COMPACTION_BYTES = {"bytes": 0}
# wall seconds statements waited on an inline rebuild or a CLUSTER BY
# permute (EXPLAIN ANALYZE's compaction_wait_ms; process-wide, as the
# port's other counters)
COMPACTION_WAIT = {"s": 0.0}

_COUNT_LOCK = threading.Lock()
# the same counts per thread: a statement diffs its own thread's around
# its execution (the slow log, the statements summary, EXPLAIN ANALYZE),
# so a concurrent statement's scans never land in its figures
_tls = threading.local()


def _count_scan(scanned: int, pruned: int) -> None:
    with _COUNT_LOCK:
        SCAN_SEGMENTS_TOTAL["scanned"] += scanned
        SCAN_SEGMENTS_TOTAL["pruned"] += pruned
    _tls.scanned = getattr(_tls, "scanned", 0) + scanned
    _tls.pruned = getattr(_tls, "pruned", 0) + pruned


def scan_counts() -> Tuple[int, int]:
    """Cumulative (scanned, pruned) on this thread."""
    return (getattr(_tls, "scanned", 0), getattr(_tls, "pruned", 0))


def _count_compact_wait(seconds: float) -> None:
    with _COUNT_LOCK:
        COMPACTION_WAIT["s"] += seconds
    _tls.compact_wait = getattr(_tls, "compact_wait", 0.0) + seconds


def compact_counts() -> Tuple[float, int]:
    """Cumulative (rebuild and re-sort wait seconds, 0) paid by this
    thread's statements; the second slot, the reference's rebuilt bytes,
    stays 0 (COMPACTION_BYTES counts them process-wide)."""
    return (getattr(_tls, "compact_wait", 0.0), 0)


def count_compaction(outcome: str, nbytes: int = 0) -> None:
    """One rebuild of `outcome` (COMPACTION_TOTAL's keys), `nbytes`
    encoded bytes installed."""
    with _COUNT_LOCK:
        COMPACTION_TOTAL[outcome] += 1
        COMPACTION_BYTES["bytes"] += nbytes


class Segment:
    """An immutable encoded slice of a table's physical rows.

    `cols` maps column name -> (Encoding, data, valid); data/valid are
    None while the payload is spilled. Zone maps and encodings stay
    resident regardless — pruning must work on cold segments.

    `refs` counts ScanPins whose scan PLANNED this segment (bumped in
    plan_scan, dropped at pin close): a store invalidation must not
    close a referenced segment's spill file out from under an in-flight
    scan — it RETIRES the segment instead, and the last release frees
    it. `pins` counts in-flight chunk stagings/evictions: a pinned
    segment's arrays are never dropped."""

    __slots__ = ("start", "end", "names", "encs", "data", "valid",
                 "zmaps", "nbytes", "pins", "refs", "retired",
                 "last_touch", "spill", "seq")

    def __init__(self, start: int, end: int, names: List[str],
                 encs: List[Encoding], data: List[np.ndarray],
                 valid: List[np.ndarray], zmaps: Dict[str, ZoneMap]):
        self.start = start
        self.end = end
        self.names = names
        self.encs = encs
        self.data: Optional[List[np.ndarray]] = data
        self.valid: Optional[List[np.ndarray]] = valid
        self.zmaps = zmaps
        self.nbytes = int(sum(d.nbytes + v.nbytes
                              for d, v in zip(data, valid)))
        self.pins = 0
        self.refs = 0
        self.retired = False
        self.last_touch = 0
        self.spill: Optional[SegmentSpillFile] = None
        # store-assigned unique id: the spill file tag. A retired old-
        # generation segment and its same-row-range successor must
        # never share a path (the retiree's file outlives the rebuild).
        self.seq = 0

    @property
    def rows(self) -> int:
        return self.end - self.start

    @property
    def resident(self) -> bool:
        return self.data is not None

    def col(self, name: str) -> Tuple[Encoding, np.ndarray, np.ndarray]:
        i = self.names.index(name)
        return self.encs[i], self.data[i], self.valid[i]


def _build_segment(table, start: int, end: int) -> Segment:
    names, encs, data, valid, zmaps = [], [], [], [], {}
    for c in table.schema.columns:
        d = table.data[c.name][start:end]
        v = table.valid[c.name][start:end]
        zmaps[c.name] = build_zone_map(d, v)
        enc, stored = encode_column(d, v, c.type_, zmaps[c.name])
        names.append(c.name)
        encs.append(enc)
        data.append(stored)
        valid.append(np.array(v, copy=True))
    return Segment(start, end, names, encs, data, valid, zmaps)


class SegmentStore:
    def __init__(self, table, segment_rows: int,
                 spill_dir: Optional[str] = None):
        self.table = table
        self.segment_rows = max(int(segment_rows), MIN_STORE_ROWS)
        self.delta_rows = self.segment_rows
        self.spill_dir = spill_dir or None
        self.segments: List[Segment] = []
        self.covered = 0
        self.built_epoch = getattr(table, "data_epoch", 0)
        self.generation = 0          # bumps on every full rebuild
        self._touch_seq = 0
        self._seg_seq = 0            # unique per segment: spill file tags
        self._tmp: Optional[str] = None
        self._stats_view = None      # (generation, covered) -> TableStats
        # invalidated segments still referenced by in-flight scans;
        # freed by the last release_planned
        self._retired: List[Segment] = []
        # background compaction: follows the latest caller's
        # tidb_tpu_compaction through store_for; while a job is pending
        # the non-force refresh keeps serving the current generation
        self.compaction_on = False
        self._compact_pending = False
        # CLUSTER BY ordered compaction: True while one statement thread
        # runs the physical re-sort, so concurrent planners skip instead
        # of double-permuting
        self._recluster_busy = False
        # the LEAF lock (module doc); registered with the sanitizer's
        # lock-order witness
        self._lock = _san.tracked_lock("SegmentStore._lock")

    # -- build / refresh ---------------------------------------------------

    def _discard_locked(self, seg: Segment) -> None:
        """A segment leaving `self.segments`: free it now, unless an
        in-flight scan still references it — then RETIRE it (the last
        `release_planned` frees it), so a concurrent rebuild can never
        close a spill file another statement is about to load."""
        if seg.refs > 0:
            seg.retired = True
            self._retired.append(seg)
            return
        if seg.spill is not None:
            seg.spill.close()
        seg.data = None
        seg.valid = None

    def _drop_all_locked(self) -> None:
        for seg in self.segments:
            self._discard_locked(seg)
        self.segments = []
        self.covered = 0
        self.generation += 1
        self._stats_view = None

    def _refresh_locked(self, force: bool = False) -> Tuple[bool, int]:
        """Returns ``(want_background, inline_bytes_built)``. The
        background request is only DECIDED here; the caller submits it
        to the worker AFTER releasing the lock, so the store lock stays
        a leaf and never blocks on the worker's queue."""
        t = self.table
        epoch = getattr(t, "data_epoch", 0)
        if epoch != self.built_epoch:
            self._drop_all_locked()
            self.built_epoch = epoch
        tail = t.n - self.covered
        if tail <= 0:
            return False, 0
        if not force and self.covered > 0 and tail < max(self.delta_rows, 1):
            return False, 0  # small delta: stays on the raw merge path
        if not force and self.covered == 0 and t.n < self.segment_rows:
            return False, 0
        if not force and self.compaction_on and self.covered > 0:
            # background path: scans keep serving the current generation
            # + raw-merge delta while the worker folds the delta in; a
            # pending job suppresses re-requests. Only DELTA folding
            # defers: the initial segmentation (covered == 0) builds
            # inline so the first scan of a table sees encoded,
            # zone-mapped segments, exactly as with compaction off
            if self._compact_pending:
                return False, 0
            self._compact_pending = True
            return True, 0
        return False, self._inline_rebuild_locked()

    def _inline_rebuild_locked(self) -> int:
        """The statement-path rebuild; returns encoded bytes built
        (charged to the scanning statement by plan_scan) and records the
        wall time on the compaction-wait counter."""
        t = self.table
        t0 = time.perf_counter()
        built = 0
        # the trailing partial segment (if any) re-builds at full size
        if self.segments and self.segments[-1].rows < self.segment_rows:
            last = self.segments.pop()
            self._discard_locked(last)
            self.covered = last.start
        for s in range(self.covered, t.n, self.segment_rows):
            e = min(s + self.segment_rows, t.n)
            seg = _build_segment(t, s, e)
            seg.seq = self._seg_seq
            self._seg_seq += 1
            self.segments.append(seg)
            self.covered = e
            built += seg.nbytes
        self._stats_view = None
        _count_compact_wait(time.perf_counter() - t0)
        return built

    def compact_inline_fallback(self) -> None:
        """Backpressure degradation (worker queue full / worker dead):
        clear the pending mark and rebuild inline on the statement
        path, exactly as with tidb_tpu_compaction=0 — typed, counted."""
        with self._lock:
            self._compact_pending = False
            built = self._inline_rebuild_locked()
        count_compaction("inline_fallback", built)

    def _want_recluster_locked(self, force: bool) -> bool:
        """Is an ordered (CLUSTER BY) rewrite due before the next fold?
        Piggybacks on the fold cadence: the delta threshold that would
        trigger a rebuild is also what makes re-sorting worthwhile."""
        t = self.table
        if not getattr(getattr(t, "schema", None), "cluster_by", None):
            return False
        if getattr(t, "clustered_rows", 0) >= t.n:
            return False
        if force:
            return True
        if self.covered > 0:
            return t.n - self.covered >= max(self.delta_rows, 1)
        return t.n >= self.segment_rows

    def _maybe_recluster(self, force: bool = False) -> None:
        """CLUSTER BY ordered compaction. A scan that
        notices the fold cadence made a re-sort worthwhile must NOT
        permute here: the caller is a lock-free reader (plan_scan), and
        other statements may be mid-scan of the very arrays the permute
        moves — torn rows with no lock to stop them. Instead the due
        permute is QUEUED on the owning catalog and performed by
        Session at a statement boundary, under the catalog writer lock
        with the reader registry quiescent (run_pending_reclusters).
        Catalog-less tables (unit fixtures, single-owner by
        construction) keep the immediate permute."""
        with self._lock:
            want = self._want_recluster_locked(force) \
                and not self._recluster_busy
        if not want:
            return
        guard = getattr(self.table, "txn_guard", None)
        if guard is None:
            self.recluster_now()
        else:
            guard.note_recluster_due(self)

    def recluster_now(self, quiesced: bool = False) -> bool:
        """The permute body, with the STORE lock released (leaf rule;
        the busy flag keeps a second caller from double-permuting). It
        is Table.recluster that takes the CATALOG writer lock, refuses
        while any transaction is open (row positions may only move with
        no write log holding positional row ids) and — unless the
        caller already quiesced the reader registry — refuses while any
        statement or scan is in flight. The resulting data_epoch bump
        makes the next _refresh_locked rebuild every segment in the new
        order. Returns True when the queued work is DONE (rows moved,
        or the table no longer wants sorting); False = retry later."""
        with self._lock:
            if self._recluster_busy:
                return False
            if not self._want_recluster_locked(True):
                return True  # raced: sorted (or hint dropped) meanwhile
            self._recluster_busy = True
        t0 = time.perf_counter()
        try:
            moved = self.table.recluster(quiesced=quiesced)
        finally:
            with self._lock:
                self._recluster_busy = False
        if moved:
            _count_compact_wait(time.perf_counter() - t0)
            count_compaction("recluster")
        t = self.table
        return bool(moved) or getattr(t, "clustered_rows", 0) >= t.n

    def refresh(self, force: bool = False) -> None:
        self._maybe_recluster(force)
        with self._lock:
            want, built = self._refresh_locked(force=force)
        if built:
            count_compaction("inline", built)
        if want:
            from tidb_tpu_torch.columnar.compaction import submit

            submit(self)

    # -- scan planning -----------------------------------------------------

    def plan_scan(self, bounds, pin: Optional["ScanPin"] = None
                  ) -> Tuple[List[Segment], int, int]:
        """(segments to scan, segments pruned, covered row count) for a
        scan whose pushed filter yielded `bounds`. With a `pin`, every
        snapshot segment is reference-counted against invalidation
        until the pin closes. Counts flow to SCAN_SEGMENTS_TOTAL."""
        self._maybe_recluster()
        with self._lock:
            want, built = self._refresh_locked()
            segs = list(self.segments)
            covered = self.covered
            if pin is not None:
                for s in segs:
                    # lifecycle: each ref is handed to the pin (extended
                    # into pin.planned below under this same lock);
                    # ScanPin.close() -> release_planned drops them all
                    s.refs += 1
                pin.planned.extend(segs)
        if built and pin is not None:
            # the inline rebuild ran under THIS statement's budget:
            # charge the encoded bytes transiently so the stall is
            # attributable (max_mem, OOM actions); the resident bytes
            # themselves are charged per segment on touch
            from tidb_tpu_torch.utils.memory import QueryOOMError

            try:
                pin.tracker.consume(built)
            except QueryOOMError:
                # attribution, not admission control: the built bytes
                # are store-resident and shared across statements, so
                # the statement cannot shed them — consume() already
                # spilled what it could and recorded the peak, which is
                # all this transient charge is for
                pass
            finally:
                # consume() records the charge BEFORE the budget check
                # can raise OOM, so the release must run even then
                pin.tracker.release(built)
        if built:
            count_compaction("inline", built)
        if want:
            from tidb_tpu_torch.columnar.compaction import submit

            submit(self)
        if bounds:
            kept = [s for s in segs if not segment_pruned(s.zmaps, bounds)]
        else:
            kept = segs
        pruned = len(segs) - len(kept)
        _count_scan(len(kept), pruned)
        return kept, pruned, covered

    def release_planned(self, segs) -> None:
        """Drop a closing pin's references; free retired segments whose
        last reference this was."""
        with self._lock:
            for seg in segs:
                seg.refs = max(seg.refs - 1, 0)
                if seg.retired and seg.refs == 0 and seg.pins == 0:
                    if seg.spill is not None:
                        seg.spill.close()
                    seg.data = None
                    seg.valid = None
                    if seg in self._retired:
                        self._retired.remove(seg)

    # -- residency / spill -------------------------------------------------

    def pin_segment(self, seg: Segment) -> int:
        """Make `seg` resident and pin it against eviction. Returns the
        bytes loaded from disk (0 when it was already resident). Like
        evict_segment, the disk read happens OUTSIDE the store lock —
        the pin taken first keeps eviction off; a racing loader that
        loses the install simply discards its copy."""
        with self._lock:
            seg.pins += 1
            self._touch_seq += 1
            seg.last_touch = self._touch_seq
            if seg.resident:
                return 0
            spill = seg.spill
        try:
            pairs = spill.load(len(seg.names))
        except BaseException:
            with self._lock:
                seg.pins -= 1  # a failed load must not pin forever
            raise
        loaded = 0
        with self._lock:
            if not seg.resident:
                seg.data = [d for d, _v in pairs]
                seg.valid = [v for _d, v in pairs]
                loaded = seg.nbytes
        if loaded:
            with _COUNT_LOCK:
                SPILL_SEGMENT_BYTES["in"] += loaded
        return loaded

    def unpin_segment(self, seg: Segment) -> None:
        with self._lock:
            seg.pins = max(seg.pins - 1, 0)

    def evict_segment(self, seg: Segment) -> int:
        """Evict one resident, unpinned segment to disk; returns bytes
        freed (0 when it was pinned/non-resident, or got touched while
        the file was being written — callers try their next candidate).
        The payload write happens OUTSIDE the store lock (payloads are
        immutable; the pin taken here keeps every other path off the
        arrays), so one statement's spill never stalls other sessions'
        planning and scanning behind disk I/O."""
        with self._lock:
            if not seg.resident or seg.pins != 0:
                return 0
            seg.pins += 1  # guards the arrays while the lock is dropped
            data, valid = seg.data, seg.valid
            spill = seg.spill
            need_write = spill is None or not spill.written
            if need_write and spill is None:
                if self._tmp is None:
                    self._tmp = make_spill_dir(self.spill_dir)
                    # the table (and so this store) can be dropped with
                    # spilled payloads on disk: tie the directory's
                    # lifetime to the store object, not the process
                    import weakref

                    weakref.finalize(self, shutil.rmtree, self._tmp,
                                     ignore_errors=True)
                spill = seg.spill = SegmentSpillFile(
                    self._tmp, f"seg{seg.seq}")
        ok = False
        try:
            if need_write:
                spill.save(list(zip(seg.names, data, valid)))
            ok = True
        finally:
            freed = 0
            with self._lock:
                seg.pins -= 1  # an ENOSPC etc. must not pin forever
                if ok and seg.pins == 0 and seg.resident:
                    seg.data = None
                    seg.valid = None
                    freed = seg.nbytes
                # a touch raced the write: leave it resident (the file
                # is written, so the NEXT eviction of it is free)
        if freed:
            with _COUNT_LOCK:
                SPILL_SEGMENT_BYTES["out"] += freed
        return freed

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(s.nbytes for s in self.segments if s.resident)

    def close(self) -> None:
        """Release every unreferenced segment and (when no in-flight
        scan holds retired ones) the spill directory. Called on DROP
        TABLE; the weakref finalizer minted with the directory removes
        it at store GC regardless, so a close() racing a live scan
        just defers the directory cleanup."""
        with self._lock:
            self._drop_all_locked()
            retired = bool(self._retired)
            tmp = self._tmp
        if tmp is not None and not retired:
            shutil.rmtree(tmp, ignore_errors=True)

    # -- statistics view ---------------------------------------------------

    def stats_view(self):
        """Aggregate the zone maps into a TableStats the planner's
        selectivity/NDV heuristics consume when no fresh ANALYZE stats
        exist (statistics.zone_map_stats). min/max become a two-point
        equi-depth histogram; NDV sums per-segment counts (an upper
        bound — the safe direction for join estimates)."""
        from tidb_tpu_torch.statistics import ColumnStats, TableStats

        with self._lock:
            key = (self.generation, self.covered)
            if self._stats_view is not None and self._stats_view[0] == key:
                return self._stats_view[1]
            segs = list(self.segments)
        if not segs:
            return None
        n_rows = sum(s.rows for s in segs)
        stats = TableStats(n_rows=n_rows, version=self.table.version)
        for name in segs[0].names:
            zs = [s.zmaps[name] for s in segs if name in s.zmaps]
            if not zs:
                continue
            mins = [z.min for z in zs if z.min is not None]
            maxs = [z.max for z in zs if z.max is not None]
            nulls = sum(z.null_count for z in zs)
            ndv = min(sum(z.ndv for z in zs), max(n_rows - nulls, 0))
            if mins:
                mn, mx = float(min(mins)), float(max(maxs))
                cs = ColumnStats(ndv=max(ndv, 1), null_count=nulls,
                                 min=mn, max=mx,
                                 bounds=np.array([mn, mx]))
            else:
                cs = ColumnStats(ndv=0, null_count=nulls)
            stats.cols[name] = cs
        with self._lock:
            self._stats_view = (key, stats)
        return stats


class ScanPin:
    """One scan's residency + accounting handle on a store.

    Registered as a spillable on the statement's spill-root tracker
    (the SpillableRuns protocol, via memory.spill_root_of): ``touch``
    charges a segment's bytes once per statement, ``spill`` evicts the
    coldest charged segment when the tracker calls back under
    pressure, and ``close`` returns every charge and drops the scan's
    segment references at statement end."""

    def __init__(self, store: SegmentStore, tracker):
        from tidb_tpu_torch.utils.memory import spill_root_of

        self.store = store
        self.tracker = tracker
        root = spill_root_of(tracker)
        self._root = root
        if root.spill_enabled:
            root.register_spillable(self)
        self.charged: Dict[int, Tuple[Segment, int]] = {}
        self.planned: List[Segment] = []  # ref-counted via plan_scan
        self._current: Optional[Segment] = None
        self.closed = False
        if _san.enabled():
            _san.note_pin_open(self)  # balanced at statement end

    def touch(self, seg: Segment) -> None:
        """Pin `seg` for staging (unpins the previously staged one) and
        charge its bytes to the statement on first touch."""
        prev, self._current = self._current, seg
        self.store.pin_segment(seg)
        if prev is not None:
            self.store.unpin_segment(prev)
        if id(seg) not in self.charged:
            self.charged[id(seg)] = (seg, seg.nbytes)
            # may re-enter self.spill(); the store lock is NOT held here
            self.tracker.consume(seg.nbytes)

    def spillable_bytes(self) -> int:
        # snapshot like spill(): the pipeline staging thread touch()-
        # inserts into `charged` while budget pressure walks it
        return sum(b for s, b in list(self.charged.values())
                   if s.resident and s.pins == 0)

    def spill(self) -> int:
        """Evict charged segments coldest-first until one actually
        frees bytes (a concurrent toucher can race one candidate;
        retired segments remain evictable — their files outlive the
        segment list). Returns the bytes released from this
        statement's accounting."""
        # snapshot first: the pipeline staging thread may be
        # touch()-inserting into `charged` while another thread's
        # budget pressure walks it
        charged = list(self.charged.values())
        order = sorted((s for s, _b in charged
                        if s.resident and s.pins == 0),
                       key=lambda s: s.last_touch)
        for seg in order:
            freed = self.store.evict_segment(seg)
            if freed <= 0:
                continue
            _seg, b = self.charged.pop(id(seg), (None, 0))
            if b:
                self.tracker.release(b)
            return b or freed
        return 0

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if _san.enabled():
            _san.note_pin_close(self)
        if self._current is not None:
            self.store.unpin_segment(self._current)
            self._current = None
        total = sum(b for _s, b in self.charged.values())
        self.charged = {}
        if total:
            self.tracker.release(total)
        self._root.unregister_spillable(self)
        planned, self.planned = self.planned, []
        self.store.release_planned(planned)


# -- store lifecycle --------------------------------------------------------

_CREATE_LOCK = _san.tracked_lock("columnar._CREATE_LOCK")


def _base_of(table):
    """The underlying columnar `Table` (the delta engine's memtable has
    already compacted by the time a scan reads `table.n`)."""
    return getattr(table, "_base", table)


def store_for(table, segment_rows: int, delta_rows: Optional[int] = None,
              spill_dir: Optional[str] = None,
              min_rows: Optional[int] = None,
              compaction: Optional[bool] = None) -> Optional[SegmentStore]:
    """The table's segment store, creating it on first use once the
    table has at least `min_rows` (default: one segment) of rows.
    Returns None for engines without `data_epoch` (foreign table
    objects) and for small tables. The first creator's `segment_rows`
    wins for the store's lifetime; `delta_rows`/`spill_dir`/
    `compaction` follow the latest caller."""
    base = _base_of(table)
    if getattr(base, "data_epoch", None) is None:
        return None
    store = getattr(base, "_segment_store", None)
    if store is None:
        floor = max(int(segment_rows), MIN_STORE_ROWS) \
            if min_rows is None else max(int(min_rows), 1)
        if base.n < floor:
            return None
        with _CREATE_LOCK:
            store = getattr(base, "_segment_store", None)
            if store is None:
                store = SegmentStore(base, segment_rows, spill_dir)
                base._segment_store = store
    if delta_rows is not None:
        store.delta_rows = max(int(delta_rows), 1)
    if spill_dir:
        store.spill_dir = spill_dir
    if compaction is not None:
        store.compaction_on = bool(compaction)
    return store


def build_for_result(table, segment_rows: int = 1 << 16) -> None:
    """Eagerly segment a materialized result table (CTE materialization
    reuse): every consumer then scans the encoded, zone-mapped form.
    Tiny results stay raw — a store would cost more than it saves."""
    store = store_for(table, segment_rows, min_rows=MIN_STORE_ROWS)
    if store is not None:
        store.refresh(force=True)
