"""Background delta->segment compaction (a copy of
tidb_tpu/columnar/compaction.py).

One process-wide worker thread watches for stores whose appended delta
crossed ``tidb_tpu_segment_delta_rows`` and rebuilds their trailing
segments OFF the statement path. The statement-side contract lives in
``SegmentStore._refresh_locked``: when compaction is on, crossing the
delta threshold marks the store pending and returns without building —
scans keep serving the current segment generation plus the raw-merge
delta (bounded staleness of the *encoded* view only; visibility is
MVCC-exact either way because the delta is always merged at scan time).

Worker protocol per job (the store's refcount/retire discipline,
leaf-lock rule intact):

  1. SNAPSHOT under ``store._lock``: epoch / generation / covered and
     the rebuild range. Nothing is built under the lock.
  2. BUILD outside every lock. Safe because ``table.n`` is published
     only after the rows below it are fully written, and row payloads
     are immutable once published (MVCC updates append new versions;
     begin/end timestamps are read fresh at stage time, never baked
     into segments). A GC/TRUNCATE/re-encode racing the build bumps
     ``data_epoch`` — detected at cutover, the build is discarded.
  3. CUTOVER under ``store._lock``: install only if the snapshot still
     describes the store (epoch, generation, covered unchanged); the
     trailing partial segment retires through ``_discard_locked`` so a
     scan that planned it keeps its spill file alive.

Backpressure: the job queue is bounded. ``submit`` refuses when the
queue is full or the worker died, and the caller degrades, counted as
``COMPACTION_TOTAL["inline_fallback"]``, to the inline rebuild on the
statement path.

The worker never holds its own condition lock while taking a store
lock (jobs pop first, compact after), so no lock-order edge exists
between the queue and any store.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from tidb_tpu_torch.columnar.store import count_compaction
from tidb_tpu_torch.utils.failpoint import inject

__all__ = ["CompactionWorker", "submit", "default_worker",
           "reset_for_tests", "MAX_QUEUED"]

# bounded job queue: one entry per store awaiting rebuild. Deep queues
# only delay the inline fallback the caller would prefer once the
# worker is this far behind.
MAX_QUEUED = 8


class CompactionWorker:
    """The background rebuild thread plus its bounded job queue."""

    def __init__(self, max_queued: int = MAX_QUEUED):
        self.max_queued = max_queued
        self._cv = threading.Condition()
        self._pending: List[object] = []   # stores awaiting compaction
        self._busy = 0                     # jobs popped, not yet finished
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    # -- submission (statement path) ------------------------------------

    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive() and not self._stop

    def submit(self, store) -> bool:
        """Queue `store` for a background rebuild; False when the queue
        is full or the worker is dead (caller falls back inline). Never
        blocks — this runs on the statement path."""
        with self._cv:
            if self._stop:
                return False
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="tidb-tpu-compaction",
                    daemon=True)
                self._thread.start()
            elif not self._thread.is_alive():
                return False
            if len(self._pending) >= self.max_queued:
                return False
            self._pending.append(store)
            self._cv.notify()
        return True

    # -- worker loop -----------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                store = self._pending.pop(0)
                self._busy += 1
            try:
                outcome, nbytes = self._compact(store)
            except BaseException:
                # a job must never kill the thread silently mid-flight;
                # the store's pending flag was cleared (or will fail
                # closed at the next inline fallback)
                outcome, nbytes = "failed", 0
            finally:
                with self._cv:
                    self._busy -= 1
                    self._cv.notify_all()
            count_compaction(outcome, nbytes)

    @staticmethod
    def _compact(store):
        """One store's rebuild: snapshot -> build outside locks ->
        validated cutover. Returns (outcome, installed_bytes)."""
        from tidb_tpu_torch.columnar.store import _build_segment

        t = store.table
        with store._lock:
            epoch = getattr(t, "data_epoch", 0)
            gen = store.generation
            covered0 = store.covered
            seg_rows = store.segment_rows
            if epoch != store.built_epoch:
                # epoch moved while queued: the next statement-path
                # refresh owns the drop-all; building now would encode
                # rows about to be discarded
                store._compact_pending = False
                return "discarded", 0
            start = covered0
            if store.segments and store.segments[-1].rows < seg_rows:
                start = store.segments[-1].start
            n = t.n
        if n <= start:
            with store._lock:
                store._compact_pending = False
            return "discarded", 0
        built = []
        try:
            inject("compact.rebuild")
            for s in range(start, n, seg_rows):
                e = min(s + seg_rows, n)
                built.append(_build_segment(t, s, e))
        except BaseException:
            with store._lock:
                store._compact_pending = False
            return "failed", 0
        nbytes = sum(g.nbytes for g in built)
        with store._lock:
            ok = (getattr(t, "data_epoch", 0) == epoch
                  and store.built_epoch == epoch
                  and store.generation == gen
                  and store.covered == covered0)
            if ok:
                # same install sequence as the inline rebuild: the
                # trailing partial retires if a planned scan holds it
                if store.segments and store.segments[-1].rows < seg_rows:
                    last = store.segments.pop()
                    store._discard_locked(last)
                    store.covered = last.start
                for seg in built:
                    seg.seq = store._seg_seq
                    store._seg_seq += 1
                    store.segments.append(seg)
                    store.covered = seg.end
                store._stats_view = None
            store._compact_pending = False
        if not ok:
            return "discarded", 0
        return "background", nbytes

    # -- test/lifecycle hooks ---------------------------------------------

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until the queue is empty and no job is in flight (or
        the worker died / `timeout` expired). Test determinism hook."""
        import time as _time

        deadline = _time.monotonic() + timeout
        with self._cv:
            while self._pending or self._busy:
                t = self._thread
                if t is None or not t.is_alive():
                    return not (self._pending or self._busy)
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
            return True

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._pending = []
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=10)


_worker_lock = threading.Lock()
_worker: Optional[CompactionWorker] = None


def default_worker() -> CompactionWorker:
    global _worker
    with _worker_lock:
        if _worker is None:
            _worker = CompactionWorker()
        return _worker


def submit(store) -> bool:
    """Queue `store` on the process worker; on refusal (backpressure /
    dead worker) degrade to the inline statement-path rebuild, typed
    and counted."""
    if default_worker().submit(store):
        return True
    store.compact_inline_fallback()
    return False


def reset_for_tests() -> None:
    """Stop and forget the process worker (chaos tests restart it)."""
    global _worker
    with _worker_lock:
        w, _worker = _worker, None
    if w is not None:
        w.stop()
