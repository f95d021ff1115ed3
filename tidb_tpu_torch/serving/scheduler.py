"""Admission-controlled statement scheduler.

Replaces the wire server's unbounded thread-per-connection execution
with a bounded worker pool: connection threads do protocol I/O only and
``submit_*`` their statements; ``tidb_tpu_scheduler_workers`` workers
execute them (still serialized on the catalog statement lock where the
storage layer demands it). Admission control rejects — with typed,
retry-safe errors — instead of queueing unboundedly:

  * queue depth       — ``tidb_tpu_sched_max_queue`` statements waiting
  * claim timeout     — ``tidb_tpu_sched_queue_timeout_ms`` unclaimed
  * memory            — a server-wide MemTracker root
    (``tidb_tpu_sched_mem_quota``) with per-session child trackers
    (``tidb_tpu_mem_quota_session``); every statement's query tracker
    chains into them (Session._exec_ctx), so quotas see live
    consumption, and admission refuses new work while the server sits
    over budget.

Batchable prepared statements detour through the Batcher (one gathered
dispatch per group); everything else runs singleton on a worker. The
scheduler drains deterministically on shutdown: queued statements
finish (or are rejected, drain=False), workers join, later submissions
get the typed draining rejection.
"""

from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import Optional

from tidb_tpu_torch.errors import (
    AdmissionRejectedError,
    SchedulerQueueTimeoutError,
    SLOShedError,
)
from tidb_tpu_torch.serving.batcher import Batcher, BatchGroup
from tidb_tpu_torch.session.sysvars import SysVarStore
from tidb_tpu_torch.utils.memory import MemTracker

__all__ = ["StatementScheduler", "schedulers_alive"]

_SCHEDULERS = weakref.WeakSet()


def schedulers_alive():
    """Live schedulers in this process (the /scheduler endpoint and
    information_schema.scheduler_stats enumerate them)."""
    return list(_SCHEDULERS)


_QUEUED, _RUNNING, _DONE, _EVICTED = range(4)


class _Task:
    """One queued singleton statement."""

    __slots__ = ("session", "fn", "state", "t0", "done", "result", "exc")

    def __init__(self, session, fn):
        self.session = session
        self.fn = fn
        self.state = _QUEUED
        self.t0 = time.perf_counter()
        self.done = threading.Event()
        self.result = None
        self.exc: Optional[BaseException] = None


class StatementScheduler:
    def __init__(self, catalog, workers: Optional[int] = None,
                 device=None):
        self.catalog = catalog
        # where the batcher's group-commit writer session runs (the
        # server's device; the writer's statements are host work)
        self.device = device
        # GLOBAL-scope knobs read through the catalog's global overlay,
        # exactly like a session would resolve them
        self.sysvars = SysVarStore(catalog.global_vars)
        # server-wide memory root; budget refreshed per admission from
        # tidb_tpu_sched_mem_quota (0 = unlimited)
        self.server_tracker = MemTracker("server", budget=None)
        self.batcher = Batcher(self)
        # cv over a sanitizer-tracked lock: worker-thread orders through
        # it are witnessed
        from tidb_tpu_torch.analysis import sanitizer as _san

        self._cv = threading.Condition(
            _san.tracked_lock("StatementScheduler._cv", threading.RLock))
        self._work = collections.deque()  # _Task | BatchGroup
        self._queued = 0                  # admitted, not yet claimed
        self._inflight_batches = 0
        self._draining = False
        self._stop = False
        self.admitted = 0
        self.rejected = 0
        self.timed_out = 0
        n = workers if workers is not None else int(
            self.sysvars.get("tidb_tpu_scheduler_workers"))
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"sched-worker-{i}")
            for i in range(max(1, int(n)))
        ]
        for t in self._workers:
            t.start()
        _SCHEDULERS.add(self)

    # -- session wiring --------------------------------------------------

    def attach_session(self, sess) -> MemTracker:
        """Give `sess` a session-level tracker chained under the server
        root; every statement's query tracker then parents here
        (Session._exec_ctx), so per-session and server-wide quotas see
        live consumption."""
        tr = MemTracker(f"session-{getattr(sess, 'conn_id', 0)}",
                        budget=None, parent=self.server_tracker)
        sess._mem_parent = tr
        return tr

    def _session_tracker(self, sess) -> MemTracker:
        tr = getattr(sess, "_mem_parent", None)
        if tr is None:
            tr = self.attach_session(sess)
        q = int(sess.sysvars.get("tidb_tpu_mem_quota_session"))
        tr.budget = q or None  # re-read per statement: SET takes effect
        return tr

    # -- admission -------------------------------------------------------

    def _shed_digest(self, sess, sql=None, stmt_id=None) -> str:
        """Statement digest for the SLO shed consumer, or "" when
        tidb_tpu_sched_slo_shed is off — the default path computes
        NOTHING and admission decisions stay byte-identical."""
        if not bool(self.sysvars.get("tidb_tpu_sched_slo_shed")):
            return ""
        try:
            if sql is not None:
                from tidb_tpu_torch.bindinfo import normalize_sql, sql_digest

                return sql_digest(normalize_sql(sql))
            ent = sess._prepared.get(stmt_id)
            return ent[4] if ent is not None else ""
        except Exception:  # noqa: BLE001 — a digest failure must never
            return ""      # lose a statement; it just skips the shed

    def _admit(self, shed_digest: str = "") -> None:
        from tidb_tpu_torch.utils import metrics as M

        quota = int(self.sysvars.get("tidb_tpu_sched_mem_quota"))
        self.server_tracker.budget = quota or None
        maxq = int(self.sysvars.get("tidb_tpu_sched_max_queue"))
        # SLO shed, deliberately minimal: only when the flag
        # gave us a digest AND the queue is pressured (>= 3/4 full — a
        # racy read by design; pressure is a heuristic, not an
        # invariant) does the burn ranking get consulted. Checked
        # before _cv: the SLO store lock is a leaf and must not nest
        # under the scheduler's.
        if shed_digest and self._queued * 4 >= maxq * 3:
            from tidb_tpu_torch.serving.slo import STORE as _slo

            if _slo.should_shed(shed_digest):
                with self._cv:
                    self.rejected += 1
                M.SCHED_ADMISSION_TOTAL.inc(outcome="rejected")
                M.SLO_SHED_TOTAL.inc()
                raise SLOShedError(
                    "server is busy: shed by SLO burn ranking "
                    f"(digest {shed_digest[:16]} over budget under "
                    "queue pressure; tidb_tpu_sched_slo_shed=1)")
        with self._cv:
            if self._draining:
                why = "statement scheduler is draining (server shutdown)"
            elif self._queued >= maxq:
                why = (f"scheduler queue is full "
                       f"({self._queued} >= tidb_tpu_sched_max_queue={maxq})")
            elif quota and self.server_tracker.consumed >= quota:
                why = (f"server memory quota exhausted "
                       f"({self.server_tracker.consumed} >= "
                       f"tidb_tpu_sched_mem_quota={quota})")
            else:
                self._queued += 1
                self.admitted += 1
                M.SCHED_QUEUE_DEPTH.set(self._queued)
                M.SCHED_ADMISSION_TOTAL.inc(outcome="admitted")
                return
            self.rejected += 1
        M.SCHED_ADMISSION_TOTAL.inc(outcome="rejected")
        raise AdmissionRejectedError(f"server is busy: {why}")

    def _unqueue(self, n: int = 1) -> None:
        from tidb_tpu_torch.utils import metrics as M

        with self._cv:
            self._queued = max(0, self._queued - n)
            M.SCHED_QUEUE_DEPTH.set(self._queued)

    # -- submission ------------------------------------------------------

    def submit_query(self, sess, sql: str):
        """Text-protocol statement: admission + singleton execution on
        a worker (the catalog statement lock is taken by the worker,
        exactly as the thread-per-connection server did). Autocommit
        point writes may instead join a group-commit window
        and ride one merged engine pass."""
        self._admit(self._shed_digest(sess, sql=sql))
        self._session_tracker(sess)
        met = int(sess.sysvars.get("max_execution_time"))
        deadline = (time.monotonic() + met / 1e3) if met > 0 else None
        try:
            member = self.batcher.try_join_dml(sess, sql, deadline)
        except Exception:  # noqa: BLE001 — the probe must never lose a
            member = None  # statement; singleton fallback handles it
        if member is not None:
            return self._await_member(member)
        task = _Task(sess, lambda: sess.execute(sql))
        self._enqueue_task(task)
        return self._await_task(task)

    def submit_prepared(self, sess, stmt_id: int, params: list):
        """Binary-protocol execution: coalescible statements join a
        batch group; everything else runs singleton."""
        self._admit(self._shed_digest(sess, stmt_id=stmt_id))
        self._session_tracker(sess)
        met = int(sess.sysvars.get("max_execution_time"))
        deadline = (time.monotonic() + met / 1e3) if met > 0 else None
        try:
            member = self.batcher.try_join(sess, stmt_id, list(params),
                                           deadline)
        except Exception:  # noqa: BLE001 — the probe must never lose a
            member = None  # statement; singleton fallback handles it
        if member is not None:
            return self._await_member(member)
        task = _Task(sess, lambda: sess.execute_prepared(stmt_id,
                                                         list(params)))
        self._enqueue_task(task)
        return self._await_task(task)

    # -- waiting ---------------------------------------------------------

    def _timeout_s(self) -> float:
        return int(self.sysvars.get("tidb_tpu_sched_queue_timeout_ms")) / 1e3

    def _note_timeout(self):
        from tidb_tpu_torch.utils import metrics as M

        with self._cv:
            self.timed_out += 1
        M.SCHED_ADMISSION_TOTAL.inc(outcome="timed_out")
        raise SchedulerQueueTimeoutError(
            "statement evicted from the scheduler queue after "
            f"{int(self.sysvars.get('tidb_tpu_sched_queue_timeout_ms'))}ms "
            "unclaimed (it never started executing; safe to retry)")

    def _await_task(self, task: _Task):
        if not task.done.wait(self._timeout_s()):
            with self._cv:
                unclaimed = task.state == _QUEUED
                if unclaimed:
                    task.state = _EVICTED
            if unclaimed:
                self._unqueue()
                self._note_timeout()
            task.done.wait()  # claimed: execution owns it, however long
        if task.exc is not None:
            raise task.exc
        return task.result

    def _await_member(self, member):
        if not member.done.wait(self._timeout_s()):
            if self.batcher.try_evict(member):
                self._unqueue()
                self._note_timeout()
            member.done.wait()  # sealed: execution owns it
        if member.exc is not None:
            raise member.exc
        return member.result

    # -- queue / workers -------------------------------------------------

    def _enqueue_task(self, task: _Task) -> None:
        with self._cv:
            self._work.append(task)
            self._cv.notify()

    def enqueue_group(self, group: BatchGroup) -> None:
        with self._cv:
            self._work.append(group)
            self._cv.notify()

    def on_group_sealed(self, group: BatchGroup, n_members: int) -> None:
        """Batcher callback at seal: the members leave the admission
        queue together (evicted ones already left one by one)."""
        if n_members:
            self._unqueue(n_members)

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                while not self._work and not self._stop:
                    self._cv.wait(0.5)
                if not self._work:
                    return  # stopping and drained
                item = self._work.popleft()
            try:
                if isinstance(item, BatchGroup):
                    with self._cv:
                        self._inflight_batches += 1
                    try:
                        self.batcher.run_group(item)
                    finally:
                        with self._cv:
                            self._inflight_batches -= 1
                else:
                    self._run_single(item)
            except Exception:  # noqa: BLE001 — a worker must survive
                # anything one statement does; per-item errors are
                # already relayed through task/member results, so
                # whatever reaches here is bookkeeping-only
                pass
            # drop the finished item while idle: a task holds its
            # session, and a closed connection's session (a mesh
            # session's shardings on the card) must not outlive it here
            item = None

    def _run_single(self, task: _Task) -> None:
        with self._cv:
            if task.state != _QUEUED:
                return  # evicted by a queue timeout
            task.state = _RUNNING
        self._unqueue()
        task.session._sched_queue_s = time.perf_counter() - task.t0
        try:
            # the storage layer is single-writer: statements across
            # sessions serialize on the catalog statement lock, exactly
            # as the thread-per-connection server did
            with self.catalog.lock:
                task.result = task.fn()
        except BaseException as e:  # noqa: BLE001 — relayed verbatim to
            task.exc = e            # the submitting connection thread
        finally:
            task.session._sched_queue_s = 0.0
            task.state = _DONE
            task.done.set()

    # -- lifecycle / stats -----------------------------------------------

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Deterministic drain: stop admitting, let queued work finish
        (drain=True) or reject it typed (drain=False), join workers."""
        rejected = []
        with self._cv:
            self._draining = True
            self._stop = True
            if not drain:
                while self._work:
                    rejected.append(self._work.popleft())
            self._cv.notify_all()
        for item in rejected:
            exc = AdmissionRejectedError(
                "server is busy: statement scheduler shut down before "
                "this statement was claimed")
            if isinstance(item, BatchGroup):
                members = self.batcher.seal_for_shutdown(item)
                self.on_group_sealed(item, len(members))
                for m in members:
                    m.finish(exc=exc)
            else:
                self._unqueue()
                item.exc = exc
                item.state = _DONE
                item.done.set()
        for t in self._workers:
            t.join(timeout)

    def stats_dict(self) -> dict:
        with self._cv:
            d = {
                "workers": len(self._workers),
                "queue_depth": self._queued,
                "inflight_batches": self._inflight_batches,
                "admitted": self.admitted,
                "rejected": self.rejected,
                "timed_out": self.timed_out,
                "draining": self._draining,
                "mem_consumed": int(self.server_tracker.consumed),
                "mem_budget": int(self.server_tracker.budget or 0),
            }
        d.update(self.batcher.snapshot())
        return d
