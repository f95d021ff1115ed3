"""Owner election + the async DDL job pipeline it guards (ref: owner/ —
etcd-lease election of the DDL owner — and ddl/'s job queue + worker).

The reference elects one DDL owner per cluster through etcd leases;
every instance can *submit* a DDL job (a row in a KV queue), only the
owner's worker executes them, and ownership fails over when the owner's
lease lapses. In-process, N server instances share one Catalog, so the
standing-in election is a TTL lease on the catalog (the mockstore move:
same interface and failover semantics, no etcd):

    Election   — campaign/renew/resign over a monotonic-clock lease
    DDLJob     — one queued statement (sql, db, state, error)
    DDLWorker  — a thread that campaigns and, while owner, drains the
                 catalog's job queue through its own Session

Sessions route DDL statements into the queue whenever workers are
registered (the multi-instance deployment); with no workers (embedded
single-session use) DDL executes inline, like the reference running
with a local store."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = ["Election", "DDLJob", "DDLWorker"]


class Election:
    """TTL-lease leader election (the etcd-lease stand-in)."""

    def __init__(self, ttl: float = 3.0, clock: Callable[[], float] = time.monotonic):
        self.ttl = ttl
        self._clock = clock
        self._lock = threading.Lock()
        self._owner: Optional[str] = None
        self._expires = 0.0

    def campaign(self, candidate: str) -> bool:
        """Become owner if the seat is free or the lease lapsed."""
        with self._lock:
            now = self._clock()
            if self._owner is None or now >= self._expires or self._owner == candidate:
                self._owner = candidate
                self._expires = now + self.ttl
                return True
            return False

    def renew(self, candidate: str) -> bool:
        with self._lock:
            if self._owner != candidate or self._clock() >= self._expires:
                return False
            self._expires = self._clock() + self.ttl
            return True

    def resign(self, candidate: str) -> None:
        with self._lock:
            if self._owner == candidate:
                self._owner = None
                self._expires = 0.0

    def owner(self) -> Optional[str]:
        with self._lock:
            if self._owner is not None and self._clock() >= self._expires:
                return None  # lapsed lease: seat open
            return self._owner


@dataclass
class DDLJob:
    """One queued DDL statement (ref: the ddl job rows in KV)."""

    job_id: int
    sql: str
    db: str
    state: str = "queued"  # queued | running | done | error
    claimed_by: Optional[str] = None
    error: Optional[BaseException] = None
    done: threading.Event = field(default_factory=threading.Event)

    def fail(self, exc: BaseException) -> None:
        self.state = "error"
        self.error = exc
        self.done.set()


class DDLWorker:
    """Campaigns for DDL ownership; while owner, executes queued jobs
    through a private Session on the shared catalog (the reference's
    ddl.worker run by the elected owner)."""

    def __init__(self, catalog, worker_id: str, poll: float = 0.05,
                 device=None):
        self.catalog = catalog
        # the worker Session's device (None = the CUDA card)
        self.device = device
        self.worker_id = worker_id
        self.poll = poll
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self.catalog.ddl_workers[self.worker_id] = self
        self._thread = threading.Thread(
            target=self._run, name=f"ddl-worker-{self.worker_id}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # join BEFORE deregistering: once this worker leaves the
        # registry, reclaim_ddl_jobs may requeue a job it still holds —
        # two workers would then run the same DDL concurrently
        if self._thread is not None:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                # a long DDL is still executing: the worker must stay
                # registered (its claimed job must not be reclaimed or
                # drained mid-run). It exits its loop when the job ends;
                # the caller may stop() again then.
                return
        self.catalog.ddl_workers.pop(self.worker_id, None)
        self.catalog.ddl_owner.resign(self.worker_id)
        # last worker out fails everything still pending — a submitter
        # waiting on job.done (holding the statement lock) must not sit
        # out its full timeout for a DDL no one will ever run
        if not self.catalog.ddl_workers:
            self.catalog.drain_ddl_jobs("DDL owner shut down")

    # ------------------------------------------------------------------

    def _run(self) -> None:
        from tidb_tpu_torch.session import Session

        sess = None
        while not self._stop.is_set():
            if not self.catalog.ddl_owner.campaign(self.worker_id):
                self._stop.wait(self.poll)
                continue
            # jobs claimed by a worker that no longer exists (owner died
            # mid-execution) go back to queued — failover covers
            # claimed-but-unfinished work, not just fresh submissions
            self.catalog.reclaim_ddl_jobs()
            job = self.catalog.next_ddl_job(self.worker_id)
            if job is None:
                self._stop.wait(self.poll)
                continue
            try:
                if sess is None:
                    sess = Session(catalog=self.catalog, db=job.db,
                                   device=self.device)
                    sess._ddl_direct = True  # never re-enqueue
                sess.db = job.db
                # NO catalog.lock here: the submitter blocks holding it
                # (server statement lock) until job.done — taking it
                # would deadlock, and its being held is exactly what
                # serializes this execution against other clients
                sess.execute(job.sql)
                job.state = "done"
            except BaseException as e:  # noqa: BLE001 — error travels to submitter
                job.state = "error"
                job.error = e
            finally:
                job.done.set()
