"""Per-digest latency SLOs: a capacity-bounded sliding
window of recent statement latencies per digest, with percentiles and
an SLO burn ratio against ``tidb_tpu_slo_target_ms``.

ROADMAP item 5 wants admission and micro-batch sizing driven by
"observed per-digest latency/drift instead of static busy-classes";
this store is that observation. Every statement end (success AND
error — what the user waited is what the SLO measures) folds its wall
time into the digest's window; reads expose p50/p95/p99, the breach
count, and the burn ratio:

    burn = (fraction of window observations over target) / (1 - 0.99)

i.e. how many times faster than its error budget the digest is
consuming the 99% objective. burn <= 1.0 is within budget; a digest
steadily at burn 3.0 exhausts a month's budget in ten days.

Surfaces: ``information_schema.digest_latency``, the ``/slo`` status
endpoint, and the ``tidb_tpu_digest_p99_seconds`` gauge (label sets
follow the LRU — an evicted digest's series is removed, not frozen).

One deliberately-minimal consumer exists behind
``tidb_tpu_sched_slo_shed`` (default OFF): under admission queue
pressure the scheduler sheds statements whose digest is burning its
budget fastest (``should_shed``), with a typed 9008 rejection. Plans
and results are NEVER affected — the consumer only picks which
statements wait when the server is saturated anyway.

Concurrency: the store lock is a LEAF like ``planner/feedback.py``'s —
fold/read only under it; the DIGEST_P99 gauge update and eviction
cleanup (which take the metric's own lock) happen after it is
released. The lock-discipline and blocking-under-lock passes check
this module.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import List, Optional

__all__ = ["DigestLatencyStore", "STORE", "DEFAULT_CAPACITY",
           "DEFAULT_TARGET_MS", "WINDOW", "OBJECTIVE"]

DEFAULT_CAPACITY = 512

# default latency objective per statement execution; overridden by the
# tidb_tpu_slo_target_ms sysvar at observe time
DEFAULT_TARGET_MS = 300.0

# sliding window of recent latencies per digest: enough for a stable
# p99 without unbounded growth on hot statements (stmtsummary's ring
# rule, sized up for the tail percentile)
WINDOW = 256

# the objective fraction: 99% of a digest's executions under target.
# Its complement (0.01) is the error budget the burn ratio divides by.
OBJECTIVE = 0.99


def _pct(xs: List[float], q: float) -> float:
    """Percentile of a non-empty sorted list (stmtsummary's estimator)."""
    return xs[min(len(xs) - 1, int(q * (len(xs) - 1) + 0.5))]


class _Entry:
    __slots__ = ("digest", "digest_text", "lat", "execs", "breaches",
                 "burn", "p99_s", "target_ms", "last_seen")

    def __init__(self, digest: str, digest_text: str):
        self.digest = digest
        self.digest_text = digest_text
        self.lat: deque = deque(maxlen=WINDOW)  # seconds
        self.execs = 0
        self.breaches = 0       # lifetime, vs target at observe time
        self.burn = 0.0         # cached at observe (should_shed is hot)
        self.p99_s = 0.0
        self.target_ms = DEFAULT_TARGET_MS  # target in force last observe
        self.last_seen = time.time()


class DigestLatencyStore:
    """Process-global, capacity-bounded (LRU on digest) latency-SLO
    store. The lock is a LEAF: fold/read only — metric updates happen
    outside it."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        from tidb_tpu_torch.analysis import sanitizer as _san

        self.lock = _san.tracked_lock("DigestLatencyStore.lock")
        self.capacity = capacity
        self._by_digest: "OrderedDict[str, _Entry]" = OrderedDict()
        self.evicted = 0

    # -- recording ----------------------------------------------------------

    def observe(self, digest: str, digest_text: str, latency_s: float,
                target_ms: float = DEFAULT_TARGET_MS,
                capacity: Optional[int] = None) -> None:
        """Fold one execution's wall time into the digest's window and
        refresh its cached burn/p99. Gauge updates and eviction cleanup
        run after the store lock is released (leaf-lock rule)."""
        if not digest:
            return
        target_s = max(float(target_ms), 0.0) / 1e3
        evicted_digests: List[str] = []
        with self.lock:
            if capacity is not None:
                self.capacity = max(1, int(capacity))
            e = self._by_digest.get(digest)
            if e is None:
                # bound retained text like the statements summary does
                e = _Entry(digest, digest_text[:2048])
                self._by_digest[digest] = e
            self._by_digest.move_to_end(digest)
            e.execs += 1
            e.target_ms = float(target_ms)
            e.lat.append(float(latency_s))
            if target_s and latency_s > target_s:
                e.breaches += 1
            xs = sorted(e.lat)
            e.p99_s = _pct(xs, 0.99)
            over = sum(1 for v in e.lat if target_s and v > target_s)
            e.burn = (over / len(e.lat)) / (1.0 - OBJECTIVE)
            e.last_seen = time.time()
            p99 = e.p99_s
            while len(self._by_digest) > self.capacity:
                old, _ = self._by_digest.popitem(last=False)
                evicted_digests.append(old)
                self.evicted += 1
        from tidb_tpu_torch.utils.metrics import DIGEST_P99

        DIGEST_P99.set(round(p99, 6), digest=digest)
        for old in evicted_digests:
            DIGEST_P99.remove(digest=old)

    # -- the shed consumer --------------------------------------------------

    def should_shed(self, digest: str) -> bool:
        """True when this digest is burning its budget fastest: over
        budget (burn > 1.0) AND within 10% of the worst burner tracked
        — under saturation the scheduler sheds the statements already
        blowing their SLO, preserving budget for the ones still inside
        it. Cheap by design (cached burns, one O(capacity) scan): this
        runs on the admission path, though only when
        tidb_tpu_sched_slo_shed is on AND the queue is pressured."""
        if not digest:
            return False
        with self.lock:
            e = self._by_digest.get(digest)
            if e is None or e.burn <= 1.0:
                return False
            worst = max(x.burn for x in self._by_digest.values())
            return e.burn >= 0.9 * worst

    # -- read side ----------------------------------------------------------

    def burn(self, digest: str) -> float:
        with self.lock:
            e = self._by_digest.get(digest)
            return e.burn if e is not None else 0.0

    def rows(self) -> List[tuple]:
        """information_schema.digest_latency rows (latencies in ms;
        target_ms = the sysvar value in force at the digest's last
        observation), worst burn first."""
        with self.lock:
            entries = list(self._by_digest.values())
            out = []
            for e in entries:
                xs = sorted(e.lat)
                out.append((
                    e.digest, e.digest_text, len(e.lat), e.execs,
                    round(_pct(xs, 0.50) * 1e3, 3) if xs else 0.0,
                    round(_pct(xs, 0.95) * 1e3, 3) if xs else 0.0,
                    round(_pct(xs, 0.99) * 1e3, 3) if xs else 0.0,
                    round(e.target_ms, 3), e.breaches,
                    round(e.burn, 4),
                    time.strftime("%Y-%m-%d %H:%M:%S",
                                  time.localtime(e.last_seen)),
                ))
        out.sort(key=lambda r: r[9], reverse=True)
        return out

    def stats_dict(self, top: int = 50) -> dict:
        """/slo endpoint payload."""
        cols = ("digest", "digest_text", "window_n", "execs", "p50_ms",
                "p95_ms", "p99_ms", "target_ms", "breaches",
                "burn_ratio", "last_seen")
        with self.lock:
            capacity, evicted = self.capacity, self.evicted
        return {
            "digests": [dict(zip(cols, r))
                        for r in self.rows()[:max(0, top)]],
            "capacity": capacity,
            "evicted": evicted,
            "objective": OBJECTIVE,
        }

    def __len__(self) -> int:
        with self.lock:
            return len(self._by_digest)

    def clear(self) -> None:
        with self.lock:
            digests = list(self._by_digest)
            self._by_digest.clear()
            self.evicted = 0
        from tidb_tpu_torch.utils.metrics import DIGEST_P99

        for d in digests:
            DIGEST_P99.remove(digest=d)


STORE = DigestLatencyStore()
