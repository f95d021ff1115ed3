"""Statement-digest summaries (ref: the statements-summary tables fed
by stmtsummary/ — per-digest aggregates over normalized SQL).

Every executed statement is normalized (literals -> ``?`` via the
bindinfo normalizer), hashed to a digest, and folded into one bounded
in-memory entry carrying exec count, latency aggregates (sum/max and a
p95 over a recent-latency ring), max memory, rows sent, error count,
and the distributed-execution figures (device dispatches, mesh
fragments). The store is an LRU capped by the
``tidb_stmt_summary_max_stmt_count`` sysvar — the simple stand-in for
the reference's SUMMARY BEGIN TIME window rotation; evictions are
counted so a truncated view is visible as such.

Surfaced as ``information_schema.statements_summary`` and as the
status port's ``/statements`` JSON endpoint."""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import List, Optional

__all__ = ["StmtSummary", "DEFAULT_MAX_STMT_COUNT"]

DEFAULT_MAX_STMT_COUNT = 200

# recent-latency ring per digest: enough for a stable p95 without
# unbounded growth on hot statements
_LATENCY_RING = 128


class _Entry:
    __slots__ = ("digest", "digest_text", "stmt_type", "plan_digest",
                 "exec_count", "sum_latency", "max_latency", "latencies",
                 "max_mem", "rows_sent", "errors", "dispatches",
                 "fragments", "first_seen", "last_seen",
                 "plan_cache_hits", "sum_plan_latency",
                 "max_drift", "sum_drift", "drift_samples",
                 "worst_drift_op", "xfer_bytes", "compile_ms",
                 "spill_bytes")

    def __init__(self, digest: str, digest_text: str, stmt_type: str):
        self.digest = digest
        self.digest_text = digest_text
        self.stmt_type = stmt_type
        self.plan_digest = ""
        self.exec_count = 0
        self.sum_latency = 0.0
        self.max_latency = 0.0
        self.latencies: deque = deque(maxlen=_LATENCY_RING)
        self.max_mem = 0
        self.rows_sent = 0
        self.errors = 0
        self.dispatches = 0
        self.fragments = 0
        self.first_seen = time.time()
        self.last_seen = self.first_seen
        # plan-cache observability: executions whose plan came from the
        # cache, and cumulative plan-acquisition wall time (cold plans
        # dominate it; hits contribute near-zero — the cache's win is
        # visible per digest, not just end-to-end)
        self.plan_cache_hits = 0
        self.sum_plan_latency = 0.0
        # plan feedback: per-digest estimation-drift
        # aggregates — chronic misestimates are findable here without
        # tracing. Drift is the worst per-operator actual/est row ratio
        # of one execution; 0.0 samples (no actual known) don't count.
        self.max_drift = 0.0
        self.sum_drift = 0.0
        self.drift_samples = 0
        self.worst_drift_op = ""
        # resource profile: cumulative host↔device transfer
        # bytes, fragment compile wall time, and spill bytes across this
        # digest's executions — all host-side accounting, no new syncs
        self.xfer_bytes = 0
        self.compile_ms = 0.0
        self.spill_bytes = 0

    def p95(self) -> float:
        if not self.latencies:
            return 0.0
        xs = sorted(self.latencies)
        return xs[min(len(xs) - 1, int(0.95 * (len(xs) - 1) + 0.5))]


def _fmt_ts(ts: float) -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts))


class StmtSummary:
    """Bounded per-digest aggregate store (LRU on last execution)."""

    def __init__(self, max_stmt_count: int = DEFAULT_MAX_STMT_COUNT):
        self.lock = threading.Lock()
        self.max_stmt_count = max_stmt_count
        self._by_digest: "OrderedDict[str, _Entry]" = OrderedDict()
        self.evicted = 0

    def record(self, digest: str, digest_text: str, stmt_type: str,
               plan_digest: str, latency_s: float, *, max_mem: int = 0,
               rows_sent: int = 0, dispatches: int = 0, fragments: int = 0,
               error: bool = False, plan_from_cache: bool = False,
               plan_latency_s: float = 0.0,
               worst_drift: float = 0.0, worst_drift_op: str = "",
               xfer_bytes: int = 0, compile_ms: float = 0.0,
               spill_bytes: int = 0,
               max_stmt_count: Optional[int] = None) -> None:
        with self.lock:
            if max_stmt_count is not None:
                self.max_stmt_count = max(1, int(max_stmt_count))
            e = self._by_digest.get(digest)
            if e is None:
                # bound the retained text like the slow-query log does:
                # a megabyte bulk INSERT must not pin its normalized
                # form in every I_S row / /statements payload
                e = _Entry(digest, digest_text[:2048], stmt_type)
                self._by_digest[digest] = e
            self._by_digest.move_to_end(digest)
            e.exec_count += 1
            e.sum_latency += latency_s
            e.max_latency = max(e.max_latency, latency_s)
            e.latencies.append(latency_s)
            e.max_mem = max(e.max_mem, int(max_mem))
            e.rows_sent += int(rows_sent)
            e.errors += 1 if error else 0
            e.dispatches += int(dispatches)
            e.fragments += int(fragments)
            e.plan_cache_hits += 1 if plan_from_cache else 0
            e.sum_plan_latency += plan_latency_s
            if worst_drift > 0:
                drift = abs(worst_drift)
                sym = max(drift, 1.0 / drift) if drift > 0 else 0.0
                if sym > e.max_drift:
                    e.max_drift = sym
                    e.worst_drift_op = worst_drift_op
                e.sum_drift += sym
                e.drift_samples += 1
            e.xfer_bytes += int(xfer_bytes)
            e.compile_ms += float(compile_ms)
            e.spill_bytes += int(spill_bytes)
            e.last_seen = time.time()
            if plan_digest:
                e.plan_digest = plan_digest
            while len(self._by_digest) > self.max_stmt_count:
                self._by_digest.popitem(last=False)
                self.evicted += 1

    def __len__(self) -> int:
        with self.lock:
            return len(self._by_digest)

    def clear(self) -> None:
        with self.lock:
            self._by_digest.clear()
            self.evicted = 0

    def rows(self) -> List[tuple]:
        """information_schema.statements_summary rows (latencies in
        seconds), ordered by cumulative latency descending."""
        with self.lock:
            entries = list(self._by_digest.values())
        entries.sort(key=lambda e: e.sum_latency, reverse=True)
        out = []
        for e in entries:
            out.append((
                e.digest, e.stmt_type, e.digest_text, e.plan_digest,
                e.exec_count, round(e.sum_latency, 6),
                round(e.sum_latency / max(e.exec_count, 1), 6),
                round(e.max_latency, 6), round(e.p95(), 6),
                e.max_mem, e.rows_sent, e.errors, e.dispatches,
                e.fragments, _fmt_ts(e.first_seen), _fmt_ts(e.last_seen),
                e.plan_cache_hits, round(e.sum_plan_latency, 6),
                round(e.max_drift, 4),
                round(e.sum_drift / max(e.drift_samples, 1), 4),
                e.worst_drift_op,
                e.xfer_bytes, round(e.compile_ms, 3), e.spill_bytes,
            ))
        return out

    def top(self, n: int = 50) -> List[dict]:
        """JSON-ready top-N by cumulative latency (the /statements
        endpoint's payload)."""
        cols = ("digest", "stmt_type", "digest_text", "plan_digest",
                "exec_count", "sum_latency", "avg_latency", "max_latency",
                "p95_latency", "max_mem", "rows_sent", "errors",
                "dispatches", "fragments", "first_seen", "last_seen",
                "plan_cache_hits", "sum_plan_latency", "max_drift",
                "mean_drift", "worst_drift_op", "xfer_bytes",
                "compile_ms", "spill_bytes")
        return [dict(zip(cols, r)) for r in self.rows()[:max(0, n)]]
