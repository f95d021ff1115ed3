"""Always-on, tail-sampled distributed tracing (a copy of
tidb_tpu/utils/tracing.py; ref: util/tracing +
the Dapper span model production OLAP engines ship: every statement
records a cheap span tree; head sampling decides whether an UNEVENTFUL
statement keeps it, tail rules retroactively keep exactly the traces
worth reading — slow statements, deadline/kill victims, retry/failover
survivors, and errors).

Building blocks:

  * ``Span`` — monotonic-clock interval with a parent link, a process
    label, and free-form annotations. ``start_us`` is relative to the
    owning trace's anchor, so spans from concurrent threads render with
    real overlap instead of as-if-sequential.
  * ``Trace`` — one statement's bounded span collection. trace_id is
    ``<digest16>-<seq>`` (statement digest + process-wide sequence).
    Lock-cheap: span-id allocation and list appends ride CPython
    atomicity; the lock is only taken to graft remote spans and to
    export.
  * ``graft`` — re-anchors spans shipped back by a DCN worker under the
    coordinator RPC span that carried them, remapping the worker's
    process-local span ids so one cross-process tree comes out.
  * ``TraceStore`` — capacity-bounded ring of KEPT traces, surfaced by
    the status port's ``/trace`` endpoint and
    ``information_schema.cluster_trace``.

Thread-local context: ``push``/``pop`` install a trace (plus current
parent span) on the calling thread; ``span()``/``annotate()``/
``current()`` read it. Code running on other threads (DCN dispatch
fan-out) records spans directly on the Trace object with explicit
parent ids instead.

A served statement's trace runs from the connection thread to the card:
the scheduler opens it at the task's enqueue time (``queued``:
``sched.queue``, then ``sched.lock_wait``), the session claims it
(``session.parse``, the ``stmt.*`` span and its phases, down to the
executor's per-operator spans and the built programs' ``jit.<ns>``
spans), and the connection thread adds ``server.write`` (``resume``).
Per-trace counters (``count``, ``sync``) hold what is too frequent for a
span: ``storage.live_rows`` and ``device.sync`` (calls, seconds). Every
time is ``time.perf_counter()``, on Linux ``clock_gettime
(CLOCK_MONOTONIC)``, the clock of ``time.monotonic()``.

While a ``torch.profiler`` is active, every live span (``begin``/
``span``) and each call under ``tally``/``sync`` also opens a
``record_function`` range of the same name, so the spans sit in the
profiler's trace beside the kernels they launch; intervals recorded after
the fact (``add_complete``: ``sched.queue``, the executor envelopes)
cannot. With no profiler the check is one module attribute read. A
profiler sees the ranges of the thread that started it only, unless it
profiles all threads (``_ExperimentalConfig(profile_all_threads=True)``).

When a statement ends (``apply_tail_rules``) its tree is folded into one
small record (``RECORDS``, read by ``statements()``), kept or not.

The off path must stay near-free: with no trace installed every hook is
one thread-local read and a None check — the bench.py warm join
microbench gates tracing overhead with sampling off at <= 2%.
"""

from __future__ import annotations

import contextlib
import itertools
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from torch.autograd import profiler as _profiler

__all__ = ["Span", "Trace", "TraceStore", "STORE", "current", "push",
           "pop", "span", "begin", "finish", "annotate",
           "current_span_id", "head_sampled", "make_trace_id", "keep",
           "current_trace_id", "PORT_SPANS", "LIVE_ROWS", "DEVICE_SYNC",
           "profiling", "open_range", "count", "sync", "tally", "queued", "settle",
           "resume", "RECORDS", "statements"]

_SEQ = itertools.count(1)

# a runaway statement must not turn its trace into a memory leak: past
# the cap spans are counted (``dropped``) but not retained
DEFAULT_MAX_SPANS = 512

_tls = threading.local()

# names the port records that the reference's tracer lacks, each a leaf
# (a prefix ends in "."): the reference's tree is the port's with these
# left out
PORT_SPANS = ("sched.lock_wait", "session.parse", "session.finish",
              "server.write", "jit.")

# the per-trace counters (calls, seconds)
LIVE_ROWS = "storage.live_rows"
DEVICE_SYNC = "device.sync"


def profiling() -> bool:
    """True while a torch.profiler is active in this process (torch's own
    flag, set and cleared as a profiler starts and stops)."""
    return _profiler._is_profiler_enabled


def open_range(name: str):
    """An open record_function range of `name`, for a caller that found
    profiling() true (the off path is that one check); close it with
    ``rf.__exit__(None, None, None)``."""
    rf = _profiler.record_function(name)
    rf.__enter__()
    return rf


def make_trace_id(digest: str) -> str:
    """trace_id = statement digest (16 hex chars) + process-wide seq."""
    return f"{(digest or 'anon')[:16]}-{next(_SEQ)}"


def head_sampled(rate: float) -> bool:
    """One head-sampling coin flip; rate<=0 never pays the RNG call."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    return random.random() < rate


class Span:
    __slots__ = ("span_id", "parent_id", "name", "start_us", "dur_us",
                 "proc", "notes", "rf")

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 start_us: int):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start_us = start_us
        self.dur_us = -1  # -1: still open
        self.proc = ""    # "" = this process; set on graft to the endpoint
        self.notes: List[str] = []
        self.rf = None    # the profiler range a live span holds open


class _NullNotes(list):
    """Append sink for the dropped-span sentinel: callers annotate
    spans unconditionally, and the shared sentinel must not accumulate
    (or leak) their notes."""

    def append(self, _x) -> None:
        pass

    def extend(self, _xs) -> None:
        pass


# sentinel returned once a trace is over its span budget: timing it is
# skipped and end() is a no-op, so hot loops never branch on fullness
_DROPPED = Span(-1, None, "<dropped>", 0)
_DROPPED.notes = _NullNotes()


class Trace:
    """One statement's span tree (see module docstring)."""

    def __init__(self, trace_id: str, sampled: bool = False,
                 max_spans: int = DEFAULT_MAX_SPANS,
                 t0_perf: Optional[float] = None):
        """`trace_id` "" opens the trace ahead of its statement, which
        claims it (``claim``); `t0_perf` anchors it at an earlier
        perf_counter() reading (a task's enqueue)."""
        self.trace_id = trace_id
        self.claimed = bool(trace_id)
        self.sampled = sampled
        self.max_spans = max_spans
        now = time.perf_counter()
        self.t0_perf = now if t0_perf is None else t0_perf
        self.start_ts = time.time() - (now - self.t0_perf)
        self.spans: List[Span] = []
        self.dropped = 0
        self.keep_reasons: List[str] = []
        # per-trace counters: name -> [calls, seconds]
        self.counters: Dict[str, list] = {}
        # aggregated leaf spans: name -> [span, seconds, {kind: calls}]
        self._tallies: Dict[str, list] = {}
        # this statement's record in RECORDS, once folded
        self.record: Optional[Dict] = None
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._count_lock = threading.Lock()

    def claim(self, trace_id: str, sampled: bool) -> None:
        """The statement's identity, for a trace opened ahead of it."""
        self.trace_id = trace_id
        self.sampled = sampled
        self.claimed = True

    # -- recording ------------------------------------------------------

    def _now_us(self) -> int:
        return int((time.perf_counter() - self.t0_perf) * 1e6)

    def begin(self, name: str, parent_id: Optional[int] = None) -> Span:
        if len(self.spans) >= self.max_spans:
            # lint: disable=lock-discipline -- lock-cheap by design (see
            # module doc): appends/counts ride CPython atomicity; the
            # lock only guards export/graft snapshots
            self.dropped += 1
            return _DROPPED
        s = Span(next(self._ids), parent_id, name, self._now_us())
        # lint: disable=lock-discipline -- CPython-atomic append; the
        # hot record path must not pay a lock per span (module doc)
        self.spans.append(s)
        if _profiler._is_profiler_enabled:
            s.rf = open_range(name)
        return s

    def end(self, s: Span) -> None:
        if s is _DROPPED:
            return
        s.dur_us = self._now_us() - s.start_us
        if s.rf is not None:
            s.rf.__exit__(None, None, None)
            s.rf = None

    def count(self, name: str, seconds: float) -> None:
        """One call of a per-trace counter."""
        with self._count_lock:
            c = self.counters.get(name)
            if c is None:
                self.counters[name] = [1, seconds]
            else:
                c[0] += 1
                c[1] += seconds

    def tally(self, name: str, t0_perf: float, seconds: float, kind: str,
              parent_id: Optional[int]) -> None:
        """One call folded into the aggregated leaf span `name`: it starts
        at the first call, lasts the calls' summed seconds and counts
        them by `kind` (``settle_tallies`` writes the counts as notes)."""
        with self._count_lock:
            t = self._tallies.get(name)
            if t is None:
                s = self.add_complete(name, t0_perf, 0.0, parent_id=parent_id)
                t = self._tallies[name] = [s, 0.0, {}]
            t[1] += seconds
            k = t[2].get(kind)
            if k is None:
                t[2][kind] = [1, seconds]
            else:
                k[0] += 1
                k[1] += seconds
            if t[0] is not _DROPPED:
                t[0].dur_us = int(t[1] * 1e6)

    def settle_tallies(self) -> None:
        """Write each aggregated span's calls by kind as its note and as
        counters ``<name>.<kind>`` (calls, seconds)."""
        with self._count_lock:
            for name, (s, _secs, kinds) in self._tallies.items():
                if s is not _DROPPED:
                    s.notes[:] = [" ".join(f"{k}={c[0]}" for k, c in sorted(kinds.items()))]
                for k, c in kinds.items():
                    self.counters[f"{name}.{k}"] = list(c)

    def add_complete(self, name: str, t0_perf: float, dur_s: float,
                     parent_id: Optional[int] = None,
                     notes: Optional[List[str]] = None) -> Span:
        """Record an already-measured interval (fragment dispatches and
        other code that timed itself with perf_counter)."""
        if len(self.spans) >= self.max_spans:
            # lint: disable=lock-discipline -- lock-cheap by design (see
            # module doc and begin())
            self.dropped += 1
            return _DROPPED
        s = Span(next(self._ids), parent_id, name,
                 int((t0_perf - self.t0_perf) * 1e6))
        s.dur_us = int(dur_s * 1e6)
        if notes:
            s.notes.extend(notes)
        # lint: disable=lock-discipline -- CPython-atomic append (see
        # module doc and begin())
        self.spans.append(s)
        return s

    def keep(self, reason: str) -> None:
        """Tail rule: this trace survives regardless of head sampling."""
        if reason not in self.keep_reasons:
            self.keep_reasons.append(reason)

    @property
    def kept(self) -> bool:
        return bool(self.keep_reasons)

    # -- cross-process assembly -----------------------------------------

    def export(self) -> List[Dict]:
        """Wire form of every FINISHED span (codec-safe scalars only) —
        a DCN worker piggybacks this on its RPC response."""
        with self._lock:
            spans = list(self.spans)
        out = []
        for s in spans:
            out.append({"i": s.span_id, "p": s.parent_id or 0,
                        "n": s.name,
                        "s": s.start_us,
                        "d": s.dur_us if s.dur_us >= 0 else
                        self._now_us() - s.start_us,
                        "a": list(s.notes)})
        return out

    def graft(self, remote: List[Dict], base: Span, proc: str) -> None:
        """Attach a worker's exported spans under `base` (the RPC span
        that carried them). Remote span ids are process-local — remap
        them to fresh local ids; remote roots (parent unknown here)
        hang off `base`. Remote offsets are relative to the worker's
        request-receipt anchor, so they re-anchor at the RPC span's
        start (the error is one network one-way — unobservable without
        a clock sync protocol, and small on a DCN link)."""
        if base is _DROPPED or not remote:
            return
        idmap: Dict[int, int] = {}
        with self._lock:
            for r in remote:
                if len(self.spans) >= self.max_spans:
                    self.dropped += len(remote) - len(idmap)
                    return
                try:
                    s = Span(next(self._ids), None, str(r["n"]),
                             base.start_us + int(r["s"]))
                    s.dur_us = int(r["d"])
                    s.proc = proc
                    notes = r.get("a") or []
                    s.notes = [str(a) for a in notes]
                    idmap[int(r["i"])] = s.span_id
                    parent = int(r.get("p") or 0)
                    s.parent_id = idmap.get(parent, base.span_id)
                except (KeyError, TypeError, ValueError):
                    continue  # malformed remote span: skip, keep the rest
                self.spans.append(s)

    # -- read side ------------------------------------------------------

    def duration_ms(self) -> float:
        roots = [s for s in self.spans if s.parent_id is None]
        end = 0
        for s in self.spans:
            end = max(end, s.start_us + max(s.dur_us, 0))
        start = min((s.start_us for s in roots), default=0)
        return round((end - start) / 1e3, 3)

    def summary(self) -> Dict:
        # the statement's root: the first root the reference records (a
        # served statement's queue, lock wait and parse come before it)
        root = next((s for s in self.spans if s.parent_id is None
                     and not s.name.startswith(PORT_SPANS)
                     and s.name != "sched.queue"), None)
        return {
            "trace_id": self.trace_id,
            "start": time.strftime("%Y-%m-%d %H:%M:%S",
                                   time.localtime(self.start_ts)),
            "root": root.name if root is not None else "",
            "duration_ms": self.duration_ms(),
            "spans": len(self.spans),
            "dropped": self.dropped,
            "sampled": self.sampled,
            "keep": list(self.keep_reasons),
        }

    def to_dict(self) -> Dict:
        """Full JSON form: summary + the span TREE (children nested)."""
        with self._lock:
            spans = list(self.spans)
        nodes = {}
        for s in spans:
            nodes[s.span_id] = {
                "span_id": s.span_id, "name": s.name, "proc": s.proc,
                "start_us": s.start_us, "duration_us": max(s.dur_us, 0),
                "annotations": list(s.notes), "children": [],
            }
        roots = []
        for s in spans:
            node = nodes[s.span_id]
            parent = nodes.get(s.parent_id)
            (roots if parent is None else parent["children"]).append(node)
        out = self.summary()
        out["tree"] = roots
        with self._count_lock:
            out["counters"] = {k: list(v) for k, v in self.counters.items()}
        return out

    def fold(self, t_end: float) -> Dict:
        """This trace as one small record: its id, its start and end on
        perf_counter(), seconds and count per span name, its counters."""
        with self._lock:
            spans = list(self.spans)
        per: Dict[str, list] = {}
        for s in spans:
            p = per.get(s.name)
            if p is None:
                p = per[s.name] = [0, 0.0]
            p[0] += 1
            p[1] += max(s.dur_us, 0) / 1e6
        with self._count_lock:
            counters = {k: list(v) for k, v in self.counters.items()}
        return {"trace_id": self.trace_id, "t_start": self.t0_perf,
                "t_end": t_end, "spans": per, "counters": counters}


# ---------------------------------------------------------------------------
# thread-local context
# ---------------------------------------------------------------------------


def push(trace: Trace, span_: Optional[Span] = None) -> None:
    """Install `trace` as this thread's current trace; `span_` (if any)
    becomes the parent for subsequently opened spans."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append((trace, [span_] if span_ is not None else []))


def pop() -> Optional[Trace]:
    stack = getattr(_tls, "stack", None)
    if not stack:
        return None
    return stack.pop()[0]


def current() -> Optional[Trace]:
    stack = getattr(_tls, "stack", None)
    if not stack:
        return None
    return stack[-1][0]


def current_span_id() -> Optional[int]:
    stack = getattr(_tls, "stack", None)
    if not stack:
        return None
    spans = stack[-1][1]
    return spans[-1].span_id if spans else None


def current_trace_id() -> str:
    tr = current()
    return tr.trace_id if tr is not None else ""


def begin(name: str) -> Optional[Span]:
    """Open a span under the thread's current trace and make it the
    parent for subsequent spans. Pair with finish(); for block-scoped
    spans prefer the span() context manager. None without a trace."""
    stack = getattr(_tls, "stack", None)
    if not stack:
        return None
    trace, spans = stack[-1]
    s = trace.begin(name, spans[-1].span_id if spans else None)
    spans.append(s)
    return s


def finish(s: Optional[Span]) -> None:
    stack = getattr(_tls, "stack", None)
    if s is None or not stack:
        return
    trace, spans = stack[-1]
    if s in spans:
        # pop through any child spans a non-local exit left open
        while spans and spans[-1] is not s:
            trace.end(spans.pop())
        spans.pop()
    trace.end(s)


@contextlib.contextmanager
def span(name: str):
    """Span under the thread's current trace; no-op when none is
    installed (the off path: one TLS read + None check)."""
    stack = getattr(_tls, "stack", None)
    if not stack:
        yield None
        return
    trace, spans = stack[-1]
    s = trace.begin(name, spans[-1].span_id if spans else None)
    spans.append(s)
    try:
        yield s
    finally:
        spans.pop()
        trace.end(s)


def count(name: str, seconds: float) -> None:
    """One call of the per-trace counter `name` under the thread's trace;
    no-op without one."""
    stack = getattr(_tls, "stack", None)
    if stack:
        stack[-1][0].count(name, seconds)


class _Timed:
    """``with sync():`` — the block's seconds into a counter, and a
    profiler range of the counter's name while one is active."""

    __slots__ = ("name", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = open_range(self.name) if _profiler._is_profiler_enabled else None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        count(self.name, time.perf_counter() - self.t0)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)


_NO_SYNC = contextlib.nullcontext()


def sync(on_card: bool = True):
    """Time a block in which the host waits on the card (a device->host
    copy, a host->device copy from pageable memory, an operation whose
    output size the host must learn) under the ``device.sync`` counter;
    with `on_card` false (the same code on the CPU) a no-op."""
    return _Timed(DEVICE_SYNC) if on_card else _NO_SYNC


def tally(name: str, t0_perf: float, seconds: float, kind: str) -> None:
    """One call of `name` (``jit.<ns>``, run as `kind`) into its
    aggregated leaf span, one per name per trace, under the phase of the
    statement the call runs in (the span right under the ``stmt.*``
    span). No-op without a trace."""
    stack = getattr(_tls, "stack", None)
    if not stack:
        return
    trace, spans = stack[-1]
    parent = spans[1] if len(spans) > 1 else (spans[0] if spans else None)
    trace.tally(name, t0_perf, seconds, kind,
                parent.span_id if parent is not None else None)


def annotate(note: str) -> None:
    """Attach a note to the thread's current span (or the trace root
    when no span is open). No-op without a trace."""
    stack = getattr(_tls, "stack", None)
    if not stack:
        return
    trace, spans = stack[-1]
    target = spans[-1] if spans else (trace.spans[0] if trace.spans else None)
    if target is not None and target is not _DROPPED:
        target.notes.append(note)


def keep(reason: str) -> None:
    """Tail-keep the thread's current trace, if any."""
    tr = current()
    if tr is not None:
        tr.keep(reason)


# ---------------------------------------------------------------------------
# tail-sampled store
# ---------------------------------------------------------------------------


class TraceStore:
    """Capacity-bounded ring of kept traces (newest wins)."""

    def __init__(self, capacity: int = 64):
        self.lock = threading.Lock()
        self.capacity = capacity
        self._ring: deque = deque()

    def add(self, trace: Trace, capacity: Optional[int] = None) -> None:
        from tidb_tpu_torch.utils.metrics import TRACE_KEPT_TOTAL

        reason = trace.keep_reasons[0] if trace.keep_reasons else "sampled"
        TRACE_KEPT_TOTAL.inc(reason=reason)
        with self.lock:
            if capacity is not None:
                self.capacity = max(1, int(capacity))
            self._ring.append(trace)
            while len(self._ring) > self.capacity:
                self._ring.popleft()

    def get(self, trace_id: str) -> Optional[Trace]:
        with self.lock:
            for t in reversed(self._ring):
                if t.trace_id == trace_id:
                    return t
        return None

    def list(self, n: int = 50) -> List[Dict]:
        if n <= 0:
            return []  # [-0:] would be the FULL ring, not none
        with self.lock:
            traces = list(self._ring)[-n:]
        return [t.summary() for t in reversed(traces)]

    def traces(self) -> List[Trace]:
        with self.lock:
            return list(self._ring)

    def clear(self) -> None:
        with self.lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self.lock:
            return len(self._ring)


# process-global like the metrics REGISTRY: the status port, I_S, and
# every session/cluster in this process share one tail-sampled store
STORE = TraceStore()


class StatementRecords:
    """Fixed-size ring of the folded records of the statements that
    ended (``Trace.fold``), oldest dropped first."""

    CAPACITY = 4096

    def __init__(self):
        self.lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.CAPACITY)

    def add(self, record: Dict) -> None:
        with self.lock:
            self._ring.append(record)

    def window(self, t_from: float, t_to: float) -> List[Dict]:
        with self.lock:
            return [r for r in self._ring if t_from <= r["t_start"] <= t_to]

    def clear(self) -> None:
        with self.lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self.lock:
            return len(self._ring)


RECORDS = StatementRecords()


def statements(t_from: float, t_to: float) -> List[Dict]:
    """The records of the statements that began (the scheduler's enqueue,
    or the session's parse outside the server) from `t_from` to `t_to`,
    both on time.monotonic()/perf_counter(), oldest first. A record:
    trace_id, t_start, t_end, spans {name: [count, seconds]}, counters
    {name: [calls, seconds]}."""
    return RECORDS.window(t_from, t_to)


def _end(tr: Trace) -> None:
    tr.settle_tallies()
    tr.record = tr.fold(time.perf_counter())
    RECORDS.add(tr.record)


def queued(t_enqueue: float) -> Trace:
    """Open, on this thread, the trace of a statement about to run: it
    starts at `t_enqueue` (perf_counter() when its task was queued) with
    the span ``sched.queue`` up to now, and the statement claims it."""
    tr = Trace("", t0_perf=t_enqueue)
    tr.add_complete("sched.queue", t_enqueue, time.perf_counter() - t_enqueue)
    push(tr)
    return tr


def settle(tr: Trace) -> None:
    """After the statement a trace was opened for: pop it off the thread
    if it is still there. A trace no statement claimed (the statement
    failed before it began) ends here, with what it holds."""
    if current() is tr:
        pop()
    if not tr.claimed and tr.record is None:
        _end(tr)


@contextlib.contextmanager
def resume(tr: Optional[Trace], name: str):
    """A live span `name` of an ended statement's trace on this thread
    (the connection thread's ``server.write``); the statement's record
    takes its seconds and ends where it ends."""
    if tr is None:
        yield None
        return
    push(tr)
    s = tr.begin(name)
    try:
        yield s
    finally:
        tr.end(s)
        pop()
        rec = tr.record
        if rec is not None and s is not _DROPPED:
            p = rec["spans"].setdefault(name, [0, 0.0])
            p[0] += 1
            p[1] += s.dur_us / 1e6
            rec["t_end"] = time.perf_counter()


def apply_tail_rules(tr: Trace, dur_s: float, threshold_ms: int,
                     error=None, capacity: Optional[int] = None) -> str:
    """The ONE end-of-statement keep sequence, shared by
    Session._execute_timed and standalone Cluster.query (two copies
    would drift): error keep -> slow keep -> pop off the thread ->
    head-sample keep -> store if kept; the trace folded into its record
    (RECORDS) either way. Returns the trace_id."""
    if error is not None:
        tr.keep(f"error:{type(error).__name__}")
    if dur_s * 1e3 >= threshold_ms:
        tr.keep("slow")
    if current() is tr:
        pop()
    if tr.sampled:
        tr.keep("sampled")
    _end(tr)
    if tr.kept:
        STORE.add(tr, capacity=capacity)
    return tr.trace_id
