"""Runtime invariant sanitizer: records what actually
happens and diffs it against the static model.

The static passes prove what the AST can see. This layer witnesses the
rest at runtime, behind the ``tidb_tpu_sanitize`` sysvar (or the
``TIDB_TPU_SANITIZE`` env var for whole-process runs):

  * **lock-order witness** — the registered engine locks (created via
    :func:`tracked_lock`) record every nested acquisition into a
    process-global order graph, across ALL threads: orders threaded
    through prefetch threads, scheduler workers, and weakref finalizers
    that the AST cannot see. The graph is cycle-checked at statement
    end, and :func:`diff_static` diffs it against the static lock graph
    (analysis/lock_discipline.static_lock_edges) — a runtime edge the
    static model lacks is exactly the blind spot this exists to light.
  * **tracker balance** — MemTracker release()/detach() report typed
    findings: a double release (consumed below zero) is fatal; a
    detach-time residual (bytes the statement never release()d) is a
    recorded leak witness (the engine's detach() reclaims it by design,
    so it stays non-fatal but visible).
  * **pin balance** — every ScanPin opened during a statement must be
    closed by statement end; a leaked pin is a fatal finding (the class
    of bug that surfaces later as spurious typed OOM).
  * **host-sync budget** — a per-statement counter of device→host
    round trips taken through the sanctioned chokepoint
    (``utils/dispatch.device_get``, which counts into the open scope),
    asserted against the statement's declared budget
    (``tidb_tpu_sanitize_sync_budget``).
  * **shared-global witness** — registered process-global writes
    during ANY in-flight statement are fatal findings (the reference's
    ``hash_probe.set_mode`` race is the founding member of this class;
    the port has no process-wide probe mode, so no site registers
    today and the witness guards the next one).
  * **wire witness** — every request crossing a DCN worker
    socket (``parallel/dcn._send`` calls :func:`note_wire_msg` while
    enabled) is diffed against the committed static protocol model
    (``analysis/wire_protocol.json``): an unknown cmd, an unknown
    field, or a missing handler-required field is a typed finding.
    This is the closed loop that keeps the static extractor honest —
    real traffic the model cannot account for means the extractor
    missed a send site, and the model would otherwise silently rot.
    Surfacing: sends on the statement's own thread (2PC, reshard)
    raise through the statement scope like any fatal finding; sends on
    dispatch/scatter worker threads stay in :func:`report` (the
    own-thread rule — blaming a concurrent statement for another's
    traffic cascades one bug into innocent failures), which is why the
    chaos gate asserts ``report()`` wire-clean rather than relying on
    per-statement raises alone.

This module is stdlib-only (the analyzer contract: never pull torch
into the CLI), and it patches nothing of torch: tests share one
process, and the counter needs no patch since every sanctioned fetch
calls :func:`count_sync` itself.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["enabled", "enable", "disable", "tracked_lock", "TrackedLock",
           "statement_begin", "statement_end", "Finding", "report",
           "diff_static", "check_lock_cycle", "reset",
           "note_tracker_release", "note_tracker_detach",
           "note_pin_open", "note_pin_close", "note_global_write",
           "count_sync", "note_wire_msg", "wire_model",
           "set_wire_model"]

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

_FINDINGS_CAP = 256


def env_gate() -> bool:
    """The TIDB_TPU_SANITIZE env seed, with conventional falsy strings
    honored — `TIDB_TPU_SANITIZE=0` must DISABLE, not enable (a bare
    bool() on the string "0" is True)."""
    v = os.environ.get("TIDB_TPU_SANITIZE", "")
    return v.strip().lower() not in ("", "0", "false", "off", "no")


@dataclass
class Finding:
    kind: str          # lock-cycle | tracker-double-release | ...
    subject: str       # what it happened to (lock names, tracker label)
    detail: str
    fatal: bool = True
    thread: str = ""

    def render(self) -> str:
        sev = "FATAL" if self.fatal else "note"
        return f"[sanitizer:{self.kind}] {sev} {self.subject}: {self.detail}"


class _State:
    def __init__(self):
        self.lock = threading.RLock()
        self.enabled = env_gate()
        self.findings: List[Finding] = []
        # runtime lock graph: a -> {b: "thread/site"} for every b
        # acquired while a was held on the same thread
        self.edges: Dict[str, Dict[str, str]] = {}
        self.active_scopes = 0
        self.dropped = 0


_ST = _State()
_tls = threading.local()


def enabled() -> bool:
    return _ST.enabled


def enable() -> None:
    """Turn the witness on process-wide. Idempotent and STICKY: the
    first sanitized statement enables it for the whole process (the
    lock graph must span sessions/threads to witness cross-session
    orders), and flipping the sysvar off stops per-statement scopes but
    leaves the witness recording until an explicit disable() — debug
    mode is per-process, not per-session (README "Sanitizer mode").

    Nothing is patched: the sync counter is the port's own chokepoint,
    ``utils/dispatch.device_get``, which calls :func:`count_sync` on
    every fetch (a no-op outside a statement scope)."""
    with _ST.lock:
        _ST.enabled = True


def disable(reset_state: bool = True) -> None:
    with _ST.lock:
        _ST.enabled = False
        if reset_state:
            reset()


def reset() -> None:
    """Drop all witnessed state (tests isolate through this)."""
    with _ST.lock:
        _ST.findings = []
        _ST.edges = {}
        _ST.dropped = 0


def _add_finding(f: Finding) -> None:
    f.thread = threading.current_thread().name
    with _ST.lock:
        if len(_ST.findings) >= _FINDINGS_CAP:
            _ST.dropped += 1
            return
        _ST.findings.append(f)


# -- lock witness -----------------------------------------------------------


def _held() -> List[tuple]:
    """This thread's held tracked locks, innermost last: (name, id of the
    inner lock) for each acquisition."""
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


class TrackedLock:
    """Wrapper around a threading lock that records nested-acquisition
    order while the sanitizer is enabled. Transparent otherwise (one
    attribute check per acquire). Condition() interop works by
    delegation: ``_release_save``/``_acquire_restore``/``_is_owned``
    resolve to the inner lock, so a cv built over a tracked lock parks
    and resumes exactly like an untracked one (the held stack keeps the
    name across the wait — consistent, since the lock is re-acquired
    before the waiter continues)."""

    __slots__ = ("name", "_lk")

    def __init__(self, name: str, inner):
        self.name = name
        self._lk = inner

    def acquire(self, *args, **kwargs):
        got = self._lk.acquire(*args, **kwargs)
        if got and _ST.enabled:
            held = _held()
            me = (self.name, id(self._lk))
            if me not in held:
                # a reentrant re-acquisition (this very RLock, already
                # held by this thread) cannot wait, so it orders nothing:
                # the reference records it as an edge from every lock
                # taken since, which makes Catalog.lock -> Catalog.readers
                # -> Catalog.lock (run_pending_reclusters, then
                # Table.recluster) a false cycle. Another instance of the
                # same name can wait, and gets its edge (a self-edge, so
                # two instances nested without an order are a cycle)
                with _ST.lock:
                    for h in set(name for name, _ in held):
                        _ST.edges.setdefault(h, {}).setdefault(
                            self.name, threading.current_thread().name)
            held.append(me)
        return got

    def release(self):
        # pop UNCONDITIONALLY: a disable() landing while this thread is
        # inside its critical section must not strand the name on the
        # held stack (a stale entry would mint phantom order edges —
        # and phantom cycles — after the next enable). Only acquire's
        # edge recording is gated on the flag.
        held = getattr(_tls, "held", None)
        if held:
            # remove the LAST occurrence (reentrant locks stack)
            me = (self.name, id(self._lk))
            for i in range(len(held) - 1, -1, -1):
                if held[i] == me:
                    del held[i]
                    break
        self._lk.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._lk.locked()

    def __getattr__(self, name):
        return getattr(self._lk, name)


def tracked_lock(name: str, factory=threading.Lock) -> TrackedLock:
    """A registered engine lock: ``self._lock =
    tracked_lock("SegmentStore._lock")``. Names follow the static
    graph's ``Class.attr`` convention so diff_static lines up."""
    return TrackedLock(name, factory())


def lock_edges() -> Dict[str, Dict[str, str]]:
    with _ST.lock:
        return {a: dict(bs) for a, bs in _ST.edges.items()}


def check_lock_cycle() -> Optional[Finding]:
    """DFS the runtime graph; a cycle is a witnessed deadlock order."""
    from tidb_tpu_torch.analysis.lock_discipline import LockDisciplinePass

    cyc = LockDisciplinePass._find_cycle(lock_edges())
    if cyc is None:
        return None
    path, locs = cyc
    f = Finding("lock-cycle", " -> ".join(path),
                "runtime acquisition-order cycle witnessed across "
                f"threads: {'; '.join(locs)}")
    _add_finding(f)
    return f


def diff_static(root: str = _REPO_ROOT) -> dict:
    """Diff the witnessed lock graph against the static model. Returns
    {"novel": [(a, b, thread)], "static_only": [(a, b)]} — novel edges
    came through paths the AST cannot see (callbacks, worker threads,
    finalizers); they are the witness's yield, not violations."""
    from tidb_tpu_torch.analysis.lock_discipline import static_lock_edges

    static = static_lock_edges(root)
    runtime = lock_edges()
    novel = [(a, b, thr) for a, bs in runtime.items()
             for b, thr in bs.items() if b not in static.get(a, {})]
    static_only = [(a, b) for a, bs in static.items()
                   for b in bs if b not in runtime.get(a, {})]
    return {"novel": sorted(novel), "static_only": sorted(static_only)}


# -- tracker / pin / global hooks ------------------------------------------


def note_tracker_release(label: str, consumed: int) -> None:
    """Called by MemTracker.release when a tracker's balance went
    negative — more bytes released than were ever consumed."""
    _add_finding(Finding(
        "tracker-double-release", label,
        f"released below zero (consumed={consumed}) — some charge was "
        "returned twice"))


def note_tracker_detach(label: str, residual: int) -> None:
    """Called by MemTracker.detach for a nonzero residual: bytes the
    statement consumed and never released. detach() reclaims them (by
    design), so this is a leak WITNESS, not a failure."""
    _add_finding(Finding(
        "tracker-residual", label,
        f"{residual} bytes never release()d before detach "
        "(reclaimed by detach; leak witness)", fatal=False))


def note_pin_open(pin) -> None:
    sc = _current_scope()
    if sc is not None:
        sc.pins[id(pin)] = pin


def note_pin_close(pin) -> None:
    sc = _current_scope()
    if sc is not None:
        sc.pins.pop(id(pin), None)


def note_global_write(name: str, value) -> None:
    """A registered process-global was written. During ANY in-flight
    statement that is a race with every other session reading it at
    trace time (the hash_probe.set_mode class) — fatal."""
    with _ST.lock:
        active = _ST.active_scopes
    if active > 0:
        _add_finding(Finding(
            "shared-global-write", name,
            f"process-global written to {value!r} while {active} "
            "statement(s) were in flight — thread the value through "
            "ExecContext/fragment args instead"))


def count_sync() -> None:
    sc = _current_scope()
    if sc is not None:
        sc.syncs += 1


# -- wire witness ------------------------------------------------


# committed static protocol model (analysis/wire_protocol.json):
# loaded lazily once, stdlib-only. {"loaded": bool, "model": dict|None}
_WIRE = {"loaded": False, "model": None}
_WIRE_MODEL_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "wire_protocol.json")


def wire_model() -> Optional[dict]:
    # the lazy load is guarded: a distributed query's parallel
    # dispatch threads hit their first _send simultaneously, and the
    # outage finding below must record ONCE, not once per thread
    with _ST.lock:
        if _WIRE["loaded"]:
            return _WIRE["model"]
        try:
            import json

            with open(_WIRE_MODEL_PATH, encoding="utf-8") as f:
                _WIRE["model"] = json.load(f)
        except (OSError, ValueError) as e:
            # failing OPEN silently would leave the operator believing
            # the wire witness is armed while a whole finding class is
            # off — record the outage ONCE, non-fatal (the other
            # witnesses still run; a lint/CLI context has no model by
            # design and never reaches here: note_wire_msg only fires
            # from a live dcn._send)
            _WIRE["model"] = None
            _add_finding(Finding(
                "wire-model-unavailable", _WIRE_MODEL_PATH,
                f"static protocol model failed to load ({e}) — the "
                "wire witness is OFF for this process; restore the "
                "committed analysis/wire_protocol.json "
                "(`python -m tidb_tpu_torch.analysis --gen-wire` regenerates it)",
                fatal=False))
        _WIRE["loaded"] = True
    return _WIRE["model"]


def set_wire_model(model: Optional[dict]) -> None:
    """Test hook: install a model (None re-loads the committed one on
    next use)."""
    _WIRE["model"] = model
    _WIRE["loaded"] = model is not None


def note_wire_msg(msg) -> None:
    """Called by ``parallel/dcn._send`` (behind the enabled() flag) for
    every frame leaving a socket. Requests — dicts carrying a string
    ``cmd`` — are diffed against the static protocol model; responses
    and handshake bytes pass through untouched. ``_``-prefixed keys are
    server-local annotations, never wire fields."""
    if not isinstance(msg, dict):
        return
    cmd = msg.get("cmd")
    if not isinstance(cmd, str):
        return
    model = wire_model()
    if model is None:
        return
    env = model.get("envelope", {})
    ent = model.get("cmds", {}).get(cmd)
    if ent is None:
        _add_finding(Finding(
            "wire-unknown-cmd", cmd,
            "request crossed a worker socket with a cmd absent from "
            "the static protocol model — a send site the extractor "
            "cannot see (or a dynamically-minted cmd); fix the sender "
            "or regenerate `python -m tidb_tpu_torch.analysis --gen-wire`"))
        return
    fields = {k for k in msg
              if isinstance(k, str) and k != "cmd"
              and not k.startswith("_")}
    allowed = set(env.get("sent", ())) | set(env.get("read", ()))
    h = ent.get("handler")
    if h is not None:
        allowed |= set(h.get("required", ())) \
            | set(h.get("conditional", ())) | set(h.get("optional", ()))
    for s in ent.get("senders", ()):
        allowed |= set(s.get("required", ())) | set(s.get("optional", ()))
    for f in sorted(fields - allowed):
        _add_finding(Finding(
            "wire-unknown-field", f"{cmd}.{f}",
            "field crossed a worker socket that the static protocol "
            "model does not know for this cmd — dead wire bytes at "
            "best, a handler the model missed at worst; regenerate "
            "the model or fix the sender"))
    if h is not None:
        for f in sorted(set(h.get("required", ())) - fields):
            _add_finding(Finding(
                "wire-missing-field", f"{cmd}.{f}",
                "request omits a field the handler reads "
                "unconditionally — this exact message raises a remote "
                "KeyError on the worker"))


# -- statement scope --------------------------------------------------------


@dataclass
class _StmtScope:
    sync_budget: Optional[int]
    start_idx: int
    pins: Dict[int, object] = field(default_factory=dict)
    syncs: int = 0


def _current_scope() -> Optional[_StmtScope]:
    scopes = getattr(_tls, "scopes", None)
    return scopes[-1] if scopes else None


def statement_begin(sync_budget: Optional[int] = None) -> _StmtScope:
    scopes = getattr(_tls, "scopes", None)
    if scopes is None:
        scopes = _tls.scopes = []
    with _ST.lock:
        sc = _StmtScope(sync_budget, len(_ST.findings))
        _ST.active_scopes += 1
    scopes.append(sc)
    return sc


def statement_end(scope: _StmtScope) -> List[Finding]:
    """Close the scope and return every finding it produced: leaked
    pins, a blown sync budget, witnessed lock cycles, and any global
    findings recorded while it ran."""
    scopes = getattr(_tls, "scopes", None)
    if scopes and scopes[-1] is scope:
        scopes.pop()
    elif scopes and scope in scopes:
        scopes.remove(scope)
    with _ST.lock:
        _ST.active_scopes = max(_ST.active_scopes - 1, 0)
    out: List[Finding] = []
    for pin in scope.pins.values():
        f = Finding(
            "pin-leak", type(pin).__name__,
            "opened during the statement and never closed — its charges "
            "and segment references outlive the statement (surfaces "
            "later as spurious typed OOM / stuck eviction)")
        _add_finding(f)
        out.append(f)
    if scope.sync_budget is not None and scope.syncs > scope.sync_budget:
        f = Finding(
            "host-sync-budget", "statement",
            f"{scope.syncs} device_get round trips > declared budget "
            f"{scope.sync_budget} — a per-chunk sync storm the "
            "pipelined executor exists to remove")
        _add_finding(f)
        out.append(f)
    cyc = check_lock_cycle()
    if cyc is not None and cyc not in out:
        out.append(cyc)
    # collect global findings recorded while this scope ran, but only
    # those witnessed ON THIS THREAD: statement scopes are per-thread,
    # and blaming statement B for a pin statement A leaked (they merely
    # overlapped) would cascade one bug into typed failures on every
    # innocent concurrent statement. Off-thread findings (prefetch
    # workers, other sessions) stay visible in report().
    me = threading.current_thread().name
    with _ST.lock:
        for f in _ST.findings[scope.start_idx:]:
            if f.thread == me and f not in out:
                out.append(f)
    return out


def report() -> dict:
    """Snapshot for tests/tools: findings + the witnessed lock graph."""
    with _ST.lock:
        findings = list(_ST.findings)
        dropped = _ST.dropped
    return {
        "enabled": _ST.enabled,
        "findings": [
            {"kind": f.kind, "subject": f.subject, "detail": f.detail,
             "fatal": f.fatal, "thread": f.thread} for f in findings],
        "dropped": dropped,
        "lock_edges": lock_edges(),
    }
