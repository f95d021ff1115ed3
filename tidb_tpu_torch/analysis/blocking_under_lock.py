"""blocking-under-lock pass: no registered lock held across a blocking
call (the machine-checked form of the columnar "store lock
is a LEAF" rule).

The serving tier's wait-discipline check proved the shape there (a
``cv.wait()`` parked with a foreign lock held stalls every statement
behind that lock for the whole gather window). This pass generalizes
it across every module that owns threading locks: while a
``with <lock>:`` body is executing, none of these may run —

  * ``wait()`` / ``wait_for()`` on anything but the held cv itself
    (Condition.wait releases only its OWN lock);
  * ``device_get`` (``utils.dispatch``, the port's sanctioned
    device→host fetch) and ``torch.cuda.synchronize`` — a sync waits
    for everything queued on the card;
  * socket I/O (``recv``/``sendall``/``accept``/``connect``/…) and
    file I/O (``open``, ``np.save``/``np.load``, spill-file
    ``save``/``load``, ``rmtree``);
  * ``MemTracker.consume`` — it re-enters spill (disk I/O) past the
    budget, so holding any lock across it holds that lock across an
    arbitrary eviction;
  * ``spill()`` / ``time.sleep`` / thread ``join`` / queue gets.

Calls are also propagated ONE level through same-class methods
(``self.m()`` under a lock where ``m`` blocks is flagged at the call
site), mirroring lock-discipline's deferred-acquire edges.

Intentional exceptions are suppressions with reasons (``# lint:
disable=blocking-under-lock -- <why>``) so each one is a documented,
counted decision — e.g. utils/memory's budget-exceeded path, which
deliberately trades concurrency for correctness under the account
lock.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from tidb_tpu_torch.analysis.core import Pass, Project, SourceFile, Violation

__all__ = ["BlockingUnderLockPass", "DEFAULT_MODULES"]

DEFAULT_MODULES = (
    "tidb_tpu_torch/parallel/dcn.py",
    "tidb_tpu_torch/utils/tracing.py",
    "tidb_tpu_torch/planner/plancache.py",
    "tidb_tpu_torch/utils/stmtsummary.py",
    "tidb_tpu_torch/storage/catalog.py",
    "tidb_tpu_torch/serving/scheduler.py",
    "tidb_tpu_torch/serving/batcher.py",
    "tidb_tpu_torch/columnar/store.py",
    "tidb_tpu_torch/executor/pipeline.py",
    "tidb_tpu_torch/utils/memory.py",
    # shuffle exchange: the placement and inbox locks are
    # LEAVES — a shuffle send under them would stall every stage/gather
    # behind one slow peer socket (fixture: bad_shuffle_lock.py)
    "tidb_tpu_torch/sharding/shuffle.py",
    "tidb_tpu_torch/sharding/placement.py",
    # plan feedback: the store lock is a LEAF — fold/read
    # only, no planning, device work, or I/O may run under it
    "tidb_tpu_torch/planner/feedback.py",
    # latency SLOs: same leaf contract — the metric gauge
    # updates and eviction cleanup run after the lock is released
    "tidb_tpu_torch/serving/slo.py",
    # background compaction: the whole point of the worker
    # is rebuild-outside-locks — encode/spill I/O under the store or
    # queue lock would stall every scan behind the rebuild it exists
    # to hide (fixture: bad_compaction_lock.py)
    "tidb_tpu_torch/columnar/compaction.py",
    # fused device top-k: the kernels are pure and lock-free
    # by contract — any lock (or device fetch under one) appearing here
    # means per-chunk merge state leaked host-side coordination
    # (fixture: bad_topk_sync.py covers the host-sync half)
    "tidb_tpu_torch/ops/topk.py",
    # topology gates: Condition.wait released-while-waiting
    # is the one sanctioned blocking call; anything else under the
    # registry lock (an RPC, a fingerprint build) would stall EVERY
    # statement's gate acquire behind one cutover
    "tidb_tpu_torch/parallel/membership.py",
)

# attribute names whose call blocks the thread
_BLOCKING_ATTRS = {
    "device_get": "device fetch",
    "synchronize": "device sync",
    "recv": "socket recv", "recv_into": "socket recv",
    "sendall": "socket send", "accept": "socket accept",
    "connect": "socket connect", "makefile": "socket I/O",
    "sleep": "sleep",
    "consume": "tracker charge (re-enters spill past the budget)",
    "spill": "spill I/O",
    "rmtree": "file I/O",
}
# save/load block only on file-ish receivers (np / spill files) — a
# plain dict .get or config .load elsewhere is not I/O
_IO_SAVE_LOAD_ROOTS = ("np", "numpy")


def _is_lockish(expr: ast.AST) -> Optional[str]:
    """Normalized name when `expr` looks like a lock/condition object."""
    if not isinstance(expr, (ast.Attribute, ast.Name)):
        return None
    text = ast.unparse(expr)
    leaf = text.rsplit(".", 1)[-1].lower()
    if "lock" in leaf or leaf in ("cv", "cond") or leaf.endswith("_cv") \
            or "condition" in leaf:
        return text
    return None


def _blocking_kind(node: ast.Call) -> Optional[Tuple[str, str]]:
    """(kind label, rendered call) when `node` is a blocking call."""
    f = node.func
    if isinstance(f, ast.Name):
        if f.id == "open":
            return "file open", "open(...)"
        if f.id == "device_get":
            return "device fetch", "device_get(...)"
        return None
    if not isinstance(f, ast.Attribute):
        return None
    recv = ast.unparse(f.value)
    root = recv.split(".", 1)[0].split("[", 1)[0]
    if f.attr in ("wait", "wait_for"):
        return "blocking wait", f"{recv}.{f.attr}(...)"
    if f.attr in _BLOCKING_ATTRS:
        return _BLOCKING_ATTRS[f.attr], f"{recv}.{f.attr}(...)"
    if f.attr in ("save", "load") and (
            root in _IO_SAVE_LOAD_ROOTS or "spill" in recv.lower()):
        return "file I/O", f"{recv}.{f.attr}(...)"
    if f.attr == "join" and ("thread" in recv.lower()
                             or "worker" in recv.lower()
                             or any(kw.arg == "timeout"
                                    for kw in node.keywords)):
        return "thread join", f"{recv}.join(...)"
    if f.attr in ("get", "put") and "queue" in recv.lower():
        return "queue wait", f"{recv}.{f.attr}(...)"
    return None


def _walk_own(fn: ast.AST):
    """ast.walk that does not descend into nested function/class
    definitions (their bodies execute in a later scope)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class BlockingUnderLockPass(Pass):
    id = "blocking-under-lock"
    doc = ("no registered lock held across a blocking call (waits, "
           "device fetches, socket/file I/O, tracker consume/spill) — "
           "the columnar leaf-lock rule, machine-checked")

    def __init__(self, modules: Sequence[str] = DEFAULT_MODULES):
        self.modules = tuple(m.replace("/", os.sep) for m in modules)

    def run(self, project: Project) -> List[Violation]:
        out: List[Violation] = []
        for sf in project.files():
            if sf.rel not in self.modules:
                continue
            # pre-scan: per-class map of method -> blocking calls inside
            # it, for the one-level self.m() propagation
            method_blocks: Dict[Tuple[str, str], List[str]] = {}
            for cls in [n for n in ast.walk(sf.tree)
                        if isinstance(n, ast.ClassDef)]:
                for m in cls.body:
                    if not isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                        continue
                    kinds = []
                    # nested defs run LATER (usually outside the caller's
                    # lock scope): only the method's own statements count
                    for node in _walk_own(m):
                        if isinstance(node, ast.Call):
                            bk = _blocking_kind(node)
                            if bk is not None:
                                kinds.append(f"{bk[0]} ({bk[1]})")
                    if kinds:
                        method_blocks[(cls.name, m.name)] = kinds
            for cls in [n for n in ast.walk(sf.tree)
                        if isinstance(n, ast.ClassDef)]:
                for m in cls.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self._walk(sf, m.body, (), out,
                                   method_blocks, cls.name)
            # module-level functions (no self-propagation there)
            for node in sf.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._walk(sf, node.body, (), out, method_blocks, None)
        return out

    # -- held-lock walk ----------------------------------------------------

    def _walk(self, sf: SourceFile, stmts, held: Tuple[str, ...], out,
              method_blocks, cls_name: Optional[str]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # closure bodies run later, outside this scope
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                new = list(held)
                for item in stmt.items:
                    for sub in ast.walk(item.context_expr):
                        self._flag(sf, sub, held, out, method_blocks,
                                   cls_name)
                    lid = _is_lockish(item.context_expr)
                    if lid is not None:
                        new.append(lid)
                self._walk(sf, stmt.body, tuple(new), out, method_blocks,
                           cls_name)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                for sub in ast.walk(stmt.iter):
                    self._flag(sf, sub, held, out, method_blocks, cls_name)
                self._walk(sf, stmt.body, held, out, method_blocks, cls_name)
                self._walk(sf, stmt.orelse, held, out, method_blocks,
                           cls_name)
            elif isinstance(stmt, ast.While):
                for sub in ast.walk(stmt.test):
                    self._flag(sf, sub, held, out, method_blocks, cls_name)
                self._walk(sf, stmt.body, held, out, method_blocks, cls_name)
                self._walk(sf, stmt.orelse, held, out, method_blocks,
                           cls_name)
            elif isinstance(stmt, ast.If):
                for sub in ast.walk(stmt.test):
                    self._flag(sf, sub, held, out, method_blocks, cls_name)
                self._walk(sf, stmt.body, held, out, method_blocks, cls_name)
                self._walk(sf, stmt.orelse, held, out, method_blocks,
                           cls_name)
            elif isinstance(stmt, ast.Try):
                self._walk(sf, stmt.body, held, out, method_blocks, cls_name)
                for h in stmt.handlers:
                    self._walk(sf, h.body, held, out, method_blocks,
                               cls_name)
                self._walk(sf, stmt.orelse, held, out, method_blocks,
                           cls_name)
                self._walk(sf, stmt.finalbody, held, out, method_blocks,
                           cls_name)
            elif isinstance(stmt, ast.Match):
                for sub in ast.walk(stmt.subject):
                    self._flag(sf, sub, held, out, method_blocks, cls_name)
                for case in stmt.cases:
                    if case.guard is not None:
                        for sub in ast.walk(case.guard):
                            self._flag(sf, sub, held, out, method_blocks,
                                       cls_name)
                    self._walk(sf, case.body, held, out, method_blocks,
                               cls_name)
            else:
                for sub in ast.walk(stmt):
                    self._flag(sf, sub, held, out, method_blocks, cls_name)

    def _flag(self, sf: SourceFile, node, held: Tuple[str, ...], out,
              method_blocks, cls_name: Optional[str]) -> None:
        if not held or not isinstance(node, ast.Call):
            return
        bk = _blocking_kind(node)
        if bk is not None:
            kind, call = bk
            if kind == "blocking wait":
                # Condition.wait releases its OWN lock: only FOREIGN
                # held locks are the hazard (the gather-window rule)
                recv = ast.unparse(node.func.value)
                others = [h for h in held if h != recv]
                if not others:
                    return
                out.append(Violation(
                    self.id, sf.rel, node.lineno,
                    f"blocking {node.func.attr}() on `{recv}` while "
                    f"holding {', '.join(sorted(set(others)))} — a "
                    "gather-window wait must not park the thread with "
                    "another lock held (it stalls every statement and "
                    "batch dispatch behind that lock for the whole "
                    "window). Release the outer lock before waiting."))
                return
            out.append(Violation(
                self.id, sf.rel, node.lineno,
                f"{kind} `{call}` while holding "
                f"{', '.join(sorted(set(held)))} — registered locks are "
                "LEAVES: release the lock before blocking (or suppress "
                "with a reason if the stall is a deliberate design "
                "decision)."))
            return
        # one-level propagation: a same-class method that blocks, called
        # while the lock is held — matched by name on ANY receiver, not
        # just `self` (the account-lock walk calls `node._on_exceed()`
        # on each ancestor tracker; those are still this class)
        f = node.func
        if cls_name is not None and isinstance(f, ast.Attribute) and \
                isinstance(f.value, ast.Name):
            kinds = method_blocks.get((cls_name, f.attr))
            if kinds:
                out.append(Violation(
                    self.id, sf.rel, node.lineno,
                    f"{f.value.id}.{f.attr}() called while holding "
                    f"{', '.join(sorted(set(held)))} and its body blocks: "
                    f"{kinds[0]}"
                    + (f" (+{len(kinds) - 1} more)" if len(kinds) > 1
                       else "")
                    + " — registered locks are LEAVES; move the blocking "
                    "work outside the lock or suppress with a reason."))
