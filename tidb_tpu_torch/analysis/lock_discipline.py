"""lock-discipline pass: static deadlock + unlocked-write detection for
the multi-threaded coordinator layer.

Two checks over the modules that own threading locks (DCN, tracing,
plan cache, statement summary, catalog):

  1. lock ordering — every ``with <lock>:`` nesting contributes an
     acquisition edge (including one level of same-class method calls
     made while holding a lock); a cycle in the resulting graph is a
     statically-provable deadlock candidate and fails the build.

  2. mixed locked/unlocked mutation — an attribute mutated under a lock
     somewhere and WITHOUT one elsewhere is a data race waiting for a
     scheduler: the unlocked site is flagged.  ``__init__`` is exempt
     (construction is single-threaded), as are methods whose name ends
     in ``_locked`` (the repo convention: the caller holds the lock),
     lock/thread-local attributes themselves, and thread-confined state
     documented with a line suppression.

Scope is intra-class and name-based (a mutation through a local alias
``h = self._health[i]; h.state = ...`` is invisible) — the pass trades
depth for zero false positives on the patterns the repo actually uses.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from tidb_tpu_torch.analysis.core import Pass, Project, SourceFile, Violation

__all__ = ["LockDisciplinePass", "static_lock_edges"]

_MUTATORS = {
    "append", "extend", "add", "remove", "discard", "pop", "popitem",
    "clear", "update", "insert", "setdefault", "move_to_end",
    "appendleft", "popleft",
}

DEFAULT_MODULES = (
    "tidb_tpu_torch/parallel/dcn.py",
    "tidb_tpu_torch/utils/tracing.py",
    "tidb_tpu_torch/planner/plancache.py",
    "tidb_tpu_torch/utils/stmtsummary.py",
    "tidb_tpu_torch/storage/catalog.py",
    "tidb_tpu_torch/serving/scheduler.py",
    "tidb_tpu_torch/serving/batcher.py",
    # columnar segment store: the store's leaf lock guards
    # segment residency/spill state shared across concurrent scans
    "tidb_tpu_torch/columnar/store.py",
    # shuffle exchange: the inbox lock guards staged-batch
    # state shared by peer-stage RPC threads and the gather/apply phase
    "tidb_tpu_torch/sharding/shuffle.py",
    # plan feedback: the store's leaf lock guards per-digest
    # observations folded by concurrent statement-end harvests
    "tidb_tpu_torch/planner/feedback.py",
    # latency SLOs: the digest-latency store's leaf lock
    # guards windows folded at statement end and read at admission
    "tidb_tpu_torch/serving/slo.py",
    # background compaction: the worker queue lock is a
    # LEAF under the store lock; snapshot/cutover take the store lock
    # only for pointer swaps — the segment build itself runs unlocked
    "tidb_tpu_torch/columnar/compaction.py",
    # fused device top-k: lock-free by contract — the merge
    # state lives on device and the pipeline owns all coordination, so
    # any lock acquired here is a discipline violation by definition
    "tidb_tpu_torch/ops/topk.py",
    # topology gates: the gate registry's one lock guards
    # per-table reader/writer counts mutated by every statement and
    # every reshard/membership cutover (fixture: bad_membership_lock.py)
    "tidb_tpu_torch/parallel/membership.py",
)

# NOTE: the serving-tier wait-discipline check moved to
# blocking_under_lock.py, which generalizes it — waits are
# one of several blocking-call kinds no registered lock may span.


def _is_threading_ctor(node: ast.AST, names: Sequence[str]) -> bool:
    """True if `node` (or any sub-expression) calls threading.<name>()."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute):
            f = sub.func
            if isinstance(f.value, ast.Name) and f.value.id == "threading" \
                    and f.attr in names:
                return True
    return False


def _self_attr(node: ast.AST) -> Optional[str]:
    """`self.X` / `self.X[...]` -> 'X' (the owning attribute)."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _ClassScan:
    def __init__(self, sf: SourceFile, cls: ast.ClassDef):
        self.sf = sf
        self.cls = cls
        self.lock_attrs: Set[str] = set()
        self.tls_attrs: Set[str] = set()
        # (attr, method, line, locked, thread_entry)
        self.mutations: List[Tuple[str, str, int, bool]] = []
        self.edges: List[Tuple[str, str, str]] = []   # (A, B, "file:line")
        self.method_acquires: Dict[str, Set[str]] = {}
        self.deferred_calls: List[Tuple[str, str, str]] = []  # (A, method, loc)
        self.thread_targets: Set[str] = set()

    def lock_id(self, expr: ast.AST) -> Optional[str]:
        """Normalized node id for a lock expression, or None."""
        attr = _self_attr(expr)
        if attr is not None:
            if attr in self.lock_attrs or attr.endswith(("lock", "locks")):
                return f"{self.cls.name}.{attr}"
            return None
        # foreign lock (e.g. `with store.lock:`): keep the source text
        if isinstance(expr, ast.Attribute) and \
                expr.attr.endswith(("lock", "locks")):
            return ast.unparse(expr)
        return None

    def scan(self) -> None:
        for stmt in self.cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._collect_attrs(stmt)
        for stmt in self.cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_method(stmt)

    def _collect_attrs(self, fn: ast.FunctionDef) -> None:
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AnnAssign)) \
                    and node.value is not None:
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    attr = _self_attr(tgt)
                    if attr is None:
                        continue
                    if _is_threading_ctor(node.value, ("Lock", "RLock",
                                                       "Condition")):
                        self.lock_attrs.add(attr)
                    elif _is_threading_ctor(node.value, ("local",)):
                        self.tls_attrs.add(attr)
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and \
                    node.func.attr == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        t = _self_attr(kw.value)
                        if t is not None:
                            self.thread_targets.add(t)
                        elif isinstance(kw.value, ast.Name):
                            self.thread_targets.add(kw.value.id)

    def _scan_method(self, fn: ast.FunctionDef) -> None:
        acquires: Set[str] = set()

        def walk(stmts, held: Tuple[str, ...]) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                self._scan_mutations(stmt, fn, held)
                self._scan_calls(stmt, held)
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    new = list(held)
                    for item in stmt.items:
                        lid = self.lock_id(item.context_expr)
                        if lid is not None:
                            acquires.add(lid)
                            loc = f"{self.sf.rel}:{item.context_expr.lineno}"
                            for h in new:
                                if h != lid:
                                    self.edges.append((h, lid, loc))
                            new.append(lid)
                    walk(stmt.body, tuple(new))
                elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                    walk(stmt.body, held)
                    walk(stmt.orelse, held)
                elif isinstance(stmt, ast.If):
                    walk(stmt.body, held)
                    walk(stmt.orelse, held)
                elif isinstance(stmt, ast.Try):
                    walk(stmt.body, held)
                    for h in stmt.handlers:
                        walk(h.body, held)
                    walk(stmt.orelse, held)
                    walk(stmt.finalbody, held)

        walk(fn.body, ())
        self.method_acquires[fn.name] = acquires

    def _scan_calls(self, stmt: ast.stmt, held: Tuple[str, ...]) -> None:
        if not held:
            return
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == "self":
                loc = f"{self.sf.rel}:{node.lineno}"
                self.deferred_calls.append((held[-1], node.func.attr, loc))

    def _scan_mutations(self, stmt: ast.stmt, fn: ast.FunctionDef,
                        held: Tuple[str, ...]) -> None:
        locked = bool(held) or fn.name.endswith("_locked")
        skip = {"__init__"}
        if fn.name in skip:
            return
        attrs: List[Tuple[str, int]] = []
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            flat: List[ast.expr] = []
            for tgt in targets:
                # unpack tuple/list targets: `self.a, self.b = ...`
                # mutates both attributes just as surely as two assigns
                stack = [tgt]
                while stack:
                    t = stack.pop()
                    if isinstance(t, (ast.Tuple, ast.List)):
                        stack.extend(t.elts)
                    elif isinstance(t, ast.Starred):
                        stack.append(t.value)
                    else:
                        flat.append(t)
            for tgt in flat:
                base = tgt
                # peel subscripts/attribute chains to the self.X base
                while isinstance(base, (ast.Subscript, ast.Attribute)):
                    a = _self_attr(base)
                    if a is not None:
                        attrs.append((a, tgt.lineno))
                        break
                    base = base.value
        elif isinstance(stmt, ast.Delete):
            for tgt in stmt.targets:
                a = _self_attr(tgt)
                if a is not None:
                    attrs.append((a, tgt.lineno))
        elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
            if isinstance(call.func, ast.Attribute) and \
                    call.func.attr in _MUTATORS:
                a = _self_attr(call.func.value)
                if a is not None:
                    attrs.append((a, call.lineno))
        for attr, line in attrs:
            if attr in self.lock_attrs or attr in self.tls_attrs:
                continue
            self.mutations.append((attr, fn.name, line, locked))


def _scan_modules(project: Project, modules: Sequence[str]
                  ) -> List["_ClassScan"]:
    scans: List[_ClassScan] = []
    for sf in project.files():
        if sf.rel not in modules:
            continue
        for node in sf.tree.body:
            if isinstance(node, ast.ClassDef):
                cs = _ClassScan(sf, node)
                cs.scan()
                scans.append(cs)
    return scans


def _edges_of(scans: List["_ClassScan"]) -> Dict[str, Dict[str, str]]:
    edges: Dict[str, Dict[str, str]] = {}
    acquires_of: Dict[Tuple[str, str], Set[str]] = {}
    for cs in scans:
        for m, acq in cs.method_acquires.items():
            acquires_of[(cs.cls.name, m)] = acq
    for cs in scans:
        for a, b, loc in cs.edges:
            edges.setdefault(a, {}).setdefault(b, loc)
        for held, method, loc in cs.deferred_calls:
            for b in acquires_of.get((cs.cls.name, method), ()):
                if b != held:
                    edges.setdefault(held, {}).setdefault(
                        b, f"{loc} (via {method}())")
    return edges


def static_lock_edges(root: str,
                      modules: Sequence[str] = DEFAULT_MODULES
                      ) -> Dict[str, Dict[str, str]]:
    """The static acquisition-order graph (A -> {B: site}) over the
    registered lock modules — what the AST can prove. The runtime
    sanitizer (analysis/sanitizer.py) diffs its witnessed orders
    against this: a runtime edge absent here came through a path the
    AST cannot see (a prefetch thread, a scheduler worker, a
    finalizer) and is exactly what the witness exists to surface."""
    project = Project(root)
    mods = tuple(m.replace("/", os.sep) for m in modules)
    return _edges_of(_scan_modules(project, mods))


class LockDisciplinePass(Pass):
    id = "lock-discipline"
    doc = ("no lock-acquisition-order cycles; no attribute mutated both "
           "under a lock and without one")

    def __init__(self, modules: Sequence[str] = DEFAULT_MODULES):
        self.modules = tuple(m.replace("/", os.sep) for m in modules)

    def run(self, project: Project) -> List[Violation]:
        out: List[Violation] = []
        scans = _scan_modules(project, self.modules)

        # -- mixed locked/unlocked mutation --------------------------------
        for cs in scans:
            by_attr: Dict[str, List[Tuple[str, int, bool]]] = {}
            for attr, method, line, locked in cs.mutations:
                by_attr.setdefault(attr, []).append((method, line, locked))
            for attr, sites in by_attr.items():
                locked_sites = [s for s in sites if s[2]]
                unlocked_sites = [s for s in sites if not s[2]]
                if not locked_sites or not unlocked_sites:
                    continue
                lm, ll, _ = locked_sites[0]
                for method, line, _ in unlocked_sites:
                    entry = (" (a thread entry point)"
                             if method in cs.thread_targets else "")
                    out.append(Violation(
                        self.id, cs.sf.rel, line,
                        f"self.{attr} is mutated without a lock in "
                        f"{cs.cls.name}.{method}{entry} but under one in "
                        f"{cs.cls.name}.{lm} (line {ll}) — a concurrent "
                        "writer can interleave. Take the lock, rename the "
                        "method *_locked if the caller holds it, or "
                        "suppress with the confinement argument."))

        # -- acquisition-order cycles --------------------------------------
        edges = _edges_of(scans)
        cycle = self._find_cycle(edges)
        if cycle is not None:
            path, locs = cycle
            out.append(Violation(
                self.id,
                locs[0].split(":")[0], int(locs[0].split(":")[1].split()[0]),
                "lock-acquisition-order cycle (static deadlock): "
                + " -> ".join(path)
                + " ; acquisition sites: " + "; ".join(locs)))
        return out

    @staticmethod
    def _find_cycle(edges: Dict[str, Dict[str, str]]
                    ) -> Optional[Tuple[List[str], List[str]]]:
        WHITE, GRAY, BLACK = 0, 1, 2
        color: Dict[str, int] = {}
        stack: List[str] = []

        def dfs(u: str) -> Optional[List[str]]:
            color[u] = GRAY
            stack.append(u)
            for v in edges.get(u, {}):
                c = color.get(v, WHITE)
                if c == GRAY:
                    return stack[stack.index(v):] + [v]
                if c == WHITE:
                    r = dfs(v)
                    if r is not None:
                        return r
            stack.pop()
            color[u] = BLACK
            return None

        for node in list(edges):
            if color.get(node, WHITE) == WHITE:
                path = dfs(node)
                if path is not None:
                    locs = []
                    for a, b in zip(path, path[1:]):
                        locs.append(edges[a][b])
                    return path, locs
        return None
