"""resource-lifecycle pass: acquire/release pairing on the execution
tiers.

The bug class this pass exists for cost PRs 7-10 repeated review
rounds: a resource acquired on the happy path whose release only runs
on the happy path — ``evict_segment`` left its transient pin armed
forever on ENOSPC, staging generators leaked their fill-tracker charge
on abandon, and every such leak surfaces later as a spurious typed OOM
or a stuck eviction, far from the statement that caused it.

The model is deliberately shallow (function-scope, name-based — the
same trade as lock-discipline: depth for zero false positives on the
patterns the repo actually uses). An *acquire* is either a registered
call (``ScanPin(...)``, ``.pin_segment(...)``, ``.consume(...)``,
``.register_spillable(...)``, ``failpoint.enable(...)``,
``._staged_chunks(...)``) or a registered refcount bump
(``X.pins += 1`` / ``X.refs += 1``). Each acquire must be *protected*
by one of:

  * a ``with`` statement (context-managed lifetime);
  * a matching release reachable on the exception path — i.e. at least
    one release for the same resource sits in a ``finally`` block or an
    ``except`` handler of the SAME function (the undo-and-reraise
    pattern counts: that is exactly the ENOSPC fix shape);
  * no in-function release at all, but the enclosing class defines one
    (class-managed lifetime: the object's ``close()``/``release()``
    owns the balance — the runtime sanitizer checks that balance at
    statement end);
  * a ``return`` of the freshly-acquired value (ownership moves to the
    caller);
  * a ``# lifecycle: <reason>`` annotation (documented handoff,
    mirroring the host-sync grammar; stale annotations are flagged).

The dangerous shape this leaves as a violation: a function that BOTH
acquires and releases, with every release on the success path only —
one exception between them and the resource is gone.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Set, Tuple

from tidb_tpu_torch.analysis.core import Pass, Project, SourceFile, Violation

__all__ = ["ResourceLifecyclePass", "ACQUIRE_SPECS", "COUNTER_ATTRS"]


@dataclass(frozen=True)
class AcquireSpec:
    kind: str                  # human label ("scan pin", "tracker charge")
    name: str                  # called attribute/constructor name
    ctor: bool                 # True: Name call (class ctor); False: attr
    releases: Tuple[str, ...]  # attr/function names that release it


ACQUIRE_SPECS: Tuple[AcquireSpec, ...] = (
    AcquireSpec("scan pin", "ScanPin", True, ("close",)),
    AcquireSpec("segment pin", "pin_segment", False, ("unpin_segment",)),
    AcquireSpec("tracker charge", "consume", False,
                ("release", "detach")),
    AcquireSpec("spillable registration", "register_spillable", False,
                ("unregister_spillable",)),
    # failpoint arming outside the context-manager helper must disarm
    # on every path or the next test inherits the fault schedule
    AcquireSpec("failpoint arm", "enable", False, ("disable",)),
    # the staged-chunk generator holds a fill-tracker charge released by
    # its finally: abandoning it un-closed leaks the charge (the reference's
    # _release_staging fix made this class explicit)
    AcquireSpec("staging generator", "_staged_chunks", False, ("close",)),
    # DCN paged-partial cursors: a drained-or-abandoned cursor must be
    # closed or the worker's cursor cap starves later statements
    AcquireSpec("dcn cursor", "_open_cursor", False, ("_close_cursor",)),
)

# refcount attributes whose += 1 is an acquire and whose any-subtracting
# assignment is a release (the columnar pin/ref protocol)
COUNTER_ATTRS = ("pins", "refs")


def _attr_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _release_kinds_in(node: ast.AST) -> Set[str]:
    """Release names + counter-decrement attrs found anywhere in node."""
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            f = sub.func
            if isinstance(f, ast.Attribute):
                out.add(f.attr)
            elif isinstance(f, ast.Name):
                out.add(f.id)
        elif isinstance(sub, (ast.Assign, ast.AugAssign)):
            targets = (sub.targets if isinstance(sub, ast.Assign)
                       else [sub.target])
            for tgt in targets:
                if isinstance(tgt, ast.Attribute) and \
                        tgt.attr in COUNTER_ATTRS:
                    dec = (isinstance(sub, ast.AugAssign)
                           and isinstance(sub.op, ast.Sub))
                    if not dec and sub.value is not None:
                        dec = any(isinstance(b, ast.BinOp)
                                  and isinstance(b.op, ast.Sub)
                                  for b in ast.walk(sub.value))
                    if dec:
                        out.add(f"-{tgt.attr}")
    return out


@dataclass
class _Acquire:
    spec_kind: str
    label: str                 # rendered name of the acquired thing
    line: int
    releases: Tuple[str, ...]  # names that would release it
    protected: bool            # with-context / return handoff


class _FnScan:
    def __init__(self, fn: ast.AST, cls: Optional[ast.ClassDef]):
        self.fn = fn
        self.cls = cls
        self.acquires: List[_Acquire] = []
        # release kinds present anywhere in the function vs only on
        # protected (finally/handler) paths
        self.releases_all: Set[str] = set()
        self.releases_protected: Set[str] = set()

    def run(self) -> None:
        self._walk(self.fn.body, protected=False)

    # -- helpers -----------------------------------------------------------

    def _match_call(self, call: ast.Call) -> Optional[Tuple[AcquireSpec, str]]:
        f = call.func
        for spec in ACQUIRE_SPECS:
            if spec.ctor:
                if isinstance(f, ast.Name) and f.id == spec.name:
                    return spec, spec.name
            else:
                if isinstance(f, ast.Attribute) and f.attr == spec.name:
                    recv = ast.unparse(f.value)
                    if spec.name == "enable" and "failpoint" not in recv:
                        continue  # generic .enable() on non-failpoints
                    return spec, f"{recv}.{spec.name}"
        return None

    def _scan_stmt(self, stmt: ast.stmt, with_ctx: bool, protected: bool
                   ) -> None:
        """Record acquires in one simple statement (headers of compound
        statements come through here too, via their expression parts)."""
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                m = self._match_call(node)
                if m is not None:
                    spec, label = m
                    self.acquires.append(_Acquire(
                        spec.kind, label, node.lineno, spec.releases,
                        protected=with_ctx or protected
                        or isinstance(stmt, ast.Return)))
        # counter bumps: X.pins += 1 (never inside with-headers etc.)
        if isinstance(stmt, ast.AugAssign) and \
                isinstance(stmt.op, ast.Add) and \
                isinstance(stmt.target, ast.Attribute) and \
                stmt.target.attr in COUNTER_ATTRS:
            self.acquires.append(_Acquire(
                "refcount bump", ast.unparse(stmt.target), stmt.lineno,
                (f"-{stmt.target.attr}",), protected=protected))
        for k in _release_kinds_in(stmt):
            self.releases_all.add(k)
            if protected:
                self.releases_protected.add(k)

    def _walk(self, stmts, protected: bool) -> None:
        # with-management applies only to an acquire AS the context
        # expression (scanned with with_ctx=True below) — acquires in a
        # with BODY are deliberately NOT protected by the with
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested scopes scanned on their own
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                # an acquire AS the context expression is with-managed
                for item in stmt.items:
                    hdr = ast.Expr(value=item.context_expr)
                    ast.copy_location(hdr, item.context_expr)
                    self._scan_stmt(hdr, True, protected)
                self._walk(stmt.body, protected)
            elif isinstance(stmt, ast.Try):
                self._walk(stmt.body, protected)
                for h in stmt.handlers:
                    self._walk(h.body, True)
                self._walk(stmt.orelse, protected)
                self._walk(stmt.finalbody, True)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                hdr = ast.Expr(value=stmt.iter)
                ast.copy_location(hdr, stmt.iter)
                self._scan_stmt(hdr, False, protected)
                self._walk(stmt.body, protected)
                self._walk(stmt.orelse, protected)
            elif isinstance(stmt, ast.While):
                self._walk(stmt.body, protected)
                self._walk(stmt.orelse, protected)
            elif isinstance(stmt, ast.If):
                hdr = ast.Expr(value=stmt.test)
                ast.copy_location(hdr, stmt.test)
                self._scan_stmt(hdr, False, protected)
                self._walk(stmt.body, protected)
                self._walk(stmt.orelse, protected)
            else:
                self._scan_stmt(stmt, False, protected)


def _class_release_kinds(cls: Optional[ast.ClassDef],
                         skip_fn: ast.AST) -> Set[str]:
    """Release names defined by OTHER methods of the enclosing class —
    the class-managed-lifetime escape (close()/release() own the
    balance; the runtime sanitizer audits it)."""
    out: Set[str] = set()
    if cls is None:
        return out
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not skip_fn:
            out |= _release_kinds_in(node)
    return out


class ResourceLifecyclePass(Pass):
    id = "resource-lifecycle"
    doc = ("every acquire (pins, tracker charges, cursors, staging "
           "generators, failpoint arms) reaches its release on every "
           "path: finally/with/class-managed, or a `# lifecycle:` "
           "annotated handoff")

    SCOPE = ("executor", "columnar", "parallel", "serving", "sharding")
    # ops/topk.py: the device top-k kernels allocate carried
    # merge state the pipeline must release at finalize — the module
    # itself must stay acquisition-free for that contract to hold
    EXTRA_FILES = ("tidb_tpu_torch/utils/memory.py", "tidb_tpu_torch/ops/topk.py")

    def __init__(self, scope: Sequence[str] = SCOPE,
                 extra_files: Sequence[str] = EXTRA_FILES):
        self.scope = tuple(scope)
        self.extra = tuple(f.replace("/", os.sep) for f in extra_files)

    def _files(self, project: Project) -> List[SourceFile]:
        files = list(project.files_under(*self.scope))
        have = {sf.rel for sf in files}
        for sf in project.files():
            if sf.rel in self.extra and sf.rel not in have:
                files.append(sf)
        return files

    def run(self, project: Project) -> List[Violation]:
        out: List[Violation] = []
        for sf in self._files(project):
            used_notes: Set[int] = set()
            for fn, cls in _functions(sf.tree):
                scan = _FnScan(fn, cls)
                scan.run()
                cls_releases: Optional[Set[str]] = None
                for acq in scan.acquires:
                    note = sf.lifecycle_note(acq.line)
                    if note is not None:
                        used_notes.add(note[0])
                        continue
                    if acq.protected:
                        continue
                    names = set(acq.releases)
                    if names & scan.releases_protected:
                        continue  # release reachable on the except path
                    counter = acq.spec_kind == "refcount bump"
                    if not counter:
                        # class-managed lifetime: close()/release()
                        # elsewhere in the class owns the balance (the
                        # runtime sanitizer audits it at statement end)
                        if cls_releases is None:
                            cls_releases = _class_release_kinds(cls, fn)
                        if names & cls_releases:
                            continue
                    if names & scan.releases_all:
                        out.append(Violation(
                            self.id, sf.rel, acq.line,
                            f"{acq.spec_kind} `{acq.label}` is released "
                            "only on the success path of "
                            f"{fn.name}() — an exception between acquire "
                            "and release leaks it (the evict_segment "
                            "ENOSPC class). Move the release into a "
                            "finally/except, use a context manager, or "
                            "annotate the acquire with `# lifecycle: "
                            "<why the release is guaranteed>`."))
                        continue
                    out.append(Violation(
                        self.id, sf.rel, acq.line,
                        f"{acq.spec_kind} `{acq.label}` in {fn.name}() "
                        "has no matching release on any path "
                        f"(looked for {', '.join(sorted(names))}). "
                        "Release it in a finally, hand it to a class "
                        "that does, or annotate with `# lifecycle: "
                        "<reason>` if ownership moves elsewhere."))
            # stale handoff annotations pre-allowlist a FUTURE acquire —
            # the same invisible-leak class this pass exists to catch
            for line in sorted(set(sf.lifecycle_notes) - used_notes):
                out.append(Violation(
                    self.id, sf.rel, line,
                    "stale lifecycle annotation: no registered acquire "
                    "on the governed line — delete it (or re-anchor it; "
                    "a refactor may have moved the acquire)"))
        return out


def lifecycle_sites(project: Project):
    """Every `# lifecycle:` annotation in scope — the documented
    allowlist of ownership handoffs (rendered by check_invariants
    --syncs beside the host-sync table, counted in the --json report,
    and pinned tier-1 so drift is visible like any suppression)."""
    p = ResourceLifecyclePass()
    out = []
    for sf in p._files(project):
        for line, reason in sorted(sf.lifecycle_notes.items()):
            out.append((sf.rel, line, reason))
    return out


def _functions(tree: ast.Module):
    """Yield (function, enclosing_class_or_None) pairs, outermost class
    attribution only (nested defs attribute to their lexical class)."""
    out = []

    def visit(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((child, cls))
                visit(child, cls)
            else:
                visit(child, cls)

    visit(tree, None)
    return out
