"""Pass driver: source model, suppression parsing, violation report.

A ``Project`` lazily parses every ``tidb_tpu_torch/`` module once; each
``Pass`` walks the shared ASTs and returns ``Violation``s; the
``Driver`` applies the suppression rules and renders one report.

Everything here is stdlib-only (ast + tokenize) — the analyzer must
never import the engine's device stack (torch) so a full run stays
well under the tier-1 10s budget.  The registry passes that DO need a live
import (metrics rendering) import only leaf modules.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["Violation", "SourceFile", "Project", "Pass", "Driver",
           "all_passes"]

# grammar (see package docstring): lint disables carry the pass list
# and a `--`-separated reason; host-sync annotations carry a reason;
# lifecycle annotations document an acquire whose release
# deliberately lives elsewhere (ownership handoff) — same shape as
# host-sync: `# lifecycle: <why the release is guaranteed elsewhere>`
_DISABLE_RE = re.compile(
    r"#\s*lint:\s*(module-)?disable=([a-z0-9_,-]+)\s*(?:--\s*(.*))?$")
_HOST_SYNC_RE = re.compile(r"#\s*host-sync:\s*(.*)$")
_LIFECYCLE_RE = re.compile(r"#\s*lifecycle:\s*(.*)$")


@dataclass
class Violation:
    pass_id: str
    path: str          # repo-relative
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_id}] {self.message}"


@dataclass
class Suppression:
    pass_id: str
    path: str
    line: int          # line the comment sits on
    target: int        # code line the directive governs
    reason: str
    module_wide: bool = False
    used: bool = False


class SourceFile:
    """One parsed module: text, AST, and its comment directives."""

    def __init__(self, root: str, path: str):
        self.root = root
        self.path = path                       # absolute
        self.rel = os.path.relpath(path, root)
        with open(path, encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=self.rel)
        self.suppressions: List[Suppression] = []
        self.host_sync_notes: Dict[int, str] = {}   # line -> reason
        self.lifecycle_notes: Dict[int, str] = {}   # line -> reason
        # line -> innermost statement span (start, end): a directive
        # trailing a multi-line statement must govern the whole
        # statement, not just the physical line the comment sits on
        self._spans: Dict[int, Tuple[int, int]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.stmt) and node.end_lineno is not None:
                span = (node.lineno, node.end_lineno)
                for ln in range(span[0], span[1] + 1):
                    prev = self._spans.get(ln)
                    if prev is None or \
                            span[1] - span[0] < prev[1] - prev[0]:
                        self._spans[ln] = span
        self._parse_comments()

    def _same_stmt(self, a: int, b: int) -> bool:
        if a == b:
            return True
        sa = self._spans.get(a)
        return sa is not None and sa == self._spans.get(b)

    def _parse_comments(self) -> None:
        try:
            toks = tokenize.generate_tokens(io.StringIO(self.text).readline)
            comments = [(t.start[0], t.string) for t in toks
                        if t.type == tokenize.COMMENT]
        except tokenize.TokenError:
            comments = []
        for line, text in comments:
            m = _DISABLE_RE.search(text)
            if m:
                module_wide = bool(m.group(1))
                reason = self._absorb_reason(
                    (m.group(3) or "").strip(), line)
                target = self._target_line(line)
                for pid in m.group(2).split(","):
                    self.suppressions.append(Suppression(
                        pid.strip(), self.rel, line, target, reason,
                        module_wide=module_wide))
                continue
            m = _HOST_SYNC_RE.search(text)
            if m:
                self.host_sync_notes[self._target_line(line)] = \
                    self._absorb_reason(m.group(1).strip(), line)
                continue
            m = _LIFECYCLE_RE.search(text)
            if m:
                self.lifecycle_notes[self._target_line(line)] = \
                    self._absorb_reason(m.group(1).strip(), line)

    def _absorb_reason(self, reason: str, line: int) -> str:
        """A standalone directive's reason may wrap onto following
        comment-only lines; join them so the rendered report carries
        the whole sentence, not its first fragment."""
        before = (self.lines[line - 1].split("#", 1)[0]
                  if line <= len(self.lines) else "")
        if before.strip():
            return reason  # trailing form: one line by definition
        for ln in range(line + 1, len(self.lines) + 1):
            text = self.lines[ln - 1].strip()
            if not text.startswith("#"):
                break
            if _DISABLE_RE.search(text) or _HOST_SYNC_RE.search(text) \
                    or _LIFECYCLE_RE.search(text):
                break  # a new directive starts its own reason
            reason = f"{reason} {text.lstrip('#').strip()}".strip()
        return reason

    def _target_line(self, line: int) -> int:
        """The code line a comment directive governs: its own line when
        the comment trails code, else the next non-comment code line
        (a standalone directive may wrap onto continuation comments)."""
        text = self.lines[line - 1] if line <= len(self.lines) else ""
        before = text.split("#", 1)[0]
        if before.strip():
            return line
        for ln in range(line + 1, len(self.lines) + 1):
            stripped = self.lines[ln - 1].strip()
            if stripped and not stripped.startswith("#"):
                return ln
        return line

    def suppression_for(self, pass_id: str, line: int
                        ) -> Optional[Suppression]:
        """A directive suppresses violations on the code line it
        governs (trailing-comment line, or the statement following a
        standalone comment) — or anywhere in that line's statement,
        so a directive trailing a wrapped call still covers a
        violation anchored to the call's first line — or module-wide."""
        for s in self.suppressions:
            if s.pass_id != pass_id:
                continue
            if s.module_wide or self._same_stmt(s.target, line):
                return s
        return None

    def host_sync_note(self, line: int) -> Optional[Tuple[int, str]]:
        if line in self.host_sync_notes:
            return line, self.host_sync_notes[line]
        for ln, reason in self.host_sync_notes.items():
            if self._same_stmt(ln, line):
                return ln, reason
        return None

    def lifecycle_note(self, line: int) -> Optional[Tuple[int, str]]:
        """`# lifecycle:` handoff annotation governing `line` (same
        statement-span rules as host_sync_note)."""
        if line in self.lifecycle_notes:
            return line, self.lifecycle_notes[line]
        for ln, reason in self.lifecycle_notes.items():
            if self._same_stmt(ln, line):
                return ln, reason
        return None


class Project:
    """Lazily-parsed view of the repo: every .py under <root>/tidb_tpu_torch.

    ``restrict`` (repo-relative paths) narrows the listing to a changed
    subset — the ``--changed`` incremental mode parses (and checks) only
    those files, which is what makes a diff lint land in well under a
    second for the builder loop."""

    def __init__(self, root: str, restrict: Optional[List[str]] = None):
        self.root = os.path.abspath(root)
        self._files: Dict[str, SourceFile] = {}
        self._listing: Optional[List[str]] = None
        self.restrict = (None if restrict is None else
                         {os.path.normpath(r) for r in restrict})

    def paths(self) -> List[str]:
        if self._listing is None:
            out = []
            pkg = os.path.join(self.root, "tidb_tpu_torch")
            for dirpath, dirnames, filenames in os.walk(pkg):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                out.extend(os.path.join(dirpath, f)
                           for f in filenames if f.endswith(".py"))
            if self.restrict is not None:
                out = [p for p in out
                       if os.path.normpath(os.path.relpath(p, self.root))
                       in self.restrict]
            self._listing = sorted(out)
        return self._listing

    def file(self, path: str) -> SourceFile:
        sf = self._files.get(path)
        if sf is None:
            sf = self._files[path] = SourceFile(self.root, path)
        return sf

    def files(self) -> List[SourceFile]:
        return [self.file(p) for p in self.paths()]

    def files_under(self, *subdirs: str) -> List[SourceFile]:
        wanted = tuple(os.path.join("tidb_tpu_torch", d) + os.sep
                       for d in subdirs)
        return [sf for sf in self.files()
                if sf.rel.startswith(wanted)]


class Pass:
    """One invariant: ``run(project)`` returns raw (pre-suppression)
    violations. ``id`` is the name used in suppression directives."""

    id = "base"
    doc = ""

    def run(self, project: Project) -> List[Violation]:  # pragma: no cover
        raise NotImplementedError


@dataclass
class PassReport:
    pass_id: str
    violations: List[Violation] = field(default_factory=list)   # unsuppressed
    suppressed: List[Tuple[Violation, Suppression]] = field(
        default_factory=list)
    problems: List[Violation] = field(default_factory=list)     # bad directives
    seconds: float = 0.0        # wall clock of this pass's run()


class Driver:
    """Run passes, apply suppressions, render the report."""

    def __init__(self, root: str, passes: Optional[List[Pass]] = None,
                 changed: Optional[List[str]] = None):
        self.project = Project(root, restrict=changed)
        self.passes = passes if passes is not None else all_passes()

    def run(self) -> List[PassReport]:
        import time as _time

        reports = []
        # directives are validated against the FULL pass registry, not
        # just the selected subset — `--pass error-shape` must not
        # misreport every jit-hygiene suppression as unknown
        known = {p.id for p in all_passes()} | {p.id for p in self.passes}
        for p in self.passes:
            rep = PassReport(p.id)
            t0 = _time.perf_counter()
            for v in p.run(self.project):
                sf = self._file_for(v)
                sup = sf.suppression_for(p.id, v.line) if sf else None
                if sup is not None:
                    sup.used = True
                    rep.suppressed.append((v, sup))
                else:
                    rep.violations.append(v)
            rep.seconds = _time.perf_counter() - t0
            reports.append(rep)
        # directive hygiene rides the first report: a suppression that
        # names no reason, an unknown pass id, or a line-level directive
        # that no longer suppresses anything (the flagged code was fixed
        # or the target line drifted) is itself a violation. Module-wide
        # disables are exempt from staleness — they are prophylactic
        # (e.g. a bench file that happens to be clean today).
        selected = {p.id for p in self.passes}
        hygiene = PassReport("suppressions")
        for sf in self.project.files():
            for s in sf.suppressions:
                if s.pass_id not in known:
                    hygiene.problems.append(Violation(
                        "suppressions", sf.rel, s.line,
                        f"unknown pass {s.pass_id!r} in lint directive"))
                if not s.reason:
                    hygiene.problems.append(Violation(
                        "suppressions", sf.rel, s.line,
                        "suppression without a reason "
                        "(use `-- <why>` after the pass list)"))
                if (not s.module_wide and not s.used
                        and s.pass_id in selected):
                    hygiene.problems.append(Violation(
                        "suppressions", sf.rel, s.line,
                        f"stale suppression: no {s.pass_id} violation on "
                        "the governed line — delete the directive (or "
                        "re-anchor it; a refactor may have moved the "
                        "code it covered)"))
            for line, reason in sf.host_sync_notes.items():
                if not reason:
                    hygiene.problems.append(Violation(
                        "suppressions", sf.rel, line,
                        "host-sync annotation without a reason"))
            for line, reason in sf.lifecycle_notes.items():
                if not reason:
                    hygiene.problems.append(Violation(
                        "suppressions", sf.rel, line,
                        "lifecycle annotation without a reason"))
        reports.append(hygiene)
        return reports

    def _file_for(self, v: Violation) -> Optional[SourceFile]:
        path = os.path.join(self.project.root, v.path)
        try:
            return self.project.file(path)
        except (OSError, SyntaxError):
            return None

    @staticmethod
    def render(reports: List[PassReport]) -> Tuple[str, int]:
        """-> (text, exit_code)."""
        out: List[str] = []
        bad = 0
        n_sup = 0
        for rep in reports:
            issues = rep.violations + rep.problems
            if issues:
                bad += len(issues)
                out.append(f"[{rep.pass_id}] {len(issues)} violation(s):")
                out.extend(f"  {v.render()}" for v in issues)
            n_sup += len(rep.suppressed)
            for v, s in rep.suppressed:
                out.append(f"[{rep.pass_id}] suppressed at {v.path}:{v.line}"
                           f" -- {s.reason}")
        status = ("FAILED" if bad else "ok")
        out.append(f"invariants {status}: {bad} violation(s), "
                   f"{n_sup} suppressed (each with a recorded reason)")
        return "\n".join(out), (1 if bad else 0)

    # JSON report schema version: bump on breaking shape changes — the
    # builder loop and tier-1 round-trip test both pin it
    JSON_SCHEMA = 1

    def to_json(self, reports: List[PassReport]) -> dict:
        """Machine-readable report: violations, suppressions, per-pass
        timings, and the annotated-allowlist counts (host-sync syncs +
        lifecycle handoffs — annotations are allowlist entries exactly
        like suppressions, so drift in them must be machine-visible
        too). The shape round-trips through json (tier-1 asserted) so
        external builder loops can consume it without scraping."""
        def _viol(v: Violation) -> dict:
            return {"pass": v.pass_id, "path": v.path.replace(os.sep, "/"),
                    "line": v.line, "message": v.message}

        passes = []
        n_bad = 0
        n_sup = 0
        for rep in reports:
            issues = rep.violations + rep.problems
            n_bad += len(issues)
            n_sup += len(rep.suppressed)
            passes.append({
                "id": rep.pass_id,
                "seconds": round(rep.seconds, 4),
                "violations": [_viol(v) for v in rep.violations],
                "problems": [_viol(v) for v in rep.problems],
                "suppressed": [
                    {"pass": rep.pass_id,
                     "path": v.path.replace(os.sep, "/"), "line": v.line,
                     "reason": s.reason} for v, s in rep.suppressed],
            })
        from tidb_tpu_torch.analysis.host_sync import annotated_sites
        from tidb_tpu_torch.analysis.registry import (elastic_surfaces,
                                                observability_surfaces,
                                                plan_feedback_surfaces)
        from tidb_tpu_torch.analysis.resource_lifecycle import lifecycle_sites

        return {
            "schema": Driver.JSON_SCHEMA,
            "ok": n_bad == 0,
            "violation_count": n_bad,
            "suppression_count": n_sup,
            "host_sync_annotation_count": len(annotated_sites(self.project)),
            "lifecycle_annotation_count": len(lifecycle_sites(self.project)),
            # the plan-feedback layer's user-visible surfaces
            # (I_S table, endpoint, metric, sysvar, EXPLAIN drift
            # column, slow-log column) counted statically — drift here
            # means a surface was silently dropped in a refactor
            "plan_feedback_surface_count":
                len(plan_feedback_surfaces(self.project)),
            # the observability plane's user-visible surfaces
            # (cluster_metrics/digest_latency I_S tables, scope=cluster
            # render, /slo endpoint, metrics_snapshot cmd, profile
            # columns, SLO sysvars/consumer) counted the same way
            "observability_surface_count":
                len(observability_surfaces(self.project)),
            # the elastic-topology plane's surfaces (online
            # reshard + recovery, membership lifecycle, cluster_info
            # I_S table, reshard/membership metrics, gate sysvar)
            # counted the same way
            "elastic_surface_count":
                len(elastic_surfaces(self.project)),
            "passes": passes,
        }


# AST-only passes (no live engine import): the set the --changed
# incremental mode runs over a diff — the registry passes need the whole
# tree (a changed subset can't prove sysvar/metric coverage either way),
# and protocol-conformance is registry-shaped too: a diff that excludes
# dcn.py would see a protocol with no handler and flag everything
AST_PASS_IDS = ("jit-hygiene", "host-sync", "lock-discipline",
                "resource-lifecycle", "blocking-under-lock",
                "cache-key-completeness", "error-shape")


def all_passes() -> List[Pass]:
    from tidb_tpu_torch.analysis.blocking_under_lock import BlockingUnderLockPass
    from tidb_tpu_torch.analysis.cache_key import CacheKeyCompletenessPass
    from tidb_tpu_torch.analysis.error_shape import ErrorShapePass
    from tidb_tpu_torch.analysis.host_sync import HostSyncPass
    from tidb_tpu_torch.analysis.jit_hygiene import JitHygienePass
    from tidb_tpu_torch.analysis.lock_discipline import LockDisciplinePass
    from tidb_tpu_torch.analysis.registry import (
        FailpointCoveragePass,
        MetricsCoveragePass,
        SysvarCoveragePass,
    )
    from tidb_tpu_torch.analysis.resource_lifecycle import ResourceLifecyclePass
    from tidb_tpu_torch.analysis.wire_protocol import ProtocolConformancePass

    return [
        JitHygienePass(),
        HostSyncPass(),
        LockDisciplinePass(),
        ResourceLifecyclePass(),
        BlockingUnderLockPass(),
        ProtocolConformancePass(),
        CacheKeyCompletenessPass(),
        MetricsCoveragePass(),
        FailpointCoveragePass(),
        SysvarCoveragePass(),
        ErrorShapePass(),
    ]
