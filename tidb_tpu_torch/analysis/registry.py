"""registry-coverage passes: metrics, failpoints, sysvars.

The metrics and failpoint checks are the reference's single-purpose
checkers as driver passes, pointed at this package: the metrics
registry of ``tidb_tpu_torch.utils.metrics`` against README.md, and
the failpoints of ``tidb_tpu_torch/`` against ``tests/test_torch_*.py``
(the port's failpoints are a registry of their own).

The sysvar pass is new: every ``tidb_*`` sysvar the engine reads
(``sysvars.get("tidb_...")``) must be registered in
``session/sysvars.py``; every registered ``tidb_*`` sysvar must be read
somewhere (a dead sysvar is a silent no-op knob — worse than an error)
and documented in README.md.
"""

from __future__ import annotations

import ast
import os
import re
import sys
from typing import Dict, List, Tuple

from tidb_tpu_torch.analysis.core import Pass, Project, Violation

__all__ = ["MetricsCoveragePass", "FailpointCoveragePass",
           "SysvarCoveragePass", "metrics_problems", "failpoint_scan",
           "plan_feedback_surfaces", "observability_surfaces",
           "elastic_surfaces"]


# ---------------------------------------------------------------------------
# plan-feedback surfaces
# ---------------------------------------------------------------------------

# every user-visible surface the plan-feedback layer must keep alive,
# as (repo-relative file, required marker). `python -m tidb_tpu_torch.analysis --json`
# reports the count so a refactor that silently drops one (renames the
# I_S table, loses the endpoint, un-registers the sysvar/metric) is a
# STATIC diff, caught before any runtime test notices.
_PLAN_FEEDBACK_SURFACES: Tuple[Tuple[str, str], ...] = (
    ("tidb_tpu_torch/storage/catalog.py", 'if name == "plan_feedback"'),
    ("tidb_tpu_torch/server/status.py", '"/plan_feedback"'),
    ("tidb_tpu_torch/utils/metrics.py", '"tidb_tpu_plan_est_drift"'),
    ("tidb_tpu_torch/session/sysvars.py", '"tidb_tpu_plan_feedback"'),
    ("tidb_tpu_torch/utils/execdetails.py", '"drift"'),
    ("tidb_tpu_torch/storage/catalog.py", '("worst_drift", FLOAT64)'),
)


def _surfaces_present(project: Project,
                      pairs: Tuple[Tuple[str, str], ...]
                      ) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    for rel, marker in pairs:
        path = os.path.join(project.root, rel)
        try:
            with open(path, encoding="utf-8") as f:
                src = f.read()
        except OSError:
            continue
        if marker in src:
            out.append((rel, marker))
    return out


def plan_feedback_surfaces(project: Project) -> List[Tuple[str, str]]:
    """The plan-feedback surfaces present in this tree: each registered
    (file, marker) pair whose marker still appears in the file's
    source. A full tree has all of them; the count is pinned tier-1."""
    return _surfaces_present(project, _PLAN_FEEDBACK_SURFACES)


# every user-visible surface of the observability plane
# (cluster metrics, resource profiles, latency SLOs), same contract as
# the plan-feedback list: a refactor that drops a surface is a static
# diff in `python -m tidb_tpu_torch.analysis --json` before any runtime test notices.
_OBSERVABILITY_SURFACES: Tuple[Tuple[str, str], ...] = (
    ("tidb_tpu_torch/storage/catalog.py", 'if name == "cluster_metrics"'),
    ("tidb_tpu_torch/storage/catalog.py", 'if name == "digest_latency"'),
    ("tidb_tpu_torch/server/status.py", 'scope=cluster'),
    ("tidb_tpu_torch/server/status.py", '"/slo"'),
    ("tidb_tpu_torch/parallel/dcn.py", '"metrics_snapshot"'),
    ("tidb_tpu_torch/utils/metrics.py", '"tidb_tpu_digest_p99_seconds"'),
    ("tidb_tpu_torch/utils/metrics.py", '"tidb_tpu_xfer_bytes_total"'),
    ("tidb_tpu_torch/utils/metrics.py", '"tidb_tpu_compile_seconds_total"'),
    ("tidb_tpu_torch/session/sysvars.py", '"tidb_tpu_slo_target_ms"'),
    ("tidb_tpu_torch/session/sysvars.py", '"tidb_tpu_sched_slo_shed"'),
    ("tidb_tpu_torch/serving/slo.py", "should_shed"),
    ("tidb_tpu_torch/storage/catalog.py", '("xfer_bytes", INT64)'),
)


def observability_surfaces(project: Project) -> List[Tuple[str, str]]:
    """The observability surfaces present in this tree (same
    marker contract as plan_feedback_surfaces)."""
    return _surfaces_present(project, _OBSERVABILITY_SURFACES)


# every user-visible surface of the elastic-topology plane
# (online reshard, membership lifecycle, recovery entry points, the
# cluster_info I_S table, metrics, gate sysvar), same contract as the
# two lists above: a refactor that drops one is a static diff in
# `python -m tidb_tpu_torch.analysis --json` before any runtime test notices.
_ELASTIC_SURFACES: Tuple[Tuple[str, str], ...] = (
    ("tidb_tpu_torch/parallel/dcn.py", "def reshard"),
    ("tidb_tpu_torch/parallel/dcn.py", "def recover_reshard"),
    ("tidb_tpu_torch/parallel/dcn.py", "def add_worker"),
    ("tidb_tpu_torch/parallel/dcn.py", "def remove_worker"),
    ("tidb_tpu_torch/parallel/dcn.py", "def reshard_progress_rows"),
    ("tidb_tpu_torch/parallel/membership.py", "CLUSTER_GATE"),
    ("tidb_tpu_torch/storage/catalog.py", 'if name == "cluster_info"'),
    ("tidb_tpu_torch/utils/metrics.py", '"tidb_tpu_reshard_shards_total"'),
    ("tidb_tpu_torch/utils/metrics.py", '"tidb_tpu_reshard_active"'),
    ("tidb_tpu_torch/utils/metrics.py", '"tidb_tpu_membership_total"'),
    ("tidb_tpu_torch/session/sysvars.py", '"tidb_tpu_reshard_gate_wait_ms"'),
)


def elastic_surfaces(project: Project) -> List[Tuple[str, str]]:
    """The elastic-topology surfaces present in this tree
    (same marker contract as plan_feedback_surfaces)."""
    return _surfaces_present(project, _ELASTIC_SURFACES)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def metrics_collect(root: str):
    """Import the metrics module from `root` and return (module,
    registered collectors)."""
    sys.path.insert(0, root)
    try:
        import importlib

        mod = importlib.import_module("tidb_tpu_torch.utils.metrics")
    finally:
        sys.path.pop(0)
    # metric registration is import-global: if tidb_tpu_torch was already
    # imported from a DIFFERENT checkout (this analyzer's own repo —
    # the shims import it at module load), a `--root` pointing
    # elsewhere would silently check the wrong repo's metrics against
    # the target's README. Refuse loudly instead.
    src = os.path.realpath(getattr(mod, "__file__", "") or "")
    want = os.path.realpath(os.path.join(root, "tidb_tpu_torch"))
    if not src.startswith(want + os.sep):
        raise RuntimeError(
            f"cannot check metrics for root {root!r}: tidb_tpu_torch is "
            f"already imported from {src} in this process. Run the "
            "checker from inside the target checkout instead.")
    with mod.REGISTRY.lock:
        metrics = list(mod.REGISTRY.metrics)
    return mod, metrics


def metrics_problems(root: str, readme_path: str
                     ) -> Tuple[List[str], List[str]]:
    """-> (problems, metric_names): every registered collector renders,
    carries help, is documented in README; duplicates are errors."""
    mod, metrics = metrics_collect(root)
    rendered = mod.render_prometheus()
    try:
        with open(readme_path, encoding="utf-8") as f:
            readme = f.read()
    except OSError as e:
        return [f"README unreadable: {e}"], []

    problems = []
    seen: Dict[str, object] = {}
    for m in metrics:
        if m.name in seen:
            problems.append(
                f"DUPLICATE metric name {m.name!r} (registered twice)")
        seen[m.name] = m
        if not (m.help or "").strip():
            problems.append(f"metric {m.name!r} has no help string")
        if f"# HELP {m.name} " not in rendered:
            problems.append(
                f"metric {m.name!r} missing from render_prometheus() output")
        if m.name not in readme:
            problems.append(
                f"ORPHAN metric {m.name!r}: not mentioned in README.md")
    return problems, sorted(seen)


class MetricsCoveragePass(Pass):
    id = "metrics-coverage"
    doc = ("every registered metric renders on /metrics, carries help, "
           "and is documented in README")

    def run(self, project: Project) -> List[Violation]:
        readme = os.path.join(project.root, "README.md")
        rel = os.path.join("tidb_tpu_torch", "utils", "metrics.py")
        try:
            problems, _names = metrics_problems(project.root, readme)
        except RuntimeError as e:
            # wrong-checkout refusal from metrics_collect: report it as
            # a violation so the pure-AST passes still render theirs
            return [Violation(self.id, rel, 1, str(e))]
        return [Violation(self.id, rel, 1, p) for p in problems]


# ---------------------------------------------------------------------------
# failpoints
# ---------------------------------------------------------------------------

_SITE_RE = re.compile(r"""\binject\(\s*(['"])([^'"]+)\1\s*\)""")
_SITE_DYN_RE = re.compile(r"""\binject\(\s*[^'")]""")
_ARM_RE = re.compile(r"""\b(?:failpoint|enable)\(\s*(['"])([^'"]+)\1""")

_SELF = {"failpoint.py", "check_failpoints.py"}


def _py_files(root: str, subdir: str) -> List[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(root, subdir)):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out.extend(os.path.join(dirpath, f) for f in filenames
                   if f.endswith(".py") and f not in _SELF)
    return sorted(out)


def failpoint_scan(root: str) -> Tuple[Dict[str, List[str]],
                                       Dict[str, List[str]], List[str]]:
    """-> (sites, armed, dynamic_sites): name -> ["file:line", ...].

    A site also counts as ARMED (covered) when its exact name appears
    as a string literal in any tests/test_torch_*.py — chaos grids arm
    failpoints through parametrized lists, so requiring the literal
    inside the failpoint() call itself would misreport every grid as
    uncovered.  The DEAD direction stays strict: only names inside
    literal failpoint()/enable() calls can be dead."""
    sites: Dict[str, List[str]] = {}
    armed: Dict[str, List[str]] = {}
    dynamic: List[str] = []
    for path in _py_files(root, "tidb_tpu_torch"):
        rel = os.path.relpath(path, root)
        with open(path, encoding="utf-8") as f:
            for ln, line in enumerate(f, 1):
                for m in _SITE_RE.finditer(line):
                    sites.setdefault(m.group(2), []).append(f"{rel}:{ln}")
                if _SITE_DYN_RE.search(line) and "def inject" not in line:
                    dynamic.append(f"{rel}:{ln}")
    test_blobs: List[Tuple[str, str]] = []
    for sub in ("tests", "tidb_tpu_torch"):
        for path in _py_files(root, sub):
            rel = os.path.relpath(path, root)
            if sub == "tests" and not os.path.basename(path).startswith(
                    "test_torch_"):
                continue  # the reference's tests arm its own registry
            with open(path, encoding="utf-8") as f:
                text = f.read()
            if sub == "tests":
                test_blobs.append((rel, text))
            for ln, line in enumerate(text.splitlines(), 1):
                for m in _ARM_RE.finditer(line):
                    armed.setdefault(m.group(2), []).append(f"{rel}:{ln}")
    for name in sites:
        if name in armed:
            continue
        for rel, text in test_blobs:
            if f'"{name}"' in text or f"'{name}'" in text:
                armed.setdefault(name, []).append(f"{rel} (mention)")
                break
    return sites, armed, dynamic


class FailpointCoveragePass(Pass):
    id = "failpoint-coverage"
    doc = ("no dead (siteless) armed failpoints, no non-literal inject() "
           "names")

    def run(self, project: Project) -> List[Violation]:
        sites, armed, dynamic = failpoint_scan(project.root)
        out: List[Violation] = []
        for name in sorted(set(armed) - set(sites)):
            for loc in armed[name]:
                path, _, line = loc.partition(":")
                out.append(Violation(
                    self.id, path, int(line.split()[0]) if line else 1,
                    f"DEAD failpoint {name!r}: armed here but no inject() "
                    "site exists (a refactor moved or renamed the call "
                    "site?)"))
        for loc in dynamic:
            path, _, line = loc.partition(":")
            out.append(Violation(
                self.id, path, int(line) if line else 1,
                "non-literal inject() name cannot be statically checked"))
        return out


# ---------------------------------------------------------------------------
# sysvars
# ---------------------------------------------------------------------------


class SysvarCoveragePass(Pass):
    id = "sysvar-coverage"
    doc = ("every tidb_* sysvar read is registered; every registered one "
           "is read somewhere and documented in README")

    SYSVARS_REL = os.path.join("tidb_tpu_torch", "session", "sysvars.py")

    def run(self, project: Project) -> List[Violation]:
        out: List[Violation] = []
        reg_path = os.path.join(project.root, self.SYSVARS_REL)
        registered: Dict[str, int] = {}
        if not os.path.exists(reg_path):
            return [Violation(self.id, self.SYSVARS_REL, 1,
                              "sysvar registry module not found")]
        sf = project.file(reg_path)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id == "SysVar" and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                registered[node.args[0].value] = node.lineno

        reads: Dict[str, List[Tuple[str, int]]] = {}
        for mod in project.files():
            for node in ast.walk(mod.tree):
                for name in self._read_names(node):
                    reads.setdefault(name, []).append((mod.rel, node.lineno))

        for name, sites in sorted(reads.items()):
            if not name.startswith("tidb_"):
                continue
            if name not in registered:
                rel, line = sites[0]
                out.append(Violation(
                    self.id, rel, line,
                    f"sysvar {name!r} is read here but not registered in "
                    "session/sysvars.py — SET/SHOW would reject it and the "
                    "read raises at runtime"))
        readme = ""
        readme_path = os.path.join(project.root, "README.md")
        if os.path.exists(readme_path):
            with open(readme_path, encoding="utf-8") as f:
                readme = f.read()
        for name, line in sorted(registered.items()):
            if not name.startswith("tidb_"):
                continue
            if name not in reads:
                out.append(Violation(
                    self.id, self.SYSVARS_REL, line,
                    f"dead sysvar {name!r}: registered but never read by "
                    "the engine — a silent no-op knob. Wire it or delete "
                    "it."))
            if name not in readme:
                out.append(Violation(
                    self.id, self.SYSVARS_REL, line,
                    f"sysvar {name!r} is not documented in README.md"))
        return out

    @staticmethod
    def _read_names(node: ast.AST) -> List[str]:
        """`<...>sysvars.get("name")` / `SYSVARS.get("name")` -> names,
        and the port's local read idiom `sv("name")` (``sv =
        self.sysvars.get`` bound once where a statement's context reads
        dozens of knobs). Conditional reads (`get("a" if x else "b")`)
        yield both arms."""
        if not (isinstance(node, ast.Call) and node.args):
            return []
        if isinstance(node.func, ast.Name):
            if node.func.id != "sv":
                return []
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr == "get":
            recv_txt = ast.unparse(node.func.value)
            if recv_txt != "SYSVARS" and not recv_txt.endswith("sysvars"):
                return []
        else:
            return []
        arg = node.args[0]
        arms = ([arg.body, arg.orelse] if isinstance(arg, ast.IfExp)
                else [arg])
        return [a.value for a in arms
                if isinstance(a, ast.Constant) and isinstance(a.value, str)]
