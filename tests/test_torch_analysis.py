"""The port's invariant analyzer (tidb_tpu_torch/analysis/) on the CPU.

  * `python -m tidb_tpu_torch.analysis` runs clean over the port's tree:
    zero unsuppressed violations across every pass, each suppression
    with a reason, and the suppression and annotation counts pinned so
    drift shows in review;
  * each of the twelve checks (the eleven passes and the suppression
    hygiene) catches a bad case and accepts a reasoned suppression: the
    three passes retargeted to torch (host-sync, jit-hygiene,
    cache-key-completeness) on torch-shaped sources written here, the
    others on the reference's tests/analysis_fixtures/ read as text with
    the package name rewritten;
  * `--json` has the reference's report schema, `--changed` lints a
    diff, and importing the analyzer loads neither torch nor jax.
"""

import json
import os
import subprocess
import sys

import pytest

from test_torch_session import reference_witness_paused  # noqa: F401
from tidb_tpu_torch.analysis import Driver
from tidb_tpu_torch.analysis.blocking_under_lock import BlockingUnderLockPass
from tidb_tpu_torch.analysis.cache_key import CacheKeyCompletenessPass
from tidb_tpu_torch.analysis.core import AST_PASS_IDS, all_passes
from tidb_tpu_torch.analysis.error_shape import ErrorShapePass
from tidb_tpu_torch.analysis.host_sync import HostSyncPass, annotated_sites
from tidb_tpu_torch.analysis.jit_hygiene import JitHygienePass
from tidb_tpu_torch.analysis.lock_discipline import LockDisciplinePass
from tidb_tpu_torch.analysis.registry import (
    FailpointCoveragePass,
    SysvarCoveragePass,
)
from tidb_tpu_torch.analysis.resource_lifecycle import ResourceLifecyclePass
from tidb_tpu_torch.analysis.wire_protocol import ProtocolConformancePass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "analysis_fixtures")
PKG = "tidb_tpu_torch"

# the port's allowlist, counted (the reference's tree: 28 suppressions,
# 6 host-sync and 2 lifecycle annotations); the fourteenth is the CUDA
# graph capture in utils/jitcache.py, which its module doc sanctions; the
# sixth and seventh host-sync annotations are the mesh executors' gate
# fetches, moved out of the fragments' programs into their retry loops
SUPPRESSIONS = 14
HOST_SYNC_ANNOTATIONS = 7
LIFECYCLE_ANNOTATIONS = 2


def _fixture_text(name: str) -> str:
    """A reference fixture with the package name rewritten to the port's."""
    with open(os.path.join(FIXTURES, name), encoding="utf-8") as f:
        text = f.read()
    return (text.replace("tidb_tpu.", f"{PKG}.").replace("tidb_tpu/", f"{PKG}/")
            .replace("import jax\n", f"from {PKG}.utils import dispatch\n")
            .replace("jax.device_get", "dispatch.device_get"))


def _root(tmp_path, files=(), sysvars=None, readme="# nothing\n"):
    """A synthetic repo root: {relative path under the package: source};
    a mini sysvars.py and README are always present."""
    pkg = tmp_path / PKG
    (pkg / "session").mkdir(parents=True, exist_ok=True)
    (pkg / "session" / "sysvars.py").write_text(
        sysvars if sysvars is not None else "SYSVARS = {}\n")
    (tmp_path / "README.md").write_text(readme)
    for rel, text in dict(files).items():
        path = pkg / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return str(tmp_path)


def _run(root, p):
    """(the pass's report, the suppression-hygiene report)."""
    reports = {r.pass_id: r for r in Driver(root, [p]).run()}
    return reports[p.id], reports["suppressions"]


def _suppress(text: str, marker: str, directive: str) -> str:
    """Append `directive` as a trailing comment to the line holding
    `marker`."""
    lines = text.splitlines()
    i = next(i for i, ln in enumerate(lines) if marker in ln)
    lines[i] = f"{lines[i]}  # {directive}"
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def cli_json():
    """ONE subprocess run of the analyzer over the port's tree."""
    proc = subprocess.run([sys.executable, "-m", "tidb_tpu_torch.analysis", "--json"],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)
    return proc


@pytest.fixture(scope="module")
def tree_reports():
    """ONE in-process run of every pass over the port's tree."""
    return {r.pass_id: r for r in Driver(ROOT).run()}


# ---------------------------------------------------------------------------
# the real tree
# ---------------------------------------------------------------------------


class TestPortTree:
    def test_cli_exits_zero_with_no_violation(self, cli_json):
        assert cli_json.returncode == 0, cli_json.stdout[-4000:] + cli_json.stderr
        rep = json.loads(cli_json.stdout)
        assert rep["ok"] and rep["violation_count"] == 0

    def test_every_pass_runs_clean(self, tree_reports):
        assert {p.id for p in all_passes()} | {"suppressions"} == set(tree_reports)
        bad = [v.render() for r in tree_reports.values()
               for v in r.violations + r.problems]
        assert not bad, bad

    def test_allowlist_counts_are_pinned(self, cli_json, tree_reports):
        rep = json.loads(cli_json.stdout)
        assert rep["suppression_count"] == SUPPRESSIONS
        assert rep["host_sync_annotation_count"] == HOST_SYNC_ANNOTATIONS
        assert rep["lifecycle_annotation_count"] == LIFECYCLE_ANNOTATIONS
        assert sum(len(r.suppressed) for r in tree_reports.values()) == SUPPRESSIONS
        assert (rep["plan_feedback_surface_count"], rep["observability_surface_count"],
                rep["elastic_surface_count"]) == (6, 12, 11)

    def test_every_suppression_carries_a_reason(self, tree_reports):
        for r in tree_reports.values():
            for v, s in r.suppressed:
                assert len(s.reason) > 10, (v.render(), s.reason)

    def test_the_named_repairs_hold(self, tree_reports):
        """The account lock's spill is a reasoned suppression; the
        sysvars the port reads through `sv(...)` count as read; the
        stale annotations on mesh fragments are gone."""
        mem = [s for v, s in tree_reports["blocking-under-lock"].suppressed
               if v.path.endswith("utils/memory.py")]
        assert mem and "spill" in mem[0].reason
        assert not tree_reports["sysvar-coverage"].violations
        notes = {rel for rel, _l, _r in annotated_sites(Driver(ROOT).project)}
        assert not {f"{PKG}/parallel/distsql.py", f"{PKG}/parallel/fragment.py"} & notes

    def test_list_and_unknown_pass(self):
        out = subprocess.run([sys.executable, "-m", "tidb_tpu_torch.analysis", "--list"],
                             capture_output=True, text=True, cwd=ROOT, timeout=120)
        assert out.returncode == 0
        assert all(p.id in out.stdout for p in all_passes())
        bad = subprocess.run([sys.executable, "-m", "tidb_tpu_torch.analysis",
                              "--pass", "no-such-pass"],
                             capture_output=True, text=True, cwd=ROOT, timeout=120)
        assert bad.returncode == 2 and "unknown pass" in bad.stdout


class TestLightImport:
    def test_importing_the_analyzer_loads_neither_torch_nor_jax(self):
        code = ("import sys, tidb_tpu_torch.analysis, tidb_tpu_torch.analysis.sanitizer, "
                "tidb_tpu_torch.analysis.core; all_ = tidb_tpu_torch.analysis.all_passes(); "
                "print('torch' in sys.modules, 'jax' in sys.modules, 'tidb_tpu' in sys.modules)")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             cwd=ROOT, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["False", "False", "False"]


class TestJsonAndChanged:
    def test_json_schema_matches_the_reference(self, tmp_path, cli_json):
        from tidb_tpu.analysis.core import Driver as RefDriver
        from tidb_tpu.analysis.error_shape import ErrorShapePass as RefErrorShape

        ref_driver = RefDriver(ROOT, [RefErrorShape()])
        ref = json.loads(json.dumps(ref_driver.to_json(ref_driver.run())))
        port = json.loads(cli_json.stdout)
        assert set(port) == set(ref)
        assert port["schema"] == ref["schema"]
        assert set(port["passes"][0]) == set(ref["passes"][0])
        viol = {"pass", "path", "line", "message"}
        sup = {"pass", "path", "line", "reason"}
        for p in port["passes"]:
            assert all(set(v) == viol for v in p["violations"] + p["problems"])
            assert all(set(s) == sup for s in p["suppressed"])

    def test_changed_mode_lints_only_the_diff(self, tmp_path):
        root = _root(tmp_path, {
            "executor/bad.py": "def f(h):\n    try:\n        h()\n    except:\n        pass\n",
            "executor/ok.py": "A = 1\n"})
        run = subprocess.run(
            [sys.executable, "-m", "tidb_tpu_torch.analysis", "--root", root, "--json",
             "--changed", f"{PKG}/executor/ok.py"],
            capture_output=True, text=True, cwd=ROOT, timeout=120)
        rep = json.loads(run.stdout)
        assert run.returncode == 0 and rep["violation_count"] == 0
        assert {p["id"] for p in rep["passes"]} == set(AST_PASS_IDS) | {"suppressions"}
        run = subprocess.run(
            [sys.executable, "-m", "tidb_tpu_torch.analysis", "--root", root, "--json",
             "--changed", f"{PKG}/executor/bad.py"],
            capture_output=True, text=True, cwd=ROOT, timeout=120)
        rep = json.loads(run.stdout)
        assert run.returncode == 1
        assert any(v["path"] == f"{PKG}/executor/bad.py"
                   for p in rep["passes"] for v in p["violations"])


# ---------------------------------------------------------------------------
# the three passes retargeted to torch: torch-shaped sources
# ---------------------------------------------------------------------------

HOST_SYNC_BAD = """\
import torch

from tidb_tpu_torch.utils.dispatch import device_get


def finalize(ch, dev):
    x = torch.arange(10, device=dev)
    n = int(x.sum())
    m = x.max().item()
    if x.any():
        n += 1
    y = x.cpu()
    z = torch.ones(3, device=dev).tolist()
    torch.cuda.synchronize()
    for c in ch:
        device_get(c)
    return n, m, y, z


def clean(ch, dev):
    h = torch.zeros(3).numpy()
    x = torch.arange(10, device=dev)
    k = x.shape[0] + x.numel()
    if x is not None and x.dtype == torch.int64:
        k += 1
    return h, k, device_get(x)
"""


class TestHostSync:
    def test_each_torch_sync_kind_is_flagged(self, tmp_path):
        root = _root(tmp_path, {"executor/x.py": HOST_SYNC_BAD})
        rep, hygiene = _run(root, HostSyncPass())
        got = sorted(v.line for v in rep.violations)
        lines = HOST_SYNC_BAD.splitlines()
        want = [i for i, ln in enumerate(lines, 1)
                if any(k in ln for k in ("int(x.sum())", ".item()", "if x.any()", "x.cpu()",
                                         ".tolist()", "synchronize()", "device_get(c)"))]
        assert got == want, [v.render() for v in rep.violations]
        assert any("per-iteration device fetch" in v.message for v in rep.violations)
        assert not hygiene.problems

    def test_out_of_scope_directory_is_ignored(self, tmp_path):
        root = _root(tmp_path, {"planner/x.py": HOST_SYNC_BAD})
        rep, _ = _run(root, HostSyncPass())
        assert not rep.violations

    def test_reasoned_annotation_and_suppression_are_accepted(self, tmp_path):
        text = _suppress(HOST_SYNC_BAD, "m = x.max().item()",
                         "host-sync: the finalize reads one scalar, once")
        text = _suppress(text, "int(x.sum())",
                         "lint: disable=host-sync -- a fixture's counted sync")
        root = _root(tmp_path, {"executor/x.py": text})
        rep, hygiene = _run(root, HostSyncPass())
        assert len(rep.violations) == 5
        assert len(rep.suppressed) == 1 and not hygiene.problems
        from tidb_tpu_torch.analysis.core import Project

        sites = annotated_sites(Project(root))
        assert [r for _p, _l, r in sites] == ["the finalize reads one scalar, once"]

    def test_stale_annotation_is_flagged(self, tmp_path):
        root = _root(tmp_path, {"executor/x.py":
                                "def f(a):\n    return a + 1  # host-sync: was a sync\n"})
        rep, _ = _run(root, HostSyncPass())
        assert any("stale host-sync annotation" in v.message for v in rep.violations)


JIT_BAD = """\
import ctypes
import subprocess

import torch

GRAPHED = torch.compile(lambda x: x + 1)


def per_call(x, scale):
    lib = ctypes.CDLL("libthing.so")
    fn = torch.compile(lambda y: y * scale)
    g = torch.cuda.CUDAGraph()
    ext = torch.utils.cpp_extension.load(name="k", sources=["k.cu"])
    subprocess.run(["nvcc", "-o", "k.so", "k.cu"], check=True)
    return lib, fn(x), g, ext
"""


class TestJitHygiene:
    def test_per_call_builds_are_flagged(self, tmp_path):
        root = _root(tmp_path, {"executor/x.py": JIT_BAD})
        rep, _ = _run(root, JitHygienePass())
        msgs = [v.message for v in rep.violations]
        assert len(msgs) == 5, msgs
        assert any("ctypes.CDLL" in m for m in msgs)
        assert any("torch.compile" in m and "scale" in m for m in msgs)
        assert any("CUDAGraph" in m for m in msgs)
        assert any("cpp_extension" in m for m in msgs)
        assert any("nvcc run" in m for m in msgs)

    def test_the_build_module_may_load_libraries(self, tmp_path):
        root = _root(tmp_path, {"ops/nvcc_build.py": (
            "import ctypes\nimport subprocess\n\n\ndef load(p):\n"
            "    subprocess.run(['nvcc', p], check=True)\n    return ctypes.CDLL(p)\n")})
        rep, _ = _run(root, JitHygienePass())
        assert not rep.violations, [v.render() for v in rep.violations]

    def test_reasoned_suppression_is_accepted(self, tmp_path):
        text = _suppress(JIT_BAD, 'ctypes.CDLL("libthing.so")',
                         "lint: disable=jit-hygiene -- loaded once behind a module cache")
        root = _root(tmp_path, {"executor/x.py": text})
        rep, hygiene = _run(root, JitHygienePass())
        assert len(rep.violations) == 4 and len(rep.suppressed) == 1
        assert not hygiene.problems


CACHE_BAD = """\
from tidb_tpu_torch.utils.jitcache import cached_jit
from tidb_tpu_torch.utils.lru import get_or_build


def compile_expr(e, mode=None):
    return lambda ch: ch


class Exec:
    def open_bad(self, exprs, mode):
        self._fn = cached_jit("ns", repr(exprs), lambda: compile_expr(exprs, mode))

    def open_bad_sysvar(self, exprs):
        sv = self.sysvars.get

        def build():
            return compile_expr(exprs, sv("tidb_tpu_join_probe_mode"))

        self._fn = cached_jit("ns", repr(exprs), build)

    def open_bad_lru(self, od, exprs):
        return get_or_build(od, repr(exprs), lambda: compile_expr(exprs, self._mode), 8)

    def open_clean(self, exprs, mode):
        self._fn = cached_jit("ns", repr((exprs, mode)), lambda: compile_expr(exprs, mode))
"""


class TestCacheKey:
    def test_uncovered_values_and_sysvar_reads_are_flagged(self, tmp_path):
        root = _root(tmp_path, {"executor/x.py": CACHE_BAD})
        rep, _ = _run(root, CacheKeyCompletenessPass())
        msgs = [v.message for v in rep.violations]
        assert len(msgs) == 4, msgs
        assert any("does not cover" in m and ": mode." in m for m in msgs)
        # the port's `sv = self.sysvars.get` read: the knob read and the
        # uncovered reader
        assert any("sysvar read inside a traced cache body" in m for m in msgs)
        assert any("does not cover" in m and ": sv." in m for m in msgs)
        assert any("self._mode" in m for m in msgs)
        clean = CACHE_BAD.splitlines().index("    def open_clean(self, exprs, mode):") + 1
        assert all(v.line < clean for v in rep.violations)

    def test_reasoned_suppression_is_accepted(self, tmp_path):
        text = _suppress(CACHE_BAD, "lambda: compile_expr(exprs, mode))\n".strip(),
                         "lint: disable=cache-key-completeness -- mode is fixed per process")
        root = _root(tmp_path, {"executor/x.py": text})
        rep, hygiene = _run(root, CacheKeyCompletenessPass())
        assert len(rep.violations) == 3 and len(rep.suppressed) == 1
        assert not hygiene.problems


# ---------------------------------------------------------------------------
# the other passes: the reference's fixtures, package name rewritten
# ---------------------------------------------------------------------------


class TestReferenceFixtures:
    def test_lock_discipline(self, tmp_path):
        text = _fixture_text("bad_lock_cycle.py")
        root = _root(tmp_path, {"parallel/bad_lock_cycle.py": text})
        p = LockDisciplinePass(modules=(f"{PKG}/parallel/bad_lock_cycle.py",))
        rep, _ = _run(root, p)
        assert any("cycle" in v.message for v in rep.violations), rep.violations
        line = rep.violations[0].line
        lines = text.splitlines()
        lines[line - 1] += "  # lint: disable=lock-discipline -- a fixture's deliberate order"
        root2 = _root(tmp_path / "s", {"parallel/bad_lock_cycle.py": "\n".join(lines) + "\n"})
        rep2, hygiene = _run(root2, p)
        assert len(rep2.suppressed) == 1 and not hygiene.problems
        assert len(rep2.violations) == len(rep.violations) - 1

    def test_blocking_under_lock(self, tmp_path):
        text = _fixture_text("bad_blocking_lock.py")
        root = _root(tmp_path, {"executor/bad_blocking_lock.py": text})
        p = BlockingUnderLockPass(modules=(f"{PKG}/executor/bad_blocking_lock.py",))
        rep, _ = _run(root, p)
        msgs = [v.render() for v in rep.violations]
        assert len(msgs) == 2, msgs
        assert any("device fetch" in m for m in msgs) and any("re-enters spill" in m
                                                              for m in msgs)
        text = _suppress(text, "tracker.consume(nbytes)        # BAD",
                         "lint: disable=blocking-under-lock -- a fixture's bounded charge")
        root = _root(tmp_path / "s", {"executor/bad_blocking_lock.py": text})
        rep, hygiene = _run(root, p)
        assert len(rep.violations) == 1 and len(rep.suppressed) == 1
        assert not hygiene.problems

    def test_resource_lifecycle(self, tmp_path):
        text = _fixture_text("bad_resource_leak.py")
        root = _root(tmp_path, {"executor/bad_resource_leak.py": text})
        rep, _ = _run(root, ResourceLifecyclePass())
        assert len(rep.violations) == 3, [v.render() for v in rep.violations]
        consume = next(v for v in rep.violations if "no matching release" in v.message)
        lines = text.splitlines()
        lines[consume.line - 1] += ("  # lint: disable=resource-lifecycle -- "
                                    "released by the fixture's caller")
        root = _root(tmp_path / "s", {"executor/bad_resource_leak.py": "\n".join(lines) + "\n"})
        rep, hygiene = _run(root, ResourceLifecyclePass())
        assert len(rep.violations) == 2 and len(rep.suppressed) == 1
        assert not hygiene.problems

    def test_error_shape(self, tmp_path):
        root = _root(tmp_path, {"server/bad_except.py": _fixture_text("bad_except.py"),
                                "errors.py": _fixture_text("bad_error_code.py")})
        rep, _ = _run(root, ErrorShapePass())
        msgs = [v.message for v in rep.violations]
        assert any("bare" in m for m in msgs) and any("swallows" in m for m in msgs)
        assert any("CodelessError" in m for m in msgs)
        assert not any("GoodError" in m for m in msgs)
        text = _fixture_text("bad_except.py")
        bare = next(v for v in rep.violations if "bare" in v.message
                    and v.path.endswith("bad_except.py"))
        lines = text.splitlines()
        lines[bare.line - 1] += "  # lint: disable=error-shape -- a fixture's re-raising catch"
        root = _root(tmp_path / "s", {"server/bad_except.py": "\n".join(lines) + "\n"})
        rep, hygiene = _run(root, ErrorShapePass())
        assert len(rep.suppressed) == 1 and not hygiene.problems

    def test_sysvar_coverage(self, tmp_path):
        sysvars = ("SYSVARS = {}\n\n\nclass SysVar:\n    def __init__(self, name, d):\n"
                   "        self.name = name\n\n\n_L = [\n    SysVar('tidb_dead_knob', True),\n"
                   "    SysVar('tidb_sv_knob', 1),\n]\n")
        reader = "def f(self):\n    sv = self.sysvars.get\n    return sv('tidb_sv_knob')\n"
        root = _root(tmp_path, {"session2/bad_sysvar.py": _fixture_text("bad_sysvar.py"),
                                "executor/reader.py": reader},
                     sysvars=sysvars, readme="tidb_sv_knob\n")
        rep, _ = _run(root, SysvarCoveragePass())
        msgs = [v.message for v in rep.violations]
        assert any("tidb_ghost_knob" in m and "not registered" in m for m in msgs), msgs
        assert any("dead sysvar 'tidb_dead_knob'" in m for m in msgs), msgs
        assert not any("tidb_sv_knob" in m for m in msgs), msgs  # read via sv(...)
        sup = sysvars.replace("    SysVar('tidb_dead_knob', True),",
                              "    SysVar('tidb_dead_knob', True),  # lint: disable="
                              "sysvar-coverage -- kept for a fixture's clients")
        root = _root(tmp_path / "s", {"executor/reader.py": reader}, sysvars=sup,
                     readme="tidb_sv_knob\n")
        rep, hygiene = _run(root, SysvarCoveragePass())
        assert not rep.violations and len(rep.suppressed) == 2
        assert not hygiene.problems

    def test_protocol_conformance(self, tmp_path):
        text = _fixture_text("bad_wire_protocol.py")
        rel = f"{PKG}/parallel/bad_wire_protocol.py"
        p = ProtocolConformancePass(modules=(rel,), model_path=None, doc_path=None)
        root = _root(tmp_path, {"parallel/bad_wire_protocol.py": text})
        rep, _ = _run(root, p)
        assert len(rep.violations) == 6, [v.render() for v in rep.violations]
        arm = next(v for v in rep.violations if "dead arm" in v.message)
        lines = text.splitlines()
        lines[arm.line - 1] += ("  # lint: disable=protocol-conformance -- "
                                "a health arm dialed raw by operators")
        root = _root(tmp_path / "s", {"parallel/bad_wire_protocol.py": "\n".join(lines) + "\n"})
        rep, hygiene = _run(root, p)
        assert len(rep.violations) == 5 and len(rep.suppressed) == 1
        assert not hygiene.problems

    def test_failpoint_coverage(self, tmp_path):
        # the arm is spelled in two pieces: this file is itself scanned
        # for arms of the port's failpoints
        arm = "fail" + "point('ghost.site')"
        src = ("from tidb_tpu_torch.utils.failpoint import inject, failpoint\n\n\n"
               "def f(name):\n    inject('real.site')\n    inject(name)\n\n\n"
               f"def arm():\n    return {arm}\n")
        root = _root(tmp_path, {"executor/fp.py": src})
        rep, _ = _run(root, FailpointCoveragePass())
        msgs = [v.message for v in rep.violations]
        assert any("DEAD failpoint 'ghost.site'" in m for m in msgs), msgs
        assert any("non-literal inject()" in m for m in msgs), msgs
        sup = src.replace("    inject(name)\n", "    inject(name)  # lint: disable="
                          "failpoint-coverage -- the name is a checked constant\n")
        sup = sup.replace(f"return {arm}", f"return {arm}"
                          "  # lint: disable=failpoint-coverage -- armed for a plugin's site")
        root = _root(tmp_path / "s", {"executor/fp.py": sup})
        rep, hygiene = _run(root, FailpointCoveragePass())
        assert not rep.violations and len(rep.suppressed) == 2
        assert not hygiene.problems

    def test_metrics_coverage(self, tmp_path):
        """The metrics pass imports the tree's metrics module, so it runs
        in a process of its own over a mini package."""
        import shutil

        pkg = tmp_path / PKG
        (pkg / "utils").mkdir(parents=True)
        (pkg / "session").mkdir()
        (pkg / "__init__.py").write_text("")
        (pkg / "utils" / "__init__.py").write_text("")
        (pkg / "session" / "sysvars.py").write_text("SYSVARS = {}\n")
        shutil.copytree(os.path.join(ROOT, PKG, "analysis"), pkg / "analysis",
                        ignore=shutil.ignore_patterns("__pycache__"))
        metrics = ("import threading\n\n\nclass M:\n    def __init__(self, name, help):\n"
                   "        self.name, self.help = name, help\n\n\nclass R:\n"
                   "    def __init__(self):\n        self.lock = threading.Lock()\n"
                   "        self.metrics = [M('tidb_fake_total', '')]\n\n\n"
                   "REGISTRY = R()\n\n\ndef render_prometheus():\n    return ''\n")
        (pkg / "utils" / "metrics.py").write_text(metrics)
        (tmp_path / "README.md").write_text("nothing\n")

        def run():
            out = subprocess.run(
                [sys.executable, "-m", "tidb_tpu_torch.analysis", "--root", str(tmp_path),
                 "--pass", "metrics-coverage", "--json"],
                capture_output=True, text=True, cwd=str(tmp_path), timeout=120,
                env=dict(os.environ, PYTHONPATH=str(tmp_path)))
            return out.returncode, json.loads(out.stdout)

        rc, rep = run()
        msgs = [v["message"] for p in rep["passes"] for v in p["violations"]]
        assert rc == 1
        assert any("no help string" in m for m in msgs), msgs
        assert any("ORPHAN metric 'tidb_fake_total'" in m for m in msgs), msgs
        (pkg / "utils" / "metrics.py").write_text(
            "# lint: module-disable=metrics-coverage -- a fixture registry\n" + metrics)
        rc, rep = run()
        assert rc == 0 and rep["suppression_count"] >= 1

    def test_suppression_hygiene(self, tmp_path):
        """The twelfth check: a directive with no reason, an unknown pass
        and a stale line directive are violations; a reasoned one that
        suppresses something is not."""
        src = ("def f(h):\n"
               "    try:\n        h()\n"
               "    except:  # lint: disable=error-shape\n        pass\n"
               "    A = 1  # lint: disable=error-shape -- the covered code is gone\n"
               "    B = 2  # lint: disable=no-such-pass -- typo'd pass\n"
               "    return A + B\n")
        root = _root(tmp_path, {"server/x.py": src})
        rep, hygiene = _run(root, ErrorShapePass())
        msgs = [v.message for v in hygiene.problems]
        assert any("without a reason" in m for m in msgs), msgs
        assert any("stale suppression" in m for m in msgs), msgs
        assert any("unknown pass 'no-such-pass'" in m for m in msgs), msgs
        ok = src.replace("# lint: disable=error-shape\n",
                         "# lint: disable=error-shape -- re-raised by the caller\n")
        ok = ok.replace("    A = 1  # lint: disable=error-shape -- the covered code is gone\n",
                        "    A = 1\n")
        ok = ok.replace("    B = 2  # lint: disable=no-such-pass -- typo'd pass\n",
                        "    B = 2\n")
        root = _root(tmp_path / "s", {"server/x.py": ok})
        rep, hygiene = _run(root, ErrorShapePass())
        assert len(rep.suppressed) == 1 and not hygiene.problems
