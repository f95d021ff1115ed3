"""jit-hygiene pass: what must be built once is never built per call.

The reference's rule (jax programs live at module level, so jax's trace
cache can hit) becomes, in eager torch, a rule about the few objects the
port builds that are expensive or stateful to make:

  * a kernel library: ``ctypes.CDLL`` / ``ctypes.cdll.LoadLibrary`` or
    an nvcc run anywhere but ``ops/nvcc_build.py``, whose per-process,
    per-source-hash cache (``load_library``) makes each library exactly
    once; ``torch.utils.cpp_extension.load``/``load_inline`` anywhere
    (a PyTorch-headers build takes minutes and bypasses that cache);
  * a captured or compiled program: ``torch.cuda.CUDAGraph``,
    ``torch.cuda.graph``, ``torch.jit.script``/``trace`` or
    ``torch.compile`` applied inside a function body gets a fresh
    identity per call (a recapture or recompile every time), and any
    value it closes over is frozen into the capture.

Module-level construction is fine (built once at import, values arrive
as arguments); the sanctioned escape for legitimately dynamic programs
is ``utils.jitcache.cached_jit`` with a suppression that states the key
discipline. The port has no such construction today: the pass guards
what comes next.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from tidb_tpu_torch.analysis.core import Pass, Project, SourceFile, Violation

__all__ = ["JitHygienePass"]

# the one module allowed to load kernel libraries and run nvcc
_BUILD_MODULE = "tidb_tpu_torch/ops/nvcc_build.py"
# capture/compile wrappers: per-call construction inside a function
_PROGRAM_WRAPPERS = {"torch.cuda.CUDAGraph", "torch.cuda.graph",
                     "torch.jit.script", "torch.jit.trace",
                     "torch.compile"}
_LIBRARY_LOADS = {"ctypes.CDLL", "ctypes.cdll.LoadLibrary", "CDLL"}
_EXTENSION_BUILDS = {"torch.utils.cpp_extension.load",
                     "torch.utils.cpp_extension.load_inline",
                     "cpp_extension.load", "cpp_extension.load_inline",
                     "load_inline"}


def _bound_names(fn: ast.AST) -> Set[str]:
    """Names bound inside a function scope (params + any assignment
    target + comprehension/for/with/except targets + local defs),
    NOT descending into nested function scopes (their bindings are
    their own)."""
    out: Set[str] = set()
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        a = fn.args
        for arg in (a.posonlyargs + a.args + a.kwonlyargs
                    + ([a.vararg] if a.vararg else [])
                    + ([a.kwarg] if a.kwarg else [])):
            out.add(arg.arg)

    def walk(node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
            return  # its body is a new scope
        if isinstance(node, ast.Lambda):
            return
        if isinstance(node, ast.ClassDef):
            out.add(node.name)
            return
        if isinstance(node, ast.Name) and isinstance(
                node.ctx, (ast.Store, ast.Del)):
            out.add(node.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out.add((alias.asname or alias.name).split(".")[0])
        elif isinstance(node, ast.ExceptHandler) and node.name:
            out.add(node.name)
        for child in ast.iter_child_nodes(node):
            walk(child)

    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        walk(stmt)
    return out


def _loaded_names(fn: ast.AST) -> Set[str]:
    """Names read inside a function INCLUDING nested scopes (a nested
    lambda reading an outer name still captures it)."""
    out: Set[str] = set()
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                out.add(node.id)
    return out


class JitHygienePass(Pass):
    id = "jit-hygiene"
    doc = ("kernel libraries load only through ops/nvcc_build.py's cache; "
           "no CUDA graph / torch.jit / torch.compile built per call")

    def run(self, project: Project) -> List[Violation]:
        out: List[Violation] = []
        for sf in project.files():
            out.extend(self._check_module(sf))
        seen = set()
        uniq = []
        for v in out:
            key = (v.path, v.line)
            if key not in seen:
                seen.add(key)
                uniq.append(v)
        return uniq

    # ------------------------------------------------------------------

    def _check_module(self, sf: SourceFile) -> List[Violation]:
        build_module = sf.rel.replace("\\", "/") == _BUILD_MODULE
        out: List[Violation] = []

        def visit(node: ast.AST, fn_stack: List[ast.AST]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    target = dec.func if isinstance(dec, ast.Call) else dec
                    if _dotted(target) in _PROGRAM_WRAPPERS and fn_stack:
                        out.append(self._violation(
                            sf, dec, node, fn_stack,
                            f"`{node.name}` is captured/compiled at "
                            "function scope (decorator)"))
                fn_stack = fn_stack + [node]
            elif isinstance(node, ast.Lambda):
                fn_stack = fn_stack + [node]
            elif isinstance(node, ast.Call):
                name = _dotted(node.func)
                if name in _PROGRAM_WRAPPERS and fn_stack:
                    target = self._wrapped_target(node, fn_stack[-1])
                    out.append(self._violation(
                        sf, node, target, fn_stack,
                        f"`{name}` built at function scope"))
                elif name in _LIBRARY_LOADS and not build_module:
                    out.append(Violation(
                        self.id, sf.rel, node.lineno,
                        f"kernel library loaded with `{name}` outside "
                        "ops/nvcc_build.py: a load per call (and a "
                        "second copy of the library) — go through "
                        "nvcc_build.load_library, whose cache builds "
                        "and loads each source version once"))
                elif name in _EXTENSION_BUILDS:
                    out.append(Violation(
                        self.id, sf.rel, node.lineno,
                        f"`{name}` builds against PyTorch's headers "
                        "(minutes per build) outside the port's build "
                        "cache — write the kernel with a plain C "
                        "interface and build it through ops/nvcc_build.py"))
                elif not build_module and _runs_nvcc(node):
                    out.append(Violation(
                        self.id, sf.rel, node.lineno,
                        "nvcc run outside ops/nvcc_build.py: a build per "
                        "call that bypasses the per-source-hash cache — "
                        "use nvcc_build.build_libraries/load_library"))
            for child in ast.iter_child_nodes(node):
                visit(child, fn_stack)

        visit(sf.tree, [])
        return out

    def _violation(self, sf: SourceFile, site: ast.AST,
                   target: Optional[ast.AST], fn_stack: List[ast.AST],
                   what: str) -> Violation:
        captured: List[str] = []
        if target is not None:
            enclosing_bound: Set[str] = set()
            for fn in fn_stack:
                enclosing_bound |= _bound_names(fn)
            free = _loaded_names(target) - _bound_names(target)
            captured = sorted(free & enclosing_bound)
        msg = (f"{what}: a fresh capture/compile per call, and any "
               "captured value is frozen into it")
        if captured:
            msg += f"; closes over {', '.join(captured)}"
        msg += (". Build it once at module level with the dynamic values "
                "as arguments, or route through a signature-keyed cache "
                "(utils.jitcache.cached_jit) and suppress with the key "
                "discipline as the reason.")
        return Violation(self.id, sf.rel, site.lineno, msg)

    @staticmethod
    def _wrapped_target(call: ast.Call,
                        scope: ast.AST) -> Optional[ast.AST]:
        """The function object being wrapped: a lambda argument, or the
        local def a Name argument points at."""
        if not call.args:
            return None
        arg = call.args[0]
        if isinstance(arg, ast.Lambda):
            return arg
        if isinstance(arg, ast.Name):
            body = scope.body if isinstance(scope.body, list) else []
            for stmt in body:
                for node in ast.walk(stmt):
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)) \
                            and node.name == arg.id:
                        return node
        return None


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _runs_nvcc(call: ast.Call) -> bool:
    """A subprocess call whose command names nvcc (a literal "nvcc" or a
    `nvcc_path()` call in its argument list)."""
    name = _dotted(call.func)
    if not name.startswith("subprocess.") and name not in (
            "Popen", "run", "check_call", "check_output"):
        return False
    for sub in ast.walk(call):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) \
                and sub.value.rsplit("/", 1)[-1] == "nvcc":
            return True
        if isinstance(sub, ast.Call) and _dotted(sub.func).endswith(
                "nvcc_path"):
            return True
    return False
