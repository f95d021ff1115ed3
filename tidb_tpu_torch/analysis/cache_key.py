"""cache-key-completeness pass: every value a cached device program is
built from must be named in its cache key.

The reference bug class this generalizes: ``hash_probe.set_mode`` wrote a
process global that jitted fragment builders read at TRACE time — a
value that shaped the compiled program but was missing from the
fragment-cache key, so a cache hit could serve a program traced for the
OTHER strategy (and concurrent sessions raced the global). The fix
threaded the mode through ``build_fn`` and into the key; this pass
makes that discipline machine-checked for every signature-keyed cache
site, so the class cannot come back through the next knob.

Registered cache sites:

  * ``cached_jit(ns, key, build, ...)`` (utils/jitcache.py) — the
    executor tier's signature-keyed jit cache;
  * ``<cache>.get_fragment(key, build)`` (parallel/executor.py
    ShardCache) — the collective-fragment cache.

Rule: every *free* name the traced body reads (the ``build`` callable's
closure surface — a lambda's body expression and its default-bound
params, or the local ``def`` a lambda returns) must be *covered* by the
key expression:

  * the name (or, for ``self.attr`` reads, the exact dotted path)
    appears in the key expression — including through local assignment
    chains (``sig = repr((a, b))`` covers ``a``/``b`` when ``sig`` is
    the key; ``key_fns = [compile(e) for e in items]`` is covered when
    ``items`` is); or
  * it is module-level / imported / builtin (static code identity).

Anything else is a violation: a Python value baked into the traced
program that a key collision can serve STALE. Sysvar reads inside a
traced body (``.sysvars.get(...)`` / ``session_info(...)``) are always
violations — a sysvar is a live knob and must be read outside the
trace and threaded through the key as an argument.

Cross-module mutable globals read by a module-level builder function
remain invisible to this (deliberately shallow) model — that residue is
exactly what the runtime sanitizer's shared-global-write witness and
the wire witness exist to catch.
"""

from __future__ import annotations

import ast
import builtins
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from tidb_tpu_torch.analysis.core import Pass, Project, SourceFile, Violation
from tidb_tpu_torch.analysis.jit_hygiene import _bound_names

__all__ = ["CacheKeyCompletenessPass"]

_BUILTINS = set(dir(builtins))


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a pure attribute chain rooted at a Name, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class _Tokens:
    """Name/dotted-path reads of one expression (or body)."""
    names: Set[str] = field(default_factory=set)
    dotted: Set[str] = field(default_factory=set)   # self.x / a.b paths

    def update_from(self, node: ast.AST) -> None:
        # comprehension targets are bound inside the expression — a
        # `[f(e) for e in items]` RHS reads `items`, not `e`
        comp_bound: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.comprehension):
                for t in ast.walk(sub.target):
                    if isinstance(t, ast.Name):
                        comp_bound.add(t.id)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) and \
                    isinstance(sub.ctx, ast.Load):
                path = _dotted(sub)
                if path is not None \
                        and path.split(".", 1)[0] not in comp_bound:
                    self.dotted.add(path)
            elif isinstance(sub, ast.Name) and \
                    isinstance(sub.ctx, ast.Load) \
                    and sub.id not in comp_bound:
                self.names.add(sub.id)


def _expr_tokens(node: ast.AST) -> _Tokens:
    t = _Tokens()
    t.update_from(node)
    return t


class _Scope:
    """The enclosing function's dataflow surface: module-level names,
    local assignments (name -> list of RHS token sets), local defs."""

    def __init__(self, sf: SourceFile, fn: ast.AST):
        self.sf = sf
        self.fn = fn
        self.module_names = self._module_names(sf.tree)
        self.assigns: Dict[str, List[_Tokens]] = {}
        self.local_defs: Dict[str, ast.FunctionDef] = {}
        self.imported: Set[str] = set()
        self._collect(fn)

    @staticmethod
    def _module_names(tree: ast.Module) -> Set[str]:
        out: Set[str] = set()
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                out.add(node.name)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for alias in node.names:
                    out.add((alias.asname or alias.name).split(".")[0])
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out.add(tgt.id)
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                out.add(node.target.id)
        return out

    def _collect(self, fn: ast.AST) -> None:
        def walk(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    self.local_defs[child.name] = child
                    continue  # its body is its own scope
                if isinstance(child, ast.ClassDef):
                    continue
                if isinstance(child, (ast.Import, ast.ImportFrom)):
                    for alias in child.names:
                        self.imported.add(
                            (alias.asname or alias.name).split(".")[0])
                elif isinstance(child, ast.Assign):
                    rhs = _expr_tokens(child.value)
                    for tgt in child.targets:
                        self._bind_target(tgt, rhs)
                elif isinstance(child, (ast.For, ast.AsyncFor)):
                    self._bind_target(child.target,
                                      _expr_tokens(child.iter))
                elif isinstance(child, ast.withitem) and \
                        child.optional_vars is not None:
                    self._bind_target(child.optional_vars,
                                      _expr_tokens(child.context_expr))
                walk(child)

        walk(fn)

    def _bind_target(self, tgt: ast.AST, rhs: _Tokens) -> None:
        if isinstance(tgt, ast.Name):
            self.assigns.setdefault(tgt.id, []).append(rhs)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._bind_target(el, rhs)


class CacheKeyCompletenessPass(Pass):
    id = "cache-key-completeness"
    doc = ("free variables and sysvars read inside cached_jit/"
           "get_fragment traced bodies must appear in the cache key "
           "(the hash_probe.set_mode race class, machine-checked)")

    def run(self, project: Project) -> List[Violation]:
        out: List[Violation] = []
        for sf in project.files():
            if "cached_jit" not in sf.text \
                    and "get_fragment" not in sf.text \
                    and "get_or_build" not in sf.text:
                continue
            out.extend(self._check_module(sf))
        return out

    # ------------------------------------------------------------------

    def _check_module(self, sf: SourceFile) -> List[Violation]:
        out: List[Violation] = []

        def visit(node: ast.AST, fn_stack: List[ast.AST]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn_stack = fn_stack + [node]
            for child in ast.iter_child_nodes(node):
                visit(child, fn_stack)
            if isinstance(node, ast.Call):
                site = self._site(node)
                if site is not None:
                    key_expr, build_expr = site
                    # module-level sites use the module as the scope:
                    # free names there are static identity, but a
                    # sysvar read in the traced body is still a live
                    # knob frozen at trace time
                    scope_fn = fn_stack[-1] if fn_stack else sf.tree
                    out.extend(self._check_site(
                        sf, node, key_expr, build_expr, scope_fn))

        visit(sf.tree, [])
        return out

    @staticmethod
    def _site(call: ast.Call) -> Optional[Tuple[ast.AST, ast.AST]]:
        f = call.func
        if isinstance(f, ast.Name) and f.id in ("cached_jit", "get_or_build") \
                and len(call.args) >= 3:
            return call.args[1], call.args[2]
        if isinstance(f, ast.Attribute) and f.attr == "cached_jit" \
                and len(call.args) >= 3:
            return call.args[1], call.args[2]
        if isinstance(f, ast.Attribute) and f.attr == "get_fragment" \
                and len(call.args) >= 2:
            return call.args[0], call.args[1]
        return None

    # ------------------------------------------------------------------

    def _check_site(self, sf: SourceFile, call: ast.Call,
                    key_expr: ast.AST, build_expr: ast.AST,
                    fn: ast.AST) -> List[Violation]:
        if isinstance(build_expr, ast.Name) and \
                isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and build_expr.id in {a.arg for a in fn.args.args
                                      + fn.args.kwonlyargs}:
            # a cache implementation handing its caller's builder on
            # (ShardCache.get_fragment over get_or_build): the callers
            # are the sites, and each is checked where it names its key
            return []
        scope = _Scope(sf, fn)
        key = self._expand_key(_expr_tokens(key_expr), scope)
        free = _Tokens()
        sysvar_reads: List[int] = []
        self._traced_reads(build_expr, scope, free, sysvar_reads,
                           depth=0)
        out: List[Violation] = []
        for line in sysvar_reads:
            out.append(Violation(
                self.id, sf.rel, line,
                "sysvar read inside a traced cache body: the value is "
                "frozen at trace time and a key collision serves it "
                "stale to every later statement — read it outside the "
                "program and thread it through the cache key as an "
                "argument (the hash_probe.set_mode fix shape)"))
        missing = sorted(
            n for n in free.names
            if n not in ("self", "cls")
            and not self._covered_name(n, key, scope, set()))
        missing += sorted(
            d for d in free.dotted
            if d.split(".", 1)[0] in ("self", "cls")
            and not self._covered_dotted(d, key, scope, set()))
        if missing:
            out.append(Violation(
                self.id, sf.rel, call.lineno,
                "cache key does not cover value(s) the traced body "
                f"closes over: {', '.join(missing)}. A key collision "
                "serves a program traced for OTHER values of these "
                "(the hash_probe.set_mode race class) — add them to "
                "the key expression, or suppress with the caller-side "
                "key discipline as the reason."))
        return out

    @staticmethod
    def _expand_key(key: _Tokens, scope: _Scope) -> _Tokens:
        """Close the key's token set over local assignment chains:
        `sig = repr((a, b)); cached_jit(ns, sig, ...)` names a and b in
        the key just as surely as writing the repr inline."""
        frontier = set(key.names)
        seen: Set[str] = set()
        while frontier:
            name = frontier.pop()
            if name in seen:
                continue
            seen.add(name)
            for rhs in scope.assigns.get(name, []):
                key.names |= rhs.names
                key.dotted |= rhs.dotted
                frontier |= rhs.names - seen
        return key

    # -- traced-body surface -----------------------------------------------

    def _traced_reads(self, build: ast.AST, scope: _Scope, free: _Tokens,
                      sysvars: List[int], depth: int) -> None:
        """Free reads of the build callable. A lambda contributes its
        body (minus its own params) plus its default expressions (they
        evaluate at definition time — closure-by-value); a Name
        resolving to a local def contributes that def's free reads."""
        if depth > 4:
            return
        if isinstance(build, ast.Lambda):
            body_free = self._def_free(build, scope)
            free.names |= body_free.names
            free.dotted |= body_free.dotted
            for d in build.args.defaults + [
                    x for x in build.args.kw_defaults if x is not None]:
                free.update_from(d)
            self._find_sysvars(build.body, sysvars)
            # `lambda: local_fn` / `lambda: make_x(a, b)`: a local def
            # the body names is part of the traced program — pull in
            # ITS free reads and discharge the def's own name (code
            # identity, not a value)
            for sub in ast.walk(build.body):
                if isinstance(sub, ast.Name) and \
                        sub.id in scope.local_defs:
                    free.names.discard(sub.id)
                    self._traced_reads(ast.Name(id=sub.id,
                                                ctx=ast.Load()),
                                       scope, free, sysvars, depth + 1)
            return
        if isinstance(build, ast.Name):
            fn = scope.local_defs.get(build.id)
            if fn is not None:
                body_free = self._def_free(fn, scope)
                free.names |= body_free.names
                free.dotted |= body_free.dotted
                self._find_sysvars(fn, sysvars)
            else:
                free.names.add(build.id)
            return
        # anything else (a call expression, an attribute): its reads
        # are the traced surface
        free.update_from(build)
        self._find_sysvars(build, sysvars)

    @staticmethod
    def _def_free(fn: ast.AST, scope: _Scope) -> _Tokens:
        # bound names of the def PLUS those of every nested function in
        # it: a nested lambda's params/locals are not free reads (but a
        # nested scope READING an outer name still surfaces it — token
        # collection walks everything)
        bound = set(_bound_names(fn))
        for sub in ast.walk(fn if isinstance(fn.body, list)
                            else fn.body):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                bound |= _bound_names(sub)
        t = _Tokens()
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            t.update_from(stmt)
        t.names = {n for n in t.names if n not in bound}
        t.dotted = {d for d in t.dotted
                    if d.split(".", 1)[0] not in bound}
        return t

    @staticmethod
    def _find_sysvars(node: ast.AST, out: List[int]) -> None:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            if isinstance(f, ast.Attribute) and f.attr == "get" \
                    and isinstance(f.value, ast.Attribute) \
                    and f.value.attr == "sysvars":
                out.append(sub.lineno)
            elif isinstance(f, ast.Name) and f.id == "sv":
                out.append(sub.lineno)  # the port's `sv = sysvars.get`
            elif (isinstance(f, ast.Name) and f.id == "session_info") \
                    or (isinstance(f, ast.Attribute)
                        and f.attr == "session_info"):
                out.append(sub.lineno)

    # -- coverage ------------------------------------------------------------

    def _covered_name(self, name: str, key: _Tokens, scope: _Scope,
                      seen: Set[str]) -> bool:
        if name in key.names:
            return True
        if name in scope.imported or name in scope.module_names \
                or name in _BUILTINS:
            return True
        if name in seen:
            return False
        seen = seen | {name}
        for rhs in scope.assigns.get(name, []):
            ok = all(self._covered_name(n, key, scope, seen)
                     for n in rhs.names if n not in ("self", "cls"))
            ok = ok and all(self._covered_dotted(d, key, scope, seen)
                            for d in rhs.dotted
                            if d.split(".", 1)[0] in ("self", "cls"))
            if ok and (rhs.names or rhs.dotted):
                return True
        return False

    def _covered_dotted(self, path: str, key: _Tokens, scope: _Scope,
                        seen: Set[str]) -> bool:
        """self/cls attribute reads need the EXACT dotted path in the
        key (a key mentioning self.a must not cover self.b); other
        bases fall back to base-name coverage."""
        if path in key.dotted:
            return True
        base = path.split(".", 1)[0]
        if base not in ("self", "cls"):
            return self._covered_name(base, key, scope, seen)
        return False
