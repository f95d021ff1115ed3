"""host-sync pass: no silent device→host syncs on the execution tiers.

Every ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``, every
``int()`` / ``float()`` / ``bool()`` and every ``if`` applied to a
device tensor, and every ``torch.cuda.synchronize()``, blocks the host
on the card.  The executor operators run once per chunk and the
fragment runners once per dispatch, so ANY such sync in
``executor/``/``ops/``/``parallel/``/``serving/``/``columnar/`` is a
per-chunk round trip.  An *intentional* sync must be visible and
justified: route it through the sanctioned fetch
(``utils.dispatch.device_get``, which the runtime sanitizer counts), or
annotate the line with ``# host-sync: <reason>`` and it is allowlisted,
counted, and surfaced in the report.

Device-ness is a forward dataflow within each function (no fixpoint):

  seeds       calls on ``torch.*`` (a creation function — ``zeros``,
              ``arange``, ``tensor``, ... — only with a ``device=``
              argument or a device-valued argument; the host-result
              helpers ``torch.device``/``iinfo``/``is_tensor``/
              ``from_numpy``/``torch.cuda.*`` never), the tensor
              methods that move a value onto a device (``.to(...)``,
              ``.cuda()``), calls of names imported from
              ``tidb_tpu_torch.ops.*`` /
              ``tidb_tpu_torch.expression.compiler`` (the device-kernel
              modules), and calls of locals bound from those programs'
              builders (``compile_expr`` / ``compile_predicate`` /
              ``cached_jit`` / ``get_fragment``: a mesh fragment is one
              program whose overflow gates come back on the device, for
              its caller to fetch after it)
  propagates  through attributes, subscripts, arithmetic, tuples,
              method calls on a device value, and (tuple-)assignment
  launders    through the sync calls themselves (their result is host)

Host-tier numpy code (spill loaders, drained chunks) stays untainted by
design — the pass guards the *device-result* sync class.
``device_get`` is the sanctioned explicit fetch: it moves a tensor or a
container of tensors in ONE copy and its result is host numpy.

Chunk-loop sync budget: even the sanctioned fetch is a device→host
round trip, and one PER CHUNK-LOOP ITERATION re-creates exactly the
ping-pong the pipelined executor exists to remove.  A ``device_get``
lexically inside a ``for``/``while`` loop therefore requires its own
``# host-sync: <reason>`` annotation — the loop sync must be *batched*
(one fetch per window), hoisted to finalize, or visibly justified.
"""

from __future__ import annotations

import ast
from typing import List, Set, Tuple

from tidb_tpu_torch.analysis.core import Pass, Project, SourceFile, Violation

__all__ = ["HostSyncPass", "annotated_sites"]

_SYNC_BUILTINS = {"int", "float", "bool"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_DEVICE_MODULE_PREFIXES = ("tidb_tpu_torch.ops",
                           "tidb_tpu_torch.expression.compiler")
_JIT_BUILDER_NAMES = {"cached_jit", "compile_expr", "compile_predicate", "get_fragment"}
# torch.* calls whose result lives on the host (or is no tensor at all)
_TORCH_HOST = {"device", "dtype", "iinfo", "finfo", "is_tensor",
               "is_floating_point", "from_numpy", "get_num_threads",
               "set_num_threads", "manual_seed", "Generator", "Size",
               "no_grad", "inference_mode", "promote_types",
               "result_type", "can_cast", "get_default_dtype",
               "Tensor", "as_strided", "set_grad_enabled"}
# kernel-module helpers that compute on Python ints (shape buckets,
# route names), not on device values
_HOST_RESULT_FNS = {"shape_bucket", "resolve_mode"}
# tensor metadata: reading it never waits for the device
_TENSOR_META = {"shape", "dtype", "device", "is_cuda", "ndim"}
_TENSOR_META_CALLS = {"dim", "numel", "size", "element_size", "data_ptr",
                      "is_contiguous", "stride", "storage_offset",
                      "get_device", "nbytes"}
# creation functions: on a device only when told so (device=) or when
# built from a device value
_TORCH_CREATE = {"zeros", "ones", "empty", "full", "arange", "tensor",
                 "as_tensor", "linspace", "eye", "rand", "randn",
                 "randint", "randperm", "zeros_like", "ones_like",
                 "empty_like", "full_like"}


def _module_device_names(tree: ast.Module) -> Tuple[Set[str], Set[str]]:
    """-> (device_fn_names, device_module_aliases) for one module."""
    fns: Set[str] = set()
    mods: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            from_device = node.module.startswith(_DEVICE_MODULE_PREFIXES)
            for alias in node.names:
                full = f"{node.module}.{alias.name}"
                if from_device:
                    # `from tidb_tpu_torch.ops import join_kernels as jk`
                    # imports a MODULE; a plain name import is a kernel fn
                    if full.startswith(_DEVICE_MODULE_PREFIXES) and \
                            "." not in alias.name and \
                            node.module in ("tidb_tpu_torch.ops",):
                        mods.add(alias.asname or alias.name)
                    else:
                        fns.add(alias.asname or alias.name)
                elif full.startswith(_DEVICE_MODULE_PREFIXES):
                    mods.add(alias.asname or alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.startswith(_DEVICE_MODULE_PREFIXES):
                    mods.add(alias.asname or alias.name.split(".")[0])
    return fns, mods


class _FnScan:
    """Forward taint over one function body."""

    def __init__(self, sf: SourceFile, fn: ast.AST,
                 device_fns: Set[str], device_mods: Set[str]):
        self.sf = sf
        self.fn = fn
        self.device_fns = device_fns
        self.device_mods = device_mods
        self.tainted: Set[str] = set()
        self.local_device_fns: Set[str] = set()
        self.hits: List[Tuple[int, str, str]] = []  # (line, kind, detail)
        self._loop_depth = 0  # chunk-loop sync budget (device_get-in-loop)

    # -- expression taint ------------------------------------------------

    def _root_name(self, node: ast.AST) -> str:
        while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
            node = node.func if isinstance(node, ast.Call) else node.value
        return node.id if isinstance(node, ast.Name) else ""

    def _is_device_call(self, call: ast.Call) -> bool:
        f = call.func
        if isinstance(f, ast.Attribute):
            root = self._root_name(f)
            if root in self.device_mods:
                return f.attr not in _HOST_RESULT_FNS
            if root == "torch":
                txt = ast.unparse(f)
                if txt.startswith("torch.cuda.") or txt.count(".") > 1 \
                        and not txt.startswith(("torch.nn.functional.",
                                                "torch.special.",
                                                "torch.linalg.")):
                    return False  # torch.cuda.* / torch.backends.* ...
                if f.attr in _TORCH_HOST:
                    return False
                if f.attr in _TORCH_CREATE:
                    return self._placed(call)
                return True
            if f.attr in ("to", "cuda"):
                return self._placed(call) or f.attr == "cuda"
        if isinstance(f, ast.Name):
            if f.id in self.device_fns or f.id in self.local_device_fns:
                return True
        return False

    def _placed(self, call: ast.Call) -> bool:
        """A creation / `.to()` call that lands on a device: a
        `device=` argument other than the literal "cpu", or a
        device-valued argument."""
        for kw in call.keywords:
            if kw.arg == "device":
                v = kw.value
                return not (isinstance(v, ast.Constant) and v.value == "cpu")
            if kw.value is not None and self.taint(kw.value):
                return True
        if isinstance(call.func, ast.Attribute) and \
                call.func.attr == "to" and call.args:
            a = call.args[0]
            if isinstance(a, ast.Constant):
                return a.value != "cpu"
            if isinstance(a, ast.Attribute) and a.attr.startswith(
                    ("int", "float", "bool", "uint")):
                return False  # .to(torch.int64): a dtype, same device
            return True
        return any(self.taint(a) for a in call.args)

    def _is_jit_builder_call(self, call: ast.Call) -> bool:
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr in _JIT_BUILDER_NAMES:
            return True
        return isinstance(f, ast.Name) and f.id in _JIT_BUILDER_NAMES

    def _is_device_get(self, call: ast.Call) -> bool:
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr == "device_get":
            return True
        return isinstance(f, ast.Name) and f.id == "device_get"

    def _sync_kind(self, call: ast.Call) -> str:
        """'' or the sync-op name when `call` is a sync operation."""
        f = call.func
        if isinstance(f, ast.Name) and f.id in _SYNC_BUILTINS and call.args:
            return f.id
        if isinstance(f, ast.Attribute):
            if f.attr in _SYNC_METHODS and not call.args \
                    and not call.keywords:
                return f".{f.attr}()"
            if ast.unparse(f) == "torch.cuda.synchronize":
                return "torch.cuda.synchronize()"
        return ""

    def taint(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.tainted
        if isinstance(e, ast.Attribute) and e.attr in _TENSOR_META:
            return False  # shape/dtype/device metadata lives on host
        if isinstance(e, (ast.Attribute, ast.Subscript, ast.Starred)):
            return self.taint(e.value)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(self.taint(x) for x in e.elts)
        if isinstance(e, ast.BinOp):
            return self.taint(e.left) or self.taint(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.taint(e.operand)
        if isinstance(e, ast.BoolOp):
            return any(self.taint(v) for v in e.values)
        if isinstance(e, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops) \
                    or any(isinstance(c, ast.Constant)
                           and isinstance(c.value, str)
                           for c in [e.left] + e.comparators):
                return False  # identity / a string: never a tensor op
            return self.taint(e.left) or any(
                self.taint(c) for c in e.comparators)
        if isinstance(e, ast.IfExp):
            return self.taint(e.body) or self.taint(e.orelse)
        if isinstance(e, ast.Call):
            if self._sync_kind(e) or self._is_device_get(e):
                return False  # the sync's own result lives on host
            if isinstance(e.func, ast.Attribute) and \
                    e.func.attr in _TENSOR_META_CALLS:
                return False
            if self._is_device_call(e):
                return True
            # method on a tainted value (x.sum(), x.astype(...)) stays
            # on device
            if isinstance(e.func, ast.Attribute) and self.taint(e.func.value):
                return True
            return False
        return False

    # -- statement walk ---------------------------------------------------

    def run(self) -> None:
        body = self.fn.body if isinstance(self.fn.body, list) else []
        self._walk(body)

    def _bind(self, target: ast.AST, tainted: bool, device_fn: bool) -> None:
        if isinstance(target, ast.Name):
            self.tainted.discard(target.id)
            self.local_device_fns.discard(target.id)
            if tainted:
                self.tainted.add(target.id)
            if device_fn:
                self.local_device_fns.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind(el, tainted, device_fn)

    def _walk(self, stmts: List[ast.stmt]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # separate scope, scanned on its own
            # a device-result sync is flagged wherever it sits, not just
            # in source-level loops: operators run once per chunk, so
            # "outside the loop" in source is still inside one at runtime
            self._scan_exprs(stmt)
            if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                value = stmt.value
                t = self.taint(value) if value is not None else False
                dfn = (isinstance(value, ast.Call)
                       and self._is_jit_builder_call(value))
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                for tgt in targets:
                    self._bind(tgt, t, dfn)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._bind(stmt.target, self.taint(stmt.iter), False)
                self._loop_depth += 1
                self._walk(stmt.body)
                self._loop_depth -= 1
                self._walk(stmt.orelse)
            elif isinstance(stmt, ast.While):
                self._loop_depth += 1
                self._walk(stmt.body)
                self._loop_depth -= 1
                self._walk(stmt.orelse)
            elif isinstance(stmt, ast.If):
                self._walk(stmt.body)
                self._walk(stmt.orelse)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    if item.optional_vars is not None:
                        self._bind(item.optional_vars,
                                   self.taint(item.context_expr), False)
                self._walk(stmt.body)
            elif isinstance(stmt, ast.Try):
                self._walk(stmt.body)
                for h in stmt.handlers:
                    self._walk(h.body)
                self._walk(stmt.orelse)
                self._walk(stmt.finalbody)

    def _scan_exprs(self, stmt: ast.stmt) -> None:
        """Flag sync calls on tainted values anywhere in `stmt`'s own
        expressions (not descending into nested compound statements —
        the walk visits those itself, with taint state up to date)."""
        compound = (ast.For, ast.AsyncFor, ast.While, ast.If, ast.With,
                    ast.AsyncWith, ast.Try, ast.FunctionDef,
                    ast.AsyncFunctionDef)
        if isinstance(stmt, compound):
            # only the header expressions belong to this statement
            headers: List[ast.AST] = []
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                headers = [stmt.iter]
            elif isinstance(stmt, ast.While):
                headers = [stmt.test]
            elif isinstance(stmt, ast.If):
                headers = [stmt.test]
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                headers = [i.context_expr for i in stmt.items]
            nodes = [n for h in headers for n in ast.walk(h)]
        else:
            nodes = list(ast.walk(stmt))
        if isinstance(stmt, (ast.If, ast.While)) and self.taint(stmt.test):
            self.hits.append((stmt.lineno, "if",
                              f"if {ast.unparse(stmt.test)[:70]}"))
        for node in nodes:
            if isinstance(node, ast.IfExp) and self.taint(node.test):
                self.hits.append((node.lineno, "if",
                                  f"if {ast.unparse(node.test)[:70]}"))
            if not isinstance(node, ast.Call):
                continue
            if self._loop_depth > 0 and self._is_device_get(node):
                # chunk-loop sync budget: the sanctioned batch fetch is
                # still one round trip per iteration inside a loop
                self.hits.append((node.lineno, "device_get-in-loop",
                                  ast.unparse(node)[:80]))
                continue
            kind = self._sync_kind(node)
            if not kind:
                continue
            if kind == "torch.cuda.synchronize()":
                detail = ast.unparse(node)
            elif kind in _SYNC_BUILTINS:
                if not self.taint(node.args[0]):
                    continue
                detail = ast.unparse(node)
            else:  # a tensor method: receiver must be tainted
                if not self.taint(node.func.value):
                    continue
                detail = ast.unparse(node)
            self.hits.append((node.lineno, kind, detail[:80]))


def _scan_file(sf: SourceFile) -> List[Tuple[int, str, str]]:
    device_fns, device_mods = _module_device_names(sf.tree)
    hits: List[Tuple[int, str, str]] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan = _FnScan(sf, node, device_fns, device_mods)
            scan.run()
            hits.extend(scan.hits)
    return hits


class HostSyncPass(Pass):
    id = "host-sync"
    doc = ("no implicit device→host syncs (.item()/.tolist()/.cpu()/"
           ".numpy()/int/float/bool/if on device values, "
           "torch.cuda.synchronize) in executor/ops/parallel/serving/"
           "columnar; intentional ones go through device_get or carry "
           "`# host-sync: <reason>`")

    SCOPE = ("executor", "ops", "parallel", "serving", "columnar",
             "sharding")

    def run(self, project: Project) -> List[Violation]:
        out: List[Violation] = []
        for sf in project.files_under(*self.SCOPE):
            used_notes = set()
            for line, kind, detail in _scan_file(sf):
                note = sf.host_sync_note(line)
                if note is not None:
                    used_notes.add(note[0])
                    continue  # annotated allowlist (reported separately)
                if kind == "device_get-in-loop":
                    out.append(Violation(
                        self.id, sf.rel, line,
                        f"per-iteration device fetch `{detail}` inside a "
                        "chunk loop (one round trip per iteration — the "
                        "ping-pong the pipelined executor removes). "
                        "Batch it into one fetch per window, hoist it to "
                        "finalize, or annotate with `# host-sync: "
                        "<reason>`."))
                    continue
                out.append(Violation(
                    self.id, sf.rel, line,
                    f"implicit device→host sync `{detail}` on the hot "
                    f"tier ({kind} forces the device to flush). Batch it "
                    "into one dispatch.device_get, hoist it off the per-chunk "
                    "path, or annotate the line with `# host-sync: "
                    "<reason>` if the sync is intentional."))
            # an annotation covering no sync is stale: left behind, it
            # would silently pre-allowlist a FUTURE sync on that line —
            # the exact invisible-sync class this pass exists to catch
            for line in sorted(set(sf.host_sync_notes) - used_notes):
                out.append(Violation(
                    self.id, sf.rel, line,
                    "stale host-sync annotation: no device→host sync "
                    "on the governed line — delete it (or re-anchor "
                    "it; a refactor may have moved the sync)"))
        return out


def annotated_sites(project: Project) -> List[Tuple[str, int, str]]:
    """Every `# host-sync:` annotation in scope — the documented
    allowlist of intentional syncs (rendered by check_invariants and
    mirrored in the README table)."""
    out = []
    for sf in project.files_under(*HostSyncPass.SCOPE):
        for line, reason in sorted(sf.host_sync_notes.items()):
            out.append((sf.rel, line, reason))
    return out
