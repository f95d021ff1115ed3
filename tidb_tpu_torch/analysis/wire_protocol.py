"""protocol-conformance pass: static model of the DCN dict wire
protocol, diffed in both directions.

The DCN tier's wire protocol is untyped dicts dispatched on a string
``cmd`` (``parallel/dcn.py`` ``Worker._handle``). A later change made it a real
distributed protocol — shuffle exchange, 2PC, reshard — and the failure
mode of an untyped protocol is silent: a sender/handler field mismatch
is a remote ``KeyError`` on a worker, invisible until a chaos test
happens to cross that arm. This pass extracts both directions of the
protocol from the AST and diffs them:

  * **send sites** — every ``{"cmd": <literal>}`` dict literal in the
    protocol modules, tracking field additions in the same function
    (``msg["k"] = ...``, ``msg.update(k=...)``, and ``msg["cmd"] = ...``
    re-dispatch forks like the partial_paged -> shuffle_gather switch).
    Fields added under extra conditions are *optional*; literal keys and
    same-branch additions are *required*.
  * **handler arms** — ``_handle``'s ``if cmd == ...`` dispatch, with
    each arm's ``msg[...]`` (required) / ``msg.get(...)`` (optional)
    reads collected transitively through the helper methods the arm
    hands ``msg`` to (``_partial_paged`` -> ``_run_sql`` etc.); reads
    nested under further conditions count as *conditional* (provable
    neither way).
  * **envelope** — fields the transport injects into EVERY message
    (``dict(msg, trace_id=...)`` on a parameter in ``_call``) and the
    fields the server preamble reads before dispatch (``_serve_conn`` /
    ``_handle`` top level). ``_``-prefixed keys are server-local
    annotations, never wire fields.

Violations: a cmd sent with no handler arm; a handler's unconditional
``msg[...]`` read of a field some sender omits (the remote KeyError); a
sent field no handler read ever touches (dead wire bytes); a handler
arm no site sends (dead arm); a *worker-side re-send* (a cmd literal
inside the handler class — the shuffle_scatter peer re-dispatch) that
does not propagate the statement envelope (``trace_id`` +
``deadline_s``); and a non-literal ``cmd`` value (the model — and the
runtime wire witness built on it — can only protect what it can name).

The extracted model is committed as ``analysis/wire_protocol.json``
(the runtime wire witness in ``analysis/sanitizer.py`` diffs real
traffic against it) and rendered as ``tidb_tpu_torch/analysis/WIRE_PROTOCOL.md``; this
pass re-extracts on every run and flags drift, so the committed model
can never silently rot behind the code.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from tidb_tpu_torch.analysis.core import Pass, Project, SourceFile, Violation

__all__ = ["ProtocolConformancePass", "extract_model", "to_wire_model",
           "render_markdown", "MODEL_REL_PATH", "DOC_REL_PATH",
           "ENVELOPE_REQUIRED"]

# the modules that ARE the wire protocol: every {"cmd": ...} literal in
# them is a send site, and the class defining _handle is the server
SEND_MODULES = ("tidb_tpu_torch/parallel/dcn.py", "tidb_tpu_torch/sharding/shuffle.py")

# committed artifacts (repo-relative); the pass checks them for drift
MODEL_REL_PATH = "tidb_tpu_torch/analysis/wire_protocol.json"
DOC_REL_PATH = "tidb_tpu_torch/analysis/WIRE_PROTOCOL.md"

# the statement envelope a worker-side re-send must propagate: the
# coordinator's trace context and the statement's remaining budget
# (the shuffle_scatter peer re-dispatch rule)
ENVELOPE_REQUIRED = ("trace_id", "deadline_s")

MODEL_SCHEMA = 1


# ---------------------------------------------------------------------------
# extraction model
# ---------------------------------------------------------------------------


@dataclass
class SendSite:
    cmd: str
    path: str                  # repo-relative
    line: int
    fn: str                    # "Class.method" / "function"
    required: Set[str] = field(default_factory=set)
    optional: Set[str] = field(default_factory=set)
    in_handler_class: bool = False   # a worker re-dispatch site

    def fields(self) -> Set[str]:
        return self.required | self.optional


@dataclass
class HandlerArm:
    cmd: str
    path: str
    line: int
    fn: str
    required: Set[str] = field(default_factory=set)     # msg[...] uncond.
    conditional: Set[str] = field(default_factory=set)  # msg[...] under if
    optional: Set[str] = field(default_factory=set)     # msg.get(...)

    def reads(self) -> Set[str]:
        return self.required | self.conditional | self.optional


@dataclass
class ProtocolModel:
    senders: List[SendSite] = field(default_factory=list)
    handlers: Dict[str, HandlerArm] = field(default_factory=dict)
    envelope_sent: Set[str] = field(default_factory=set)
    envelope_read: Set[str] = field(default_factory=set)
    problems: List[Violation] = field(default_factory=list)


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _is_wire_field(name: str) -> bool:
    # "_"-prefixed keys are server-local annotations (e.g.
    # _deadline_mono anchored at receipt), never wire fields
    return name != "cmd" and not name.startswith("_")


# ---------------------------------------------------------------------------
# send-site extraction
# ---------------------------------------------------------------------------


# a branch frame: ("if", id(node), arm_index) — contexts are stacks of
# frames from the function root; Try/loop bodies add an ("opt",) frame
# (their execution isn't provable, so additions there are optional)
_Ctx = Tuple[Tuple, ...]


def _compatible(a: _Ctx, b: _Ctx) -> bool:
    """Two contexts can both be live unless they take DIFFERENT arms of
    the SAME if statement."""
    for fa, fb in zip(a, b):
        if fa == fb:
            continue
        if fa[0] == "if" and fb[0] == "if" and fa[1] == fb[1] \
                and fa[2] != fb[2]:
            return False
        return True
    return True


def _is_prefix(a: _Ctx, b: _Ctx) -> bool:
    return len(a) <= len(b) and b[:len(a)] == a


@dataclass
class _Variant:
    """One (dict variable, cmd) in flight inside a function."""
    cmd: str
    line: int
    ctx: _Ctx
    required: Set[str]
    optional: Set[str]
    excluded: List[_Ctx] = field(default_factory=list)  # forked-away branches

    def add(self, name: str, ctx: _Ctx) -> None:
        if any(_is_prefix(e, ctx) for e in self.excluded):
            return  # the dict is a different cmd in that branch
        if not _compatible(self.ctx, ctx):
            return
        if not _is_wire_field(name):
            return
        if ctx == self.ctx:
            self.required.add(name)
        else:
            self.optional.add(name)


class _SendScan:
    """Collect send sites from one function body (linear walk with a
    branch-context stack)."""

    def __init__(self, sf: SourceFile, fn_name: str,
                 in_handler_class: bool, model: ProtocolModel):
        self.sf = sf
        self.fn_name = fn_name
        self.in_handler_class = in_handler_class
        self.model = model
        self.vars: Dict[str, List[_Variant]] = {}
        self.params: Set[str] = set()

    # -- helpers -----------------------------------------------------------

    def _dict_cmd(self, node: ast.AST) -> Optional[ast.Dict]:
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if _const_str(k) == "cmd":
                    return node
        return None

    def _literal_fields(self, d: ast.Dict) -> Tuple[Optional[str], Set[str]]:
        cmd = None
        fields: Set[str] = set()
        for k, v in zip(d.keys, d.values):
            name = _const_str(k)
            if name is None:
                if k is None:
                    self.model.problems.append(Violation(
                        ProtocolConformancePass.id, self.sf.rel, d.lineno,
                        "wire message built with **-expansion: the "
                        "static protocol model cannot name its fields"))
                continue
            if name == "cmd":
                cmd = _const_str(v)
                if cmd is None:
                    self.model.problems.append(Violation(
                        ProtocolConformancePass.id, self.sf.rel,
                        d.lineno,
                        "non-literal cmd value in a wire message: the "
                        "protocol model (and the runtime wire witness) "
                        "can only protect cmds it can name"))
            elif _is_wire_field(name):
                fields.add(name)
        return cmd, fields

    def _emit(self, var: _Variant) -> None:
        self.model.senders.append(SendSite(
            var.cmd, self.sf.rel, var.line, self.fn_name,
            set(var.required), set(var.optional),
            in_handler_class=self.in_handler_class))

    # -- walk --------------------------------------------------------------

    def run(self, fn: ast.AST) -> None:
        a = fn.args
        for arg in (a.posonlyargs + a.args + a.kwonlyargs
                    + ([a.vararg] if a.vararg else [])
                    + ([a.kwarg] if a.kwarg else [])):
            self.params.add(arg.arg)
        self._walk(fn.body, ())
        for variants in self.vars.values():
            for v in variants:
                self._emit(v)

    def _walk(self, stmts: List[ast.stmt], ctx: _Ctx) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested scopes are their own functions
            self._scan_stmt(stmt, ctx)
            if isinstance(stmt, ast.If):
                frame = ("if", id(stmt), 0)
                self._walk(stmt.body, ctx + (frame,))
                self._walk(stmt.orelse, ctx + (("if", id(stmt), 1),))
            elif isinstance(stmt, ast.Try):
                self._walk(stmt.body, ctx + (("opt", id(stmt)),))
                for h in stmt.handlers:
                    self._walk(h.body, ctx + (("opt", id(h)),))
                self._walk(stmt.orelse, ctx + (("opt", id(stmt), 2),))
                self._walk(stmt.finalbody, ctx)
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                self._walk(stmt.body, ctx + (("opt", id(stmt)),))
                self._walk(stmt.orelse, ctx)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                self._walk(stmt.body, ctx)

    def _scan_stmt(self, stmt: ast.stmt, ctx: _Ctx) -> None:
        # 1) tracked creation: `msg = {...,"cmd": c,...}`
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            d = self._dict_cmd(stmt.value)
            if d is not None:
                cmd, fields = self._literal_fields(d)
                if cmd is not None:
                    name = stmt.targets[0].id
                    self.vars.setdefault(name, []).append(_Variant(
                        cmd, d.lineno, ctx, fields, set()))
                return
        # 2) field add / cmd fork: `msg["k"] = v`
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Subscript) \
                and isinstance(stmt.targets[0].value, ast.Name):
            var = stmt.targets[0].value.id
            key = _const_str(stmt.targets[0].slice)
            variants = self.vars.get(var)
            if variants is not None and key is not None:
                if key == "cmd":
                    new_cmd = _const_str(stmt.value)
                    if new_cmd is None:
                        self.model.problems.append(Violation(
                            ProtocolConformancePass.id, self.sf.rel,
                            stmt.lineno,
                            "non-literal cmd re-assignment on a wire "
                            "message: the protocol model cannot name "
                            "the re-dispatched cmd"))
                        return
                    # fork: the dict is `new_cmd` in this branch from
                    # here on; the originals never see this branch
                    fork = _Variant(new_cmd, stmt.lineno, ctx,
                                    set(), set())
                    for v in variants:
                        if _compatible(v.ctx, ctx):
                            fork.required |= v.required
                            fork.optional |= v.optional
                            v.excluded.append(ctx)
                    variants.append(fork)
                else:
                    for v in variants:
                        v.add(key, ctx)
                return
        # 3) `msg.update(k=..., ...)` / `msg.update({...})`
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
            f = call.func
            if isinstance(f, ast.Attribute) and f.attr == "update" \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id in self.vars:
                for kw in call.keywords:
                    if kw.arg is not None:
                        for v in self.vars[f.value.id]:
                            v.add(kw.arg, ctx)
                for arg in call.args:
                    if isinstance(arg, ast.Dict):
                        for k in arg.keys:
                            name = _const_str(k)
                            if name is not None:
                                for v in self.vars[f.value.id]:
                                    v.add(name, ctx)
                return
        # 3b) transport envelope injection: `msg = dict(msg, k=...)`
        # REBINDING a message parameter — the _call/_run_scatter idiom.
        # Only this exact shape counts: an arbitrary dict() rewrap
        # elsewhere in the module is ordinary code, and treating it as
        # envelope would silently widen the runtime witness allowlist
        # for every cmd
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and isinstance(stmt.value, ast.Call) \
                and isinstance(stmt.value.func, ast.Name) \
                and stmt.value.func.id == "dict" \
                and stmt.value.args \
                and isinstance(stmt.value.args[0], ast.Name) \
                and stmt.value.args[0].id == stmt.targets[0].id \
                and stmt.targets[0].id in self.params \
                and stmt.value.keywords:
            self.model.envelope_sent.update(
                kw.arg for kw in stmt.value.keywords
                if kw.arg is not None and _is_wire_field(kw.arg))
            return
        # 4) everything else: untracked literals + dict() rewraps.
        # Compound statements contribute only their HEADER expressions
        # here — their bodies come back through _walk, so scanning the
        # whole subtree would double-count every nested site.
        if isinstance(stmt, (ast.If, ast.While)):
            nodes = list(ast.walk(stmt.test))
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            nodes = list(ast.walk(stmt.iter))
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            nodes = [n for item in stmt.items
                     for n in ast.walk(item.context_expr)]
        elif isinstance(stmt, ast.Try):
            nodes = []
        else:
            nodes = list(ast.walk(stmt))
        for node in nodes:
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id == "dict" and node.args and \
                    isinstance(node.args[0], ast.Name) and node.keywords:
                base = node.args[0].id
                kws = [kw.arg for kw in node.keywords
                       if kw.arg is not None and _is_wire_field(kw.arg)]
                if base in self.vars:
                    for v in self.vars[base]:
                        for k in kws:
                            # a rewrap's lifetime is the expression —
                            # always an optional augmentation
                            v.optional.add(k)
            d = self._dict_cmd(node)
            if d is not None and not (
                    isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.value is d):
                cmd, fields = self._literal_fields(d)
                if cmd is not None:
                    self.model.senders.append(SendSite(
                        cmd, self.sf.rel, d.lineno, self.fn_name,
                        fields, set(),
                        in_handler_class=self.in_handler_class))


# ---------------------------------------------------------------------------
# handler extraction
# ---------------------------------------------------------------------------


class _HandlerScan:
    """Reads of the msg parameter per dispatch arm, followed through
    helper methods the arm hands msg to (one class, memoized)."""

    def __init__(self, sf: SourceFile, cls: ast.ClassDef,
                 module_fns: Dict[str, ast.FunctionDef]):
        self.sf = sf
        self.cls = cls
        self.methods: Dict[str, ast.FunctionDef] = {
            n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        self.module_fns = module_fns
        # method name -> (required, conditional, optional) of its own
        # msg-param reads incl. transitive helper calls
        self._memo: Dict[str, Tuple[Set[str], Set[str], Set[str]]] = {}

    # -- msg reads in a statement list ------------------------------------

    def _reads(self, stmts: List[ast.stmt], var: str, cond: bool,
               req: Set[str], con: Set[str], opt: Set[str],
               stack: Tuple[str, ...]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            self._scan_expr(stmt, var, cond, req, con, opt, stack,
                            headers_only=True)
            if isinstance(stmt, ast.If):
                self._reads(stmt.body, var, True, req, con, opt, stack)
                self._reads(stmt.orelse, var, True, req, con, opt, stack)
            elif isinstance(stmt, ast.Try):
                # a try body's reads are attempted (KeyError can fire);
                # handlers/orelse are conditional
                self._reads(stmt.body, var, cond, req, con, opt, stack)
                for h in stmt.handlers:
                    self._reads(h.body, var, True, req, con, opt, stack)
                self._reads(stmt.orelse, var, True, req, con, opt, stack)
                self._reads(stmt.finalbody, var, cond, req, con, opt,
                            stack)
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                self._reads(stmt.body, var, True, req, con, opt, stack)
                self._reads(stmt.orelse, var, True, req, con, opt, stack)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                self._reads(stmt.body, var, cond, req, con, opt, stack)

    def _scan_expr(self, stmt: ast.stmt, var: str, cond: bool,
                   req: Set[str], con: Set[str], opt: Set[str],
                   stack: Tuple[str, ...], headers_only: bool) -> None:
        """Reads in one statement's expressions. For compound
        statements only the header expressions are scanned here (their
        bodies come back through _reads with the right cond flag)."""
        if headers_only and isinstance(stmt, ast.If):
            nodes = list(ast.walk(stmt.test))
        elif headers_only and isinstance(stmt, (ast.For, ast.AsyncFor)):
            nodes = list(ast.walk(stmt.iter))
        elif headers_only and isinstance(stmt, ast.While):
            nodes = list(ast.walk(stmt.test))
        elif headers_only and isinstance(stmt, (ast.With, ast.AsyncWith)):
            nodes = [n for item in stmt.items
                     for n in ast.walk(item.context_expr)]
        elif headers_only and isinstance(stmt, ast.Try):
            nodes = []
        else:
            nodes = list(ast.walk(stmt))
        for node in nodes:
            # msg["field"] loads (stores are server-local annotations)
            if isinstance(node, ast.Subscript) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == var and \
                    isinstance(node.ctx, ast.Load):
                name = _const_str(node.slice)
                if name is not None and _is_wire_field(name):
                    (con if cond else req).add(name)
            # msg.get("field"[, default])
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "get" and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == var and node.args:
                name = _const_str(node.args[0])
                if name is not None and _is_wire_field(name):
                    opt.add(name)
            # helper delegation: self._meth(..., msg, ...) or f(msg)
            elif isinstance(node, ast.Call):
                self._delegate(node, var, cond, req, con, opt, stack)

    def _delegate(self, call: ast.Call, var: str, cond: bool,
                  req: Set[str], con: Set[str], opt: Set[str],
                  stack: Tuple[str, ...]) -> None:
        target: Optional[ast.FunctionDef] = None
        skip_self = 0
        f = call.func
        if isinstance(f, ast.Attribute) and \
                isinstance(f.value, ast.Name) and f.value.id == "self":
            target = self.methods.get(f.attr)
            skip_self = 1
        elif isinstance(f, ast.Name):
            target = self.module_fns.get(f.id)
        if target is None or target.name in stack:
            return
        # which parameter receives our msg variable?
        param: Optional[str] = None
        names = [a.arg for a in target.args.args][skip_self:]
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Name) and arg.id == var \
                    and i < len(names):
                param = names[i]
                break
        if param is None:
            for kw in call.keywords:
                if isinstance(kw.value, ast.Name) and kw.value.id == var:
                    param = kw.arg
                    break
        if param is None:
            return
        sub = self._fn_reads(target, param, stack + (target.name,))
        if cond:
            con.update(sub[0])
        else:
            req.update(sub[0])
        con.update(sub[1])
        opt.update(sub[2])

    def _fn_reads(self, fn: ast.FunctionDef, param: str,
                  stack: Tuple[str, ...]
                  ) -> Tuple[Set[str], Set[str], Set[str]]:
        key = f"{fn.name}:{param}"
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        req: Set[str] = set()
        con: Set[str] = set()
        opt: Set[str] = set()
        self._memo[key] = (req, con, opt)  # cycle guard
        self._reads(fn.body, param, False, req, con, opt, stack)
        return req, con, opt

    # -- arms --------------------------------------------------------------

    def arms(self, model: ProtocolModel) -> None:
        handle = self.methods.get("_handle")
        if handle is None:
            return
        args = [a.arg for a in handle.args.args]
        msg = args[1] if len(args) > 1 and args[0] == "self" else args[0]
        # the dispatch variable: `cmd = msg["cmd"]`
        cmd_var = None
        for stmt in handle.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and isinstance(stmt.value, ast.Subscript) \
                    and isinstance(stmt.value.value, ast.Name) \
                    and stmt.value.value.id == msg \
                    and _const_str(stmt.value.slice) == "cmd":
                cmd_var = stmt.targets[0].id
        fn_name = f"{self.cls.name}._handle"
        for stmt in handle.body:
            arm_cmds = self._arm_cmds(stmt, cmd_var)
            if arm_cmds is None:
                # preamble/epilogue: envelope reads (deadline anchoring,
                # trace context) apply to every cmd
                req: Set[str] = set()
                con: Set[str] = set()
                opt: Set[str] = set()
                self._reads([stmt], msg, False, req, con, opt, ())
                self._scan_expr(stmt, msg, False, req, con, opt, (),
                                headers_only=False)
                model.envelope_read |= req | con | opt
                continue
            req, con, opt = set(), set(), set()
            self._scan_expr(stmt, msg, False, req, con, opt, (),
                            headers_only=True)
            self._reads(stmt.body, msg, False, req, con, opt, ())
            for c in arm_cmds:
                model.handlers[c] = HandlerArm(
                    c, self.sf.rel, stmt.lineno, fn_name,
                    set(req), set(con), set(opt))
        # the server preamble outside _handle (_serve_conn's trace
        # context peek on the freshly-received frame)
        self._serve_conn_reads(model)

    def _arm_cmds(self, stmt: ast.stmt,
                  cmd_var: Optional[str]) -> Optional[List[str]]:
        if cmd_var is None or not isinstance(stmt, ast.If) \
                or not isinstance(stmt.test, ast.Compare):
            return None
        t = stmt.test
        if not (isinstance(t.left, ast.Name) and t.left.id == cmd_var
                and len(t.ops) == 1):
            return None
        if isinstance(t.ops[0], ast.Eq):
            c = _const_str(t.comparators[0])
            return [c] if c is not None else None
        if isinstance(t.ops[0], ast.In) and \
                isinstance(t.comparators[0], (ast.Tuple, ast.List)):
            out = []
            for el in t.comparators[0].elts:
                c = _const_str(el)
                if c is not None:
                    out.append(c)
            return out or None
        return None

    def _serve_conn_reads(self, model: ProtocolModel) -> None:
        serve = self.methods.get("_serve_conn")
        if serve is None:
            return
        # the received-frame variable: `X = _recv(...)`
        var = None
        for node in ast.walk(serve):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call) \
                    and isinstance(node.value.func, ast.Name) \
                    and node.value.func.id == "_recv":
                var = node.targets[0].id
        if var is None:
            return
        req: Set[str] = set()
        con: Set[str] = set()
        opt: Set[str] = set()
        # "_handle" rides the stack so delegation into the dispatcher
        # is NOT followed: its per-arm reads are per-cmd, not envelope
        self._reads(serve.body, var, True, req, con, opt,
                    ("_serve_conn", "_handle"))
        model.envelope_read |= req | con | opt


# ---------------------------------------------------------------------------
# extraction driver
# ---------------------------------------------------------------------------


def extract_model(project: Project,
                  modules: Tuple[str, ...] = SEND_MODULES) -> ProtocolModel:
    model = ProtocolModel()
    wanted = {os.path.normpath(m) for m in modules}
    files = [sf for sf in project.files()
             if os.path.normpath(sf.rel) in wanted]
    for sf in files:
        module_fns = {n.name: n for n in sf.tree.body
                      if isinstance(n, ast.FunctionDef)}
        # the handler class: the one defining _handle
        handler_cls = None
        for node in sf.tree.body:
            if isinstance(node, ast.ClassDef) and any(
                    isinstance(m, ast.FunctionDef) and m.name == "_handle"
                    for m in node.body):
                handler_cls = node
                break
        # send sites, function by function (so field additions resolve
        # in their own scope)
        def visit(node, cls_name: Optional[str], in_handler: bool):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, child.name, child is handler_cls)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    fn_name = (f"{cls_name}.{child.name}" if cls_name
                               else child.name)
                    scan = _SendScan(sf, fn_name, in_handler, model)
                    scan.run(child)
                    visit(child, cls_name, in_handler)
                else:
                    visit(child, cls_name, in_handler)

        visit(sf.tree, None, False)
        if handler_cls is not None:
            _HandlerScan(sf, handler_cls, module_fns).arms(model)
    return model


# ---------------------------------------------------------------------------
# serialized model + docs rendering
# ---------------------------------------------------------------------------


def to_wire_model(model: ProtocolModel) -> dict:
    """Deterministic, line-number-free form of the model: what gets
    committed as wire_protocol.json and what the runtime wire witness
    loads. Function-level site names keep the file stable across
    unrelated edits to the protocol modules."""
    cmds: Dict[str, dict] = {}
    for s in sorted(model.senders, key=lambda s: (s.cmd, s.fn, s.line)):
        ent = cmds.setdefault(s.cmd, {"handler": None, "senders": []})
        site = {"fn": s.fn,
                "required": sorted(s.required),
                "optional": sorted(s.optional)}
        if site not in ent["senders"]:
            ent["senders"].append(site)
    for c, h in sorted(model.handlers.items()):
        ent = cmds.setdefault(c, {"handler": None, "senders": []})
        ent["handler"] = {"fn": h.fn,
                          "required": sorted(h.required),
                          "conditional": sorted(h.conditional),
                          "optional": sorted(h.optional)}
    return {
        "schema": MODEL_SCHEMA,
        "envelope": {"sent": sorted(model.envelope_sent),
                     "read": sorted(model.envelope_read)},
        "cmds": {c: cmds[c] for c in sorted(cmds)},
    }


def render_markdown(wire: dict) -> str:
    """tidb_tpu_torch/analysis/WIRE_PROTOCOL.md: the generated wire-protocol reference
    (cmd -> sender sites -> handler -> required/optional fields)."""
    out = [
        "# DCN wire-protocol reference",
        "",
        "**GENERATED** by `python -m tidb_tpu_torch.analysis --gen-wire` from the static",
        "protocol model (`tidb_tpu_torch/analysis/wire_protocol.py`); the",
        "`protocol-conformance` pass and a tier-1 drift test assert this",
        "file matches a fresh extraction — edit the protocol code, then",
        "regenerate, never edit this file by hand.",
        "",
        "Transport envelope — injected into every message by the",
        "transport layer, consumed by the server preamble:",
        "",
        f"- sent: {', '.join('`%s`' % f for f in wire['envelope']['sent']) or '(none)'}",
        f"- read: {', '.join('`%s`' % f for f in wire['envelope']['read']) or '(none)'}",
        "",
        "| cmd | sender site(s) | handler | required fields | optional fields |",
        "|---|---|---|---|---|",
    ]
    for cmd, ent in wire["cmds"].items():
        senders = ent["senders"]
        h = ent["handler"]
        sender_cell = "<br>".join(
            f"`{s['fn']}`" for s in senders) or "*(none in tree)*"
        if h is None:
            handler_cell, req_cell, opt_cell = "*(no arm)*", "", ""
        else:
            handler_cell = f"`{h['fn']}`"
            req_cell = ", ".join(f"`{f}`" for f in h["required"]) or "—"
            opt = sorted(set(h["optional"]) | set(h["conditional"]))
            opt_cell = ", ".join(f"`{f}`" for f in opt) or "—"
        out.append(f"| `{cmd}` | {sender_cell} | {handler_cell} "
                   f"| {req_cell} | {opt_cell} |")
    out.append("")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------


class ProtocolConformancePass(Pass):
    id = "protocol-conformance"
    doc = ("DCN dict protocol statically modeled: senders and handler "
           "arms agree on cmds and fields; worker re-sends propagate "
           "the statement envelope; committed model is drift-checked")

    def __init__(self, modules: Tuple[str, ...] = SEND_MODULES,
                 model_path: Optional[str] = MODEL_REL_PATH,
                 doc_path: Optional[str] = DOC_REL_PATH):
        self.modules = modules
        self.model_path = model_path
        self.doc_path = doc_path

    def run(self, project: Project) -> List[Violation]:
        model = extract_model(project, self.modules)
        out: List[Violation] = list(model.problems)
        out.extend(self._diff(model))
        out.extend(self._drift(project, model))
        return out

    # -- the two-direction diff -------------------------------------------

    def _diff(self, model: ProtocolModel) -> List[Violation]:
        out: List[Violation] = []
        sent_cmds = {s.cmd for s in model.senders}
        # union of reads per cmd (for the dead-field direction)
        for s in model.senders:
            h = model.handlers.get(s.cmd)
            if h is None:
                out.append(Violation(
                    self.id, s.path, s.line,
                    f"cmd {s.cmd!r} is sent here but Worker._handle has "
                    "no arm for it — the worker raises `unknown dcn "
                    "command` at runtime"))
                continue
            for f in sorted(h.required - s.required):
                out.append(Violation(
                    self.id, s.path, s.line,
                    f"send site of {s.cmd!r} omits field {f!r} that the "
                    f"handler ({h.fn}) reads unconditionally — a remote "
                    "KeyError on the worker"))
            reads = h.reads() | model.envelope_read
            for f in sorted(s.fields() - reads):
                out.append(Violation(
                    self.id, s.path, s.line,
                    f"field {f!r} of {s.cmd!r} is sent but no handler "
                    "read ever touches it — dead wire bytes (delete it, "
                    "or the handler forgot to consume it)"))
            if s.in_handler_class:
                # transport-level injection (_call's trace context)
                # does NOT exempt worker re-sends: peer hops ride
                # _peer_call/_send, which inject nothing — the fields
                # must be on the literal (or its same-scope additions)
                missing = [f for f in ENVELOPE_REQUIRED
                           if f not in s.fields()]
                if missing:
                    out.append(Violation(
                        self.id, s.path, s.line,
                        f"worker-side re-send of {s.cmd!r} does not "
                        "propagate the statement envelope "
                        f"({', '.join(missing)}): a fan-out hop must "
                        "carry the coordinator's trace context and "
                        "remaining deadline"))
        for c, h in sorted(model.handlers.items()):
            if c not in sent_cmds:
                out.append(Violation(
                    self.id, h.path, h.line,
                    f"handler arm for {c!r} has no send site in the "
                    "protocol modules — dead arm (delete it, or "
                    "suppress with the out-of-tree caller as the "
                    "reason)"))
        # envelope fields nobody reads anywhere are dead on EVERY wire
        # message
        all_reads = model.envelope_read | {
            f for h in model.handlers.values() for f in h.reads()}
        for f in sorted(model.envelope_sent - all_reads):
            out.append(Violation(
                self.id, self.modules[0], 1,
                f"transport-injected envelope field {f!r} is read by "
                "no handler or server preamble — dead wire bytes on "
                "every message"))
        return out

    # -- drift vs the committed artifacts ---------------------------------

    def _drift(self, project: Project,
               model: ProtocolModel) -> List[Violation]:
        out: List[Violation] = []
        if self.model_path is None:
            return out
        wire = to_wire_model(model)
        path = os.path.join(project.root, self.model_path)
        try:
            with open(path, encoding="utf-8") as f:
                committed = json.load(f)
        except (OSError, ValueError):
            committed = None
        if committed != wire:
            out.append(Violation(
                self.id, self.model_path, 1,
                "committed wire-protocol model does not match a fresh "
                "extraction — run `python -m tidb_tpu_torch.analysis --gen-wire` "
                "and commit the result (the runtime wire witness diffs "
                "real traffic against this file; it must never rot)"))
        if self.doc_path is not None:
            doc = os.path.join(project.root, self.doc_path)
            try:
                with open(doc, encoding="utf-8") as f:
                    have = f.read()
            except OSError:
                have = None
            if have != render_markdown(wire):
                out.append(Violation(
                    self.id, self.doc_path, 1,
                    "generated wire-protocol reference is stale — run "
                    "`python -m tidb_tpu_torch.analysis --gen-wire`"))
        return out
