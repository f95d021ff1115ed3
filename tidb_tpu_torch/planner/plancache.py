"""Digest-keyed plan cache (ref: planner/core plan_cache* — the prepared
plan cache plus the instance-level cache behind
tidb_enable_non_prepared_plan_cache).

The cache maps a statement's *shape* — the bindinfo-normalized digest
plus everything else that legitimately feeds planning (current db,
parameter type fingerprint, plan-structural constants the digest blurs,
hints, planner sysvars, mesh width, binding versions) — to a lowered
physical plan. Parameter values are bound at execution time WITHOUT
re-planning by patching the recorded literal slots of the cached plan.

Soundness model (the part that differs from the reference, which plans
param-agnostically): this engine's binder consumes literal VALUES while
planning (dictionary-code rewrites, constant folding, point-get keys),
so a plan built for one parameter vector is only reusable if every
place a value leaked into the final plan is known and patchable. That
is established constructively on the first (miss) execution:

  1. plan the statement with its actual literals;
  2. plan it AGAIN with per-slot perturbed sentinel values;
  3. diff the two physical plans in lockstep. If they differ anywhere
     except at scalar leaves whose (value, sentinel) pair exactly
     matches one parameter's raw value, the statement is uncacheable.
     Every parameter must surface in at least one leaf (coverage) — a
     parameter folded away (``? > 0`` -> TRUE), rewritten to dictionary
     codes, rescaled into a decimal/date encoding, or hidden in a
     derived LUT produces either an unattributable diff or a coverage
     gap, and the statement is (soundly) refused.

On a hit the recorded (path, param-index) slots are patched into a
structurally-shared copy; untouched subtrees are shared and read-only.
Access-path values patched this way (point-get keys, index range
bounds) stay correct because every access node retains the full
``pushed_cond`` as a residual filter.

Invalidation: any ``catalog.schema_version`` bump clears the whole
cache (the reference's schema-change invalidation); per-entry stats
identity + freshness checks evict entries whose tables were ANALYZEd
(new stats object) or written (freshness flip) since planning.

Known-uncacheable shapes are cached negatively (entry with
``patches=None``) so they pay the sentinel verification once, not per
execution; the reason is surfaced on the ``/plan_cache`` endpoint.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from tidb_tpu_torch.chunk.dictionary import Dictionary, RuntimeDictionary
from tidb_tpu_torch.parser import ast as A

__all__ = ["PlanCache", "PlanCacheEntry", "StmtInfo", "TemplateInfo",
           "analyze_statement", "analyze_template", "bind_template_params",
           "transform_literals", "make_sentinels", "build_entry",
           "instantiate", "batchable_plan",
           "classify_dml", "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = 256

# builtins the binder folds to bind-time literals that must never be
# frozen into a shared cached plan. Session identity (user/conn_id)
# matters because the cache is instance-wide; clocks matter everywhere.
# database()/version() are deliberately absent: db is a key component
# and version is process-constant.
_VOLATILE = frozenset({
    "now", "current_timestamp", "localtime", "localtimestamp", "sysdate",
    "curdate", "current_date", "curtime", "current_time", "utc_date",
    "utc_time", "utc_timestamp", "user", "current_user", "session_user",
    "system_user", "connection_id", "rand", "uuid", "sleep",
    "last_insert_id", "found_rows",
})

# plan fields legitimately value-dependent without being value-carrying:
# cost estimates, and the TopN pushdown descriptor (re-derived after
# patching via optimizer._annotate_topn, so it never aliases stale
# subtrees).
_IGNORE_FIELDS = frozenset({"est_rows", "pushdown"})


# ---------------------------------------------------------------------------
# statement analysis: literal slots, structural constants, volatility
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StmtInfo:
    params: List[object]          # literal values in deterministic order
    kinds: Tuple[str, ...]        # per-param type code: i | f | s
    struct: Tuple                 # digest-blurred plan-structural constants
    volatile: Optional[str]      # first volatile builtin found, else None
    unsafe: bool = False         # a literal sits in a foldable context


def _num_value(text: str):
    t = text.lower()
    if t.startswith("0x") or t.startswith("-0x"):
        return int(t, 16)
    try:
        return int(text)
    except ValueError:
        return float(text)


def _num_text(v) -> str:
    return repr(v) if isinstance(v, float) else str(v)


def _is_dc(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


# binary operators whose DIRECT literal operands the binder consumes
# verbatim (comparisons and the boolean skeleton). A literal under any
# OTHER operator/function can be folded into a derived value that is
# coincidentally identity on the sampled points (abs(5) == 5) — such
# slots are flagged unsafe and the whole statement refuses to cache.
_SAFE_BINOPS = frozenset({"=", "<>", "!=", "<", "<=", ">", ">=", "<=>",
                          "and", "or", "xor"})


def _child_safety(v, safe: bool) -> bool:
    if isinstance(v, (A.SelectStmt, A.UnionStmt)):
        return True  # fresh clause context (subqueries included)
    if isinstance(v, A.EBinary):
        return safe and v.op in _SAFE_BINOPS
    if isinstance(v, (A.EFunc, A.ECase, A.ECast, A.EUnary, A.EInterval,
                      A.EWindow, A.ELike, A.ERegexp)):
        return False
    return safe


def _traverse(v, fn, rebuild: bool, safe: bool = True):
    """THE literal-slot traversal — the single definition of slot order
    shared by analysis (collect-only) and sentinel substitution
    (rebuild): one walker means the positional patch map can never
    desynchronize. ``fn(kind, value, safe)`` fires per slot with kind
    in {num, str, int, param, node}; its return value replaces the slot
    in rebuild mode. Slots are A.ENum (int/float), A.EStr (str), the
    plain-int limit/offset fields of SelectStmt/UnionStmt, and EParam
    markers — every NUM/STR/? token normalizes to ``?`` in the digest,
    so each must be a slot or two same-digest statements could share
    one cached plan."""
    if isinstance(v, A.ENum):
        r = fn("num", _num_value(v.text), safe)
        return A.ENum(_num_text(r)) if rebuild else v
    if isinstance(v, A.EStr):
        r = fn("str", v.value, safe)
        return A.EStr(r) if rebuild else v
    if isinstance(v, A.EParam):
        fn("param", v.index, safe)
        return v
    if isinstance(v, list):
        out = [_traverse(x, fn, rebuild, safe) for x in v]
        return out if rebuild else v
    if isinstance(v, tuple):
        out = tuple(_traverse(x, fn, rebuild, safe) for x in v)
        return out if rebuild else v
    if not _is_dc(v):
        return v
    fn("node", v, safe)
    child_safe = _child_safety(v, safe)
    is_su = isinstance(v, (A.SelectStmt, A.UnionStmt))
    if rebuild:
        kw = {}
        for f in dataclasses.fields(v):
            x = getattr(v, f.name)
            if (is_su and f.name in ("limit", "offset")
                    and isinstance(x, int) and not isinstance(x, bool)):
                kw[f.name] = int(fn("int", x, True))
            else:
                kw[f.name] = _traverse(x, fn, True, child_safe)
        return type(v)(**kw)
    for f in dataclasses.fields(v):
        x = getattr(v, f.name)
        if (is_su and f.name in ("limit", "offset")
                and isinstance(x, int) and not isinstance(x, bool)):
            fn("int", x, True)
        else:
            _traverse(x, fn, False, child_safe)
    return v


def transform_literals(stmt, fn):
    """Rebuild the statement AST passing every literal slot value
    through ``fn(value)`` in slot order (sentinel substitution)."""
    return _traverse(
        stmt,
        lambda kind, v, safe: v if kind in ("param", "node") else fn(v),
        rebuild=True)


class _Analysis:
    """Shared collector for analyze_statement / analyze_template."""

    def __init__(self):
        self.slots: List = []
        self.struct: List = []
        self.volatile: List[str] = []
        self.unsafe = False

    def __call__(self, kind, v, safe):
        if kind in ("num", "str", "int"):
            self.slots.append(("c", v))
            if not safe:
                self.unsafe = True
        elif kind == "param":
            self.slots.append(("p", v))
            if not safe:
                self.unsafe = True
        elif isinstance(v, A.EFunc):
            n = v.name
            if n in _VOLATILE and (n != "unix_timestamp" or not v.args):
                self.volatile.append(n)
        elif isinstance(v, A.ECast):
            self.struct.append(("cast", v.type_name, tuple(v.type_args)))
        elif isinstance(v, A.EWindow) and v.frame is not None:
            self.struct.append(("frame", repr(v.frame)))
        return v


def _kinds(vals) -> Tuple[str, ...]:
    return tuple("i" if isinstance(v, int) and not isinstance(v, bool)
                 else "f" if isinstance(v, float) else "s" for v in vals)


def analyze_statement(stmt) -> StmtInfo:
    """Collect-only pass over a literal-substituted statement (runs on
    EVERY cache probe — no AST rebuild)."""
    a = _Analysis()
    _traverse(stmt, a, rebuild=False)
    if any(k == "p" for k, _ in a.slots):
        a.unsafe = True  # unbound markers cannot be patched or planned
    params = [v for k, v in a.slots if k == "c"]
    a.struct.sort(key=repr)
    return StmtInfo(params=params, kinds=_kinds(params),
                    struct=tuple(a.struct),
                    volatile=(a.volatile[0] if a.volatile else None),
                    unsafe=a.unsafe)


@dataclasses.dataclass
class TemplateInfo:
    """Prepare-time analysis of a statement TEMPLATE (EParam markers in
    place): literal slots in walk order, each a constant value or a
    parameter reference, plus the value-independent struct/volatile
    findings. Lets execute_prepared skip the per-execution AST walk."""

    slots: Tuple                  # (("c", value) | ("p", param_index), ...)
    struct: Tuple
    volatile: Optional[str]
    unsafe: bool = False


def analyze_template(stmt) -> TemplateInfo:
    """analyze_statement over a prepared template: EParam nodes become
    parameter slots at exactly the position their substituted literal
    would occupy (the _param_literal substitution yields one ENum/EStr
    per marker, so slot order is preserved — same walker, same order)."""
    a = _Analysis()
    _traverse(stmt, a, rebuild=False)
    a.struct.sort(key=repr)
    return TemplateInfo(slots=tuple(a.slots), struct=tuple(a.struct),
                        volatile=(a.volatile[0] if a.volatile else None),
                        unsafe=a.unsafe)


_UNSUPPORTED = object()


def _coerce_param(v):
    """A bound parameter value as the literal the _param_literal
    substitution would produce — MUST track that function exactly, or
    the fast path and the substituted-AST analysis would disagree."""
    import datetime

    if isinstance(v, bool):
        return 1 if v else 0
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        return v  # ENum(repr(v)) round-trips exactly
    if isinstance(v, str):
        return v
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, datetime.datetime):
        return v.isoformat(sep=" ")
    if isinstance(v, datetime.date):
        return v.isoformat()
    # None substitutes as ENull (not a literal slot) and anything else
    # is str()-ed by _param_literal — shapes the template walk cannot
    # predict, so the caller falls back to analyzing the substituted AST
    return _UNSUPPORTED


def bind_template_params(tinfo: TemplateInfo, params) -> Optional[StmtInfo]:
    """TemplateInfo + bound params -> the StmtInfo the substituted AST
    would analyze to, or None when a value needs the slow path."""
    vals: List[object] = []
    for kind, v in tinfo.slots:
        if kind == "c":
            vals.append(v)
        else:
            if v >= len(params):
                return None
            w = _coerce_param(params[v])
            if w is _UNSUPPORTED:
                return None
            vals.append(w)
    return StmtInfo(params=vals, kinds=_kinds(vals), struct=tinfo.struct,
                    volatile=tinfo.volatile, unsafe=tinfo.unsafe)


def make_sentinels(params) -> List[object]:
    """Per-slot perturbed values of the same Python type. Distinct
    (value, sentinel) pairs per index: equal values at two indices get
    different sentinels, so diff attribution is never ambiguous."""
    out = []
    for i, v in enumerate(params):
        if isinstance(v, bool):
            out.append(v)  # never produced by extraction; keep stable
        elif isinstance(v, int):
            out.append(v + 1 + i)
        elif isinstance(v, float):
            out.append(v + 1.5 + i)
        else:
            out.append(str(v) + "\x00~" + str(i))
    return out


# ---------------------------------------------------------------------------
# lockstep plan diff + patch-map attribution
# ---------------------------------------------------------------------------


def _scalar(x) -> bool:
    return (isinstance(x, (int, float, str, np.integer, np.floating))
            and not isinstance(x, bool))


def _int_like(x) -> bool:
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


def _float_like(x) -> bool:
    return isinstance(x, (float, np.floating))


def _diff(a, b, path, out) -> bool:
    """Lockstep structural compare; scalar mismatches are recorded as
    candidate patch leaves, anything else incompatible returns False."""
    if a is b:
        return True
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b
    if _scalar(a) and _scalar(b):
        same_class = (type(a) is type(b)
                      or (_int_like(a) and _int_like(b))
                      or (_float_like(a) and _float_like(b)))
        if not same_class:
            return bool(a == b)
        if a == b:
            return True
        out.append((path, a, b))
        return True
    if type(a) is not type(b):
        return False
    if _is_dc(a):
        for f in dataclasses.fields(a):
            if f.name in _IGNORE_FIELDS:
                continue
            if not _diff(getattr(a, f.name), getattr(b, f.name),
                         path + (f.name,), out):
                return False
        return True
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return False
        for i, (x, y) in enumerate(zip(a, b)):
            if not _diff(x, y, path + (i,), out):
                return False
        return True
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return False
        for k in a:
            if not _diff(a[k], b[k], path + (("key", k),), out):
                return False
        return True
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, Dictionary):
        return a.values == b.values and a.collation == b.collation
    # other objects (tables, indexes, ...) must be the SAME object —
    # two plans over one catalog resolve identical instances
    return False


def _match(leaf, p) -> bool:
    """Does a plan leaf hold parameter value `p` under the identity
    transform (type-compatible exact equality)? Anything the binder
    transformed (dict codes, decimal scaling, date encoding) fails here
    and makes the statement uncacheable — by design."""
    if isinstance(p, bool) or isinstance(leaf, bool):
        return False
    if isinstance(p, int) and _int_like(leaf):
        return int(leaf) == p
    if isinstance(p, float) and _float_like(leaf):
        return float(leaf) == p
    if isinstance(p, str) and isinstance(leaf, str):
        return leaf == p
    return False


def _attribute(diffs, params, sentinels):
    """diff leaves -> ((path, param_index), ...) or None. Every leaf
    must map to exactly one parameter's (value, sentinel) pair and every
    parameter must be covered by at least one leaf."""
    patches, covered = [], set()
    for path, av, bv in diffs:
        hit = None
        for i, (p, sv) in enumerate(zip(params, sentinels)):
            if _match(av, p) and _match(bv, sv):
                hit = i
                break
        if hit is None:
            return None
        patches.append((path, hit))
        covered.add(hit)
    if covered != set(range(len(params))):
        return None
    return tuple(patches)


def _patch(node, path, value):
    """Persistent-structure rebuild of `node` with `value` at `path`;
    only nodes along the path are copied, everything else is shared
    with the cached plan (plans are read-only at execution)."""
    if not path:
        return value
    step, rest = path[0], path[1:]
    if isinstance(node, list):
        cp = list(node)
        cp[step] = _patch(node[step], rest, value)
        return cp
    if isinstance(node, tuple):
        cp = list(node)
        cp[step] = _patch(node[step], rest, value)
        return tuple(cp)
    if isinstance(node, dict):
        cp = dict(node)
        cp[step[1]] = _patch(node[step[1]], rest, value)
        return cp
    # dataclass, frozen (Expr) or not (plan nodes): copy.copy keeps
    # out-of-band attrs (_dict, segment_sizes); object.__setattr__
    # writes through frozen-ness
    cp = copy.copy(node)
    object.__setattr__(cp, step, _patch(getattr(node, step), rest, value))
    return cp


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlanCacheEntry:
    digest: str
    db: str
    phys: object                       # cached physical plan; None if negative
    patches: Optional[Tuple]           # None => known-uncacheable
    n_params: int
    param_kinds: Tuple[str, ...]
    # per referenced table: (table, id(stats) or None, stats_fresh)
    table_states: Tuple
    schema_version: int
    reason: str = ""                   # why uncacheable (negative entries)
    hits: int = 0
    # shape digest of the cached plan (EXPLAIN text hash), computed on
    # the first hit and reused — hits identify the SAME plan, so
    # re-hashing per execution would be pure waste
    plan_digest: str = ""
    # memoized batchable_plan() verdict: None = not yet asked, "" =
    # batchable, else the blocking reason (the serving tier asks on
    # every coalescing probe; the plan never changes after publication)
    batch_reason: Optional[str] = None


def _plan_hazards(phys):
    """Walk the physical plan for referenced tables and disqualifying
    embedded state. Returns (tables, reason_or_None)."""
    tables, reason = [], None
    stack, seen = [phys], set()
    while stack:
        x = stack.pop()
        if x is None or id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, RuntimeDictionary):
            # filled/reset per execution (group_concat output state):
            # sharing it across cached executions would race
            reason = reason or "runtime dictionary state in plan"
            continue
        if _is_dc(x):
            for attr in ("table", "inner_table"):
                t = getattr(x, attr, None)
                if t is None:
                    continue
                tables.append(t)
                if getattr(t, "_anonymous", False):
                    reason = reason or "plan-time materialized table"
                if getattr(getattr(t, "schema", None), "partition",
                           None) is not None:
                    # partition pruning consumes values non-identically
                    # (v % n_parts, range bisects) — coincidental
                    # identity at fill time would patch wrong part ids
                    reason = reason or "partitioned table"
            if str(getattr(x, "db", "")).lower() == "information_schema":
                reason = reason or "information_schema source"
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return tables, reason


def _table_states(tables) -> Tuple:
    out, seen = [], set()
    for t in tables:
        if id(t) in seen:
            continue
        seen.add(id(t))
        s = getattr(t, "stats", None)
        out.append((t, None if s is None else id(s),
                    s is not None and s.version == t.version))
    return tuple(out)


def build_entry(stmt, phys, info: StmtInfo, digest: str, db: str,
                schema_version: int, plan_sentinel, subplan_used):
    """Verify cacheability of `phys` for `stmt` and build the entry.
    `plan_sentinel(stmt2)` must run the exact planning pipeline the real
    plan used; `subplan_used()` reports whether planning executed a
    plan-time subquery (which bakes data, not just shape)."""
    tables, reason = _plan_hazards(phys)
    states = _table_states(tables)

    def entry(phys_, patches, why=""):
        return PlanCacheEntry(
            digest=digest, db=db, phys=phys_, patches=patches,
            n_params=len(info.params), param_kinds=info.kinds,
            table_states=states, schema_version=schema_version, reason=why)

    if subplan_used():
        return entry(None, None, "plan-time subquery/CTE execution")
    if reason:
        return entry(None, None, reason)
    if not info.params:
        return entry(phys, ())
    sentinels = make_sentinels(info.params)
    try:
        it = iter(sentinels)
        sstmt = transform_literals(stmt, lambda v: next(it))
        sphys = plan_sentinel(sstmt)
    except Exception:  # noqa: BLE001 — any sentinel failure just refuses
        return entry(None, None, "sentinel planning failed")
    if subplan_used():
        return entry(None, None, "plan-time subquery/CTE execution")
    diffs: List = []
    if not _diff(phys, sphys, (), diffs):
        return entry(None, None, "value-dependent plan shape")
    patches = _attribute(diffs, info.params, sentinels)
    if patches is None:
        return entry(None, None, "literal not traceable to a plan slot")
    return entry(phys, patches)


def instantiate(entry: PlanCacheEntry, params) -> object:
    """Cached plan with `params` bound into the verified slots."""
    plan = entry.phys
    for path, idx in entry.patches:
        plan = _patch(plan, path, params[idx])
    return plan


def batchable_plan(entry: PlanCacheEntry) -> str:
    """'' when `entry`'s plan can carry several sessions' parameter
    vectors in ONE gathered dispatch (the serving tier's cross-session
    micro-batching), else the blocking reason.

    Batchable shape: a ``cond_covered`` PPointGet, optionally under a
    fused Projection chain, whose verified patch slots ALL live in the
    access path (``key_values``, or the ``pushed_cond`` the unique-index
    probe subsumes). The projection pipeline is then parameter-free —
    identical for every member — so one pass over the gathered union of
    every member's fetched rows followed by a positional split yields
    exactly what N singleton executions would have produced."""
    r = entry.batch_reason
    if r is None:
        r = _batchable_reason(entry)
        entry.batch_reason = r
    return r


def _batchable_reason(entry: PlanCacheEntry) -> str:
    from tidb_tpu_torch.planner.physical import PPointGet, PProjection

    if entry.patches is None or entry.phys is None:
        return "uncacheable"
    node = entry.phys
    while isinstance(node, PProjection):
        node = node.children[0]
    if not isinstance(node, PPointGet):
        return "not a covered point get"
    if not node.cond_covered:
        return "residual filter over fetched rows"
    for path, _idx in entry.patches:
        names = [p for p in path if isinstance(p, str)]
        anchor = next((n for n in names if n != "children"), "")
        if anchor not in ("key_values", "pushed_cond"):
            return f"param outside the access path ({anchor or '?'})"
    return ""


def _literal_expr(e) -> bool:
    """True when `e` evaluates to a constant from its text alone: a
    literal, or a sign applied to a numeric literal. Deliberately
    stricter than the binder's constant folding — functions (NOW()),
    casts and variables bind fine on the singleton path but are refused
    here so a group-committed member can never observe a different
    evaluation context than its singleton execution would have."""
    if isinstance(e, (A.ENum, A.EStr, A.ENull, A.EBool)):
        return True
    if isinstance(e, A.EUnary) and e.op in ("-", "+"):
        return isinstance(e.arg, A.ENum)
    return False


def _point_where(stmt) -> Optional[Tuple[str, object]]:
    """(column, literal value AST) for a WHERE of exactly `col = lit`
    (either operand order); None for any other shape."""
    w = getattr(stmt, "where", None)
    if not isinstance(w, A.EBinary) or w.op != "=":
        return None
    name, lit = w.left, w.right
    if _literal_expr(name) and isinstance(lit, A.EName):
        name, lit = lit, name
    if not isinstance(name, A.EName) or not _literal_expr(lit):
        return None
    tname = stmt.table.name.lower()
    alias = (stmt.table.alias or stmt.table.name).lower()
    if name.qualifier and name.qualifier.lower() not in (tname, alias):
        return None
    return name.name, lit


def classify_dml(stmt) -> Tuple[str, Optional[dict]]:
    """Structural half of the group-commit DML classifier:
    ('', parts) when `stmt` has a shape the write batcher can coalesce,
    else (reason, None). Schema-dependent gates (unique index on the
    WHERE column, SET columns outside every index, value binding) run
    in Session.dml_batch_probe, which owns the catalog.

    Coalescible shapes — chosen so N members applied as ONE engine pass
    inside one transaction are provably equal to N serial singletons:

      * INSERT ... VALUES with purely literal rows (no SELECT source,
        no REPLACE/ON DUPLICATE KEY — their conflict flows are
        per-row-stateful);
      * point UPDATE: single table, WHERE col = literal, every SET
        value a literal or one ``col ± literal`` step over this table's
        own columns (host-evaluable at the probed rows);
      * point DELETE: single table, WHERE col = literal.
    """
    if isinstance(stmt, A.InsertStmt):
        if stmt.select is not None:
            return "INSERT ... SELECT", None
        if stmt.replace or stmt.on_dup:
            return "REPLACE / ON DUPLICATE KEY UPDATE", None
        if not stmt.rows:
            return "no VALUES rows", None
        for row in stmt.rows:
            for cell in row:
                if not _literal_expr(cell):
                    return "non-literal INSERT value", None
        return "", {"kind": "insert"}
    if isinstance(stmt, A.UpdateStmt):
        if stmt.from_ is not None:
            return "multi-table UPDATE", None
        point = _point_where(stmt)
        if point is None:
            return "WHERE is not `col = literal`", None
        sets = []
        for name_ast, val_ast in stmt.sets:
            if name_ast.qualifier:
                return "qualified SET column", None
            if _literal_expr(val_ast):
                sets.append((name_ast.name, ("const", val_ast)))
                continue
            # one additive step over a column of this table:
            # col ± literal (or literal + col)
            if (isinstance(val_ast, A.EBinary) and val_ast.op in ("+", "-")):
                lhs, rhs = val_ast.left, val_ast.right
                if (isinstance(lhs, A.EName) and not lhs.qualifier
                        and _literal_expr(rhs)):
                    sets.append((name_ast.name,
                                 ("delta", lhs.name, val_ast.op, rhs, False)))
                    continue
                if (val_ast.op == "+" and isinstance(rhs, A.EName)
                        and not rhs.qualifier and _literal_expr(lhs)):
                    sets.append((name_ast.name,
                                 ("delta", rhs.name, "+", lhs, False)))
                    continue
            return "SET value beyond literal / col±literal", None
        return "", {"kind": "update", "where": point, "sets": sets}
    if isinstance(stmt, A.DeleteStmt):
        if stmt.from_ is not None:
            return "multi-table DELETE", None
        point = _point_where(stmt)
        if point is None:
            return "WHERE is not `col = literal`", None
        return "", {"kind": "delete", "where": point}
    return "not a DML statement", None


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------


class PlanCache:
    """Instance-wide LRU over verified plan entries (the catalog owns
    one, like the statements-summary store). Thread-safe; entries are
    immutable after publication."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        from tidb_tpu_torch.analysis import sanitizer as _san

        self.lock = _san.tracked_lock("PlanCache.lock")
        self.capacity = capacity
        self._od: "OrderedDict" = OrderedDict()
        self._schema_version = -1
        self.hits = 0
        self.misses = 0
        self.bypasses = 0
        self.evictions = 0
        self.invalidations = 0
        self._bypass_reasons: dict = {}

    @staticmethod
    def _metric(event: str, n: int = 1) -> None:
        from tidb_tpu_torch.utils.metrics import PLAN_CACHE_TOTAL

        PLAN_CACHE_TOTAL.inc(n, event=event)

    def _sync_schema_locked(self, schema_version: int) -> None:
        if schema_version != self._schema_version:
            if self._od:
                self.invalidations += len(self._od)
                self._metric("invalidate", len(self._od))
                self._od.clear()
            self._schema_version = schema_version

    @staticmethod
    def _valid(e: PlanCacheEntry) -> bool:
        for t, stats_id, fresh in e.table_states:
            s = getattr(t, "stats", None)
            if (None if s is None else id(s)) != stats_id:
                return False  # ANALYZE (or auto-analyze) since planning
            if (s is not None and s.version == t.version) != fresh:
                return False  # freshness flipped: DML since planning
        return True

    def on_schema_change(self, schema_version: int) -> None:
        """Eager invalidation hook (catalog.schema_version setter):
        release pinned plans/tables at the DDL, not at the next probe."""
        with self.lock:
            self._sync_schema_locked(schema_version)

    def lookup(self, key, schema_version: int,
               capacity: Optional[int] = None) -> Optional[PlanCacheEntry]:
        with self.lock:
            if capacity is not None:
                self.capacity = max(1, int(capacity))
            self._sync_schema_locked(schema_version)
            e = self._od.get(key)
            if e is None:
                return None
            if not self._valid(e):
                del self._od[key]
                self.invalidations += 1
                self._metric("invalidate")
                return None
            self._od.move_to_end(key)
            return e

    def store(self, key, entry: PlanCacheEntry, schema_version: int) -> None:
        with self.lock:
            self._sync_schema_locked(schema_version)
            if entry.schema_version != self._schema_version:
                return  # DDL raced the fill; the entry is already stale
            self._od[key] = entry
            self._od.move_to_end(key)
            while len(self._od) > self.capacity:
                self._od.popitem(last=False)
                self.evictions += 1
                self._metric("evict")

    def note_hit(self, entry: PlanCacheEntry) -> None:
        with self.lock:
            self.hits += 1
            entry.hits += 1
        self._metric("hit")

    def note_miss(self) -> None:
        with self.lock:
            self.misses += 1
        self._metric("miss")

    def note_bypass(self, reason: str) -> None:
        with self.lock:
            self.bypasses += 1
            self._bypass_reasons[reason] = \
                self._bypass_reasons.get(reason, 0) + 1
        self._metric("bypass")

    def invalidate_digest(self, digest: str) -> int:
        """Drop every entry of one statement digest (keys lead with the
        digest). Plan feedback calls this when a NEW
        significant cardinality observation lands: a cached plan would
        otherwise keep serving the pre-feedback shape forever. O(size)
        over a small LRU; counted as invalidations."""
        with self.lock:
            doomed = [k for k in self._od
                      if isinstance(k, tuple) and k and k[0] == digest]
            for k in doomed:
                del self._od[k]
            if doomed:
                self.invalidations += len(doomed)
                self._metric("invalidate", len(doomed))
            return len(doomed)

    def clear(self) -> None:
        with self.lock:
            self._od.clear()

    def __len__(self) -> int:
        with self.lock:
            return len(self._od)

    def stats_dict(self, top: int = 50) -> dict:
        """JSON-ready snapshot (the /plan_cache endpoint payload)."""
        with self.lock:
            entries = [{
                "digest": e.digest, "db": e.db, "params": e.n_params,
                "cacheable": e.patches is not None, "hits": e.hits,
                "reason": e.reason,
            } for e in self._od.values()]
            snap = {
                "size": len(self._od), "capacity": self.capacity,
                "schema_version": self._schema_version,
                "hits": self.hits, "misses": self.misses,
                "bypasses": self.bypasses, "evictions": self.evictions,
                "invalidations": self.invalidations,
                "bypass_reasons": dict(self._bypass_reasons),
            }
        entries.sort(key=lambda d: d["hits"], reverse=True)
        snap["entries"] = entries[:max(0, top)]
        return snap
