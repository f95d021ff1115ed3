"""Logical plan nodes and the AST -> logical-plan builder
(ref: planner/core PlanBuilder + logical operators).

Subquery strategy (round 1): uncorrelated IN-subqueries in WHERE conjuncts
become semi/anti joins (the decorrelation the reference's planner does);
uncorrelated EXISTS and scalar subqueries are evaluated eagerly through a
session-provided callback and folded to constants (the reference likewise
evaluates "max-one-row" subqueries at optimize time). Correlated
subqueries raise UnsupportedError.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from tidb_tpu_torch.errors import PlanError, SchemaError, UnsupportedError
from tidb_tpu_torch.expression.expr import Call, ColumnRef, Expr, Literal, Lookup, walk
from tidb_tpu_torch.chunk.dictionary import Dictionary
from tidb_tpu_torch.parser import ast as A
from tidb_tpu_torch.planner.binder import AGG_FUNCS, Binder, PlanCol, Scope, ast_key
from tidb_tpu_torch.types import (
    BOOL,
    FLOAT64,
    INT64,
    STRING,
    SQLType,
    TypeKind,
    common_type,
    decimal_type,
)

__all__ = [
    "LogicalPlan", "LScan", "LSelection", "LProjection", "LAggregate",
    "AggSpec", "LJoin", "LSort", "LLimit", "LUnion", "LWindow",
    "build_select", "BuildContext", "expr_display",
]


# ---------------------------------------------------------------------------
# nodes
# ---------------------------------------------------------------------------

@dataclass
class LogicalPlan:
    schema: List[PlanCol] = field(default_factory=list)
    children: List["LogicalPlan"] = field(default_factory=list)

    @property
    def child(self) -> "LogicalPlan":
        return self.children[0]


@dataclass
class LScan(LogicalPlan):
    db: str = ""
    table_name: str = ""
    table: object = None  # storage.Table
    # predicate pushed into the scan fragment (the coprocessor analogue)
    pushed_cond: Optional[Expr] = None


@dataclass
class LSelection(LogicalPlan):
    cond: Expr = None


@dataclass
class LProjection(LogicalPlan):
    exprs: List[Expr] = field(default_factory=list)
    n_visible: Optional[int] = None  # hidden ORDER BY helper columns follow


CORE_AGGS = ("sum", "count", "avg", "min", "max")


def core_generic_agg(group_exprs, aggs) -> bool:
    """THE plan-static eligibility predicate for the device generic-agg
    kernels (sort-based grouping): grouped, no DISTINCT, core funcs
    only. One definition shared by the routing gates in
    executor/builder.py, executor/pipeline.py and executor/aggregate.py
    — context-dependent gates (tidb_enable_tpu_exec etc.) stay at the
    call sites."""
    return bool(group_exprs) and not any(a.distinct for a in aggs) \
        and all(a.func in CORE_AGGS for a in aggs)


@dataclass
class AggSpec:
    uid: str
    func: str            # sum | count | avg | min | max | bit_* | group_concat
    arg: Optional[Expr]  # None for COUNT(*)
    distinct: bool = False
    type_: SQLType = INT64
    # GROUP_CONCAT runtime info: (separator, order_desc_or_None,
    # output RuntimeDictionary to fill at execution)
    extra: Optional[tuple] = None


@dataclass
class LAggregate(LogicalPlan):
    group_exprs: List[Expr] = field(default_factory=list)  # over child schema
    group_uids: List[str] = field(default_factory=list)
    aggs: List[AggSpec] = field(default_factory=list)


@dataclass
class LJoin(LogicalPlan):
    kind: str = "inner"  # inner | left | semi | anti | cross
    # equi conditions as (left_expr, right_expr) over the resp. child schemas
    eq_conds: List[Tuple[Expr, Expr]] = field(default_factory=list)
    other_cond: Optional[Expr] = None
    # anti joins from NOT EXISTS keep NULL-key probe rows (no match ->
    # EXISTS is false -> NOT EXISTS true), unlike NOT IN's NULL semantics
    exists_sem: bool = False
    # memo-chosen index access path for the INNER (right-child) side:
    # index name on the right child's base table whose key prefix is the
    # join key set — the lowering emits an IndexJoin instead of a hash
    # join (planner/cascades.py; SURVEY.md:88-89 access-path search)
    index_join: Optional[str] = None


@dataclass
class LWindow(LogicalPlan):
    """One window function: child schema + one output column (out_uid).
    Default frames: whole partition without ORDER BY; RANGE UNBOUNDED
    PRECEDING .. CURRENT ROW (peers included) with it."""

    func: str = "row_number"
    args: List[Expr] = field(default_factory=list)
    partition_by: List[Expr] = field(default_factory=list)
    order_by: List[Tuple[Expr, bool]] = field(default_factory=list)
    out_uid: str = ""
    out_type: SQLType = INT64
    # positional params: LEAD/LAG -> (offset, default_value_or_None,
    # default_is_null); NTILE -> (n,)
    params: tuple = ()
    # explicit ROWS frame bounds (ast.EWindow.frame); None = defaults
    frame: object = None


@dataclass
class LSort(LogicalPlan):
    items: List[Tuple[Expr, bool]] = field(default_factory=list)  # (expr, desc)


@dataclass
class LLimit(LogicalPlan):
    count: int = 0
    offset: int = 0


@dataclass
class LUnion(LogicalPlan):
    all: bool = False


# ---------------------------------------------------------------------------
# display helper (EXPLAIN / auto column names)
# ---------------------------------------------------------------------------

def expr_display(e) -> str:
    """Reconstruct readable SQL-ish text from an AST expression."""
    if isinstance(e, A.EName):
        return f"{e.qualifier}.{e.name}" if e.qualifier else e.name
    if isinstance(e, A.ENum):
        return e.text
    if isinstance(e, A.EStr):
        return f"'{e.value}'"
    if isinstance(e, A.ENull):
        return "NULL"
    if isinstance(e, A.EBool):
        return "TRUE" if e.value else "FALSE"
    if isinstance(e, A.EStar):
        return f"{e.qualifier}.*" if e.qualifier else "*"
    if isinstance(e, A.EBinary):
        return f"{expr_display(e.left)} {e.op} {expr_display(e.right)}"
    if isinstance(e, A.EUnary):
        return f"{e.op} {expr_display(e.arg)}"
    if isinstance(e, A.EFunc):
        inner = ", ".join(expr_display(a) for a in e.args)
        if e.distinct:
            inner = "distinct " + inner
        return f"{e.name}({inner})"
    if isinstance(e, A.ECase):
        return "case ... end"
    if isinstance(e, A.ECast):
        return f"cast({expr_display(e.arg)} as {e.type_name})"
    if isinstance(e, A.EIn):
        return f"{expr_display(e.arg)} in (...)"
    if isinstance(e, A.EBetween):
        return f"{expr_display(e.arg)} between ..."
    if isinstance(e, A.ELike):
        return f"{expr_display(e.arg)} like {expr_display(e.pattern)}"
    if isinstance(e, A.EIsNull):
        return f"{expr_display(e.arg)} is {'not ' if e.negated else ''}null"
    if isinstance(e, (A.EExists,)):
        return "exists(...)"
    if isinstance(e, (A.ESubquery,)):
        return "(subquery)"
    if isinstance(e, A.EInterval):
        return f"interval {expr_display(e.value)} {e.unit}"
    return type(e).__name__


# ---------------------------------------------------------------------------
# build context
# ---------------------------------------------------------------------------

@dataclass
class BuildContext:
    catalog: object
    db: str = "test"
    binder: Binder = field(default_factory=Binder)
    # session-provided: execute a logical plan, return list of row tuples of
    # python values in device repr (used for scalar/EXISTS subqueries)
    execute_subplan: Optional[Callable] = None
    ctes: Dict[str, object] = field(default_factory=dict)  # name -> AST select
    cte_multi: set = field(default_factory=set)   # names referenced >= 2x
    cte_tables: Dict[str, tuple] = field(default_factory=dict)  # materialized
    # body ids whose every reference is duplicate-insensitive (all inside
    # IN/EXISTS semi-join zones): materialization may dedup + rewrite
    cte_duponly: set = field(default_factory=set)


def _conjuncts(e) -> List:
    if isinstance(e, A.EBinary) and e.op == "and":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _and_ir(parts: List[Expr]) -> Optional[Expr]:
    out = None
    for p in parts:
        out = p if out is None else Call(type_=BOOL, op="and", args=(out, p))
    return out


# ---------------------------------------------------------------------------
# FROM clause
# ---------------------------------------------------------------------------

def _count_table_refs(node, name: str) -> int:
    """Occurrences of `name` as an unqualified TableName in the AST,
    NOT descending into scopes where an inner WITH shadows the name."""
    import dataclasses as _dc

    count = 0
    stack = [node]
    seen_root = node
    while stack:
        e = stack.pop()
        if isinstance(e, A.TableName):
            if e.name == name and e.schema is None:
                count += 1
            continue
        if (isinstance(e, A.SelectStmt) and e is not seen_root
                and any(c.name == name for c in e.ctes)):
            continue  # inner WITH shadows the name: out of scope
        if _dc.is_dataclass(e) and not isinstance(e, type):
            for f in _dc.fields(e):
                v = getattr(e, f.name)
                vs = v if isinstance(v, (list, tuple)) else [v]
                for item in vs:
                    if isinstance(item, tuple):
                        stack.extend(item)
                    elif _dc.is_dataclass(item):
                        stack.append(item)
    return count


_AGG_FUNC_NAMES = {"sum", "count", "avg", "min", "max", "group_concat",
                   "stddev", "std", "stddev_pop", "stddev_samp", "variance",
                   "var_pop", "var_samp", "bit_and", "bit_or", "bit_xor",
                   "any_value"}


def _multiplicity_sensitive(node) -> bool:
    """Does any select inside `node` aggregate, window, or LIMIT? If so,
    row multiplicity of its inputs can change its result and inputs must
    not be deduplicated."""
    import dataclasses as _dc

    stack = [node]
    while stack:
        e = stack.pop()
        if isinstance(e, A.SelectStmt) and (
                e.group_by or e.having is not None or e.limit is not None
                or e.offset is not None):
            return True
        if isinstance(e, A.UnionStmt) and (
                e.limit is not None or e.offset is not None
                or e.all or e.op != "union"):
            # LIMIT/OFFSET pick rows by position; UNION ALL / EXCEPT /
            # INTERSECT have bag semantics — all multiplicity-dependent
            return True
        if isinstance(e, A.EFunc) and e.name in _AGG_FUNC_NAMES:
            return True
        if isinstance(e, A.EWindow):
            return True
        if _dc.is_dataclass(e) and not isinstance(e, type):
            for f in _dc.fields(e):
                v = getattr(e, f.name)
                vs = v if isinstance(v, (list, tuple)) else [v]
                for item in vs:
                    if isinstance(item, tuple):
                        stack.extend(item)
                    elif _dc.is_dataclass(item):
                        stack.append(item)
    return False


def _cte_semi_only(stmt, name: str) -> bool:
    """True when EVERY reference to CTE `name` sits inside an IN/EXISTS
    subquery that contains no aggregate/window/LIMIT — a pure semi-join
    zone where only the DISTINCT row set matters. Such a CTE may be
    deduplicated at materialization (set(join(A,B)) == set(join(set(A),
    set(B))), and filters/projections commute with dedup likewise).
    Ref: the reference planner's semi-join dedup of subquery sources."""
    import dataclasses as _dc

    stack = [stmt]
    while stack:
        e = stack.pop()
        if isinstance(e, A.TableName):
            if e.name == name and e.schema is None:
                return False  # a reference OUTSIDE every semi zone
            continue
        if (isinstance(e, A.SelectStmt) and e is not stmt
                and any(c.name == name for c in e.ctes)):
            continue  # inner WITH shadows the name
        sub_zones = []
        if isinstance(e, A.EIn) and e.subquery is not None:
            sub_zones.append(e.subquery)
        elif isinstance(e, A.EExists):
            sub_zones.append(e.subquery)
        for z in sub_zones:
            if _count_table_refs(z, name) and _multiplicity_sensitive(z):
                return False  # referenced where multiplicity matters
        if sub_zones:
            # zone contents are dup-safe; outer parts (e.g. IN's lhs arg
            # and value list) still need scanning
            if isinstance(e, A.EIn):
                stack.append(e.arg)
                stack.extend(e.values or [])
            continue
        if _dc.is_dataclass(e) and not isinstance(e, type):
            for f in _dc.fields(e):
                v = getattr(e, f.name)
                vs = v if isinstance(v, (list, tuple)) else [v]
                for item in vs:
                    if isinstance(item, tuple):
                        stack.extend(item)
                    elif _dc.is_dataclass(item):
                        stack.append(item)
    return True


def _try_selfjoin_distinctness(stmt):
    """Rewrite the duplicate-detection self-join — TPC-DS Q95's ws_wh
    shape (SURVEY.md:131) — into a grouped min/max distinctness test:

        SELECT t1.a FROM t t1, t t2
        WHERE t1.a = t2.a AND t1.b <> t2.b
      =set=
        SELECT a FROM t WHERE a IS NOT NULL AND b IS NOT NULL
        GROUP BY a HAVING MIN(b) <> MAX(b)

    Set-equal only (the join multiplies rows per matching pair), so
    callers must be in a duplicate-insensitive context (semi-join zones,
    dedup'd CTE materialization). The join form is O(sum of group^2)
    rows through a hash join; the grouped form is one segment min/max.
    Returns the rewritten SelectStmt or None if the shape doesn't match.
    """
    if not isinstance(stmt, A.SelectStmt) or stmt.group_by or stmt.having \
            or stmt.limit is not None or stmt.offset is not None \
            or len(stmt.items) != 1 or stmt.ctes:
        return None
    f = stmt.from_
    if not (isinstance(f, A.Join) and f.kind in ("cross", "inner")
            and f.on is None and f.using is None
            and isinstance(f.left, A.TableName)
            and isinstance(f.right, A.TableName)
            and f.left.name == f.right.name
            and f.left.schema == f.right.schema):
        return None
    a1 = f.left.alias or f.left.name
    a2 = f.right.alias or f.right.name
    if a1 == a2:
        return None
    aliases = {a1, a2}

    def _same_col_pair(e, op):
        """e is `q1.x <op> q2.x` with {q1,q2} == aliases -> x, else None."""
        if (isinstance(e, A.EBinary) and e.op == op
                and isinstance(e.left, A.EName) and isinstance(e.right, A.EName)
                and e.left.name == e.right.name
                and {e.left.qualifier, e.right.qualifier} == aliases):
            return e.left.name
        return None

    key_cols, diff_cols, other = [], [], []
    for conj in _conjuncts(stmt.where) if stmt.where is not None else []:
        k = _same_col_pair(conj, "=")
        if k is not None:
            key_cols.append(k)
            continue
        d = _same_col_pair(conj, "<>") or _same_col_pair(conj, "!=")
        if d is not None:
            diff_cols.append(d)
            continue
        other.append(conj)
    if not key_cols or len(diff_cols) != 1 or other:
        return None
    item = stmt.items[0]
    if not (isinstance(item.expr, A.EName)
            and (item.expr.qualifier in aliases or item.expr.qualifier is None)
            and item.expr.name in key_cols):
        return None
    diff = diff_cols[0]
    not_null = None
    for c in dict.fromkeys(key_cols + [diff]):  # ordered, unique
        cond = A.EIsNull(arg=A.EName(name=c), negated=True)
        not_null = cond if not_null is None else A.EBinary(
            op="and", left=not_null, right=cond)
    return A.SelectStmt(
        items=[A.SelectItem(expr=A.EName(name=item.expr.name),
                            alias=item.alias or item.expr.name)],
        from_=A.TableName(name=f.left.name, schema=f.left.schema),
        where=not_null,
        group_by=[A.EName(name=k) for k in key_cols],
        having=A.EBinary(
            op="<>",
            left=A.EFunc(name="min", args=[A.EName(name=diff)]),
            right=A.EFunc(name="max", args=[A.EName(name=diff)])),
    )


def _materialized_cte_scan(name: str, ctx: BuildContext) -> LogicalPlan:
    """Plan + run the CTE body once; later references scan the
    materialized rows from an anonymous host table."""
    body_ast = ctx.ctes[name]
    hit = ctx.cte_tables.get(id(body_ast))
    if hit is None:
        from tidb_tpu_torch.storage.table import ColumnInfo, Table, TableSchema

        dup_only = id(body_ast) in ctx.cte_duponly
        run_ast = body_ast
        if dup_only:
            # every consumer is a semi-join zone: the duplicate-detection
            # self-join may collapse to a grouped min/max distinctness
            # test, and the materialized rows may dedup either way
            run_ast = _try_selfjoin_distinctness(body_ast) or body_ast
        body = build_select(run_ast, ctx, None)
        rows = ctx.execute_subplan(body)
        if dup_only and rows:
            rows = list(dict.fromkeys(map(tuple, rows)))
        schema = TableSchema(
            name=f"__cte_{name}__",
            columns=[ColumnInfo(name=c.name or c.uid, type_=c.type_)
                     for c in body.schema])
        # uniquify duplicate display names (SELECT a, a ...)
        seen = {}
        for c in schema.columns:
            if c.name in seen:
                seen[c.name] += 1
                c.name = f"{c.name}_{seen[c.name]}"
            else:
                seen[c.name] = 0
        table = Table(schema)
        table._anonymous = True  # plan-time temp: exempt from priv walk
        if rows:
            table.insert_rows(rows)
        # one materialization per body, observable: the regression test
        # for the ws_wh rescan asserts this site fires once however
        # many consumers scan the result (a site EVENT, not a device
        # round trip — EXPLAIN's dispatch accounting must stay honest)
        # segment the materialized result: every consumer then scans the
        # encoded, zone-mapped form instead of raw rows. The session
        # threads its columnar sysvars through session_info so SET
        # tidb_tpu_columnar_enable=0 skips the encode entirely.
        si = ctx.binder.session_info
        if si.get("columnar_enable", True):
            from tidb_tpu_torch.columnar.store import build_for_result

            build_for_result(
                table, segment_rows=int(si.get("segment_rows", 1 << 16)))
        hit = (table, [c.name for c in schema.columns])
        ctx.cte_tables[id(body_ast)] = hit
    table, names = hit
    cols = [
        PlanCol(uid=ctx.binder.new_uid(n), name=n,
                type_=table.schema.col(n).type_,
                dict_=table.dicts.get(n))
        for n in names
    ]
    return LScan(schema=cols, db=ctx.db, table_name=f"__cte_{name}__",
                 table=table)


def build_from(src, ctx: BuildContext, outer: Optional[Scope]) -> Tuple[LogicalPlan, Scope]:
    if src is None:
        # SELECT without FROM: one-row dual table
        return LScan(schema=[], db=ctx.db, table_name="", table=None), Scope([], outer)

    if isinstance(src, A.TableName):
        alias = src.alias or src.name
        if src.name in ctx.ctes and src.schema is None:
            if (id(ctx.ctes[src.name]) in ctx.cte_multi
                    and ctx.execute_subplan is not None):
                sub = _materialized_cte_scan(src.name, ctx)
            else:
                sub = build_select(ctx.ctes[src.name], ctx, outer)
            cols = [
                dataclasses.replace(c, qualifier=alias) for c in sub.schema
            ]
            sub = _realias(sub, cols)
            return sub, Scope(cols, outer)
        db = src.schema or ctx.db
        view = ctx.catalog.view(db, src.name)
        if view is not None:
            # a view is a stored SELECT expanded like a derived table
            # (ref: the view expansion in planner/core's PlanBuilder)
            vcols, vstmt, _sql = view
            depth = getattr(ctx, "_view_depth", 0)
            if depth > 16:
                raise PlanError(f"view nesting too deep at {src.name!r}")
            # the body resolves in the view's DEFINING database with a
            # clean name space: no caller CTEs (they must not shadow the
            # view's tables) and no outer correlation
            ctx._view_depth = depth + 1
            saved_db, saved_ctes = ctx.db, ctx.ctes
            ctx.db, ctx.ctes = db, {}
            try:
                sub = build_select(vstmt, ctx, None)
            finally:
                ctx._view_depth = depth
                ctx.db, ctx.ctes = saved_db, saved_ctes
            cols = [dataclasses.replace(c, qualifier=alias) for c in sub.schema]
            if vcols is not None:
                if len(vcols) != len(cols):
                    raise PlanError(
                        f"view {src.name!r} has {len(vcols)} columns, "
                        f"SELECT yields {len(cols)}")
                cols = [dataclasses.replace(c, name=n)
                        for c, n in zip(cols, vcols)]
            sub = _realias(sub, cols)
            sub._block_boundary = True
            return sub, Scope(cols, outer)
        table = ctx.catalog.table(db, src.name)
        cols = [
            PlanCol(
                uid=ctx.binder.new_uid(f"{src.name}.{c.name}"),
                name=c.name,
                type_=c.type_,
                qualifier=alias,
                dict_=table.dicts.get(c.name),
            )
            for c in table.schema.public_columns()
        ]
        # hidden physical-rowid pseudo-column: resolvable by name (the
        # multi-table DML path selects it through joins), invisible to
        # SELECT * and pruned away when unreferenced
        cols.append(PlanCol(
            uid=ctx.binder.new_uid(f"{src.name}.__rowid__"),
            name="__rowid__", type_=INT64, qualifier=alias, hidden=True))
        return (
            LScan(schema=cols, db=db, table_name=src.name, table=table),
            Scope(cols, outer),
        )

    if isinstance(src, A.SubqueryTable):
        sub = build_select(src.select, ctx, outer)
        cols = [dataclasses.replace(c, qualifier=src.alias) for c in sub.schema]
        sub = _realias(sub, cols)
        # query-block boundary: outer optimizer hints (LEADING) stop here
        sub._block_boundary = True
        return sub, Scope(cols, outer)

    if isinstance(src, A.Join):
        if src.kind == "full":
            return _build_full_join(src, ctx, outer)
        left, lscope = build_from(src.left, ctx, outer)
        right, rscope = build_from(src.right, ctx, outer)
        if src.kind == "right":
            left, right = right, left
            lscope, rscope = rscope, lscope
            kind = "left"
        else:
            kind = src.kind
        combined = Scope(lscope.cols + rscope.cols, outer)
        eq, other = [], []
        cond_asts = []
        if src.on is not None:
            cond_asts = _conjuncts(src.on)
        elif src.using:
            for name in src.using:
                cond_asts.append(
                    A.EBinary("=", A.EName(name, _qual_of(lscope, name)),
                              A.EName(name, _qual_of(rscope, name)))
                )
        left_uids = {c.uid for c in lscope.cols}
        right_uids = {c.uid for c in rscope.cols}
        for cast_ in cond_asts:
            bound = ctx.binder.bind_expr(cast_, combined)
            side = _classify_eq(bound, left_uids, right_uids)
            if side == "lr":
                eq.append((bound.args[0], bound.args[1]))
            elif side == "rl":
                eq.append((bound.args[1], bound.args[0]))
            else:
                other.append(bound)
        join = LJoin(
            schema=lscope.cols + rscope.cols,
            children=[left, right],
            kind=kind,
            eq_conds=eq,
            other_cond=_and_ir(other),
        )
        if kind == "left":
            # right-side columns become nullable — semantics only, repr same
            pass
        return join, combined

    raise PlanError(f"unknown FROM source {type(src).__name__}")


def _qual_of(scope: Scope, name: str) -> Optional[str]:
    c = scope.try_resolve(name, None)
    return c.qualifier if c else None


def _classify_eq(bound: Expr, left_uids, right_uids) -> Optional[str]:
    if not (isinstance(bound, Call) and bound.op == "eq"):
        return None
    a, b = bound.args
    ua = {n.name for n in walk(a) if isinstance(n, ColumnRef)}
    ub = {n.name for n in walk(b) if isinstance(n, ColumnRef)}
    if ua and ub:
        if ua <= left_uids and ub <= right_uids:
            return "lr"
        if ua <= right_uids and ub <= left_uids:
            return "rl"
    return None


def _realias(plan: LogicalPlan, cols: List[PlanCol]) -> LogicalPlan:
    """Wrap a subplan so its schema carries new qualifiers (same uids)."""
    plan.schema = cols
    return plan


# ---------------------------------------------------------------------------
# aggregate extraction
# ---------------------------------------------------------------------------

# normalization of aggregate aliases; variance/stddev are REAL agg funcs
# (two-pass m2 states in the executor — the E[x^2]-E[x]^2 decomposition
# cancels catastrophically on large-magnitude data and is NOT used)
VARIANCE_AGGS = ("var_pop", "var_samp", "stddev_pop", "stddev_samp")
_AGG_ALIASES = {"variance": "var_pop", "std": "stddev_pop",
                "stddev": "stddev_pop", "any_value": "min"}


def _rewrite_extended_aggs(e):
    """Normalize aggregate aliases on select/having/order-by ASTs before
    collection: VARIANCE->VAR_POP, STD/STDDEV->STDDEV_POP,
    ANY_VALUE->MIN (ref: the reference's aggfuncs name canonicalization).
    """
    if not hasattr(e, "__dataclass_fields__") or isinstance(
            e, (A.SelectStmt, A.UnionStmt)):
        return e
    for f in e.__dataclass_fields__:
        v = getattr(e, f)
        if isinstance(v, list):
            setattr(e, f, [
                _rewrite_extended_aggs(x) if hasattr(x, "__dataclass_fields__")
                else (tuple(_rewrite_extended_aggs(y) if hasattr(y, "__dataclass_fields__")
                            else y for y in x) if isinstance(x, tuple) else x)
                for x in v])
        elif hasattr(v, "__dataclass_fields__") and not isinstance(
                v, (A.SelectStmt, A.UnionStmt)):
            setattr(e, f, _rewrite_extended_aggs(v))
    if isinstance(e, A.EFunc) and e.name in _AGG_ALIASES and len(e.args) == 1:
        return A.EFunc(_AGG_ALIASES[e.name], e.args, distinct=e.distinct)
    return e


def _collect_agg_calls(e, out: Dict[str, A.EFunc]):
    if isinstance(e, A.EFunc) and e.name in AGG_FUNCS:
        out.setdefault(ast_key(e), e)
        return  # no nested aggregates
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        if isinstance(v, list):
            for x in v:
                if hasattr(x, "__dataclass_fields__"):
                    _collect_agg_calls(x, out)
                elif isinstance(x, tuple):
                    for y in x:
                        if hasattr(y, "__dataclass_fields__"):
                            _collect_agg_calls(y, out)
        elif hasattr(v, "__dataclass_fields__") and not isinstance(v, (A.SelectStmt, A.UnionStmt)):
            _collect_agg_calls(v, out)


def _substitute(e, mapping: Dict[str, str]):
    """Replace AST subtrees (by structural key) with EName(uid) references."""
    k = ast_key(e)
    if k in mapping:
        return A.EName(mapping[k])
    if not hasattr(e, "__dataclass_fields__"):
        return e
    if isinstance(e, (A.SelectStmt, A.UnionStmt)):
        return e
    kwargs = {}
    for f in e.__dataclass_fields__:
        v = getattr(e, f)
        if isinstance(v, list):
            kwargs[f] = [
                tuple(_substitute(y, mapping) for y in x) if isinstance(x, tuple)
                else _substitute(x, mapping) if hasattr(x, "__dataclass_fields__")
                else x
                for x in v
            ]
        elif hasattr(v, "__dataclass_fields__") and not isinstance(v, (A.SelectStmt, A.UnionStmt)):
            kwargs[f] = _substitute(v, mapping)
        else:
            kwargs[f] = v
    return type(e)(**kwargs)


_WINDOW_FUNCS = {"row_number", "rank", "dense_rank",
                 "count", "sum", "avg", "min", "max",
                 "lead", "lag", "first_value", "last_value", "ntile"}


def _collect_window_calls(e, out: Dict[str, A.EWindow]) -> None:
    if isinstance(e, A.EWindow):
        if e.func not in _WINDOW_FUNCS:
            raise UnsupportedError(f"window function {e.func.upper()}")
        out.setdefault(ast_key(e), e)
        return  # no windows nested inside windows
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        if isinstance(v, list):
            for x in v:
                if hasattr(x, "__dataclass_fields__"):
                    _collect_window_calls(x, out)
        elif hasattr(v, "__dataclass_fields__") and not isinstance(v, (A.SelectStmt, A.UnionStmt)):
            _collect_window_calls(v, out)


def _window_default_repr(binder, d0: Literal, arg: Expr, fname: str):
    """LEAD/LAG default literal -> the argument column's DEVICE
    representation (dict code for strings, scaled int for decimals),
    since the executor substitutes it directly into the value array.
    Returns (value, is_null)."""
    if d0.value is None:
        return None, True
    t = arg.type_
    k = t.kind
    if k in (TypeKind.STRING, TypeKind.JSON):
        d = binder._dict_of(arg)
        if d is None:
            raise UnsupportedError(
                f"{fname.upper()} string default without dictionary context")
        s = str(d0.value) if d0.type_.kind == TypeKind.STRING else str(int(d0.value))
        code = d.code_of(s)
        if code < 0:
            raise UnsupportedError(
                f"{fname.upper()} default {s!r} not in the column dictionary")
        return int(code), False
    if k == TypeKind.DECIMAL:
        if d0.type_.kind == TypeKind.DECIMAL:
            return int(d0.value) * 10 ** (t.scale - d0.type_.scale) \
                if t.scale >= d0.type_.scale else \
                int(round(int(d0.value) / 10 ** (d0.type_.scale - t.scale))), False
        if d0.type_.kind == TypeKind.INT:
            return int(d0.value) * 10 ** t.scale, False
        if d0.type_.kind == TypeKind.FLOAT:
            return int(round(float(d0.value) * 10 ** t.scale)), False
    if k == TypeKind.FLOAT:
        v = d0.value
        if d0.type_.kind == TypeKind.DECIMAL:
            v = int(v) / 10 ** d0.type_.scale
        return float(v), False
    return d0.value, False


def _normalize_frame(w: A.EWindow):
    """One rule for both LWindow construction sites: frames don't
    apply to ranking functions or LEAD/LAG (MySQL ignores them), and
    RANGE UNBOUNDED PRECEDING..CURRENT ROW IS the default — every other
    combination executes explicitly."""
    frame = getattr(w, "frame", None)
    if frame is None:
        return None
    if w.func in ("row_number", "rank", "dense_rank", "ntile",
                  "lead", "lag"):
        return None
    if frame[0] == "range" and frame[1] == ("unbounded_preceding",) \
            and frame[2] == ("current",):
        return None
    return frame


def _plan_window(w: A.EWindow, plan: LogicalPlan, scope: Scope,
                 ctx: BuildContext):
    """Stack one LWindow node; returns (plan, widened scope, out uid)."""
    binder = ctx.binder
    part = [binder.bind_expr(e, scope) for e in w.partition_by]
    order = [(binder.bind_expr(oi.expr, scope), oi.desc) for oi in w.order_by]
    params: tuple = ()
    if w.func in ("lead", "lag", "first_value", "last_value"):
        if not w.args:
            raise PlanError(f"{w.func.upper()} needs an argument")
        if w.func in ("first_value", "last_value") and len(w.args) != 1:
            raise PlanError(f"{w.func.upper()} takes exactly one argument")
        arg = binder.bind_expr(w.args[0], scope)
        if w.func in ("lead", "lag"):
            off = 1
            if len(w.args) > 1:
                o = binder.bind_expr(w.args[1], scope)
                if not isinstance(o, Literal) or o.value is None \
                        or int(o.value) < 0:
                    raise PlanError(
                        f"{w.func.upper()} offset must be a nonnegative constant")
                off = int(o.value)
            dval, dnull = None, True
            if len(w.args) > 2:
                d0 = binder.coerce_untyped_literal(
                    binder.bind_expr(w.args[2], scope), arg.type_)
                if not isinstance(d0, Literal):
                    raise PlanError(f"{w.func.upper()} default must be constant")
                dval, dnull = _window_default_repr(binder, d0, arg, w.func)
            params = (off, dval, dnull)
        node_args = [arg]
        uid = binder.new_uid(f"win.{w.func}")
        col = PlanCol(uid=uid, name=uid, type_=arg.type_,
                      dict_=binder._dict_of(arg))
        frame = _normalize_frame(w)
        node = LWindow(schema=list(plan.schema) + [col], children=[plan],
                       func=w.func, args=node_args, partition_by=part,
                       order_by=order, out_uid=uid, out_type=arg.type_,
                       params=params, frame=frame)
        return node, Scope(list(scope.cols) + [col], scope.parent), uid
    if w.func == "ntile":
        if len(w.args) != 1:
            raise PlanError("NTILE takes one constant argument")
        nlit = binder.bind_expr(w.args[0], scope)
        if not isinstance(nlit, Literal) or nlit.value is None \
                or int(nlit.value) < 1:
            raise PlanError("NTILE argument must be a positive constant")
        uid = binder.new_uid("win.ntile")
        col = PlanCol(uid=uid, name=uid, type_=INT64)
        node = LWindow(schema=list(plan.schema) + [col], children=[plan],
                       func="ntile", args=[], partition_by=part,
                       order_by=order, out_uid=uid, out_type=INT64,
                       params=(int(nlit.value),))
        return node, Scope(list(scope.cols) + [col], scope.parent), uid
    if w.func in ("row_number", "rank", "dense_rank"):
        if w.args:
            raise PlanError(f"{w.func.upper()} takes no arguments")
        args: List[Expr] = []
        out_type = INT64
        d = None
    else:
        if w.func == "count" and (not w.args or isinstance(w.args[0], A.EStar)):
            args = []
            out_type = INT64
            d = None
        else:
            if len(w.args) != 1:
                raise PlanError(f"window {w.func.upper()} takes one argument")
            arg = binder.bind_expr(w.args[0], scope)
            args = [arg]
            out_type = (INT64 if w.func == "count"
                        else _agg_result_type(w.func, arg))
            d = binder._dict_of(arg) if w.func in ("min", "max") else None
    uid = binder.new_uid(f"win.{w.func}")
    col = PlanCol(uid=uid, name=uid, type_=out_type, dict_=d)
    frame = _normalize_frame(w)
    node = LWindow(
        schema=list(plan.schema) + [col], children=[plan],
        func=w.func, args=args, partition_by=part, order_by=order,
        out_uid=uid, out_type=out_type, frame=frame,
    )
    return node, Scope(list(scope.cols) + [col], scope.parent), uid


def _agg_result_type(func: str, arg: Optional[Expr]) -> SQLType:
    if func == "count":
        return INT64
    if func == "avg":
        return FLOAT64
    if func in ("min", "max"):
        return arg.type_
    if func in ("bit_and", "bit_or", "bit_xor"):
        # MySQL result is BIGINT UNSIGNED; we keep the int64 bit pattern
        return INT64
    if func == "group_concat":
        return STRING
    if func in VARIANCE_AGGS:
        return FLOAT64
    # sum
    k = arg.type_.kind
    if k == TypeKind.DECIMAL:
        return decimal_type(18, arg.type_.scale)
    if k == TypeKind.FLOAT:
        return FLOAT64
    return INT64


# ---------------------------------------------------------------------------
# SELECT builder
# ---------------------------------------------------------------------------

def build_select(stmt, ctx: BuildContext, outer: Optional[Scope] = None) -> LogicalPlan:
    if isinstance(stmt, A.UnionStmt):
        return _build_union(stmt, ctx, outer)
    assert isinstance(stmt, A.SelectStmt)

    # CTEs visible in this select; single-reference CTEs inline (MERGE),
    # multi-reference ones materialize once at plan time (the reference
    # planner's CTE MATERIALIZE default for shared CTEs) so an expensive
    # body — e.g. TPC-DS Q95's web_sales self-join — computes once
    old_ctes = dict(ctx.ctes)
    for cte in stmt.ctes:
        if cte.columns:
            raise UnsupportedError("CTE column lists not supported yet")
        ctx.ctes[cte.name] = cte.select
        if _count_table_refs(stmt, cte.name) >= 2:
            # keyed by the BODY's identity: a same-named CTE in another
            # scope is a different object and never aliases this one
            ctx.cte_multi.add(id(cte.select))
            if _cte_semi_only(stmt, cte.name):
                ctx.cte_duponly.add(id(cte.select))
    try:
        return _build_select_core(stmt, ctx, outer)
    finally:
        ctx.ctes = old_ctes


def _build_select_core(stmt: A.SelectStmt, ctx: BuildContext, outer) -> LogicalPlan:
    binder = ctx.binder
    plan, scope = build_from(stmt.from_, ctx, outer)

    # ---- WHERE: subquery conjuncts become joins/gates ----
    if stmt.where is not None:
        plain = []
        conjuncts = [x for c in _conjuncts(stmt.where) for x in _factor_or(c)]
        for conj in conjuncts:
            conj = _normalize_not(conj)
            if isinstance(conj, A.EIn) and conj.subquery is not None:
                # scalar subqueries inside the IN's left-hand side fold first
                conj = dataclasses.replace(conj, arg=_fold_subqueries(conj.arg, ctx, scope))
                plan, scope = _in_subquery_to_join(conj, plan, scope, ctx)
                continue
            if isinstance(conj, A.EExists):
                join = _exists_to_join(conj, plan, scope, ctx)
                if join == "const":
                    plain.append(A.EBool(not conj.negated))
                elif join is not None:
                    plan = join
                else:
                    plain.append(A.EBool(_exists_value(conj, ctx, scope)))
                continue
            hit = _try_scalar_corr(conj, plan, scope, ctx)
            if hit is not None:
                conj, plan, scope = hit
            conj = _fold_subqueries(conj, ctx, scope)
            plain.append(conj)
        if plain:
            cond = _and_ir([binder.bind_expr(c, scope) for c in plain])
            plan = LSelection(schema=plan.schema, children=[plan], cond=cond)

    # ---- aggregate detection ----
    for item in stmt.items:
        new = _rewrite_extended_aggs(item.expr)
        if new is not item.expr and item.alias is None:
            item.alias = expr_display(item.expr)
        item.expr = new
    if stmt.having is not None:
        stmt.having = _rewrite_extended_aggs(stmt.having)
    for oi in stmt.order_by:
        oi.expr = _rewrite_extended_aggs(oi.expr)

    agg_calls: Dict[str, A.EFunc] = {}
    for item in stmt.items:
        _collect_agg_calls(item.expr, agg_calls)
    if stmt.having is not None:
        _collect_agg_calls(stmt.having, agg_calls)
    for oi in stmt.order_by:
        _collect_agg_calls(oi.expr, agg_calls)

    has_agg = bool(agg_calls) or bool(stmt.group_by)
    alias_map = {
        item.alias.lower(): item.expr for item in stmt.items if item.alias
    }

    post_scope = scope
    if has_agg:
        plan, post_scope, mapping = _build_aggregate(stmt, plan, scope, ctx, agg_calls, alias_map)
    else:
        mapping = {}

    # ---- HAVING ----
    if stmt.having is not None:
        if not has_agg:
            raise PlanError("HAVING without aggregation")
        # uncorrelated scalar subqueries in HAVING fold to constants now
        h_ast = _fold_subqueries(stmt.having, ctx, scope)
        h_ast = _substitute(h_ast, mapping)
        cond = binder.bind_expr(h_ast, post_scope)
        plan = LSelection(schema=plan.schema, children=[plan], cond=cond)

    # ---- window functions (evaluate after grouping + HAVING) ----
    win_calls: Dict[str, A.EWindow] = {}
    for item in stmt.items:
        _collect_window_calls(item.expr, win_calls)
    for oi in stmt.order_by:
        _collect_window_calls(oi.expr, win_calls)
    if win_calls:
        for key, w in win_calls.items():
            w2 = _substitute(w, mapping) if mapping else w
            plan, post_scope, uid = _plan_window(w2, plan, post_scope, ctx)
            mapping[key] = uid

    subst = bool(mapping)

    # ---- SELECT items ----
    items: List[Tuple[str, object]] = []  # (display name, ast)
    for item in stmt.items:
        if isinstance(item.expr, A.EStar):
            src_scope = scope if not has_agg else None
            if src_scope is None:
                raise PlanError("SELECT * with GROUP BY requires explicit columns")
            for c in src_scope.cols:
                if c.hidden:
                    continue
                if item.expr.qualifier and (c.qualifier or "").lower() != item.expr.qualifier.lower():
                    continue
                items.append((c.name, A.EName(c.name, c.qualifier)))
            if not items:
                raise PlanError("* expanded to nothing")
        else:
            name = item.alias or expr_display(item.expr)
            items.append((name, _substitute(item.expr, mapping) if subst else item.expr))

    proj_exprs: List[Expr] = []
    proj_cols: List[PlanCol] = []
    for name, ast_e in items:
        bound = binder.codify_output_literal(binder.bind_expr(ast_e, post_scope))
        uid = binder.new_uid(name)
        proj_exprs.append(bound)
        proj_cols.append(
            PlanCol(uid=uid, name=name, type_=bound.type_, qualifier=None,
                    dict_=getattr(bound, "_dict", None))
        )
    n_visible = len(proj_cols)

    # ---- ORDER BY (may add hidden projection columns) ----
    sort_items: List[Tuple[Expr, bool]] = []
    if stmt.order_by:
        by_alias = {c.name.lower(): i for i, c in enumerate(proj_cols)}
        for oi in stmt.order_by:
            target_idx = None
            if isinstance(oi.expr, A.ENum) and "." not in oi.expr.text:
                pos = int(oi.expr.text)
                if not 1 <= pos <= n_visible:
                    raise PlanError(f"ORDER BY position {pos} out of range")
                target_idx = pos - 1
            elif isinstance(oi.expr, A.EName) and oi.expr.qualifier is None and oi.expr.name.lower() in by_alias:
                target_idx = by_alias[oi.expr.name.lower()]
            if target_idx is not None:
                pc = proj_cols[target_idx]
                sort_items.append((ColumnRef(type_=pc.type_, name=pc.uid), oi.desc))
                continue
            ast_e = _substitute(oi.expr, mapping) if subst else oi.expr
            bound = binder.bind_expr(ast_e, post_scope)
            uid = binder.new_uid("sort")
            proj_exprs.append(bound)
            proj_cols.append(PlanCol(uid=uid, name=uid, type_=bound.type_,
                                     dict_=getattr(bound, "_dict", None)))
            sort_items.append((ColumnRef(type_=bound.type_, name=uid), oi.desc))

    plan = LProjection(
        schema=proj_cols, children=[plan], exprs=proj_exprs, n_visible=n_visible
    )

    # ---- DISTINCT ----
    if stmt.distinct:
        if len(proj_cols) != n_visible:
            raise UnsupportedError("DISTINCT with ORDER BY on hidden columns")
        plan = LAggregate(
            schema=list(proj_cols),
            children=[plan],
            group_exprs=_canon_group_refs(proj_cols),
            group_uids=[c.uid for c in proj_cols],
            aggs=[],
        )

    if sort_items:
        plan = LSort(schema=plan.schema, children=[plan], items=sort_items)

    if stmt.limit is not None:
        plan = LLimit(
            schema=plan.schema, children=[plan],
            count=stmt.limit, offset=stmt.offset or 0,
        )
    return plan


def _canon_group_refs(cols) -> List[Expr]:
    """Group-key exprs for DISTINCT / set-operation dedup: _ci string
    columns dedup by CANONICAL code so fold-equal rows collapse into one
    (MySQL's case-insensitive DISTINCT); other columns pass through."""
    out = []
    for c in cols:
        e = c.ref()
        d = getattr(e, "_dict", None) or c.dict_
        if d is not None and getattr(d, "is_ci", False):
            ne = Lookup.build(e, d.canon_lut(), STRING)
            object.__setattr__(ne, "_dict", d)
            e = ne
        out.append(e)
    return out


def _build_aggregate(stmt, plan, scope, ctx, agg_calls, alias_map):
    binder = ctx.binder
    mapping: Dict[str, str] = {}
    group_exprs: List[Expr] = []
    group_uids: List[str] = []
    group_cols: List[PlanCol] = []

    for g_ast in stmt.group_by:
        # ordinal / alias resolution
        if isinstance(g_ast, A.ENum) and "." not in g_ast.text:
            pos = int(g_ast.text)
            if not 1 <= pos <= len(stmt.items):
                raise PlanError(f"GROUP BY position {pos} out of range")
            g_ast = stmt.items[pos - 1].expr
        elif (
            isinstance(g_ast, A.EName)
            and g_ast.qualifier is None
            and g_ast.name.lower() in alias_map
            and scope.try_resolve(g_ast.name, None) is None
        ):
            g_ast = alias_map[g_ast.name.lower()]
        bound = binder.bind_expr(g_ast, scope)
        gdict = getattr(bound, "_dict", None)
        if gdict is not None and gdict.is_ci:
            # group CANONICAL codes so fold-equal strings land in one
            # group (MySQL _ci GROUP BY); the canonical code decodes to
            # the class representative in the same dictionary
            bound = binder.attach_dict(
                Lookup.build(bound, gdict.canon_lut(), STRING), gdict)
        uid = binder.new_uid("group")
        mapping[ast_key(g_ast)] = uid
        group_exprs.append(bound)
        group_uids.append(uid)
        name = expr_display(g_ast)
        if isinstance(g_ast, A.EName):
            name = g_ast.name
        group_cols.append(
            PlanCol(uid=uid, name=name, type_=bound.type_,
                    dict_=getattr(bound, "_dict", None))
        )

    aggs: List[AggSpec] = []
    agg_cols: List[PlanCol] = []
    for key, call in agg_calls.items():
        if key in mapping:
            continue
        func = call.name
        if func == "count" and (not call.args or isinstance(call.args[0], A.EStar)):
            arg = None
        else:
            if len(call.args) != 1:
                raise UnsupportedError(f"{func.upper()} with {len(call.args)} args")
            arg = binder.bind_expr(call.args[0], scope)
            adict = getattr(arg, "_dict", None)
            if (call.distinct and adict is not None and adict.is_ci
                    and func not in ("min", "max", "group_concat")):
                # DISTINCT dedups fold-equal strings under _ci (MySQL);
                # min/max keep raw codes — code order already collates —
                # and group_concat keeps its raw arg (its two-phase
                # rewrite owns the arg shape; its DISTINCT stays bytewise)
                arg = binder.attach_dict(
                    Lookup.build(arg, adict.canon_lut(), STRING), adict)
        t = _agg_result_type(func, arg)
        uid = binder.new_uid(func)
        mapping[key] = uid
        extra = None
        out_dict = (getattr(arg, "_dict", None)
                    if func in ("min", "max") and arg is not None else None)
        if func == "group_concat":
            # result strings exist only at execution time: attach a
            # RuntimeDictionary the executor fills per run
            from tidb_tpu_torch.chunk.dictionary import RuntimeDictionary

            order_desc = None
            if call.agg_order is not None:
                if (len(call.agg_order) != 1
                        or ast_key(call.agg_order[0][0]) != ast_key(call.args[0])):
                    raise UnsupportedError(
                        "GROUP_CONCAT ORDER BY must be the concatenated "
                        "expression itself")
                order_desc = call.agg_order[0][1]
            out_dict = RuntimeDictionary([])
            extra = (call.separator if call.separator is not None else ",",
                     order_desc, out_dict)
        aggs.append(AggSpec(uid=uid, func=func, arg=arg,
                            distinct=call.distinct, type_=t, extra=extra))
        agg_cols.append(
            PlanCol(uid=uid, name=expr_display(call), type_=t, dict_=out_dict)
        )

    node = LAggregate(
        schema=group_cols + agg_cols,
        children=[plan],
        group_exprs=group_exprs,
        group_uids=group_uids,
        aggs=aggs,
    )
    return node, Scope(node.schema, None), mapping


# ---------------------------------------------------------------------------
# WHERE-clause rewrites
# ---------------------------------------------------------------------------

def _disjuncts(e) -> List:
    if isinstance(e, A.EBinary) and e.op == "or":
        return _disjuncts(e.left) + _disjuncts(e.right)
    return [e]


def _and_ast(parts: List) -> Optional[object]:
    out = None
    for p in parts:
        out = p if out is None else A.EBinary("and", out, p)
    return out


def _factor_or(conj) -> List:
    """(a AND b) OR (a AND c) -> [a, b OR c]: conjuncts common to every OR
    branch factor out, so join keys hidden under OR (TPC-H Q19's shape)
    become extractable equi-join conditions instead of forcing a cross
    join (ref: planner/core expression_rewriter's extractFiltersFromDNF)."""
    if not (isinstance(conj, A.EBinary) and conj.op == "or"):
        return [conj]
    branches = _disjuncts(conj)
    keyed = [{ast_key(c): c for c in _conjuncts(b)} for b in branches]
    common_keys = set(keyed[0])
    for k in keyed[1:]:
        common_keys &= set(k)
    if not common_keys:
        return [conj]
    common = [keyed[0][k] for k in sorted(common_keys)]
    residuals = []
    for k in keyed:
        rest = [c for key, c in k.items() if key not in common_keys]
        if not rest:
            return common  # one branch is exactly the common part: OR is true
        residuals.append(_and_ast(rest))
    out = None
    for r in residuals:
        out = r if out is None else A.EBinary("or", out, r)
    return common + [out]


def _normalize_not(conj):
    """Push NOT into EXISTS/IN so the join rewrites below see them."""
    while isinstance(conj, A.EUnary) and conj.op == "not":
        arg = conj.arg
        if isinstance(arg, A.EExists):
            conj = dataclasses.replace(arg, negated=not arg.negated)
        elif isinstance(arg, A.EIn):
            conj = dataclasses.replace(arg, negated=not arg.negated)
        elif isinstance(arg, A.EUnary) and arg.op == "not":
            conj = arg.arg
        else:
            return conj
    return conj


def _ast_names(e, out: List):
    """Collect EName nodes, not descending into nested selects."""
    if isinstance(e, A.EName):
        out.append(e)
        return
    if not hasattr(e, "__dataclass_fields__") or isinstance(e, (A.SelectStmt, A.UnionStmt)):
        return
    for f in e.__dataclass_fields__:
        v = getattr(e, f)
        if isinstance(v, list):
            for x in v:
                if isinstance(x, tuple):
                    for y in x:
                        _ast_names(y, out)
                else:
                    _ast_names(x, out)
        elif isinstance(v, tuple):
            for y in v:
                _ast_names(y, out)
        else:
            _ast_names(v, out)


def _has_subquery(e) -> bool:
    if isinstance(e, (A.ESubquery, A.EExists, A.SelectStmt, A.UnionStmt)):
        return True
    if isinstance(e, A.EIn) and e.subquery is not None:
        return True
    if not hasattr(e, "__dataclass_fields__"):
        return False
    for f in e.__dataclass_fields__:
        v = getattr(e, f)
        if isinstance(v, list):
            for x in v:
                if isinstance(x, tuple):
                    if any(_has_subquery(y) for y in x):
                        return True
                elif _has_subquery(x):
                    return True
        elif isinstance(v, tuple):
            if any(_has_subquery(y) for y in v):
                return True
        elif _has_subquery(v):
            return True
    return False


def _expr_side(e, inner_scope: Scope, outer_scope: Scope) -> str:
    """Which scope an expression's column refs live in: 'inner', 'outer',
    'const' (no refs), 'mixed', or 'unknown'. Inner shadows outer, matching
    SQL name resolution."""
    names: List = []
    _ast_names(e, names)
    if not names:
        return "const"
    sides = set()
    for n in names:
        if inner_scope.try_resolve(n.name, n.qualifier) is not None:
            sides.add("inner")
        elif outer_scope.try_resolve(n.name, n.qualifier) is not None:
            sides.add("outer")
        else:
            return "unknown"
    return sides.pop() if len(sides) == 1 else "mixed"


def _align_dicts(outer_expr: Expr, inner_expr: Expr, inner_dict) -> Tuple[Expr, Expr]:
    """Translate both sides of a cross-plan string equality onto a union
    dictionary so codes compare correctly."""
    od = getattr(outer_expr, "_dict", None)
    idd = inner_dict if inner_dict is not None else getattr(inner_expr, "_dict", None)
    if od is None and idd is None:
        return outer_expr, inner_expr
    if od is None or idd is None:
        raise UnsupportedError("subquery join mixing string and non-string")
    if od != idd:
        import numpy as np

        union = Dictionary.union(od, idd)
        outer_expr = Lookup.build(outer_expr, od.translate_canon_to(union).astype(np.int32), STRING)
        inner_expr = Lookup.build(inner_expr, idd.translate_canon_to(union).astype(np.int32), STRING)
    elif od.is_ci:
        # same dictionary on both sides still needs canon codes: raw
        # codes would compare case-sensitively under a _ci collation
        lut = od.canon_lut()
        outer_expr = Lookup.build(outer_expr, lut, STRING)
        inner_expr = Lookup.build(inner_expr, lut, STRING)
    return outer_expr, inner_expr


def _split_correlation(sub: A.SelectStmt, ctx: BuildContext, outer_scope: Scope):
    """Build the subquery's FROM and classify its WHERE conjuncts against
    (inner, outer) scopes. Returns None if any conjunct defeats the
    decorrelation (nested subquery, unknown name, non-equality mix), else
    (inner_plan, inner_scope, local, corr_eq, corr_other) where corr_eq is
    [(outer_ast, inner_ast)] equalities and corr_other the remaining
    outer-referencing conjuncts."""
    inner_plan, inner_scope = build_from(sub.from_, ctx, None)
    local, corr_eq, corr_other = [], [], []
    for c in (_conjuncts(sub.where) if sub.where is not None else []):
        if _has_subquery(c):
            return None
        side = _expr_side(c, inner_scope, outer_scope)
        if side in ("inner", "const"):
            local.append(c)
        elif side == "unknown":
            return None
        elif side == "mixed" and isinstance(c, A.EBinary) and c.op == "=":
            ls = _expr_side(c.left, inner_scope, outer_scope)
            rs = _expr_side(c.right, inner_scope, outer_scope)
            if {ls, rs} == {"inner", "outer"}:
                oa, ia = (c.right, c.left) if ls == "inner" else (c.left, c.right)
                corr_eq.append((oa, ia))
            else:
                corr_other.append(c)
        else:  # outer-only or non-equality mixed
            corr_other.append(c)
    return inner_plan, inner_scope, local, corr_eq, corr_other


def _exists_to_join(conj: A.EExists, plan, scope: Scope, ctx: BuildContext):
    """Correlated [NOT] EXISTS -> semi/anti join on the correlation
    equalities (the decorrelation the reference's planner performs); other
    correlated conjuncts ride along as the join's other_cond. Returns None
    for uncorrelated subqueries (eager evaluation handles those)."""
    sub = conj.subquery
    if not isinstance(sub, A.SelectStmt) or sub.from_ is None:
        return None
    if sub.group_by or sub.having is not None or sub.limit is not None:
        return None
    agg_calls: Dict[str, A.EFunc] = {}
    for it in sub.items:
        if not isinstance(it.expr, A.EStar):
            _collect_agg_calls(it.expr, agg_calls)
    if agg_calls:
        # an ungrouped aggregate select always yields exactly one row, so
        # EXISTS over it is constant TRUE whatever the correlation matches
        return "const"
    split = _split_correlation(sub, ctx, scope)
    if split is None:
        return None
    inner_plan, inner_scope, local, corr_eq, corr_other = split
    if not corr_eq and not corr_other:
        return None  # uncorrelated
    if not corr_eq:
        raise UnsupportedError("correlated EXISTS without an equality correlation")
    binder = ctx.binder
    if local:
        cond = _and_ir([binder.bind_expr(c, inner_scope) for c in local])
        inner_plan = LSelection(schema=inner_plan.schema, children=[inner_plan], cond=cond)
    eq = []
    for oa, ia in corr_eq:
        oe = binder.bind_expr(oa, scope)
        ie = binder.bind_expr(ia, inner_scope)
        inner_dict = getattr(ie, "_dict", None)
        oe, ie = _align_dicts(oe, ie, inner_dict)
        eq.append((oe, ie))
    other = None
    if corr_other:
        combined = Scope(list(scope.cols) + list(inner_scope.cols), scope.parent)
        other = _and_ir([binder.bind_expr(c, combined) for c in corr_other])
    return LJoin(
        schema=list(plan.schema),
        children=[plan, inner_plan],
        kind="anti" if conj.negated else "semi",
        eq_conds=eq,
        other_cond=other,
        exists_sem=True,
    )


_CMP_OPS = {"=", "<>", "!=", "<", "<=", ">", ">="}


def _try_scalar_corr(conj, plan, scope: Scope, ctx: BuildContext):
    """Rewrite `expr cmp (correlated scalar aggregate subquery)` as an inner
    join against the subquery re-grouped by its correlation keys, with the
    comparison referencing the joined aggregate column (classic scalar-agg
    decorrelation; ref: planner/core decorrelate rule). Returns
    (new_conj_ast, plan, scope) or None."""
    if not (isinstance(conj, A.EBinary) and conj.op in _CMP_OPS):
        return None
    if isinstance(conj.right, A.ESubquery) and not isinstance(conj.left, A.ESubquery):
        sub_node, other_side, sub_on_right = conj.right, conj.left, True
    elif isinstance(conj.left, A.ESubquery) and not isinstance(conj.right, A.ESubquery):
        sub_node, other_side, sub_on_right = conj.left, conj.right, False
    else:
        return None
    sel = sub_node.select
    if not isinstance(sel, A.SelectStmt) or sel.from_ is None:
        return None
    if sel.group_by or sel.having is not None or len(sel.items) != 1:
        return None
    agg_calls: Dict[str, A.EFunc] = {}
    _collect_agg_calls(sel.items[0].expr, agg_calls)
    if not agg_calls:
        return None  # not guaranteed single-row; only agg subqueries rewrite
    if any(c.name == "count" for c in agg_calls.values()):
        # COUNT over an empty group is 0, not NULL — the inner-join rewrite
        # below would drop zero-match outer rows instead of comparing 0
        return None
    split = _split_correlation(sel, ctx, scope)
    if split is None:
        return None
    _, _, local, corr_eq, corr_other = split
    if not corr_eq or corr_other:
        return None
    # regroup the subquery by its correlation keys and join on them
    new_sel = A.SelectStmt(
        items=[A.SelectItem(ia) for _, ia in corr_eq] + [sel.items[0]],
        from_=sel.from_,
        where=_and_ast(local),
        group_by=[ia for _, ia in corr_eq],
    )
    sub_plan = build_select(new_sel, ctx, None)
    value_col = sub_plan.schema[len(corr_eq)]
    binder = ctx.binder
    eq = []
    for i, (oa, _ia) in enumerate(corr_eq):
        oe = binder.bind_expr(oa, scope)
        ic = sub_plan.schema[i]
        ie = ic.ref()
        oe, ie = _align_dicts(oe, ie, ic.dict_)
        eq.append((oe, ie))
    join = LJoin(
        schema=list(plan.schema) + [value_col],
        children=[plan, sub_plan],
        kind="inner",
        eq_conds=eq,
    )
    # rows with no group simply drop out of the inner join — identical to
    # the NULL-comparison semantics of the original scalar subquery for
    # the agg functions this rewrite accepts (empty agg -> NULL)
    vref = A.EName(value_col.uid)
    new_conj = A.EBinary(conj.op, other_side, vref) if sub_on_right else A.EBinary(conj.op, vref, other_side)
    new_scope = Scope(list(scope.cols) + [value_col], scope.parent)
    return new_conj, join, new_scope


# ---------------------------------------------------------------------------
# subqueries
# ---------------------------------------------------------------------------

def _fold_subqueries(conj, ctx: BuildContext, scope: Scope):
    """Replace uncorrelated scalar subqueries (ESubquery) inside an AST
    conjunct with literal AST nodes by executing them now."""
    if isinstance(conj, A.ESubquery):
        rows = _run_subplan(conj.select, ctx, scope)
        if len(rows) > 1:
            raise PlanError("scalar subquery returned more than one row")
        if not rows or rows[0][0] is None:
            return A.ENull()
        v = rows[0][0]
        if isinstance(v, str):
            return A.EStr(v)
        if isinstance(v, float):
            return A.ENum(f"{v:.17e}")  # exponent form binds as FLOAT64
        return A.ENum(repr(v))
    if not hasattr(conj, "__dataclass_fields__") or isinstance(conj, (A.SelectStmt, A.UnionStmt)):
        return conj
    kwargs = {}
    for f in conj.__dataclass_fields__:
        v = getattr(conj, f)
        if hasattr(v, "__dataclass_fields__") and not isinstance(v, (A.SelectStmt, A.UnionStmt)):
            kwargs[f] = _fold_subqueries(v, ctx, scope)
        elif isinstance(v, list):
            kwargs[f] = [
                _fold_subqueries(x, ctx, scope) if hasattr(x, "__dataclass_fields__") and not isinstance(x, (A.SelectStmt, A.UnionStmt)) else x
                for x in v
            ]
        else:
            kwargs[f] = v
    return type(conj)(**kwargs)


def _run_subplan(select_ast, ctx: BuildContext, scope: Scope) -> list:
    if ctx.execute_subplan is None:
        raise UnsupportedError("subquery execution not wired (no session)")
    sub = build_select(select_ast, ctx, scope)  # scope as parent: correlation detection
    return ctx.execute_subplan(sub)


def _exists_value(conj: A.EExists, ctx: BuildContext, scope: Scope) -> bool:
    limited = dataclasses.replace(conj.subquery) if isinstance(conj.subquery, A.SelectStmt) else conj.subquery
    if isinstance(limited, A.SelectStmt) and limited.limit is None:
        limited.limit = 1
    rows = _run_subplan(limited, ctx, scope)
    val = bool(rows)
    return (not val) if conj.negated else val


def _in_subquery_to_join(conj: A.EIn, plan, scope, ctx: BuildContext):
    # IN is duplicate-insensitive: an inline duplicate-detection
    # self-join collapses to the grouped distinctness form
    sub_ast = _try_selfjoin_distinctness(conj.subquery) or conj.subquery
    sub = build_select(sub_ast, ctx, scope)
    if len(sub.schema) != 1:
        raise PlanError("IN subquery must return exactly one column")
    outer_expr = ctx.binder.bind_expr(conj.arg, scope)
    inner_col = sub.schema[0]
    inner_expr: Expr = inner_col.ref()

    # align string dictionaries across the two sides
    od = getattr(outer_expr, "_dict", None)
    idd = inner_col.dict_
    if od is not None or idd is not None:
        if od is None or idd is None:
            raise UnsupportedError("IN subquery mixing string and non-string")
        if od != idd:
            import numpy as np

            union = Dictionary.union(od, idd)
            outer_expr = Lookup.build(outer_expr, od.translate_canon_to(union).astype(np.int32), STRING)
            inner_expr = Lookup.build(inner_expr, idd.translate_canon_to(union).astype(np.int32), STRING)
        elif od.is_ci:
            # same dictionary still needs canonical codes under _ci
            lut = od.canon_lut()
            outer_expr = Lookup.build(outer_expr, lut, STRING)
            inner_expr = Lookup.build(inner_expr, lut, STRING)

    kind = "anti" if conj.negated else "semi"
    join = LJoin(
        schema=list(plan.schema),  # semi/anti joins keep the outer schema
        children=[plan, sub],
        kind=kind,
        eq_conds=[(outer_expr, inner_expr)],
    )
    return join, Scope(join.schema, scope.parent)


# ---------------------------------------------------------------------------
# UNION
# ---------------------------------------------------------------------------

def _build_full_join(src: A.Join, ctx: BuildContext, outer):
    """L FULL JOIN R = (L LEFT JOIN R) UNION ALL (rows of R with no
    qualified L match, left payload all-NULL) — the same rewrite the
    reference's planner applies; there is no native full-join operator.
    Both branches rebuild their sources (fresh uid spaces); branch B
    projects onto branch A's uids so the union is pure concatenation."""
    left_join = A.Join("left", src.left, src.right, src.on, src.using)
    plan_a, scope_a = build_from(left_join, ctx, outer)
    acols = scope_a.cols

    # branch B: anti join with probe = right side
    left2, lscope2 = build_from(src.left, ctx, outer)
    right2, rscope2 = build_from(src.right, ctx, outer)
    combined2 = Scope(lscope2.cols + rscope2.cols, outer)
    cond_asts = _conjuncts(src.on) if src.on is not None else []
    if src.using:
        for name in src.using:
            cond_asts.append(
                A.EBinary("=", A.EName(name, _qual_of(lscope2, name)),
                          A.EName(name, _qual_of(rscope2, name))))
    left_uids = {c.uid for c in lscope2.cols}
    right_uids = {c.uid for c in rscope2.cols}
    eq, other = [], []
    for cast_ in cond_asts:
        bound = ctx.binder.bind_expr(cast_, combined2)
        side = _classify_eq(bound, left_uids, right_uids)
        if side == "lr":
            eq.append((bound.args[1], bound.args[0]))  # probe=right first
        elif side == "rl":
            eq.append((bound.args[0], bound.args[1]))
        else:
            other.append(bound)
    anti = LJoin(
        schema=list(rscope2.cols), children=[right2, left2], kind="anti",
        eq_conds=eq, other_cond=_and_ir(other),
        exists_sem=True,  # an unmatched NULL right key still appears
    )
    n_left = len(acols) - len(rscope2.cols)
    exprs_b: List[Expr] = [
        Literal(type_=c.type_, value=None) for c in acols[:n_left]
    ] + [c.ref() for c in rscope2.cols]
    bcols = [dataclasses.replace(c) for c in acols]
    proj_b = LProjection(schema=bcols, children=[anti], exprs=exprs_b)

    union = LUnion(schema=list(acols), children=[plan_a, proj_b], all=True)
    return union, Scope(acols, outer)


def _build_union(stmt: A.UnionStmt, ctx: BuildContext, outer) -> LogicalPlan:
    if stmt.op not in ("union", "except", "intersect"):
        raise UnsupportedError(f"{stmt.op.upper()} not supported yet")
    if stmt.op in ("except", "intersect") and stmt.all:
        raise UnsupportedError(f"{stmt.op.upper()} ALL not supported yet")
    sides: List[LogicalPlan] = []

    def flatten(s):
        if (stmt.op == "union" and isinstance(s, A.UnionStmt)
                and s.op == "union" and s.all == stmt.all
                and not s.order_by and s.limit is None):
            flatten(s.left)
            flatten(s.right)
        else:
            sides.append(build_select(s, ctx, outer))

    flatten(stmt.left)
    flatten(stmt.right)

    arity = len(sides[0].schema)
    for s in sides:
        if len(s.schema) != arity:
            raise PlanError("UNION arity mismatch")

    # result types + dictionaries per position
    out_cols: List[PlanCol] = []
    for i in range(arity):
        t = sides[0].schema[i].type_
        for s in sides[1:]:
            t = common_type(t, s.schema[i].type_)
        d = None
        if t.kind == TypeKind.STRING:
            d = sides[0].schema[i].dict_ or Dictionary([])
            for s in sides[1:]:
                d = Dictionary.union(d, s.schema[i].dict_ or Dictionary([]))
        out_cols.append(
            PlanCol(uid=ctx.binder.new_uid(f"union.{sides[0].schema[i].name}"),
                    name=sides[0].schema[i].name, type_=t, dict_=d)
        )

    # coerce each side through a projection
    import numpy as np
    from tidb_tpu_torch.expression.expr import Cast

    coerced = []
    for s in sides:
        exprs = []
        for i, oc in enumerate(out_cols):
            src = s.schema[i]
            e: Expr = src.ref()
            if oc.type_.kind == TypeKind.STRING:
                sd = src.dict_ or Dictionary([])
                if sd != oc.dict_:
                    e = Lookup.build(e, sd.translate_to(oc.dict_).astype(np.int32), STRING)
            elif src.type_ != oc.type_:
                e = Cast(type_=oc.type_, arg=e)
            exprs.append(e)
        cols = [dataclasses.replace(c) for c in out_cols]
        coerced.append(LProjection(schema=cols, children=[s], exprs=exprs))
        # all sides project onto the SAME uids so union is pure concat
        for c, oc in zip(cols, out_cols):
            c.uid = oc.uid

    if stmt.op in ("except", "intersect"):
        # set semantics via a marked union: tag each side, group by all
        # columns, keep groups by side counts (NULLs group together, so
        # NULL rows compare equal — exactly set-operation semantics)
        binder = ctx.binder
        # one side-tag column: per group, sl = SUM(tag) counts left-side
        # rows and COUNT(*) - sl counts right-side rows
        l_uid = binder.new_uid("__settag")
        lcol = PlanCol(uid=l_uid, name=l_uid, type_=INT64)
        for i, proj in enumerate(coerced):
            proj.exprs = list(proj.exprs) + [
                Literal(type_=INT64, value=1 if i == 0 else 0)]
            proj.schema = list(proj.schema) + [dataclasses.replace(lcol)]
        ext_cols = out_cols + [lcol]
        node = LUnion(schema=ext_cols, children=coerced, all=True)
        sl_uid, cnt_uid = binder.new_uid("sum.__settag"), binder.new_uid("cnt")
        agg_schema = list(out_cols) + [
            PlanCol(uid=sl_uid, name=sl_uid, type_=INT64),
            PlanCol(uid=cnt_uid, name=cnt_uid, type_=INT64),
        ]
        node = LAggregate(
            schema=agg_schema, children=[node],
            group_exprs=_canon_group_refs(out_cols),
            group_uids=[c.uid for c in out_cols],
            aggs=[AggSpec(uid=sl_uid, func="sum", arg=lcol.ref(), type_=INT64),
                  AggSpec(uid=cnt_uid, func="count", arg=None, type_=INT64)],
        )
        sl = ColumnRef(type_=INT64, name=sl_uid)
        cnt = ColumnRef(type_=INT64, name=cnt_uid)
        zero = Literal(type_=INT64, value=0)
        left_present = Call(type_=BOOL, op="gt", args=(sl, zero))
        sr = Call(type_=INT64, op="sub", args=(cnt, sl))
        right_test = Call(type_=BOOL,
                          op="eq" if stmt.op == "except" else "gt",
                          args=(sr, zero))
        cond = Call(type_=BOOL, op="and", args=(left_present, right_test))
        node = LSelection(schema=list(agg_schema), children=[node], cond=cond)
        node = LProjection(schema=list(out_cols), children=[node],
                           exprs=[c.ref() for c in out_cols],
                           n_visible=len(out_cols))
    else:
        node = LUnion(schema=out_cols, children=coerced, all=stmt.all)
        if not stmt.all:
            node = LAggregate(
                schema=list(out_cols),
                children=[node],
                group_exprs=_canon_group_refs(out_cols),
                group_uids=[c.uid for c in out_cols],
                aggs=[],
            )

    plan = node
    if stmt.order_by:
        by_alias = {c.name.lower(): c for c in out_cols}
        items = []
        for oi in stmt.order_by:
            if isinstance(oi.expr, A.ENum):
                pos = int(oi.expr.text)
                c = out_cols[pos - 1]
            elif isinstance(oi.expr, A.EName) and oi.expr.name.lower() in by_alias:
                c = by_alias[oi.expr.name.lower()]
            else:
                raise UnsupportedError("UNION ORDER BY must use output columns")
            items.append((c.ref(), oi.desc))
        plan = LSort(schema=plan.schema, children=[plan], items=items)
    if stmt.limit is not None:
        plan = LLimit(schema=plan.schema, children=[plan], count=stmt.limit, offset=stmt.offset or 0)
    return plan
