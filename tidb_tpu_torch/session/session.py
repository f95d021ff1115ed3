"""Session: the SQL entry point of the port.

A statement loop of its own over the copied parser and planner: CREATE
TABLE / DROP TABLE / CREATE DATABASE / USE, INSERT ... VALUES, SET and
SELECT (UNION included), each an autocommit statement, plus `load_tpch`.
Statements run on `device`: None means the CUDA card, and a Session
without a card raises instead of carrying on on the CPU.

Not yet ported from tidb_tpu/session/session.py: transactions and
savepoints, UPDATE/DELETE/REPLACE/upserts, INSERT ... SELECT, LOAD DATA,
EXPLAIN/TRACE/SHOW, DDL breadth (indexes, constraints, partitions,
views, ALTER), privileges, prepared statements, the plan cache, plan
feedback, tracing and the serving, DCN and mesh tiers.
"""

from __future__ import annotations

from typing import List, Optional

from tidb_tpu_torch.errors import ExecutionError, UnsupportedError
from tidb_tpu_torch.executor import ExecContext, ResultSet, build_executor, run_plan
from tidb_tpu_torch.parser import ast as A
from tidb_tpu_torch.parser import parse
from tidb_tpu_torch.planner.optimizer import plan_statement
from tidb_tpu_torch.planner.physical import PProjection, lower
from tidb_tpu_torch.planner.rules import optimize_logical
from tidb_tpu_torch.session.sysvars import SysVarStore
from tidb_tpu_torch.storage.catalog import Catalog
from tidb_tpu_torch.storage.table import ColumnInfo, TableSchema
from tidb_tpu_torch.types import TypeKind, parse_type_name
from tidb_tpu_torch.utils.device import resolve_device

__all__ = ["Session"]


class Session:
    def __init__(self, catalog: Optional[Catalog] = None, db: str = "test",
                 chunk_capacity: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self.catalog = catalog if catalog is not None else Catalog()
        self.db = db
        self._chunk_capacity = chunk_capacity  # explicit override; else sysvar
        self.sysvars = SysVarStore(self.catalog.global_vars)
        self.user_vars: dict = {}

    @property
    def chunk_capacity(self) -> int:
        if self._chunk_capacity is not None:
            return self._chunk_capacity
        return int(self.sysvars.get("tidb_max_chunk_size"))

    def load_tpch(self, sf: float = 0.01, seed: int = 7, native=None) -> dict:
        """Generate and ingest the eight TPC-H tables into this session's
        database (storage/tpch.py). Returns table -> row count."""
        from tidb_tpu_torch.storage.tpch import load_tpch

        return load_tpch(self.catalog, sf=sf, db=self.db, seed=seed,
                         native=native)

    # ------------------------------------------------------------------

    def execute(self, sql: str) -> Optional[ResultSet]:
        """Execute one or more statements; returns the last result set."""
        result = None
        for stmt in parse(sql):
            result = self._execute_stmt(stmt)
        return result

    def query(self, sql: str) -> List[tuple]:
        rs = self.execute(sql)
        if rs is None:
            return []
        return rs.rows

    # ------------------------------------------------------------------

    def _plan_capacity(self, plan) -> int:
        """Chunk capacity sized to the plan's largest base table, clamped
        to the configured maximum (as tidb_tpu's Session does)."""
        cap = self.chunk_capacity
        if plan is None:
            return cap
        biggest = 0
        stack = [plan]
        while stack:
            node = stack.pop()
            t = getattr(node, "table", None)
            if t is not None:
                biggest = max(biggest, getattr(t, "n", 0))
            stack.extend(getattr(node, "children", ()))
        if biggest <= 0:
            return cap
        want = max(1 << 14, 1 << (biggest + (biggest >> 2)).bit_length())
        return min(cap, want)

    def _exec_ctx(self, plan=None) -> ExecContext:
        from tidb_tpu_torch.utils.memory import MemTracker

        sv = self.sysvars.get
        # the statement's memory root: its budget is tidb_mem_quota_query,
        # and spillables (segment pins) anchor here
        tracker = MemTracker(
            "query", budget=int(sv("tidb_mem_quota_query")),
            spill_enabled=bool(sv("tidb_enable_tmp_storage_on_oom")),
            spill_root=True)
        return ExecContext(
            chunk_capacity=self._plan_capacity(plan),
            device=self.device,
            group_concat_max_len=int(sv("group_concat_max_len")),
            join_device_build=bool(sv("tidb_tpu_join_device_build")),
            join_tiles=int(sv("tidb_tpu_join_tiles_per_dispatch")),
            join_probe_mode=str(sv("tidb_tpu_join_probe_mode")),
            mem_tracker=tracker,
            # the port has one engine, torch on self.device, so 'auto' takes
            # the device path on every device; 'off' keeps the host engine
            # (the generic aggregation's numpy groupby, the classic joins)
            device_agg=(bool(sv("tidb_enable_tpu_exec"))
                        and str(sv("tidb_device_engine_mode")) != "off"),
            columnar_enable=bool(sv("tidb_tpu_columnar_enable")),
            segment_rows=int(sv("tidb_tpu_segment_rows")),
            segment_delta_rows=int(sv("tidb_tpu_segment_delta_rows")),
            columnar_spill_dir=str(sv("tidb_tpu_columnar_spill_dir")),
            pipeline_fuse=bool(sv("tidb_tpu_pipeline_fuse")),
            prefetch_depth=int(sv("tidb_tpu_pipeline_prefetch_depth")),
            device_buffer_cache_bytes=int(sv("tidb_tpu_device_buffer_cache_bytes")),
        )

    def _execute_subplan(self, logical) -> List[tuple]:
        """Planner callback: run a bound logical subplan to completion."""
        logical = optimize_logical(
            logical,
            cascades=bool(self.sysvars.get("tidb_enable_cascades_planner")),
            agg_push_down=bool(self.sysvars.get("tidb_opt_agg_push_down")))
        phys = lower(logical)
        n_vis = phys.n_visible if isinstance(phys, PProjection) else None
        return run_plan(build_executor(phys), self._exec_ctx(plan=phys),
                        n_visible=n_vis).rows

    def _plan_select(self, stmt):
        return plan_statement(
            stmt, self.catalog, db=self.db,
            execute_subplan=self._execute_subplan,
            cascades=bool(self.sysvars.get("tidb_enable_cascades_planner")),
            n_parts=1,
            # columnar knobs for plan-time materialization (CTE reuse
            # segments its result iff enabled)
            session_info={
                "user": "root", "conn_id": 0,
                "columnar_enable": bool(self.sysvars.get("tidb_tpu_columnar_enable")),
                "segment_rows": int(self.sysvars.get("tidb_tpu_segment_rows"))},
            agg_push_down=bool(self.sysvars.get("tidb_opt_agg_push_down")),
        )

    def _run_select(self, stmt) -> ResultSet:
        phys = self._plan_select(stmt)
        root = build_executor(phys)
        n_vis = phys.n_visible if isinstance(phys, PProjection) else None
        if n_vis is None and hasattr(phys, "children") and phys.children:
            # Sort/Limit on top of the projection keep hidden sort columns
            c = phys
            while c.children and not isinstance(c, PProjection):
                c = c.children[0]
            if isinstance(c, PProjection) and c.n_visible is not None and c.n_visible < len(phys.schema):
                n_vis = c.n_visible
        return run_plan(root, self._exec_ctx(plan=phys), n_visible=n_vis)

    # ------------------------------------------------------------------

    def _sub_vars(self, e):
        """Replace @@sysvar / @uservar references with their current values
        (ref: sessionctx/variable resolution during expression rewriting)."""
        if isinstance(e, A.EVar):
            if e.scope == "user":
                v = self.user_vars.get(e.name.lstrip("@"))
            elif e.scope == "global":
                from tidb_tpu_torch.session.sysvars import SYSVARS

                n = e.name.lower()
                var = SYSVARS.get(n)
                if var is None:
                    raise ExecutionError(f"unknown system variable {n!r}")
                v = self.catalog.global_vars.get(n, var.default)
            else:
                v = self.sysvars.get(e.name)
            if v is None:
                return A.ENull()
            if isinstance(v, bool):
                return A.ENum("1" if v else "0")
            if isinstance(v, (int, float)):
                return A.ENum(repr(v))
            return A.EStr(str(v))
        if not hasattr(e, "__dataclass_fields__"):
            return e
        kwargs = {}
        for f in e.__dataclass_fields__:
            v = getattr(e, f)
            if isinstance(v, list):
                kwargs[f] = [
                    tuple(self._sub_vars(y) if hasattr(y, "__dataclass_fields__") else y for y in x)
                    if isinstance(x, tuple)
                    else self._sub_vars(x) if hasattr(x, "__dataclass_fields__") else x
                    for x in v
                ]
            elif hasattr(v, "__dataclass_fields__"):
                kwargs[f] = self._sub_vars(v)
            else:
                kwargs[f] = v
        return type(e)(**kwargs)

    def _execute_stmt(self, stmt) -> Optional[ResultSet]:
        if not isinstance(stmt, A.SetStmt) and _ast_contains(stmt, A.EVar):
            stmt = self._sub_vars(stmt)
        if isinstance(stmt, (A.SelectStmt, A.UnionStmt)):
            if getattr(stmt, "into_outfile", None) is not None:
                raise UnsupportedError("SELECT ... INTO OUTFILE is not yet ported")
            if getattr(stmt, "lock_mode", None) is not None:
                raise UnsupportedError("locking reads are not yet ported")
            return self._run_select(stmt)
        if isinstance(stmt, A.InsertStmt):
            return self._run_insert(stmt)
        if isinstance(stmt, A.CreateTableStmt):
            return self._run_create_table(stmt)
        if isinstance(stmt, A.DropTableStmt):
            for t in stmt.tables:
                self.catalog.drop_table(t.schema or self.db, t.name, stmt.if_exists)
            return None
        if isinstance(stmt, A.CreateDatabaseStmt):
            self.catalog.create_database(stmt.name, stmt.if_not_exists)
            return None
        if isinstance(stmt, A.UseStmt):
            self.catalog.database(stmt.db)  # raises if missing
            self.db = stmt.db
            return None
        if isinstance(stmt, A.SetStmt):
            from tidb_tpu_torch.planner.binder import Binder

            for scope, name, value in stmt.assignments:
                lit = Binder().bind_literal(value) if not isinstance(value, A.EName) else None
                v = lit.value if lit is not None else value.name
                if lit is not None and lit.type_.kind == TypeKind.DECIMAL:
                    v = v / (10 ** lit.type_.scale)
                if scope == "user":
                    self.user_vars[name.lstrip("@")] = v
                else:
                    self.sysvars.set(name, v, scope or "session")
            return None
        raise UnsupportedError(f"statement {type(stmt).__name__} is not yet ported")

    # -- DDL ---------------------------------------------------------------

    def _column_info(self, c: A.ColumnDef) -> ColumnInfo:
        t = parse_type_name(c.type_name, c.type_args)
        default = None
        if c.default is not None:
            from tidb_tpu_torch.planner.binder import Binder

            lit = Binder().bind_literal(c.default)
            default = lit.value
            if default is not None and lit.type_.kind == TypeKind.DECIMAL:
                import decimal as _dec

                # literals carry scaled-int decimals; defaults are stored
                # in logical form (DEFAULT 1.5 is 1.5, not 15), exactly
                default = _dec.Decimal(default).scaleb(-lit.type_.scale)
        text = c.type_name.lower()
        if c.type_args:
            text += "(" + ",".join(str(a) for a in c.type_args) + ")"
        return ColumnInfo(
            c.name, t,
            not_null=c.not_null or c.primary_key,
            default=default,
            auto_increment=c.auto_increment,
            type_text=text,
            collation=c.collation,
        )

    def _run_create_table(self, stmt: A.CreateTableStmt):
        unported = [
            ("LIKE", stmt.like is not None),
            ("AS SELECT", stmt.as_select is not None),
            ("TEMPORARY", stmt.temporary),
            ("PARTITION BY", stmt.partition is not None),
            ("SHARD BY", stmt.shard is not None),
            ("FOREIGN KEY", bool(stmt.foreign_keys)),
            ("UNIQUE KEY", bool(stmt.unique_keys)
             or any(c.unique for c in stmt.columns)),
            ("INDEX", bool(stmt.indexes)),
            ("CHECK", bool(stmt.checks) or any(c.checks for c in stmt.columns)),
            ("GENERATED column", any(c.generated is not None for c in stmt.columns)),
        ]
        for what, present in unported:
            if present:
                raise UnsupportedError(f"CREATE TABLE ... {what} is not yet ported")
        cols = []
        pk = list(stmt.primary_key) if stmt.primary_key else None
        for c in stmt.columns:
            if c.primary_key:
                pk = [c.name]
            info = self._column_info(c)
            if info.collation is None and stmt.collation:
                info.collation = stmt.collation  # table default COLLATE
            cols.append(info)
        schema = TableSchema(stmt.table.name, cols, primary_key=pk,
                             collation=stmt.collation, cluster_by=stmt.cluster)
        self.catalog.create_table(stmt.table.schema or self.db, schema,
                                  stmt.if_not_exists)
        return None

    # -- DML ---------------------------------------------------------------

    def _run_insert(self, stmt: A.InsertStmt):
        if stmt.select is not None or stmt.replace or stmt.on_dup:
            raise UnsupportedError(
                "INSERT ... SELECT / REPLACE / ON DUPLICATE KEY UPDATE are not yet ported")
        from tidb_tpu_torch.planner.binder import Binder

        table = self.catalog.table(stmt.table.schema or self.db, stmt.table.name)
        binder = Binder()
        rows = []
        names = stmt.columns or table.insertable_names()
        for r_ast in stmt.rows:
            if len(r_ast) != len(names):
                raise ExecutionError(
                    f"column count mismatch: {len(r_ast)} values for {len(names)} columns"
                )
            rows.append([self._bind_const(binder, cell, table.schema.col(cname))
                         for cell, cname in zip(r_ast, names)])
        with self.catalog.lock:  # single-writer commit point
            table.insert_rows(rows, columns=stmt.columns)
        return None

    def _bind_const(self, binder, cell_ast, col: ColumnInfo):
        """Evaluate a constant INSERT value to a python value in the
        table's logical form."""
        from tidb_tpu_torch.expression.expr import Literal
        from tidb_tpu_torch.planner.binder import Scope
        from tidb_tpu_torch.planner.rules import fold_constants
        from tidb_tpu_torch.types import days_to_date, micros_to_datetime

        bound = binder.bind_expr(cell_ast, Scope([], None))
        bound = binder.coerce_untyped_literal(bound, col.type_)
        bound = fold_constants(bound)
        if not isinstance(bound, Literal):
            raise UnsupportedError("non-constant INSERT value")
        if bound.value is None:
            return None
        k = col.type_.kind
        v = bound.value
        if k == TypeKind.DATE:
            if bound.type_.kind == TypeKind.DATE:
                return days_to_date(v)
            return v
        if k == TypeKind.DATETIME:
            if bound.type_.kind == TypeKind.DATETIME:
                return micros_to_datetime(v)
            return v
        if k == TypeKind.DECIMAL:
            if bound.type_.kind == TypeKind.DECIMAL:
                import decimal as _dec

                # exact descale: float division corrupts 16+-digit decimals
                return _dec.Decimal(v).scaleb(-bound.type_.scale)
            return v
        if k == TypeKind.TIME:
            if bound.type_.kind == TypeKind.TIME:
                import datetime as _dt

                return _dt.timedelta(microseconds=v)
            return v
        if k == TypeKind.ENUM:
            if bound.type_.kind == TypeKind.ENUM:
                if v == 0:  # coercion's no-match sentinel: invalid on insert
                    raise ExecutionError(
                        f"invalid ENUM value for column {col.name!r}")
                return int(v)  # 1-based index
            return v
        if k == TypeKind.SET:
            if bound.type_.kind == TypeKind.SET:
                if v < 0:
                    raise ExecutionError(
                        f"invalid SET value for column {col.name!r}")
                return int(v)  # bitmask
            return v
        if bound.type_.kind == TypeKind.DECIMAL:
            # decimal literal into a non-decimal column: leave the
            # scaled-int representation (1.5 is Literal(15, scale=1))
            if k == TypeKind.STRING:
                from tidb_tpu_torch.types import scaled_to_decimal_str

                return scaled_to_decimal_str(v, bound.type_.scale)
            return v / (10 ** bound.type_.scale)
        if k == TypeKind.STRING:
            return str(v)
        return v


def _ast_contains(e, cls) -> bool:
    """Whether any node of type `cls` occurs in an AST (tuples in lists
    included — e.g. SET assignments, CASE whens)."""
    if isinstance(e, cls):
        return True
    if not hasattr(e, "__dataclass_fields__"):
        return False
    for f in e.__dataclass_fields__:
        v = getattr(e, f)
        if isinstance(v, list):
            for x in v:
                if isinstance(x, tuple):
                    if any(_ast_contains(y, cls) for y in x if hasattr(y, "__dataclass_fields__")):
                        return True
                elif hasattr(x, "__dataclass_fields__") and _ast_contains(x, cls):
                    return True
        elif hasattr(v, "__dataclass_fields__") and _ast_contains(v, cls):
            return True
    return False
