"""Session: the SQL entry point of the port.

A statement loop of its own over the copied parser and planner: CREATE
TABLE (PRIMARY KEY, UNIQUE KEY, INDEX, FOREIGN KEY, CHECK, generated
columns, PARTITION BY RANGE/HASH and CLUSTER BY included) / DROP TABLE /
CREATE DATABASE / USE / TRUNCATE / CREATE and DROP INDEX / ALTER TABLE
(ADD/DROP/MODIFY COLUMN, RENAME, ADD INDEX, ADD/DROP FOREIGN KEY,
ADD/DROP CHECK, CLUSTER BY) and the single-process online-DDL stages
(`apply_ddl_stage`), INSERT (VALUES and SELECT, REPLACE, ON DUPLICATE
KEY UPDATE), UPDATE and DELETE (single- and multi-table), BEGIN / START
TRANSACTION / COMMIT / ROLLBACK, SAVEPOINT / ROLLBACK TO / RELEASE
SAVEPOINT and the `autocommit` sysvar, SET, SELECT (UNION included) and
its locking form (FOR UPDATE / FOR SHARE), CREATE [OR REPLACE] / DROP
VIEW, ANALYZE TABLE, EXPLAIN [ANALYZE] and SHOW, plus `load_tpch`.
Writes run inside a transaction (`TxnState`: an implicit one commits at
statement end) and commit through the two-phase committer
(storage/txn2pc.py); reads inside a transaction see its snapshot and its
own provisional rows (`_exec_ctx`'s `read_ts` and `txn_marker`). A
commit that wrote rows re-analyzes the tables whose modifications crossed
the auto-analyze threshold (`tidb_enable_auto_analyze`,
`tidb_auto_analyze_ratio`), as the reference does.
Statements run on `device`: None means the CUDA card, and a Session
without a card raises instead of carrying on on the CPU.

Every statement is bracketed for CLUSTER BY ordered compaction: due
permutes run at quiescent statement boundaries, and the statement itself
registers as a lock-free reader in between.

Not yet ported from tidb_tpu/session/session.py: CREATE TABLE ... LIKE /
AS SELECT / TEMPORARY / SHARD BY, the DDL job queue, the delta engine,
KILL and statement deadlines, LOAD DATA, TRACE, SHOW GRANTS /
PROCESSLIST / BINDINGS / PLUGINS, users and privileges (EXPLAIN checks
none), SQL bindings (EXPLAIN shows the unbound plan), prepared
statements, the plan cache, plan feedback, tracing and the serving, DCN
and mesh tiers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from tidb_tpu_torch.errors import (
    ExecutionError,
    PlanError,
    SchemaError,
    UnsupportedError,
    WriteConflictError,
)
from tidb_tpu_torch.executor import ExecContext, ResultSet, build_executor, run_plan
from tidb_tpu_torch.parser import ast as A
from tidb_tpu_torch.parser import parse
from tidb_tpu_torch.planner.optimizer import plan_statement
from tidb_tpu_torch.planner.physical import PProjection, explain_text, lower
from tidb_tpu_torch.planner.rules import optimize_logical
from tidb_tpu_torch.session.sysvars import SysVarStore
from tidb_tpu_torch.storage.catalog import Catalog
from tidb_tpu_torch.storage.table import ColumnInfo, TableSchema
from tidb_tpu_torch.types import TypeKind, parse_type_name
from tidb_tpu_torch.utils.device import resolve_device

__all__ = ["Session", "TxnState", "wire_check", "wire_generated"]

# SHOW kinds whose modules the port does not have yet
_SHOW_UNPORTED = {"grants": "users and privileges",
                  "processlist": "KILL and the process list",
                  "bindings": "SQL plan bindings",
                  "plugins": "the plugin framework"}


@dataclasses.dataclass
class TxnState:
    """An open transaction (ref: session txn lifecycle over the Percolator
    model — here the marker doubles as the provisional ts and row lock)."""

    marker: int
    read_ts: int
    # id(table) -> (table, TableTxnLog): commit/rollback touch only the
    # logged rows, not whole version arrays
    logs: dict = dataclasses.field(default_factory=dict)
    # tables holding this txn's pessimistic row locks (FOR UPDATE/SHARE)
    lock_tables: dict = dataclasses.field(default_factory=dict)
    # ordered savepoints: (name, {table_id: (n_ranges, n_ended)})
    savepoints: list = dataclasses.field(default_factory=list)

    def log_for(self, table):
        from tidb_tpu_torch.storage.table import TableTxnLog

        entry = self.logs.get(id(table))
        if entry is None:
            entry = (table, TableTxnLog())
            self.logs[id(table)] = entry
        return entry[1]

    def set_savepoint(self, name: str) -> None:
        """Snapshot per-table log positions (ref: the txn memdb's
        staging checkpoints backing SAVEPOINT)."""
        snap = {tid: (len(log.ranges), len(log.ended))
                for tid, (_t, log) in self.logs.items()}
        # re-declaring a name moves it (MySQL: old one is deleted)
        self.savepoints = [(n, s) for n, s in self.savepoints if n != name]
        self.savepoints.append((name, snap))

    def rollback_to(self, name: str) -> bool:
        """Undo every write made after `name` (kept, per MySQL).
        Inserted versions after the snapshot die; provisional deletes
        after it are restored; logs truncate to the snapshot."""
        import numpy as np

        from tidb_tpu_torch.storage.table import MAX_TS

        idx = next((i for i, (n, _s) in enumerate(self.savepoints)
                    if n == name), None)
        if idx is None:
            return False
        snap = self.savepoints[idx][1]
        for tid, (table, log) in self.logs.items():
            nr, ne = snap.get(tid, (0, 0))
            if len(log.ranges) == nr and len(log.ended) == ne:
                continue  # untouched since the savepoint: keep caches
            # restore deletes first, then kill inserted versions (a row
            # both inserted and deleted after the savepoint ends dead)
            for ids in log.ended[ne:]:
                e_ = table.end_ts[ids]
                table.end_ts[ids] = np.where(
                    e_ == self.marker, MAX_TS, e_)
            for s, e in log.ranges[nr:]:
                b = table.begin_ts[s:e]
                dead = b == self.marker
                table.end_ts[s:e][dead] = 0
                b[dead] = 0
            del log.ranges[nr:]
            del log.ended[ne:]
            log.contiguous = False  # version window no longer this txn's own
            # prune _txn_dead to the restored delete set: stale ids would
            # let REPLACE treat rows as this-txn-deleted (unique holes)
            if self.marker in table._txn_dead:
                keep = set()
                for ids in log.ended:
                    keep.update(int(i) for i in ids)
                table._txn_dead[self.marker] = [
                    i for i in table._txn_dead[self.marker] if i in keep]
            table.version += 1
        del self.savepoints[idx + 1:]
        return True

    def release_savepoint(self, name: str) -> bool:
        """Drop `name` and every later savepoint (MySQL semantics); the
        txn's changes are untouched."""
        idx = next((i for i, (n, _s) in enumerate(self.savepoints)
                    if n == name), None)
        if idx is None:
            return False
        del self.savepoints[idx:]
        return True


class Session:
    def __init__(self, catalog: Optional[Catalog] = None, db: str = "test",
                 chunk_capacity: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self.catalog = catalog if catalog is not None else Catalog()
        self.db = db
        self._chunk_capacity = chunk_capacity  # explicit override; else sysvar
        self.sysvars = SysVarStore(self.catalog.global_vars)
        self.user_vars: dict = {}
        self.txn: Optional[TxnState] = None
        # set while a FOR UPDATE/SHARE read runs: reads latest committed
        # instead of the txn snapshot (MySQL locking reads are current)
        self._lock_read = False
        # SHOW WARNINGS' area, reset by every other statement
        self._warnings: list = []
        # the statement's memory trackers (EXPLAIN ANALYZE's mem_max)
        self._stmt_trackers: list = []

    @property
    def chunk_capacity(self) -> int:
        if self._chunk_capacity is not None:
            return self._chunk_capacity
        return int(self.sysvars.get("tidb_max_chunk_size"))

    # -- transactions ------------------------------------------------------

    def _begin(self) -> None:
        if self.txn is not None:
            self._commit()  # MySQL: BEGIN implicitly commits the open txn
        marker, read_ts = self.catalog.begin_txn()  # registers for GC safepoint
        self.txn = TxnState(marker=marker, read_ts=read_ts)

    def _ensure_txn(self):
        """(txn, implicit): implicit txns commit at statement end."""
        if self.txn is not None:
            return self.txn, False
        self._begin()
        if not self.sysvars.get("autocommit"):
            return self.txn, False
        return self.txn, True

    def _commit(self) -> None:
        txn, self.txn = self.txn, None
        if txn is None:
            return
        with self.catalog.lock:  # single-writer commit point
            self._commit_locked(txn)

    def _commit_locked(self, txn) -> None:
        from tidb_tpu_torch.storage.txn2pc import TwoPhaseCommitter

        committer = TwoPhaseCommitter(
            self.catalog, txn.marker, list(txn.logs.values()))
        try:
            committer.execute()
        except Exception:
            # UNDECIDED failure (prewrite error / crash before the commit
            # point): abort so the row locks can't leak — without a status
            # record resolve_locks could never clean them up. A DECIDED
            # txn (status recorded) is committed; leave its residue for
            # resolve_locks, never roll it back.
            if self.catalog.txn_status(txn.marker) is None:
                committer.rollback()
            raise
        finally:
            # the txn is decided either way: pessimistic locks release
            for t in txn.lock_tables.values():
                t.release_locks(txn.marker)
        if txn.logs and self.sysvars.get("tidb_gc_enable"):
            self.catalog.auto_gc([t for t, _ in txn.logs.values()])
        if txn.logs and self.sysvars.get("tidb_enable_auto_analyze"):
            self.catalog.maybe_auto_analyze(
                [t for t, _ in txn.logs.values()],
                ratio=float(self.sysvars.get("tidb_auto_analyze_ratio")))

    def _rollback(self) -> None:
        txn, self.txn = self.txn, None
        if txn is None:
            return
        with self.catalog.lock:
            self._rollback_locked(txn)

    def _rollback_locked(self, txn) -> None:
        from tidb_tpu_torch.storage.txn2pc import TwoPhaseCommitter

        for t in txn.lock_tables.values():
            t.release_locks(txn.marker)
        TwoPhaseCommitter(
            self.catalog, txn.marker, list(txn.logs.values())).rollback()
        if txn.logs and self.sysvars.get("tidb_gc_enable"):
            self.catalog.auto_gc([t for t, _ in txn.logs.values()])

    def _run_dml(self, fn):
        """Run a write inside the session txn; implicit txns commit (or
        roll back on error) at statement end. A write conflict against a
        marker whose txn already DECIDED (crashed mid-2PC) resolves the
        stale locks and retries once — the Backoffer/resolve-lock flow.

        The mutation + implicit commit run under the catalog's writer
        lock: the storage layout is single-writer by design (ref: one
        leaseholder per region). Readers stay lock-free — MVCC timestamps
        make committed rows stable under concurrent appends."""
        txn, implicit = self._ensure_txn()
        with self.catalog.lock:
            try:
                try:
                    fn(txn)
                except WriteConflictError:
                    if self.catalog.resolve_locks():
                        fn(txn)  # stale locks cleared; one retry
                    else:
                        raise
            except Exception:
                if implicit:
                    txn2, self.txn = self.txn, None
                    if txn2 is not None:
                        self._rollback_locked(txn2)
                raise
            if implicit:
                txn2, self.txn = self.txn, None
                if txn2 is not None:
                    self._commit_locked(txn2)
        return None

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
            result = self._execute_bracketed(stmt)
        return result

    def _execute_bracketed(self, stmt) -> Optional[ResultSet]:
        """One statement inside the CLUSTER BY bracket: due permutes run
        at statement boundaries ONLY (never from a reader's plan_scan)
        and only while the catalog's reader registry is quiescent; the
        statement registers as a lock-free reader in between, so no
        other thread's boundary can move rows out from under it."""
        self.catalog.run_pending_reclusters()
        if not (isinstance(stmt, A.ShowStmt) and stmt.kind == "warnings"):
            self._warnings.clear()  # MySQL: each statement resets the area
        self._stmt_trackers = []
        self.catalog.reader_enter()
        try:
            return self._execute_stmt(stmt)
        finally:
            self.catalog.reader_exit()
            # a permute the statement's own plan_scan queued runs now,
            # at ITS end, with its scans closed
            self.catalog.run_pending_reclusters()

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
        # the statement may build several contexts (subplans): EXPLAIN
        # ANALYZE reports the max over all of them
        self._stmt_trackers.append(tracker)
        del self._stmt_trackers[:-64]  # bound pathological statements
        return ExecContext(
            chunk_capacity=self._plan_capacity(plan),
            device=self.device,
            # inside a transaction: its snapshot plus its own provisional
            # rows (the fused fragments read this per batch and bypass the
            # device buffer cache)
            read_ts=(None if self._lock_read else
                     self.txn.read_ts if self.txn is not None else None),
            txn_marker=self.txn.marker if self.txn is not None else 0,
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
            compaction_enable=bool(sv("tidb_tpu_compaction")),
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

    def _run_locking_select(self, stmt) -> ResultSet:
        # NOTE on cost: the visible query runs once, plus one hidden
        # __rowid__ shadow query per base table. Folding rowids into the
        # main select is impossible in general (DISTINCT/GROUP BY/agg
        # shapes have no per-row identity), so the shadow pass is the
        # uniform mechanism; locking reads are OLTP-sized by nature.
        """SELECT ... FOR UPDATE / SHARE (ref: pessimistic locking reads
        over the 2PC row locks).

        Pessimistic protocol: under the catalog lock, (1) read at the
        LATEST committed snapshot (MySQL locking reads are current
        reads, not consistent reads), (2) collect the matched base-table
        row ids via the hidden __rowid__ columns, (3) if every row is
        free, register the locks and return. On conflict: release the
        catalog lock, wait, retry the whole read — bounded by
        innodb_lock_wait_timeout (timeout breaks any deadlock cycle);
        NOWAIT fails on the first conflict. Locks release at
        commit/rollback; without an open txn the check still serializes
        against other txns' locks but registers nothing (the statement
        is its own transaction)."""
        import time as _time

        mode = "x" if stmt.lock_mode == "update" else "s"
        targets = []
        if stmt.from_ is not None:
            # refuse shapes whose rows we cannot map back to base-table
            # row ids: silently locking NOTHING would hand the caller a
            # read-modify-write foot-gun
            def visit(src):
                if isinstance(src, A.TableName):
                    yield src
                elif isinstance(src, A.Join):
                    yield from visit(src.left)
                    yield from visit(src.right)
                else:
                    raise UnsupportedError(
                        "FOR UPDATE/SHARE over derived tables is not "
                        "supported; lock the base tables directly")
            for tn in visit(stmt.from_):
                db = tn.schema or self.db
                if any(c.name == tn.name for c in getattr(stmt, "ctes", ())):
                    raise UnsupportedError(
                        "FOR UPDATE/SHARE over a CTE is not supported")
                targets.append((tn, self.catalog.table(db, tn.name)))
        timeout = 0.0 if stmt.lock_nowait else float(
            self.sysvars.get("innodb_lock_wait_timeout"))
        deadline = _time.monotonic() + timeout
        marker = self.txn.marker if self.txn is not None else 0
        while True:
            with self.catalog.lock:
                self._lock_read = True
                try:
                    rs = self._run_select(stmt)
                    per_table = []
                    for tn, table in targets:
                        alias = tn.alias or tn.name
                        shadow = A.SelectStmt(
                            items=[A.SelectItem(
                                A.EName("__rowid__", qualifier=alias))],
                            from_=stmt.from_, where=stmt.where,
                            ctes=getattr(stmt, "ctes", []))
                        srs = self._run_select(shadow)
                        ids = np.array(
                            sorted({r[0] for r in srs.rows
                                    if r[0] is not None}),
                            dtype=np.int64)
                        per_table.append((table, ids))
                finally:
                    self._lock_read = False
                conflict = None
                for table, ids in per_table:
                    conflict = table.lock_conflict(ids, marker, mode)
                    if conflict:
                        conflict = f"{table.schema.name}: {conflict}"
                        break
                if conflict is None:
                    if self.txn is not None:
                        for table, ids in per_table:
                            table.lock_rows(ids, marker, mode)
                            self.txn.lock_tables[id(table)] = table
                    return rs
            if _time.monotonic() >= deadline:
                raise ExecutionError(
                    "Lock wait timeout exceeded; try restarting "
                    f"transaction ({conflict})")
            _time.sleep(0.02)

    def _run_select(self, stmt) -> ResultSet:
        if self.txn is None and not self.sysvars.get("autocommit"):
            self._begin()  # consistent-snapshot reads without autocommit
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
        # a DECIDED txn whose commit crashed mid-secondaries leaves rows
        # invisible behind marker timestamps; readers resolve such locks
        # at the statement boundary (the reader-side resolve-lock flow) —
        # commits run under the catalog lock, so a pending status here
        # always means a crashed txn
        if self.catalog.has_stale_txns():
            self.catalog.resolve_locks()
        if not isinstance(stmt, A.SetStmt) and _ast_contains(stmt, A.EVar):
            stmt = self._sub_vars(stmt)
        if isinstance(stmt, (A.SelectStmt, A.UnionStmt)):
            if getattr(stmt, "into_outfile", None) is not None:
                raise UnsupportedError("SELECT ... INTO OUTFILE is not yet ported")
            if isinstance(stmt, A.UnionStmt) and any(
                    getattr(arm, "lock_mode", None)
                    for arm in _union_arms(stmt)):
                # MySQL rejects FOR UPDATE on union arms too
                raise UnsupportedError("FOR UPDATE is not allowed with UNION")
            if getattr(stmt, "lock_mode", None) is not None:
                return self._run_locking_select(stmt)
            return self._run_select(stmt)
        if isinstance(stmt, A.ExplainStmt):
            return self._run_explain(stmt)
        if isinstance(stmt, A.ShowStmt):
            return self._run_show(stmt)
        if isinstance(stmt, A.AnalyzeStmt):
            from tidb_tpu_torch.statistics import analyze_table

            for tn in stmt.tables:
                t = self.catalog.table(tn.schema or self.db, tn.name)
                analyze_table(t)
                t.modify_count = 0
            return None
        if isinstance(stmt, A.CreateViewStmt):
            self._commit()  # DDL semantics
            self.catalog.create_view(
                stmt.schema or self.db, stmt.name, stmt.columns,
                stmt.select, stmt.select_sql, stmt.or_replace)
            return None
        if isinstance(stmt, A.DropViewStmt):
            self._commit()
            # MySQL 8: all-or-nothing — validate every name first
            if not stmt.if_exists:
                for t in stmt.names:
                    if self.catalog.view(t.schema or self.db, t.name) is None:
                        raise SchemaError(f"no view {t.schema or self.db}.{t.name}")
            for t in stmt.names:
                self.catalog.drop_view(t.schema or self.db, t.name, if_exists=True)
            return None
        if isinstance(stmt, A.InsertStmt):
            return self._run_insert(stmt)
        if isinstance(stmt, A.UpdateStmt):
            return self._run_update(stmt)
        if isinstance(stmt, A.DeleteStmt):
            return self._run_delete(stmt)
        if isinstance(stmt, A.BeginStmt):
            self._begin()
            return None
        if isinstance(stmt, A.CommitStmt):
            self._commit()
            return None
        if isinstance(stmt, A.RollbackStmt):
            self._rollback()
            return None
        if isinstance(stmt, A.SavepointStmt):
            if self.txn is None and not self.sysvars.get("autocommit"):
                self._begin()  # MySQL: SAVEPOINT joins/starts the txn
            if self.txn is not None:  # no-op in autocommit (MySQL)
                with self.catalog.lock:
                    self.txn.set_savepoint(stmt.name)
            return None
        if isinstance(stmt, A.RollbackToStmt):
            ok = False
            if self.txn is not None:
                with self.catalog.lock:
                    ok = self.txn.rollback_to(stmt.name)
            if not ok:
                raise ExecutionError(
                    f"SAVEPOINT {stmt.name} does not exist")
            return None
        if isinstance(stmt, A.ReleaseSavepointStmt):
            if self.txn is None or not self.txn.release_savepoint(stmt.name):
                raise ExecutionError(
                    f"SAVEPOINT {stmt.name} does not exist")
            return None
        if isinstance(stmt, A.AlterTableStmt):
            return self._run_alter_table(stmt)
        if isinstance(stmt, A.TruncateStmt):
            t = self.catalog.table(stmt.table.schema or self.db, stmt.table.name)
            with self.catalog.lock:
                t.truncate()
            return None
        if isinstance(stmt, A.CreateIndexStmt):
            t = self.catalog.table(stmt.table.schema or self.db, stmt.table.name)
            with self.catalog.lock:
                t.create_index(stmt.name, stmt.columns, unique=stmt.unique)
            # index DDL changes access-path choices (and clears the device
            # buffer cache through the catalog hook)
            self.catalog.schema_version += 1
            return None
        if isinstance(stmt, A.DropIndexStmt):
            t = self.catalog.table(stmt.table.schema or self.db, stmt.table.name)
            with self.catalog.lock:
                t.drop_index(stmt.name)
            self.catalog.schema_version += 1
            return None
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
                    # MySQL: enabling autocommit commits the open txn
                    if (name.lower() == "autocommit" and scope != "global"
                            and self.sysvars.get("autocommit")):
                        self._commit()
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

    def apply_ddl_stage(self, sql: str, stage: str) -> None:
        """One step of an ONLINE schema change (ref: the multi-version
        none→write-only→public state machine with schema-version leases).
        A coordinator drives every instance through the same stage before
        advancing, so at most two adjacent states coexist:

        ADD COLUMN:  write_only -> public
          write_only: the column exists in storage (default-backfilled)
          and is written by new DML, but is invisible to reads — an
          instance still at the previous version keeps inserting the
          old positional shape correctly.
        ADD INDEX:   write_only -> backfill -> public
          write_only: enforced on every new write, invisible to access
          paths; backfill: validate all existing rows (abort drops the
          staged index); public: readable.
        abort: undo a staged ADD (crash/validation-failure path)."""
        stmt = parse(sql)[0]
        if not isinstance(stmt, A.AlterTableStmt) or stmt.action not in (
                "add_column", "add_index"):
            raise UnsupportedError(
                "online DDL stages cover ADD COLUMN / ADD INDEX only")
        db = stmt.table.schema or self.db
        t = self.catalog.table(db, stmt.table.name)
        with self.catalog.lock:
            if stmt.action == "add_column":
                info = self._column_info(stmt.column)
                if info.collation is None and t.schema.collation:
                    info.collation = t.schema.collation
                if stage == "write_only":
                    if info.not_null and info.default is None:
                        raise ExecutionError(
                            "online ADD COLUMN requires a DEFAULT for a "
                            "NOT NULL column (writers one schema version "
                            "behind cannot supply it)")
                    info.state = "write_only"
                    t.add_column(info)
                elif stage == "public":
                    t.schema.col(info.name).state = "public"
                    t.version += 1
                elif stage == "abort":
                    # only a STAGED column may be dropped: a duplicate-
                    # name failure must never destroy the user's column
                    if any(c.name == info.name and c.state == "write_only"
                           for c in t.schema.columns):
                        t.schema.col(info.name).state = "public"
                        t.drop_column(info.name)
                else:
                    raise UnsupportedError(f"bad ddl stage {stage!r}")
            else:
                name, columns = stmt.index
                iname = name or f"idx_{'_'.join(columns)}"
                if stage == "write_only":
                    t.create_index(iname, columns, unique=stmt.unique,
                                   state="write_only")
                elif stage == "backfill":
                    idx = t.indexes[iname]
                    if idx.unique:
                        try:
                            t._check_unique(idx)
                        except Exception:
                            t.drop_index(iname)
                            raise
                elif stage == "public":
                    t.indexes[iname].state = "public"
                    t.version += 1
                elif stage == "abort":
                    staged = t.indexes.get(iname)
                    if staged is not None and staged.state == "write_only":
                        t.drop_index(iname)
                else:
                    raise UnsupportedError(f"bad ddl stage {stage!r}")
            self.catalog.schema_version += 1

    def _run_alter_table(self, stmt: A.AlterTableStmt):
        db = stmt.table.schema or self.db
        t = self.catalog.table(db, stmt.table.name)
        def with_table_coll(info):
            if info.collation is None and t.schema.collation:
                info.collation = t.schema.collation
            return info

        if stmt.action == "add_column":
            t.add_column(with_table_coll(self._column_info(stmt.column)))
        elif stmt.action == "drop_column":
            t.drop_column(stmt.old_name)
        elif stmt.action == "modify_column":
            t.modify_column(with_table_coll(self._column_info(stmt.column)))
        elif stmt.action == "rename":
            self.catalog.rename_table(db, stmt.table.name, stmt.new_name)
        elif stmt.action == "add_index":
            name, columns = stmt.index
            t.create_index(name or f"idx_{'_'.join(columns)}", columns,
                           unique=stmt.unique)
        elif stmt.action == "add_foreign_key":
            parent, fk = self.catalog._resolve_foreign_key(db, t, stmt.fk)
            if stmt.new_name:
                fk.name = stmt.new_name
            if any(f.name == fk.name for f in t.foreign_keys):
                raise SchemaError(
                    f"duplicate foreign key constraint name {fk.name!r}")
            # existing rows must already satisfy the constraint (same
            # probe as every write path, live versions only)
            if t.n:
                t._check_fk_parents(0, t.n, fks=[fk], live_only=True)
            t.foreign_keys.append(fk)
            parent.referencing.append((t, fk))
        elif stmt.action == "drop_foreign_key":
            fk = next((f for f in t.foreign_keys
                       if f.name == stmt.old_name), None)
            if fk is None:
                raise SchemaError(f"no foreign key {stmt.old_name!r}")
            t.foreign_keys.remove(fk)
            fk.parent.referencing = [
                (c, f) for c, f in fk.parent.referencing if f is not fk]
        elif stmt.action == "add_check":
            cname, e_ast, txt = stmt.check
            name = cname
            if not name:  # first free generated slot
                i = 1
                while any(c.name == f"{t.schema.name}_chk_{i}"
                          for c in t.checks):
                    i += 1
                name = f"{t.schema.name}_chk_{i}"
            wire_check(t, name, e_ast, txt)
            # existing rows must satisfy THE NEW CHECK specifically (no
            # column filter: a constant predicate has no columns at all)
            chk = t.checks[-1]
            try:
                if t.n:
                    t._check_row_constraints(0, t.n, live_only=True,
                                             checks=[chk])
            except ExecutionError:
                t.checks.pop()
                raise
        elif stmt.action == "drop_check":
            before = len(t.checks)
            t.checks = [c for c in t.checks if c.name != stmt.old_name]
            if len(t.checks) == before:
                raise SchemaError(f"no CHECK constraint {stmt.old_name!r}")
        elif stmt.action == "cluster":
            # ordered-compaction hint: persisted on the schema; the NEXT
            # delta->segment fold physically re-sorts the table
            # (Table.recluster), so the statement itself stays
            # metadata-only
            t.schema.cluster_by = self._cluster_by_col(
                stmt.cluster, t.schema.columns)
            base = getattr(t, "_base", t)
            base.clustered_rows = 0  # force the re-sort at the next fold
        else:
            # reshard (SHARD BY placement) waits for the multi-device tier
            raise UnsupportedError(f"ALTER TABLE {stmt.action}")
        # every completed ALTER advances the schema version (ref: one
        # version per DDL job) — plan-cache invalidation hangs off it
        self.catalog.schema_version += 1
        return None

    @staticmethod
    def _cluster_by_col(name, cols):
        """Validate a CLUSTER BY column name (None = clear the hint).
        Any orderable type works — dictionary codes order
        lexicographically by construction — except JSON, whose code
        order carries no meaning worth sorting a table by."""
        if name is None:
            return None
        info = next((c for c in cols if c.name == name), None)
        if info is None:
            raise SchemaError(f"unknown cluster column {name!r}")
        if info.type_.kind == TypeKind.JSON:
            raise SchemaError(
                f"cluster column {name!r} must not be JSON-typed")
        return name

    def _run_create_table(self, stmt: A.CreateTableStmt):
        unported = [
            ("LIKE", stmt.like is not None),
            ("AS SELECT", stmt.as_select is not None),
            ("TEMPORARY", stmt.temporary),
            ("SHARD BY", stmt.shard is not None),
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
        part = None
        if stmt.partition is not None:
            from tidb_tpu_torch.storage.table import PartitionInfo

            kind, pcol, spec = stmt.partition
            pinfo = next((c for c in cols if c.name == pcol), None)
            if pinfo is None:
                raise SchemaError(f"unknown partition column {pcol!r}")
            if pinfo.type_.kind != TypeKind.INT:
                # MySQL likewise rejects non-integer partition functions
                raise SchemaError(
                    f"partition column {pcol!r} must be integer-typed")
            if kind == "range":
                uppers = [u for _n, u in spec]
                finite = [u for u in uppers if u is not None]
                strictly_inc = all(a < b for a, b in zip(finite, finite[1:]))
                maxvalue_ok = all(u is not None for u in uppers[:-1])
                if not strictly_inc or not maxvalue_ok:
                    raise SchemaError(
                        "RANGE partition bounds must be strictly "
                        "increasing with MAXVALUE last")
                part = PartitionInfo(kind="range", column=pcol,
                                     names=[n for n, _u in spec],
                                     uppers=uppers)
            else:
                part = PartitionInfo(kind="hash", column=pcol,
                                     n_parts=int(spec))
        schema = TableSchema(stmt.table.name, cols, primary_key=pk,
                             collation=stmt.collation, partition=part,
                             cluster_by=self._cluster_by_col(
                                 stmt.cluster, cols))
        t = self.catalog.create_table(
            stmt.table.schema or self.db, schema, stmt.if_not_exists,
            foreign_keys=stmt.foreign_keys)
        if t is not None and t.schema is schema:
            # inline constraint wiring happens only on a table this
            # statement actually created, and a failure must UNDO the
            # creation, or the catalog keeps a half-constrained table
            try:
                for kname, kcols in stmt.unique_keys:
                    t.create_index(kname or f"uk_{'_'.join(kcols)}", kcols,
                                   unique=True)
                for c in stmt.columns:
                    # column-level UNIQUE attribute == a unique key
                    if c.unique and not any(
                            ix.columns == [c.name] and ix.unique
                            for ix in t.indexes.values()):
                        t.create_index(f"uk_{c.name}", [c.name], unique=True)
                for kname, kcols in stmt.indexes:
                    t.create_index(kname or f"idx_{'_'.join(kcols)}", kcols)
                specs = [("", e, txt) for c in stmt.columns
                         for e, txt in c.checks] + list(stmt.checks)
                for i, (cname, e_ast, txt) in enumerate(specs):
                    wire_check(
                        t, cname or f"{schema.name}_chk_{i + 1}", e_ast, txt)
                for c in stmt.columns:
                    if c.generated is not None:
                        e_ast, txt, stored = c.generated
                        wire_generated(t, c.name, e_ast, txt, stored)
            except Exception:
                self.catalog.drop_table(stmt.table.schema or self.db,
                                        schema.name, if_exists=True)
                raise
            for item in stmt.ignored + [i for c in stmt.columns
                                        for i in c.ignored]:
                # accepted-but-ignored clauses surface as warnings
                # instead of vanishing (SHOW WARNINGS; MySQL code 1235)
                self._warnings.append(
                    ("Warning", 1235, f"{item} is parsed but ignored"))
        return None

    # -- DML ---------------------------------------------------------------

    def _run_insert(self, stmt: A.InsertStmt):
        table = self.catalog.table(stmt.table.schema or self.db, stmt.table.name)
        gen_cols = {g.col for g in table.generated}
        if stmt.columns and gen_cols & set(stmt.columns):
            bad = sorted(gen_cols & set(stmt.columns))[0]
            raise ExecutionError(
                f"column {bad!r} is a generated column: "
                "its value cannot be inserted")
        if stmt.select is not None:
            def do(txn):
                rs = self._run_select(stmt.select)
                rows = [list(r) for r in rs.rows]
                if stmt.replace:
                    self._replace_rows(table, rows, stmt.columns, txn)
                elif stmt.on_dup:
                    row_asts = [[_value_to_ast(v) for v in r] for r in rows]
                    self._upsert_rows(table, stmt.table.name, rows, row_asts,
                                      stmt.columns, stmt.on_dup, txn)
                else:
                    table.insert_rows(rows, columns=stmt.columns,
                                      begin_ts=txn.marker,
                                      log=txn.log_for(table))

            return self._run_dml(do)
        from tidb_tpu_torch.planner.binder import Binder

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

        tname = stmt.table.name

        if stmt.replace:
            def do(txn):
                self._replace_rows(table, rows, stmt.columns, txn)

            return self._run_dml(do)

        if stmt.on_dup:
            def do(txn):
                self._upsert_rows(table, tname, rows, stmt.rows,
                                  stmt.columns, stmt.on_dup, txn)

            return self._run_dml(do)

        def do(txn):
            table.insert_rows(rows, columns=stmt.columns, begin_ts=txn.marker,
                              log=txn.log_for(table))

        return self._run_dml(do)

    # -- upsert machinery (ref: InsertExec's dup-key flows) ------------

    @staticmethod
    def _conflict_maps(table, marker):
        """One conflict map per enforced unique index (O(n) pass each);
        maintained incrementally across the statement's own mutations."""
        return {idx.name: (idx, table.conflict_map(idx, marker))
                for idx in table.indexes.values() if idx.unique}

    def _replace_rows(self, table, rows, columns, txn) -> None:
        """REPLACE: delete every live row any unique key collides with;
        a later VALUES row colliding with an earlier one of the same
        statement supersedes it (last row wins). One delete + one
        insert call per statement."""
        names = columns or table.schema.public_names()
        maps = self._conflict_maps(table, txn.marker)
        log = txn.log_for(table)
        pending: list = []
        dead: list = []
        for row in rows:
            vals = table.row_value_map(names, row)
            keys = [(idx, m, table.encode_index_key(idx, vals))
                    for idx, m in maps.values()]
            for _idx, m, key in keys:
                if key is None:
                    continue
                hit = m.pop(key, None)
                if hit is None:
                    continue
                if isinstance(hit, tuple):  # pending row of this statement
                    pending[hit[1]] = None
                elif hit not in dead:
                    dead.append(hit)
            pi = len(pending)
            pending.append(list(row))
            for _idx, m, key in keys:
                if key is not None:
                    m[key] = ("p", pi)
        if dead:
            table.delete_rows(np.array(dead, dtype=np.int64),
                              end_ts=txn.marker, marker=txn.marker, log=log,
                              log_for=txn.log_for)
        live = [r for r in pending if r is not None]
        if live:
            table.insert_rows(live, columns=columns, begin_ts=txn.marker,
                              log=log)

    def _upsert_rows(self, table, tname, rows, row_asts, columns,
                     assignments, txn) -> None:
        """INSERT ... ON DUPLICATE KEY UPDATE: conflicting rows are
        updated (VALUES(col) refers to the would-be-inserted value),
        fresh rows insert."""
        from tidb_tpu_torch.planner.binder import Binder

        binder = Binder()
        names = columns or table.schema.public_names()
        maps = self._conflict_maps(table, txn.marker)
        log = txn.log_for(table)
        for row, r_ast in zip(rows, row_asts):
            vals = table.row_value_map(names, row)
            hit = None
            for idx, m in maps.values():
                key = table.encode_index_key(idx, vals)
                if key is not None and key in m:
                    hit = m[key]
                    break
            if hit is None:
                table.insert_rows([row], columns=columns,
                                  begin_ts=txn.marker, log=log)
                new_id = table.n - 1
                for idx, m in maps.values():
                    key = table.encode_index_key(idx, vals)
                    if key is not None:
                        m[key] = new_id
                continue
            ids = np.array([hit], dtype=np.int64)
            cellmap = dict(zip(names, r_ast))
            # VALUES(col) over an omitted column yields its default
            # (consistent with row_value_map's conflict detection)
            for c in table.schema.columns:
                if c.name not in cellmap and c.default is not None \
                        and not c.auto_increment:
                    cellmap[c.name] = _value_to_ast(c.default)
            updates = {}
            for name_ast, val_ast in assignments:
                col = table.schema.col(name_ast.name)
                val_ast2 = _sub_values_refs(val_ast, cellmap)
                if not _ast_has_name(val_ast2):
                    v = self._bind_const(binder, val_ast2, col)
                    updates[col.name] = [v]
                else:
                    updates[col.name] = self._eval_update_expr(
                        table, tname, val_ast2, ids, col)
            table.update_rows(ids, updates, begin_ts=txn.marker,
                              end_ts=txn.marker, marker=txn.marker, log=log,
                              log_for=txn.log_for)
            # the update superseded `hit` with a new version: refresh
            # EVERY index's mapping (assignments may change key columns;
            # a later VALUES row hitting the stale id would silently
            # no-op against the dead version)
            new_id = table.n - 1
            for idx, m in maps.values():
                old_key = table.index_key_at(idx, hit)
                if old_key is not None and m.get(old_key) == hit:
                    del m[old_key]
                nk = table.index_key_at(idx, new_id)
                if nk is not None:
                    m[nk] = new_id

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


    # -- UPDATE / DELETE ---------------------------------------------------

    def _scan_cols(self, table, table_name: str):
        """(binder, storage PlanCols, the __rowid__ PlanCol) over `table`."""
        from tidb_tpu_torch.planner.binder import Binder, PlanCol
        from tidb_tpu_torch.types import INT64

        binder = Binder()
        cols = [
            PlanCol(
                uid=binder.new_uid(f"{table_name}.{c.name}"),
                name=c.name, type_=c.type_, qualifier=table_name,
                dict_=table.dicts.get(c.name),
            )
            for c in table.schema.columns
        ]
        rid = PlanCol(uid=binder.new_uid(f"{table_name}.__rowid__"),
                      name="__rowid__", type_=INT64, qualifier=table_name)
        return binder, cols, rid

    def _drain_rowid_scan(self, table, cols, rid, stages, bounds=(),
                          out_uid=None):
        """Run a TableScanExec staging only `cols` (the ones an expression
        references) plus the hidden __rowid__, and return the live rows'
        physical ids (and the `out_uid` column's data and validity) on the
        host."""
        from tidb_tpu_torch.executor.scan import TableScanExec

        scan = TableScanExec(schema=cols + [rid], table=table, stages=stages,
                             prune_bounds=bounds)
        scan.open(self._exec_ctx())
        ids, datas, valids = [], [], []
        try:
            while True:
                ch = scan.next()
                if ch is None:
                    break
                live = ch.sel
                ids.append(ch.col(rid.uid).data[live].cpu().numpy())
                if out_uid is not None:
                    c = ch.col(out_uid)
                    datas.append(c.data[live].cpu().numpy())
                    valids.append(c.valid[live].cpu().numpy())
        finally:
            scan.close()
        ids = (np.concatenate(ids).astype(np.int64)
               if ids else np.zeros(0, dtype=np.int64))
        if out_uid is None:
            return ids
        return ids, np.concatenate(datas), np.concatenate(valids)

    def _rows_matching(self, table, where, table_name: str) -> np.ndarray:
        """Row ids (physical) matching a WHERE clause — shared by
        UPDATE/DELETE. A scan of the columns the predicate reads plus the
        hidden row id, the predicate its filter, its zone-consultable
        bounds pruning whole segments before staging."""
        from tidb_tpu_torch.columnar.zonemap import collect_prune_bounds
        from tidb_tpu_torch.planner.binder import Scope
        from tidb_tpu_torch.planner.rules import fold_constants

        binder, cols, rid = self._scan_cols(table, table_name)
        stages, bounds, refs = [], (), set()
        if where is not None:
            cond = fold_constants(binder.bind_expr(where, Scope(cols, None)))
            stages.append(("filter", cond))
            refs = _column_refs(cond)
            bounds = collect_prune_bounds(
                cond, {c.uid: (c.name, c.type_) for c in cols})
        # the scan's __rowid__ pseudo-column carries each row's TRUE
        # physical id. Reconstructing ids from chunk position is wrong
        # under the columnar store: segment chunks size to the segment
        # (not chunk_capacity) and zone pruning skips ranges.
        return self._drain_rowid_scan(
            table, [c for c in cols if c.uid in refs], rid, stages, bounds)

    def _multi_table_targets(self, stmt) -> List[A.TableName]:
        """All base tables in a multi-table DML's table-refs tree."""
        out = []

        def visit(src):
            if isinstance(src, A.TableName):
                out.append(src)
            elif isinstance(src, A.Join):
                visit(src.left)
                visit(src.right)

        visit(stmt.from_)
        return out

    def _multi_dml_rowids(self, stmt, target: A.TableName,
                          val_asts=()) -> tuple:
        """Run the multi-table DML's join as a real SELECT of the
        target's hidden __rowid__ (+ SET value expressions), dedup by
        rowid keeping the first match (MySQL: a row matching multiple
        times is updated once)."""
        alias = target.alias or target.name
        items = [A.SelectItem(A.EName("__rowid__", qualifier=alias),
                              alias="__rid")]
        for i, v in enumerate(val_asts):
            items.append(A.SelectItem(v, alias=f"__v{i}"))
        sel = A.SelectStmt(items=items, from_=stmt.from_, where=stmt.where)
        rs = self._run_select(sel)
        seen = set()
        ids, vals = [], []
        for row in rs.rows:
            rid = row[0]
            # outer joins NULL-pad the target side; those rows have no
            # target row to touch (MySQL: unmatched rows are untouched)
            if rid is None or rid in seen:
                continue
            seen.add(rid)
            ids.append(rid)
            vals.append(row[1:])
        return np.array(ids, dtype=np.int64), vals

    def _run_update(self, stmt: A.UpdateStmt):
        if stmt.from_ is not None:
            return self._run_update_multi(stmt)
        table = self.catalog.table(stmt.table.schema or self.db, stmt.table.name)

        def do(txn):
            ids = self._rows_matching(table, stmt.where, stmt.table.name)
            if len(ids) == 0:
                return
            from tidb_tpu_torch.planner.binder import Binder

            binder = Binder()
            updates = {}
            gen_cols = {g.col for g in table.generated}
            for name_ast, val_ast in stmt.sets:
                col = table.schema.col(name_ast.name)
                if col.name in gen_cols:
                    raise ExecutionError(
                        f"column {col.name!r} is a generated column: "
                        "its value cannot be set")
                if not _ast_has_name(val_ast):
                    v = self._bind_const(binder, val_ast, col)
                    updates[col.name] = [v] * len(ids)
                else:
                    # expression over current row values: evaluate via scan
                    updates[col.name] = self._eval_update_expr(
                        table, stmt.table.name, val_ast, ids, col)
            table.update_rows(ids, updates, begin_ts=txn.marker,
                              end_ts=txn.marker, marker=txn.marker,
                              log=txn.log_for(table), log_for=txn.log_for)

        return self._run_dml(do)

    def _run_update_multi(self, stmt: A.UpdateStmt):
        """UPDATE t1 JOIN t2 ... SET t1.c = expr [WHERE ...]: the join
        runs as a real SELECT of t1's hidden rowid + the SET values
        (evaluated in full join context — expressions may reference any
        joined table), then the target applies a plain MVCC update."""
        refs = self._multi_table_targets(stmt)
        by_alias = {(t.alias or t.name).lower(): t for t in refs}
        quals = {q.lower() for q, _ in
                 ((n.qualifier, n) for n, _ in stmt.sets) if q}
        if len(quals) > 1:
            raise UnsupportedError(
                "multi-table UPDATE touching several target tables")
        if quals:
            target = by_alias.get(next(iter(quals)))
            if target is None:
                raise PlanError(f"unknown table {next(iter(quals))!r} in SET")
        else:
            # unqualified SET columns: the owning table must be unique
            owners = set()
            for name_ast, _ in stmt.sets:
                for t in refs:
                    tab = self.catalog.table(t.schema or self.db, t.name)
                    if any(c.name == name_ast.name
                           for c in tab.schema.columns):
                        owners.add((t.alias or t.name).lower())
            if len(owners) != 1:
                raise PlanError(
                    "SET columns must name their table in a multi-table "
                    "UPDATE")
            target = by_alias[next(iter(owners))]
        table = self.catalog.table(target.schema or self.db, target.name)

        def do(txn):
            ids, vals = self._multi_dml_rowids(
                stmt, target, [v for _, v in stmt.sets])
            if len(ids) == 0:
                return
            updates = {}
            for j, (name_ast, _) in enumerate(stmt.sets):
                col = table.schema.col(name_ast.name)
                updates[col.name] = [v[j] for v in vals]
            table.update_rows(ids, updates, begin_ts=txn.marker,
                              end_ts=txn.marker, marker=txn.marker,
                              log=txn.log_for(table), log_for=txn.log_for)

        return self._run_dml(do)

    def _eval_update_expr(self, table, table_name, val_ast, ids, col: ColumnInfo):
        """Evaluate a SET expression at physical rows `ids`: one scan of
        the columns it reads projects (row id, value); each id then takes
        the value its own row id carries, so the answer does not depend
        on the order or the chunking the scan staged rows in."""
        import decimal as _dec

        from tidb_tpu_torch.expression.expr import ColumnRef
        from tidb_tpu_torch.planner.binder import Scope
        from tidb_tpu_torch.types import days_to_date, micros_to_datetime

        binder, cols, rid = self._scan_cols(table, table_name)
        bound = binder.bind_expr(val_ast, Scope(cols, None))
        out_uid = "__upd__"
        refs = _column_refs(bound)
        stages = [("project", [(out_uid, bound),
                               (rid.uid, ColumnRef(rid.type_, rid.uid))])]
        rids, data, valid = self._drain_rowid_scan(
            table, [c for c in cols if c.uid in refs], rid, stages,
            out_uid=out_uid)
        order = np.argsort(rids, kind="stable")
        pos = order[np.clip(np.searchsorted(rids[order], ids), 0,
                            max(len(rids) - 1, 0))]
        if len(ids) and (len(rids) == 0 or (rids[pos] != ids).any()):
            raise ExecutionError("UPDATE lost a row between match and evaluation")
        data, valid = data[pos], valid[pos]
        k = col.type_.kind
        if k == TypeKind.STRING:
            # string exprs evaluate to dictionary codes; decode host-side
            # (update_rows re-encodes into the column's own dictionary)
            d = getattr(bound, "_dict", None)
            if d is None:
                raise UnsupportedError(
                    "UPDATE string expression without a dictionary context")
            return d.decode(data, valid)
        out = []
        for d, v in zip(data, valid):
            if not v:
                out.append(None)
            elif k == TypeKind.DATE:
                out.append(days_to_date(int(d)))
            elif k == TypeKind.DATETIME:
                out.append(micros_to_datetime(int(d)))
            elif k == TypeKind.DECIMAL:
                src_scale = bound.type_.scale if bound.type_.kind == TypeKind.DECIMAL else 0
                # exact descale (float division corrupts long decimals)
                out.append(_dec.Decimal(int(d)).scaleb(-src_scale)
                           if src_scale else int(d))
            else:
                out.append(d.item())
        return out

    def _run_delete(self, stmt: A.DeleteStmt):
        if stmt.from_ is not None:
            # DELETE t FROM <refs> / DELETE FROM t USING <refs>: rows to
            # delete come from the join (dedup'd target rowids). The
            # DELETE target names a table OR its alias in the refs.
            refs = self._multi_table_targets(stmt)
            want = (stmt.table.alias or stmt.table.name).lower()
            target = next(
                (t for t in refs
                 if (t.alias or t.name).lower() == want
                 or t.name.lower() == want), None)
            if target is None:
                raise PlanError(
                    f"DELETE target {stmt.table.name!r} is not in the "
                    "table references")
            table = self.catalog.table(target.schema or self.db, target.name)

            def do(txn):
                ids, _ = self._multi_dml_rowids(stmt, target)
                if len(ids):
                    table.delete_rows(ids, end_ts=txn.marker,
                                      marker=txn.marker,
                                      log=txn.log_for(table),
                                      log_for=txn.log_for)

            return self._run_dml(do)

        table = self.catalog.table(stmt.table.schema or self.db, stmt.table.name)

        def do(txn):
            ids = self._rows_matching(table, stmt.where, stmt.table.name)
            table.delete_rows(ids, end_ts=txn.marker, marker=txn.marker,
                              log=txn.log_for(table), log_for=txn.log_for)

        return self._run_dml(do)

    def _run_explain(self, stmt: A.ExplainStmt):
        """EXPLAIN shows the plan (`explain_text`); EXPLAIN ANALYZE runs it
        with every operator instrumented (utils/execdetails.py) and adds
        the statement's resource profile. The reference's SQL bindings
        and privilege checks are not ported: the plan is the unbound one
        and nothing is checked."""
        target = stmt.stmt
        if not isinstance(target, (A.SelectStmt, A.UnionStmt)):
            raise UnsupportedError("EXPLAIN only supports SELECT")
        phys = self._plan_select(target)
        if stmt.analyze:
            from tidb_tpu_torch.columnar.store import COMPACTION_WAIT
            from tidb_tpu_torch.utils import dispatch as _dsp
            from tidb_tpu_torch.utils.execdetails import analyze_text, instrument

            root = build_executor(phys)
            instrument(root)
            # resource profile: deltas of the host-side counters around
            # the execution — no new syncs
            p0 = (_dsp.xfer_bytes(), _dsp.compile_seconds(),
                  _dsp.spill_bytes(), COMPACTION_WAIT["s"])
            run_plan(root, self._exec_ctx(plan=phys))  # execute; rows discarded
            text = analyze_text(root)
            mem_max = max((t.max_consumed for t in self._stmt_trackers),
                          default=0)
            text += ("\nprofile: mem_max=%d xfer_bytes=%d compile_ms=%.1f"
                     " spill_bytes=%d compaction_wait_ms=%.1f"
                     % (mem_max, _dsp.xfer_bytes() - p0[0],
                        (_dsp.compile_seconds() - p0[1]) * 1e3,
                        _dsp.spill_bytes() - p0[2],
                        (COMPACTION_WAIT["s"] - p0[3]) * 1e3))
            return ResultSet(names=["EXPLAIN ANALYZE"],
                             rows=[(line,) for line in text.split("\n")])
        text = explain_text(phys)
        return ResultSet(names=["EXPLAIN"], rows=[(line,) for line in text.split("\n")])

    @staticmethod
    def _like_filter(rows, like: Optional[str], col: int = 0):
        if like is None:
            return rows
        import re

        pat = re.escape(like).replace("%", ".*").replace("_", ".")
        rx = re.compile(f"^{pat}$", re.IGNORECASE)
        return [r for r in rows if rx.match(str(r[col]))]

    def _run_show(self, stmt: A.ShowStmt):
        if stmt.kind in _SHOW_UNPORTED:
            raise UnsupportedError(
                f"SHOW {stmt.kind.upper()} is not yet ported: it waits for "
                f"{_SHOW_UNPORTED[stmt.kind]}")
        if stmt.kind == "warnings":
            return ResultSet(names=["Level", "Code", "Message"],
                             rows=list(self._warnings))
        if stmt.kind == "databases":
            rows = [(n,) for n in sorted(self.catalog.databases)]
            return ResultSet(names=["Database"], rows=self._like_filter(rows, stmt.like))
        if stmt.kind == "tables":
            names = set(self.catalog.tables(self.db))
            names.update(self.catalog.database(self.db).views)
            rows = [(n,) for n in sorted(names)]  # MySQL lists views too
            return ResultSet(names=[f"Tables_in_{self.db}"], rows=self._like_filter(rows, stmt.like))
        if stmt.kind == "columns":
            t = self.catalog.table(self.db, stmt.target)
            rows = [
                (c.name, str(c.type_), "NO" if c.not_null else "YES")
                for c in t.schema.public_columns()
            ]
            return ResultSet(names=["Field", "Type", "Null"], rows=rows)
        if stmt.kind == "index":
            t = self.catalog.table(self.db, stmt.target)
            rows = []
            for idx in t.indexes.values():
                if idx.state != "public":
                    continue  # staged online-DDL index: not visible yet
                for seq, col in enumerate(idx.columns, 1):
                    rows.append((stmt.target, 0 if idx.unique else 1,
                                 idx.name, seq, col))
            return ResultSet(
                names=["Table", "Non_unique", "Key_name", "Seq_in_index",
                       "Column_name"],
                rows=rows)
        if stmt.kind == "create_table":
            t = self.catalog.table(self.db, stmt.target)
            kindmap = {"int": "bigint", "float": "double",
                       "string": "varchar(255)", "bool": "tinyint(1)"}
            lines = []
            for c in t.schema.public_columns():
                ty = c.type_text or kindmap.get(str(c.type_), str(c.type_))
                parts = [f"  `{c.name}` {ty}"]
                if c.type_.is_dict_encoded and c.collation is not None:
                    # a non-default collation round-trips (the default,
                    # utf8mb4_general_ci, is implied like MySQL's)
                    parts.append(f"COLLATE {c.collation}")
                if c.not_null:
                    parts.append("NOT NULL")
                if c.auto_increment:
                    parts.append("AUTO_INCREMENT")
                if c.default is not None:
                    dv = str(c.default).replace("\\", "\\\\")
                    dv = dv.replace("'", "''")
                    parts.append(f"DEFAULT '{dv}'")
                lines.append(" ".join(parts))
            if t.schema.primary_key:
                keys = ", ".join(f"`{k}`" for k in t.schema.primary_key)
                lines.append(f"  PRIMARY KEY ({keys})")
            for name, ix in t.indexes.items():
                if name == "PRIMARY" or ix.state != "public":
                    continue
                keys = ", ".join(f"`{k}`" for k in ix.columns)
                kw = "UNIQUE KEY" if ix.unique else "KEY"
                lines.append(f"  {kw} `{name}` ({keys})")
            for fk in t.foreign_keys:
                cols = ", ".join(f"`{c}`" for c in fk.columns)
                pcols = ", ".join(f"`{c}`" for c in fk.parent_cols)
                line = (f"  FOREIGN KEY ({cols}) REFERENCES "
                        f"`{fk.parent.schema.name}` ({pcols})")
                for clause, act in (("ON DELETE", fk.on_delete),
                                    ("ON UPDATE", fk.on_update)):
                    if act != "restrict":
                        line += f" {clause} {act.replace('_', ' ').upper()}"
                lines.append(line)
            for chk in getattr(t, "checks", ()):
                lines.append(
                    f"  CONSTRAINT `{chk.name}` CHECK ({chk.sql})")
            ddl = (f"CREATE TABLE `{stmt.target}` (\n"
                   + ",\n".join(lines)
                   + f"\n) ENGINE={t.engine}")
            pi = t.schema.partition
            if pi is not None:
                if pi.kind == "hash":
                    ddl += (f"\nPARTITION BY HASH (`{pi.column}`) "
                            f"PARTITIONS {pi.n_parts}")
                else:
                    parts = ", ".join(
                        f"PARTITION `{n}` VALUES LESS THAN "
                        + ("MAXVALUE" if u is None else f"({u})")
                        for n, u in zip(pi.names, pi.uppers))
                    ddl += (f"\nPARTITION BY RANGE (`{pi.column}`) "
                            f"({parts})")
            if t.schema.cluster_by:
                ddl += f"\nCLUSTER BY (`{t.schema.cluster_by}`)"
            return ResultSet(names=["Table", "Create Table"],
                             rows=[(stmt.target, ddl)])
        if stmt.kind == "create_view":
            v = self.catalog.view(self.db, stmt.target)
            if v is None:
                raise SchemaError(f"no view {self.db}.{stmt.target}")
            vcols, _ast, sql = v
            collist = f" ({', '.join(vcols)})" if vcols else ""
            return ResultSet(
                names=["View", "Create View"],
                rows=[(stmt.target,
                       f"CREATE VIEW `{stmt.target}`{collist} AS {sql}")])
        if stmt.kind == "variables":
            from tidb_tpu_torch.session.sysvars import display

            rows = sorted((k, display(v)) for k, v in self.sysvars.all_effective().items())
            return ResultSet(names=["Variable_name", "Value"],
                             rows=self._like_filter(rows, stmt.like))
        raise UnsupportedError(f"SHOW {stmt.kind}")



def _union_arms(u):
    """Leaf SelectStmts of a UnionStmt tree."""
    for side in (u.left, u.right):
        if isinstance(side, A.UnionStmt):
            yield from _union_arms(side)
        else:
            yield side


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


def _value_to_ast(v):
    """Python logical value -> literal AST (SELECT-sourced upserts,
    VALUES() over defaulted columns)."""
    import decimal

    if v is None:
        return A.ENull()
    if isinstance(v, bool):
        return A.EBool(v)
    if isinstance(v, (int, float, decimal.Decimal)):
        return A.ENum(str(v))
    return A.EStr(str(v))


def _sub_values_refs(e, cellmap):
    """ON DUPLICATE KEY UPDATE: VALUES(col) -> that row's insert value."""
    def fn(x):
        if (isinstance(x, A.EFunc) and x.name == "values"
                and len(x.args) == 1 and isinstance(x.args[0], A.EName)):
            n = x.args[0].name
            if n not in cellmap:
                raise PlanError(f"VALUES({n}) refers to a column not inserted")
            return cellmap[n]
        return x

    return _ast_transform(e, fn)


def _ast_has_name(e) -> bool:
    return _ast_contains(e, A.EName)


def _ast_transform(e, fn):
    """Rebuild an AST applying fn to every dataclass node (pre-order);
    fn returning a new node stops recursion into it. Containers (lists,
    tuples, nested lists — e.g. InsertStmt.rows) recurse structurally."""
    def walk(v):
        if hasattr(v, "__dataclass_fields__"):
            return _ast_transform(v, fn)
        if isinstance(v, list):
            return [walk(x) for x in v]
        if isinstance(v, tuple):
            return tuple(walk(x) for x in v)
        return v

    r = fn(e)
    if r is not e:
        return r
    if not hasattr(e, "__dataclass_fields__"):
        return e
    return type(e)(**{f: walk(getattr(e, f)) for f in e.__dataclass_fields__})


def _column_refs(e) -> set:
    """Names of every ColumnRef in a bound expression tree (any node
    type: fields, lists and tuples are walked structurally)."""
    from tidb_tpu_torch.expression.expr import ColumnRef

    out = set()

    def walk(v):
        if isinstance(v, ColumnRef):
            out.add(v.name)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif hasattr(v, "__dataclass_fields__"):
            for f in v.__dataclass_fields__:
                walk(getattr(v, f))

    walk(e)
    return out


def wire_check(t, name: str, e_ast, sql_text: str) -> None:
    """Bind + compile one CHECK constraint at DDL time (MySQL-8 CHECK
    enforcement). Uids are column names, so the stored evaluator is
    schema-stable. Dict-encoded
    string columns are refused: a plan-time LUT would bake in codes
    of the CREATE-time (empty) dictionary and go stale as it
    grows."""
    from tidb_tpu_torch.expression.compiler import compile_expr
    from tidb_tpu_torch.planner.binder import Binder, PlanCol, Scope
    from tidb_tpu_torch.planner.rules import _refs
    from tidb_tpu_torch.storage.table import CheckInfo

    dict_cols = {c.name for c in t.schema.columns
                 if c.type_.is_dict_encoded}
    # refuse string-column checks BEFORE binding: the binder's own
    # dictionary-context errors would otherwise mask this message
    named = {n.name.lower() for n in _ast_names(e_ast)}
    if named & {c.lower() for c in dict_cols}:
        raise UnsupportedError(
            "CHECK constraints over string columns are not supported "
            "(dictionary codes are not stable across inserts)")
    cols = [PlanCol(uid=c.name, name=c.name, type_=c.type_)
            for c in t.schema.columns]
    binder = Binder()
    bound = binder.to_bool(binder.bind_expr(e_ast, Scope(cols, None)))
    refs = sorted(_refs(bound))
    if any(c.name == name for c in t.checks):
        raise SchemaError(
            f"duplicate check constraint name {name!r}")
    t.checks.append(CheckInfo(name=name, pred=compile_expr(bound),
                              cols=refs, sql=sql_text))

def wire_generated(t, colname: str, e_ast, sql_text: str,
                    stored: bool) -> None:
    """Bind + compile one generated column at DDL time (ref: MySQL
    GENERATED ALWAYS AS). Same machinery and restrictions as CHECK
    constraints: uids are column names; string source columns are
    refused (plan-time dictionary LUTs go stale); self-reference and
    reference to other generated columns are refused like MySQL's
    ordering rule (only columns earlier in the row)."""
    from tidb_tpu_torch.expression.compiler import compile_expr
    from tidb_tpu_torch.planner.binder import Binder, PlanCol, Scope
    from tidb_tpu_torch.planner.rules import _refs
    from tidb_tpu_torch.storage.table import GeneratedInfo

    dict_cols = {c.name for c in t.schema.columns
                 if c.type_.is_dict_encoded}
    named = {n.name.lower() for n in _ast_names(e_ast)}
    if named & {c.lower() for c in dict_cols}:
        raise UnsupportedError(
            "generated columns over string columns are not supported "
            "(dictionary codes are not stable across inserts)")
    gen_cols = {g.col.lower() for g in t.generated} | {colname.lower()}
    if named & gen_cols:
        raise UnsupportedError(
            "a generated column cannot reference itself or another "
            "generated column")
    if t.schema.col(colname).type_.is_dict_encoded:
        raise UnsupportedError(
            "string-typed generated columns are not supported "
            "(computed values cannot be dictionary-encoded at "
            "write time)")
    cols = [PlanCol(uid=c.name, name=c.name, type_=c.type_)
            for c in t.schema.columns]
    bound = Binder().bind_expr(e_ast, Scope(cols, None))
    t.generated.append(GeneratedInfo(
        col=colname, fn=compile_expr(bound), cols=sorted(_refs(bound)),
        sql=sql_text, stored=stored))


def _ast_names(e):
    """Every EName in an expression AST (dataclass walk)."""
    import dataclasses as _dc

    out = []
    stack = [e]
    while stack:
        x = stack.pop()
        if isinstance(x, A.EName):
            out.append(x)
        if _dc.is_dataclass(x) and not isinstance(
                x, (A.SelectStmt, A.UnionStmt)):
            for f in _dc.fields(x):
                v = getattr(x, f.name)
                vs = v if isinstance(v, (list, tuple)) else [v]
                for item in vs:
                    if isinstance(item, tuple):
                        stack.extend(item)
                    else:
                        stack.append(item)
    return out
