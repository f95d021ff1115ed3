"""Session: the SQL entry point of the port.

A statement loop of its own over the copied parser and planner: CREATE
TABLE (PRIMARY KEY, UNIQUE KEY, INDEX, FOREIGN KEY, CHECK, generated
columns, PARTITION BY RANGE/HASH, CLUSTER BY and ENGINE=delta included;
TEMPORARY, LIKE and AS SELECT too) / DROP TABLE / CREATE and DROP
DATABASE / USE / TRUNCATE / CREATE and DROP INDEX / ALTER TABLE
(ADD/DROP/MODIFY COLUMN, RENAME, ADD INDEX, ADD/DROP FOREIGN KEY,
ADD/DROP CHECK, CLUSTER BY) and the single-process online-DDL stages
(`apply_ddl_stage`), INSERT (VALUES and SELECT, REPLACE, ON DUPLICATE
KEY UPDATE), UPDATE and DELETE (single- and multi-table), BEGIN / START
TRANSACTION / COMMIT / ROLLBACK, SAVEPOINT / ROLLBACK TO / RELEASE
SAVEPOINT and the `autocommit` sysvar, SET, SELECT (UNION included) and
its locking form (FOR UPDATE / FOR SHARE), CREATE [OR REPLACE] / DROP
VIEW, ANALYZE TABLE, EXPLAIN [ANALYZE] and SHOW, LOAD DATA [LOCAL]
INFILE and SELECT ... INTO OUTFILE, plus `load_tpch`. `self.catalog` is
a `SessionCatalog`: the session's TEMPORARY tables shadow the shared
catalog's by name and vanish with the connection.
Writes run inside a transaction (`TxnState`: an implicit one commits at
statement end) and commit through the two-phase committer
(storage/txn2pc.py); reads inside a transaction see its snapshot and its
own provisional rows (`_exec_ctx`'s `read_ts` and `txn_marker`). A
commit that wrote rows re-analyzes the tables whose modifications crossed
the auto-analyze threshold (`tidb_enable_auto_analyze`,
`tidb_auto_analyze_ratio`), as the reference does.
Statements run on `device`: None means the CUDA card, and a Session
without a card raises instead of carrying on on the CPU.

`Session(mesh=...)` runs reads on a device mesh (parallel/): outside a
transaction, `_build_root` routes every plan through
`build_dist_executor`, whose fragments run one per-shard program over
the mesh's (dcn x shard) grid; the planner sizes plans by the mesh's
part count, and a plan that keeps an eager-aggregation partial off the
mesh is re-planned without it. With a mesh and no `device`, the
session's single-device executors run on the mesh's first device.

Every statement runs inside `_execute_timed`, the reference's statement
envelope: the deadline from `max_execution_time` and the KILL flags
(`cancel_reason`, polled by every executor through `cancel_check`), the
always-on trace, the statements summary, the slow log, the SLO store,
the plugins' audit hooks, the optional `torch.profiler` trace
(`tidb_profile_dir`) and the CLUSTER BY bracket (due permutes run at
quiescent statement boundaries; the statement registers as a lock-free
reader in between). SELECTs plan through the digest-keyed plan cache
(planner/plancache.py); `prepare` / `execute_prepared` serve the binary
protocol, and `batch_probe` / `dml_batch_probe` the serving tier's
micro-batcher. Privileges are checked as the reference checks them
(`root` bypasses); KILL, TRACE, SHOW PROCESSLIST / GRANTS / BINDINGS /
PLUGINS, CREATE / DROP USER, GRANT / REVOKE and INSTALL / UNINSTALL
PLUGIN are the reference's. DDL goes to the elected DDL owner's job
queue when a server runs one (owner/).

Plan feedback (planner/feedback.py): a SELECT parks its executed tree;
the statement envelope harvests est-vs-actual rows into the process
store, whose hints then shape the next planning of the digest (join
cardinalities, the eager-aggregation push-down decision, the fused
probe's tile count, the fused top-k routing). SQL bindings
(CREATE / DROP [GLOBAL] BINDING) inject their hints into a matching
statement; `/*+ MEMORY_QUOTA(...) */` sets the statement's budget.

The runtime invariant sanitizer (analysis/sanitizer.py): under
tidb_tpu_sanitize each statement runs in a scope that checks pin and
tracker balances, the host-sync budget and the lock-order witness at
its end; a fatal finding raises SanitizerError on the success path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from tidb_tpu_torch.analysis import sanitizer as _san
from tidb_tpu_torch.errors import (
    ExecutionError,
    PlanError,
    QueryKilledError,
    QueryTimeoutError,
    SanitizerError,
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
from tidb_tpu_torch.storage.catalog import Catalog, SessionCatalog
from tidb_tpu_torch.storage.table import ColumnInfo, TableSchema
from tidb_tpu_torch.types import TypeKind, parse_type_name
from tidb_tpu_torch.utils.device import resolve_device

__all__ = ["Session", "TxnState", "wire_check", "wire_generated"]


_LOAD_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "0": "\0", "b": "\b",
                 "Z": "\x1a"}


def _split_load_fields(line: str, delim: str, quote):
    """Split one LOAD DATA line into fields with MySQL semantics the csv
    module cannot express: backslash escapes delimiters/specials
    (\\t \\n \\\\, an escaped delimiter stays inside the field), the NULL
    sentinel is the two-character sequence \\N standing ALONE unquoted
    (a quoted "N" or literal N is data), and an optional enclosure char
    with doubled- or backslash-escaped quotes. Returns a list of
    str-or-None. A line with no backslash and no enclosure char splits
    as str.split does, so it takes that path (the same fields, without
    the walk over every character)."""
    if "\\" not in line and (not quote or quote not in line):
        return line.split(delim)
    out = []
    i, n = 0, len(line)
    while True:
        buf = []
        is_null = False
        if quote and i < n and line[i] == quote:
            i += 1
            while i < n:
                c = line[i]
                if c == "\\" and i + 1 < n:
                    nxt = line[i + 1]
                    buf.append(_LOAD_ESCAPES.get(nxt, nxt))
                    i += 2
                    continue
                if c == quote:
                    if i + 1 < n and line[i + 1] == quote:  # doubled
                        buf.append(quote)
                        i += 2
                        continue
                    i += 1
                    break
                buf.append(c)
                i += 1
        else:
            start = i
            while i < n and line[i] != delim:
                c = line[i]
                if c == "\\" and i + 1 < n:
                    nxt = line[i + 1]
                    if (nxt == "N" and i == start
                            and (i + 2 == n or line[i + 2] == delim)):
                        is_null = True
                        i += 2
                        continue
                    # an escaped delimiter is the delimiter, even when
                    # the delimiter char is also an escape-table key
                    buf.append(delim if nxt == delim
                               else _LOAD_ESCAPES.get(nxt, nxt))
                    i += 2
                    continue
                buf.append(c)
                i += 1
        out.append(None if is_null else "".join(buf))
        if i >= n:
            break
        i += 1  # consume the delimiter
    return out


def _nested_into_outfile(node, top) -> bool:
    """INTO OUTFILE anywhere except the top-level SelectStmt (inside a
    UNION arm, derived table, or subquery) is a silent-no-op hazard —
    detect it so execute() can refuse loudly (MySQL errors likewise)."""
    import dataclasses as _dc

    stack = [node]
    seen = set()
    while stack:
        e = stack.pop()
        if id(e) in seen or not _dc.is_dataclass(e):
            continue
        seen.add(id(e))
        if isinstance(e, A.SelectStmt) and e is not top \
                and e.into_outfile is not None:
            return True
        for f in _dc.fields(e):
            v = getattr(e, f.name)
            vs = v if isinstance(v, (list, tuple)) else [v]
            for item in vs:
                if isinstance(item, tuple):
                    stack.extend(item)
                else:
                    stack.append(item)
    return False


def _has_eager_partial(phys) -> bool:
    """Does this physical plan contain an eager-aggregation partial (a
    HashAgg whose outputs carry the rule's derived 'eagg.' uids)?"""
    from tidb_tpu_torch.planner.physical import PHashAgg

    stack = [phys]
    while stack:
        p = stack.pop()
        if isinstance(p, PHashAgg) and any(a.uid.startswith("eagg.") for a in p.aggs):
            return True
        stack.extend(p.children)
    return False


def _dist_engaged(root) -> bool:
    """Did the dist builder place mesh executors (not a full host
    fallback)?"""
    from tidb_tpu_torch.parallel.executor import DIST_EXECUTORS

    stack = [root]
    while stack:
        e = stack.pop()
        if isinstance(e, DIST_EXECUTORS):
            return True
        stack.extend(e.children)
    return False


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
        staging checkpoints backing SAVEPOINT). Delta-engine buffers
        compact first so every pre-savepoint write has a logged range
        a later partial rollback will never touch."""
        for table, _log in list(self.logs.values()):
            _ = table.n  # delta tables compact on this read
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
            _ = table.n  # compact delta buffers so undo sees every row
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
                 chunk_capacity: Optional[int] = None, device=None, mesh=None):
        if device is None and mesh is not None:
            device = mesh.device_of(0)
        self.device = resolve_device(device)
        self.mesh = mesh
        self._shard_cache = None
        if mesh is not None:
            from tidb_tpu_torch.parallel.executor import ShardCache

            self._shard_cache = ShardCache(mesh)
        # per-session overlay: TEMPORARY-table namespace over the shared
        # catalog (unwraps another session's proxy to the common base)
        self.catalog = SessionCatalog(catalog if catalog is not None
                                      else Catalog())
        self.db = db
        self._chunk_capacity = chunk_capacity  # explicit override; else sysvar
        self.sysvars = SysVarStore(self.catalog.global_vars)
        self.user_vars: dict = {}
        # authenticated account for privilege checks (ref: privilege/
        # RequestVerification); in-process sessions default to the
        # bootstrap superuser, the wire server sets this after handshake
        self.user = "root"
        from tidb_tpu_torch.bindinfo import BindHandle

        self._bindings = BindHandle("session")
        # stmt_id -> (ast, n_params, sql, normalized, digest, TemplateInfo)
        self._prepared: dict = {}
        self._stmt_id = 0
        self.txn: Optional[TxnState] = None
        # set while a FOR UPDATE/SHARE read runs: reads latest committed
        # instead of the txn snapshot (MySQL locking reads are current)
        self._lock_read = False
        # processlist registration (ref: server/ connection registry)
        self.conn_id = self.catalog.next_conn_id()
        self.catalog.processes[self.conn_id] = self
        import weakref

        object.__setattr__(self.catalog, "_viewer", weakref.ref(self))
        self._current_sql: Optional[str] = None
        self._current_t0: float = 0.0
        # per-statement diagnostics: the statement's memory trackers
        # (EXPLAIN ANALYZE's mem_max, the summary) and its plan digest
        self._stmt_trackers: list = []
        self._last_plan_digest: Optional[str] = None
        # plan-cache per-statement context: is the current statement a
        # prepared execution (picks the enable sysvar), did its plan
        # come from the cache, and the plan-acquisition wall time
        self._exec_prepared = False
        self._plan_from_cache_stmt = False
        self._stmt_plan_s = 0.0
        # (source, normalized, digest) computed once per statement
        self._stmt_digest_memo = None
        # plan feedback: the executed (phys, root, rows) parked for
        # harvest, the worst est-vs-actual drift of the last statement
        # (slow-log column), and the effective eager-agg setting the plan
        # was acquired with (exploration may differ from the sysvar)
        self._fb_capture = None
        self._fb_worst_drift = (0.0, "")
        self._fb_last_apd = None
        # prepare-time (sql, norm, digest, StmtInfo) for the current
        # prepared execution, and its deferred parameters: a plan-cache
        # hit never materializes the bound AST
        self._ps_ctx = None
        self._ps_params = None
        self._ps_materialized = None
        self._killed = False       # KILL <id>: connection is dead
        self._kill_query = False   # KILL QUERY <id>: one-shot cancel
        # serving-tier seams (serving/): a coalesced batch member runs
        # through _execute_timed with the executor replaced by a runner
        # returning its pre-demuxed result
        self._stmt_runner = None
        # parent for per-statement MemTrackers (the scheduler's
        # session-level tracker, itself a child of the server tracker)
        self._mem_parent = None
        # the trace the scheduler opened for this session's statement,
        # which the connection thread resumes to write the result
        self._served_trace = None
        # statement deadline (monotonic seconds) armed per statement
        # from max_execution_time; None = unbounded
        self._stmt_deadline: Optional[float] = None
        # external cancellation hooks: a DCN worker serving an RPC arms
        # these so a coordinator-sent cancel or the RPC's shipped
        # deadline aborts the local execution at its next chunk boundary
        self._ext_cancel = None            # callable -> truthy to cancel
        self._ext_deadline: Optional[float] = None  # monotonic seconds
        # SHOW WARNINGS' area, reset by every other statement
        self._warnings: list = []

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
        from tidb_tpu_torch.utils.metrics import TXN_TOTAL

        TXN_TOTAL.inc(outcome="commit")
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
        from tidb_tpu_torch.utils.metrics import TXN_TOTAL

        TXN_TOTAL.inc(outcome="rollback")
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
        import time as _time

        from tidb_tpu_torch.utils import metrics as M
        from tidb_tpu_torch.utils import tracing

        # the statement's trace opens before its parse: the scheduler's
        # (queued), else one here that the statement claims
        tr = tracing.current()
        fresh = tr is None
        if fresh:
            tr = tracing.Trace("")
            tracing.push(tr)
        try:
            t0 = _time.perf_counter()
            if tr.claimed:  # a statement run inside another's
                stmts = parse(sql)
            else:
                with tracing.span("session.parse"):
                    stmts = parse(sql)
            M.PARSE_SECONDS.observe(_time.perf_counter() - t0)
            result = None
            for stmt in stmts:
                result = self._execute_timed(stmt, sql)
            return result
        finally:
            if fresh:
                tracing.settle(tr)

    def _execute_timed(self, stmt, sql: str) -> Optional[ResultSet]:
        """Metrics, the statements summary, the slow log, the trace and
        the optional torch.profiler trace around one statement (the
        reference's statement envelope), inside the CLUSTER BY bracket."""
        import contextlib
        import time as _time

        from tidb_tpu_torch.columnar.store import compact_counts as _cmp_counts
        from tidb_tpu_torch.columnar.store import scan_counts as _seg_counts
        from tidb_tpu_torch.utils import dispatch as _dsp
        from tidb_tpu_torch.utils import metrics as M
        from tidb_tpu_torch.utils import tracing

        # a DECIDED txn whose commit crashed mid-secondaries leaves rows
        # invisible behind marker timestamps; readers resolve such locks
        # at the statement boundary (the reader-side resolve-lock flow) —
        # commits run under the catalog lock, so a pending status here
        # always means a crashed txn. Here, not in execute(), so prepared
        # executions get the same guarantee.
        if self.catalog.has_stale_txns():
            self.catalog.resolve_locks()
        if self._killed:
            raise QueryKilledError("connection was killed")
        self._kill_query = False  # a prior KILL QUERY cancels only its query
        # arm the statement deadline: max_execution_time is a per-
        # statement budget in ms (0 = unbounded); monotonic, so wall-
        # clock jumps can neither fire nor defuse it
        met = int(self.sysvars.get("max_execution_time"))
        self._stmt_deadline = (
            _time.monotonic() + met / 1e3) if met > 0 else None
        if not (isinstance(stmt, A.ShowStmt)
                and getattr(stmt, "kind", "") == "warnings"):
            self._warnings.clear()  # MySQL: each statement resets the area
        self._current_sql = sql
        self._current_t0 = _time.time()
        stype = type(stmt).__name__.removesuffix("Stmt").lower()
        self.catalog.plugins.statement_begin(self, sql, stype)
        prof_dir = str(self.sysvars.get("tidb_profile_dir"))
        ctx = (_profiled(prof_dir, self.device, self.conn_id) if prof_dir
               else contextlib.nullcontext())
        self._stmt_trackers = []
        self._last_plan_digest = None
        self._plan_from_cache_stmt = False
        self._stmt_plan_s = 0.0
        self._stmt_digest_memo = None
        # plan feedback: _run_select parks (phys, root, rows) here; the
        # success path below harvests it and drops the reference at
        # statement end (a parked executor tree pins device tensors)
        self._fb_capture = None
        self._fb_worst_drift = (0.0, "")
        self._fb_last_apd = None
        c0 = _dsp.compile_count()
        # per-statement resource profile: this thread's baselines
        prof0 = (_dsp.xfer_bytes(), _dsp.compile_seconds(),
                 _dsp.spill_bytes())
        # always-on tracing: every statement records a span tree; tail
        # rules / head sampling decide at the end whether it is kept. A
        # statement arriving with a trace already installed nests.
        try:
            digest_now = self._stmt_digest(stmt, sql)[1]
        except Exception:  # noqa: BLE001 — diagnostics never fail a stmt
            digest_now = ""
        tr = tracing.current()
        owns_trace = tr is None or not tr.claimed
        if owns_trace:
            # a trace opened ahead of the statement (its queue, lock wait
            # and parse) becomes this statement's
            rate = float(self.sysvars.get("tidb_trace_sample_rate"))
            trace_id = tracing.make_trace_id(digest_now)
            sampled = tracing.head_sampled(rate)
            if tr is None:
                tr = tracing.Trace(trace_id, sampled=sampled)
                tracing.push(tr)
            else:
                tr.claim(trace_id, sampled)
        stmt_span = tracing.begin(f"stmt.{stype}")
        d0 = _dsp.count()
        f0 = _dsp.fragment_count()
        seg0 = _seg_counts()
        cw0 = _cmp_counts()
        # runtime invariant sanitizer: debug-mode statement scope —
        # pin/tracker balances, host-sync budget (dispatch.device_get
        # round trips), lock-order witness — checked at statement end;
        # fatal findings raise a typed SanitizerError on the success path
        _san_scope = None
        _san_findings: list = []
        if bool(self.sysvars.get("tidb_tpu_sanitize")):
            _san.enable()
            _san_scope = _san.statement_begin(sync_budget=int(
                self.sysvars.get("tidb_tpu_sanitize_sync_budget")))
        # CLUSTER BY ordered compaction: due permutes run at statement
        # boundaries ONLY and only while the catalog's reader registry
        # is quiescent; this statement then registers as a lock-free
        # reader so no other thread's boundary can move rows under it
        self.catalog.run_pending_reclusters()
        self.catalog.reader_enter()
        t0 = _time.perf_counter()
        try:
            with ctx:
                runner = self._stmt_runner
                result = (self._execute_stmt(stmt) if runner is None
                          else runner(stmt))
        except Exception as exc:
            dur = _time.perf_counter() - t0
            M.QUERY_TOTAL.inc(type=stype, status="error")
            if isinstance(exc, QueryTimeoutError):
                M.DEADLINE_EXCEEDED_TOTAL.inc()
            with tracing.span("session.finish"):
                detail = self._record_stmt(stmt, sql, stype, dur, d0, None,
                                           seg0=seg0, prof0=prof0, cw0=cw0,
                                           f0=f0, error=True)
                self._slo_observe(dur)
            tracing.annotate(f"error:{type(exc).__name__}: {exc}")
            trace_id = self._finish_trace(tr, stmt_span, owns_trace, dur,
                                          error=exc)
            self._maybe_log_slow(sql, dur, detail, trace_id,
                                 disposition=f"error:{type(exc).__name__}")
            self.catalog.plugins.statement_end(self, sql, stype, dur, exc)
            raise
        finally:
            self.catalog.reader_exit()
            # a permute the statement's own plan_scan queued runs now,
            # at ITS end, with its scans closed
            self.catalog.run_pending_reclusters()
            self._current_sql = None
            self._stmt_deadline = None
            # serving tier: return residual operator consumption to the
            # session/server trackers
            if self._mem_parent is not None:
                for t in self._stmt_trackers:
                    t.detach()
            if _san_scope is not None:
                # after the detach loop so residual witnesses attribute
                # to this statement; fatal findings raise on the
                # success path below (never mask an in-flight error)
                _san_findings = _san.statement_end(_san_scope)
            # BaseException safety net (KeyboardInterrupt & co bypass
            # the except): a trace must never leak onto the thread
            import sys as _sys

            if _sys.exc_info()[0] is not None:
                # failed statements don't harvest: drop the parked
                # executor tree now (the success path consumes it below)
                self._fb_capture = None
            if owns_trace and _sys.exc_info()[0] is not None \
                    and tracing.current() is tr:
                tracing.pop()
        dur = _time.perf_counter() - t0
        M.QUERY_TOTAL.inc(type=stype, status="ok")
        M.QUERY_DURATION.observe(dur, type=stype)
        with tracing.span("session.finish"):
            # plan feedback: fold this execution's est-vs-actual truth into
            # the per-digest store before the summary, slow log and trace
            # run, so they all see the drift it computed
            self._fb_record(dur, result, _dsp.compile_count() - c0)
            detail = self._record_stmt(stmt, sql, stype, dur, d0, result,
                                       seg0=seg0, prof0=prof0, cw0=cw0, f0=f0)
            self._slo_observe(dur)
        trace_id = self._finish_trace(tr, stmt_span, owns_trace, dur)
        self._maybe_log_slow(sql, dur, detail, trace_id)
        # plugin hooks run LAST (mirroring the error path): an audit
        # plugin that raises must not skip trace finalization
        self.catalog.plugins.statement_end(self, sql, stype, dur, None)
        fatal = [f for f in _san_findings if f.fatal]
        if fatal:
            raise SanitizerError(
                "sanitizer: engine invariant broken during this "
                "statement: " + "; ".join(f.render() for f in fatal[:4]))
        return result

    def _fb_enabled(self) -> bool:
        return bool(self.sysvars.get("tidb_tpu_plan_feedback"))

    def _fb_record(self, dur: float, result, recompiles: int) -> None:
        """Plan feedback capture: harvest the executed tree parked by
        _run_select and fold the observation into the process store. Runs
        on the success path only (a partial execution's actuals are not
        the statement's truth) and never fails the statement. When a new
        significant cardinality hint landed, the digest's plan-cache
        entries are evicted so the next planning consults it."""
        cap, self._fb_capture = self._fb_capture, None
        self._fb_worst_drift = (0.0, "")
        if cap is None or not self._fb_enabled():
            return
        try:
            from tidb_tpu_torch.planner import feedback as _fb
            from tidb_tpu_torch.utils import metrics as M
            from tidb_tpu_torch.utils import tracing

            phys, root, n_rows = cap
            memo = self._stmt_digest_memo
            digest = memo[2] if memo is not None else ""
            if not digest:
                return
            warm = self._plan_from_cache_stmt and recompiles == 0
            obs = _fb.harvest(phys, root, n_rows, dur, warm)
            apd = self._fb_last_apd if self._fb_last_apd is not None \
                else self._agg_push_down()
            new_hint = _fb.STORE.record(
                digest, self._last_plan_digest or "", apd, obs,
                capacity=int(
                    self.sysvars.get("tidb_tpu_plan_feedback_capacity")))
            if obs.worst_drift > 1.0:
                self._fb_worst_drift = (obs.worst_drift_ratio,
                                        obs.worst_drift_op)
                tracing.annotate(
                    f"worst_drift:{obs.worst_drift_op} "
                    f"{obs.worst_drift_ratio:.2f}x")
            if obs.worst_drift > 0:
                # only statements with at least one known actual observe:
                # otherwise the 1.0 bucket would conflate "every estimate
                # exact" with "no data"
                M.PLAN_EST_DRIFT.observe(_fb.drift_factor(obs))
            if new_hint:
                pc = getattr(self.catalog, "plan_cache", None)
                if pc is not None:
                    pc.invalidate_digest(digest)
        except Exception:  # noqa: BLE001 — diagnostics never fail a stmt
            pass

    def _slo_observe(self, dur: float) -> None:
        """Fold this statement's wall time into the per-digest SLO
        window (success and error paths alike)."""
        try:
            memo = self._stmt_digest_memo
            if memo is None or not memo[2]:
                return
            from tidb_tpu_torch.serving import slo as _slo

            _slo.STORE.observe(
                memo[2], memo[1], dur,
                target_ms=int(self.sysvars.get("tidb_tpu_slo_target_ms")),
                capacity=int(self.sysvars.get("tidb_tpu_slo_capacity")))
        except Exception:  # noqa: BLE001 — diagnostics never fail a stmt
            pass

    def _maybe_log_slow(self, sql: str, dur: float, detail, trace_id: str,
                        disposition: str = "") -> None:
        """One slow-log decision for both the success and the error path.
        Threshold in ms; 0 logs every statement."""
        from tidb_tpu_torch.utils import metrics as M

        threshold = int(self.sysvars.get("tidb_slow_log_threshold"))
        if dur * 1e3 < threshold:
            return
        M.SLOW_QUERY_TOTAL.inc()
        drift, drift_op = self._fb_worst_drift
        self.catalog.log_slow_query(
            self.db, sql, dur, digest=detail[0],
            plan_digest=self._last_plan_digest or "",
            max_mem=detail[1], dispatches=detail[2],
            segs_scanned=detail[3], segs_pruned=detail[4],
            trace_id=trace_id, disposition=disposition,
            worst_drift=drift, worst_drift_op=drift_op,
            xfer_bytes=detail[5], compile_ms=detail[6],
            spill_bytes=detail[7], compaction_wait_ms=detail[8])

    def _stmt_digest(self, stmt, sql: str):
        """(normalized_text, digest) for this statement, memoized per
        source text: one lex per statement."""
        from tidb_tpu_torch.bindinfo import normalize_sql, sql_digest

        src = getattr(stmt, "_source", None) or sql
        memo = self._stmt_digest_memo
        if memo is not None and memo[0] == src:
            return memo[1], memo[2]
        ps = self._ps_ctx
        if ps is not None and ps[0] == src:
            # prepared execution: prepare-time analysis already lexed
            self._stmt_digest_memo = (src, ps[1], ps[2])
            return ps[1], ps[2]
        if len(src) > 16384:
            # bound the lex: bulk statements digest their raw text
            norm = src[:2048]
            digest = sql_digest(src)
        else:
            norm = normalize_sql(src)
            digest = sql_digest(norm)
        self._stmt_digest_memo = (src, norm, digest)
        return norm, digest

    def _finish_trace(self, tr, stmt_span, owns: bool, dur_s: float,
                      error=None) -> str:
        """Close the statement span; when this statement OWNS the trace,
        apply the tail rules, pop it off the thread and store it if
        kept. Returns the trace_id for the slow-log row."""
        from tidb_tpu_torch.utils import tracing

        try:
            tracing.finish(stmt_span)
            if not owns or tr is None:
                return tr.trace_id if tr is not None else ""
            return tracing.apply_tail_rules(
                tr, dur_s,
                int(self.sysvars.get("tidb_slow_log_threshold")),
                error=error,
                capacity=int(self.sysvars.get("tidb_trace_store_capacity")))
        except Exception:  # noqa: BLE001 — diagnostics never fail a stmt
            return ""

    def _record_stmt(self, stmt, sql: str, stype: str, dur: float,
                     d0: int, result, seg0=(0, 0), prof0=(0, 0.0, 0),
                     cw0=(0.0, 0), f0: int = 0, error: bool = False):
        """Fold one execution into the per-digest statements summary;
        returns (digest, max_mem, dispatches, segs_scanned, segs_pruned,
        xfer_bytes, compile_ms, spill_bytes, compaction_wait_ms) for the
        slow-query log. `dispatches` and `xfer_bytes` are this thread's
        (utils/dispatch.py): a concurrent statement's never count."""
        from tidb_tpu_torch.columnar.store import compact_counts as _cmp_counts
        from tidb_tpu_torch.columnar.store import scan_counts as _seg_counts
        from tidb_tpu_torch.utils import dispatch as _dsp

        try:
            norm, digest = self._stmt_digest(stmt, sql)
            max_mem = max((t.max_consumed for t in self._stmt_trackers),
                          default=0)
            if self._mem_parent is not None:
                for t in self._stmt_trackers:
                    t.detach()  # idempotent; the finally path re-runs it
            self._stmt_trackers = []  # don't pin operator state while idle
            dispatches = _dsp.count() - d0
            fragments = _dsp.fragment_count() - f0
            seg1 = _seg_counts()
            segs_scanned = seg1[0] - seg0[0]
            segs_pruned = seg1[1] - seg0[1]
            xfer = _dsp.xfer_bytes() - prof0[0]
            compile_ms = (_dsp.compile_seconds() - prof0[1]) * 1e3
            spill = _dsp.spill_bytes() - prof0[2]
            compact_ms = (_cmp_counts()[0] - cw0[0]) * 1e3
            if xfer or spill or compile_ms >= 1.0:
                from tidb_tpu_torch.utils import tracing as _tracing

                _tracing.annotate(
                    f"profile: mem_max={max_mem} xfer_bytes={xfer} "
                    f"compile_ms={compile_ms:.1f} spill_bytes={spill}")
            drift, drift_op = self._fb_worst_drift
            self.catalog.stmt_summary.record(
                digest, norm, stype, self._last_plan_digest or "", dur,
                max_mem=max_mem,
                rows_sent=len(result.rows) if result is not None else 0,
                dispatches=dispatches, fragments=fragments, error=error,
                plan_from_cache=self._plan_from_cache_stmt,
                plan_latency_s=self._stmt_plan_s,
                worst_drift=drift, worst_drift_op=drift_op,
                xfer_bytes=xfer, compile_ms=compile_ms, spill_bytes=spill,
                max_stmt_count=int(
                    self.sysvars.get("tidb_stmt_summary_max_stmt_count")))
            return (digest, max_mem, dispatches, segs_scanned, segs_pruned,
                    xfer, compile_ms, spill, compact_ms)
        except Exception:  # noqa: BLE001 — diagnostics must never fail
            return "", 0, 0, 0, 0, 0, 0.0, 0, 0.0

    def query(self, sql: str) -> List[tuple]:
        rs = self.execute(sql)
        if rs is None:
            return []
        return rs.rows

    def cancel_reason(self):
        """Why the in-flight statement should stop, or None: a typed
        exception instance (the executor raises it verbatim), so a KILL
        and a deadline expiry surface as different MySQL errors. Polled
        at every chunk boundary through ExecContext.cancel_check."""
        import time as _time

        if self._killed:
            return QueryKilledError("connection was killed")
        if self._kill_query:
            return QueryKilledError("Query execution was interrupted (KILL)")
        now = None
        for dl in (self._stmt_deadline, self._ext_deadline):
            if dl is not None:
                now = _time.monotonic() if now is None else now
                if now > dl:
                    return QueryTimeoutError(
                        "Query execution was interrupted, maximum "
                        "statement execution time exceeded")
        ext = self._ext_cancel
        if ext is not None and ext():
            return QueryKilledError("Query execution was interrupted (KILL)")
        return None

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

    def _exec_ctx(self, hints=(), plan=None) -> ExecContext:
        from tidb_tpu_torch.utils.memory import MemTracker

        sv = self.sysvars.get
        quota = int(sv("tidb_mem_quota_query"))
        for hname, hargs in hints or ():
            if hname == "memory_quota" and hargs:
                q = _parse_quota(hargs[0])  # MEMORY_QUOTA(bytes | N MB | N GB)
                if q is not None:
                    quota = q  # unparseable hints are ignored, as TiDB warns
        # the statement's memory root: its budget is tidb_mem_quota_query
        # or the statement's MEMORY_QUOTA hint, and spillables (sort and
        # aggregation runs, segment pins) anchor here
        tracker = MemTracker(
            "query", budget=quota,
            # serving tier: chain into the scheduler's session/server
            # trackers so per-session and server-wide quotas see this
            # statement; spill decisions stay anchored HERE (spill_root)
            parent=self._mem_parent,
            spill_enabled=bool(sv("tidb_enable_tmp_storage_on_oom")),
            spill_root=True)
        # the statement may build several contexts (subplans): EXPLAIN
        # ANALYZE reports the max over all of them
        self._stmt_trackers.append(tracker)
        for old in self._stmt_trackers[:-64]:
            old.detach()  # evicted trackers must not pin parent bytes
        del self._stmt_trackers[:-64]  # bound pathological statements
        ctx = ExecContext(
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
            graph_cache_bytes=int(sv("tidb_tpu_graph_cache_bytes")),
            device_cache_bytes=int(sv("tidb_device_cache_bytes")),
            broadcast_rows_limit=int(sv("tidb_broadcast_join_threshold_count")),
            stage_encoded=bool(sv("tidb_tpu_stage_encoded")),
            cancel_check=self.cancel_reason,
        )
        memo = self._stmt_digest_memo
        if memo is not None and memo[2]:
            # the mesh programs of one statement share a memory pool across
            # its executions (parallel/executor._statement_pool)
            ctx.stmt_digest = memo[2]
        if self._fb_enabled():
            # plan feedback consumer: a digest whose fused probes overflowed
            # their first tiles gets its tile batch sized to the observed
            # worst need, so the overflow expands in one call, not several
            memo = self._stmt_digest_memo
            if memo is not None and memo[2]:
                from tidb_tpu_torch.planner import feedback as _fb

                need = _fb.STORE.tile_hint(memo[2])
                if need > ctx.join_tiles:
                    ctx.join_tiles = need
                # fused top-k consumer: a digest whose ORDER BY + LIMIT k
                # overflowed the device state's gate starts classic on its
                # second execution
                if _fb.STORE.topn_overflow(memo[2]):
                    ctx.fused_topn = False
        return ctx

    def _build_root(self, phys):
        """The executor tree for `phys`. An installed executor plugin
        named by tidb_executor_plugin takes over construction (the
        plugin/ extension point)."""
        plug_name = str(self.sysvars.get("tidb_executor_plugin"))
        if plug_name:
            build = self.catalog.plugins.executor_builder(plug_name)
            if build is not None:
                return build(phys, self)
        if self.txn is not None:
            # snapshot reads need per-row visibility masks; the sharded
            # tables hold committed-latest, so a transaction reads locally
            return build_executor(phys)
        if self._shard_cache is not None and self.sysvars.get("tidb_enable_tpu_exec"):
            from tidb_tpu_torch.parallel.executor import build_dist_executor

            return build_dist_executor(phys, self._shard_cache,
                                       full=self._device_engine_auto())
        return build_executor(phys)

    def _device_engine_auto(self) -> bool:
        """Engine routing of a mesh session (the planner's cop-task vs
        root-task choice): full fragments on a card or on more than one
        shard; one CPU shard keeps joins and generic aggregation on the
        single-device executors. 'force' and 'off' pin it."""
        mode = str(self.sysvars.get("tidb_device_engine_mode"))
        if mode == "force":
            return True
        if mode == "off":
            return False
        devs = self.mesh.devices
        return devs[0].type != "cpu" or len(devs) > 1

    def _dist_expected(self) -> bool:
        """Would this session route eligible plans to the mesh? Mirrors
        _build_root: an executor plugin takes over before the dist branch."""
        if str(self.sysvars.get("tidb_executor_plugin")):
            return False
        return (self.txn is None and self._shard_cache is not None
                and bool(self.sysvars.get("tidb_enable_tpu_exec"))
                and self._device_engine_auto())

    def _n_parts(self) -> int:
        return 1 if self.mesh is None else self.mesh.n_parts

    def _agg_push_down(self) -> bool:
        return bool(self.sysvars.get("tidb_opt_agg_push_down"))

    def _execute_subplan(self, logical) -> List[tuple]:
        """Planner callback: run a bound logical subplan to completion."""
        logical = optimize_logical(
            logical,
            cascades=bool(self.sysvars.get("tidb_enable_cascades_planner")),
            agg_push_down=self._agg_push_down())
        phys = lower(logical)
        # plan-time subqueries execute before the statement-level check
        # and fold into literals, so they are checked here
        self._check_plan_privs(phys)
        n_vis = phys.n_visible if isinstance(phys, PProjection) else None
        return run_plan(self._build_root(phys), self._exec_ctx(plan=phys),
                        n_visible=n_vis).rows

    def _plan_select(self, stmt, agg_push_down=None, execute_subplan=None):
        import time as _time

        from tidb_tpu_torch.planner import feedback as _fb
        from tidb_tpu_torch.utils import metrics as M

        t0 = _time.perf_counter()
        # plan feedback: install the recorded-cardinality hints for this
        # one planning call; the estimators consult them thread-locally,
        # so EXPLAIN and TRACE show the plan an execution would get
        with _fb.planning_hints(self._fb_enabled()):
            phys = plan_statement(
                stmt, self.catalog, db=self.db,
                execute_subplan=execute_subplan or self._execute_subplan,
                cascades=bool(self.sysvars.get("tidb_enable_cascades_planner")),
                n_parts=self._n_parts(),
                # columnar knobs for plan-time materialization (CTE reuse
                # segments its result iff enabled)
                session_info={
                    "user": self.user, "conn_id": self.conn_id,
                    "columnar_enable": bool(self.sysvars.get("tidb_tpu_columnar_enable")),
                    "segment_rows": int(self.sysvars.get("tidb_tpu_segment_rows"))},
                agg_push_down=(self._agg_push_down() if agg_push_down is None
                               else agg_push_down),
            )
        M.PLAN_SECONDS.observe(_time.perf_counter() - t0)
        return phys

    def _acquire_plan(self, stmt, agg_push_down=None):
        """Physical plan for a SELECT/UNION, through the digest-keyed
        plan cache when the statement is eligible (ref: planner/core
        plan_cache*). Sets @@last_plan_from_cache and accumulates the
        acquisition wall time for the statements summary.

        Plan feedback: when the session would push eager aggregation
        (sysvar on, no explicit override), the digest's measured
        push-vs-no-push decision can select the no-push variant instead;
        it caches under its own key (the effective setting is part of the
        plan-cache key). A user pin of tidb_opt_agg_push_down = 0 is
        authoritative and never consulted."""
        import time as _time

        t0 = _time.perf_counter()
        try:
            if (agg_push_down is None and self._fb_enabled()
                    and self._agg_push_down()):
                src = getattr(stmt, "_source", None)
                if src and len(src) <= 16384:
                    from tidb_tpu_torch.planner import feedback as _fb

                    try:
                        digest = self._stmt_digest(stmt, src)[1]
                        if _fb.STORE.apd_decision(digest) is False:
                            agg_push_down = False
                    except Exception:  # noqa: BLE001 — feedback is
                        pass           # advisory, never load-bearing
            self._fb_last_apd = (self._agg_push_down()
                                 if agg_push_down is None
                                 else bool(agg_push_down))
            return self._acquire_plan_inner(stmt, agg_push_down)
        finally:
            self._stmt_plan_s += _time.perf_counter() - t0

    def _materialize_stmt(self, stmt):
        """Bind deferred prepared parameters into `stmt` (identity memo:
        a statement may be planned twice)."""
        params = self._ps_params
        if params is None:
            return stmt
        memo = self._ps_materialized
        if memo is not None and memo[0] is stmt:
            return memo[1]
        src = getattr(stmt, "_source", None)
        out = _sub_params(stmt, params)
        if src is not None:
            out._source = src
        self._ps_materialized = (stmt, out)
        return out

    def _acquire_plan_inner(self, stmt, agg_push_down=None):
        from tidb_tpu_torch.planner import plancache as _pc

        self._last_plan_digest = None  # _run_select hashes the fresh
        # plan unless a cache hit installs the entry's memoized digest
        self.sysvars.set("last_plan_from_cache", False, "session")
        enabled = bool(self.sysvars.get(
            "tidb_enable_prepared_plan_cache" if self._exec_prepared
            else "tidb_enable_non_prepared_plan_cache"))
        cache = getattr(self.catalog, "plan_cache", None)
        if not enabled or cache is None:
            return self._plan_select(self._materialize_stmt(stmt),
                                     agg_push_down=agg_push_down)

        def bypass(reason):
            cache.note_bypass(reason)
            return self._plan_select(self._materialize_stmt(stmt),
                                     agg_push_down=agg_push_down)

        if self._lock_read:
            return bypass("locking read")
        if getattr(stmt, "into_outfile", None) is not None:
            return bypass("INTO OUTFILE")
        # only parser-produced statements carry _source; synthetic ASTs
        # (DML subselects, locking-read shadow scans) must never share a
        # digest with the statement that spawned them
        src = getattr(stmt, "_source", None)
        if not src or len(src) > 16384:
            return bypass("no normalizable source")
        ps = self._ps_ctx
        if ps is not None and ps[0] == src:
            _, norm, digest, info = ps  # prepare-time analysis
        else:
            try:
                info = _pc.analyze_statement(stmt)
            except Exception:  # noqa: BLE001 — analysis is best-effort
                return bypass("analysis failed")
            memo = self._stmt_digest_memo
            if memo is not None and memo[0] == src:
                _src, norm, digest = memo  # statement start already lexed
            else:
                from tidb_tpu_torch.bindinfo import normalize_sql, sql_digest

                norm = normalize_sql(src)
                digest = sql_digest(norm)
        if info.volatile:
            return bypass(f"volatile builtin {info.volatile}()")
        if info.unsafe:
            # a literal inside a foldable expression (abs(?), ?+1, ...)
            # can bake a derived value the patcher would overwrite with
            # the raw parameter — refuse the whole statement
            return bypass("literal in foldable expression context")
        self._stmt_digest_memo = (src, norm, digest)
        eff_apd = (self._agg_push_down() if agg_push_down is None
                   else agg_push_down)
        key = self._plan_cache_key(stmt, info, digest, eff_apd)
        sv = self.catalog.schema_version
        cap = int(self.sysvars.get("tidb_prepared_plan_cache_size"))
        entry = cache.lookup(key, sv, cap)
        if entry is not None and entry.patches is None:
            return bypass(entry.reason or "known uncacheable")
        if entry is not None and entry.n_params == len(info.params):
            try:
                phys = _pc.instantiate(entry, info.params)
            except Exception:  # noqa: BLE001 — fall back to planning
                phys = None
            if phys is not None:
                cache.note_hit(entry)
                self.sysvars.set("last_plan_from_cache", True, "session")
                self._plan_from_cache_stmt = True
                if not entry.plan_digest:
                    import hashlib as _hl

                    entry.plan_digest = _hl.sha256(
                        explain_text(entry.phys).encode()).hexdigest()[:32]
                self._last_plan_digest = entry.plan_digest
                if self._n_parts() > 1:
                    from tidb_tpu_torch.planner.optimizer import _annotate_topn

                    _annotate_topn(phys)  # re-derive on the patched tree
                return phys
        cache.note_miss()
        used = [False]

        def _sub(logical):
            used[0] = True
            return self._execute_subplan(logical)

        stmt = self._materialize_stmt(stmt)
        phys = self._plan_select(stmt, agg_push_down=agg_push_down,
                                 execute_subplan=_sub)
        try:
            new = _pc.build_entry(
                stmt, phys, info, digest, self.db, sv,
                plan_sentinel=lambda s2: self._plan_select(
                    s2, agg_push_down=agg_push_down, execute_subplan=_sub),
                subplan_used=lambda: used[0])
            cache.store(key, new, sv)
        except Exception:  # noqa: BLE001 — the cache must never fail
            pass          # (or slow-path-block) the statement
        return phys

    def _plan_cache_key(self, stmt, info, digest, eff_apd):
        """THE plan-cache key — shared by the probe/fill path above and
        the serving tier's coalescing probe (batch_probe), so two
        statements coalesce exactly when they would share a cache entry
        (same digest, db, param-type fingerprint, structural constants,
        hints, planner sysvars, mesh width, binding versions)."""
        hints_fp = tuple((h, tuple(str(a) for a in args))
                         for h, args in getattr(stmt, "hints", ()) or ())
        return (
            digest, self.db, info.kinds, info.struct, hints_fp,
            bool(self.sysvars.get("tidb_enable_cascades_planner")),
            bool(eff_apd), self._n_parts(),
            self._bindings.version, self.catalog.bind_handle.version,
            # TEMPORARY tables shadow names without a schema_version
            # bump: a session holding any gets private entries, re-keyed
            # by the temp epoch so drop+recreate can never serve the old
            # table object's plan
            ((self.conn_id, getattr(self.catalog, "_temp_epoch", 0))
             if getattr(self.catalog, "_temp", None) else 0),
        )

    def batch_probe(self, stmt_id: int, params: list):
        """Serving-tier coalescing probe (serving/batcher.py): decide
        WITHOUT executing whether this prepared execution would be a
        plan-cache hit on a batchable plan. Returns (key, entry, info)
        when every safety gate passes, else None (the statement then runs
        the full singleton path)."""
        ent = self._prepared.get(stmt_id)
        if ent is None:
            return None  # execute_prepared raises the real error
        stmt, n_params, sql, norm, digest, tinfo = ent
        if (tinfo is None or digest is None or len(params) != n_params
                or not isinstance(stmt, A.SelectStmt)
                or getattr(stmt, "lock_mode", None) is not None
                or getattr(stmt, "into_outfile", None) is not None):
            return None
        # session-state gates: txn snapshots, kill flags, mesh routing,
        # plugins and plan bindings all change execution
        if (self.txn is not None or self._killed or self._kill_query
                or self._lock_read
                or not self.sysvars.get("autocommit")
                or self._shard_cache is not None
                or str(self.sysvars.get("tidb_executor_plugin"))
                or len(self._bindings) or len(self.catalog.bind_handle)
                or not self.sysvars.get("tidb_enable_prepared_plan_cache")):
            return None
        cache = getattr(self.catalog, "plan_cache", None)
        if cache is None:
            return None
        from tidb_tpu_torch.planner import plancache as _pc

        info = _pc.bind_template_params(tinfo, params)
        if info is None or info.volatile or info.unsafe:
            return None
        key = self._plan_cache_key(stmt, info, digest, self._agg_push_down())
        entry = cache.lookup(
            key, self.catalog.schema_version,
            int(self.sysvars.get("tidb_prepared_plan_cache_size")))
        if (entry is None or entry.patches is None
                or entry.n_params != len(info.params)):
            return None
        if _pc.batchable_plan(entry):
            return None  # non-empty string = the blocking reason
        return key, entry, info

    _DML_HEADS = ("insert", "update", "delete")

    def dml_batch_probe(self, sql: str):
        """Group-commit coalescing probe (the write-path sibling of
        batch_probe): decide WITHOUT executing whether this autocommit
        text-protocol write can join a gathered DML window. Returns
        (key, spec) when every gate passes, else None."""
        head = sql.lstrip()[:6].lower()
        if head not in self._DML_HEADS:
            return None
        if (self.txn is not None or self._killed or self._kill_query
                or not self.sysvars.get("autocommit")
                or self._shard_cache is not None
                or str(self.sysvars.get("tidb_executor_plugin"))):
            return None
        if getattr(self.catalog, "_temp", None):
            # a TEMPORARY namespace is session-local; the batcher's
            # writer session could resolve the wrong table
            return None
        try:
            stmts = parse(sql)
        except Exception:  # noqa: BLE001 — singleton raises the parse error
            return None
        if len(stmts) != 1:
            return None
        stmt = stmts[0]
        from tidb_tpu_torch.planner import plancache as _pc

        reason, parts = _pc.classify_dml(stmt)
        if reason:
            return None
        kind = parts["kind"]
        # the singleton dispatch's privilege gate, probed up front: a
        # denial falls back to singleton execution, which raises it
        self._priv_table(kind, stmt.table)
        db = stmt.table.schema or self.db
        try:
            table = self.catalog.table(db, stmt.table.name)
            spec = self._dml_spec(kind, stmt, db, table, parts)
        except Exception:  # noqa: BLE001 — any refusal -> singleton
            return None
        if spec is None:
            return None
        from tidb_tpu_torch.bindinfo import normalize_sql, sql_digest

        digest = sql_digest(normalize_sql(sql))
        # schema_version pins the spec's bindings: a DDL between probe
        # and execution splits groups, and the batcher re-checks the
        # version at apply time under the catalog lock
        key = (digest, "dml", db, kind, self.catalog.schema_version)
        return key, spec

    def _dml_spec(self, kind, stmt, db, table, parts):
        """Schema-dependent half of the group-commit classifier: bind
        the statement's literals and resolve its point-access index.
        None = not coalescible."""
        from tidb_tpu_torch.planner.binder import Binder

        binder = Binder()
        gen_cols = {g.col for g in table.generated}
        spec = {"kind": kind, "db": db, "table": stmt.table.name}
        if kind == "insert":
            if stmt.columns and gen_cols & set(stmt.columns):
                return None  # singleton raises the generated-column error
            names = stmt.columns or table.insertable_names()
            rows = []
            for r_ast in stmt.rows:
                if len(r_ast) != len(names):
                    return None  # singleton raises the count mismatch
                rows.append([self._bind_const(binder, cell,
                                              table.schema.col(cname))
                             for cell, cname in zip(r_ast, names)])
            spec["columns"] = stmt.columns
            spec["rows"] = rows
            return spec
        where_col, lit_ast = parts["where"]
        col = table.schema.col(where_col)
        if col.type_.is_dict_encoded:
            # a string key's encoding can shift when the dictionary
            # grows between probe and apply; ints/dates are stable
            return None
        idx = next((ix for ix in table.indexes.values()
                    if ix.unique and ix.columns == [where_col]), None)
        if idx is None:
            return None  # no O(log n) point access; singleton scans
        v = self._bind_const(binder, lit_ast, col)
        if v is None:
            return None  # WHERE col = NULL matches nothing (MySQL)
        key_vals = table.encode_index_key(idx, {where_col: v})
        if key_vals is None:
            return None
        spec["index"] = idx.name
        spec["key"] = key_vals
        if kind == "delete":
            return spec
        indexed = {c for ix in table.indexes.values() for c in ix.columns}
        sets = []
        for set_col, how in parts["sets"]:
            tc = table.schema.col(set_col)
            if tc.name in gen_cols:
                return None  # singleton raises the generated-column error
            if tc.name in indexed:
                # a SET over an indexed column could redirect ANOTHER
                # member's point probe mid-window
                return None
            if how[0] == "const":
                sets.append((tc.name, "const",
                             self._bind_const(binder, how[1], tc)))
                continue
            _tag, src, op, delta_ast, _swap = how
            sc = table.schema.col(src)
            if sc.type_.is_dict_encoded or sc.type_.kind not in (
                    TypeKind.INT, TypeKind.FLOAT):
                return None  # host-side ± only over plain numerics
            if tc.type_.is_dict_encoded or tc.type_.kind not in (
                    TypeKind.INT, TypeKind.FLOAT):
                return None
            delta = self._bind_const(binder, delta_ast, sc)
            if delta is None:
                return None  # col ± NULL is NULL; keep the host eval dumb
            sets.append((tc.name, "delta", (src, op, delta)))
        spec["sets"] = sets
        return spec

    def _apply_binding(self, stmt):
        """Plan-binding lookup (ref: bindinfo BindHandle): on a match of
        the statement's normalized source, plan the bound (hinted)
        statement instead. Session bindings shadow global ones."""
        if not len(self._bindings) and not len(self.catalog.bind_handle):
            return stmt
        source = getattr(stmt, "_source", None)
        if not source:
            return stmt
        from tidb_tpu_torch.bindinfo import normalize_sql

        norm = normalize_sql(source)
        b = self._bindings.match(norm) or self.catalog.bind_handle.match(norm)
        if b is None:
            return stmt
        # inject the binding's hints into the user's statement, never the
        # bound statement itself, whose literals are the ones CREATE
        # BINDING happened to carry. Copy instead of mutating: a cached
        # prepared-statement AST must not keep the hints after the binding
        # is dropped.
        if (isinstance(stmt, A.SelectStmt) and isinstance(b.stmt, A.SelectStmt)
                and b.stmt.hints):
            out = dataclasses.replace(stmt, hints=list(b.stmt.hints))
            out._source = source  # replace() drops parser attrs; the plan
            # cache keys on (digest, hints, binding versions), so a hinted
            # copy is still safely distinguishable
            return out
        return stmt

    def _targets_temp_table(self, stmt) -> bool:
        """True when a DDL statement targets a table shadowed by this
        session's TEMPORARY namespace — such DDL must run inline (the
        DDL owner's session cannot see session-local tables)."""
        temp = getattr(self.catalog, "_temp", {})
        if not temp:
            return False
        names = []
        if isinstance(stmt, A.DropTableStmt):
            names = [(t.schema or self.db, t.name) for t in stmt.tables]
        elif isinstance(stmt, (A.TruncateStmt, A.AlterTableStmt)):
            tn = stmt.table
            names = [(tn.schema or self.db, tn.name)]
        elif isinstance(stmt, (A.CreateIndexStmt, A.DropIndexStmt)):
            tn = stmt.table
            names = [(tn.schema or self.db, tn.name)]
        elif isinstance(stmt, A.CreateTableStmt):
            # LIKE / AS SELECT reading a temp-shadowed SOURCE must also
            # stay inline: the DDL owner's session resolves the
            # permanent table instead
            if stmt.like is not None:
                tn = stmt.like
                names.append((tn.schema or self.db, tn.name))
            sel = getattr(stmt, "as_select", None)
            if sel is not None:
                def walk_sources(node):
                    if isinstance(node, A.TableName):
                        names.append((node.schema or self.db, node.name))
                    elif isinstance(node, A.Join):
                        walk_sources(node.left)
                        walk_sources(node.right)
                    elif isinstance(node, A.SubqueryTable):
                        walk_select(node.select)

                def walk_select(st):
                    for arm in ([st] if isinstance(st, A.SelectStmt)
                                else list(_union_arms(st))):
                        if arm.from_ is not None:
                            walk_sources(arm.from_)

                walk_select(sel)
        return any(k in temp for k in names)

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
        from tidb_tpu_torch.utils import tracing
        from tidb_tpu_torch.utils.execdetails import time_operators

        if self.txn is None and not self.sysvars.get("autocommit"):
            self._begin()  # consistent-snapshot reads without autocommit
        with tracing.span("session.plan"):
            phys = self._acquire_plan(stmt)
            self._check_plan_privs(phys)
            root = self._build_root(phys)
            if self._dist_expected() and _has_eager_partial(phys) \
                    and not _dist_engaged(root):
                # the eager-aggregation shape kept this plan off the mesh
                # (the fragment tier takes scan-rooted generic partials,
                # not every shape): losing the fragments costs more than
                # the rewrite saves, so re-plan without it (the no-push
                # variant caches under its own key)
                phys = self._acquire_plan(stmt, agg_push_down=False)
                root = self._build_root(phys)
        # plan digest: hash of the plan's shape (explain text), paired
        # with the statement digest in the summary and the slow log; a
        # cache hit already set the entry's memoized digest
        if self._last_plan_digest is None:
            import hashlib as _hl

            self._last_plan_digest = _hl.sha256(
                explain_text(phys).encode()).hexdigest()[:32]
        n_vis = phys.n_visible if isinstance(phys, PProjection) else None
        if n_vis is None and hasattr(phys, "children") and phys.children:
            # Sort/Limit on top of the projection keep hidden sort columns
            c = phys
            while c.children and not isinstance(c, PProjection):
                c = c.children[0]
            if isinstance(c, PProjection) and c.n_visible is not None and c.n_visible < len(phys.schema):
                n_vis = c.n_visible
        with tracing.span("session.execute") as exec_span:
            if exec_span is not None:
                time_operators(root)
            rs = run_plan(root,
                          self._exec_ctx(hints=getattr(stmt, "hints", ()),
                                         plan=phys),
                          n_visible=n_vis)
        if exec_span is not None:
            self._graft_operator_spans(tracing.current(), exec_span, root)
        if self._fb_enabled():
            # park the executed tree for the statement-end feedback
            # harvest; _execute_timed drops the reference either way
            self._fb_capture = (phys, root, len(rs.rows))
        return rs

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

    def kill(self, stmt) -> None:
        """KILL [QUERY|CONNECTION] <id>: QUERY cancels the victim's
        in-flight statement at its next chunk boundary; CONNECTION also
        fails every later statement. It only sets the victim's flags:
        no statement envelope (resolve-locks, recluster), so the server's
        connection thread may call it without the catalog lock, while a
        commit of the victim's or another's is in flight."""
        if self._killed:
            raise QueryKilledError("connection was killed")
        victim = self.catalog.processes.get(stmt.conn_id)
        if victim is None:
            # existence BEFORE privilege (MySQL): a nonexistent id is
            # "Unknown thread id" for every user
            raise ExecutionError(f"Unknown thread id: {stmt.conn_id}")
        if self.user != "root" and victim.user != self.user:
            self._priv("super")  # only SUPER kills others
        if stmt.query_only:
            victim._kill_query = True
        else:
            victim._killed = True

    def _priv(self, priv: str, db: str = "*", table: str = "*") -> None:
        self.catalog.privileges.require(self.user, priv, db, table)

    def _priv_table(self, priv: str, tn) -> None:
        self._priv(priv, tn.schema or self.db, tn.name)

    def _check_plan_privs(self, phys) -> None:
        """SELECT privilege on every base table the plan scans (views
        are expanded at bind time, so their underlying tables are what
        gets checked)."""
        from tidb_tpu_torch.planner.physical import PScan

        stack = [phys]
        while stack:
            node = stack.pop()
            if isinstance(node, PScan) and node.table is not None:
                if getattr(node.table, "_anonymous", False):
                    # plan-time temp (materialized CTE): its body was
                    # privilege-checked when the subplan executed
                    stack.extend(getattr(node, "children", ()))
                    continue
                db = getattr(node, "db", None) or self.db
                if db.lower() != "information_schema":  # world-readable
                    self._priv("select", db, node.table_name)
            stack.extend(getattr(node, "children", ()))

    _DDL_PRIV = {
        A.CreateTableStmt: "create", A.CreateDatabaseStmt: "create",
        A.CreateIndexStmt: "index", A.DropIndexStmt: "index",
        A.DropTableStmt: "drop", A.DropDatabaseStmt: "drop",
        A.TruncateStmt: "drop", A.AlterTableStmt: "alter",
    }

    def _check_ddl_privs(self, stmt) -> None:
        priv = self._DDL_PRIV[type(stmt)]
        if isinstance(stmt, A.DropTableStmt):
            for tn in stmt.tables:
                self._priv_table(priv, tn)
            return
        if isinstance(stmt, (A.CreateDatabaseStmt, A.DropDatabaseStmt)):
            self._priv(priv, stmt.name)
            return
        self._priv_table(priv, stmt.table)

    def _execute_stmt(self, stmt) -> Optional[ResultSet]:
        # textual fast path for the per-statement AST sweep: the parser
        # makes EVar nodes only from a literal '@', so sources without
        # one skip the walk (the OLTP hot path runs this per statement)
        src_txt = getattr(stmt, "_source", None)
        if (not isinstance(stmt, A.SetStmt)
                and (src_txt is None or "@" in src_txt)
                and _ast_contains(stmt, A.EVar)):
            stmt = self._sub_vars(stmt)
            if src_txt is not None:
                stmt._source = src_txt  # the rebuild drops parser attrs
        if isinstance(stmt, (A.SelectStmt, A.UnionStmt)):
            into = getattr(stmt, "into_outfile", None)
            if ((src_txt is None or "outfile" in src_txt.lower())
                    and _nested_into_outfile(stmt, top=stmt)):
                raise UnsupportedError(
                    "INTO OUTFILE is only supported on a top-level SELECT")
            if into is not None:
                self._precheck_outfile(into)  # fail BEFORE the query runs
            if isinstance(stmt, A.UnionStmt) and any(
                    getattr(arm, "lock_mode", None)
                    for arm in _union_arms(stmt)):
                # MySQL rejects FOR UPDATE on union arms too
                raise UnsupportedError("FOR UPDATE is not allowed with UNION")
            if getattr(stmt, "lock_mode", None) is not None:
                rs = self._run_locking_select(self._apply_binding(stmt))
            else:
                rs = self._run_select(self._apply_binding(stmt))
            if into is not None:
                return self._write_outfile(rs, into)
            return rs
        if isinstance(stmt, A.CreateBindingStmt):
            from tidb_tpu_torch.bindinfo import normalize_sql

            if normalize_sql(stmt.target_sql) != normalize_sql(stmt.using_sql):
                raise PlanError(
                    "binding statements differ after normalization")
            handle = (self.catalog.bind_handle if stmt.scope == "global"
                      else self._bindings)
            handle.create(stmt.target_sql, stmt.using_sql)
            return None
        if isinstance(stmt, A.DropBindingStmt):
            handle = (self.catalog.bind_handle if stmt.scope == "global"
                      else self._bindings)
            if not handle.drop(stmt.target_sql):
                raise ExecutionError("no such binding")
            return None
        if isinstance(stmt, A.InsertStmt):
            self._priv_table("insert", stmt.table)
        elif isinstance(stmt, A.UpdateStmt):
            if stmt.from_ is None:
                self._priv_table("update", stmt.table)
        elif isinstance(stmt, A.DeleteStmt):
            if stmt.from_ is None:
                self._priv_table("delete", stmt.table)
        if isinstance(stmt, tuple(self._DDL_PRIV)):
            self._check_ddl_privs(stmt)
            self._commit()  # DDL implicitly commits the open txn (MySQL)
            # a server's elected DDL owner runs queued DDL for every
            # connection (ref: ddl job queue + owner election); inline
            # otherwise (embedded use / the worker's own session)
            if (self.catalog.ddl_workers
                    and not getattr(self, "_ddl_direct", False)
                    and not getattr(stmt, "temporary", False)
                    and not self._targets_temp_table(stmt)):
                # TEMPORARY tables are session-local: routing them to the
                # DDL owner would create them in the WORKER's namespace
                source = getattr(stmt, "_source", None)
                if source:
                    job = self.catalog.submit_ddl(source, self.db)
                    # no arbitrary deadline: abandoning a RUNNING job
                    # would release the statement lock while its worker
                    # still mutates the catalog; fail fast only when no
                    # worker remains to ever run it
                    while not job.done.wait(timeout=1):
                        if not self.catalog.ddl_workers:
                            self.catalog.drain_ddl_jobs("DDL owner shut down")
                    if job.error is not None:
                        raise job.error
                    return None
        if isinstance(stmt, A.ExplainStmt):
            return self._run_explain(stmt)
        if isinstance(stmt, A.TraceStmt):
            return self._run_trace(stmt)
        if isinstance(stmt, A.KillStmt):
            self.kill(stmt)
            return None
        if isinstance(stmt, A.InstallPluginStmt):
            self._priv("super")  # SQL-reachable module import is admin-only
            self.catalog.plugins.load_module(stmt.name, stmt.module)
            return None
        if isinstance(stmt, A.UninstallPluginStmt):
            self._priv("super")
            self.catalog.plugins.uninstall(stmt.name)
            return None
        if isinstance(stmt, A.CreateUserStmt):
            self._priv("super")
            self.catalog.create_user(stmt.user, stmt.password, stmt.if_not_exists)
            return None
        if isinstance(stmt, A.DropUserStmt):
            self._priv("super")
            self.catalog.drop_user(stmt.user, stmt.if_exists)
            self.catalog.privileges.drop_user(stmt.user)
            return None
        if isinstance(stmt, (A.GrantStmt, A.RevokeStmt)):
            self._priv("super")
            if stmt.user not in self.catalog.users:
                raise ExecutionError(f"no user {stmt.user!r}")
            db = stmt.db if stmt.db is not None else self.db
            if isinstance(stmt, A.GrantStmt):
                self.catalog.privileges.grant(stmt.user, stmt.privs, db, stmt.table)
            else:
                self.catalog.privileges.revoke(stmt.user, stmt.privs, db, stmt.table)
            return None
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
            self._priv("create", stmt.schema or self.db)
            self._commit()  # DDL semantics
            self.catalog.create_view(
                stmt.schema or self.db, stmt.name, stmt.columns,
                stmt.select, stmt.select_sql, stmt.or_replace)
            return None
        if isinstance(stmt, A.DropViewStmt):
            for t in stmt.names:
                self._priv("drop", t.schema or self.db, t.name)
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
        if isinstance(stmt, A.DropDatabaseStmt):
            self.catalog.drop_database(stmt.name, stmt.if_exists)
            return None
        if isinstance(stmt, A.LoadDataStmt):
            return self._run_load_data(stmt)
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
                    if scope == "global":
                        self._priv("super")  # ref: SUPER for global sysvars
                    self.sysvars.set(name, v, scope or "session")
                    # MySQL: enabling autocommit commits the open txn
                    if (name.lower() == "autocommit" and scope != "global"
                            and self.sysvars.get("autocommit")):
                        self._commit()
            return None
        raise UnsupportedError(f"statement {type(stmt).__name__} is not yet ported")

    # -- prepared statements (ref: server/conn_stmt.go + planner plan
    # cache; the binary protocol's COM_STMT_* commands drive these) -------

    def prepare(self, sql: str) -> tuple:
        """Parse once, count placeholders. Returns (stmt_id, n_params)."""
        import time as _time

        from tidb_tpu_torch.utils import metrics as M

        t0 = _time.perf_counter()
        stmts = parse(sql)
        M.PARSE_SECONDS.observe(_time.perf_counter() - t0)
        if len(stmts) != 1:
            raise UnsupportedError("PREPARE requires exactly one statement")
        stmt = stmts[0]
        n_params = _count_params(stmt)
        # prepare-time plan-cache context: the normalized digest and the
        # template's literal-slot analysis are value-independent, so the
        # per-execution hot path never re-lexes or re-walks the AST
        from tidb_tpu_torch.bindinfo import normalize_sql, sql_digest
        from tidb_tpu_torch.planner import plancache as _pc

        try:
            norm = normalize_sql(sql) if len(sql) <= 16384 else None
            digest = sql_digest(norm) if norm is not None else None
            tinfo = _pc.analyze_template(stmt)
        except Exception:  # noqa: BLE001 — fall back to per-exec analysis
            norm = digest = tinfo = None
        self._stmt_id += 1
        self._prepared[self._stmt_id] = (stmt, n_params, sql, norm, digest,
                                         tinfo)
        return self._stmt_id, n_params

    def execute_prepared(self, stmt_id: int, params: list) -> Optional[ResultSet]:
        ent = self._prepared.get(stmt_id)
        if ent is None:
            raise ExecutionError(f"unknown prepared statement {stmt_id}")
        stmt, n_params, sql, norm, digest, tinfo = ent
        if len(params) != n_params:
            raise ExecutionError(
                f"prepared statement takes {n_params} params, got {len(params)}")
        info = None
        if tinfo is not None and digest is not None:
            from tidb_tpu_torch.planner import plancache as _pc

            info = _pc.bind_template_params(tinfo, params)
        # defer parameter substitution for plain SELECT/UNION templates:
        # a plan-cache hit executes without the bound AST, and every
        # planning path materializes it via _materialize_stmt. Locking
        # reads and DML consume literals outside the planner, so they
        # always bind eagerly.
        defer = (info is not None and n_params
                 and isinstance(stmt, (A.SelectStmt, A.UnionStmt))
                 and getattr(stmt, "lock_mode", None) is None
                 and getattr(stmt, "into_outfile", None) is None
                 and not (isinstance(stmt, A.UnionStmt) and any(
                     getattr(arm, "lock_mode", None)
                     for arm in _union_arms(stmt))))
        if n_params and not defer:
            stmt = _sub_params(stmt, params)
            # the rebuilt AST loses the parser's _source attr; restore
            # it — the plan cache and statements summary digest it
            stmt._source = sql
        # through the timed path: prepared executions get the same
        # metrics / slow log / trace / profiler hooks as text queries
        self._exec_prepared = True
        if info is not None:
            self._ps_ctx = (sql, norm, digest, info)
        if defer:
            self._ps_params = params
        try:
            return self._execute_timed(stmt, sql)
        finally:
            self._exec_prepared = False
            self._ps_ctx = None
            self._ps_params = None
            self._ps_materialized = None

    def close_prepared(self, stmt_id: int) -> None:
        self._prepared.pop(stmt_id, None)

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
        elif stmt.action == "reshard":
            # new placement metadata; version bump invalidates placement
            # snapshots, schema_version bump (below) invalidates cached
            # plans — an in-flight statement demotes via the existing
            # catalog-lock revalidation instead of serving a stale map
            old = t.schema.shard_by
            info = self._shard_by_info(stmt.shard, t.schema.columns)
            info.version = (old.version + 1) if old is not None else 1
            t.schema.shard_by = info
        else:
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

    @staticmethod
    def _shard_by_info(spec, cols):
        """Validate a parsed SHARD BY spec against the column list and
        build the persisted ShardByInfo (None passes through)."""
        if spec is None:
            return None
        from tidb_tpu_torch.storage.table import ShardByInfo

        kind, scol, arg = spec
        info = next((c for c in cols if c.name == scol), None)
        if info is None:
            raise SchemaError(f"unknown shard column {scol!r}")
        if info.type_.kind != TypeKind.INT:
            raise SchemaError(
                f"shard column {scol!r} must be integer-typed")
        if kind == "range":
            return ShardByInfo(kind="range", column=scol,
                               shards=len(arg) + 1, bounds=list(arg))
        return ShardByInfo(kind="hash", column=scol, shards=int(arg))

    def _run_create_table(self, stmt: A.CreateTableStmt):
        if stmt.like is not None:
            return self._run_create_like(stmt)
        if stmt.as_select is not None:
            return self._run_ctas(stmt)
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
                             shard_by=self._shard_by_info(stmt.shard, cols),
                             cluster_by=self._cluster_by_col(
                                 stmt.cluster, cols))
        if stmt.temporary:
            if stmt.foreign_keys:
                raise UnsupportedError(
                    "TEMPORARY tables cannot have foreign keys (MySQL)")
            t = self.catalog.create_temp_table(
                stmt.table.schema or self.db, schema, stmt.if_not_exists,
                engine=stmt.engine)
        else:
            t = self.catalog.create_table(
                stmt.table.schema or self.db, schema,
                stmt.if_not_exists, engine=stmt.engine,
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

    def _run_create_like(self, stmt: A.CreateTableStmt):
        """CREATE TABLE t LIKE src: clone columns (incl. declared type
        text, defaults, auto-increment), primary key, and secondary
        indexes — NOT data, foreign keys, or the source's rows (MySQL
        semantics; FKs are deliberately not copied, like MySQL)."""
        import copy

        src_tn = stmt.like
        self._priv("select", src_tn.schema or self.db, src_tn.name)
        # (FKs are deliberately not copied — MySQL LIKE semantics)
        src = self.catalog.table(src_tn.schema or self.db, src_tn.name)
        schema = copy.deepcopy(src.schema)
        schema.name = stmt.table.name
        for c in schema.columns:
            c.state = "public"
        if stmt.temporary:
            t = self.catalog.create_temp_table(
                stmt.table.schema or self.db, schema, stmt.if_not_exists,
                engine=src.engine)
        else:
            t = self.catalog.create_table(
                stmt.table.schema or self.db, schema,
                stmt.if_not_exists, engine=src.engine)
        if t is not None and t.schema is schema:
            for name, ix in src.indexes.items():
                if name != "PRIMARY" and name not in t.indexes:
                    t.create_index(name, list(ix.columns), unique=ix.unique)
            # MySQL 8 clones CHECK constraints too (preds bind by column
            # name against an identical schema, so sharing is sound)
            t.checks = list(src.checks)
        return None

    def _run_ctas(self, stmt: A.CreateTableStmt):
        """CREATE TABLE t AS SELECT ...: infer the schema from the
        select's output columns (engine types; strings land as varchar)
        and bulk-insert the result (ref: the reference's CTAS path)."""
        # refuse BEFORE running the (possibly expensive) select
        db = stmt.table.schema or self.db
        if self.catalog.has_table(db, stmt.table.name):
            if stmt.if_not_exists:
                return None
            from tidb_tpu_torch.errors import DuplicateTableError

            raise DuplicateTableError(f"table {stmt.table.name!r} exists")
        rs = self._run_select(stmt.as_select)
        from tidb_tpu_torch.types import (DATE, DATETIME, FLOAT64, INT64, STRING,
                                    TIME, TypeKind)

        kind_to_type = {
            TypeKind.INT: INT64, TypeKind.FLOAT: FLOAT64,
            TypeKind.BOOL: parse_type_name("boolean", ()),
            TypeKind.DATE: DATE, TypeKind.DATETIME: DATETIME,
            TypeKind.TIME: TIME,
        }
        cols = []
        seen = set()
        fulls = rs.sql_types or [None] * len(rs.names)
        colls = rs.collations or [None] * len(rs.names)
        for name, kind, full, coll in zip(rs.names, rs.types, fulls, colls):
            cname = name
            i = 2
            while cname in seen:  # duplicate output names disambiguate
                cname = f"{name}_{i}"
                i += 1
            seen.add(cname)
            if kind == TypeKind.DECIMAL:
                # the select's exact precision/scale carries over
                t_ = full if full is not None else parse_type_name(
                    "decimal", (18, 4))
            elif kind in (TypeKind.STRING, TypeKind.JSON):
                t_ = STRING
            elif full is not None and kind in (TypeKind.ENUM, TypeKind.SET):
                t_ = full
            else:
                t_ = kind_to_type.get(kind, STRING)
            # the source column's collation carries over (MySQL CTAS)
            cols.append(ColumnInfo(cname, t_, collation=coll))
        schema = TableSchema(stmt.table.name, cols)
        if stmt.temporary:
            t = self.catalog.create_temp_table(
                stmt.table.schema or self.db, schema, stmt.if_not_exists)
        else:
            t = self.catalog.create_table(
                stmt.table.schema or self.db, schema, stmt.if_not_exists)
        if t is not None and t.schema is schema and rs.rows:
            def do(txn):
                for start in range(0, len(rs.rows), 4096):
                    t.insert_rows(rs.rows[start:start + 4096],
                                  begin_ts=txn.marker, log=txn.log_for(t))

            self._run_dml(do)
        # CTAS is DDL: implicit commit even under autocommit=0 (MySQL) —
        # _run_select may have opened a snapshot txn that would otherwise
        # hold the inserted rows provisional forever
        if self.txn is not None:
            self._commit()
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

    def _precheck_outfile(self, into) -> None:
        """OUTFILE refusals run BEFORE the query: a non-SUPER user or a
        pre-existing target must not pay for the whole scan first."""
        import os

        self._priv("super")  # server-side file write (FILE analogue)
        if len(into.fields_term) != 1 or (
                into.enclosed is not None and len(into.enclosed) != 1):
            raise UnsupportedError(
                "FIELDS TERMINATED/ENCLOSED BY must be one character")
        if os.path.exists(into.path):
            raise ExecutionError(f"file {into.path!r} already exists")

    def _write_outfile(self, rs: ResultSet, into) -> ResultSet:
        """SELECT ... INTO OUTFILE: the LOAD DATA-compatible export pair
        (round-trips through _split_load_fields). mode='x' keeps the
        no-overwrite guarantee atomic under concurrent exporters."""
        delim, quote = into.fields_term, into.enclosed

        def field_text(v):
            if v is None:
                return "\\N"
            # control chars escape FIRST (line framing is \n; a tab
            # delim is covered by the \t mapping), then the delimiter
            s = (str(v).replace("\\", "\\\\").replace("\n", "\\n")
                 .replace("\t", "\\t").replace("\r", "\\r"))
            if quote:
                return quote + s.replace(quote, quote + quote) + quote
            if delim not in ("\t", "\n", "\r"):
                s = s.replace(delim, "\\" + delim)
            return s

        with open(into.path, "x", newline="") as f:
            for row in rs.rows:
                f.write(delim.join(field_text(v) for v in row))
                f.write(into.lines_term)
        return ResultSet(names=["rows"], rows=[(len(rs.rows),)],
                         types=[TypeKind.INT])

    def _run_load_data(self, stmt: A.LoadDataStmt):
        """LOAD DATA INFILE: streamed ingest in txn'd batches (ref:
        executor/load_data). Server-side reads gate on SUPER — the FILE
        privilege analogue; LOCAL (the caller supplies its own file, as
        in MySQL) needs only INSERT. MySQL field semantics via
        _split_load_fields: backslash escapes (\\t \\n \\\\ and escaped
        delimiters), the \\N NULL sentinel, optional enclosure with
        doubled or escaped quotes; empty fields are NULL for non-string
        columns and '' for strings; IGNORE n LINES skips headers."""
        db = stmt.table.schema or self.db
        self._priv("insert", db, stmt.table.name)
        if not stmt.local:
            self._priv("super")  # server-side file access (FILE analogue)
        table = self.catalog.table(db, stmt.table.name)
        if stmt.lines_term not in ("\n", "\r\n"):
            raise UnsupportedError("LINES TERMINATED BY must be \\n or \\r\\n")
        if len(stmt.fields_term) != 1 or (
                stmt.enclosed is not None and len(stmt.enclosed) != 1):
            raise UnsupportedError(
                "FIELDS TERMINATED/ENCLOSED BY must be one character")
        names = stmt.columns or table.schema.public_names()
        cols = [table.schema.col(n) for n in names]
        str_col = [c.type_.kind in (TypeKind.STRING, TypeKind.JSON)
                   for c in cols]
        bool_col = [c.type_.kind == TypeKind.BOOL for c in cols]

        def convert(row):
            out = []
            for j in range(len(cols)):
                raw = row[j] if j < len(row) else None
                if raw is None or (raw == "" and not str_col[j]):
                    out.append(None)
                elif bool_col[j]:
                    # raw text reaches to_device_value, whose bool(v)
                    # would make the STRING "0" truthy
                    out.append(raw.strip().lower() not in ("0", "false", ""))
                else:
                    out.append(raw)
            return out

        total = [0]
        resume_pos = [None]  # retry resumes AFTER already-staged batches

        def do(txn):
            with open(stmt.path, newline="") as f:
                if resume_pos[0] is not None:
                    # a WriteConflict retry re-enters with the earlier
                    # batches already provisionally inserted under this
                    # txn marker (a failing insert leaves the table
                    # untouched) — continue from the saved offset
                    f.seek(resume_pos[0])
                else:
                    for _ in range(stmt.ignore_lines):
                        f.readline()
                batch = []
                # readline, not `for line in f`: a text file refuses
                # tell() while it is iterated, and the resume offset
                # needs tell() after every batch (the reference iterates
                # and raises OSError past its first 4,096 lines)
                for line in iter(f.readline, ""):
                    line = line.rstrip("\r\n")
                    batch.append(convert(_split_load_fields(
                        line, stmt.fields_term, stmt.enclosed)))
                    if len(batch) >= 4096:
                        total[0] += table.insert_rows(
                            batch, columns=names, begin_ts=txn.marker,
                            log=txn.log_for(table))
                        resume_pos[0] = f.tell()
                        batch = []
                if batch:
                    total[0] += table.insert_rows(
                        batch, columns=names, begin_ts=txn.marker,
                        log=txn.log_for(table))
                    resume_pos[0] = f.tell()

        self._run_dml(do)
        return ResultSet(names=["rows"], rows=[(total[0],)],
                         types=[TypeKind.INT])

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
        self._priv("update", target.schema or self.db, target.name)

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
            self._priv("delete", target.schema or self.db, target.name)

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
        the statement's resource profile. The statement's privileges are
        checked as for the statement itself; a matching SQL binding's
        hints apply, so EXPLAIN shows the bound plan."""
        target = stmt.stmt
        if not isinstance(target, (A.SelectStmt, A.UnionStmt)):
            raise UnsupportedError("EXPLAIN only supports SELECT")
        target = self._apply_binding(target)  # EXPLAIN shows the bound plan
        phys = self._plan_select(target)
        # MySQL requires the same privileges for EXPLAIN as for the
        # statement itself; ANALYZE even executes it
        self._check_plan_privs(phys)
        if stmt.analyze:
            from tidb_tpu_torch.columnar.store import compact_counts as _cmp
            from tidb_tpu_torch.utils import dispatch as _dsp
            from tidb_tpu_torch.utils.execdetails import analyze_text, instrument

            root = self._build_root(phys)
            instrument(root)
            # resource profile: deltas of this thread's host-side
            # counters around the execution — no new syncs
            p0 = (_dsp.xfer_bytes(), _dsp.compile_seconds(),
                  _dsp.spill_bytes(), _cmp()[0])
            run_plan(root, self._exec_ctx(plan=phys))  # execute; rows discarded
            text = analyze_text(root)
            mem_max = max((t.max_consumed for t in self._stmt_trackers),
                          default=0)
            text += ("\nprofile: mem_max=%d xfer_bytes=%d compile_ms=%.1f"
                     " spill_bytes=%d compaction_wait_ms=%.1f"
                     % (mem_max, _dsp.xfer_bytes() - p0[0],
                        (_dsp.compile_seconds() - p0[1]) * 1e3,
                        _dsp.spill_bytes() - p0[2],
                        (_cmp()[0] - p0[3]) * 1e3))
            return ResultSet(names=["EXPLAIN ANALYZE"],
                             rows=[(line,) for line in text.split("\n")])
        text = explain_text(phys)
        return ResultSet(names=["EXPLAIN"], rows=[(line,) for line in text.split("\n")])

    def _run_trace(self, stmt: A.TraceStmt):
        """TRACE <select>: execute under the statement's (always-on)
        trace and render ITS span tree — one tracer serves TRACE, the
        slow log and /trace."""
        target = stmt.stmt
        if not isinstance(target, (A.SelectStmt, A.UnionStmt)):
            raise UnsupportedError("TRACE only supports SELECT")
        from tidb_tpu_torch.utils import tracing
        from tidb_tpu_torch.utils.execdetails import instrument

        if self.txn is None and not self.sysvars.get("autocommit"):
            self._begin()  # same consistent-snapshot rule as _run_select
        tracing.keep("trace")  # the trace IS the output: always retain
        tr = tracing.current()
        with tracing.span("session.plan"):
            phys = self._plan_select(target)
            self._check_plan_privs(phys)  # TRACE executes the statement
        with tracing.span("session.build_executor"):
            root = self._build_root(phys)
            instrument(root)
        with tracing.span("session.execute") as exec_span:
            run_plan(root, self._exec_ctx(plan=phys))
        if tr is not None and exec_span is not None:
            self._graft_operator_spans(tr, exec_span, root)
        return ResultSet(names=["span", "start_ms", "duration_ms"],
                         rows=self._trace_rows(tr))

    @staticmethod
    def _graft_operator_spans(tr, exec_span, root) -> None:
        """Per-operator spans from the EXPLAIN ANALYZE instrumentation
        (TRACE) or the plain timing wrapper (execdetails.time_operators):
        start = the operator's first open/next activity, duration = its
        cumulative open+next wall (a coverage envelope: operators
        interleave per chunk), self = that less its children's."""
        def visit(e, parent_id):
            st = e.stats
            t0 = (st.first_ts if st.first_ts is not None
                  else tr.t0_perf + exec_span.start_us / 1e6)
            total = st.open_wall + st.next_wall
            own = total - sum(c.stats.open_wall + c.stats.next_wall
                              for c in e.children)
            notes = [f"rows={st.rows}"] if st.measured else []
            notes += [f"loops={st.chunks}", f"dispatches={st.dispatches}",
                      f"self_ms={max(own, 0.0) * 1e3:.3f}"]
            if st.recompiles:
                notes.append(f"recompiles={st.recompiles}")
            s = tr.add_complete("executor." + type(e).__name__, t0, total,
                                parent_id=parent_id, notes=notes)
            pid = s.span_id if s.span_id > 0 else parent_id
            for c in e.children:
                visit(c, pid)

        visit(root, exec_span.span_id)

    @staticmethod
    def _trace_rows(tr) -> list:
        """Render the current statement span's subtree as the TRACE
        result rows: (indented name, start_ms offset, duration_ms)."""
        from tidb_tpu_torch.utils import tracing

        if tr is None:
            return []
        base_id = tracing.current_span_id()
        spans = list(tr.spans)
        base = next((s for s in spans if s.span_id == base_id), None)
        base_start = base.start_us if base is not None else 0
        children: dict = {}
        for s in spans:
            children.setdefault(s.parent_id, []).append(s)
        rows: list = []

        def visit(s, depth):
            rows.append(("  " * depth + s.name,
                         round((s.start_us - base_start) / 1e3, 3),
                         round(max(s.dur_us, 0) / 1e3, 3)))
            for c in sorted(children.get(s.span_id, ()),
                            key=lambda x: x.start_us):
                visit(c, depth + 1)

        for c in sorted(children.get(base_id, ()), key=lambda x: x.start_us):
            visit(c, 0)
        return rows

    @staticmethod
    def _like_filter(rows, like: Optional[str], col: int = 0):
        if like is None:
            return rows
        import re

        pat = re.escape(like).replace("%", ".*").replace("_", ".")
        rx = re.compile(f"^{pat}$", re.IGNORECASE)
        return [r for r in rows if rx.match(str(r[col]))]

    def _run_show(self, stmt: A.ShowStmt):
        if stmt.kind == "grants":
            user = stmt.target or self.user
            if user != self.user:
                self._priv("super")
            if user not in self.catalog.users:
                raise ExecutionError(f"no user {user!r}")
            rows = [(g,) for g in self.catalog.privileges.grants_for(user)]
            return ResultSet(names=[f"Grants for {user}"], rows=rows)
        if stmt.kind == "processlist":
            rows = self.catalog.processlist_rows(
                viewer_user=self.user, with_state=True)
            return ResultSet(
                names=["Id", "User", "Host", "db", "Command", "Time",
                       "State", "Info"], rows=rows)
        if stmt.kind == "bindings":
            rows = self._bindings.rows() + self.catalog.bind_handle.rows()
            return ResultSet(
                names=["Original_sql", "Bind_sql", "Scope", "Status"], rows=rows)
        if stmt.kind == "plugins":
            return ResultSet(
                names=["Name", "Status", "Type", "Library", "Version"],
                rows=self.catalog.plugins.rows())
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
            # privilege BEFORE the lookup: an unprivileged probe must not
            # learn which table names exist
            self._priv("select", self.db, stmt.target)
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


def _parse_quota(arg: str):
    """MEMORY_QUOTA hint argument: plain bytes, or 'N MB' / 'N GB'
    (TiDB's documented unit forms). None = unparseable, ignore."""
    parts = str(arg).strip().split()
    try:
        n = int(parts[0])
    except (ValueError, IndexError):
        return None
    unit = parts[1].upper() if len(parts) > 1 else ""
    mult = {"": 1, "KB": 1 << 10, "MB": 1 << 20, "GB": 1 << 30}.get(unit)
    return n * mult if mult is not None else None


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


def _count_params(stmt) -> int:
    n = 0
    stack = [stmt]
    while stack:
        e = stack.pop()
        if isinstance(e, A.EParam):
            n = max(n, e.index + 1)
        elif isinstance(e, (list, tuple)):
            stack.extend(e)
        elif hasattr(e, "__dataclass_fields__"):
            stack.extend(getattr(e, f) for f in e.__dataclass_fields__)
    return n


def _param_literal(v):
    """Bound parameter value -> literal AST node (typed contexts coerce
    strings the same way quoted literals coerce)."""
    import datetime

    if v is None:
        return A.ENull()
    if isinstance(v, bool):
        return A.ENum("1" if v else "0")
    if isinstance(v, int):
        return A.ENum(str(v))
    if isinstance(v, float):
        return A.ENum(repr(v))
    if isinstance(v, bytes):
        return A.EStr(v.decode("utf-8", "replace"))
    if isinstance(v, datetime.datetime):
        return A.EStr(v.isoformat(sep=" "))
    if isinstance(v, datetime.date):
        return A.EStr(v.isoformat())
    return A.EStr(str(v))


def _sub_params(stmt, params):
    return _ast_transform(
        stmt, lambda e: _param_literal(params[e.index]) if isinstance(e, A.EParam) else e
    )


_PROFILE_SEQ = __import__("itertools").count(1)


def _profiled(prof_dir: str, device, conn_id: int):
    """The `tidb_profile_dir` hook (the reference's jax.profiler trace):
    a torch.profiler trace of the statement, CUDA activity included on
    the card, written as a chrome trace into `prof_dir`."""
    import contextlib
    import os

    import torch

    @contextlib.contextmanager
    def run():
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(prof_dir, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(os.path.join(
            prof_dir, f"stmt-{conn_id}-{next(_PROFILE_SEQ)}.json"))

    return run()
