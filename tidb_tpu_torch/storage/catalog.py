"""Catalog: databases -> tables (a trimmed copy of
tidb_tpu/storage/catalog.py).

In-memory and schema-versioned (a schema change clears the device buffer
cache), with the timestamp oracle every table stamps its commits from,
the open-transaction registry (the GC safepoint), the 2PC status records
lock resolution finishes crashed commits from, MVCC GC, foreign-key
wiring, RENAME TABLE, views, auto-analyze after commit and the
lock-free reader registry that CLUSTER BY permutes wait on, and its
serving half: user accounts (mysql_native_password) and grants, the
plugin registry, global plan bindings, the DDL owner election and job
queue, the plan cache, the statements summary, the slow-query log and
the process list KILL reads; the table engine per table
(storage/kvapi.py: columnar or delta), DROP DATABASE, information_schema
and the per-session TEMPORARY namespace (`SessionCatalog`).

`dcn_worker_stats`, `cluster_info` and `cluster_metrics` read every
live DCN `Cluster` of the process (parallel/dcn.py's `clusters_alive()`
and `fleet_metrics_entries()`); `plan_feedback` reads the process's
plan-feedback store (planner/feedback.py).
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass, field
from typing import Dict, List

from tidb_tpu_torch.analysis import sanitizer as _san
from tidb_tpu_torch.errors import (
    DuplicateTableError,
    ExecutionError,
    SchemaError,
    UnsupportedError,
)
from tidb_tpu_torch.storage.table import ColumnInfo, Table, TableSchema

__all__ = ["Database", "Catalog", "SessionCatalog"]


@dataclass
class Database:
    name: str
    tables: Dict[str, Table] = field(default_factory=dict)
    # views: name -> (explicit column names or None, SELECT ast, sql text)
    views: Dict[str, tuple] = field(default_factory=dict)


class Catalog:
    def __init__(self):
        # statement-granularity writer lock: the host storage layer is
        # single-writer by design. Registered with the runtime
        # sanitizer's lock-order witness.
        self.lock = _san.tracked_lock("Catalog.lock", threading.RLock)
        self.databases: Dict[str, Database] = {"test": Database("test")}
        # extension points (ref: plugin/ — per-process plugin list)
        from tidb_tpu_torch.plugin import PluginRegistry

        self.plugins = PluginRegistry()
        # global plan bindings (ref: bindinfo — mysql.bind_info); empty
        # until CREATE BINDING is ported with the planner's hints
        from tidb_tpu_torch.bindinfo import BindHandle

        self.bind_handle = BindHandle("global")
        # DDL owner election + job queue (ref: owner/ + ddl/ job rows);
        # workers register per server instance — empty means inline DDL
        from tidb_tpu_torch.owner import Election

        self.ddl_owner = Election()
        self.ddl_workers: Dict[str, object] = {}
        self._ddl_jobs: list = []
        self._ddl_job_id = 0
        self._ddl_qlock = threading.Lock()
        self._schema_version = 0
        # cluster-wide GLOBAL sysvars (ref: mysql.global_variables)
        self.global_vars: Dict[str, object] = {}
        # timestamp oracle + txn id allocator (ref: PD TSO; monotonically
        # increasing, shared by every table in this catalog)
        self._ts = 0
        self._txn_id = 0
        # open transactions: marker -> read_ts (drives the GC safepoint)
        self._open_txns: Dict[int, int] = {}
        # 2PC status records: marker -> ("committed", ts) | ("aborted", 0)
        # present only between commit/abort point and secondary completion
        self._txn_status: Dict[int, tuple] = {}
        # user accounts: name -> mysql_native_password stage-2 hash
        # (SHA1(SHA1(password)), like mysql.user.authentication_string);
        # "" means empty password. Ref: privilege/'s MySQLPrivilege.
        self.users: Dict[str, bytes] = {"root": b""}
        from tidb_tpu_torch.privilege import Privileges

        self.privileges = Privileges()
        # recent slow statements (ref: the slow-query log)
        from collections import deque

        self.slow_queries = deque(maxlen=128)
        # per-digest statement aggregates (the status port's /statements)
        from tidb_tpu_torch.utils.stmtsummary import StmtSummary

        self.stmt_summary = StmtSummary()
        # instance-wide digest-keyed plan cache (ref: the prepared plan
        # cache + tidb_enable_non_prepared_plan_cache); imported lazily:
        # the planner pulls in the optimizer stack
        from tidb_tpu_torch.planner.plancache import PlanCache

        self.plan_cache = PlanCache()
        # live sessions for SHOW PROCESSLIST / KILL (ref: server/'s
        # connection registry); weak values — a dropped session vanishes
        import weakref

        self.processes = weakref.WeakValueDictionary()
        self._conn_id = 0
        self._conn_id_lock = threading.Lock()
        # lock-free reader registry (CLUSTER BY recluster): autocommit
        # SELECTs never enter _open_txns, yet a CLUSTER BY permute moves
        # the physical rows they read without any lock. Statements
        # register their execution window here (reader_enter/exit), scan
        # executors additionally count open scans (scan_enter/exit), and
        # recluster runs ONLY while this registry is quiescent, holding
        # _readers_lock so no new reader can start mid-permute. Order:
        # Catalog.lock -> _readers_lock.
        self._readers_lock = _san.tracked_lock("Catalog.readers", threading.Lock)
        self._stmt_readers: Dict[int, int] = {}  # thread ident -> depth
        self._open_scans = 0
        # SegmentStores whose CLUSTER BY permute is due; performed at
        # the next quiescent statement boundary (run_pending_reclusters)
        self._recluster_pending: list = []

    @property
    def schema_version(self) -> int:
        return self._schema_version

    @schema_version.setter
    def schema_version(self, v: int) -> None:
        self._schema_version = int(v)
        # eager plan-cache invalidation: entries pin table objects, so
        # waiting for the next probe would keep DROPped tables alive
        pc = getattr(self, "plan_cache", None)
        if pc is not None:
            pc.on_schema_change(self._schema_version)
        # the device buffer cache pins table objects: a schema change
        # clears it eagerly, so DROP/CREATE never serves buffers of a
        # dropped table. Looked up lazily: the catalog stays importable
        # without the executor stack, and a cache that does not exist
        # yet has nothing to invalidate (getattr-guarded: sys.modules can
        # hold a module another thread is still importing)
        pipe = sys.modules.get("tidb_tpu_torch.executor.pipeline")
        cache = getattr(pipe, "DEVICE_CACHE", None)
        if cache is not None:
            cache.on_schema_change()
        # the mesh tier's shard caches pin table objects too: same rule
        par = sys.modules.get("tidb_tpu_torch.parallel.executor")
        drop_shards = getattr(par, "on_schema_change", None)
        if drop_shards is not None:
            drop_shards()
        # plan feedback: recorded est-vs-actual truth was measured against
        # plans over the old schema; same eager rule (and the same lazy
        # lookup) as the device cache
        fb = sys.modules.get("tidb_tpu_torch.planner.feedback")
        store = getattr(fb, "STORE", None)
        if store is not None:
            store.on_schema_change()

    def processlist_rows(self, viewer_user=None, with_state=False):
        """Live-session rows for SHOW PROCESSLIST. A viewer without the
        SUPER privilege sees only their own threads (MySQL)."""
        import time as _time

        all_users = (viewer_user is None
                     or self.privileges.has(viewer_user, "super"))
        rows = []
        for cid in sorted(self.processes.keys()):
            sess = self.processes.get(cid)
            if sess is None or (not all_users
                                and sess.user != viewer_user):
                continue
            sql_now = getattr(sess, "_current_sql", None)
            row = [cid, sess.user, "localhost", sess.db,
                   "Query" if sql_now else "Sleep",
                   int(_time.time() - sess._current_t0) if sql_now else 0]
            if with_state:
                row.append("" if sql_now else None)
            row.append((sql_now or "")[:100] or None)
            rows.append(tuple(row))
        return rows

    def next_conn_id(self) -> int:
        # its own tiny lock: the catalog statement lock can be held for
        # a whole long statement, and session CREATION must never block
        # behind it (the wire server handshakes on a fresh thread)
        with self._conn_id_lock:
            self._conn_id += 1
            return self._conn_id

    def submit_ddl(self, sql: str, db: str):
        """Enqueue a DDL job for the elected owner's worker."""
        from tidb_tpu_torch.owner import DDLJob

        with self._ddl_qlock:
            self._ddl_job_id += 1
            job = DDLJob(self._ddl_job_id, sql, db)
            self._ddl_jobs.append(job)
        return job

    def next_ddl_job(self, worker_id: str = ""):
        with self._ddl_qlock:
            for j in self._ddl_jobs:
                if j.state == "queued":
                    j.state = "running"  # claimed atomically: a lease
                    # change between campaign() and here must not let
                    # two workers run the same job
                    j.claimed_by = worker_id
                    return j
            # opportunistic pruning of finished history
            self._ddl_jobs = [j for j in self._ddl_jobs if not j.done.is_set()]
        return None

    def reclaim_ddl_jobs(self) -> int:
        """Requeue jobs claimed by a worker that is gone (owner died
        mid-execution; the new owner picks them up)."""
        n = 0
        with self._ddl_qlock:
            for j in self._ddl_jobs:
                if (j.state == "running" and j.claimed_by
                        and j.claimed_by not in self.ddl_workers):
                    j.state = "queued"
                    j.claimed_by = None
                    n += 1
        return n

    def drain_ddl_jobs(self, reason: str) -> None:
        """Fail every unfinished job (no workers remain to run them)."""
        with self._ddl_qlock:
            for j in self._ddl_jobs:
                if not j.done.is_set():
                    j.fail(ExecutionError(reason))
            self._ddl_jobs = []

    def next_ts(self) -> int:
        self._ts += 1
        return self._ts

    @property
    def current_ts(self) -> int:
        return self._ts

    def next_txn_id(self) -> int:
        self._txn_id += 1
        return self._txn_id

    # -- transactions / GC safepoint ---------------------------------------
    # (ref: PD's TSO + GC safepoint advance: the safepoint is the oldest
    # snapshot any open txn can read; versions ended at/below it are dead)

    def begin_txn(self) -> tuple:
        """Allocate (marker, read_ts) and register the txn as open."""
        from tidb_tpu_torch.storage.table import TXN_TS_BASE

        marker = TXN_TS_BASE + self.next_txn_id()
        read_ts = self.current_ts
        self._open_txns[marker] = read_ts
        return marker, read_ts

    def end_txn(self, marker: int) -> None:
        self._open_txns.pop(marker, None)

    # -- lock-free reader registry (CLUSTER BY permute safety) --------------
    # Readers of the live column arrays take no lock (the MVCC design:
    # committed rows are stable under concurrent APPENDS). A physical
    # permute breaks that invariant, so it may only run while nothing is
    # reading: statements bracket themselves with reader_enter/exit, scan
    # executors (and the paged cursors that outlive a statement) with
    # scan_enter/exit, and run_pending_reclusters refuses unless both
    # counts are zero — holding _readers_lock across the permute so no
    # new reader can begin mid-move.

    def reader_enter(self) -> None:
        ident = threading.get_ident()
        with self._readers_lock:
            self._stmt_readers[ident] = self._stmt_readers.get(ident, 0) + 1

    def reader_exit(self) -> None:
        ident = threading.get_ident()
        with self._readers_lock:
            d = self._stmt_readers.get(ident, 0) - 1
            if d <= 0:
                self._stmt_readers.pop(ident, None)
            else:
                self._stmt_readers[ident] = d

    def scan_enter(self) -> None:
        with self._readers_lock:
            self._open_scans += 1

    def scan_exit(self) -> None:
        with self._readers_lock:
            self._open_scans = max(self._open_scans - 1, 0)

    def note_recluster_due(self, store) -> None:
        """A scan noticed a CLUSTER BY permute is due (fold cadence).
        Queue it; the permute runs at a statement boundary, never on the
        reader path that noticed it."""
        with self._readers_lock:
            if store not in self._recluster_pending:
                self._recluster_pending.append(store)

    def run_pending_reclusters(self) -> None:
        """Perform queued CLUSTER BY permutes if the world is quiescent
        (no open txns, no registered statement windows, no open scans).
        Called at statement boundaries with the calling thread NOT
        registered. Stores whose permute still refuses (e.g. another
        session's open txn) stay queued for a later boundary."""
        if not self._recluster_pending:
            return
        with self.lock:
            if self._open_txns:
                return
            done = []
            with self._readers_lock:
                if self._stmt_readers or self._open_scans:
                    return
                # _readers_lock HELD across the permute: a new reader
                # blocks in reader_enter until rows stop moving
                for store in self._recluster_pending:
                    if store.recluster_now(quiesced=True):
                        done.append(store)
            for store in done:
                self._recluster_pending.remove(store)

    # -- 2PC status records (the Percolator primary; ref: txn status in
    # TiKV consulted by lock resolution) ------------------------------------

    def commit_point(self, marker: int) -> int:
        """THE atomic commit: after this status write the txn is
        committed regardless of crashes. Returns the commit ts."""
        ts = self.next_ts()
        self._txn_status[marker] = ("committed", ts)
        return ts

    def abort_point(self, marker: int) -> None:
        self._txn_status[marker] = ("aborted", 0)

    def finish_txn(self, marker: int) -> None:
        """All secondaries applied: drop the status record + the open
        registration."""
        self._txn_status.pop(marker, None)
        self.end_txn(marker)

    def txn_status(self, marker: int):
        return self._txn_status.get(marker)

    def has_stale_txns(self) -> bool:
        """Any decided txn with possibly-unapplied residue? (O(1) —
        status records are dropped in finish_txn on the success path.)"""
        return bool(self._txn_status)

    def resolve_locks(self) -> int:
        """Finish crashed commits/aborts (the resolve-lock flow): any
        marker with a recorded decision but unapplied table residue gets
        its markers rewritten (commit) or erased (rollback) via the
        logless full-scan paths, which are idempotent. Returns resolved
        txn count."""
        n = 0
        for marker, (st, ts) in list(self._txn_status.items()):
            for db in self.databases.values():
                for t in db.tables.values():
                    if st == "committed":
                        t.txn_commit(marker, ts)
                    else:
                        t.txn_rollback(marker)
                    t.release_locks(marker)  # crashed FOR UPDATE locks
            self.finish_txn(marker)
            n += 1
        return n

    def safepoint(self) -> int:
        """Oldest snapshot any open txn can read. NOTE: today's GC
        drivers refuse to run with open txns at all (their write logs
        hold physical row positions — see Table.gc), so when GC actually
        runs this equals current_ts; the min() is the contract for a
        future log-remapping GC that can run under open snapshots."""
        return min(self._open_txns.values(), default=self._ts)

    def log_slow_query(self, db: str, sql: str, duration_s: float,
                       digest: str = "", plan_digest: str = "",
                       max_mem: int = 0, dispatches: int = 0,
                       segs_scanned: int = 0, segs_pruned: int = 0,
                       trace_id: str = "", disposition: str = "",
                       worst_drift: float = 0.0,
                       worst_drift_op: str = "",
                       xfer_bytes: int = 0, compile_ms: float = 0.0,
                       spill_bytes: int = 0,
                       compaction_wait_ms: float = 0.0) -> None:
        """One slow-log row. `trace_id` joins the row to the kept trace
        on /trace?id=; `disposition` is "" for a completed statement or
        "error:<Type>" for one that died mid-execution (deadline, kill,
        runtime error). `worst_drift`/`worst_drift_op`: the statement's
        worst est-vs-actual operator drift from plan feedback, so a slow
        statement with a hundredfold drift reads as a planning problem."""
        import logging
        import time

        self.slow_queries.append((
            time.strftime("%Y-%m-%d %H:%M:%S"), db, round(duration_s, 4),
            sql.strip()[:2048], digest, plan_digest, int(max_mem),
            int(dispatches), int(segs_scanned), int(segs_pruned),
            trace_id, disposition, worst_drift_op, round(worst_drift, 4),
            int(xfer_bytes), round(float(compile_ms), 3), int(spill_bytes),
            round(float(compaction_wait_ms), 3),
        ))
        logging.getLogger("tidb_tpu_torch.slowlog").warning(
            "slow query (%.3fs) db=%s digest=%s mem=%d dispatches=%d "
            "segs=%d/%d trace=%s%s: %s",
            duration_s, db, digest, max_mem, dispatches, segs_scanned,
            segs_scanned + segs_pruned, trace_id,
            f" [{disposition}]" if disposition else "",
            sql.strip()[:512])

    def gc(self) -> Dict[str, int]:
        """Reclaim dead MVCC versions in every table. Conservative: a
        no-op while any txn is open (open write logs hold physical row
        positions; see Table.gc contract). Returns table -> reclaimed."""
        if self._open_txns:
            return {}
        sp = self.safepoint()
        out: Dict[str, int] = {}
        for db in self.databases.values():
            for name, t in db.tables.items():
                r = t.gc(sp)
                if r:
                    out[f"{db.name}.{name}"] = r
        _count_reclaimed(out)
        return out

    def auto_gc(self, tables=None, min_dead: int = 4096,
                ratio: float = 0.3) -> Dict[str, int]:
        """Opportunistic GC after DML: compact tables whose dead-version
        count crossed the threshold (the auto-GC worker analogue).
        `tables` limits the scan to the tables a txn touched — the
        threshold check costs an O(n) liveness pass per table, which
        must not be paid for every table on every commit."""
        if self._open_txns:
            return {}
        sp = self.safepoint()
        if tables is None:
            tables = [t for db in self.databases.values()
                      for t in db.tables.values()]
        out: Dict[str, int] = {}
        for t in tables:
            phys, dead = t.maintenance_stats()
            if dead >= min_dead and dead >= ratio * phys:
                r = t.gc(sp)
                if r:
                    out[t.schema.name] = r
        _count_reclaimed(out)
        return out

    def maybe_auto_analyze(self, tables, ratio: float = 0.5,
                           min_rows: int = 1024) -> int:
        """Stats lifecycle (ref: statistics auto-analyze): re-collect a
        touched table's statistics when the rows modified since the last
        ANALYZE cross ratio * analyzed row count (or the table has grown
        past min_rows with no stats at all). Runs inline after commit —
        the single-process analogue of the reference's stats-owner
        background worker. Returns how many tables were analyzed."""
        from tidb_tpu_torch.statistics import analyze_table

        done = 0
        for t in tables:
            mc = getattr(t, "modify_count", 0)
            stats = getattr(t, "stats", None)
            if stats is None:
                # maintenance_stats: threshold probe that must not force
                # a delta-engine compaction on every commit
                if t.maintenance_stats()[0] < min_rows or mc == 0:
                    continue
            elif mc < ratio * max(stats.n_rows, min_rows):
                continue
            analyze_table(t)
            t.modify_count = 0
            done += 1
        return done

    def create_database(self, name: str, if_not_exists: bool = False):
        if name in self.databases:
            if if_not_exists:
                return
            raise DuplicateTableError(f"database {name!r} exists")
        self.databases[name] = Database(name)
        self.schema_version += 1

    def drop_database(self, name: str, if_exists: bool = False):
        if name not in self.databases:
            if if_exists:
                return
            raise SchemaError(f"no database {name!r}")
        dropped = set(self.databases[name].tables.values())
        # FK hygiene matching drop_table: refuse when a table here is
        # referenced from OUTSIDE the database; release the back-edges
        # dropped children hold on external parents
        for t in dropped:
            for child, _fk in getattr(t, "referencing", ()):
                if child is not t and child not in dropped:
                    raise SchemaError(
                        f"cannot drop database {name!r}: "
                        f"{t.schema.name!r} is referenced by a foreign "
                        "key outside it")
        for t in dropped:
            for fk in getattr(t, "foreign_keys", ()):
                if fk.parent not in dropped:
                    fk.parent.referencing = [
                        (c, f) for c, f in fk.parent.referencing
                        if c is not t]
        del self.databases[name]
        self.schema_version += 1

    def database(self, name: str) -> Database:
        if name.lower() == "information_schema":
            return self._info_schema_db()
        db = self.databases.get(name)
        if db is None:
            raise SchemaError(f"no database {name!r}")
        return db

    # -- tables ------------------------------------------------------------

    def create_table(self, db: str, schema: TableSchema,
                     if_not_exists: bool = False,
                     engine: str = None,
                     foreign_keys=None) -> Table:
        d = self.database(db)
        if schema.name in d.tables:
            if if_not_exists:
                return d.tables[schema.name]
            raise DuplicateTableError(f"table {schema.name!r} exists")
        if schema.name in d.views:
            if if_not_exists:
                return None
            raise DuplicateTableError(f"view {schema.name!r} exists")
        from tidb_tpu_torch.storage.kvapi import make_table

        t = make_table(schema, engine)
        t.ts_source = self.next_ts
        t.txn_guard = self  # recluster's writer-lock + open-txn gate
        # two-pass: every FK spec must RESOLVE before any back-edge is
        # written; a failure after partial wiring would leave phantom
        # references blocking DROP of the parents forever
        resolved = [self._resolve_foreign_key(db, t, spec)
                    for spec in foreign_keys or ()]
        for parent, fk in resolved:
            t.foreign_keys.append(fk)
            parent.referencing.append((t, fk))
        d.tables[schema.name] = t
        self.schema_version += 1
        return t

    def _resolve_foreign_key(self, db: str, child, spec):
        """Resolve one FOREIGN KEY spec (multi-column, with referential
        actions; ref: ddl foreign-key jobs) WITHOUT mutating anything.
        The referenced column list must carry a matching unique index —
        the same requirement MySQL effectively imposes for well-defined
        parent probes."""
        from tidb_tpu_torch.storage.table import FKInfo

        cols, ref, ref_cols = spec[:3]
        on_delete = spec[3] if len(spec) > 3 else "restrict"
        on_update = spec[4] if len(spec) > 4 else "restrict"
        if len(cols) != len(ref_cols) or not cols:
            raise SchemaError(
                "FOREIGN KEY column count must match REFERENCES")
        for c in cols:
            child.schema.col(c)  # raises if absent
        parent = self.table(ref.schema or db, ref.name)
        for c in ref_cols:
            parent.schema.col(c)
        unique_on_ref = any(
            ix.unique and ix.columns == list(ref_cols)
            for ix in parent.indexes.values())
        if not unique_on_ref:
            raise SchemaError(
                f"foreign key target {ref.name}.({', '.join(ref_cols)}) "
                "must be a PRIMARY KEY or matching UNIQUE index")
        for c, pc in zip(cols, ref_cols):
            cc, pcc = child.schema.col(c), parent.schema.col(pc)
            if (cc.type_.is_dict_encoded and pcc.type_.is_dict_encoded
                    and cc.coll != pcc.coll):
                # FK matching compares fold keys; mixed collations would
                # compare apples to oranges (MySQL requires identical
                # collations on FK column pairs too)
                raise SchemaError(
                    f"foreign key column {c!r} collation {cc.coll!r} must "
                    f"match referenced {pc!r} collation {pcc.coll!r}")
        fk = FKInfo(columns=list(cols), parent=parent,
                    parent_cols=list(ref_cols),
                    name=f"fk_{child.schema.name}_{'_'.join(cols)}",
                    parent_db=ref.schema or db,
                    on_delete=on_delete, on_update=on_update)
        return parent, fk

    def drop_table(self, db: str, name: str, if_exists: bool = False):
        d = self.database(db)
        if name not in d.tables:
            if if_exists:
                return
            raise SchemaError(f"no table {db}.{name}")
        t = d.tables[name]
        if any(child is not t for child, _fk in t.referencing):
            raise SchemaError(
                f"cannot drop {name!r}: referenced by a foreign key")
        # a dropped child releases its back-edges on every parent
        for fk in t.foreign_keys:
            fk.parent.referencing = [
                (c, f) for c, f in fk.parent.referencing if c is not t]
        # columnar segment store: release spilled payloads promptly (a
        # weakref finalizer on the store backstops tables dropped by GC)
        store = getattr(t, "_segment_store", None)
        if store is not None:
            try:
                store.close()
            except Exception:  # noqa: BLE001 — cleanup must not block DROP
                pass
        del d.tables[name]
        self.schema_version += 1

    def table(self, db: str, name: str) -> Table:
        if db.lower() == "information_schema":
            t = self._info_schema_table(name.lower())
            if t is None:
                raise SchemaError(f"no table {db}.{name}")
            return t
        d = self.database(db)
        t = d.tables.get(name)
        if t is None:
            raise SchemaError(f"no table {db}.{name}")
        return t

    def has_table(self, db: str, name: str) -> bool:
        if db.lower() == "information_schema":
            return name.lower() in _INFO_TABLES
        return name in self.databases.get(db, Database(db)).tables

    def tables(self, db: str) -> List[str]:
        return sorted(self.database(db).tables.keys())

    # -- views (ref: the view half of ddl/ + infoschema; a view is a
    # stored SELECT expanded at plan time like a derived table) ---------

    def create_view(self, db: str, name: str, columns, stmt, sql: str,
                    or_replace: bool = False) -> None:
        d = self.database(db)
        if name in d.tables:
            raise DuplicateTableError(f"table {name!r} exists")
        if name in d.views and not or_replace:
            raise DuplicateTableError(f"view {name!r} exists")
        d.views[name] = (tuple(columns) if columns else None, stmt, sql)
        self.schema_version += 1

    def drop_view(self, db: str, name: str, if_exists: bool = False) -> None:
        d = self.database(db)
        if name not in d.views:
            if if_exists:
                return
            raise SchemaError(f"no view {db}.{name}")
        del d.views[name]
        self.schema_version += 1

    def view(self, db: str, name: str):
        d = self.databases.get(db)
        return d.views.get(name) if d is not None else None

    def rename_table(self, db: str, old: str, new: str):
        d = self.database(db)
        if old not in d.tables:
            raise SchemaError(f"no table {db}.{old}")
        if new in d.tables:
            raise DuplicateTableError(f"table {new!r} exists")
        if new in d.views:
            raise DuplicateTableError(f"view {new!r} exists")
        t = d.tables.pop(old)
        t.schema.name = new
        d.tables[new] = t
        self.schema_version += 1

    # -- users (ref: privilege/ — mysql_native_password authentication) --

    @staticmethod
    def native_hash(password: str) -> bytes:
        """mysql_native_password stage-2 hash (what the server stores)."""
        import hashlib

        if not password:
            return b""
        return hashlib.sha1(hashlib.sha1(password.encode()).digest()).digest()

    def create_user(self, user: str, password: str = "",
                    if_not_exists: bool = False) -> None:
        if user in self.users:
            if if_not_exists:
                return  # MySQL: existing account (and password) untouched
            raise DuplicateTableError(f"user {user!r} exists")
        self.users[user] = self.native_hash(password)

    def drop_user(self, user: str, if_exists: bool = False) -> None:
        if user not in self.users:
            if if_exists:
                return
            raise SchemaError(f"no user {user!r}")
        del self.users[user]

    def set_password(self, user: str, password: str) -> None:
        if user not in self.users:
            raise SchemaError(f"no user {user!r}")
        self.users[user] = self.native_hash(password)

    def verify_user(self, user: str, token: bytes, salt: bytes) -> bool:
        """Check a mysql_native_password scramble:
        token = SHA1(password) XOR SHA1(salt + SHA1(SHA1(password)))."""
        import hashlib

        stage2 = self.users.get(user)
        if stage2 is None:
            return False
        if stage2 == b"":
            return token in (b"", b"\x00" * 20)
        if len(token) != 20:
            return False
        mix = hashlib.sha1(salt + stage2).digest()
        stage1 = bytes(a ^ b for a, b in zip(token, mix))
        return hashlib.sha1(stage1).digest() == stage2

    # -- INFORMATION_SCHEMA (ref: infoschema/'s virtual memtables) ----------
    # Read-only views over catalog metadata, materialized per access so
    # they always reflect the current schema version.

    def _info_schema_db(self) -> Database:
        # listing=True: a SHOW TABLES / schema walk materializes every
        # info table — dcn_worker_stats must not fan RPCs out to live
        # clusters just to report that it exists
        d = Database("information_schema")
        for name in _INFO_TABLES:
            d.tables[name] = self._info_schema_table(name, listing=True)
        return d

    def _info_schema_table(self, name: str, viewer=None,
                           listing: bool = False):
        from tidb_tpu_torch.types import FLOAT64, INT64, STRING

        def make(cols, rows):
            schema = TableSchema(
                name, [ColumnInfo(c, t, not_null=False) for c, t in cols])
            t = Table(schema)
            if rows:
                t.insert_rows(rows, begin_ts=0)
            return t

        if name == "schemata":
            return make(
                [("catalog_name", STRING), ("schema_name", STRING)],
                [("def", n) for n in sorted(self.databases)]
                + [("def", "information_schema")],
            )
        if name == "tables":
            rows = []
            for dbn in sorted(self.databases):
                for tn in sorted(self.databases[dbn].tables):
                    t = self.databases[dbn].tables[tn]
                    rows.append(("def", dbn, tn, "BASE TABLE", t.live_rows))
                for vn in sorted(self.databases[dbn].views):
                    rows.append(("def", dbn, vn, "VIEW", 0))
            return make(
                [("table_catalog", STRING), ("table_schema", STRING),
                 ("table_name", STRING), ("table_type", STRING),
                 ("table_rows", INT64)],
                rows,
            )
        if name == "columns":
            rows = []
            for dbn in sorted(self.databases):
                for tn in sorted(self.databases[dbn].tables):
                    t = self.databases[dbn].tables[tn]
                    pk = set(t.schema.primary_key or [])
                    for i, c in enumerate(t.schema.columns):
                        rows.append((
                            dbn, tn, c.name, i + 1,
                            c.type_.kind.name.lower(),
                            "NO" if c.not_null else "YES",
                            "PRI" if c.name in pk else "",
                        ))
            return make(
                [("table_schema", STRING), ("table_name", STRING),
                 ("column_name", STRING), ("ordinal_position", INT64),
                 ("data_type", STRING), ("is_nullable", STRING),
                 ("column_key", STRING)],
                rows,
            )
        if name == "key_column_usage":
            rows = []
            for dbn in sorted(self.databases):
                for tn in sorted(self.databases[dbn].tables):
                    t = self.databases[dbn].tables[tn]
                    for idx in t.indexes.values():
                        if not idx.unique:
                            continue
                        for i, cname in enumerate(idx.columns):
                            rows.append(("def", dbn, idx.name, dbn, tn,
                                         cname, i + 1, None, None, None))
                    for fk in getattr(t, "foreign_keys", ()):
                        for i, (c, pc) in enumerate(
                                zip(fk.columns, fk.parent_cols)):
                            rows.append(("def", dbn, fk.name, dbn, tn,
                                         c, i + 1, fk.parent_db,
                                         fk.parent.schema.name, pc))
            return make(
                [("constraint_catalog", STRING),
                 ("constraint_schema", STRING), ("constraint_name", STRING),
                 ("table_schema", STRING), ("table_name", STRING),
                 ("column_name", STRING), ("ordinal_position", INT64),
                 ("referenced_table_schema", STRING),
                 ("referenced_table_name", STRING),
                 ("referenced_column_name", STRING)],
                rows,
            )
        if name == "referential_constraints":
            rows = []
            for dbn in sorted(self.databases):
                for tn in sorted(self.databases[dbn].tables):
                    t = self.databases[dbn].tables[tn]
                    for fk in getattr(t, "foreign_keys", ()):
                        rows.append(
                            ("def", dbn, fk.name, tn,
                             fk.parent_db, fk.parent.schema.name,
                             fk.on_update.replace("_", " ").upper(),
                             fk.on_delete.replace("_", " ").upper()))
            return make(
                [("constraint_catalog", STRING),
                 ("constraint_schema", STRING), ("constraint_name", STRING),
                 ("table_name", STRING),
                 ("unique_constraint_schema", STRING),
                 ("referenced_table_name", STRING),
                 ("update_rule", STRING), ("delete_rule", STRING)],
                rows,
            )
        if name == "partitions":
            rows = []
            for dbn in sorted(self.databases):
                for tn in sorted(self.databases[dbn].tables):
                    pi = self.databases[dbn].tables[tn].schema.partition
                    if pi is None:
                        rows.append(("def", dbn, tn, None, None, None, None))
                        continue
                    for p in range(pi.count()):
                        desc = None
                        if pi.kind == "range":
                            u = pi.uppers[p]
                            desc = "MAXVALUE" if u is None else str(u)
                        rows.append(("def", dbn, tn, pi.part_name(p), p + 1,
                                     pi.kind.upper(), desc))
            return make(
                [("table_catalog", STRING), ("table_schema", STRING),
                 ("table_name", STRING), ("partition_name", STRING),
                 ("partition_ordinal_position", INT64),
                 ("partition_method", STRING),
                 ("partition_description", STRING)],
                rows,
            )
        if name == "processlist":
            rows = self.processlist_rows(viewer_user=viewer,
                                         with_state=True)
            return make(
                [("id", INT64), ("user", STRING), ("host", STRING),
                 ("db", STRING), ("command", STRING), ("time", INT64),
                 ("state", STRING), ("info", STRING)],
                rows,
            )
        if name == "slow_query":
            return make(
                [("time", STRING), ("db", STRING), ("query_time", FLOAT64),
                 ("query", STRING), ("digest", STRING),
                 ("plan_digest", STRING), ("max_mem", INT64),
                 ("dispatches", INT64), ("segs_scanned", INT64),
                 ("segs_pruned", INT64), ("trace_id", STRING),
                 ("disposition", STRING), ("worst_drift_op", STRING),
                 ("worst_drift", FLOAT64), ("xfer_bytes", INT64),
                 ("compile_ms", FLOAT64), ("spill_bytes", INT64),
                 ("compaction_wait_ms", FLOAT64)],
                list(self.slow_queries),
            )
        if name == "cluster_trace":
            # one row per span of every KEPT trace (the process-global
            # tail-sampled store) — joinable against slow_query.trace_id
            # and the /metrics exemplars
            from tidb_tpu_torch.utils import tracing

            rows = []
            for t in tracing.STORE.traces():
                ts = _time_strftime(t.start_ts)
                keep = ",".join(t.keep_reasons)
                for s in list(t.spans):
                    rows.append((
                        t.trace_id, ts, keep, s.span_id, s.parent_id,
                        s.name, s.proc or "local", s.start_us,
                        max(s.dur_us, 0), ";".join(s.notes)))
            return make(
                [("trace_id", STRING), ("time", STRING), ("keep", STRING),
                 ("span_id", INT64), ("parent_span_id", INT64),
                 ("name", STRING), ("proc", STRING), ("start_us", INT64),
                 ("duration_us", INT64), ("annotations", STRING)],
                rows,
            )
        if name == "dcn_worker_stats":
            # per-worker failure-domain counters of every live Cluster
            # in this process, joinable from SQL
            rows = []
            if not listing:
                from tidb_tpu_torch.parallel.dcn import clusters_alive

                for ci, cl in enumerate(clusters_alive()):
                    try:
                        rows.extend((ci,) + r
                                    for r in cl.worker_stats_rows())
                    except Exception:  # noqa: BLE001 — a dying cluster
                        continue       # must not fail the whole read
            return make(
                [("cluster", INT64), ("worker", INT64),
                 ("endpoint", STRING), ("state", STRING),
                 ("executed", INT64), ("cancelled", INT64),
                 ("deadline_exceeded", INT64), ("cancel_rpcs", INT64),
                 ("pages", INT64), ("open_cursors", INT64),
                 ("shards_owned", INT64), ("shard_bytes", INT64),
                 ("shuffle_bytes_in", INT64),
                 ("shuffle_bytes_out", INT64),
                 ("reconnects", INT64), ("replica", INT64),
                 ("error", STRING)],
                rows,
            )
        if name == "scheduler_stats":
            # serving-tier counters of every live statement scheduler in
            # this process: one summary row per scheduler (digest = '')
            # plus one row per coalesced digest. Guarded like
            # dcn_worker_stats: a SHOW TABLES / schema walk (listing)
            # must not touch live schedulers just to report existence.
            rows = []
            if not listing:
                from tidb_tpu_torch.serving import schedulers_alive

                for si, sch in enumerate(schedulers_alive()):
                    try:
                        d = sch.stats_dict()
                    except Exception:  # noqa: BLE001 — a dying scheduler
                        continue       # must not fail the whole read
                    rows.append((
                        si, "", d["workers"], d["queue_depth"],
                        d["inflight_batches"], d["admitted"],
                        d["rejected"], d["timed_out"], d["batches"],
                        d["coalesced_stmts"], d["mem_consumed"],
                        d["mem_budget"],
                        "draining" if d["draining"] else "running"))
                    for dg, cnt in sorted(d["coalesce_by_digest"].items()):
                        rows.append((si, dg, None, None, None, None, None,
                                     None, None, cnt, None, None, ""))
            return make(
                [("scheduler", INT64), ("digest", STRING),
                 ("workers", INT64), ("queue_depth", INT64),
                 ("inflight_batches", INT64), ("admitted", INT64),
                 ("rejected", INT64), ("timed_out", INT64),
                 ("batches", INT64), ("coalesced_stmts", INT64),
                 ("mem_consumed", INT64), ("mem_budget", INT64),
                 ("state", STRING)],
                rows,
            )
        if name == "statements_summary":
            return make(
                [("digest", STRING), ("stmt_type", STRING),
                 ("digest_text", STRING), ("plan_digest", STRING),
                 ("exec_count", INT64), ("sum_latency", FLOAT64),
                 ("avg_latency", FLOAT64), ("max_latency", FLOAT64),
                 ("p95_latency", FLOAT64), ("max_mem", INT64),
                 ("rows_sent", INT64), ("errors", INT64),
                 ("dispatches", INT64), ("fragments", INT64),
                 ("first_seen", STRING), ("last_seen", STRING),
                 ("plan_cache_hits", INT64), ("sum_plan_latency", FLOAT64),
                 ("max_drift", FLOAT64), ("mean_drift", FLOAT64),
                 ("worst_drift_op", STRING), ("xfer_bytes", INT64),
                 ("compile_ms", FLOAT64), ("spill_bytes", INT64)],
                self.stmt_summary.rows(),
            )
        if name == "plan_feedback":
            # per-operator est-vs-actual truth of every recorded
            # (digest, plan): the SQL face of the plan-feedback store
            from tidb_tpu_torch.planner.feedback import STORE as _fb_store

            return make(
                [("digest", STRING), ("plan_digest", STRING),
                 ("variant", STRING), ("execs", INT64),
                 ("warm_execs", INT64), ("best_warm_ms", FLOAT64),
                 ("eager_partial", INT64), ("fused_probe", INT64),
                 ("op", STRING), ("est_rows", FLOAT64),
                 ("actual_rows", FLOAT64), ("drift", FLOAT64),
                 ("op_execs", INT64)],
                _fb_store.rows(),
            )
        if name == "cluster_metrics":
            # the fleet metrics plane: the SAME scrape entries
            # /metrics?scope=cluster renders, as SQL rows — per-worker
            # samples, the merged worker='fleet' view, and an error row
            # per unreachable worker. Guarded like dcn_worker_stats: a
            # SHOW TABLES / schema walk (listing) must not scrape a live
            # fleet just to report existence.
            rows = []
            if not listing:
                from tidb_tpu_torch.parallel.dcn import fleet_metrics_entries
                from tidb_tpu_torch.utils.metrics import cluster_rows

                rows = cluster_rows(fleet_metrics_entries())
            return make(
                [("worker", STRING), ("metric", STRING),
                 ("labels", STRING), ("value", FLOAT64),
                 ("error", STRING)],
                rows,
            )
        if name == "cluster_info":
            # topology / online-reshard progress: a fleet summary row
            # per live coordinator plus one row per moved shard of every
            # in-flight reshard (a fault-fenced shard shows state
            # "cutover"). No listing guard needed: local coordinator
            # memory, reading it fans out nothing.
            rows = []
            if not listing:
                from tidb_tpu_torch.parallel.dcn import clusters_alive

                for cl in clusters_alive():
                    try:
                        rows.extend(cl.reshard_progress_rows())
                    except Exception:  # noqa: BLE001 — a dying
                        continue       # coordinator shows no rows
            return make(
                [("table_name", STRING), ("shard", INT64),
                 ("state", STRING), ("dst_worker", INT64),
                 ("old_version", INT64), ("new_version", INT64),
                 ("workers", INT64), ("draining", INT64)],
                rows,
            )
        if name == "digest_latency":
            # per-digest latency SLO store: sliding-window
            # percentiles + burn ratio against tidb_tpu_slo_target_ms.
            # No listing guard needed: local process memory.
            from tidb_tpu_torch.serving.slo import STORE as _slo_store

            return make(
                [("digest", STRING), ("digest_text", STRING),
                 ("window_n", INT64), ("execs", INT64),
                 ("p50_ms", FLOAT64), ("p95_ms", FLOAT64),
                 ("p99_ms", FLOAT64), ("target_ms", FLOAT64),
                 ("breaches", INT64), ("burn_ratio", FLOAT64),
                 ("last_seen", STRING)],
                _slo_store.rows(),
            )
        if name == "statistics":
            rows = []
            for dbn in sorted(self.databases):
                for tn in sorted(self.databases[dbn].tables):
                    t = self.databases[dbn].tables[tn]
                    for idx in t.indexes.values():
                        for i, cname in enumerate(idx.columns):
                            rows.append((
                                dbn, tn, 0 if idx.unique else 1,
                                idx.name, i + 1, cname,
                            ))
            return make(
                [("table_schema", STRING), ("table_name", STRING),
                 ("non_unique", INT64), ("index_name", STRING),
                 ("seq_in_index", INT64), ("column_name", STRING)],
                rows,
            )
        return None


def _count_reclaimed(out: Dict[str, int]) -> None:
    """MVCC versions a GC pass reclaimed, into tidb_tpu_gc_reclaimed_rows_total."""
    if out:
        from tidb_tpu_torch.utils.metrics import GC_RECLAIMED

        GC_RECLAIMED.inc(sum(out.values()))


def _time_strftime(ts: float) -> str:
    import time

    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts))


_INFO_TABLES = ("schemata", "tables", "columns", "statistics", "slow_query",
                "key_column_usage", "referential_constraints",
                "partitions", "processlist", "statements_summary",
                "cluster_trace", "dcn_worker_stats", "scheduler_stats",
                "plan_feedback", "cluster_metrics", "digest_latency",
                "cluster_info")


def _drop_staged(table) -> None:
    """A dropped temporary table's staged batches leave the device buffer
    cache at once: temp DDL bumps no schema_version, whose setter clears
    the cache for permanent tables. Looked up lazily, as that setter
    does; a delta table's batches are staged from its base table."""
    pipe = sys.modules.get("tidb_tpu_torch.executor.pipeline")
    cache = getattr(pipe, "DEVICE_CACHE", None)
    if cache is None:
        return
    for t in (table, getattr(table, "_base", None)):
        if t is not None:
            cache.drop_table(t)


class SessionCatalog:
    """Per-session overlay adding a TEMPORARY-table namespace over the
    shared catalog (ref: MySQL temporary tables — session-local, shadow
    permanent tables by name, vanish with the connection). Everything
    except table resolution/creation/drop delegates to the base; the
    planner and executors only ever resolve through `table()`, so temp
    tables flow through every downstream path unchanged."""

    def __init__(self, base: "Catalog"):
        while isinstance(base, SessionCatalog):
            base = base._base
        object.__setattr__(self, "_base", base)
        object.__setattr__(self, "_temp", {})  # (db, name) -> Table
        # bumped on every temp create/drop: temp DDL never advances the
        # shared schema_version, so the plan cache keys on this instead
        # (a dropped-and-recreated temp table must never serve the old
        # table object's cached plan)
        object.__setattr__(self, "_temp_epoch", 0)
        object.__setattr__(self, "_viewer", None)  # weakref to Session

    def __getattr__(self, name):
        return getattr(self._base, name)

    def __setattr__(self, name, value):
        # attribute writes always land on the shared base — a proxy-local
        # shadow (e.g. schema_version) would silently fork the catalog
        setattr(self._base, name, value)

    @property
    def base(self) -> "Catalog":
        return self._base

    def table(self, db: str, name: str) -> Table:
        t = self._temp.get((db, name))
        if t is not None:
            return t
        if (db.lower() == "information_schema"
                and name.lower() == "processlist"):
            # viewer-aware: a session without SUPER sees only its own
            # threads, same as SHOW PROCESSLIST
            viewer = self._viewer() if self._viewer is not None else None
            # always returns a Table — never fall through to the
            # base path, whose viewer-less build is unfiltered
            return self._base._info_schema_table(
                "processlist",
                viewer=getattr(viewer, "user", None) or "")
        return self._base.table(db, name)

    def tables(self, db: str):
        out = list(self._base.tables(db))
        out.extend(n for (d, n) in self._temp if d == db and n not in out)
        return out

    def create_temp_table(self, db: str, schema: TableSchema,
                          if_not_exists: bool = False,
                          engine: str = None) -> Table:
        if (db, schema.name) in self._temp:
            if if_not_exists:
                return self._temp[(db, schema.name)]
            raise DuplicateTableError(
                f"temporary table {schema.name!r} exists")
        from tidb_tpu_torch.storage.kvapi import make_table

        t = make_table(schema, engine)
        t.ts_source = self._base.next_ts
        t.txn_guard = self._base
        self._temp[(db, schema.name)] = t
        object.__setattr__(self, "_temp_epoch", self._temp_epoch + 1)
        return t

    def drop_table(self, db: str, name: str, if_exists: bool = False):
        if (db, name) in self._temp:
            _drop_staged(self._temp.pop((db, name)))
            object.__setattr__(self, "_temp_epoch", self._temp_epoch + 1)
            return
        return self._base.drop_table(db, name, if_exists=if_exists)

    def drop_temp_tables(self) -> None:
        """Connection end: the whole temp namespace vanishes."""
        for t in self._temp.values():
            _drop_staged(t)
        self._temp.clear()
        object.__setattr__(self, "_temp_epoch", self._temp_epoch + 1)
