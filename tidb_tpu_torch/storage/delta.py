"""Write-optimized table engine: row memtable over a columnar base (a
copy of tidb_tpu/storage/delta.py).

Ref counterpart: the TiFlash delta-tree shape (and, one level down, the
LSM memtable of the reference's TiKV storage) — fresh writes land in a
cheap row-format buffer; a compaction pass folds them into the
read-optimized columnar base in bulk.

Why it exists here: the columnar `Table` pays per-INSERT costs that are
fine at bulk-load granularity but quadratic for row-at-a-time ingest —
most painfully the sorted-dictionary merge for string columns, which
can remap every existing code whenever one new string arrives. The
delta engine converts each INSERT's values at statement time (so type /
NOT-NULL errors still surface on the right statement), buffers them as
host rows, and compacts into the base with ONE bulk columnar append
(one dictionary merge, one version bump) on the first read or at the
row threshold.

Semantics preserved:
  * visibility — every read path compacts first, so SELECT after INSERT
    (same or different txn) sees the rows with their correct MVCC
    timestamps; buffered txn writes carry their marker and commit /
    rollback rewrites them in place without forcing a compaction;
  * statement-accurate errors — value conversion, NOT NULL, and
    auto-increment assignment happen at buffer time;
  * uniqueness — tables with any unique index (or a primary key) write
    through: deferred unique checks would raise on the wrong statement.

The engine is selected per table: CREATE TABLE ... ENGINE=delta
(`storage.kvapi.make_table`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from tidb_tpu_torch.errors import ExecutionError

# attribute reads that must NOT trigger compaction (schema-shaped or
# engine bookkeeping; everything else sees the post-compaction state)
_PASSTHROUGH = {
    "schema", "indexes", "ts_source", "stats", "ndv_sketch",
    "modify_count", "to_device_value", "engine",
    # schema-derived reads: must not force a compaction per statement
    "insertable_names", "generated", "foreign_keys", "checks",
}

_OWN = {"_base", "_cols", "_ts", "_logs", "_count"}

FLUSH_ROWS = 4096


class DeltaTable:
    """Memtable + columnar base. Conforms to `kvapi.TABLE_ENGINE_API`
    by construction: intercepted writes/txn hooks here, everything else
    delegates to the base `Table` after compaction."""

    engine = "delta"

    def __init__(self, base):
        object.__setattr__(self, "_base", base)
        object.__setattr__(self, "_cols", {})
        object.__setattr__(self, "_ts", [])
        object.__setattr__(self, "_logs", [])  # per-row TableTxnLog or None
        object.__setattr__(self, "_count", 0)

    # -- engine plumbing ---------------------------------------------------

    def __getattr__(self, name):
        base = object.__getattribute__(self, "_base")
        if name not in _PASSTHROUGH:
            self._compact()
        return getattr(base, name)

    def __setattr__(self, name, value):
        if name in _OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(self._base, name, value)

    @property
    def buffered_rows(self) -> int:
        """Rows in the memtable (diagnostics / tests)."""
        return self._count

    def maintenance_stats(self):
        """Threshold probe WITHOUT compaction: buffered rows are live
        rows-to-be; the base's dead count is unaffected by the buffer."""
        base = self._base
        return base.n + self._count, base.n - base.live_rows

    @property
    def modify_count(self) -> int:
        """Auto-analyze churn including still-buffered rows (they ARE
        modifications; compaction moves the count into the base)."""
        return self._base.modify_count + self._count

    def _bufferable(self) -> bool:
        # deferred unique/FK enforcement would raise on the wrong
        # statement; constrained tables write through
        base = self._base
        return not (any(ix.unique for ix in base.indexes.values())
                    or base.foreign_keys or base.referencing
                    or base.checks)

    # -- write surface -----------------------------------------------------

    def insert_rows(self, rows, columns=None, begin_ts=None, log=None) -> int:
        base = self._base
        if not self._bufferable():
            self._compact()
            return base.insert_rows(rows, columns=columns,
                                    begin_ts=begin_ts, log=log)
        names = columns or base.insertable_names()
        cols = [base.schema.col(n) for n in names]
        m = len(rows)
        if m == 0:
            return 0
        provided = {c.name for c in cols}
        buf = self._cols
        if not buf:
            for c in base.schema.columns:
                buf[c.name] = []
        # convert at statement time: type and NOT NULL errors surface on
        # THIS statement, exactly like the write-through path. A failed
        # conversion must leave the buffer untouched.
        staged: Dict[str, List] = {c.name: [] for c in base.schema.columns}
        for c in base.schema.columns:
            if c.name in provided:
                continue
            if c.auto_increment:
                staged[c.name] = list(range(base._auto_inc, base._auto_inc + m))
            elif c.default is not None:
                staged[c.name] = [base.to_device_value(c, c.default)] * m
            elif c.not_null and not any(
                    g.col == c.name for g in base.generated):
                raise ExecutionError(
                    f"column {c.name!r} has no default and is NOT NULL")
            else:
                # NULL, or a generated column computed at compaction
                staged[c.name] = [None] * m
        for j, (name, c) in enumerate(zip(names, cols)):
            vals = [base.to_device_value(c, r[j]) for r in rows]
            if c.not_null and any(v is None for v in vals):
                raise ExecutionError(f"NULL in NOT NULL column {c.name!r}")
            staged[name] = vals
        # conversion succeeded: commit the batch to the memtable
        for c in base.schema.columns:
            buf[c.name].extend(staged[c.name])
        for c in base.schema.columns:
            if c.auto_increment and c.name not in provided:
                base._auto_inc += m
        ts = base._next_ts() if begin_ts is None else begin_ts
        self._ts.extend([ts] * m)
        self._logs.extend([log] * m)
        self._count += m
        if self._count >= FLUSH_ROWS:
            self._compact()
        return m

    # -- txn lifecycle (buffered rows keep their markers) ------------------

    def txn_commit(self, marker: int, commit_ts: int, log=None) -> None:
        if self._count:
            # committed rows no longer belong to an open txn log
            self._logs = [None if t == marker else lg
                          for t, lg in zip(self._ts, self._logs)]
            self._ts = [commit_ts if t == marker else t for t in self._ts]
        if log is not None and not log.ranges and not log.ended:
            # the txn's writes live entirely in the memtable: nothing of
            # this marker reached the base, and skipping the call keeps
            # base.version (and every cache keyed on it) stable across
            # buffered-only commits
            return
        self._base.txn_commit(marker, commit_ts, log=log)

    def txn_rollback(self, marker: int, log=None) -> None:
        if self._count:
            keep = [i for i, t in enumerate(self._ts) if t != marker]
            if len(keep) != self._count:
                for name, vals in self._cols.items():
                    self._cols[name] = [vals[i] for i in keep]
                self._ts = [self._ts[i] for i in keep]
                self._logs = [self._logs[i] for i in keep]
                self._count = len(keep)
        if log is not None and not log.ranges and not log.ended:
            return
        self._base.txn_rollback(marker, log=log)

    def truncate(self):
        self._cols = {}
        self._ts = []
        self._logs = []
        self._count = 0
        return self._base.truncate()

    # -- compaction --------------------------------------------------------

    def _compact(self) -> None:
        """Fold the memtable into the columnar base: one bulk append,
        one dictionary merge per string column, one version bump."""
        if not self._count:
            return
        base = self._base
        arrays: Dict[str, np.ndarray] = {}
        valids: Dict[str, np.ndarray] = {}
        strings: Dict[str, List[Optional[str]]] = {}
        m = self._count
        for c in base.schema.columns:
            vals = self._cols[c.name]
            if c.type_.is_dict_encoded:
                strings[c.name] = vals
                continue
            vd = np.array([v is not None for v in vals], dtype=np.bool_)
            arr = np.zeros(m, dtype=c.type_.np_dtype)
            if vd.any():
                arr[vd] = [v for v in vals if v is not None]
            arrays[c.name] = arr
            valids[c.name] = vd
        ts = np.array(self._ts, dtype=np.int64)
        logs = self._logs
        self._cols = {}
        self._ts = []
        self._logs = []
        self._count = 0
        base.insert_columns(arrays, valids, strings=strings)
        start = base.n - m
        # bulk appends stamp "committed at origin"; restore each row's
        # real timestamp (commit ts or still-open txn marker)
        base.begin_ts[start: base.n] = ts
        # rows buffered under an OPEN txn log must register their base
        # ranges NOW: the txn's later commit/rollback walks log.ranges to
        # rewrite markers, and an unlogged compacted row would keep its
        # provisional marker forever (committed data silently vanishing)
        i = 0
        while i < m:
            j = i
            while j < m and logs[j] is logs[i]:
                j += 1
            if logs[i] is not None:
                logs[i].ranges.append((start + i, start + j))
                # the version-window cache-carry optimization assumes
                # ranges were appended at their own version bumps;
                # a compaction batches them — disable it conservatively
                logs[i].contiguous = False
            i = j
        # memtable DML counts toward the auto-analyze churn trigger
        base.modify_count += m
