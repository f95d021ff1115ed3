"""Host columnar tables (a trimmed copy of tidb_tpu/storage/table.py).

Layout decisions (device-first):
  * column-major numpy buffers in the device representation already
    (scaled ints, day counts, dict codes) so staging to the card is a
    straight tensor copy of a slice — no row pivots on the hot path
  * appends grow buffers geometrically
  * each string column owns a sorted Dictionary; appends that introduce new
    strings re-encode the column
  * `version` bumps on every mutation; `data_epoch` when existing rows
    are rewritten in place (the dictionary re-encode)
  * MVCC visibility per physical row: `begin_ts`/`end_ts`, read through
    `live_mask`

  * unique indexes (PRIMARY from `schema.primary_key`, UNIQUE KEY,
    CREATE UNIQUE INDEX) are enforced on every write; point and range
    lookups binary-search a sorted (key, row) cache rebuilt per version
  * MVCC writes: DELETE ends rows at a commit ts or a txn marker, UPDATE
    ends the old versions and appends new ones; commit/rollback rewrite
    the markers of the rows a `TableTxnLog` recorded

Not yet ported (the next slice): foreign keys, CHECK constraints,
generated columns, partitions, pessimistic row locks (FOR UPDATE),
online DDL, ANALYZE's NDV sketches and CLUSTER BY recluster. Their hooks
sit where the reference calls them, marked "next slice".
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from tidb_tpu_torch.chunk.dictionary import Dictionary
from tidb_tpu_torch.errors import (
    ExecutionError,
    SchemaError,
    TypeError_,
    WriteConflictError,
)
from tidb_tpu_torch.types import (
    SQLType,
    TypeKind,
    date_to_days,
    datetime_to_micros,
    decimal_to_scaled,
)

__all__ = ["ColumnInfo", "TableSchema", "Table", "TableTxnLog", "IndexInfo",
           "TXN_TS_BASE", "MAX_TS"]


@dataclass
class TableTxnLog:
    """Rows one transaction touched in one table, so commit/rollback cost
    O(rows written) not O(table) (ref: the txn's memdb buffer keying the
    2PC mutations)."""

    ranges: List[tuple] = field(default_factory=list)  # appended [start,end)
    ended: List[np.ndarray] = field(default_factory=list)  # end_ts-stamped ids
    # commit-time cache-merge bookkeeping (Table._log_mark): table version
    # before this txn's first logged write, version after its last one,
    # and whether every bump in between was this txn's own
    vstart: int = -1
    vlast: int = -1
    contiguous: bool = True


@dataclass
class ColumnInfo:
    name: str
    type_: SQLType
    not_null: bool = False
    default: object = None
    auto_increment: bool = False
    # the DDL's declared type text (e.g. "varchar(20)") — SQLType erases
    # display-only details like string lengths; SHOW CREATE TABLE needs
    # them back verbatim
    type_text: Optional[str] = None
    # string collation (ref: MySQL per-column collations); None means the
    # MySQL-compatible default (utf8mb4_general_ci — case-insensitive)
    collation: Optional[str] = None
    # online-DDL schema state (ref: the none→delete-only→write-only→
    # public state machine, SURVEY.md:180-185): "write_only" columns are
    # invisible to reads (star expansion, positional INSERT width) but
    # default-filled on writes, so an instance one schema version behind
    # still writes correct rows during ADD COLUMN
    state: str = "public"

    @property
    def coll(self) -> str:
        from tidb_tpu_torch.chunk.dictionary import DEFAULT_COLLATION

        return self.collation or DEFAULT_COLLATION


@dataclass
class IndexInfo:
    """Secondary index metadata. Unique indexes are ENFORCED on every
    write (ref: the reference's index KV records + unique-key checks);
    the columnar engine scans by mask, so the index's query-side role is
    the constraint, plus a lazily built sorted lookup for point and
    range access."""

    name: str
    columns: List[str]
    unique: bool = False
    # next slice: online DDL's index state ("write_only": maintained and
    # enforced on writes, invisible to the planner's access paths)


@dataclass
class TableSchema:
    name: str
    columns: List[ColumnInfo]
    primary_key: Optional[List[str]] = None
    # table default COLLATE (applied to columns that declare none)
    collation: Optional[str] = None
    # PARTITION BY / SHARD BY metadata: not yet ported, always None
    partition: Optional[object] = None
    shard_by: Optional[object] = None
    # CLUSTER BY column: recorded for the columnar store, which is not yet
    # ported; scans read rows in ingest order
    cluster_by: Optional[str] = None

    def col(self, name: str) -> ColumnInfo:
        for c in self.columns:
            if c.name == name:
                return c
        raise SchemaError(f"no column {name!r} in table {self.name!r}")

    def names(self) -> List[str]:
        return [c.name for c in self.columns]

    def public_columns(self) -> List[ColumnInfo]:
        """Columns visible to reads (online-DDL write_only excluded)."""
        return [c for c in self.columns if c.state == "public"]

    def public_names(self) -> List[str]:
        return [c.name for c in self.public_columns()]


_GROW = 1.5
_MIN_CAP = 1024


def _key_order(mat: np.ndarray) -> np.ndarray:
    """Stable order of the rows of an int64 key matrix, first column most
    significant: the order a stable sort of its structured view gives
    (the reference sorts the view; np.lexsort over the columns is the
    same order and several times faster at millions of rows)."""
    if mat.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    return np.lexsort(mat.T[::-1])

# MVCC timestamps: committed rows carry ts < TXN_TS_BASE; an open
# transaction stamps its provisional writes with marker = TXN_TS_BASE +
# txn_id (greater than every possible read_ts, so invisible to others —
# and, sitting in end_ts, an effective row lock). MAX_TS = "not deleted".
TXN_TS_BASE = 1 << 60
MAX_TS = 1 << 62


class Table:
    """Append-friendly columnar store for one table."""

    engine = "columnar"

    def __init__(self, schema: TableSchema):
        self.schema = schema
        self.n = 0  # physical rows incl. dead versions
        self.version = 0
        # bumps whenever EXISTING physical rows' data/valid buffers are
        # rewritten in place (the dictionary-growth re-encode; appends and
        # MVCC timestamp changes don't count). The columnar segment store
        # snapshots row-range payloads and rebuilds on any epoch move;
        # `version` alone moves on every DML and cannot tell an append
        # from a rewrite.
        self.data_epoch = 0
        # the columnar segment store (tidb_tpu_torch/columnar/store.py),
        # made by the first scan once the table holds a segment of rows
        self._segment_store = None
        self._auto_inc = 1
        self._local_ts = 0  # fallback TSO for catalog-less tables
        self.ts_source = None  # catalog-provided TSO (set by create_table)
        cap = _MIN_CAP
        self._cap = cap
        self.data: Dict[str, np.ndarray] = {}
        self.valid: Dict[str, np.ndarray] = {}
        self.dicts: Dict[str, Dictionary] = {}
        for c in schema.columns:
            self.data[c.name] = np.zeros(cap, dtype=c.type_.np_dtype)
            self.valid[c.name] = np.zeros(cap, dtype=np.bool_)
            if c.type_.is_dict_encoded:
                self.dicts[c.name] = Dictionary([], c.coll)
        # MVCC visibility range per physical row (see TXN_TS_BASE above)
        self.begin_ts = np.zeros(cap, dtype=np.int64)
        self.end_ts = np.full(cap, MAX_TS, dtype=np.int64)
        self.indexes: Dict[str, IndexInfo] = {}
        if schema.primary_key:
            # the primary key IS a unique index and is ENFORCED like one
            # (ref: the clustered index / unique-key checks on write)
            self.indexes["PRIMARY"] = IndexInfo(
                "PRIMARY", list(schema.primary_key), unique=True)
        # per-unique-index sorted key cache: name -> (version, keys);
        # fresh only across pure inserts, rebuilt lazily otherwise
        self._uniq_cache: Dict[str, tuple] = {}
        self._uniq_pending: Dict[str, np.ndarray] = {}
        # point-lookup cache: index name -> (version, sorted keys, rows)
        self._lookup_cache: Dict[str, tuple] = {}
        # rows provisionally ended per open txn marker (REPLACE/upsert
        # re-insert freedom + O(dead) instead of O(n) scans)
        self._txn_dead: Dict[int, list] = {}

    def _next_ts(self) -> int:
        if self.ts_source is not None:
            return self.ts_source()
        self._local_ts += 1
        return self._local_ts

    # -- row count ---------------------------------------------------------

    @property
    def live_rows(self) -> int:
        """Committed-latest row count (provisional writes excluded)."""
        if self.n == 0:
            return 0
        b = self.begin_ts[: self.n]
        e = self.end_ts[: self.n]
        return int(((b < TXN_TS_BASE) & (e >= TXN_TS_BASE)).sum())

    def maintenance_stats(self):
        """(physical_rows, dead_rows) for the auto-GC threshold."""
        return self.n, self.n - self.live_rows

    def _ensure(self, extra: int):
        need = self.n + extra
        if need <= self._cap:
            return
        cap = max(int(self._cap * _GROW), need, _MIN_CAP)
        for name in self.data:
            self.data[name] = np.resize(self.data[name], cap)
            self.data[name][self.n:] = 0
            self.valid[name] = np.resize(self.valid[name], cap)
            self.valid[name][self.n:] = False
        self.begin_ts = np.resize(self.begin_ts, cap)
        self.begin_ts[self.n:] = 0
        self.end_ts = np.resize(self.end_ts, cap)
        self.end_ts[self.n:] = MAX_TS
        self._cap = cap

    # -- ingestion ---------------------------------------------------------

    def to_device_value(self, col: ColumnInfo, v):
        """Host python value -> device representation scalar."""
        import datetime

        if v is None:
            return None
        k = col.type_.kind
        try:
            if k == TypeKind.INT:
                return int(v)
            if k == TypeKind.FLOAT:
                return float(v)
            if k == TypeKind.BOOL:
                return bool(v)
            if k == TypeKind.DECIMAL:
                return decimal_to_scaled(v, col.type_.scale)
            if k == TypeKind.DATE:
                if isinstance(v, str):
                    v = datetime.date.fromisoformat(v)
                return date_to_days(v)
            if k == TypeKind.DATETIME:
                if isinstance(v, str):
                    v = datetime.datetime.fromisoformat(v)
                return datetime_to_micros(v)
            if k == TypeKind.TIME:
                from tidb_tpu_torch.types import time_to_micros

                return time_to_micros(v)
            if k == TypeKind.ENUM:
                members = col.type_.members
                if isinstance(v, int):  # 1-based index form
                    if not 1 <= v <= len(members):
                        raise ValueError(f"ENUM index {v} out of range")
                    return v
                try:
                    return members.index(str(v)) + 1
                except ValueError:
                    raise ValueError(f"unknown ENUM member {v!r}")
            if k == TypeKind.SET:
                from tidb_tpu_torch.types import set_to_mask

                return set_to_mask(v, list(col.type_.members))
            if k in (TypeKind.STRING, TypeKind.JSON):
                return str(v)  # encoded in bulk by insert_rows
        except (ValueError, TypeError) as e:
            raise TypeError_(f"bad value {v!r} for column {col.name}: {e}")
        raise TypeError_(f"unsupported type {col.type_}")

    def insert_rows(self, rows: Sequence[Sequence], columns: Optional[List[str]] = None,
                    begin_ts: Optional[int] = None,
                    log: Optional["TableTxnLog"] = None) -> int:
        """Insert python rows (already in logical form; strings as str,
        dates as date/str, decimals as str/float). Returns rows inserted.
        begin_ts: commit timestamp, or a txn marker for provisional writes;
        None commits immediately at the next TSO tick."""
        # positional inserts carry the PUBLIC column width: a writer one
        # schema version behind an in-flight ADD COLUMN (write_only)
        # supplies the old shape and the new column default-fills below
        names = columns or self.insertable_names()
        cols = [self.schema.col(n) for n in names]
        m = len(rows)
        if m == 0:
            return 0
        self._ensure(m)
        start, end = self.n, self.n + m
        provided = set(names)
        # columns not provided get default/NULL/auto-inc
        for c in self.schema.columns:
            if c.name in provided:
                continue
            if c.auto_increment:
                vals = np.arange(self._auto_inc, self._auto_inc + m, dtype=np.int64)
                self._auto_inc += m
                self.data[c.name][start:end] = vals
                self.valid[c.name][start:end] = True
            elif c.default is not None:
                dv = self.to_device_value(c, c.default)
                if c.type_.is_dict_encoded:
                    self._append_strings(c.name, [dv] * m, start, end)
                else:
                    self.data[c.name][start:end] = dv
                    self.valid[c.name][start:end] = True
            elif c.not_null:
                raise ExecutionError(f"column {c.name!r} has no default and is NOT NULL")
            # else: stays NULL
        for j, (name, c) in enumerate(zip(names, cols)):
            vals = [self.to_device_value(c, r[j]) for r in rows]
            if any(v is None for v in vals) and c.not_null:
                raise ExecutionError(f"NULL in NOT NULL column {c.name!r}")
            if c.type_.is_dict_encoded:
                self._append_strings(name, vals, start, end)
            else:
                arr = self.data[name]
                vd = self.valid[name]
                for i, v in enumerate(vals):
                    if v is None:
                        vd[start + i] = False
                    else:
                        arr[start + i] = v
                        vd[start + i] = True
        # marker exclusion (rows this txn deleted don't conflict) costs an
        # O(n) end_ts scan — only pay it when the txn actually deleted
        # something in this table (REPLACE / upsert flows)
        in_txn = begin_ts is not None and begin_ts >= TXN_TS_BASE
        txn_deleted = log is not None and bool(log.ended)
        # next slice: generated columns (_apply_generated) compute here
        self._enforce_unique_new(
            start, end, marker=begin_ts if in_txn and txn_deleted else None)
        # next slice: FK parents, CHECK constraints and the partition
        # bound (_check_fk_parents, _check_row_constraints,
        # _check_partition) validate here
        # before n advances: a violation leaves the table untouched
        self.begin_ts[start:end] = self._next_ts() if begin_ts is None else begin_ts
        self.end_ts[start:end] = MAX_TS
        self.n = end
        if log is not None:
            log.ranges.append((start, end))
        self.version += 1
        if log is not None:
            self._log_mark(log)
        self._uniq_commit()
        return m

    def insert_columns(self, arrays: Dict[str, np.ndarray], valids: Optional[Dict[str, np.ndarray]] = None, strings: Optional[Dict[str, list]] = None):
        """Bulk columnar ingest (datagen / LOAD). `arrays` hold device reprs
        for non-string columns; `strings` holds raw python strings per
        string column."""
        sizes = [len(a) for a in arrays.values()] + [len(s) for s in (strings or {}).values()]
        if not sizes:
            return 0
        m = sizes[0]
        if any(s != m for s in sizes):
            raise ExecutionError(f"bulk insert length mismatch: {sizes}")
        self._ensure(m)
        start, end = self.n, self.n + m
        for c in self.schema.columns:
            name = c.name
            if strings and name in strings:
                self._append_strings(name, strings[name], start, end)
            elif name in arrays:
                self.data[name][start:end] = arrays[name].astype(c.type_.np_dtype, copy=False)
                if valids and name in valids:
                    self.valid[name][start:end] = valids[name]
                else:
                    self.valid[name][start:end] = True
            elif c.not_null:
                raise ExecutionError(f"bulk insert missing NOT NULL column {name!r}")
        self._enforce_unique_new(start, end)
        self.begin_ts[start:end] = 0  # bulk loads are committed "at origin"
        self.end_ts[start:end] = MAX_TS
        self.n = end
        self.version += 1
        self._uniq_commit()
        return m

    def ingest_encoded(self, arrays: Dict[str, np.ndarray],
                       pools: Dict[str, list]) -> int:
        """Bulk ingest with PRE-ENCODED dictionary codes (the native
        data-loader path): string columns arrive as int codes indexing
        their sorted unique `pools` entry; no Python string objects are
        materialized for the rows. Table must be empty."""
        if self.n:
            raise ExecutionError("encoded ingest requires an empty table")
        sizes = {len(a) for a in arrays.values()}
        if len(sizes) != 1:
            raise ExecutionError(f"encoded ingest length mismatch: {sizes}")
        m = sizes.pop()
        self._ensure(m)
        for c in self.schema.columns:
            name = c.name
            if name in pools:
                pool = pools[name]
                if sorted(set(pool)) != list(pool):
                    raise ExecutionError(
                        f"pool for {name!r} must be sorted and unique")
                codes = arrays.get(name)
                if codes is not None and len(codes) and (
                        codes.min() < 0 or codes.max() >= len(pool)):
                    raise ExecutionError(
                        f"codes for {name!r} outside [0, {len(pool)})")
                d = Dictionary(pool, c.coll)
                self.dicts[name] = d
                if codes is not None and d.values != list(pool):
                    # a _ci collation reorders the bytewise pool: remap
                    # the pre-encoded codes onto the collation order
                    remap = np.array([d._index[v] for v in pool],
                                     dtype=np.int32)
                    arrays[name] = remap[codes]
            if name in arrays:
                self.data[name][:m] = arrays[name].astype(
                    c.type_.np_dtype, copy=False)
                self.valid[name][:m] = True
            elif c.not_null:
                raise ExecutionError(f"encoded ingest missing NOT NULL {name!r}")
        self._enforce_unique_new(0, m)
        self.begin_ts[:m] = 0
        self.end_ts[:m] = MAX_TS
        self.n = m
        self.version += 1
        self._uniq_commit()
        return m

    def _append_strings(self, name: str, vals: list, start: int, end: int):
        d = self.dicts[name]
        new = {v for v in vals if v is not None and v not in d}
        if new:
            # dictionary grows: build union dict and re-encode existing codes
            nd = Dictionary(list(d.values) + list(new), d.collation)
            if self.n > 0 and len(d) > 0:
                trans = d.translate_to(nd)
                self.data[name][: self.n] = trans[self.data[name][: self.n]]
            self.dicts[name] = nd
            d = nd
            # re-encoding is a physical change: structures keyed on
            # version must see it now, and segments holding the old codes
            # must rebuild
            self.version += 1
            self.data_epoch += 1  # existing codes rewrote in place
        codes, valid = d.encode_with(vals)
        self.data[name][start:end] = codes
        self.valid[name][start:end] = valid

    # -- mutation ----------------------------------------------------------

    def _writable_mask(self, ids: np.ndarray, marker: int) -> np.ndarray:
        """Mask over `ids` this write may stamp: rows already ended by
        another txn's marker (lock conflict) or by a commit (optimistic
        conflict) raise; rows already ended by OUR marker are skipped.
        (next slice: rows pessimistically locked by another txn with
        FOR UPDATE/SHARE conflict here too.)"""
        in_bounds = (ids >= 0) & (ids < self.n)
        clipped = np.clip(ids, 0, max(self.n - 1, 0))
        cur = np.where(in_bounds, self.end_ts[clipped], MAX_TS)
        ours = cur == marker if marker else np.zeros(len(ids), dtype=np.bool_)
        blocked = (cur != MAX_TS) & ~ours & in_bounds
        # another txn's UNCOMMITTED insert is a lock too: its end_ts is
        # still MAX_TS, but its begin_ts marker makes it untouchable
        bts = np.where(in_bounds, self.begin_ts[clipped], 0)
        blocked |= (bts >= TXN_TS_BASE) & (bts != marker) & in_bounds
        if blocked.any():
            raise WriteConflictError(
                "write conflict: row modified by another transaction "
                f"(table {self.schema.name!r})"
            )
        return in_bounds & ~ours

    def delete_rows(self, row_ids: np.ndarray, end_ts: Optional[int] = None,
                    marker: int = 0, log: Optional["TableTxnLog"] = None) -> int:
        """End rows' visibility at end_ts (a commit ts, or a txn marker for
        provisional deletes). Returns count newly deleted."""
        ids = np.asarray(row_ids, dtype=np.int64)
        ids = ids[self._writable_mask(ids, marker)]
        # next slice: the FK children's referential actions
        # (_check_fk_children) run here, their writes joining the
        # caller's transaction through a map of child tables to txn logs
        self.end_ts[ids] = self._next_ts() if end_ts is None else end_ts
        if end_ts is not None and end_ts >= TXN_TS_BASE and len(ids):
            self._txn_dead.setdefault(end_ts, []).extend(ids.tolist())
        if log is not None:
            log.ended.append(ids)
        self.version += 1
        if log is not None:
            self._log_mark(log)
        return len(ids)

    def update_rows(self, row_ids: np.ndarray, updates: Dict[str, list],
                    begin_ts: Optional[int] = None, end_ts: Optional[int] = None,
                    marker: int = 0, log: Optional["TableTxnLog"] = None) -> int:
        """MVCC update: end the old row versions and append new versions
        carrying the updated values (ref: TiDB writes a new MVCC version
        per update; here the version chain is physical-row append)."""
        ids = np.asarray(row_ids, dtype=np.int64)
        keep = self._writable_mask(ids, marker)
        ids = ids[keep]
        m = len(ids)
        if m == 0:
            return 0
        # convert values BEFORE mutating any state: a bad value must leave
        # the table untouched, or an explicit txn could commit half a row
        converted: Dict[str, list] = {}
        for name, vals in updates.items():
            c = self.schema.col(name)
            vals = [v for v, k in zip(vals, keep) if k]
            if c.type_.is_dict_encoded:
                converted[name] = [None if v is None else str(v) for v in vals]
            else:
                converted[name] = [
                    None if v is None else self.to_device_value(c, v) for v in vals
                ]

        if begin_ts is None and end_ts is None:
            begin_ts = end_ts = self._next_ts()

        # write the new versions into buffer slots FIRST (n not advanced,
        # old versions not ended): a unique violation must leave the
        # table untouched
        self._ensure(m)
        start, end = self.n, self.n + m
        for name in self.data:
            self.data[name][start:end] = self.data[name][ids]
            self.valid[name][start:end] = self.valid[name][ids]
        # overwrite the updated columns in the new versions
        for name, vals in converted.items():
            c = self.schema.col(name)
            if c.type_.is_dict_encoded:
                self._append_strings(name, vals, start, end)
            else:
                for i, v in zip(range(start, end), vals):
                    if v is None:
                        self.valid[name][i] = False
                    else:
                        self.data[name][i] = v
                        self.valid[name][i] = True
        # next slice: generated columns (_apply_generated) compute here
        if any(ix.unique for ix in self.indexes.values()):
            # the replaced versions don't count as present for uniqueness;
            # full-scan check (the incremental cache can't express the
            # simultaneous remove+add of an update). Rejected slots clear
            # their valid bits so stale values never resurrect.
            saved = self.end_ts[ids].copy()
            self.end_ts[ids] = 0
            try:
                for ix in self.indexes.values():
                    if ix.unique:
                        self._check_unique(ix, extra=(start, end), marker=end_ts if end_ts >= TXN_TS_BASE else None)
            except ExecutionError:
                for name in self.valid:
                    self.valid[name][start:end] = False
                raise
            finally:
                self.end_ts[ids] = saved

        # next slice: FK parents, CHECK constraints, the partition bound
        # and ON UPDATE RESTRICT children validate the new versions here
        self.end_ts[ids] = end_ts
        if end_ts >= TXN_TS_BASE and m:
            self._txn_dead.setdefault(end_ts, []).extend(ids.tolist())
        self.begin_ts[start:end] = begin_ts
        self.end_ts[start:end] = MAX_TS
        self.n = end
        if log is not None:
            log.ended.append(ids)
            log.ranges.append((start, end))
        self.version += 1
        if log is not None:
            self._log_mark(log)
        # next slice: ON UPDATE CASCADE / SET NULL children run here, after
        # the new parent keys are visible
        return m

    def _log_mark(self, log: "TableTxnLog") -> None:
        """Called right after each logged mutation's version bump.
        Records the version window this txn's writes span so txn_commit
        can tell whether a point-lookup cache predates the txn (safe to
        merge the new rows into) or postdates its last write (already
        complete). `contiguous` survives only if every bump since
        `vstart` was this txn's own — a foreign bump (another writer,
        GC compaction moving physical ids) disables merging."""
        if log.vstart < 0:
            log.vstart = self.version - 1
        elif log.vlast != self.version - 1:
            log.contiguous = False
        log.vlast = self.version

    def txn_commit(self, marker: int, commit_ts: int,
                   log: Optional["TableTxnLog"] = None) -> None:
        """Rewrite this txn's markers to the commit timestamp. With a log,
        only the logged rows are touched (O(rows written)); without one,
        the full version arrays are scanned."""
        self._txn_dead.pop(marker, None)
        vbefore = self.version
        if log is not None:
            for s, e in log.ranges:
                b = self.begin_ts[s:e]
                b[b == marker] = commit_ts
            for ids in log.ended:
                e_ = self.end_ts[ids]
                self.end_ts[ids] = np.where(e_ == marker, commit_ts, e_)
        else:
            b = self.begin_ts[: self.n]
            e = self.end_ts[: self.n]
            bm = b == marker
            em = e == marker
            if not bm.any() and not em.any():
                return  # no residue here: don't invalidate caches
            b[bm] = commit_ts
            e[em] = commit_ts
        self.version += 1
        if log is not None and not log.ended:
            # a pure-insert commit doesn't change the present key set:
            # carry fresh unique caches forward so autocommit insert
            # workloads keep the O(m log n) merge path instead of
            # re-sorting the table every statement
            for name, (v, keys) in list(self._uniq_cache.items()):
                if v == vbefore:
                    self._uniq_cache[name] = (self.version, keys)
            # point-lookup caches: one built AFTER this txn's last write
            # (v == vbefore — inserts bump version at write time, and
            # index_lookup rebuilds from all physical rows, so it already
            # holds the new ids) is complete — carry it forward untouched;
            # merging it back in would duplicate the new rows on every
            # subsequent point get. One built just BEFORE the txn's first
            # write (v == vstart, with no foreign bump in the window —
            # _log_mark's contiguity proof) predates the new physical
            # positions: MERGE them in, O(m log n + n) memcpy instead of
            # a full re-sort on the next probe (autocommit insert path).
            if self._lookup_cache:
                new_ids = (np.concatenate([np.arange(s, e) for s, e in log.ranges])
                           if log.ranges else np.zeros(0, dtype=np.int64))
                mergeable = (log.contiguous and log.vstart >= 0
                             and log.vlast == vbefore)
                for name, hit in list(self._lookup_cache.items()):
                    v, skeys, srows = hit
                    idx = self.indexes.get(name)
                    if idx is None:
                        del self._lookup_cache[name]
                        continue
                    if v == vbefore:
                        # commit only rewrites timestamps, not keys/rows
                        self._lookup_cache[name] = (self.version, skeys, srows)
                        continue
                    if not (mergeable and v == log.vstart):
                        continue  # stale: next probe rebuilds
                    mat, ids = self._uniq_key_rows(idx, new_ids)
                    add = np.ascontiguousarray(mat).view(skeys.dtype).reshape(-1)
                    order = np.argsort(add, kind="stable")
                    add, ids = add[order], ids[order]
                    pos = np.searchsorted(skeys, add)
                    self._lookup_cache[name] = (
                        self.version,
                        np.insert(skeys, pos, add),
                        np.insert(srows, pos, ids),
                    )

    def txn_rollback(self, marker: int, log: Optional["TableTxnLog"] = None) -> None:
        """Discard provisional writes; restore provisional deletes."""
        self._txn_dead.pop(marker, None)
        if log is not None:
            # restore deletes first; then kill inserted versions (a row both
            # inserted and deleted by this txn must end up dead)
            for ids in log.ended:
                e_ = self.end_ts[ids]
                self.end_ts[ids] = np.where(e_ == marker, MAX_TS, e_)
            for s, e in log.ranges:
                b = self.begin_ts[s:e]
                dead = b == marker
                self.end_ts[s:e][dead] = 0
                b[dead] = 0
        else:
            b = self.begin_ts[: self.n]
            e = self.end_ts[: self.n]
            dead = b == marker
            # rows both inserted and deleted by this txn must end dead:
            # only restore provisional deletes of rows we didn't insert
            em = (e == marker) & ~dead
            if not dead.any() and not em.any():
                return  # no residue here: don't invalidate caches
            e[dead] = 0
            b[dead] = 0
            e[em] = MAX_TS
        self.version += 1

    # -- indexes -----------------------------------------------------------

    def create_index(self, name: str, columns: List[str],
                     unique: bool = False) -> None:
        for c in columns:
            self.schema.col(c)  # raises if absent
        if name in self.indexes:
            raise SchemaError(f"duplicate index {name!r}")
        idx = IndexInfo(name=name, columns=list(columns), unique=unique)
        if unique:
            # next slice: online DDL's write_only index defers this
            # existing-row validation to its backfill stage
            self._check_unique(idx)
        self.indexes[name] = idx
        self.version += 1

    def drop_index(self, name: str) -> None:
        if name not in self.indexes:
            raise SchemaError(f"no index {name!r}")
        del self.indexes[name]
        self.version += 1

    def _present_mask(self) -> np.ndarray:
        """Rows that exist for constraint purposes: every version not yet
        ended by a commit (includes provisional writes and rows under a
        txn's delete marker — conservative, like InnoDB's locked checks)."""
        return self.end_ts[: self.n] >= TXN_TS_BASE

    def _uniq_key_rows(self, idx: IndexInfo, sel: np.ndarray):
        """(int64 key matrix, surviving row ids) at positions `sel`;
        rows with any NULL key column are dropped (MySQL: NULLs never
        conflict). The single source of index-key encoding — the unique
        checks, conflict maps, and point lookups all go through it."""
        ok = np.ones(len(sel), dtype=np.bool_)
        cols = []
        for cname in idx.columns:
            d = self.data[cname][sel]
            v = self.valid[cname][sel]
            ok &= v
            dic = self.dicts.get(cname)
            if dic is not None and dic.is_ci:
                # fold-class representative: 'abc' and 'ABC' must collide
                # in a unique index under a _ci collation (MySQL)
                lut = dic.canon_lut()
                d = lut[np.clip(d.astype(np.int64), 0, max(len(lut) - 1, 0))] \
                    if len(lut) else d
            if np.issubdtype(d.dtype, np.floating):
                d = d.astype(np.float64).view(np.int64)
            cols.append(d.astype(np.int64))
        mat = np.stack(cols, axis=1)[ok] if cols else np.zeros((0, 0), np.int64)
        return mat, sel[ok]

    def _uniq_keys_at(self, idx: IndexInfo, sel: np.ndarray,
                      sort: bool = False) -> np.ndarray:
        """Key rows at `sel` as a sortable structured array (sorted when
        `sort`)."""
        mat, _ids = self._uniq_key_rows(idx, sel)
        if sort:
            mat = mat[_key_order(mat)]
        dt = np.dtype([(f"k{i}", np.int64) for i in range(len(idx.columns))])
        return np.ascontiguousarray(mat).view(dt).reshape(-1)

    def index_key_at(self, idx: IndexInfo, rid: int):
        """One physical row's key tuple for `idx`, or None (NULL key)."""
        mat, ids = self._uniq_key_rows(idx, np.array([rid], dtype=np.int64))
        if len(ids) == 0:
            return None
        return tuple(mat[0].tolist())

    def _sorted_index(self, idx_name: str):
        """Sorted (keys, row ids) for `idx_name`, cached per version —
        the shared substrate of point and range index access."""
        idx = self.indexes[idx_name]
        hit = self._lookup_cache.get(idx_name)
        if hit is None or hit[0] != self.version:
            all_rows = np.arange(self.n, dtype=np.int64)
            mat, ids = self._uniq_key_rows(idx, all_rows)
            dt = np.dtype([(f"k{i}", np.int64) for i in range(len(idx.columns))])
            order = _key_order(mat)
            keys = np.ascontiguousarray(mat[order]).view(dt).reshape(-1)
            hit = (self.version, keys, ids[order])
            self._lookup_cache[idx_name] = hit
        return hit[1], hit[2]

    def _mvcc_mask(self, cand: np.ndarray, read_ts=None,
                   marker: int = 0) -> np.ndarray:
        """Visibility mask over candidate physical rows at `read_ts`
        (own-txn writes included via `marker`)."""
        b = self.begin_ts[cand]
        e = self.end_ts[cand]
        if read_ts is None:
            keep = (b < TXN_TS_BASE) & (e >= TXN_TS_BASE)
            if marker:
                # same own-writes rule as live_mask's committed-latest
                # branch (point gets / index lookups under FOR UPDATE)
                keep = (((b < TXN_TS_BASE) | (b == marker))
                        & (e >= TXN_TS_BASE) & (e != marker))
            return keep
        keep = (b <= read_ts) & (e > read_ts)
        if marker:
            keep = (((b <= read_ts) | (b == marker))
                    & (e > read_ts) & (e != marker))
        return keep

    def _mvcc_visible(self, cand: np.ndarray, read_ts=None,
                      marker: int = 0) -> np.ndarray:
        """Filter candidate physical rows to the versions visible at
        `read_ts` (own-txn writes included via `marker`)."""
        if len(cand) == 0:
            return cand
        return cand[self._mvcc_mask(cand, read_ts, marker)]

    def index_lookup(self, idx_name: str, key_vals, read_ts=None,
                     marker: int = 0) -> np.ndarray:
        """Visible physical row positions whose index key equals
        `key_vals` — O(log n) against a sorted (key, row) cache per
        index+version instead of a full scan (ref: the reference's
        PointGetExecutor reading the index KV record, SURVEY.md:91).
        MVCC versions share a key; visibility filters them here."""
        skeys, srows = self._sorted_index(idx_name)
        probe = np.zeros(1, dtype=skeys.dtype)
        for i, v in enumerate(key_vals):
            probe[f"k{i}"] = np.int64(v)
        lo = np.searchsorted(skeys, probe[0], side="left")
        hi = np.searchsorted(skeys, probe[0], side="right")
        return self._mvcc_visible(srows[lo:hi], read_ts, marker)

    def index_range_lookup(self, idx_name: str, eq_vals, lo=None, hi=None,
                           lo_incl: bool = True, hi_incl: bool = True,
                           read_ts=None, marker: int = 0) -> np.ndarray:
        """Visible physical rows whose index key has prefix `eq_vals`
        and whose next key column lies in [lo, hi] (either bound open
        when None, inclusive per the _incl flags) — two binary searches
        against the same sorted cache point lookups use (ref: the
        reference's IndexRangeScan feeding IndexLookUpExecutor,
        SURVEY.md:91). Rows with NULL in any key column are absent from
        the cache, matching MySQL range-access semantics."""
        skeys, srows = self._sorted_index(idx_name)
        p = len(eq_vals)
        i64 = np.iinfo(np.int64)

        def bound(range_val, fill, side):
            probe = np.zeros(1, dtype=skeys.dtype)
            for i, v in enumerate(eq_vals):
                probe[f"k{i}"] = np.int64(v)
            for i, name in enumerate(skeys.dtype.names):
                if i < p:
                    continue
                probe[name] = np.int64(range_val) if (
                    i == p and range_val is not None) else fill
            return int(np.searchsorted(skeys, probe[0], side=side))

        # lower edge: >= lo (or > lo when exclusive); open bound floors
        # the suffix at int64 min so the whole eq-prefix group is kept
        if lo is None:
            start = bound(None, i64.min, "left")
        elif lo_incl:
            start = bound(lo, i64.min, "left")
        else:
            start = bound(lo, i64.max, "right")
        if hi is None:
            stop = bound(None, i64.max, "right")
        elif hi_incl:
            stop = bound(hi, i64.max, "right")
        else:
            stop = bound(hi, i64.min, "left")
        if stop <= start:
            return np.zeros(0, dtype=np.int64)
        return self._mvcc_visible(srows[start:stop], read_ts, marker)

    def _uniq_sorted(self, idx: IndexInfo) -> np.ndarray:
        """Sorted key set of present rows, cached per table version.
        Kept incrementally fresh across pure-insert workloads (the
        bulk-load path), so per-insert cost is O(m log n + n) memcpy
        instead of a full O(n log n) re-sort."""
        hit = self._uniq_cache.get(idx.name)
        if hit is not None and hit[0] == self.version:
            return hit[1]
        sel = np.nonzero(self._present_mask())[0]
        keys = self._uniq_keys_at(idx, sel, sort=True)
        self._uniq_cache[idx.name] = (self.version, keys)
        return keys

    def _check_unique_batch(self, idx: IndexInfo, start: int, end: int,
                            marker: Optional[int] = None) -> None:
        """Insert-path uniqueness: buffer rows [start, end) vs the sorted
        key cache. Stages the merged key set in _uniq_pending; the caller
        commits it after the version bump."""
        cache = self._uniq_sorted(idx)
        if marker is not None:
            # keys of rows this txn deleted are free for re-insertion;
            # a rollback resurrects them but also bumps the version,
            # which rebuilds the cache. O(dead) via the per-marker
            # registry, not an O(n) end_ts scan per insert.
            dead = np.asarray(self._txn_dead.get(marker, []), dtype=np.int64)
            if len(dead):
                dk = self._uniq_keys_at(idx, dead, sort=True)
                pos = np.searchsorted(cache, dk)
                ok = (pos < len(cache))
                if ok.any():
                    hitpos = pos[ok]
                    match = cache[hitpos] == dk[ok]
                    cache = np.delete(cache, np.unique(hitpos[match]))
        batch = self._uniq_keys_at(idx, np.arange(start, end), sort=True)
        if len(batch) == 0:
            return
        if len(batch) > 1 and (batch[1:] == batch[:-1]).any():
            raise ExecutionError(
                f"duplicate entry for unique index {idx.name!r} "
                f"on {self.schema.name!r}")
        pos = np.searchsorted(cache, batch)
        if len(cache):
            hit = (pos < len(cache)) & (
                cache[np.minimum(pos, len(cache) - 1)] == batch)
            if hit.any():
                raise ExecutionError(
                    f"duplicate entry for unique index {idx.name!r} "
                    f"on {self.schema.name!r}")
        self._uniq_pending[idx.name] = np.insert(cache, pos, batch)

    def _uniq_commit(self) -> None:
        """Adopt staged key sets at the (just bumped) current version."""
        for name, keys in self._uniq_pending.items():
            self._uniq_cache[name] = (self.version, keys)
        self._uniq_pending.clear()

    def _check_unique(self, idx: IndexInfo, extra: Optional[tuple] = None,
                      marker: Optional[int] = None) -> None:
        """Raise if the index's key columns contain duplicates among
        present rows (rows with any NULL key are exempt, MySQL-style).
        `extra`=(start, end) adds not-yet-committed buffer slots;
        `marker` exempts versions this txn already superseded."""
        mask = self._present_mask()
        if marker is not None:
            mask = mask & (self.end_ts[: self.n] != marker)
        sel = np.nonzero(mask)[0]
        if extra is not None:
            sel = np.concatenate([sel, np.arange(extra[0], extra[1])])
        if len(sel) < 2:
            return
        mat, _ids = self._uniq_key_rows(idx, sel)
        if len(mat) < 2:
            return
        srt = mat[_key_order(mat)]
        if (srt[1:] == srt[:-1]).all(axis=1).any():
            raise ExecutionError(
                f"duplicate entry for unique index {idx.name!r} "
                f"on {self.schema.name!r}")

    def _enforce_unique_new(self, start: int, end: int,
                            marker: Optional[int] = None) -> None:
        """Validate unique indexes counting buffer slots [start, end) as
        present; called BEFORE self.n advances so a violation leaves the
        table untouched. On rejection the written slots' valid bits are
        cleared — later inserts that omit a column must read them as
        NULL, not as the rejected row's values. `marker`: rows this txn
        provisionally deleted don't conflict (REPLACE's delete+insert)."""
        try:
            for idx in self.indexes.values():
                if idx.unique:
                    self._check_unique_batch(idx, start, end, marker)
        except ExecutionError:
            self._uniq_pending.clear()
            for name in self.valid:
                self.valid[name][start:end] = False
            raise

    # -- conflict lookup for REPLACE / ON DUPLICATE KEY UPDATE ----------

    def encode_index_key(self, idx: IndexInfo, value_map: Dict[str, object]):
        """Logical column values -> the index's comparable int key tuple,
        or None when the key can't conflict (a NULL component, or a
        string not present in the column dictionary)."""
        out = []
        for cname in idx.columns:
            v = value_map.get(cname)
            if v is None:
                return None  # NULL never conflicts (MySQL)
            col = self.schema.col(cname)
            dv = self.to_device_value(col, v)
            if col.type_.is_dict_encoded:
                # collation-equal class, canonically coded (matches
                # _uniq_key_rows' canon mapping for _ci columns)
                lo, hi = self.dicts[cname].eq_range(str(dv))
                if lo >= hi:
                    return None  # new string: cannot equal any stored key
                out.append(int(lo))
            elif col.type_.kind == TypeKind.FLOAT:
                out.append(int(np.float64(dv).view(np.int64)))
            else:
                out.append(int(np.int64(dv)))
        return tuple(out)

    def conflict_map(self, idx: IndexInfo, marker: Optional[int] = None) -> dict:
        """key tuple -> physical row id over rows present for constraint
        purposes, minus rows this txn provisionally deleted AND minus
        other open txns' provisional inserts (those are locked rows a
        REPLACE/upsert must not touch — colliding with one surfaces as
        a unique-violation/write-conflict instead of silent clobbering).
        One O(n) pass; callers keep it fresh across their own
        statement's mutations instead of rescanning per VALUES row."""
        mask = self._present_mask()
        if marker is not None:
            mask = mask & (self.end_ts[: self.n] != marker)
            b = self.begin_ts[: self.n]
            mask = mask & ~((b >= TXN_TS_BASE) & (b != marker))
        sel = np.nonzero(mask)[0]
        mat, ids = self._uniq_key_rows(idx, sel)
        if mat.size == 0 and len(ids) == 0:
            return {}
        return {tuple(k): int(i) for k, i in zip(mat.tolist(), ids.tolist())}

    def row_value_map(self, names, row) -> Dict[str, object]:
        """Column name -> logical value for one INSERT row, with schema
        defaults filled in for omitted columns (so unique indexes over
        default-valued columns still detect conflicts)."""
        out = dict(zip(names, row))
        for c in self.schema.columns:
            if c.name not in out and c.default is not None and not c.auto_increment:
                out[c.name] = c.default
        return out

    def gc(self, safepoint: int) -> int:
        """Reclaim row versions invisible to every current and future
        reader (ref: the TiKV GC worker below the safepoint): versions
        whose end_ts committed at or before the safepoint, including
        rollback-dead rows (begin=end=0). Rows ended by an open txn's
        marker (>= TXN_TS_BASE) are never garbage. Compacts the column
        buffers in place and shrinks them when mostly empty.

        Caller contract: no open transaction may hold physical row ids
        into this table (txn write logs use positions) — the catalog's
        GC driver only runs with zero open transactions."""
        n = self.n
        if n == 0:
            return 0
        e = self.end_ts[:n]
        garbage = (e <= safepoint) & (e < TXN_TS_BASE)
        k = int(garbage.sum())
        if k == 0:
            return 0
        keep = ~garbage
        m = n - k
        for name in self.data:
            self.data[name][:m] = self.data[name][:n][keep]
            self.valid[name][:m] = self.valid[name][:n][keep]
            # vacated tail must read as NULL: insert paths that omit a
            # column rely on slots >= n having valid=False
            self.valid[name][m:n] = False
        self.begin_ts[:m] = self.begin_ts[:n][keep]
        self.end_ts[:m] = self.end_ts[:n][keep]
        self.n = m
        self.data_epoch += 1  # physical row positions moved
        # release buffer memory when the table shrank far below capacity
        want = max(_MIN_CAP, int(m * _GROW))
        if self._cap > 4 * want:
            for name in self.data:
                self.data[name] = np.resize(self.data[name], want)
                self.valid[name] = np.resize(self.valid[name], want)
            self.begin_ts = np.resize(self.begin_ts, want)
            self.end_ts = np.resize(self.end_ts, want)
            self._cap = want
        self.version += 1
        return k

    def truncate(self):
        # next slice: a table referenced by a foreign key refuses here
        self.n = 0
        self.version += 1
        self.data_epoch += 1  # every stored payload discarded
        self.begin_ts[:] = 0
        self.end_ts[:] = MAX_TS
        for c in self.schema.columns:
            # valid[] must clear: insert paths that omit a column rely on
            # stale slots reading as NULL
            self.valid[c.name][:] = False
            self.data[c.name][:] = 0
            if c.type_.is_dict_encoded:
                self.dicts[c.name] = Dictionary([], c.coll)

    def insertable_names(self) -> List[str]:
        """Positional-INSERT width: the public columns."""
        return self.schema.public_names()

    # -- reads -------------------------------------------------------------

    def column_slice(self, name: str, start: int, end: int):
        """(data, valid) physical slice incl. dead row versions — executor
        masks them via live_mask."""
        return self.data[name][start:end], self.valid[name][start:end]

    def live_mask(self, start: int, end: int, read_ts: Optional[int] = None,
                  marker: int = 0) -> np.ndarray:
        """Row visibility. read_ts=None reads committed-latest; a snapshot
        read at read_ts additionally sees its own txn's marker writes."""
        b = self.begin_ts[start:end]
        e = self.end_ts[start:end]
        if read_ts is None:
            vis = (b < TXN_TS_BASE) & (e >= TXN_TS_BASE)
            if marker:
                # committed-latest (locking reads) still sees the txn's
                # OWN provisional writes: an UPDATE then FOR UPDATE in
                # one txn must lock the new version, not the stale row
                vis = (((b < TXN_TS_BASE) | (b == marker))
                       & (e >= TXN_TS_BASE) & (e != marker))
            return vis
        vis = (b <= read_ts) & (e > read_ts)
        if marker:
            vis = ((b <= read_ts) | (b == marker)) & (e > read_ts) & (e != marker)
        return vis
