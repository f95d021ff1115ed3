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
  * constraints on every write: FOREIGN KEY (with its referential
    actions), CHECK, generated columns and the RANGE partition bound;
    pessimistic row locks (FOR UPDATE/SHARE) block other writers
  * column DDL (ADD/DROP/MODIFY COLUMN, online-DDL write_only states)
  * CLUSTER BY: `recluster` physically re-sorts the rows by the cluster
    column (stable, NULLs first) so the segment store's zone maps prune
  * statistics upkeep: `modify_count` (rows a commit wrote since the last
    ANALYZE, the auto-analyze trigger) and the per-column NDV sketches
    ANALYZE seeds and every insert path feeds (`_sketch_insert`)
"""

from __future__ import annotations

import time
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
from tidb_tpu_torch.utils import host_map, tracing

__all__ = ["ColumnInfo", "TableSchema", "Table", "TableTxnLog", "IndexInfo",
           "FKInfo", "GeneratedInfo", "CheckInfo", "PartitionInfo",
           "ShardByInfo", "TXN_TS_BASE", "MAX_TS"]


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
class FKInfo:
    """A FOREIGN KEY constraint: multi-column, with referential actions.
    `parent` is the referenced Table object (wired by the catalog at
    CREATE time), whose `referencing` list holds the back-edge for
    parent-side checks/actions. NULL matching is MySQL's simple match: a
    child row with ANY NULL component passes."""

    columns: List[str]
    parent: object          # storage Table of the referenced table
    parent_cols: List[str]
    name: str = ""
    parent_db: str = ""     # the parent's database
    on_delete: str = "restrict"   # restrict | cascade | set_null
    on_update: str = "restrict"

    @property
    def column(self) -> str:  # single-column convenience (display)
        return self.columns[0]

    @property
    def parent_col(self) -> str:
        return self.parent_cols[0]


@dataclass
class GeneratedInfo:
    """A generated column (MySQL GENERATED ALWAYS AS): `fn` is the
    compiled chunk->Column evaluator over the row's other columns, bound
    at DDL time like CHECK constraints. STORED and VIRTUAL are both
    materialized at write time (a columnar engine reads columns, not
    rows)."""

    col: str
    fn: object
    cols: List[str]
    sql: str
    stored: bool = True


@dataclass
class CheckInfo:
    """A CHECK constraint: bound predicate over this table's columns
    (uids == column names), compiled once at DDL time. A row violates
    only when the predicate is FALSE; NULL/UNKNOWN passes."""

    name: str
    pred: object          # compiled chunk -> Column evaluator
    cols: List[str]
    sql: str


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
    # online-DDL state: "write_only" indexes are maintained/enforced on
    # every write but invisible to the planner's access paths until the
    # backfill validates existing rows and flips them public
    state: str = "public"


@dataclass
class PartitionInfo:
    """Logical table partitioning (MySQL PARTITION BY RANGE/HASH; the
    planner prunes partitions). RANGE: partition i holds rows with
    uppers[i-1] <= col < uppers[i] (None = MAXVALUE). HASH: pid = value
    % n_parts (NULL rows land in partition 0, like MySQL)."""

    kind: str                     # "range" | "hash"
    column: str
    names: List[str] = field(default_factory=list)
    uppers: List[Optional[int]] = field(default_factory=list)  # range
    n_parts: int = 0              # hash

    def count(self) -> int:
        return len(self.names) if self.kind == "range" else self.n_parts

    def part_name(self, pid: int) -> str:
        if self.kind == "range":
            return self.names[pid]
        return f"p{pid}"

    def ids_of_values(self, vals: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Partition id per value. Without a MAXVALUE partition the
        returned id can equal count(): an overflow the write path
        rejects (_check_partition)."""
        v = np.where(valid, vals.astype(np.int64), 0)
        if self.kind == "hash":
            return np.where(valid, v % max(self.n_parts, 1), 0)
        bounds = np.array(
            [u for u in self.uppers if u is not None], dtype=np.int64)
        pid = np.searchsorted(bounds, v, side="right")
        return np.where(valid, pid, 0)


@dataclass
class ShardByInfo:
    """Cross-worker placement metadata (SHARD BY ... DDL; consumed by
    tidb_tpu_torch/sharding). HASH: shard = mix(value) % shards, NULL ->
    0. RANGE: `bounds` are k ascending exclusive uppers making k+1
    shards (shard i holds bounds[i-1] <= value < bounds[i]; the last
    shard is unbounded above), NULL -> 0. `version` bumps on every
    reshard so placement snapshots and plan-cache entries keyed on it
    invalidate; the catalog's schema_version bumps alongside."""

    kind: str                 # "hash" | "range"
    column: str
    shards: int
    bounds: List[int] = field(default_factory=list)  # range only
    version: int = 0


@dataclass
class TableSchema:
    name: str
    columns: List[ColumnInfo]
    primary_key: Optional[List[str]] = None
    # table default COLLATE (applied to columns that declare none)
    collation: Optional[str] = None
    # PARTITION BY metadata; None = unpartitioned
    partition: Optional[PartitionInfo] = None
    # SHARD BY metadata waits for the multi-device tier: always None
    shard_by: Optional[ShardByInfo] = None
    # CLUSTER BY column: delta->segment compaction keeps the table
    # physically sorted by this column (ASC, NULLs first) so the columnar
    # store's zone maps prune range filters; None = no ordered compaction
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


def _cluster_order(key: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The CLUSTER BY permutation: stable, ascending, NULLs first (as
    ``np.lexsort((key, valid))``). An integer key without NULLs whose
    range fits 16 bits (dates, dictionary codes) sorts as uint16 offsets,
    where numpy's stable sort is a radix sort."""
    if len(key) and key.dtype.kind in "iu" and valid.all():
        lo = int(key.min())
        if int(key.max()) - lo < 1 << 16:
            return np.argsort((key - lo).astype(np.uint16), kind="stable")
    return np.lexsort((key, valid.astype(np.int64)))


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
        # CLUSTER BY watermark: leading physical rows known to be in
        # cluster order. Appends grow `n` past it (the delta is
        # unordered); recluster() advances it to `n`. Order-preserving
        # rewrites (gc's mask compaction) keep a full watermark valid.
        self.clustered_rows = 0
        # owning catalog (set by create_table): recluster() takes its
        # writer lock and consults its open-txn and reader registries
        self.txn_guard = None
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
        # rows modified since the last ANALYZE (auto-analyze trigger)
        self.modify_count = 0
        # per-column KMV NDV sketches (statistics.NDVSketch), seeded by
        # ANALYZE and fed by every insert so distinct-count estimates
        # track DML churn between analyzes
        self.ndv_sketch: Dict[str, object] = {}
        # FOREIGN KEY constraints: this table's child-side FKs, and
        # back-edges from tables whose FKs reference THIS table
        self.foreign_keys: List[FKInfo] = []
        self.referencing: List[tuple] = []  # (child Table, FKInfo)
        # fk-check cache: cols -> (version, live key set / sorted array)
        self._fk_keys: Dict[tuple, tuple] = {}
        # CHECK constraints (CheckInfo), wired by the session at DDL time
        self.checks: List[CheckInfo] = []
        # generated columns (GeneratedInfo), wired at DDL time; computed
        # on every write before constraints run
        self.generated: List[GeneratedInfo] = []
        # pessimistic row locks from SELECT ... FOR UPDATE / SHARE:
        # rid -> {txn marker: "x"|"s"}. Guarded by the catalog lock like
        # every mutation; writers check it in _writable_mask,
        # commit/rollback release by marker.
        self.row_locks: Dict[int, Dict[int, str]] = {}

    def _next_ts(self) -> int:
        if self.ts_source is not None:
            return self.ts_source()
        self._local_ts += 1
        return self._local_ts

    # -- row count ---------------------------------------------------------

    @property
    def live_rows(self) -> int:
        """Committed-latest row count (provisional writes excluded): a
        pass over every row's timestamps, whose seconds go into the
        statement's storage.live_rows counter."""
        t0 = time.perf_counter()
        n = 0
        if self.n:
            b = self.begin_ts[: self.n]
            e = self.end_ts[: self.n]
            n = int(((b < TXN_TS_BASE) & (e >= TXN_TS_BASE)).sum())
        tracing.count(tracing.LIVE_ROWS, time.perf_counter() - t0)
        return n

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
            elif c.not_null and not any(
                    g.col == c.name for g in self.generated):
                # generated columns compute below (_apply_generated),
                # so NOT NULL on them never needs a default
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
        self._apply_generated(start, end)
        self._enforce_unique_new(
            start, end, marker=begin_ts if in_txn and txn_deleted else None)
        self._check_fk_parents(start, end)
        self._check_row_constraints(start, end)
        self._check_partition(start, end)
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
        self._sketch_insert(start, end)
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
            elif c.not_null and not any(
                    g.col == c.name for g in self.generated):
                raise ExecutionError(f"bulk insert missing NOT NULL column {name!r}")
        self._apply_generated(start, end)
        self._enforce_unique_new(start, end)
        self._check_fk_parents(start, end)
        self._check_row_constraints(start, end)
        self._check_partition(start, end)
        self.begin_ts[start:end] = 0  # bulk loads are committed "at origin"
        self.end_ts[start:end] = MAX_TS
        self.n = end
        self.version += 1
        self._uniq_commit()
        self._sketch_insert(start, end)
        return m

    # -- foreign keys ------------------------------------------------------

    def _fk_decode(self, col: str, vals: np.ndarray,
                   fold: bool = True) -> np.ndarray:
        """Decode this table's values of `col` for cross-table FK
        comparison: the collation FOLD KEY for dict columns (so 'abc'
        matches a parent's 'ABC' under _ci; canonical codes are
        table-local and must never cross tables), raw otherwise.
        fold=False decodes the raw stored strings, what a cascade WRITE
        must use, or a _ci cascade would lowercase the child's data."""
        dic = self.dicts.get(col)
        if dic is None:
            return vals
        if not fold:
            return np.array(
                [dic.values[int(c)] for c in vals], dtype=object)
        return np.array(
            [dic.fold(dic.values[int(c)]) for c in vals], dtype=object)

    def _fk_tuples(self, cols: List[str], rows: np.ndarray):
        """(key tuples, all-components-valid mask) at `rows`: MySQL's
        simple match, a row with ANY NULL component never participates."""
        ok = np.ones(len(rows), dtype=np.bool_)
        for c in cols:
            ok &= self.valid[c][rows]
        sel = rows[ok]
        decoded = [self._fk_decode(c, self.data[c][sel]) for c in cols]
        return list(zip(*decoded)) if len(sel) else [], ok

    def _live_key_tuples(self, cols: List[str]) -> set:
        """Key-tuple set of present rows (the parent side of an FK
        probe), cached per version; values are decoded so they compare
        across tables."""
        key = tuple(cols)
        hit = self._fk_keys.get(key)
        if hit is not None and hit[0] == self.version:
            return hit[1]
        present = np.nonzero(self._present_mask())[0]
        tuples, _ok = self._fk_tuples(cols, present)
        keys = set(tuples)
        self._fk_keys[key] = (self.version, keys)
        return keys

    def _live_key_array(self, col: str) -> np.ndarray:
        """Single-column vectorized variant of _live_key_tuples: sorted
        unique decoded values of present rows, cached per version, so
        the common one-column FK probe stays on np.isin."""
        key = (col, "arr")
        hit = self._fk_keys.get(key)
        if hit is not None and hit[0] == self.version:
            return hit[1]
        present = self._present_mask()
        vals = self.data[col][: self.n][present & self.valid[col][: self.n]]
        keys = np.unique(vals)
        dic = self.dicts.get(col)
        if dic is not None:
            keys = np.unique(np.array(
                [dic.fold(dic.values[int(c)]) for c in keys], dtype=object))
        self._fk_keys[key] = (self.version, keys)
        return keys

    def _check_fk_parents(self, start: int, end: int,
                          cols: Optional[set] = None,
                          fks=None, live_only: bool = False) -> None:
        """Every fully-non-NULL FK key in rows [start, end) must exist
        in its parent (RESTRICT on the child write). Raises BEFORE the
        rows become visible. `fks` restricts to specific constraints and
        `live_only` to present row versions (ALTER TABLE ADD FOREIGN KEY
        checking existing data)."""
        rows = np.arange(start, end)
        if live_only:
            rows = rows[self._present_mask()[start:end]]
        for fk in (fks if fks is not None else self.foreign_keys):
            if cols is not None and not (set(fk.columns) & cols):
                continue
            if len(fk.columns) == 1:
                # vectorized single-column fast path (the common case)
                c = fk.columns[0]
                vd = self.valid[c][rows]
                vals = self._fk_decode(c, self.data[c][rows][vd])
                if not len(vals):
                    continue
                keys = fk.parent._live_key_array(fk.parent_cols[0])
                ok = np.isin(vals, keys)
                if not ok.all():
                    raise ExecutionError(
                        f"foreign key {fk.name or fk.column!r} violation: "
                        f"{vals[~ok][0]!r} not present in "
                        f"{fk.parent.schema.name}.{fk.parent_cols[0]}")
                continue
            tuples, _ok = self._fk_tuples(fk.columns, rows)
            if not tuples:
                continue
            keys = fk.parent._live_key_tuples(fk.parent_cols)
            for t in tuples:
                if t not in keys:
                    raise ExecutionError(
                        f"foreign key {fk.name or fk.column!r} violation: "
                        f"{t if len(t) > 1 else t[0]!r} not present in "
                        f"{fk.parent.schema.name}"
                        f".({', '.join(fk.parent_cols)})")

    def _fk_referencing_rows(self, cols: List[str], keys: set) -> np.ndarray:
        """Present row ids whose (fully non-NULL) FK tuple is in `keys`."""
        present = np.nonzero(self._present_mask())[0]
        if len(cols) == 1:
            c = cols[0]
            vd = self.valid[c][present]
            sel = present[vd]
            if not len(sel):
                return np.zeros(0, dtype=np.int64)
            vals = self._fk_decode(c, self.data[c][sel])
            # decoded strings compare as objects; numbers keep the column's
            # dtype, so np.isin sorts instead of comparing object by object
            karr = np.array([k[0] for k in keys], dtype=vals.dtype)
            return sel[np.isin(vals, karr)]
        tuples, ok = self._fk_tuples(cols, present)
        sel = present[ok]
        if not tuples:
            return np.zeros(0, dtype=np.int64)
        hit = np.fromiter((t in keys for t in tuples), dtype=np.bool_,
                          count=len(tuples))
        return sel[hit]

    def _fk_tuples_aligned(self, cols: List[str], rows: np.ndarray,
                           fold: bool = True):
        """Row-aligned key tuples with None for NULL components.
        fold=True yields comparison keys; fold=False the raw values."""
        out = []
        for i in rows.tolist():
            t = []
            for c in cols:
                if self.valid[c][i]:
                    t.append(self._fk_decode(
                        c, self.data[c][i:i + 1], fold=fold)[0])
                else:
                    t.append(None)
            out.append(tuple(t))
        return out

    def _check_fk_children(self, ids: np.ndarray, *, action: str = "delete",
                           end_ts=None, marker: int = 0, log_for=None,
                           new_rows: Optional[np.ndarray] = None,
                           depth: int = 0, phase: str = "both") -> None:
        """Rows `ids` are about to be deleted (action="delete") or have
        their key columns rewritten (action="update", `new_rows` holding
        the new versions). Applies each child FK's referential action:
        restrict raises, cascade deletes/updates the child rows
        (recursively, bounded like MySQL's 15-level cascade limit),
        set_null NULLs the child key columns. `log_for` maps a child
        Table to its TableTxnLog so cascaded writes stay inside the
        caller's transaction."""
        if not self.referencing or not len(ids):
            return
        if depth > 15:
            raise ExecutionError("foreign key cascade depth exceeded")
        for child, fk in list(self.referencing):
            act = fk.on_delete if action == "delete" else fk.on_update
            # phase="pre" runs BEFORE the parent mutation (abort-early
            # restrict checks); phase="post" runs after the parent's new
            # versions are visible, so a cascaded child write re-checks
            # its FK against the UPDATED parent keys
            if phase == "pre" and act != "restrict":
                continue
            if phase == "post" and act == "restrict":
                continue
            tuples, _ok = self._fk_tuples(fk.parent_cols, ids)
            keys = set(tuples)
            if not keys:
                continue
            rows = child._fk_referencing_rows(fk.columns, keys)
            if not len(rows):
                continue
            if act == "restrict":
                hit_c, _ok = child._fk_tuples(fk.columns, rows[:1])
                bad = hit_c[0] if hit_c else "?"
                raise ExecutionError(
                    f"cannot delete or update {self.schema.name!r} row: "
                    f"key {bad if len(fk.columns) > 1 else bad[0]!r} is "
                    f"referenced by "
                    f"{child.schema.name}.({', '.join(fk.columns)})")
            clog = log_for(child) if log_for is not None else None
            if act == "set_null":
                for c in fk.columns:
                    if child.schema.col(c).not_null:
                        raise ExecutionError(
                            f"FK {fk.name!r} ON {action.upper()} SET NULL: "
                            f"{child.schema.name}.{c} is NOT NULL")
                child.update_rows(
                    rows, {c: [None] * len(rows) for c in fk.columns},
                    begin_ts=marker or None, end_ts=end_ts if marker else None,
                    marker=marker, log=clog, log_for=log_for,
                    _fk_depth=depth + 1)
            elif act == "cascade" and action == "delete":
                child.delete_rows(rows, end_ts=end_ts, marker=marker,
                                  log=clog, log_for=log_for,
                                  _fk_depth=depth + 1)
            elif act == "cascade":  # update: rewrite child keys old->new
                # match on FOLD keys (how the referencing rows were
                # found), but write the parent's RAW new values: a _ci
                # cascade must not replace 'BOB' with its fold 'bob'
                old_al = self._fk_tuples_aligned(fk.parent_cols, ids)
                new_raw = self._fk_tuples_aligned(
                    fk.parent_cols,
                    new_rows if new_rows is not None else ids, fold=False)
                new_keys = {o: n for o, n in zip(old_al, new_raw)
                            if None not in o}
                tuples_c, ok_c = child._fk_tuples(fk.columns, rows)
                rows_ok = rows[ok_c]
                raw_c = child._fk_tuples_aligned(fk.columns, rows_ok,
                                                 fold=False)
                updates = {c: [] for c in fk.columns}
                for t, raw in zip(tuples_c, raw_c):
                    # unmatched keys keep the child's own raw value
                    nt = new_keys.get(t, raw)
                    for c, v in zip(fk.columns, nt):
                        updates[c].append(v)
                child.update_rows(
                    rows_ok, updates,
                    begin_ts=marker or None, end_ts=end_ts if marker else None,
                    marker=marker, log=clog, log_for=log_for,
                    _fk_depth=depth + 1)

    # -- generated columns and CHECK constraints ---------------------------

    def _eval_rows(self, fn, cols: List[str], start: int, end: int):
        """Run a compiled chunk->Column evaluator over buffer rows
        [start, end); returns host (data, valid). The write path is host
        work in both packages (the reference evaluates these under its
        host_eager scope), so the evaluator runs on CPU tensors whatever
        the session's device: this is the write path's own placement,
        not a fallback from the card."""
        import torch

        from tidb_tpu_torch.chunk.chunk import Chunk
        from tidb_tpu_torch.chunk.column import Column

        n = end - start
        cap = 8
        while cap < n:
            cap *= 2
        cs = {}
        for cname in cols:
            t = self.schema.col(cname).type_
            cs[cname] = Column.from_numpy(
                self.data[cname][start:end], t,
                valid=self.valid[cname][start:end], capacity=cap,
                device="cpu")
        sel = torch.arange(cap) < n
        col = fn(Chunk(cs, sel))
        return col.data[:n].numpy(), col.valid[:n].numpy()

    def _apply_generated(self, start: int, end: int) -> None:
        """Materialize generated columns for buffer rows [start, end)
        from their source columns, BEFORE uniqueness/CHECK/FK
        validation, which may reference them."""
        if not self.generated:
            return
        for gen in self.generated:
            data, valid = self._eval_rows(gen.fn, gen.cols, start, end)
            col = self.schema.col(gen.col)
            if col.not_null and not valid.all():
                raise ExecutionError(
                    f"generated column {gen.col!r} computed NULL but is "
                    "declared NOT NULL")
            self.data[gen.col][start:end] = data.astype(
                col.type_.np_dtype, copy=False)
            self.valid[gen.col][start:end] = valid

    def insertable_names(self) -> List[str]:
        """Positional-INSERT width: public columns minus generated ones
        (their values are never supplied; omitting the slot keeps old
        writers working)."""
        gen = {g.col for g in self.generated}
        return [n for n in self.schema.public_names() if n not in gen]

    def _check_row_constraints(self, start: int, end: int,
                               cols: Optional[set] = None,
                               live_only: bool = False,
                               checks=None) -> None:
        """CHECK constraints over rows [start, end): violation =
        predicate FALSE (NULL passes, per SQL). `live_only` restricts to
        present row versions (ALTER TABLE ADD CHECK validating existing
        data must skip dead versions)."""
        if not self.checks:
            return
        rows_live = None
        if live_only:
            rows_live = self._present_mask()[start:end]
        for chk in (checks if checks is not None else self.checks):
            if cols is not None and not (set(chk.cols) & cols):
                continue
            data, valid = self._eval_rows(chk.pred, chk.cols, start, end)
            bad = valid & ~data.astype(bool)
            if rows_live is not None:
                bad &= rows_live
            if bad.any():
                raise ExecutionError(
                    f"CHECK constraint {chk.name!r} violated: ({chk.sql})")

    def _sketch_insert(self, start: int, end: int) -> None:
        """Feed newly written rows into the per-column NDV sketches (a
        no-op until ANALYZE seeds them). Dict-encoded columns hash the
        decoded strings — codes shift when the sorted dictionary grows,
        so they are not stable identities over time."""
        if not self.ndv_sketch:
            return
        from tidb_tpu_torch.statistics import hash_column_values

        for name, sk in self.ndv_sketch.items():
            vd = self.valid[name][start:end]
            vals = self.data[name][start:end][vd]
            if not len(vals):
                continue
            sk.update(hash_column_values(vals, self.dicts.get(name)))

    def ingest_encoded(self, arrays: Dict[str, np.ndarray],
                       pools: Dict[str, list]) -> int:
        """Bulk ingest with PRE-ENCODED dictionary codes (the native
        data-loader path): string columns arrive as int codes indexing
        their sorted unique `pools` entry; no Python string objects are
        materialized for the rows. Table must be empty.

        The table's columns are made one at a time and each of `arrays`
        leaves the dict once it is copied: a caller that hands over its
        only references holds one column twice at a time, never the
        whole table (lineitem at SF10: 16 generated int64 columns, 7.7
        GB, beside 7.7 GB of storage)."""
        if self.n:
            raise ExecutionError("encoded ingest requires an empty table")
        sizes = {len(a) for a in arrays.values()}
        if len(sizes) != 1:
            raise ExecutionError(f"encoded ingest length mismatch: {sizes}")
        m = sizes.pop()
        cap = max(m, self._cap)
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
            if name not in arrays and c.not_null:
                raise ExecutionError(f"encoded ingest missing NOT NULL {name!r}")
            # zero-filled by the allocator: pages are touched as rows land
            data = np.zeros(cap, dtype=self.data[name].dtype)
            valid = np.zeros(cap, dtype=np.bool_)
            src = arrays.pop(name, None)
            if src is not None:
                data[:m] = src
                valid[:m] = True
            del src
            self.data[name], self.valid[name] = data, valid
        self.begin_ts = np.zeros(cap, dtype=np.int64)
        self.end_ts = np.full(cap, MAX_TS, dtype=np.int64)
        self._cap = cap
        self._enforce_unique_new(0, m)
        self.n = m
        self.version += 1
        self._uniq_commit()
        return m

    def _append_strings(self, name: str, vals: list, start: int, end: int):
        d = self.dicts[name]
        index = d._index
        new = {v for v in vals if v is not None and v not in index}
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
        Rows pessimistically locked by ANOTHER txn (FOR UPDATE/SHARE)
        also conflict: a shared lock blocks writers too."""
        if self.row_locks:
            for rid in ids.tolist():
                holders = self.row_locks.get(int(rid))
                if holders and any(m != marker for m in holders):
                    raise WriteConflictError(
                        "write conflict: row locked by another "
                        f"transaction (table {self.schema.name!r})")
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

    def lock_conflict(self, ids: np.ndarray, marker: int, mode: str):
        """First conflict preventing `marker` from locking `ids` in
        `mode` ("x"|"s"), or None. Caller holds the catalog lock.
        Conflicts: another holder when either side is exclusive, or a
        provisional write (insert/update/delete marker) by another txn."""
        for rid in ids.tolist():
            holders = self.row_locks.get(int(rid))
            if holders and any(
                    m != marker and (mode == "x" or md == "x")
                    for m, md in holders.items()):
                return f"row {int(rid)} locked"
        if len(ids):
            in_b = (ids >= 0) & (ids < self.n)
            cl = np.clip(ids, 0, max(self.n - 1, 0))
            ets = np.where(in_b, self.end_ts[cl], MAX_TS)
            bts = np.where(in_b, self.begin_ts[cl], 0)
            prov = ((ets >= TXN_TS_BASE) & (ets < MAX_TS) & (ets != marker)) \
                | ((bts >= TXN_TS_BASE) & (bts != marker))
            if prov.any():
                return f"row {int(ids[prov.argmax()])} has an uncommitted write"
        return None

    def lock_rows(self, ids: np.ndarray, marker: int, mode: str) -> None:
        """Register `marker`'s locks over `ids` (no conflict checking:
        call lock_conflict first, same catalog-lock hold). An existing
        shared lock upgrades to exclusive, never downgrades."""
        for rid in ids.tolist():
            holders = self.row_locks.setdefault(int(rid), {})
            if mode == "x" or holders.get(marker) != "x":
                holders[marker] = mode

    def release_locks(self, marker: int) -> None:
        """Drop every lock `marker` holds (commit/rollback/resolve)."""
        if not self.row_locks:
            return
        for rid in list(self.row_locks):
            holders = self.row_locks[rid]
            if holders.pop(marker, None) is not None and not holders:
                del self.row_locks[rid]

    def delete_rows(self, row_ids: np.ndarray, end_ts: Optional[int] = None,
                    marker: int = 0, log: Optional["TableTxnLog"] = None,
                    log_for=None, _fk_depth: int = 0) -> int:
        """End rows' visibility at end_ts (a commit ts, or a txn marker for
        provisional deletes). Returns count newly deleted. `log_for`
        maps child tables to their txn logs so ON DELETE CASCADE /
        SET NULL writes join the caller's transaction."""
        ids = np.asarray(row_ids, dtype=np.int64)
        ids = ids[self._writable_mask(ids, marker)]
        self._check_fk_children(ids, action="delete", end_ts=end_ts,
                                marker=marker, log_for=log_for,
                                depth=_fk_depth)
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
                    marker: int = 0, log: Optional["TableTxnLog"] = None,
                    log_for=None, _fk_depth: int = 0) -> int:
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
        self._apply_generated(start, end)
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

        upd_cols = set(converted)
        try:
            self._check_fk_parents(start, end, cols=upd_cols)
            self._check_row_constraints(start, end, cols=upd_cols)
            if (self.schema.partition is not None
                    and self.schema.partition.column in upd_cols):
                self._check_partition(start, end)
            ref_cols = set()
            for _c, fk in self.referencing:
                ref_cols |= set(fk.parent_cols)
            fk_changed = None
            if ref_cols & upd_cols:
                changed = np.zeros(len(ids), dtype=np.bool_)
                for pcol in ref_cols & upd_cols:
                    old = self.data[pcol][ids]
                    ov = self.valid[pcol][ids]
                    new = self.data[pcol][start:end]
                    nv = self.valid[pcol][start:end]
                    changed |= (ov != nv) | (ov & nv & (old != new))
                if changed.any():
                    fk_changed = (ids[changed].copy(),
                                  np.arange(start, end)[changed])
                    # abort-early half: ON UPDATE RESTRICT children
                    self._check_fk_children(
                        fk_changed[0], action="update", phase="pre",
                        depth=_fk_depth)
        except ExecutionError:
            for name in self.valid:
                self.valid[name][start:end] = False
            raise
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
        self._sketch_insert(start, end)
        if fk_changed is not None:
            # action half AFTER the new parent keys are visible, so a
            # cascaded child write FK-checks against the updated parent;
            # statement atomicity on a mid-cascade failure is the txn
            # layer's (marker rollback), like any multi-table statement
            self._check_fk_children(
                fk_changed[0], action="update", phase="post",
                end_ts=end_ts, marker=marker, log_for=log_for,
                new_rows=fk_changed[1], depth=_fk_depth)
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
                self.modify_count += e - s
            for ids in log.ended:
                e_ = self.end_ts[ids]
                self.end_ts[ids] = np.where(e_ == marker, commit_ts, e_)
                self.modify_count += len(ids)
        else:
            b = self.begin_ts[: self.n]
            e = self.end_ts[: self.n]
            bm = b == marker
            em = e == marker
            if not bm.any() and not em.any():
                return  # no residue here: don't invalidate caches
            b[bm] = commit_ts
            e[em] = commit_ts
            # full-scan commits must still advance the auto-analyze
            # trigger or stats silently go stale for these workloads
            self.modify_count += int(bm.sum()) + int(em.sum())
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

    # -- DDL ---------------------------------------------------------------
    # (ref: ddl/ online schema change; single-process => synchronous, but
    # the backfill over existing rows is the same job)

    def add_column(self, col: ColumnInfo) -> None:
        if any(c.name == col.name for c in self.schema.columns):
            raise SchemaError(f"duplicate column {col.name!r}")
        if col.not_null and col.default is None and self.live_rows > 0:
            raise ExecutionError(
                f"cannot add NOT NULL column {col.name!r} without DEFAULT "
                "to a non-empty table")
        self.schema.columns.append(col)
        self.data[col.name] = np.zeros(self._cap, dtype=col.type_.np_dtype)
        self.valid[col.name] = np.zeros(self._cap, dtype=np.bool_)
        if col.type_.is_dict_encoded:
            self.dicts[col.name] = Dictionary([], col.coll)
        if col.default is not None:
            # backfill existing rows with the default
            dv = self.to_device_value(col, col.default)
            if col.type_.is_dict_encoded:
                self._append_strings(col.name, [dv] * self.n, 0, self.n)
            else:
                self.data[col.name][: self.n] = dv
                self.valid[col.name][: self.n] = True
        self.version += 1
        self.data_epoch += 1  # column set changed under existing rows

    def drop_column(self, name: str) -> None:
        if any(name in fk.columns for fk in self.foreign_keys) or any(
                name in fk.parent_cols for _c, fk in self.referencing):
            raise SchemaError(
                f"cannot drop column {name!r}: used by a foreign key")
        if any(name in chk.cols for chk in self.checks):
            raise SchemaError(
                f"cannot drop column {name!r}: used by a CHECK constraint")
        col = self.schema.col(name)  # raises if absent
        if self.schema.primary_key and name in self.schema.primary_key:
            raise ExecutionError(f"cannot drop primary-key column {name!r}")
        for idx in self.indexes.values():
            if name in idx.columns:
                raise ExecutionError(
                    f"cannot drop column {name!r}: used by index {idx.name!r}")
        self.schema.columns.remove(col)
        del self.data[name]
        del self.valid[name]
        self.dicts.pop(name, None)
        if self.schema.cluster_by == name:
            self.schema.cluster_by = None  # ordering key is gone
        self.version += 1
        self.data_epoch += 1  # column set changed under existing rows

    def modify_column(self, col: ColumnInfo) -> None:
        """Change a column's type, converting existing values. Numeric
        widenings and integer-domain decimal scale shifts only; anything
        lossy (non-integral, indivisible scale-down, out-of-domain BOOL,
        int64 overflow, precision loss above 2^53 into FLOAT) raises
        rather than corrupting. Lossy-value checks look only at valid
        slots of PRESENT versions — stale bytes under NULLs and dead
        (ended) versions are never read by current/future readers and
        must not turn the statement into an error."""
        old = self.schema.col(col.name)
        ok_kinds = {TypeKind.INT, TypeKind.FLOAT, TypeKind.DECIMAL, TypeKind.BOOL}
        ok, nk = old.type_.kind, col.type_.kind
        n = self.n
        valid = self.valid[col.name][:n]
        # lossiness is judged on present (not-ended) valid values only
        chk = valid & self._present_mask()
        # zero stale bytes under NULL/dead slots: they are never read,
        # but they must not overflow or NaN-poison the bulk conversion
        data = np.where(valid, self.data[col.name][:n],
                        np.zeros((), dtype=self.data[col.name].dtype))

        def lossy(msg):
            raise ExecutionError(f"MODIFY {col.name}: {msg}")

        saved_dict = saved_coll = None
        if (ok == nk == TypeKind.STRING
                and col.collation is not None and col.collation != old.coll):
            # MODIFY ... COLLATE: re-sort the dictionary under the new
            # collation and translate stored codes; new-collation unique
            # semantics re-validate below like any narrowing
            d_old = self.dicts[col.name]
            saved_dict, saved_coll = d_old, old.collation
            d_new = Dictionary(list(d_old.values), col.collation)
            trans = d_old.translate_to(d_new)
            conv = np.where(valid, trans[np.clip(data, 0, max(len(trans) - 1, 0))]
                            if len(trans) else data, 0)
            self.dicts[col.name] = d_new
            old.collation = col.collation
        elif ok == nk and not (ok == TypeKind.DECIMAL
                               and old.type_.scale != col.type_.scale):
            conv = data
        elif ok not in ok_kinds or nk not in ok_kinds:
            lossy(f"cannot convert {ok.name} to {nk.name}")
        elif nk == TypeKind.BOOL:
            if ((data[chk] != 0) & (data[chk] != 1)).any():
                lossy("values outside 0/1 cannot become BOOL")
            conv = data.astype(np.bool_)
        elif {ok, nk} <= {TypeKind.INT, TypeKind.DECIMAL, TypeKind.BOOL}:
            # pure integer-domain scale shift: no float round trip, so
            # 18-digit decimals survive exactly
            shift = ((col.type_.scale if nk == TypeKind.DECIMAL else 0)
                     - (old.type_.scale if ok == TypeKind.DECIMAL else 0))
            src = np.where(chk, data.astype(np.int64), 0)
            if shift >= 0:
                mul = 10 ** shift
                if len(src) and np.abs(src).max() > (2 ** 63 - 1) // mul:
                    lossy(f"scale-up by {mul} overflows int64")
                conv = src * mul
            else:
                div = 10 ** (-shift)
                if (src[chk] % div != 0).any():
                    lossy(f"scale reduction loses digits (divide by {div})")
                conv = src // div
        elif nk == TypeKind.FLOAT:
            src = np.where(chk, data, np.zeros((), dtype=data.dtype))
            if np.issubdtype(src.dtype, np.integer) and len(src) and (
                    np.abs(src).max() > (1 << 53)):
                lossy("magnitudes above 2^53 lose precision in FLOAT")
            conv = src.astype(np.float64)
            if ok == TypeKind.DECIMAL:
                conv = conv / (10 ** old.type_.scale)
        elif ok == TypeKind.FLOAT and nk == TypeKind.DECIMAL:
            conv = np.round(data * 10 ** col.type_.scale)
            back = conv[chk] / (10 ** col.type_.scale)
            if not np.allclose(back, data[chk], rtol=0, atol=0.5 * 10 ** -col.type_.scale):
                lossy(f"values do not fit DECIMAL scale {col.type_.scale}")
            conv = conv.astype(np.int64)
        else:  # FLOAT -> INT
            if not np.allclose(data[chk], np.round(data[chk])):
                lossy("non-integral values")
            conv = np.round(data).astype(np.int64)

        if col.not_null and n and (
                ~valid[self.live_mask(0, n)]).any():
            lossy("NULLs present, NOT NULL requested")
        buf = np.zeros(self._cap, dtype=col.type_.np_dtype)
        buf[:n] = conv
        saved = self.data[col.name]
        self.data[col.name] = buf
        # a narrowing conversion (e.g. float -> decimal rounding) can
        # merge previously distinct unique keys: re-validate, and restore
        # the old column on violation so the table stays consistent
        try:
            for idx in self.indexes.values():
                if idx.unique and col.name in idx.columns:
                    self._check_unique(idx)
        except ExecutionError:
            self.data[col.name] = saved
            if saved_dict is not None:
                self.dicts[col.name] = saved_dict
                old.collation = saved_coll
            raise
        old.type_ = col.type_
        old.not_null = col.not_null
        if col.default is not None:
            old.default = col.default
        self.version += 1
        self.data_epoch += 1  # stored values converted in place

    # -- indexes -----------------------------------------------------------

    def create_index(self, name: str, columns: List[str],
                     unique: bool = False, state: str = "public") -> None:
        for c in columns:
            self.schema.col(c)  # raises if absent
        if name in self.indexes:
            raise SchemaError(f"duplicate index {name!r}")
        idx = IndexInfo(name=name, columns=list(columns), unique=unique,
                        state=state)
        if unique and state == "public":
            # atomic path validates now; a write_only (online DDL)
            # index defers existing-row validation to its backfill stage
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
        # mask compaction preserves relative order: a FULLY clustered
        # table stays clustered; a partial watermark would need per-row
        # accounting, so it conservatively resets
        self.clustered_rows = m if self.clustered_rows >= n else 0
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

    def recluster(self, quiesced: bool = False) -> bool:
        """Physically re-sort ALL rows by the CLUSTER BY column (ASC,
        NULLs first, stable — so same-key rows keep arrival order) so
        segment zone maps over the rebuild prune range filters. Returns True when rows actually moved (data_epoch bumps,
        invalidating the segment store for an ordered rebuild).

        Row positions may only move under the catalog's writer lock
        with NO transaction open — the same contract as gc(): txn write
        logs address rows by position, and _run_dml's collect-to-apply
        window assumes positions are stable while it holds the catalog
        lock. Open txns are NOT the only readers of physical positions:
        an autocommit SELECT reads the live arrays lock-free (it never
        enters _open_txns), so the permute additionally requires the
        catalog's reader registry to be quiescent — no registered
        statement window, no open scan executor or paged cursor — and
        holds the registry lock across the move so no new reader can
        start mid-permute. ``quiesced=True`` is the catalog's own
        run_pending_reclusters path, which already holds that lock.
        Refusals return False; the queued fold retries at a later
        statement boundary. Catalog-less tables (unit fixtures) fall
        back to the table-local evidence of an open txn: provisional
        begin/end timestamps, pessimistic row locks, provisionally-ended
        rows."""
        col = self.schema.cluster_by
        if not col or col not in self.data or self.n <= 1:
            return False
        if self.clustered_rows >= self.n:
            return False  # already in order
        guard = self.txn_guard
        if guard is None:
            return self._recluster_locked()
        with guard.lock:
            if guard._open_txns:
                return False
            if quiesced:
                return self._recluster_locked()
            with guard._readers_lock:
                if guard._stmt_readers or guard._open_scans:
                    return False
                return self._recluster_locked()

    def _recluster_locked(self) -> bool:
        """The permute body; caller holds the catalog lock (or owns the
        table outright). The table-local open-txn checks stay as
        defense in depth for catalog-less tables."""
        col = self.schema.cluster_by
        n = self.n
        if self.clustered_rows >= n:
            return False  # raced: another caller sorted first
        if self.row_locks or self._txn_dead:
            return False
        b, e = self.begin_ts[:n], self.end_ts[:n]
        if (b >= TXN_TS_BASE).any() or \
                ((e >= TXN_TS_BASE) & (e < MAX_TS)).any():
            return False
        d, v = self.data[col][:n], self.valid[col][:n]
        if np.issubdtype(d.dtype, np.floating):
            key = d.astype(np.float64)
        else:
            # dict codes order lexicographically by construction, so
            # sorting string/date columns by code is sorting by value
            key = d.astype(np.int64)
        key = np.where(v, key, 0)
        order = _cluster_order(key, v)
        if (order == np.arange(n)).all():
            self.clustered_rows = n  # already sorted: watermark only
            return False
        # permute into FRESH buffers first — each fancy-index allocates
        # (tens of MB per column at SF1), and a MemoryError halfway
        # through an in-place loop would leave some columns permuted
        # and others not, permanently. The install below is plain
        # buffer copies into existing storage: nothing left to fail.
        # Both run column by column on the host's threads (460 MB a
        # column at SF10: a gather is memory-latency bound)
        arrays = ([self.data[name] for name in self.data]
                  + [self.valid[name] for name in self.data]
                  + [self.begin_ts, self.end_ts])
        moved = host_map(lambda a: a[:n][order], arrays)

        def install(pair):
            pair[0][:n] = pair[1]

        host_map(install, list(zip(arrays, moved)))
        self.clustered_rows = n
        self.data_epoch += 1  # physical row positions moved
        self.version += 1
        return True

    def truncate(self):
        if any(child is not self for child, _fk in self.referencing):
            raise ExecutionError(
                f"cannot truncate {self.schema.name!r}: referenced by a "
                "foreign key")
        self.n = 0
        self.version += 1
        self.data_epoch += 1  # every stored payload discarded
        self.clustered_rows = 0
        self.begin_ts[:] = 0
        self.end_ts[:] = MAX_TS
        for c in self.schema.columns:
            # valid[] must clear: insert paths that omit a column rely on
            # stale slots reading as NULL
            self.valid[c.name][:] = False
            self.data[c.name][:] = 0
            if c.type_.is_dict_encoded:
                self.dicts[c.name] = Dictionary([], c.coll)

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

    def _check_partition(self, start: int, end: int) -> None:
        """RANGE partitioning without a MAXVALUE partition rejects
        out-of-range rows at write time (MySQL: 'no partition for
        value')."""
        pi = self.schema.partition
        if pi is None or pi.kind != "range" or pi.uppers[-1] is None:
            return
        vals = self.data[pi.column][start:end]
        valid = self.valid[pi.column][start:end]
        pids = pi.ids_of_values(vals, valid)
        if (pids[valid] >= pi.count()).any():
            bad = vals[valid][pids[valid] >= pi.count()][0]
            raise ExecutionError(
                f"table {self.schema.name!r} has no partition for "
                f"value {int(bad)}")

    def partition_rows(self, pids, read_ts=None, marker: int = 0) -> np.ndarray:
        """Visible physical rows in the given partitions, via a
        per-version cache of partition -> physical row ids (one
        vectorized pass over the partition column; the pruned-scan
        analogue of the sorted index cache)."""
        pi = self.schema.partition
        assert pi is not None
        hit = getattr(self, "_part_cache", None)
        if hit is None or hit[0] != self.version:
            vals = self.data[pi.column][: self.n]
            valid = self.valid[pi.column][: self.n]
            all_pids = pi.ids_of_values(vals, valid)
            by_pid = {}
            for pid in range(pi.count() + 1):  # +1: overflow bucket
                rows = np.nonzero(all_pids == pid)[0]
                if len(rows):
                    by_pid[pid] = rows
            hit = (self.version, by_pid)
            self._part_cache = hit
        rows = [hit[1].get(int(p), np.zeros(0, dtype=np.int64))
                for p in pids]
        allrows = np.sort(np.concatenate(rows)) if rows else \
            np.zeros(0, dtype=np.int64)
        return self._mvcc_visible(allrows, read_ts, marker)
