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

This slice carries what bulk load and autocommit INSERT/SELECT need.
Not yet ported: UPDATE/DELETE and transactions, unique-key and foreign-key
enforcement, CHECK constraints, generated columns, partitions, indexes,
online DDL, GC and CLUSTER BY compaction. `indexes` stays empty, so the
planner never picks an index access path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from tidb_tpu_torch.chunk.dictionary import Dictionary
from tidb_tpu_torch.errors import ExecutionError, SchemaError, TypeError_
from tidb_tpu_torch.types import (
    SQLType,
    TypeKind,
    date_to_days,
    datetime_to_micros,
    decimal_to_scaled,
)

__all__ = ["ColumnInfo", "TableSchema", "Table", "TXN_TS_BASE", "MAX_TS"]


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
        # no index is ported yet: the planner's access paths see none
        self.indexes: Dict[str, object] = {}

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
                    begin_ts: Optional[int] = None) -> int:
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
        self.begin_ts[start:end] = self._next_ts() if begin_ts is None else begin_ts
        self.end_ts[start:end] = MAX_TS
        self.n = end
        self.version += 1
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
        self.begin_ts[start:end] = 0  # bulk loads are committed "at origin"
        self.end_ts[start:end] = MAX_TS
        self.n = end
        self.version += 1
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
        self.begin_ts[:m] = 0
        self.end_ts[:m] = MAX_TS
        self.n = m
        self.version += 1
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
