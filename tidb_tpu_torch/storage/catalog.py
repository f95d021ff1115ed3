"""Catalog: databases -> tables (a trimmed copy of
tidb_tpu/storage/catalog.py).

In-memory and schema-versioned (a schema change clears the device buffer
cache), with the timestamp oracle every table
stamps its commits from. This slice keeps databases, tables, views and
the TSO. Not yet ported: information_schema, users and privileges,
plugins, bindings, the DDL owner and job queue, the plan cache, statement
summaries, transactions' 2PC status records and GC.
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass, field
from typing import Dict, List

from tidb_tpu_torch.errors import DuplicateTableError, SchemaError
from tidb_tpu_torch.storage.table import Table, TableSchema

__all__ = ["Database", "Catalog"]


@dataclass
class Database:
    name: str
    tables: Dict[str, Table] = field(default_factory=dict)
    # views: name -> (explicit column names or None, SELECT ast, sql text)
    views: Dict[str, tuple] = field(default_factory=dict)


class Catalog:
    def __init__(self):
        # statement-granularity writer lock: the host storage layer is
        # single-writer by design
        self.lock = threading.RLock()
        self.databases: Dict[str, Database] = {"test": Database("test")}
        self._schema_version = 0
        # cluster-wide GLOBAL sysvars (ref: mysql.global_variables)
        self.global_vars: Dict[str, object] = {}
        # timestamp oracle (ref: PD TSO; monotonically increasing, shared
        # by every table in this catalog)
        self._ts = 0

    @property
    def schema_version(self) -> int:
        return self._schema_version

    @schema_version.setter
    def schema_version(self, v: int) -> None:
        self._schema_version = int(v)
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

    def next_ts(self) -> int:
        self._ts += 1
        return self._ts

    @property
    def current_ts(self) -> int:
        return self._ts

    def create_database(self, name: str, if_not_exists: bool = False):
        if name in self.databases:
            if if_not_exists:
                return
            raise DuplicateTableError(f"database {name!r} exists")
        self.databases[name] = Database(name)
        self.schema_version += 1

    def database(self, name: str) -> Database:
        db = self.databases.get(name)
        if db is None:
            raise SchemaError(f"no database {name!r}")
        return db

    # -- tables ------------------------------------------------------------

    def create_table(self, db: str, schema: TableSchema,
                     if_not_exists: bool = False) -> Table:
        d = self.database(db)
        if schema.name in d.tables:
            if if_not_exists:
                return d.tables[schema.name]
            raise DuplicateTableError(f"table {schema.name!r} exists")
        if schema.name in d.views:
            if if_not_exists:
                return None
            raise DuplicateTableError(f"view {schema.name!r} exists")
        t = Table(schema)
        t.ts_source = self.next_ts
        d.tables[schema.name] = t
        self.schema_version += 1
        return t

    def drop_table(self, db: str, name: str, if_exists: bool = False):
        d = self.database(db)
        if name not in d.tables:
            if if_exists:
                return
            raise SchemaError(f"no table {db}.{name}")
        # columnar segment store: release spilled payloads promptly (a
        # weakref finalizer on the store backstops tables dropped by GC)
        store = getattr(d.tables[name], "_segment_store", None)
        if store is not None:
            try:
                store.close()
            except Exception:  # noqa: BLE001 — cleanup must not block DROP
                pass
        del d.tables[name]
        self.schema_version += 1

    def table(self, db: str, name: str) -> Table:
        d = self.database(db)
        t = d.tables.get(name)
        if t is None:
            raise SchemaError(f"no table {db}.{name}")
        return t

    def has_table(self, db: str, name: str) -> bool:
        return name in self.databases.get(db, Database(db)).tables

    def tables(self, db: str) -> List[str]:
        return sorted(self.database(db).tables.keys())

    def view(self, db: str, name: str):
        d = self.databases.get(db)
        return d.views.get(name) if d is not None else None
