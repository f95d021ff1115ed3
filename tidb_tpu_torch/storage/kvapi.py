"""The layered storage-engine boundary (a copy of
tidb_tpu/storage/kvapi.py).

Ref counterpart: the reference's kv/ abstraction — its SQL layer talks
to a pluggable Storage (TiKV / mockstore / unistore) through one
interface, so engines swap without the layers above noticing. Here the
swap point is the TABLE ENGINE behind the catalog: everything above
(planner, executors, txn layer, DDL, statistics) reaches tables only
through the surface named by `TABLE_ENGINE_API`, so an object providing
that surface is a storage engine, full stop.

Two engines ship:
  * ``columnar`` — `storage.table.Table`: read-optimized dense columnar
    arrays with MVCC version ranges (the default; what the segment
    store and the fused scan read).
  * ``delta`` — `storage.delta.DeltaTable`: write-optimized memtable +
    columnar base (the TiFlash delta-tree shape). Row-at-a-time INSERTs
    buffer as converted host rows — deferring the per-statement
    dictionary merge and columnar append that make string-heavy trickle
    ingest O(n) per row — and compact into the base in one bulk append
    on any read (or at the row threshold).

CREATE TABLE ... ENGINE=delta selects the engine per table;
`make_table` is the factory the catalog calls.
"""

from __future__ import annotations

from tidb_tpu_torch.errors import SchemaError

# The executor/planner/txn-facing surface of a table engine. This is a
# NAMED CONTRACT (kept in sync by
# tests/test_torch_engines.py::test_contract_both_engines): a new engine
# must provide every attribute here with Table's semantics.
TABLE_ENGINE_API = frozenset({
    # identity / shape
    "schema", "n", "version", "live_rows", "engine",
    # columnar payload access (scan surface)
    "data", "valid", "dicts", "column_slice", "live_mask",
    # MVCC metadata
    "begin_ts", "end_ts",
    # write surface
    "insert_rows", "insert_columns", "ingest_encoded", "update_rows",
    "truncate",
    # txn lifecycle
    "txn_commit", "txn_rollback",
    # indexes / point access
    "indexes", "index_lookup", "create_index", "drop_index",
    # maintenance
    "gc", "add_column", "drop_column", "modify_count",
    "maintenance_stats",
})

ENGINES = ("columnar", "delta")


def make_table(schema, engine=None):
    """Factory for the per-table storage engine (the catalog's single
    construction point; ref: kv.Storage selection at startup)."""
    from tidb_tpu_torch.storage.delta import DeltaTable
    from tidb_tpu_torch.storage.table import Table

    eng = (engine or "columnar").lower()
    if eng in ("columnar", "innodb", "tiflash"):  # accepted aliases
        return Table(schema)
    if eng == "delta":
        return DeltaTable(Table(schema))
    raise SchemaError(f"unknown storage engine {engine!r} "
                      f"(supported: {', '.join(ENGINES)})")


def conforms(table) -> list:
    """Names from TABLE_ENGINE_API the object is missing (empty = a
    valid engine)."""
    return sorted(n for n in TABLE_ENGINE_API if not hasattr(table, n))
