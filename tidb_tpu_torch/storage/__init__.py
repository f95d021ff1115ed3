"""Host-side storage layer (ref: kv/, store/mockstore, table/, meta/).

  table.py        -- TableSchema + Table: append-only columnar buffers in
                     device representation, MVCC visibility per row
  catalog.py      -- databases -> tables; schema versioning; the TSO;
                     information_schema; the per-session TEMPORARY overlay
  kvapi.py        -- the table-engine contract and `make_table` (a copy)
  delta.py        -- the write-optimized delta engine (a copy)
  tpch.py         -- the TPC-H generator (a copy) plus `load_arrays`,
                     which ingests tables exported from another engine
  native_gen.py   -- ctypes loader of native/libtpchgen.so (a copy)
  tpch_queries.py -- the TPC-H query texts (a copy)
"""

from tidb_tpu_torch.storage.table import ColumnInfo, Table, TableSchema
from tidb_tpu_torch.storage.catalog import Catalog, Database

__all__ = ["ColumnInfo", "Table", "TableSchema", "Catalog", "Database"]
