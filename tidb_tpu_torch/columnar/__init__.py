"""Columnar segment store (the counterpart of tidb_tpu/columnar/).

The layer between host table storage (`storage/table.py`) and the
executors: a table's physical rows are sliced into fixed-capacity
immutable **segments**, each holding

  * per-column ENCODED payloads: dictionary codes and integer-backed
    kinds (INT/DECIMAL/DATE/DATETIME/TIME/ENUM/SET) stored
    frame-of-reference in the narrowest signed dtype that holds the
    value range, floats and bools raw, so the bytes staged host->device
    shrink with the data (`encoding.py`);
  * per-column **zone maps** (min/max/null_count/NDV) consulted by scan
    planning against pushed-down range/equality predicates to skip
    whole segments before any staging (`zonemap.py`), and doubling as
    the planner's fallback statistics (`statistics.zone_map_stats`);
  * a spill lifecycle: cold segments serialize to disk (`spillfile.py`)
    under memory pressure through the statement MemTracker's spill
    protocol and re-materialize on demand (`store.py`).

Delta rows (physical rows appended after the last segment build) stay on
the raw scan path and merge at scan time; MVCC visibility is read live
from the table. In-place rewrites of existing rows (the dictionary
re-encode, GC, column DDL, a CLUSTER BY re-sort) bump `Table.data_epoch`,
which invalidates the whole store. Deltas past
`tidb_tpu_segment_delta_rows` fold on the background compaction worker
(`compaction.py`) or, with `tidb_tpu_compaction` off, inline at the
next scan.
"""

from tidb_tpu_torch.columnar.store import (  # noqa: F401
    SegmentStore,
    build_for_result,
    store_for,
)
from tidb_tpu_torch.columnar.zonemap import collect_prune_bounds  # noqa: F401

__all__ = ["SegmentStore", "store_for", "build_for_result", "collect_prune_bounds"]
