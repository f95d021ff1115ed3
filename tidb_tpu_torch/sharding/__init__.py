"""Sharded table placement + cross-process shuffle.

Without placement, the DCN tier executes every query over fully
replicated or row-range-partitioned data: adding workers adds failover
paths but no capacity. This package makes data placement a first-class catalog
concept:

  * ``placement.py`` — the policy layer: hash/range shard maps driven
    by DDL (``SHARD BY HASH(col) SHARDS n``), persisted on
    ``TableSchema.shard_by`` and versioned so plan caches and placement
    snapshots invalidate on resharding; shard -> worker assignment and
    owner-set computation (scans dispatch ONLY to shard owners).
  * ``shuffle.py`` — the cross-process exchange generalizing the
    fragment tier's all_to_all repartition to DCN workers: rows
    partition by key on the sender, per-destination batches travel
    FoR-compressed (the encoded staging format), and the receiver
    reassembles them into staged chunks with backpressure charged to a
    MemTracker.

The coordinator half (owner-pruned dispatch, shuffle-join planning,
2PC distributed writes with crash recovery) lives in
``parallel/dcn.py`` — see README "Sharded placement"."""

from tidb_tpu_torch.sharding.placement import (  # noqa: F401
    ShardMap,
    owners_by_worker,
    shard_of_array,
    shard_of_value,
    worker_of_shard,
)
