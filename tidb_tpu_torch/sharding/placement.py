"""Shard placement policy: where every row of a SHARD BY table lives.

The map is pure metadata (``storage/table.py``'s ``ShardByInfo``
persists it; this module is the math): a row's shard comes from its
shard-key value, a shard's owner comes from round-robin over the worker
fleet, and both sides of every exchange — the coordinator routing
loads/DML, and the workers partitioning shuffle sends — MUST agree on
the same functions, so they all live here.

Hash placement uses the same 64-bit odd-multiplier mix as the fragment
tier's all_to_all repartition (``parallel/distsql._hash_dest``): a
hash-placed table whose shard column IS the join key and whose shard
count is a multiple of the worker count is therefore CO-LOCATED with a
hash shuffle's destinations — ``(mix(k) % (m*W)) % W == mix(k) % W`` —
and the planner skips its exchange entirely.

NULL shard keys land in shard 0 (MySQL's NULL-partition convention);
they are placed, scanned, and joined like any other value — a NULL key
simply never matches in a join, which the local executors already
handle."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["ShardMap", "shard_of_array", "shard_of_value",
           "worker_of_shard", "owners_by_worker", "with_n_workers",
           "shards_to_move"]

# keep in sync with parallel/distsql._HASH_MULT — co-location between a
# hash placement and a hash shuffle depends on the identical mix
_HASH_MULT = np.int64(-7046029254386353131)  # 0x9E3779B97F4A7C15 as int64


@dataclass(frozen=True)
class ShardMap:
    """Immutable snapshot of one table's placement: the ShardByInfo
    fields plus the worker-fleet width it was resolved against. Frozen
    so a statement that captured a map mid-reshard keeps routing
    consistently until it finishes; `version` tells stale from fresh."""

    kind: str                       # "hash" | "range"
    column: str
    shards: int
    n_workers: int
    bounds: Tuple[int, ...] = ()    # range only: ascending uppers
    version: int = 0

    @classmethod
    def from_info(cls, info, n_workers: int) -> "ShardMap":
        return cls(kind=info.kind, column=info.column, shards=info.shards,
                   n_workers=n_workers, bounds=tuple(info.bounds),
                   version=info.version)

    def to_wire(self) -> Dict:
        """DCN-codec-serializable form: scatter RPCs ship the map so
        both ends of an exchange route with identical arithmetic."""
        return {"kind": self.kind, "column": self.column,
                "shards": self.shards, "n_workers": self.n_workers,
                "bounds": list(self.bounds), "version": self.version}

    @classmethod
    def from_wire(cls, w: Dict) -> "ShardMap":
        return cls(kind=w["kind"], column=w["column"],
                   shards=int(w["shards"]), n_workers=int(w["n_workers"]),
                   bounds=tuple(w.get("bounds") or ()),
                   version=int(w.get("version") or 0))

    def shard_of(self, value: Optional[int]) -> int:
        return shard_of_value(self, value)

    def worker_of(self, shard: int) -> int:
        return worker_of_shard(shard, self.n_workers)

    def owners(self) -> Dict[int, List[int]]:
        return owners_by_worker(self.shards, self.n_workers)

    def colocated_on(self, key_column: str) -> bool:
        """True when a hash shuffle on `key_column` would route every
        row to the worker that already owns it (see module doc)."""
        return (self.kind == "hash" and key_column == self.column
                and self.shards % self.n_workers == 0)


def _mix(values: np.ndarray) -> np.ndarray:
    h = values.astype(np.int64, copy=False) * _HASH_MULT
    return h


def shard_of_array(smap: ShardMap, values: np.ndarray,
                   valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Vectorized row -> shard id. NULL (invalid) rows -> shard 0."""
    values = np.asarray(values)
    if smap.kind == "hash":
        with np.errstate(over="ignore"):
            dest = ((_mix(values) % smap.shards) + smap.shards) % smap.shards
    else:
        bounds = np.asarray(smap.bounds, dtype=np.int64)
        dest = np.searchsorted(bounds, values.astype(np.int64, copy=False),
                               side="right")
    dest = dest.astype(np.int64, copy=False)
    if valid is not None:
        dest = np.where(np.asarray(valid, dtype=bool), dest, 0)
    return dest


def shard_of_value(smap: ShardMap, value: Optional[int]) -> int:
    """Scalar form (shard-key equality pruning on the coordinator)."""
    if value is None:
        return 0
    return int(shard_of_array(smap, np.asarray([value], dtype=np.int64))[0])


def worker_of_shard(shard: int, n_workers: int) -> int:
    """Round-robin shard -> worker assignment. Deterministic and
    fleet-width-pure: every process derives the same owner without a
    placement service round trip."""
    return int(shard) % max(int(n_workers), 1)


def owners_by_worker(shards: int, n_workers: int) -> Dict[int, List[int]]:
    """worker index -> shard ids it owns (workers owning none are
    absent — exactly the set a sharded scan must NOT dispatch to)."""
    out: Dict[int, List[int]] = {}
    for s in range(shards):
        out.setdefault(worker_of_shard(s, n_workers), []).append(s)
    return out


def with_n_workers(smap: ShardMap, n_workers: int) -> ShardMap:
    """Same placement math, re-resolved against a different fleet width
    (membership change): shard ids are untouched — only the round-robin
    shard->worker assignment moves, which keeps the co-location identity
    `(mix(k) % (m*W')) % W' == mix(k) % W'` intact for the NEW W'.
    Bumps `version` so cached plans demote like any other map change."""
    return ShardMap(kind=smap.kind, column=smap.column, shards=smap.shards,
                    n_workers=int(n_workers), bounds=smap.bounds,
                    version=smap.version + 1)


def shards_to_move(old: ShardMap, new: ShardMap) -> Dict[int, List[int]]:
    """Online-reshard work list: NEW-map shard id -> the old-map workers
    whose live rows can contain that shard's keys (the backfill sources).

    When only the fleet width changed (same kind/column/shards/bounds),
    each new shard IS an old shard, so its single source is its old
    owner — and shards whose owner doesn't move are skipped entirely.
    When the shard function itself changed (count, kind, or bounds),
    any old shard can contribute rows to any new shard, so every new
    shard backfills from every old owner."""
    same_fn = (old.kind == new.kind and old.column == new.column
               and old.shards == new.shards and old.bounds == new.bounds)
    out: Dict[int, List[int]] = {}
    old_workers = sorted(old.owners())
    for s in range(new.shards):
        if same_fn:
            src = worker_of_shard(s, old.n_workers)
            if src == worker_of_shard(s, new.n_workers):
                continue  # owner unchanged: nothing moves
            out[s] = [src]
        else:
            out[s] = list(old_workers)
    return out
