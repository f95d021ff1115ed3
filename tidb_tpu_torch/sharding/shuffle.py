"""Cross-process shuffle: the data plane of the DCN exchange.

Generalizes the fragment tier's all_to_all repartition
(``parallel/distsql.repartition_by_key``) to workers in separate
processes: the sender partitions its live rows by the join/placement
key with the SAME hash the device exchange uses, encodes each
destination's batch frame-of-reference compressed (the
``tidb_tpu_stage_encoded`` format — ``columnar.encoding.encode_column``
is the one encoder), and ships it over the DCN codec (numpy arrays are
first-class there). The receiver reassembles batches into staged
chunks through a ``ShuffleInbox`` whose bytes are charged to a
MemTracker — backpressure is a typed OOM on the sender's stage RPC,
never silent growth.

Transport stays in ``parallel/dcn.py``; this module is pure data:
extract -> partition -> encode | decode -> assemble. That split keeps
every socket call OUTSIDE the placement/inbox locks (the
blocking-under-lock pass enforces it — see
tests/analysis_fixtures/bad_shuffle_lock.py for the violation shape).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from tidb_tpu_torch.columnar.encoding import (
    INT_BACKED_KINDS,
    decode_host,
    Encoding,
    encode_column,
)
from tidb_tpu_torch.types import TypeKind

__all__ = ["extract_live_columns", "extract_rows", "live_shard_rows",
           "partition_rows", "encode_batch",
           "decode_batch", "batch_wire_bytes", "ShuffleInbox",
           "assemble_into_table"]


def extract_live_columns(table, columns: Optional[List[str]] = None
                         ) -> Tuple[Dict[str, np.ndarray],
                                    Dict[str, np.ndarray],
                                    Dict[str, list], int]:
    """(arrays, valids, strings, n_live) of a table's LIVE committed
    rows. String columns decode to python lists (their dict codes are
    process-local — codes from one worker mean nothing on another);
    everything else ships in its device repr."""
    n = table.n
    live = table.live_mask(0, n) if n else np.zeros(0, dtype=bool)
    idx = np.nonzero(live)[0]
    return extract_rows(table, idx, columns) + (len(idx),)


def live_shard_rows(table, smap, shard: int) -> np.ndarray:
    """Physical ids of the live rows that `smap` places in `shard`, read
    from the shard column alone (the other columns are extracted only
    for these rows)."""
    from tidb_tpu_torch.sharding.placement import shard_of_array

    n = table.n
    if not n:
        return np.zeros(0, dtype=np.int64)
    live = np.nonzero(table.live_mask(0, n))[0]
    shards = shard_of_array(smap, table.data[smap.column][:n][live],
                            table.valid[smap.column][:n][live])
    return live[shards == np.int64(shard)]


def extract_rows(table, idx: np.ndarray, columns: Optional[List[str]] = None
                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray],
                            Dict[str, list]]:
    """extract_live_columns' (arrays, valids, strings) for the physical
    rows `idx`, in their order."""
    names = columns or table.schema.public_names()
    n = table.n
    arrays: Dict[str, np.ndarray] = {}
    valids: Dict[str, np.ndarray] = {}
    strings: Dict[str, list] = {}
    for name in names:
        info = table.schema.col(name)
        d = table.data[name][:n][idx]
        v = table.valid[name][:n][idx]
        if info.type_.kind == TypeKind.STRING:
            strings[name] = table.dicts[name].decode(d, v)
        else:
            arrays[name] = d
            valids[name] = np.asarray(v, dtype=bool)
    return arrays, valids, strings


def partition_rows(arrays: Dict[str, np.ndarray],
                   valids: Dict[str, np.ndarray],
                   strings: Dict[str, list],
                   dest: np.ndarray, n_dests: int
                   ) -> List[Optional[Tuple[Dict, Dict, Dict]]]:
    """Split one extracted row set into per-destination row sets.
    ``dest`` is the row -> destination vector (from
    ``placement.shard_of_array`` composed with ``worker_of_shard``, or
    a broadcast constant). Destinations with no rows get None."""
    out: List[Optional[Tuple[Dict, Dict, Dict]]] = [None] * n_dests
    for w in range(n_dests):
        idx = np.nonzero(dest == w)[0]
        if len(idx) == 0:
            continue
        a = {k: v[idx] for k, v in arrays.items()}
        va = {k: v[idx] for k, v in valids.items()}
        st = {k: [v[i] for i in idx] for k, v in strings.items()}
        out[w] = (a, va, st)
    return out


def encode_batch(types: Dict[str, object], arrays: Dict[str, np.ndarray],
                 valids: Dict[str, np.ndarray],
                 strings: Dict[str, list]) -> Dict:
    """One destination's rows -> codec-serializable wire batch. Integer
    device reprs travel FoR-encoded in the narrowest dtype that covers
    their range (same selection rule as segment/staging encoding); the
    decode is ``stored + ref`` on the receiver."""
    cols: Dict[str, Dict] = {}
    n = 0
    for name, d in arrays.items():
        v = valids[name]
        n = len(d)
        t = types[name]
        if t.kind in INT_BACKED_KINDS and np.issubdtype(d.dtype, np.integer):
            enc, stored = encode_column(d, v, t)
            cols[name] = {"d": stored, "v": v, "ref": int(enc.ref),
                          "enc": enc.kind, "dt": enc.dtype}
        else:
            cols[name] = {"d": np.ascontiguousarray(d), "v": v,
                          "ref": 0, "enc": "raw", "dt": str(d.dtype)}
    for name, vals in strings.items():
        n = len(vals)
        cols[name] = {"s": list(vals)}
    return {"n": n, "cols": cols}


def decode_batch(types: Dict[str, object], batch: Dict
                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray],
                            Dict[str, list]]:
    """Wire batch -> (arrays, valids, strings) in full device reprs,
    ready for ``Table.insert_columns``."""
    arrays: Dict[str, np.ndarray] = {}
    valids: Dict[str, np.ndarray] = {}
    strings: Dict[str, list] = {}
    for name, col in batch["cols"].items():
        if "s" in col:
            strings[name] = col["s"]
            continue
        enc = Encoding(col["enc"], col["dt"], col["ref"])
        arrays[name] = decode_host(enc, col["d"], types.get(name))
        valids[name] = np.asarray(col["v"], dtype=bool)
    return arrays, valids, strings


def batch_wire_bytes(batch: Dict) -> int:
    """Approximate payload bytes of a wire batch — the number both the
    SHUFFLE_BYTES_TOTAL metric and the inbox MemTracker charge account
    in, so the observability and the backpressure agree."""
    total = 0
    for col in batch["cols"].values():
        if "s" in col:
            total += sum(len(s) + 1 if s is not None else 1
                         for s in col["s"])
        else:
            total += col["d"].nbytes + col["v"].nbytes
    return total


class ShuffleInbox:
    """Receiver-side staging area: batches arriving from peer workers,
    grouped by (shuffle id, side), charged to a MemTracker as they
    land and released when drained or closed.

    Lock discipline: ``_lock`` is a LEAF — batch bytes are charged to
    the tracker BEFORE the lock is taken (consume re-enters spill past
    the budget, and no socket recv ever happens under it; the
    transport hands fully-received batches in). A typed OOM from the
    tracker travels back to the sender as the stage RPC's error: that
    IS the backpressure.

    Abandoned shuffles (coordinator crashed between scatter and
    gather) reap on a TTL like worker cursors, releasing their
    tracker charge — chaos tests assert zero retained entries."""

    TTL_S = 600.0

    def __init__(self, tracker=None):
        self.tracker = tracker
        self._lock = threading.Lock()
        # shuffle id -> {"ts": last activity, "bytes": charged,
        #               "sides": {side: [batch, ...]}}
        self._entries: Dict[str, Dict] = {}

    def stage(self, shuffle_id: str, side: str, batch: Dict) -> int:
        """Accept one batch; returns its accounted bytes. Charges the
        tracker first (typed OOM propagates to the sender un-staged)."""
        nbytes = batch_wire_bytes(batch)
        if self.tracker is not None:
            try:
                self.tracker.consume(nbytes)
            except BaseException:
                # consume records the charge BEFORE the budget check
                # raises: undo it, or the refused batch's bytes would
                # poison every later stage (undo-and-reraise shape)
                self.tracker.release(nbytes)
                raise
        try:
            with self._lock:
                self._reap_locked()
                ent = self._entries.setdefault(
                    shuffle_id, {"ts": time.time(), "bytes": 0, "sides": {}})
                ent["ts"] = time.time()
                ent["bytes"] += nbytes
                ent["sides"].setdefault(side, []).append(batch)
        except Exception:
            if self.tracker is not None:
                self.tracker.release(nbytes)
            raise
        return nbytes

    def drain(self, shuffle_id: str, side: str) -> List[Dict]:
        """All batches staged for one side; the entry stays (other
        sides may still be pending) until close()."""
        with self._lock:
            ent = self._entries.get(shuffle_id)
            if ent is None:
                return []
            ent["ts"] = time.time()
            return list(ent["sides"].get(side, []))

    def close(self, shuffle_id: str) -> None:
        """Release one shuffle's staged batches and tracker charge.
        Idempotent — the coordinator's finally block and the TTL reaper
        may both reach a dead shuffle."""
        with self._lock:
            ent = self._entries.pop(shuffle_id, None)
        if ent is not None and self.tracker is not None and ent["bytes"]:
            self.tracker.release(ent["bytes"])

    def open_count(self) -> int:
        with self._lock:
            return len(self._entries)

    def staged_bytes(self) -> int:
        with self._lock:
            return sum(e["bytes"] for e in self._entries.values())

    def _reap_locked(self) -> None:
        now = time.time()
        stale = [sid for sid, e in self._entries.items()
                 if now - e["ts"] > self.TTL_S]
        for sid in stale:
            ent = self._entries.pop(sid)
            if self.tracker is not None and ent["bytes"]:
                # release under the lock is fine (pure accounting); the
                # CHARGE is what must stay outside
                self.tracker.release(ent["bytes"])


def assemble_into_table(session, table_name: str, types: Dict[str, object],
                        batches: List[Dict]) -> int:
    """Decode staged batches and bulk-insert them into `table_name` on
    the worker's catalog (the reassembled co-partitioned slice a
    shuffle_gather runs its partial SQL over). Returns rows landed."""
    t = session.catalog.table(session.db, table_name)
    total = 0
    for batch in batches:
        arrays, valids, strings = decode_batch(types, batch)
        if batch["n"] == 0:
            continue
        total += t.insert_columns(arrays, valids, strings=strings)
    return total
