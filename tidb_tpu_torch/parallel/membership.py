"""Elastic topology: the coordinator-side primitives that make a
cluster membership or placement change a SERVED-THROUGH operation
instead of an outage.

Two pieces live here, both pure host logic (no sockets — the
blocking-under-lock pass governs this module, and every RPC belongs to
``parallel/dcn.py``):

* :class:`TableGates` — a per-table readers/writer gate. Statements
  read-acquire the tables they touch (shared); the online-reshard
  driver write-acquires ONE table for the brief per-shard backfill and
  cutover windows, and membership finalize write-acquires the global
  ``CLUSTER_GATE`` entry every statement also holds. Writer-priority
  (a waiting writer blocks NEW readers) so a cutover is never starved
  by a stream of scans, and every wait is BOUNDED — a stuck topology
  change degrades statements typed, never hangs them.

* :func:`rows_fingerprint` — the order-independent row-set hash the
  per-shard cutover validates with: the sum of the sources' fingerprints
  over the moving shard must equal the destination staging table's
  fingerprint, or the shard does not flip. Order-independent because
  the backfill's extract order and the double-write arrival order are
  not the storage order.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Dict, Iterable, List, Optional

__all__ = ["TableGates", "CLUSTER_GATE", "rows_fingerprint"]

# the gate entry EVERY statement read-acquires alongside its tables:
# membership finalize (compacting the socket fleet) write-acquires it,
# so no statement can be mid-flight over a worker index being removed
CLUSTER_GATE = "__cluster__"


class _Gate:
    __slots__ = ("readers", "writer", "writer_waiting")

    def __init__(self) -> None:
        self.readers = 0
        self.writer = False
        self.writer_waiting = 0


class TableGates:
    """Per-table shared/exclusive gate with writer priority and bounded
    waits. One Condition guards every entry: acquisitions over MULTIPLE
    names are atomic (all-or-wait), so a statement's read set and a
    cutover's write never deadlock on ordering."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._gates: Dict[str, _Gate] = {}

    def _gate(self, name: str) -> _Gate:
        g = self._gates.get(name)
        if g is None:
            g = self._gates[name] = _Gate()
        return g

    def acquire_read(self, names: Iterable[str],
                     timeout_s: float = 10.0) -> List[str]:
        """Shared-acquire every name (atomically); returns the token to
        hand back to :meth:`release_read`. A waiting or active writer on
        ANY name blocks the whole set (writer priority). Times out
        TYPED via ``TimeoutError`` — the caller re-raises it as the
        statement-facing error naming what is being cut over."""
        names = sorted(set(names))
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while True:
                gates = [self._gate(n) for n in names]
                if not any(g.writer or g.writer_waiting for g in gates):
                    for g in gates:
                        g.readers += 1
                    return names
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    busy = [n for n, g in zip(names, gates)
                            if g.writer or g.writer_waiting]
                    raise TimeoutError(
                        f"gate(s) {busy} held for topology change")
                self._cond.wait(remaining)

    def release_read(self, token: List[str]) -> None:
        with self._cond:
            for n in token:
                g = self._gates.get(n)
                if g is not None and g.readers > 0:
                    g.readers -= 1
            self._cond.notify_all()

    def acquire_write(self, name: str,
                      timeout_s: float = 60.0) -> None:
        """Exclusive-acquire one name: waits out current readers while
        `writer_waiting` holds new ones at the door."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            g = self._gate(name)
            g.writer_waiting += 1
            try:
                while g.readers > 0 or g.writer:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"gate {name!r}: statements still hold it")
                    self._cond.wait(remaining)
                g.writer = True
            finally:
                g.writer_waiting -= 1
                self._cond.notify_all()

    def release_write(self, name: str) -> None:
        with self._cond:
            g = self._gates.get(name)
            if g is not None:
                g.writer = False
            self._cond.notify_all()


def rows_fingerprint(arrays: Dict, valids: Dict, strings: Dict,
                     columns: Iterable[str],
                     sel: Optional[object] = None) -> tuple:
    """(row_count, fingerprint) of an extracted row set — the
    ``shuffle.extract_live_columns`` shape, optionally restricted by a
    boolean ``sel`` mask. Order-independent: each row canonicalizes to
    a tuple repr (NULL-aware, numpy scalars unboxed so the same value
    fingerprints identically whatever dtype carried it), crc32s, and
    the fingerprints SUM mod 2**64 — so source shards hashed separately
    add up to the destination staging table hashed whole. The rows are
    built a column at a time (``tolist`` unboxes as ``item`` does, and a
    tuple's repr is its values' reprs joined by ", "), so the value is
    the reference's per-row loop's."""
    import numpy as np

    columns = list(columns)
    if sel is not None:
        idx = np.nonzero(np.asarray(sel, dtype=bool))[0]
    else:
        probe = next(iter(columns), None)
        if probe is None:
            return 0, 0
        n = (len(strings[probe]) if probe in strings
             else len(arrays[probe]))
        idx = np.arange(n)
    cols = []
    for c in columns:
        if c in strings:
            col = strings[c]
            cols.append(col if sel is None else [col[i] for i in idx.tolist()])
            continue
        vals = np.asarray(arrays[c])[idx].tolist()
        for i in np.nonzero(~np.asarray(valids[c], dtype=bool)[idx])[0].tolist():
            vals[i] = None
        cols.append(vals)
    # each row's tuple repr assembled from its values' reprs, a column
    # at a time: "(a, b)", and "(a,)" for one column
    reprs = [list(map(repr, col)) for col in cols]
    if not reprs:
        texts = ["()"] * len(idx)
    elif len(reprs) == 1:
        texts = map("({},)".format, reprs[0])
    else:
        texts = map("({})".format, map(", ".join, zip(*reprs)))
    fp = sum(map(zlib.crc32, map(str.encode, texts))) % (1 << 64)
    return int(len(idx)), fp
