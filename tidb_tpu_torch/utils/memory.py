"""Memory tracking + spill (a copy of tidb_tpu/utils/memory.py; ref:
util/memory.Tracker tree with OOM actions, and util/chunk.RowContainer's
spill-to-disk).

A MemTracker forms a tree (query root -> operator trackers). consume()
propagates to the root, where the budget lives. On exceeding the budget
the tracker first asks its registered spillables to shed host memory
(largest consumer first — the reference's SpillDiskAction); if nothing
can spill, it cancels the query (the reference's PanicOnExceed/Cancel
action).

Tracked: host-side state (segment payloads a scan pins, sort runs, agg
state) and the device bytes a statement keeps in flight (the pipeline's
prefetch window and buffer-cache fill). The reference's metrics calls
are plain module-level counters here (`MEM_QUOTA_ENGAGED`,
`SPILL_TOTAL`). The account lock is registered with the runtime
sanitizer's lock-order witness, and release()/detach() report a double
release and a residual to it (analysis/sanitizer.py).
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import List, Optional

from tidb_tpu_torch.analysis import sanitizer as _san
from tidb_tpu_torch.errors import ExecutionError

__all__ = ["MemTracker", "QueryOOMError", "SpillFile", "SpillableRuns",
           "spill_root_of", "MEM_QUOTA_ENGAGED", "SPILL_TOTAL"]

# statements whose tracker crossed its budget once (the reference's
# MEM_QUOTA_ENGAGED metric)
MEM_QUOTA_ENGAGED = [0]
# host spills of SpillableRuns: count and bytes (SPILL_TOTAL/SPILL_BYTES)
SPILL_TOTAL = {"spills": 0, "bytes": 0}

# One process-wide reentrant lock for tracker-tree accounting: the
# pipeline staging thread and the serving tier's concurrent
# statements both consume() into shared parent trackers, and the
# read-modify-write on `consumed` must not interleave across threads.
# Reentrant because _on_exceed -> spill() re-enters release()/consume()
# on the same thread. Spill I/O under the lock is acceptable: it only
# happens past the budget, where correctness beats concurrency.
# Registered with the sanitizer's lock witness so orders through it are
# recorded.
_ACCOUNT_LOCK = _san.tracked_lock("memory._ACCOUNT_LOCK", threading.RLock)


def spill_root_of(tracker: "MemTracker") -> "MemTracker":
    """The tracker spillables anchor on: the nearest statement-level
    spill root up the parent chain (falling back to the chain's top).
    The ONE definition of the protocol walk — SpillableRuns and the
    columnar ScanPin both register through it."""
    root = tracker
    while root.parent is not None and not root.spill_root:
        root = root.parent
    return root


class QueryOOMError(ExecutionError):
    pass


class MemTracker:
    def __init__(self, label: str = "query", budget: Optional[int] = None,
                 parent: Optional["MemTracker"] = None, spill_enabled: bool = True,
                 spill_root: bool = False):
        self.label = label
        self.budget = budget
        self.parent = parent
        self.spill_enabled = spill_enabled
        # marks the statement-level tracker: spillables anchor here even
        # when the serving tier parents it under session/server trackers
        # (those aggregate accounting only — operator state from one
        # statement must never spill in response to ANOTHER statement's
        # pressure, and their budgets cancel rather than spill)
        self.spill_root = spill_root
        self.consumed = 0
        self.max_consumed = 0
        self._quota_engaged = False  # first budget crossing counted once
        self._spillables: List[object] = []  # objects with spill() -> int

    def child(self, label: str) -> "MemTracker":
        return MemTracker(label, parent=self)

    def detach(self) -> None:
        """Disconnect from the parent chain, returning any un-released
        residual consumption to the ancestors. Statement end under the
        serving tier: operator state the statement never release()d
        (freed wholesale with the executor tree) must not leak into the
        session/server accounting forever."""
        with _ACCOUNT_LOCK:
            p, self.parent = self.parent, None
            if p is None or self.consumed == 0:
                return
            n = self.consumed
            if _san.enabled() and n > 0:
                # leak witness: bytes the statement consumed and never
                # released — detach reclaims them, the sanitizer makes
                # them visible
                _san.note_tracker_detach(self.label, n)
            node = p
            while node is not None:
                node.consumed -= n
                node = node.parent

    def register_spillable(self, obj) -> None:
        self._spillables.append(obj)

    def unregister_spillable(self, obj) -> None:
        if obj in self._spillables:
            self._spillables.remove(obj)

    def consume(self, nbytes: int) -> None:
        """Charge `nbytes` to this tracker and every ancestor, then run the
        budget checks. The charge is recorded on the whole chain before any
        check can raise QueryOOMError, so a caller that counted the bytes
        before the call releases exactly what was charged, on the error
        path too. (The reference checks each node as it charges it: an OOM
        raised at the statement's root left the ancestors above it
        uncharged, and a caller's release then took them below zero.)"""
        with _ACCOUNT_LOCK:
            node = self
            while node is not None:
                node.consumed += nbytes
                node.max_consumed = max(node.max_consumed, node.consumed)
                node = node.parent
            node = self
            while node is not None:
                if node.budget is not None and node.consumed > node.budget:
                    # lint: disable=blocking-under-lock -- deliberate:
                    # past the budget, spill I/O runs under the account
                    # lock — correctness beats concurrency there (module
                    # doc); re-entrancy is why the lock is an RLock
                    node._on_exceed()
                node = node.parent

    def release(self, nbytes: int) -> None:
        with _ACCOUNT_LOCK:
            if _san.enabled() and nbytes > 0 and \
                    self.consumed - nbytes < 0 <= self.consumed:
                # crossing zero on THIS release = some charge returned
                # twice (fatal finding; reported once per crossing)
                _san.note_tracker_release(self.label,
                                          self.consumed - nbytes)
            node = self
            while node is not None:
                node.consumed -= nbytes
                node = node.parent

    # ------------------------------------------------------------------

    def _on_exceed(self) -> None:
        if not self._quota_engaged:
            self._quota_engaged = True
            MEM_QUOTA_ENGAGED[0] += 1
        # shed the largest spillable first until we're back under budget;
        # spillables register on the budget-holding (root) tracker
        while self.budget is not None and self.consumed > self.budget:
            candidates = [s for s in self._spillables if s.spillable_bytes() > 0]
            if not candidates:
                raise QueryOOMError(
                    f"Out Of Memory Quota! [budget={self.budget} consumed={self.consumed}]"
                )
            biggest = max(candidates, key=lambda s: s.spillable_bytes())
            freed = biggest.spill()
            if freed <= 0:
                raise QueryOOMError(
                    f"Out Of Memory Quota! [budget={self.budget} consumed={self.consumed}]"
                )


class SpillFile:
    """A spilled batch of named numpy arrays, one .npy per array so reads
    can be mmap-backed (row gathers touch only the needed pages)."""

    def __init__(self, arrays: dict, spill_dir: Optional[str] = None):
        import numpy as np

        self.dir = tempfile.mkdtemp(prefix="tidb_tpu_spill_", dir=spill_dir)
        self.names = list(arrays)
        self.nbytes = 0
        self.rows = 0
        for name, a in arrays.items():
            np.save(os.path.join(self.dir, f"{name}.npy"), a)
            self.nbytes += a.nbytes
            self.rows = len(a)

    def load(self, name: str):
        import numpy as np

        return np.load(os.path.join(self.dir, f"{name}.npy"), mmap_mode="r")

    def close(self) -> None:
        import shutil

        shutil.rmtree(self.dir, ignore_errors=True)


class SpillableRuns:
    """Chunk-wise accumulator of named numpy arrays that can shed its
    buffer to disk under memory pressure (the RowContainer analogue).

    Arrays in one append() call must share a row count. Registered on the
    budget-holding tracker; consume() may re-enter via spill()."""

    def __init__(self, tracker: MemTracker, label: str = "runs"):
        self.tracker = tracker
        root = spill_root_of(tracker)
        self._root = root
        if root.spill_enabled:
            root.register_spillable(self)
        self.buf: dict = {}
        self.buf_bytes = 0
        self.files: List[SpillFile] = []
        self.closed = False
        self._frozen: Optional[dict] = None

    def append(self, named: dict) -> None:
        for k, a in named.items():
            self.buf.setdefault(k, []).append(a)
        b = int(sum(a.nbytes for a in named.values()))
        self.buf_bytes += b
        self.tracker.consume(b)  # may call back into self.spill()

    def spillable_bytes(self) -> int:
        return self.buf_bytes

    def spill(self) -> int:
        if self.buf_bytes == 0:
            return 0
        import numpy as np

        if self._frozen is not None:
            # appends may have landed after a reader froze the buffer —
            # spill both, or rows would silently vanish
            arrays = {
                k: (np.concatenate([self._frozen[k]] + self.buf[k])
                    if self.buf.get(k) else self._frozen[k])
                for k in self._frozen
            }
        else:
            arrays = {k: np.concatenate(v) for k, v in self.buf.items()}
        if not arrays:
            return 0
        self.files.append(SpillFile(arrays))
        freed = self.buf_bytes
        self.buf = {}
        self._frozen = None
        self.buf_bytes = 0
        self.tracker.release(freed)
        SPILL_TOTAL["spills"] += 1
        SPILL_TOTAL["bytes"] += freed
        from tidb_tpu_torch.utils import dispatch as _dsp

        _dsp.record_spill(freed)  # the statement's profile
        return freed

    @property
    def spilled(self) -> bool:
        return bool(self.files)

    def freeze(self) -> None:
        """Collapse the chunk-list buffer into single arrays (call once,
        after the last append; repeated all_runs() calls then share them)."""
        import numpy as np

        if self._frozen is None and any(self.buf.values()):
            self._frozen = {k: np.concatenate(v) for k, v in self.buf.items()}
            self.buf = {}

    def in_memory(self) -> dict:
        self.freeze()
        return self._frozen or {}

    def all_runs(self):
        """[(loader, rows)] across spilled files + the resident buffer.
        loader(name) returns that run's array (mmap-backed for files)."""
        runs = [(f.load, f.rows) for f in self.files]
        mem = self.in_memory()
        if mem:
            rows = len(next(iter(mem.values())))
            runs.append((lambda name, _m=mem: _m[name], rows))
        return runs

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        for f in self.files:
            f.close()
        self.files = []
        self.tracker.release(self.buf_bytes)
        self.buf = {}
        self.buf_bytes = 0
        self._root.unregister_spillable(self)
