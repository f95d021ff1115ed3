"""Two-phase commit over the columnar storage (a copy of
tidb_tpu/storage/txn2pc.py; ref: store/tikv's
twoPhaseCommitter + the Percolator model: prewrite locks -> primary
commit point -> secondary commits, with lock resolution on recovery).

In this engine a txn's provisional writes are already "locks": rows it
inserted carry begin_ts=marker and rows it ended carry end_ts=marker
(both > any read_ts, so invisible/blocking to others). The committer
adds the structure the reference has:

  1. PREWRITE  — validate every logged lock is still ours (the analogue
                 of prewrite's conflict check; single-writer storage
                 makes this a sanity pass, but it is the extension point
                 for a multi-writer backend)
  2. COMMIT POINT — one atomic write: the catalog's txn-status record
                 (marker -> committed@ts). This is the Percolator
                 primary: after it, the txn IS committed even if the
                 process dies before any table is touched.
  3. SECONDARIES — rewrite each table's markers to the commit ts
                 (idempotent; crash here leaves residue that
                 resolve_locks finishes from the status record).

Failpoints at every boundary let tests kill the commit mid-flight and
assert atomicity across the "restart" (catalog.resolve_locks)."""

from __future__ import annotations

from typing import List, Tuple

from tidb_tpu_torch.errors import ExecutionError
from tidb_tpu_torch.utils.failpoint import inject

__all__ = ["TwoPhaseCommitter"]


class TwoPhaseCommitter:
    def __init__(self, catalog, marker: int, logs: List[Tuple[object, object]]):
        self.catalog = catalog
        self.marker = marker
        self.logs = logs

    # ------------------------------------------------------------------

    def _prewrite(self, table, log) -> None:
        """Every lock this txn took must still be ours."""
        import numpy as np

        for s, e in log.ranges:
            b = table.begin_ts[s:e]
            if not (b[b >= self.marker] == self.marker).all():
                raise ExecutionError(
                    f"prewrite conflict on {table.schema.name!r}: "
                    "provisional rows clobbered")
        for ids in log.ended:
            if len(ids) == 0:
                continue
            e_ = table.end_ts[np.asarray(ids)]
            from tidb_tpu_torch.storage.table import MAX_TS

            theirs = (e_ != self.marker) & (e_ < MAX_TS)  # not ours, not open
            if theirs.any():
                raise ExecutionError(
                    f"prewrite conflict on {table.schema.name!r}: "
                    "lock lost to another transaction")

    def execute(self) -> int:
        """Run the full protocol; returns the commit timestamp."""
        inject("2pc.before_prewrite")
        for t, log in self.logs:
            self._prewrite(t, log)
            inject("2pc.after_prewrite_one")

        inject("2pc.before_commit_point")
        commit_ts = self.catalog.commit_point(self.marker)
        inject("2pc.after_commit_point")

        for t, log in self.logs:
            inject("2pc.before_secondary")
            t.txn_commit(self.marker, commit_ts, log)
        self.catalog.finish_txn(self.marker)
        return commit_ts

    def rollback(self) -> None:
        """Aborted txn: record the decision, then erase the locks."""
        self.catalog.abort_point(self.marker)
        inject("2pc.after_abort_point")
        for t, log in self.logs:
            inject("2pc.before_rollback_one")
            t.txn_rollback(self.marker, log)
        self.catalog.finish_txn(self.marker)
