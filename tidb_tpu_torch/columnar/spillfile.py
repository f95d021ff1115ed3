"""Disk-backed segment payloads (a copy of
tidb_tpu/columnar/spillfile.py).

One ``.npz`` per spilled segment holding every column's encoded data
and validity arrays. Encodings, zone maps and the row range stay in
memory (they are tiny and pruning must keep working while the payload
is cold); only the bulk arrays round-trip through disk. Files are
written once — segment payloads are immutable until the store's epoch
invalidates them — so a re-evicted segment that already has a file
just drops its arrays.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["SegmentSpillFile", "make_spill_dir"]


def make_spill_dir(spill_dir: Optional[str]) -> str:
    """A fresh private directory for one store's spill files, under the
    configured tidb_tpu_columnar_spill_dir (system tmp when unset)."""
    return tempfile.mkdtemp(prefix="tidb_tpu_seg_", dir=spill_dir or None)


class SegmentSpillFile:
    """The on-disk form of one segment's encoded payload."""

    def __init__(self, dir_: str, tag: str):
        self.path = os.path.join(dir_, f"{tag}.npz")
        self.nbytes = 0

    @property
    def written(self) -> bool:
        return self.nbytes > 0

    def save(self, cols: List[Tuple[str, np.ndarray, np.ndarray]]) -> int:
        """Write (name, data, valid) triples; returns bytes written.
        Array keys are positional (d0/v0, ...) so column names never
        need filesystem escaping; the caller re-zips by its own column
        order, which is immutable for a segment's lifetime."""
        payload = {}
        total = 0
        for i, (_name, data, valid) in enumerate(cols):
            payload[f"d{i}"] = data
            payload[f"v{i}"] = valid
            total += data.nbytes + valid.nbytes
        np.savez(self.path, **payload)
        self.nbytes = total
        return total

    def load(self, n_cols: int) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Read back the positional (data, valid) pairs."""
        with np.load(self.path) as z:
            return [(z[f"d{i}"], z[f"v{i}"]) for i in range(n_cols)]

    def close(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass
        self.nbytes = 0
