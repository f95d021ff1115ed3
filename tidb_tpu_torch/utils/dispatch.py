"""Device-dispatch accounting (the counterpart of tidb_tpu/utils/dispatch.py).

``execdetails`` snapshots these counters around each operator's
open/next, so EXPLAIN ANALYZE shows per-operator launch counts, and the
statement's ``profile:`` line shows its transfer and build costs. The
reference counts XLA program dispatches; eager torch has no program to
count, so the port gives each name its torch meaning:

  - ``count``: launches of the port's own CUDA kernels, read from the
    wrappers' ``LAUNCHES`` counters (ops/segment_sum.py, ops/hash_probe.py);
    the plain versions a CPU tensor takes launch nothing
  - ``compile_count`` / ``compile_seconds``: nvcc builds of a kernel
    library at first use (ops/nvcc_build.py)
  - ``xfer_bytes``: host->device bytes staged (the fused pipeline's
    copies and the classic scan's)
  - ``spill_bytes``: bytes a statement spilled to disk (0: spill is not
    ported)

The counters are process-wide, not per thread as in the reference: the
prefetch thread stages a statement's batches, and the launch counters
they read are process-wide already.
"""

from __future__ import annotations

import threading

__all__ = ["count", "by_site", "record_xfer", "xfer_bytes", "record_compile",
           "compile_count", "compile_seconds", "spill_bytes"]

_lock = threading.Lock()
_xfer = 0
_compiles = 0
_compile_s = 0.0


def by_site() -> dict:
    """Launches per kernel entry (the wrappers' LAUNCHES, merged)."""
    from tidb_tpu_torch.ops import hash_probe, segment_sum

    return {**segment_sum.LAUNCHES, **hash_probe.LAUNCHES}


def count() -> int:
    """Kernel launches so far (the sum of every wrapper's count)."""
    return sum(by_site().values())


def record_xfer(nbytes: int) -> None:
    """Count host->device bytes, called where a staging copy is issued."""
    global _xfer
    with _lock:
        _xfer += int(nbytes)


def xfer_bytes() -> int:
    return _xfer


def record_compile(seconds: float, builds: int) -> None:
    """Count kernel libraries built by nvcc and the wall seconds taken."""
    global _compiles, _compile_s
    with _lock:
        _compiles += builds
        _compile_s += float(seconds)


def compile_count() -> int:
    return _compiles


def compile_seconds() -> float:
    return _compile_s


def spill_bytes() -> int:
    return 0
