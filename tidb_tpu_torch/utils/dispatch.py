"""Device-dispatch accounting (the counterpart of tidb_tpu/utils/dispatch.py).

``execdetails`` snapshots these counters around each operator's
open/next, so EXPLAIN ANALYZE shows per-operator launch counts, and the
statement's ``profile:`` line and the statements summary show its
transfer and build costs. The reference counts XLA program dispatches;
eager torch has no program to count, so the port gives each name its
torch meaning:

  - ``count`` / ``by_site``: launches of the port's own CUDA kernels,
    counted by the wrappers (ops/segment_sum.py, ops/hash_probe.py)
    through ``count_launch``; the plain versions a CPU tensor takes
    launch nothing
  - ``compile_count`` / ``compile_seconds``: nvcc builds of a kernel
    library at first use (ops/nvcc_build.py)
  - ``xfer_bytes``: host->device bytes staged (the fused pipeline's
    copies and the classic scan's)
  - ``spill_bytes``: bytes a statement's operators spilled to disk
    (utils/memory.py's SpillableRuns)
  - ``fragment_count``: mesh-fragment executions (parallel/executor.py),
    the statements summary's fragments column; not launches

``device_get`` (counted per thread by ``fetch_count``) is the one
sanctioned device->host fetch (the
counterpart of ``jax.device_get``): it moves a tensor, or a nested
tuple/list/dict of tensors, to host numpy in one copy, and counts one
round trip into the runtime sanitizer's statement scope
(``analysis/sanitizer.count_sync``), which is what
``tidb_tpu_sanitize_sync_budget`` limits.

As in the reference, every counter is per thread: the server runs
statements on concurrent worker threads, and one statement's figures
must not absorb another's launches. Work done on a statement's behalf
by another thread (the pipeline's prefetch thread) is charged to that
statement's thread through its ``Account`` (``account()`` on the
statement's thread, ``record_xfer(n, into=acct)`` on the helper). The
process-wide totals are the wrappers' ``LAUNCHES`` dicts (rendered as
``tidb_tpu_device_dispatch_total``) and the metrics registry's
``tidb_tpu_xfer_bytes_total`` and ``tidb_tpu_compile_seconds_total``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["Account", "account", "count", "by_site", "count_launch",
           "record_xfer", "xfer_bytes", "record_compile", "compile_count",
           "compile_seconds", "record_spill", "spill_bytes",
           "record_fragment", "fragment_count", "device_get", "fetch_count"]


class Account:
    """One thread's counters. Written by its own thread and, for staging
    done on its behalf, by a helper thread: hence the lock."""

    __slots__ = ("lock", "count", "by_site", "xfer", "compiles", "compile_s",
                 "spill", "fragments", "fetches")

    def __init__(self):
        self.lock = threading.Lock()
        self.count = 0
        self.by_site: Dict[str, int] = {}
        self.xfer = 0
        self.compiles = 0
        self.compile_s = 0.0
        self.spill = 0
        self.fragments = 0
        self.fetches = 0


_tls = threading.local()


def account() -> Account:
    """The calling thread's counters (made at first use)."""
    acct = getattr(_tls, "acct", None)
    if acct is None:
        acct = _tls.acct = Account()
    return acct


_LAUNCH_LOCK = threading.Lock()


def count_launch(launches: Dict[str, int], site: str) -> None:
    """One launch of the kernel entry `site`: into its wrapper module's
    process total `launches` (the ``LAUNCHES`` dict) and this thread's
    account."""
    with _LAUNCH_LOCK:
        launches[site] += 1
    acct = account()
    with acct.lock:
        acct.count += 1
        acct.by_site[site] = acct.by_site.get(site, 0) + 1


def by_site() -> dict:
    """This thread's launches per kernel entry."""
    acct = account()
    with acct.lock:
        return dict(acct.by_site)


def count() -> int:
    """Kernel launches on this thread so far."""
    return account().count


def record_xfer(nbytes: int, into: Optional[Account] = None) -> None:
    """Count host->device bytes where a staging copy is issued, on this
    thread or on the statement account `into`."""
    n = int(nbytes)
    if n <= 0:
        return
    acct = into if into is not None else account()
    with acct.lock:
        acct.xfer += n
    from tidb_tpu_torch.utils.metrics import XFER_BYTES

    XFER_BYTES.inc(n, dir="h2d")


def xfer_bytes() -> int:
    return account().xfer


def record_compile(seconds: float, builds: int) -> None:
    """Count kernel libraries built by nvcc and the wall seconds taken,
    charged to the thread whose statement triggered the build."""
    acct = account()
    with acct.lock:
        acct.compiles += builds
        acct.compile_s += float(seconds)
    from tidb_tpu_torch.utils.metrics import COMPILE_SECONDS

    COMPILE_SECONDS.inc(float(seconds))


def compile_count() -> int:
    return account().compiles


def compile_seconds() -> float:
    return account().compile_s


def record_spill(nbytes: int) -> None:
    """Count bytes this thread's statement spilled to disk (the process
    totals move at the spill site, utils/memory.py's SPILL_TOTAL)."""
    acct = account()
    with acct.lock:
        acct.spill += int(nbytes)


def spill_bytes() -> int:
    return account().spill


def record_fragment() -> None:
    """One mesh-fragment execution on this thread."""
    acct = account()
    with acct.lock:
        acct.fragments += 1


def fragment_count() -> int:
    """Mesh-fragment executions on this thread so far."""
    return account().fragments


def fetch_count() -> int:
    """Sanctioned device->host fetches (``device_get`` calls) on this
    thread so far."""
    return account().fetches


def device_get(x):
    """Host numpy copies of the tensors in `x`: a tensor becomes an
    ndarray of its shape, a tuple, list or dict of them (nested) the
    same container of ndarrays, and anything else passes through. Device
    tensors go over in ONE device->host copy (several are packed byte-wise
    into one device buffer first); CPU tensors are viewed as they are. One call is
    one counted round trip, whatever it moves."""
    import torch

    from tidb_tpu_torch.analysis import sanitizer

    sanitizer.count_sync()
    acct = account()
    with acct.lock:
        acct.fetches += 1
    dev = []

    def find(v):
        if isinstance(v, torch.Tensor):
            if v.device.type != "cpu":
                dev.append(v)
        elif isinstance(v, (tuple, list)):
            for e in v:
                find(e)
        elif isinstance(v, dict):
            for e in v.values():
                find(e)

    find(x)
    host = {}
    if len(dev) == 1:
        host[id(dev[0])] = dev[0].detach().cpu().numpy()
    elif dev:
        flat = [t.detach().contiguous().reshape(-1) for t in dev]
        packed = torch.cat([t.view(torch.uint8) for t in flat]).cpu().numpy()
        off = 0
        for t, f in zip(dev, flat):
            nb = f.numel() * f.element_size()
            dt = torch.empty(0, dtype=t.dtype).numpy().dtype
            host[id(t)] = packed[off:off + nb].view(dt).reshape(tuple(t.shape))
            off += nb

    def build(v):
        if isinstance(v, torch.Tensor):
            got = host.get(id(v))
            return got if got is not None else v.detach().numpy()
        if isinstance(v, tuple):
            return tuple(build(e) for e in v)
        if isinstance(v, list):
            return [build(e) for e in v]
        if isinstance(v, dict):
            return {k: build(e) for k, e in v.items()}
        return v

    return build(x)
