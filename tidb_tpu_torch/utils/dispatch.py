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
  - ``by_site`` also holds one dispatch per call of a cached program
    (``jit:<ns>``, utils/jitcache.py, whose ``runs()`` splits the calls
    by how they ran), as the reference's ``counted_jit`` records it, and a
    CUDA-graph capture's wall time is charged to ``compile_seconds``, as
    the reference charges a trace and compile. ``count`` stays the
    kernels' launches alone.

While a thread captures a CUDA graph (utils/jitcache.py) nothing runs:
the launches are recorded. So a host-side effect of device work (a
launch count, a route count) goes through ``on_execute``, which runs it
now or, during a capture, records it for every replay of the graph
(``count_launch`` does so): the counts then equal the kernels'
executions whether a batch ran eagerly or by replay. ``retain`` hands a
capture the long-lived device tensors its kernels read (lookup tables,
scan scratch), which the graph keeps alive; what the eager warm-up before
a capture (``Warmup``) retains under a key is held until that capture,
which finds it with ``held`` (a lookup table evicted from its cache in
between is not uploaded inside the capture).

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
from typing import Callable, Dict, List, Optional

__all__ = ["Account", "account", "count", "by_site", "count_launch",
           "record_xfer", "xfer_bytes", "record_compile", "compile_count",
           "compile_seconds", "record_compile_seconds", "record_spill",
           "spill_bytes", "record_fragment", "fragment_count", "device_get",
           "fetch_count", "record_jit", "on_execute",
           "capturing", "retain", "held", "Capture", "Warmup"]


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


class Capture:
    """What one CUDA-graph capture on this thread gathered: the host-side
    effects to run at each replay, and the device tensors to keep alive.
    `held` is what the warm-up before it retained by key (``Warmup``)."""

    __slots__ = ("effects", "retained", "held")
    _slot = "capture"

    def __init__(self, held: Optional[dict] = None):
        self.effects: List[tuple] = []
        self.retained: List = []
        self.held: dict = dict(held or {})

    def __enter__(self):
        if getattr(_tls, self._slot, None) is not None:
            raise RuntimeError(f"a CUDA graph {self._slot} is already open on this thread")
        setattr(_tls, self._slot, self)
        return self

    def __exit__(self, *exc) -> None:
        setattr(_tls, self._slot, None)

    def replay_effects(self) -> None:
        for fn, args in self.effects:
            fn(*args)


class Warmup(Capture):
    """The eager call of a signature before its capture: it runs and
    counts as usual, and what it retains under a key is held for the
    capture (``Capture(held=warmup.held)``)."""

    __slots__ = ()
    _slot = "warm"


def capturing() -> bool:
    """True while this thread captures a CUDA graph."""
    return getattr(_tls, "capture", None) is not None


def on_execute(fn: Callable, *args) -> None:
    """Run `fn(*args)`, a host-side effect of device work, now; or, while
    this thread captures a CUDA graph, at each replay of it instead."""
    cap = getattr(_tls, "capture", None)
    if cap is not None:
        cap.effects.append((fn, args))
    else:
        fn(*args)


def retain(obj, key=None) -> None:
    """Keep `obj` (a device tensor, or a tuple holding some) alive as long
    as the CUDA graph this thread is capturing, or, in the warm-up before
    a capture, until that capture, where ``held(key)`` finds it again
    (nothing outside both)."""
    rec = getattr(_tls, "capture", None) or getattr(_tls, "warm", None)
    if rec is not None:
        rec.retained.append(obj)
        if key is not None:
            rec.held[key] = obj


def held(key):
    """What the warm-up before this thread's capture retained under `key`
    (None outside a capture, or when it retained nothing there)."""
    cap = getattr(_tls, "capture", None)
    return None if cap is None else cap.held.get(key)


def count_launch(launches: Dict[str, int], site: str) -> None:
    """One launch of the kernel entry `site`: into its wrapper module's
    process total `launches` (the ``LAUNCHES`` dict) and this thread's
    account; during a capture, at each replay (``on_execute``)."""
    on_execute(_count_launch, launches, site)


def _count_launch(launches: Dict[str, int], site: str) -> None:
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


def record_compile_seconds(seconds: float) -> None:
    """Charge the wall seconds of a CUDA-graph capture to the thread whose
    statement triggered it (the reference's ``_record_compile_seconds``
    for a trace and compile)."""
    acct = account()
    with acct.lock:
        acct.compile_s += float(seconds)
    from tidb_tpu_torch.utils.metrics import COMPILE_SECONDS

    COMPILE_SECONDS.inc(float(seconds))


def record_jit(site: str) -> None:
    """One call of a cached program (utils/jitcache.py) on this thread:
    one dispatch at `site` (``jit:<ns>``) in ``by_site``."""
    acct = account()
    with acct.lock:
        acct.by_site[site] = acct.by_site.get(site, 0) + 1


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
