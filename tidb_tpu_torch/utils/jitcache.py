"""Built-program cache (the counterpart of tidb_tpu/utils/jitcache.py;
ref: the planner's plan cache reusing compiled plans across executions).

The reference keys each jitted program by the repr of its IR, because a
trace and an XLA compile cost far more than the repr. The port's
executors do not use this cache: in eager torch their builds are
closures over `expression.compiler.compile_expr` (the device tables are
cached there), and a build costs less than its key. On an H100 host
(host_ab.py) a build took 2.5-19 us, the repr key of the same IR 10-140
us a call and a hit's lookup 3-8 us, so every executor site lost host
time by caching. This module stays the sanctioned place for a build that
costs more than its key (a captured CUDA graph, a compiled kernel
variant): the jit-hygiene and cache-key-completeness passes
(`analysis/`) check its call sites. Keys are reprs of the compiled IR:
binder uids are deterministic per statement, so the same SQL text gives
the same key, while any difference in baked constants (dictionary codes
for string literals) changes it.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Tuple

from tidb_tpu_torch.utils.lru import get_or_build

__all__ = ["cached_jit", "clear", "size"]

# LRU-bounded: keys bake in value-level constants (dictionary codes for
# string literals), so mutating workloads mint new keys over time — old
# entries must age out rather than accumulate for the process lifetime.
MAX_ENTRIES = 512

_CACHE: "OrderedDict[Tuple[str, str], Callable]" = OrderedDict()
# statements run on several threads (the serving tier's workers): the
# OrderedDict's recency moves and evictions must not interleave
_LOCK = threading.Lock()


def cached_jit(ns: str, key: str, build: Callable[[], Callable]) -> Callable:
    """Return the callable for (ns, key), building it on first use.

    `build` returns the callable; it is only called on a miss. Built
    callables take every per-execution value (chunks, device, state) as
    arguments, so one entry serves every chunk size and every run."""
    with _LOCK:
        return get_or_build(_CACHE, (ns, key), build, MAX_ENTRIES)


def clear() -> None:
    with _LOCK:
        _CACHE.clear()


def size() -> int:
    with _LOCK:
        return len(_CACHE)
