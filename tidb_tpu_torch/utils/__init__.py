"""Cross-cutting utilities."""

import os
from concurrent.futures import ThreadPoolExecutor

HOST_THREADS = min(8, os.cpu_count() or 1)


def host_map(fn, items) -> list:
    """[fn(x) for x in items], on up to HOST_THREADS threads: numpy work
    over independent large columns (a 60M-row gather) releases the GIL,
    so a CLUSTER BY re-sort permutes its columns on every core."""
    items = list(items)
    if len(items) < 2 or HOST_THREADS < 2:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=min(HOST_THREADS, len(items))) as ex:
        return list(ex.map(fn, items))
