"""Failpoint injection (a copy of tidb_tpu/utils/failpoint.py; ref:
pingcap/failpoint — `failpoint.Inject`
annotations compiled into the reference, letting tests trigger commit
failures, retry paths, and OOM actions).

Call sites sprinkle `inject("name")` at interesting boundaries (2PC
phases, exchange staging, spill, every DCN protocol edge). Tests arm
them:

    with failpoint("commit.before_secondaries", CrashError):
        ...

Arming modes (composable, mirroring the reference's term grammar
`N%return` / `Nth.return`):

  * times=N   — fire at most N times, then go quiet
  * nth=N     — fire only on the N-th trigger (1-based); earlier and
                later hits pass through
  * prob=p    — fire with probability p per hit, from a seeded private
                RNG so chaos runs are reproducible

`hits(name)` counts how often an ARMED call site was reached since its
enable() (unarmed reaches stay free and uncounted) — chaos tests arm a
point, drive the workload, then assert the injection point actually sat
on the executed path. Disabled failpoints cost one dict lookup."""

from __future__ import annotations

import contextlib
import random
import threading
from typing import Callable, Dict, Optional

__all__ = ["inject", "enable", "disable", "failpoint", "FailpointError",
           "hits", "active_names"]


class FailpointError(RuntimeError):
    """Default injected failure (stands in for a crash/network fault)."""


_active: Dict[str, Callable[[], None]] = {}
_hits: Dict[str, int] = {}
_lock = threading.Lock()


def inject(name: str) -> None:
    """Trigger point — no-op unless a test armed `name`."""
    hook = _active.get(name)
    if hook is not None:
        hook()


def hits(name: str) -> int:
    """Times an ARMED `name` call site was reached since enable()."""
    with _lock:
        return _hits.get(name, 0)


def active_names():
    with _lock:
        return sorted(_active)


def enable(name: str, action: Optional[Callable[[], None]] = None,
           exc: Optional[type] = None, times: Optional[int] = None,
           prob: Optional[float] = None, nth: Optional[int] = None,
           seed: int = 0) -> None:
    """Arm a failpoint: run `action`, or raise `exc` (default
    FailpointError). `times` limits how many firings happen; `nth`
    fires only on the N-th trigger; `prob` fires probabilistically per
    hit (seeded — reruns see the same fault schedule)."""
    state = {"left": times, "hit": 0}
    rng = random.Random(seed) if prob is not None else None

    def hook():
        with _lock:
            state["hit"] += 1
            _hits[name] = state["hit"]
            n = state["hit"]
            if nth is not None and n != nth:
                return
            if rng is not None and rng.random() >= prob:
                return
            if state["left"] is not None:
                if state["left"] <= 0:
                    return
                state["left"] -= 1
        if action is not None:
            action()
        else:
            raise (exc or FailpointError)(f"failpoint {name!r}")

    with _lock:
        _active[name] = hook
        _hits[name] = 0


def disable(name: str) -> None:
    with _lock:
        _active.pop(name, None)


@contextlib.contextmanager
def failpoint(name: str, exc: Optional[type] = None,
              action: Optional[Callable[[], None]] = None,
              times: Optional[int] = None, prob: Optional[float] = None,
              nth: Optional[int] = None, seed: int = 0):
    enable(name, action=action, exc=exc, times=times, prob=prob, nth=nth,
           seed=seed)
    try:
        yield
    finally:
        disable(name)
