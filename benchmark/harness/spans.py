"""The program's own records of the statements sent in the window: one
record per statement, folded from its span tree when it ended
(tidb_tpu_torch.utils.tracing.statements: trace_id, t_start, t_end on
time.monotonic(), spans {name: [count, seconds]}, counters {name:
[calls, seconds]}). The per-layer metrics lock_wait_ms, live_rows_ms,
execute_ms, sync_wait_ms and untraced_ms read them.

A program without these records gives None, and so does a window whose
records do not match its statements one for one: the metrics are then
left out of the result's line."""

from __future__ import annotations

import sys
from typing import Callable, List, Optional

# the spans that partition a served statement's time on the server: the
# statement's top-level spans and its stmt.* span's children
STATEMENT_PARTS = ("sched.queue", "sched.lock_wait", "session.parse", "server.write",
                   "session.plan", "session.execute", "session.finish")


def records(ctx) -> Optional[List[dict]]:
    """tracing.statements(ctx.t0, ctx.t_close): the records of the
    statements that reached the server from the window's first send to
    its close, which are the statements sent in the window."""
    try:
        from tidb_tpu_torch.utils import tracing
    except ImportError:
        return None
    read = getattr(tracing, "statements", None)
    if read is None or not ctx.statements:
        return None
    recs = read(ctx.t0, ctx.t_close)
    if len(recs) != len(ctx.statements):
        print(f"# spans: {len(recs)} statement records for {len(ctx.statements)} "
              "statements sent in the window", file=sys.stderr)
        return None
    return recs


def span_s(rec: dict, name: str) -> float:
    return rec["spans"].get(name, (0, 0.0))[1]


def counter_s(rec: dict, name: str) -> float:
    return rec["counters"].get(name, (0, 0.0))[1]


def mean_ms(ctx, seconds_of: Callable[[dict], float]) -> Optional[float]:
    """The mean over the window's statement records of `seconds_of`, in ms."""
    recs = records(ctx)
    if recs is None:
        return None
    return sum(seconds_of(r) for r in recs) / len(recs) * 1000.0
