"""Serving tier (a copy of tidb_tpu/serving): the layer between the MySQL-protocol server
and Session that turns a thread-per-connection SQL node into an
admission-controlled, throughput-oriented statement scheduler.

Two pieces:

``scheduler.py``  — a bounded worker pool with admission control (queue
    depth cap, queue-claim timeout, per-session and server-wide memory
    quotas wired into utils/memory.py's tracker tree) and typed
    rejection errors instead of unbounded thread spawn.

``batcher.py``    — cross-session micro-batching: concurrent statements
    that would hit the plan cache under the SAME key (digest +
    param-type fingerprint + planner sysvars) on a batchable plan
    coalesce during a short gather window into ONE gathered pass (on
    the host: a point-select's rows never go to the card), with results
    de-multiplexed per session
    and every per-statement semantic (warnings, @@last_plan_from_cache,
    stmt-summary, deadlines/KILL) preserved exactly. Anything unsafe
    falls back to singleton execution — a correctness gate, not
    best-effort.
"""

from tidb_tpu_torch.serving.scheduler import (
    StatementScheduler,
    schedulers_alive,
)

__all__ = ["StatementScheduler", "schedulers_alive"]
