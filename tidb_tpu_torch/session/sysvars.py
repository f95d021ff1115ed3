"""System variables (ref: sessionctx/variable — the two-tier GLOBAL /
SESSION variable system, incl. the `tidb_enable_tpu_exec`-style switch the
north star registers for toggling the device executor).

Globals live on the Catalog (the cluster-state analogue of
mysql.global_variables); sessions overlay them. New sessions snapshot
nothing — reads fall through session -> global -> default, like the
reference's cached global + session copy."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

from tidb_tpu_torch.errors import ExecutionError

__all__ = ["SysVar", "SYSVARS", "SysVarStore", "canonical"]


def _sanitizer_env_gate() -> bool:
    """TIDB_TPU_SANITIZE env seed for the sanitize sysvar default —
    ONE parser (analysis/sanitizer.env_gate) so `=0` disables here and
    in the sanitizer's own process gate identically."""
    from tidb_tpu_torch.analysis.sanitizer import env_gate

    return env_gate()

GLOBAL, SESSION, BOTH = "global", "session", "both"


@dataclass(frozen=True)
class SysVar:
    name: str
    default: object
    scope: str = BOTH
    kind: str = "str"  # bool | int | float | str | enum
    min_: Optional[int] = None
    max_: Optional[int] = None
    enum_values: Optional[tuple] = None  # kind == "enum": allowed (lowercase)


SYSVARS: Dict[str, SysVar] = {}


def _reg(*vs: SysVar) -> None:
    for v in vs:
        SYSVARS[v.name] = v


_reg(
    # the north-star switch: route eligible fragments to the device mesh
    SysVar("tidb_enable_tpu_exec", True, BOTH, "bool"),
    # auto: full device fragments on accelerators and multi-device
    # meshes; on a degenerate single-CPU backend, joins and generic
    # aggregation route to the vectorized host engine instead (XLA:CPU
    # sorts lose to numpy's by 5-10x and a 1-device mesh has no
    # parallelism to win back). force/off override the heuristic.
    SysVar("tidb_device_engine_mode", "auto", BOTH, "enum",
           enum_values=("auto", "force", "off")),
    # non-empty: name of an installed executor plugin that builds the
    # operator tree instead of the built-in builders (ref: plugin/)
    SysVar("tidb_executor_plugin", "", BOTH, "str"),
    # memo-based exhaustive join-order search (ref: planner/cascades
    # and the sysvar of the same name); greedy ordering otherwise
    SysVar("tidb_enable_cascades_planner", False, BOTH, "bool"),
    # eager aggregation (partial agg below joins); stats-gated, so ON by
    # default unlike the reference's blind-push variant
    SysVar("tidb_opt_agg_push_down", True, BOTH, "bool"),
    SysVar("group_concat_max_len", 1024, BOTH, "int"),
    SysVar("tidb_gc_enable", True, BOTH, "bool"),
    # stats lifecycle (ref: statistics auto-analyze): after DML commits,
    # re-ANALYZE a table whose modified-row count crossed ratio * rows
    SysVar("tidb_enable_auto_analyze", True, BOTH, "bool"),
    SysVar("tidb_auto_analyze_ratio", 0.5, BOTH, "float"),
    # statements slower than this (ms) go to the slow-query log
    SysVar("tidb_slow_log_threshold", 300, BOTH, "int", min_=0, max_=1 << 31),
    # head-sampling rate for always-on statement tracing: every
    # statement RECORDS a trace; this decides whether an uneventful one
    # is kept. Tail rules (slow, error, deadline/kill, retry/failover)
    # keep their traces regardless, so 0 still captures the interesting
    # statements — see utils/tracing.py
    SysVar("tidb_trace_sample_rate", 0.01, BOTH, "float"),
    # ring capacity of the tail-sampled trace store (/trace +
    # information_schema.cluster_trace); GLOBAL: one store per process
    SysVar("tidb_trace_store_capacity", 64, GLOBAL, "int",
           min_=1, max_=4096),
    # LRU cap on distinct digests kept by the statements-summary store
    # (ref: tidb_stmt_summary_max_stmt_count); evictions are counted.
    # GLOBAL-only like the reference: the store is catalog-wide, so a
    # session-local cap would evict other sessions' diagnostics
    SysVar("tidb_stmt_summary_max_stmt_count", 200, GLOBAL, "int",
           min_=1, max_=1 << 16),
    # digest-keyed plan cache (ref: tidb_enable_prepared_plan_cache /
    # the instance plan cache): prepared statements reuse verified plans
    # by default; non-prepared SELECT reuse is opt-in like the reference
    SysVar("tidb_enable_prepared_plan_cache", True, BOTH, "bool"),
    SysVar("tidb_enable_non_prepared_plan_cache", False, BOTH, "bool"),
    # LRU cap on the instance-wide plan cache; GLOBAL-only for the same
    # reason as the statements-summary cap (one shared store)
    SysVar("tidb_prepared_plan_cache_size", 256, GLOBAL, "int",
           min_=1, max_=1 << 16),
    # whether the previous SELECT's plan came from the plan cache
    # (read via @@last_plan_from_cache, like the reference)
    SysVar("last_plan_from_cache", False, SESSION, "bool"),
    # non-empty: wrap query execution in jax.profiler.trace(dir)
    SysVar("tidb_profile_dir", "", BOTH, "str"),
    # tables above this size stream through fixed [P,R] staging batches
    # instead of residing wholly in device memory (the >HBM path)
    SysVar("tidb_device_cache_bytes", 8 << 30, BOTH, "int",
           min_=1 << 20, max_=1 << 45),
    # partitioned device join (ISSUE 3): device-resident build sort,
    # fused-expand tile budget, and the fragment broadcast-build ceiling
    SysVar("tidb_tpu_join_device_build", True, BOTH, "bool"),
    SysVar("tidb_tpu_join_tiles_per_dispatch", 8, BOTH, "int",
           min_=1, max_=64),
    # join probe strategy (ISSUE 10): how probe chunks resolve (lo, hi)
    # match ranges over the sorted build keys. off = searchsorted always;
    # auto = open-addressing hash table when the computation targets TPU
    # (trace-time force_platform aware, like segment_sum), searchsorted
    # on CPU where its cache-friendly binary rounds measure faster;
    # xla/pallas force the table everywhere (window-scan probe / Pallas
    # VMEM kernel). Dense packed-key domains keep the O(1) direct-address
    # index regardless. Threaded per-statement through ExecContext into
    # BOTH tiers (fragment programs take it as a trace-time static in
    # their cache key) — the hash_probe process global is only the
    # offline default (ISSUE 12 fixed the set_mode race).
    SysVar("tidb_tpu_join_probe_mode", "auto", BOTH, "enum",
           enum_values=("off", "auto", "xla", "pallas")),
    # -- runtime invariant sanitizer (ISSUE 12) ------------------------
    # debug mode: wrap the registered locks in the runtime order
    # witness, audit tracker/pin balances at statement end, count
    # device_get round trips against the declared budget, and raise a
    # typed SanitizerError on fatal findings. Seeded by the
    # TIDB_TPU_SANITIZE env var for whole-process runs.
    SysVar("tidb_tpu_sanitize", _sanitizer_env_gate(), BOTH, "bool"),
    # per-statement ceiling on sanctioned device_get round trips while
    # sanitizing — the runtime form of the host-sync chunk-loop budget
    SysVar("tidb_tpu_sanitize_sync_budget", 4096, BOTH, "int",
           min_=1, max_=1 << 20),
    SysVar("tidb_broadcast_join_threshold_count", 1 << 21, BOTH, "int",
           min_=1 << 10, max_=1 << 28),
    # -- plan feedback (ISSUE 15) --------------------------------------
    # close the estimate->actual loop: record per-digest est-vs-actual
    # operator cardinalities at statement end and let the next planning
    # of the same digest consume them (join ordering, eager-agg push-
    # down exploration, fused-probe tile sizing, dcn broadcast-vs-
    # shuffle). Off = plans are byte-identical to the heuristic-only
    # planner and nothing is recorded. Feedback changes PLANS only,
    # never results.
    SysVar("tidb_tpu_plan_feedback", True, BOTH, "bool"),
    # LRU cap on distinct statement digests the feedback store retains;
    # GLOBAL: one store per process, like the statements summary
    SysVar("tidb_tpu_plan_feedback_capacity", 512, GLOBAL, "int",
           min_=1, max_=1 << 16),
    # -- serving tier (ISSUE 7): admission-controlled scheduler +
    # cross-session micro-batched dispatch -----------------------------
    # wire-connection cap enforced at the accept loop; over-limit
    # handshakes get MySQL error 1040 (ER_CON_COUNT_ERROR). 0 = unbounded
    SysVar("tidb_max_connections", 0, GLOBAL, "int", min_=0, max_=1 << 20),
    # gather window for cross-session micro-batching: the first
    # coalescible statement waits up to this long for same-shaped
    # followers before the batch dispatches. 0 disables coalescing
    # (every statement runs singleton through the scheduler)
    SysVar("tidb_tpu_batch_window_us", 250, GLOBAL, "int",
           min_=0, max_=1_000_000),
    # hard cap on members per coalesced dispatch; a full group seals
    # immediately without waiting out the window
    SysVar("tidb_tpu_max_batch_size", 64, GLOBAL, "int", min_=1, max_=4096),
    # scheduler worker-pool width (read at scheduler construction)
    SysVar("tidb_tpu_scheduler_workers", 4, GLOBAL, "int", min_=1, max_=256),
    # admission control: statements queued beyond this are rejected with
    # a typed "server is busy" error instead of queuing unboundedly
    SysVar("tidb_tpu_sched_max_queue", 256, GLOBAL, "int",
           min_=1, max_=1 << 20),
    # admitted statements not claimed by a worker within this budget are
    # evicted from the queue with a typed queue-timeout error (they
    # never started, so retry is always safe)
    SysVar("tidb_tpu_sched_queue_timeout_ms", 10_000, GLOBAL, "int",
           min_=1, max_=1 << 31),
    # server-wide host-memory budget across all in-flight statements
    # (the scheduler's root MemTracker); 0 = unlimited. New statements
    # are rejected at admission while consumption sits above it
    SysVar("tidb_tpu_sched_mem_quota", 0, GLOBAL, "int",
           min_=0, max_=1 << 45),
    # per-session host-memory budget across that session's in-flight
    # statement (a child of the server tracker); 0 = unlimited
    SysVar("tidb_tpu_mem_quota_session", 0, BOTH, "int",
           min_=0, max_=1 << 45),
    # -- per-digest latency SLOs (ISSUE 16) ----------------------------
    # latency objective per statement execution: the SLO store counts a
    # window observation over this target as a budget breach and
    # derives the burn ratio from the breach fraction (99% objective)
    SysVar("tidb_tpu_slo_target_ms", 300, GLOBAL, "int",
           min_=1, max_=1 << 31),
    # LRU cap on distinct digests the SLO store retains; GLOBAL: one
    # store per process, like the plan-feedback capacity
    SysVar("tidb_tpu_slo_capacity", 512, GLOBAL, "int",
           min_=1, max_=1 << 16),
    # the first SLO consumer (default OFF): under admission queue
    # pressure (queue >= 3/4 of tidb_tpu_sched_max_queue) shed the
    # statements whose digest is burning its SLO budget fastest, with
    # a typed 9008 rejection. Plans and results are never affected —
    # off leaves admission decisions byte-identical
    SysVar("tidb_tpu_sched_slo_shed", False, GLOBAL, "bool"),
    # -- columnar segment store (ISSUE 8) ------------------------------
    # scans over stored tables stage encoded, zone-mapped segments with
    # decompression fused into the jitted scan program; off = raw slices
    SysVar("tidb_tpu_columnar_enable", True, BOTH, "bool"),
    # fixed segment capacity in rows; the first store built for a table
    # pins its value for that table's lifetime
    SysVar("tidb_tpu_segment_rows", 1 << 16, BOTH, "int",
           min_=1 << 10, max_=1 << 22),
    # appended (delta) rows that trigger a coverage extension + zone-map
    # refresh at the next scan; smaller = fresher zone maps, more
    # build churn
    SysVar("tidb_tpu_segment_delta_rows", 1 << 16, BOTH, "int",
           min_=1 << 10, max_=1 << 24),
    # directory for spilled segment files (empty = system tmp); cold
    # segments evicted under the statement memory budget land here
    SysVar("tidb_tpu_columnar_spill_dir", "", BOTH, "str"),
    # background delta->segment compaction (ISSUE 17): a worker thread
    # rebuilds trailing segments off the statement path and cuts over
    # at the store lock; 0 = today's inline rebuild-at-scan behavior
    SysVar("tidb_tpu_compaction", True, BOTH, "bool"),
    # -- pipelined device-resident execution (ISSUE 9) -----------------
    # fuse scan->filter->project->partial-agg into ONE jitted program
    # per fragment, accumulating agg state on device across chunks with
    # a single fetch at finalize; off = the per-operator chunk pipeline
    SysVar("tidb_tpu_pipeline_fuse", True, BOTH, "bool"),
    # staging chunks the prefetch thread keeps in flight ahead of the
    # compute loop (jax.device_put of chunk k+1 while k computes);
    # 0 disables the thread and stages inline
    SysVar("tidb_tpu_pipeline_prefetch_depth", 2, BOTH, "int",
           min_=0, max_=16),
    # byte budget of the cross-statement device buffer cache (staged
    # scan inputs kept device-resident between statements, invalidated
    # like the plan cache); 0 disables it. GLOBAL: one cache per process
    SysVar("tidb_tpu_device_buffer_cache_bytes", 256 << 20, GLOBAL, "int",
           min_=0, max_=1 << 40),
    # byte quota of the built-program cache's CUDA graphs (utils/jitcache.py:
    # their private pools and static input buffers; the least recently
    # used programs go past it). GLOBAL: one cache per process
    SysVar("tidb_tpu_graph_cache_bytes", 4 << 30, GLOBAL, "int",
           min_=0, max_=1 << 40),
    # stage fragment inputs as frame-of-reference-encoded narrow arrays
    # (decode fused into the fragment program) instead of raw int64
    SysVar("tidb_tpu_stage_encoded", True, BOTH, "bool"),
    # fixed device batch capacity (ref: tidb_max_chunk_size)
    SysVar("tidb_max_chunk_size", 1 << 16, BOTH, "int", min_=1 << 10, max_=1 << 24),
    # per-query host-side memory budget in bytes (ref: tidb_mem_quota_query)
    SysVar("tidb_mem_quota_query", 1 << 31, BOTH, "int", min_=1 << 20, max_=1 << 45),
    # spill host operator state to disk instead of cancelling on OOM
    SysVar("tidb_enable_tmp_storage_on_oom", True, BOTH, "bool"),
    SysVar("autocommit", True, BOTH, "bool"),
    # pessimistic locking-read wait bound (seconds; MySQL default is 50,
    # shortened here — analytics sessions should fail fast)
    SysVar("innodb_lock_wait_timeout", 5, BOTH, "int"),
    SysVar("sql_mode", "STRICT_TRANS_TABLES", BOTH, "str"),
    SysVar("version", "8.0.11-tidb-tpu-0.1.0", GLOBAL, "str"),
    SysVar("version_comment", "tidb_tpu: TPU-native SQL execution engine", GLOBAL, "str"),
    SysVar("time_zone", "SYSTEM", BOTH, "str"),
    SysVar("max_execution_time", 0, BOTH, "int", min_=0, max_=1 << 31),
    # per-RPC socket deadline on the DCN tier, ms; 0 disables. Distinct
    # from max_execution_time: the statement deadline bounds the whole
    # query, this bounds any SINGLE coordinator<->worker round trip (a
    # hung worker must not pin a statement for the full statement budget)
    SysVar("tidb_tpu_dcn_rpc_timeout", 30000, BOTH, "int",
           min_=0, max_=1 << 31),
    # a partition whose primary AND replica are unreachable: fail the
    # query (default, exact results) or serve the reachable partitions
    # with a warning (availability over completeness)
    SysVar("tidb_tpu_dcn_partial_results", False, BOTH, "bool"),
    # bound on a statement's wait for a topology-change gate (online
    # reshard backfill/cutover window, membership finalize), ms: past
    # it the statement degrades TYPED ("topology change in progress")
    # instead of hanging behind a stuck cutover
    SysVar("tidb_tpu_reshard_gate_wait_ms", 10000, BOTH, "int",
           min_=0, max_=1 << 31),
    SysVar("tx_isolation", "REPEATABLE-READ", BOTH, "str"),
    SysVar("transaction_isolation", "REPEATABLE-READ", BOTH, "str"),
    SysVar("character_set_client", "utf8mb4", BOTH, "str"),
    SysVar("character_set_results", "utf8mb4", BOTH, "str"),
    SysVar("character_set_connection", "utf8mb4", BOTH, "str"),
    SysVar("collation_connection", "utf8mb4_bin", BOTH, "str"),
)

_TRUTHY = {"1", "on", "true", "yes"}
_FALSY = {"0", "off", "false", "no"}


def canonical(var: SysVar, value) -> object:
    """Validate + canonicalize a SET value per the variable's kind."""
    if var.kind == "bool":
        s = str(value).strip().lower()
        if s in _TRUTHY:
            return True
        if s in _FALSY:
            return False
        raise ExecutionError(f"invalid boolean value {value!r} for {var.name}")
    if var.kind == "int":
        try:
            n = int(value)
        except (TypeError, ValueError):
            raise ExecutionError(f"invalid integer value {value!r} for {var.name}")
        if var.min_ is not None and n < var.min_:
            n = var.min_
        if var.max_ is not None and n > var.max_:
            n = var.max_
        return n
    if var.kind == "float":
        try:
            return float(value)
        except (TypeError, ValueError):
            raise ExecutionError(
                f"invalid float value {value!r} for {var.name}")
    if var.kind == "enum":
        s = str(value).strip().lower()
        if s not in (var.enum_values or ()):
            raise ExecutionError(
                f"invalid value {value!r} for {var.name} "
                f"(allowed: {', '.join(var.enum_values or ())})")
        return s
    return str(value)


def display(value) -> str:
    if isinstance(value, bool):
        return "ON" if value else "OFF"
    return str(value)


class SysVarStore:
    """Session-side view: overlay dict over the catalog's global dict."""

    def __init__(self, globals_: Dict[str, object]):
        self._globals = globals_
        self._session: Dict[str, object] = {}

    def get(self, name: str):
        name = name.lower()
        if name in self._session:
            return self._session[name]
        if name in self._globals:
            return self._globals[name]
        var = SYSVARS.get(name)
        if var is None:
            raise ExecutionError(f"unknown system variable {name!r}")
        return var.default

    def set(self, name: str, value, scope: str = SESSION) -> None:
        name = name.lower()
        var = SYSVARS.get(name)
        if var is None:
            raise ExecutionError(f"unknown system variable {name!r}")
        value = canonical(var, value)
        if scope == GLOBAL:
            if var.scope == SESSION:
                raise ExecutionError(f"{name} is a SESSION-only variable")
            self._globals[name] = value
        else:
            if var.scope == GLOBAL:
                raise ExecutionError(
                    f"{name} is a GLOBAL variable; use SET GLOBAL")
            self._session[name] = value

    def all_effective(self) -> Dict[str, object]:
        out = {name: v.default for name, v in SYSVARS.items()}
        out.update(self._globals)
        out.update(self._session)
        return out
