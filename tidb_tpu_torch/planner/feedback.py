"""Plan feedback (a copy of tidb_tpu/planner/feedback.py): per-digest est-vs-actual capture and the first
runtime-truth planner decisions (ref: TiDB's statement summary + SQL
plan management loop — record what a plan actually did, use it the next
time the same statement is planned).

The engine produces accurate runtime facts everywhere (exact NDV zone
maps, per-operator EXPLAIN ANALYZE actuals, per-probe-chunk match
totals); until this module the planner consumed only heuristics
(``planner/physical.py``'s 1/NDV selectivities, ``est_rows`` never
compared against reality). The store closes that loop:

  * ``Session._execute_timed`` harvests, at statement end, the
    per-operator est-vs-actual row counts from ``RuntimeStats``
    (``executor/base.py``): actuals come free where the engine already
    knows them host-side (join match totals, aggregate group counts,
    the materialized root) and exactly under EXPLAIN ANALYZE / TRACE
    instrumentation — never from a new per-chunk device sync.
  * Observations fold into a process-global, capacity-bounded store
    keyed by (statement digest, plan identity), invalidated on
    DDL/ANALYZE through the same ``catalog.schema_version`` hook the
    plan cache uses.
  * Consumers, behind ``tidb_tpu_plan_feedback`` (default on):
      (a) recorded scan selectivities and join output cardinalities
          override the heuristic estimates on the NEXT planning of the
          same shapes (join ordering; dcn ``_plan_shuffle`` reads the
          observed per-side exchange bytes for broadcast-vs-shuffle);
      (b) the eager-agg push-down decision becomes measured: when a
          digest's default plan carries an eager partial, the
          alternative (no-push, fusible) plan is explored once and the
          warm-measured faster variant wins — the Q18 bench no longer
          pins ``tidb_opt_agg_push_down=0``;
      (c) fused-probe tile sizing: observed overflow rates raise the
          statement's ``join_tiles`` so dup-heavy probes expand in
          fewer dispatches.
  * Surfaces: ``information_schema.plan_feedback``, est/drift columns
    on EXPLAIN ANALYZE, the ``PLAN_EST_DRIFT`` histogram (with trace
    exemplars), worst-drift annotations on kept traces, and the
    ``/plan_feedback`` status endpoint.

Correctness contract: feedback may change PLANS, never RESULTS. Every
consumer picks among independently-correct alternatives (join order,
exchange mode, push-down variant, tile count), so a bad feedback entry
can degrade performance but never correctness — the tests re-validate
feedback-driven plans against the sqlite oracle.

Concurrency: one leaf lock guards the store; nothing blocking (no
planning, no device work, no I/O) ever runs under it — the
lock-discipline and blocking-under-lock passes check this module.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

__all__ = ["PlanFeedbackStore", "STORE", "Observation", "OpObservation",
           "planning_hints", "current_hints", "cond_fingerprint",
           "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = 512

# a recorded actual only overrides the heuristic when the misestimate
# is material: small drift is within the noise the estimators already
# carry, and overriding it would churn plans for nothing
SIGNIFICANT_DRIFT = 4.0

# exploration budget per plan variant: runs allowed before giving up on
# ever seeing a warm (cache-hit, no-recompile) measurement and scoring
# the variant by its best cold run instead
EXPLORE_BUDGET = 8

# a variant must beat the incumbent's warm best by this margin to take
# over — hysteresis against latency jitter flip-flopping near-ties
WIN_MARGIN = 0.9


# ---------------------------------------------------------------------------
# observations
# ---------------------------------------------------------------------------

class OpObservation:
    """One operator's est-vs-actual fold across executions."""

    __slots__ = ("op", "est_rows", "actual_rows", "execs")

    def __init__(self, op: str, est_rows: float, actual_rows: float):
        self.op = op
        self.est_rows = float(est_rows)
        self.actual_rows = float(actual_rows)
        self.execs = 1

    def fold(self, est_rows: float, actual_rows: float) -> None:
        self.est_rows = float(est_rows)
        self.actual_rows = float(actual_rows)  # latest wins: the most
        self.execs += 1                        # recent truth is freshest

    def drift(self) -> float:
        """actual/est ratio; 0.0 when the estimate was zero."""
        return self.actual_rows / self.est_rows if self.est_rows > 0 else 0.0


class Observation:
    """What one execution of one (digest, plan) taught us. Built by
    ``harvest`` outside any lock; folded into the store under it."""

    def __init__(self):
        self.ops: List[Tuple[str, float, float]] = []  # (op, est, actual)
        self.scan_rows: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self.join_rows: Dict[frozenset, float] = {}
        self.eager_partial = False
        self.fused_probe = False
        self.latency_s = 0.0
        self.warm = False
        self.tile_chunks = 0
        self.tile_overflows = 0
        self.tile_max_need = 0
        # fused top-k: largest LIMIT+offset k a FusedScanTopNExec
        # observed past its device capacity gate (0 = never overflowed)
        self.topn_overflow = 0
        self.worst_drift = 0.0       # max(ratio, 1/ratio) over known ops
        self.worst_drift_op = ""
        self.worst_drift_ratio = 1.0  # signed actual/est of the worst op


class _Variant:
    """Per-(digest, plan_digest) aggregate entry."""

    __slots__ = ("digest", "plan_digest", "apd", "execs", "warm_execs",
                 "best_warm_s", "best_any_s", "eager_partial",
                 "fused_probe", "ops", "tile_chunks", "tile_overflows",
                 "tile_max_need", "topn_overflow", "worst_drift",
                 "worst_drift_op")

    def __init__(self, digest: str, plan_digest: str, apd: bool):
        self.digest = digest
        self.plan_digest = plan_digest
        self.apd = apd
        self.execs = 0
        self.warm_execs = 0
        self.best_warm_s: Optional[float] = None
        self.best_any_s: Optional[float] = None
        self.eager_partial = False
        self.fused_probe = False
        self.ops: "OrderedDict[str, OpObservation]" = OrderedDict()
        self.tile_chunks = 0
        self.tile_overflows = 0
        self.tile_max_need = 0
        self.topn_overflow = 0
        self.worst_drift = 0.0
        self.worst_drift_op = ""

    def score(self) -> Optional[float]:
        """Latency this variant competes with: warm best when measured,
        else (exploration budget exhausted) the best cold run."""
        if self.best_warm_s is not None:
            return self.best_warm_s
        if self.execs >= EXPLORE_BUDGET:
            return self.best_any_s
        return None


# ---------------------------------------------------------------------------
# expression fingerprints (stable across re-plannings)
# ---------------------------------------------------------------------------

def cond_fingerprint(cond, uid_to_name: Dict[str, str]) -> str:
    """Stable fingerprint of a pushed filter with ColumnRef uids mapped
    to base column NAMES — binder uids can differ between plannings of
    the same SQL, so a raw repr() would never match across executions."""
    from tidb_tpu_torch.expression.expr import Call, ColumnRef, Literal, Lookup

    parts: List[str] = []

    def visit(e):
        if e is None:
            parts.append("~")
            return
        if isinstance(e, ColumnRef):
            parts.append("c:" + uid_to_name.get(e.name, e.name))
            return
        if isinstance(e, Literal):
            parts.append("l:" + repr(e.value))
            return
        if isinstance(e, Lookup):
            parts.append("lk(")
            visit(e.arg)
            parts.append(")")
            return
        if isinstance(e, Call):
            parts.append(e.op + "(")
            for a in e.args:
                visit(a)
                parts.append(",")
            parts.append(")")
            return
        parts.append(type(e).__name__)

    visit(cond)
    return "".join(parts)


def _base_relation(plan) -> bool:
    """True when a physical subtree is one base table reached through
    row-shaping operators only (selections/projections over a scan) —
    the shapes whose observed join cardinality is a clean PAIRWISE
    truth the join orderer can reuse."""
    from tidb_tpu_torch.planner.physical import PProjection, PScan, PSelection

    p = plan
    while isinstance(p, (PProjection, PSelection)):
        p = p.child
    return isinstance(p, PScan) and p.table is not None


def _resolve_scan_col_phys(plan, uid: str):
    """Physical-tree twin of planner.physical.resolve_scan_col: trace a
    column uid to its defining base-table (table_name, column_name)
    through pass-through projections."""
    from tidb_tpu_torch.expression.expr import ColumnRef
    from tidb_tpu_torch.planner.physical import PProjection, PScan

    if isinstance(plan, PScan):
        for c in plan.schema:
            if c.uid == uid:
                return (plan.table_name, c.name) if plan.table is not None \
                    else None
        return None
    if isinstance(plan, PProjection):
        for c, e in zip(plan.schema, plan.exprs):
            if c.uid == uid:
                if isinstance(e, ColumnRef):
                    return _resolve_scan_col_phys(plan.child, e.name)
                return None
    for ch in plan.children:
        r = _resolve_scan_col_phys(ch, uid)
        if r is not None:
            return r
    return None


def _side_fingerprint(plan) -> Optional[Tuple[str, str]]:
    """(table_name, combined filter fingerprint) of a join side that is
    one base table reached through row-shaping operators only, else
    None. Duck-typed over BOTH trees (logical and physical share the
    projection/selection/scan attribute shapes): selections above the
    scan contribute their conditions to the fingerprint alongside the
    scan's pushed filter, so a filtered and an unfiltered join of the
    same tables never share an observation."""
    p = plan
    fps: List[str] = []
    while True:
        if hasattr(p, "pushed_cond"):  # the base scan (LScan / PScan)
            if getattr(p, "table", None) is None:
                return None
            if p.pushed_cond is not None:
                fps.append(cond_fingerprint(
                    p.pushed_cond, {c.uid: c.name for c in p.schema}))
            return (p.table_name, "&".join(sorted(fps)))
        if hasattr(p, "exprs"):        # projection: row-preserving
            p = p.children[0]
            continue
        if hasattr(p, "cond") and not hasattr(p, "eq_left") \
                and not hasattr(p, "eq_conds"):  # selection
            fps.append(cond_fingerprint(
                p.cond, {c.uid: c.name for c in p.schema}))
            p = p.children[0]
            continue
        return None  # joins, aggregates, anything else: not pairwise


def _join_key(left, right, eq_pairs, resolve) -> Optional[tuple]:
    """Feedback key of one pairwise join: the (table, column) pairs its
    equalities resolve to, plus each side's (table, filter fingerprint).
    None when either side is not a base relation or a key fails to
    resolve — the recorded truth is PAIRWISE and filter-specific, so
    only the same shape may record or consume it."""
    from tidb_tpu_torch.expression.expr import ColumnRef, Lookup

    fl, fr = _side_fingerprint(left), _side_fingerprint(right)
    if fl is None or fr is None:
        return None
    pairs = set()
    for side, e in eq_pairs:
        while isinstance(e, Lookup):
            e = e.arg
        if not isinstance(e, ColumnRef):
            return None
        r = resolve(side, e.name)
        if r is None:
            return None
        pairs.add(r)
    if not pairs:
        return None
    return (frozenset(pairs), frozenset({fl, fr}))


def join_key_logical(left, right, eq_conds) -> Optional[tuple]:
    from tidb_tpu_torch.planner.physical import resolve_scan_col

    def resolve(side, uid):
        r = resolve_scan_col(side, uid)
        return None if r is None else (getattr(r[0].schema, "name", ""),
                                       r[1])

    eq_pairs = [(s, e) for le, re_ in eq_conds
                for s, e in ((left, le), (right, re_))]
    return _join_key(left, right, eq_pairs, resolve)


def _join_key_physical(plan) -> Optional[tuple]:
    left, right = plan.children
    eq_pairs = ([(left, e) for e in plan.eq_left]
                + [(right, e) for e in plan.eq_right])
    return _join_key(left, right, eq_pairs, _resolve_scan_col_phys)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

class PlanFeedbackStore:
    """Process-global, capacity-bounded (LRU on digest) plan-feedback
    store. The lock is a LEAF: fold/read only — callers do planning and
    harvesting outside it."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        from tidb_tpu_torch.analysis import sanitizer as _san

        # tracked: the runtime sanitizer witnesses acquisition order,
        # so a future callback that takes another lock under this one
        # shows up as a runtime edge
        self.lock = _san.tracked_lock("PlanFeedbackStore.lock")
        self.capacity = capacity
        self._by_digest: "OrderedDict[str, Dict[str, _Variant]]" = \
            OrderedDict()
        # digest-independent cardinality truth (the production QFB
        # shape): observed scan selectivities and join output rows,
        # keyed by base-table fingerprints so any statement touching
        # the same shapes benefits. Bounded alongside the digest LRU.
        self._scan_rows: "OrderedDict[Tuple[str, str], Tuple[float, float]]"\
            = OrderedDict()
        self._join_rows: "OrderedDict[frozenset, float]" = OrderedDict()
        # dcn exchange observations: digest -> (side->bytes, side->
        # shard-map version). Survives schema_version invalidation by
        # design (see record_shuffle); bounded by the same capacity.
        self._shuffle: "OrderedDict[str, tuple]" = OrderedDict()
        self.evicted = 0
        self.invalidations = 0
        self.recorded = 0

    # -- recording ----------------------------------------------------------

    def record(self, digest: str, plan_digest: str, apd: bool,
               obs: Observation, capacity: Optional[int] = None) -> bool:
        """Fold one execution's observation. Returns True when a NEW
        significant cardinality hint appeared (the caller then evicts
        the digest's plan-cache entries so the next planning actually
        consults it)."""
        if not digest:
            return False
        new_hint = False
        with self.lock:
            if capacity is not None:
                self.capacity = max(1, int(capacity))
            variants = self._by_digest.get(digest)
            if variants is None:
                variants = self._by_digest[digest] = {}
            self._by_digest.move_to_end(digest)
            v = variants.get(plan_digest)
            if v is None:
                v = variants[plan_digest] = _Variant(
                    digest, plan_digest, apd)
            v.execs += 1
            v.eager_partial = obs.eager_partial
            v.fused_probe = v.fused_probe or obs.fused_probe
            v.best_any_s = (obs.latency_s if v.best_any_s is None
                            else min(v.best_any_s, obs.latency_s))
            if obs.warm:
                v.warm_execs += 1
                v.best_warm_s = (obs.latency_s if v.best_warm_s is None
                                 else min(v.best_warm_s, obs.latency_s))
            for op, est, actual in obs.ops:
                cur = v.ops.get(op)
                if cur is None:
                    if len(v.ops) >= 64:  # bound pathological plans
                        continue
                    v.ops[op] = OpObservation(op, est, actual)
                else:
                    cur.fold(est, actual)
            v.tile_chunks += obs.tile_chunks
            v.tile_overflows += obs.tile_overflows
            v.tile_max_need = max(v.tile_max_need, obs.tile_max_need)
            v.topn_overflow = max(v.topn_overflow, obs.topn_overflow)
            if obs.worst_drift > v.worst_drift:
                v.worst_drift = obs.worst_drift
                v.worst_drift_op = obs.worst_drift_op
            for key, (actual, base) in obs.scan_rows.items():
                # scan hints never force a plan-cache eviction: they
                # refine estimates at the NEXT natural replan (a lone
                # misestimated filter rarely changes the plan, and
                # evicting would break the hit-on-second-execution
                # contract for every drifting point lookup)
                self._scan_rows[key] = (actual, base)
                self._scan_rows.move_to_end(key)
            for key, actual in obs.join_rows.items():
                prev = self._join_rows.get(key)
                self._join_rows[key] = actual
                self._join_rows.move_to_end(key)
                if prev is None or abs(prev - actual) > 0.5 * max(
                        actual, 1.0):
                    new_hint = True
            self.recorded += 1
            while len(self._by_digest) > self.capacity:
                self._by_digest.popitem(last=False)
                self.evicted += 1
            cap8 = self.capacity * 8  # a few shapes per digest
            while len(self._scan_rows) > cap8:
                self._scan_rows.popitem(last=False)
            while len(self._join_rows) > cap8:
                self._join_rows.popitem(last=False)
        return new_hint

    def record_shuffle(self, digest: str, side_bytes: Dict[str, int],
                       versions: Optional[Dict[str, int]] = None) -> None:
        """Observed per-side wire bytes of a dcn shuffle join (the
        coordinator's scatter acks), with the shard-map versions they
        were measured under. Kept in a SEPARATE map that schema_version
        bumps do NOT clear: every dcn query creates a local staging
        table (DDL), which would erase the observation before the next
        planning could use it. The honest invalidation signal for
        exchange sizing is the PLACEMENT version — reshard/reload bumps
        it, and shuffle_hint() refuses stale versions."""
        if not digest or not side_bytes:
            return
        with self.lock:
            cur = self._shuffle.get(digest)
            merged = dict(cur[0]) if cur is not None else {}
            for side, nbytes in side_bytes.items():
                merged[side] = int(nbytes)
            self._shuffle[digest] = (merged, dict(versions or {}))
            self._shuffle.move_to_end(digest)
            while len(self._shuffle) > self.capacity:
                self._shuffle.popitem(last=False)

    # -- invalidation -------------------------------------------------------

    def on_schema_change(self) -> None:
        """DDL/ANALYZE: recorded truth was measured against data and
        stats that no longer exist — drop everything (the plan cache's
        rule, applied to the feedback that would re-shape its plans).
        Exchange observations are exempt: they invalidate by PLACEMENT
        version instead (see record_shuffle) — every dcn query's local
        staging DDL would otherwise erase them immediately."""
        with self.lock:
            self._by_digest.clear()
            self._scan_rows.clear()
            self._join_rows.clear()
            self.invalidations += 1

    # -- consumers ----------------------------------------------------------

    def scan_hint(self, table_name: str, cond_fp: str
                  ) -> Optional[Tuple[float, float]]:
        with self.lock:
            return self._scan_rows.get((table_name, cond_fp))

    def join_hint(self, key: frozenset) -> Optional[float]:
        with self.lock:
            return self._join_rows.get(key)

    def apd_decision(self, digest: str) -> Optional[bool]:
        """Measured eager-agg push-down choice for this digest, or None
        to keep the heuristic default. Only consulted when the session
        default WOULD push (a user pin of 0 is authoritative).

        Protocol: the default (push) plan executes first; if it carried
        an eager partial, the no-push alternative is explored, then the
        warm-measured faster variant wins (cold runs — plan-cache miss
        or kernel recompile — never count as measurements; after
        EXPLORE_BUDGET runs a variant scores by its best cold run so a
        never-warm variant cannot block convergence)."""
        with self.lock:
            variants = self._by_digest.get(digest)
            if not variants:
                return None
            on = next((v for v in variants.values() if v.apd), None)
            off = next((v for v in variants.values() if not v.apd), None)
            if on is None or not on.eager_partial:
                # push-down never fired (or the default variant hasn't
                # run yet): the decision changes nothing — stay default
                return None
            if off is None:
                return False  # explore the no-push alternative once
            s_off, s_on = off.score(), on.score()
            if s_off is None:
                return False   # keep exploring until warm (budgeted)
            if s_on is None:
                return None    # re-measure the default until warm
            return False if s_off < s_on * WIN_MARGIN else None

    def tile_hint(self, digest: str) -> int:
        """Learned join_tiles floor for this digest from observed fused
        tile overflow (0 = no opinion). Dup-heavy probes that overflowed
        their in-program tile expand the remainder in ceil(need/tiles)
        dispatches — size the tile batch to the observed worst need."""
        with self.lock:
            variants = self._by_digest.get(digest)
            if not variants:
                return 0
            need = 0
            for v in variants.values():
                if v.tile_overflows > 0:
                    need = max(need, v.tile_max_need)
            return min(need, 64)

    def topn_overflow(self, digest: str) -> int:
        """Largest ORDER BY+LIMIT k this digest was observed to need
        PAST the fused top-k capacity gate (0 = never overflowed). The
        session consumes it per statement: an overflowing digest's
        SECOND execution starts on the classic materializing sort
        instead of re-failing the fused gate at every open()."""
        with self.lock:
            variants = self._by_digest.get(digest)
            if not variants:
                return 0
            return max((v.topn_overflow for v in variants.values()),
                       default=0)

    def shuffle_hint(self, digest: str,
                     versions: Optional[Dict[str, int]] = None
                     ) -> Dict[str, int]:
        """Observed per-side exchange bytes for this digest, or {} when
        the placement moved since they were measured (any recorded
        table whose current shard-map version differs)."""
        with self.lock:
            hit = self._shuffle.get(digest)
            if hit is None:
                return {}
            side_bytes, recorded_v = hit
            if versions is not None:
                for t, v in recorded_v.items():
                    if versions.get(t, v) != v:
                        del self._shuffle[digest]  # stale: placement
                        return {}                  # moved underneath
            return dict(side_bytes)

    # -- surfaces -----------------------------------------------------------

    def rows(self) -> List[tuple]:
        """information_schema.plan_feedback: one row per recorded
        operator per (digest, plan)."""
        with self.lock:
            out = []
            for digest, variants in self._by_digest.items():
                for v in variants.values():
                    base = (digest, v.plan_digest,
                            "push" if v.apd else "no_push", v.execs,
                            v.warm_execs,
                            round((v.best_warm_s or 0.0) * 1e3, 3),
                            1 if v.eager_partial else 0,
                            1 if v.fused_probe else 0)
                    if not v.ops:
                        out.append(base + ("", -1.0, -1.0, 0.0, 0))
                    for op, o in v.ops.items():
                        out.append(base + (
                            op, round(o.est_rows, 2),
                            round(o.actual_rows, 2),
                            round(o.drift(), 4), o.execs))
            for digest, (side_bytes, _vers) in self._shuffle.items():
                for side, nb in sorted(side_bytes.items()):
                    out.append((digest, "", "shuffle", 0, 0, 0.0, 0, 0,
                                f"shuffle:{side}", -1.0, float(nb),
                                0.0, 0))
            return out

    def stats_dict(self, top: int = 50) -> dict:
        """/plan_feedback endpoint payload."""
        with self.lock:
            digests = []
            for digest, variants in list(self._by_digest.items())[-top:]:
                vs = []
                for v in variants.values():
                    vs.append({
                        "plan_digest": v.plan_digest,
                        "agg_push_down": v.apd,
                        "execs": v.execs,
                        "warm_execs": v.warm_execs,
                        "best_warm_ms": round((v.best_warm_s or 0) * 1e3, 3),
                        "best_any_ms": round((v.best_any_s or 0) * 1e3, 3),
                        "eager_partial": v.eager_partial,
                        "fused_probe": v.fused_probe,
                        "worst_drift": round(v.worst_drift, 3),
                        "worst_drift_op": v.worst_drift_op,
                        "tile_overflow": [v.tile_overflows, v.tile_chunks],
                        "topn_overflow": v.topn_overflow,
                        "ops": {op: [round(o.est_rows, 2),
                                     round(o.actual_rows, 2)]
                                for op, o in v.ops.items()},
                    })
                digests.append({"digest": digest, "variants": vs})
            return {
                "digests": digests,
                "capacity": self.capacity,
                "recorded": self.recorded,
                "evicted": self.evicted,
                "invalidations": self.invalidations,
                "scan_hints": len(self._scan_rows),
                "join_hints": len(self._join_rows),
                "shuffle": {d: dict(sb) for d, (sb, _v)
                            in self._shuffle.items()},
            }

    def clear(self) -> None:
        with self.lock:
            self._by_digest.clear()
            self._scan_rows.clear()
            self._join_rows.clear()
            self._shuffle.clear()
            self.evicted = 0
            self.recorded = 0


STORE = PlanFeedbackStore()


# ---------------------------------------------------------------------------
# planning hints (thread-local: installed by the session around one
# plan_statement call; planner/physical.py estimators consult them)
# ---------------------------------------------------------------------------

class _Hints:
    __slots__ = ("store",)

    def __init__(self, store: PlanFeedbackStore):
        self.store = store

    def scan_rows(self, table, table_name: str, cond, uid_to_name,
                  current_n: float) -> Optional[float]:
        """Observed-selectivity estimate for a filtered scan, or None.
        The stored actual is rescaled by the table's CURRENT cardinality
        so DML between executions ages the hint gracefully."""
        hit = self.store.scan_hint(
            table_name, cond_fingerprint(cond, uid_to_name))
        if hit is None:
            return None
        actual, base = hit
        est = actual if base <= 0 else actual / base * max(current_n, 1.0)
        return max(est, 1.0)

    def join_rows(self, left, right, eq_conds) -> Optional[float]:
        key = join_key_logical(left, right, eq_conds)
        if key is None:
            return None
        return self.store.join_hint(key)


_TLS = threading.local()


class planning_hints:
    """Context manager installing feedback hints for one planning call.
    Reentrant-safe: an inner install (subplan planning) shadows and
    restores."""

    def __init__(self, enabled: bool, store: Optional[PlanFeedbackStore]
                 = None):
        self._hints = _Hints(store or STORE) if enabled else None
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_TLS, "hints", None)
        _TLS.hints = self._hints
        return self._hints

    def __exit__(self, *exc):
        _TLS.hints = self._prev
        return False


def current_hints() -> Optional[_Hints]:
    return getattr(_TLS, "hints", None)


# ---------------------------------------------------------------------------
# harvest (statement end, outside the store lock)
# ---------------------------------------------------------------------------

def harvest(phys, root, result_rows: int, latency_s: float,
            warm: bool) -> Observation:
    """Walk the executed tree and collect est-vs-actual truth. Actuals
    come from RuntimeStats only: ``rows`` when the operator was
    instrumented (EXPLAIN ANALYZE / TRACE), else ``out_rows`` — the
    counts operators learn host-side for free (join match totals,
    aggregate group counts). The plan node each executor answers for
    rides the builder's ``_feedback_plan`` annotation."""
    from tidb_tpu_torch.planner.physical import (PHashAgg, PHashJoin,
                                           PProjection, PScan,
                                           PSelection)

    obs = Observation()
    obs.latency_s = float(latency_s)
    obs.warm = bool(warm)
    # eager-partial detection walks the PLAN (always complete); the
    # exec tree may have absorbed the partial into a fused/transient
    # subtree
    pstack = [phys]
    while pstack:
        p = pstack.pop()
        if isinstance(p, PHashAgg) and any(
                a.uid.startswith("eagg.") for a in p.aggs):
            obs.eager_partial = True
            break
        pstack.extend(p.children)
    seen_plans = set()
    pairs: List[Tuple[object, float]] = []  # (plan node, actual rows)
    stack = [root]
    while stack:
        e = stack.pop()
        stack.extend(c for c in e.children if c is not None)
        p = getattr(e, "_feedback_plan", None)
        st = getattr(e, "stats", None)
        if type(e).__name__ == "FusedScanProbeExec" \
                and getattr(e, "_ran_fused", False):
            obs.fused_probe = True
            if st is not None:
                obs.tile_chunks += st.tile_chunks
                obs.tile_overflows += st.tile_overflows
                obs.tile_max_need = max(obs.tile_max_need,
                                        st.tile_max_need)
        if type(e).__name__ == "FusedScanTopNExec" \
                and getattr(e, "_topn_overflow", 0):
            # the k this root WANTED but couldn't fuse — the store's
            # topn_overflow() consumer routes the digest classic
            obs.topn_overflow = max(obs.topn_overflow,
                                    int(e._topn_overflow))
        # actuals a transient subtree learned before it was dropped —
        # a fused probe's drained build child, or EITHER fused exec's
        # open()-time fallback delegate tree (_close_delegate parks
        # them on the OUTER exec for exactly this walk)
        pairs.extend((bp, float(rows)) for bp, rows
                     in getattr(e, "_fb_build_pairs", ()))
        if p is None or st is None:
            continue
        if st.measured:
            pairs.append((p, float(st.rows)))
        elif st.out_rows >= 0:
            pairs.append((p, float(st.out_rows)))
        elif e is root and result_rows >= 0:
            pairs.append((p, float(result_rows)))

    def peel_projections(p):
        """Physical node -> base PScan through row-preserving
        projections (None when a Selection intervenes: its output count
        is not the scan's)."""
        while isinstance(p, PProjection):
            p = p.child
        if isinstance(p, PSelection):
            return None
        return p if isinstance(p, PScan) and p.table is not None else None

    for p, actual in pairs:
        if id(p) in seen_plans:
            continue
        seen_plans.add(id(p))
        est = float(getattr(p, "est_rows", 0.0))
        # disambiguate same-named operators (a bushy plan has several
        # HashJoins): suffix the occurrence index
        name = p.op_name()
        k = sum(1 for n, _e, _a in obs.ops
                if n == name or n.startswith(name + "#"))
        if k:
            name = f"{name}#{k + 1}"
        obs.ops.append((name, est, actual))
        ratio = actual / est if est > 0 else 0.0
        if ratio > 0:
            sym = max(ratio, 1.0 / ratio)
            if sym > obs.worst_drift:
                obs.worst_drift = sym
                obs.worst_drift_op = p.op_name()
                obs.worst_drift_ratio = ratio
        significant = (est <= 0 or ratio <= 0
                       or ratio >= SIGNIFICANT_DRIFT
                       or ratio <= 1.0 / SIGNIFICANT_DRIFT)
        if not significant:
            continue
        if isinstance(p, PHashJoin) and p.kind == "inner" \
                and all(_base_relation(c) for c in p.children):
            # only joins over BASE relations record a cardinality hint:
            # a join above another join observes its whole subtree's
            # fan-out, which would poison the pairwise estimate the
            # join orderer asks for
            key = _join_key_physical(p)
            if key is not None:
                obs.join_rows[key] = actual
        base = peel_projections(p)
        if base is not None and base.pushed_cond is not None:
            from tidb_tpu_torch.statistics import table_stats

            s = table_stats(base.table)
            n = float(s.n_rows) if s is not None \
                else float(base.table.live_rows)
            uid_to_name = {c.uid: c.name for c in base.schema}
            fp = cond_fingerprint(base.pushed_cond, uid_to_name)
            obs.scan_rows[(base.table_name, fp)] = (actual, n)
    return obs


def drift_factor(obs: Observation) -> float:
    """The symmetric drift of the worst-estimated operator (>= 1.0; 1.0
    = every known estimate was exact). Observed on PLAN_EST_DRIFT."""
    return max(obs.worst_drift, 1.0)
