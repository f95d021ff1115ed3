"""Metrics registry (a copy of tidb_tpu/utils/metrics.py; ref: metrics/ —
Prometheus collectors per layer, served on the HTTP status port).

The engine's own counters in the port are plain dicts in their modules
(the pipeline's, the segment store's, the memory tracker's), which its
tests read and reset directly. They render here under the reference's
family names through ``DictCounter``, a collector that reads the dict at
scrape time.

Counters and histograms with optional labels, exposed in the Prometheus
text format by server/status.py. A process-global REGISTRY mirrors the
reference's package-level collectors; everything is thread-safe under
one lock (metric updates are far off the hot device path).

Fleet aggregation: ``snapshot()`` produces the wire form of every
registered metric and ``render_cluster`` the ``/metrics?scope=cluster``
exposition (per-worker ``worker`` labels plus a merged
``worker="fleet"`` view), and ``cluster_rows`` the same scrape as
information_schema.cluster_metrics rows, over the entries
parallel/dcn.py's ``fleet_metrics_entries()`` gathers (this process as
the coordinator plus every live Cluster's workers)."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "DictCounter", "Histogram", "Gauge", "REGISTRY",
           "Registry",
           "render_prometheus", "snapshot", "merge_snapshots",
           "render_cluster", "cluster_rows", "SNAPSHOT_SCHEMA"]

_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0)


class Registry:
    def __init__(self):
        self.lock = threading.Lock()
        self.metrics: "List[object]" = []

    def register(self, m) -> None:
        with self.lock:
            self.metrics.append(m)


REGISTRY = Registry()


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str = "",
                 registry: Optional[Registry] = None):
        self.name = name
        self.help = help_
        self.lock = threading.Lock()
        (registry or REGISTRY).register(self)


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_="", registry=None):
        super().__init__(name, help_, registry)
        self._values: Dict[Tuple, float] = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self.lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels) -> float:
        with self.lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)

    def remove(self, **labels) -> None:
        """Drop one label set (an LRU-evicted digest's gauge must not
        render a stale value forever)."""
        with self.lock:
            self._values.pop(tuple(sorted(labels.items())), None)

    def samples(self):
        with self.lock:  # snapshot: writers may insert new label keys
            items = sorted(self._values.items())
        for key, v in items:
            yield dict(key), v


class Gauge(Counter):
    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        with self.lock:
            self._values[tuple(sorted(labels.items()))] = v

    def dec(self, n: float = 1.0, **labels) -> None:
        self.inc(-n, **labels)


class DictCounter(Counter):
    """A counter family whose values live in a plain dict (or list) of
    another module, read at scrape time: ``attr`` of module ``module``
    (or, for a tuple of modules, their dicts merged). With ``label``,
    every non-zero key renders as one sample labelled ``{label: key}``;
    with ``key``, that one entry renders unlabelled. The modules are
    looked up lazily, so registering never imports them."""

    def __init__(self, name, help_, module, attr: str,
                 label: Optional[str] = None, key=None, registry=None):
        super().__init__(name, help_, registry)
        self._mods = (module,) if isinstance(module, str) else tuple(module)
        self._attr = attr
        self._label = label
        self._key = key

    def _dict(self):
        import sys

        found = [d for d in (getattr(sys.modules.get(m), self._attr, None)
                             for m in self._mods) if d is not None]
        if len(found) <= 1:
            return found[0] if found else None
        merged = {}
        for d in found:
            merged.update(d)
        return merged

    def inc(self, n: float = 1.0, **labels) -> None:
        raise TypeError(f"{self.name} counts in {self._mods[0]}.{self._attr}")

    def value(self, **labels) -> float:
        d = self._dict()
        if d is None:
            return 0.0
        k = labels.get(self._label) if self._label else self._key
        try:
            return float(d[k])
        except (KeyError, IndexError, TypeError):
            return 0.0

    def samples(self):
        d = self._dict()
        if d is None:
            return
        if self._label is None:
            v = float(d[self._key])
            if v:
                yield {}, v
            return
        for k, v in sorted(dict(d).items()):
            if v:
                yield {self._label: k}, float(v)


# a stored exemplar older than this stops shielding its (possibly
# smaller) value: the "worst recent observation" window
_EXEMPLAR_WINDOW_S = 60.0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_="", buckets=_DEFAULT_BUCKETS,
                 registry=None, exemplars: bool = False):
        super().__init__(name, help_, registry)
        self.buckets = tuple(buckets)
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        # exemplars=True: each observation under an active trace may
        # become the label set's exemplar — the trace_id of the worst
        # recent observation, rendered OpenMetrics-style on the +Inf
        # bucket so /metrics links straight to /trace?id=<trace_id>
        self.exemplars_enabled = exemplars
        self._exemplars: Dict[Tuple, Tuple[float, str, float]] = {}

    def observe(self, v: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        trace_id = ""
        if self.exemplars_enabled:
            from tidb_tpu_torch.utils import tracing

            trace_id = tracing.current_trace_id()
        with self.lock:
            counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            i = 0
            while i < len(self.buckets) and v > self.buckets[i]:
                i += 1
            counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + v
            if trace_id:
                import time as _time

                now = _time.time()
                cur = self._exemplars.get(key)
                if cur is None or v >= cur[0] \
                        or now - cur[2] > _EXEMPLAR_WINDOW_S:
                    self._exemplars[key] = (v, trace_id, now)

    def exemplar(self, **labels) -> Optional[Tuple[float, str]]:
        """(value, trace_id) of the worst recent observation, or None."""
        with self.lock:
            e = self._exemplars.get(tuple(sorted(labels.items())))
        return (e[0], e[1]) if e is not None else None

    def count(self, **labels) -> int:
        with self.lock:
            return sum(self._counts.get(tuple(sorted(labels.items())), []))

    def samples(self):
        with self.lock:  # snapshot under the lock (see Counter.samples)
            items = [(k, list(self._counts[k]), self._sums.get(k, 0.0),
                      self._exemplars.get(k))
                     for k in sorted(self._counts)]
        for key, counts, total, ex in items:
            yield dict(key), counts, total, ex


def _fmt_labels(labels: Dict, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in labels.items()]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _exemplar_kept(trace_id: str) -> int:
    """1 when the exemplar's trace is currently readable on /trace?id=.
    Exemplars record trace_id at OBSERVATION time; the trace may later
    be discarded (head sampling) or ring-evicted — annotating the
    rendered exemplar stops operators chasing 404s for those."""
    from tidb_tpu_torch.utils import tracing

    return 1 if tracing.STORE.get(trace_id) is not None else 0


def _exemplar_tail(ex) -> str:
    """OpenMetrics exemplar rendering: the worst recent observation's
    trace_id (+ whether that trace is still fetchable), on +Inf."""
    if ex is None:
        return ""
    kept = ex[2] if len(ex) > 2 else _exemplar_kept(ex[1])
    return (f' # {{trace_id="{ex[1]}",kept="{int(kept)}"}}'
            f' {round(float(ex[0]), 6)}')


def render_prometheus(registry: Optional[Registry] = None) -> str:
    """Prometheus text exposition of every registered metric."""
    reg = registry or REGISTRY
    out = []
    with reg.lock:
        metrics = list(reg.metrics)
    for m in metrics:
        out.append(f"# HELP {m.name} {m.help}")
        out.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            for labels, counts, total, ex in m.samples():
                acc = 0
                for b, c in zip(m.buckets, counts):
                    acc += c
                    le = _fmt_labels(labels, f'le="{b}"')
                    out.append(f"{m.name}_bucket{le} {acc}")
                acc += counts[-1]
                le = _fmt_labels(labels, 'le="+Inf"')
                ex2 = (ex[0], ex[1]) if ex is not None else None
                out.append(f"{m.name}_bucket{le} {acc}"
                           f"{_exemplar_tail(ex2)}")
                out.append(f"{m.name}_sum{_fmt_labels(labels)} {total}")
                out.append(f"{m.name}_count{_fmt_labels(labels)} {acc}")
        else:
            for labels, v in m.samples():
                out.append(f"{m.name}{_fmt_labels(labels)} {v}")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# fleet aggregation: snapshot wire form + merge + renderers
# ---------------------------------------------------------------------------

SNAPSHOT_SCHEMA = 1


def snapshot(registry: Optional[Registry] = None) -> Dict:
    """DCN-codec-safe wire form of every registered metric (the
    ``metrics_snapshot`` RPC payload): name/kind/help per metric, label
    dicts + scalar values per sample; histograms carry their bucket
    bounds, per-bucket counts, sum, and the exemplar as
    ``[value, trace_id, kept]`` — ``kept`` is stamped HERE because only
    the observing process's trace store can answer it."""
    reg = registry or REGISTRY
    with reg.lock:
        metrics = list(reg.metrics)
    out = []
    for m in metrics:
        d: Dict = {"name": m.name, "kind": m.kind, "help": m.help}
        if isinstance(m, Histogram):
            d["buckets"] = [float(b) for b in m.buckets]
            d["samples"] = [
                [labels, list(counts), float(total),
                 None if ex is None
                 else [float(ex[0]), str(ex[1]), _exemplar_kept(ex[1])]]
                for labels, counts, total, ex in m.samples()]
        else:
            d["samples"] = [[labels, float(v)]
                            for labels, v in m.samples()]
        out.append(d)
    return {"schema": SNAPSHOT_SCHEMA, "metrics": out}


def _iter_snap_metrics(entries):
    """(worker_label, metric_dict) over every well-formed snapshot in
    scrape entries [(label, snapshot|None, error)] — malformed or
    errored entries contribute nothing here (their error surfaces
    separately)."""
    for label, snap, _err in entries:
        if not isinstance(snap, dict):
            continue
        for m in snap.get("metrics") or ():
            if isinstance(m, dict) and m.get("name"):
                yield label, m


def merge_snapshots(entries) -> List[Dict]:
    """Fleet-merged metric list from scrape entries
    ``[(worker_label, snapshot|None, error)]``:

      * counters — label-set values SUM across workers
      * gauges — per-worker readings only (a summed queue depth or
        health state is a lie); merged output omits them
      * histograms — per-bucket counts and sums merge bucket-wise
        (requires identical bucket bounds — all processes run the same
        collectors; a mismatched snapshot's sample is skipped)
      * exemplars — the worst (max-value) observation wins

    Returns metric dicts in the snapshot shape, first-seen order."""
    merged: "Dict[str, Dict]" = {}
    order: List[str] = []
    for _label, m in _iter_snap_metrics(entries):
        name, kind = m["name"], m.get("kind", "untyped")
        if kind == "gauge":
            continue
        cur = merged.get(name)
        if cur is None:
            cur = merged[name] = {"name": name, "kind": kind,
                                  "help": m.get("help", ""),
                                  "samples": {}}
            if kind == "histogram":
                cur["buckets"] = list(m.get("buckets") or ())
            order.append(name)
        for s in m.get("samples") or ():
            try:
                labels = dict(s[0])
                key = tuple(sorted(labels.items()))
            except (TypeError, IndexError):
                continue
            if kind == "histogram":
                if list(m.get("buckets") or ()) != cur["buckets"]:
                    continue  # foreign bucket layout: unmergeable
                counts, total = list(s[1]), float(s[2])
                ex = s[3] if len(s) > 3 else None
                hit = cur["samples"].get(key)
                if hit is None:
                    cur["samples"][key] = [labels, counts, total, ex]
                else:
                    hit[1] = [a + b for a, b in zip(hit[1], counts)]
                    hit[2] += total
                    if ex is not None and (hit[3] is None
                                           or ex[0] >= hit[3][0]):
                        hit[3] = ex
            else:
                v = float(s[1])
                hit = cur["samples"].get(key)
                if hit is None:
                    cur["samples"][key] = [labels, v]
                else:
                    hit[1] += v
    out = []
    for name in order:
        m = merged[name]
        m["samples"] = list(m["samples"].values())
        out.append(m)
    return out


def _snap_sample_lines(m: Dict, labels: Dict, s, out: List[str]) -> None:
    """Exposition lines of one snapshot-form sample (histogram or
    scalar), shared by the per-worker and fleet sections."""
    name = m["name"]
    if m.get("kind") == "histogram":
        counts, total = s[1], s[2]
        ex = s[3] if len(s) > 3 else None
        acc = 0
        for b, c in zip(m.get("buckets") or (), counts):
            acc += c
            le = _fmt_labels(labels, f'le="{b}"')
            out.append(f"{name}_bucket{le} {acc}")
        acc += counts[-1] if counts else 0
        le = _fmt_labels(labels, 'le="+Inf"')
        out.append(f"{name}_bucket{le} {acc}{_exemplar_tail(ex)}")
        out.append(f"{name}_sum{_fmt_labels(labels)} {total}")
        out.append(f"{name}_count{_fmt_labels(labels)} {acc}")
    else:
        out.append(f"{name}{_fmt_labels(labels)} {s[1]}")


def render_cluster(entries) -> str:
    """Prometheus text exposition of a cluster scrape: every worker's
    samples labeled ``worker=<label>``, the merged fleet view labeled
    ``worker="fleet"`` (counters/histograms only — see
    merge_snapshots), and one ``tidb_tpu_cluster_scrape_error`` gauge
    sample per unreachable worker (the scrape itself never fails)."""
    out: List[str] = []
    seen_meta = set()
    by_name: "Dict[str, List]" = {}
    order: List[str] = []
    for label, m in _iter_snap_metrics(entries):
        if m["name"] not in by_name:
            by_name[m["name"]] = []
            order.append(m["name"])
        by_name[m["name"]].append((label, m))
    fleet = {m["name"]: m for m in merge_snapshots(entries)}
    for name in order:
        first = by_name[name][0][1]
        if name not in seen_meta:
            seen_meta.add(name)
            out.append(f"# HELP {name} {first.get('help', '')}")
            out.append(f"# TYPE {name} {first.get('kind', 'untyped')}")
        for label, m in by_name[name]:
            for s in m.get("samples") or ():
                try:
                    labels = dict(s[0])
                except (TypeError, IndexError):
                    continue
                labels["worker"] = label
                _snap_sample_lines(m, labels, s, out)
        fm = fleet.get(name)
        if fm is not None:
            for s in fm["samples"]:
                labels = dict(s[0])
                labels["worker"] = "fleet"
                _snap_sample_lines(fm, labels, s, out)
    errs = [(label, err) for label, snap, err in entries if err]
    if errs:
        out.append("# HELP tidb_tpu_cluster_scrape_error Workers whose "
                   "metrics_snapshot RPC failed during this cluster "
                   "scrape (error row, not a failed scrape)")
        out.append("# TYPE tidb_tpu_cluster_scrape_error gauge")
        for label, err in errs:
            lbl = _fmt_labels({"worker": label,
                               "error": err.replace('"', "'")})
            out.append(f"tidb_tpu_cluster_scrape_error{lbl} 1")
    return "\n".join(out) + "\n"


def cluster_rows(entries) -> List[tuple]:
    """information_schema.cluster_metrics rows from scrape entries:
    ``(worker, metric, labels, value, error)``. Histograms contribute
    their ``_count`` and ``_sum`` series (the SQL surface is for
    totals; bucket shapes live on /metrics). Fleet-merged rows carry
    ``worker='fleet'``; an unreachable worker yields one row whose
    ``error`` is set and whose metric columns are NULL."""
    rows: List[tuple] = []

    def sample_rows(worker: str, m: Dict) -> None:
        name = m["name"]
        for s in m.get("samples") or ():
            try:
                labels = dict(s[0])
            except (TypeError, IndexError):
                continue
            lbl = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            if m.get("kind") == "histogram":
                rows.append((worker, f"{name}_count", lbl,
                             float(sum(s[1])), ""))
                rows.append((worker, f"{name}_sum", lbl, float(s[2]), ""))
            else:
                rows.append((worker, name, lbl, float(s[1]), ""))

    for label, snap, err in entries:
        if err:
            rows.append((label, None, None, None, err))
            continue
        if not isinstance(snap, dict):
            continue
        for m in snap.get("metrics") or ():
            if isinstance(m, dict) and m.get("name"):
                sample_rows(label, m)
    for m in merge_snapshots(entries):
        sample_rows("fleet", m)
    return rows


# -- engine collectors (ref: metrics/*.go one file per layer) ---------------

QUERY_TOTAL = Counter("tidb_tpu_query_total", "Statements executed, by type/status")
QUERY_DURATION = Histogram("tidb_tpu_query_duration_seconds",
                           "Statement wall time, by type")
SLOW_QUERY_TOTAL = Counter("tidb_tpu_slow_query_total",
                           "Statements exceeding tidb_slow_log_threshold")
TXN_TOTAL = Counter("tidb_tpu_txn_total", "Transaction outcomes")
GC_RECLAIMED = Counter("tidb_tpu_gc_reclaimed_rows_total",
                       "MVCC versions reclaimed by GC")
CONN_GAUGE = Gauge("tidb_tpu_connections", "Open server connections")
EXTERNAL_AGG = Counter("tidb_tpu_external_agg_total",
                       "Key-range external aggregation merges (group "
                       "state exceeded the memory budget)")

# -- the mesh tier (parallel/): fragment executions and merges -------------

FRAGMENT_DISPATCH = Counter("tidb_tpu_fragment_dispatch_total",
                            "Distributed fragment executions, by kind")
FRAGMENT_SECONDS = Histogram(
    "tidb_tpu_fragment_seconds",
    "Wall time of one mesh-fragment execution, by kind (eager dispatch: "
    "the host's launches and collectives, not device busy time); "
    "carries a trace_id exemplar for the worst recent execution",
    exemplars=True)
FRAGMENT_COMPILE = Counter(
    "tidb_tpu_fragment_compile_total",
    "Fragment programs compiled from plan subtrees, by output kind")
COLLECTIVE_MERGE_SECONDS = Histogram(
    "tidb_tpu_collective_merge_seconds",
    "Merge of per-shard collective states across streamed fragment "
    "batches")

# -- the DCN tier (parallel/dcn.py): wire traffic, RPCs, failure domain ----

DCN_BYTES = Counter(
    "tidb_tpu_dcn_bytes_total",
    "DCN tier wire traffic through this process, by direction")
DCN_RTT = Histogram(
    "tidb_tpu_dcn_rtt_seconds",
    "Coordinator-observed round-trip time of one DCN worker call")
DCN_RPC_SECONDS = Histogram(
    "tidb_tpu_dcn_rpc_seconds",
    "One coordinator->worker RPC round trip, by rpc command; carries a "
    "trace_id exemplar for the worst recent call so /metrics links "
    "straight to the offending trace on /trace?id=",
    exemplars=True)
DCN_RETRY_TOTAL = Counter(
    "tidb_tpu_dcn_retry_total",
    "DCN recovery actions by kind: rpc (idempotent call re-sent on a "
    "fresh connection), reconnect (worker socket re-established by the "
    "health machine), cancel_dial (side-channel connection opened to "
    "deliver a cancel)")
DCN_FAILOVER_TOTAL = Counter(
    "tidb_tpu_dcn_failover_total",
    "Partition partials re-run on a replica worker after the primary "
    "(and its retry) was unreachable")
WORKER_STATE = Gauge(
    "tidb_tpu_dcn_worker_state",
    "Per-worker health-machine state: 0=up, 1=suspect, 2=down")
DCN_CANCEL_TOTAL = Counter(
    "tidb_tpu_dcn_cancel_total",
    "Coordinator-initiated cancels of in-flight worker partials "
    "(KILL propagation / statement deadline expiry)")

# -- sharded placement, the cross-process shuffle, membership --------------

SHUFFLE_BYTES_TOTAL = Counter(
    "tidb_tpu_shuffle_bytes_total",
    "Cross-worker shuffle exchange payload bytes (FoR-encoded batches) "
    "by direction: out = shipped to a peer worker, in = staged into "
    "the local inbox from a peer")
SHARD_SCAN_TOTAL = Counter(
    "tidb_tpu_shard_scan_total",
    "Distributed statements planned against SHARD BY placement, by "
    "whether owner pruning skipped part of the fleet (pruned=yes: at "
    "least one non-owner worker received no RPC and did no work)")
RESHARD_SHARDS_TOTAL = Counter(
    "tidb_tpu_reshard_shards_total",
    "Per-shard online-reshard steps completed, by phase: backfill = "
    "shard snapshot staged at its new owner (double-write window "
    "opened), cutover = shard validated and flipped to the new "
    "placement")
RESHARD_ACTIVE = Gauge(
    "tidb_tpu_reshard_active",
    "1 while the labeled table has an online reshard in flight "
    "(statements keep serving by the old map; DML double-writes moved "
    "shards), 0 once the new placement is installed or the run "
    "abandoned")
MEMBERSHIP_TOTAL = Counter(
    "tidb_tpu_membership_total",
    "Cluster membership changes completed, by kind: join = "
    "add_worker admitted a new worker into the serving fleet, remove "
    "= remove_worker drained one out")

# -- execution telemetry (launches, planning, joins, memory) ---------------

DISPATCH_TOTAL = DictCounter(
    "tidb_tpu_device_dispatch_total",
    "Launches of the port's CUDA kernels, by kernel entry: the wrappers' "
    "process totals (utils.dispatch keeps each thread's own count)",
    ("tidb_tpu_torch.ops.segment_sum", "tidb_tpu_torch.ops.hash_probe"),
    "LAUNCHES", label="site")
PLAN_CACHE_TOTAL = Counter(
    "tidb_tpu_plan_cache_total",
    "Plan-cache events by kind: hit, miss, bypass (ineligible or "
    "known-uncacheable statement), evict (LRU), invalidate (schema/"
    "stats change)")
PARSE_SECONDS = Histogram(
    "tidb_tpu_parse_seconds",
    "SQL text -> AST wall time per parse() call")
PLAN_SECONDS = Histogram(
    "tidb_tpu_plan_seconds",
    "Logical optimization + physical lowering wall time per "
    "plan_statement call (cache hits skip this entirely)")
JOIN_COMPILE_TOTAL = Counter(
    "tidb_tpu_join_compile_total",
    "Join programs built, by kernel: fusedprobe (the fused scan->probe "
    "batch program, built once per plan shape by utils/jitcache.py); a "
    "steady-state repeated join must not move it")
JOIN_PROBE_MODE_TOTAL = DictCounter(
    "tidb_tpu_join_probe_mode_total",
    "Probe chunks resolved per route of tidb_probe_count, by mode: "
    "direct (dense-domain direct-address index), table (open-addressing "
    "hash table), sorted (range lookup over the sorted build) — the "
    "join path's own calls (ops.join_kernels.PROBE_ROUTES); a DCN "
    "coordinator reads its workers' through metrics_snapshot",
    "tidb_tpu_torch.ops.join_kernels", "PROBE_ROUTES", label="mode")
JOIN_PROBE_SECONDS = Histogram(
    "tidb_tpu_join_probe_seconds",
    "Host wall time of one probe pass over a probe chunk, from its launch "
    "to its match total on the host (a deferred chunk's wait for its "
    "window's one read included), by join kind; carries a trace_id "
    "exemplar for the worst recent pass",
    exemplars=True)
JOIN_BUILD_SECONDS = Histogram(
    "tidb_tpu_join_build_seconds",
    "Host wall time of one hash-join build phase (drain + pack + sort, "
    "the device work it waits on included), by tier: device (packed and "
    "sorted on the card), host_sorted (tidb_tpu_join_device_build=0 "
    "escape hatch)")
DEADLINE_EXCEEDED_TOTAL = Counter(
    "tidb_tpu_deadline_exceeded_total",
    "Statements aborted because max_execution_time expired")
MEM_QUOTA_ENGAGED = DictCounter(
    "tidb_tpu_mem_quota_engaged_total",
    "Queries whose host memory consumption crossed tidb_mem_quota_query "
    "(spill or cancel followed)", "tidb_tpu_torch.utils.memory", "MEM_QUOTA_ENGAGED", key=0)
SPILL_TOTAL = DictCounter(
    "tidb_tpu_spill_total", "Operator-state spill events to tmp storage",
    "tidb_tpu_torch.utils.memory", "SPILL_TOTAL", key="spills")
SPILL_BYTES = DictCounter(
    "tidb_tpu_spill_bytes_total", "Bytes shed to tmp storage by spills",
    "tidb_tpu_torch.utils.memory", "SPILL_TOTAL", key="bytes")


# -- columnar segment store ---------------------------------------

SCAN_SEGMENTS_SCANNED_TOTAL = DictCounter(
    "tidb_tpu_scan_segments_scanned_total",
    "Columnar segments staged by table scans (after zone-map pruning); "
    "with ..._pruned_total this gives the engine-reported pruning "
    "fraction the Q6 perf floor asserts on",
    "tidb_tpu_torch.columnar.store", "SCAN_SEGMENTS_TOTAL", key="scanned")
SCAN_SEGMENTS_PRUNED_TOTAL = DictCounter(
    "tidb_tpu_scan_segments_pruned_total",
    "Columnar segments skipped before host->device staging because the "
    "scan's pushed range/equality predicates cannot match the "
    "segment's zone maps (min/max/null_count)",
    "tidb_tpu_torch.columnar.store", "SCAN_SEGMENTS_TOTAL", key="pruned")
SPILL_SEGMENT_BYTES = DictCounter(
    "tidb_tpu_spill_segment_bytes_total",
    "Encoded segment payload bytes moved across the disk spill "
    "boundary, by direction: out = evicted to a segment spill file "
    "under the statement memory budget, in = re-materialized from "
    "disk on a later touch", "tidb_tpu_torch.columnar.store", "SPILL_SEGMENT_BYTES", label="dir")

# -- pipelined device-resident execution --------------------------

PIPELINE_PREFETCH_TOTAL = DictCounter(
    "tidb_tpu_pipeline_prefetch_total",
    "Chunk staging events through the double-buffered pipeline, by "
    "outcome: hit (buffer was already staged when the compute loop "
    "asked), wait (the loop blocked on in-flight staging), inline "
    "(prefetch disabled or depth exhausted — staged synchronously), "
    "cancelled (KILL/deadline stopped the staging thread mid-fragment), "
    "error (staging died on quota OOM or another fault — relayed typed "
    "to the compute loop)", "tidb_tpu_torch.executor.pipeline", "PIPELINE_PREFETCH_TOTAL",
    label="outcome")
PIPELINE_PREFETCH_BYTES = DictCounter(
    "tidb_tpu_pipeline_prefetch_bytes_total",
    "Host->device bytes moved by the pipeline staging thread ahead of "
    "compute (double-buffered overlap; inline stagings count too)",
    "tidb_tpu_torch.executor.pipeline", "PIPELINE_PREFETCH_BYTES", key="h2d")
DEVICE_CACHE_TOTAL = DictCounter(
    "tidb_tpu_device_cache_total",
    "Cross-statement device buffer cache events, by kind: hit (a warm "
    "statement reused staged device buffers and moved zero bytes), "
    "miss, evict (LRU under tidb_tpu_device_buffer_cache_bytes), "
    "invalidate (table version/data_epoch/stats moved, or a schema "
    "change cleared the cache — the plan cache's invalidation rules)",
    "tidb_tpu_torch.executor.pipeline", "DEVICE_CACHE_TOTAL", label="kind")

# -- tracing ----------------------------------------------------------------

TRACE_KEPT_TOTAL = Counter(
    "tidb_tpu_trace_kept_total",
    "Traces retained in the tail-sampled store, by first keep reason "
    "(sampled, slow, error:*, retry, failover, trace)")

# -- plan feedback --------------------------------------------------------

PLAN_EST_DRIFT = Histogram(
    "tidb_tpu_plan_est_drift",
    "Per-statement worst-operator estimation drift: max(actual/est, "
    "est/actual) over every operator whose actual row count the "
    "feedback harvest knew — 1.0 means every estimate was exact, 100 a "
    "hundredfold misestimate; carries a trace_id exemplar for the "
    "worst recent statement so /metrics links the drift straight to "
    "its trace",
    buckets=(1.0, 1.5, 2.0, 4.0, 10.0, 30.0, 100.0, 1000.0),
    exemplars=True)


# -- serving tier: admission-controlled scheduler + micro-batching ----------

SCHED_QUEUE_DEPTH = Gauge(
    "tidb_tpu_sched_queue_depth",
    "Statements admitted but not yet claimed by a scheduler worker "
    "(queued singletons + members of still-gathering batch groups)")
SCHED_ADMISSION_TOTAL = Counter(
    "tidb_tpu_sched_admission_total",
    "Scheduler admission decisions, by outcome: admitted, rejected "
    "(queue full / server memory quota / draining), timed_out (admitted "
    "but evicted after tidb_tpu_sched_queue_timeout_ms unclaimed)")
BATCH_SIZE = Histogram(
    "tidb_tpu_batch_size",
    "Members per coalesced device dispatch (1 = a batchable statement "
    "whose gather window closed alone)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128))
BATCH_COALESCE_TOTAL = Counter(
    "tidb_tpu_batch_coalesce_total",
    "Statements that rode a multi-statement coalesced dispatch (members "
    "of batches with n >= 2; singleton executions never count)")

# -- write path: group-commit DML + background compaction --------

DML_BATCH_SIZE = Histogram(
    "tidb_tpu_dml_batch_size",
    "Members per group-committed DML window (1 = a batchable write "
    "whose gather window closed alone); mirrors tidb_tpu_batch_size "
    "for the read path",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128))
COMPACTION_TOTAL = DictCounter(
    "tidb_tpu_compaction_total",
    "Delta->segment rebuild passes, by outcome: background (worker "
    "build installed at cutover), inline (statement-path rebuild — the "
    "pre-compaction behavior, still used when tidb_tpu_compaction=0 or "
    "force-refresh), inline_fallback (worker queue full or dead: typed "
    "degradation back to the statement path), discarded (the store "
    "changed under the worker's snapshot; built segments dropped), "
    "failed (background build raised)", "tidb_tpu_torch.columnar.store", "COMPACTION_TOTAL",
    label="outcome")
COMPACTION_BYTES = DictCounter(
    "tidb_tpu_compaction_bytes_total",
    "Encoded segment bytes produced by delta->segment rebuilds "
    "(background and inline alike); with tidb_tpu_compaction_total "
    "this gives bytes-per-pass and the write amplification trend",
    "tidb_tpu_torch.columnar.store", "COMPACTION_BYTES", key="bytes")

# -- cluster observability plane ---------------------------------

XFER_BYTES = Counter(
    "tidb_tpu_xfer_bytes_total",
    "Host<->device transfer bytes observed at the EXISTING staging/"
    "fetch choke points (prefetcher stagings, probe-window and agg "
    "drains), by dir: h2d, d2h — the process-wide mirror of the "
    "per-statement profile accounting; no new device syncs are paid "
    "to collect it")
COMPILE_SECONDS = Counter(
    "tidb_tpu_compile_seconds_total",
    "Wall seconds spent in first-invocation kernel/fragment "
    "trace+compile, attributed to the triggering statement's profile "
    "(warm statements add zero)")
DIGEST_P99 = Gauge(
    "tidb_tpu_digest_p99_seconds",
    "Sliding-window p99 statement latency per digest (the SLO store's "
    "view; label sets follow the store's LRU — an evicted digest's "
    "series is removed)")
SLO_SHED_TOTAL = Counter(
    "tidb_tpu_slo_shed_total",
    "Statements shed at admission under queue pressure because their "
    "digest was burning its latency SLO budget fastest "
    "(tidb_tpu_sched_slo_shed; plans and results are never affected)")
