"""HTTP status port (a copy of tidb_tpu/server/status.py; ref: the
tidb-server status port: /metrics for Prometheus, /status for
liveness/version, plus schema introspection).

Endpoints:
    /metrics     - Prometheus text exposition of tidb_tpu_* collectors;
                   ?scope=cluster scrapes every live Cluster's workers
                   over DCN and renders per-worker `worker` labels plus
                   the merged `worker="fleet"` view (unreachable
                   workers become error samples, never a failed scrape)
    /status      - JSON: version, connections, schema version, uptime
    /schema      - JSON: databases -> tables -> row counts
    /statements  - JSON: top-N statement digests by cumulative latency
                   (?top=N, default 50) from the statements-summary store
    /plan_cache  - JSON: plan-cache hit/miss/bypass/evict/invalidate
                   totals plus per-entry digests (?top=N, default 50)
    /cluster     - JSON: per-worker DCN health machine (up/suspect/down,
                   reconnect counts, backoff windows) for every live
                   Cluster in this process
    /scheduler   - JSON: serving-tier stats for every live statement
                   scheduler (queue depth, inflight batches, admission
                   counters, per-digest coalesce counts)
    /trace       - JSON: summaries of the kept (tail-sampled) traces
                   (?top=N, default 50); /trace?id=<trace_id> returns
                   one trace's full cross-process span tree
    /plan_feedback - JSON: the plan-feedback store (?top=N digests,
                   default 50): per-(digest, plan) est-vs-actual
                   operator cardinalities, warm latencies, eager-agg
                   exploration state, tile-overflow telemetry
    /slo         - JSON: the per-digest latency SLO store (?top=N,
                   default 50): sliding-window p50/p95/p99, breach
                   counts, and burn ratios against tidb_tpu_slo_target_ms
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

__all__ = ["StatusServer"]


class StatusServer:
    def __init__(self, catalog, host: str = "127.0.0.1", port: int = 10080,
                 version: str = ""):
        self.catalog = catalog
        self.version = version
        self.started = time.time()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                try:
                    if self.path == "/metrics" or \
                            self.path.startswith("/metrics?"):
                        from urllib.parse import parse_qs, urlparse

                        q = parse_qs(urlparse(self.path).query)
                        if q.get("scope", [""])[0] == "cluster":
                            from tidb_tpu_torch.parallel.dcn import \
                                fleet_metrics_entries
                            from tidb_tpu_torch.utils.metrics import \
                                render_cluster

                            body = render_cluster(
                                fleet_metrics_entries()).encode()
                        else:
                            from tidb_tpu_torch.utils.metrics import \
                                render_prometheus

                            body = render_prometheus().encode()
                        ctype = "text/plain; version=0.0.4"
                    elif self.path == "/status":
                        from tidb_tpu_torch.utils.metrics import CONN_GAUGE

                        body = json.dumps({
                            "version": outer.version,
                            "status": "ok",
                            "connections": CONN_GAUGE.value(),
                            "schema_version": outer.catalog.schema_version,
                            "uptime_s": round(time.time() - outer.started, 1),
                        }).encode()
                        ctype = "application/json"
                    elif self.path == "/statements" or \
                            self.path.startswith("/statements?"):
                        from urllib.parse import parse_qs, urlparse

                        q = parse_qs(urlparse(self.path).query)
                        try:
                            top = int(q.get("top", ["50"])[0])
                        except ValueError:
                            top = 50
                        body = json.dumps({
                            "statements":
                                outer.catalog.stmt_summary.top(top),
                            "evicted": outer.catalog.stmt_summary.evicted,
                        }).encode()
                        ctype = "application/json"
                    elif self.path == "/plan_cache" or \
                            self.path.startswith("/plan_cache?"):
                        from urllib.parse import parse_qs, urlparse

                        q = parse_qs(urlparse(self.path).query)
                        try:
                            top = int(q.get("top", ["50"])[0])
                        except ValueError:
                            top = 50
                        body = json.dumps(
                            outer.catalog.plan_cache.stats_dict(top)).encode()
                        ctype = "application/json"
                    elif self.path == "/trace" or \
                            self.path.startswith("/trace?"):
                        from urllib.parse import parse_qs, urlparse

                        from tidb_tpu_torch.utils import tracing

                        q = parse_qs(urlparse(self.path).query)
                        tid = q.get("id", [None])[0]
                        if tid is not None:
                            t = tracing.STORE.get(tid)
                            if t is None:
                                self.send_error(404, "no such trace")
                                return
                            body = json.dumps(t.to_dict()).encode()
                        else:
                            try:
                                top = int(q.get("top", ["50"])[0])
                            except ValueError:
                                top = 50
                            body = json.dumps({
                                "traces": tracing.STORE.list(top),
                                "capacity": tracing.STORE.capacity,
                            }).encode()
                        ctype = "application/json"
                    elif self.path == "/plan_feedback" or \
                            self.path.startswith("/plan_feedback?"):
                        from urllib.parse import parse_qs, urlparse

                        from tidb_tpu_torch.planner.feedback import STORE

                        q = parse_qs(urlparse(self.path).query)
                        try:
                            top = int(q.get("top", ["50"])[0])
                        except ValueError:
                            top = 50
                        body = json.dumps(STORE.stats_dict(top)).encode()
                        ctype = "application/json"
                    elif self.path == "/slo" or \
                            self.path.startswith("/slo?"):
                        from urllib.parse import parse_qs, urlparse

                        from tidb_tpu_torch.serving.slo import STORE as slo_store

                        q = parse_qs(urlparse(self.path).query)
                        try:
                            top = int(q.get("top", ["50"])[0])
                        except ValueError:
                            top = 50
                        body = json.dumps(
                            slo_store.stats_dict(top)).encode()
                        ctype = "application/json"
                    elif self.path == "/cluster":
                        from tidb_tpu_torch.parallel.dcn import clusters_alive

                        body = json.dumps({
                            "clusters": [c.health_snapshot()
                                         for c in clusters_alive()],
                        }).encode()
                        ctype = "application/json"
                    elif self.path == "/scheduler":
                        from tidb_tpu_torch.serving import schedulers_alive

                        body = json.dumps({
                            "schedulers": [s.stats_dict()
                                           for s in schedulers_alive()],
                        }).encode()
                        ctype = "application/json"
                    elif self.path == "/schema":
                        # snapshot under the catalog lock: concurrent DDL
                        # mutates these dicts
                        with outer.catalog.lock:
                            snap = {
                                dbn: {tn: t.live_rows
                                      for tn, t in db.tables.items()}
                                for dbn, db in outer.catalog.databases.items()
                            }
                        body = json.dumps(snap).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except BrokenPipeError:
                    pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="status-http")
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
