"""The port's observability (tidb_tpu_torch/utils/tracing.py,
utils/stmtsummary.py, utils/metrics.py, the slow log and the SLO store)
held to the reference's on the same statements:

  * TRACE's span tree equals the reference's by span names and nesting
    (not times);
  * a statement's trace is kept for the same reasons (head sampling,
    slow, error, deadline) and reaches the slow log with the same
    disposition;
  * the statements summary's digests, texts, counts and errors are equal;
  * the family names in /metrics are equal, except the families whose
    module the port does not have (`_UNPORTED_FAMILIES`, each with its
    module).

The reference Session runs with tidb_device_engine_mode = 'force', so on
the CPU it renders the device operators the port runs."""

import numpy as np
import pytest
import torch

from tidb_tpu.errors import QueryTimeoutError as JaxTimeout
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.utils import metrics as jmetrics
from tidb_tpu.utils import tracing as jtracing
from tidb_tpu_torch.errors import QueryTimeoutError
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.utils import metrics as pmetrics
from tidb_tpu_torch.utils import tracing as ptracing
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

torch.set_num_threads(1)

# the mesh tier's families (parallel/), registered by the port
_MESH_FAMILIES = ("tidb_tpu_fragment_dispatch_total", "tidb_tpu_fragment_seconds",
                  "tidb_tpu_fragment_compile_total", "tidb_tpu_collective_merge_seconds")

# reference metric families whose module the port does not have (none
# since the DCN tier, sharding and membership are ported)
_UNPORTED_FAMILIES: dict = {}

_SETUP = ("set tidb_slow_log_threshold = 300000",
          "set tidb_trace_sample_rate = 0",
          "create table tt (a bigint primary key, b varchar(8), c decimal(10,2))",
          "insert into tt values " + ",".join(
              f"({i},'g{i % 3}',{i}.25)" for i in range(64)),
          "create table uu (k bigint, v bigint)",
          "insert into uu values " + ",".join(
              f"({i % 16},{i})" for i in range(48)))


def _pair():
    js = JaxSession()
    js.execute("set tidb_tpu_compaction = 0")
    js.execute("set tidb_device_engine_mode = 'force'")
    ps = Session(device="cpu")
    for sql in _SETUP:
        js.execute(sql)
        ps.execute(sql)
    return js, ps


def _shape(rows):
    """TRACE rows without times: (indent depth, span name)."""
    return [(len(r[0]) - len(r[0].lstrip(" ")), r[0].strip()) for r in rows]


@pytest.mark.parametrize("sql", [
    "select count(*) from tt",
    "select b, count(*), sum(c) from tt group by b order by b",
    "select a, b from tt where a < 5 order by a",
    "select tt.b, sum(uu.v) from tt join uu on tt.a = uu.k group by tt.b "
    "order by tt.b",
    "select a from tt where a = 7",
], ids=["count", "group", "filter_sort", "join", "point"])
def test_trace_span_tree_matches_reference(sql):
    js, ps = _pair()
    want = js.execute("TRACE " + sql)
    got = ps.execute("TRACE " + sql)
    assert got.names == want.names == ["span", "start_ms", "duration_ms"]
    assert _shape(got.rows) == _shape(want.rows)
    assert any(n.startswith("executor.") for _d, n in _shape(got.rows))
    # TRACE always keeps its trace, regardless of sampling
    assert "trace" in ptracing.STORE.traces()[-1].keep_reasons


def _kept(store, before):
    return [t for t in store.traces() if t.trace_id not in before]


def _statement_traces(s, store, timeout_cls):
    """(keep reasons, root span, slow-log dispositions) of a fixed
    statement sequence: head-sampled, uneventful, slow, error, deadline."""
    out = []
    before = {t.trace_id for t in store.traces()}
    s.execute("set tidb_trace_sample_rate = 1")
    s.query("select 1")
    s.execute("set tidb_trace_sample_rate = 0")
    s.query("select 2")  # uneventful: discarded
    s.execute("set tidb_slow_log_threshold = 0")
    s.query("select 41 + 1")
    with pytest.raises(Exception):
        s.query("select * from missing_tbl_for_tracing")
    s.catalog.table("test", "uu").insert_columns(
        {"k": np.arange(150_000, dtype=np.int64) % 1000,
         "v": np.arange(150_000, dtype=np.int64)})
    s.execute("set max_execution_time = 1")  # 1 ms: must expire
    with pytest.raises(timeout_cls):
        s.query("select count(*) from uu u1 join uu u2 on u1.k = u2.k "
                "where u1.v > 10")
    s.execute("set max_execution_time = 0")
    s.execute("set tidb_slow_log_threshold = 300000")
    for tr in _kept(store, before):
        out.append((tuple(tr.keep_reasons), tr.spans[0].name))
    slow = [(r[3], r[11]) for r in s.catalog.slow_queries]
    return out, slow, store.get(s.catalog.slow_queries[-1][10]) is not None


def test_statement_traces_kept_for_the_same_reasons():
    js, ps = _pair()
    want = _statement_traces(js, jtracing.STORE, JaxTimeout)
    got = _statement_traces(ps, ptracing.STORE, QueryTimeoutError)
    assert got == want
    assert ptracing.current() is None  # nothing leaked onto the thread


def test_statements_summary_digests_and_counts_match():
    js, ps = _pair()
    stmts = ["select a from tt where a = 1", "select a from tt where a = 2",
             "select b, count(*) from tt group by b",
             "select * from missing_t", "update tt set c = c + 1 where a = 3",
             "select count(*) from tt join uu on tt.a = uu.k"]
    views = []
    for s in (js, ps):
        setup = {e["digest"] for e in s.catalog.stmt_summary.top(100)}
        for sql in stmts:
            try:
                s.execute(sql)
            except Exception:  # noqa: BLE001 — the error is counted
                pass
        sid, _ = s.prepare("select b from tt where a = ?")
        for k in range(3):
            s.execute_prepared(sid, [k])
        views.append(sorted(
            (e["digest"], e["digest_text"], e["stmt_type"], e["exec_count"],
             e["errors"], e["rows_sent"], e["plan_cache_hits"])
            for e in s.catalog.stmt_summary.top(100)
            if e["digest"] not in setup))
    assert views[1] == views[0]
    assert any(v[4] for v in views[1])  # the error was counted


def test_metrics_families_match_reference():
    def families(mod):
        return {m.name: m.kind for m in mod.REGISTRY.metrics}

    want, got = families(jmetrics), families(pmetrics)
    missing = set(want) - set(got)
    assert missing == set(_UNPORTED_FAMILIES)
    assert set(got) <= set(want)  # no family the reference lacks
    assert {n: k for n, k in got.items()} == {
        n: k for n, k in want.items() if n not in _UNPORTED_FAMILIES}
    assert all(got.get(f) == want[f] for f in _MESH_FAMILIES)
    # the port's engine counters render under the reference's names
    js, ps = _pair()
    ps.execute("set tidb_enable_non_prepared_plan_cache = 1")
    ps.query("select count(*) from tt")
    ps.query("select count(*) from tt")
    text = pmetrics.render_prometheus()
    for fam in ("tidb_tpu_plan_cache_total", "tidb_tpu_query_total",
                "tidb_tpu_device_cache_total", "tidb_tpu_parse_seconds"):
        assert f"\n{fam}" in text or f"\n{fam}_" in text, fam


def test_slo_store_fed_like_the_reference():
    js, ps = _pair()
    rows = []
    for s, store in ((js, __import__("tidb_tpu.serving.slo",
                                     fromlist=["STORE"]).STORE),
                     (ps, __import__("tidb_tpu_torch.serving.slo",
                                     fromlist=["STORE"]).STORE)):
        store.clear()
        for _ in range(3):
            s.query("select a from tt where a = 5")
        with pytest.raises(Exception):
            s.query("select * from nowhere_slo")
        rows.append(sorted((r[0], r[1], r[2]) for r in store.rows()))
    assert rows[1] == rows[0] and rows[1]


def test_profile_dir_writes_a_torch_profiler_trace(tmp_path):
    """tidb_profile_dir: the reference's jax.profiler hook becomes a
    torch.profiler trace of each statement (a chrome trace file)."""
    import json

    ps = Session(device="cpu")
    ps.execute("create table pt (a bigint)")
    ps.execute("insert into pt values (1), (2)")
    ps.execute(f"set tidb_profile_dir = '{tmp_path}'")
    assert ps.query("select sum(a) from pt") == [(3,)]
    ps.execute("set tidb_profile_dir = ''")
    traces = sorted(tmp_path.glob("stmt-*.json"))
    assert len(traces) == 2  # the SELECT, and the SET that ends it
    assert "traceEvents" in json.loads(traces[0].read_text())
