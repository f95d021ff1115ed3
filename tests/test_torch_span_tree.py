"""A served statement's span tree and its record (tidb_tpu_torch/utils/
tracing.py), through the port's Server and its client on the CPU:

  * the span names and their nesting for a join statement, from the
    scheduler's queue to the response's write;
  * the record's start and end lie within the client's send and done on
    time.monotonic(), the clock every span is taken on;
  * child spans lie within their parents, and the storage.live_rows
    counter counts the planner's calls of Table.live_rows;
  * the record ring's bound and statements()' window;
  * with a torch.profiler active, the live spans are record_function
    ranges in its chrome trace, and without one no range is opened;
  * device.sync counts what a sync() block waited;
  * the join families and the GC family move with their events.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from tidb_tpu_torch.server import Server
from tidb_tpu_torch.server.client import Client
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.catalog import Catalog
from tidb_tpu_torch.utils import metrics as M
from tidb_tpu_torch.utils import tracing

torch.set_num_threads(1)

JOIN = "select t.b, sum(u.v) from t join u on t.a = u.k group by t.b order by t.b"
POINT = "select a from t where a = 7"
TOP = ("sched.queue", "sched.lock_wait", "session.parse", "stmt.select", "server.write")


@pytest.fixture(scope="module")
def served():
    cat = Catalog()
    s = Session(catalog=cat, device="cpu")
    for sql in ("set global tidb_slow_log_threshold = 300000",
                "create table t (a bigint primary key, b bigint)",
                "insert into t values " + ",".join(f"({i},{i % 5})" for i in range(200)),
                "create table u (k bigint, v bigint)",
                "insert into u values " + ",".join(f"({i % 50},{i})" for i in range(300))):
        s.execute(sql)
    srv = Server(catalog=cat, host="127.0.0.1", port=0, status_port=None, device="cpu")
    srv.start()
    c = Client("127.0.0.1", srv.port, db="test", timeout=60.0)
    try:
        yield cat, c
    finally:
        c.close()
        srv.shutdown(drain=True, timeout=30)


def _one(c, sql):
    """(rows, the statement's record, its kept trace, send, done)."""
    c.query("set tidb_trace_sample_rate = 1")
    t_send = time.monotonic()
    rows = c.query(sql)[1]
    t_done = time.monotonic()
    recs = tracing.statements(t_send, t_done)
    assert len(recs) == 1
    tr = tracing.STORE.get(recs[0]["trace_id"])
    assert tr is not None
    return rows, recs[0], tr, t_send, t_done


def _tree(tr):
    """{span name: parent name} of a trace (names are unique here)."""
    by_id = {s.span_id: s for s in tr.spans}
    return {s.name: (by_id[s.parent_id].name if s.parent_id in by_id else None)
            for s in tr.spans}


def test_one_clock():
    """Spans are taken on perf_counter(), the benchmark's clients on
    time.monotonic(): on Linux both read CLOCK_MONOTONIC."""
    pc, mono = time.get_clock_info("perf_counter"), time.get_clock_info("monotonic")
    assert pc.implementation == mono.implementation == "clock_gettime(CLOCK_MONOTONIC)"
    a = time.monotonic()
    b = time.perf_counter()
    c = time.monotonic()
    assert a <= b <= c


def test_a_join_statement_s_span_tree(served):
    _cat, c = served
    rows, rec, tr, _ts, _td = _one(c, JOIN)
    assert len(rows) == 5
    tree = _tree(tr)
    for name in TOP:
        assert tree[name] is None, name
    for name in ("session.plan", "session.execute", "session.finish"):
        assert tree[name] == "stmt.select", name
    ops = [n for n in tree if n.startswith("executor.")]
    assert ops and tree[ops[0]] == "session.execute"
    jits = [n for n in tree if n.startswith("jit.")]
    assert jits and all(tree[n] == "session.execute" for n in jits)
    # the record holds every name once, with the program calls by kind
    assert set(rec["spans"]) == set(tree)
    assert rec["trace_id"] == tr.trace_id
    for n in jits:
        assert sum(v[0] for k, v in rec["counters"].items() if k.startswith(n + ".")) >= 1
    # the port's leaf spans are what the reference's tree lacks
    assert {n for n in tree if n.startswith(tracing.PORT_SPANS)} == \
        {"sched.lock_wait", "session.parse", "session.finish", "server.write", *jits}


def test_the_record_lies_within_the_clients_send_and_done(served):
    _cat, c = served
    for sql in (JOIN, POINT):
        _rows, rec, _tr, t_send, t_done = _one(c, sql)
        # the record ends as server.write's bookkeeping ends, a few
        # microseconds after the last packet left: the client may read
        # it first
        assert t_send <= rec["t_start"] <= rec["t_end"] <= t_done + 1e-3
        parts = sum(rec["spans"][n][1] for n in TOP if n != "stmt.select")
        stmt = rec["spans"]["stmt.select"][1]
        assert parts + stmt <= t_done - t_send + 1e-5


def test_a_statement_that_fails_to_parse_has_its_record_too(served):
    from tidb_tpu_torch.server.client import ServerError

    _cat, c = served
    t_send = time.monotonic()
    with pytest.raises(ServerError):
        c.query("selec 1")
    t_done = time.monotonic()
    recs = tracing.statements(t_send, t_done)
    assert len(recs) == 1
    assert set(recs[0]["spans"]) == {"sched.queue", "sched.lock_wait", "session.parse",
                                     "server.write"}
    assert recs[0]["t_end"] <= t_done + 1e-3


def test_children_lie_within_their_parents(served):
    _cat, c = served
    _rows, _rec, tr, _ts, _td = _one(c, JOIN)
    by_id = {s.span_id: s for s in tr.spans}
    slack = 2  # µs: each end is rounded to a microsecond
    for s in tr.spans:
        p = by_id.get(s.parent_id)
        if p is None:
            continue
        assert p.start_us - slack <= s.start_us, (s.name, p.name)
        assert s.start_us + s.dur_us <= p.start_us + p.dur_us + slack, (s.name, p.name)
    # the top-level spans follow one another
    top = sorted((s for s in tr.spans if s.parent_id is None), key=lambda s: s.start_us)
    assert [s.name for s in top] == list(TOP)
    for a, b in zip(top, top[1:]):
        assert a.start_us + a.dur_us <= b.start_us + slack, (a.name, b.name)


def test_live_rows_counts_the_planner_s_calls(served, monkeypatch):
    import sys

    from tidb_tpu_torch.storage.table import Table

    cat, c = served
    calls = []
    real = Table.live_rows.fget

    def spy(self):
        calls.append(sys._getframe(1).f_code.co_filename)
        return real(self)

    monkeypatch.setattr(Table, "live_rows", property(spy))
    # no statistics on t and u: the planner counts their rows
    _rows, rec, _tr, _ts, _td = _one(c, JOIN)
    assert calls and all("/planner/" in f for f in calls)
    assert rec["counters"][tracing.LIVE_ROWS][0] == len(calls)
    assert rec["counters"][tracing.LIVE_ROWS][1] <= rec["spans"]["stmt.select"][1]


def test_the_timed_tree_is_freed_with_the_statement(monkeypatch):
    """The operator timing holds its executors weakly: a traced
    statement's tree (and the device memory it holds) goes when the
    statement drops it, with no wait for the cycle collector."""
    import gc
    import weakref

    import tidb_tpu_torch.session.session as S

    s = Session(device="cpu")
    s.execute("create table w (a bigint, b bigint)")
    s.execute("insert into w values (1, 2), (3, 4)")
    roots = []
    real = S.run_plan

    def run_plan(root, ctx, n_visible=None):
        roots.append(weakref.ref(root))
        return real(root, ctx, n_visible)

    monkeypatch.setattr(S, "run_plan", run_plan)
    gc.disable()
    try:
        assert s.query("select a, sum(b) from w group by a order by a") == [(1, 2), (3, 4)]
        assert roots and all(r() is None for r in roots)
    finally:
        gc.enable()


def test_the_ring_s_bound_and_window():
    ring = tracing.StatementRecords()
    assert ring.CAPACITY == 4096
    for i in range(ring.CAPACITY + 10):
        ring.add({"t_start": float(i)})
    assert len(ring) == ring.CAPACITY
    assert ring.window(0.0, 9.0) == []  # the oldest went first
    got = ring.window(100.0, 102.5)
    assert [r["t_start"] for r in got] == [100.0, 101.0, 102.0]


def test_device_sync_counts_what_a_sync_block_waited():
    tr = tracing.Trace("t-1")
    tracing.push(tr)
    try:
        with tracing.sync():
            time.sleep(0.002)
        with tracing.sync(on_card=False):
            time.sleep(0.002)
    finally:
        tracing.pop()
    n, s = tr.counters[tracing.DEVICE_SYNC]
    assert n == 1 and 0.002 <= s < 1.0


def _profiled_trace(c, sql, path):
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    # the program's spans run on the server's threads: a profiler sees
    # another thread's ranges only when it profiles all threads
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        c.query(sql)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "user_annotation"}


def test_live_spans_are_profiler_ranges(served, tmp_path, monkeypatch):
    _cat, c = served
    names = _profiled_trace(c, JOIN, tmp_path / "on.json")
    for n in ("sched.lock_wait", "session.parse", "session.plan", "session.execute",
              "server.write"):
        assert n in names, n
    assert any(n.startswith("jit.") for n in names)
    assert any(n.startswith("executor.") for n in names)
    # with no profiler the spans open no range
    opened = []
    real = torch.autograd.profiler.record_function

    def spy(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", spy)
    assert not tracing.profiling()
    c.query(JOIN)
    assert opened == []


def test_join_and_gc_families_move(served):
    cat, c = served

    def n(h):
        return sum(sum(counts) for _l, counts, _s, _e in h.samples())

    b0, p0 = n(M.JOIN_BUILD_SECONDS), n(M.JOIN_PROBE_SECONDS)
    k0 = sum(v for _l, v in M.JOIN_COMPILE_TOTAL.samples())
    c.query("select count(*) from t join u on t.a = u.k where u.v > 1")
    k1 = sum(v for _l, v in M.JOIN_COMPILE_TOTAL.samples())
    c.query("select count(*) from t join u on t.a = u.k where u.v > 1")
    assert n(M.JOIN_BUILD_SECONDS) >= b0 + 1  # the second reads the parked build
    assert n(M.JOIN_PROBE_SECONDS) >= p0 + 2
    assert k1 >= k0 + 1  # a new plan shape builds its program once ...
    assert sum(v for _l, v in M.JOIN_COMPILE_TOTAL.samples()) == k1  # ... and only once
    ex = M.JOIN_PROBE_SECONDS.exemplar(kind="inner")
    assert ex is not None and ex[1]
    g0 = sum(v for _l, v in M.GC_RECLAIMED.samples())
    s = Session(catalog=cat, device="cpu")
    s.execute("create table g (a bigint)")
    s.execute("insert into g values " + ",".join(f"({i})" for i in range(100)))
    s.execute("delete from g where a < 40")
    reclaimed = cat.gc()
    assert sum(reclaimed.values()) >= 40
    assert sum(v for _l, v in M.GC_RECLAIMED.samples()) == g0 + sum(reclaimed.values())
