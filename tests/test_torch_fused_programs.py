"""One device program per fused batch (tidb_tpu_torch/utils/jitcache.py
behind the four fused sites of executor/pipeline.py) on the CPU, held to
the JAX package.

The reference compiles each fused batch through ``cached_jit`` at four
sites (segment and generic aggregation, scan->probe, top-k) and records
one dispatch a batch at ``jit:<ns>``. The port goes through the same
sites with the same keys (reprs of the IR); on the card each signature
becomes a captured CUDA graph. Here:

  * keys: the same SQL gives the same key and a different string literal
    a different one, at each of the four sites;
  * TPC-H Q1, Q6, Q3, Q5, Q18 and a fused top-N at SF0.01 (chunk capacity
    4,096, 1,024-row segments) give the reference's rows and its
    per-site dispatch counts (``jit:fusedagg``, ``jit:fusedprobe``,
    ``jit:fusedtopk``) on the same data;
  * the graph path's own logic (signatures, static input slots, the copy
    in, the packed outputs cloned out, donated state, the host effects
    replayed, no fallback) runs on CPU tensors under a stand-in for
    ``torch.cuda.CUDAGraph`` whose replay runs the captured body again:
    rows, route counts and dispatches equal the eager path's, and outputs
    a caller keeps are never overwritten by a later replay.

Rows compare as tests/test_torch_pipeline.py compares them (exact for
integers and decimals, 1e-12 relative for averages). The card's own
tests (graph replay against the eager switch, threads) are in
tests/test_torch_cuda.py."""

import contextlib
import threading

import numpy as np
import pytest
import torch

from tidb_tpu.utils import dispatch as jdispatch
from tidb_tpu_torch.executor import pipeline as pl
from tidb_tpu_torch.ops import join_kernels as jk
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.tpch_queries import Q
from tidb_tpu_torch.utils import dispatch, jitcache

from test_torch_pipeline import CAP, SEG_ROWS, assert_rows, tpch_seg_pair
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

torch.set_num_threads(1)

SITES = ("jit:fusedagg", "jit:fusedprobe", "jit:fusedtopk")
TOPN = ("select l_orderkey, l_linenumber, l_extendedprice from lineitem "
        "where l_shipdate >= date '1995-01-01' order by l_extendedprice desc limit 10")
QUERIES = {"q1": Q["q1"][0], "q6": Q["q6"][0], "q3": Q["q3"][0], "q5": Q["q5"][0],
           "q18": Q["q18"][0].replace("> 300", "> 200"), "topn": TOPN}
ORDERED = {"q1", "q3", "q5", "q18", "topn"}


@pytest.fixture(autouse=True)
def fresh_cache():
    jitcache.clear()
    jitcache.reset_runs()
    old = jitcache.set_graphs(True)
    yield
    jitcache.set_graphs(old)
    jitcache.clear()


@pytest.fixture(scope="module")
def tpch():
    js, ps = tpch_seg_pair()
    # the reference's CPU run takes its host engine in 'auto'; 'force' runs
    # the device generic aggregation, fused over a plain scan, as the port
    js.execute("set tidb_device_engine_mode = 'force'")
    for s in (js, ps):
        s.execute("set tidb_tpu_compaction = 0")
        for sql in QUERIES.values():  # settle stores, re-sorts and plans alike
            s.query(sql)
    return js, ps


def _sites(by_site: dict, before: dict) -> dict:
    return {k: by_site.get(k, 0) - before.get(k, 0) for k in SITES}


# -- keys ---------------------------------------------------------------------


def _literal_session():
    s = Session(device="cpu", chunk_capacity=1024)
    s.execute("set tidb_tpu_segment_rows = 1024")
    s.execute("create table t (a bigint, b varchar(8), c bigint)")
    rng = np.random.default_rng(3)
    n = 5000
    s.catalog.table("test", "t").insert_columns(
        {"a": np.arange(n, dtype=np.int64),
         "c": rng.integers(0, 100, n).astype(np.int64)},
        strings={"b": [f"s{i % 7}" for i in range(n)]})
    s.execute("create table d (k bigint primary key, w bigint)")
    s.execute("insert into d values " + ",".join(f"({i},{i * 2})" for i in range(100)))
    return s


SITE_SQL = {
    "fusedagg.seg": ("fusedagg", "select b, count(*), sum(c) from t where b <> '{}' "
                                 "group by b order by b"),
    "fusedagg.gen": ("fusedagg", "select c, count(*) from t where b <> '{}' "
                                 "group by c order by c"),
    "fusedprobe": ("fusedprobe", "select sum(t.c + d.w) from t join d on t.c = d.k "
                                 "where t.b <> '{}'"),
    "fusedtopk": ("fusedtopk", "select a, b, c from t where b <> '{}' "
                               "order by c desc, a limit 5"),
}


def _keys(ns):
    return {k for (n, k) in jitcache._CACHE if n == ns}


@pytest.mark.parametrize("site", sorted(SITE_SQL))
def test_same_sql_same_key_and_each_literal_its_own(site):
    ns, sql = SITE_SQL[site]
    s = _literal_session()
    first = s.query(sql.format("s3"))
    keys = _keys(ns)
    assert len(keys) == 1 and (site != "fusedagg.seg" or next(iter(keys)).startswith("seg|"))
    assert s.query(sql.format("s3")) == first
    assert _keys(ns) == keys  # the same text: the same key
    other = s.query(sql.format("s4"))
    assert other != first
    assert len(_keys(ns)) == 2  # the literal's code is baked into its own key


# -- the reference's per-site dispatches and rows -----------------------------


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_dispatches_and_rows_equal_the_reference(tpch, q):
    js, ps = tpch
    j0 = jdispatch.by_site()
    want = js.query(QUERIES[q])
    jsites = _sites(jdispatch.by_site(), j0)
    p0 = dispatch.by_site()
    got = ps.query(QUERIES[q])
    psites = _sites(dispatch.by_site(), p0)
    assert want
    assert_rows(got, want, ordered=q in ORDERED)
    assert sum(psites.values()) > 0, psites
    assert psites == jsites, (psites, jsites)


# -- the graph path on CPU tensors ----------------------------------------------


class _Stream:
    def wait_stream(self, other):
        pass

    def wait_event(self, event):
        pass


class _Event:
    def record(self, stream=None):
        pass


class _Graph:
    """Stands in for torch.cuda.CUDAGraph: a replay runs the captured body
    again, its host effects swallowed (the real record replays them)."""

    def __init__(self):
        self.body = None
        self.replays = 0

    def pool(self):
        return (0, 0)

    def replay(self):
        self.replays += 1
        with dispatch.Capture():
            self.body()


@pytest.fixture
def cpu_graphs(monkeypatch):
    stream = _Stream()
    monkeypatch.setattr(jitcache, "_on_card", lambda dev: True)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None, priority=0: stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(jitcache, "_pool_bytes", lambda dev, before: 4096)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 0))

    def capture_body(graph, body, pool=None):
        graph.body = body
        body()

    monkeypatch.setattr(jitcache._Graph, "_capture_body", staticmethod(capture_body))
    jitcache.clear()
    yield
    jitcache.clear()


def test_program_replays_copy_in_and_clone_out(cpu_graphs):
    """A donated packed state flows through the graph (in place inside it,
    a fresh clone out); a staged batch's views of one buffer are one
    packed argument, one slot; an earlier call's outputs survive later
    replays."""
    def update(state, staged):
        data, sel = staged
        state["s"].add_(torch.where(sel, data["x"], 0).sum().reshape(1))
        state["n"].add_(sel.sum().reshape(1))
        return state

    prog = jitcache.cached_jit("t", "upd", lambda: update, donate_argnums=(0,))

    def staged(i):
        buf = torch.zeros(512, dtype=torch.uint8)
        x = buf[0:64].view(torch.int64)
        sel = buf[256:264].view(torch.bool)
        x.copy_(torch.arange(8) * (i + 1))
        sel.copy_(torch.arange(8) % 2 == 0)
        return jitcache.packed_view(buf, ({"x": x}, sel))

    state = jitcache.packed({"s": torch.zeros(1, dtype=torch.int64),
                             "n": torch.zeros(1, dtype=torch.int64)})
    for i in range(5):
        state = prog(state, staged(i))
        kept = state
    assert jitcache.runs()["t"] == {"eager": 1, "capture": 1, "replay": 3}
    want = sum((0 + 2 + 4 + 6) * (i + 1) for i in range(5))
    assert int(state["s"]) == want and int(state["n"]) == 20
    assert isinstance(kept, jitcache.PackedMap)
    g = prog.graphs()[0]
    assert len(g.slots) == 2  # the state and the batch: one slot each
    # outputs held by the caller are fresh tensors, not the graph's buffers
    assert kept.packed_buf.data_ptr() not in {t.data_ptr() for t in g.slots}
    before = {k: v.clone() for k, v in kept.items()}
    prog(kept, staged(9))
    assert all(torch.equal(kept[k], before[k]) for k in kept)


def test_packed_trees_rebuild_and_update_in_place():
    tree = (torch.arange(5), ((torch.ones(3, dtype=torch.int32), torch.zeros(2)),),
            torch.tensor(7))
    st = jitcache.packed(tree)
    assert isinstance(st, jitcache.PackedTuple) and st.packed_buf.dim() == 1
    base = st.packed_buf.data_ptr()
    assert all((v.data_ptr() - base) % 256 == 0 for v in st.packed_layout.views(st.packed_buf))
    again = st.packed_layout.rebuild(st.packed_buf.clone())
    assert torch.equal(again[0], tree[0]) and torch.equal(again[1][0][0], tree[1][0][0])
    assert again.packed_layout == st.packed_layout
    new = (tree[0] * 2, ((tree[1][0][0] + 1, tree[1][0][1] - 1),), tree[2] + 1)
    assert jitcache.update_packed(st, new) is st
    assert torch.equal(st[0], tree[0] * 2) and int(st[2]) == 8
    with pytest.raises(ValueError):
        jitcache.update_packed(st, (tree[0],))


def test_pushed_outputs_survive_later_replays(cpu_graphs):
    """The generic stack and the probe window keep outputs across replays:
    each call's result is its own clone."""
    prog = jitcache.cached_jit("t", "sq", lambda: lambda x: {"y": x * x, "n": x.sum()})
    kept = [prog(torch.full((16,), float(i))) for i in range(10)]
    assert [float(k["y"][0]) for k in kept] == [float(i * i) for i in range(10)]
    assert [float(k["n"]) for k in kept] == [16.0 * i for i in range(10)]
    assert jitcache.runs()["t"]["replay"] == 8


def test_a_failed_capture_raises_and_never_falls_back(cpu_graphs):
    """A failed capture raises (the call gives no eager result) and puts
    its signature back to unseen: the next call warms up again."""
    calls, fail = [], [True]

    def fn(x):
        calls.append(dispatch.capturing())
        if dispatch.capturing() and fail[0]:
            raise RuntimeError("operation not permitted when stream is capturing")
        return x + 1

    prog = jitcache.cached_jit("t", "bad", lambda: fn)
    x = torch.ones(4)
    for _ in range(2):
        assert torch.equal(prog(x), x + 1)  # the warm-up, eager
        with pytest.raises(RuntimeError, match="capturing"):
            prog(x)
        assert not prog.graphs()
    assert calls == [False, True, False, True]  # no eager run in a failing call
    fail[0] = False
    for _ in range(3):
        assert torch.equal(prog(x), x + 1)
    assert len(prog.graphs()) == 1
    assert jitcache.runs()["t"] == {"eager": 3, "capture": 1, "replay": 1}


def test_first_calls_on_two_threads_both_warm_up(cpu_graphs):
    """Two threads in a signature's first call at once: both run eagerly
    (the second is no capture of a half-done warm-up); the next call
    captures."""
    both_inside = threading.Barrier(2, timeout=20)
    calls = []

    def fn(x):
        calls.append(dispatch.capturing())
        if len(calls) <= 2:
            both_inside.wait()  # holds each first call until both are inside
        return x * 2

    prog = jitcache.cached_jit("t", "race", lambda: fn)
    x = torch.arange(4.0)
    out, errs = [], []

    def first():
        try:
            out.append(prog(x))
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    ts = [threading.Thread(target=first) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert not errs and len(out) == 2 and all(torch.equal(o, x * 2) for o in out)
    assert calls == [False, False]
    assert jitcache.runs()["t"] == {"eager": 2}
    assert torch.equal(prog(x), x * 2) and torch.equal(prog(x), x * 2)
    assert jitcache.runs()["t"] == {"eager": 2, "capture": 1, "replay": 1}


def test_a_lookup_table_evicted_after_the_warm_up_is_not_uploaded_in_the_capture(
        cpu_graphs):
    """The warm-up's lookup table is held for the capture: evicted from
    the compiler's cache in between, the capture reads the warm-up's
    tensor (an upload inside a capture raises) and the graph keeps it."""
    from tidb_tpu_torch.expression import compiler

    values = tuple(range(100, 140))

    def fn(idx):
        return compiler._device_table(values, np.int64, idx.device)[idx]

    prog = jitcache.cached_jit("t", "lookup", lambda: fn)
    idx = torch.tensor([0, 5, 39])
    want = torch.tensor([100, 105, 139])
    assert torch.equal(prog(idx), want)  # the warm-up uploads the table
    warm_table = compiler._device_table(values, np.int64, idx.device)
    with compiler._TABLES_LOCK:
        compiler._TABLES.clear()
    assert torch.equal(prog(idx), want)  # the capture
    g = prog.graphs()[0]
    assert any(r[1] is warm_table for r in g.capture_rec.retained if isinstance(r, tuple))
    assert g.capture_rec.held == {}
    assert torch.equal(prog(torch.tensor([1, 2, 3])), torch.tensor([101, 102, 103]))
    assert jitcache.runs()["t"] == {"eager": 1, "capture": 1, "replay": 1}
    # with no warm-up to take it from, the capture refuses the upload
    with compiler._TABLES_LOCK:
        compiler._TABLES.clear()
    with dispatch.Capture(), pytest.raises(Exception, match="before a CUDA graph capture"):
        fn(idx)


def test_the_switch_and_cpu_tensors_run_eagerly():
    prog = jitcache.cached_jit("t", "e", lambda: lambda x: x + 1)
    for _ in range(3):
        prog(torch.zeros(2))  # CPU tensors: eager, counted
    with jitcache.eager():
        assert not jitcache.graphs_enabled()
    assert jitcache.graphs_enabled()
    assert jitcache.runs()["t"] == {"eager": 3}
    assert not prog.graphs()


def test_signature_separates_shapes_and_baked_values(cpu_graphs):
    prog = jitcache.cached_jit("t", "sig", lambda: lambda x, k: x * k)
    for _ in range(3):
        for n in (4, 8):
            for k in (2, 3):
                assert torch.equal(prog(torch.ones(n), k), torch.full((n,), float(k)))
    assert len(prog.graphs()) == 4
    assert jitcache.runs()["t"] == {"eager": 4, "capture": 4, "replay": 4}


def test_signatures_of_a_program_share_its_read_only_slots(cpu_graphs):
    """A read-only argument (a probe's build side) is held once per
    program: the graphs of two batch shapes read one slot, whose bytes
    count once; a new build tensor of the same shapes is copied into it."""
    def probe(batch, build):
        return batch + build[:batch.shape[0]]

    prog = jitcache.cached_jit("t", "shared", lambda: probe)
    jitcache.reset_runs()
    build = torch.arange(1 << 12)
    for _ in range(3):
        for n in (8, 16):
            assert torch.equal(prog(torch.ones(n, dtype=torch.int64), build), build[:n] + 1)
    gs = prog.graphs()
    assert len(gs) == 2
    assert gs[0].slots[1].data_ptr() == gs[1].slots[1].data_ptr()
    assert gs[0].slots[0].data_ptr() != gs[1].slots[0].data_ptr()
    assert sum(g.nbytes for g in gs) < 2 * build.nbytes
    other = build * 3
    assert torch.equal(prog(torch.ones(8, dtype=torch.int64), other), other[:8] + 1)
    assert torch.equal(prog(torch.ones(16, dtype=torch.int64), build), build[:16] + 1)
    assert jitcache.runs()["t"] == {"eager": 2, "capture": 2, "replay": 4}


def test_bytes_bound_evicts_the_least_recent(cpu_graphs, monkeypatch):
    monkeypatch.setattr(jitcache, "_BOUND", [jitcache.MAX_BYTES])
    progs = []
    for i in range(4):
        p = jitcache.cached_jit("t", str(i), lambda: lambda x: x + 1,
                                max_bytes=3 * 4096 + 1000)
        for _ in range(2):
            p(torch.zeros(8))  # the second call captures one graph
        progs.append(p)
    assert jitcache.max_bytes() == 3 * 4096 + 1000
    assert jitcache.size() == 3 and ("t", "0") not in jitcache._CACHE
    assert jitcache.resident_bytes() <= jitcache.max_bytes()
    assert all(n > 4096 for ns in jitcache.graph_bytes().values() for n in ns)


def test_the_quota_comes_from_the_global_sysvar(monkeypatch):
    """Each fused site passes its statement's tidb_tpu_graph_cache_bytes
    as the graphs' byte bound."""
    monkeypatch.setattr(jitcache, "_BOUND", [jitcache.MAX_BYTES])
    s = _literal_session()
    assert s.query("select @@global.tidb_tpu_graph_cache_bytes") == [(4 << 30,)]
    s.execute(f"set global tidb_tpu_graph_cache_bytes = {64 << 20}")
    try:
        for _ns, sql in SITE_SQL.values():
            jitcache._BOUND[0] = 0
            s.query(sql.format("s3"))
            assert jitcache.max_bytes() == 64 << 20, sql
    finally:
        s.execute(f"set global tidb_tpu_graph_cache_bytes = {4 << 30}")


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_graph_path_equals_the_eager_path(tpch, cpu_graphs, q):
    """Three runs through the graph path: the rows, the join's route
    counts and the per-site dispatches equal the eager path's; by the
    third run every fused batch replays and nothing is captured. Plan
    feedback is off for the session meanwhile: it picks Q18's push-down by
    measured times, and the runs must share the eager run's plan."""
    _js, ps = tpch
    ps.execute("set tidb_tpu_plan_feedback = 0")
    try:
        _graph_runs_equal_eager(ps, q)
    finally:
        ps.execute("set tidb_tpu_plan_feedback = 1")


def _graph_runs_equal_eager(ps, q):
    sql = QUERIES[q]
    with jitcache.eager():
        jk.reset_routes()
        d0 = dispatch.by_site()
        want = ps.query(sql)
        eager_sites = _sites(dispatch.by_site(), d0)
        eager_routes = dict(jk.PROBE_ROUTES)
    for run in range(3):
        jk.reset_routes()
        jitcache.reset_runs()
        d0 = dispatch.by_site()
        got = ps.query(sql)
        assert_rows(got, want, ordered=q in ORDERED)
        assert _sites(dispatch.by_site(), d0) == eager_sites
        assert dict(jk.PROBE_ROUTES) == eager_routes
    runs = jitcache.runs()
    assert sum(r.get("capture", 0) + r.get("eager", 0) for r in runs.values()) == 0
    assert {f"jit:{ns}": r["replay"] for ns, r in runs.items()} == {
        k: v for k, v in eager_sites.items() if v}


def test_statements_on_threads_share_graphs(tpch, cpu_graphs):
    """Two sessions on threads run Q3 and Q1 through the same graphs at
    once: each gets the eager rows."""
    _js, ps = tpch
    cat = ps.catalog.base
    with jitcache.eager():
        want = {q: ps.query(QUERIES[q]) for q in ("q1", "q3")}
    out, errs = [], []

    def run(q):
        s = Session(cat, chunk_capacity=CAP, device="cpu")
        s.execute(f"set tidb_tpu_segment_rows = {SEG_ROWS}")
        try:
            for _ in range(3):
                out.append((q, s.query(QUERIES[q])))
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(q,)) for q in ("q1", "q3", "q1", "q3")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not errs and len(out) == 12
    for q, rows in out:
        assert_rows(rows, want[q], ordered=True)
