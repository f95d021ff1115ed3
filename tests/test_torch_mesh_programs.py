"""One device program per mesh fragment (tidb_tpu_torch/parallel/ behind
utils/jitcache.cached_jit) on the CPU, held to the JAX package.

The reference compiles each mesh fragment into one program,
``jax.jit(shard_map(...))``, at four sites: the scan aggregation
(``distagg``), the repartition join aggregation (``distjoinagg``), the
general fragment (``fragment``) and the streaming state merge
(``aggcombine``). The port runs each through ``cached_jit``; on the card
each input signature becomes one captured CUDA graph that reads a
resident sharding where it lies. Here the graph path runs on CPU meshes
of 4 and 8 shards under tests/test_torch_fused_programs.py's stand-in
for ``torch.cuda.CUDAGraph`` (a replay runs the captured body again):

  * TPC-H Q1, Q3, Q5 and Q18 at SF0.01 through ``Session(mesh=...)``
    give the same rows eagerly, at the capture and by replay, equal to
    the reference's ``Session(mesh=...)`` on its 8-device CPU mesh;
  * ``jitcache.runs()`` shows eager -> capture -> replay at each of the
    four namespaces, a statement's graphs in one memory pool;
  * an exchange overflow grows a capacity into a new key with the same
    rows, and a probe table that leaves a run unplaced re-runs its join
    on the sorted route with the same rows;
  * a resident sharding has no static slot, its programs go with it
    (an UPDATE, an evict) and nothing of the cache keeps it alive;
  * broadcast inputs are uploaded before the program, never inside the
    capture;
  * a mesh over two devices (simulated) runs its fragments eagerly,
    counted as ``eager_multi_device``.
"""

import gc
import weakref

import pytest
import torch

from tidb_tpu.parallel import make_mesh as jax_make_mesh
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.tpch import load_tpch as jax_load_tpch
from tidb_tpu_torch.parallel import executor as pex
from tidb_tpu_torch.parallel import fragment as frag_mod
from tidb_tpu_torch.parallel import make_mesh, partition
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.tpch_queries import Q
from tidb_tpu_torch.utils import dispatch, jitcache

from test_torch_fused_programs import cpu_graphs  # noqa: F401 (the stand-in graphs)
from test_torch_parallel import QJOIN, TABLES, same_rows
from test_torch_session import _export_into
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

torch.set_num_threads(1)

CPU = torch.device("cpu")
QUERIES = ("q1", "q3", "q5", "q18")
MESH_NS = ("distagg", "distjoinagg", "fragment", "aggcombine")
STREAMED_Q1 = Q["q1"][0]


def _sql(q):
    # Q18's HAVING at 300 keeps no order at SF0.01: 200 keeps a few
    return Q[q][0].replace("> 300", "> 200") if q == "q18" else Q[q][0]


def _mesh(n):
    return make_mesh(n_shards=n // 2, n_dcn=2, devices=[CPU] * n)


@pytest.fixture(scope="module")
def tpch(devices8):
    """The reference's 8-device mesh session at SF0.01, its rows of the
    four queries, and port mesh sessions of 4 and 8 shards over the same
    tables."""
    js = JaxSession(chunk_capacity=4096,
                    mesh=jax_make_mesh(n_shards=4, n_dcn=2, devices=devices8))
    jax_load_tpch(js.catalog, sf=0.01)
    want = {q: js.query(_sql(q)) for q in QUERIES}
    sessions = {}
    for n in (4, 8):
        ps = Session(chunk_capacity=4096, mesh=_mesh(n))
        for name in TABLES:
            _export_into(ps, js.catalog.table("test", name), name)
        sessions[n] = ps
    return want, sessions


@pytest.fixture
def graphs_on():
    jitcache.clear()
    jitcache.reset_runs()
    old = jitcache.set_graphs(True)
    yield
    jitcache.set_graphs(old)
    jitcache.clear()


def _mesh_runs():
    return {ns: r for ns, r in jitcache.runs().items() if ns in MESH_NS}


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("q", QUERIES)
def test_rows_equal_eagerly_at_capture_and_by_replay(tpch, graphs_on, cpu_graphs,
                                                     q, shards):
    want, sessions = tpch
    s = sessions[shards]
    sql = _sql(q)
    with jitcache.eager():
        eager = s.query(sql)
    assert set().union(*[set(r) for r in _mesh_runs().values()]) <= {"eager"}
    same_rows(eager, want[q], ordered=True)
    hows = []
    for _ in range(3):
        jitcache.reset_runs()
        assert s.query(sql) == eager
        hows.append({how for r in _mesh_runs().values() for how in r})
    assert _mesh_runs(), q
    # the warm-ups, then the captures, then every fragment by replay
    assert "capture" in hows[1] and hows[2] == {"replay"}, hows


def test_each_namespace_warms_up_captures_then_replays(tpch, graphs_on, cpu_graphs,
                                                        monkeypatch):
    _want, sessions = tpch
    s = sessions[8]
    monkeypatch.setattr(pex.DistAggExec, "STREAM_ROWS_PER_PART", 1024)
    cases = {"distagg": Q["q1"][0], "distjoinagg": QJOIN, "fragment": Q["q3"][0]}
    for ns, sql in cases.items():
        seen = []
        for _ in range(3):
            jitcache.reset_runs()
            s.query(sql)
            seen.append(jitcache.runs().get(ns, {}))
        assert [set(r) for r in seen] == [{"eager"}, {"capture"}, {"replay"}], (ns, seen)
    # a streamed Q1: lineitem above the device cache's budget, batches of
    # 8 x 1,024 rows; the batches' partial states merge in "aggcombine"
    s.execute("set tidb_device_cache_bytes = 65536")
    try:
        with jitcache.eager():
            resident = Session(catalog=s.catalog.base, chunk_capacity=4096,
                               mesh=_mesh(8)).query(STREAMED_Q1)
        seen = []
        for _ in range(3):
            jitcache.reset_runs()
            assert s.query(STREAMED_Q1) == resident
            seen.append(jitcache.runs())
    finally:
        s.execute("set tidb_device_cache_bytes = 8589934592")
    # eight batches a statement: the first run's batches warm up, capture
    # and replay the merge and the batch program; later runs replay all
    combine = [r["aggcombine"] for r in seen]
    assert set(combine[0]) == {"eager", "capture", "replay"}, combine
    assert all(set(r["aggcombine"]) == set(r["distagg"]) == {"replay"}
               for r in seen[1:]), seen
    # the streamed batches' and the merge's graphs (the evicted resident
    # sharding took its programs along), built by one statement: in its one
    # memory pool, one set of slots, one replay lock
    graphs = [g for p in jitcache.programs() if p.ns in MESH_NS for g in p.graphs()]
    assert {p.ns for p in jitcache.programs()} >= {"distagg", "aggcombine"}
    assert len(graphs) >= 2 and len({id(g.shared) for g in graphs}) == 1


def test_an_overflow_grows_a_new_key_with_the_same_rows(tpch, graphs_on, cpu_graphs,
                                                        monkeypatch):
    _want, sessions = tpch
    s = sessions[8]
    sql = Q["q3"][0]
    with jitcache.eager():
        want = s.query(sql)
    real = frag_mod._Compiler._add_growth

    def tight(self, default, kind):
        return real(self, default / 16 if kind == "exch" else default, kind)

    monkeypatch.setattr(frag_mod._Compiler, "_add_growth", tight)
    s._shard_cache.growth.clear()
    jitcache.clear()
    for _ in range(3):
        assert s.query(sql) == want
    keys = [p for p in jitcache.programs() if p.ns == "fragment"]
    # the tight exchange, then its doublings: one program (key) each
    assert len(keys) >= 2
    assert set(jitcache.runs()["fragment"]) >= {"replay"}


def test_an_unplaced_table_run_moves_the_join_to_the_sorted_route(
        tpch, graphs_on, cpu_graphs, monkeypatch):
    from tidb_tpu_torch.ops import hash_probe as hp

    _want, sessions = tpch
    s = sessions[8]
    with jitcache.eager():
        want = {sql: s.query(sql) for sql in (Q["q3"][0], QJOIN)}
    s.execute("set tidb_tpu_join_probe_mode = 'xla'")  # the table on the CPU too
    # one probe round: colliding runs go unplaced
    monkeypatch.setattr(hp, "MAX_PROBES", 1)
    s._shard_cache.growth.clear()
    jitcache.clear()
    try:
        for sql, rows in want.items():
            for _ in range(3):
                assert s.query(sql) == rows
    finally:
        s.execute("set tidb_tpu_join_probe_mode = 'auto'")
    growths = list(s._shard_cache.growth.values())
    assert any(g == (2.0, "off") for g in growths), growths  # DistJoinAggExec's route
    kinds = [p for p in jitcache.programs() if p.ns == "fragment"]
    assert len(kinds) >= 2  # the table route's program, then the sorted one's


@pytest.fixture
def small():
    """A port mesh session of 4 CPU shards over its own SF0.005 tables
    (the tests below write to them)."""
    s = Session(chunk_capacity=4096, mesh=_mesh(4))
    s.load_tpch(0.005)
    return s


def test_a_resident_sharding_has_no_static_slot(small, graphs_on, cpu_graphs):
    s = small
    for _ in range(3):
        s.query(Q["q1"][0])
    st = s._shard_cache.get(s.catalog.table("test", "lineitem"))
    progs = jitcache.programs(owner=st.serial)
    assert progs and all(p.resident == (0,) for p in progs)
    assert all(p.graphs() for p in progs)
    # no byte of the sharding is copied into the program
    assert sum(p.slot_bytes() for p in progs) == 0
    assert partition.table_bytes(s.catalog.table("test", "lineitem")) > 0


def test_update_and_evict_drop_the_old_sharding_and_its_programs(small, graphs_on,
                                                                 cpu_graphs):
    s = small
    sql = Q["q1"][0]
    li = s.catalog.table("test", "lineitem")
    for step in ("update", "evict"):
        for _ in range(3):
            before = s.query(sql)
        st = s._shard_cache.get(li)
        serial, ref = st.serial, weakref.ref(st)
        assert jitcache.programs(owner=serial)
        del st
        if step == "update":
            s.execute("update lineitem set l_quantity = l_quantity + 1 "
                      "where l_orderkey = 1")
            assert s.query(sql) != before
        else:
            s._shard_cache.evict(li)
        gc.collect()
        assert ref() is None, step
        assert not jitcache.programs(owner=serial), step
    for _ in range(3):
        s.query(sql)
    assert jitcache.programs(owner=s._shard_cache.get(li).serial)


def _broadcast_query(s):
    """A TPC-H query whose mesh fragment carries a broadcast input."""
    from tidb_tpu_torch.parser import parse

    for q in ("q18", "q20", "q22", "q11", "q17", "q2", "q15", "q16"):
        root = pex.build_dist_executor(s._plan_select(parse(Q[q][0])[0]), s._shard_cache)
        stack = [root]
        while stack:
            e = stack.pop()
            if isinstance(e, pex.DistFragmentExec) and e._prog.broadcasts:
                return Q[q][0]
            stack.extend(e.children)
    raise AssertionError("no TPC-H query broadcasts on the mesh")


def test_broadcasts_upload_before_the_program(tpch, graphs_on, cpu_graphs, monkeypatch):
    _want, sessions = tpch
    s = sessions[4]
    sql = _broadcast_query(s)
    with jitcache.eager():
        want = s.query(sql)
    uploads = []
    real = partition.upload_packed

    def watched(arrays, dev):
        uploads.append(dispatch.capturing())
        return real(arrays, dev)

    monkeypatch.setattr(partition, "upload_packed", watched)
    for _ in range(3):
        assert s.query(sql) == want
    runs = jitcache.runs()["fragment"]
    assert runs.get("capture") and runs.get("replay"), runs
    assert uploads and not any(uploads), uploads


def test_a_mesh_over_two_devices_runs_eagerly(tpch, graphs_on, cpu_graphs, monkeypatch):
    want, sessions = tpch
    s = sessions[8]
    two = {torch.device("cuda", 0), torch.device("cuda", 1)}
    monkeypatch.setattr(jitcache, "_devices", lambda leaves: two)
    for q in ("q1", "q3"):
        for _ in range(3):
            same_rows(s.query(_sql(q)), want[q], ordered=True)
    runs = _mesh_runs()
    assert runs and all(set(r) == {"eager_multi_device"} for r in runs.values()), runs
    assert not any(p.graphs() for p in jitcache.programs())


def test_a_pool_counts_whole_and_goes_with_its_last_program(cpu_graphs, monkeypatch):
    """The mesh's graphs share one memory pool: the cache counts the pool
    as one unit (its captures and its one set of slots), evicts the
    least recent units first, and lets the pool go only whole."""
    monkeypatch.setattr(jitcache, "_BOUND", [jitcache.MAX_BYTES])
    x = torch.arange(4)

    def prog(key, pool):
        return jitcache.cached_jit("t", key, lambda: (lambda v: v + 1), pool=pool)

    for key, pool in (("a", None), ("b", "p"), ("c", "p")):
        for _ in range(2):  # the warm-up, then the capture
            assert torch.equal(prog(key, pool)(x), x + 1)
    units = jitcache.held_units()
    # a's graph and its own slot; the pool's two graphs and one shared slot
    assert units == [4096 + 256, 2 * 4096 + 256], units
    # a bound below the pool alone: the older unit goes, the pool stays
    jitcache.cached_jit("t", "b", lambda: None, max_bytes=5000)
    assert {p.ns + p.pool for p in jitcache.programs()} == {"tp"}
    assert jitcache.held_units() == [2 * 4096 + 256]
    # a newer unpooled program: now the pool is the older unit, and goes whole
    for _ in range(2):
        prog("d", None)(x)
    assert [p.pool for p in jitcache.programs()] == [None]
    assert not jitcache._POOLS


def test_drop_owner_from_a_finalizer_never_waits(cpu_graphs, monkeypatch):
    """A sharding's finalizer may run inside any allocation, also one made
    while the cache holds its lock (a new pool's handle): its drop_owner
    must not wait for that lock, and the drop happens at the next access."""
    import threading

    x = torch.arange(4)

    def prog(key, pool, owners=()):
        return jitcache.cached_jit("t", key, lambda: (lambda v: v + 1), owners=owners,
                                   pool=pool)

    for _ in range(2):  # the warm-up, then the capture into pool "p"
        prog("a", "p", owners=("old",))(x)
    assert jitcache.programs(owner="old")

    def handle_with_a_finalizer():
        jitcache.drop_owner("old")  # a collected sharding's finalizer, here
        return (0, 0)

    monkeypatch.setattr(torch.cuda, "graph_pool_handle", handle_with_a_finalizer)

    def capture_into_a_new_pool():
        for _ in range(2):
            prog("b", "q")(x)

    t = threading.Thread(target=capture_into_a_new_pool, daemon=True)
    t.start()
    t.join(timeout=60)
    if t.is_alive():
        # the wedged thread keeps its locks: give the module fresh ones so
        # the teardown and the tests after this one can run, then fail
        lock_type = type(threading.Lock())
        for name in [n for n, v in vars(jitcache).items() if isinstance(v, lock_type)]:
            setattr(jitcache, name, threading.Lock())
        pytest.fail("drop_owner waited for a lock its own thread holds")
    assert not jitcache.programs(owner="old")
    assert [p.pool for p in jitcache.programs()] == ["q"]
    assert {k[0] for k in jitcache._POOLS} == {"q"}


def test_a_statements_programs_share_one_pool_across_executions(tpch, graphs_on, cpu_graphs,
                                                                monkeypatch):
    """Programs a later execution of the same statement builds (here a
    tighter exchange's new keys, as a moved plan or a grown capacity
    would give) capture into the statement's pool, not one beside it:
    the quota then counts the statement once."""
    _want, sessions = tpch
    s = sessions[4]
    sql = Q["q3"][0]
    for _ in range(2):  # the warm-up and the capture
        want = s.query(sql)
    first = {p.pool for p in jitcache.programs() if p.ns == "fragment"}
    real = frag_mod._Compiler._add_growth

    def tight(self, default, kind):
        return real(self, default / 16 if kind == "exch" else default, kind)

    monkeypatch.setattr(frag_mod._Compiler, "_add_growth", tight)
    s._shard_cache.growth.clear()
    for _ in range(3):
        assert s.query(sql) == want
    progs = [p for p in jitcache.programs() if p.ns == "fragment"]
    assert len(progs) >= 2 and {p.pool for p in progs} == first and len(first) == 1
    # another statement has a pool of its own
    s.query(Q["q5"][0])
    assert len({p.pool for p in jitcache.programs() if p.ns == "fragment"}) == 2
