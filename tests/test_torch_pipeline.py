"""The port's fused scan pipeline (tidb_tpu_torch/executor/pipeline.py) on
the CPU: FusedScanAggExec, ChunkPrefetcher and the DeviceBufferCache,
against the port's classic tree and the JAX package's Session.

The table is the reference's `pipe_session` table (tests/test_pipeline.py):
10,000 rows, chunk capacity 4,096 and `tidb_tpu_segment_rows = 1024`, so
scans read packed multi-segment batches (k = 4 segments a batch) and
several batches a fragment. TPC-H Q1 and Q6 run at SF0.01 under the same
settings. Rows compare exactly (integers and decimals) and within 1e-12
relative for averages, as sorted lists where the SQL does not order."""

import datetime

import numpy as np
import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.tpch import load_tpch as jax_load_tpch
from tidb_tpu.testutil import rows_equal
from tidb_tpu_torch.errors import QueryTimeoutError
from tidb_tpu_torch.executor import pipeline as pl
from tidb_tpu_torch.executor.base import ExecContext, run_plan
from tidb_tpu_torch.executor.builder import build_executor
from tidb_tpu_torch.executor.pipeline import (
    DEVICE_CACHE,
    ChunkPrefetcher,
    FusedScanAggExec,
    table_ident,
)
from tidb_tpu_torch.parser import parse
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.tpch_queries import Q
from tidb_tpu_torch.types import date_to_days
from tidb_tpu_torch.utils.memory import MemTracker, QueryOOMError

from test_torch_session import _export_into

CAP = 1 << 12
SEG_ROWS = 1024


def _key(r):
    return tuple((x is None, str(x)) for x in r)


def assert_rows(got, want, ordered=False):
    """Exact for integers and decimals (decimal strings compare as
    strings), 1e-12 relative for floats (averages)."""
    if not ordered:
        got, want = sorted(got, key=_key), sorted(want, key=_key)
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                assert b is not None and abs(a - b) <= 1e-12 * max(abs(b), 1e-300), (g, w)
            else:
                assert a == b, (g, w)
    ok, msg = rows_equal(got, want, ordered=True)
    assert ok, msg


def _pipe_rows(n=10000):
    rng = np.random.default_rng(11)
    k = [("a", "b", "c", None)[i] for i in rng.integers(0, 4, n)]
    i = np.arange(n)
    g = (i % 5).astype(np.int64)
    v = (i % 211).astype(np.int64)
    v_ok = i % 7 != 0
    f = i * 0.25
    d = np.array([date_to_days(datetime.date(1995, 1 + (x // 1000) % 12, 10 + x % 9))
                  for x in i], dtype=np.int32)
    m = np.round((i % 5000) / 7.0, 2)
    m = np.rint(m * 100).astype(np.int64)  # DECIMAL(10,2), scaled
    return {"g": g, "v": v, "f": f, "d": d, "m": m}, {"v": v_ok}, {"k": k}


def _load_pipe(s, arrays, valids, strings):
    s.execute(f"set tidb_tpu_segment_rows = {SEG_ROWS}")
    s.execute("create table t (k varchar(10), g int, v int, f double, d date, m decimal(10,2))")
    s.catalog.table("test", "t").insert_columns(
        {n: a.copy() for n, a in arrays.items()},
        valids={n: a.copy() for n, a in valids.items()},
        strings={n: list(a) for n, a in strings.items()})


@pytest.fixture(scope="module")
def pipe_pair():
    js, ps = JaxSession(chunk_capacity=CAP), Session(chunk_capacity=CAP, device="cpu")
    rows = _pipe_rows()
    for s in (js, ps):
        _load_pipe(s, *rows)
    return js, ps


QUERIES = [
    # segment strategy (dict-code group keys), NULL group included
    "select k, count(*), sum(v), min(v), max(f), avg(v) from t group by k",
    # generic strategy (int keys): the device group tables, fused filter
    "select g, sum(v + 1), count(v), max(v) from t where f < 1800 group by g",
    # global aggregate (no group keys)
    "select count(*), sum(v), min(f), max(f) from t where g <> 2",
    # decimal two-limb sums through the fused fragment
    "select k, sum(m), avg(m) from t group by k",
    # zone-prunable date range over the segmented store
    "select k, sum(v), count(*) from t where d < date '1995-04-01' group by k",
    # empty result: grouped agg over no rows
    "select g, sum(v) from t where v < -5 group by g",
    # empty input, global agg: exactly one row
    "select count(*), sum(v) from t where v < -5",
]


def _arms(s, sql):
    """(fused rows, unfused rows) of one statement."""
    s.execute("set tidb_tpu_pipeline_fuse = 0")
    try:
        unfused = s.query(sql)
    finally:
        s.execute("set tidb_tpu_pipeline_fuse = 1")
    return s.query(sql), unfused


@pytest.mark.parametrize("sql", QUERIES)
def test_fused_unfused_and_jax_agree(pipe_pair, sql):
    js, ps = pipe_pair
    fused, unfused = _arms(ps, sql)
    want = js.query(sql)
    assert_rows(fused, want)
    assert_rows(unfused, want)


def _walk(root):
    stack = [root]
    while stack:
        e = stack.pop()
        yield e
        stack.extend(c for c in e.children if c is not None)
        if getattr(e, "_delegate", None) is not None:
            stack.append(e._delegate)


def _run(ps, sql):
    """Run `sql` through the port's builder; returns (rows, executors)."""
    phys = ps._plan_select(parse(sql)[0])
    root = build_executor(phys)
    rs = run_plan(root, ps._exec_ctx(plan=phys), n_visible=getattr(phys, "n_visible", None))
    return rs.rows, list(_walk(root))


def test_fused_agg_is_routed_and_runs_fused(pipe_pair):
    _js, ps = pipe_pair
    _rows, execs = _run(ps, QUERIES[0])
    fused = [e for e in execs if isinstance(e, FusedScanAggExec)]
    assert fused and fused[0]._ran_fused and fused[0]._delegate is None
    # 10,000 rows in 1,024-row segments: 10 segments, 4 to a batch
    assert fused[0].stats.segs_scanned == 10


def test_generic_agg_takes_the_delegate(pipe_pair):
    """The generic strategy runs fused on the device engine (its group
    tables stack on the device); with the engine off
    (tidb_device_engine_mode = 'off') it takes the classic delegate."""
    from tidb_tpu_torch.executor import aggregate as agg

    _js, ps = pipe_pair
    agg.reset_counters()
    rows, execs = _run(ps, QUERIES[1])
    fused = [e for e in execs if isinstance(e, FusedScanAggExec)]
    assert fused and fused[0]._ran_fused and fused[0]._delegate is None
    assert agg.DEVICE_GENERIC_TOTAL == {"classic": 0, "fused": 1}
    ps.execute("set tidb_device_engine_mode = 'off'")
    try:
        host_rows, execs = _run(ps, QUERIES[1])
    finally:
        ps.execute("set tidb_device_engine_mode = 'auto'")
    fused = [e for e in execs if isinstance(e, FusedScanAggExec)]
    assert fused and not fused[0]._ran_fused
    assert agg.DEVICE_GENERIC_TOTAL == {"classic": 0, "fused": 1}
    assert sorted(host_rows) == sorted(rows)


def test_delegate_under_pipeline_fuse_0(pipe_pair):
    _js, ps = pipe_pair
    root = build_executor(ps._plan_select(parse(QUERIES[0])[0]))
    ex = [e for e in _walk(root) if isinstance(e, FusedScanAggExec)][0]
    ctx = ExecContext(chunk_capacity=CAP, pipeline_fuse=False)
    try:
        ex.open(ctx)
        assert ex._delegate is not None and not ex._ran_fused
        assert ex.next() is not None
    finally:
        ex.close()


# -- TPC-H Q1 and Q6 at SF0.01 ------------------------------------------------

def tpch_seg_pair():
    """A JAX and a port Session over the same SF0.01 tables, both with
    chunk capacity 4,096 and 1,024-row segments."""
    js = JaxSession(chunk_capacity=CAP)
    js.execute(f"set tidb_tpu_segment_rows = {SEG_ROWS}")
    jax_load_tpch(js.catalog, sf=0.01)
    ps = Session(chunk_capacity=CAP, device="cpu")
    ps.execute(f"set tidb_tpu_segment_rows = {SEG_ROWS}")
    for name in ("lineitem", "orders", "customer", "supplier", "nation", "region"):
        _export_into(ps, js.catalog.table("test", name), name)
    return js, ps


@pytest.fixture(scope="module")
def tpch_seg():
    return tpch_seg_pair()


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_tpch_fused_unfused_and_jax_agree(tpch_seg, q):
    js, ps = tpch_seg
    want = js.query(Q[q][0])
    assert want
    fused, unfused = _arms(ps, Q[q][0])
    assert_rows(fused, want, ordered=True)
    assert_rows(unfused, want, ordered=True)
    _rows, execs = _run(ps, Q[q][0])
    agg = [e for e in execs if isinstance(e, FusedScanAggExec)]
    assert agg and agg[0]._ran_fused
    assert agg[0].stats.segs_scanned + agg[0].stats.segs_pruned == 59  # 60,175 rows


# -- DeviceBufferCache ----------------------------------------------------------

WARM = "select k, sum(v), count(*) from t group by k"


def _staged_batches():
    t = pl.PIPELINE_PREFETCH_TOTAL
    return t["hit"] + t["wait"] + t["inline"]


def test_warm_run_stages_nothing(pipe_pair):
    _js, ps = pipe_pair
    DEVICE_CACHE.clear()
    staged = _staged_batches()
    ps.query(WARM)  # fill
    n_batches = _staged_batches() - staged
    hits, staged = pl.DEVICE_CACHE_TOTAL["hit"], _staged_batches()
    rows = ps.query(WARM)  # warm: the batches come from the cache
    assert pl.DEVICE_CACHE_TOTAL["hit"] == hits + 1
    assert _staged_batches() == staged
    _, execs = _run(ps, WARM)
    agg = [e for e in execs if isinstance(e, FusedScanAggExec)][0]
    assert n_batches > 1 and agg.stats.staged == n_batches
    assert rows == ps.query(WARM)


def test_insert_invalidates(pipe_pair):
    js, ps = pipe_pair
    ps.query(WARM)
    for s in (js, ps):
        s.execute("insert into t values ('a', 1, 5, 0.5, '1995-01-11', 1.25)")
    inv = pl.DEVICE_CACHE_TOTAL["invalidate"]
    got = ps.query(WARM)
    assert pl.DEVICE_CACHE_TOTAL["invalidate"] == inv + 1
    assert_rows(got, js.query(WARM))  # the refreshed entry serves the new row


def test_drop_and_create_clear_the_cache(pipe_pair):
    _js, ps = pipe_pair
    ps.query(WARM)
    assert len(DEVICE_CACHE) > 0
    ps.execute("create table ddl_probe (a int)")  # schema_version bump
    assert len(DEVICE_CACHE) == 0
    ps.query(WARM)
    assert len(DEVICE_CACHE) > 0
    ps.execute("drop table ddl_probe")
    assert len(DEVICE_CACHE) == 0


def test_schema_version_hook_clears_cache():
    """Every schema_version bump clears DEVICE_CACHE, so buffers never
    pin a dropped table."""
    s = Session(device="cpu")
    s.execute("create table small (a int, b int)")
    t = s.catalog.table("test", "small")
    DEVICE_CACHE.put(t, ("probe",), table_ident(t), [{}], 1, 1 << 20)
    assert len(DEVICE_CACHE) == 1
    s.catalog.schema_version += 1
    assert len(DEVICE_CACHE) == 0


def test_budget_zero_disables(pipe_pair):
    _js, ps = pipe_pair
    ps.execute("set global tidb_tpu_device_buffer_cache_bytes = 0")
    try:
        DEVICE_CACHE.clear()
        c0 = dict(pl.DEVICE_CACHE_TOTAL)
        staged = _staged_batches()
        ps.query(WARM)
        once = _staged_batches() - staged
        ps.query(WARM)
        assert len(DEVICE_CACHE) == 0
        assert pl.DEVICE_CACHE_TOTAL == c0  # bypassed, not missing
        assert once > 1 and _staged_batches() == staged + 2 * once  # staged twice
    finally:
        ps.execute(f"set global tidb_tpu_device_buffer_cache_bytes = {256 << 20}")


def test_ident_moves_on_version_and_epoch(pipe_pair):
    js, ps = pipe_pair
    t = ps.catalog.table("test", "t")
    i0 = table_ident(t)
    for s in (js, ps):
        s.execute("insert into t values ('b', 2, 7, 1.5, '1995-02-11', 2.5)")
    i1 = table_ident(t)
    assert i1 != i0 and i1[0] > i0[0] and i1[1] == i0[1]
    for s in (js, ps):  # a new string: the dictionary re-encodes in place
        s.execute("insert into t values ('aa', 2, 7, 1.5, '1995-02-11', 2.5)")
    assert table_ident(t)[1] > i1[1]
    assert_rows(ps.query(WARM), js.query(WARM))


# -- ChunkPrefetcher ------------------------------------------------------------

def _jobs(n, rows=1 << 11):
    def mk(i):
        def job(arena_for):
            arena = arena_for(rows * 8)
            x = arena.zeros(rows, np.int64)
            x[:] = i
            return {"x": x}

        return job

    return [mk(i) for i in range(n)]


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_depth_gives_the_same_rows(pipe_pair, depth):
    js, ps = pipe_pair
    ps.execute(f"set tidb_tpu_pipeline_prefetch_depth = {depth}")
    ps.execute("set global tidb_tpu_device_buffer_cache_bytes = 0")
    try:
        t = pl.PIPELINE_PREFETCH_TOTAL
        ahead = t["hit"] + t["wait"]
        for sql in QUERIES[0], QUERIES[3], QUERIES[4]:
            assert_rows(ps.query(sql), js.query(sql))
        # depth 0 stages every batch inline; depth 2 stages ahead on the
        # thread (a one-batch fragment stages inline at any depth)
        assert (t["hit"] + t["wait"] > ahead) == (depth > 0)
    finally:
        ps.execute("set tidb_tpu_pipeline_prefetch_depth = 2")
        ps.execute(f"set global tidb_tpu_device_buffer_cache_bytes = {256 << 20}")


def test_prefetcher_stages_in_order_and_returns_its_charges():
    ctx = ExecContext(chunk_capacity=CAP, prefetch_depth=2)
    pf = ChunkPrefetcher(_jobs(6), ctx)
    try:
        assert pf._thread is not None
        for i in range(6):
            assert int(pf.get(i)["x"][0]) == i
    finally:
        pf.close()
    assert ctx.mem_tracker.consumed == 0


def test_prefetcher_inline_at_depth_zero():
    ctx = ExecContext(chunk_capacity=CAP, prefetch_depth=0)
    inline = pl.PIPELINE_PREFETCH_TOTAL["inline"]
    pf = ChunkPrefetcher(_jobs(3), ctx)
    try:
        assert pf._thread is None
        for i in range(3):
            assert int(pf.get(i)["x"][0]) == i
    finally:
        pf.close()
    assert pl.PIPELINE_PREFETCH_TOTAL["inline"] == inline + 3


def test_tight_quota_is_typed_oom():
    """In-flight staged bytes charge the statement tracker: a budget below
    one staged batch surfaces as the typed OOM (spill disabled)."""
    tracker = MemTracker("stmt", budget=4096, spill_enabled=False, spill_root=True)
    ctx = ExecContext(chunk_capacity=CAP, prefetch_depth=2, mem_tracker=tracker)
    pf = ChunkPrefetcher(_jobs(4, rows=1 << 12), ctx)
    try:
        with pytest.raises(QueryOOMError):
            for i in range(4):
                pf.get(i)
    finally:
        pf.close()


def test_tight_statement_quota_raises_through_session():
    """tidb_mem_quota_query reaches the fused scan: the segment bytes it
    pins exceed a 1 MiB budget, and with spilling off the statement fails
    with the typed OOM (raised in the staging thread, relayed by get)."""
    s = Session(chunk_capacity=CAP, device="cpu")
    s.execute(f"set tidb_tpu_segment_rows = {SEG_ROWS}")
    # a cached warm run would stage (and pin) nothing
    s.execute("set global tidb_tpu_device_buffer_cache_bytes = 0")
    s.execute("create table wide (a bigint, b bigint, c bigint)")
    rng = np.random.default_rng(5)
    n = 300_000
    s.catalog.table("test", "wide").insert_columns(
        {c: rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64) for c in "abc"})
    sql = "select count(*), sum(a), sum(b), sum(c) from wide where a > 0"
    want = s.query(sql)
    s.execute(f"set tidb_mem_quota_query = {1 << 20}")
    s.execute("set tidb_enable_tmp_storage_on_oom = 0")
    with pytest.raises(QueryOOMError):
        s.query(sql)
    s.execute("set tidb_enable_tmp_storage_on_oom = 1")
    # with spilling on, cold segments spill to disk and the query completes
    assert s.query(sql) == want


def test_staging_error_reaches_the_consumer_unchanged():
    """An error in the staging thread is raised from get(); the prefetcher
    never falls back to inline staging after it."""
    jobs = _jobs(4)

    def broken(arena_for):
        raise ValueError("staging failed")

    jobs[1] = broken
    ctx = ExecContext(chunk_capacity=CAP, prefetch_depth=2)
    err, inline = pl.PIPELINE_PREFETCH_TOTAL["error"], pl.PIPELINE_PREFETCH_TOTAL["inline"]
    pf = ChunkPrefetcher(jobs, ctx)
    try:
        assert int(pf.get(0)["x"][0]) == 0
        with pytest.raises(ValueError, match="staging failed"):
            pf.get(1)
        with pytest.raises(ValueError):
            pf.get(2)
    finally:
        pf.close()
    assert pl.PIPELINE_PREFETCH_TOTAL["error"] == err + 1
    assert pl.PIPELINE_PREFETCH_TOTAL["inline"] == inline


def test_staging_thread_polls_cancellation():
    armed = []

    def cancel():
        return QueryTimeoutError("deadline") if armed else False

    jobs = _jobs(4)
    first = jobs[1]

    def arming(arena_for):
        out = first(arena_for)
        armed.append(True)
        return out

    jobs[1] = arming
    ctx = ExecContext(chunk_capacity=CAP, prefetch_depth=1, cancel_check=cancel)
    pf = ChunkPrefetcher(jobs, ctx)
    try:
        assert pf.get(0) is not None
        with pytest.raises(QueryTimeoutError):
            for i in range(1, 4):
                pf.get(i)
    finally:
        pf.close()
    assert ctx.mem_tracker.consumed == 0


def test_cancel_mid_fragment_releases_staging(pipe_pair):
    _js, ps = pipe_pair
    root = build_executor(ps._plan_select(parse("select k, sum(v) from t group by k")[0]))
    fused = [e for e in _walk(root) if isinstance(e, FusedScanAggExec)]
    polls = []

    def cancel():
        polls.append(1)
        return QueryTimeoutError("deadline") if len(polls) > 2 else False

    ctx = ExecContext(chunk_capacity=1 << 11, cancel_check=cancel, segment_rows=SEG_ROWS,
                      device_buffer_cache_bytes=0)
    try:
        with pytest.raises(QueryTimeoutError):
            root.open(ctx)
            while root.next() is not None:
                pass
    finally:
        root.close()
    assert fused[0]._pin is None and fused[0]._prefetcher is None

