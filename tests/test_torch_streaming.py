"""Streaming on the port's mesh tier against the reference's: tables above
tidb_device_cache_bytes stream through fixed [P, R] staging batches
instead of staying resident (the counterpart of tests/test_streaming.py).
The reference runs on its 8-device virtual CPU mesh, the port on eight
CPU shards, over the same TPC-H tables (the reference's generator,
exported into the port) or the same inserted columns. Rows compare with
the sqlite oracle (numbers within 1e-6 relative), with the reference
(non-floats exactly, floats within 1e-9 relative), and a streamed run
with the resident one exactly."""

import numpy as np
import pytest
import torch

from tidb_tpu.parallel import make_mesh as jax_make_mesh
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.tpch import load_tpch as jax_load_tpch
from tidb_tpu.testutil import mirror_to_sqlite, rows_equal
from tidb_tpu_torch.parallel import executor as pex
from tidb_tpu_torch.parallel import make_mesh
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.tpch_queries import Q
from tidb_tpu_torch.utils.metrics import FRAGMENT_DISPATCH
from test_torch_parallel import CPU8, same_rows
from test_torch_session import _export_into
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

torch.set_num_threads(1)

BUDGET = "SET tidb_device_cache_bytes = 1048576"


def _pair(devices8, sf, capacity, tables, shards=(4, 2)):
    js = JaxSession(chunk_capacity=capacity, mesh=jax_make_mesh(
        n_shards=shards[0], n_dcn=shards[1], devices=devices8))
    jax_load_tpch(js.catalog, sf=sf)
    ps = Session(chunk_capacity=capacity, mesh=make_mesh(
        n_shards=shards[0], n_dcn=shards[1], devices=CPU8))
    for name in tables:
        _export_into(ps, js.catalog.table("test", name), name)
    return js, ps


@pytest.fixture(scope="module")
def sess(devices8):
    from tidb_tpu.parallel import executor as jex

    js, ps = _pair(devices8, 0.02, 4096, ("lineitem",))
    for s in (js, ps):
        s.execute(BUDGET)  # lineitem must stream in many batches
    jex.DistAggExec.STREAM_ROWS_PER_PART = 2048
    pex.DistAggExec.STREAM_ROWS_PER_PART = 2048
    yield js, ps, mirror_to_sqlite(js.catalog, tables=["lineitem"])
    jex.DistAggExec.STREAM_ROWS_PER_PART = 1 << 20
    pex.DistAggExec.STREAM_ROWS_PER_PART = 1 << 20


@pytest.fixture
def stream_calls(monkeypatch):
    calls = {"stream": 0}
    orig = pex.DistAggExec._run_segment_streaming

    def spy(self, domains, cols):
        calls["stream"] += 1
        return orig(self, domains, cols)

    monkeypatch.setattr(pex.DistAggExec, "_run_segment_streaming", spy)
    return calls


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_query_streams_and_matches(sess, stream_calls, q):
    js, ps, oracle = sess
    got = ps.query(Q[q][0])
    assert stream_calls["stream"] >= 1, "streaming path not taken"
    ok, msg = rows_equal(got, oracle.execute(Q[q][1] or Q[q][0]).fetchall(), ordered=True)
    assert ok, msg
    same_rows(got, js.query(Q[q][0]), ordered=True)


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_streamed_equals_resident(sess, q):
    _js, ps, _ = sess
    streamed = ps.query(Q[q][0])
    ps.execute("SET tidb_device_cache_bytes = 34359738368")  # resident again
    try:
        resident = ps.query(Q[q][0])
    finally:
        ps.execute(BUDGET)
    assert streamed == resident


def test_streaming_matches_resident_min_max(sess):
    _js, ps, _ = sess
    sql = ("select l_returnflag, count(*), sum(l_quantity), min(l_discount), "
           "max(l_tax) from lineitem group by l_returnflag order by l_returnflag")
    streamed = ps.query(sql)
    ps.execute("SET tidb_device_cache_bytes = 34359738368")
    try:
        resident = ps.query(sql)
    finally:
        ps.execute(BUDGET)
    assert streamed == resident


class TestFragmentStreaming:
    """Tables above the budget stream through general fragments, joins and
    generic aggregation included."""

    def test_q18_streams_oracle_checked(self, devices8):
        js, ps = _pair(devices8, 0.01, 1 << 16, ("lineitem", "orders", "customer"),
                       shards=(8, 1))
        for s in (js, ps):
            s.execute("set tidb_device_engine_mode = 'force'")
            s.execute(BUDGET)  # lineitem (~60k rows) over the 1 MB budget
        before = FRAGMENT_DISPATCH.value(kind="general_generic_stream")
        got = ps.query(Q["q18"][0])
        assert FRAGMENT_DISPATCH.value(kind="general_generic_stream") > before, \
            "expected the streaming fragment path"
        conn = mirror_to_sqlite(js.catalog, tables=["lineitem", "orders", "customer"])
        ok, msg = rows_equal(got, conn.execute(Q["q18"][1] or Q["q18"][0]).fetchall())
        assert ok, msg
        same_rows(got, js.query(Q["q18"][0]), ordered=False)

    def test_streamed_join_segment_agg(self, devices8):
        ps = Session(chunk_capacity=1 << 14, mesh=make_mesh(devices=CPU8))
        ps.execute("set tidb_device_engine_mode = 'force'")
        ps.execute("create table fat (k bigint, flag varchar(1), v bigint)")
        ps.execute("create table dim (k bigint primary key, w bigint)")
        rng = np.random.default_rng(5)
        n = 60_000
        ps.catalog.table("test", "fat").insert_columns(
            {"k": rng.integers(0, 500, n), "v": rng.integers(0, 100, n)},
            strings={"flag": [("A", "B")[i % 2] for i in range(n)]})
        ps.catalog.table("test", "dim").insert_columns(
            {"k": np.arange(500), "w": np.arange(500) % 10})
        sql = ("select flag, count(*), sum(v + w) from fat "
               "join dim on fat.k = dim.k group by flag order by flag")
        want = ps.query(sql)  # the resident path first
        ps.execute(BUDGET)
        before = FRAGMENT_DISPATCH.value(kind="general_segment_stream")
        got = ps.query(sql)
        assert FRAGMENT_DISPATCH.value(kind="general_segment_stream") > before, \
            "expected the streaming fragment path"
        assert got == want


def test_build_side_of_anti_join_never_streams(devices8):
    """The build side of a NOT IN is pinned resident (streaming it would
    re-decide matches per batch): the result stays exact over budget."""
    ps = Session(chunk_capacity=1 << 13, mesh=make_mesh(devices=CPU8))
    ps.execute("set tidb_device_engine_mode = 'force'")
    ps.execute("create table small (k bigint)")
    ps.execute("create table big (k bigint, pad1 bigint, pad2 bigint)")
    ps.catalog.table("test", "small").insert_columns({"k": np.arange(100, dtype=np.int64)})
    n = 50_000
    # big holds only even keys < 100 (and lots of padding bytes)
    ps.catalog.table("test", "big").insert_columns(
        {"k": (np.arange(n) % 50 * 2).astype(np.int64),
         "pad1": np.zeros(n, dtype=np.int64), "pad2": np.zeros(n, dtype=np.int64)})
    sql = "select count(*) from small where k not in (select k from big)"
    want = ps.query(sql)
    assert want == [(50,)], want  # the odd keys survive
    ps.execute(BUDGET)
    assert ps.query(sql) == want
