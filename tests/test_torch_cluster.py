"""CLUSTER BY ordered compaction and the background compaction worker
through the port (tidb_tpu_torch on the CPU) against the JAX package.

The same ingest goes into both packages; after the fold both must hold
the same physical rows in the same order with the same `clustered_rows`,
and TPC-H Q6 over the reference's default layout (lineitem CLUSTER BY
l_shipdate, exported into the port) must scan and prune the same
segments. The reader registry, the permute's refusals and the
compaction worker's chaos cases mirror tests/test_topn_fused.py
(TestClusterBy, TestReclusterReaderGate) and tests/test_write_path.py
(TestCompactionChaos). The port's worker is reset around every test; the
reference's process-wide worker is left as it was found."""

import random

import numpy as np
import pytest

from tidb_tpu.columnar import store as jax_store
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.tpch import load_tpch as jax_load_tpch
from tidb_tpu_torch.columnar import compaction
from tidb_tpu_torch.columnar import store as st
from tidb_tpu_torch.columnar.store import ScanPin, store_for
from tidb_tpu_torch.executor import ExecContext, build_executor
from tidb_tpu_torch.parser import parse
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.tpch_queries import Q
from tidb_tpu_torch.utils import failpoint as fp
from tidb_tpu_torch.utils.memory import MemTracker

from test_torch_keys import both
from test_torch_session import _export_into, _same, reference_witness_paused  # noqa: F401


@pytest.fixture(autouse=True)
def fresh_port_worker():
    compaction.reset_for_tests()
    yield
    compaction.reset_for_tests()


@pytest.fixture()
def jax_worker_isolated():
    """A reference session with tidb_tpu_compaction on may start the
    reference's process-wide worker: give this test a worker of its own
    and put the process's one back afterwards."""
    from tidb_tpu.columnar import compaction as jc

    with jc._worker_lock:
        saved, jc._worker = jc._worker, None
    yield
    with jc._worker_lock:
        mine, jc._worker = jc._worker, saved
    if mine is not None:
        mine.stop()


def _pair(**kw):
    js = JaxSession(**kw)
    js.execute("set tidb_tpu_compaction = 0")
    return js, Session(device="cpu", **kw)


def _shuffled_ingest(sessions, name, rows, seed, batch=1000):
    random.seed(seed)
    order = list(range(rows))
    random.shuffle(order)
    for s in sessions:
        s.execute(f"create table {name} (d int, v int) cluster by (d)")
        for off in range(0, rows, batch):
            s.execute(f"insert into {name} values " + ",".join(
                f"({d}, {d % 7})" for d in order[off:off + batch]))


def _physical(t, cols):
    return {c: np.asarray(t.data[c][:t.n]).copy() for c in cols}


# -- DDL -----------------------------------------------------------------------

@pytest.mark.parametrize("stmt", [
    "alter table c1 cluster by (b)",
    "alter table c1 cluster by none",
    "alter table c1 cluster by (zz)",
    "create table c2 (a int, j json) cluster by (j)",
    "create table c3 (a int) cluster by (q)",
])
def test_cluster_ddl_matches_reference(stmt):
    js, ps = _pair()
    both(js, ps, "create table c1 (a int, b int) cluster by (a)")
    both(js, ps, stmt)
    for name in ("c1", "c2", "c3"):
        if js.catalog.has_table("test", name):
            assert ps.catalog.table("test", name).schema.cluster_by == \
                js.catalog.table("test", name).schema.cluster_by


# -- ordered compaction ----------------------------------------------------------

def test_ordered_compaction_matches_reference():
    """Shuffled ingest into a clustered table: the fold re-sorts both
    packages' rows into the same physical order (stable, ascending)."""
    js, ps = _pair(chunk_capacity=1 << 10)
    for s in (js, ps):
        s.execute("set tidb_tpu_segment_rows = 512")
    _shuffled_ingest((js, ps), "cl", 4000, seed=3)
    for s in (js, ps):
        assert s.query("select count(*) from cl") == [(4000,)]
    jt, pt = js.catalog.table("test", "cl"), ps.catalog.table("test", "cl")
    assert pt.clustered_rows == jt.clustered_rows == pt.n == 4000
    got, want = _physical(pt, ("d", "v")), _physical(jt, ("d", "v"))
    for c in got:
        np.testing.assert_array_equal(got[c], want[c])
    assert (np.diff(got["d"]) >= 0).all()
    assert not ps.catalog._recluster_pending


def test_nulls_first_stable_order_matches_reference():
    """NULL cluster keys sort first; equal keys keep arrival order."""
    js, ps = _pair()
    vals = [(3, 1), (None, 2), (1, 3), (3, 4), (None, 5), (1, 6), (2, 7)]
    for s in (js, ps):
        s.execute("create table cn (d int, v int) cluster by (d)")
        s.execute("insert into cn values " + ", ".join(
            f"({'NULL' if d is None else d}, {v})" for d, v in vals))
    jt, pt = js.catalog.table("test", "cn"), ps.catalog.table("test", "cn")
    assert jt.recluster() is True and pt.recluster() is True
    for c in ("d", "v"):
        np.testing.assert_array_equal(pt.data[c][:pt.n], jt.data[c][:jt.n])
        np.testing.assert_array_equal(pt.valid[c][:pt.n], jt.valid[c][:jt.n])
    assert pt.data["v"][:pt.n].tolist() == [2, 5, 3, 6, 7, 1, 4]


@pytest.mark.parametrize("shuffled", [True, False])
def test_flag_off_fold_equality(shuffled):
    """tidb_tpu_compaction moves WHERE the rebuild runs, never what a scan
    returns: identical ingest with the worker on and off folds to the same
    rows and the same physical clustered order. Appends in key order (a
    date-clustered table fed new days) keep the table sorted, so each
    fold past the delta threshold is the worker's rebuild."""
    res = {}
    for flag in (1, 0):
        s = Session(device="cpu", chunk_capacity=1 << 10)
        s.execute(f"set tidb_tpu_compaction = {flag}")
        s.execute("set tidb_tpu_segment_rows = 1024")
        s.execute("set tidb_tpu_segment_delta_rows = 1024")
        s.execute("create table cf (d int, v int) cluster by (d)")
        order = list(range(6000))
        if shuffled:
            random.seed(5)
            random.shuffle(order)
        c0 = dict(st.COMPACTION_TOTAL)
        t = s.catalog.table("test", "cf")
        for off in range(0, 6000, 1500):
            s.execute("insert into cf values " + ",".join(
                f"({d}, {(d * 3) % 11})" for d in order[off:off + 1500]))
            s.query("select count(*) from cf where d >= 100")
            assert compaction.default_worker().drain(30)
        rows = s.query("select d, v from cf where d >= 100 and d < 900 "
                       "order by d, v")
        got = {k: st.COMPACTION_TOTAL[k] - c0[k] for k in c0}
        res[flag] = (rows, t.clustered_rows, t.n, _physical(t, ("d", "v")), got)
    assert res[0][0] == res[1][0]
    assert res[0][1:3] == res[1][1:3] == (6000, 6000)
    for c in ("d", "v"):
        np.testing.assert_array_equal(res[0][3][c], res[1][3][c])
    assert res[0][4]["background"] == 0
    if not shuffled:
        assert res[1][4]["background"] >= 1
        assert res[1][4]["recluster"] == 0


def test_tpch_q6_clustered_layout_matches_reference():
    """The reference's default TPC-H layout (lineitem CLUSTER BY
    l_shipdate), SF0.05 with 8,192-row segments: the first Q6 folds and
    re-sorts lineitem in both packages to the same physical order, and
    the second Q6 scans 7 segments and prunes 30 in both."""
    js = JaxSession()
    js.execute("set tidb_tpu_compaction = 0")
    jax_load_tpch(js.catalog, sf=0.05)
    ps = Session(device="cpu")
    for s in (js, ps):
        s.execute("set tidb_tpu_segment_rows = 8192")
    jt = js.catalog.table("test", "lineitem")
    assert jt.schema.cluster_by == "l_shipdate" and jt.clustered_rows == 0
    pt = _export_into(ps, jt, "lineitem")
    assert pt.schema.cluster_by == "l_shipdate" and pt.clustered_rows == 0
    sql = Q["q6"][0]
    _same(ps.query(sql), js.query(sql), ordered=True)
    assert pt.clustered_rows == jt.clustered_rows == pt.n
    cols = ("l_shipdate", "l_orderkey", "l_linenumber")
    got, want = _physical(pt, cols), _physical(jt, cols)
    for c in cols:
        np.testing.assert_array_equal(got[c], want[c])
    j0, p0 = jax_store.scan_counts(), dict(st.SCAN_SEGMENTS_TOTAL)
    _same(ps.query(sql), js.query(sql), ordered=True)
    j1 = jax_store.scan_counts()
    jdiff = (j1[0] - j0[0], j1[1] - j0[1])
    pdiff = (st.SCAN_SEGMENTS_TOTAL["scanned"] - p0["scanned"],
             st.SCAN_SEGMENTS_TOTAL["pruned"] - p0["pruned"])
    assert pdiff == jdiff == (7, 30)


# -- the permute's refusals ------------------------------------------------------

def test_recluster_refused_under_other_sessions_txn():
    """Another session's open transaction (on a different table) blocks
    the permute in both packages: the single-writer invariant is
    catalog-wide."""
    out = []
    for mk in (lambda: JaxSession(), lambda: Session(device="cpu")):
        a = mk()
        a.execute("create table cg (d int, v int) cluster by (d)")
        a.execute("insert into cg values (9, 1), (2, 2), (4, 3)")
        a.execute("create table other (x int)")
        a.execute("insert into other values (1)")
        t = a.catalog.table("test", "cg")
        b = type(a)(catalog=a.catalog, **({} if isinstance(a, JaxSession)
                                          else {"device": "cpu"}))
        b.execute("begin")
        try:
            b.execute("update other set x = 2")
            refused = t.recluster()
        finally:
            b.execute("commit")
        out.append((refused, t.recluster(), t.data["d"][:t.n].tolist()))
    assert out[0] == out[1] == (False, True, [2, 4, 9])


def test_recluster_refused_under_open_txn():
    out = []
    for s in _pair():
        s.execute("create table cr (d int, v int) cluster by (d)")
        s.execute("insert into cr values (5, 1), (1, 2), (3, 3)")
        t = s.catalog.table("test", "cr")
        s.execute("begin")
        try:
            s.execute("update cr set v = 9 where d = 3")
            refused = t.recluster()
        finally:
            s.execute("commit")
        moved = t.recluster()
        out.append((refused, moved, t.clustered_rows == t.n,
                    t.data["d"][:t.n].tolist(), sorted(s.query("select d, v from cr"))))
    assert out[0] == out[1]
    assert out[1][:3] == (False, True, True)
    assert out[1][4] == [(1, 2), (3, 9), (5, 1)]


def test_recluster_partial_failure_leaves_table_intact():
    """The permute is all-or-nothing: a failure allocating the second
    column's permuted copy leaves every column, the epoch and the
    watermark as they were; a clean retry then succeeds."""
    class Boom(MemoryError):
        pass

    class ExplodingOnFancyIndex(np.ndarray):
        def __getitem__(self, item):
            if isinstance(item, np.ndarray) and item.ndim == 1 \
                    and item.dtype.kind in "iu":
                raise Boom()
            return super().__getitem__(item)

    s = Session(device="cpu")
    s.execute("create table cx (d int, v int) cluster by (d)")
    s.execute("insert into cx values (7, 1), (3, 2), (5, 3)")
    t = s.catalog.table("test", "cx")
    before = {n: t.data[n][:t.n].copy() for n in t.data}
    epoch = t.data_epoch
    plain = t.data["v"]
    t.data["v"] = plain.view(ExplodingOnFancyIndex)
    try:
        with pytest.raises(Boom):
            t.recluster()
    finally:
        t.data["v"] = plain
    assert t.data_epoch == epoch
    for name in before:
        assert (t.data[name][:t.n] == before[name]).all()
    assert t.clustered_rows < t.n
    assert t.recluster() is True
    assert t.data["d"][:t.n].tolist() == [3, 5, 7]


# -- the reader registry -----------------------------------------------------------

def _clustered(s, name="rg", rows=2000):
    s.execute(f"create table {name} (d int, v int) cluster by (d)")
    random.seed(11)
    order = list(range(rows))
    random.shuffle(order)
    s.execute(f"insert into {name} values " + ",".join(
        f"({d}, {d % 7})" for d in order))
    return s.catalog.table("test", name)


def test_refused_while_statement_reader_counted():
    s = Session(device="cpu")
    t = _clustered(s)
    s.catalog.reader_enter()
    try:
        assert t.recluster() is False
    finally:
        s.catalog.reader_exit()
    assert t.recluster() is True
    assert t.clustered_rows == t.n


def test_refused_while_scan_open_across_statements():
    """An open scan executor (a cursor outliving its statement) holds the
    permute off until close()."""
    s = Session(device="cpu", chunk_capacity=1 << 9)
    t = _clustered(s)
    root = build_executor(s._plan_select(parse("select d, v from rg")[0]))
    root.open(ExecContext(chunk_capacity=1 << 9, device=s.device))
    try:
        assert root.next() is not None
        assert s.catalog._open_scans >= 1
        assert t.recluster() is False
    finally:
        root.close()
    assert s.catalog._open_scans == 0
    assert t.recluster() is True


def test_scan_trigger_defers_to_statement_boundary():
    """A scan only notes the due permute; it runs at the end of the
    noticing statement, with the reader registry quiescent."""
    s = Session(device="cpu", chunk_capacity=1 << 10)
    s.execute("set tidb_tpu_segment_rows = 1024")
    t = _clustered(s)
    assert s.query("select count(*) from rg") == [(2000,)]
    assert t.clustered_rows == t.n == 2000
    assert not s.catalog._recluster_pending
    assert (np.diff(t.data["d"][:t.n].astype(np.int64)) >= 0).all()
    assert s.catalog._open_scans == 0 and not s.catalog._stmt_readers


# -- the compaction worker ---------------------------------------------------------

def _mk_store(n=4096, seg_rows=1024, delta_rows=1024):
    s = Session(device="cpu")
    # the session's columnar config pinned to the store's: a query's scan
    # re-applies the session values through store_for
    s.execute(f"set tidb_tpu_segment_rows = {seg_rows}")
    s.execute(f"set tidb_tpu_segment_delta_rows = {delta_rows}")
    s.execute("create table p (a int, b int)")
    t = s.catalog.table("test", "p")
    t.insert_columns({"a": np.arange(n, dtype=np.int64),
                      "b": np.arange(n, dtype=np.int64) % 7})
    store = store_for(t, segment_rows=seg_rows, delta_rows=delta_rows,
                      compaction=True)
    store.refresh(force=True)
    assert store.segments
    return s, t, store


def _append_delta(t, n0, count):
    t.insert_columns({"a": np.arange(n0, n0 + count, dtype=np.int64),
                      "b": np.zeros(count, dtype=np.int64)})


def test_background_rebuild_installs_and_counts():
    s, t, store = _mk_store()
    b0 = st.COMPACTION_TOTAL["background"]
    _append_delta(t, 4096, 1024)
    store.refresh()
    assert store._compact_pending
    assert compaction.default_worker().drain(10)
    assert not store._compact_pending
    assert st.COMPACTION_TOTAL["background"] == b0 + 1
    assert store.covered == 4096 + 1024
    assert s.query("select count(*), sum(b) from p") == \
        [(5120, sum(i % 7 for i in range(4096)))]


def test_rebuild_failpoint_fails_closed_data_exact():
    """compact.rebuild fires inside the background build: the job counts
    as failed, the pending mark clears, and scans stay exact off the
    raw-merge delta; the next refresh succeeds."""
    s, t, store = _mk_store()
    f0 = st.COMPACTION_TOTAL["failed"]
    _append_delta(t, 4096, 1024)
    with fp.failpoint("compact.rebuild", times=1):
        store.refresh()
        assert compaction.default_worker().drain(10)
    assert st.COMPACTION_TOTAL["failed"] == f0 + 1
    assert not store._compact_pending
    assert store.covered == 4096
    assert s.query("select count(*) from p") == [(5120,)]
    store.refresh()
    assert compaction.default_worker().drain(10)
    assert store.covered == 5120


def test_scan_racing_cutover_keeps_retired_segment():
    """A scan plans the trailing partial segment, then the background
    cutover retires it: it stays alive until the pin closes."""
    _s, t, store = _mk_store(n=4096 + 512)
    assert store.segments[-1].rows < store.segment_rows
    pin = ScanPin(store, MemTracker("stmt", spill_root=True))
    segs, _pruned, _cov = store.plan_scan([], pin=pin)
    partial = store.segments[-1]
    assert partial in segs and partial.refs >= 1
    _append_delta(t, 4096 + 512, 1024)
    store.refresh()
    assert compaction.default_worker().drain(10)
    assert partial not in store.segments
    assert partial.retired and partial in store._retired
    assert partial.data is not None
    pin.close()
    assert partial not in store._retired
    assert all(seg.refs == 0 and seg.pins == 0 for seg in store.segments)
    assert store.covered == 4096 + 512 + 1024


def test_worker_death_degrades_inline():
    """A dead worker refuses the job; the store rebuilds inline on the
    statement path, counted as inline_fallback, with the same data."""
    s, t, store = _mk_store()
    compaction.default_worker().stop()
    i0 = st.COMPACTION_TOTAL["inline_fallback"]
    _append_delta(t, 4096, 1024)
    store.refresh()
    assert not store._compact_pending
    assert st.COMPACTION_TOTAL["inline_fallback"] == i0 + 1
    assert store.covered == 5120
    assert s.query("select count(*) from p") == [(5120,)]


def test_reference_worker_left_as_found(jax_worker_isolated):
    """The flag on in both packages over the same appends: the same rows,
    each package's own worker doing the folds."""
    js, ps = JaxSession(), Session(device="cpu")
    for s in (js, ps):
        s.execute("set tidb_tpu_segment_rows = 1024")
        s.execute("set tidb_tpu_segment_delta_rows = 1024")
        s.execute("create table w (a int, b int)")
        s.execute("insert into w values " + ",".join(
            f"({i}, {i % 5})" for i in range(3000)))
        s.query("select count(*) from w")
        s.execute("insert into w values " + ",".join(
            f"({i}, {i % 5})" for i in range(3000, 4500)))
        s.query("select count(*) from w")
    from tidb_tpu.columnar import compaction as jc

    assert jc.default_worker().drain(10) and compaction.default_worker().drain(10)
    sql = "select b, count(*), sum(a) from w group by b order by b"
    _same(ps.query(sql), js.query(sql), ordered=True)
