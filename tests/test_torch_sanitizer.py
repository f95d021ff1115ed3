"""The port's runtime invariant sanitizer (tidb_tpu_torch/analysis/
sanitizer.py) on the CPU: the reference's detector tests
(tests/test_sanitizer.py) on the port, a parity test against the
reference, and a sanitized subset of the port's workloads.

Detectors: the lock-order witness (cycle-checked, diffed against the
static lock graph), MemTracker double-release and residual at
release()/detach(), ScanPin balance at statement end, the per-statement
host-sync budget (the port counts at `utils/dispatch.device_get`), the
shared-global witness (kept, with no site registered: the port has no
process-wide probe mode) and the wire witness (test_torch_wire_protocol).
"""

import threading

import numpy as np
import pytest

from test_torch_dcn import feedback_stores_cleared  # noqa: F401 (autouse)
from test_torch_session import reference_witness_paused  # noqa: F401
from tidb_tpu_torch.analysis import sanitizer as san
from tidb_tpu_torch.errors import SanitizerError
from tidb_tpu_torch.session import Session as PortSession
from tidb_tpu_torch.utils import dispatch
from tidb_tpu_torch.utils.memory import MemTracker


@pytest.fixture(autouse=True)
def clean_sanitizer():
    """Every test starts and ends with the port's sanitizer off and
    empty: its witness state is process-global by design."""
    san.disable()
    yield
    san.disable()


def Session(**kw):
    kw.setdefault("device", "cpu")
    return PortSession(**kw)


def sanitized_session(**kw):
    s = Session(**kw)
    s.execute("set tidb_tpu_sanitize = 1")
    return s


def findings(kind=None):
    fs = san.report()["findings"]
    return [f for f in fs if kind is None or f["kind"] == kind]


# ---------------------------------------------------------------------------
# lock-order witness
# ---------------------------------------------------------------------------


class TestLockWitness:
    def test_engine_locks_are_registered(self):
        from tidb_tpu_torch.columnar import store
        from tidb_tpu_torch.planner.feedback import PlanFeedbackStore
        from tidb_tpu_torch.serving.batcher import Batcher, BatchGroup
        from tidb_tpu_torch.serving.scheduler import StatementScheduler
        from tidb_tpu_torch.serving.slo import DigestLatencyStore
        from tidb_tpu_torch.storage.catalog import Catalog
        from tidb_tpu_torch.utils import memory

        cat = Catalog()
        assert isinstance(cat.lock, san.TrackedLock)
        assert isinstance(cat._readers_lock, san.TrackedLock)
        assert isinstance(memory._ACCOUNT_LOCK, san.TrackedLock)
        assert isinstance(cat.plan_cache.lock, san.TrackedLock)
        assert isinstance(store._CREATE_LOCK, san.TrackedLock)
        assert isinstance(PlanFeedbackStore().lock, san.TrackedLock)
        assert isinstance(DigestLatencyStore().lock, san.TrackedLock)
        sched = StatementScheduler(cat, workers=1)
        try:
            assert isinstance(sched._cv._lock, san.TrackedLock)
            assert isinstance(Batcher(sched)._lock, san.TrackedLock)
            assert isinstance(BatchGroup("k", None, 0.001, 4).cv._lock, san.TrackedLock)
        finally:
            sched.shutdown()

    def test_nested_acquisition_records_an_edge(self):
        san.enable()
        a = san.tracked_lock("TestW.a_lock")
        b = san.tracked_lock("TestW.b_lock")
        with a:
            with b:
                pass
        edges = san.lock_edges()
        assert "TestW.b_lock" in edges.get("TestW.a_lock", {}), edges

    def test_disabled_lock_records_nothing(self):
        a = san.tracked_lock("TestOff.a_lock")
        b = san.tracked_lock("TestOff.b_lock")
        with a:
            with b:
                pass
        assert not san.lock_edges()

    def test_runtime_cycle_is_a_fatal_finding(self):
        san.enable()
        a = san.tracked_lock("TestC.a_lock")
        b = san.tracked_lock("TestC.b_lock")

        def t1():
            with a:
                with b:
                    pass

        th = threading.Thread(target=t1)
        th.start()
        th.join(30)
        assert not th.is_alive()
        with b:
            with a:
                pass
        f = san.check_lock_cycle()
        assert f is not None and f.fatal
        assert "TestC.a_lock" in f.subject and "TestC.b_lock" in f.subject
        assert findings("lock-cycle")

    def test_cycle_fails_the_sanitized_statement(self):
        s = sanitized_session()
        s.execute("create table w (a int)")
        a = san.tracked_lock("TestS.a_lock")
        b = san.tracked_lock("TestS.b_lock")

        def t1():
            with a:
                with b:
                    pass

        th = threading.Thread(target=t1)
        th.start()
        th.join(30)
        with b:
            with a:
                pass
        with pytest.raises(SanitizerError, match="lock-cycle"):
            s.execute("select count(*) from w")

    def test_reentrant_acquisition_orders_nothing(self):
        """Re-acquiring an RLock this thread holds cannot wait: it adds
        no edge, so a -> b -> a on one thread is no cycle."""
        import threading as _th

        san.enable()
        a = san.tracked_lock("TestR.a_lock", _th.RLock)
        b = san.tracked_lock("TestR.b_lock")
        with a:
            with b:
                with a:
                    pass
        edges = san.lock_edges()
        assert edges == {"TestR.a_lock": {"TestR.b_lock": "MainThread"}}, edges
        assert san.check_lock_cycle() is None

    def test_two_instances_of_one_name_nest_with_an_edge(self):
        """Two instances of one lock name (two stores' SegmentStore._lock)
        can wait on each other, ABBA across threads: nesting them records
        the self-edge that a reentrant re-acquisition does not, and the
        witness reports it as a cycle."""
        san.enable()
        a1 = san.tracked_lock("TestI.store_lock", threading.RLock)
        a2 = san.tracked_lock("TestI.store_lock", threading.RLock)
        with a1:
            with a1:
                pass
            assert not san.lock_edges()
            with a2:
                pass
        edges = san.lock_edges()
        assert edges == {"TestI.store_lock": {"TestI.store_lock": "MainThread"}}, edges
        f = san.check_lock_cycle()
        assert f is not None and f.fatal
        assert f.subject == "TestI.store_lock -> TestI.store_lock"

    def test_recluster_at_statement_end_is_no_cycle(self):
        """The first statement over a fresh CLUSTER BY table re-sorts it at
        its end: run_pending_reclusters holds Catalog.lock, then
        Catalog.readers, and Table.recluster re-enters Catalog.lock. The
        reference's witness records that re-entry as an edge and fails
        the statement with a lock-cycle; the port's runs clean."""
        from tidb_tpu.analysis import sanitizer as jsan
        from tidb_tpu.errors import SanitizerError as JaxSanitizerError
        from tidb_tpu.session import Session as JaxSession
        from tidb_tpu.storage.catalog import Catalog as JaxCatalog
        from tidb_tpu.storage.tpch import load_tpch as jax_load_tpch
        from tidb_tpu_torch.storage.catalog import Catalog
        from tidb_tpu_torch.storage.tpch import load_tpch
        from tidb_tpu_torch.storage.tpch_queries import Q

        setup = ("set global tidb_tpu_segment_rows = 1024",
                 "set global tidb_tpu_compaction = 0")
        cat = Catalog()
        load_tpch(cat, sf=0.01)
        for sql in setup:
            Session(catalog=cat).execute(sql)
        s = sanitized_session(catalog=cat)
        assert s.query(Q["q1"][0]) == Session(catalog=cat).query(Q["q1"][0])
        assert not [f for f in findings() if f["fatal"]], findings()
        assert "Catalog.readers" in san.lock_edges().get("Catalog.lock", {})

        was_on = jsan.enabled()
        try:
            jcat = JaxCatalog()
            jax_load_tpch(jcat, sf=0.01)
            for sql in setup + ("set global tidb_device_engine_mode = 'force'",):
                JaxSession(catalog=jcat).execute(sql)
            js = JaxSession(catalog=jcat)
            js.execute("set tidb_tpu_sanitize = 1")
            with pytest.raises(JaxSanitizerError, match="lock-cycle"):
                js.query(Q["q1"][0])
        finally:
            jsan.disable()
            if was_on:
                jsan.enable()

    def test_diff_static_surfaces_novel_edges(self):
        san.enable()
        a = san.tracked_lock("TestD.a_lock")
        b = san.tracked_lock("TestD.b_lock")
        with a:
            with b:
                pass
        d = san.diff_static()
        assert any(x == "TestD.a_lock" and y == "TestD.b_lock"
                   for x, y, _thr in d["novel"]), d["novel"]

    def test_static_graph_is_the_ports(self):
        import os

        from tidb_tpu_torch.analysis.lock_discipline import static_lock_edges

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        static = static_lock_edges(root)
        assert isinstance(static, dict)


class TestGateSemantics:
    def test_env_gate_honors_falsy_strings(self, monkeypatch):
        from tidb_tpu_torch.session.sysvars import _sanitizer_env_gate

        for v in ("", "0", "false", "OFF", "no"):
            monkeypatch.setenv("TIDB_TPU_SANITIZE", v)
            assert san.env_gate() is False, v
            assert _sanitizer_env_gate() is False, v
        for v in ("1", "true", "ON", "yes"):
            monkeypatch.setenv("TIDB_TPU_SANITIZE", v)
            assert san.env_gate() is True, v
            assert _sanitizer_env_gate() is True, v

    def test_release_pops_held_across_disable(self):
        san.enable()
        a = san.tracked_lock("TestP.a_lock")
        a.acquire()
        san.disable(reset_state=False)
        a.release()
        san.enable()
        b = san.tracked_lock("TestP.b_lock")
        with b:
            pass
        edges = san.lock_edges()
        assert "TestP.b_lock" not in edges.get("TestP.a_lock", {}), edges

    def test_gate_is_sticky_until_disable(self):
        s = sanitized_session()
        s.execute("create table g1 (a int)")
        s.execute("select count(*) from g1")
        assert san.enabled()
        s.execute("set tidb_tpu_sanitize = 0")
        s.execute("select count(*) from g1")
        assert san.enabled()  # per process, like the reference
        san.disable()
        assert not san.enabled()

    def test_enable_patches_nothing_of_torch(self):
        import torch

        before = (torch.Tensor.item, torch.Tensor.cpu, torch.Tensor.numpy,
                  torch.Tensor.tolist)
        san.enable()
        assert (torch.Tensor.item, torch.Tensor.cpu, torch.Tensor.numpy,
                torch.Tensor.tolist) == before


# ---------------------------------------------------------------------------
# tracker balance
# ---------------------------------------------------------------------------


class TestTrackerWitness:
    def test_double_release_is_typed(self):
        san.enable()
        t = MemTracker("mutant")
        t.consume(100)
        t.release(150)
        fs = findings("tracker-double-release")
        assert fs and fs[0]["fatal"] and fs[0]["subject"] == "mutant"

    def test_balanced_tracker_is_clean(self):
        san.enable()
        t = MemTracker("ok")
        t.consume(100)
        t.release(100)
        assert not findings("tracker-double-release")

    def test_detach_residual_is_a_leak_witness(self):
        san.enable()
        parent = MemTracker("parent")
        child = MemTracker("child", parent=parent)
        child.consume(4096)
        child.detach()
        fs = findings("tracker-residual")
        assert fs and not fs[0]["fatal"] and "4096" in fs[0]["detail"]
        assert parent.consumed == 0

    def test_clean_detach_no_witness(self):
        san.enable()
        parent = MemTracker("parent")
        child = MemTracker("child", parent=parent)
        child.consume(64)
        child.release(64)
        child.detach()
        assert not findings("tracker-residual")


# ---------------------------------------------------------------------------
# pin balance at statement end
# ---------------------------------------------------------------------------


def _store_and_tracker():
    from tidb_tpu_torch.columnar.store import store_for

    s = Session()
    s.execute("create table p (a int, b int)")
    t = s.catalog.table("test", "p")
    n = 4096
    t.insert_columns({"a": np.arange(n, dtype=np.int64),
                      "b": np.arange(n, dtype=np.int64) % 7})
    store = store_for(t, segment_rows=1024)
    store.refresh(force=True)
    assert store is not None and store.segments
    return store, MemTracker("stmt", spill_root=True)


class TestPinWitness:
    def test_leaked_pin_is_fatal_at_statement_end(self):
        from tidb_tpu_torch.columnar.store import ScanPin

        store, tracker = _store_and_tracker()
        san.enable()
        scope = san.statement_begin()
        pin = ScanPin(store, tracker)
        out = san.statement_end(scope)
        leaks = [f for f in out if f.kind == "pin-leak"]
        assert leaks and leaks[0].fatal
        assert "ScanPin" in leaks[0].subject
        pin.close()

    def test_closed_pin_is_clean(self):
        from tidb_tpu_torch.columnar.store import ScanPin

        store, tracker = _store_and_tracker()
        san.enable()
        scope = san.statement_begin()
        pin = ScanPin(store, tracker)
        segs, _pruned, _cov = store.plan_scan([], pin=pin)
        for seg in segs:
            pin.touch(seg)
        pin.close()
        out = san.statement_end(scope)
        assert not [f for f in out if f.kind == "pin-leak"], out
        assert all(seg.pins == 0 for seg in store.segments)
        assert tracker.consumed == 0


# ---------------------------------------------------------------------------
# host-sync budget, counted at dispatch.device_get
# ---------------------------------------------------------------------------


class TestSyncBudget:
    def test_unit_budget_breach(self):
        san.enable()
        scope = san.statement_begin(sync_budget=2)
        for _ in range(3):
            san.count_sync()
        out = san.statement_end(scope)
        hits = [f for f in out if f.kind == "host-sync-budget"]
        assert hits and hits[0].fatal and "3" in hits[0].detail

    def test_device_get_counts_one_round_trip_a_call(self):
        import torch

        san.enable()
        scope = san.statement_begin()
        f0 = dispatch.fetch_count()
        got = dispatch.device_get({"a": torch.arange(4), "b": [torch.ones(2, 3)],
                                   "c": 5, "d": np.zeros(2)})
        dispatch.device_get(torch.tensor(7))
        out = san.statement_end(scope)
        assert scope.syncs == 2 and dispatch.fetch_count() - f0 == 2
        assert not out
        assert got["a"].tolist() == [0, 1, 2, 3] and got["b"][0].shape == (2, 3)
        assert got["c"] == 5 and isinstance(got["d"], np.ndarray)

    def test_statement_over_budget_raises_typed(self):
        s = sanitized_session(chunk_capacity=1 << 12)
        s.execute("create table g (a int, b int)")
        t = s.catalog.table("test", "g")
        n = 10000
        t.insert_columns({"a": np.arange(n, dtype=np.int64),
                          "b": np.arange(n, dtype=np.int64) % 13})
        s.execute("set tidb_device_engine_mode = 'off'")  # the host groupby
        sql = "select b % 7 as grp, sum(a) from g group by grp order by grp"
        ok = s.query(sql)
        assert len(ok) == 7
        s.execute("set tidb_tpu_sanitize_sync_budget = 1")
        with pytest.raises(SanitizerError, match="host-sync-budget"):
            s.query(sql)


# ---------------------------------------------------------------------------
# shared-global witness: kept, no site registered in the port
# ---------------------------------------------------------------------------


class TestGlobalWitness:
    def test_write_during_statement_is_fatal(self):
        san.enable()
        scope = san.statement_begin()
        san.note_global_write("fixture.global", "x")
        out = san.statement_end(scope)
        hits = [f for f in out if f.kind == "shared-global-write"]
        assert hits and hits[0].fatal and hits[0].subject == "fixture.global"

    def test_write_outside_statements_is_allowed(self):
        san.enable()
        san.note_global_write("fixture.global", "x")
        assert not findings("shared-global-write")

    def test_probe_mode_rides_the_statement(self):
        """Sessions with divergent probe modes answer the same join; no
        process global exists to race (the port threads the mode through
        ExecContext), so nothing is witnessed."""
        s1 = sanitized_session()
        s1.execute("create table j1 (k int primary key, v int)")
        s1.execute("insert into j1 values " + ",".join(
            f"({i},{i * 3})" for i in range(64)))
        s1.execute("create table j2 (k int, w int)")
        s1.execute("insert into j2 values " + ",".join(
            f"({i % 64},{i})" for i in range(256)))
        s2 = sanitized_session(catalog=s1.catalog.base)
        s1.execute("set tidb_tpu_join_probe_mode = 'xla'")
        s2.execute("set tidb_tpu_join_probe_mode = 'off'")
        q = "select sum(j1.v + j2.w) from j1 join j2 on j1.k = j2.k"
        assert s1.query(q) == s2.query(q)
        assert not findings("shared-global-write")


# ---------------------------------------------------------------------------
# parity with the reference: a leaked pin fails the statement in both
# ---------------------------------------------------------------------------


def _leaky_scan(mod_store, session):
    """Run a scan whose pins are never closed (ScanPin.close a no-op for
    the statement); returns the error it raised, and closes the pins."""
    leaked = []
    real = mod_store.ScanPin.close
    mod_store.ScanPin.close = lambda self: leaked.append(self)
    try:
        try:
            session.query("select sum(b) from lk where a >= 100")
            err = None
        except Exception as e:  # noqa: BLE001 — each package's own error type
            err = e
    finally:
        mod_store.ScanPin.close = real
        for pin in leaked:
            pin.close()
    return err, len(leaked)


class TestParity:
    N = 20000

    def _load(self, s):
        s.execute("set tidb_tpu_segment_rows = 2048")
        s.execute("create table lk (a bigint, b bigint)")
        t = s.catalog.table("test", "lk")
        t.insert_columns({"a": np.arange(self.N, dtype=np.int64),
                          "b": np.arange(self.N, dtype=np.int64) % 11})
        assert s.query("select sum(b) from lk where a >= 100")  # build the store
        s.execute("set tidb_tpu_sanitize = 1")

    def test_leaked_pin_raises_in_both_packages(self):
        from tidb_tpu.analysis import sanitizer as jsan
        from tidb_tpu.columnar import store as jstore
        from tidb_tpu.session import Session as JaxSession
        from tidb_tpu_torch.columnar import store as pstore

        was_on = jsan.enabled()
        try:
            js = JaxSession(chunk_capacity=1 << 12)
            self._load(js)
            jerr, jn = _leaky_scan(jstore, js)
        finally:
            jsan.disable()
            if was_on:
                jsan.enable()
        ps = Session(chunk_capacity=1 << 12)
        self._load(ps)
        perr, pn = _leaky_scan(pstore, ps)
        assert jn and pn
        assert type(jerr).__name__ == type(perr).__name__ == "SanitizerError", (jerr, perr)
        assert "pin-leak" in str(jerr) and "pin-leak" in str(perr)

    def test_the_same_statement_closed_runs_clean(self):
        ps = Session(chunk_capacity=1 << 12)
        self._load(ps)
        want = int((np.arange(self.N)[100:] % 11).sum())
        assert int(ps.query("select sum(b) from lk where a >= 100")[0][0]) == want
        assert not [f for f in findings() if f["fatal"]]


# ---------------------------------------------------------------------------
# a sanitized subset of the port's workloads: exact results, no finding
# ---------------------------------------------------------------------------


class TestSanitizedSubset:
    def _bulk(self, s, name, n, mod=97):
        s.execute(f"create table {name} (a int, b int, c int)")
        t = s.catalog.table("test", name)
        rng = np.random.default_rng(7)
        t.insert_columns({
            "a": np.arange(n, dtype=np.int64),
            "b": np.asarray(rng.integers(0, mod, n), dtype=np.int64),
            "c": np.asarray(rng.integers(0, 1000, n), dtype=np.int64)})
        return t

    def test_columnar_scan_prune_and_spill_clean(self):
        s = sanitized_session(chunk_capacity=1 << 12)
        s.execute("set tidb_tpu_segment_rows = 2048")
        t = self._bulk(s, "t", 10000)
        a = t.data["a"][:10000]
        b = t.data["b"][:10000]
        got = s.query("select sum(b) from t where a >= 8000")[0][0]
        assert int(got) == int(b[(a >= 8000)].sum())
        s.execute("set global tidb_tpu_device_buffer_cache_bytes = 0")
        s.execute("set tidb_mem_quota_query = 16777216")
        for _ in range(2):
            got = s.query("select sum(b) from t where a >= 2000")[0][0]
            assert int(got) == int(b[(a >= 2000)].sum())

    def test_pipeline_fused_agg_clean(self):
        s = sanitized_session(chunk_capacity=1 << 12)
        t = self._bulk(s, "t", 20000, mod=13)
        b = t.data["b"][:20000]
        c = t.data["c"][:20000]
        rows = s.query("select b, count(*), sum(c) from t group by b order by b")
        assert len(rows) == 13
        for grp, cnt, total in rows:
            m = b == int(grp)
            assert int(cnt) == int(m.sum())
            assert int(total) == int(c[m].sum())

    def test_join_clean(self):
        s = sanitized_session()
        self._bulk(s, "f", 5000, mod=50)
        s.execute("create table d (k int primary key, name int)")
        s.execute("insert into d values " + ",".join(
            f"({i},{i * 7})" for i in range(50)))
        t = s.catalog.table("test", "f")
        b = t.data["b"][:5000]
        got = s.query("select sum(d.name + f.b) from f join d on f.b = d.k")[0][0]
        assert int(got) == int(sum(b * 7 + b))

    def test_tpch_five_and_workloads_clean(self):
        """Q1, Q6, Q3, Q5 and Q18 at SF0.01 and SSB's flights at a small
        scale factor, sanitized: the rows of an unsanitized run, counted
        syncs, no fatal finding."""
        from tidb_tpu_torch.storage.ssb import SSB_QUERIES, load_ssb
        from tidb_tpu_torch.storage.tpch_queries import Q

        plain = Session()
        plain.load_tpch(0.01)
        load_ssb(plain.catalog.base, sf=0.002, seed=11)
        want = {q: plain.query(Q[q][0]) for q in ("q1", "q6", "q3", "q5", "q18")}
        want.update({q: plain.query(SSB_QUERIES[q]) for q in ("q1.1", "q2.1", "q3.1",
                                                             "q4.1")})
        s = sanitized_session(catalog=plain.catalog.base)
        for q in want:
            sql = Q[q][0] if q in Q else SSB_QUERIES[q]
            f0 = dispatch.fetch_count()
            assert s.query(sql) == want[q], q
            assert dispatch.fetch_count() - f0 >= 1, q
        assert not [f for f in findings() if f["fatal"]], findings()

    def test_serving_concurrent_clean(self):
        from tidb_tpu_torch.serving import StatementScheduler
        from tidb_tpu_torch.storage.catalog import Catalog

        cat = Catalog()
        boot = Session(catalog=cat)
        boot.execute("set global tidb_tpu_sanitize = 1")
        boot.execute("set global tidb_slow_log_threshold = 300000")
        boot.execute("set global tidb_trace_sample_rate = 0")
        boot.execute("set global tidb_tpu_batch_window_us = 20000")
        boot.execute("create table t (id bigint primary key, v bigint)")
        boot.execute("insert into t values " + ",".join(
            f"({i},{i * 11})" for i in range(100)))
        sched = StatementScheduler(cat, workers=3)
        try:
            sessions = [Session(catalog=cat) for _ in range(4)]
            sids = [s.prepare("select v from t where id = ?")[0] for s in sessions]
            results = [[] for _ in range(4)]
            errors = []
            barrier = threading.Barrier(4)

            def client(ci):
                barrier.wait(30)
                for i in range(12):
                    key = (ci * 17 + i * 5) % 100
                    try:
                        rs = sched.submit_prepared(sessions[ci], sids[ci], [key])
                        results[ci].append((key, rs.rows))
                    except Exception as e:  # noqa: BLE001 — asserted below
                        errors.append(e)

            threads = [threading.Thread(target=client, args=(ci,)) for ci in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
            assert not any(th.is_alive() for th in threads)
            assert not errors, errors
            for ci in range(4):
                for key, rows in results[ci]:
                    assert rows == [(key * 11,)]
        finally:
            sched.shutdown()
        assert not [f for f in findings() if f["fatal"]], findings()
