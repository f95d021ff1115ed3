"""The port's serving tier (tidb_tpu_torch/serving: the admission-
controlled statement scheduler, the cross-session micro-batcher, the SLO
store) held to the reference's: the cases of tests/test_serving.py and
tests/test_slo.py run against both packages, each session of the port on
the CPU, and their outcomes compare. Batched results equal singleton
results (also with a member killed or expired during the gather), the
admission and queue-timeout errors carry the reference's types, codes
and messages, and drain finishes queued statements.

Every thread join and socket here has a timeout; every scheduler and
server is shut down in a finally block."""

import threading
import time
import types

import pytest
import torch

import tidb_tpu.errors as jerr
import tidb_tpu.serving as jserving
import tidb_tpu.serving.slo as jslo
import tidb_tpu.session as jsession
import tidb_tpu.storage.catalog as jcatalog
import tidb_tpu.utils.memory as jmemory
import tidb_tpu.utils.metrics as jmetrics
import tidb_tpu_torch.errors as perr
import tidb_tpu_torch.serving as pserving
import tidb_tpu_torch.serving.slo as pslo
import tidb_tpu_torch.session as psession
import tidb_tpu_torch.storage.catalog as pcatalog
import tidb_tpu_torch.utils.memory as pmemory
import tidb_tpu_torch.utils.metrics as pmetrics
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

torch.set_num_threads(1)

POINT = "select c, k from t where id = ?"
N_ROWS = 200


def _pkg(name):
    """One package's entry points, with the port's sessions and
    schedulers on the CPU."""
    if name == "jax":
        return types.SimpleNamespace(
            Session=jsession.Session, Catalog=jcatalog.Catalog,
            Scheduler=jserving.StatementScheduler, E=jerr, M=jmetrics,
            OOM=jmemory.QueryOOMError, slo=jslo)
    return types.SimpleNamespace(
        Session=lambda **kw: psession.Session(device="cpu", **kw),
        Catalog=pcatalog.Catalog,
        Scheduler=lambda cat, **kw: pserving.StatementScheduler(
            cat, device="cpu", **kw),
        E=perr, M=pmetrics, OOM=pmemory.QueryOOMError, slo=pslo)


PKGS = ("jax", "torch")


def _both(scenario, **kw):
    """Run `scenario` against both packages; the port's outcome must
    equal the reference's."""
    out = {p: scenario(_pkg(p), **kw) for p in PKGS}
    assert out["torch"] == out["jax"]
    return out["torch"]


def make_cat(P, **globals_):
    cat = P.Catalog()
    boot = P.Session(catalog=cat)
    boot.execute("set global tidb_slow_log_threshold = 300000")
    boot.execute("set global tidb_trace_sample_rate = 0")
    boot.execute("set global tidb_tpu_compaction = 0")
    for k, v in globals_.items():
        boot.execute(f"set global {k} = {v}")
    boot.execute(
        "create table t (id bigint primary key, k bigint, c varchar(32))")
    boot.execute("insert into t values " + ",".join(
        f"({i},{i % 7},'c-{i:05d}')" for i in range(N_ROWS)))
    boot.execute("analyze table t")
    return cat, boot


def _err(e):
    return None if e is None else (type(e).__name__, getattr(e, "code", None),
                                   str(e))


def _join(threads, timeout=30):
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)


def scenario_interleaved(P):
    """8 clients x 12 interleaved keys (hits, shared hot keys, misses)
    through a wide gather window: every result equals the serial oracle,
    and coalescing engaged."""
    cat, boot = make_cat(P, tidb_tpu_batch_window_us=100_000,
                         tidb_tpu_max_batch_size=8)
    sched = P.Scheduler(cat, workers=4)
    c0 = P.M.BATCH_COALESCE_TOTAL.value()

    def keys_of(ci):
        return [(ci * 37 + i * 11) % N_ROWS if i % 5 else 7
                for i in range(10)] + [N_ROWS + 123, N_ROWS + 456]

    try:
        sessions = [P.Session(catalog=cat) for _ in range(8)]
        sids = [s.prepare(POINT)[0] for s in sessions]
        sched.submit_prepared(sessions[0], sids[0], [0])  # plan-cache fill
        results = [[] for _ in sessions]
        errors = []
        barrier = threading.Barrier(len(sessions))

        def client(ci):
            barrier.wait(10)
            for key in keys_of(ci):
                try:
                    results[ci].append(sched.submit_prepared(
                        sessions[ci], sids[ci], [key]).rows)
                except Exception as e:  # noqa: BLE001 — asserted below
                    errors.append(e)

        ts = [threading.Thread(target=client, args=(ci,))
              for ci in range(len(sessions))]
        for t in ts:
            t.start()
        _join(ts)
    finally:
        sched.shutdown()
    assert not errors, errors
    oracle = P.Session(catalog=cat)
    osid, _ = oracle.prepare(POINT)
    for ci in range(8):
        assert results[ci] == [oracle.execute_prepared(osid, [k]).rows
                               for k in keys_of(ci)]
    assert P.M.BATCH_COALESCE_TOTAL.value() - c0 >= 8
    lp = [s.query("select @@last_plan_from_cache")[0][0] for s in sessions]
    return results, lp


def test_batched_results_equal_singleton():
    results, lp = _both(scenario_interleaved)
    assert results[0][-1] == [] and set(lp) == {1}


def scenario_member_kill(P):
    """KILL QUERY lands on a member while its group gathers: that member
    alone gets the typed kill error; its batchmates' rows are exact."""
    cat, boot = make_cat(P, tidb_tpu_batch_window_us=400_000,
                         tidb_tpu_max_batch_size=3)
    sched = P.Scheduler(cat, workers=2)
    try:
        sa, sb, sc = (P.Session(catalog=cat) for _ in range(3))
        sids = [s.prepare(POINT)[0] for s in (sa, sb, sc)]
        sched.submit_prepared(sa, sids[0], [0])
        ma = sched.batcher.try_join(sa, sids[0], [10], None)
        mb = sched.batcher.try_join(sb, sids[1], [11], None)
        boot.execute(f"kill query {sa.conn_id}")
        mc = sched.batcher.try_join(sc, sids[2], [12], None)
        for m in (ma, mb, mc):
            assert m.done.wait(10)
        out = [(_err(m.exc), None if m.exc else m.result.rows)
               for m in (ma, mb, mc)]
        # one-shot: the killed session keeps working
        out.append(sched.submit_prepared(sa, sids[0], [10]).rows)
        return out
    finally:
        sched.shutdown()


def scenario_member_deadline(P):
    cat, boot = make_cat(P, tidb_tpu_batch_window_us=400_000,
                         tidb_tpu_max_batch_size=2)
    sched = P.Scheduler(cat, workers=2)
    try:
        sa, sb = P.Session(catalog=cat), P.Session(catalog=cat)
        sids = [sa.prepare(POINT)[0], sb.prepare(POINT)[0]]
        sched.submit_prepared(sa, sids[0], [0])
        ma = sched.batcher.try_join(sa, sids[0], [20],
                                    time.monotonic() - 0.01)
        mb = sched.batcher.try_join(sb, sids[1], [21], None)
        for m in (ma, mb):
            assert m.done.wait(10)
        return [(_err(m.exc), None if m.exc else m.result.rows)
                for m in (ma, mb)]
    finally:
        sched.shutdown()


def scenario_member_quota(P):
    """A member whose session memory quota is absurdly small gets the
    typed OOM; its batchmate survives."""
    cat, boot = make_cat(P, tidb_tpu_batch_window_us=200_000,
                         tidb_tpu_max_batch_size=2)
    sched = P.Scheduler(cat, workers=2)
    box = {}
    try:
        se, sf = P.Session(catalog=cat), P.Session(catalog=cat)
        se.execute("set tidb_tpu_mem_quota_session = 1")
        sids = {id(se): se.prepare(POINT)[0], id(sf): sf.prepare(POINT)[0]}
        warm = P.Session(catalog=cat)
        sched.submit_prepared(warm, warm.prepare(POINT)[0], [0])
        barrier = threading.Barrier(2)

        def client(sess, tag, key):
            barrier.wait(10)
            try:
                box[tag] = sched.submit_prepared(sess, sids[id(sess)],
                                                 [key]).rows
            except Exception as e:  # noqa: BLE001 — asserted below
                box[tag] = type(e).__name__

        ts = [threading.Thread(target=client, args=(se, "e", 30)),
              threading.Thread(target=client, args=(sf, "f", 31))]
        for t in ts:
            t.start()
        _join(ts, 15)
    finally:
        sched.shutdown()
    return box


@pytest.mark.parametrize("scenario", [scenario_member_kill,
                                      scenario_member_deadline,
                                      scenario_member_quota],
                         ids=["kill", "deadline", "quota"])
def test_member_leaves_batch_typed(scenario):
    out = _both(scenario)
    assert out  # the reference's outcomes, held above


def _blocked(P, cat, submit_second, drain=None, settle_inside=True):
    """One worker parked on the catalog lock the test holds: s1 is
    claimed, s2 queued; `submit_second` decides what happens next.
    `settle_inside`: s2 finishes (typed) while the lock is still held."""
    sched = P.Scheduler(cat, workers=1)
    s1, s2 = P.Session(catalog=cat), P.Session(catalog=cat)
    box = {}

    def second():
        try:
            box["b"] = sched.submit_query(s2, "select 2").rows
        except Exception as e:  # noqa: BLE001 — compared below
            box["b"] = _err(e)

    try:
        with cat.lock:
            t1 = threading.Thread(target=lambda: box.update(
                a=sched.submit_query(s1, "select 1").rows))
            t1.start()
            deadline = time.time() + 5
            while time.time() < deadline:  # s1 claimed
                if sched.stats_dict()["queue_depth"] == 0:
                    break
                time.sleep(0.002)
            t2 = threading.Thread(target=second)
            t2.start()
            while time.time() < deadline:  # s2 queued
                if sched.stats_dict()["queue_depth"] == 1:
                    break
                time.sleep(0.002)
            box["third"] = submit_second(sched)
            if drain is not None:
                sched.shutdown(drain=drain, timeout=0.2)
            if settle_inside:
                t2.join(10)
        _join([t1, t2], 10)
    finally:
        sched.shutdown()
    st = sched.stats_dict()
    box["stats"] = (st["rejected"], st["timed_out"])
    return box


def scenario_queue_full(P):
    cat, _ = make_cat(P, tidb_tpu_sched_max_queue=1,
                      tidb_tpu_batch_window_us=0)

    def third(sched):
        try:
            sched.submit_query(P.Session(catalog=cat), "select 3")
        except Exception as e:  # noqa: BLE001 — compared
            return _err(e)

    return _blocked(P, cat, third, settle_inside=False)


def scenario_queue_timeout(P):
    cat, _ = make_cat(P, tidb_tpu_sched_queue_timeout_ms=120,
                      tidb_tpu_batch_window_us=0)
    return _blocked(P, cat, lambda sched: None)


def scenario_no_drain(P):
    cat, _ = make_cat(P, tidb_tpu_batch_window_us=0)
    return _blocked(P, cat, lambda sched: None, drain=False)


@pytest.mark.parametrize("scenario", [scenario_queue_full,
                                      scenario_queue_timeout,
                                      scenario_no_drain],
                         ids=["queue_full", "queue_timeout", "no_drain"])
def test_admission_errors_typed_as_reference(scenario):
    box = _both(scenario)
    assert box["a"] == [(1,)]


def scenario_drain(P):
    """shutdown(drain=True): every admitted statement finishes, later
    submissions get the typed draining rejection, workers join."""
    cat, _ = make_cat(P, tidb_tpu_batch_window_us=0)
    sched = P.Scheduler(cat, workers=2)
    sessions = [P.Session(catalog=cat) for _ in range(6)]
    results, errors = [], []

    def client(s, i):
        try:
            results.append(sched.submit_query(s, f"select {i}").rows)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(type(e).__name__)

    ts = [threading.Thread(target=client, args=(s, i))
          for i, s in enumerate(sessions)]
    for t in ts:
        t.start()
    sched.shutdown(drain=True)
    _join(ts, 10)
    assert len(results) + len(errors) == 6
    assert set(errors) <= {"AdmissionRejectedError"}
    assert not any(w.is_alive() for w in sched._workers)
    with pytest.raises(P.E.AdmissionRejectedError, match="draining") as ei:
        sched.submit_query(sessions[0], "select 99")
    return _err(ei.value)


def test_drain_finishes_queued_statements():
    _both(scenario_drain)


def scenario_group_commit(P):
    """Autocommit point writes from concurrent sessions ride one
    group-commit window; the table ends as serial execution leaves it."""
    cat, boot = make_cat(P, tidb_tpu_batch_window_us=100_000,
                         tidb_tpu_max_batch_size=4)
    sched = P.Scheduler(cat, workers=2)
    sessions = [P.Session(catalog=cat) for _ in range(4)]
    barrier = threading.Barrier(4)
    errors = []

    def client(ci):
        barrier.wait(10)
        try:
            sched.submit_query(sessions[ci],
                               f"update t set k = k + {ci + 1} where id = {ci}")
            sched.submit_query(sessions[ci],
                               f"insert into t values ({1000 + ci}, {ci}, 'n{ci}')")
            sched.submit_query(sessions[ci], f"delete from t where id = {10 + ci}")
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    ts = [threading.Thread(target=client, args=(ci,)) for ci in range(4)]
    try:
        for t in ts:
            t.start()
        _join(ts)
    finally:
        sched.shutdown()
    assert not errors, errors
    return boot.query("select id, k, c from t where id < 20 or id >= 1000 "
                      "order by id")


def test_group_commit_equals_serial():
    _both(scenario_group_commit)


def scenario_slo(P):
    """The per-digest latency store: windows, percentiles, breaches and
    the shed ranking, fed the same observations in both packages."""
    store = P.slo.DigestLatencyStore(capacity=4)
    for i in range(40):
        store.observe("d-fast", "select ?", 0.001 * (1 + i % 3),
                      target_ms=50, capacity=4)
        store.observe("d-slow", "select sleep(?)", 0.2 + 0.001 * i,
                      target_ms=50, capacity=4)
    for k in range(6):  # LRU past capacity
        store.observe(f"d-{k}", f"q{k}", 0.01, target_ms=50, capacity=4)
    snap = store.stats_dict(10)
    for d in snap.get("digests", []):
        d.pop("last_seen", None)
    return snap, store.should_shed("d-slow"), store.should_shed("d-fast")


def test_slo_store_matches_reference():
    _both(scenario_slo)


def test_scheduler_stats_and_metrics_families():
    """The /scheduler payload and the serving metric families match the
    reference's keys and names."""
    keys = {}
    for p in PKGS:
        P = _pkg(p)
        cat, _ = make_cat(P, tidb_tpu_batch_window_us=0)
        sched = P.Scheduler(cat, workers=1)
        try:
            sched.submit_query(P.Session(catalog=cat), "select 1")
        finally:
            sched.shutdown()
        keys[p] = sorted(sched.stats_dict())
    assert keys["torch"] == keys["jax"]
    names = [m.name for m in (pmetrics.SCHED_QUEUE_DEPTH,
                              pmetrics.SCHED_ADMISSION_TOTAL,
                              pmetrics.BATCH_SIZE,
                              pmetrics.BATCH_COALESCE_TOTAL,
                              pmetrics.DML_BATCH_SIZE,
                              pmetrics.SLO_SHED_TOTAL)]
    assert names == [m.name for m in (jmetrics.SCHED_QUEUE_DEPTH,
                                      jmetrics.SCHED_ADMISSION_TOTAL,
                                      jmetrics.BATCH_SIZE,
                                      jmetrics.BATCH_COALESCE_TOTAL,
                                      jmetrics.DML_BATCH_SIZE,
                                      jmetrics.SLO_SHED_TOTAL)]
