"""Chaos on the port's DCN tier, held to the reference's outcomes.

A subset of the reference's chaos grids (tests/test_chaos_dcn.py and
test_chaos_sharding.py): each fault is armed in one package's failpoint
registry at a time (the two registries are separate), the same workload
runs on a port fleet and on a reference fleet, and both must end the
same way — the no-fault rows, or the same typed error — and leave no
cursor, cancel token, staged shuffle or prepared 2PC behind. Workers run
in-process so a failpoint reaches both sides of the wire."""

import socket
import threading
import time

import numpy as np
import pytest
import torch

import tidb_tpu.parallel.dcn as jdcn
import tidb_tpu.utils.failpoint as jfp
import tidb_tpu_torch.parallel.dcn as pdcn
import tidb_tpu_torch.utils.failpoint as pfp
from tidb_tpu.errors import TiDBTPUError as JaxTiDBError
from tidb_tpu_torch.errors import QueryTimeoutError, TiDBTPUError
from test_torch_dcn import (  # noqa: F401 (autouse)
    feedback_stores_cleared, make_cluster, start_workers)
from test_torch_session import reference_witness_paused  # noqa: F401

torch.set_num_threads(1)

N_ROWS = 600
PAGE = 32

QUERIES = {
    "group_agg": ("select grp, count(*) as n, sum(v) as s from c "
                  "group by grp order by grp"),
    "scan": "select k, v from c order by k",
}
FAULTS = [
    ("dcn.coord.send", dict(exc=ConnectionError, times=1)),
    ("dcn.coord.recv", dict(exc=ConnectionError, times=1)),
    ("dcn.coord.fetch", dict(exc=ConnectionError, times=1)),
    ("dcn.worker.handle", dict(times=1)),
    ("dcn.worker.partial", dict(times=1)),
    ("dcn.worker.page", dict(times=1)),
]

# what a typed failure may be, per package (the failpoints' own error
# class included: it stands in for a crash)
_TYPED = {pdcn: (TiDBTPUError, ConnectionError, OSError, pfp.FailpointError),
          jdcn: (JaxTiDBError, ConnectionError, OSError, jfp.FailpointError)}
_FP = {pdcn: pfp, jdcn: jfp}


def kill_worker(w):
    w._running = False
    try:
        w._sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    w._sock.close()


def assert_clean(workers, cl):
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if all(not w._cursors and not w._inflight
               and w._inbox.open_count() == 0 and w._txn2pc is None
               for w in workers):
            break
        time.sleep(0.02)
    assert all(not w._cursors for w in workers)
    assert all(not w._inflight for w in workers)
    assert all(w._inbox.open_count() == 0 for w in workers)
    assert all(w._shuffle_tracker.consumed == 0 for w in workers)
    assert all(w._txn2pc is None for w in workers)
    assert not cl._txn_pending and not cl._txn_decided


def partitioned(mod, replicas={0: 1, 1: 0}):
    ws = start_workers(mod, 2)
    cl = make_cluster(mod, ws, replicas=replicas, rpc_timeout_s=15.0,
                      connect_timeout_s=5.0)
    cl.PAGE_ROWS = PAGE
    cl.broadcast_exec("create table c (k bigint, grp bigint, v bigint)")
    half = N_ROWS // 2
    ks = np.arange(N_ROWS, dtype=np.int64)
    for w, sl in enumerate((slice(0, half), slice(half, N_ROWS))):
        cl.load_partition(w, "c", arrays={
            "k": ks[sl], "grp": ks[sl] % 7, "v": ks[sl] * 3}, db="test")
    return ws, cl


def sharded(mod, n_workers=3):
    ws = start_workers(mod, n_workers)
    cl = make_cluster(mod, ws, rpc_timeout_s=15.0, connect_timeout_s=5.0)
    cl.ddl("create table f (k bigint, v bigint) shard by hash(k) shards 6")
    cl.ddl("create table d (k bigint, grp bigint) shard by hash(grp) shards 3")
    ks = np.arange(400, dtype=np.int64)
    cl.load_sharded("f", arrays={"k": ks, "v": ks * 3})
    cl.load_sharded("d", arrays={"k": ks[::2], "grp": ks[::2] % 5})
    return ws, cl


def outcome(mod, fn):
    """'rows' and the rows, or the typed error's class name."""
    try:
        return ("rows", fn())
    except _TYPED[mod] as e:
        return (type(e).__name__, None)


# every (fault, query) pair but one: a lost response of a paged scan
# (dcn.coord.recv x scan) races the retry against the first attempt on
# the worker, and the reference can leak the first attempt's cursor
# there (its own grid's rare failure); the port's repair is pinned by
# test_retried_partial_keeps_the_newer_attempts_cursor below
GRID = [(f, q) for f, _kw in FAULTS for q in sorted(QUERIES)
        if (f, q) != ("dcn.coord.recv", "scan")]


@pytest.mark.parametrize("fault,qname", GRID)
def test_fault_grid_outcome_equals_reference(fault, qname):
    kwargs = dict(next(kw for n, kw in FAULTS if n == fault))
    sql = QUERIES[qname]
    got = {}
    for mod in (pdcn, jdcn):
        ws, cl = partitioned(mod)
        try:
            want = cl.query(sql)
            with _FP[mod].failpoint(fault, **kwargs):
                got[mod] = outcome(mod, lambda: cl.query(sql, timeout_s=30.0))
            if got[mod][0] == "rows":
                assert got[mod][1] == want, (mod.__name__, fault, qname)
            assert_clean(ws, cl)
            assert cl.query(sql) == want
            got[mod] = (got[mod][0], want)
        finally:
            cl.shutdown()
    assert got[pdcn] == got[jdcn]


def test_reconnect_refused_falls_to_replica():
    from tidb_tpu_torch.utils.metrics import DCN_FAILOVER_TOTAL

    ws, cl = partitioned(pdcn)
    try:
        sql = QUERIES["group_agg"]
        want = cl.query(sql)
        f0 = DCN_FAILOVER_TOTAL.value()
        with pfp.failpoint("dcn.coord.send", exc=ConnectionError, times=1):
            with pfp.failpoint("dcn.connect", exc=ConnectionError, times=1):
                assert cl.query(sql, timeout_s=30.0) == want
        assert DCN_FAILOVER_TOTAL.value() > f0
        assert_clean(ws, cl)
    finally:
        cl.shutdown()


def test_deadline_and_kill_propagate_typed():
    """A worker that stalls past the statement's budget: the coordinator
    raises QueryTimeoutError and the worker counts the expiry (or the
    cancel that the coordinator fanned out)."""
    ws, cl = partitioned(pdcn)
    try:
        before = [dict(w.stats) for w in ws]

        def stall():
            time.sleep(0.4)

        with pfp.failpoint("dcn.worker.partial", action=stall):
            with pytest.raises(QueryTimeoutError):
                cl.query(QUERIES["group_agg"], timeout_s=0.15)
        time.sleep(0.5)
        moved = sum(w.stats["deadline_exceeded"] + w.stats["cancelled"]
                    + w.stats["cancel_rpcs"] - b["deadline_exceeded"]
                    - b["cancelled"] - b["cancel_rpcs"]
                    for w, b in zip(ws, before))
        assert moved > 0
        assert_clean(ws, cl)
        stop = threading.Event()
        with pfp.failpoint("dcn.worker.partial", action=stall):
            t = threading.Timer(0.1, stop.set)
            t.start()
            with pytest.raises(TiDBTPUError):
                cl.query(QUERIES["group_agg"], cancel=stop.is_set)
        assert cl.query(QUERIES["scan"])[:2] == [(0, 0), (1, 3)]
    finally:
        cl.shutdown()


@pytest.mark.parametrize("fault", ["shuffle.send", "shuffle.recv"])
def test_shuffle_fault_outcome_equals_reference(fault):
    sql = ("select d.grp, count(*) as n, sum(f.v) as sv from f "
           "join d on f.k = d.k group by d.grp order by d.grp")
    got = {}
    for mod in (pdcn, jdcn):
        ws, cl = sharded(mod)
        try:
            want = cl.query(sql)
            with _FP[mod].failpoint(fault, times=1):
                got[mod] = outcome(mod, lambda: cl.query(sql))
            assert _FP[mod].hits(fault) > 0
            if got[mod][0] == "rows":
                assert got[mod][1] == want
            assert_clean(ws, cl)
            assert cl.query(sql) == want
            got[mod] = (got[mod][0], want)
        finally:
            cl.shutdown()
    assert got[pdcn] == got[jdcn]


def test_reshard_faults_abandon_or_fence_then_recover():
    ws, cl = sharded(pdcn)
    sql = "select count(*) as n, sum(v) as s from f"
    try:
        want = cl.query(sql)
        # the backfill failpoint fires inside a worker: it comes back
        # as that worker's typed error
        with pfp.failpoint("reshard.backfill", times=1):
            with pytest.raises(TiDBTPUError, match="reshard.backfill"):
                cl.reshard("alter table f shard by hash(k) shards 9")
        # abandoned before anything destructive: the old map serves
        assert cl.placement("f").shards == 6 and not cl._reshard_state
        assert cl.query(sql) == want
        with pfp.failpoint("reshard.cutover", times=1):
            with pytest.raises(pfp.FailpointError):
                cl.reshard("alter table f shard by hash(k) shards 9")
        # fenced on the stuck shard, typed, until recover_reshard()
        with pytest.raises(TiDBTPUError, match="recover_reshard"):
            cl.query(sql)
        assert list(cl.recover_reshard().values()) == ["resharded"]
        assert cl.placement("f").shards == 9
        assert cl.query(sql) == want
        assert_clean(ws, cl)
    finally:
        cl.shutdown()


def test_2pc_crash_between_prepare_and_commit_recovers():
    ws, cl = sharded(pdcn)
    try:
        with pfp.failpoint("2pc.prepare", times=1):
            with pytest.raises(pfp.FailpointError):
                cl.execute_dml("insert into f (k, v) values (9001, 1), (9002, 2)")
        assert cl.query("select count(*) as n from f where k > 9000") == [(0,)]
        with pfp.failpoint("2pc.commit", times=1):
            with pytest.raises(pfp.FailpointError):
                cl.execute_dml("insert into f (k, v) values (9001, 1), (9002, 2)")
        # the decision is recorded: a prepared participant refuses
        # foreign statements typed until recover_txns() lands it
        with pytest.raises(TiDBTPUError, match="pending"):
            cl.query("select count(*) as n from f")
        assert list(cl.recover_txns().values()) == ["committed"]
        assert cl.query("select count(*) as n from f where k > 9000") == [(2,)]
        assert_clean(ws, cl)
    finally:
        cl.shutdown()


def test_membership_join_fault_never_half_admits():
    ws, cl = sharded(pdcn, n_workers=2)
    joiner = start_workers(pdcn, 1)[0]
    sql = "select count(*) as n, sum(v) as s from f"
    try:
        want = cl.query(sql)
        with pfp.failpoint("member.join", times=1):
            with pytest.raises(pfp.FailpointError):
                cl.add_worker("127.0.0.1", joiner.port)
        assert len(cl._socks) == 2 and cl.query(sql) == want
        assert cl.add_worker("127.0.0.1", joiner.port) == 2
        assert cl.query(sql) == want
        cl.remove_worker(2)
        assert cl.query(sql) == want
    finally:
        cl.shutdown()
        kill_worker(joiner)


def test_owner_death_mid_shuffle_is_typed_and_leakless():
    ws, cl = sharded(pdcn)
    sql = ("select d.grp, count(*) as n, sum(f.v) as sv from f "
           "join d on f.k = d.k group by d.grp order by d.grp")
    try:
        with pfp.failpoint("shuffle.recv", action=lambda: kill_worker(ws[2]),
                           nth=1):
            with pytest.raises(_TYPED[pdcn]):
                cl.query(sql)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and any(
                w._inbox.open_count() for w in ws[:2]):
            time.sleep(0.02)
        assert all(w._inbox.open_count() == 0 for w in ws[:2])
        assert all(not w._cursors for w in ws[:2])
    finally:
        cl.shutdown()


def test_retried_partial_keeps_the_newer_attempts_cursor():
    """A partial whose response is lost (`dcn.coord.recv` after the send)
    is sent again under the same token. When the first attempt reaches
    the worker's executor after the retry did (its thread held back
    here by `dcn.worker.partial`), it used to evict the retry's cursor
    and pin its own, which nobody drains: the reference leaks that
    cursor until its TTL (its chaos grid's rare `dcn.coord.recv-scan`
    failure). The port keeps the newest attempt's cursor: the scan
    equals the no-fault rows and no cursor is left."""
    ws = start_workers(pdcn, 1)
    cl = make_cluster(pdcn, ws, rpc_timeout_s=15.0, connect_timeout_s=5.0)
    cl.PAGE_ROWS = PAGE
    sql = QUERIES["scan"]
    try:
        cl.broadcast_exec("create table c (k bigint, grp bigint, v bigint)")
        ks = np.arange(N_ROWS, dtype=np.int64)
        cl.load_partition(0, "c", arrays={"k": ks, "grp": ks % 7, "v": ks * 3})
        want = cl.query(sql)
        with pfp.failpoint("dcn.coord.recv", exc=ConnectionError, times=1), \
                pfp.failpoint("dcn.worker.partial", action=lambda: time.sleep(0.5),
                              nth=1):
            assert cl.query(sql, timeout_s=30.0) == want
        time.sleep(1.0)  # the held-back first attempt finishes
        assert_clean(ws, cl)
    finally:
        cl.shutdown()


def test_retry_that_enters_the_executor_first_keeps_its_cursor():
    """The retry's thread reaches Worker._partial_paged before the first
    attempt's (each connection has its own thread): the first attempt's
    thread is held in Worker._handle until the retry is inside, and the
    retry waits there until the first attempt is done. Ranked by arrival,
    the held-back first attempt took the newer rank, evicted nothing yet
    open and pinned its own cursor, and the retry, overtaken, returned
    one page with no cursor. Ranked by the coordinator's attempt number,
    the first attempt opens nothing and the retry's cursor drains: the
    scan equals the no-fault rows and no cursor is left. Events, not
    sleeps, order the threads."""
    ws = start_workers(pdcn, 1)
    w = ws[0]
    cl = make_cluster(pdcn, ws, rpc_timeout_s=15.0, connect_timeout_s=5.0)
    cl.PAGE_ROWS = PAGE
    sql = QUERIES["scan"]
    retry_in, first_done = threading.Event(), threading.Event()
    held = {"armed": False, "conn": None}
    real_handle = w._handle

    def handle(msg):
        if msg.get("cmd") != "partial_paged":
            return real_handle(msg)
        if not held["armed"]:
            # the no-fault run: the cluster's own connection's thread
            held["conn"] = threading.get_ident()
            return real_handle(msg)
        if threading.get_ident() != held["conn"]:
            return real_handle(msg)  # the retry, on its new connection
        assert retry_in.wait(10), "the retry never reached the executor"
        try:
            return real_handle(msg)
        finally:
            first_done.set()

    def retry_inside():
        retry_in.set()
        assert first_done.wait(10), "the first attempt never finished"

    w._handle = handle
    try:
        cl.broadcast_exec("create table c (k bigint, grp bigint, v bigint)")
        ks = np.arange(N_ROWS, dtype=np.int64)
        cl.load_partition(0, "c", arrays={"k": ks, "grp": ks % 7, "v": ks * 3})
        want = cl.query(sql)
        held["armed"] = True
        with pfp.failpoint("dcn.coord.recv", exc=ConnectionError, times=1), \
                pfp.failpoint("dcn.worker.partial", action=retry_inside, nth=1):
            assert cl.query(sql, timeout_s=30.0) == want
        assert retry_in.is_set() and first_done.is_set()
        assert_clean(ws, cl)
    finally:
        cl.shutdown()
