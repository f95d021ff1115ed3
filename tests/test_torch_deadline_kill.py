"""Statement deadlines and KILL in the port (Session.cancel_reason wired
into every ExecContext as cancel_check; Session._execute_timed), held to
the reference's on the local cases of tests/test_deadline_kill.py: the
same statements raise the same typed errors (QueryTimeoutError 3024,
QueryKilledError 1317) with the same messages.

Then a kill inside a fused fragment, with the device buffer cache on and
the prefetch thread staging: the statement raises the typed error, the
prefetch thread is joined, the cache holds no partial staging of the
table, and the next statements' rows equal the reference's."""

import threading
import time

import numpy as np
import pytest
import torch

from tidb_tpu.session import Session as JaxSession
from tidb_tpu_torch.errors import QueryKilledError, QueryTimeoutError
from tidb_tpu_torch.executor import pipeline as pl
from tidb_tpu_torch.session import Session
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

torch.set_num_threads(1)

_JOIN = ("select count(*) from big b1 join big b2 on b1.a = b2.a "
         "where b1.a % 3 = 0")


def _err(e):
    return type(e).__name__, e.code, str(e)


def _big(make, n=200_000, **kw):
    s = make(**kw)
    s.execute("create table big (a bigint)")
    s.catalog.table("test", "big").insert_columns(
        {"a": np.arange(n, dtype=np.int64)})
    return s


def _both(fn):
    want = fn(lambda **kw: JaxSession(**kw))
    got = fn(lambda **kw: Session(device="cpu", **kw))
    assert got == want
    return got


def test_max_execution_time_is_3024_and_per_statement():
    def run(make):
        s = _big(make, chunk_capacity=1024)
        s.execute("set max_execution_time = 1")  # 1 ms: must expire
        try:
            s.query(_JOIN)
        except Exception as e:  # noqa: BLE001 — compared
            err = _err(e)
        else:
            err = None
        s.execute("set max_execution_time = 0")  # 0 disarms
        return err, s.query("select count(*) from big"), s._stmt_deadline

    err, rows, armed = _both(run)
    assert err == ("QueryTimeoutError", 3024, "Query execution was "
                   "interrupted, maximum statement execution time exceeded")
    assert rows == [(200_000,)] and armed is None


def test_deadline_scoped_per_statement():
    def run(make):
        s = make()
        s.execute("set max_execution_time = 5000")
        return s.query("select 1 + 1"), s._stmt_deadline

    assert _both(run) == ([(2,)], None)


def _kill_during(make, kill_sql_of, n=400_000):
    """Run the self-join on one session while another kills it; the
    victim's statement is seen running first (deterministic landing)."""
    s = _big(make, n=n, chunk_capacity=2048)
    killer = make(catalog=s.catalog)
    box = {}

    def victim():
        try:
            box["rows"] = s.query(
                "select count(*) from big t1 join big t2 on t1.a = t2.a")
        except Exception as e:  # noqa: BLE001 — compared
            box["err"] = _err(e)

    th = threading.Thread(target=victim)
    th.start()
    deadline = time.time() + 30
    while s._current_sql is None and time.time() < deadline:
        time.sleep(0.001)
    killer.execute(kill_sql_of(s.conn_id))
    th.join(60)
    assert not th.is_alive()
    try:
        after = s.query("select 1")
    except Exception as e:  # noqa: BLE001 — compared
        after = _err(e)
    return box, after


def test_kill_query_is_1317_and_one_shot():
    box, after = _both(lambda make: _kill_during(
        make, lambda cid: f"kill query {cid}"))
    assert box == {"err": ("QueryKilledError", 1317,
                           "Query execution was interrupted (KILL)")}
    assert after == [(1,)]


def test_kill_connection_is_1317_and_permanent():
    box, after = _both(lambda make: _kill_during(
        make, lambda cid: f"kill {cid}"))
    assert box == {"err": ("QueryKilledError", 1317,
                           "connection was killed")}
    assert after == ("QueryKilledError", 1317, "connection was killed")


def test_kill_unknown_thread_id():
    def run(make):
        try:
            make().execute("kill query 987654")
        except Exception as e:  # noqa: BLE001 — compared
            return _err(e)

    assert _both(run)[0] == "ExecutionError"


# -- a kill inside a fused fragment ---------------------------------------

_Q = "select sum(a), count(*) from fk where a % 7 = 1"


def _fused_session():
    s = Session(device="cpu", chunk_capacity=4096)
    s.execute("set tidb_tpu_segment_rows = 1024")
    s.execute("set tidb_tpu_compaction = 0")
    s.execute("set tidb_tpu_pipeline_prefetch_depth = 2")
    s.execute("create table fk (a bigint)")
    s.catalog.table("test", "fk").insert_columns(
        {"a": np.arange(64 * 1024, dtype=np.int64)})
    return s


def _reference_rows():
    js = JaxSession(chunk_capacity=4096)
    js.execute("set tidb_tpu_compaction = 0")
    js.execute("create table fk (a bigint)")
    js.catalog.table("test", "fk").insert_columns(
        {"a": np.arange(64 * 1024, dtype=np.int64)})
    return js.query(_Q)


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "tidb-torch-prefetch" and t.is_alive()]


@pytest.mark.parametrize("how", ["kill", "deadline"])
def test_kill_inside_fused_fragment_leaves_engine_whole(monkeypatch, how):
    s = _fused_session()
    table = s.catalog.table("test", "fk")
    pl.DEVICE_CACHE.clear()
    pl.reset_counters()
    stage = pl.ChunkPrefetcher._stage
    calls = [0]

    def staging(self, job):
        calls[0] += 1
        if calls[0] == 3:  # mid-fragment: two batches already staged
            if how == "kill":
                s._kill_query = True
            else:
                s._stmt_deadline = time.monotonic() - 1.0
        return stage(self, job)

    monkeypatch.setattr(pl.ChunkPrefetcher, "_stage", staging)
    want_err = QueryKilledError if how == "kill" else QueryTimeoutError
    with pytest.raises(want_err) as ei:
        s.query(_Q)
    assert type(ei.value) is want_err  # typed, not wrapped
    assert pl.PIPELINE_FUSED_TOTAL["agg"] == 1  # it ran fused
    assert pl.PIPELINE_PREFETCH_TOTAL["cancelled"] + \
        pl.PIPELINE_PREFETCH_TOTAL["wait"] + pl.PIPELINE_PREFETCH_TOTAL["hit"] >= 1
    assert not _prefetch_threads()  # joined, not abandoned
    # nothing cut short was cached: no entry of this table at all
    assert all(e["table"] is not table
               for e in pl.DEVICE_CACHE._entries.values())
    monkeypatch.setattr(pl.ChunkPrefetcher, "_stage", stage)
    want = _reference_rows()
    assert s.query(_Q) == want  # the next statement is right
    # ...and its full staging is cached whole: a warm run hits it
    hits = pl.DEVICE_CACHE_TOTAL["hit"]
    assert s.query(_Q) == want
    assert pl.DEVICE_CACHE_TOTAL["hit"] == hits + 1
    assert not _prefetch_threads()
