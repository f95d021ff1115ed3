"""Pessimistic locking reads through the port (tidb_tpu_torch on the CPU)
against the JAX package: SELECT ... FOR UPDATE / FOR SHARE / LOCK IN SHARE
MODE, the row locks they register, the writers they refuse, NOWAIT and
the lock-wait timeout, and the release of a crashed transaction's locks
by lock resolution (cases from tests/test_locking_reads.py).

The sequential cases run one script on three sessions per package (one
catalog each): every statement succeeds in both or is refused in both
alike, every query gives the same rows, and the row-lock maps agree. The
threaded cases join every thread with a timeout and assert the join
happened, so a hang fails its test instead of running out the suite's
clock."""

import threading
import time

import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.catalog import Catalog as JaxCatalog
from tidb_tpu_torch.errors import ExecutionError, WriteConflictError
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.catalog import Catalog

from test_torch_session import _same, reference_witness_paused  # noqa: F401

_SETUP = [(0, "create table acct (id bigint primary key, v bigint)"),
          (0, "insert into acct values (1, 100), (2, 100)")]


def _sessions(n=3):
    jcat, pcat = JaxCatalog(), Catalog()
    js = [JaxSession(catalog=jcat) for _ in range(n)]
    for s in js:
        s.execute("set tidb_tpu_compaction = 0")
    return js, [Session(catalog=pcat, device="cpu") for _ in range(n)]


def _outcome(s, sql):
    try:
        rs = s.execute(sql)
        return ("rows", None if rs is None else rs.rows)
    except Exception as e:  # noqa: BLE001 — the class is the result
        return ("error", type(e).__name__, str(e))


def run_script(script):
    """(session index, sql) steps on both packages; returns the sessions."""
    js, ps = _sessions()
    for i, sql in _SETUP + script:
        want, got = _outcome(js[i], sql), _outcome(ps[i], sql)
        if want[0] == "rows" and got[0] == "rows" and want[1] is not None:
            _same(got[1], want[1], ordered=False)
        else:
            assert got == want, (i, sql, got, want)
        jt = js[0].catalog.table("test", "acct")
        pt = ps[0].catalog.table("test", "acct")
        assert {r: sorted(h.values()) for r, h in pt.row_locks.items()} == \
            {r: sorted(h.values()) for r, h in jt.row_locks.items()}, (i, sql)
    return js, ps


CASES = {
    "parse_forms": [(0, "select v from acct where id = 1 for update"),
                    (0, "select v from acct where id = 1 for share"),
                    (0, "select v from acct where id = 1 lock in share mode")],
    "release_on_commit": [(1, "begin"), (1, "select * from acct where id = 1 for update"),
                          (2, "update acct set v = 1 where id = 1"), (1, "commit"),
                          (2, "update acct set v = 1 where id = 1"),
                          (0, "select * from acct")],
    "release_on_rollback": [(1, "begin"), (1, "select * from acct for update"),
                            (1, "rollback"), (2, "update acct set v = 3")],
    "for_update_blocks_writer": [
        (1, "begin"), (1, "select * from acct where id = 1 for update"),
        (2, "update acct set v = 0 where id = 1"), (2, "delete from acct where id = 1"),
        (2, "update acct set v = 55 where id = 2"), (1, "commit"),
        (2, "update acct set v = 0 where id = 1"), (0, "select v from acct")],
    "share_locks_compatible": [
        (1, "begin"), (2, "begin"), (1, "select * from acct where id = 1 for share"),
        (2, "select * from acct where id = 1 for share"),
        (0, "update acct set v = 0 where id = 1"),
        (0, "select * from acct where id = 1 for update nowait"),
        (1, "commit"), (2, "commit"), (0, "update acct set v = 0 where id = 1")],
    "share_then_upgrade": [
        (1, "begin"), (1, "select * from acct where id = 2 for share"),
        (1, "select * from acct where id = 2 for update"),
        (2, "select * from acct where id = 2 for share nowait"), (1, "rollback")],
    "nowait_fails_fast": [
        (1, "begin"), (1, "select * from acct where id = 1 for update"), (2, "begin"),
        (2, "select * from acct where id = 1 for update nowait"),
        (2, "select * from acct where id = 2 for update nowait"),
        (1, "rollback"), (2, "rollback")],
    "sees_latest_not_snapshot": [
        (1, "begin"), (1, "select v from acct where id = 1"),
        (2, "update acct set v = 42 where id = 1"), (1, "select v from acct where id = 1"),
        (1, "select v from acct where id = 1 for update"), (1, "commit")],
    "sees_own_update": [
        (1, "begin"), (1, "update acct set v = 250 where id = 1"),
        (1, "select v from acct where id = 1 for update"), (1, "commit"),
        (0, "select v from acct where id = 1")],
    "hides_own_delete": [
        (1, "begin"), (1, "delete from acct where id = 2"),
        (1, "select id from acct for update"), (1, "rollback"), (0, "select id from acct")],
    "insert_then_locks_new_row": [
        (1, "begin"), (1, "insert into acct values (3, 300)"),
        (1, "select v from acct where id = 3 for update"),
        (2, "update acct set v = 1 where id = 3"), (1, "commit"),
        (2, "update acct set v = 1 where id = 3"), (0, "select * from acct")],
    "uncommitted_write_blocks_lock": [
        (1, "begin"), (1, "update acct set v = 9 where id = 1"),
        (2, "select * from acct where id = 1 for update nowait"), (1, "commit"),
        (2, "select * from acct where id = 1 for update nowait")],
    "join_locks_both_tables": [
        (0, "create table hold (id bigint primary key, amt bigint)"),
        (0, "insert into hold values (1, 5), (2, 6)"), (1, "begin"),
        (1, "select acct.v, hold.amt from acct join hold on acct.id = hold.id "
            "where acct.id = 2 for update"),
        (2, "update hold set amt = 0 where id = 2"),
        (2, "update hold set amt = 0 where id = 1"), (1, "commit"),
        (2, "update hold set amt = 0 where id = 2"), (0, "select * from hold")],
    "derived_table_refused": [(0, "select * from (select v from acct) d for update")],
    "union_refused": [(0, "select v from acct union select v from acct for update")],
    "autocommit_checks_without_registering": [
        (1, "begin"), (1, "select * from acct where id = 1 for update"),
        (2, "select * from acct where id = 2 for update"),
        (2, "select * from acct where id = 1 for update nowait"), (1, "commit")],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_locking_reads_match_reference(name):
    run_script(CASES[name])


def test_crashed_transactions_locks_release_on_resolve():
    """A transaction that holds FOR UPDATE locks and dies after its abort
    decision leaves them behind; the next statement's lock resolution
    releases them (Catalog.resolve_locks), in both packages."""
    out = []
    for js_or_ps in _sessions():
        s0, a, b = js_or_ps
        for _i, sql in _SETUP:
            s0.execute(sql)
        t = s0.catalog.table("test", "acct")
        a.execute("begin")
        a.execute("select * from acct where id = 1 for update")
        held = dict(t.row_locks)
        a.catalog.abort_point(a.txn.marker)
        a.txn = None  # the session died with its transaction
        b.execute("update acct set v = 7 where id = 1")
        out.append((len(held), dict(t.row_locks), b.query("select v from acct where id = 1"),
                    s0.catalog.has_stale_txns()))
    assert out[0] == out[1] == (1, {}, [(7,)], False)


def test_wait_timeout():
    _js, (s0, a, b) = _sessions()
    for _i, sql in _SETUP:
        s0.execute(sql)
    b.execute("set innodb_lock_wait_timeout = 1")
    a.execute("begin")
    a.execute("select * from acct where id = 1 for update")
    b.execute("begin")
    t0 = time.monotonic()
    with pytest.raises(ExecutionError, match="Lock wait timeout"):
        b.execute("select * from acct where id = 1 for update")
    assert 0.9 <= time.monotonic() - t0 < 4.0
    a.execute("rollback")
    b.execute("rollback")


def test_waiter_proceeds_after_release():
    """A locking read waits for the writer's commit and then reads the
    latest committed value."""
    _js, (s0, a, b) = _sessions()
    for _i, sql in _SETUP:
        s0.execute(sql)
    a.execute("begin")
    a.execute("update acct set v = 77 where id = 1")
    got, errors = [], []

    def reader():
        try:
            b.execute("begin")
            got.append(b.query("select v from acct where id = 1 for update")[0][0])
            b.execute("commit")
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    th = threading.Thread(target=reader)
    th.start()
    time.sleep(0.2)
    a.execute("commit")
    th.join(timeout=10)
    assert not th.is_alive(), "the locking read never returned"
    assert not errors, errors
    assert got == [77]


def test_transfers_correct_with_for_update():
    """Read-compute-write transfers between two accounts from four
    threads: with FOR UPDATE every update lands (balances return to 100
    each after equal numbers of opposite transfers)."""
    _js, (s0, _a, _b) = _sessions()
    for _i, sql in _SETUP:
        s0.execute(sql)
    cat, errors = s0.catalog, []

    def worker(tid):
        s = Session(catalog=cat, device="cpu")
        src = 1 if tid % 2 == 0 else 2
        for _ in range(3):
            for _attempt in range(300):
                try:
                    s.execute("begin")
                    b1 = s.query("select v from acct where id = 1 for update")[0][0]
                    b2 = s.query("select v from acct where id = 2 for update")[0][0]
                    nb1, nb2 = (b1 - 7, b2 + 7) if src == 1 else (b1 + 7, b2 - 7)
                    s.execute(f"update acct set v = {nb1} where id = 1")
                    s.execute(f"update acct set v = {nb2} where id = 2")
                    s.execute("commit")
                    break
                except (WriteConflictError, ExecutionError):
                    try:
                        s.execute("rollback")
                    except Exception:  # noqa: BLE001 — already rolled back
                        pass
                    time.sleep(0.01)
            else:
                errors.append(f"worker {tid}: retries exhausted")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads), "a transfer thread hung"
    assert not errors, errors
    assert s0.query("select v from acct order by id") == [(100,), (100,)]
    assert not cat.table("test", "acct").row_locks
