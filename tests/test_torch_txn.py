"""Transactions through the port (tidb_tpu_torch on the CPU) against the
JAX package: BEGIN / START TRANSACTION / COMMIT / ROLLBACK, the
`autocommit` sysvar, snapshot isolation between two sessions on one
catalog, the write-conflict error, MVCC GC, and two-phase commit crashed
at each of its failpoints and finished by `Catalog.resolve_locks` (cases
from tests/test_txn2pc.py).

Each case runs the same statements on a reference pair of sessions and
a port pair; every read and every refusal must agree. A failpoint is
armed in both packages at once (each has its own registry) and disarmed
on the way out."""

import contextlib

import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.catalog import Catalog as JaxCatalog
from tidb_tpu.utils import failpoint as jax_fp
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.catalog import Catalog
from tidb_tpu_torch.utils import failpoint as fp

from test_torch_keys import both, same_rows
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)


def _sessions(n=2):
    """n reference sessions on one catalog, n port sessions on another."""
    jcat, pcat = JaxCatalog(), Catalog()
    js = [JaxSession(catalog=jcat) for _ in range(n)]
    for s in js:
        s.execute("set tidb_tpu_compaction = 0")
    return js, [Session(catalog=pcat, device="cpu") for _ in range(n)]


@contextlib.contextmanager
def armed(name, **kw):
    """Arm failpoint `name` in both packages; always disarm both."""
    jax_fp.enable(name, **kw)
    fp.enable(name, **kw)
    try:
        yield
    finally:
        jax_fp.disable(name)
        fp.disable(name)


def crash_both(js, ps, sql):
    """`sql` must die at the armed failpoint in both engines; the
    session's view of its transaction dies with the crash."""
    for s, err in ((js, jax_fp.FailpointError), (ps, fp.FailpointError)):
        with pytest.raises(err):
            s.execute(sql)
        s.txn = None


# -- one session: BEGIN / COMMIT / ROLLBACK / autocommit ---------------------

_SEED = ["create table t (id bigint primary key, v bigint, s varchar(8))",
         "insert into t values (1, 10, 'a'), (2, 20, 'b'), (3, 30, 'c')"]

# (name, statements); both sessions read after every statement
_SCRIPTS = [
    ("commit", ["begin", "insert into t values (4, 40, 'd')",
                "update t set v = v + 1 where id <= 2", "delete from t where id = 3",
                "commit"]),
    ("rollback", ["begin", "insert into t values (4, 40, 'd')",
                  "update t set v = v + 1", "delete from t where id = 3",
                  "rollback"]),
    ("start_transaction", ["start transaction", "update t set s = 'z' where id = 2",
                           "commit"]),
    ("begin_commits_open_txn", ["begin", "insert into t values (5, 50, 'e')",
                                "begin", "rollback"]),
    ("own_writes_then_rewrite", ["begin", "insert into t values (6, 60, 'f')",
                                 "update t set v = 61 where id = 6",
                                 "delete from t where id = 6",
                                 "insert into t values (6, 62, 'g')", "commit"]),
    ("autocommit_off_rollback", ["set autocommit = 0",
                                 "insert into t values (7, 70, 'h')", "rollback",
                                 "set autocommit = 1"]),
    ("autocommit_off_commit", ["set autocommit = 0",
                               "update t set v = 0 where id = 1", "commit",
                               "set autocommit = 1"]),
    ("enabling_autocommit_commits", ["set autocommit = 0",
                                     "delete from t where id = 2",
                                     "set autocommit = 1", "rollback"]),
    ("truncate_then_reinsert", ["truncate table t", "insert into t values (1, 1, 'x')"]),
]


@pytest.mark.parametrize("name,script", _SCRIPTS, ids=[c[0] for c in _SCRIPTS])
def test_single_session_transactions_match_reference(name, script):
    (js, jo), (ps, po) = _sessions()
    for q in _SEED:
        both(js, ps, q)
    for q in script:
        both(js, ps, q)
        # the writer sees its own provisional rows; the other session sees
        # committed-latest only
        same_rows(js, ps, "select * from t")
        _same_other(jo, po)
    assert ps.txn is None and js.txn is None


def _same_other(jo, po):
    from test_torch_session import _same

    _same(po.query("select * from t"), jo.query("select * from t"), False)


# -- two sessions: snapshot isolation and conflicts ---------------------------

def test_snapshot_isolation_between_sessions():
    (j1, j2), (p1, p2) = _sessions()
    for q in _SEED:
        both(j1, p1, q)
    both(j1, p1, "begin")
    same_rows(j1, p1, "select sum(v) from t")
    # another session commits changes after the snapshot was taken
    both(j2, p2, "update t set v = 100 where id = 1")
    both(j2, p2, "insert into t values (9, 90, 'n')")
    both(j2, p2, "delete from t where id = 3")
    # the open transaction still reads its snapshot
    assert p1.query("select sum(v) from t") == [(60,)]
    same_rows(j1, p1, "select * from t")
    same_rows(j2, p2, "select * from t")
    both(j1, p1, "commit")
    same_rows(j1, p1, "select * from t")
    assert p1.query("select sum(v) from t") == [(210,)]


@pytest.mark.parametrize("second", [
    "update t set v = 2 where id = 1",
    "delete from t where id = 1",
], ids=["update", "delete"])
def test_write_conflict_on_a_locked_row(second):
    (j1, j2), (p1, p2) = _sessions()
    for q in _SEED:
        both(j1, p1, q)
    both(j1, p1, "begin")
    both(j2, p2, "begin")
    both(j1, p1, "update t set v = 1 where id = 1")  # takes the row lock
    assert both(j2, p2, second) == "WriteConflictError"
    both(j1, p1, "commit")
    both(j2, p2, "rollback")
    same_rows(j1, p1, "select * from t")


def test_write_conflict_on_a_row_committed_after_the_snapshot():
    (j1, j2), (p1, p2) = _sessions()
    for q in _SEED:
        both(j1, p1, q)
    both(j1, p1, "begin")
    same_rows(j1, p1, "select v from t where id = 2")
    both(j2, p2, "update t set v = 99 where id = 2")
    assert both(j1, p1, "update t set v = v + 1 where id = 2") == "WriteConflictError"
    both(j1, p1, "rollback")
    same_rows(j1, p1, "select * from t")


def test_insert_of_a_key_another_txn_holds_is_refused():
    (j1, j2), (p1, p2) = _sessions()
    for q in _SEED:
        both(j1, p1, q)
    both(j1, p1, "begin")
    both(j1, p1, "insert into t values (8, 80, 'p')")
    assert both(j2, p2, "insert into t values (8, 81, 'q')") == "ExecutionError"
    both(j1, p1, "commit")
    same_rows(j2, p2, "select * from t")


# -- MVCC GC -------------------------------------------------------------------

def test_auto_gc_compacts_after_a_big_delete():
    (js, _jo), (ps, _po) = _sessions()
    both(js, ps, "create table g (id bigint primary key, v bigint)")
    both(js, ps, "insert into g values " + ",".join(
        f"({i}, {i % 13})" for i in range(6000)))
    pt = ps.catalog.table("test", "g")
    epoch = pt.data_epoch
    both(js, ps, "delete from g where id >= 500")  # 5,500 dead: auto-GC
    jt = js.catalog.table("test", "g")
    assert pt.n == jt.n == 500 and pt.data_epoch == epoch + 1
    same_rows(js, ps, "select v, count(*) from g group by v")
    same_rows(js, ps, "select v from g where id = 499")
    both(js, ps, "update g set v = -1 where id < 10")
    assert ps.catalog.gc() == js.catalog.gc() == {"test.g": 10}
    same_rows(js, ps, "select * from g")


# -- two-phase commit crashes ---------------------------------------------------

def _two_table_txn(s):
    for q in ("create table a (x bigint)", "create table b (y bigint)",
              "insert into a values (0)", "insert into b values (0)", "begin",
              "insert into a values (1)", "insert into b values (2)",
              "delete from b where y = 0"):
        s.execute(q)


@pytest.mark.parametrize("point,decided", [
    ("2pc.before_prewrite", False),
    ("2pc.after_prewrite_one", False),
    ("2pc.before_commit_point", False),
    ("2pc.after_commit_point", True),
    ("2pc.before_secondary", True),
])
def test_commit_crash_is_atomic_after_resolve(point, decided):
    (js, jr), (ps, pr) = _sessions()
    _two_table_txn(js)
    _two_table_txn(ps)
    with armed(point):
        crash_both(js, ps, "commit")
    ps.catalog.resolve_locks()
    js.catalog.resolve_locks()
    for sql in ("select x from a", "select y from b"):
        same_rows(jr, pr, sql)
    assert sorted(pr.query("select x from a")) == ([(0,), (1,)] if decided else [(0,)])
    assert not ps.catalog._open_txns and not ps.catalog.has_stale_txns()


def test_crash_between_secondaries_commits_everything():
    (js, jr), (ps, pr) = _sessions()
    _two_table_txn(js)
    _two_table_txn(ps)
    with armed("2pc.before_secondary", nth=2):
        crash_both(js, ps, "commit")
    assert ps.catalog.resolve_locks() == js.catalog.resolve_locks() == 1
    for sql in ("select x from a", "select y from b"):
        same_rows(jr, pr, sql)
    assert sorted(pr.query("select y from b")) == [(2,)]


@pytest.mark.parametrize("point", ["2pc.after_abort_point", "2pc.before_rollback_one"])
def test_rollback_crash_is_finished_by_resolve(point):
    (js, jr), (ps, pr) = _sessions()
    _two_table_txn(js)
    _two_table_txn(ps)
    with armed(point):
        crash_both(js, ps, "rollback")
    assert ps.catalog.resolve_locks() == js.catalog.resolve_locks() == 1
    for sql in ("select x from a", "select y from b"):
        same_rows(jr, pr, sql)
    assert pr.query("select y from b") == [(0,)]


def test_undecided_commit_failure_releases_locks():
    (js, j2), (ps, p2) = _sessions()
    for q in _SEED:
        both(js, ps, q)
    both(js, ps, "begin")
    both(js, ps, "update t set v = 20 where id = 1")
    with armed("2pc.before_commit_point"):
        for s, err in ((js, jax_fp.FailpointError), (ps, fp.FailpointError)):
            with pytest.raises(err):
                s.execute("commit")
    assert not ps.catalog._open_txns, "the marker must not pin the safepoint"
    both(j2, p2, "update t set v = 30 where id = 1")  # no leaked lock
    same_rows(j2, p2, "select * from t")


def test_conflict_with_a_crashed_txn_resolves_and_retries():
    (j1, j2), (p1, p2) = _sessions()
    for q in _SEED:
        both(j1, p1, q)
    both(j1, p1, "begin")
    both(j1, p1, "update t set v = 20 where id = 1")
    with armed("2pc.before_secondary"):
        crash_both(j1, p1, "commit")
    # the stale marker blocks the write; the resolve-lock retry clears it
    both(j2, p2, "update t set v = 30 where id = 1")
    same_rows(j2, p2, "select * from t")


def test_reader_resolves_a_crashed_decided_commit():
    (js, j2), (ps, p2) = _sessions()
    for q in _SEED:
        both(js, ps, q)
    both(js, ps, "create table other (x bigint)")
    tb = ps.catalog.table("test", "other")
    tb_v = tb.version
    with armed("2pc.after_commit_point"):
        for s, err in ((js, jax_fp.FailpointError), (ps, fp.FailpointError)):
            with pytest.raises(err):
                s.execute("update t set v = 99 where id = 1")
    assert ps.catalog.has_stale_txns()
    # a pure read on another session resolves the residue first
    same_rows(j2, p2, "select v from t where id = 1")
    assert p2.query("select v from t where id = 1") == [(99,)]
    assert not ps.catalog.has_stale_txns()
    assert tb.version == tb_v  # a table without residue keeps its version
