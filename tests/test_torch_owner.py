"""The port's DDL owner (tidb_tpu_torch/owner: the TTL-lease election, the
DDL job queue on the catalog and the worker that runs it) and the online
schema-change stages across instances, held to the reference's.

The cases of tests/test_owner.py run against the port (sessions on the
CPU). The `cluster`-fixture cases of tests/test_online_ddl.py, which the
reference runs over two DCN worker processes, run here in one process:
each "instance" is a Session on its own Catalog, and `_online_ddl` steps
every instance through the stages as the reference's
`Cluster.online_ddl` does (one all-instance barrier per stage, abort
everywhere on a failure). The same cases run through two reference
sessions too, and both packages' results must be equal."""

import threading
import time

import pytest
import torch

from tidb_tpu.owner import Election as JaxElection
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.catalog import Catalog as JaxCatalog
from tidb_tpu_torch.owner import DDLWorker, Election
from tidb_tpu_torch.parser import ast as A
from tidb_tpu_torch.parser import parse
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.catalog import Catalog
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.mark.parametrize("cls", [Election, JaxElection], ids=["port", "ref"])
def test_election_campaign_renew_resign_and_lapse(cls):
    t = [0.0]
    e = cls(ttl=10.0, clock=lambda: t[0])
    trail = [e.campaign("a"), e.campaign("b"), e.owner()]
    t[0] = 5.0
    trail += [e.renew("a"), e.renew("b")]
    e.resign("a")
    trail += [e.owner(), e.campaign("b")]
    t[0] = 16.0  # b's lease lapsed without renewal
    trail += [e.owner(), e.campaign("a"), e.renew("b")]
    assert trail == [True, False, "a", True, False, None, True,
                     None, True, False]


def _sess(cat):
    return Session(catalog=cat, device="cpu")


def test_ddl_runs_through_owner():
    cat = Catalog()
    w = DDLWorker(cat, "w1", poll=0.01, device="cpu")
    w.start()
    try:
        s = _sess(cat)
        s.execute("create table odd (x bigint)")
        s.execute("insert into odd values (5)")  # DML stays inline
        assert s.query("select x from odd") == [(5,)]
        assert cat._ddl_job_id >= 1  # the job went through the queue
        assert cat.ddl_owner.owner() == "w1"
        with pytest.raises(Exception, match="exists"):
            s.execute("create table odd (x bigint)")  # error reaches us
    finally:
        w.stop()
    assert not w._thread.is_alive()


def test_owner_death_fails_over():
    cat = Catalog()
    cat.ddl_owner = Election(ttl=0.3)
    a = DDLWorker(cat, "a", poll=0.01, device="cpu")
    b = DDLWorker(cat, "b", poll=0.01, device="cpu")
    a.start()
    deadline = time.time() + 5
    while cat.ddl_owner.owner() != "a" and time.time() < deadline:
        time.sleep(0.01)
    assert cat.ddl_owner.owner() == "a"
    b.start()
    try:
        # kill a without resigning: its lease must lapse, not be ceded
        a._stop.set()
        a._thread.join(timeout=5)
        s = _sess(cat)
        s.execute("create table fo (x bigint)")  # b must pick this up
        assert ("fo",) in s.execute("show tables").rows
        assert cat.ddl_owner.owner() == "b"
    finally:
        cat.ddl_workers.pop("a", None)
        b.stop()


def test_stop_drains_and_orphans_are_reclaimed():
    cat = Catalog()
    w = DDLWorker(cat, "w1", poll=0.01, device="cpu")
    w.start()
    w.stop()
    s = _sess(cat)
    t0 = time.time()
    s.execute("create table nolock (x bigint)")  # inline: no workers left
    assert time.time() - t0 < 5
    job = cat.submit_ddl("create table rec (x bigint)", "test")
    assert cat.next_ddl_job("ghost") is job  # a dead worker claimed it
    live = DDLWorker(cat, "live", poll=0.01, device="cpu")
    live.start()
    try:
        assert job.done.wait(timeout=10)
        assert job.state == "done"
        assert ("rec",) in s.execute("show tables").rows
    finally:
        live.stop()


# -- the online-DDL cluster cases, one process -----------------------------

def _online_ddl(instances, sql, between_stages=None, locks=None):
    """Step every instance through the stages of `sql` (the reference's
    Cluster.online_ddl over in-process instances). `locks` serialize each
    instance's calls, as one connection per worker does."""
    import contextlib

    locks = locks or [contextlib.nullcontext() for _ in instances]

    def stage_all(stage):
        for s, lk in zip(instances, locks):
            with lk:
                s.apply_ddl_stage(sql, stage)

    stmt = parse(sql)[0]
    if not (isinstance(stmt, A.AlterTableStmt)
            and stmt.action in ("add_column", "add_index")):
        for s in instances:
            s.execute(sql)
        return
    stages = (["write_only", "public"] if stmt.action == "add_column"
              else ["write_only", "backfill", "public"])
    done = []
    try:
        for stage in stages:
            stage_all(stage)
            done.append(stage)
            if between_stages is not None:
                between_stages(stage)
    except Exception:
        if "public" not in done:
            try:
                stage_all("abort")
            except Exception:  # noqa: BLE001 — best-effort abort
                pass
        raise


def case_concurrent_dml(make):
    inst = [make() for _ in range(2)]
    for s in inst:
        s.execute("create table od (k bigint, v bigint)")
    for w, s in enumerate(inst):
        s.execute("insert into od values " + ",".join(
            f"({w * 1000 + i}, 1)" for i in range(50)))
    stop, errs, counts = threading.Event(), [], [50, 50]
    locks = [threading.Lock(), threading.Lock()]

    def dml(w):
        i = 100
        while not stop.is_set():
            try:
                with locks[w]:
                    # explicit old columns: legal at EVERY schema stage
                    inst[w].execute(f"insert into od (k, v) values "
                                    f"({w * 1000 + i + 500}, 1)")
                counts[w] += 1
                i += 1
            except Exception as e:  # noqa: BLE001
                errs.append(e)
                return
            time.sleep(0.005)

    def window(stage):
        if stage == "write_only":
            # the OLD positional shape still inserts while the staged
            # column is write_only on every instance
            for w in range(2):
                with locks[w]:
                    inst[w].execute(f"insert into od values "
                                    f"({w * 1000 + 999}, 1)")
                counts[w] += 1
        time.sleep(0.1)

    ts = [threading.Thread(target=dml, args=(w,)) for w in range(2)]
    for t in ts:
        t.start()
    try:
        _online_ddl(inst, "alter table od add column extra bigint default 42",
                    between_stages=window, locks=locks)
        time.sleep(0.05)
    finally:
        stop.set()
        for t in ts:
            t.join(timeout=10)
    assert not errs, errs
    return [inst[w].query("select count(*) = %d, min(extra), max(extra) from od"
                          % counts[w]) for w in range(2)]


def case_mixed_version_window(make):
    inst = [make() for _ in range(2)]
    for s in inst:
        s.execute("create table mv (k bigint)")
    sql = "alter table mv add column c bigint default 9"
    inst[0].apply_ddl_stage(sql, "write_only")
    # instance 0 at write_only, instance 1 one version behind: both
    # accept the old positional shape
    inst[0].execute("insert into mv values (1)")
    inst[1].execute("insert into mv values (2)")
    out = [inst[0].query("select * from mv")]  # staged column invisible
    inst[1].apply_ddl_stage(sql, "write_only")
    for s in inst:
        s.apply_ddl_stage(sql, "public")
    return out + [s.query("select k, c from mv") for s in inst]


def case_unique_backfill_abort(make):
    inst = [make() for _ in range(2)]
    for s in inst:
        s.execute("create table oi (a bigint)")
    inst[0].execute("insert into oi values (1)")
    inst[1].execute("insert into oi values (7), (7)")  # a duplicate on 1 only
    with pytest.raises(Exception, match="[Dd]uplicate") as ei:
        _online_ddl(inst, "alter table oi add unique uqa (a)")
    # aborted everywhere: the staged index is gone on BOTH
    for s in inst:
        s.execute("insert into oi values (99), (99)")
    return [str(ei.value)] + [s.query("select a from oi order by a")
                              for s in inst]


@pytest.mark.parametrize("case", [case_concurrent_dml,
                                  case_mixed_version_window,
                                  case_unique_backfill_abort],
                         ids=["concurrent_dml", "mixed_version_window",
                              "unique_backfill_abort"])
def test_online_ddl_across_instances_matches_reference(case):
    def jax_instance():
        s = JaxSession(catalog=JaxCatalog())
        s.execute("set tidb_tpu_compaction = 0")
        return s

    want = case(jax_instance)
    got = case(lambda: _sess(Catalog()))
    assert got == want
