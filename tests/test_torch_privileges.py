"""Users and grants in the port (tidb_tpu_torch/privilege, the session's
checks at statement dispatch, CREATE / DROP USER, GRANT / REVOKE, SHOW
GRANTS) held to the reference's: the cases of tests/test_privileges.py
run as the same sequence of (user, statement) steps through a tidb_tpu
Session and a tidb_tpu_torch Session (CPU), and every step's outcome —
rows, or the error's class and message — must be equal. The
information_schema case waits for information_schema."""

import pytest
import torch

from tidb_tpu.session import Session as JaxSession
from tidb_tpu_torch.server import Server
from tidb_tpu_torch.server.client import Client, ServerError
from tidb_tpu_torch.session import Session
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

torch.set_num_threads(1)

_BASE = [("root", "create table t (a bigint, b varchar(10))"),
         ("root", "insert into t values (1, 'x'), (2, 'y')"),
         ("root", "create user alice identified by 'pw'")]


def _a(*sqls):
    return [("alice", q) for q in sqls]


def _r(*sqls):
    return [("root", q) for q in sqls]


CASES = {
    "unprivileged_denied": _a(
        "select * from t", "insert into t values (3, 'z')",
        "update t set b = 'q' where a = 1", "delete from t", "drop table t",
        "create table t2 (a bigint)", "create user bob",
        "grant select on t to alice"),
    "table_scope_grant": _r("grant select on t to alice") + _a(
        "select a from t order by a", "insert into t values (3, 'z')")
        + _r("revoke select on t from alice") + _a("select a from t"),
    "db_and_global_scope": _r("grant select, insert on test.* to alice")
        + _a("insert into t values (3, 'z')", "select count(*) from t")
        + _r("create database other", "create table other.o (x bigint)")
        + _a("select * from other.o") + _r("grant all on *.* to alice")
        + _a("select count(*) from other.o", "create user bob"),
    "join_checks_every_table": _r("create table u (k bigint)",
                                  "grant select on t to alice")
        + _a("select * from t join u on t.a = u.k")
        + _r("grant select on u to alice")
        + _a("select count(*) from t join u on t.a = u.k"),
    "view_checks_underlying": _r("create view v as select a from t",
                                 "grant select on v to alice")
        + _a("select * from v") + _r("grant select on t to alice")
        + _a("select * from v order by a"),
    "ddl_privs": _r("grant create on test.* to alice")
        + _a("create table mine (x bigint)", "drop table mine",
             "alter table mine add column y bigint")
        + _r("grant drop, alter on test.* to alice")
        + _a("alter table mine add column y bigint", "drop table mine"),
    "show_grants": _r("grant select, insert on t to alice",
                      "grant all on *.* to alice", "show grants for alice",
                      "create user carol")
        + [("carol", "show grants"), ("carol", "show grants for alice")],
    "drop_user_clears_grants": _r("grant select on t to alice",
                                  "drop user alice", "create user alice")
        + _a("select * from t"),
    "root_bypasses": _r("select count(*) from t", "show grants"),
    "revoke_all_and_partial": _r("grant select, insert on test.* to alice",
                                 "revoke all on test.* from alice")
        + _a("select * from t") + _r("grant all on test.* to alice",
                                     "revoke insert on test.* from alice")
        + _a("select count(*) from t", "insert into t values (9, 'q')"),
    "bare_star_is_current_db": _r("create database otherdb",
                                  "create table otherdb.o2 (x bigint)",
                                  "grant select on * to alice")
        + _a("select count(*) from t", "select * from otherdb.o2"),
    "super_gates_global_set_and_plugins": _a(
        "set global autocommit = 1", "install plugin p soname 'os'",
        "set autocommit = 1", "uninstall plugin p", "show plugins"),
    "subquery_tables_checked": _r("create table secret (x bigint)",
                                  "insert into secret values (42)",
                                  "grant select on t to alice")
        + _a("select a from t where a = (select max(x) from secret)",
             "select a from t where exists (select 1 from secret)"),
    "view_ddl_requires_privs": _r("create view vv as select a from t")
        + _a("drop view vv", "create view v2 as select 1"),
    "revoke_unknown_user": _r("revoke all on *.* from nosuchuser",
                              "grant select on t to nosuchuser"),
    "explain_and_trace_require_select": _a(
        "explain select * from t", "explain analyze select * from t",
        "trace select * from t", "show create table t")
        + _r("grant select on t to alice")
        + _a("explain select * from t", "show create table t"),
    "kill_needs_super_for_others": _a("kill query 1", "kill query 999")
        + _r("kill query 2"),
}


def _outcome(s, sql):
    try:
        rs = s.execute(sql)
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("error", type(e).__name__, getattr(e, "code", None), str(e))
    if rs is None:
        return ("ok",)
    if sql.startswith(("explain analyze", "trace")):
        return ("rows", len(rs.rows) > 0)  # timings differ run to run
    return ("rows", rs.names, rs.rows)


def _run(make, steps):
    root = make(None)
    sessions = {"root": root}
    out = []
    for user, sql in _BASE + steps:
        if user not in sessions:
            sessions[user] = make(root.catalog)
            sessions[user].user = user
        out.append((user, sql, _outcome(sessions[user], sql)))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_privileges_match_reference(case):
    want = _run(lambda cat: JaxSession(catalog=cat), CASES[case])
    got = _run(lambda cat: Session(catalog=cat, device="cpu"), CASES[case])
    assert got == want
    # the case really exercised a denial or a grant
    assert any(o[2][0] in ("error", "rows") for o in got[len(_BASE):])


def test_wire_level_denial_is_1142():
    """An authenticated but unprivileged user is refused over the MySQL
    protocol with ER_TABLEACCESS_DENIED (1142); after a grant the same
    account reads."""
    s = Session(device="cpu")
    for _user, sql in _BASE:
        s.execute(sql)
    srv = Server(catalog=s.catalog, port=0, device="cpu")
    srv.start()
    try:
        c = Client(port=srv.port, user="alice", password="pw")
        try:
            with pytest.raises(ServerError) as ei:
                c.query("select * from t")
            assert ei.value.code == 1142
        finally:
            c.close()
        s.execute("grant select on test.t to alice")
        c = Client(port=srv.port, user="alice", password="pw")
        try:
            assert c.query("select count(*) from t")[1] == [("2",)]
        finally:
            c.close()
    finally:
        srv.stop()
