"""SAVEPOINT / ROLLBACK TO / RELEASE SAVEPOINT through the port
(tidb_tpu_torch on the CPU) against the JAX package: a partial rollback
undoes the inserts, deletes and updates made after the savepoint while
the earlier writes and the transaction survive (cases from
tests/test_savepoints.py; its delta-engine case waits for that engine).
Each case is a script run on a fresh pair of sessions: every statement
succeeds in both or is refused in both alike, every query ("?") gives the
same rows."""

import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu_torch.session import Session

from test_torch_keys import both, same_rows
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

_SETUP = ["create table t (a bigint, b bigint)", "insert into t values (1, 10), (2, 20)"]

CASES = {
    "undoes_inserts": [
        "begin", "insert into t values (3, 30)", "savepoint sp1",
        "insert into t values (4, 40), (5, 50)", "?select count(*) from t",
        "rollback to sp1", "?select a from t", "commit", "?select a from t"],
    "restores_deletes_and_updates": [
        "begin", "savepoint sp1", "delete from t where a = 1",
        "update t set b = 99 where a = 2", "?select a, b from t",
        "rollback to savepoint sp1", "?select a, b from t", "commit", "?select a, b from t"],
    "nested": [
        "begin", "insert into t values (3, 30)", "savepoint a",
        "insert into t values (4, 40)", "savepoint b", "insert into t values (5, 50)",
        "rollback to b", "?select max(a) from t", "rollback to a",
        "?select max(a) from t", "rollback to b", "rollback to a", "commit",
        "?select a from t"],
    "release": [
        "begin", "savepoint a", "insert into t values (3, 30)", "savepoint b",
        "release savepoint a", "?select count(*) from t", "rollback to a",
        "rollback to b", "release savepoint a", "commit", "?select count(*) from t"],
    "unknown": ["begin", "rollback to nope", "release savepoint nope", "rollback",
                "rollback to nope"],
    "full_rollback_after_partial": [
        "begin", "insert into t values (3, 30)", "savepoint sp",
        "insert into t values (4, 40)", "rollback to sp", "rollback", "?select a from t"],
    "redeclared_moves": [
        "begin", "insert into t values (3, 30)", "savepoint sp",
        "insert into t values (4, 40)", "savepoint sp", "insert into t values (5, 50)",
        "rollback to sp", "?select max(a) from t", "commit", "?select a from t"],
    "uniqueness_after_rollback_to": [
        "create table u (k bigint primary key)", "insert into u values (1)", "begin",
        "savepoint sp", "delete from u where k = 1", "rollback to sp",
        "insert into u values (1)", "replace into u values (1)", "rollback",
        "?select k from u"],
    "starts_txn_without_autocommit": [
        "set autocommit = 0", "savepoint sp1", "insert into t values (9, 90)",
        "rollback to sp1", "?select count(*) from t where a = 9", "rollback",
        "set autocommit = 1", "?select count(*) from t"],
    "noop_in_autocommit": ["savepoint sp", "insert into t values (7, 70)",
                           "rollback to sp", "?select a from t"],
    "upsert_and_multi_table_after_savepoint": [
        "create table k (id bigint primary key, v bigint)",
        "insert into k values (1, 1), (2, 2)", "begin", "savepoint s1",
        "insert into k values (1, 5) on duplicate key update v = v + 100",
        "update t join k on t.a = k.id set t.b = k.v", "?select a, b from t",
        "?select id, v from k", "rollback to s1", "?select a, b from t",
        "?select id, v from k", "commit"],
    "constraints_after_rollback_to": [
        "create table p (id bigint primary key)", "insert into p values (1), (2)",
        "create table c (pid bigint, q bigint check (q > 0), "
        "foreign key (pid) references p (id) on delete cascade)",
        "insert into c values (1, 5), (2, 6)", "begin", "savepoint s1",
        "delete from p where id = 1", "?select pid from c", "rollback to s1",
        "?select pid from c", "insert into c values (2, -1)", "commit",
        "?select pid, q from c"],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_savepoints_match_reference(name):
    js = JaxSession()
    js.execute("set tidb_tpu_compaction = 0")
    ps = Session(device="cpu")
    for sql in _SETUP + CASES[name]:
        if sql.startswith("?"):
            same_rows(js, ps, sql[1:])
        else:
            both(js, ps, sql)
    assert ps.txn is None and js.txn is None


def test_rollback_to_over_the_segment_store():
    """A partial rollback over a table with a segment store: the undone
    versions leave every scan path exact (fused, classic raw)."""
    js = JaxSession()
    js.execute("set tidb_tpu_compaction = 0")
    ps = Session(device="cpu")
    for s in (js, ps):
        s.execute("set tidb_tpu_segment_rows = 1024")
        s.execute("create table big (k bigint, v bigint)")
        s.execute("insert into big values " + ", ".join(
            f"({i}, {i % 13})" for i in range(3000)))
    sql = "select count(*), sum(v) from big where k >= 10"
    script = ["begin", "insert into big values (5000, 1), (5001, 2)", "savepoint s",
              "delete from big where k < 500", "update big set v = 0 where k > 2900",
              "?" + sql, "rollback to s", "?" + sql, "commit", "?" + sql,
              "set tidb_tpu_pipeline_fuse = 0", "set tidb_tpu_columnar_enable = 0",
              "?" + sql]
    for stmt in script:
        if stmt.startswith("?"):
            same_rows(js, ps, stmt[1:])
        else:
            both(js, ps, stmt)
    assert ps.query(sql) == [(2992, sum(i % 13 for i in range(10, 3000)) + 3)]
