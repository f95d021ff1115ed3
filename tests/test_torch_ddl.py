"""ALTER TABLE in one process through the port (tidb_tpu_torch on the CPU)
against the JAX package: ADD/DROP/MODIFY COLUMN with backfill and the
lossless-conversion refusals, RENAME, ADD INDEX, the online-DDL stages a
single process applies (`apply_ddl_stage`: write_only columns and
indexes, backfill, public, abort), and the unknown ALTER actions.

Each case is a script run on a fresh reference session and a fresh port
session (cases from tests/test_ddl.py and the single-process cases of
tests/test_online_ddl.py; SHOW, EXPLAIN and the cross-worker DDL queue
wait for those statements and the multi-device tier): a statement must
succeed in both or be refused in both alike, a query ("?") must give the
same rows, and a stage ("@stage sql") runs through both sessions'
apply_ddl_stage."""

import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu_torch.parser import parse
from tidb_tpu_torch.planner.physical import PIndexRangeScan, PPointGet
from tidb_tpu_torch.session import Session

from test_torch_keys import same_rows
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)


def _outcome(fn):
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 — the class is the result
        return (type(e).__name__, str(e))


def run_script(script):
    js = JaxSession()
    js.execute("set tidb_tpu_compaction = 0")
    ps = Session(device="cpu")
    for sql in script:
        if sql.startswith("?"):
            same_rows(js, ps, sql[1:])
            continue
        if sql.startswith("@"):
            stage, stmt = sql[1:].split(" ", 1)
            outs = [_outcome(lambda s=s: s.apply_ddl_stage(stmt, stage))
                    for s in (js, ps)]
        else:
            outs = [_outcome(lambda s=s: s.execute(sql)) for s in (js, ps)]
        assert outs[0] == outs[1], (sql, outs)
    return js, ps


_T = ["create table t (id bigint primary key, name varchar(20), v bigint)",
      "insert into t values (1, 'a', 10), (2, 'b', 20), (3, NULL, 30)"]

CASES = {
    "add_column_null": _T + ["alter table t add column extra bigint",
                             "?select id, extra from t",
                             "insert into t values (4, 'd', 40, 99)",
                             "?select extra from t where id = 4"],
    "add_column_default": _T + ["alter table t add column flag bigint default 7",
                                "?select sum(flag) from t",
                                "?select count(*) from t where flag = 7"],
    "add_string_default": _T + ["alter table t add column tag varchar(8) default 'x'",
                                "?select id, tag from t"],
    "add_not_null_needs_default": _T + ["alter table t add column req bigint not null",
                                        "alter table t add column req bigint not null "
                                        "default 1", "?select sum(req) from t"],
    "add_duplicate_column": _T + ["alter table t add column v bigint"],
    "drop_column": _T + ["alter table t drop column v", "?select * from t",
                         "select v from t"],
    "drop_pk_column": _T + ["alter table t drop column id"],
    "drop_missing_column": _T + ["alter table t drop column nope"],
    "modify_int_to_double": _T + ["alter table t modify column v double",
                                  "?select v from t", "insert into t values (4, 'd', 1.5)",
                                  "?select v from t where id = 4"],
    "modify_int_to_decimal": _T + ["alter table t modify column v decimal(10,2)",
                                   "?select sum(v) from t", "?select id, v from t"],
    "modify_incompatible": _T + ["alter table t modify column name bigint"],
    "rename": _T + ["alter table t rename to t2", "?select count(*) from t2",
                    "select count(*) from t", "alter table t2 rename to t2"],
    "fractional_defaults": [
        "create table t (id bigint, f double default 1.5, d decimal(10,2) default 2.5)",
        "insert into t (id) values (1)", "?select f, d from t",
        "alter table t add column g double default 3.5", "?select g from t"],
    "modify_decimal_rescale": [
        "create table t (x decimal(18,2))", "insert into t values ('90071992547409.93')",
        "alter table t modify x decimal(18,4)", "?select x from t",
        "alter table t modify x decimal(18,1)", "?select x from t"],
    "modify_bool_domain": [
        "create table t (b bigint)", "insert into t values (0), (1)",
        "alter table t modify b boolean", "?select b from t",
        "create table u (b bigint)", "insert into u values (5)",
        "alter table u modify b boolean"],
    "modify_after_delete_and_null": [
        "create table t (a double)", "insert into t values (1.5)", "delete from t",
        "insert into t values (2.0), (NULL)", "alter table t modify a bigint",
        "?select a from t"],
    "modify_scale_up_overflow": [
        "create table t (x decimal(18,0))", "insert into t values ('900719925474099300')",
        "alter table t modify x decimal(18,4)", "?select x from t"],
    "modify_precision_refused": [
        "create table t (x bigint)", "insert into t values (9007199254740993)",
        "alter table t modify x double"],
    "modify_merging_unique_keys": [
        "create table t (x double)", "create unique index u on t (x)",
        "insert into t values (1.232), (1.228)", "alter table t modify x decimal(10,2)",
        "insert into t values (9.99)", "?select count(*) from t"],
    "alter_add_index": _T + ["alter table t add index idx_v (v)",
                             "alter table t add unique uv (v)",
                             "insert into t values (9, 'z', 10)",
                             "alter table t add index idx_v (name)", "?select * from t"],
    "drop_indexed_column": _T + ["create index iv on t (v)", "alter table t drop column v",
                                 "drop index iv on t", "alter table t drop column v",
                                 "?select * from t"],
    # online DDL stages in one process
    "staged_column_hidden_but_written": [
        "create table t (a bigint, b bigint)", "insert into t values (1, 10)",
        "@write_only alter table t add column c bigint default 7",
        "?select * from t", "insert into t values (2, 20)",
        "@public alter table t add column c bigint default 7", "?select * from t"],
    "abort_drops_staged_column": [
        "create table t (a bigint)",
        "@write_only alter table t add column c bigint",
        "@abort alter table t add column c bigint",
        "insert into t values (1)", "?select * from t"],
    "staged_unique_enforced": [
        "create table t (a bigint, b bigint)", "insert into t values (1, 1)",
        "@write_only alter table t add unique uq (b)", "insert into t values (2, 1)",
        "@backfill alter table t add unique uq (b)",
        "@public alter table t add unique uq (b)", "insert into t values (3, 1)",
        "?select * from t where b = 1"],
    "backfill_failure_aborts": [
        "create table t (a bigint)", "insert into t values (1), (1)",
        "@write_only alter table t add unique uq (a)",
        "@backfill alter table t add unique uq (a)", "insert into t values (1)",
        "?select count(*) from t"],
    "abort_never_drops_preexisting": [
        "create table t (a bigint, b bigint)", "insert into t values (1, 2)",
        "alter table t add index idx (b)",
        "@write_only alter table t add column a bigint",
        "@abort alter table t add column a bigint", "?select * from t",
        "@write_only alter table t add index idx (b)",
        "@abort alter table t add index idx (b)", "?select * from t"],
    "online_not_null_needs_default": [
        "create table t (a bigint)",
        "@write_only alter table t add column c bigint not null",
        "insert into t values (1)", "?select * from t"],
    "stage_other_actions_refused": [
        "create table t (a bigint)", "@write_only alter table t drop column a",
        "@sideways alter table t add column c bigint"],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_alter_table_matches_reference(name):
    js, ps = run_script(CASES[name])
    for tname in ("t", "t2", "u"):
        if js.catalog.has_table("test", tname):
            jt, pt = js.catalog.table("test", tname), ps.catalog.table("test", tname)
            assert [(c.name, c.type_.kind.name, c.type_.scale, c.state)
                    for c in pt.schema.columns] == \
                [(c.name, c.type_.kind.name, c.type_.scale, c.state)
                 for c in jt.schema.columns]
            assert sorted((i.name, i.unique, i.state) for i in pt.indexes.values()) == \
                sorted((i.name, i.unique, i.state) for i in jt.indexes.values())


def test_write_only_index_is_no_access_path():
    s = Session(device="cpu")
    s.execute("create table t (a bigint, b bigint)")
    s.execute("insert into t values (1, 1)")
    sql = "alter table t add unique uq (b)"

    def leaf():
        node = s._plan_select(parse("select * from t where b = 1")[0])
        while node.children:
            node = node.children[0]
        return type(node)

    s.apply_ddl_stage(sql, "write_only")
    assert leaf() not in (PPointGet, PIndexRangeScan)
    s.apply_ddl_stage(sql, "backfill")
    s.apply_ddl_stage(sql, "public")
    assert leaf() in (PPointGet, PIndexRangeScan)


def test_reshard_waits_for_the_multi_device_tier():
    """ALTER TABLE ... SHARD BY in one session is the reference's
    metadata-only reshard: the placement and its version change and the
    schema version bumps, as in the reference; the rows move only under
    the DCN tier's Cluster.reshard (tests/test_torch_sharding.py)."""
    s = Session(device="cpu")
    js = JaxSession()
    for sess in (s, js):
        sess.execute("create table t (id bigint primary key)")
        v0 = sess.catalog.schema_version
        sess.execute("alter table t shard by hash(id) shards 4")
        info = sess.catalog.table("test", "t").schema.shard_by
        assert (info.kind, info.column, info.shards, info.version) == (
            "hash", "id", 4, 1)
        assert sess.catalog.schema_version == v0 + 1


def test_schema_version_bumps_per_stage():
    s = Session(device="cpu")
    s.execute("create table t (a bigint)")
    v0 = s.catalog.schema_version
    s.apply_ddl_stage("alter table t add column c bigint", "write_only")
    s.apply_ddl_stage("alter table t add column c bigint", "public")
    assert s.catalog.schema_version == v0 + 2


def test_column_ddl_rebuilds_the_segment_store():
    """ADD, MODIFY and DROP COLUMN rewrite the rows in place (data_epoch),
    so a table with a segment store answers from the new layout, as the
    reference does."""
    js = JaxSession()
    js.execute("set tidb_tpu_compaction = 0")
    ps = Session(device="cpu")
    for s in (js, ps):
        s.execute("set tidb_tpu_segment_rows = 1024")
        s.execute("create table big (k bigint, v decimal(10,2))")
        s.execute("insert into big values " + ", ".join(
            f"({i}, {i % 97}.{i % 10}0)" for i in range(3000)))
    sql = "select count(*), sum(v) from big where k >= 100"
    same_rows(js, ps, sql)
    for stmt in ("alter table big add column w bigint default 3",
                 "alter table big modify column v decimal(12,4)",
                 "alter table big drop column w"):
        epoch = ps.catalog.table("test", "big").data_epoch
        for s in (js, ps):
            s.execute(stmt)
        assert ps.catalog.table("test", "big").data_epoch > epoch
        same_rows(js, ps, sql)
        same_rows(js, ps, "select * from big where k < 5")
