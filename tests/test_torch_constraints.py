"""CHECK constraints, generated columns and foreign keys through the port
(tidb_tpu_torch on the CPU) against the JAX package, and the carry-across
of a reference table's schema by `load_arrays`.

Each case is a script run statement by statement on a fresh reference
session and a fresh port session: a statement must succeed in both or be
refused in both with the same error class and message, and every query
(a line starting with "?") must give the same rows. Cases mirror
tests/test_check_constraints.py, the generated-column cases of
tests/test_surface_tail.py and tests/test_foreign_keys.py (SHOW CREATE,
LOAD DATA, DROP DATABASE and information_schema wait for those
statements)."""

import numpy as np
import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu_torch.session import Session

from test_torch_keys import both, same_rows
from test_torch_session import _export_into, reference_witness_paused  # noqa: F401


def _pair():
    js = JaxSession()
    js.execute("set tidb_tpu_compaction = 0")
    return js, Session(device="cpu")


def run_script(script):
    js, ps = _pair()
    for sql in script:
        if sql.startswith("?"):
            same_rows(js, ps, sql[1:])
        else:
            both(js, ps, sql)
    return js, ps


_CHECK_T = ("create table t (a bigint check (a > 0), b bigint, d date, "
            "constraint b_lt_100 check (b < 100), check (b >= a))")

CHECK_CASES = {
    "insert_checked": [
        _CHECK_T, "insert into t values (1, 50, '2024-01-01')",
        "insert into t values (-1, 50, '2024-01-01')",
        "insert into t values (1, 200, '2024-01-01')",
        "insert into t values (60, 50, '2024-01-01')", "?select * from t"],
    "null_passes": [_CHECK_T, "insert into t values (NULL, NULL, NULL)",
                    "?select count(*) from t"],
    "update_checked": [
        _CHECK_T, "insert into t values (1, 50, '2024-01-01')",
        "update t set b = 99 where a = 1", "update t set b = 150 where a = 1",
        "update t set a = 100 where a = 1", "?select a, b from t"],
    "multi_row_batch_atomic": [
        _CHECK_T, "insert into t values (1, 10, NULL), (2, -5, NULL), (0, 1, NULL)",
        "?select count(*) from t"],
    "string_check_refused": ["create table sc (s varchar(8) check (s <> ''))"],
    "failed_wire_leaves_no_table": [
        "create table half (s varchar(8), a bigint, check (s <> ''))",
        "create table half (a bigint check (a > 0))", "insert into half values (-1)",
        "?select count(*) from half"],
    "drop_checked_column_refused": [_CHECK_T, "alter table t drop column b"],
    "anonymous_constraint": ["create table ac (a bigint, constraint check (a > 0))",
                             "insert into ac values (0)", "insert into ac values (1)",
                             "?select a from ac"],
    "add_check_validates_existing": [
        "create table a (v bigint)", "insert into a values (5), (10)",
        "alter table a add constraint vmax check (v < 100)",
        "insert into a values (500)", "alter table a add check (v > 7)",
        "insert into a values (1)", "?select v from a"],
    "add_check_ignores_dead_versions": [
        "create table a (v bigint)", "insert into a values (-5)",
        "delete from a where v = -5", "alter table a add check (v > 0)",
        "insert into a values (-1)", "insert into a values (3)", "?select v from a"],
    "drop_check": [_CHECK_T, "alter table t drop check b_lt_100",
                   "insert into t values (1, 500, NULL)", "alter table t drop check nope",
                   "?select a, b from t"],
    "constant_check_and_dup_names": [
        "create table a (v bigint)", "insert into a values (5)",
        "alter table a add check (1 < 0)",
        "alter table a add constraint c1 check (v > 0)",
        "alter table a add constraint c1 check (v < 9)",
        "alter table a add check (v < 1000)", "alter table a add check (v <> 13)",
        "alter table a drop check a_chk_1", "alter table a add check (v < 500)",
        "insert into a values (13)", "insert into a values (600)",
        "insert into a values (7)", "?select v from a"],
    "check_in_txn_rolls_back": [
        _CHECK_T, "begin", "insert into t values (1, 5, NULL)",
        "insert into t values (3, 1, NULL)", "rollback", "?select count(*) from t"],
}


@pytest.mark.parametrize("name", sorted(CHECK_CASES))
def test_check_constraints_match_reference(name):
    js, ps = run_script(CHECK_CASES[name])
    if js.catalog.has_table("test", "a"):
        assert sorted(c.name for c in ps.catalog.table("test", "a").checks) == \
            sorted(c.name for c in js.catalog.table("test", "a").checks)


GENERATED_CASES = {
    "stored_and_virtual": [
        "create table g (a bigint, b bigint, c bigint generated always as (a + b) "
        "stored, d bigint as (a * 2) virtual)",
        "insert into g values (1, 10), (2, 20)", "?select * from g",
        "update g set b = 100 where a = 1", "?select a, c, d from g"],
    "explicit_values_rejected": [
        "create table g (a bigint, c bigint as (a + 1))",
        "insert into g (a, c) values (1, 5)", "insert into g values (1)",
        "update g set c = 9", "?select * from g"],
    "where_and_unique_index": [
        "create table g (a bigint, c bigint as (a * a) stored)",
        "insert into g values (2), (3), (4)", "?select a from g where c > 5",
        "create unique index uc on g (c)", "insert into g values (-3)",
        "insert into g values (5)", "?select a, c from g"],
    "self_or_generated_reference": [
        "create table g (a bigint, c bigint as (c + 1))",
        "create table g2 (a bigint, c bigint as (a + 1), d bigint as (c + 1))"],
    "not_null_generated": [
        "create table g (a bigint, c bigint generated always as (a + 1) not null)",
        "insert into g values (1)", "insert into g values (NULL)", "?select c from g"],
    "string_target_rejected": ["create table g (a bigint, v varchar(10) as (a))"],
    "insert_select_rejected": [
        "create table src (x bigint)", "insert into src values (9)",
        "create table g (a bigint, c bigint as (a + 1))",
        "insert into g (a, c) select x, x from src",
        "insert into g (a) select x from src", "?select a, c from g"],
    "decimal_product_exact": [
        "create table gd (p decimal(15,2), d decimal(15,2), "
        "dp decimal(15,4) generated always as (p * (1 - d)) stored, "
        "check (d between 0.00 and 0.10))",
        "insert into gd values (90123.45, 0.07), (1.01, 0.00), (NULL, 0.05)",
        "insert into gd values (10.00, 0.20)",
        "?select p, d, dp from gd", "?select sum(dp) from gd"],
    "generated_feeds_check": [
        "create table gc (a bigint, c bigint as (a * 10) stored, check (c < 100))",
        "insert into gc values (5)", "insert into gc values (50)",
        "update gc set a = 20", "?select a, c from gc"],
}


@pytest.mark.parametrize("name", sorted(GENERATED_CASES))
def test_generated_columns_match_reference(name):
    run_script(GENERATED_CASES[name])


_FK_SETUP = ["create table p (id bigint primary key, v bigint)",
             "insert into p values (1, 10), (2, 20), (3, 30)",
             "create table c (x bigint, pid bigint, foreign key (pid) references p(id))"]
_FK2_SETUP = ["create table p (a bigint, b bigint, v bigint, primary key (a, b))",
              "insert into p values (1,1,10),(1,2,20),(2,1,30)"]

FK_CASES = {
    "child_insert": _FK_SETUP + ["insert into c values (100, 1), (101, NULL)",
                                 "insert into c values (102, 99)", "?select * from c"],
    "child_update": _FK_SETUP + ["insert into c values (100, 1)",
                                 "update c set pid = 2 where x = 100",
                                 "update c set pid = 77 where x = 100", "?select * from c"],
    "parent_delete": _FK_SETUP + ["insert into c values (100, 2)",
                                  "delete from p where id = 2", "delete from p where id = 3",
                                  "delete from c where x = 100", "delete from p where id = 2",
                                  "?select * from p"],
    "parent_key_update": _FK_SETUP + ["insert into c values (100, 1)",
                                      "update p set id = 9 where id = 1",
                                      "update p set v = 11 where id = 1",
                                      "update p set id = 1 where id = 1",
                                      "update p set id = id where id = 1", "?select * from p"],
    "drop_and_truncate": _FK_SETUP + ["insert into c values (100, 1)", "drop table p",
                                      "truncate table p", "drop table c", "drop table p"],
    "target_must_be_unique": _FK_SETUP + [
        "create table c2 (y bigint, foreign key (y) references p(v))"],
    "txn_scoped": _FK_SETUP + ["begin", "insert into p values (50, 1)",
                               "insert into c values (1, 50)", "commit",
                               "?select count(*) from c where pid = 50"],
    "txn_rollback_restores": _FK_SETUP + ["begin", "insert into p values (60, 1)",
                                          "insert into c values (1, 60)", "rollback",
                                          "insert into c values (2, 60)",
                                          "?select count(*) from c"],
    "string_fk_values_not_codes": _FK_SETUP + [
        "create table sp (name varchar(12), unique key (name))",
        "insert into sp values ('apple'), ('pear')",
        "create table sc (tag varchar(12), foreign key (tag) references sp(name))",
        "insert into sc values ('pear')", "insert into sc values ('zzz')",
        "delete from sp where name = 'pear'", "delete from sp where name = 'apple'",
        "?select tag from sc"],
    "failed_create_no_phantom_edges": _FK_SETUP + [
        "create table c2 (a bigint, b bigint, foreign key (a) references p(id), "
        "foreign key (b) references missing(x))", "drop table c", "drop table p"],
    "drop_fk_column_refused": _FK_SETUP + ["alter table c drop column pid",
                                           "alter table p drop column id"],
    "alter_add_drop_fk": [
        "create table p (id bigint primary key)", "insert into p values (1), (2)",
        "create table c (pid bigint)", "insert into c values (1), (NULL)",
        "alter table c add constraint fk1 foreign key (pid) references p(id)",
        "insert into c values (99)", "delete from p where id = 1",
        "create table c2 (pid bigint)", "insert into c2 values (42)",
        "alter table c2 add foreign key (pid) references p(id)",
        "alter table c drop foreign key fk1", "insert into c values (99)",
        "delete from p where id = 1", "?select pid from c", "?select id from p"],
    "duplicate_fk_name": [
        "create table p (id bigint primary key)", "create table c (x bigint, y bigint)",
        "alter table c add constraint fk foreign key (x) references p(id)",
        "alter table c add constraint fk foreign key (y) references p(id)"],
    "composite_restrict": _FK2_SETUP + [
        "create table c (x bigint, y bigint, foreign key (x, y) references p (a, b))",
        "insert into c values (1,1),(2,1)", "insert into c values (9,9)",
        "insert into c values (9, NULL)", "delete from p where a = 1 and b = 1",
        "?select * from c"],
    "composite_requires_unique": _FK2_SETUP + [
        "create table c2 (x bigint, y bigint, foreign key (x, y) references p (b, v))"],
    "on_delete_cascade": _FK2_SETUP + [
        "create table c (x bigint, y bigint, w bigint, foreign key (x, y) "
        "references p (a, b) on delete cascade)",
        "insert into c values (1,1,100),(1,2,200),(2,1,300)", "delete from p where a = 1",
        "?select w from c"],
    "cascade_recurses": _FK2_SETUP + [
        "create table mid (m bigint primary key, a bigint, b bigint, "
        "foreign key (a, b) references p (a, b) on delete cascade)",
        "create table leaf (m bigint, foreign key (m) references mid (m) "
        "on delete cascade)",
        "insert into mid values (7, 1, 1)", "insert into leaf values (7)",
        "delete from p where a = 1 and b = 1", "?select count(*) from mid",
        "?select count(*) from leaf"],
    "on_delete_set_null": _FK2_SETUP + [
        "create table c (x bigint, y bigint, w bigint, foreign key (x, y) "
        "references p (a, b) on delete set null)",
        "insert into c values (1,1,100),(2,1,300)", "delete from p where a = 1 and b = 1",
        "?select x, y, w from c"],
    "set_null_not_null_child": _FK2_SETUP + [
        "create table c (x bigint not null, y bigint, foreign key (x, y) "
        "references p (a, b) on delete set null)",
        "insert into c values (1,1)", "delete from p where a = 1 and b = 1",
        "?select * from p"],
    "on_update_cascade": _FK2_SETUP + [
        "create table c (x bigint, y bigint, foreign key (x, y) references p (a, b) "
        "on update cascade)",
        "insert into c values (1,1),(1,2)", "update p set b = 5 where a = 1 and b = 1",
        "?select x, y from c", "insert into c values (1, 1)"],
    "on_update_set_null": _FK2_SETUP + [
        "create table c (x bigint, y bigint, foreign key (x, y) references p (a, b) "
        "on update set null)",
        "insert into c values (1,1)", "update p set b = 9 where a = 1 and b = 1",
        "?select x, y from c"],
    "on_update_restrict_default": _FK2_SETUP + [
        "create table c (x bigint, y bigint, foreign key (x, y) references p (a, b))",
        "insert into c values (1,1)", "update p set b = 9 where a = 1 and b = 1"],
    "cascade_rolls_back_with_txn": _FK2_SETUP + [
        "create table c (x bigint, y bigint, foreign key (x, y) references p (a, b) "
        "on delete cascade)",
        "insert into c values (1,1),(2,1)", "begin", "delete from p where a = 1 and b = 1",
        "?select count(*) from c", "rollback", "?select count(*) from c",
        "?select count(*) from p"],
    "ci_matches_across_case": [
        "create table p2 (name varchar(20) primary key)", "insert into p2 values ('ABC')",
        "create table c2 (n varchar(20), foreign key (n) references p2 (name) "
        "on delete cascade)",
        "insert into c2 values ('abc')", "delete from p2 where name = 'abc'",
        "?select count(*) from c2"],
    "on_update_cascade_preserves_case": [
        "create table p4 (name varchar(20) primary key)", "insert into p4 values ('Alice')",
        "create table c4 (n varchar(20), foreign key (n) references p4 (name) "
        "on update cascade)",
        "insert into c4 values ('ALICE')", "update p4 set name = 'BOB' where name = 'alice'",
        "?select n from c4", "update p4 set name = 'Carol-X' where name = 'bob'",
        "?select n from c4"],
    "mixed_collation_rejected": [
        "create table p3 (name varchar(20) collate utf8mb4_bin primary key)",
        "create table c3 (n varchar(20), foreign key (n) references p3 (name))"],
}


@pytest.mark.parametrize("name", sorted(FK_CASES))
def test_foreign_keys_match_reference(name):
    js, ps = run_script(FK_CASES[name])
    for tname in ("c", "c2", "c4", "mid", "leaf"):
        if js.catalog.has_table("test", tname):
            jt, pt = js.catalog.table("test", tname), ps.catalog.table("test", tname)
            assert [(f.name, f.columns, f.parent.schema.name, f.parent_cols, f.on_delete,
                     f.on_update) for f in pt.foreign_keys] == \
                [(f.name, f.columns, f.parent.schema.name, f.parent_cols, f.on_delete,
                  f.on_update) for f in jt.foreign_keys]


# -- load_arrays carries a reference table's schema across -------------------------

_EXPORT_SETUP = [
    "create table parent (pid bigint primary key, name varchar(10))",
    "insert into parent values " + ", ".join(f"({i}, 'n{i % 7}')" for i in range(40)),
    "create table child (id bigint primary key, pid bigint, q decimal(10,2), "
    "d decimal(10,2), g decimal(12,4) generated always as (q * (1 - d)) stored, "
    "check (d between 0.00 and 0.10), check (q > 0), "
    "foreign key (pid) references parent (pid) on delete cascade) "
    "partition by range (pid) (partition p0 values less than (10), "
    "partition p1 values less than (30), partition p2 values less than maxvalue) "
    "cluster by (q)",
    "insert into child (id, pid, q, d) values " + ", ".join(
        f"({i}, {(i * 13) % 40}, {(i * 37) % 500 + 1}.25, 0.0{i % 10})"
        for i in range(300)),
]

_EXPORT_CHECKS = [
    "?select count(*), sum(g), sum(q) from child",
    "?select pid, count(*), sum(g) from child where pid < 10 group by pid",
    "?select id, g from child where pid >= 10 and pid < 30 and d > 0.05",
    "insert into child (id, pid, q, d) values (1000, 5, 10.00, 0.50)",
    "insert into child (id, pid, q, d) values (1001, 99, 10.00, 0.05)",
    "insert into child (id, pid, q, d) values (1002, 5, -1.00, 0.05)",
    "insert into child (id, pid, q, d, g) values (1003, 5, 1.00, 0.05, 1)",
    "insert into child (id, pid, q, d) values (7, 5, 1.00, 0.05)",
    "insert into child (id, pid, q, d) values (1004, 5, 2.00, 0.03)",
    "?select id, g from child where pid = 5",
    "delete from parent where pid = 13",
    "?select count(*) from child",
    "truncate table parent",
    "drop table parent",
]


def test_export_carries_schema_into_the_port():
    """A clustered, partitioned, constrained reference table (with a
    generated column and a foreign key to an exported parent) exported by
    load_arrays: the port holds the same schema and gives the reference's
    answers and refusals statement for statement."""
    from tidb_tpu.session import Session as JS

    js = JS()
    js.execute("set tidb_tpu_compaction = 0")
    for sql in _EXPORT_SETUP:
        js.execute(sql)
    ps = Session(device="cpu")
    jp, jc = js.catalog.table("test", "parent"), js.catalog.table("test", "child")
    assert jc.recluster() is True  # the reference's rows in cluster order
    _export_into(ps, jp, "parent")
    pc = _export_into(ps, jc, "child")
    assert pc.schema.cluster_by == "q" and pc.clustered_rows == jc.clustered_rows == jc.n
    assert (pc.schema.partition.kind, pc.schema.partition.names,
            pc.schema.partition.uppers) == ("range", ["p0", "p1", "p2"], [10, 30, None])
    assert [(c.name, c.sql) for c in pc.checks] == [(c.name, c.sql) for c in jc.checks]
    assert [(g.col, g.sql, g.stored) for g in pc.generated] == \
        [(g.col, g.sql, g.stored) for g in jc.generated]
    assert [(f.columns, f.parent.schema.name, f.on_delete) for f in pc.foreign_keys] == \
        [(["pid"], "parent", "cascade")]
    np.testing.assert_array_equal(pc.data["q"][:pc.n], jc.data["q"][:jc.n])
    np.testing.assert_array_equal(pc.data["g"][:pc.n], jc.data["g"][:jc.n])
    for sql in _EXPORT_CHECKS:
        if sql.startswith("?"):
            same_rows(js, ps, sql[1:])
        else:
            both(js, ps, sql)


def test_export_refuses_rows_breaking_a_carried_constraint():
    """load_arrays validates the rows against the carried constraints
    before they become visible: an array set breaking a CHECK is refused."""
    from tidb_tpu_torch.errors import ExecutionError
    from tidb_tpu_torch.storage.table import ColumnInfo
    from tidb_tpu_torch.storage.tpch import load_arrays
    from tidb_tpu_torch.types import INT64

    ps = Session(device="cpu")
    with pytest.raises(ExecutionError, match="CHECK constraint 'pos'"):
        load_arrays(ps.catalog, "bad", [ColumnInfo("a", INT64)],
                    {"a": np.array([1, -2, 3])}, checks=[("pos", "a > 0")])
