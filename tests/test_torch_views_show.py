"""Views and SHOW through the port (tidb_tpu_torch on the CPU) against the
JAX package: the SQL of tests/test_views.py and the SHOW kinds the port
has, statement for statement on both.

Views: CREATE [OR REPLACE] VIEW with and without a column list, a view
over a view joined to a table, a view in another database, a caller's CTE
that must not shadow the view's tables, DROP VIEW [IF EXISTS] all or
nothing, the name clashes with tables. (The information_schema case of
tests/test_views.py waits for information_schema.) SHOW: DATABASES,
TABLES (views listed, LIKE), COLUMNS / DESCRIBE, INDEX / KEYS, CREATE
TABLE (keys, partitions, CHECK, generated columns, foreign keys, CLUSTER
BY), CREATE VIEW, VARIABLES (LIKE), WARNINGS, GRANTS, PROCESSLIST,
BINDINGS and PLUGINS. Result sets must be equal (names and rows),
refusals equal in class and message.
"""

import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu_torch.session import Session

from test_torch_keys import both
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)


def _pair():
    js = JaxSession(chunk_capacity=256)
    js.execute("set tidb_tpu_compaction = 0")
    ps = Session(chunk_capacity=256, device="cpu")
    for sql in ("create table t (a bigint, g varchar(4))",
                "insert into t values (1,'x'),(2,'x'),(3,'y')"):
        both(js, ps, sql)
    return js, ps


def same_result(js, ps, sql, ordered=True):
    """Both engines give the same column names and rows."""
    want, got = js.execute(sql), ps.execute(sql)
    assert got.names == want.names, sql
    if ordered:
        assert got.rows == want.rows, sql
    else:
        assert sorted(got.rows, key=repr) == sorted(want.rows, key=repr), sql
    return got.rows


# (name, statements run on both, queries compared); each runs on a fresh pair
_VIEW_CASES = [
    ("basic_and_filter",
     ["create view v as select g, sum(a) as total from t group by g"],
     ["select * from v order by g", "select total from v where g = 'y'"]),
    ("explicit_columns",
     ["create view v (grp, tot) as select g, sum(a) from t group by g"],
     ["select grp, tot from v order by grp"]),
    ("or_replace",
     ["create view v as select a from t",
      "create or replace view v as select count(*) as n from t"],
     ["select n from v"]),
    ("view_over_view_and_join",
     ["create view v1 as select g, sum(a) as tot from t group by g",
      "create view v2 as select g, tot from v1 where tot > 2"],
     ["select v2.g, t.a from v2 join t on t.g = v2.g order by v2.g, a"]),
    ("show_tables_lists_views",
     ["create view v as select a from t"],
     ["show tables", "show tables like 'v%'"]),
    ("updates_reflect_base_table",
     ["create view v as select count(*) as n from t",
      "insert into t values (4, 'z')"],
     ["select n from v"]),
    ("resolves_in_defining_db",
     ["create database other", "create table other.src (x bigint)",
      "insert into other.src values (7)", "use other",
      "create view vv as select x from src", "use test"],
     ["select x from other.vv", "show databases"]),
    ("caller_cte_does_not_shadow",
     ["create view v as select sum(a) as s from t"],
     ["with t as (select 99 as a) select s from v"]),
    ("view_as_identifier",
     ["create table audit_t (view bigint)", "insert into audit_t values (5)"],
     ["select view from audit_t"]),
    ("show_create_view",
     ["create view v (one) as select a from t"],
     ["show create view v"]),
    ("create_table_if_not_exists_over_view",
     ["create view v as select a from t",
      "create table if not exists v (x bigint)"],
     ["select count(*) from v"]),
    ("drop_view",
     ["create view v as select a from t", "drop view v",
      "drop view if exists nosuch"],
     ["show tables"]),
    ("view_in_join_of_tpch_shape",
     ["create table s (k bigint primary key, name varchar(10))",
      "insert into s values (1, 'one'), (2, 'two'), (3, 'three')",
      "create view rev (k, total) as select a, sum(a) from t group by a",
      ],
     ["select name, total from s, rev where s.k = rev.k and total = "
      "(select max(total) from rev) order by name"]),
]


@pytest.mark.parametrize("name,setup,queries", _VIEW_CASES,
                         ids=[c[0] for c in _VIEW_CASES])
def test_views_match_reference(name, setup, queries):
    js, ps = _pair()
    for sql in setup:
        assert both(js, ps, sql) is None, sql
    for sql in queries:
        same_result(js, ps, sql, ordered="order by" in sql or "show" in sql)


# (name, setup, the statement both must refuse alike, error class)
_VIEW_REFUSALS = [
    ("duplicate_view", ["create view v as select a from t"],
     "create view v as select a from t", "DuplicateTableError"),
    ("view_over_table_name", [], "create view t as select 1", "DuplicateTableError"),
    ("drop_missing", [], "drop view nosuch", "SchemaError"),
    ("column_count_mismatch", ["create view v (one) as select a, g from t"],
     "select * from v", "PlanError"),
    ("table_over_view_name", ["create view v as select a from t"],
     "create table v (x bigint)", "DuplicateTableError"),
    ("multi_drop_atomic", ["create view v1 as select a from t"],
     "drop view v1, nosuch", "SchemaError"),
]


@pytest.mark.parametrize("name,setup,sql,err", _VIEW_REFUSALS,
                         ids=[c[0] for c in _VIEW_REFUSALS])
def test_view_refusals_match_reference(name, setup, sql, err):
    js, ps = _pair()
    for s in setup:
        assert both(js, ps, s) is None, s
    assert both(js, ps, sql) == err
    same_result(js, ps, "show tables")  # a failed multi-drop kept v1


def test_self_reference_depth_limited():
    """A view redefined behind the parser's back to reference itself:
    expansion stops with an error in both, not a recursion."""
    from tidb_tpu.parser import parse as jax_parse
    from tidb_tpu_torch.parser import parse

    js, ps = _pair()
    both(js, ps, "create view v as select a from t")
    js.catalog.database("test").views["v"] = (
        None, jax_parse("select a from v")[0], "select a from v")
    ps.catalog.database("test").views["v"] = (
        None, parse("select a from v")[0], "select a from v")
    assert both(js, ps, "select * from v") == "PlanError"


# -- SHOW -----------------------------------------------------------------------

_SHOW_SETUP = [
    "create table parent (id bigint primary key, name varchar(20) not null)",
    "create table child (id bigint primary key, pid bigint, "
    "qty decimal(10,2) default '1.50', note varchar(30) collate utf8mb4_bin, "
    "total decimal(12,2) as (qty * 2) stored, "
    "unique key uk_note (note), key k_pid (pid), "
    "constraint c_qty check (qty > 0), "
    "foreign key (pid) references parent (id) on delete cascade) "
    "cluster by (pid)",
    "create table ranged (k bigint, v bigint) partition by range (k) "
    "(partition p0 values less than (10), partition p1 values less than (100), "
    "partition p2 values less than maxvalue)",
    "create table hashed (k bigint, v bigint) partition by hash (k) partitions 4",
    "create view cv (n) as select count(*) from child",
]

_SHOWS = [
    "show databases",
    "show tables",
    "show tables like '%e%'",
    "show columns from child",
    "describe parent",
    "show index from child",
    "show keys from parent",
    "show create table parent",
    "show create table child",
    "show create table ranged",
    "show create table hashed",
    "show create view cv",
    "show variables like 'tidb_enable_auto_analyze'",
    "show variables like 'tidb_auto_analyze%'",
    "show variables like 'autocommit'",
    "show warnings",
]


@pytest.fixture(scope="module")
def show_pair():
    js, ps = _pair()
    for sql in _SHOW_SETUP:
        assert both(js, ps, sql) is None, sql
    return js, ps


@pytest.mark.parametrize("sql", _SHOWS)
def test_show_matches_reference(show_pair, sql):
    js, ps = show_pair
    rows = same_result(js, ps, sql)
    assert rows or sql == "show warnings"


def test_show_warnings_lists_ignored_clauses():
    js, ps = _pair()
    sql = "create table wt (a bigint) engine=innodb default charset=utf8mb4"
    assert both(js, ps, sql) is None
    rows = same_result(js, ps, "show warnings")
    assert rows and all(r[1] == 1235 for r in rows)
    # the next statement resets the area
    both(js, ps, "select 1")
    assert same_result(js, ps, "show warnings") == []


@pytest.mark.parametrize("kind", ["grants", "processlist", "bindings", "plugins"])
def test_unported_show_kinds_are_refused(kind):
    """The four SHOW kinds the port refused until users, the process
    list, bindings and plugins were ported: each now answers as the
    reference does (the process list's Time column
    aside, a wall-clock reading)."""
    js, ps = JaxSession(), Session(device="cpu")
    want, got = js.execute(f"show {kind}"), ps.execute(f"show {kind}")
    assert got.names == want.names
    def cut(rows):
        return [r[:5] + r[6:] for r in rows] if kind == "processlist" else rows
    assert cut(got.rows) == cut(want.rows)
