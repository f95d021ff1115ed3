"""Keys and index access through the port (tidb_tpu_torch on the CPU)
against the JAX package, statement for statement.

- PRIMARY KEY (one column and composite) and UNIQUE KEY enforcement on
  INSERT, multi-row INSERT and UPDATE: the port refuses what the reference
  refuses, with the same error class and message, and leaves the rows as
  the reference leaves them. CREATE UNIQUE INDEX over duplicates is
  refused. NULL keys never conflict; a _ci collation folds case.
- The TPC-H tables exported from the reference carry their primary keys
  (test_torch_session._export_into): a duplicate o_orderkey, or a
  duplicate (l_orderkey, l_linenumber), is refused by both engines.
- Point and range access (cases from tests/test_pointget.py): the port's
  planner picks the reference's PPointGet / PIndexRangeScan / PScan (pure
  ranges take the index once the INSERT's commit has auto-analyzed the
  table), and the rows equal the reference's, also after a DELETE and
  inside a transaction's snapshot.

Every reference Session here sets `tidb_tpu_compaction = 0`: the port
has no compaction worker, and the reference's must not start.
"""

import numpy as np
import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.tpch import load_tpch as jax_load_tpch
from tidb_tpu_torch.parser import parse
from tidb_tpu_torch.planner.physical import PIndexRangeScan, PPointGet, PScan
from tidb_tpu_torch.session import Session

from test_torch_session import _export_into, _same, reference_witness_paused  # noqa: F401


def new_pair():
    js = JaxSession()
    js.execute("set tidb_tpu_compaction = 0")
    return js, Session(device="cpu")


def both(js, ps, sql):
    """Run `sql` on both engines; they must agree on success or on the
    error's class and message. Returns the error class name or None."""
    outs = []
    for s in (js, ps):
        try:
            s.execute(sql)
            outs.append(None)
        except Exception as e:  # noqa: BLE001 — the class is the result
            outs.append((type(e).__name__, str(e)))
    assert outs[0] == outs[1], (sql, outs)
    return outs[1] and outs[1][0]


def same_rows(js, ps, sql, ordered=False):
    _same(ps.query(sql), js.query(sql), ordered)


def leaf(ps, sql):
    """The port planner's access-path leaf for a one-table SELECT."""
    node = ps._plan_select(parse(sql)[0])
    while node.children and not isinstance(node, PScan):
        node = node.children[0]
    return node


# -- unique enforcement ------------------------------------------------------

_KEY_SETUP = [
    "create table k1 (id bigint primary key, v bigint, s varchar(8))",
    "insert into k1 values (1, 10, 'a'), (2, 20, 'b'), (3, 30, NULL)",
    "create table k2 (a bigint, b bigint, v bigint, primary key (a, b))",
    "insert into k2 values (1, 1, 0), (1, 2, 0), (2, 1, 0)",
    "create table k3 (id bigint primary key, u bigint, w varchar(8), "
    "unique key uk_u (u), unique key uk_w (w))",
    "insert into k3 values (1, 100, 'x'), (2, 200, 'y'), (3, NULL, NULL), "
    "(4, NULL, NULL)",
]

# (name, statement, error class or None); each runs on a fresh pair
_KEY_CASES = [
    ("pk_insert", "insert into k1 values (2, 99, 'z')", "ExecutionError"),
    ("pk_insert_fresh", "insert into k1 values (4, 40, 'd')", None),
    ("pk_batch_dup", "insert into k1 values (5, 0, 'e'), (5, 1, 'f')", "ExecutionError"),
    ("pk_batch_vs_table", "insert into k1 values (6, 0, 'e'), (1, 1, 'f')", "ExecutionError"),
    ("pk_update", "update k1 set id = 1 where id = 3", "ExecutionError"),
    ("pk_update_shift", "update k1 set id = id + 10", None),
    ("pk_update_same_value", "update k1 set v = v + 1 where id = 2", None),
    ("composite_insert", "insert into k2 values (1, 2, 5)", "ExecutionError"),
    ("composite_partial_overlap", "insert into k2 values (2, 2, 5)", None),
    ("composite_update", "update k2 set b = 2 where a = 1 and b = 1", "ExecutionError"),
    ("unique_insert", "insert into k3 values (9, 200, 'q')", "ExecutionError"),
    ("unique_string_insert", "insert into k3 values (9, 900, 'x')", "ExecutionError"),
    ("unique_nulls_never_conflict", "insert into k3 values (9, NULL, NULL)", None),
    ("unique_update", "update k3 set u = 100 where id = 2", "ExecutionError"),
    ("unique_update_to_null", "update k3 set u = NULL where id = 2", None),
    ("create_unique_over_dups", "create unique index uv on k2 (v)", "ExecutionError"),
    ("create_unique_ok", "create unique index uv on k1 (v)", None),
    ("txn_dup_rollback", "begin; insert into k1 values (7, 7, 'g'); "
                         "insert into k1 values (7, 8, 'h')", "ExecutionError"),
]


@pytest.mark.parametrize("name,sql,err", _KEY_CASES, ids=[c[0] for c in _KEY_CASES])
def test_unique_keys_match_reference(name, sql, err):
    js, ps = new_pair()
    for q in _KEY_SETUP:
        both(js, ps, q)
    assert both(js, ps, sql) == err
    for s in (js, ps):
        if s.txn is not None:
            s.execute("rollback")
    for t in ("k1", "k2", "k3"):
        same_rows(js, ps, f"select * from {t}")
    if err:
        # a refused statement leaves nothing behind: the next insert that
        # omits columns reads NULL, not the refused row's values
        both(js, ps, "insert into k1 (id) values (100)")
        same_rows(js, ps, "select * from k1")


def test_ci_collation_folds_case_in_unique_keys():
    js, ps = new_pair()
    both(js, ps, "create table c (id bigint primary key, "
                 "n varchar(10) collate utf8mb4_general_ci, unique key un (n))")
    both(js, ps, "insert into c values (1, 'abc')")
    assert both(js, ps, "insert into c values (2, 'ABC')") == "ExecutionError"
    assert both(js, ps, "insert into c values (3, 'abd')") is None
    same_rows(js, ps, "select * from c")


@pytest.fixture(scope="module")
def tpch_keys():
    js = JaxSession()
    js.execute("set tidb_tpu_compaction = 0")
    jax_load_tpch(js.catalog, sf=0.01)
    ps = Session(device="cpu")
    for name in ("orders", "lineitem"):
        _export_into(ps, js.catalog.table("test", name), name)
    return js, ps


def test_exported_tpch_tables_carry_their_primary_keys(tpch_keys):
    js, ps = tpch_keys
    for name, cols in (("orders", ["o_orderkey"]),
                       ("lineitem", ["l_orderkey", "l_linenumber"])):
        idx = ps.catalog.table("test", name).indexes
        assert list(idx) == ["PRIMARY"] and idx["PRIMARY"].columns == cols
        assert idx["PRIMARY"].unique


@pytest.mark.parametrize("sql", [
    "insert into orders (o_orderkey, o_custkey, o_orderstatus, o_totalprice, "
    "o_orderdate, o_orderpriority, o_clerk, o_shippriority, o_comment) "
    "values (1, 1, 'O', 1.00, '1995-01-01', '1-URGENT', 'Clerk#1', 0, 'dup')",
    "insert into lineitem (l_orderkey, l_partkey, l_suppkey, l_linenumber, "
    "l_quantity, l_extendedprice, l_discount, l_tax, l_returnflag, "
    "l_linestatus, l_shipdate, l_commitdate, l_receiptdate, l_shipinstruct, "
    "l_shipmode, l_comment) values (1, 1, 1, 1, 1, 1.00, 0.00, 0.00, 'N', "
    "'O', '1995-01-01', '1995-01-01', '1995-01-01', 'NONE', 'AIR', 'dup')",
], ids=["orders_pk", "lineitem_composite_pk"])
def test_duplicate_tpch_key_is_refused(tpch_keys, sql):
    js, ps = tpch_keys
    before = [t.live_rows for t in (ps.catalog.table("test", "orders"),
                                    ps.catalog.table("test", "lineitem"))]
    assert both(js, ps, sql) == "ExecutionError"
    after = [t.live_rows for t in (ps.catalog.table("test", "orders"),
                                   ps.catalog.table("test", "lineitem"))]
    assert after == before


# -- point and range access ---------------------------------------------------

def _points():
    js, ps = new_pair()
    both(js, ps, "create table p (id bigint primary key, v bigint, s varchar(8))")
    both(js, ps, "insert into p values " + ",".join(
        f"({i}, {i * 10}, 'x{i % 7}')" for i in range(1, 2001)))
    both(js, ps, "create table r (a bigint, b bigint, v bigint, primary key (a, b))")
    both(js, ps, "insert into r values " + ",".join(
        f"({i // 10}, {i % 10}, {i})" for i in range(1000)))
    return js, ps


@pytest.fixture
def points():
    return _points()


@pytest.fixture(scope="module")
def points_read_only():
    return _points()


_POINT_CASES = [
    ("hit", "select v from p where id = 77", PPointGet),
    ("residual_miss", "select v from p where id = 77 and v > 1000", PPointGet),
    ("absent_key", "select v from p where id = -1", PPointGet),
    ("string_residual", "select s from p where id = 8 and s = 'x1'", PPointGet),
    ("composite_point", "select v from r where a = 12 and b = 3", PPointGet),
    # a pure range takes the index only when statistics make it selective:
    # the 2,000-row INSERT's commit auto-analyzes p in both packages, and
    # its histogram makes these ranges narrow. An equality prefix (0.1 a
    # column) wins without statistics.
    ("range", "select id, v from p where id between 100 and 110", PIndexRangeScan),
    ("range_open", "select id from p where id > 1990", PIndexRangeScan),
    ("prefix_range", "select v from r where a = 7 and b >= 4", PIndexRangeScan),
    ("prefix_eq", "select v from r where a = 50", PIndexRangeScan),
    ("not_selective", "select count(*) from p where id > 5", PScan),
    ("non_key", "select id from p where v = 770", PScan),
]


@pytest.mark.parametrize("name,sql,kind", _POINT_CASES, ids=[c[0] for c in _POINT_CASES])
def test_access_paths_match_reference(points_read_only, name, sql, kind):
    from tidb_tpu.parser import parse as jax_parse

    js, ps = points_read_only
    assert type(leaf(ps, sql)) is kind, name
    node = js._plan_select(jax_parse(sql)[0])
    while node.children and type(node).__name__ != kind.__name__:
        node = node.children[0]
    assert type(node).__name__ == kind.__name__, name  # the reference's plan
    same_rows(js, ps, sql)


def test_point_after_delete(points):
    js, ps = points
    both(js, ps, "delete from p where id = 500")
    assert type(leaf(ps, "select v from p where id = 500")) is PPointGet
    assert ps.query("select v from p where id = 500") == []
    same_rows(js, ps, "select v from p where id = 500")
    same_rows(js, ps, "select id from p where id between 495 and 505")


def test_point_sees_txn_snapshot(points):
    js, ps = points
    other = Session(catalog=ps.catalog, device="cpu")
    for s in (js, ps):
        s.execute("begin")
        s.execute("update p set v = -5 where id = 10")
    same_rows(js, ps, "select v from p where id = 10")
    assert ps.query("select v from p where id = 10") == [(-5,)]
    # another session reads committed-latest: the provisional row is not
    # there, the old version is
    assert other.query("select v from p where id = 10") == [(100,)]
    for s in (js, ps):
        s.execute("rollback")
    same_rows(js, ps, "select v from p where id = 10")
    both(js, ps, "update p set v = 123 where id = 10")
    assert ps.query("select v from p where id = 10") == [(123,)]
    assert other.query("select v from p where id = 10") == [(123,)]


def test_secondary_unique_index_point_get(points):
    js, ps = points
    both(js, ps, "create unique index uv on p (v)")
    node = leaf(ps, "select id from p where v = 770")
    assert type(node) is PPointGet and node.index_name == "uv"
    same_rows(js, ps, "select id from p where v = 770")
    both(js, ps, "drop index uv on p")
    assert type(leaf(ps, "select id from p where v = 770")) is PScan


def test_decimal_key_is_not_point_get_but_answers(points):
    js, ps = points
    both(js, ps, "create table dp (price decimal(10,2) primary key, v bigint)")
    both(js, ps, "insert into dp values (5.00, 1), (6.50, 2)")
    assert type(leaf(ps, "select v from dp where price = 5")) is not PPointGet
    for sql in ("select v from dp where price = 5",
                "select v from dp where price = 6.50"):
        same_rows(js, ps, sql)


def test_point_cache_follows_inserts_and_commits(points):
    js, ps = points
    t = ps.catalog.table("test", "p")
    assert ps.query("select v from p where id = 1999") == [(19990,)]
    both(js, ps, "insert into p values (5001, 50010, 'n')")
    assert ps.query("select v from p where id = 5001") == [(50010,)]
    # an autocommit insert merges into the cache instead of re-sorting
    assert t._lookup_cache["PRIMARY"][0] == t.version
    assert len(t._lookup_cache["PRIMARY"][1]) == 2001
    for s in (js, ps):
        s.execute("begin")
        s.execute("insert into p values (9001, 90010, 'new')")
    assert ps.query("select v from p where id = 9001") == [(90010,)]
    for s in (js, ps):
        s.execute("commit")
    for sql in ("select v from p where id = 9001",
                "select count(*) from p where id = 9001",
                "select v from p where id = 2000"):
        same_rows(js, ps, sql)


def test_point_get_rows_come_from_the_index(points):
    """The executor gathers exactly the rows the host index returns."""
    _js, ps = points
    t = ps.catalog.table("test", "p")
    rows = t.index_lookup("PRIMARY", (1234,))
    assert len(rows) == 1 and int(np.asarray(t.data["v"][rows])[0]) == 12340
    assert len(t.index_lookup("PRIMARY", (999999,))) == 0
    lo = t.index_range_lookup("PRIMARY", (), 10, 12)
    assert sorted(int(x) for x in t.data["id"][lo]) == [10, 11, 12]


def test_sorted_index_caches_equal_the_reference(points):
    """The port sorts index keys with np.lexsort over the key columns, the
    reference a structured-dtype stable sort: the same (key, row) order,
    row versions and ties included, and the same unique-key cache."""
    js, ps = points
    for q in ("update r set v = -v where a = 3", "delete from r where a = 4 and b > 5",
              "insert into r values (4, 9, 1), (100, 0, 2)"):
        both(js, ps, q)
    for name in ("p", "r"):
        jt, pt = js.catalog.table("test", name), ps.catalog.table("test", name)
        jk, jr = jt._sorted_index("PRIMARY")
        pk, pr = pt._sorted_index("PRIMARY")
        assert pk.tolist() == jk.tolist() and pr.tolist() == jr.tolist()
        idx = pt.indexes["PRIMARY"]
        assert pt._uniq_sorted(idx).tolist() == jt._uniq_sorted(
            jt.indexes["PRIMARY"]).tolist()
