"""Table partitioning through the port (tidb_tpu_torch on the CPU) against
the JAX package: PARTITION BY RANGE / HASH, the planner's pruning into a
PartitionScan of the matching partitions (PartitionScanExec reading the
partitions' cached row ids), the RANGE bound refusing rows past a
bound-less last partition, and the DDL's refusals (cases from
tests/test_partitions.py; its EXPLAIN, SHOW CREATE and information_schema
asserts wait for those statements, so the plans are compared through
each package's planner instead)."""

import numpy as np
import pytest

from tidb_tpu.parser import parse as jax_parse
from tidb_tpu.session import Session as JaxSession
from tidb_tpu_torch.executor.scan import PartitionScanExec
from tidb_tpu_torch.executor import build_executor
from tidb_tpu_torch.parser import parse
from tidb_tpu_torch.session import Session

from test_torch_keys import both, same_rows
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

_RANGE = """create table pt (id bigint, v bigint)
  partition by range (id) (
    partition p0 values less than (100),
    partition p1 values less than (200),
    partition p2 values less than maxvalue)"""


def _pair():
    js = JaxSession()
    js.execute("set tidb_tpu_compaction = 0")
    return js, Session(device="cpu")


@pytest.fixture()
def pair():
    js, ps = _pair()
    for sql in (_RANGE, "insert into pt values "
                + ",".join(f"({i},{i * 2})" for i in range(0, 300, 5))):
        both(js, ps, sql)
    return js, ps


def _partition_scans(plan):
    out, stack = [], [plan]
    while stack:
        node = stack.pop()
        if type(node).__name__ == "PPartitionScan":
            out.append(tuple(node.part_names))
        stack.extend(node.children)
    return out


def _same_plan_partitions(js, ps, sql):
    """Both planners prune `sql` to the same partitions (or neither)."""
    want = _partition_scans(js._plan_select(jax_parse(sql)[0]))
    got = _partition_scans(ps._plan_select(parse(sql)[0]))
    assert got == want, (sql, got, want)
    return got


_QUERIES = [
    ("range_mid", "select count(*), sum(v) from pt where id >= 100 and id < 200",
     [("p1",)]),
    ("eq", "select v from pt where id = 250", [("p2",)]),
    ("open_prefix", "select count(*) from pt where id < 100", [("p0",)]),
    ("open_suffix", "select id, v from pt where id > 150", [("p1", "p2")]),
    ("no_partition_predicate", "select count(*) from pt where v > 100", []),
    ("empty_range", "select count(*) from pt where id > 300 and id < 10", [()]),
    ("residual", "select id from pt where id >= 100 and id < 200 and v > 300",
     [("p1",)]),
]


@pytest.mark.parametrize("name,sql,parts", _QUERIES, ids=[q[0] for q in _QUERIES])
def test_pruned_plans_and_results_match_reference(pair, name, sql, parts):
    js, ps = pair
    assert _same_plan_partitions(js, ps, sql) == parts
    same_rows(js, ps, sql)


def test_partition_scan_executor_reads_only_its_partitions(pair):
    _js, ps = pair
    plan = ps._plan_select(parse("select id from pt where id < 100")[0])
    root = build_executor(plan)
    stack, found = [root], []
    while stack:
        e = stack.pop()
        if isinstance(e, PartitionScanExec):
            found.append(e)
        stack.extend(e.children)
    assert len(found) == 1 and found[0].part_ids == (0,)
    rows = ps.query("select id from pt where id < 100")
    assert sorted(r[0] for r in rows) == list(range(0, 100, 5))


@pytest.mark.parametrize("stmts", [
    ["update pt set v = 0 where id >= 200", "delete from pt where id < 100"],
    ["update pt set id = id + 100 where id < 50"],
    ["begin", "insert into pt values (7, 1), (107, 2)", "delete from pt where id = 105"],
])
def test_dml_respects_partitions(pair, stmts):
    js, ps = pair
    for sql in stmts:
        both(js, ps, sql)
    for sql in ("select count(*), sum(v) from pt",
                "select id, v from pt where id < 100",
                "select id, v from pt where id >= 100 and id < 200",
                "select id, v from pt where id = 7"):
        same_rows(js, ps, sql)


_DDL_CASES = [
    ("overflow_without_maxvalue",
     ["create table pr (id bigint) partition by range (id) "
      "(partition p0 values less than (10))",
      "insert into pr values (11)", "insert into pr values (9), (12)",
      "insert into pr values (3)", "update pr set id = 10 where id = 3",
      "insert into pr values (NULL)"]),
    ("bad_bounds", ["create table pb (id bigint) partition by range (id) "
                    "(partition a values less than (20), "
                    "partition b values less than (10))"]),
    ("interior_maxvalue", ["create table tm (k bigint) partition by range (k) ("
                           "partition p0 values less than (10), "
                           "partition p1 values less than maxvalue, "
                           "partition p2 values less than (20))"]),
    ("duplicate_bounds", ["create table td (k bigint) partition by range (k) ("
                          "partition p0 values less than (10), "
                          "partition p1 values less than (10))"]),
    ("non_integer_column", ["create table ts (name varchar(10)) "
                            "partition by range (name) "
                            "(partition p0 values less than (3))"]),
    ("unknown_column", ["create table tu (a bigint) partition by hash (b) "
                        "partitions 4"]),
]


@pytest.mark.parametrize("name,stmts", _DDL_CASES, ids=[c[0] for c in _DDL_CASES])
def test_partition_ddl_and_bounds_match_reference(name, stmts):
    js, ps = _pair()
    for sql in stmts:
        both(js, ps, sql)
    if js.catalog.has_table("test", "pr"):
        same_rows(js, ps, "select id from pr")


def test_negative_range_bounds():
    js, ps = _pair()
    for sql in ("create table tn (k bigint) partition by range (k) ("
                "partition p0 values less than (-10), "
                "partition p1 values less than (0), "
                "partition p2 values less than maxvalue)",
                "insert into tn values (-20),(-5),(5)"):
        both(js, ps, sql)
    sql = "select k from tn where k < -10"
    assert _same_plan_partitions(js, ps, sql) == [("p0",)]
    same_rows(js, ps, sql)
    assert ps.query(sql) == [(-20,)]


def test_hash_partitions_prune_on_equality_only():
    js, ps = _pair()
    for sql in ("create table ph (id bigint, v bigint) "
                "partition by hash (id) partitions 4",
                "insert into ph values " + ",".join(f"({i},{i})" for i in range(40))
                + ", (NULL, -1)"):
        both(js, ps, sql)
    assert _same_plan_partitions(js, ps, "select v from ph where id = 6") == [("p2",)]
    assert _same_plan_partitions(js, ps, "select v from ph where id < 6") == []
    for sql in ("select v from ph where id = 6", "select v from ph where id < 6",
                "select count(*) from ph where id is null", "select sum(v) from ph"):
        same_rows(js, ps, sql)


def test_partition_scan_feeds_the_segment_aggregation():
    """A range-partitioned table large enough for a segment store: the
    pruned PartitionScan feeds the classic segment aggregation (the
    tidb_segagg path on the card), equal to the reference and numpy."""
    js, ps = _pair()
    n = 20_000
    rng = np.random.default_rng(3)
    ids = rng.permutation(n).astype(np.int64)
    g = (ids % 5).astype(np.int64)
    v = rng.integers(-1000, 1000, n).astype(np.int64)
    for s in (js, ps):
        s.execute("set tidb_tpu_segment_rows = 4096")
        s.execute("create table pa (id bigint, g bigint, v decimal(10,2)) "
                  "partition by range (id) (partition p0 values less than (5000), "
                  "partition p1 values less than (10000), "
                  "partition p2 values less than maxvalue)")
        s.catalog.table("test", "pa").insert_columns({"id": ids, "g": g, "v": v})
    sql = ("select g, count(*), sum(v) from pa where id >= 5000 and id < 10000 "
           "group by g order by g")
    assert _same_plan_partitions(js, ps, sql) == [("p1",)]
    same_rows(js, ps, sql, ordered=True)
    m = (ids >= 5000) & (ids < 10000)
    got = ps.query(sql)
    assert [(r[0], r[1]) for r in got] == [(k, int((m & (g == k)).sum())) for k in range(5)]
    assert [int(r[2].replace(".", "")) for r in got] == \
        [int(v[m & (g == k)].sum()) for k in range(5)]
