"""The memo-based join-order search (planner/cascades.py) behind
tidb_enable_cascades_planner, through the port against the reference.

Mirrors tests/test_cascades.py at n_parts = 1 (the port has no mesh; the
memo's exchange cost is then zero, and the mesh-cost cases wait for the
multi-device tier). Q3 and Q5 shapes run on the same TPC-H data in both
packages and against the sqlite oracle; the memo's modeled cost is never
above the greedy orderer's, and equals the reference's; the twelve-table
chain reaches the iterative DP search. Plans compare as EXPLAIN text."""

import re

import numpy as np
import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.tpch import load_tpch as jax_load_tpch
from tidb_tpu.testutil import mirror_to_sqlite, rows_equal
from tidb_tpu_torch.session import Session

from test_torch_session import _export_into, _same
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

Q5ISH = """select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = 'ASIA'
group by n_name order by revenue desc"""

Q3ISH = """select o_orderkey, sum(l_extendedprice) as rev
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey
group by o_orderkey order by rev desc limit 10"""

_TABLES = ("lineitem", "orders", "customer", "supplier", "nation", "region")


@pytest.fixture(scope="module")
def tpch():
    js = JaxSession(chunk_capacity=4096)
    jax_load_tpch(js.catalog, sf=0.002)
    js.execute("set tidb_tpu_compaction = 0")
    ps = Session(device="cpu", chunk_capacity=4096)
    for name in _TABLES:
        _export_into(ps, js.catalog.table("test", name), name)
    for s in (js, ps):
        s.execute("analyze table " + ", ".join(_TABLES))
    return js, ps, mirror_to_sqlite(js.catalog)


def modeled_cost(mod, session, sql, cascades):
    """Sum of modeled intermediate join cardinalities of the optimized
    logical plan of `sql`, with `mod` the package ("tidb_tpu" or
    "tidb_tpu_torch")."""
    import importlib

    parse = importlib.import_module(f"{mod}.parser").parse
    Binder = importlib.import_module(f"{mod}.planner.binder").Binder
    lg = importlib.import_module(f"{mod}.planner.logical")
    ph = importlib.import_module(f"{mod}.planner.physical")
    optimize_logical = importlib.import_module(f"{mod}.planner.rules").optimize_logical
    total = 0.0

    def walk(p):
        nonlocal total
        for ch in getattr(p, "children", []):
            walk(ch)
        if isinstance(p, lg.LJoin) and p.kind in ("inner", "cross"):
            l, r = p.children
            if p.eq_conds:
                total += float(ph.eq_join_rows(
                    l, r, p.eq_conds, ph._estimate(l), ph._estimate(r)))
            else:
                total += float(ph._estimate(l)) * float(ph._estimate(r))

    ctx = lg.BuildContext(catalog=session.catalog, db="test", binder=Binder(),
                          execute_subplan=session._execute_subplan)
    walk(optimize_logical(lg.build_select(parse(sql)[0], ctx), cascades=cascades))
    return total


def _explain(s, sql):
    return [r[0] for r in s.query("explain " + sql)]


def _memo(s, sql):
    s.execute("set tidb_enable_cascades_planner = 1")
    try:
        return s.query(sql), _explain(s, sql)
    finally:
        s.execute("set tidb_enable_cascades_planner = 0")


@pytest.mark.parametrize("sql", [Q5ISH, Q3ISH], ids=["q5", "q3"])
def test_correct_under_memo_and_plan_matches_reference(tpch, sql):
    js, ps, oracle = tpch
    want = oracle.execute(sql).fetchall()
    greedy = ps.query(sql)
    got, plan = _memo(ps, sql)
    jgot, jplan = _memo(js, sql)
    ok, msg = rows_equal(greedy, want, ordered=True)
    assert ok, f"greedy: {msg}"
    ok, msg = rows_equal(got, want, ordered=True)
    assert ok, f"memo: {msg}"
    _same(got, jgot, ordered=True)
    assert plan == jplan


def test_memo_cost_never_worse_than_greedy(tpch):
    js, ps, _ = tpch
    greedy = modeled_cost("tidb_tpu_torch", ps, Q5ISH, cascades=False)
    memo = modeled_cost("tidb_tpu_torch", ps, Q5ISH, cascades=True)
    assert memo <= greedy * 1.0001
    assert memo == pytest.approx(modeled_cost("tidb_tpu", js, Q5ISH, cascades=True))
    assert greedy == pytest.approx(modeled_cost("tidb_tpu", js, Q5ISH, cascades=False))


def _small_pair(setup):
    js = JaxSession(chunk_capacity=1024)
    js.execute("set tidb_tpu_compaction = 0")
    ps = Session(device="cpu", chunk_capacity=1024)
    for s in (js, ps):
        for sql in setup:
            s.execute(sql)
    return js, ps


def test_memo_beats_greedy_on_adversarial_shape():
    """Greedy seeds at the smallest table `a`, whose only edge is a huge
    fanout into `b`; the memo reduces the selective b-c edge first."""
    js, ps = _small_pair([
        "create table a (k bigint)",
        "create table b (k bigint, m bigint)",
        "create table c (m bigint, z bigint)",
        "insert into a values " + ", ".join(f"({i % 3})" for i in range(10)),
        "insert into b values " + ", ".join(f"({i % 3}, {i})" for i in range(300)),
        "insert into c values " + ", ".join(f"({i}, {i})" for i in range(300)),
        "analyze table a, b, c"])
    sql = "select count(*) from a, b, c where a.k = b.k and b.m = c.m"
    memo = modeled_cost("tidb_tpu_torch", ps, sql, True)
    assert memo < modeled_cost("tidb_tpu_torch", ps, sql, False)
    assert memo == pytest.approx(modeled_cost("tidb_tpu", js, sql, True))
    for flag in ("1", "0"):
        for s in (js, ps):
            s.execute(f"set tidb_enable_cascades_planner = {flag}")
        assert ps.query(sql) == js.query(sql) == [(1000,)]


def test_disconnected_graph_crosses_late():
    """Cross splits are enumerated even when connected splits exist: with
    only an a-b edge, the best plan joins a-b first and crosses c last."""
    js, ps = _small_pair([
        "create table a (k bigint)",
        "create table b (k bigint)",
        "create table c (z bigint)",
        "insert into a values (1)",
        "insert into b values " + ", ".join(f"({i})" for i in range(200)),
        "insert into c values " + ", ".join(f"({i})" for i in range(200)),
        "analyze table a, b, c"])
    sql = "select count(*) from a, b, c where a.k = b.k"
    greedy = modeled_cost("tidb_tpu_torch", ps, sql, False)
    memo = modeled_cost("tidb_tpu_torch", ps, sql, True)
    assert memo <= greedy * 1.0001, (memo, greedy)
    got, plan = _memo(ps, sql)
    jgot, jplan = _memo(js, sql)
    assert got == jgot == ps.query(sql) == [(200,)]
    assert plan == jplan


class TestWideJoinsIDP:
    """Beyond MAX_LEAVES the memo collapses connected windows by
    iterative DP instead of falling back to greedy."""

    def test_twelve_table_chain_optimizes(self):
        import tidb_tpu_torch.planner.cascades as C

        n = 12
        setup = []
        for i in range(n):
            setup.append(f"create table c{i} (a bigint, b bigint)")
            setup.append(f"insert into c{i} values " + ",".join(
                f"({j}, {j + i})" for j in range(1, 6)))
            setup.append(f"analyze table c{i}")
        js, ps = _small_pair(setup)
        joins = " ".join(
            f"join c{i} on c{i - 1}.b - {i - 1} = c{i}.a" if i else "c0"
            for i in range(n))
        sql = "select count(*), sum(c11.b) from " + joins
        calls = []
        orig = C._idp_search

        def spy(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        C._idp_search = spy
        try:
            got, plan = _memo(ps, sql)
        finally:
            C._idp_search = orig
        assert calls, "the 12-leaf join never reached the IDP search"
        jgot, jplan = _memo(js, sql)
        conn = mirror_to_sqlite(js.catalog)
        ok, msg = rows_equal(got, conn.execute(sql).fetchall(), ordered=True)
        assert ok, msg
        assert got == jgot
        assert plan == jplan
        # each of the 12 tables is scanned exactly once
        assert len(re.findall(r"table:c\d+", "\n".join(plan))) == 12, plan

    def test_idp_matches_greedy_results_star(self):
        setup = ["create table hub (k bigint, v bigint)",
                 "insert into hub values " + ",".join(
                     f"({i % 4}, {i})" for i in range(40))]
        for i in range(11):
            setup.append(f"create table sp{i} (k bigint, w bigint)")
            setup.append(f"insert into sp{i} values (0, {i}), (1, {i + 100}), "
                         f"(2, {i + 200}), (3, {i + 300})")
            setup.append(f"analyze table sp{i}")
        setup.append("analyze table hub")
        js, ps = _small_pair(setup)
        sql = ("select sum(hub.v), " + ", ".join(
            f"sum(sp{i}.w)" for i in range(11)) + " from hub "
            + " ".join(f"join sp{i} on hub.k = sp{i}.k" for i in range(11)))
        got, _plan = _memo(ps, sql)
        conn = mirror_to_sqlite(js.catalog)
        ok, msg = rows_equal(got, conn.execute(sql).fetchall(), ordered=True)
        assert ok, msg
        assert got == _memo(js, sql)[0]


def test_eager_agg_cost_based_under_memo():
    """The cost-based eager-aggregation placement (cascades' LOCAL_WORK)
    plans as the reference's does and stays exact."""
    rng = np.random.default_rng(5)
    li = ",".join(f"({int(k)}, {int(q)})" for k, q in zip(
        rng.integers(0, 300, 3000), rng.integers(1, 50, 3000)))
    js, ps = _small_pair([
        "create table li (ok bigint, qty bigint)",
        "create table od (ok bigint, pri bigint)",
        "insert into li values " + li,
        "insert into od values " + ",".join(f"({i}, {i % 5})" for i in range(300)),
        "analyze table li, od"])
    sql = ("select pri, count(*), sum(qty) from li join od on li.ok = od.ok "
           "group by pri order by pri")
    got, plan = _memo(ps, sql)
    jgot, jplan = _memo(js, sql)
    assert got == jgot == ps.query(sql)
    assert plan == jplan
