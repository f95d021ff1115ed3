"""The port's mesh tier (tidb_tpu_torch.parallel) against the reference's
(tidb_tpu.parallel) on identical TPC-H data at SF0.002, chunk capacity
4,096: the reference on its 8-device virtual CPU mesh (2 x 4), the port on
a 2 x 4 mesh of eight CPU shards. Shardings compare array for array;
query rows compare with the sqlite oracle (numbers within 1e-6 relative)
and with the reference (decimals exact as strings, floats within 1e-9
relative: a mesh adds partial float sums in exchange order)."""

import numpy as np
import pytest
import torch

from tidb_tpu.parallel import make_mesh as jax_make_mesh
from tidb_tpu.parallel import shard_table as jax_shard_table
from tidb_tpu.parallel.executor import build_dist_executor as jax_build
from tidb_tpu.parser import parse as jax_parse
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.tpch import load_tpch as jax_load_tpch
from tidb_tpu.testutil import mirror_to_sqlite, rows_equal
from tidb_tpu_torch.parallel import make_mesh, shard_table
from tidb_tpu_torch.parallel.executor import build_dist_executor
from tidb_tpu_torch.parser import parse
from tidb_tpu_torch.session import Session
from test_torch_session import _export_into
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
FLOAT_REL = 1e-9

Q1 = """select l_returnflag, l_linestatus,
               sum(l_quantity) as sum_qty,
               sum(l_extendedprice) as sum_base_price,
               sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
               sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
               avg(l_quantity) as avg_qty,
               avg(l_extendedprice) as avg_price,
               avg(l_discount) as avg_disc,
               count(*) as count_order
        from lineitem
        where l_shipdate <= date '1998-12-01' - interval '90' day
        group by l_returnflag, l_linestatus
        order by l_returnflag, l_linestatus"""

Q1_ORACLE = """select l_returnflag, l_linestatus,
               sum(l_quantity), sum(l_extendedprice),
               sum(l_extendedprice * (1 - l_discount)),
               sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)),
               avg(l_quantity), avg(l_extendedprice), avg(l_discount), count(*)
        from lineitem
        where l_shipdate <= '1998-09-02'
        group by l_returnflag, l_linestatus
        order by l_returnflag, l_linestatus"""

Q6 = """select sum(l_extendedprice * l_discount) as revenue
        from lineitem
        where l_shipdate >= date '1994-01-01'
          and l_shipdate < date '1994-01-01' + interval '1' year
          and l_discount between 0.06 - 0.01 and 0.06 + 0.01
          and l_quantity < 24"""

Q6_ORACLE = """select sum(l_extendedprice * l_discount)
        from lineitem
        where l_shipdate >= '1994-01-01' and l_shipdate < '1995-01-01'
          and l_discount between 0.05 and 0.07 and l_quantity < 24"""

QJOIN = """select l_returnflag, count(*) as n, sum(l_quantity) as q
           from lineitem join orders on l_orderkey = o_orderkey
           where o_totalprice > 100000
           group by l_returnflag
           order by l_returnflag"""

QGLOBAL = ("select count(*), sum(l_quantity), min(l_quantity), max(l_quantity) "
           "from lineitem")

TABLES = ("lineitem", "orders", "customer", "supplier", "nation", "region",
          "part", "partsupp")


@pytest.fixture(scope="module")
def pair(devices8):
    js = JaxSession(chunk_capacity=4096,
                    mesh=jax_make_mesh(n_shards=4, n_dcn=2, devices=devices8))
    jax_load_tpch(js.catalog, sf=0.002)
    ps = Session(chunk_capacity=4096, mesh=make_mesh(n_shards=4, n_dcn=2, devices=CPU8))
    for name in TABLES:
        _export_into(ps, js.catalog.table("test", name), name)
    return js, ps, mirror_to_sqlite(js.catalog)


def same_rows(got, want, ordered):
    """Equal within FLOAT_REL on floats, exactly elsewhere."""
    ok, msg = rows_equal(got, want, ordered=ordered, rel_tol=FLOAT_REL)
    assert ok, msg
    if not ordered:
        key = lambda r: tuple((v is None, str(v)) for v in r)  # noqa: E731
        got, want = sorted(got, key=key), sorted(want, key=key)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if not isinstance(a, float):
                assert a == b, (g, w)


def check(pair, sql, oracle_sql=None, ordered=False):
    js, ps, oracle = pair
    got = ps.query(sql)
    want = oracle.execute(oracle_sql or sql).fetchall()
    ok, msg = rows_equal(got, want, ordered=ordered)
    assert ok, f"{sql}\n{msg}"
    same_rows(got, js.query(sql), ordered)
    return got


def executors(root):
    out, stack = [], [root]
    while stack:
        e = stack.pop()
        out.append(type(e).__name__)
        stack.extend(e.children)
    return out


class TestShardTable:
    def test_roundtrip(self, pair):
        _js, ps, _ = pair
        t = ps.catalog.table("test", "nation")
        st = shard_table(t, ps.mesh)
        assert st.n_parts == 8
        d = torch.stack(st.data["n_nationkey"]).numpy()
        sel = torch.stack(st.sel).numpy()
        want, _ = t.column_slice("n_nationkey", 0, t.n)
        assert sorted(d[sel].tolist()) == sorted(want.tolist())

    @pytest.mark.parametrize("table", ["lineitem", "orders", "nation"])
    @pytest.mark.parametrize("encode", [False, True], ids=["raw", "for"])
    def test_layout_equals_reference(self, pair, devices8, table, encode):
        js, ps, _ = pair
        mesh = jax_make_mesh(n_shards=4, n_dcn=2, devices=devices8)
        want = jax_shard_table(js.catalog.table("test", table), mesh, encode=encode)
        got = shard_table(ps.catalog.table("test", table), ps.mesh, encode=encode)
        assert (got.n_parts, got.rows_per_part, got.total_rows) == (
            want.n_parts, want.rows_per_part, want.total_rows)
        assert {k: int(v) for k, v in got.refs.items()} == \
            {k: int(v) for k, v in want.refs.items()}
        assert np.array_equal(torch.stack(got.sel).numpy(), np.asarray(want.sel))
        for name in want.data:
            d = torch.stack(got.data[name]).numpy()
            assert d.dtype == np.asarray(want.data[name]).dtype, name
            assert np.array_equal(d, np.asarray(want.data[name])), name
            assert np.array_equal(torch.stack(got.valid[name]).numpy(),
                                  np.asarray(want.valid[name])), name

    def test_parts_live_on_their_devices(self, pair):
        _js, ps, _ = pair
        st = shard_table(ps.catalog.table("test", "lineitem"), ps.mesh)
        assert len(st.sel) == 8
        assert all(t.device == d for t, d in zip(st.sel, ps.mesh.devices))
        assert all(t.shape == (st.rows_per_part,) for t in st.data["l_quantity"])


class TestDistPlan:
    @pytest.mark.parametrize("sql,cls", [(Q1, "DistAggExec"),
                                         (QJOIN, "DistJoinAggExec")],
                             ids=["q1", "join"])
    def test_executor_class_in_both(self, pair, sql, cls):
        js, ps, _ = pair
        want = executors(jax_build(js._plan_select(jax_parse(sql)[0]), js._shard_cache))
        got = executors(build_dist_executor(ps._plan_select(parse(sql)[0]), ps._shard_cache))
        assert cls in want
        assert got == want


def _dist_node(root, cls):
    stack = [root]
    while stack:
        e = stack.pop()
        if type(e).__name__ == cls:
            return e
        stack.extend(e.children)
    raise AssertionError(f"no {cls}")


def _same_state(got, want):
    """A port state dict (tensors) against the reference's (jax arrays):
    every key, int64 states exactly, float sums within 1e-9 relative."""
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=FLOAT_REL, err_msg=k)
        else:
            assert np.array_equal(g, w), k


class TestFragmentFunctions:
    """distsql's fragment functions on identical shardings, each package
    taking its own plan's fields (the executors' inputs)."""

    @pytest.mark.parametrize("sql", [Q1, Q6], ids=["q1", "q6"])
    def test_dist_agg_fragment_equals_reference(self, pair, devices8, sql):
        from tidb_tpu.parallel import dist_agg_fragment as jax_fragment
        from tidb_tpu_torch.parallel import dist_agg_fragment

        js, ps, _ = pair
        jex = _dist_node(jax_build(js._plan_select(jax_parse(sql)[0]), js._shard_cache),
                         "DistAggExec")
        pex = _dist_node(build_dist_executor(ps._plan_select(parse(sql)[0]),
                                             ps._shard_cache), "DistAggExec")
        mesh = jax_make_mesh(n_shards=4, n_dcn=2, devices=devices8)
        want = jax_fragment(jax_shard_table(jex._scan.table, mesh), jex._stages,
                            jex.group_exprs, jex.aggs,
                            [n + 1 for n in jex.segment_sizes or []],
                            uid_map={c.name: c.uid for c in jex._scan.schema})
        got = dist_agg_fragment(shard_table(pex._scan.table, ps.mesh), pex._stages,
                                pex.group_exprs, pex.aggs,
                                [n + 1 for n in pex.segment_sizes or []],
                                uid_map={c.name: c.uid for c in pex._scan.schema})
        _same_state(got, want)

    def test_dist_join_agg_fragment_equals_reference(self, pair, devices8):
        from tidb_tpu.parallel import dist_join_agg_fragment as jax_fragment
        from tidb_tpu_torch.parallel import dist_join_agg_fragment

        js, ps, _ = pair
        mesh = jax_make_mesh(n_shards=4, n_dcn=2, devices=devices8)
        outs = []
        for ex, shard, m, tag in (
                (_dist_node(jax_build(js._plan_select(jax_parse(QJOIN)[0]), js._shard_cache),
                            "DistJoinAggExec"), jax_shard_table, mesh, "jax"),
                (_dist_node(build_dist_executor(ps._plan_select(parse(QJOIN)[0]),
                                                ps._shard_cache), "DistJoinAggExec"),
                 shard_table, ps.mesh, "port")):
            j = ex._join
            pk = j.eq_left if j.build_side == 1 else j.eq_right
            bk = j.eq_right if j.build_side == 1 else j.eq_left
            fn = jax_fragment if tag == "jax" else dist_join_agg_fragment
            outs.append(fn(shard(ex._probe_scan.table, m), shard(ex._build_scan.table, m),
                           ex._probe_stages, ex._build_stages, pk[0], bk[0],
                           {c.name: c.uid for c in ex._probe_scan.schema},
                           {c.name: c.uid for c in ex._build_scan.schema},
                           ex._post_stages, ex.group_exprs, ex.aggs,
                           [n + 1 for n in ex.segment_sizes or []]))
        (want, want_ovf), (got, got_ovf) = outs
        assert int(want_ovf) == got_ovf == 0
        _same_state(got, want)


class TestDistResults:
    def test_q1(self, pair):
        got = check(pair, Q1, Q1_ORACLE, ordered=True)
        assert len(got) >= 3

    def test_q6(self, pair):
        check(pair, Q6, Q6_ORACLE)

    def test_join_agg(self, pair):
        check(pair, QJOIN, ordered=True)

    def test_global_agg(self, pair):
        check(pair, QGLOBAL)

    def test_matches_single_device(self, pair):
        _js, ps, _ = pair
        single = Session(chunk_capacity=4096, device="cpu")
        single.catalog = ps.catalog
        same_rows(ps.query(Q1), single.query(Q1), ordered=True)

    @pytest.mark.parametrize("sql", [Q6, QJOIN], ids=["q6", "join"])
    def test_summary_counts_fragments_as_the_reference(self, pair, sql):
        js, ps, _ = pair

        def fragments(s):
            return {e["digest"]: e["fragments"] for e in s.catalog.stmt_summary.top(1000)}

        before = (fragments(js), fragments(ps))
        js.query(sql)
        ps.query(sql)
        after = (fragments(js), fragments(ps))
        got, want = ({d: n - b.get(d, 0) for d, n in a.items() if n != b.get(d, 0)}
                     for a, b in ((after[1], before[1]), (after[0], before[0])))
        assert got == want and sum(got.values()) > 0
