"""All 22 TPC-H queries through the port (tidb_tpu_torch on the CPU), the
port's counterpart of tests/test_tpch.py.

- SF 0.1 (lineitem ~600k rows, chunk capacity 8,192): every query against the
  indexed sqlite oracle, ordered, with the oracle's own SQL variants. The
  tables are generated once by the reference's generator (seed 7), mirrored
  into sqlite and exported into the port (test_torch_session._export_into).
  Q9 returns no rows at this scale in both engines and in sqlite, so its
  equality checks nothing.
- SF 0.01: the thirteen queries whose plans group on the device generic
  aggregation (Q2, Q3, Q7, Q8, Q9, Q10, Q11, Q13, Q15, Q16, Q17, Q18, Q20)
  against the JAX reference with `tidb_device_engine_mode = 'force'` (its
  accelerator routing), unordered, each asserted through
  aggregate.DEVICE_GENERIC_TOTAL to have run on the port's device path:
  fused (FusedScanAggExec's generic strategy) for Q15, Q17, Q18 and Q20.
- The fused scan->top-k root (FusedScanTopNExec) on lineitem with one sort
  key (the threshold cut) and with three (the full merge), a full ORDER BY
  under the capacity gate, and a LIMIT above the chunk capacity, which
  takes the classic delegate: each against the reference, ordered.
"""

import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.catalog import Catalog as JaxCatalog
from tidb_tpu.storage.tpch import load_tpch as jax_load_tpch
from tidb_tpu.testutil import index_tpch_oracle, mirror_to_sqlite, rows_equal
from tidb_tpu_torch.executor import aggregate as agg
from tidb_tpu_torch.executor import pipeline as pl
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.tpch_queries import Q

from test_torch_session import _export_into, _same

GENERIC = ("q2", "q3", "q7", "q8", "q9", "q10", "q11", "q13", "q15", "q16", "q17",
           "q18", "q20")
FUSED_GENERIC = ("q15", "q17", "q18", "q20")
# Q17 divides a decimal sum by 7.0. XLA folds the reference's (sum / 100) / 7
# into sum / 700; the port divides in two steps, as sqlite does on the same
# values, and lands one ulp away. Q17 compares within rows_equal's tolerance.
ULP_APART = ("q17",)


def _port_copy(jax_catalog, chunk_capacity=None) -> Session:
    ps = Session(device="cpu", chunk_capacity=chunk_capacity)
    for name in jax_catalog.tables("test"):
        _export_into(ps, jax_catalog.table("test", name), name)
    return ps


@pytest.fixture(scope="module")
def grid():
    # a bare reference catalog: the generator and the oracle need no
    # reference Session (and so start none of its background machinery)
    cat = JaxCatalog()
    jax_load_tpch(cat, sf=0.1)
    oracle = index_tpch_oracle(mirror_to_sqlite(cat))
    return _port_copy(cat, chunk_capacity=8192), oracle


@pytest.mark.parametrize("name", list(Q))
def test_tpch_sf01_matches_sqlite(grid, name):
    ps, oracle = grid
    sql, osql = Q[name]
    agg.reset_counters()
    got = ps.query(sql)
    want = oracle.execute(osql or sql).fetchall()
    ok, msg = rows_equal(got, want, ordered=True)
    assert ok, f"{name}: {msg}"
    if name != "q9":
        assert got, f"{name} returned no rows"
    ran = agg.DEVICE_GENERIC_TOTAL
    assert (ran["classic"] + ran["fused"] > 0) == (name in GENERIC), (name, ran)
    if name in FUSED_GENERIC:
        assert ran["fused"] > 0, (name, ran)


@pytest.fixture(scope="module")
def pair():
    js = JaxSession()
    js.execute("set tidb_tpu_compaction = 0")
    js.execute("set tidb_device_engine_mode = 'force'")
    jax_load_tpch(js.catalog, sf=0.01)
    return js, _port_copy(js.catalog)


@pytest.mark.parametrize("name", GENERIC)
def test_generic_queries_match_reference_on_the_device_path(pair, name):
    js, ps = pair
    sql = Q[name][0]
    agg.reset_counters()
    got = ps.query(sql)
    ran = dict(agg.DEVICE_GENERIC_TOTAL)
    want = js.query(sql)
    if name in ULP_APART:
        ok, msg = rows_equal(got, want)
        assert ok, msg
    else:
        _same(got, want, ordered=False)
    assert ran["classic"] + ran["fused"] > 0, ran
    assert (ran["fused"] > 0) == (name in FUSED_GENERIC), ran


@pytest.mark.parametrize("name", ["q3", "q18_low"])
def test_generic_host_engine_matches_the_device_path(pair, name):
    """tidb_device_engine_mode = 'off' keeps the host groupby (the oracle
    mode chip_smoke times against): the same rows, no device generic run.
    Q18 at SF 0.01 has no order above 300 units; 200 gives rows."""
    _js, ps = pair
    sql = Q["q3"][0] if name == "q3" else Q["q18"][0].replace("> 300", "> 200")
    want = ps.query(sql)
    ps.execute("set tidb_device_engine_mode = 'off'")
    try:
        agg.reset_counters()
        got = ps.query(sql)
        assert agg.DEVICE_GENERIC_TOTAL == {"classic": 0, "fused": 0}
    finally:
        ps.execute("set tidb_device_engine_mode = 'auto'")
    assert want and got == want


TOPN = {
    "single_key": ("select l_orderkey, l_linenumber, l_extendedprice from lineitem "
                   "where l_shipdate >= date '1995-01-01' "
                   "order by l_extendedprice desc limit 10", "topn"),
    "multi_key": ("select l_orderkey, l_linenumber, l_extendedprice from lineitem "
                  "where l_shipdate >= date '1995-01-01' "
                  "order by l_extendedprice desc, l_orderkey, l_linenumber limit 100", "topn"),
    "ties_nulls_asc": ("select l_orderkey, l_linenumber, l_quantity from lineitem "
                       "order by l_quantity limit 50", "topn"),
    "full_sort": ("select n_name, n_regionkey from nation order by n_regionkey desc, n_name",
                  "topn"),
    "over_capacity": ("select l_orderkey, l_linenumber, l_extendedprice from lineitem "
                      "where l_shipdate >= date '1995-01-01' "
                      "order by l_extendedprice desc limit 70000", "delegate"),
}


@pytest.mark.parametrize("name", list(TOPN))
def test_fused_topn_matches_reference(pair, name):
    js, ps = pair
    sql, route = TOPN[name]
    pl.reset_counters()
    got = ps.query(sql)
    assert pl.PIPELINE_FUSED_TOTAL[route] == 1, pl.PIPELINE_FUSED_TOTAL
    assert pl.PIPELINE_FUSED_TOTAL["topn"] == (route == "topn")
    want = js.query(sql)
    assert want
    _same(got, want, ordered=True)


def test_fused_topn_off_takes_the_delegate(pair):
    """ExecContext.fused_topn = False (the reference's plan feedback sets it
    for a digest whose LIMIT overflowed the state) keeps the classic sort."""
    from tidb_tpu_torch.executor import build_executor, run_plan
    from tidb_tpu_torch.parser import parse

    js, ps = pair
    sql = TOPN["single_key"][0]
    phys = ps._plan_select(parse(sql)[0])
    ctx = ps._exec_ctx(plan=phys)
    ctx.fused_topn = False
    pl.reset_counters()
    rows = run_plan(build_executor(phys), ctx).rows
    assert pl.PIPELINE_FUSED_TOTAL["delegate"] == 1 and pl.PIPELINE_FUSED_TOTAL["topn"] == 0
    _same(rows, js.query(sql), ordered=True)
