"""DCN broadcast joins on the port (the reference's tests/test_dcn_join.py
on both fleets): `fact JOIN dim...` with the fact table partitioned over
the workers and every dimension shipped whole to each of them. SSB Q3.2
runs on two port workers and on two reference workers from the same
generator, and the rows compare as `_same` does. The port's SSB
generator (tidb_tpu_torch/storage/ssb.py, a copy) makes the reference's
tables value for value."""

import numpy as np
import pytest
import torch

import tidb_tpu.storage.ssb as jssb
import tidb_tpu_torch.parallel.dcn as pdcn
import tidb_tpu_torch.storage.ssb as pssb
from tidb_tpu.session import Session as JaxSession
from tidb_tpu_torch.errors import UnsupportedError
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.types import TypeKind
from test_torch_dcn import (  # noqa: F401 (autouse)
    feedback_stores_cleared, fleets, same)
from test_torch_session import (  # noqa: F401
    reference_witness_off, reference_witness_paused)

torch.set_num_threads(1)

SF = 0.002
DIMS = ["ssb_date", "ssb_customer", "ssb_supplier", "ssb_part"]


def _ddl(name):
    cols = []
    for cname, t, nn in pssb.SSB_SCHEMAS[name]:
        if t.kind == TypeKind.STRING:
            sql_t = "varchar(32)"
        elif t.kind == TypeKind.DATE:
            sql_t = "date"
        elif t.kind == TypeKind.DECIMAL:
            sql_t = f"decimal({t.precision},{t.scale})"
        else:
            sql_t = "bigint"
        cols.append(f"{cname} {sql_t}{' not null' if nn else ''}")
    return f"create table {name} ({', '.join(cols)})"


@pytest.fixture(scope="module")
def ssb_fleets():
    """Both fleets get the generator's rows as columns (the DDL through
    SQL): every dimension broadcast whole, lineorder split in halves.
    Module-scoped, so it pauses the reference's lock-order witness
    itself (the autouse fixture covers each test, not this setup)."""
    from tidb_tpu_torch.sharding.shuffle import extract_live_columns

    oracle = Session(device="cpu")
    pssb.load_ssb(oracle.catalog, sf=SF)
    cols = {n: extract_live_columns(oracle.catalog.table("test", n))
            for n in DIMS + ["lineorder"]}
    with reference_witness_off(), fleets(2) as (_pw, pc, _jw, jc):
        for cl in (pc, jc):
            for name in DIMS + ["lineorder"]:
                cl.broadcast_exec(_ddl(name))
            for name in DIMS:
                a, v, st, _n = cols[name]
                cl.broadcast_table(name, arrays=a, valids=v, strings=st)
            a, v, st, n = cols["lineorder"]
            for i, sl in enumerate((slice(0, n // 2), slice(n // 2, n))):
                cl.load_partition(
                    i, "lineorder", arrays={k: x[sl] for k, x in a.items()},
                    valids={k: x[sl] for k, x in v.items()},
                    strings={k: x[sl] for k, x in st.items()})
        yield pc, jc, oracle


def test_ssb_generator_equals_reference():
    js = JaxSession()
    jssb.load_ssb(js.catalog, sf=SF)
    ps = Session(device="cpu")
    pssb.load_ssb(ps.catalog, sf=SF)
    assert list(pssb.SSB_QUERIES) == list(jssb.SSB_QUERIES)
    for name in DIMS + ["lineorder"]:
        jt, pt = js.catalog.table("test", name), ps.catalog.table("test", name)
        assert pt.n == jt.n > 0
        for c in jt.schema.columns:
            np.testing.assert_array_equal(np.asarray(pt.data[c.name][:pt.n]),
                                          np.asarray(jt.data[c.name][:jt.n]))
        sql = f"select * from {name} order by 1 limit 50"
        same(ps.query(sql), js.query(sql))


def test_ssb_q32_on_cluster(ssb_fleets):
    pc, jc, oracle = ssb_fleets
    sql = pssb.SSB_QUERIES["q3.2"]
    got = pc.query(sql)
    assert got, "q3.2 selected nothing"
    same(got, jc.query(sql), ordered=False)
    same(got, oracle.query(sql), ordered=False)


def test_join_aggregate_and_topn_shapes(ssb_fleets):
    pc, jc, oracle = ssb_fleets
    agg = ("select d_year, count(*) as n, sum(lo_quantity) as q "
           "from lineorder join ssb_date on lo_orderdate = d_datekey "
           "where d_year >= 1994 group by d_year")
    same(pc.query(agg), jc.query(agg), ordered=False)
    same(pc.query(agg), oracle.query(agg), ordered=False)
    topn = ("select lo_orderkey, lo_revenue as r "
            "from lineorder join ssb_date on lo_orderdate = d_datekey "
            "where d_year = 1995 order by r desc, lo_orderkey limit 7")
    assert pc.query(topn) == jc.query(topn) == oracle.query(topn)


def test_unregistered_or_outer_join_refuses(ssb_fleets):
    with pytest.raises(UnsupportedError, match="not broadcast"):
        pdcn.partial_rewrite(
            "select count(*) as n from lineorder join nowhere on "
            "lo_custkey = x", partitioned={"lineorder"}, broadcast=set())
    with pytest.raises(UnsupportedError, match="partitioned"):
        pdcn.partial_rewrite("select count(*) as n from a join b on x = y",
                             partitioned=set(), broadcast={"a", "b"})
    with pytest.raises(UnsupportedError, match="left join"):
        pdcn.partial_rewrite(
            "select count(*) as n from lineorder left join ssb_date on "
            "lo_orderdate = d_datekey",
            partitioned={"lineorder"}, broadcast={"ssb_date"})
