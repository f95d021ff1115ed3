"""SSB's 13 queries and TPC-DS Q95 on the port against sqlite and the
reference, on the CPU (the port's counterpart of tests/test_workloads.py).

Each package generates its own tables from the same scale factor and seed
(tidb_tpu_torch/storage/ssb.py and tpcds.py beside the reference's): the
tables must be equal value for value. The reference's tables are
mirrored into sqlite (testutil.mirror_to_sqlite); the port's rows must
equal sqlite's (SSB unordered, as the reference's test compares, its
ORDER BYs leaving revenue ties open; Q95 ordered) and the reference's
rows on the same data.
"""

import numpy as np
import pytest

from test_torch_session import _same, reference_witness_paused  # noqa: F401
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import ssb as jssb
from tidb_tpu.storage import tpcds as jtpcds
from tidb_tpu.testutil import mirror_to_sqlite, rows_equal
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.ssb import SSB_QUERIES, load_ssb
from tidb_tpu_torch.storage.tpcds import Q95, Q95_SQLITE, TPCDS_SCHEMAS, load_tpcds_q95

SSB_SF = 0.002
Q95_SF = 0.2


def _pair(load_port, load_ref, sf):
    js = JaxSession(chunk_capacity=8192)
    ref_counts = load_ref(js.catalog, sf=sf)
    ps = Session(device="cpu", chunk_capacity=8192)
    port_counts = load_port(ps.catalog.base, sf=sf)
    assert port_counts == ref_counts
    return js, ps, mirror_to_sqlite(js.catalog)


@pytest.fixture(scope="module")
def ssb():
    return _pair(load_ssb, jssb.load_ssb, SSB_SF)


@pytest.fixture(scope="module")
def tpcds():
    return _pair(load_tpcds_q95, jtpcds.load_tpcds_q95, Q95_SF)


def _tables_equal(js, ps, names):
    for name in names:
        jt, pt = js.catalog.table("test", name), ps.catalog.table("test", name)
        assert jt.n == pt.n, name
        assert [c.name for c in jt.schema.columns] == [c.name for c in pt.schema.columns]
        assert jt.schema.primary_key == pt.schema.primary_key, name
        for c in jt.schema.columns:
            n = jt.n
            assert np.array_equal(np.asarray(jt.data[c.name][:n]), pt.data[c.name][:n]), \
                (name, c.name)
            assert np.array_equal(np.asarray(jt.valid[c.name][:n]), pt.valid[c.name][:n]), \
                (name, c.name)
            if c.name in jt.dicts:
                assert list(jt.dicts[c.name].values) == list(pt.dicts[c.name].values), \
                    (name, c.name)


class TestGenerators:
    def test_ssb_tables_equal_the_references(self, ssb):
        js, ps, _ = ssb
        _tables_equal(js, ps, list(jssb.SSB_SCHEMAS))

    def test_tpcds_tables_equal_the_references(self, tpcds):
        js, ps, _ = tpcds
        assert TPCDS_SCHEMAS.keys() == jtpcds.TPCDS_SCHEMAS.keys()
        _tables_equal(js, ps, list(TPCDS_SCHEMAS))

    def test_query_texts_are_the_references(self):
        assert SSB_QUERIES == jssb.SSB_QUERIES
        assert (Q95, Q95_SQLITE) == (jtpcds.Q95, jtpcds.Q95_SQLITE)


class TestSSB:
    @pytest.mark.parametrize("name", sorted(SSB_QUERIES))
    def test_query(self, ssb, name):
        js, ps, oracle = ssb
        sql = SSB_QUERIES[name]
        got = ps.query(sql)
        ok, msg = rows_equal(got, oracle.execute(sql).fetchall(), ordered=False)
        assert ok, f"{name}: {msg}"
        _same(got, js.query(sql), ordered=False)

    def test_q3_order_keys_respected(self, ssb):
        _, ps, _ = ssb
        rows = ps.query(SSB_QUERIES["q3.1"])
        years = [r[2] for r in rows]
        assert years == sorted(years)
        for y in set(years):
            revs = [float(r[3]) for r in rows if r[2] == y]
            assert revs == sorted(revs, reverse=True)

    def test_flights_nonempty(self, ssb):
        _, ps, _ = ssb
        assert ps.query(SSB_QUERIES["q1.1"])[0][0] is not None
        for name in ("q3.1", "q3.3", "q3.4", "q4.1"):
            assert len(ps.query(SSB_QUERIES[name])) > 0, name


class TestTPCDSQ95:
    def test_q95(self, tpcds):
        js, ps, oracle = tpcds
        got = ps.query(Q95)
        ok, msg = rows_equal(got, oracle.execute(Q95_SQLITE).fetchall(), ordered=True)
        assert ok, msg
        _same(got, js.query(Q95), ordered=True)

    def test_q95_nonempty(self, tpcds):
        _, ps, _ = tpcds
        n = ps.query(Q95)
        assert n and n[0][0] and n[0][0] > 0, n
