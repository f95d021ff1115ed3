"""The storage-engine boundary (kvapi) and the delta engine through the
port (tidb_tpu_torch on the CPU) against the JAX package.

The cases of tests/test_engines.py, each run on a fresh reference
session and a fresh port session: the contract test holds the port's
`DeltaTable` and `Table` to the port's `TABLE_ENGINE_API` (equal to the
reference's), the engine-equivalence cases run the same SQL on both
engines in both packages and compare the rows, and the delta cases check
the memtable's bookkeeping (buffered rows, one bulk append, markers that
survive a compaction inside a transaction) in both packages alike.

The last cases hold the fused and classic scans to the reference over a
delta-engine `lineitem` at SF0.01 whose last rows are still buffered
when the query starts: TPC-H Q1 and Q6 must see them, and a segment
store built over the table keys its base `Table` whichever object the
executor holds.
"""

import pytest
from chip_smoke import no_key_ddl

from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import kvapi as jax_kvapi
from tidb_tpu.storage.tpch import load_tpch as jax_load_tpch
from tidb_tpu_torch.columnar import compaction
from tidb_tpu_torch.columnar.store import store_for
from tidb_tpu_torch.executor import pipeline as pl
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import delta as delta_mod
from tidb_tpu_torch.storage.kvapi import ENGINES, TABLE_ENGINE_API, conforms, make_table
from tidb_tpu_torch.storage.table import ColumnInfo, TableSchema
from tidb_tpu_torch.storage.tpch_queries import Q
from tidb_tpu_torch.types import INT64

from test_torch_keys import both, same_rows
from test_torch_session import _export_into, _same, reference_witness_paused  # noqa: F401


def new_pair():
    js = JaxSession()
    js.execute("set tidb_tpu_compaction = 0")
    return js, Session(device="cpu")


def test_contract_both_engines():
    assert TABLE_ENGINE_API == jax_kvapi.TABLE_ENGINE_API
    assert ENGINES == jax_kvapi.ENGINES
    schema = TableSchema("t", [ColumnInfo("a", INT64)])
    for eng in ENGINES:
        t = make_table(schema, eng)
        assert conforms(t) == [], (eng, conforms(t))
        assert t.engine == eng
    # the accepted aliases build the columnar engine, as the reference's
    for alias in ("innodb", "tiflash", None):
        assert make_table(schema, alias).engine == "columnar"


def test_unknown_engine_rejected():
    js, ps = new_pair()
    assert both(js, ps, "create table bad (a bigint) engine=rocksdb") == "SchemaError"
    assert not ps.catalog.has_table("test", "bad")


@pytest.fixture(params=["columnar", "delta"])
def pair(request):
    js, ps = new_pair()
    return js, ps, request.param


def _create(js, ps, eng, name, cols):
    assert both(js, ps, f"create table {name} ({cols}) engine={eng}") is None
    assert ps.catalog.table("test", name).engine == eng


def _script(js, ps, stmts):
    """Each statement must succeed or fail alike; "?sql" compares rows."""
    for sql in stmts:
        if sql.startswith("?"):
            same_rows(js, ps, sql[1:], ordered="order by" in sql)
        else:
            both(js, ps, sql)


class TestEngineEquivalence:
    """The same SQL, row for row, on both engines and in both packages."""

    def test_crud_and_scan(self, pair):
        js, ps, eng = pair
        _create(js, ps, eng, "t", "a bigint, s varchar(10), d double")
        _script(js, ps, [
            "insert into t values (1, 'x', 1.5), (2, 'y', NULL)",
            "insert into t values (3, NULL, 2.5)",
            "?select a, s, d from t order by a",
            "update t set d = 9.0 where a = 2",
            "delete from t where a = 1",
            "?select a, d from t order by a",
        ])
        assert ps.query("select a, d from t order by a") == [(2, 9.0), (3, 2.5)]

    def test_aggregation_and_strings(self, pair):
        js, ps, eng = pair
        _create(js, ps, eng, "g", "k varchar(4), v bigint")
        _script(js, ps, [
            "insert into g values " + ", ".join(
                f"('k{i % 3}', {i})" for i in range(300)),
            "?select k, count(*), sum(v) from g group by k order by k",
            "?select count(*) from g where k = 'k1'",
        ])
        got = ps.query("select k, count(*), sum(v) from g group by k order by k")
        assert [r[1] for r in got] == [100, 100, 100]
        assert sum(r[2] for r in got) == sum(range(300))

    def test_txn_commit_and_rollback(self, pair):
        js, ps, eng = pair
        _create(js, ps, eng, "tx", "a bigint")
        _script(js, ps, [
            "insert into tx values (1)", "begin",
            "insert into tx values (2), (3)",
            "?select count(*) from tx",  # own writes
            "rollback", "?select count(*) from tx",
            "begin", "insert into tx values (4)", "commit",
            "?select a from tx order by a",
        ])
        assert ps.query("select a from tx order by a") == [(1,), (4,)]

    def test_unique_pk_enforced(self, pair):
        js, ps, eng = pair
        _create(js, ps, eng, "u", "a bigint primary key, b bigint")
        both(js, ps, "insert into u values (1, 10)")
        assert both(js, ps, "insert into u values (1, 20)") == "ExecutionError"
        same_rows(js, ps, "select b from u")
        assert ps.query("select b from u") == [(10,)]

    def test_inline_unique_key_clause(self, pair):
        js, ps, eng = pair
        both(js, ps, f"create table iu (a bigint, b bigint, unique key (b)) "
                     f"engine={eng}")
        both(js, ps, "insert into iu values (1, 5)")
        assert both(js, ps, "insert into iu values (2, 5)") == "ExecutionError"
        same_rows(js, ps, "select a, b from iu")

    def test_analyze_and_autoanalyze(self, pair):
        from tidb_tpu.statistics import table_stats as jax_table_stats
        from tidb_tpu_torch.statistics import table_stats

        js, ps, eng = pair
        _create(js, ps, eng, "an", "a bigint")
        both(js, ps, "insert into an values " + ", ".join(
            f"({i})" for i in range(1200)))
        jt = table_stats(ps.catalog.table("test", "an"))
        assert jt is not None  # auto-analyze fired
        assert jt.n_rows == 1200
        assert jax_table_stats(js.catalog.table("test", "an")).n_rows == jt.n_rows


def _delta_pair(ddl):
    js, ps = new_pair()
    both(js, ps, ddl)
    return js, ps, js.catalog.table("test", "d"), ps.catalog.table("test", "d")


class TestDeltaEngine:
    def test_buffers_and_compacts_in_bulk(self):
        js, ps, jt, pt = _delta_pair(
            "create table d (a bigint, s varchar(12)) engine=delta")
        v0 = pt._base.version
        # 40 single-row inserts with NEW strings each: the columnar
        # engine would do 40 dictionary merges; delta buffers them
        for i in range(40):
            both(js, ps, f"insert into d values ({i}, 'str{i:04d}')")
        assert pt.buffered_rows == jt.buffered_rows == 40
        assert pt._base.n == jt._base.n == 0  # nothing materialized yet
        # first read compacts: ONE bulk append, ONE version window
        same_rows(js, ps, "select count(*), min(s), max(s) from d")
        assert ps.query("select count(*), min(s), max(s) from d") == [
            (40, "str0000", "str0039")]
        assert pt.buffered_rows == jt.buffered_rows == 0
        assert pt._base.n == jt._base.n == 40
        assert pt._base.version - v0 <= 3  # one bulk append, not 40

    def test_read_then_commit_keeps_rows(self):
        """A SELECT inside the transaction compacts its buffered marker
        rows into the base; their ranges must join the transaction's log
        so COMMIT rewrites them."""
        js, ps, jt, pt = _delta_pair("create table d (a bigint) engine=delta")
        _script(js, ps, ["begin", "insert into d values (1), (2), (3)",
                         "?select count(*) from d", "commit",
                         "?select a from d order by a"])
        assert ps.query("select a from d order by a") == [(1,), (2,), (3,)]
        # and survive GC at a later safepoint (no orphaned markers)
        pt.gc(ps.catalog.next_ts())
        jt.gc(js.catalog.next_ts())
        same_rows(js, ps, "select count(*) from d")
        assert ps.query("select count(*) from d") == [(3,)]

    def test_read_then_rollback_no_residue(self):
        js, ps, jt, pt = _delta_pair("create table d (a bigint) engine=delta")
        _script(js, ps, ["insert into d values (9)", "begin",
                         "insert into d values (1), (2)",
                         "?select count(*) from d", "rollback",
                         "?select a from d"])
        pt.gc(ps.catalog.next_ts())
        jt.gc(js.catalog.next_ts())
        same_rows(js, ps, "select a from d")
        assert ps.query("select a from d") == [(9,)]

    def test_txn_visibility_through_buffer(self):
        js, ps, _jt, _pt = _delta_pair("create table d (a bigint) engine=delta")
        _script(js, ps, ["begin", "insert into d values (1), (2)",
                         "?select count(*) from d", "rollback",
                         "?select count(*) from d"])
        assert ps.query("select count(*) from d") == [(0,)]

    def test_rollback_discards_buffered_rows(self):
        js, ps, jt, pt = _delta_pair("create table d (a bigint) engine=delta")
        _script(js, ps, ["insert into d values (99)", "begin",
                         "insert into d values (1), (2)"])
        assert pt.buffered_rows == jt.buffered_rows >= 2  # no read yet
        _script(js, ps, ["rollback", "?select a from d"])
        assert ps.query("select a from d") == [(99,)]

    def test_threshold_compaction(self):
        from tidb_tpu.storage import delta as jax_delta

        assert delta_mod.FLUSH_ROWS == jax_delta.FLUSH_ROWS == 4096
        js, ps, jt, pt = _delta_pair("create table d (a bigint) engine=delta")
        n = delta_mod.FLUSH_ROWS + 5
        for t in (jt, pt):
            t.insert_rows([(i,) for i in range(n)])
        assert pt.buffered_rows == jt.buffered_rows < delta_mod.FLUSH_ROWS
        assert pt._base.n == jt._base.n >= delta_mod.FLUSH_ROWS
        same_rows(js, ps, "select count(*), sum(a) from d")

    def test_statement_accurate_errors(self):
        js, ps, _jt, _pt = _delta_pair(
            "create table d (a bigint not null, b bigint) engine=delta")
        # NOT NULL, no default; then a bad int
        assert both(js, ps, "insert into d (b) values (1)") == "ExecutionError"
        assert both(js, ps, "insert into d values ('xx', 1)") is not None
        same_rows(js, ps, "select count(*) from d")
        assert ps.query("select count(*) from d") == [(0,)]

    def test_auto_increment_through_buffer(self):
        js, ps, jt, pt = _delta_pair(
            "create table d (id bigint auto_increment, v bigint) engine=delta")
        # no unique index: ids assigned at buffer time
        for t in (jt, pt):
            t.insert_rows([(7,), (8,)], columns=["v"])
            t.insert_rows([(9,)], columns=["v"])
        same_rows(js, ps, "select id, v from d order by id", ordered=True)
        assert ps.query("select id, v from d order by id") == [
            (1, 7), (2, 8), (3, 9)]


@pytest.fixture(scope="module")
def delta_lineitem():
    """lineitem at SF0.01 (60,175 rows) as a delta table `ld` in both
    packages: INSERT ... SELECT, then 50 single-row INSERTs that stay in
    the memtable until the next read."""
    js = JaxSession()
    js.execute("set tidb_tpu_compaction = 0")
    jax_load_tpch(js.catalog, sf=0.01)
    ps = Session(device="cpu", chunk_capacity=4096)
    ps.execute("set tidb_tpu_compaction = 0")
    _export_into(ps, js.catalog.table("test", "lineitem"), "lineitem")
    # no key: a keyed delta table writes through, and this one must buffer
    ddl = no_key_ddl(js, "lineitem", "ld", "delta")
    assert ddl == no_key_ddl(ps, "lineitem", "ld", "delta")
    for s in (js, ps):
        s.execute(ddl)
        s.execute("insert into ld select * from lineitem")
    return js, ps


_TRICKLE = ("insert into ld values ({k}, 1, 1, {ln}, 10.00, 1234.50, 0.05, "
            "0.02, 'N', 'O', '1994-03-{d:02d}', '1994-04-01', "
            "'1994-04-10', 'NONE', 'AIR', 'trickle')")


@pytest.mark.parametrize("mode", ["fused", "classic"])
@pytest.mark.parametrize("q", ["q1", "q6"])
def test_tpch_over_delta_lineitem(delta_lineitem, q, mode):
    """Buffered rows are in the first SELECT's answer, in fused and in
    classic mode alike; every query of the grid adds its own rows."""
    js, ps = delta_lineitem
    base = 10_000_000 + 100 * ("q1", "q6").index(q) + 50 * (mode == "classic")
    for i in range(50):
        sql = _TRICKLE.format(k=base + i, ln=1 + i % 7, d=1 + i % 28)
        js.execute(sql)
        ps.execute(sql)
    pt = ps.catalog.table("test", "ld")
    assert pt.buffered_rows >= 50
    fuse, col = (1, 1) if mode == "fused" else (0, 0)
    ps.execute(f"set tidb_tpu_pipeline_fuse = {fuse}")
    ps.execute(f"set tidb_tpu_columnar_enable = {col}")
    sql = Q[q][0].replace("lineitem", "ld")
    fused0 = pl.PIPELINE_FUSED_TOTAL["agg"]
    try:
        got = ps.query(sql)
    finally:
        ps.execute("set tidb_tpu_pipeline_fuse = 1")
        ps.execute("set tidb_tpu_columnar_enable = 1")
    assert pt.buffered_rows == 0
    assert (pl.PIPELINE_FUSED_TOTAL["agg"] > fused0) == (mode == "fused")
    want = js.query(sql)
    assert want
    _same(got, want, ordered=True)


def test_segment_store_keys_the_base_table(delta_lineitem):
    """The segment store attaches to the delta table's base `Table`,
    whether the caller holds the wrapper or the base, and a read through
    the store covers the compacted rows."""
    js, ps = delta_lineitem
    ps.execute("set tidb_tpu_segment_rows = 1024")
    try:
        ps.execute(_TRICKLE.format(k=20_000_000, ln=1, d=3))
        js.execute(_TRICKLE.format(k=20_000_000, ln=1, d=3))
        pt = ps.catalog.table("test", "ld")
        sql = "select count(*), sum(l_quantity) from ld where l_shipdate >= '1994-01-01'"
        same_rows(js, ps, sql)
        compaction.default_worker().drain(10)
        store = store_for(pt, 1024)
        assert store is not None
        assert store is store_for(pt._base, 1024)
        assert pt._base._segment_store is store
        assert store.table is pt._base
        same_rows(js, ps, sql)
    finally:
        ps.execute("set tidb_tpu_segment_rows = 65536")
