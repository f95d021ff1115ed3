"""The port's fused scan->probe executor (FusedScanProbeExec in
tidb_tpu_torch/executor/pipeline.py) on the CPU, against the port's
classic HashJoinExec tree (tidb_tpu_pipeline_fuse = 0) and the JAX
package's Session.

TPC-H Q3, Q5 and Q18 run at SF0.01 with chunk capacity 4,096 and
1,024-row segments in both engines (so lineitem and orders read packed
segment batches); their plan trees must equal the reference's under the
same settings once both engines have built their segment stores. A grid
of small joins (probe side 5,000 rows, so it reads packed segment
batches too) covers Q18's PK-FK shape, dup-heavy batches that overflow
the first output tile, zero-row and no-match sides, NULL keys on both
sides, sparse keys under every tidb_tpu_join_probe_mode, the LEFT pad and
composite keys; and the build cache: a warm run probes a parked build,
and an INSERT on either side invalidates. Rows compare exactly (every
value is an integer or a decimal), as sorted lists where the SQL does
not order."""

import numpy as np
import pytest

from tidb_tpu.parser import parse as jax_parse
from tidb_tpu.session import Session as JaxSession
from tidb_tpu_torch.executor import pipeline as pl
from tidb_tpu_torch.executor.join import HashJoinExec
from tidb_tpu_torch.executor.pipeline import FusedScanProbeExec
from tidb_tpu_torch.ops import join_kernels as jk
from tidb_tpu_torch.parser import parse
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.tpch_queries import Q

from test_torch_join import _tree
from test_torch_pipeline import CAP, SEG_ROWS, _arms, _run, assert_rows, tpch_seg_pair
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

Q18_LOW = Q["q18"][0].replace("> 300", "> 200")
TPCH = {"q3": Q["q3"][0], "q5": Q["q5"][0], "q18": Q["q18"][0], "q18_low": Q18_LOW}


@pytest.fixture(scope="module")
def tpch_seg():
    return tpch_seg_pair()


@pytest.mark.parametrize("q", sorted(TPCH))
def test_tpch_fused_unfused_and_jax_agree(tpch_seg, q):
    js, ps = tpch_seg
    want = js.query(TPCH[q])
    assert want or q == "q18"
    fused, unfused = _arms(ps, TPCH[q])
    assert_rows(fused, want, ordered=True)
    assert_rows(unfused, want, ordered=True)


@pytest.mark.parametrize("q", ["q3", "q5", "q18"])
def test_tpch_plan_trees_match_jax(tpch_seg, q):
    """With segment stores in both engines (zone-map statistics feed the
    estimates), the join trees still equal the reference's."""
    js, ps = tpch_seg
    js.query(TPCH[q])
    ps.query(TPCH[q])  # both engines have built their stores
    assert ps.catalog.table("test", "lineitem")._segment_store is not None
    want = _tree(js._plan_select(jax_parse(TPCH[q])[0]))
    got = _tree(ps._plan_select(parse(TPCH[q])[0]))
    assert got == want


def test_inner_joins_run_fused_and_the_semi_join_stays_classic(tpch_seg):
    from chip_smoke import fusible_joins  # the repository root's, as on the card

    _js, ps = tpch_seg
    for q in ("q3", "q5", "q18_low"):
        phys = ps._plan_select(parse(TPCH[q])[0])
        want = fusible_joins(phys)
        assert want >= 1, q
        pl.reset_counters()
        jk.reset_routes()
        _rows, execs = _run(ps, TPCH[q])
        assert pl.PIPELINE_FUSED_TOTAL["probe"] == want, q
        assert sum(jk.PROBE_ROUTES.values()) > 0
        if q == "q18_low":  # the IN subquery's semi join: the classic tree
            classic = [e.kind for e in execs if type(e) is HashJoinExec]
            assert classic.count("semi") == 1


# -- the fused-probe grid -------------------------------------------------------

NP = 5000  # probe rows: 5 segments of 1,024, 4 to a batch


def _tables(s):
    s.execute("create table b (k bigint, j bigint, v bigint)")
    s.execute("create table p (k bigint, j bigint, w bigint)")
    return s.catalog.table("test", "b"), s.catalog.table("test", "p")


def _grid_case(name):
    """fill(session) for one grid case: the same arrays in both engines."""
    rng = np.random.default_rng(GRID_CASES.index(name))

    def fill(s):
        tb, tp = _tables(s)
        if name == "pk_fk":  # Q18's shape: unique build keys, every probe hits
            bk = np.arange(1, 1501)
            pk = rng.integers(1, 1501, NP)
        elif name == "dup_overflow":  # 8 build rows a key: 8 matches a row
            bk = np.repeat(np.arange(500), 8)
            pk = rng.integers(0, 500, NP)
        elif name == "zero_row_build":
            bk = np.zeros(0, dtype=np.int64)
            pk = rng.integers(0, 100, NP)
        elif name == "no_match":
            bk = np.arange(2000)
            pk = rng.integers(10_000, 20_000, NP)
        elif name == "nulls_both":
            bk = np.arange(1200)
            pk = rng.integers(0, 1500, NP)
        elif name == "sparse":  # 40-bit keys: no dense domain to index
            bk = rng.integers(0, 1500, 1500) << 40
            pk = rng.integers(0, 1700, NP) << 40
        else:
            raise KeyError(name)
        bj = rng.integers(0, 3, len(bk))
        pj = rng.integers(0, 3, NP)
        if len(bk):
            bv = {"k": bk.astype(np.int64), "j": bj, "v": np.arange(len(bk))}
            valids = ({"k": rng.random(len(bk)) > 0.1} if name == "nulls_both" else None)
            tb.insert_columns(bv, valids=valids)
        valids = {"k": rng.random(NP) > 0.1} if name == "nulls_both" else None
        tp.insert_columns({"k": pk.astype(np.int64), "j": pj, "w": np.arange(NP)},
                          valids=valids)
    return fill


GRID_CASES = ["pk_fk", "dup_overflow", "zero_row_build", "no_match", "nulls_both", "sparse"]
GRID_QUERIES = [
    "select count(*), sum(b.v), sum(p.w) from p join b on p.k = b.k",
    "select count(*), count(b.v), sum(b.v), sum(p.w) from p left join b on p.k = b.k",
    "select count(*), sum(b.v) from p join b on p.k = b.k and p.j = b.j",
    "select p.w, b.v from p join b on p.k = b.k where p.w < 40 order by p.w, b.v",
]
_REF: dict = {}


def _session(engine):
    s = (JaxSession(chunk_capacity=CAP) if engine == "jax"
         else Session(chunk_capacity=CAP, device="cpu"))
    s.execute(f"set tidb_tpu_segment_rows = {SEG_ROWS}")
    return s


def _reference(case):
    if case not in _REF:
        js = _session("jax")
        js.execute("SET tidb_slow_log_threshold = 300000")
        _grid_case(case)(js)
        _REF[case] = [js.query(q) for q in GRID_QUERIES]
    return _REF[case]


@pytest.mark.parametrize("case", GRID_CASES)
def test_grid_fused_unfused_and_jax_agree(case):
    ps = _session("port")
    _grid_case(case)(ps)
    want = _reference(case)
    for q, w in zip(GRID_QUERIES, want):
        fused, unfused = _arms(ps, q)
        assert_rows(fused, w, ordered="order by" in q)
        assert_rows(unfused, w, ordered="order by" in q)
        _rows, execs = _run(ps, q)
        fx = [e for e in execs if isinstance(e, FusedScanProbeExec)]
        assert len(fx) == 1 and fx[0]._ran_fused, (case, q)
    store = ps.catalog.table("test", "p")._segment_store
    assert store is not None and len(store.segments) == 5


def test_dup_heavy_batches_overflow_the_first_tile():
    ps = _session("port")
    _grid_case("dup_overflow")(ps)
    _rows, execs = _run(ps, GRID_QUERIES[0])
    fx = [e for e in execs if isinstance(e, FusedScanProbeExec)][0]
    # 5,000 probe rows, 8 matches each: 40,000 output rows over 2 batches
    assert fx.stats.out_rows == 8 * NP
    assert fx.stats.tile_chunks == 2 and fx.stats.tile_overflows == 2
    assert fx.stats.tile_max_need == 7  # 8 x 4,096 slots, 1 tile in-line
    assert_rows(_rows, _reference("dup_overflow")[0])


@pytest.mark.parametrize("mode,route", [("off", "sorted"), ("auto", "sorted"),
                                        ("xla", "table"), ("pallas", "table")])
def test_sparse_keys_under_every_probe_mode(mode, route):
    ps = _session("port")
    ps.execute(f"SET tidb_tpu_join_probe_mode = '{mode}'")
    _grid_case("sparse")(ps)
    jk.reset_routes()
    got = [ps.query(q) for q in GRID_QUERIES]
    for q, g, w in zip(GRID_QUERIES, got, _reference("sparse")):
        assert_rows(g, w, ordered="order by" in q)
    # the single-key queries take the mode's route; the two-key query packs
    # a dense (k, j) domain only if it fits the direct index
    assert jk.PROBE_ROUTES[route] > 0
    assert jk.PROBE_ROUTES["table" if route == "sorted" else "sorted"] == 0


def test_warm_build_is_cached_and_inserts_on_either_side_invalidate():
    js, ps = _session("jax"), _session("port")
    for s in (js, ps):
        _grid_case("pk_fk")(s)
    q = GRID_QUERIES[0]
    assert_rows(ps.query(q), js.query(q))
    c0 = dict(pl.DEVICE_CACHE_TOTAL)
    assert_rows(ps.query(q), js.query(q))
    # warm: the probe batches and the parked build both hit
    assert pl.DEVICE_CACHE_TOTAL["hit"] == c0["hit"] + 2
    _rows, execs = _run(ps, q)
    fx = [e for e in execs if isinstance(e, FusedScanProbeExec)][0]
    assert fx._build_cache_table is ps.catalog.table("test", "b")
    for table, row in (("b", "(7, 1, 123456)"), ("p", "(7, 1, 654321)")):
        for s in (js, ps):
            s.execute(f"insert into {table} values {row}")
        inv = pl.DEVICE_CACHE_TOTAL["invalidate"]
        assert_rows(ps.query(q), js.query(q))
        assert pl.DEVICE_CACHE_TOTAL["invalidate"] == inv + 1, table


def test_hash_packed_composite_keys_take_the_classic_delegate():
    """Two keys whose ranges overflow int64 range packing (hash mode, known
    only after the build drain): the fused probe falls back to the classic
    tree, which re-verifies every candidate exactly."""
    from test_torch_join import _fill_wide

    sql = "select p.w, b.v from p join b on p.k = b.k and p.w = b.v + 1 order by p.w, b.v"
    js, ps = _session("jax"), _session("port")
    for s in (js, ps):
        _fill_wide(s)
    pl.reset_counters()
    got = ps.query(sql)
    assert pl.PIPELINE_FUSED_TOTAL == {"agg": 0, "generic": 0, "probe": 0, "topn": 0,
                                       "delegate": 1}
    want = js.query(sql)
    assert want
    assert_rows(got, want, ordered=True)
