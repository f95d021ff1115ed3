"""The hash join through the port's Session (tidb_tpu_torch, plain PyTorch
on the CPU) against the JAX package's Session on identical data.

TPC-H Q3, Q5 and Q18 run at SF0.01 on the tables the JAX generator made
(exported with test_torch_session's `tpch_pair`); the edge-case grid of
tests/test_join_kernels.py::TestProbeModeEquivalence runs under each
tidb_tpu_join_probe_mode in both engines, the reference on its device
tier (tidb_device_engine_mode = force). Rows compare as Python values:
exactly, in order where the SQL orders them and as sorted lists where it
does not (the port's build sort is stable and the reference's is not, so
unordered rows may come out in another order)."""

import numpy as np
import pytest

from tidb_tpu.parser import parse as jax_parse
from tidb_tpu.session import Session as JaxSession
from tidb_tpu_torch.ops import join_kernels as jk
from tidb_tpu_torch.parser import parse
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.tpch_queries import Q

from test_torch_session import _same, tpch_pair  # noqa: F401  (fixture)
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

# Q18 at SF0.01 has no order above 300 units, so it returns no rows; the
# same query at a lower threshold returns some
Q18_LOW = Q["q18"][0].replace("> 300", "> 200")
TPCH = {"q3": Q["q3"][0], "q5": Q["q5"][0], "q18": Q["q18"][0], "q18_low": Q18_LOW}


@pytest.mark.parametrize("q", sorted(TPCH))
def test_tpch_join_matches_jax(tpch_pair, q):
    js, ps = tpch_pair
    want = js.query(TPCH[q])
    got = ps.query(TPCH[q])
    assert want or q == "q18", "reference returned no rows"
    _same(got, want, ordered=True)


def test_q3_takes_the_direct_index(tpch_pair):
    _js, ps = tpch_pair
    jk.reset_routes()
    ps.query(TPCH["q3"])
    assert jk.PROBE_ROUTES["direct"] > 0
    assert jk.PROBE_ROUTES["table"] == 0 and jk.PROBE_ROUTES["sorted"] == 0


@pytest.mark.parametrize("mode,route", [("pallas", "table"), ("xla", "table"),
                                        ("off", "sorted"), ("auto", "sorted")])
def test_q18_semi_join_route(tpch_pair, mode, route):
    """Q18's semi join has no dense domain to index (its build is empty
    at SF0.01), so it takes the table under xla/pallas and searchsorted
    on the CPU's auto; the answer is the same."""
    js, ps = tpch_pair
    ps.execute(f"set tidb_tpu_join_probe_mode = '{mode}'")
    try:
        jk.reset_routes()
        got = ps.query(TPCH["q18"])
        assert jk.PROBE_ROUTES[route] == 1  # the semi join probes one chunk
        _same(got, js.query(TPCH["q18"]), ordered=True)
    finally:
        ps.execute("set tidb_tpu_join_probe_mode = 'auto'")


def _tree(node):
    """(operator, join kind, build side, key count, children) of a plan."""
    return (type(node).__name__, getattr(node, "kind", None),
            getattr(node, "build_side", None), len(getattr(node, "eq_left", ()) or ()),
            tuple(_tree(c) for c in node.children))


@pytest.mark.parametrize("q", ["q3", "q5", "q18"])
def test_plan_shape_matches_jax(tpch_pair, q):
    """The lowered plans have the same tree: operator types, join kinds,
    build sides and key counts (the build side decides the table or the
    direct index, so it must not drift)."""
    js, ps = tpch_pair
    want = _tree(js._plan_select(jax_parse(TPCH[q])[0]))
    got = _tree(ps._plan_select(parse(TPCH[q])[0]))
    assert got == want


_THREE = [
    "create table a (x bigint, y bigint)",
    "create table b (x bigint, z bigint)",
    "create table c (z bigint, w bigint)",
    "insert into a values (1, 10), (2, 20), (3, 30), (NULL, 40), (2, 21)",
    "insert into b values (1, 100), (2, 200), (2, 201), (4, 400)",
    "insert into c values (100, 7), (200, 8), (201, 9), (NULL, 10), (300, 11)",
]


def test_three_table_join_plans_and_runs():
    """A join of three tables orders its joins through `_join_step_cost`,
    which raised UnsupportedError in the port before it was restored."""
    js, ps = JaxSession(), Session(device="cpu")
    for sql in _THREE:
        js.execute(sql)
        ps.execute(sql)
    sql = ("select a.y, b.z, c.w from a, b, c where a.x = b.x and b.z = c.z "
           "order by a.y, b.z, c.w")
    want = js.query(sql)
    assert want
    _same(ps.query(sql), want, ordered=True)


# -- the reference's probe-mode grid (tests/test_join_kernels.py:201-300) ----

GRID_QUERIES = [
    "select count(*) as n, sum(b.v) as sv, sum(p.w) as sw from p join b on p.k = b.k",
    "select count(*) from p where k in (select k from b)",
    "select count(*) from p where k not in (select k from b)",
    "select count(*) from p where not exists (select 1 from b where b.k = p.k)",
    "select count(*), count(b.v) from p left join b on p.k = b.k",
    # beyond the reference's grid: a left join with other_cond, the host
    # sort hatch's statements, and a two-key join whose ranges overflow
    # int64 (hash packing with exact re-verification)
    "select count(*), count(b.v), sum(b.v) from p left join b on p.k = b.k and b.v < 40",
    "select p.w, b.v from p join b on p.k = b.k and p.w = b.v + 1 order by p.w, b.v",
    "select count(*) from p where exists (select 1 from b where b.k = p.k and b.v > p.w)",
]


def _fill_random(nb, npr, sparse=True, with_null=False, stride=64):
    def fill(s):
        s.execute("create table b (k bigint, v bigint)")
        s.execute("create table p (k bigint, w bigint)")
        rng = np.random.default_rng(nb + npr)
        mul = (1 << 40) if sparse else 1
        if nb:
            s.catalog.table("test", "b").insert_columns(
                {"k": rng.integers(0, max(nb // 2, 1), nb) * mul, "v": np.arange(nb)})
        if npr:
            s.catalog.table("test", "p").insert_columns(
                {"k": rng.integers(0, max(nb, 1) + stride, npr) * mul,
                 "w": np.arange(npr)})
        if with_null:
            s.execute("insert into b values (null, -1)")
            s.execute("insert into p values (null, -1)")
    return fill


def _fill_dups(s):
    s.execute("create table b (k bigint, v bigint)")
    s.execute("create table p (k bigint, w bigint)")
    bk = np.repeat(np.array([1, 2, 3]) * (1 << 40), 50)
    s.catalog.table("test", "b").insert_columns({"k": bk, "v": np.arange(len(bk))})
    pk = np.repeat(np.array([1, 2, 3, 99]) * (1 << 40), 40)
    s.catalog.table("test", "p").insert_columns({"k": pk, "w": np.arange(len(pk))})


def _fill_int64(s):
    s.execute("create table b (k bigint, v bigint)")
    s.execute("create table p (k bigint, w bigint)")
    lo, hi = -(1 << 63), (1 << 63) - 1
    s.execute(f"insert into b values ({lo},1),({hi},2),(7,3),({hi},4)")
    s.execute(f"insert into p values ({lo},10),({hi},20),(7,30),(8,40)")


def _fill_wide(s):
    """Two-key ranges whose product overflows int64: hash packing."""
    s.execute("create table b (k bigint, v bigint)")
    s.execute("create table p (k bigint, w bigint)")
    rng = np.random.default_rng(3)
    k = rng.integers(-(1 << 62), 1 << 62, 60)
    s.catalog.table("test", "b").insert_columns({"k": k, "v": np.arange(60) * (1 << 35)})
    s.catalog.table("test", "p").insert_columns(
        {"k": np.concatenate([k, k[:10] + 1]),
         "w": np.concatenate([np.arange(60) * (1 << 35) + 1, np.arange(10)])})


GRID = {
    "sparse_nulls": _fill_random(300, 1000, sparse=True, with_null=True),
    "dense_nulls": _fill_random(300, 1000, sparse=False, with_null=True),
    "dup_heavy_multi_tile": _fill_dups,
    "zero_row_build": _fill_random(0, 10),
    "zero_row_probe": _fill_random(10, 0),
    "full_int64_domain": _fill_int64,
    "bucket_255": _fill_random(64, 255),
    "bucket_256": _fill_random(64, 256),
    "bucket_257": _fill_random(64, 257),
    "hash_packed": _fill_wide,
}

_REF_CACHE: dict = {}


def _rows(s):
    return [sorted(s.query(q), key=str) for q in GRID_QUERIES]


def _reference(case, mode):
    key = (case, mode)
    if key not in _REF_CACHE:
        js = JaxSession(chunk_capacity=256)
        js.execute("SET tidb_slow_log_threshold = 300000")
        js.execute("SET tidb_device_engine_mode = 'force'")
        js.execute(f"SET tidb_tpu_join_probe_mode = '{mode}'")
        GRID[case](js)
        _REF_CACHE[key] = _rows(js)
    return _REF_CACHE[key]


@pytest.mark.parametrize("mode", ["off", "xla", "pallas"])
@pytest.mark.parametrize("case", sorted(GRID))
def test_probe_mode_grid_matches_jax(case, mode):
    ps = Session(device="cpu", chunk_capacity=256)
    ps.execute(f"SET tidb_tpu_join_probe_mode = '{mode}'")
    GRID[case](ps)
    jk.reset_routes()
    got = _rows(ps)
    assert got == _reference(case, mode)
    if case == "sparse_nulls":
        # sparse 40-bit keys defeat the direct index: the table (or
        # searchsorted under 'off') really runs
        assert (jk.PROBE_ROUTES["table"] > 0) == (mode != "off")
        assert jk.PROBE_ROUTES["direct"] == 0
    if case == "dense_nulls":
        assert jk.PROBE_ROUTES["direct"] > 0 and jk.PROBE_ROUTES["table"] == 0


def test_host_sorted_build_hatch_matches_device_build():
    """tidb_tpu_join_device_build = 0 sorts the build on the host and
    answers as the device build does."""
    ps = Session(device="cpu", chunk_capacity=128)
    _fill_random(300, 1000, sparse=False, with_null=True)(ps)
    want = _rows(ps)
    ps.execute("SET tidb_tpu_join_device_build = 0")
    assert _rows(ps) == want
    ps.execute("SET tidb_tpu_join_probe_mode = 'pallas'")
    ps.execute("drop table b")
    ps.execute("drop table p")
    _fill_random(300, 1000, sparse=True, with_null=True)(ps)
    got = _rows(ps)
    ps.execute("SET tidb_tpu_join_device_build = 1")
    assert got == _rows(ps)
