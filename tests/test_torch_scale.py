"""The port at scale, checked at small sizes on the CPU: the join estimate
of a key both sides repeat, the fused probe's expansion memory, and a
temporary table's staged batches.

- The key-domain rule (planner/physical.py `_key_domain`): a join key with
  no statistic counts the distinct values of the single-column PRIMARY or
  UNIQUE key it is equated with (nation's 25 keys for Q5's
  s_nationkey = c_nationkey), so the customer-to-supplier join of Q5 on a
  fresh SF0.1 session is estimated within 2x of its rows (the old fallback,
  max(|L|, |R|), gave customer's 15,000 against about 120,000: at SF10 the
  join holds about 1.2 billion rows). `reference_key_domain()` applies the
  same rule to the reference's planner, independently written, so tests
  that hold the port's plans to the reference's hold them to the rule
  (ROADMAP, known divergences).
- Q1, Q6 and Q5 on a fresh session, in that order (the order that filled
  the card at SF1), equal the reference's rows and the sqlite oracle's.
- A many-to-many fused join whose overflow needs at least 4 x join_tiles
  tiles a batch: tiles made and not yet taken by the consumer stay within
  the window's first tiles plus join_tiles (the probe expands as it is
  drained), the rows equal the reference's, and under a quota the join
  exceeds the statement ends in QueryOOMError with its tracker at 0.
- A temporary table's staged batches leave the device buffer cache when
  it is dropped and when its connection ends (ROADMAP Queue C item 3).
"""

import contextlib

import numpy as np
import pytest

from tidb_tpu.expression import expr as jax_expr
from tidb_tpu.parser import parse as jax_parse
from tidb_tpu.planner import physical as jax_physical
from tidb_tpu.planner import logical as jax_logical
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.tpch import load_tpch as jax_load_tpch
from tidb_tpu.testutil import index_tpch_oracle, mirror_to_sqlite, rows_equal
from tidb_tpu_torch.executor import pipeline as pl
from tidb_tpu_torch.executor.pipeline import FusedScanProbeExec
from tidb_tpu_torch.ops import join_kernels as jk
from tidb_tpu_torch.parser import parse
from tidb_tpu_torch.planner.physical import PHashJoin, PScan, explain_text
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.tpch_queries import Q
from tidb_tpu_torch.utils.memory import QueryOOMError

from test_torch_pipeline import CAP, SEG_ROWS, _run, assert_rows
from test_torch_session import _export_into, reference_witness_paused  # noqa: F401


# -- the key-domain rule, applied to the reference's planner -----------------

def _ref_unique_domain(child, uid):
    """The live rows of the table whose single-column unique key `uid` (or
    a column an inner join below `child` equates with it) is, or None."""
    def strip(e):
        while isinstance(e, jax_expr.Lookup):
            e = e.arg
        return e.name if isinstance(e, jax_expr.ColumnRef) else None

    edges = []

    def walk(p):
        if isinstance(p, jax_logical.LJoin) and p.kind == "inner":
            edges.extend((strip(a), strip(b)) for a, b in p.eq_conds)
        for c in p.children:
            walk(c)

    walk(child)
    cls, todo = {uid}, [uid]
    while todo:
        u = todo.pop()
        for a, b in edges:
            for x, y in ((a, b), (b, a)):
                if x == u and y is not None and y not in cls:
                    cls.add(y)
                    todo.append(y)
    sizes = []
    for u in cls:
        hit = jax_physical.resolve_scan_col(child, u)
        if hit is None:
            continue
        table, col = hit
        if any(ix.unique and list(ix.columns) == [col] and ix.state == "public"
               for ix in table.indexes.values()):
            sizes.append(float(table.live_rows))
    return max(min(sizes), 1.0) if sizes else None


@contextlib.contextmanager
def reference_key_domain():
    """The reference's eq_join_rows with the port's key-domain rule: a join
    key whose NDV `_eq_ndv` does not know counts its unique-key domain."""
    real_rows, real_ndv = jax_physical.eq_join_rows, jax_physical._eq_ndv

    def eq_ndv(child, expr, rows):
        got = real_ndv(child, expr, rows)
        if got is not None:
            return got
        while isinstance(expr, jax_expr.Lookup):
            expr = expr.arg
        if not isinstance(expr, jax_expr.ColumnRef):
            return None
        return _ref_unique_domain(child, expr.name)

    def eq_join_rows(*args, **kw):
        jax_physical._eq_ndv = eq_ndv
        try:
            return real_rows(*args, **kw)
        finally:
            jax_physical._eq_ndv = real_ndv

    jax_physical.eq_join_rows = eq_join_rows
    try:
        yield
    finally:
        jax_physical.eq_join_rows = real_rows


# -- Q5's estimate and rows ---------------------------------------------------

# Q5's conjuncts with the tables each reads
Q5_CONJUNCTS = [
    ("c_custkey = o_custkey", {"customer", "orders"}),
    ("l_orderkey = o_orderkey", {"lineitem", "orders"}),
    ("l_suppkey = s_suppkey", {"lineitem", "supplier"}),
    ("c_nationkey = s_nationkey", {"customer", "supplier"}),
    ("s_nationkey = n_nationkey", {"supplier", "nation"}),
    ("n_regionkey = r_regionkey", {"nation", "region"}),
    ("r_name = 'ASIA'", {"region"}),
    ("o_orderdate >= date '1994-01-01' and o_orderdate < date '1995-01-01'", {"orders"}),
]


def _scans(p) -> set:
    if isinstance(p, PScan):
        return {p.table_name}
    return set().union(*(_scans(c) for c in p.children)) if p.children else set()


def _customer_join(p):
    """The lowest join whose inputs hold both customer and supplier."""
    for c in p.children:
        got = _customer_join(c)
        if got is not None:
            return got
    if isinstance(p, PHashJoin) and {"customer", "supplier"} <= _scans(p):
        return p
    return None


def test_q5_customer_join_estimate_within_2x_on_a_fresh_session():
    s = Session(device="cpu")
    s.load_tpch(0.1)
    join = _customer_join(s._plan_select(parse(Q["q5"][0])[0]))
    tables = _scans(join)
    where = " and ".join(c for c, t in Q5_CONJUNCTS if t <= tables)
    actual = s.query(f"select count(*) from {', '.join(sorted(tables))} where {where}")[0][0]
    assert actual > 100_000  # the SF^2 join: about 120,000 rows at SF0.1
    assert actual / 2 <= join.est_rows <= actual * 2, (tables, join.est_rows, actual)


@pytest.fixture(scope="module")
def q5_tables():
    js = JaxSession()
    jax_load_tpch(js.catalog, sf=0.05)
    oracle = index_tpch_oracle(mirror_to_sqlite(js.catalog))
    return js, oracle


def test_fresh_session_q1_q6_q5_equal_the_reference_and_sqlite(q5_tables):
    js, oracle = q5_tables
    ps = Session(device="cpu")
    for name in js.catalog.tables("test"):
        _export_into(ps, js.catalog.table("test", name), name)
    for q in ("q1", "q6", "q5"):
        sql, osql = Q[q]
        got = ps.query(sql)
        assert got
        ok, msg = rows_equal(got, js.query(sql), ordered=True)
        assert ok, f"{q} against the reference: {msg}"
        ok, msg = rows_equal(got, oracle.execute(osql or sql).fetchall(), ordered=True)
        assert ok, f"{q} against sqlite: {msg}"


def test_reference_under_the_rule_plans_q5_as_the_port():
    js = JaxSession()
    jax_load_tpch(js.catalog, sf=0.02)
    ps = Session(device="cpu")
    for name in js.catalog.tables("test"):
        _export_into(ps, js.catalog.table("test", name), name)
    with reference_key_domain():
        want = jax_physical.explain_text(js._plan_select(jax_parse(Q["q5"][0])[0]))
    assert explain_text(ps._plan_select(parse(Q["q5"][0])[0])) == want


# -- the fused probe's expansion memory ---------------------------------------

DUPS = 16          # build rows per key: 16 matches a probe row
NP = 5000          # probe rows: two batches of four 1,024-row segments
JOIN_TILES = 2
JOIN_SQL = "select count(*), sum(b.v), sum(p.w) from p join b on p.k = b.k"


def _dup_tables(s):
    rng = np.random.default_rng(17)
    s.execute(f"set tidb_tpu_segment_rows = {SEG_ROWS}")
    s.execute("create table b (k bigint, v bigint)")
    s.execute("create table p (k bigint, w bigint)")
    bk = np.repeat(np.arange(500), DUPS)
    s.catalog.table("test", "b").insert_columns({"k": bk, "v": np.arange(len(bk))})
    s.catalog.table("test", "p").insert_columns(
        {"k": rng.integers(0, 500, NP), "w": np.arange(NP)})


@pytest.fixture
def counted_tiles(monkeypatch):
    """Tiles expand_tiles made and chunks the fused probe handed out; the
    most made and not yet taken at once."""
    state = {"made": 0, "taken": 0, "most": 0}
    real_expand, real_next = jk.expand_tiles, FusedScanProbeExec.next

    def expand(*args, n_tiles, **kw):
        state["made"] += n_tiles
        state["most"] = max(state["most"], state["made"] - state["taken"])
        return real_expand(*args, n_tiles=n_tiles, **kw)

    def take(self):
        out = real_next(self)
        if out is not None:
            state["taken"] += 1
        return out

    monkeypatch.setattr(jk, "expand_tiles", expand)
    monkeypatch.setattr(FusedScanProbeExec, "next", take)
    return state


def test_overflow_expands_as_it_is_drained(counted_tiles):
    ps = Session(device="cpu", chunk_capacity=CAP)
    ps.execute(f"set tidb_tpu_join_tiles_per_dispatch = {JOIN_TILES}")
    _dup_tables(ps)
    js = JaxSession(chunk_capacity=CAP)
    js.execute("SET tidb_slow_log_threshold = 300000")
    _dup_tables(js)
    got, execs = _run(ps, JOIN_SQL)
    assert_rows(got, js.query(JOIN_SQL))
    assert got[0][0] == DUPS * NP
    fx = [e for e in execs if isinstance(e, FusedScanProbeExec)][0]
    batches = fx.stats.tile_chunks
    # a batch overflows its first tile into at least 4 x join_tiles more
    assert fx.stats.tile_max_need >= 4 * JOIN_TILES, fx.stats
    # the window's first tiles and one expand call's tiles, no more
    assert counted_tiles["most"] <= batches + JOIN_TILES, counted_tiles


def test_overflow_over_the_quota_fails_typed_with_nothing_charged():
    ps = Session(device="cpu", chunk_capacity=CAP)
    ps.execute(f"set tidb_tpu_join_tiles_per_dispatch = {JOIN_TILES}")
    _dup_tables(ps)
    trackers = []
    orig = ps._exec_ctx

    def small_ctx(**kw):
        ctx = orig(**kw)
        ctx.mem_tracker.budget = 64 << 10  # below one expand call's tiles
        trackers.append(ctx.mem_tracker)
        return ctx

    ps._exec_ctx = small_ctx
    with pytest.raises(QueryOOMError):
        ps.query(JOIN_SQL)
    assert trackers and all(t.consumed == 0 for t in trackers)
    ps._exec_ctx = orig
    assert ps.query(JOIN_SQL)[0][0] == DUPS * NP


# -- a temporary table's staged batches ---------------------------------------

def _staged_entries(table) -> int:
    return sum(1 for e in pl.DEVICE_CACHE._entries.values() if e["table"] is table)


@pytest.mark.parametrize("how", ["drop", "disconnect"])
def test_temporary_table_leaves_no_staged_batches(how):
    s = Session(device="cpu", chunk_capacity=CAP)
    s.execute(f"set tidb_tpu_segment_rows = {SEG_ROWS}")
    s.execute("create temporary table tt (k bigint, v bigint)")
    t = s.catalog.table("test", "tt")
    t.insert_columns({"k": np.arange(NP) % 7, "v": np.arange(NP)})
    assert s.query("select k, sum(v) from tt group by k order by k")[0] == (0, sum(range(0, NP, 7)))
    assert _staged_entries(t) > 0
    before = pl.DEVICE_CACHE.resident_bytes()
    if how == "drop":
        s.execute("drop table tt")
    else:
        s.catalog.drop_temp_tables()
    assert _staged_entries(t) == 0
    assert pl.DEVICE_CACHE.resident_bytes() < before
