"""Statistics through the port (tidb_tpu_torch on the CPU) against the JAX
package: ANALYZE, the NDV sketch, `modify_count` and auto-analyze after a
commit, and the plans they give.

- TPC-H SF0.05 (the reference's generator, seed 7) exported into the
  port with every reference and port Session at `tidb_tpu_compaction = 0`.
  The 22 queries are planned (`explain_text`) and run in both packages in
  three states, in this order: (a) unanalyzed; (c) after one committed
  `DELETE FROM lineitem WHERE l_orderkey = 1`, whose commit auto-analyzes
  lineitem in both; (b) after `ANALYZE TABLE` of all eight tables. The
  reference plans with the port's key-domain join estimate
  (test_torch_scale.reference_key_domain; ROADMAP, known divergences).
  The plan text must be equal, the rows equal by `rows_equal` (numbers within
  1e-6 relative) and then exactly as Python values (Q17 within 1e-6 only:
  the float division divergence ROADMAP lists).
- After (b) every table's `TableStats` equals the reference's field by
  field: row count, and per column NDV, null count, min, max, the
  histogram bounds (float64, bit-equal) and the MCV keys and counts.
- On a small pair: NDV sketch estimates (the KMV minimum hashes, equal)
  after ANALYZE and inserts; `modify_count` and the auto-analyze decision
  after each statement of one DML sequence that includes a commit finished
  by `resolve_locks` (the full-scan commit branch) and a CLUSTER BY
  re-sort (which counts as no modification).
"""

import contextlib

import numpy as np
import pytest

from tidb_tpu.parser import parse as jax_parse
from tidb_tpu.planner.physical import explain_text as jax_explain
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.tpch import load_tpch as jax_load_tpch
from tidb_tpu.testutil import rows_equal
from tidb_tpu.utils import failpoint as jax_fp
from tidb_tpu_torch.parser import parse
from tidb_tpu_torch.planner.physical import explain_text
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.tpch_queries import Q
from tidb_tpu_torch.utils import failpoint as fp

from test_torch_keys import both
from test_torch_scale import reference_key_domain
from test_torch_session import _export_into, _same, reference_witness_paused  # noqa: F401

TABLES = ("nation", "region", "part", "supplier", "partsupp", "customer",
          "orders", "lineitem")
STATES = ("unanalyzed", "after_dml", "analyzed")


def _snapshot(js, ps) -> dict:
    """Each query's plan text and rows in both packages: every plan first,
    then every run (runs build segment stores, whose zone maps feed the
    estimates, in the same order in both)."""
    out = {}
    for name, (sql, _osql) in Q.items():
        out[name] = [jax_explain(js._plan_select(jax_parse(sql)[0])),
                     explain_text(ps._plan_select(parse(sql)[0]))]
    for name, (sql, _osql) in Q.items():
        out[name] += [js.query(sql), ps.query(sql)]
    return out


@pytest.fixture(scope="module", autouse=True)
def reference_under_key_domain():
    """The reference plans with the port's key-domain join estimate (ROADMAP,
    known divergences): the plans are held to the rule, not to the
    reference's fallback."""
    with reference_key_domain():
        yield


@pytest.fixture(scope="module")
def tpch_states():
    js = JaxSession()
    js.execute("set tidb_tpu_compaction = 0")
    jax_load_tpch(js.catalog, sf=0.05)
    ps = Session(device="cpu")
    ps.execute("set tidb_tpu_compaction = 0")
    for name in TABLES:
        _export_into(ps, js.catalog.table("test", name), name)
    states = {"unanalyzed": _snapshot(js, ps)}
    for s in (js, ps):
        for sql in ("begin", "delete from lineitem where l_orderkey = 1", "commit"):
            s.execute(sql)
    states["after_dml"] = _snapshot(js, ps)
    for s in (js, ps):
        s.execute("analyze table " + ", ".join(TABLES))
    states["analyzed"] = _snapshot(js, ps)
    return js, ps, states


_CASES = [(st, q) for st in STATES for q in Q]


@pytest.mark.parametrize("state,q", _CASES, ids=[f"{s}-{q}" for s, q in _CASES])
def test_plan_matches_reference(tpch_states, state, q):
    want, got = tpch_states[2][state][q][:2]
    assert got == want


@pytest.mark.parametrize("state,q", _CASES, ids=[f"{s}-{q}" for s, q in _CASES])
def test_rows_match_reference(tpch_states, state, q):
    want, got = tpch_states[2][state][q][2:]
    if q == "q17":
        # XLA folds the reference's `sum / 7.0` into one division; the port
        # divides in two steps as sqlite does (ROADMAP, known divergences):
        # the last bit may differ, so Q17 compares within rows_equal's 1e-6
        ok, msg = rows_equal(got, want, ordered=True)
        assert ok, msg
    else:
        _same(got, want, ordered=True)


def test_commit_auto_analyzes_lineitem(tpch_states):
    """The DML's commit analyzed lineitem in both (no stats, 300k rows,
    modify_count > 0); ANALYZE then left every table fresh and reset."""
    js, ps, _ = tpch_states
    for s in (js, ps):
        for name in TABLES:
            t = s.catalog.table("test", name)
            assert t.stats is not None and t.stats.version == t.version, name
            assert t.modify_count == 0


@pytest.mark.parametrize("name", TABLES)
def test_table_stats_match_reference(tpch_states, name):
    js, ps, _ = tpch_states
    want = js.catalog.table("test", name).stats
    got = ps.catalog.table("test", name).stats
    assert got.n_rows == want.n_rows
    assert list(got.cols) == list(want.cols)
    for col, w in want.cols.items():
        g = got.cols[col]
        assert (g.ndv, g.null_count, g.min, g.max) == (w.ndv, w.null_count, w.min, w.max), col
        if w.bounds is None:
            assert g.bounds is None, col
        else:
            assert g.bounds.dtype == np.float64, col
            np.testing.assert_array_equal(g.bounds, w.bounds, err_msg=col)
        assert g.mcv == w.mcv, col
        if w.mcv:
            assert list(g.mcv) == list(w.mcv), col  # same order: by count


# -- the NDV sketch, modify_count and the auto-analyze decision --------------

def _pair():
    js = JaxSession()
    js.execute("set tidb_tpu_compaction = 0")
    ps = Session(device="cpu")
    ps.execute("set tidb_tpu_compaction = 0")
    return js, ps


def test_ndv_sketch_tracks_inserts_like_reference():
    js, ps = _pair()
    rng = np.random.default_rng(11)
    both(js, ps, "create table s (k bigint, f double, g varchar(8), d decimal(8,2))")

    def rows(n, hi):
        return ", ".join(
            f"({int(k)}, {float(f)!r}, 'g{int(g)}', {int(d)}.{int(d) % 100:02d})"
            for k, f, g, d in zip(rng.integers(0, hi, n), rng.normal(size=n),
                                  rng.integers(0, hi // 4, n),
                                  rng.integers(0, hi, n)))

    both(js, ps, "insert into s values " + rows(300, 200))
    both(js, ps, "analyze table s")
    for hi in (1000, 5000, 20000):
        both(js, ps, "insert into s values " + rows(400, hi))
        for s in (js, ps):
            s.execute("update s set f = f + 1 where k < 10")
        jt, pt = js.catalog.table("test", "s"), ps.catalog.table("test", "s")
        assert set(pt.ndv_sketch) == set(jt.ndv_sketch) == {"k", "f", "g", "d"}
        for col, jsk in jt.ndv_sketch.items():
            psk = pt.ndv_sketch[col]
            np.testing.assert_array_equal(psk.mins, jsk.mins, err_msg=col)
            assert psk.estimate() == jsk.estimate(), col


@contextlib.contextmanager
def armed_before_secondary():
    """Arm the 2PC failpoint between secondaries in both packages."""
    jax_fp.enable("2pc.before_secondary")
    fp.enable("2pc.before_secondary")
    try:
        yield
    finally:
        jax_fp.disable("2pc.before_secondary")
        fp.disable("2pc.before_secondary")


_DML = [
    "create table a (k bigint primary key, v bigint)",
    "create table b (k bigint, v bigint) cluster by (k)",
    "set tidb_tpu_segment_rows = 1024",
    # 1,500 rows: no stats yet, past 1,024 rows, so the commit analyzes
    "insert into a values " + ", ".join(f"({i}, {i % 17})" for i in range(1500)),
    "insert into b values " + ", ".join(f"({(i * 7919) % 3001}, {i})" for i in range(3001)),
    "update a set v = v + 1 where k < 100",
    "delete from a where k >= 1000",
    "begin",
    "update a set v = 0 where k < 400",
    "insert into b values (5000, 1), (5001, 2)",
    "commit",
    # the first fold of b re-sorts it by k at this statement's end
    "select count(*) from b where k > 10",
    "update b set v = v + 1 where k < 2000",
    "select count(*) from b where k > 10",
    "delete from b where k < 1600",
]


def _stats_state(s, names):
    out = []
    for name in names:
        t = s.catalog.table("test", name)
        st = getattr(t, "stats", None)  # set by the first ANALYZE
        fresh = st is not None and st.version == t.version
        out.append((name, t.modify_count, fresh, st and st.n_rows,
                    t.clustered_rows))
    return out


def test_modify_count_and_auto_analyze_match_reference():
    """After every statement both packages hold the same modify_count,
    the same freshness and analyzed row count. The middle transaction's
    COMMIT crashes between its secondaries (2PC): resolve_locks finishes
    it over the full-scan commit branch, which must count its rows."""
    js, ps = _pair()
    history = []
    for sql in _DML:
        if sql == "commit":
            with armed_before_secondary():
                for s, err in ((js, jax_fp.FailpointError), (ps, fp.FailpointError)):
                    with pytest.raises(err):
                        s.execute(sql)
                    s.txn = None
            assert ps.catalog.resolve_locks() == js.catalog.resolve_locks() == 1
        else:
            assert both(js, ps, sql) is None, sql
        names = [n for n in ("a", "b") if ps.catalog.has_table("test", n)]
        got, want = _stats_state(ps, names), _stats_state(js, names)
        assert got == want, sql
        history.append(got)
    # the sequence exercised each decision: analyzed at the bulk inserts,
    # modifications counted past a fresh analyze, the re-sort at the fold
    flat = [row for step in history for row in step]
    assert any(name == "a" and fresh for name, _m, fresh, _n, _c in flat)
    assert any(name == "b" and mc > 0 and not fresh for name, mc, fresh, _n, _c in flat)
    assert history[-1][1][4] > 0  # b was re-sorted
