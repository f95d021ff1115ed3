"""Spill and memory accounting: the port's sort, host generic aggregation,
key-range external merge and hash-join build tracker, held to the
reference (tidb_tpu) on the same data.

Mirrors tests/test_memory.py (TestSpillCorrectness, TestExternalRangeMerge)
and the spill cases of tests/test_agg_ext.py. The reference on the CPU runs
its host engine; the port reaches the same host generic aggregation with
`tidb_device_engine_mode = 'off'` (its 'auto' runs torch on every device).
Rows compare exactly for integers and decimals and at 1e-9 relative for
averages and variances (the merge order of float partial states differs
between a spilled and an unspilled run). Spill files are written under a
per-test temporary directory, which must be empty again afterwards."""

import contextlib
import os
import tempfile

import numpy as np
import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.tpch import load_tpch as jax_load_tpch
from tidb_tpu.utils import dispatch as jdispatch
from tidb_tpu.utils.metrics import EXTERNAL_AGG as J_EXTERNAL_AGG
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.session.session import _parse_quota
from tidb_tpu_torch.storage.tpch_queries import Q
from tidb_tpu_torch.utils import dispatch as pdispatch
from tidb_tpu_torch.utils.memory import MemTracker, QueryOOMError, SpillableRuns
from tidb_tpu_torch.utils.metrics import EXTERNAL_AGG as P_EXTERNAL_AGG

from test_torch_session import _export_into
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

BUDGET = 64 * 1024  # small enough to force spills on 4,000 rows


@pytest.fixture(autouse=True)
def spill_dir(tmp_path, monkeypatch):
    """Spill files of both packages land in a directory of this test's
    own, which must hold no operator spill file when the test ends (the
    segment stores' own directories, `tidb_tpu_seg_*`, live with their
    tables)."""
    d = tmp_path / "spill"
    d.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(d))
    yield d
    left = [n for n in os.listdir(d) if n.startswith("tidb_tpu_spill_")]
    assert left == [], "spill files left behind"


def _fill(s):
    s.execute("create table t (a bigint, b bigint, c varchar(10), "
              "d decimal(12,2), f double)")
    rng = np.random.default_rng(3)
    # 50 groups: partial group tables fit a small budget while the raw
    # input does not, the shape the aggregation's spill path is built for
    rows = ", ".join(
        f"({int(a)}, {int(b)}, 'g{int(b) % 7}', {int(a) % 9973}.{int(b) % 100:02d}, "
        f"{float(f)!r})"
        for a, b, f in zip(rng.integers(0, 1_000_000, 4000),
                           rng.integers(0, 50, 4000), rng.random(4000)))
    s.execute(f"insert into t values {rows}")
    return s


def make_pair(**kw):
    js = _fill(JaxSession(**kw))
    js.execute("set tidb_tpu_compaction = 0")
    ps = _fill(Session(device="cpu", **kw))
    # the host engine: the reference's CPU 'auto' picks it too
    ps.execute("set tidb_device_engine_mode = 'off'")
    return js, ps


def tiny_budget(s, budget):
    """Patch a session's exec ctx to a budget below the sysvar floor;
    returns the list that collects each context's tracker."""
    orig = s._exec_ctx
    trackers = []

    def tiny_ctx(**kwargs):
        ctx = orig(**kwargs)
        ctx.mem_tracker.budget = budget
        trackers.append(ctx.mem_tracker)
        return ctx

    s._exec_ctx = tiny_ctx
    return trackers


def close_rows(got, want, rel=1e-9):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(y, float) and isinstance(x, float):
                assert x == pytest.approx(y, rel=rel, abs=1e-12), (g, w)
            else:
                assert x == y, (g, w)


def spilled(fn):
    """(result, spill bytes of the reference's and the port's thread)."""
    j0, p0 = jdispatch.spill_bytes(), pdispatch.spill_bytes()
    out = fn()
    return out, jdispatch.spill_bytes() - j0, pdispatch.spill_bytes() - p0


class TestTracker:
    def test_spill_sheds_before_oom(self):
        root = MemTracker("q", budget=3000)
        runs = SpillableRuns(root.child("sort"))
        for _ in range(10):
            runs.append({"x": np.zeros(100, dtype=np.int64)})  # 800 B each
        assert runs.spilled
        assert root.consumed <= 3000
        assert sum(rows for _, rows in runs.all_runs()) == 1000
        runs.close()
        assert root.consumed == 0

    def test_spill_feeds_the_statement_profile(self):
        root = MemTracker("q", budget=1000)
        runs = SpillableRuns(root.child("sort"))
        p0 = pdispatch.spill_bytes()
        runs.append({"x": np.zeros(200, dtype=np.int64)})  # 1,600 B: spills
        assert pdispatch.spill_bytes() - p0 == 1600
        runs.close()


@pytest.mark.parametrize("sql", [
    "select a, b from t order by a, b",
    "select a, c, d, f from t order by d desc, f",
    "select b, c from t order by c, b desc, a limit 700",
], ids=["two_keys", "decimal_double", "topn"])
def test_sort_spill_matches_reference(sql):
    js, ps = make_pair(chunk_capacity=256)
    want_plain = js.query(sql)
    jt, pt = tiny_budget(js, BUDGET), tiny_budget(ps, BUDGET)
    (want, got), jsp, psp = spilled(lambda: (js.query(sql), ps.query(sql)))
    assert got == want == want_plain
    assert psp > 0 and jsp > 0, (jsp, psp)
    # the budget was really hit, and every tracker ends at zero
    assert any(t.max_consumed > BUDGET for t in pt)
    assert all(t.consumed == 0 for t in pt + jt), "leaked accounting"


@pytest.mark.parametrize("sql", [
    "select b, count(*), sum(a), min(a), max(a), avg(a) from t "
    "group by b order by b",
    "select b, c, count(*), sum(d), avg(d), min(f), max(f) from t "
    "group by b, c order by b, c",
    "select b, bit_and(a), bit_or(a), bit_xor(a), var_pop(f), stddev_samp(f) "
    "from t group by b order by b",
    "select count(*), bit_or(a), var_samp(f) from t",
], ids=["core", "decimal_string", "bitwise_variance", "global"])
def test_generic_agg_spill_matches_reference(sql):
    js, ps = make_pair(chunk_capacity=256)
    js.execute("set tidb_enable_tpu_exec = 0")
    want_plain = js.query(sql)
    jt, pt = tiny_budget(js, BUDGET), tiny_budget(ps, BUDGET)
    (want, got), jsp, psp = spilled(lambda: (js.query(sql), ps.query(sql)))
    close_rows(got, want)
    close_rows(got, want_plain)
    assert psp > 0 and jsp > 0, (jsp, psp)
    assert any(t.max_consumed > BUDGET for t in pt)
    assert all(t.consumed == 0 for t in pt + jt), "leaked accounting"


def test_distinct_agg_under_budget_matches_reference():
    """DISTINCT needs raw values: spilled runs rematerialize under the
    `hashagg.distinct` tracker, in both packages alike."""
    sql = "select b, count(distinct c), sum(distinct b) from t group by b order by b"
    js, ps = make_pair(chunk_capacity=256)
    js.execute("set tidb_enable_tpu_exec = 0")
    outs = []
    for s in (js, ps):
        tiny_budget(s, 4 * BUDGET)
        try:
            outs.append(("ok", s.query(sql)))
        except Exception as e:  # noqa: BLE001 — the class is the result
            outs.append((type(e).__name__, None))
    assert outs[0] == outs[1]


def test_oom_when_spill_disabled_in_both():
    js, ps = make_pair(chunk_capacity=256)
    errs = []
    for s in (js, ps):
        s.execute("set tidb_enable_tmp_storage_on_oom = OFF")
        tiny_budget(s, 1024)
        with pytest.raises(Exception) as ei:
            s.query("select a from t order by a")
        errs.append(type(ei.value).__name__)
    assert errs == ["QueryOOMError", "QueryOOMError"]
    with pytest.raises(QueryOOMError):
        ps.query("select c, sum(a) from t group by c")


class TestExternalRangeMerge:
    """Key-range external aggregation: when the spilled runs' total group
    state exceeds the budget (near-unique keys), the aggregation merges
    and emits one key range at a time."""

    @staticmethod
    def _pair(name, cols, quota=1 << 20, cap=1 << 14):
        js = JaxSession(chunk_capacity=cap)
        js.execute("set tidb_tpu_compaction = 0")
        ps = Session(device="cpu", chunk_capacity=cap)
        ps.execute("set tidb_device_engine_mode = 'off'")
        for s in (js, ps):
            s.execute(f"create table {name} (" + ", ".join(
                f"{c} bigint" for c in cols) + ")")
            s.catalog.table("test", name).insert_columns(dict(cols))
        return js, ps

    @staticmethod
    def _quota(pair, quota):
        for s in pair:
            s.execute(f"set tidb_mem_quota_query = {quota}")
            s.execute("set tidb_enable_tmp_storage_on_oom = 1")

    def test_near_unique_keys_under_tight_quota(self):
        n = 200_000
        pair = self._pair("e", {"k": np.arange(n), "v": np.arange(n) * 3})
        self._quota(pair, 1 << 20)
        sql = ("select count(*), sum(s2) from "
               "(select k, sum(v) as s2 from e group by k) d")
        e0 = (J_EXTERNAL_AGG.value(), P_EXTERNAL_AGG.value())
        (want, got), _jsp, psp = spilled(lambda: tuple(s.query(sql) for s in pair))
        assert got == want == [(n, sum(range(n)) * 3)]
        assert J_EXTERNAL_AGG.value() > e0[0]
        assert P_EXTERNAL_AGG.value() > e0[1], "external merge never engaged"
        assert psp > 0

    def test_results_match_unbudgeted(self):
        n = 120_000
        rng = np.random.default_rng(3)
        pair = self._pair("e2", {"k": rng.integers(0, n, n),
                                 "v": rng.integers(-50, 50, n)})
        sql = ("select k, count(*), sum(v), min(v), max(v) from e2 "
               "group by k order by k limit 500")
        want = pair[0].query(sql)
        self._quota(pair, 1 << 20)
        assert pair[1].query(sql) == pair[0].query(sql) == want

    def test_low_cardinality_stays_in_memory(self):
        n = 300_000
        pair = self._pair("lo", {"k": np.arange(n) % 10,
                                 "v": np.ones(n, np.int64)})
        self._quota(pair, 2 << 20)
        e0 = P_EXTERNAL_AGG.value()
        sql = "select k, count(*) from lo group by k order by k"
        assert pair[1].query(sql) == pair[0].query(sql) == [
            (k, n // 10) for k in range(10)]
        assert P_EXTERNAL_AGG.value() == e0, "external path fired needlessly"

    def test_scalar_agg_under_quota(self):
        n = 400_000
        pair = self._pair("sc", {"v": np.ones(n, np.int64)})
        self._quota(pair, 1 << 20)
        sql = "select count(*), sum(v) from sc"
        assert pair[1].query(sql) == pair[0].query(sql) == [(n, n)]

    def test_mid_merge_bail_on_underestimated_density(self):
        """A low-cardinality prefix fools the 16k-row density sample into
        the in-memory merge; the high-cardinality tail must bail to the
        external path mid-merge instead of failing the quota."""
        n = 1_200_000
        keys = np.concatenate([np.zeros(200_000, np.int64),
                               np.arange(n - 200_000)])
        pair = self._pair("bs", {"k": keys, "v": np.ones(n, np.int64)},
                          cap=1 << 20)
        self._quota(pair, 8 << 20)
        sql = ("select count(*), sum(s2) from (select k, sum(v) s2 "
               "from bs group by k) d")
        assert pair[1].query(sql) == pair[0].query(sql) == [(n - 200_000, n)]


def test_hash_join_build_is_charged_until_close():
    """The staged build's resident bytes sit on `hashjoin.build` while the
    join runs and go back at close(), on the device build and on the host
    sorted build alike."""
    from tidb_tpu_torch.executor import build_executor
    from tidb_tpu_torch.executor.join import HashJoinExec
    from tidb_tpu_torch.parser import parse

    ps = Session(device="cpu")
    ps.execute("create table bl (k bigint, v bigint)")
    ps.execute("create table pr (k bigint, w bigint)")
    ps.execute("insert into bl values " + ",".join(f"({i}, {i * 2})" for i in range(300)))
    ps.execute("insert into pr values " + ",".join(f"({i % 50}, {i})" for i in range(900)))
    sql = "select pr.w, bl.v from pr join bl on pr.k = bl.k where bl.v > 3"
    for fuse, device_build in ((0, 1), (0, 0), (1, 1)):
        ps.execute(f"set tidb_tpu_pipeline_fuse = {fuse}")
        ps.execute(f"set tidb_tpu_join_device_build = {device_build}")
        phys = ps._plan_select(parse(sql)[0])
        root = build_executor(phys)
        ctx = ps._exec_ctx(plan=phys)
        root.open(ctx)
        joins, stack = [], [root]
        while stack:
            e = stack.pop()
            if e is None:
                continue
            if isinstance(e, HashJoinExec) and hasattr(e, "_sorted_keys"):
                joins.append(e)
            stack.extend(getattr(e, "children", ()))
            stack.append(getattr(e, "_delegate", None))
        assert len(joins) == 1
        j = joins[0]
        want = (j._sorted_keys.nbytes + j._firsts.nbytes
                + sum(d.nbytes + v.nbytes for d, v in j._build_payload.values()))
        assert j._build_bytes == want > 0
        assert j._mem_tracker.label == "hashjoin.build"
        assert j._mem_tracker.consumed == want
        assert ctx.mem_tracker.consumed >= want
        n = sum(int(ch.sel.sum()) for ch in root.chunks())
        assert n == 48 * 18  # k in [2, 49]: 18 probe rows each
        root.close()
        assert j._build_bytes == 0
        assert ctx.mem_tracker.consumed == 0


@pytest.mark.parametrize("arg", ["1024", "64 MB", "2 GB", "3 kb", "lots",
                                 "", "12 TB", " 7 "])
def test_memory_quota_units_match_reference(arg):
    from tidb_tpu.session.session import _parse_quota as jax_parse_quota

    assert _parse_quota(arg) == jax_parse_quota(arg)


def test_memory_quota_hint_sets_the_statement_budget():
    js, ps = make_pair(chunk_capacity=256)
    sql = "select /*+ MEMORY_QUOTA(1024) */ a from t order by a"
    for s in (js, ps):
        s.execute("set tidb_enable_tmp_storage_on_oom = 0")
    errs = []
    for s in (js, ps):
        with pytest.raises(Exception) as ei:
            s.query(sql)
        errs.append(type(ei.value).__name__)
    assert errs == ["QueryOOMError", "QueryOOMError"]
    # an unparseable argument is ignored: the sysvar budget holds
    q = "select /*+ MEMORY_QUOTA(lots) */ count(*) from t"
    assert ps.query(q) == js.query(q) == [(4000,)]
    # and the hint reaches the tracker the statement runs under
    for s in (js, ps):
        s.execute("set tidb_enable_tmp_storage_on_oom = 1")
    seen = []
    orig = ps._exec_ctx

    def spy(**kw):
        ctx = orig(**kw)
        seen.append(ctx.mem_tracker.budget)
        return ctx

    ps._exec_ctx = spy
    (want, got), jsp, psp = spilled(lambda: (
        js.query("select /*+ MEMORY_QUOTA(64 KB) */ a, b from t order by a, b"),
        ps.query("select /*+ MEMORY_QUOTA(64 KB) */ a, b from t order by a, b")))
    assert got == want
    assert seen == [64 << 10]
    assert psp > 0 and jsp > 0


@pytest.fixture(scope="module")
def q18_pair():
    js = JaxSession()
    jax_load_tpch(js.catalog, sf=0.01)
    ps = Session(device="cpu")
    for name in ("lineitem", "orders", "customer"):
        _export_into(ps, js.catalog.table("test", name), name)
    return js, ps


@pytest.mark.parametrize("quota", ["640 KB", "2560 KB"])
def test_q18_default_mode_under_quota_ends_as_reference(q18_pair, quota):
    """Q18 in each package's default mode under a MEMORY_QUOTA: the
    reference's CPU default is its host engine, the port's the device
    generic aggregation (charged to `hashagg.device`, which does not
    spill). The outcome, completion with the same rows or QueryOOMError,
    must be the same."""
    js, ps = q18_pair
    sql = Q["q18"][0].replace("select", f"select /*+ MEMORY_QUOTA({quota}) */", 1)
    outs = []
    for s in (js, ps):
        try:
            outs.append(("ok", s.query(sql)))
        except Exception as e:  # noqa: BLE001 — the class is the result
            outs.append((type(e).__name__, None))
    assert outs[1][0] == outs[0][0], (outs[0][0], outs[1][0])
    if outs[0][0] == "ok":
        assert outs[1][1] == outs[0][1]


class TestChargeOnError:
    """A QueryOOMError never leaves bytes charged. The port's
    MemTracker.consume records the charge on the whole chain before any
    budget check raises, and every caller counts the bytes before the
    call, so its release balances on the error path too. The reference
    checks each node as it charges it, so the ancestors above the
    statement's root go uncharged, and its device aggregation's finalize
    and a fused executor's delegate that fails to open leave bytes
    charged (ROADMAP, intended divergences)."""

    def test_chain_is_charged_before_the_check(self):
        server = MemTracker("server")
        root = MemTracker("query", budget=1000, parent=server, spill_root=True)
        op = root.child("op")
        with pytest.raises(QueryOOMError):
            op.consume(5000)
        assert (op.consumed, root.consumed, server.consumed) == (5000, 5000, 5000)
        op.release(5000)
        assert (op.consumed, root.consumed, server.consumed) == (0, 0, 0)

    def test_device_aggregation_oom_leaves_nothing_charged(self, q18_pair):
        _js, ps = q18_pair
        sql = Q["q18"][0].replace("select", "select /*+ MEMORY_QUOTA(1 MB) */", 1)
        with ps_trackers(ps) as ctxs:
            with pytest.raises(QueryOOMError):
                ps.query(sql)
        assert ctxs and all(c.mem_tracker.consumed == 0 for c in ctxs)

    def test_failed_delegate_open_is_closed(self):
        """A full ORDER BY over the fused top-k's gate opens the classic
        sort as its delegate; when that open() raises QueryOOMError
        (spilling off), the delegate is still closed and its runs'
        charge released."""
        _js, ps = make_pair(chunk_capacity=256)
        ps.execute("set tidb_device_engine_mode = 'auto'")
        ps.execute("set tidb_enable_tmp_storage_on_oom = 0")
        with ps_trackers(ps) as ctxs:
            tiny_budget(ps, 1024)
            with pytest.raises(QueryOOMError):
                ps.query("select a, b, c, d, f from t order by f, a")
        assert ctxs and all(c.mem_tracker.consumed == 0 for c in ctxs)


@contextlib.contextmanager
def ps_trackers(s):
    """The exec contexts a port session makes inside the block."""
    seen = []
    orig = s._exec_ctx

    def spy(**kw):
        ctx = orig(**kw)
        seen.append(ctx)
        return ctx

    s._exec_ctx = spy
    try:
        yield seen
    finally:
        s._exec_ctx = orig
