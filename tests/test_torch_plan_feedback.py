"""Plan feedback: the port's planner/feedback.py store, its consumers in
the session (join cardinalities, the eager-aggregation push-down
protocol, the fused probe's tile hint) and its surfaces, held to the
reference (tidb_tpu) on the same inputs.

Mirrors tests/test_plan_feedback.py. The store and the push-down protocol
are driven with the same injected observations in both packages and must
answer alike; the decision taken from measured wall times is never
compared (it depends on the clock). The skewed join is exact against the
sqlite oracle on both executions in both packages, and its plan flips in
the port as in the reference.

Left out: `test_concurrent_statements_under_sanitizer` (the port has no
lock sanitizer, ROADMAP Queue A item 7) and `TestShuffleBytesFeedback`
(the DCN shuffle, item 6), and the static surface count of the
reference's analysis registry.

The stores are process-global in both packages: every test starts and
ends with both empty."""

import json
import urllib.request

import numpy as np
import pytest

from tidb_tpu.planner import feedback as jfb
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.catalog import Catalog as JaxCatalog
from tidb_tpu.testutil import mirror_to_sqlite, rows_equal
from tidb_tpu_torch.parser import parse
from tidb_tpu_torch.planner import feedback as fb
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.catalog import Catalog

from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def stores_cleared():
    fb.STORE.on_schema_change()
    jfb.STORE.on_schema_change()
    yield
    fb.STORE.on_schema_change()
    jfb.STORE.on_schema_change()


def _obs(mod, ops=(), latency=0.01, warm=False, eager=False, fused=False,
         join_rows=None, scan_rows=None, tiles=(0, 0, 0)):
    o = mod.Observation()
    o.ops = list(ops)
    o.latency_s = latency
    o.warm = warm
    o.eager_partial = eager
    o.fused_probe = fused
    o.join_rows = dict(join_rows or {})
    o.scan_rows = dict(scan_rows or {})
    o.tile_chunks, o.tile_overflows, o.tile_max_need = tiles
    return o


def both_stores(**kw):
    return fb.PlanFeedbackStore(**kw), jfb.PlanFeedbackStore(**kw)


def _stats(st):
    d = st.stats_dict()
    for dg in d.get("digests", ()):
        for v in dg.get("variants", ()):
            v.pop("last_ms", None)
    return d


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


class TestStore:
    def test_roundtrip(self):
        outs = []
        for st, mod in zip(both_stores(capacity=8), (fb, jfb)):
            st.record("d1", "p1", True,
                      _obs(mod, ops=[("Scan", 100.0, 400.0)], latency=0.02))
            outs.append((st.rows(), _stats(st)))
        assert outs[0] == outs[1]
        rows = outs[0][0]
        assert rows[0][:4] == ("d1", "p1", "push", 1)
        assert rows[0][8:12] == ("Scan", 100.0, 400.0, 4.0)
        assert outs[0][1]["recorded"] == 1

    def test_latest_actual_wins_and_execs_fold(self):
        outs = []
        for st, mod in zip(both_stores(), (fb, jfb)):
            st.record("d", "p", True, _obs(mod, ops=[("Join", 10.0, 100.0)]))
            st.record("d", "p", True, _obs(mod, ops=[("Join", 10.0, 80.0)]))
            outs.append(st.rows())
        assert outs[0] == outs[1]
        assert outs[0][0][10] == 80.0 and outs[0][0][12] == 2

    def test_lru_bound_and_capacity_argument(self):
        outs = []
        for st, mod in zip(both_stores(capacity=4), (fb, jfb)):
            for i in range(10):
                st.record(f"d{i}", "p", True, _obs(mod))
            a = ({r[0] for r in st.rows()}, st.evicted)
            for i in range(8):
                st.record(f"e{i}", "p", True, _obs(mod), capacity=2)
            outs.append((a, len(st.rows())))
        assert outs[0] == outs[1] == (({"d6", "d7", "d8", "d9"}, 6), 2)

    def test_invalidation_clears_everything(self):
        key = frozenset({("a", "k"), ("b", "k")})
        outs = []
        for st, mod in zip(both_stores(), (fb, jfb)):
            st.record("d", "p", True, _obs(
                mod, join_rows={key: 500.0},
                scan_rows={("a", "c:x"): (10.0, 100.0)}))
            before = (st.join_hint(key), st.scan_hint("a", "c:x"))
            st.on_schema_change()
            outs.append((before, st.rows(), st.join_hint(key),
                         st.scan_hint("a", "c:x"), st.invalidations))
        assert outs[0] == outs[1]
        assert outs[0][1:] == ([], None, None, 1)

    def test_ddl_and_analyze_invalidate_the_global_store(self):
        s = Session(catalog=Catalog(), device="cpu")
        s.execute("create table inv (a bigint)")
        fb.STORE.record("d-inv", "p", True, _obs(fb))
        assert any(r[0] == "d-inv" for r in fb.STORE.rows())
        s.execute("create table inv2 (a bigint)")  # DDL: schema_version
        assert not any(r[0] == "d-inv" for r in fb.STORE.rows())
        fb.STORE.record("d-inv", "p", True, _obs(fb))
        s.execute("analyze table inv")  # statistics reset the baseline too
        assert not any(r[0] == "d-inv" for r in fb.STORE.rows())

    def test_concurrent_writers(self):
        import threading

        st = fb.PlanFeedbackStore(capacity=64)
        errs = []

        def worker(i):
            try:
                for j in range(200):
                    st.record(f"d{j % 32}", f"p{i}", True,
                              _obs(fb, ops=[("Scan", 10.0, 20.0 + i)]))
                    st.scan_hint("a", "fp")
                    st.rows()
            except Exception as e:  # noqa: BLE001 — collected for assert
                errs.append(e)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs
        assert len(st.rows()) <= 64 * 8
        assert st.recorded == 800

    def test_shuffle_hint_roundtrip(self):
        outs = []
        for st in both_stores():
            st.record_shuffle("dg", {"t1": 1024, "t2": 9999}, {"t1": 3, "t2": 1})
            a = st.shuffle_hint("dg")
            st.record_shuffle("dg", {"t1": 2048}, {"t1": 3})
            b = st.shuffle_hint("dg")["t1"]
            st.on_schema_change()
            c = st.shuffle_hint("dg", {"t1": 3, "t2": 1})["t1"]
            d = st.shuffle_hint("dg", {"t1": 4, "t2": 1})
            outs.append((a, b, c, d, st.shuffle_hint("dg"), st.shuffle_hint("x")))
        assert outs[0] == outs[1]
        assert outs[0] == ({"t1": 1024, "t2": 9999}, 2048, 2048, {}, {}, {})

    def test_helpers_agree(self):
        assert fb.EXPLORE_BUDGET == jfb.EXPLORE_BUDGET
        assert fb.WIN_MARGIN == jfb.WIN_MARGIN
        assert fb.DEFAULT_CAPACITY == jfb.DEFAULT_CAPACITY
        for ops in ([], [("Scan", 10.0, 10.0)], [("Join", 4.0, 400.0)],
                    [("Agg", 100.0, 1.0), ("Scan", 2.0, 3.0)]):
            po, jo = _obs(fb, ops=ops), _obs(jfb, ops=ops)
            for o, mod in ((po, fb), (jo, jfb)):
                o.ops = [mod.OpObservation(op, e, a) for op, e, a in ops]
            assert fb.drift_factor(po) == jfb.drift_factor(jo)


class TestApdDecision:
    """The measured push-vs-no-push protocol, driven with the same
    injected observations in both packages."""

    @staticmethod
    def _run(steps):
        outs = []
        for st, mod in zip(both_stores(), (fb, jfb)):
            seq = [st.apd_decision("d")]
            for variant, apd, kw in steps:
                if variant == "budget":
                    for _ in range(mod.EXPLORE_BUDGET):
                        st.record("d", "off", False, _obs(mod, latency=0.01))
                else:
                    st.record("d", variant, apd, _obs(mod, **kw))
                seq.append(st.apd_decision("d"))
            outs.append(seq)
        assert outs[0] == outs[1]
        return outs[0]

    def test_protocol(self):
        assert self._run([
            ("on", True, dict(eager=True, latency=0.1)),
            ("off", False, dict(latency=0.09)),
            ("off", False, dict(latency=0.02, warm=True)),
            ("on", True, dict(eager=True, latency=0.08, warm=True)),
        ]) == [None, False, False, None, False]

    def test_faster_default_sticks(self):
        assert self._run([
            ("on", True, dict(eager=True, latency=0.02, warm=True)),
            ("off", False, dict(latency=0.05, warm=True)),
        ])[-1] is None

    def test_no_eager_partial_means_no_opinion(self):
        assert self._run([("on", True, dict(eager=False, latency=0.1))]) == [
            None, None]

    def test_explore_budget_gives_up_on_warm(self):
        assert self._run([
            ("on", True, dict(eager=True, latency=0.1, warm=True)),
            ("budget", False, {}),
        ])[-1] is False

    def test_tile_hint(self):
        outs = []
        for st, mod in zip(both_stores(), (fb, jfb)):
            seq = []
            for tiles in ((10, 0, 0), (10, 3, 23), (10, 1, 700)):
                st.record("d", "p", True, _obs(mod, tiles=tiles))
                seq.append(st.tile_hint("d"))
            outs.append(seq)
        assert outs[0] == outs[1] == [0, 23, 64]


# ---------------------------------------------------------------------------
# the skewed join: heuristics pick the wrong order, the second execution
# flips it, exact against the oracle both times
# ---------------------------------------------------------------------------


def _skew_session(cls, **kw):
    s = cls(**kw)
    s.execute("set tidb_enable_auto_analyze = 0")
    s.execute("set tidb_slow_log_threshold = 0")  # every statement logs
    rng = np.random.default_rng(7)
    s.execute("create table a (k bigint, g bigint, flag bigint)")
    s.execute("create table b (k bigint, v bigint)")
    s.execute("create table c (g bigint, lbl bigint)")
    n = 8000
    k = rng.integers(1000, 9000, n).astype(np.int64)
    flag = rng.integers(0, 80, n).astype(np.int64)
    k[flag == 77] = 5  # every flag=77 row carries the hot key
    s.catalog.table("test", "a").insert_columns({
        "k": k, "g": rng.integers(0, 200, n).astype(np.int64), "flag": flag})
    s.catalog.table("test", "b").insert_columns({
        "k": np.full(100, 5, dtype=np.int64),
        "v": np.arange(100, dtype=np.int64)})
    s.catalog.table("test", "c").insert_columns({
        "g": (np.arange(800) % 200).astype(np.int64),
        "lbl": np.arange(800, dtype=np.int64)})
    s.execute("analyze table a, b, c")
    return s


_SKEW_SQL = ("select count(*) as n, sum(b.v) as sv from a "
             "join b on a.k = b.k join c on a.g = c.g "
             "where a.flag = 77")


def _op_depth(line):
    return len(line) - len(line.lstrip(" │├└─·"))


def _first_join_tables(explain_rows):
    """Table names that are direct children of the deepest HashJoin."""
    lines = [r[0] for r in explain_rows]
    joins = [(i, _op_depth(line))
             for i, line in enumerate(lines) if "HashJoin" in line]
    deepest, depth = max(joins, key=lambda t: t[1])
    tables = []
    for line in lines[deepest + 1:]:
        if _op_depth(line) <= depth:
            break
        if "table:" in line:
            tables.append(line.split("table:")[1].split(",")[0].strip())
    return set(tables)


def _skew_flip(s, want):
    """(first pair, second pair, plan changed, join hint) of the flip."""
    ex1 = _first_join_tables(s.execute("explain " + _SKEW_SQL).rows)
    r1 = s.query(_SKEW_SQL)
    d1 = s._last_plan_digest
    ok, msg = rows_equal(r1, want, ordered=True)
    assert ok, msg
    r2 = s.query(_SKEW_SQL)
    d2 = s._last_plan_digest
    ok, msg = rows_equal(r2, want, ordered=True)
    assert ok, msg
    ex2 = _first_join_tables(s.execute("explain " + _SKEW_SQL).rows)
    r3 = s.query(_SKEW_SQL)
    ok, _ = rows_equal(r3, want, ordered=True)
    assert ok
    return ex1, ex2, d1 != d2, s._last_plan_digest == d2


class TestSkewedJoinOrderFlip:
    def test_flip_matches_reference_and_is_oracle_exact(self):
        js = _skew_session(JaxSession, catalog=JaxCatalog())
        ps = _skew_session(Session, catalog=Catalog(), device="cpu")
        conn = mirror_to_sqlite(js.catalog, tables=["a", "b", "c"])
        want = conn.execute(_SKEW_SQL).fetchall()
        conn.close()
        got = _skew_flip(ps, want)
        hints = {k: v for k, v in fb.STORE._join_rows.items()
                 if k[0] == frozenset({("a", "k"), ("b", "k")})}
        assert _skew_flip(js, want) == got
        assert got == ({"a", "b"}, {"a", "c"}, True, True)
        # the harvest recorded the base pair's truth, keyed with each
        # side's filter fingerprint
        assert len(hints) == 1, fb.STORE._join_rows
        (key, rows), = hints.items()
        assert rows == pytest.approx(10400.0)
        sides = dict(key[1])
        assert sides["b"] == "" and "77" in sides["a"], key

    def test_feedback_off_reverts_to_heuristic_plan(self):
        ps = _skew_session(Session, catalog=Catalog(), device="cpu")
        ps.query(_SKEW_SQL)  # records the hint
        ps.execute("set tidb_tpu_plan_feedback = 0")
        ex = ps.execute("explain " + _SKEW_SQL).rows
        assert _first_join_tables(ex) == {"a", "b"}, ex
        rec0 = fb.STORE.recorded
        ps.query(_SKEW_SQL)
        assert fb.STORE.recorded == rec0  # nothing recorded either

    def test_drift_surfaces_and_metric(self):
        from tidb_tpu_torch.utils.metrics import PLAN_EST_DRIFT

        c0 = PLAN_EST_DRIFT.count()
        ps = _skew_session(Session, catalog=Catalog(), device="cpu")
        ps.query(_SKEW_SQL)
        ps.query(_SKEW_SQL)
        rows = ps.query(
            "select worst_drift_op, worst_drift from "
            "information_schema.slow_query where worst_drift > 1")
        assert rows, "no slow-log row carries drift"
        assert any(op.startswith("HashJoin") for op, _d in rows)
        summ = ps.query(
            "select max_drift, mean_drift, worst_drift_op from "
            "information_schema.statements_summary where max_drift > 4")
        assert summ, "statements_summary lost the drift aggregates"
        isrows = ps.query(
            "select op, est_rows, actual_rows, drift from "
            "information_schema.plan_feedback where drift > 4")
        assert isrows, "plan_feedback shows no drifted operator"
        assert PLAN_EST_DRIFT.count() > c0


# ---------------------------------------------------------------------------
# eager-aggregation exploration: protocol and correctness
# ---------------------------------------------------------------------------


def _apd_session(cls, **kw):
    s = cls(chunk_capacity=1 << 16, **kw)
    s.execute("SET tidb_device_engine_mode = 'force'")
    s.execute("SET tidb_enable_non_prepared_plan_cache = 1")
    s.execute("set tidb_enable_auto_analyze = 0")
    rng = np.random.default_rng(3)
    s.execute("create table li (ok bigint, qty bigint)")
    s.execute("create table ords (ok bigint, pri bigint)")
    n_o, n_l = 1500, 6000
    s.catalog.table("test", "ords").insert_columns({
        "ok": np.arange(n_o, dtype=np.int64),
        "pri": (np.arange(n_o) % 5).astype(np.int64)})
    s.catalog.table("test", "li").insert_columns({
        "ok": rng.integers(0, n_o, n_l).astype(np.int64),
        "qty": rng.integers(1, 50, n_l).astype(np.int64)})
    s.execute("analyze table li, ords")
    return s


_APD_SQL = ("select pri, count(*) as n, sum(qty) as q from li "
            "join ords on li.ok = ords.ok group by pri order by pri")


class TestApdExplorationIntegration:
    def test_q18_shape_explores_and_stays_correct(self):
        from tidb_tpu_torch.bindinfo import normalize_sql, sql_digest

        js = _apd_session(JaxSession, catalog=JaxCatalog())
        ps = _apd_session(Session, catalog=Catalog(), device="cpu")
        conn = mirror_to_sqlite(js.catalog, tables=["li", "ords"])
        want = conn.execute(_APD_SQL).fetchall()
        conn.close()
        apds = {}
        for name, s in (("port", ps), ("ref", js)):
            apds[name] = []
            for _ in range(6):
                got = s.query(_APD_SQL)
                apds[name].append(s._fb_last_apd)
                ok, msg = rows_equal(got, want, ordered=True)
                assert ok, msg  # every explored variant is oracle-exact
            assert bool(s.sysvars.get("tidb_opt_agg_push_down"))
        # run 0 executes the default (push) plan, run 1 explores the
        # no-push alternative, in both packages
        assert apds["port"][:2] == apds["ref"][:2] == [True, False], apds
        dg = sql_digest(normalize_sql(_APD_SQL))
        variants = {}
        for d in fb.STORE.stats_dict(50)["digests"]:
            if d["digest"] == dg:
                variants = {v["agg_push_down"]: v for v in d["variants"]}
        assert set(variants) == {True, False}, variants
        assert variants[True]["eager_partial"]
        assert not variants[False]["eager_partial"]
        if variants[True]["warm_execs"] and variants[False]["warm_execs"]:
            faster_off = (variants[False]["best_warm_ms"]
                          < variants[True]["best_warm_ms"] * fb.WIN_MARGIN)
            assert (fb.STORE.apd_decision(dg) is False) == faster_off

    def test_user_pin_is_authoritative(self):
        for s in (Session(catalog=Catalog(), device="cpu"),
                  JaxSession(catalog=JaxCatalog())):
            s.execute("create table pin_t (a bigint)")
            s.execute("set tidb_opt_agg_push_down = 0")
            s.query("select count(*) from pin_t")
            assert s._fb_last_apd is False


# ---------------------------------------------------------------------------
# the tile hint and the fused top-k routing
# ---------------------------------------------------------------------------


class TestContextConsumers:
    def test_exec_ctx_raises_join_tiles(self):
        s = Session(catalog=Catalog(), device="cpu")
        s.execute("create table tt (a bigint)")
        src = "select a from tt"
        norm, digest = s._stmt_digest(parse(src)[0], src)
        s._stmt_digest_memo = (src, norm, digest)
        assert s._exec_ctx().join_tiles == 8  # the sysvar's default
        fb.STORE.record(digest, "p", True, _obs(fb, tiles=(100, 40, 23)))
        s._stmt_digest_memo = (src, norm, digest)
        assert s._exec_ctx().join_tiles == 23
        s.execute("set tidb_tpu_plan_feedback = 0")
        s._stmt_digest_memo = (src, norm, digest)
        assert s._exec_ctx().join_tiles == 8  # off: no override

    def test_topn_overflow_routes_the_digest_classic(self):
        """A LIMIT past the device state's gate records its k; the next
        execution of the digest starts on the classic sort, as in the
        reference, with the same rows."""
        from tidb_tpu_torch.executor import pipeline as pl

        outs = []
        for s in (Session(catalog=Catalog(), device="cpu", chunk_capacity=64),
                  JaxSession(catalog=JaxCatalog(), chunk_capacity=64)):
            s.execute("create table tk (a bigint, b bigint)")
            s.catalog.table("test", "tk").insert_columns({
                "a": np.arange(500, dtype=np.int64) % 97,
                "b": np.arange(500, dtype=np.int64)})
            sql = "select a, b from tk order by a desc, b limit 100"
            rows = [s.query(sql) for _ in range(2)]
            assert rows[0] == rows[1]
            outs.append(rows[0])
            src = sql
            norm, digest = s._stmt_digest(parse(src)[0], src)
            store = fb.STORE if isinstance(s, Session) else jfb.STORE
            assert store.topn_overflow(digest) == 100
            if isinstance(s, Session):
                s._stmt_digest_memo = (src, norm, digest)
                assert s._exec_ctx().fused_topn is False
                pl.reset_counters()
                assert s.query(sql) == rows[0]
                assert pl.PIPELINE_FUSED_TOTAL["topn"] == 0
        assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# EXPLAIN / EXPLAIN ANALYZE columns
# ---------------------------------------------------------------------------


class TestExplainSurfaces:
    @pytest.fixture(scope="class")
    def sess(self):
        s = Session(catalog=Catalog(), device="cpu")
        s.execute("create table e (a bigint, b bigint)")
        s.execute("insert into e values (1,1),(2,2),(3,3),(4,4)")
        return s

    def test_explain_renders_est_rows(self, sess):
        rs = sess.execute("explain select a from e where b > 1")
        assert "estRows" in rs.rows[0][0]
        for (line,) in rs.rows[1:]:
            assert any(ch.isdigit() for ch in line), line

    def test_explain_analyze_est_and_drift(self, sess):
        rs = sess.execute("explain analyze select a from e where b > 1")
        header = rs.rows[0][0]
        for col in ("estRows", "actRows", "drift"):
            assert col in header, header
        assert "3" in "\n".join(r[0] for r in rs.rows[1:])


# ---------------------------------------------------------------------------
# the status endpoint, information_schema and the trace annotation
# ---------------------------------------------------------------------------


class TestEndToEndSurfaces:
    def test_plan_feedback_endpoint_matches_information_schema(self):
        from tidb_tpu_torch.server.server import Server

        cat = Catalog()
        s = Session(catalog=cat, device="cpu")
        s.execute("create table ep (a bigint, b bigint)")
        s.execute("insert into ep values (1, 1), (2, 2), (3, 2)")
        s.query("select b, count(*) from ep group by b")
        s.query("select count(*) from ep")
        srv = Server(catalog=cat, port=0, status_port=0, device="cpu")
        srv.start()
        try:
            base = f"http://127.0.0.1:{srv.status_port}"
            doc = json.loads(urllib.request.urlopen(
                base + "/plan_feedback?top=10").read())
        finally:
            srv.stop()
        assert "digests" in doc and doc["capacity"] >= 1
        assert doc["recorded"] >= 2
        rows = s.query("select digest, plan_digest, execs from "
                       "information_schema.plan_feedback")
        want = {(d["digest"], v["plan_digest"], v["execs"])
                for d in doc["digests"] for v in d["variants"]}
        assert {tuple(r) for r in rows} == want

    def test_worst_drift_annotation_on_kept_trace(self):
        from tidb_tpu_torch.utils import tracing

        s = _skew_session(Session, catalog=Catalog(), device="cpu")
        s.execute("set tidb_trace_sample_rate = 1")  # keep everything
        s.query(_SKEW_SQL)
        notes = []
        for t in tracing.STORE.traces():
            for sp in list(t.spans):
                notes.extend(getattr(sp, "notes", ()))
        assert any(str(n).startswith("worst_drift:") for n in notes), \
            "no kept trace carries the worst-drift annotation"
