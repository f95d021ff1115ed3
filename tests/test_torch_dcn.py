"""The port's DCN tier (tidb_tpu_torch/parallel/dcn.py) held to the
reference's (tidb_tpu/parallel/dcn.py) on the CPU.

Two fleets of in-process workers get the same seeded numpy rows: one of
port workers (`Worker(device="cpu")`, each a tidb_tpu_torch Session) under
a port `Cluster`, one of reference workers under a reference `Cluster`.
The reference's DCN query list (tests/test_dcn.py) runs through both and
the rows compare as `_same` does. Besides:

  * the restricted codec gives the same bytes in both packages for every
    allowed dtype, decimals, dates and nesting, and refuses a tensor;
  * `partial_rewrite` gives the same SQL in both packages;
  * the port's worker answers every `cmd` of the reference's committed
    wire model (tidb_tpu/analysis/wire_protocol.json), and the port sends
    no `cmd` outside it; a reference coordinator drives port workers;
  * a sampled query's trace grafts the workers' spans under the
    coordinator's rpc spans, with the reference's span names;
  * `python -m tidb_tpu_torch.parallel.dcn --device cpu` serves a query
    with a poisoned `jax` first on the path (it imports no JAX), and
    exits 1 without a card when it is not given `--device cpu`.

The helpers here (`fleets`, `same`, `seeded_rows`, the autouse
`feedback_stores_cleared`) serve the other test_torch_dcn_* / sharding /
chaos files too."""

import contextlib
import datetime
import decimal
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import tidb_tpu.parallel.dcn as jdcn
import tidb_tpu_torch.parallel.dcn as pdcn
from tidb_tpu_torch.errors import ExecutionError, UnsupportedError
from tidb_tpu_torch.session import Session
from test_torch_session import (  # noqa: F401
    _same, reference_witness_off, reference_witness_paused)

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def feedback_stores_cleared():
    """Both packages' process-wide plan-feedback and digest-latency
    stores empty before and after each DCN test: the workers' and the
    coordinators' sessions (and the shuffle planner) record into them,
    and later tests of the same process read them whole
    (test_torch_plan_feedback.py, test_torch_info_schema.py)."""
    from tidb_tpu.planner import feedback as jfb
    from tidb_tpu.serving import slo as jslo
    from tidb_tpu_torch.planner import feedback as pfb
    from tidb_tpu_torch.serving import slo as pslo

    stores = (jfb.STORE, pfb.STORE, jslo.STORE, pslo.STORE)
    for st in stores:
        st.clear()
    yield
    for st in stores:
        st.clear()


def same(got, want, ordered=True):
    """Rows equal as the session parity tests compare them."""
    _same(got, want, ordered)


def start_workers(mod, n, **kw):
    """n in-process workers of `mod` (the port's take device="cpu")."""
    if mod is pdcn:
        kw.setdefault("device", "cpu")
    ws = [mod.Worker(**kw) for _ in range(n)]
    for w in ws:
        threading.Thread(target=w.serve_forever, daemon=True).start()
    return ws


def make_cluster(mod, workers, **kw):
    if mod is pdcn:
        kw.setdefault("device", "cpu")
    return mod.Cluster([("127.0.0.1", w.port) for w in workers], **kw)


@contextlib.contextmanager
def fleets(n, **cluster_kw):
    """(port workers, port cluster, reference workers, reference
    cluster) of n workers each; both shut down after the block."""
    pw = start_workers(pdcn, n)
    jw = start_workers(jdcn, n)
    pc = make_cluster(pdcn, pw, **cluster_kw)
    jc = make_cluster(jdcn, jw, **cluster_kw)
    try:
        yield pw, pc, jw, jc
    finally:
        for cl in (pc, jc):
            try:
                cl.shutdown()
            except Exception:  # noqa: BLE001 — a test may have killed one
                pass


DDL = ("create table m (k bigint, grp varchar(8), v bigint, f double,"
       " p decimal(10,2), d date)")
GROUPS = ["aa", "bb", "cc", None]


def seeded_rows(lo, hi, seed):
    """The reference test's partition rows (tests/test_dcn.py::_rows)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(lo, hi):
        g = GROUPS[rng.integers(0, 4)]
        v = int(rng.integers(-50, 50)) if rng.random() > 0.1 else None
        f = float(rng.normal()) if rng.random() > 0.1 else None
        p = f"{rng.integers(0, 9999) / 100:.2f}"
        d = f"199{rng.integers(0, 9)}-0{rng.integers(1, 9)}-1{rng.integers(0, 9)}"
        out.append((i, g, v, f, p, d))
    return out


def values_sql(rows):
    return ", ".join(
        "(" + ", ".join(
            "null" if x is None else (f"'{x}'" if isinstance(x, str) else str(x))
            for x in r) + ")"
        for r in rows)


QUERIES = [
    ("select grp, count(*) as n, sum(v) as sv, avg(v) as av, min(f) as mf,"
     " max(f) as xf from m where k < 600 group by grp order by grp"),
    ("select count(*) as n, sum(p) as sp, avg(f) as af from m"),
    ("select sum(v) as rev from m where d >= '1995-01-01' and v > 0"),
    ("select grp, count(v) as cv, count(*) as ca from m group by grp order by grp"),
    ("select grp, sum(v * 2 + 1) as s2 from m where v is not null"
     " group by grp order by grp"),
    ("select grp, sum(v) as sv from m where grp is not null"
     " group by grp order by sv desc limit 2"),
    ("select k, v from m where v is not null order by v desc, k limit 5"),
    "select k from m where k < 5 order by k",
    ("select grp, min(p) as mp, max(d) as xd from m group by grp "
     "order by grp"),
]


@pytest.fixture(scope="module")
def row_range():
    """Both fleets with the reference test's row-range partitions, loaded
    through each worker's SQL surface, plus a single-node port oracle.
    Module-scoped, so it pauses the reference's lock-order witness
    itself (the autouse fixture covers each test, not this setup)."""
    with reference_witness_off(), fleets(2) as (pw, pc, jw, jc):
        for cl in (pc, jc):
            cl.broadcast_exec(DDL)
            cl._call(0, {"cmd": "exec", "sql":
                         f"insert into m values {values_sql(seeded_rows(0, 400, 1))}"})
            cl._call(1, {"cmd": "exec", "sql":
                         f"insert into m values {values_sql(seeded_rows(400, 700, 2))}"})
        oracle = Session(device="cpu")
        oracle.execute(DDL)
        oracle.execute("insert into m values "
                       + values_sql(seeded_rows(0, 400, 1)
                                    + seeded_rows(400, 700, 2)))
        yield pw, pc, jw, jc, oracle


@pytest.mark.parametrize("sql", QUERIES)
def test_queries_match_reference_fleet(row_range, sql):
    _pw, pc, _jw, jc, oracle = row_range
    got = pc.query(sql)
    want = jc.query(sql)
    assert want, "the reference fleet returned no rows"
    same(got, want)
    # and the fleet's merge equals one port session over all the rows
    single = oracle.query(sql)
    rows_norm = [tuple(round(x, 6) if isinstance(x, float) else x for x in r)
                 for r in got]
    assert rows_norm == [tuple(round(x, 6) if isinstance(x, float) else x
                               for x in r) for r in single]


def test_worker_error_is_typed_like_reference(row_range):
    _pw, pc, _jw, jc, _o = row_range
    with pytest.raises(ExecutionError) as pe:
        pc.query("select sum(nosuch) as s from m")
    import tidb_tpu.errors as jerr

    with pytest.raises(jerr.ExecutionError) as je:
        jc.query("select sum(nosuch) as s from m")
    assert type(pe.value).__name__ == type(je.value).__name__


def test_reference_coordinator_drives_port_workers(row_range):
    """Wire compatibility both ways of the split: a reference Cluster over
    the port's workers gives the reference fleet's rows."""
    pw, _pc, _jw, jc, _o = row_range
    cross = make_cluster(jdcn, pw)
    try:
        for sql in QUERIES[:4]:
            same(cross.query(sql), jc.query(sql))
    finally:
        cross.close()


# -- the codec -----------------------------------------------------------

_CODEC_MSGS = [
    {"cmd": "load_columns", "n": None, "t": True, "f": False,
     "i": 12345678901234567890, "neg": -7, "d": 3.5, "s": "héllo",
     "b": b"\x00\x01", "lst": [1, "x", None], "tup": (1, 2),
     "date": datetime.date(1995, 3, 1),
     "dt": datetime.datetime(2001, 2, 3, 4, 5, 6),
     "dec": decimal.Decimal("10.25"), "negdec": decimal.Decimal("-0.001"),
     "nested": {"a": [{"b": (np.int64(3), np.float64(2.5), np.bool_(True))}]}},
    {"arrays": {dt: np.arange(-3, 4).astype(dt) if dt not in ("bool",)
                else np.array([True, False, True])
                for dt in ("bool", "int8", "int16", "int32", "int64", "uint8",
                           "uint16", "uint32", "uint64", "float32", "float64")
                if not dt.startswith("uint")},
     "unsigned": [np.arange(5).astype(dt)
                  for dt in ("uint8", "uint16", "uint32", "uint64")],
     "matrix": np.arange(12, dtype=np.int32).reshape(3, 4),
     "empty": np.zeros(0, dtype=np.float64)},
    [("a", 1, 2.0), ["b", None, decimal.Decimal("1e-3")]],
]


@pytest.mark.parametrize("i", range(len(_CODEC_MSGS)))
def test_codec_bytes_equal_reference(i):
    msg = _CODEC_MSGS[i]
    b = pdcn._dumps(msg)
    assert b == jdcn._dumps(msg)
    back = pdcn._loads(b)
    ref = jdcn._loads(b)
    assert pdcn._dumps(back) == jdcn._dumps(ref) == b


def test_codec_refuses_tensors_and_objects():
    for bad in (torch.tensor([1, 2]), torch.tensor(3), {"x": torch.zeros(2)},
                np.array([object()], dtype=object), object()):
        with pytest.raises(pdcn.DcnCodecError):
            pdcn._dumps(bad)
    with pytest.raises(ExecutionError):
        pdcn._loads(b"Z")
    with pytest.raises(ExecutionError):
        pdcn._loads(pdcn._dumps([1, 2]) + b"N")


# -- the rewrites ----------------------------------------------------------

_REWRITES = [
    ("select grp, avg(v) as a, count(*) as c from m where v > 0 "
     "group by grp order by grp", {}),
    ("select k, v from m where v > 0 order by v desc limit 3 offset 1", {}),
    ("select count(*) as n, sum(p) as sp from m", {"table_as": "m__part1"}),
    ("select d_year, count(*) as n, sum(lo_quantity) as q from lineorder "
     "join ssb_date on lo_orderdate = d_datekey where d_year >= 1994 "
     "group by d_year",
     {"partitioned": {"lineorder"}, "broadcast": {"ssb_date"}}),
    ("select count(*) as n, sum(f.v) as sv from f join d on f.k = d.k",
     {"co_partitioned": frozenset({"f", "d"}),
      "renames": {"d": "__shuffle_sh1_d"}, "partitioned": {"f", "d"}}),
    ("select l_returnflag, sum(l_extendedprice * (1 - l_discount)) as r, "
     "min(l_shipdate) as m, max(l_tax) as t from lineitem where l_shipdate "
     "<= date '1998-09-02' group by l_returnflag order by l_returnflag", {}),
]


@pytest.mark.parametrize("i", range(len(_REWRITES)))
def test_partial_rewrite_equals_reference(i):
    sql, kw = _REWRITES[i]
    assert pdcn.partial_rewrite(sql, **kw) == jdcn.partial_rewrite(sql, **kw)


@pytest.mark.parametrize("sql", [
    "select a.v from m a join m b on a.k = b.k",
    "select count(distinct grp) from m",
    "select sum(v) + 1 as s from m",
    "select grp, group_concat(v) from m group by grp",
    "select k from m limit 3",
])
def test_unsupported_shapes_refused_like_reference(sql):
    import tidb_tpu.errors as jerr

    with pytest.raises(jerr.UnsupportedError) as je:
        jdcn.partial_rewrite(sql)
    with pytest.raises(UnsupportedError) as pe:
        pdcn.partial_rewrite(sql)
    assert str(pe.value) == str(je.value)


def test_tpch_q18_refused_typed_like_reference():
    """TPC-H Q18 over co-partitioned lineitem and orders and a broadcast
    customer (chip_smoke's DCN layout): both packages refuse it with the
    same typed error (its IN subquery has no partial form)."""
    import tidb_tpu.errors as jerr
    from tidb_tpu_torch.storage.tpch_queries import Q

    kw = dict(partitioned={"lineitem", "orders"}, broadcast={"customer"},
              co_partitioned=frozenset({"lineitem", "orders"}))
    with pytest.raises(jerr.UnsupportedError) as je:
        jdcn.partial_rewrite(Q["q18"][0], **kw)
    with pytest.raises(UnsupportedError) as pe:
        pdcn.partial_rewrite(Q["q18"][0], **kw)
    assert str(pe.value) == str(je.value)


# -- the wire model ----------------------------------------------------------

def _wire_model():
    with open(os.path.join(_REPO, "tidb_tpu", "analysis",
                           "wire_protocol.json")) as f:
        return json.load(f)


def test_port_worker_answers_every_modeled_cmd():
    """Each cmd of the reference's committed model reaches its own arm of
    the port's Worker._handle: none falls through to 'unknown dcn
    command' (a bad message may still fail inside its handler)."""
    cmds = sorted(_wire_model()["cmds"])
    assert cmds
    w = pdcn.Worker(device="cpu")
    try:
        for cmd in cmds:
            if cmd == "shutdown":
                assert w._handle({"cmd": cmd}) == "bye"
                continue
            try:
                w._handle({"cmd": cmd})
            except ExecutionError as e:
                assert "unknown dcn command" not in str(e), cmd
            except Exception:  # noqa: BLE001 — a missing field, not a miss
                pass
        with pytest.raises(ExecutionError, match="unknown dcn command"):
            w._handle({"cmd": "no_such_cmd"})
    finally:
        w._sock.close()


def test_port_sends_no_cmd_outside_the_model():
    src = open(pdcn.__file__).read()
    sent = set(re.findall(r'"cmd":\s*"([a-z_0-9]+)"', src))
    sent |= set(re.findall(r'msg\["cmd"\]\s*=\s*"([a-z_0-9]+)"', src))
    model = set(_wire_model()["cmds"])
    assert sent, "no send sites found"
    assert sent <= model, sorted(sent - model)
    # the reference's own send sites name the same set
    ref = set(re.findall(r'"cmd":\s*"([a-z_0-9]+)"', open(jdcn.__file__).read()))
    ref |= set(re.findall(r'msg\["cmd"\]\s*=\s*"([a-z_0-9]+)"',
                          open(jdcn.__file__).read()))
    assert sent == ref


# -- the worker process --------------------------------------------------------

def _spawn_worker(extra_env, args):
    # one torch thread: the other test workers of the run share the cores
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.update(extra_env)
    return subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch.parallel.dcn", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=_REPO)


def test_worker_subprocess_imports_no_jax(tmp_path):
    """A `jax` package that raises on import sits first on PYTHONPATH:
    the worker must still start and serve a query."""
    poison = tmp_path / "poison" / "jax"
    poison.mkdir(parents=True)
    (poison / "__init__.py").write_text(
        "raise ImportError('the DCN worker must not import jax')\n")
    p = _spawn_worker({"PYTHONPATH": os.pathsep.join(
        [str(poison.parent), _REPO, os.environ.get("PYTHONPATH", "")])},
        ["--device", "cpu"])
    try:
        line = p.stdout.readline()
        m = re.search(r"DCN_WORKER_PORT=(\d+)", line)
        assert m, (line, p.stderr.read() if p.poll() is not None else "")
        cl = pdcn.Cluster([("127.0.0.1", int(m.group(1)))], device="cpu")
        try:
            cl.broadcast_exec("create table t (k bigint, v decimal(8,2))")
            cl._call(0, {"cmd": "exec", "sql":
                         "insert into t values (1, 2.50), (2, 3.25), (3, null)"})
            cl.mark_partitioned("t")
            assert cl.query("select count(*) as n, sum(v) as s from t") == [
                (3, "5.75")]
        finally:
            cl.shutdown()
        assert p.wait(timeout=30) == 0
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()


def test_worker_without_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _spawn_worker({}, [])
    out, err = p.communicate(timeout=120)
    assert p.returncode == 1
    assert "DCN_WORKER_PORT" not in out
    assert "no CUDA device" in err


def test_worker_and_cluster_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(ExecutionError, match="no CUDA device"):
        pdcn.Worker()


# -- auth, failover, paging (the reference's own cases, on port workers) -------

def test_secret_handshake_and_downgrade_refusal():
    w = start_workers(pdcn, 1, secret="sesame")[0]
    plain = start_workers(pdcn, 1)[0]
    try:
        cl = make_cluster(pdcn, [w], secret="sesame")
        assert cl._call(0, {"cmd": "ping"}) == "pong"
        cl.close()
        with pytest.raises(ExecutionError):
            make_cluster(pdcn, [w])
        with pytest.raises((ConnectionError, OSError, ExecutionError)):
            make_cluster(pdcn, [w], secret="wrong")._call(0, {"cmd": "ping"})
        with pytest.raises(ExecutionError):
            make_cluster(pdcn, [plain], secret="sesame")
        with pytest.raises(ExecutionError):
            pdcn.Worker(host="0.0.0.0", device="cpu")
    finally:
        make_cluster(pdcn, [w], secret="sesame").shutdown()
        make_cluster(pdcn, [plain]).shutdown()


def _load_big(cl, n_rows=2000):
    cl.broadcast_exec("create table big (k bigint, v bigint)")
    half = n_rows // 2
    for w, (lo, hi) in enumerate(((0, half), (half, n_rows))):
        cl.load_partition(w, "big", arrays={
            "k": np.arange(lo, hi, dtype=np.int64),
            "v": np.arange(lo, hi, dtype=np.int64)}, db="test")


def test_paged_drain_failover_and_no_leaked_cursors():
    """Partials bigger than a page drain through worker cursors; a primary
    that dies mid-drain fails over to its replica's mirror with no row
    twice; both fleets give the same rows."""
    sql = "select k, count(*) as n, sum(v) as s from big group by k order by k"
    with fleets(2, replicas={0: 1, 1: 0}) as (pw, pc, jw, jc):
        for cl in (pc, jc):
            _load_big(cl)
            cl.PAGE_ROWS = 64
        got = pc.query(sql)
        same(got, jc.query(sql))
        assert len(got) == 2000 and all(not w._cursors for w in pw)
        orig = pc._call
        state = {"killed": False}

        def flaky(i, msg):
            if msg.get("cmd") == "fetch" and i == 0 and not state["killed"]:
                state["killed"] = True
                pw[0]._running = False
                pw[0]._sock.close()
                pc._socks[0].close()
                raise ConnectionError("worker 0 died mid-drain")
            return orig(i, msg)

        pc._call = flaky
        try:
            got = pc.query(sql)
        finally:
            pc._call = orig
        assert state["killed"]
        assert sum(r[1] for r in got) == 2000
        assert sum(r[2] for r in got) == sum(range(2000))


def test_staging_types_from_all_partitions():
    with fleets(2) as (_pw, pc, _jw, jc):
        for cl in (pc, jc):
            cl.broadcast_exec("create table sn (k bigint, s varchar(8))")
            cl.load_partition(0, "sn", arrays={"k": np.zeros(3, dtype=np.int64)},
                              strings={"s": [None, None, None]}, db="test")
            cl.load_partition(1, "sn", arrays={"k": np.ones(3, dtype=np.int64)},
                              strings={"s": ["aa", "bb", None]}, db="test")
        sql = "select k, min(s) as ms, count(s) as c from sn group by k order by k"
        assert pc.query(sql) == jc.query(sql) == [(0, None, 0), (1, "aa", 2)]


def test_circuit_breaker_math_equals_reference():
    assert (pdcn.Cluster.RECONNECT_BASE_S, pdcn.Cluster.RECONNECT_CAP_S,
            pdcn.Cluster.RECONNECT_MAX_DOUBLINGS, pdcn.Cluster.JITTER_FRAC,
            pdcn.Cluster.GATE_WAIT_S, pdcn.Cluster.PAGE_ROWS) == (
        jdcn.Cluster.RECONNECT_BASE_S, jdcn.Cluster.RECONNECT_CAP_S,
        jdcn.Cluster.RECONNECT_MAX_DOUBLINGS, jdcn.Cluster.JITTER_FRAC,
        jdcn.Cluster.GATE_WAIT_S, jdcn.Cluster.PAGE_ROWS)
    w = start_workers(pdcn, 1)[0]
    cl = make_cluster(pdcn, [w])
    try:
        h = cl._health[0]
        with cl._sock_locks[0]:
            cl._note_failure_locked(0, RuntimeError("blip"))
            assert (h.state, h.next_retry, h.attempts) == (pdcn.SUSPECT, 0.0, 0)
            cl._note_failure_locked(0, RuntimeError("again"))
            assert (h.state, h.attempts) == (pdcn.DOWN, 1)
            with pytest.raises(ConnectionError, match="circuit open"):
                cl._reconnect_locked(0)
            h.next_retry = 0.0
            assert cl._reconnect_locked(0) is cl._socks[0]
            cl._note_ok_locked(0)
            assert h.state == pdcn.UP
        assert cl._call(0, {"cmd": "ping"}) == "pong"
    finally:
        cl.shutdown()


def test_coordinator_restart_reattaches():
    with fleets(2, replicas={0: 1, 1: 0}) as (pw, pc, _jw, _jc):
        _load_big(pc)
        want = [(2000, sum(range(2000)))]
        sql = "select count(*) as n, sum(v) as s from big"
        assert pc.query(sql) == want
        pc.close()
        cl2 = make_cluster(pdcn, pw, replicas={0: 1, 1: 0})
        cl2.mark_partitioned("big")
        try:
            assert cl2.query(sql) == want
        finally:
            cl2.shutdown()


def test_info_schema_and_status_read_live_clusters():
    """dcn_worker_stats, cluster_info and cluster_metrics read the live
    clusters of the process, as the reference's do."""
    from tidb_tpu_torch.server.status import StatusServer

    with fleets(2) as (pw, pc, _jw, _jc):
        _load_big(pc, 200)
        pc.query("select count(*) as n from big")
        s = Session(device="cpu")
        rows = s.query("select worker, endpoint, state, executed from "
                       "information_schema.dcn_worker_stats")
        mine = [r for r in rows
                if r[1] in {f"127.0.0.1:{w.port}" for w in pw}]
        assert sorted(r[0] for r in mine) == [0, 1]
        assert all(r[2] == "up" and r[3] >= 1 for r in mine)
        info = s.query("select table_name, workers from "
                       "information_schema.cluster_info")
        assert ("__fleet__", 2) in info
        metrics = s.query("select distinct worker from "
                          "information_schema.cluster_metrics")
        names = {r[0] for r in metrics}
        assert {f"127.0.0.1:{w.port}" for w in pw} <= names
        assert "fleet" in names
        import urllib.request

        st = StatusServer(s.catalog, port=0)
        st.start()
        try:
            base = f"http://127.0.0.1:{st.port}"
            body = json.loads(urllib.request.urlopen(base + "/cluster").read())
            eps = {w["endpoint"] for c in body["clusters"] for w in c["workers"]}
            assert {f"127.0.0.1:{w.port}" for w in pw} <= eps
            text = urllib.request.urlopen(
                base + "/metrics?scope=cluster").read().decode()
            assert f'worker="127.0.0.1:{pw[0].port}"' in text
            assert "tidb_tpu_dcn_bytes_total" in text
        finally:
            st.stop()


def test_traced_query_assembles_worker_spans_like_reference(row_range):
    """A sampled Cluster.query keeps one trace whose workers' spans were
    shipped back and grafted under the coordinator's rpc spans (proc =
    the worker's endpoint); the coordinator and worker span names equal
    the reference's."""
    import tidb_tpu.utils.tracing as jtr
    import tidb_tpu_torch.utils.tracing as ptr
    from tidb_tpu.session import Session as JaxSession

    _pw, pc, _jw, jc, _o = row_range
    sql = QUERIES[0]
    names = []
    for cl, sess, tr in ((pc, Session(device="cpu"), ptr), (jc, JaxSession(), jtr)):
        sess.execute("set tidb_trace_sample_rate = 1")
        cl.query(sql, session=sess)
        kept = [t for t in tr.STORE.traces()
                if t.spans and t.spans[0].name == "dcn.query"]
        assert kept
        spans = kept[-1].spans
        remote = [s for s in spans if s.proc]
        assert {s.proc for s in remote} == {f"{h}:{p}" for h, p in cl._endpoints}
        names.append(sorted(s.name for s in spans
                            if s.name.startswith(("dcn.", "worker."))))
    assert names[0] == names[1]

