"""IndexJoinExec: the index-lookup join the cascades memo plans, through
the port against the reference.

Mirrors tests/test_index_join.py. The same data goes into a reference
session and a port session (tidb_enable_cascades_planner = 1 in both);
EXPLAIN must choose IndexJoin where the reference does, and the rows must
be the reference's and the hash planner's, NULL keys, composite-key
prefixes and a transaction's snapshot included."""

import numpy as np
import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu_torch.session import Session

from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)


def _pair(setup, **kw):
    js = JaxSession(**kw)
    js.execute("set tidb_tpu_compaction = 0")
    ps = Session(device="cpu", **kw)
    for s in (js, ps):
        s.execute("set tidb_enable_cascades_planner = 1")
        for step in setup:
            if isinstance(step, tuple):  # (table, {column: array}) in bulk
                s.catalog.table("test", step[0]).insert_columns(dict(step[1]))
            else:
                s.execute(step)
    return js, ps


def _explain(s, sql):
    return [r[0] for r in s.query("explain " + sql)]


def _big_setup():
    rng = np.random.default_rng(17)
    setup = ["create table h (hk bigint primary key, hw bigint)",
             "create table a (ak bigint, aw bigint)",
             "create table f (fa bigint, fh bigint, v bigint)"]
    hk = np.arange(40000, dtype=np.int64)
    setup.append(("h", {"hk": hk, "hw": hk % 97}))
    setup.append("insert into a values " + ",".join(
        f"({i % 50}, {i})" for i in range(150)))
    fi = np.arange(8000, dtype=np.int64)
    setup.append(("f", {"fa": rng.integers(0, 50, 8000).astype(np.int64),
                        "fh": rng.integers(0, 40000, 8000).astype(np.int64),
                        "v": fi % 1000}))
    setup += [f"analyze table {t}" for t in ("h", "a", "f")]
    return setup


@pytest.fixture(scope="module")
def pair():
    return _pair(_big_setup())


Q = ("select count(*) as n, sum(v + aw + hw) as s from f "
     "join a on fa = ak join h on fh = hk where v < 30")


def test_memo_chooses_index_join_as_reference(pair):
    js, ps = pair
    rows = _explain(ps, Q)
    assert any("IndexJoin" in r and "index:PRIMARY" in r for r in rows), rows
    assert rows == _explain(js, Q)


def test_index_join_results_match_reference_and_hash_planner(pair):
    js, ps = pair
    got = ps.query(Q)
    assert got == js.query(Q)
    ps.execute("set tidb_enable_cascades_planner = 0")
    try:
        assert not any("IndexJoin" in r for r in _explain(ps, Q))
        assert ps.query(Q) == got
    finally:
        ps.execute("set tidb_enable_cascades_planner = 1")


def test_big_outer_stays_hash(pair):
    js, ps = pair
    q = "select count(*) as n from f join h on fh = hk"
    rows = _explain(ps, q)
    assert not any("IndexJoin" in r for r in rows), rows
    assert rows == _explain(js, q)
    assert ps.query(q) == js.query(q)


def test_index_join_columns_and_residual_filter(pair):
    """Output columns from both sides, a residual condition on the inner
    side and an ORDER BY above the join."""
    js, ps = pair
    q = ("select fa, fh, v, aw, hw from f join a on fa = ak "
         "join h on fh = hk where v < 30 and hw > 40 order by v, fh, aw")
    assert any("IndexJoin" in r for r in _explain(ps, q))
    got = ps.query(q)
    assert got and got == js.query(q)


def test_nulls_and_txn_snapshot():
    js, ps = _pair([
        "create table hh (k bigint primary key, w bigint)",
        "insert into hh values " + ",".join(f"({i}, {i})" for i in range(5000)),
        "create table aa (x bigint, y bigint)",
        "insert into aa values (1, 1), (2, 2), (3, 3)",
        "create table ff (fk bigint, fx bigint)",
        "insert into ff values (10, 1), (NULL, 2), (20, 3), (99999, 1)",
        "analyze table hh", "analyze table aa", "analyze table ff"])
    q = ("select fk, y, w from ff join aa on fx = x join hh on fk = k "
         "order by fk")
    for s in (js, ps):
        assert any("IndexJoin" in r for r in _explain(s, q))
        # a NULL key and a missing key (99999) are dropped (inner join)
        assert s.query(q) == [(10, 1, 10), (20, 3, 20)]
        # the transaction's snapshot: its delete is visible inside it and
        # undone by the rollback
        s.execute("begin")
        s.execute("delete from hh where k = 10")
        assert s.query(q) == [(20, 3, 20)]
        s.execute("rollback")
        assert s.query(q) == [(10, 1, 10), (20, 3, 20)]


def test_composite_index_prefix_probe():
    """Join key = prefix of a composite index (the TPC-H lineitem key
    shape): the probe spans the whole equal-prefix run."""
    js, ps = _pair([
        "create table li (ok bigint, ln bigint, q bigint, primary key (ok, ln))",
        ("li", {"ok": np.arange(20000, dtype=np.int64) // 4,
                "ln": np.arange(20000, dtype=np.int64) % 4,
                "q": np.arange(20000, dtype=np.int64)}),
        "create table od (ok bigint, d bigint)",
        "insert into od values " + ",".join(
            f"({i}, {i % 9})" for i in range(0, 5000, 10)),
        "create table cu (d bigint, nm bigint)",
        "insert into cu values " + ",".join(f"({i}, {i * 2})" for i in range(9)),
        "analyze table li", "analyze table od", "analyze table cu"])
    q = ("select count(*) as n, sum(q) as sq from od join cu on od.d = cu.d "
         "join li on od.ok = li.ok where nm < 8")
    rows = _explain(ps, q)
    assert any("IndexJoin" in r and "table:li" in r for r in rows), rows
    assert rows == _explain(js, q)
    oks = [i for i in range(0, 5000, 10) if (i % 9) < 4]
    want = [(4 * len(oks), sum(4 * ok * 4 + 6 for ok in oks))]
    assert ps.query(q) == js.query(q) == want


def test_explain_plan_changes_without_index():
    """Same data and query: the available index path changes the plan
    (IndexJoin against a hash tree), in both packages alike."""
    def build(with_index):
        pk = " primary key" if with_index else ""
        setup = [f"create table h (hk bigint{pk}, hw bigint)",
                 "create table a (ak bigint, aw bigint)",
                 "create table f (fa bigint, fh bigint, v bigint)"]
        hk = np.arange(30000, dtype=np.int64)
        setup.append(("h", {"hk": hk, "hw": hk % 7}))
        setup.append("insert into a values " + ",".join(
            f"({i % 40}, {i})" for i in range(120)))
        fi = np.arange(6000, dtype=np.int64)
        setup.append(("f", {"fa": fi % 40, "fh": (fi * 37) % 30000,
                            "v": fi % 500}))
        setup += [f"analyze table {t}" for t in ("h", "a", "f")]
        return _pair(setup)

    q = ("select count(*) as n from f join a on fa = ak "
         "join h on fh = hk where v < 25")
    (jw, pw), (jn, pn) = build(True), build(False)
    with_idx, without = _explain(pw, q), _explain(pn, q)
    assert any("IndexJoin" in r for r in with_idx), with_idx
    assert not any("IndexJoin" in r for r in without), without
    assert with_idx == _explain(jw, q) and without == _explain(jn, q)
    assert pw.query(q) == pn.query(q) == jw.query(q)
