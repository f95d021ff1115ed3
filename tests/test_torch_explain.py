"""EXPLAIN and EXPLAIN ANALYZE through the port (tidb_tpu_torch on the CPU)
against the JAX package.

TPC-H SF0.01 (the reference's generator, seed 7) exported into the port.
The reference Session runs its device engine (`tidb_device_engine_mode =
'force'`): the port has one engine, torch on the session's device, whose
counterpart that is (ROADMAP, known divergences: engine routing); under
'auto' the reference takes its host engine on the CPU and its fused
operators render `[classic]`.

- The reference plans with the port's key-domain join estimate
  (test_torch_scale.reference_key_domain; ROADMAP, known divergences).
- EXPLAIN: the text of all 22 queries equal, line for line.
- EXPLAIN ANALYZE: the operator column (tree and names, `[classic]`
  marks included), `estRows` and `actRows` equal to the reference's on the
  same plan, and the root's `actRows` equal to the query's row count. The
  time, start and execution-info columns are checked for shape only (wall
  times differ run to run); on the CPU no kernel launches, so every
  operator shows `dispatches:0` and the profile line `xfer_bytes=0`.
- The session-feature cases of tests/test_session_features.py: a plain
  EXPLAIN, EXPLAIN ANALYZE row counts, DESCRIBE and SHOW INDEX / KEYS.
"""

import re

import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.tpch import load_tpch as jax_load_tpch
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.tpch_queries import Q

from test_torch_keys import both, new_pair
from test_torch_scale import reference_key_domain
from test_torch_session import _export_into, reference_witness_paused  # noqa: F401

TABLES = ("nation", "region", "part", "supplier", "partsupp", "customer",
          "orders", "lineitem")
_PROFILE = re.compile(r"^profile: mem_max=\d+ xfer_bytes=0 compile_ms=0\.0 "
                      r"spill_bytes=0 compaction_wait_ms=\d+\.\d$")


@pytest.fixture(scope="module", autouse=True)
def reference_under_key_domain():
    """The reference plans with the port's key-domain join estimate (ROADMAP,
    known divergences): the plans are held to the rule, not to the
    reference's fallback."""
    with reference_key_domain():
        yield


@pytest.fixture(scope="module")
def pair():
    js = JaxSession()
    js.execute("set tidb_tpu_compaction = 0")
    js.execute("set tidb_device_engine_mode = 'force'")
    jax_load_tpch(js.catalog, sf=0.01)
    ps = Session(device="cpu")
    ps.execute("set tidb_tpu_compaction = 0")
    for name in TABLES:
        _export_into(ps, js.catalog.table("test", name), name)
    return js, ps


def _columns(rows):
    """(id, estRows, actRows) per operator line, the other columns, and
    the profile line of an EXPLAIN ANALYZE result."""
    head = rows[0][0]
    cut = [head.index(h) for h in ("estRows", "actRows", "drift", "time",
                                   "start", "staged", "execution info")]
    ops, rest = [], []
    for (line,) in rows[1:-1]:
        f = [line[:cut[0]]] + [line[a:b] for a, b in zip(cut, cut[1:])] + [line[cut[-1]:]]
        ops.append((f[0].rstrip(), f[1].strip(), f[2].strip()))
        rest.append([x.strip() for x in f[3:]])
    return ops, rest, rows[-1][0]


@pytest.mark.parametrize("q", list(Q))
def test_explain_matches_reference(pair, q):
    js, ps = pair
    sql = "explain " + Q[q][0]
    want, got = js.query(sql), ps.query(sql)
    assert got == want


@pytest.mark.parametrize("q", list(Q))
def test_explain_analyze_matches_reference(pair, q):
    js, ps = pair
    sql = Q[q][0]
    want_ops, _, _ = _columns(js.query("explain analyze " + sql))
    got = ps.query("explain analyze " + sql)
    ops, rest, profile = _columns(got)
    assert ops == want_ops
    assert int(ops[0][2]) == len(ps.query(sql))
    for drift, time_, start, staged, info in rest:
        assert re.fullmatch(r"-|\d+\.\d\d", drift)
        assert re.fullmatch(r"\d+\.\dms", time_)
        assert re.fullmatch(r"·*\| \+\d+us|\|", start)
        assert re.fullmatch(r"-|\d+", staged)
        assert re.match(r"open:\d+\.\dms own:\d+\.\dms loops:\d+ dispatches:0\b", info)
    assert _PROFILE.match(profile), profile


# -- the session-feature cases ------------------------------------------------

@pytest.fixture
def small():
    js, ps = new_pair()
    for sql in ("create table t (a bigint, b varchar(10))",
                "insert into t values (1,'x'), (2,'y'), (3,'x'), (null,'z')"):
        both(js, ps, sql)
    return js, ps


def test_plain_explain(small):
    js, ps = small
    rows = ps.query("explain select a from t where a > 1")
    assert rows == js.query("explain select a from t where a > 1")
    text = "\n".join(r[0] for r in rows)
    assert "TableFullScan" in text and "estRows" in text


def test_analyze_runs_and_reports(small):
    js, ps = small
    sql = "explain analyze select b, count(*) from t group by b order by b"
    rows = ps.query(sql)
    text = "\n".join(r[0] for r in rows)
    assert "actRows" in text and "loops:" in text and "dispatches:" in text
    assert _columns(rows)[0] == _columns(js.query(sql))[0]


def test_analyze_rowcounts(small):
    js, ps = small
    rows = ps.query("explain analyze select a from t where a > 1")
    scan_line = next(r[0] for r in rows if "TableScan" in r[0])
    # 2 rows pass the fused filter (NULL excluded)
    assert " 2 " in scan_line
    assert _columns(rows)[0] == _columns(
        js.query("explain analyze select a from t where a > 1"))[0]


def test_explain_refuses_non_select(small):
    js, ps = small
    assert both(js, ps, "explain insert into t values (5, 'q')") == "UnsupportedError"


def test_describe_and_show_index(small):
    js, ps = small
    assert ps.execute("describe t").rows == ps.execute("show columns from t").rows
    assert ps.execute("desc t").rows == js.execute("desc t").rows
    for sql in ("create table si (x bigint primary key, y bigint)",
                "create index iy on si (y)"):
        both(js, ps, sql)
    rows = ps.execute("show index from si").rows
    assert rows == js.execute("show index from si").rows
    assert ("si", 0, "PRIMARY", 1, "x") in rows
    assert ("si", 1, "iy", 1, "y") in rows
    assert ps.execute("show keys from si").rows == rows
