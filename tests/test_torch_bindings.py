"""SQL plan bindings (CREATE / DROP [SESSION | GLOBAL] BINDING) and the
optimizer hints they carry (LEADING, MEMORY_QUOTA), through the port
against the reference.

Mirrors the binding and hint cases of tests/test_bindinfo.py. Every
statement runs on a reference session and a port session built by the
same SQL; plans compare as EXPLAIN text and rows exactly, and errors by
class and message."""

import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu_torch.errors import ExecutionError, PlanError
from tidb_tpu_torch.session import Session

from test_torch_keys import both
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

_SETUP = [
    "create table big (id bigint primary key, k bigint, v bigint)",
    "create table small (k bigint primary key, tag bigint)",
    "insert into big values " + ", ".join(
        f"({i}, {i % 10}, {i * 2})" for i in range(200)),
    "insert into small values " + ", ".join(f"({i}, {i})" for i in range(10)),
]


@pytest.fixture(scope="module")
def pair():
    js = JaxSession(chunk_capacity=256)
    js.execute("set tidb_tpu_compaction = 0")
    ps = Session(device="cpu", chunk_capacity=256)
    for s in (js, ps):
        for sql in _SETUP:
            s.execute(sql)
    return js, ps


def explain(s, sql):
    return [r[0] for r in s.query(f"explain {sql}")]


def plan_shape(s, sql):
    """Operator tree shape only (drops estimates and conditions, which keep
    the user's literals under a binding)."""
    return [r[0].split()[0] for r in s.query(f"explain {sql}")]


def test_leading_forces_order(pair):
    js, ps = pair
    sql = "select count(*) from big join small on big.k = small.k"
    forced = "select /*+ LEADING(big, small) */ count(*) from big join small on big.k = small.k"
    other = "select /*+ LEADING(small, big) */ count(*) from big join small on big.k = small.k"
    for q in (sql, forced, other):
        assert explain(ps, q) == explain(js, q), q
        assert ps.query(q) == js.query(q) == [(200,)]
    assert explain(ps, forced) != explain(ps, other)


def test_create_match_drop_session_binding(pair):
    js, ps = pair
    sql = "select count(*) from big join small on big.k = small.k where big.v > 10"
    hinted = ("select /*+ LEADING(small, big) */ count(*) from big join small"
              " on big.k = small.k where big.v > 10")
    plain_plan = explain(ps, sql)
    for s in (js, ps):
        s.execute(f"create session binding for {sql} using {hinted}")
    assert ps.query("show bindings") == js.query("show bindings")
    rows = ps.query("show bindings")
    assert len(rows) == 1 and rows[0][2] == "session"
    # the binding's hints are injected: the plan shape matches the hinted
    # statement for any literal values (normalized match)
    want_shape = plan_shape(ps, hinted)
    assert plan_shape(ps, sql) == want_shape
    assert plan_shape(ps, sql.replace("> 10", "> 77")) == want_shape
    assert explain(ps, sql) == explain(js, sql)
    # the user's own literals stay: only the hints transfer
    n10 = ps.query(sql)
    n300 = ps.query(sql.replace("> 10", "> 300"))
    assert n10 != n300
    assert (n10, n300) == (js.query(sql), js.query(sql.replace("> 10", "> 300")))
    for s in (js, ps):
        s.execute(f"drop session binding for {sql}")
    assert ps.query("show bindings") == js.query("show bindings") == []
    assert ps.query(sql) == n10
    assert explain(ps, sql) == plain_plan


def test_global_binding_changes_the_plan_and_not_the_rows(pair):
    """A GLOBAL binding with a LEADING hint that changes the join order:
    every session of the catalog plans the hinted order, the rows stay,
    and DROP restores the previous plan."""
    js, ps = pair
    sql = "select big.id, small.tag from big join small on big.k = small.k where big.v < 30"
    before, rows_before = explain(ps, sql), ps.query(sql)
    order = "small, big" if before == explain(
        ps, sql.replace("select", "select /*+ LEADING(big, small) */", 1)) \
        else "big, small"
    hinted = sql.replace("select", f"select /*+ LEADING({order}) */", 1)
    for s in (js, ps):
        s.execute(f"create global binding for {sql} using {hinted}")
    try:
        ps2 = Session(catalog=ps.catalog, device="cpu")
        js2 = JaxSession(catalog=js.catalog)
        bound = explain(ps2, sql)
        assert bound != before
        assert bound == explain(ps2, hinted) == explain(js2, sql)
        key = sorted
        assert key(ps2.query(sql)) == key(rows_before) == key(js2.query(sql))
        assert len(ps2.query("show bindings")) == 1
    finally:
        for s in (js, ps):
            s.execute(f"drop global binding for {sql}")
    assert ps2.query("show bindings") == []
    assert explain(ps, sql) == before


def test_mismatched_binding_rejected(pair):
    js, ps = pair
    sql = "create binding for select count(*) from small using select sum(tag) from small"
    assert both(js, ps, sql) == "PlanError"
    with pytest.raises(PlanError):
        ps.execute(sql)


def test_drop_missing_errors(pair):
    js, ps = pair
    sql = "drop binding for select id from big"
    assert both(js, ps, sql) == "ExecutionError"
    with pytest.raises(ExecutionError):
        ps.execute(sql)


def test_memory_quota_hint_enforced(pair):
    js, ps = pair
    sql = ("select /*+ MEMORY_QUOTA(1024) */ big.v from big"
           " join small on big.k = small.k order by big.v")
    for s in (js, ps):
        s.execute("set tidb_enable_tmp_storage_on_oom = 0")
    try:
        # the consumed bytes in the message differ (each package's build
        # holds its own arrays); the class is the outcome
        errs = []
        for s in (js, ps):
            with pytest.raises(Exception) as ei:
                s.query(sql)
            errs.append(type(ei.value).__name__)
        assert errs == ["QueryOOMError", "QueryOOMError"]
    finally:
        for s in (js, ps):
            s.execute("set tidb_enable_tmp_storage_on_oom = 1")


def test_memory_quota_units(pair):
    js, ps = pair
    for q in ("select /*+ MEMORY_QUOTA(64 MB) */ count(*) from small",
              "select /*+ MEMORY_QUOTA(lots) */ count(*) from small"):
        assert ps.query(q) == js.query(q) == [(10,)]


def test_global_binding_with_memory_quota(pair):
    js, ps = pair
    sql = "select count(*) from small where tag > 3"
    for s in (js, ps):
        s.execute(f"create global binding for {sql} using "
                  f"select /*+ MEMORY_QUOTA(1073741824) */ count(*)"
                  f" from small where tag > 3")
    try:
        s2 = Session(catalog=ps.catalog, device="cpu")
        seen = []
        orig = s2._exec_ctx

        def spy(**kw):
            ctx = orig(**kw)
            seen.append(ctx.mem_tracker.budget)
            return ctx

        s2._exec_ctx = spy
        assert s2.query(sql) == ps.query(sql) == js.query(sql) == [(6,)]
        assert seen == [1 << 30]  # the bound hint set the budget
    finally:
        for s in (js, ps):
            s.execute(f"drop global binding for {sql}")


def test_hints_elsewhere_are_comments(pair):
    js, ps = pair
    for sql in ("create table hr (x bigint)",
                "insert /*+ MEMORY_QUOTA(1) */ into hr values (1)",
                "update /*+ x() */ hr set x = 2"):
        assert both(js, ps, sql) is None
    q = "select x from hr /*+ trailing */"
    assert ps.query(q) == js.query(q) == [(2,)]
    for sql in ("delete /*+ h() */ from hr", "drop table hr"):
        assert both(js, ps, sql) is None


def test_leading_typo_and_derived_block(pair):
    js, ps = pair
    typo = ("select /*+ LEADING(nope, nada) */ count(*) "
            "from big join small on big.k = small.k")
    plain = "select count(*) from big join small on big.k = small.k"
    assert explain(ps, typo) == explain(ps, plain) == explain(js, typo)
    inner = "(select big.v from big join small on big.k = small.k) d"
    hinted = f"select /*+ LEADING(small, big) */ count(*) from {inner}"
    assert explain(ps, hinted) == explain(ps, f"select count(*) from {inner}")
    assert explain(ps, hinted) == explain(js, hinted)
    dup = "select /*+ LEADING(big, big, small) */ count(*) from big join small on big.k = small.k"
    assert ps.query(dup) == js.query(dup) == ps.query(plain)


def test_prepared_stmt_unaffected_after_drop(pair):
    js, ps = pair
    sql = "select count(*) from big where v > 5"
    out = []
    for s in (js, ps):
        stmt_id, _ = s.prepare(sql)
        s.execute(f"create binding for {sql} using "
                  f"select /*+ MEMORY_QUOTA(512 MB) */ count(*) from big where v > 5")
        r1 = s.execute_prepared(stmt_id, []).rows
        s.execute(f"drop binding for {sql}")
        # the cached prepared AST must not keep the dropped binding's hints
        ast = s._prepared[stmt_id][0]
        assert not getattr(ast, "hints", [])
        assert s.execute_prepared(stmt_id, []).rows == r1
        out.append(r1)
    assert out[0] == out[1]
