"""The port's general fragments (tidb_tpu_torch/parallel/fragment.py)
against the reference's (tidb_tpu/parallel/fragment.py) and the sqlite
oracle, on the same tables made by the same SQL: the reference on its
8-device virtual CPU mesh (2 x 4), the port on eight CPU shards (2 x 4).

Every query of tests/test_fragment.py: many-to-many, multi-key,
three-way, left, other-condition, semi and NOT IN anti joins, a segment
aggregation over a join tree, the high-cardinality aggregation and its
per-part emission, the growth retry on skew, the derived-table probe and
an INSERT that changes a fragment's result. Whether the fragment engages
(DistFragmentExec in the built tree) must be the same in both packages.
Rows compare with the oracle (numbers within 1e-6 relative) and with the
reference (non-floats exactly, floats within 1e-9 relative)."""

import numpy as np
import pytest
import torch

from tidb_tpu.parallel import make_mesh as jax_make_mesh
from tidb_tpu.parallel.executor import build_dist_executor as jax_build
from tidb_tpu.parser import parse as jax_parse
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.testutil import mirror_to_sqlite, rows_equal
from tidb_tpu_torch.parallel import make_mesh
from tidb_tpu_torch.parallel.executor import build_dist_executor
from tidb_tpu_torch.parser import parse
from tidb_tpu_torch.session import Session
from test_torch_parallel import CPU8, same_rows
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

torch.set_num_threads(1)


def _setup_sql():
    """tests/test_fragment.py's tables, as SQL statements (seed 11)."""
    rng = np.random.default_rng(11)
    out = ["CREATE TABLE fact (fk bigint, fk2 bigint, grp bigint, val bigint, tag varchar(8))",
           "CREATE TABLE dim (dk bigint, dk2 bigint, dgrp bigint, weight bigint)",
           "CREATE TABLE dim2 (ek bigint, cat bigint)"]
    n, nd, ne = 4000, 600, 40
    rows = []
    for i in range(n):
        fk = "NULL" if i % 53 == 0 else str(rng.integers(1, nd + 1))
        rows.append(
            f"({fk}, {rng.integers(0, 4)}, {rng.integers(0, 900)}, "
            f"{rng.integers(-100, 100)}, 't{rng.integers(0, 3)}')")
    for start in range(0, n, 500):
        out.append("INSERT INTO fact VALUES " + ", ".join(rows[start:start + 500]))
    rows = [f"({(i % 300) + 1}, {i % 4}, {i % 25}, {rng.integers(1, 10)})"
            for i in range(1, nd + 1)]
    out.append("INSERT INTO dim VALUES " + ", ".join(rows))
    out.append("INSERT INTO dim2 VALUES " + ", ".join(f"({i}, {i % 7})"
                                                      for i in range(1, ne + 1)))
    return out


@pytest.fixture(scope="module")
def sessions(devices8):
    js = JaxSession(chunk_capacity=2048,
                    mesh=jax_make_mesh(n_shards=4, n_dcn=2, devices=devices8))
    ps = Session(chunk_capacity=2048, mesh=make_mesh(n_shards=4, n_dcn=2, devices=CPU8))
    for sql in _setup_sql():
        js.execute(sql)
        ps.execute(sql)
    return js, ps, mirror_to_sqlite(js.catalog)


def engaged(names) -> bool:
    return "DistFragmentExec" in names


def built(session, sql, jax_side: bool):
    if jax_side:
        root = jax_build(session._plan_select(jax_parse(sql)[0]), session._shard_cache)
    else:
        root = build_dist_executor(session._plan_select(parse(sql)[0]), session._shard_cache)
    names, stack = set(), [root]
    while stack:
        e = stack.pop()
        names.add(type(e).__name__)
        stack.extend(e.children)
    return names


def check(sessions, sql, expect_fragment=True):
    js, ps, oracle = sessions
    want_names = built(js, sql, True)
    got_names = built(ps, sql, False)
    assert engaged(got_names) == engaged(want_names), (got_names, want_names)
    if expect_fragment:
        assert engaged(got_names), f"fragment not used: {sorted(got_names)}"
    got = ps.query(sql)
    ok, msg = rows_equal(got, oracle.execute(sql).fetchall(), ordered=True)
    assert ok, msg
    same_rows(got, js.query(sql), ordered=True)


def test_many_many_join_generic_agg(sessions):
    check(sessions, """
        select grp, count(*), sum(val * weight) from fact
        join dim on fk = dk group by grp order by grp""")


def test_multi_key_join(sessions):
    check(sessions, """
        select dgrp, count(*), sum(val) from fact
        join dim on fk = dk and fk2 = dk2 group by dgrp order by dgrp""")


def test_three_way_join(sessions):
    check(sessions, """
        select cat, count(*), sum(val * weight) from fact
        join dim on fk = dk
        join dim2 on dgrp = ek
        group by cat order by cat""")


def test_left_join(sessions):
    check(sessions, """
        select grp, count(weight), count(*) from fact
        left join dim on fk = dk and dk2 = 1
        group by grp order by grp""")


def test_join_other_cond(sessions):
    check(sessions, """
        select dgrp, count(*) from fact join dim on fk = dk and val > weight
        group by dgrp order by dgrp""")


def test_semi_join(sessions):
    check(sessions, """
        select grp, count(*) from fact
        where fk in (select dk from dim where weight > 5)
        group by grp order by grp""")


@pytest.mark.parametrize("sql,frag", [
    ("""select count(*) from fact
        where fk2 not in (select cat from dim2 where cat < 3)""", False),
    ("""select grp, count(*) from fact
        where fk not in (select dk from dim where dk > 250)
        group by grp order by grp""", True),
], ids=["no_nulls", "probe_nulls"])
def test_anti_join_not_in_null(sessions, sql, frag):
    check(sessions, sql, expect_fragment=frag)


def test_segment_agg_over_join_tree(sessions):
    check(sessions, """
        select tag, count(*), sum(weight) from fact
        join dim on fk = dk group by tag order by tag""")


def test_high_cardinality_dist_agg(sessions):
    check(sessions, """
        select grp, fk2, count(*), sum(val), min(val), max(val), avg(val)
        from fact group by grp, fk2 order by grp, fk2""")


def test_growth_retry_on_skew(sessions):
    # every fact row joins every dim row with dk2 = 1: expansion retries
    check(sessions, """
        select count(*), sum(weight) from fact join dim on fk2 = dk2
        where dk2 = 1""", expect_fragment=False)


@pytest.mark.parametrize("sql", [
    """select count(*) from
       (select fk f, count(*) c from fact group by fk) d
       join dim on d.f = dk""",
    """select dgrp, count(*) from
       (select fk f, sum(val) v from fact group by fk) d
       left join dim on d.f = dk group by dgrp order by dgrp""",
], ids=["inner", "left"])
def test_derived_table_probe_not_inflated(sessions, sql):
    # a subquery on the probe side must not enter as a replicated
    # broadcast (that counted every probe row once per shard)
    check(sessions, sql, expect_fragment=False)


def test_update_invalidates_fragment_results(sessions):
    js, ps, oracle = sessions
    sql = """select grp, count(*), sum(val * weight) from fact
             join dim on fk = dk group by grp order by grp"""
    before = ps.query(sql)
    for s in (js, ps):
        s.execute("INSERT INTO fact VALUES (1, 1, 1, 42, 'tX')")
    oracle.execute("INSERT INTO fact VALUES (1, 1, 1, 42, 'tX')")
    after = ps.query(sql)
    assert before != after
    ok, msg = rows_equal(after, oracle.execute(sql).fetchall(), ordered=True)
    assert ok, msg
    same_rows(after, js.query(sql), ordered=True)


def test_high_cardinality_multikey_per_part_emission(devices8):
    """The exact per-part reduce makes per-part tables duplicate-free, so
    the finalize emits parts as they are: against the host engine and the
    reference at a cardinality with many groups per shard."""
    js = JaxSession(chunk_capacity=1 << 14, mesh=jax_make_mesh(devices=devices8))
    ps = Session(chunk_capacity=1 << 14, mesh=make_mesh(devices=CPU8))
    rng = np.random.default_rng(7)
    n = 40_000
    cols = {"k": rng.integers(0, 20_000, n), "k2": rng.integers(0, 3, n),
            "v": rng.integers(-50, 50, n)}
    for s in (js, ps):
        s.execute("set tidb_device_engine_mode = 'force'")
        s.execute("create table hc (k bigint, k2 bigint, v bigint)")
        s.catalog.table("test", "hc").insert_columns(dict(cols))
    sql = "select k, k2, sum(v), count(*), min(v), max(v) from hc group by k, k2"
    assert engaged(built(ps, sql, False)) and engaged(built(js, sql, True))
    got = sorted(ps.query(sql))
    host = Session(catalog=ps.catalog, device="cpu")
    host.execute("set tidb_enable_tpu_exec = 0")
    assert got == sorted(host.query(sql))
    assert got == sorted(js.query(sql))
