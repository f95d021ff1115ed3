"""information_schema and DROP DATABASE through the port (tidb_tpu_torch
on the CPU) against the JAX package.

The queries of the reference's own tests (tests/test_foreign_keys.py,
test_partitions.py, test_views.py, test_observability.py,
test_surface_tail.py and test_columnar.py) run on a reference session
and a port session built by the same SQL; the metadata tables
(schemata, tables, columns, statistics, key_column_usage,
referential_constraints, partitions) must give the same rows, and the
runtime tables (slow_query, statements_summary, processlist,
cluster_trace, scheduler_stats, digest_latency) the same columns and
the same rows where they do not carry times or ids of their own.

dcn_worker_stats, cluster_info and cluster_metrics read the live DCN
clusters of the process (`parallel/dcn.py`'s registry): with none, the
first two give the reference's columns and no rows, and cluster_metrics
this process's metrics as `coordinator` and the merged `fleet` rows, in
both packages (tests/test_torch_dcn.py reads them over a live fleet).
plan_feedback reads each package's plan-feedback store and gives the
same rows after the same statements, apart from the columns that carry
times.
"""

import numpy as np
import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.catalog import _INFO_TABLES as JAX_INFO_TABLES
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.catalog import _INFO_TABLES

from test_torch_keys import both, same_rows
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)


def new_pair(**kw):
    js = JaxSession(**kw)
    js.execute("set tidb_tpu_compaction = 0")
    return js, Session(device="cpu", **kw)


def run_both(js, ps, stmts):
    for sql in stmts:
        assert both(js, ps, sql) is None, sql


def _listing(s):
    s.execute("use information_schema")
    try:
        return s.execute("show tables").rows
    finally:
        s.execute("use test")


def _cols(s, table):
    return s.execute(f"select * from information_schema.{table} limit 0").names


def test_the_same_tables_and_columns():
    js, ps = new_pair()
    assert _INFO_TABLES == JAX_INFO_TABLES
    assert _listing(ps) == _listing(js) == [(n,) for n in sorted(_INFO_TABLES)]
    for name in _INFO_TABLES:
        assert _cols(ps, name) == _cols(js, name), name


_META = [
    "create database other",
    "create table p (id bigint primary key, v bigint)",
    "insert into p values (1, 10), (2, 20), (3, 30)",
    "create table c (x bigint, pid bigint, foreign key (pid) references p(id))",
    "insert into c values (100, 1), (101, NULL)",
    "create table other.w (k varchar(8) not null, d date, amt decimal(9,3), "
    "unique key uk_k (k), key ix_d (d, amt))",
    "insert into other.w values ('a', '2024-01-01', 1.5), ('b', NULL, NULL)",
    "create table pt (k bigint, v bigint) partition by range (k) ("
    "partition p0 values less than (100), partition p1 values less than (200), "
    "partition p2 values less than maxvalue)",
    "insert into pt values (5, 1), (150, 2), (999, 3)",
    "create view vw as select id from p",
]


@pytest.fixture
def meta():
    js, ps = new_pair()
    run_both(js, ps, _META)
    return js, ps


@pytest.mark.parametrize("sql", [
    "select * from information_schema.schemata",
    "select * from information_schema.tables",
    "select * from information_schema.columns",
    "select * from information_schema.statistics",
    "select * from information_schema.key_column_usage",
    "select * from information_schema.referential_constraints",
    "select * from information_schema.partitions",
    "select table_schema, count(*) from information_schema.columns "
    "group by table_schema",
    "select table_name, table_rows from information_schema.tables "
    "where table_type = 'BASE TABLE' and table_rows > 1",
])
def test_metadata_tables(meta, sql):
    js, ps = meta
    same_rows(js, ps, sql)
    assert ps.query(sql)


def test_information_schema_fk_introspection(meta):
    js, ps = meta
    sql = ("select constraint_name, column_name, referenced_table_schema, "
           "referenced_table_name, referenced_column_name "
           "from information_schema.key_column_usage "
           "where referenced_table_name is not null")
    same_rows(js, ps, sql)
    assert ps.query(sql) == [("fk_c_pid", "pid", "test", "p", "id")]
    sql = ("select constraint_name, table_name, referenced_table_name, "
           "delete_rule from information_schema.referential_constraints")
    same_rows(js, ps, sql)
    assert ps.query(sql) == [("fk_c_pid", "c", "p", "RESTRICT")]


def test_referential_constraints_rules():
    js, ps = new_pair()
    run_both(js, ps, [
        "create table p (a bigint, b bigint, primary key (a, b))",
        "create table c (x bigint, y bigint, foreign key (x, y) "
        "references p (a, b) on delete cascade)"])
    sql = ("select delete_rule, update_rule from "
           "information_schema.referential_constraints where table_name = 'c'")
    same_rows(js, ps, sql)
    assert ps.query(sql) == [("CASCADE", "RESTRICT")]


def test_drop_database_fk_hygiene():
    """An FK from outside refuses the drop; dropping the child's database
    releases the back-edge its tables held on a parent outside it."""
    js, ps = new_pair()
    run_both(js, ps, [
        "create database other", "create table par (id bigint primary key)",
        "create table other.kid (pid bigint, "
        "foreign key (pid) references test.par(id))"])
    assert both(js, ps, "drop table par") == "SchemaError"
    run_both(js, ps, ["create database third",
                      "create table third.par2 (id bigint primary key)",
                      "create table kid2 (pid bigint, "
                      "foreign key (pid) references third.par2(id))"])
    # third.par2 is referenced from test.kid2: refused, nothing dropped
    assert both(js, ps, "drop database third") == "SchemaError"
    same_rows(js, ps, "select * from information_schema.schemata")
    run_both(js, ps, ["drop database other",  # releases par's back-edge
                      "drop table par", "drop table kid2",
                      "drop database third"])
    assert both(js, ps, "drop database third") == "SchemaError"
    assert both(js, ps, "drop database if exists third") is None
    same_rows(js, ps, "select * from information_schema.schemata")
    assert sorted(ps.catalog.databases) == ["test"]


def test_drop_database_clears_device_cache_entries():
    """The drop bumps schema_version, and the bump clears the device
    buffer cache: no entry of a dropped table stays."""
    from tidb_tpu_torch.executor.pipeline import DEVICE_CACHE

    ps = Session(device="cpu", chunk_capacity=4096)
    ps.execute("create database scratch")
    ps.execute("create table scratch.f (a bigint, b bigint)")
    t = ps.catalog.table("scratch", "f")
    t.insert_columns({"a": np.arange(20_000, dtype=np.int64) % 7,
                      "b": np.arange(20_000, dtype=np.int64)})
    ps.execute("set tidb_tpu_segment_rows = 1024")
    try:
        want = ps.query("select a, sum(b) from scratch.f group by a order by a")
        assert ps.query("select a, sum(b) from scratch.f group by a order by a") == want
        assert any(e["table"] is t for e in DEVICE_CACHE._entries.values())
        v = ps.catalog.schema_version
        ps.execute("drop database scratch")
        assert ps.catalog.schema_version == v + 1
        assert all(e["table"] is not t for e in DEVICE_CACHE._entries.values())
    finally:
        ps.execute("set tidb_tpu_segment_rows = 65536")


class TestPartitions:
    def test_partitions_table(self, meta):
        js, ps = meta
        sql = ("select partition_name, partition_ordinal_position, "
               "partition_method, partition_description from "
               "information_schema.partitions where table_name = 'pt' "
               "order by partition_ordinal_position")
        same_rows(js, ps, sql, ordered=True)
        assert ps.query(sql) == [("p0", 1, "RANGE", "100"), ("p1", 2, "RANGE", "200"),
                                 ("p2", 3, "RANGE", "MAXVALUE")]

    def test_unpartitioned_single_null_row(self, meta):
        js, ps = meta
        run_both(js, ps, ["create table up (a bigint)"])
        sql = ("select partition_name from information_schema.partitions "
               "where table_name = 'up'")
        same_rows(js, ps, sql)
        assert ps.query(sql) == [(None,)]


class TestViews:
    def test_information_schema_lists_views(self, meta):
        js, ps = meta
        sql = ("select table_name, table_type from information_schema.tables"
               " where table_name = 'vw'")
        same_rows(js, ps, sql)
        assert ps.query(sql) == [("vw", "VIEW")]

    def test_dropped_view_leaves_the_listing(self, meta):
        js, ps = meta
        run_both(js, ps, ["drop view vw"])
        sql = ("select count(*) from information_schema.tables "
               "where table_type = 'VIEW'")
        same_rows(js, ps, sql)
        assert ps.query(sql) == [(0,)]


class TestObservability:
    def test_slow_query_log(self):
        js, ps = new_pair()
        for s in (js, ps):
            s.execute("SET tidb_slow_log_threshold = 0")  # everything is slow
            s.execute("CREATE TABLE t (a bigint)")
            s.query("select count(*) from t")
            s.execute("SET tidb_slow_log_threshold = 300000")
        sql = ("select db, query from information_schema.slow_query "
               "where query like '%count(*)%'")
        same_rows(js, ps, sql)
        assert ps.query(sql)

    def test_aggregation_and_normalization(self):
        js, ps = new_pair()
        outs = []
        for s in (js, ps):
            s.execute("CREATE TABLE ss (a bigint, b bigint)")
            s.execute("INSERT INTO ss VALUES (1, 2), (3, 4)")
            s.query("select b from ss where a = 1")
            s.query("select b from ss where a = 3")  # same digest, new literal
            rows = s.query(
                "select digest, exec_count, avg_latency, max_latency, rows_sent,"
                " plan_digest from information_schema.statements_summary"
                " where digest_text = 'select b from ss where a = ?'")
            assert len(rows) == 1, rows
            digest, n, avg, mx, sent, plan_digest = rows[0]
            assert len(digest) == 32 and len(plan_digest) == 32
            assert mx >= avg > 0
            outs.append((digest, n, sent))
        assert outs[0] == outs[1] == (outs[0][0], 2, 2)

    def test_error_count(self):
        js, ps = new_pair()
        for s in (js, ps):
            with pytest.raises(Exception):
                s.query("select * from missing_tbl_for_summary")
        sql = ("select exec_count, errors from information_schema."
               "statements_summary where digest_text = "
               "'select * from missing_tbl_for_summary'")
        same_rows(js, ps, sql)
        assert ps.query(sql) == [(1, 1)]

    def test_summary_lists_the_same_digests(self):
        js, ps = new_pair()
        for s in (js, ps):
            s.execute("CREATE TABLE dg (a bigint, s varchar(4))")
            s.execute("INSERT INTO dg VALUES (1, 'x'), (2, 'y'), (3, 'x')")
            for k in range(3):
                s.query(f"select s, count(*) from dg where a > {k} group by s")
            s.query("select max(a) from dg")
        sql = ("select digest, stmt_type, digest_text, exec_count, rows_sent, "
               "errors from information_schema.statements_summary "
               "where digest_text like '%dg%'")
        same_rows(js, ps, sql)
        assert len(ps.query(sql)) == 4

    def test_dispatches_on_the_cpu(self):
        """The port counts its kernels' launches, and on the CPU there
        are none: the summary's dispatches stay 0 for a scan."""
        ps = Session(device="cpu")
        ps.execute("CREATE TABLE dd (a bigint)")
        ps.execute("INSERT INTO dd VALUES (1), (2), (3)")
        ps.query("select count(*) from dd where a > 1")
        rows = ps.query(
            "select exec_count, dispatches from information_schema."
            "statements_summary where digest_text = "
            "'select count ( * ) from dd where a > ?'")
        assert rows == [(1, 0)]

    def test_slow_log_enriched_with_digest(self):
        js, ps = new_pair()
        hits = []
        for s in (js, ps):
            s.execute("SET tidb_slow_log_threshold = 0")
            s.execute("CREATE TABLE sl (a bigint)")
            s.query("select count(*) from sl")
            s.execute("SET tidb_slow_log_threshold = 300000")
            rows = s.query(
                "select query, digest, plan_digest, max_mem, dispatches"
                " from information_schema.slow_query")
            hit = [r for r in rows if r[0] == "select count(*) from sl"]
            assert hit, rows
            _q, digest, plan_digest, max_mem, dispatches = hit[-1]
            assert len(digest) == 32 and len(plan_digest) == 32
            assert max_mem >= 0 and dispatches >= 0
            # the digest joins back to the summary table
            j = s.query("select exec_count from"
                        " information_schema.statements_summary"
                        f" where digest = '{digest}'")
            assert j and j[0][0] >= 1
            hits.append(digest)
        assert hits[0] == hits[1]

    def test_cluster_trace_keeps_spans(self):
        js, ps = new_pair()
        outs = []
        for s in (js, ps):
            s.execute("set tidb_trace_sample_rate = 1")
            s.execute("create table tr (a bigint)")
            s.query("select count(*) from tr")
            rows = s.query("select trace_id, name, duration_us from "
                           "information_schema.cluster_trace")
            assert rows and all(d >= 0 for _t, _n, d in rows)
            outs.append({n for _t, n, _d in rows})
            s.execute("set tidb_trace_sample_rate = 0.01")
        assert "session.plan" in outs[1]
        assert {"session.plan", "session.execute"} <= outs[0] & outs[1]


def test_processlist_table():
    outs = []
    for cls, kw in ((JaxSession, {}), (Session, {"device": "cpu"})):
        s = cls(**kw)
        s2 = cls(catalog=s.catalog, **kw)
        rows = s.query("select id, user, command from "
                       "information_schema.processlist order by id")
        ids = [r[0] for r in rows]
        assert s.conn_id in ids and s2.conn_id in ids
        outs.append([(u, c) for _i, u, c in rows])
    assert outs[0] == outs[1]


def test_processlist_is_viewer_aware():
    """A session without SUPER sees only its own threads, as SHOW
    PROCESSLIST does."""
    outs = []
    for cls, kw in ((JaxSession, {}), (Session, {"device": "cpu"})):
        s = cls(**kw)
        s.execute("create user 'eve'")
        s2 = cls(catalog=s.catalog, **kw)
        s2.user = "eve"
        rows = s2.query("select id, user from information_schema.processlist")
        outs.append([u for _i, u in rows])
        assert [i for i, _u in rows] == [s2.conn_id]
    assert outs[0] == outs[1] == [["eve"]][0]


def test_slow_log_carries_seg_counts():
    """The slow log's segment columns over a store whose zone maps prune
    (the case of tests/test_columnar.py)."""
    js, ps = new_pair(chunk_capacity=1 << 13)
    n = 10000
    rng = np.random.default_rng(5)
    a = np.arange(n, dtype=np.int64)  # clustered: zone maps prune ranges
    b = np.asarray(rng.integers(0, 1000, n), dtype=np.int64)
    d = np.asarray(rng.integers(0, 100000, n), dtype=np.int64)
    strs = [f"name{int(x) % 11}" for x in b]
    outs = []
    for s in (js, ps):
        s.execute("set tidb_tpu_segment_rows = 2048")
        s.execute("set tidb_tpu_segment_delta_rows = 2048")
        s.execute("create table t (a int, b int, c varchar(16), d decimal(10,2))")
        s.catalog.table("test", "t").insert_columns(
            {"a": a, "b": b, "d": d}, strings={"c": strs})
        s.execute("set tidb_slow_log_threshold = 0")  # log everything
        s.query("select count(*) from t where a >= 9000")
        s.execute("set tidb_slow_log_threshold = 300")
        rows = s.query(
            "select query, segs_scanned, segs_pruned from "
            "information_schema.slow_query where query like '%a >= 9000%'")
        assert rows
        outs.append(rows[-1])
        s.execute("set tidb_tpu_segment_rows = 65536")
    q, scanned, pruned = outs[1]
    assert scanned >= 1 and pruned >= 3, (scanned, pruned)
    assert outs[0] == outs[1]


@pytest.fixture
def serving_isolated(monkeypatch):
    """The process-global stores these reads see, made the test's own.
    Schedulers that earlier tests of the worker left alive are shut down
    (their workers joined, so none of them writes into a store any more)
    and both packages' registries swapped for empty ones; then the
    plan-feedback and digest-latency stores are cleared, before and after.
    A scheduler collected or dying between two counts can no longer make
    them differ, and no foreign statement lands in a store mid-test."""
    import weakref

    import tidb_tpu.serving.scheduler as jsched
    import tidb_tpu_torch.serving.scheduler as psched
    from tidb_tpu.planner import feedback as jfb
    from tidb_tpu.serving import slo as jslo
    from tidb_tpu_torch.planner import feedback as pfb
    from tidb_tpu_torch.serving import slo as pslo

    for mod in (jsched, psched):
        for sch in list(mod._SCHEDULERS):
            sch.shutdown(drain=True, timeout=10.0)
        monkeypatch.setattr(mod, "_SCHEDULERS", weakref.WeakSet())
    stores = (jfb.STORE, pfb.STORE, jslo.STORE, pslo.STORE)
    for st in stores:
        st.clear()
    yield
    for st in stores:
        st.clear()


def test_serving_stores_read_alike(serving_isolated):
    """scheduler_stats and digest_latency read stores the port already
    had: one summary row per live scheduler of the package (here the one
    each package starts, leftovers of other tests shut down first), and
    the same digests."""
    from tidb_tpu.serving import StatementScheduler as JaxScheduler
    from tidb_tpu.serving import schedulers_alive as jax_alive
    from tidb_tpu_torch.serving import StatementScheduler, schedulers_alive

    js, ps = new_pair()
    scheds = [JaxScheduler(js.catalog.base, workers=1),
              StatementScheduler(ps.catalog.base, workers=1, device="cpu")]
    try:
        for s in (js, ps):
            s.execute("create table sv (a bigint)")
            s.query("select count(*) from sv")
        sql = "select count(*) from information_schema.scheduler_stats where digest = ''"
        assert len(jax_alive()) == len(schedulers_alive()) == 1
        assert js.query(sql) == [(len(jax_alive()),)]
        assert ps.query(sql) == [(len(schedulers_alive()),)]
        same_rows(js, ps, "select digest_text, execs from information_schema.digest_latency "
                          "where digest_text like '%sv%'")
    finally:
        for sch in scheds:
            sch.shutdown(drain=True, timeout=10.0)


# -- the cluster tables with no live cluster ---------------------------------


@pytest.fixture
def no_live_clusters(monkeypatch):
    """Both packages' registries of live DCN clusters empty for the test
    (a fleet another test of the process shut down stays registered
    until it is collected)."""
    import weakref

    import tidb_tpu.parallel.dcn as jdcn
    import tidb_tpu_torch.parallel.dcn as pdcn

    for mod in (jdcn, pdcn):
        monkeypatch.setattr(mod, "_CLUSTERS", weakref.WeakSet())


@pytest.mark.parametrize("table", ["dcn_worker_stats", "cluster_info"])
def test_cluster_tables_are_empty(table, no_live_clusters):
    js, ps = new_pair()
    sql = f"select * from information_schema.{table}"
    assert ps.query(sql) == [] == js.query(sql)


def test_cluster_metrics_without_a_fleet(no_live_clusters):
    """The reference with no fleet: its own registry as `coordinator`,
    merged into `fleet`; every coordinator counter has a fleet row."""
    js, ps = new_pair()
    outs = []
    for s in (js, ps):
        s.execute("create table cm (a bigint)")
        s.query("select count(*) from cm")
        rows = s.query("select worker, metric, labels, value, error from "
                       "information_schema.cluster_metrics")
        assert {r[0] for r in rows} == {"coordinator", "fleet"}
        assert all(r[4] == "" for r in rows)
        coord = {(m, lb) for w, m, lb, _v, _e in rows if w == "coordinator"}
        fleet = {(m, lb) for w, m, lb, _v, _e in rows if w == "fleet"}
        assert fleet <= coord
        outs.append({m for m, _lb in coord})
    assert "tidb_tpu_query_total" in outs[0] & outs[1]


def test_plan_feedback_read_refuses(serving_isolated):
    """information_schema.plan_feedback no longer refuses: after the same
    statements in both packages it gives the same rows (the store's
    digest, plan digest, variant, executions and per-operator estimates
    and actuals; warm executions and best warm time carry the clock and
    are left out). Both process-global stores start and end empty."""
    from tidb_tpu.planner import feedback as jfb
    from tidb_tpu_torch.planner import feedback as pfb

    cols = ("digest, plan_digest, variant, execs, eager_partial, op, "
            "est_rows, actual_rows, drift, op_execs")
    stmts = ("select b, count(*), sum(a) from fb group by b order by b",
             "select a from fb where b = 2 order by a",
             "select count(*) from fb where a > 3")
    js, ps = new_pair()
    js.execute("set tidb_device_engine_mode = 'force'")
    pfb.STORE.on_schema_change()
    jfb.STORE.on_schema_change()
    try:
        run_both(js, ps, [
            "create table fb (a bigint, b bigint)",
            "insert into fb values " + ",".join(
                f"({i}, {i % 5})" for i in range(64))])
        for sql in stmts * 2:
            assert ps.query(sql) == js.query(sql)
        q = f"select {cols} from information_schema.plan_feedback"
        got, want = ps.query(q), js.query(q)
        assert want and len(got) == len(want)
        key = lambda r: tuple(str(v) for v in r)  # noqa: E731
        assert sorted(got, key=key) == sorted(want, key=key)
        assert ("plan_feedback",) in _listing(ps)
    finally:
        pfb.STORE.on_schema_change()
        jfb.STORE.on_schema_change()


def test_information_schema_is_world_readable():
    """No SELECT grant is needed on information_schema, in both packages."""
    outs = []
    for cls, kw in ((JaxSession, {}), (Session, {"device": "cpu"})):
        s = cls(**kw)
        s.execute("create user 'ann'")
        s.execute("create table secret (a bigint)")
        s.user = "ann"
        try:
            rows = s.query("select table_name from information_schema.tables")
            try:
                s.query("select * from secret")
                denied = None
            except Exception as e:  # noqa: BLE001 — the class is the result
                denied = type(e).__name__
        finally:
            s.user = "root"
        outs.append((rows, denied))
    assert outs[0] == outs[1]
    assert outs[1][1] == "PrivilegeError"
