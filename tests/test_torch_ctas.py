"""CREATE TABLE ... AS SELECT, CREATE TABLE ... LIKE and CREATE TEMPORARY
TABLE through the port (tidb_tpu_torch on the CPU) against the JAX
package.

The cases of tests/test_ctas.py run on a reference session and a port
session built alike: every statement succeeds in both or fails in both
with the same error, and every query gives the same rows. CTAS must
infer the reference's schema (DECIMAL precision and scale, DATE as int32
days, strings re-encoded into a fresh dictionary), so SHOW CREATE TABLE
of each result is compared too. LIKE clones the engine, the keys, the
indexes and the CHECKs, never the rows or the foreign keys.

TEMPORARY: a temp table shadows a permanent one in its own session
only; the plan cache never serves one session's shadowed plan to
another, nor a dropped temp table's plan to its successor; a wire
disconnect drops the connection's temp tables, on the reference's
server and on the port's.
"""

import threading

import pytest

from tidb_tpu.server.server import Server as JaxServer
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.catalog import Catalog as JaxCatalog
from tidb_tpu_torch.server.client import Client
from tidb_tpu_torch.server.server import Server
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.catalog import Catalog, SessionCatalog

from test_torch_keys import both, same_rows
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

_SRC = [
    "create table src (id bigint primary key, name varchar(12), "
    "amt decimal(10,2), d date, key idx_n (name))",
    "insert into src values (1, 'a', 10.50, '2024-01-01'), "
    "(2, 'b', 20.25, '2024-02-01'), (3, 'a', 5.00, NULL)",
]


@pytest.fixture
def pair():
    js = JaxSession()
    js.execute("set tidb_tpu_compaction = 0")
    ps = Session(device="cpu")
    for sql in _SRC:
        assert both(js, ps, sql) is None
    return js, ps


def _ddl(s, name):
    return s.execute(f"show create table {name}").rows[0][1]


def test_ctas_basic(pair):
    js, ps = pair
    both(js, ps, "create table t2 as select id, name, amt from src where id < 3")
    same_rows(js, ps, "select id, name, amt from t2 order by id", ordered=True)
    assert ps.query("select id, name, amt from t2 order by id") == [
        (1, "a", "10.50"), (2, "b", "20.25")]
    assert _ddl(ps, "t2") == _ddl(js, "t2")


def test_ctas_without_as(pair):
    js, ps = pair
    both(js, ps, "create table t3 select name, count(*) as n, sum(amt) as total "
                 "from src group by name order by name")
    same_rows(js, ps, "select name, n, total from t3 order by name", ordered=True)
    assert ps.query("select name, n, total from t3 order by name") == [
        ("a", 2, "15.50"), ("b", 1, "20.25")]
    # the SUM's decimal scale carries over as the reference infers it
    assert _ddl(ps, "t3") == _ddl(js, "t3")


def test_ctas_types_round_trip(pair):
    js, ps = pair
    both(js, ps, "create table t4 as select id, d, name from src")
    ddl = _ddl(ps, "t4")
    assert "bigint" in ddl and "date" in ddl
    assert ddl == _ddl(js, "t4")
    for sql in ("select count(*) from t4 where d >= '2024-01-15'",
                "select count(*) from t4 where d is null",
                "select name, count(*) from t4 group by name"):
        same_rows(js, ps, sql)
    assert ps.query("select count(*) from t4 where d >= '2024-01-15'") == [(1,)]
    t = ps.catalog.table("test", "t4")
    assert str(t.data["d"].dtype) in ("int32", "torch.int32")  # days
    # strings land in a dictionary of their own, re-encoded
    assert sorted(t.dicts["name"].values) == ["a", "b"]


def test_ctas_empty_result(pair):
    js, ps = pair
    for sql in ("create table t5 as select id, name from src where id > 99",
                "insert into t5 values (7, 'x')"):
        both(js, ps, sql)
    same_rows(js, ps, "select id, name from t5")
    assert ps.query("select name from t5") == [("x",)]


def test_like_clones_structure_not_data(pair):
    js, ps = pair
    both(js, ps, "create table c1 like src")
    same_rows(js, ps, "select count(*) from c1")
    t = ps.catalog.table("test", "c1")
    assert t.schema.primary_key == ["id"]
    assert "idx_n" in t.indexes
    ddl = _ddl(ps, "c1")
    assert "decimal(10,2)" in ddl and "varchar(12)" in ddl
    assert ddl == _ddl(js, "c1")
    # unique enforcement carried over
    both(js, ps, "insert into c1 values (1, 'x', 1, NULL)")
    assert both(js, ps, "insert into c1 values (1, 'y', 2, NULL)") == "ExecutionError"


def test_like_paren_form_and_engine(pair):
    js, ps = pair
    both(js, ps, "create table dsrc (a bigint) engine=delta")
    both(js, ps, "create table dcopy (like dsrc)")
    assert ps.catalog.table("test", "dcopy").engine == "delta"
    assert js.catalog.table("test", "dcopy").engine == "delta"


def test_like_does_not_copy_fks(pair):
    js, ps = pair
    for sql in ("create table parent (id bigint primary key)",
                "create table child (pid bigint, "
                "foreign key (pid) references parent(id))",
                "create table child2 like child",
                # MySQL: LIKE does not clone FKs — child2 inserts are unchecked
                "insert into child2 values (999)"):
        assert both(js, ps, sql) is None, sql
    assert both(js, ps, "insert into child values (999)") is not None
    same_rows(js, ps, "select count(*) from child2")
    assert ps.query("select count(*) from child2") == [(1,)]


def test_ctas_implicit_commit_under_autocommit_off(pair):
    js, ps = pair
    for s, cls in ((js, JaxSession), (ps, Session)):
        s.execute("set autocommit = 0")
        try:
            s.execute("create table t6 as select id from src")
            # DDL implicitly commits: a fresh session sees the rows
            kw = {} if cls is JaxSession else {"device": "cpu"}
            s2 = cls(catalog=s.catalog, **kw)
            assert s2.query("select count(*) from t6") == [(3,)]
            assert s.txn is None
        finally:
            s.execute("set autocommit = 1")


def test_ctas_existing_table_fails_before_select(pair):
    js, ps = pair
    assert both(js, ps, "create table src as select 1 as x") == "DuplicateTableError"
    # IF NOT EXISTS: silently skipped, source untouched
    both(js, ps, "create table if not exists src as select 99 as id2")
    same_rows(js, ps, "select count(*) from src")
    assert ps.query("select count(*) from src") == [(3,)]


def test_like_clones_checks(pair):
    js, ps = pair
    both(js, ps, "create table cc (a bigint check (a > 0))")
    both(js, ps, "create table cc2 like cc")
    assert both(js, ps, "insert into cc2 values (-1)") is not None
    assert both(js, ps, "insert into cc2 values (5)") is None
    same_rows(js, ps, "select a from cc2")


# -- TEMPORARY ---------------------------------------------------------------


def _sessions(cls, **kw):
    """Two sessions over one shared catalog."""
    a = cls(**kw)
    if cls is JaxSession:
        a.execute("set tidb_tpu_compaction = 0")
    return a, cls(catalog=a.catalog, **kw)


@pytest.mark.parametrize("engine", ["columnar", "delta"])
def test_temporary_shadows_in_its_own_session_only(engine):
    outs = []
    for cls, kw in ((JaxSession, {}), (Session, {"device": "cpu"})):
        a, b = _sessions(cls, **kw)
        for sql in _SRC:
            a.execute(sql)
        a.execute(f"create temporary table src (id bigint, tag varchar(4)) "
                  f"engine={engine}")
        a.execute("insert into src values (7, 'tmp'), (8, 'tmp')")
        got = [a.query("select id, tag from src order by id"),
               b.query("select id, name from src order by id"),
               a.catalog.tables("test"), b.catalog.tables("test"),
               # information_schema lists the shared catalog only
               a.query("select table_name from information_schema.tables "
                       "where table_schema = 'test'")]
        # a temp table takes no foreign key, and drops before the
        # permanent one it shadows
        try:
            a.execute("create temporary table fk (x bigint, "
                      "foreign key (x) references src(id))")
            got.append(None)
        except Exception as e:  # noqa: BLE001 — the class is the result
            got.append(type(e).__name__)
        a.execute("drop table src")
        got.append(a.query("select id, name from src order by id"))
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[1][0] == [(7, "tmp"), (8, "tmp")]
    assert outs[1][1] == [(1, "a"), (2, "b"), (3, "a")]
    assert outs[1][5] == "UnsupportedError"
    assert outs[1][6] == outs[1][1]


def test_plan_cache_keeps_shadowed_plans_apart():
    """One SQL text, two sessions: the temp-shadowed plan stays in its
    session (the key carries the connection and the temp epoch), and a
    temp table dropped and made again never serves the old plan."""
    sql = "select count(*) from src where id > ?"
    outs = []
    for cls, kw in ((JaxSession, {}), (Session, {"device": "cpu"})):
        a, b = _sessions(cls, **kw)
        for x in _SRC:
            a.execute(x)
        a.execute("create temporary table src (id bigint)")
        a.execute("insert into src values (5), (6), (7), (8)")
        got = []
        for s in (a, b, a, b):
            sid, _n = s.prepare(sql)
            got.append(s.execute_prepared(sid, [0]).rows)
            got.append(s.execute_prepared(sid, [0]).rows)
            got.append(bool(s.sysvars.get("last_plan_from_cache")))
        a.execute("drop table src")
        a.execute("create temporary table src (id bigint)")
        a.execute("insert into src values (9)")
        sid, _n = a.prepare(sql)
        got.append(a.execute_prepared(sid, [0]).rows)
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[1][0] == [(4,)] and outs[1][3] == [(3,)]
    assert outs[1][2] and outs[1][5]  # each session hits its own entry
    assert outs[1][-1] == [(1,)]


def test_temporary_ddl_stays_inline_under_a_ddl_owner():
    """With a DDL owner running, temp DDL (and LIKE from a temp source)
    runs in the session itself: the owner's session cannot see it."""
    srv = Server(port=0, device="cpu")
    srv.start()
    try:
        s = Session(catalog=srv.catalog, device="cpu")
        assert srv.catalog.ddl_workers
        s.execute("create temporary table tt (a bigint)")
        s.execute("insert into tt values (1), (2)")
        s.execute("create temporary table tt2 like tt")
        s.execute("create table perm like tt")
        assert s.catalog.table("test", "tt2").schema.columns[0].name == "a"
        assert srv.catalog.has_table("test", "perm")
        assert not srv.catalog.has_table("test", "tt")
        assert s.query("select count(*) from tt") == [(2,)]
    finally:
        srv.stop()


def _disconnect_case(srv, catalog):
    """A connection makes a temp table over the wire and leaves; a second
    connection reads the permanent table the temp one shadowed."""
    c1, c2 = Client(port=srv.port), Client(port=srv.port)
    try:
        c1.execute("create table perm (a bigint)")
        c1.execute("insert into perm values (1)")
        c1.execute("create temporary table perm (a bigint, b bigint)")
        c1.execute("insert into perm values (10, 20), (30, 40)")
        shadowed = c1.query("select count(*) from perm")[1]
        other = c2.query("select count(*) from perm")[1]
        sess = next(p for p in catalog.processes.values() if p.catalog._temp)
        had = dict(sess.catalog._temp)
    finally:
        c1.close()
    for _ in range(500):  # the connection thread's finally runs async
        if not sess.catalog._temp:
            break
        threading.Event().wait(0.01)
    try:
        after = c2.query("select count(*) from perm")[1]
    finally:
        c2.close()
    return shadowed, other, sorted(had), dict(sess.catalog._temp), after


def test_wire_disconnect_drops_temporary_tables():
    jcat, pcat = JaxCatalog(), Catalog()
    jcat.global_vars["tidb_tpu_compaction"] = False
    jsrv = JaxServer(catalog=jcat, port=0)
    psrv = Server(catalog=pcat, port=0, device="cpu")
    outs = []
    for srv, cat in ((jsrv, jcat), (psrv, pcat)):
        srv.start()
        try:
            outs.append(_disconnect_case(srv, cat))
        finally:
            srv.stop()
    assert outs[0] == outs[1]
    shadowed, other, had, left, after = outs[1]
    assert shadowed == [("2",)] and other == [("1",)] and after == [("1",)]
    assert had == [("test", "perm")] and left == {}


def test_session_catalog_unwraps_and_writes_through():
    base = Catalog()
    s1 = Session(catalog=base, device="cpu")
    s2 = Session(catalog=s1.catalog, device="cpu")
    assert isinstance(s1.catalog, SessionCatalog)
    assert s1.catalog.base is base and s2.catalog.base is base
    v = base.schema_version
    s1.catalog.schema_version += 1  # lands on the shared base
    assert base.schema_version == v + 1
    s1.execute("create temporary table t (a bigint)")
    assert base.schema_version == v + 1  # temp DDL bumps no version
    assert s1.catalog._temp_epoch == 1 and s2.catalog._temp_epoch == 0
