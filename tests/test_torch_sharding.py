"""The port's sharded placement, cross-process shuffle, 2PC DML, online
reshard and membership (tidb_tpu_torch/sharding/ and parallel/dcn.py)
held to the reference on the CPU.

The reference's sqlite-oracle cases (tests/test_sharding.py) run over a
port fleet and a reference fleet of the same width that got the same
seeded rows through `load_sharded`; both must equal sqlite and each
other. The placement math is compared destination for destination, the
shuffle's wire batches byte for byte. One reference fault is repaired
in the port and pinned here: `reshard()` no longer fails while a
concurrent 2PC sits between its prepare and its commit
(`test_reshard_waits_out_a_pending_2pc`)."""

import threading
import time

import numpy as np
import pytest
import torch

import tidb_tpu.parallel.dcn as jdcn
import tidb_tpu.sharding.placement as jpl
import tidb_tpu.sharding.shuffle as jsh
import tidb_tpu_torch.parallel.dcn as pdcn
import tidb_tpu_torch.sharding.placement as ppl
import tidb_tpu_torch.sharding.shuffle as psh
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.testutil import mirror_to_sqlite, rows_equal
from tidb_tpu.types import SQLType as JType, TypeKind as JKind
from tidb_tpu_torch.errors import ExecutionError, TiDBTPUError, UnsupportedError
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.types import SQLType, TypeKind
from tidb_tpu_torch.utils.failpoint import failpoint
from test_torch_dcn import (  # noqa: F401 (autouse)
    feedback_stores_cleared, make_cluster, same, start_workers)
from test_torch_session import (  # noqa: F401
    reference_witness_off, reference_witness_paused)

torch.set_num_threads(1)

N_ROWS = 1200
DDL_HASH = ("create table f (k bigint, g bigint, v bigint, s varchar(8)) "
            "shard by hash(k) shards 8")
DDL_RANGE = ("create table f (k bigint, g bigint, v bigint, s varchar(8)) "
             "shard by range(k) shards (300, 700)")
DDL_DIM = ("create table d (k bigint, w bigint, name varchar(8)) "
           "shard by hash(w) shards 4")

QUERIES = [
    ("select g, count(*) as n, count(v) as cv, sum(v) as sv, "
     "min(v) as mv, max(v) as xv, avg(v) as av from f group by g "
     "order by g"),
    ("select count(*) as n, sum(v) as sv from f where k < 400"),
    ("select k, v from f where v > 0 order by v desc, k limit 9"),
    ("select count(*) as n, sum(f.v) as sv from f join d on f.k = d.k"),
    ("select d.name, count(*) as n, sum(f.v) as sv from f "
     "join d on f.k = d.k where d.w < 11 group by d.name order by d.name"),
]


def fact_rows(skewed=False, null_keys=False):
    """The reference test's seeded fact rows (test_sharding._fact_rows)."""
    rng = np.random.default_rng(7)
    if skewed:
        k = np.where(rng.random(N_ROWS) < 0.9,
                     rng.integers(0, 3, N_ROWS), rng.integers(0, 1000, N_ROWS))
    else:
        k = rng.permutation(N_ROWS)
    k = k.astype(np.int64)
    kv = np.ones(N_ROWS, dtype=bool)
    if null_keys:
        kv = rng.random(N_ROWS) > 0.1
    g = (np.arange(N_ROWS, dtype=np.int64) % 7)
    v = np.arange(N_ROWS, dtype=np.int64) * 3 - 100
    s = [f"s{i % 5}" if i % 11 else None for i in range(N_ROWS)]
    return k, kv, g, v, s


def load_fleet(cl, ddl=DDL_HASH, **rows_kw):
    cl.ddl(ddl)
    cl.ddl(DDL_DIM)
    k, kv, g, v, s = fact_rows(**rows_kw)
    cl.load_sharded("f", arrays={"k": k, "g": g, "v": v},
                    valids={"k": kv}, strings={"s": s})
    dk = np.arange(0, N_ROWS, 4, dtype=np.int64)
    cl.load_sharded("d", arrays={"k": dk, "w": dk % 13},
                    strings={"name": [f"n{i % 9}" for i in dk]})


def port_fleet(n, ddl=DDL_HASH, replicas=None, **rows_kw):
    ws = start_workers(pdcn, n)
    cl = make_cluster(pdcn, ws, replicas=replicas, rpc_timeout_s=30.0,
                      connect_timeout_s=5.0)
    load_fleet(cl, ddl, **rows_kw)
    return ws, cl


def ref_fleet(n, ddl=DDL_HASH, **rows_kw):
    ws = start_workers(jdcn, n)
    cl = make_cluster(jdcn, ws, rpc_timeout_s=30.0, connect_timeout_s=5.0)
    load_fleet(cl, ddl, **rows_kw)
    return ws, cl


def sqlite_oracle(ddl=DDL_HASH, **rows_kw):
    s = JaxSession(chunk_capacity=4096)
    s.execute(ddl)
    s.execute(DDL_DIM)
    k, kv, g, v, sv = fact_rows(**rows_kw)
    s.catalog.table("test", "f").insert_columns(
        {"k": k, "g": g, "v": v}, {"k": kv}, strings={"s": sv})
    dk = np.arange(0, N_ROWS, 4, dtype=np.int64)
    s.catalog.table("test", "d").insert_columns(
        {"k": dk, "w": dk % 13}, strings={"name": [f"n{i % 9}" for i in dk]})
    return s, mirror_to_sqlite(s.catalog)


def kill_listener(w):
    """Stop a worker taking connections: shutdown() wakes its blocked
    accept() (close() alone leaves the listener open in the kernel)."""
    import socket

    w._running = False
    try:
        w._sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    w._sock.close()


def assert_clean(workers):
    assert all(not w._cursors for w in workers)
    assert all(w._inbox.open_count() == 0 for w in workers)
    assert all(w._shuffle_tracker.consumed == 0 for w in workers)
    assert all(w._txn2pc is None for w in workers)


def oracle_equal(got, want, sql):
    ok, msg = rows_equal(got, want, ordered="order by" in sql)
    assert ok, f"{sql}\n{msg}"


# -- placement math and the shuffle's data plane ------------------------------

_KEYS = np.concatenate([
    np.arange(-2000, 2000, dtype=np.int64),
    np.random.default_rng(3).integers(-(1 << 62), 1 << 62, 4000),
    np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1],
             dtype=np.int64)])


@pytest.mark.parametrize("kind,shards,n_workers,bounds", [
    ("hash", 8, 2, ()), ("hash", 12, 2, ()), ("hash", 8, 3, ()),
    ("hash", 1, 4, ()), ("range", 3, 2, (300, 700)),
    ("range", 5, 3, (-(1 << 40), -5, 0, 1 << 50)),
])
def test_shard_map_places_every_key_like_reference(kind, shards, n_workers,
                                                   bounds):
    pm = ppl.ShardMap(kind, "k", shards, n_workers, bounds, 3)
    jm = jpl.ShardMap(kind, "k", shards, n_workers, bounds, 3)
    valid = np.random.default_rng(1).random(len(_KEYS)) > 0.05
    for v in (None, valid):
        np.testing.assert_array_equal(ppl.shard_of_array(pm, _KEYS, v),
                                      jpl.shard_of_array(jm, _KEYS, v))
    for key in (None, 0, -1, 37, 1 << 40, int(_KEYS[4100])):
        assert pm.shard_of(key) == jm.shard_of(key)
    assert pm.owners() == jm.owners()
    assert [pm.worker_of(s) for s in range(shards)] == \
        [jm.worker_of(s) for s in range(shards)]
    assert pm.to_wire() == jm.to_wire()
    assert ppl.ShardMap.from_wire(jm.to_wire()) == pm
    assert pm.colocated_on("k") == jm.colocated_on("k")
    wider_p, wider_j = ppl.with_n_workers(pm, n_workers + 1), \
        jpl.with_n_workers(jm, n_workers + 1)
    assert wider_p.to_wire() == wider_j.to_wire()
    assert ppl.shards_to_move(pm, wider_p) == jpl.shards_to_move(jm, wider_j)


def test_hash_placement_is_the_mesh_exchange_mix():
    """A hash placement over W shards routes each key where the mesh's
    repartition (parallel/distsql._hash_dest) sends it: the co-location
    rule of the shuffle planner rests on that identity."""
    from tidb_tpu_torch.parallel.distsql import _hash_dest

    for w in (2, 3, 8):
        m = ppl.ShardMap("hash", "k", w, w)
        np.testing.assert_array_equal(
            ppl.shard_of_array(m, _KEYS),
            _hash_dest(torch.from_numpy(_KEYS), w).numpy())


def test_shuffle_batches_equal_reference_bytes():
    arrays = {"a": np.array([5, 1000, -3, 7], dtype=np.int64),
              "f": np.array([1.5, -0.0, np.nan, 2.0]),
              "d": np.array([9000, 9100, 9050, 0], dtype=np.int32)}
    valids = {"a": np.array([True, True, False, True]),
              "f": np.array([True, True, True, False]),
              "d": np.array([True, False, True, True])}
    strings = {"s": ["x", None, "yy", "z"]}
    ptypes = {"a": SQLType(TypeKind.INT), "f": SQLType(TypeKind.FLOAT),
              "d": SQLType(TypeKind.DATE)}
    jtypes = {"a": JType(JKind.INT), "f": JType(JKind.FLOAT),
              "d": JType(JKind.DATE)}
    pb = psh.encode_batch(ptypes, arrays, valids, strings)
    jb = jsh.encode_batch(jtypes, arrays, valids, strings)
    assert pdcn._dumps(pb) == jdcn._dumps(jb)
    assert pb["cols"]["a"]["enc"] == "for"
    pa, pv, ps = psh.decode_batch(ptypes, pb)
    ja, jv, js = jsh.decode_batch(jtypes, jb)
    for c in arrays:
        np.testing.assert_array_equal(pv[c], jv[c])
        np.testing.assert_array_equal(pa[c][pv[c]], ja[c][jv[c]])
    assert ps == js == strings
    assert psh.batch_wire_bytes(pb) == jsh.batch_wire_bytes(jb)
    dest = ppl.shard_of_array(ppl.ShardMap("hash", "a", 2, 2), arrays["a"],
                              valids["a"])
    pp = psh.partition_rows(arrays, valids, strings, dest, 2)
    jp = jsh.partition_rows(arrays, valids, strings, dest, 2)
    assert pdcn._dumps([None if p is None else list(p) for p in pp]) == \
        jdcn._dumps([None if p is None else list(p) for p in jp])


@pytest.mark.parametrize("cols", [("a", "s", "f", "b", "i32", "u", "g"), ("s",),
                                  ("f",), ()], ids=["seven", "string", "float", "none"])
def test_rows_fingerprint_equals_reference(cols):
    """The cutover's validation hash: the port builds it a column at a
    time, and must give the reference's value on every row set."""
    from tidb_tpu.parallel.membership import rows_fingerprint as jfp
    from tidb_tpu_torch.parallel.membership import rows_fingerprint as pfp

    rng = np.random.default_rng(5)
    n = 3000
    arrays = {"a": rng.integers(-5, 5, n), "f": rng.standard_normal(n) * 1e10,
              "b": rng.random(n) < 0.5, "i32": rng.integers(0, 99, n).astype(np.int32),
              "u": rng.integers(0, 9, n).astype(np.uint8),
              "g": np.array([np.nan, -0.0, np.inf, 1e-300] * (n // 4))}
    valids = {k: rng.random(n) > 0.1 for k in arrays}
    strings = {"s": [None if i % 5 == 0 else f"x'{i}\"\\\u00e9\n" for i in range(n)]}
    for sel in (None, rng.random(n) < 0.3):
        assert pfp(arrays, valids, strings, list(cols), sel) == \
            jfp(arrays, valids, strings, list(cols), sel)


def test_shard_rows_extract_the_reference_selection():
    """The worker extracts one shard's rows from the shard column first;
    the rows are the reference's whole-table extract masked to the
    shard, in order."""
    s = Session(device="cpu")
    s.execute(DDL_HASH)
    k, kv, g, v, sv = fact_rows(null_keys=True)
    t = s.catalog.table("test", "f")
    t.insert_columns({"k": k, "g": g, "v": v}, {"k": kv}, strings={"s": sv})
    s.execute("delete from f where g = 3")
    smap = ppl.ShardMap("hash", "k", 8, 2)
    arrays, valids, strings, _n = psh.extract_live_columns(t)
    shards = ppl.shard_of_array(smap, arrays["k"], valids["k"])
    for shard in range(8):
        a, va, st = psh.extract_rows(t, psh.live_shard_rows(t, smap, shard))
        m = shards == shard
        for c in arrays:
            np.testing.assert_array_equal(a[c], arrays[c][m])
            np.testing.assert_array_equal(va[c], valids[c][m])
        assert st["s"] == [x for x, keep in zip(strings["s"], m) if keep]


def test_inbox_backpressure_is_typed_and_released():
    from tidb_tpu_torch.utils.memory import MemTracker, QueryOOMError

    tracker = MemTracker("t", budget=64, spill_enabled=False)
    inbox = psh.ShuffleInbox(tracker)
    batch = {"n": 1, "cols": {"a": {"d": np.zeros(4, dtype=np.int8),
                                    "v": np.ones(4, dtype=bool), "ref": 0,
                                    "enc": "raw", "dt": "int8"}}}
    big = {"n": 1, "cols": {"a": {"d": np.zeros(256, dtype=np.int8),
                                  "v": np.ones(256, dtype=bool), "ref": 0,
                                  "enc": "raw", "dt": "int8"}}}
    inbox.stage("s1", "f", batch)
    with pytest.raises(QueryOOMError):
        inbox.stage("s1", "f", big)
    assert len(inbox.drain("s1", "f")) == 1
    inbox.close("s1")
    inbox.close("s1")
    assert tracker.consumed == 0 and inbox.open_count() == 0


# -- the sqlite-oracle grid, against the reference fleet too -------------------

_FLEETS = {}


@pytest.fixture(scope="module")
def fleet_cache():
    yield _FLEETS
    with reference_witness_off():  # module teardown: no autouse pause
        for (pw, pc), (jw, jc) in _FLEETS.values():
            for cl in (pc, jc):
                try:
                    cl.shutdown()
                except Exception:  # noqa: BLE001 — teardown best effort
                    pass
    _FLEETS.clear()


def cached_fleets(cache, n, ddl):
    key = (n, ddl)
    if key not in cache:
        cache[key] = (port_fleet(n, ddl), ref_fleet(n, ddl))
    return cache[key]


_ORACLES = {}


def cached_oracle(ddl):
    if ddl not in _ORACLES:
        _ORACLES[ddl] = sqlite_oracle(ddl)
    return _ORACLES[ddl][1]


@pytest.mark.parametrize("n_workers", [1, 2, 4])
@pytest.mark.parametrize("ddl", [DDL_HASH, DDL_RANGE], ids=["hash", "range"])
@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_query_matches_sqlite_and_reference(fleet_cache, n_workers, ddl, qi):
    sql = QUERIES[qi]
    (pw, pc), (_jw, jc) = cached_fleets(fleet_cache, n_workers, ddl)
    got = pc.query(sql)
    oracle_equal(got, cached_oracle(ddl).execute(sql).fetchall(), sql)
    same(got, jc.query(sql), ordered="order by" in sql)
    assert_clean(pw)


@pytest.mark.parametrize("n_workers", [1, 2, 4])
@pytest.mark.parametrize("rows_kw", [{"skewed": True}, {"null_keys": True}],
                         ids=["skewed", "null_keys"])
def test_skew_and_null_shard_keys(n_workers, rows_kw):
    pw, pc = port_fleet(n_workers, **rows_kw)
    _s, conn = sqlite_oracle(**rows_kw)
    try:
        for sql in (QUERIES[0], QUERIES[3]):
            oracle_equal(pc.query(sql), conn.execute(sql).fetchall(), sql)
        assert_clean(pw)
    finally:
        pc.shutdown()


_DMLS = [
    ("insert into f (k, g, v, s) values "
     "(100001, 1, 11, 'new'), (100002, 2, -7, null), (100003, 3, 0, 'x')"),
    "update f set v = v + 1 where g = 3",
    "update f set v = 0 where k = 100001",
    "delete from f where k = 100002",
    "delete from f where g = 5",
]


@pytest.mark.parametrize("n_workers", [1, 2, 4])
def test_dml_2pc_matches_sqlite_and_reference(n_workers):
    pw, pc = port_fleet(n_workers)
    jw, jc = ref_fleet(n_workers)
    oracle, _conn = sqlite_oracle()
    try:
        for dml in _DMLS:
            got, want = pc.execute_dml(dml), jc.execute_dml(dml)
            assert got["workers"] == want["workers"], dml
            oracle.execute(dml)
        conn = mirror_to_sqlite(oracle.catalog)
        for sql in (QUERIES[0], QUERIES[1], QUERIES[3]):
            got = pc.query(sql)
            oracle_equal(got, conn.execute(sql).fetchall(), sql)
            same(got, jc.query(sql), ordered="order by" in sql)
        assert not pc._txn_pending and not pc._txn_decided
        assert_clean(pw)
    finally:
        pc.shutdown()
        jc.shutdown()


# -- owner pruning and DML routing (the port's own fleet) ---------------------

def test_non_owners_do_no_work_and_equality_prunes_to_one():
    pw, pc = port_fleet(4, ddl=("create table f (k bigint, g bigint, v "
                                "bigint, s varchar(8)) shard by hash(k) "
                                "shards 2"))
    try:
        before = [w.stats["executed"] for w in pw]
        pc.query("select g, sum(v) as s from f group by g order by g")
        deltas = [w.stats["executed"] - b for w, b in zip(pw, before)]
        assert deltas[0] > 0 and deltas[1] > 0 and deltas[2:] == [0, 0]
        assert [s["shards_owned"] for s in pc.worker_stats()] == [2, 2, 1, 1]
        before = [w.stats["executed"] for w in pw]
        assert pc.query("select count(*) as n from f where k = 37")[0][0] == 1
        moved = [i for i, (w, b) in enumerate(zip(pw, before))
                 if w.stats["executed"] > b]
        smap = pc.placement("f")
        assert moved == [smap.worker_of(smap.shard_of(37))]
    finally:
        pc.shutdown()


def test_dml_routing_and_typed_refusals():
    pw, pc = port_fleet(4)
    try:
        smap = pc.placement("f")
        res = pc.execute_dml("insert into f (k, g, v) values (500000, 0, 1)")
        assert res["workers"] == [smap.worker_of(smap.shard_of(500000))]
        assert pc.query("select count(*) as n from f where k = 500000") == [(1,)]
        assert pc.execute_dml(
            "insert into f (k, g, v) values (null, 0, 9)")["workers"] == [0]
        with pytest.raises(UnsupportedError):
            pc.execute_dml("insert into f (k, g, v) values (1 + 2, 0, 1)")
        pc.broadcast_exec("create table plain (a bigint)")
        with pytest.raises(ExecutionError):
            pc.execute_dml("insert into plain values (1)")
        with pytest.raises(UnsupportedError, match="reshard"):
            pc.ddl("alter table f shard by hash(k) shards 2")
        with pytest.raises(TiDBTPUError):
            pc.query("select count(*) as n from f join d on f.k < d.k")
    finally:
        pc.shutdown()


def test_session_shard_by_ddl_and_cached_plan_demotion():
    """CREATE/ALTER ... SHARD BY in one port session, as the reference's
    session takes them: metadata only, the version bumps, and a cached
    plan demotes."""
    s = Session(device="cpu")
    js = JaxSession()
    for sess in (s, js):
        sess.execute("create table r (k bigint, v bigint) "
                     "shard by hash(k) shards 4")
        sess.execute("insert into r values (1, 10), (2, 20)")
        sess.execute("set session tidb_enable_non_prepared_plan_cache = 1")
    sql = "select sum(v) as s from r where k < 10"
    for sess in (s, js):
        assert sess.query(sql) == [(30,)]
        assert sess.query(sql) == [(30,)]
        assert sess.query("select @@last_plan_from_cache") == [(1,)]
        v0 = sess.catalog.schema_version
        sess.execute("alter table r shard by range(k) shards (5, 9)")
        assert sess.catalog.schema_version == v0 + 1
        info = sess.catalog.table("test", "r").schema.shard_by
        assert (info.kind, info.shards, list(info.bounds), info.version) == (
            "range", 3, [5, 9], 1)
        assert sess.query(sql) == [(30,)]
        assert sess.query("select @@last_plan_from_cache") == [(0,)]
    from tidb_tpu_torch.errors import SchemaError

    with pytest.raises(SchemaError, match="integer-typed"):
        s.execute("create table bad (a varchar(4)) shard by hash(a) shards 2")
    with pytest.raises(SchemaError, match="unknown shard column"):
        s.execute("create table bad (a bigint) shard by hash(z) shards 2")


# -- online reshard, membership, failover ------------------------------------

def test_reshard_moves_rows_and_serves_the_new_map():
    pw, pc = port_fleet(4)
    jw, jc = ref_fleet(4)
    _o, conn = sqlite_oracle()
    try:
        v0 = pc.placement("f").version
        for cl in (pc, jc):
            cl.reshard("alter table f shard by hash(k) shards 6")
        assert pc.placement("f").version == v0 + 1
        assert pc.placement("f").to_wire() == jc.placement("f").to_wire()
        for sql in QUERIES:
            got = pc.query(sql)
            oracle_equal(got, conn.execute(sql).fetchall(), sql)
            same(got, jc.query(sql), ordered="order by" in sql)
        assert [s["shards_owned"] for s in pc.worker_stats()] == [3, 3, 2, 2]
        pc.reshard("alter table f shard by range(k) shards (600)")
        oracle_equal(pc.query(QUERIES[1]),
                     conn.execute(QUERIES[1]).fetchall(), QUERIES[1])
        assert_clean(pw)
        assert pc.recover_reshard() == {}
    finally:
        pc.shutdown()
        jc.shutdown()


def test_reshard_rebuilds_mirrors_and_fails_over():
    pw, pc = port_fleet(2, replicas={0: 1, 1: 0})
    _o, conn = sqlite_oracle()
    try:
        pc.reshard("alter table f shard by hash(k) shards 6")
        want = conn.execute(QUERIES[0]).fetchall()
        oracle_equal(pc.query(QUERIES[0]), want, QUERIES[0])
        from tidb_tpu_torch.utils.metrics import DCN_FAILOVER_TOTAL

        fo = DCN_FAILOVER_TOTAL.value()
        kill_listener(pw[0])
        pc._socks[0].close()
        oracle_equal(pc.query(QUERIES[0]), want, QUERIES[0])
        assert DCN_FAILOVER_TOTAL.value() > fo
    finally:
        pc.shutdown()


def test_add_and_remove_worker():
    pw, pc = port_fleet(2)
    _o, conn = sqlite_oracle()
    joiner = start_workers(pdcn, 1)[0]
    try:
        bk = np.arange(7, dtype=np.int64)
        pc.broadcast_exec("create table bc (k bigint, v bigint)")
        pc.broadcast_table("bc", arrays={"k": bk, "v": bk * 2})
        assert pc.add_worker("127.0.0.1", joiner.port) == 2
        assert pc.placement("f").n_workers == 3
        assert joiner.session.query(
            "select count(*) as n, sum(v) as s from bc") == [(7, 42)]
        for sql in QUERIES:
            oracle_equal(pc.query(sql), conn.execute(sql).fetchall(), sql)
        assert joiner.session.query("select count(*) from f")[0][0] > 0
        pc.remove_worker(2)
        assert len(pc._socks) == 2 and pc.placement("f").n_workers == 2
        for sql in QUERIES:
            oracle_equal(pc.query(sql), conn.execute(sql).fetchall(), sql)
        assert joiner.session.query("select count(*) from f") == [(0,)]
        with pytest.raises(ExecutionError, match="no worker 9"):
            pc.remove_worker(9)
        with pytest.raises(UnsupportedError, match="strand rows"):
            pc.remove_worker(1, graceful=False)
    finally:
        pc.shutdown()
        try:
            joiner._handle({"cmd": "shutdown"})
            joiner._sock.close()
        except OSError:
            pass


def test_colocated_sides_skip_the_exchange():
    ws = start_workers(pdcn, 2)
    cl = make_cluster(pdcn, ws)
    try:
        cl.ddl("create table a (k bigint, v bigint) shard by hash(k) shards 4")
        cl.ddl("create table b (k bigint, u bigint) shard by hash(k) shards 2")
        ks = np.arange(400, dtype=np.int64)
        cl.load_sharded("a", arrays={"k": ks, "v": ks * 2})
        cl.load_sharded("b", arrays={"k": ks[::2], "u": ks[::2] + 1})
        before = [w.stats["shuffle_bytes_out"] for w in ws]
        got = cl.query("select count(*) as n, sum(a.v) as sv "
                       "from a join b on a.k = b.k")
        assert got == [(200, int((ks[::2] * 2).sum()))]
        assert [w.stats["shuffle_bytes_out"] for w in ws] == before
    finally:
        cl.shutdown()


# -- the repaired reference fault: reshard during a pending 2PC ---------------

def test_reshard_waits_out_a_pending_2pc():
    """One execute_dml is held between its 2PC prepare and its commit
    (the `2pc.commit` failpoint blocks it there), so its participant
    worker refuses every foreign statement; reshard() is called
    meanwhile. The reference broadcasts its ALTER outside every gate and
    fails at once with the worker's "pending" refusal. The port takes the
    cluster gate for the broadcast: the reshard waits for the 2PC, then
    completes, and every row sits where the new map places it."""
    pw, pc = port_fleet(3)
    in_window = threading.Event()
    release = threading.Event()

    def hold():
        in_window.set()
        assert release.wait(30)

    out = {}

    def dml():
        out["dml"] = pc.execute_dml(
            "insert into f (k, g, v) values (777777, 1, 5)")

    def reshard():
        try:
            pc.reshard("alter table f shard by hash(k) shards 12")
            out["reshard"] = "done"
        except Exception as e:  # noqa: BLE001 — recorded for the assert
            out["reshard"] = e

    try:
        with failpoint("2pc.commit", action=hold, times=1):
            td = threading.Thread(target=dml)
            td.start()
            assert in_window.wait(30)
            # the participant is prepared and refusing foreign statements
            smap = pc.placement("f")
            owner = smap.worker_of(smap.shard_of(777777))
            assert pw[owner]._txn2pc is not None
            tr = threading.Thread(target=reshard)
            tr.start()
            time.sleep(0.3)
            assert "reshard" not in out, out.get("reshard")  # it waits
            release.set()
            td.join(30)
            tr.join(60)
        assert out["reshard"] == "done", out["reshard"]
        assert out["dml"]["workers"] == [owner]
        new = pc.placement("f")
        assert new.shards == 12
        total = 0
        for i, w in enumerate(pw):
            rows = w.session.query("select k from f")
            keys = [r[0] for r in rows]
            total += len(keys)
            assert all(new.worker_of(new.shard_of(k)) == i for k in keys)
        assert total == N_ROWS + 1
        assert pc.query("select count(*) as n from f where k = 777777") == [(1,)]
        assert_clean(pw)
    finally:
        release.set()
        pc.shutdown()


def test_sustained_mixed_traffic_through_online_reshard():
    """The reference's served-through acceptance on the port: two readers
    and two 2PC writers run before, during and after a live reshard;
    every read equals sqlite, every acked write survives the cutover,
    and no statement fails except the documented transient (a statement
    reaching a worker inside another 2PC's prepare->commit window)."""
    pw, pc = port_fleet(3)
    s, conn = sqlite_oracle()
    read_sql = ("select g, count(*) as n, sum(v) as sv from f "
                "where k < 10000 group by g order by g")
    want = conn.execute(read_sql).fetchall()
    stop = threading.Event()
    lock = threading.Lock()
    errors, applied, reads = [], [], [0]

    def transient(e):
        return "pending" in str(e)

    def reader():
        while not stop.is_set():
            try:
                got = pc.query(read_sql)
            except TiDBTPUError as e:
                if not transient(e):
                    with lock:
                        errors.append(("read", repr(e)))
                continue
            ok, msg = rows_equal(got, want, ordered=True)
            with lock:
                if not ok:
                    errors.append(("mismatch", msg))
                reads[0] += 1

    def writer(wid):
        n = 0
        while not stop.is_set():
            kk = 10000 + wid * 100000 + n
            n += 1
            sql = f"insert into f (k, g, v) values ({kk}, {kk % 7}, {kk * 3})"
            try:
                pc.execute_dml(sql)
            except TiDBTPUError as e:
                if not transient(e):
                    with lock:
                        errors.append(("write", repr(e)))
                continue
            with lock:
                applied.append(sql)
            time.sleep(0.005)

    threads = ([threading.Thread(target=reader) for _ in range(2)]
               + [threading.Thread(target=writer, args=(w,)) for w in range(2)])
    for t in threads:
        t.start()
    try:
        time.sleep(0.5)
        pc.reshard("alter table f shard by hash(k) shards 12")
        time.sleep(0.5)
    finally:
        stop.set()
        for t in threads:
            t.join(60)
    try:
        assert errors == [], errors[:5]
        assert pc.placement("f").shards == 12
        assert reads[0] > 0 and applied
        for sql in applied:
            conn.execute(sql)
        full = "select count(*) as n, count(v) as cv, sum(v) as sv from f"
        oracle_equal(pc.query(full), conn.execute(full).fetchall(), full)
        oracle_equal(pc.query(read_sql), want, read_sql)
        assert_clean(pw)
    finally:
        pc.shutdown()
