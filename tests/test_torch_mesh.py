"""The port's mesh (tidb_tpu_torch/parallel) held to numpy and to the
reference (tidb_tpu/parallel) on identical inputs:

  * the collectives (psum, pmin, pmax, all_to_all) under mesh.run_spmd
    against numpy for 1, 3 and 8 parts, int64 wrap included
  * the exchange's destinations (_hash_dest, _mix_hash) bit-equal to the
    reference's, over keys with negative values and int64 extremes
  * the fragment join's primitives (sort_build_hashes, probe_hash_ranges,
    probe_for_join) against the reference's functions, each call at its
    own shape (the reference's jitted table build fails on a second call
    at one shape in one process under JAX 0.9 on the CPU)
  * the per-shard top-k under a TopN (tests/test_dist_topn.py) against the
    reference and the sqlite oracle
  * the executor classes build_dist_executor builds for the 22 TPC-H
    queries on the 8-part mesh, node for node equal to the reference's,
    and the 22 queries through the 8-part port session against sqlite at
    SF0.01
  * Server(mesh=...) over the wire against the same session in process,
    `python -m tidb_tpu_torch --device cpu --mesh auto`, and a mesh
    without a card raising

The reference runs on its 8-device virtual CPU mesh, the port on eight
CPU shards. Rows: numbers within 1e-6 relative of the oracle; non-floats
exactly and floats within 1e-9 relative of the reference."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tidb_tpu.parallel import make_mesh as jax_make_mesh
from tidb_tpu.parallel.executor import DistFragmentExec as JaxDistFragmentExec
from tidb_tpu.parallel.executor import build_dist_executor as jax_build
from tidb_tpu.parser import parse as jax_parse
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.tpch import load_tpch as jax_load_tpch
from tidb_tpu.testutil import index_tpch_oracle, mirror_to_sqlite, rows_equal
from tidb_tpu_torch.errors import ExecutionError
from tidb_tpu_torch.parallel import make_mesh
from tidb_tpu_torch.parallel.distsql import _hash_dest
from tidb_tpu_torch.parallel.executor import DistFragmentExec, build_dist_executor
from tidb_tpu_torch.parallel.fragment import _mix_hash
from tidb_tpu_torch.parallel.mesh import Mesh, all_to_all, pmax, pmin, psum, run_spmd
from tidb_tpu_torch.parser import parse
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.tpch_queries import Q
from test_torch_parallel import CPU8, TABLES, same_rows
from test_torch_session import _export_into
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
I64 = np.iinfo(np.int64)


def _jnp():
    import jax.numpy as jnp

    return jnp


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _values(P, seed):
    rng = np.random.default_rng(seed)
    ints = rng.integers(-1000, 1000, (P, 5)).astype(np.int64)
    ints[:, 0] = I64.max - 3  # psum wraps mod 2^64
    ints[:, 1] = I64.min + 2
    return ints, rng.normal(size=(P, 5))


def _wrapping_sum(a):
    return (a.astype(object).sum(axis=0) + (1 << 63)) % (1 << 64) - (1 << 63)


@pytest.mark.parametrize("P", [1, 3, 8])
def test_reductions_against_numpy(P):
    ints, floats = _values(P, P)
    mesh = make_mesh(n_shards=P, devices=[torch.device("cpu")] * P)

    def program(p, i, f):
        s = yield psum(i)
        lo = yield pmin(i)
        hi = yield pmax(f)
        fs = yield psum(f)
        return s, lo, hi, fs

    out = run_spmd(mesh, program, [(torch.from_numpy(ints[p]), torch.from_numpy(floats[p]))
                                   for p in range(P)])
    for s, lo, hi, fs in out:  # every part gets the same result
        assert s.tolist() == _wrapping_sum(ints).tolist()
        assert lo.tolist() == ints.min(axis=0).tolist()
        assert hi.tolist() == floats.max(axis=0).tolist()
        np.testing.assert_allclose(fs.numpy(), floats.sum(axis=0), rtol=1e-12)


@pytest.mark.parametrize("P", [1, 3, 8])
def test_all_to_all_against_numpy(P):
    rng = np.random.default_rng(10 + P)
    send = rng.integers(I64.min, I64.max, (P, P, 4), dtype=np.int64)
    flags = rng.random((P, P, 4)) < 0.5
    mesh = make_mesh(n_shards=P, devices=[torch.device("cpu")] * P)

    def program(p, x, f):
        got = yield all_to_all({"x": x, "f": f})
        return got

    out = run_spmd(mesh, program, [(torch.from_numpy(send[p]), torch.from_numpy(flags[p]))
                                   for p in range(P)])
    for q in range(P):  # recv[q][p] = send[p][q]
        assert np.array_equal(out[q]["x"].numpy(), send[:, q])
        assert np.array_equal(out[q]["f"].numpy(), flags[:, q])


def test_diverging_programs_raise():
    mesh = make_mesh(n_shards=2, devices=[torch.device("cpu")] * 2)

    def program(p):
        if p == 0:
            yield psum(torch.zeros(1))
        return p

    with pytest.raises(ExecutionError, match="diverged"):
        run_spmd(mesh, program, [(), ()])


# ---------------------------------------------------------------------------
# exchange destinations and the fragment join's primitives
# ---------------------------------------------------------------------------


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(I64.min, I64.max, n, dtype=np.int64)
    k[:8] = [I64.min, I64.max, -1, 0, 1, -7, I64.min + 1, I64.max - 1]
    return k


@pytest.mark.parametrize("P", [1, 3, 8])
def test_hash_dest_equals_reference(P):
    from tidb_tpu.parallel.distsql import _hash_dest as jax_hash_dest

    k = _keys(4096, P)
    want = np.asarray(jax_hash_dest(_jnp().asarray(k), P))
    got = _hash_dest(torch.from_numpy(k), P).numpy()
    assert np.array_equal(got, want)
    assert got.min() >= 0 and got.max() < P


@pytest.mark.parametrize("n_keys", [1, 2, 3])
def test_mix_hash_and_its_destination_equal_reference(n_keys):
    from tidb_tpu.parallel.distsql import _hash_dest as jax_hash_dest
    from tidb_tpu.parallel.fragment import _mix_hash as jax_mix_hash

    bits = [_keys(2048, 100 + i) for i in range(n_keys)]
    want = np.asarray(jax_mix_hash([_jnp().asarray(b) for b in bits]))
    got = _mix_hash([torch.from_numpy(b) for b in bits])
    assert np.array_equal(got.numpy(), want)
    for P in (3, 8):
        assert np.array_equal(_hash_dest(got, P).numpy(),
                              np.asarray(jax_hash_dest(_jnp().asarray(want), P)))


def _build_side(n, seed):
    rng = np.random.default_rng(seed)
    pool = _keys(max(n // 3, 8), seed + 1)
    h = rng.choice(pool, n)
    live = rng.random(n) < 0.8
    return h, live, pool


@pytest.mark.parametrize("n", [997, 2048, 3001])
def test_sort_build_hashes_equals_reference(n):
    from tidb_tpu.ops.join_kernels import sort_build_hashes as jax_sort
    from tidb_tpu_torch.ops.join_kernels import sort_build_hashes

    h, live, _ = _build_side(n, n)
    jsh, jcvi, jorder = (np.asarray(a) for a in jax_sort(_jnp().asarray(h),
                                                           _jnp().asarray(live)))
    sh, cvi, order = sort_build_hashes(torch.from_numpy(h), torch.from_numpy(live))
    assert np.array_equal(sh.numpy(), jsh)
    assert np.array_equal(cvi.numpy(), jcvi)
    order = order.numpy()
    # ties may order differently (the reference's sort is not stable): the
    # same (hash, dead) sequence, and a permutation
    assert np.array_equal(h[order], h[jorder]) and np.array_equal(live[order], live[jorder])
    assert np.array_equal(np.sort(order), np.arange(n))
    # cvi counts exactly the live rows of each sorted prefix
    assert np.array_equal(cvi.numpy()[1:], np.cumsum(live[order]))


# each case its own (build, probe) shape: see the module docstring
PROBE_CASES = [("off", 1201, 777), ("auto", 1303, 779), ("xla", 1409, 781),
               ("pallas", 1511, 783), ("xla", 700_001, 785)]


@pytest.mark.parametrize("mode,nb,npr", PROBE_CASES,
                         ids=[f"{m}-{nb}" for m, nb, _ in PROBE_CASES])
def test_probe_primitives_equal_reference(mode, nb, npr):
    from tidb_tpu.ops import hash_probe as jhp
    from tidb_tpu.ops.join_kernels import probe_hash_ranges as jax_ranges
    from tidb_tpu.ops.join_kernels import sort_build_hashes as jax_sort
    from tidb_tpu_torch.ops import hash_probe as hp
    from tidb_tpu_torch.ops.join_kernels import probe_hash_ranges, sort_build_hashes

    jnp = _jnp()
    h, live, pool = _build_side(nb, nb)
    rng = np.random.default_rng(npr)
    probes = np.concatenate([rng.choice(pool, npr - 64), _keys(64, npr)])
    ok = rng.random(npr) < 0.9
    jsh, jcvi, _ = jax_sort(jnp.asarray(h), jnp.asarray(live))
    sh, cvi, _ = sort_build_hashes(torch.from_numpy(h), torch.from_numpy(live))
    # the pallas mode runs the reference's kernel in interpret mode on the CPU
    jmode = "xla" if mode == "pallas" else mode
    jlo, jhi = (np.asarray(a) for a in jhp.probe_for_join(jsh, jnp.asarray(probes), mode=jmode))
    lo, hi, unplaced = hp.probe_for_join(sh, torch.from_numpy(probes), mode=mode)
    assert unplaced is None or int(unplaced) == 0  # every run placed: the ranges hold
    assert np.array_equal(lo.numpy(), jlo) and np.array_equal(hi.numpy(), jhi)
    jlo2, jcnt = (np.asarray(a) for a in jax_ranges(jsh, jcvi, jnp.asarray(probes),
                                                    jnp.asarray(ok), mode=jmode))
    lo2, cnt, _unplaced = probe_hash_ranges(sh, cvi, torch.from_numpy(probes),
                                            torch.from_numpy(ok), mode=mode)
    assert np.array_equal(cnt.numpy(), jcnt)
    hit = jcnt > 0
    assert np.array_equal(lo2.numpy()[hit], jlo2[hit])
    # the count is exactly each probe key's live build rows
    want = {}
    for k, v in zip(h, live):
        want[k] = want.get(k, 0) + int(v)
    assert cnt.tolist() == [want.get(k, 0) if o else 0 for k, o in zip(probes, ok)]


# ---------------------------------------------------------------------------
# the per-shard top-k (tests/test_dist_topn.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def topn(devices8):
    rng = np.random.default_rng(23)
    rows = []
    for i in range(6000):
        g = int(rng.integers(0, 1500))  # a high-cardinality group key
        v = int(rng.integers(-1000, 1000))
        f = "NULL" if i % 97 == 0 else f"{rng.normal():.6f}"
        rows.append(f"({i}, {g}, {v}, {f})")
    js = JaxSession(chunk_capacity=2048,
                    mesh=jax_make_mesh(n_shards=4, n_dcn=2, devices=devices8))
    ps = Session(chunk_capacity=2048, mesh=make_mesh(n_shards=4, n_dcn=2, devices=CPU8))
    for s in (js, ps):
        s.execute("CREATE TABLE ft (k bigint, grp bigint, val bigint, f double)")
        for st in range(0, 6000, 500):
            s.execute("INSERT INTO ft VALUES " + ", ".join(rows[st:st + 500]))
        s.execute("CREATE TABLE dm (dk bigint, w bigint)")
        s.execute("INSERT INTO dm VALUES " + ", ".join(
            f"({i}, {i % 11})" for i in range(0, 1500)))
    return js, ps, mirror_to_sqlite(js.catalog)


def _pushed(root, cls) -> bool:
    stack = [root]
    while stack:
        e = stack.pop()
        if isinstance(e, cls) and e._prog.topn is not None:
            return True
        stack.extend(e.children)
    return False


TOPN_SQL = {
    "agg_output_desc": ("""select grp, sum(val) as s from ft group by grp
        order by s desc, grp limit 10""", True),
    "group_key_asc": ("""select grp, count(*) as c from ft group by grp
        order by grp limit 7""", True),
    "count_and_offset": ("""select grp, count(*) as c from ft group by grp
        order by c desc, grp limit 5 offset 3""", True),
    "avg_float_nulls": ("""select grp, avg(f) as a from ft group by grp
        order by a desc, grp limit 12""", True),
    "min_float_nulls": ("""select grp, min(f) as m from ft group by grp
        order by m, grp limit 12""", True),
    "through_projection": ("""select grp, sum(val) * 2 as s2, max(val) as m from ft
        group by grp order by m desc, grp limit 9""", True),
    "having_blocks": ("""select grp, sum(val) as s from ft group by grp
        having count(*) > 2 order by s desc, grp limit 10""", False),
    "computed_key_blocks": ("""select grp, sum(val) as s from ft group by grp
        order by sum(val) + grp desc, grp limit 10""", False),
    "over_join_agg": ("""select grp, sum(val * w) as s from ft join dm on grp = dk
        group by grp order by s desc, grp limit 8""", True),
}


@pytest.mark.parametrize("name", list(TOPN_SQL))
def test_dist_topn_equals_reference(topn, name):
    js, ps, oracle = topn
    sql, pushed = TOPN_SQL[name]
    jroot = jax_build(js._plan_select(jax_parse(sql)[0]), js._shard_cache)
    proot = build_dist_executor(ps._plan_select(parse(sql)[0]), ps._shard_cache)
    assert _pushed(jroot, JaxDistFragmentExec) == pushed
    assert _pushed(proot, DistFragmentExec) == pushed
    got = ps.query(sql)
    ok, msg = rows_equal(got, oracle.execute(sql).fetchall(), ordered=True)
    assert ok, msg
    same_rows(got, js.query(sql), ordered=True)


def test_explain_marks_topn_pushdown(topn):
    _js, ps, _ = topn
    rows = [r[0] for r in ps.query("explain select grp, sum(val) s from ft group by grp "
                                   "order by s desc limit 10")]
    assert any("TopN" in r and "partial_topn:device" in r for r in rows), rows


# ---------------------------------------------------------------------------
# TPC-H on the 8-part mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch8(devices8):
    js = JaxSession(chunk_capacity=4096,
                    mesh=jax_make_mesh(n_shards=4, n_dcn=2, devices=devices8))
    jax_load_tpch(js.catalog, sf=0.01)
    ps = Session(chunk_capacity=4096, mesh=make_mesh(n_shards=4, n_dcn=2, devices=CPU8))
    for name in TABLES:
        _export_into(ps, js.catalog.table("test", name), name)
    return js, ps, index_tpch_oracle(mirror_to_sqlite(js.catalog))


def _tree(e, depth=0):
    out = [(depth, type(e).__name__)]
    for c in e.children:
        out += _tree(c, depth + 1)
    return out


QUERIES = sorted(Q, key=lambda q: int(q[1:]))


@pytest.mark.parametrize("q", QUERIES)
def test_routing_equals_reference(tpch8, q):
    js, ps, _ = tpch8
    want = _tree(jax_build(js._plan_select(jax_parse(Q[q][0])[0]), js._shard_cache))
    got = _tree(build_dist_executor(ps._plan_select(parse(Q[q][0])[0]), ps._shard_cache))
    assert got == want


@pytest.mark.parametrize("q", QUERIES)
def test_tpch_on_the_mesh_equals_sqlite(tpch8, q):
    _js, ps, oracle = tpch8
    sql, oracle_sql = Q[q][0], Q[q][1] or Q[q][0]
    got = ps.query(sql)
    ok, msg = rows_equal(got, oracle.execute(oracle_sql).fetchall(),
                         ordered="order by" in sql.lower())
    assert ok, f"{q}: {msg}"


# ---------------------------------------------------------------------------
# the server and the CLI
# ---------------------------------------------------------------------------


def _text(rows):
    return [tuple(None if v is None else str(v) for v in r) for r in rows]


def test_server_with_a_mesh_equals_in_process(tpch8):
    from tidb_tpu_torch.server.client import Client
    from tidb_tpu_torch.server.server import Server

    _js, ps, _ = tpch8
    srv = Server(catalog=ps.catalog.base, port=0, status_port=None, mesh=ps.mesh)
    srv.start()
    try:
        assert srv.device == torch.device("cpu")
        c = Client(port=srv.port)
        for sql in (Q["q6"][0], Q["q3"][0],
                    "select l_returnflag, count(*), sum(l_quantity) from lineitem "
                    "group by l_returnflag order by l_returnflag"):
            _names, rows = c.query(sql)
            assert rows == _text(ps.query(sql)), sql
        c.close()
    finally:
        srv.shutdown(drain=True)


def test_cli_mesh_auto_on_the_cpu():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch", "--port", "0", "--status-port", "-1",
         "--device", "cpu", "--mesh", "auto"],
        stderr=subprocess.PIPE, text=True, cwd=_REPO, env=env)
    try:
        port, mesh_line = None, None
        t0 = time.time()
        while time.time() - t0 < 60:
            line = proc.stderr.readline()
            if line.startswith("# mesh "):
                mesh_line = line
            if "listening on" in line:
                port = int(line.rsplit(":", 1)[1])
                break
        assert port, "server did not report a listening port"
        assert mesh_line and "dcn=1, shard=1" in mesh_line and "cpu" in mesh_line
        from tidb_tpu_torch.server.client import Client

        c = Client(port=port)
        c.execute("CREATE TABLE x (a bigint, g bigint)")
        c.execute("INSERT INTO x VALUES (1, 0), (2, 0), (5, 1)")
        assert c.query("select g, sum(a) from x group by g order by g")[1] == \
            [("0", "3"), ("1", "5")]
        c.close()
        proc.send_signal(2)  # SIGINT drains and exits 0
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_a_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(ExecutionError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(ExecutionError, match="no CUDA device"):
        Session(mesh=Mesh([[torch.device("cuda", 0)]]))


def test_schema_change_drops_the_shardings():
    """A DDL (a schema_version move) drops every shard cache's shardings,
    as it clears the device buffer cache: a dropped table's device copies
    never outlive it."""
    s = Session(mesh=make_mesh(n_shards=2, devices=[torch.device("cpu")] * 2))
    s.execute("create table sc (k bigint, v bigint)")
    s.execute("insert into sc values (1, 2), (3, 4), (5, 6)")
    assert s.query("select count(*), sum(v) from sc") == [(3, 12)]
    assert len(s._shard_cache) == 1
    s.execute("create table other (a bigint)")
    assert len(s._shard_cache) == 0
    assert s.query("select count(*), sum(v) from sc") == [(3, 12)]


def test_a_closed_connection_frees_its_mesh_session():
    """Each connection of a mesh server stages its own shardings; once the
    connection closes, nothing of the server (its scheduler's idle
    workers included) may keep that Session and its shardings alive."""
    import gc

    from tidb_tpu_torch.parallel import executor as pex
    from tidb_tpu_torch.server.client import Client
    from tidb_tpu_torch.server.server import Server

    mesh = make_mesh(n_shards=2, devices=[torch.device("cpu")] * 2)
    s = Session(mesh=mesh)
    s.execute("create table fc (k bigint, v bigint)")
    s.execute("insert into fc values (1, 2), (3, 4), (5, 6)")
    srv = Server(catalog=s.catalog.base, port=0, status_port=None, mesh=mesh)
    srv.start()
    try:
        conns = [Client(port=srv.port) for _ in range(4)]
        for c in conns:
            assert c.query("select count(*), sum(v) from fc")[1] == [("3", "12")]
        # the in-process session's cache and the four connections'
        assert len([c for c in pex._CACHES if c.mesh is mesh]) == 5
        for c in conns:
            c.close()
        del conns, c
        t0 = time.time()
        while time.time() - t0 < 10:
            gc.collect()
            if len([c for c in pex._CACHES if c.mesh is mesh]) == 1:
                break
            time.sleep(0.1)
        assert [len(c) for c in pex._CACHES if c.mesh is mesh] == [len(s._shard_cache)]
    finally:
        srv.shutdown(drain=True)


def test_shutdown_ends_every_connection_thread():
    """shutdown() wakes and joins connections still open: no connection
    thread (nor the freeing of its mesh Session) outlives the server, as
    `python -m tidb_tpu_torch` exits right after it."""
    import gc
    import threading

    from tidb_tpu_torch.parallel import executor as pex
    from tidb_tpu_torch.server.client import Client
    from tidb_tpu_torch.server.server import Server

    mesh = make_mesh(n_shards=2, devices=[torch.device("cpu")] * 2)
    s = Session(mesh=mesh)
    s.execute("create table sd (k bigint, v bigint)")
    s.execute("insert into sd values (1, 2), (3, 4)")
    srv = Server(catalog=s.catalog.base, port=0, status_port=None, mesh=mesh)
    srv.start()
    conns = [Client(port=srv.port) for _ in range(3)]
    for c in conns:
        assert c.query("select sum(v) from sd")[1] == [("6",)]
    conns[0].close()
    srv.shutdown(drain=True)
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("server-conn-") and t.is_alive()]
    gc.collect()
    assert [len(c) for c in pex._CACHES if c.mesh is mesh] == [len(s._shard_cache)]
    for c in conns[1:]:
        with pytest.raises(Exception):
            c.query("select 1")
