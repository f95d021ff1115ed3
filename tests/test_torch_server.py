"""The port's MySQL-protocol server (tidb_tpu_torch/server, sessions on the
CPU) beside the reference's, byte for byte.

Both servers run on port 0 over equal data: the small tables of
tests/test_server_ext.py are created by the same SQL, and the TPC-H
tables at SF0.01 that the reference's generator made are carried into
the port with `_export_into`. Every case of tests/test_server.py and
tests/test_server_ext.py (the information_schema ones aside: the port has
no information_schema) and TPC-H Q1, Q3 and Q18 run on one connection to
each server. Every response's packets must be byte-equal: result sets in
the text and the binary protocol, OK and ERR packets (so equal code,
SQLSTATE and message). Of the handshake only the salt and the connection
id may differ. Authentication with and without a password is accepted
and refused alike.

Every socket has a timeout; both servers stop in the fixture's finalizer.
"""

import socket
import struct
import subprocess
import sys
import time

import pytest
import torch

from tidb_tpu.server import Server as JaxServer
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.catalog import Catalog as JaxCatalog
from tidb_tpu.storage.tpch import load_tpch as jax_load_tpch
from tidb_tpu_torch.server import Server
from tidb_tpu_torch.server import protocol as P
from tidb_tpu_torch.server.client import Client, ServerError
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.catalog import Catalog
from tidb_tpu_torch.storage.tpch_queries import Q

from test_torch_session import _REPO, _export_into, reference_witness_paused  # noqa: F401

torch.set_num_threads(1)

_SETUP = (
    "set global tidb_tpu_compaction = 0",
    "CREATE TABLE t (id bigint, name varchar(20), f double)",
    "INSERT INTO t VALUES (1, 'a', 1.5), (2, 'b', NULL), (3, NULL, 2.5)",
    "CREATE INDEX it ON t (id)",
)
_TPCH = ("lineitem", "orders", "customer", "nation", "region", "supplier")


@pytest.fixture(scope="module")
def servers():
    jcat = JaxCatalog()
    js = JaxSession(catalog=jcat)
    pcat = Catalog()
    ps = Session(catalog=pcat, device="cpu")
    for cat in (jcat, pcat):
        cat.create_user("alice", "secret")
    for sql in _SETUP:
        js.execute(sql)
        ps.execute(sql)
    jax_load_tpch(jcat, sf=0.01)
    for name in _TPCH:
        _export_into(ps, jcat.table("test", name), name)
    jsrv = JaxServer(catalog=jcat, port=0)
    psrv = Server(catalog=pcat, port=0, device="cpu")
    jsrv.start()
    try:
        psrv.start()
    except BaseException:
        jsrv.stop()
        raise
    yield jsrv, psrv
    psrv.stop()
    jsrv.stop()


class _Tap:
    """A client socket that keeps every byte the server sends."""

    def __init__(self, sock):
        self.sock = sock
        self.got = bytearray()

    def recv(self, n):
        b = self.sock.recv(n)
        self.got += b
        return b

    def take(self) -> bytes:
        out, self.got = bytes(self.got), bytearray()
        return out

    def __getattr__(self, name):
        return getattr(self.sock, name)


def _tapped(port, **kw):
    c = Client(port=port, **kw)
    c.sock = _Tap(c.sock)
    return c


def _do(c, op):
    """Run one operation; return the server's raw response bytes (and
    the error code when it refused)."""
    kind, arg = op[0], op[1:]
    code = None
    try:
        if kind == "query":
            c.query(arg[0])
        elif kind == "ping":
            c.ping()
        elif kind == "prepare":
            c.last_sid = c.prepare(arg[0])[0]
        elif kind == "exec":
            c.execute_prepared(c.last_sid if arg[0] is None else arg[0],
                               arg[1])
        elif kind == "close":
            c.close_prepared(c.last_sid)
            c.ping()  # COM_STMT_CLOSE has no response; ping after it
        elif kind == "raw_exec":  # a re-execution without rebinding types
            body = (struct.pack("<I", c.last_sid) + b"\x00"
                    + struct.pack("<I", 1) + b"\x00" + b"\x00"
                    + struct.pack("<q", arg[0]))
            P.write_packet(c.sock, 0, b"\x17" + body)
            c._read_binary_resultset()
        elif kind == "init_db":
            P.write_packet(c.sock, 0, b"\x02" + arg[0].encode())
            P.read_packet(c.sock)
        elif kind == "field_list":
            P.write_packet(c.sock, 0, b"\x04" + arg[0].encode() + b"\x00")
            P.read_packet(c.sock)
        elif kind == "reset":
            P.write_packet(c.sock, 0, b"\x1a" + struct.pack("<I", c.last_sid))
            P.read_packet(c.sock)
    except ServerError as e:
        code = e.code
    return c.sock.take(), code


CASES = {
    # tests/test_server.py
    "ping": [("ping",)],
    "ddl_dml_query": [
        ("query", "drop table if exists srv_t"),
        ("query", "create table srv_t (a bigint, b varchar(16), c decimal(10,2))"),
        ("query", "insert into srv_t values (1, 'x', '1.50'), (2, 'y', '2.25'),"
                  " (3, null, null)"),
        ("query", "select a, b, c from srv_t order by a")],
    "aggregate": [
        ("query", "drop table if exists srv_g"),
        ("query", "create table srv_g (k varchar(8), v bigint)"),
        ("query", "insert into srv_g values ('a', 1), ('a', 2), ('b', 10)"),
        ("query", "select k, count(*), sum(v) from srv_g group by k order by k")],
    "error_keeps_connection": [
        ("query", "select * from no_such_table"), ("ping",),
        ("query", "select 1 + 1")],
    "version": [("query", "select @@version")],
    "parse_error": [("query", "selec 1")],
    "commands": [("init_db", "test"), ("init_db", "no_such_db"),
                 ("field_list", "t"), ("query", "select database()")],
    # tests/test_server_ext.py
    "prepared_params": [
        ("prepare", "select id, name, f from t where id > ? order by id"),
        ("exec", None, (1,)), ("exec", None, (2,)), ("close",)],
    "prepared_string_float": [
        ("prepare", "select id from t where name = ? or f = ? order by id"),
        ("exec", None, ("a", 2.5))],
    "prepared_insert_null": [
        ("query", "CREATE TABLE p (a bigint, b varchar(10))"),
        ("prepare", "insert into p values (?, ?)"),
        ("exec", None, (10, "x")), ("exec", None, (11, None)),
        ("query", "select a, b from p order by a"), ("query", "DROP TABLE p")],
    "prepared_reexec_cached_types": [
        ("prepare", "select id from t where id > ? order by id"),
        ("exec", None, (1,)), ("raw_exec", 2), ("reset",)],
    "prepared_unknown_id": [("exec", 99999, ())],
    "prepared_tpch_binary_rows": [
        ("prepare", "select o_orderkey, o_custkey, o_totalprice, o_orderdate,"
                    " o_orderstatus, o_comment from orders where o_orderkey = ?"),
        ("exec", None, (1,)), ("exec", None, (7,)), ("exec", None, (2,))],
    "users_sql": [
        ("query", "CREATE USER 'bob' IDENTIFIED BY 'pw'"),
        ("query", "CREATE USER 'bob' IDENTIFIED BY 'pw'"),
        ("query", "GRANT SELECT ON test.t TO 'bob'"),
        ("query", "SHOW GRANTS FOR 'bob'"),
        ("query", "DROP USER 'bob'"), ("query", "DROP USER 'bob'")],
    # TPC-H at SF0.01 by COM_QUERY
    "tpch_q1": [("query", Q["q1"][0])],
    "tpch_q3": [("query", Q["q3"][0])],
    "tpch_q18": [("query", Q["q18"][0])],
}


@pytest.mark.parametrize("case", list(CASES))
def test_packets_byte_equal(servers, case):
    jsrv, psrv = servers
    cj, cp = _tapped(jsrv.port), _tapped(psrv.port)
    cj.sock.take(), cp.sock.take()
    try:
        for op in CASES[case]:
            want, got = _do(cj, op), _do(cp, op)
            assert got == want, (case, op)
    finally:
        cj.close()
        cp.close()


def _handshake(port):
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        _seq, payload = P.read_packet(s)
    ver_end = payload.index(b"\x00", 1)
    masked = bytearray(payload)
    masked[ver_end + 1:ver_end + 5] = b"\x00" * 4       # connection id
    masked[ver_end + 5:ver_end + 13] = b"\x00" * 8      # salt, part 1
    tail = ver_end + 13 + 1 + 2 + 1 + 2 + 2 + 1 + 10
    masked[tail:tail + 12] = b"\x00" * 12               # salt, part 2
    return bytes(masked), payload


def test_handshake_equal_but_salt_and_connection_id(servers):
    jsrv, psrv = servers
    (want, _), (got, _) = _handshake(jsrv.port), _handshake(psrv.port)
    assert got == want


@pytest.mark.parametrize("user,password,ok", [
    ("root", "", True), ("alice", "secret", True), ("alice", "wrong", False),
    ("alice", "", False), ("nobody", "x", False)])
def test_auth_accepted_and_refused_alike(servers, user, password, ok):
    outcome = []
    for srv in servers:
        try:
            c = Client(port=srv.port, user=user, password=password)
        except ServerError as e:
            outcome.append(("refused", e.code, e.message))
        else:
            outcome.append(("ok", c.query("select 1 + 1")))
            c.close()
    assert outcome[0] == outcome[1]
    assert outcome[1][0] == ("ok" if ok else "refused")
    assert ok or outcome[1][1] == 1045


def test_two_connections_share_catalog_and_isolate_txns(servers):
    seen = []
    for srv in servers:
        c1, c2 = Client(port=srv.port), Client(port=srv.port)
        try:
            c1.execute("drop table if exists srv_x")
            c1.execute("create table srv_x (x bigint)")
            c1.execute("insert into srv_x values (1)")
            c1.execute("begin")
            c1.execute("update srv_x set x = 2")
            before = c2.query("select x from srv_x")
            c1.execute("commit")
            seen.append((before, c2.query("select x from srv_x")))
        finally:
            c1.close()
            c2.close()
    assert seen[0] == seen[1] == (
        (["x"], [("1",)]), (["x"], [("2",)]))


def test_wire_prepared_coalesces_across_connections(servers):
    """Binary-protocol executions from separate connections ride the
    batcher in both servers and return the same rows."""
    outs = []
    for srv in servers:
        boot = Client(port=srv.port)
        boot.execute("set global tidb_tpu_batch_window_us = 100000")
        boot.execute("set global tidb_tpu_max_batch_size = 4")
        clients = [Client(port=srv.port) for _ in range(4)]
        try:
            sids = [c.prepare("select o_totalprice, o_orderstatus from "
                              "orders where o_orderkey = ?")[0]
                    for c in clients]
            res = [[] for _ in clients]

            def run(ci):
                for i in range(6):
                    res[ci].append(clients[ci].execute_prepared(
                        sids[ci], [1 + ci * 32 + i * 7])[1])

            import threading

            ts = [threading.Thread(target=run, args=(ci,))
                  for ci in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(30)
            assert not any(t.is_alive() for t in ts)
            outs.append(res)
        finally:
            boot.execute("set global tidb_tpu_batch_window_us = 250")
            for c in clients + [boot]:
                c.close()
    assert outs[0] == outs[1]


def test_max_connections_1040_at_handshake(servers):
    codes = []
    for srv in servers:
        c1 = Client(port=srv.port)
        before = srv._active_conns
        c1.execute(f"set global tidb_max_connections = {before}")
        try:
            with pytest.raises(ServerError) as ei:
                Client(port=srv.port)
            codes.append((ei.value.code, ei.value.message))
        finally:
            c1.execute("set global tidb_max_connections = 0")
            c1.close()
    assert codes[0] == codes[1] == (1040, "Too many connections")


def test_kill_over_the_wire_interrupts():
    """KILL QUERY from a second connection stops a running statement
    with 1317 and leaves the victim's connection usable. The port runs
    KILL on the connection thread; the reference queues it on its pool
    behind the victim's catalog statement lock, so its KILL waits for
    the statement to end and stops nothing (ROADMAP Queue C)."""
    import threading

    import numpy as np

    srv = Server(port=0, device="cpu")
    srv.start()
    c, k = Client(port=srv.port), Client(port=srv.port)
    try:
        c.execute("create table big (a bigint)")
        srv.catalog.table("test", "big").insert_columns(
            {"a": np.arange(3_000_000, dtype=np.int64)})
        cid = int(c.query("select connection_id()")[1][0][0])
        box = {}

        def victim():
            try:
                box["rows"] = c.query(
                    "select count(*) from big b1 join big b2 on b1.a = b2.a")
            except ServerError as e:
                box["err"] = e.code

        th = threading.Thread(target=victim)
        th.start()
        deadline = time.time() + 30
        # the victim's statement is running (read in process: SHOW
        # PROCESSLIST itself queues behind the victim's statement lock)
        while time.time() < deadline:
            if srv.catalog.processes[cid]._current_sql is not None:
                break
            time.sleep(0.005)
        time.sleep(0.05)
        k.execute(f"kill query {cid}")
        th.join(60)
        assert not th.is_alive()
        assert box == {"err": 1317}
        assert c.query("select 1")[1] == [("1",)]  # one-shot
    finally:
        c.close()
        k.close()
        srv.stop()


def _commit_held_at_the_commit_point(send_kill):
    """An autocommit UPDATE held at `2pc.after_commit_point` (decided,
    secondaries not yet applied) while, with `send_kill`, another
    connection sends KILL QUERY of an idle third one. Returns what the
    committer, the table and the catalog show afterwards."""
    import threading

    from tidb_tpu_torch.utils import failpoint as fp

    srv = Server(port=0, device="cpu")
    srv.start()
    w, k, idle = (Client(port=srv.port) for _ in range(3))
    try:
        w.execute("create table t (id bigint primary key, v bigint)")
        w.execute("insert into t values (1, 10), (2, 20)")
        idle_id = int(idle.query("select connection_id()")[1][0][0])
        held, release = threading.Event(), threading.Event()
        box = {}

        def hold():
            held.set()
            assert release.wait(30)

        def writer():
            try:
                w.execute("update t set v = v + 1 where id = 1")
                box["ok"] = True
            except ServerError as e:
                box["err"] = e.code

        with fp.failpoint("2pc.after_commit_point", action=hold, times=1):
            th = threading.Thread(target=writer)
            th.start()
            assert held.wait(30)
            box["stale_while_held"] = srv.catalog.has_stale_txns()
            if send_kill:
                # answered while the commit still holds the catalog lock
                k.execute(f"kill query {idle_id}")
                box["stale_after_kill"] = srv.catalog.has_stale_txns()
            release.set()
            th.join(30)
        assert not th.is_alive()
        tb = srv.catalog.table("test", "t")
        return (box.get("ok"), box["stale_while_held"],
                box.get("stale_after_kill", True),
                w.query("select id, v from t order by id")[1],
                tb.modify_count, srv.catalog.has_stale_txns())
    finally:
        for c in (w, k, idle):
            c.close()
        srv.stop()


def test_kill_during_a_commit_leaves_the_commit_alone():
    """A wire KILL runs on its connection thread without the catalog
    lock, so it must not run the statement boundary's resolve-locks:
    that would take a commit in flight on a worker for a crashed one and
    apply its secondaries a second time. With the KILL, the rows, the
    table's modify_count and the catalog's pending transactions equal a
    run without it, and the decided commit is still pending when the
    KILL has been answered."""
    with_kill = _commit_held_at_the_commit_point(True)
    without = _commit_held_at_the_commit_point(False)
    assert with_kill[0] is True and with_kill[1] is True
    assert with_kill[2] is True  # the KILL resolved nothing
    assert with_kill[3] == [("1", "11"), ("2", "20")]
    assert with_kill[3:] == without[3:]


def test_cli_boot_on_the_cpu_and_refusal_without_a_card():
    """`python -m tidb_tpu_torch --device cpu` serves the reference's
    client; without a card and without --device cpu it exits non-zero."""
    env = {**__import__("os").environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch", "--port", "0",
         "--status-port", "-1", "--device", "cpu"],
        stderr=subprocess.PIPE, text=True, cwd=_REPO, env=env)
    try:
        port = None
        t0 = time.time()
        while time.time() - t0 < 60:
            line = proc.stderr.readline()
            if "listening on" in line:
                port = int(line.rsplit(":", 1)[1])
                break
        assert port, "server did not report a listening port"
        from tidb_tpu.server.client import Client as JaxClient

        c = JaxClient(port=port)
        c.execute("CREATE TABLE x (a bigint)")
        c.execute("INSERT INTO x VALUES (42)")
        assert c.query("select a from x")[1] == [("42",)]
        c.close()
        proc.send_signal(2)  # SIGINT drains and exits 0
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    if not torch.cuda.is_available():
        r = subprocess.run(
            [sys.executable, "-m", "tidb_tpu_torch", "--port", "0",
             "--status-port", "-1"], cwd=_REPO, env=env,
            capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert "no CUDA device" in r.stderr


def test_server_start_without_a_card_raises():
    """`Server(device=None)` means the card: with none it raises at
    start() and never serves from the CPU."""
    from tidb_tpu_torch.errors import ExecutionError

    if torch.cuda.is_available():
        pytest.skip("a card is present: start() would bring it up")
    srv = Server(port=0)
    with pytest.raises(ExecutionError, match="no CUDA device"):
        srv.start()
    assert srv.scheduler is None and srv._sock is None
