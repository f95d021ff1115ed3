"""Threaded MySQL-protocol server over Session (a copy of
tidb_tpu/server/server.py; ref: server/server.go Server.Run +
clientConn.Run: accept, handshake, command dispatch loop).

One Session per connection, all sharing one Catalog — the same shape as
the reference's one-process-many-connections SQL node. Every session
runs on the server's `device`: the CUDA card unless the caller asks for
the CPU. With a `mesh` (parallel/mesh.py), every connection's Session
runs its reads on that mesh, and `device` defaults to the mesh's first
device. `start()` brings the card up on the calling thread (CUDA
context and both kernel libraries built by nvcc) before it accepts a
connection, so the first statement never waits on a build, and raises
when there is no card.

Connection threads do protocol I/O only; statements execute on the
serving tier's bounded worker pool (tidb_tpu_torch/serving — admission
control, typed busy/timeout rejections, cross-session micro-batching of
plan-cache-hit point reads). The accept loop itself is capped by
tidb_max_connections: over-limit handshakes get MySQL error 1040
instead of an unbounded daemon thread.

KILL runs on the connection thread, not on the pool: it only flips the
victim session's flags, and a pool worker would wait behind the
victim's catalog statement lock until the statement it is meant to
stop had finished.
"""

from __future__ import annotations

import os
import socket
import threading
import traceback
from typing import Dict, Optional

from tidb_tpu_torch.errors import TiDBTPUError as TidbError
from tidb_tpu_torch.server import protocol as P
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.session.sysvars import SysVarStore
from tidb_tpu_torch.storage.catalog import Catalog
from tidb_tpu_torch.utils import tracing
from tidb_tpu_torch.utils.device import resolve_device

__all__ = ["Server"]

ER_CON_COUNT_ERROR = 1040  # MySQL "Too many connections"

COM_QUIT = 0x01
COM_INIT_DB = 0x02
COM_QUERY = 0x03
COM_FIELD_LIST = 0x04
COM_PING = 0x0E
COM_STMT_PREPARE = 0x16
COM_STMT_EXECUTE = 0x17
COM_STMT_CLOSE = 0x19
COM_STMT_RESET = 0x1A


class Server:
    def __init__(self, catalog: Optional[Catalog] = None, host: str = "127.0.0.1",
                 port: int = 4000, status_port: Optional[int] = None,
                 device=None, mesh=None):
        self.catalog = catalog or Catalog()
        self.host = host
        self.port = port
        # every connection's Session runs here (None = the CUDA card, or
        # the mesh's first device) and, with a mesh, reads on the mesh
        self.mesh = mesh
        self.device = mesh.device_of(0) if device is None and mesh is not None else device
        self.status_port = status_port  # None disables the HTTP status tier
        self._status_server = None
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conn_id = 0
        self._running = False
        # server-scope view of the GLOBAL sysvars (tidb_max_connections,
        # scheduler knobs) — the accept loop has no session of its own
        self.sysvars = SysVarStore(self.catalog.global_vars)
        # the serving tier: bounded execution + admission control +
        # micro-batching (created in start(), drained in shutdown())
        self.scheduler = None
        self._active_conns = 0
        self._conn_lock = threading.Lock()
        # live connection threads and their sockets: shutdown() wakes and
        # joins them, so no connection (nor the freeing of its Session's
        # device tensors) outlives the server into interpreter exit
        self._conns: Dict[threading.Thread, socket.socket] = {}

    # ------------------------------------------------------------------

    def start(self) -> None:
        # bring the device up NOW, on the caller's thread, as the
        # reference initializes its backend before accepting: no card
        # (and the CPU not asked for) raises here instead of serving
        self.device = _bring_up(self.device)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self.port = self._sock.getsockname()[1]  # resolves port 0
        self._sock.listen(16)
        self._running = True
        if self.status_port is not None:
            from tidb_tpu_torch.server.status import StatusServer
            from tidb_tpu_torch.session.sysvars import SYSVARS

            self._status_server = StatusServer(
                self.catalog, host=self.host, port=self.status_port,
                version=str(SYSVARS["version"].default))
            self._status_server.start()
            self.status_port = self._status_server.port
        # each server instance runs a DDL worker; the elected owner
        # executes queued DDL for every instance (ref: owner/ + ddl/)
        from tidb_tpu_torch.owner import DDLWorker

        self._ddl_worker = DDLWorker(self.catalog, f"server-{id(self):x}",
                                     device=self.device)
        self._ddl_worker.start()
        from tidb_tpu_torch.serving import StatementScheduler

        self.scheduler = StatementScheduler(self.catalog, device=self.device)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="server-accept")
        self._accept_thread.start()

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Graceful stop: close the accept socket (no new connections),
        drain the scheduler pool deterministically (queued statements
        finish — or are rejected typed with drain=False — and workers
        join), then stop the auxiliary tiers."""
        self._running = False
        if self._sock is not None:
            try:
                # shutdown() first: close() alone leaves a thread blocked
                # in accept() on Linux; this wakes it so it can be joined
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if self._accept_thread is not None:
            self._accept_thread.join(timeout)
            self._accept_thread = None
        if self.scheduler is not None:
            self.scheduler.shutdown(drain=drain, timeout=timeout)
        with self._conn_lock:
            conns = list(self._conns.items())
        for _t, conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)  # wakes its blocked read
            except OSError:
                pass
        for t, _conn in conns:
            t.join(timeout)
        if getattr(self, "_ddl_worker", None) is not None:
            self._ddl_worker.stop()
            self._ddl_worker = None
        if self._status_server is not None:
            self._status_server.stop()
            self._status_server = None

    def stop(self) -> None:
        self.shutdown(drain=True)

    def serve_forever(self) -> None:
        self.start()
        try:
            self._accept_thread.join()
        except KeyboardInterrupt:
            self.stop()

    # ------------------------------------------------------------------

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            # connection cap (ref: server.go's checkConnectionCount):
            # over-limit clients get MySQL 1040 as the FIRST packet and
            # the socket closes — no daemon thread, no session
            limit = int(self.sysvars.get("tidb_max_connections"))
            with self._conn_lock:
                if limit and self._active_conns >= limit:
                    over = True
                else:
                    over = False
                    self._active_conns += 1
            if over:
                try:
                    P.write_packet(conn, 0, P.err_packet(
                        ER_CON_COUNT_ERROR, "Too many connections", "08004"))
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            self._conn_id += 1
            t = threading.Thread(
                target=self._serve_conn, args=(conn, self._conn_id), daemon=True,
                name=f"server-conn-{self._conn_id}")
            with self._conn_lock:
                # a finished connection's entry goes once its thread ended
                # (its Session freed); shutdown() joins the rest
                for done in [d for d in self._conns if not d.is_alive()]:
                    del self._conns[done]
                self._conns[t] = conn
            t.start()

    def _serve_conn(self, conn: socket.socket, conn_id: int) -> None:
        from tidb_tpu_torch.utils.metrics import CONN_GAUGE

        CONN_GAUGE.inc()
        sess = None
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sess = Session(catalog=self.catalog, device=self.device, mesh=self.mesh)
            if self.scheduler is not None:
                self.scheduler.attach_session(sess)
            salt = os.urandom(20).replace(b"\x00", b"\x01")
            version = str(sess.sysvars.get("version"))
            P.write_packet(conn, 0, P.handshake_v10(conn_id, version, salt))
            _seq, payload = P.read_packet(conn)
            hello = P.parse_handshake_response(payload)
            # auth plugins first (ref: plugin/ authentication hook);
            # builtin mysql_native_password scramble otherwise
            verdict = self.catalog.plugins.authenticate(
                hello["user"], hello["auth"], salt)
            if verdict is None:
                verdict = self.catalog.verify_user(hello["user"], hello["auth"], salt)
            if not verdict:
                P.write_packet(conn, 2, P.err_packet(
                    1045, f"Access denied for user '{hello['user']}'", "28000"))
                return
            sess.user = hello["user"]
            if hello["db"]:
                try:
                    sess.execute(f"use {hello['db']}")
                except TidbError:
                    pass
            P.write_packet(conn, 2, P.ok_packet())
            self._command_loop(conn, sess)
        except (ConnectionError, OSError):
            pass
        except Exception:
            traceback.print_exc()
        finally:
            CONN_GAUGE.dec()
            with self._conn_lock:
                self._active_conns -= 1
            try:
                # connection end: the session's TEMPORARY tables vanish
                if sess is not None:
                    sess.catalog.drop_temp_tables()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
            try:
                conn.close()
            except OSError:
                pass

    def _command_loop(self, conn: socket.socket, sess: Session) -> None:
        while True:
            _seq, payload = P.read_packet(conn)
            if not payload:
                return
            cmd, body = payload[0], payload[1:]
            if cmd == COM_QUIT:
                return
            if cmd == COM_PING:
                P.write_packet(conn, 1, P.ok_packet())
                continue
            if cmd == COM_INIT_DB:
                self._run_sql(conn, sess, f"use {body.decode()}")
                continue
            if cmd == COM_QUERY:
                self._run_sql(conn, sess, body.decode("utf-8"))
                continue
            if cmd == COM_FIELD_LIST:
                P.write_packet(conn, 1, P.eof_packet())
                continue
            if cmd == COM_STMT_PREPARE:
                self._stmt_prepare(conn, sess, body.decode("utf-8"))
                continue
            if cmd == COM_STMT_EXECUTE:
                self._stmt_execute(conn, sess, body)
                continue
            if cmd == COM_STMT_CLOSE:
                if len(body) >= 4:
                    sess.close_prepared(int.from_bytes(body[:4], "little"))
                continue  # no response, per protocol
            if cmd == COM_STMT_RESET:
                P.write_packet(conn, 1, P.ok_packet())
                continue
            P.write_packet(conn, 1, P.err_packet(1047, f"unknown command {cmd:#x}"))

    def _stmt_prepare(self, conn, sess: Session, sql: str) -> None:
        try:
            stmt_id, n_params = sess.prepare(sql)
        except TidbError as e:
            P.write_packet(conn, 1, P.err_packet(getattr(e, "code", 1105), str(e)))
            return
        # num_columns=0: clients read the actual column defs from the
        # execute response's result-set header
        seq = P.write_packet(conn, 1, P.stmt_prepare_ok(stmt_id, 0, n_params))
        for i in range(n_params):
            seq = P.write_packet(conn, seq, P.column_def41(f"?{i}", P.MYSQL_TYPE_VAR_STRING))
        if n_params:
            P.write_packet(conn, seq, P.eof_packet())

    def _stmt_execute(self, conn, sess: Session, body: bytes) -> None:
        try:
            stmt_id = int.from_bytes(body[:4], "little")
            ent = sess._prepared.get(stmt_id)
            if ent is None:
                P.write_packet(conn, 1, P.err_packet(1243, f"unknown statement {stmt_id}"))
                return
            n_params = ent[1]
            # param types arrive only on the first execute; cache them
            # per statement for re-executions (per protocol)
            if not hasattr(sess, "_stmt_types"):
                sess._stmt_types = {}
            stmt_id, params, types = P.parse_stmt_execute(
                body, n_params, sess._stmt_types.get(stmt_id))
            sess._stmt_types[stmt_id] = types
            # serving tier: admission control + micro-batching; the
            # worker takes the catalog statement lock (this thread only
            # parks on the result)
            rs = self.scheduler.submit_prepared(sess, stmt_id, params)
        except TidbError as e:
            with self._writing(sess):
                P.write_packet(conn, 1, P.err_packet(getattr(e, "code", 1105), str(e)))
            return
        except Exception as e:  # engine bug — surface, don't kill the conn
            traceback.print_exc()
            with self._writing(sess):
                P.write_packet(conn, 1, P.err_packet(1105, f"internal error: {e}"))
            return
        with self._writing(sess):
            status = self._status(sess)
            if rs is None:
                P.write_packet(conn, 1, P.ok_packet(status=status))
                return
            types = rs.types or [None] * len(rs.names)
            seq = P.write_packet(conn, 1, P.lenc_int(len(rs.names)))
            for name, kind in zip(rs.names, types):
                seq = P.write_packet(conn, seq, P.column_def41(name, P.binary_kind(kind)))
            seq = P.write_packet(conn, seq, P.eof_packet(status=status))
            for row in rs.rows:
                seq = P.write_packet(conn, seq, P.binary_row(list(row), types))
            P.write_packet(conn, seq, P.eof_packet(status=status))

    @staticmethod
    def _writing(sess: Session):
        """Writing a statement's response: the server.write span of the
        trace the scheduler opened for it (none for a statement the
        connection thread ran itself)."""
        tr, sess._served_trace = sess._served_trace, None
        return tracing.resume(tr, "server.write")

    @staticmethod
    def _status(sess: Session) -> int:
        status = 0
        if sess.sysvars.get("autocommit"):
            status |= P.SERVER_STATUS_AUTOCOMMIT
        if sess.txn is not None:
            status |= P.SERVER_STATUS_IN_TRANS
        return status

    def _run_sql(self, conn: socket.socket, sess: Session, sql: str) -> None:
        try:
            kill = _kill_stmt(sql)
            if kill is not None:
                # flags only, outside the statement envelope: never
                # queued behind the victim's lock
                sess.kill(kill)
                rs = None
            else:
                # serving tier: bounded workers execute (and serialize
                # on the catalog lock there); this thread does protocol
                # I/O only
                rs = self.scheduler.submit_query(sess, sql)
        except TidbError as e:
            with self._writing(sess):
                P.write_packet(conn, 1, P.err_packet(getattr(e, "code", 1105), str(e)))
            return
        except Exception as e:  # engine bug — surface, don't kill the conn
            traceback.print_exc()
            with self._writing(sess):
                P.write_packet(conn, 1, P.err_packet(1105, f"internal error: {e}"))
            return
        with self._writing(sess):
            status = self._status(sess)
            if rs is None:
                P.write_packet(conn, 1, P.ok_packet(status=status))
                return
            types = rs.types or [None] * len(rs.names)
            seq = P.write_packet(conn, 1, P.lenc_int(len(rs.names)))
            for name, kind in zip(rs.names, types):
                seq = P.write_packet(conn, seq, P.column_def41(name, P.mysql_type_of(kind)))
            seq = P.write_packet(conn, seq, P.eof_packet(status=status))
            for row in rs.rows:
                seq = P.write_packet(conn, seq, P.text_row(list(row)))
            P.write_packet(conn, seq, P.eof_packet(status=status))


def _kill_stmt(sql: str):
    """The KillStmt when `sql` is a lone KILL statement (the one
    statement the connection thread runs itself), else None."""
    head = sql.lstrip()[:5].lower()
    if head != "kill" and not head.startswith("kill "):
        return None
    from tidb_tpu_torch.parser import ast as A
    from tidb_tpu_torch.parser import parse

    try:
        stmts = parse(sql)
    except Exception:  # noqa: BLE001 — the pool path raises the parse error
        return None
    if len(stmts) == 1 and isinstance(stmts[0], A.KillStmt):
        return stmts[0]
    return None


def _bring_up(device):
    """Resolve the server's device and make it ready on this thread: on
    the card, the CUDA context and both kernel libraries (one nvcc per
    source, started together), so no statement waits on either."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    import torch

    from tidb_tpu_torch.ops import hash_probe, nvcc_build, segment_sum

    torch.cuda.init()
    torch.zeros(1, device=dev)
    nvcc_build.build_libraries([
        os.path.join(nvcc_build.CSRC, m.SOURCE) for m in (segment_sum, hash_probe)])
    segment_sum.load_kernels()
    hash_probe.load_kernels()
    return dev
