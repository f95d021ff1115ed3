"""Multi-host tier: coprocessor fan-out over host RPC (ref: distsql's
per-region gRPC fan-out to TiKV coprocessors; SURVEY.md §7.6 "DCN tier +
host RPC after single-slice works").

Architecture (the reference's shape, re-mapped):

    coordinator (this process)          workers (one process per host)
    ───────────────────────────        ─────────────────────────────────
    parse + plan the query              own a row-range PARTITION of
    rewrite agg -> partial form         each table (region analogue)
    fan out partial SQL over RPC   ->   run scan+filter+partial-agg on
    merge partial states by group       their local backend (their own
    key via a final agg (MPP final      chip/mesh — the ICI tier works
    stage on the coordinator)      <-   below this one unchanged)

Partial/final split: COUNT->SUM of counts, SUM->SUM, MIN/MAX->MIN/MAX,
AVG->SUM(sum)/SUM(count). Plain SELECT ... ORDER BY ... LIMIT pushes the
TopN into every worker (local top-n) and merges on the coordinator — the
reference's coprocessor TopN pushdown. Group keys travel as decoded host
values, so workers' independent string dictionaries never reconcile.

Transport: length-prefixed messages in a RESTRICTED codec (scalars,
strings, bytes, date/time/decimal, lists/dicts, allowlisted numpy
arrays — never arbitrary objects), so a hostile peer cannot execute
code by serialization alone. An optional shared secret adds an
HMAC-SHA256 challenge handshake per connection; binding a worker to a
non-loopback interface REQUIRES the secret.

Failure handling mirrors the reference's region-error model: each
partition may have a REPLICA on another worker (its copy lives in
`<table>__part<i>`); a worker RPC failure retries the partial there
before failing the query.

This is the port's copy of tidb_tpu/parallel/dcn.py: the wire format,
the commands and the coordinator's plans are the reference's byte for
byte. A worker's partial SQL runs through a tidb_tpu_torch Session on
its torch device (the card unless `device="cpu"` is asked for), so the
segment aggregation and hash-join probe kernels run under each worker.
No torch object ever reaches the codec: result rows are plain Python
values, and a tensor is refused like any other unknown type.

Two faults of the reference are repaired here: reshard() runs its ALTER
broadcast inside a CLUSTER_GATE write window, so a concurrent 2PC that
sits between prepare and commit on some worker can no longer make the
broadcast fail (that worker refuses every foreign statement while its
prepared transaction is pending); and a retried partial's first
attempt, when it reaches the executor after the retry, no longer evicts
the retry's cursor and pins its own (Worker._partial_paged)."""

from __future__ import annotations

import datetime
import decimal
import hashlib
import hmac
import itertools
import os
import random
import re
import socket
import struct
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np

from tidb_tpu_torch.errors import (
    ExecutionError,
    QueryKilledError,
    QueryTimeoutError,
    TwoPhaseCommitIncomplete,
    UnsupportedError,
)
from tidb_tpu_torch.parallel.membership import CLUSTER_GATE, TableGates
from tidb_tpu_torch.parser import ast as A
from tidb_tpu_torch.parser import parse
from tidb_tpu_torch.parser.printer import expr_to_sql
from tidb_tpu_torch.utils import tracing
from tidb_tpu_torch.types import TypeKind
from tidb_tpu_torch.utils.failpoint import inject

__all__ = ["Worker", "Cluster", "partial_rewrite", "clusters_alive",
           "fleet_metrics_entries"]

# health-machine states, exported for tests and /cluster
UP, SUSPECT, DOWN = "up", "suspect", "down"
_STATE_CODE = {UP: 0, SUSPECT: 1, DOWN: 2}

# live coordinator registry for the status port's /cluster endpoint
_CLUSTERS: "weakref.WeakSet" = weakref.WeakSet()

_TOKEN_SEQ = itertools.count(1)


def clusters_alive() -> List["Cluster"]:
    return list(_CLUSTERS)


def fleet_metrics_entries() -> List[tuple]:
    """One cluster scrape: the coordinator's own registry (labeled
    ``coordinator``) plus every live Cluster's per-worker snapshots.
    The input shape metrics.render_cluster / cluster_rows consume —
    /metrics?scope=cluster and information_schema.cluster_metrics read
    the SAME entries, so the two surfaces can never disagree."""
    from tidb_tpu_torch.utils import metrics as _metrics

    entries: List[tuple] = [("coordinator", _metrics.snapshot(), "")]
    for cl in clusters_alive():
        try:
            entries.extend(cl.metrics_snapshots())
        except Exception as e:  # noqa: BLE001 — a cluster mid-shutdown
            entries.append((f"cluster@{id(cl):x}", None,
                            f"{type(e).__name__}: {e}"))
    return entries


def _retype_wire_error(err: str, detail: str) -> ExecutionError:
    """One rule for every hop: a remote error travels the wire as
    `ClassName: message`, and kill/deadline must stay typed end to end
    whether the hop is coordinator->worker (Cluster._remote_error) or
    worker->peer (the shuffle_stage re-dispatch). A second copy of this
    prefix match would silently drift the next typed class."""
    if err.startswith("QueryTimeoutError:"):
        return QueryTimeoutError(detail)
    if err.startswith("QueryKilledError:"):
        return QueryKilledError(detail)
    return ExecutionError(detail)


class DcnCodecError(ExecutionError):
    """Malformed wire frame: the connection is desynced and must die."""


class DcnRpcTimeoutError(ConnectionError):
    """An RPC outlived its socket deadline. Distinguished from a broken
    link because the worker is PROBABLY STILL EXECUTING the request —
    idempotent retry must not re-send (it would double the worker's
    load and collide with the first attempt's cancel token); the caller
    falls to replica failover instead."""

_LEN = struct.Struct(">I")
_D = struct.Struct(">d")

# ---------------------------------------------------------------------------
# restricted wire codec (replaces pickle: data only, no code)
# ---------------------------------------------------------------------------

_DTYPES = {
    "bool", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64", "float32", "float64",
}


class _Wire(bytes):
    """A value already in codec form: _enc copies it as it is. Built only
    on the sending side (a bulk load encodes one partition once for its
    owner and for its replica); _dec never produces one."""


def _enc(obj, out: List[bytes]) -> None:
    if type(obj) is _Wire:
        out.append(obj)
    elif obj is None:
        out.append(b"N")
    elif obj is True:
        out.append(b"T")
    elif obj is False:
        out.append(b"F")
    elif isinstance(obj, (int, np.integer)):
        b = str(int(obj)).encode()
        out += [b"I", _LEN.pack(len(b)), b]
    elif isinstance(obj, (float, np.floating)):
        out += [b"D", _D.pack(float(obj))]
    elif isinstance(obj, str):
        b = obj.encode()
        out += [b"S", _LEN.pack(len(b)), b]
    elif isinstance(obj, (bytes, bytearray)):
        out += [b"B", _LEN.pack(len(obj)), bytes(obj)]
    elif isinstance(obj, np.bool_):
        out.append(b"T" if bool(obj) else b"F")
    elif isinstance(obj, np.ndarray):
        if obj.dtype.name not in _DTYPES:
            raise DcnCodecError(f"dcn codec: dtype {obj.dtype} not allowed")
        a = np.ascontiguousarray(obj)
        dt = a.dtype.name.encode()
        raw = a.tobytes()
        out += [b"A", _LEN.pack(len(dt)), dt,
                _LEN.pack(a.ndim), b"".join(_LEN.pack(d) for d in a.shape),
                _LEN.pack(len(raw)), raw]
    elif isinstance(obj, (list, tuple)):
        out += [b"L" if isinstance(obj, list) else b"U", _LEN.pack(len(obj))]
        # strings and NULLs inline: a string column ships as one list of
        # millions of values, and the full type dispatch per value was
        # most of its encode time (the bytes are _enc's own)
        pack = _LEN.pack
        for x in obj:
            if type(x) is str:
                b = x.encode()
                out += (b"S", pack(len(b)), b)
            elif x is None:
                out.append(b"N")
            else:
                _enc(x, out)
    elif isinstance(obj, dict):
        out += [b"M", _LEN.pack(len(obj))]
        for k, v in obj.items():
            if not isinstance(k, str):
                raise DcnCodecError("dcn codec: dict keys must be str")
            kb = k.encode()
            out += [_LEN.pack(len(kb)), kb]
            _enc(v, out)
    elif isinstance(obj, datetime.datetime):  # before date (subclass)
        b = obj.isoformat().encode()
        out += [b"t", _LEN.pack(len(b)), b]
    elif isinstance(obj, datetime.date):
        b = obj.isoformat().encode()
        out += [b"d", _LEN.pack(len(b)), b]
    elif isinstance(obj, decimal.Decimal):
        b = str(obj).encode()
        out += [b"c", _LEN.pack(len(b)), b]
    else:
        raise DcnCodecError(
            f"dcn codec: type {type(obj).__name__} not serializable")


def _need(buf: bytes, pos: int, n: int) -> int:
    if pos + n > len(buf):
        raise DcnCodecError("dcn codec: truncated message")
    return pos + n


def _dec(buf: bytes, pos: int):
    tag = buf[pos:pos + 1]
    pos += 1
    if tag == b"N":
        return None, pos
    if tag == b"T":
        return True, pos
    if tag == b"F":
        return False, pos
    if tag in (b"I", b"S", b"B", b"d", b"t", b"c"):
        end = _need(buf, pos, _LEN.size)
        (n,) = _LEN.unpack(buf[pos:end])
        pos = end
        end = _need(buf, pos, n)
        raw = buf[pos:end]
        pos = end
        if tag == b"I":
            return int(raw), pos
        if tag == b"B":
            return raw, pos
        s = raw.decode()
        if tag == b"S":
            return s, pos
        if tag == b"d":
            return datetime.date.fromisoformat(s), pos
        if tag == b"t":
            return datetime.datetime.fromisoformat(s), pos
        return decimal.Decimal(s), pos
    if tag == b"D":
        end = _need(buf, pos, _D.size)
        (v,) = _D.unpack(buf[pos:end])
        return v, end
    if tag in (b"L", b"U"):
        end = _need(buf, pos, _LEN.size)
        (n,) = _LEN.unpack(buf[pos:end])
        pos = end
        items = []
        append = items.append
        unpack_from = _LEN.unpack_from
        size = len(buf)
        for _ in range(n):
            # strings and NULLs inline (the encoder's fast path); every
            # other tag, and every malformed one, goes through _dec
            t = buf[pos] if pos < size else -1
            if t == 0x53:  # b"S"
                if pos + 5 > size:
                    raise DcnCodecError("dcn codec: truncated message")
                (k,) = unpack_from(buf, pos + 1)
                end = pos + 5 + k
                if end > size:
                    raise DcnCodecError("dcn codec: truncated message")
                append(buf[pos + 5:end].decode())
                pos = end
            elif t == 0x4E:  # b"N"
                append(None)
                pos += 1
            else:
                v, pos = _dec(buf, pos)
                append(v)
        return (items if tag == b"L" else tuple(items)), pos
    if tag == b"M":
        end = _need(buf, pos, _LEN.size)
        (n,) = _LEN.unpack(buf[pos:end])
        pos = end
        d = {}
        for _ in range(n):
            end = _need(buf, pos, _LEN.size)
            (kn,) = _LEN.unpack(buf[pos:end])
            pos = end
            end = _need(buf, pos, kn)
            k = buf[pos:end].decode()
            pos = end
            d[k], pos = _dec(buf, pos)
        return d, pos
    if tag == b"A":
        end = _need(buf, pos, _LEN.size)
        (dn,) = _LEN.unpack(buf[pos:end])
        pos = end
        end = _need(buf, pos, dn)
        dtname = buf[pos:end].decode()
        pos = end
        if dtname not in _DTYPES:
            raise DcnCodecError(f"dcn codec: dtype {dtname} not allowed")
        end = _need(buf, pos, _LEN.size)
        (ndim,) = _LEN.unpack(buf[pos:end])
        pos = end
        shape = []
        for _ in range(ndim):
            end = _need(buf, pos, _LEN.size)
            shape.append(_LEN.unpack(buf[pos:end])[0])
            pos = end
        end = _need(buf, pos, _LEN.size)
        (rn,) = _LEN.unpack(buf[pos:end])
        pos = end
        end = _need(buf, pos, rn)
        arr = np.frombuffer(buf[pos:end], dtype=dtname).reshape(shape).copy()
        return arr, end
    raise DcnCodecError(f"dcn codec: bad tag {tag!r}")


def _dumps(obj) -> bytes:
    out: List[bytes] = []
    _enc(obj, out)
    return b"".join(out)


def _loads(buf: bytes):
    try:
        obj, pos = _dec(buf, 0)
    except DcnCodecError:
        raise
    except Exception as e:  # noqa: BLE001 — int()/decode()/reshape/...
        raise DcnCodecError(f"dcn codec: malformed message ({e})")
    if pos != len(buf):
        raise DcnCodecError("dcn codec: trailing bytes")
    return obj


# last frame sizes on THIS thread: _call annotates its rpc span with
# per-call (and per-page) byte counts without threading them through
# every return value — send/recv pairs never change threads mid-call
_IO_TLS = threading.local()


def _send(sock: socket.socket, obj) -> None:
    # runtime wire witness: while the sanitizer is enabled, every request
    # leaving a socket is diffed against the committed static protocol
    # model (unknown cmd/field or missing required field = typed
    # finding). Cost when off = one flag check; analysis.sanitizer is
    # stdlib-only, so the import is free.
    from tidb_tpu_torch.analysis import sanitizer as _san

    if _san.enabled():
        _san.note_wire_msg(obj)
    payload = _dumps(obj)
    sock.sendall(_LEN.pack(len(payload)) + payload)
    from tidb_tpu_torch.utils.metrics import DCN_BYTES

    _IO_TLS.last_sent = _LEN.size + len(payload)
    DCN_BYTES.inc(_LEN.size + len(payload), direction="sent")


def _recv(sock: socket.socket):
    hdr = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(hdr)
    obj = _loads(_recv_exact(sock, n))
    from tidb_tpu_torch.utils.metrics import DCN_BYTES

    _IO_TLS.last_recv = _LEN.size + n
    DCN_BYTES.inc(_LEN.size + n, direction="recv")
    return obj


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    # into one preallocated buffer: appending each chunk to a bytes
    # object copies the whole prefix every time (quadratic in the frame:
    # a 90 MB partition took 11 s on loopback)
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return bytes(buf)


def _is_loopback(host: str) -> bool:
    # NB "" binds INADDR_ANY (all interfaces) — decidedly not loopback
    return host in ("127.0.0.1", "::1", "localhost")


def dial(host: str, port: int, secret: Optional[str] = None,
         timeout: Optional[float] = None) -> socket.socket:
    """Client-side connect + mutual auth handshake against a Worker.
    Shared by the coordinator (``Cluster._connect``) and by workers
    dialing PEERS for the shuffle exchange — one handshake
    implementation, so the endpoint-binding and downgrade-refusal
    rules hold on every link in the fleet."""
    s = socket.create_connection((host, port), timeout=timeout)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    flag = _recv_exact(s, 1)
    if flag == b"\x01":
        if not secret:
            s.close()
            raise ExecutionError(
                "dcn worker demands auth but no secret configured")
        nonce_w = _recv_exact(s, 16)
        nonce_c = os.urandom(16)
        claim_host = "127.0.0.1" if host == "localhost" else host
        endpoint = f"{claim_host}:{port}".encode()
        transcript = endpoint + b"|" + nonce_w + nonce_c
        s.sendall(nonce_c + bytes([len(endpoint)]) + endpoint
                  + hmac.new(secret.encode(),
                             b"dcn-coord|" + transcript,
                             hashlib.sha256).digest())
        # reverse challenge: the worker must prove the secret too — a
        # spoofed worker that merely echoed the \x01 flag cannot
        mac_w = _recv_exact(s, 32)
        want = hmac.new(secret.encode(), b"dcn-worker|" + transcript,
                        hashlib.sha256).digest()
        if not hmac.compare_digest(mac_w, want):
            s.close()
            raise ExecutionError(
                f"dcn worker {host}:{port} failed the reverse "
                "handshake (wrong or missing secret)")
    elif secret:
        # downgrade refusal: a client configured for auth must not talk
        # to an endpoint that waives it (spoofed worker)
        s.close()
        raise ExecutionError(
            f"dcn worker {host}:{port} does not require auth but this "
            "cluster is configured with a secret")
    # create_connection leaves its connect timeout armed on the socket;
    # callers apply per-RPC deadlines themselves
    s.settimeout(None)
    return s


# ---------------------------------------------------------------------------
# worker
# ---------------------------------------------------------------------------


class Worker:
    """One host's coprocessor service: a Session over its partition."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 secret: Optional[str] = None, device=None):
        from tidb_tpu_torch.session import Session

        if not _is_loopback(host) and not secret:
            raise ExecutionError(
                "dcn worker: binding a non-loopback interface requires a "
                "shared secret (--secret-file / DCN_SECRET)")
        self.secret = secret
        # normalized for the handshake's endpoint-claim check
        self._bind_host = "127.0.0.1" if host == "localhost" else host
        # the partition's session runs on `device` (None = the card; no
        # quiet fall back to the CPU)
        self.session = Session(device=device)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(4)
        self._running = False
        # paged-partial result cursors: handle -> (created_ts, rows).
        # Bounded so a crashed coordinator can't leak worker memory, but
        # eviction is age-aware: an actively-draining cursor must never
        # be expired just because other coordinators opened newer ones.
        self._cursors: Dict[int, Tuple[float, List[tuple]]] = {}
        # idempotency: token -> open cursor handle. A coordinator that
        # lost a partial_paged RESPONSE retries with the same token; the
        # retry evicts the orphaned first-attempt cursor so a lossy link
        # can't pin partials until the TTL
        self._token_cursors: Dict[str, int] = {}
        # the newest attempt received per token: a retry can overtake the
        # attempt it replaces on the way to the executor, and only the
        # newest may open (or drop) the token's cursor
        self._token_attempt: Dict[str, int] = {}
        self._attempts = itertools.count(1)
        self._next_cursor = 1
        self._cursor_lock = threading.Lock()
        # coordinator-cancellable in-flight statements: token -> Event.
        # The cancel RPC arrives on its OWN connection (the statement's
        # connection is blocked producing the response), sets the event,
        # and the executing session's chunk-boundary poll aborts. A
        # cancel can RACE the statement it targets (the side channel is
        # faster than a queued partial): unknown tokens are remembered
        # so a late-registering statement starts already-cancelled.
        self._inflight: Dict[str, threading.Event] = {}
        self._cancelled_tokens: Dict[str, float] = {}
        self._inflight_lock = threading.Lock()
        # ONE statement at a time on the shared session: an abandoned
        # RPC's thread may still be executing when the coordinator
        # reconnects and sends the next statement — unsynchronized,
        # both would mutate session state concurrently. Cancels bypass
        # this lock (own connection, _inflight only), so a queued
        # statement can't deadlock behind one being cancelled.
        self._exec_lock = threading.Lock()
        # observable failure-domain counters (cmd "stats"): chaos tests
        # and the kill/deadline suites assert workers actually stopped
        self.stats: Dict[str, int] = {
            "executed": 0, "cancelled": 0, "deadline_exceeded": 0,
            "cancel_rpcs": 0, "pages": 0,
            "shuffle_bytes_in": 0, "shuffle_bytes_out": 0,
        }
        self._stats_lock = threading.Lock()
        # sharded placement: table -> (owned shard ids, bytes)
        # recorded by the coordinator's place_shards RPC; surfaced via
        # cmd "stats" -> information_schema.dcn_worker_stats
        self._placed: Dict[str, Tuple[List[int], int]] = {}
        self._placed_lock = threading.Lock()
        # shuffle exchange inbox: batches from peer workers staged here
        # until the coordinator's gather/apply phase drains them; bytes
        # charged to a MemTracker (budget re-read from the session's
        # tidb_mem_quota_query before every stage) so a hot shuffle hits
        # typed backpressure instead of silent growth
        from tidb_tpu_torch.sharding.shuffle import ShuffleInbox
        from tidb_tpu_torch.utils.memory import MemTracker

        self._shuffle_tracker = MemTracker("shuffle", budget=None,
                                           spill_enabled=False)
        self._inbox = ShuffleInbox(self._shuffle_tracker)
        # pooled peer connections for scatter sends: one authed socket
        # per peer endpoint, serialized by a per-peer lock (an
        # interleaved send/recv pair would desync the framing — same
        # rule as the coordinator's _sock_locks). Re-dialing per batch
        # paid TCP connect + the mutual-auth handshake on the hot path.
        self._peer_socks: Dict[Tuple[str, int], socket.socket] = {}
        self._peer_locks: Dict[Tuple[str, int], threading.Lock] = {}
        self._peer_pool_lock = threading.Lock()
        # reshard idempotency ledger: per-(run, shard) install keys this
        # worker already applied — a re-driven reshard_install (lost
        # response, recover_reshard) must NOT land the staging rows twice
        self._reshards_done: Dict[str, int] = {}
        # one pending prepared 2PC transaction at a time (the shared
        # session holds its provisional writes between the prepare and
        # commit RPCs); other statements are refused typed while it is
        # pending so they cannot be absorbed into the open transaction
        self._txn2pc: Optional[Tuple[str, float]] = None
        self._txn2pc_lock = threading.Lock()

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    def _drop_cursor_locked(self, h) -> None:
        self._cursors.pop(h, None)
        for t in [t for t, c in self._token_cursors.items() if c == h]:
            del self._token_cursors[t]

    def _drop_token_cursor_locked(self, token) -> None:
        if token is None:
            return
        h = self._token_cursors.pop(token, None)
        if h is not None:
            self._cursors.pop(h, None)

    CURSOR_CAP = 64          # hard cap on concurrently open cursors
    CURSOR_TTL_S = 600.0     # only cursors idle this long are evictable

    def serve_forever(self) -> None:
        self._running = True
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _handshake(self, conn: socket.socket) -> bool:
        """Mutual challenge/response before any message is decoded. The
        flag byte tells the client whether auth is demanded.

        The coordinator's MAC is bound to its role, the endpoint it
        believes it dialed, and both nonces — so a MAC harvested by a
        spoofed endpoint cannot be relayed to a worker at a different
        address (the worker refuses an endpoint claim that isn't
        itself), and neither side's MAC can be replayed in the other
        direction. The worker then proves knowledge of the secret with
        its own role-bound MAC over the same transcript. This is
        authentication only: there is NO transport encryption or
        post-handshake integrity — run DCN links over trusted networks
        (the reference's gRPC-over-TLS analogue is out of scope)."""
        if not self.secret:
            conn.sendall(b"\x00")
            return True
        nonce_w = os.urandom(16)
        conn.sendall(b"\x01" + nonce_w)
        try:
            nonce_c = _recv_exact(conn, 16)
            elen = _recv_exact(conn, 1)[0]
            endpoint = _recv_exact(conn, elen)
            mac_c = _recv_exact(conn, 32)
        except (ConnectionError, OSError):
            return False
        # the claimed endpoint must be this worker: port must match; host
        # must match the bind host unless bound to a wildcard. The
        # compare is literal (no DNS resolution): coordinators must dial
        # workers by the exact bind address, or bind workers to a
        # wildcard — a hostname dial against an IP-bound worker is
        # indistinguishable from a relayed claim and is refused
        try:
            ep_host, ep_port = endpoint.decode().rsplit(":", 1)
            port_ok = int(ep_port) == self.port
        except (UnicodeDecodeError, ValueError):
            conn.close()
            return False
        if ep_host == "localhost":  # match the coordinator's normalization
            ep_host = "127.0.0.1"
        host_ok = self._bind_host in ("", "0.0.0.0", "::") \
            or ep_host == self._bind_host
        if not port_ok or not host_ok:
            conn.close()
            return False
        transcript = endpoint + b"|" + nonce_w + nonce_c
        want = hmac.new(self.secret.encode(), b"dcn-coord|" + transcript,
                        hashlib.sha256).digest()
        if not hmac.compare_digest(mac_c, want):
            conn.close()
            return False
        conn.sendall(hmac.new(self.secret.encode(),
                              b"dcn-worker|" + transcript,
                              hashlib.sha256).digest())
        return True

    # a worker-side RPC trace is small: the statement's own spans plus
    # page/cancel observations — far below the coordinator's budget
    RPC_TRACE_MAX_SPANS = 128

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            if not self._handshake(conn):
                return
            while True:
                msg = _recv(conn)
                # trace-context arrival: record this RPC's server-side
                # spans (receive -> parse/plan -> execute -> page drain)
                # into a per-request trace anchored at RECEIPT, and
                # piggyback them on the response — errors included (a
                # failing attempt's spans matter most). The executing
                # session nests its statement spans automatically via
                # the thread-local tracing context.
                wtr = wroot = None
                if isinstance(msg, dict) and msg.get("trace_id"):
                    wtr = tracing.Trace(str(msg["trace_id"]),
                                        max_spans=self.RPC_TRACE_MAX_SPANS)
                    wroot = wtr.begin(f"worker.{msg.get('cmd', '?')}")
                    tracing.push(wtr, wroot)
                try:
                    try:
                        resp = {"ok": True, "result": self._handle(msg)}
                    except Exception as e:  # noqa: BLE001 — travels back
                        resp = {"ok": False,
                                "error": f"{type(e).__name__}: {e}"}
                finally:
                    if wtr is not None:
                        tracing.pop()
                        wtr.end(wroot)
                if wtr is not None:
                    resp["trace"] = wtr.export()
                try:
                    _send(conn, resp)
                except DcnCodecError as e:
                    # an unserializable RESULT fails before any bytes
                    # hit the wire: the connection is still synced, so
                    # the error can travel back like a handler error
                    _send(conn, {"ok": False,
                                 "error": f"{type(e).__name__}: {e}"})
                if msg.get("cmd") == "shutdown":
                    self._running = False
                    try:
                        # close() alone doesn't wake a thread blocked in
                        # accept() on Linux; shutdown() does
                        self._sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    self._sock.close()
                    return
        except (ConnectionError, OSError, DcnCodecError):
            pass  # desynced or dropped peer: close this connection
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _run_sql(self, msg: Dict):
        """Execute a shipped statement under the RPC's failure domain:
        the message's `deadline_s` (the coordinator statement's
        REMAINING budget) arms the session's external deadline, and its
        `token` registers a cancel event a coordinator-side KILL can set
        out of band. Both are polled by the session's chunk loop, so the
        worker stops burning CPU server-side instead of computing a
        result nobody will read.

        One worker session serves every connection, so the hooks are
        save/restored around each statement — concurrent statements from
        two coordinators would contend, which matches the single-session
        design of the rest of this Worker."""
        token = msg.get("token")
        ev: Optional[threading.Event] = None
        if token is not None:
            ev = threading.Event()
            with self._inflight_lock:
                self._inflight[token] = ev
                # the cancel may have beaten us here
                if self._cancelled_tokens.pop(token, None) is not None:
                    ev.set()
        sess = self.session
        # ownership-guarded hooks: an ABANDONED earlier attempt (the
        # coordinator timed out and moved on, this thread kept running)
        # finishes later — its cleanup must not clobber a newer
        # statement's cancel event or deadline. Each attempt only
        # resets state that is still ITS OWN (belt-and-braces under
        # the exec lock; still needed for two-coordinator workers).
        my_cancel = ev.is_set if ev is not None else None
        my_deadline = msg.get("_deadline_mono")  # anchored at RECEIPT
        self._bump("executed")
        try:
            with self._exec_lock:
                self._guard_2pc_locked()
                if my_cancel is not None:
                    sess._ext_cancel = my_cancel
                if my_deadline is not None:
                    sess._ext_deadline = my_deadline
                try:
                    return sess.execute(msg["sql"])
                finally:
                    if my_cancel is not None \
                            and sess._ext_cancel is my_cancel:
                        sess._ext_cancel = None
                    if my_deadline is not None \
                            and sess._ext_deadline == my_deadline:
                        sess._ext_deadline = None
        except QueryTimeoutError:
            self._bump("deadline_exceeded")
            raise
        except QueryKilledError:
            self._bump("cancelled")
            raise
        finally:
            if token is not None:
                with self._inflight_lock:
                    if self._inflight.get(token) is ev:
                        del self._inflight[token]

    # -- sharded placement + shuffle exchange + 2PC ----------

    def _guard_2pc_locked(self) -> None:
        """Called under the exec lock before any statement runs: while
        a prepared 2PC transaction is pending, foreign statements are
        refused TYPED (they would otherwise silently join the open
        transaction on the shared session). A prepared participant
        NEVER resolves unilaterally — it voted yes, and the coordinator
        may hold a commit decision it cannot see, so only txn_commit /
        txn_abort (a coordinator's recover_txns()) releases it. This is
        the textbook 2PC blocking window, kept observable on purpose."""
        with self._txn2pc_lock:
            pend = self._txn2pc
            if pend is not None:
                raise ExecutionError(
                    f"dcn worker: 2pc transaction {pend[0]} is pending "
                    "(prepare acknowledged, decision not yet received); "
                    "statement refused until a coordinator resolves it")

    def _txn2pc_cmd(self, cmd: str, msg: Dict):
        """txn_prepare / txn_commit / txn_abort: one participant's half
        of the coordinator's two-phase commit (storage/txn2pc.py is the
        single-process committer the session's COMMIT already runs; this
        wraps it in the cross-process prepare/decide protocol)."""
        xid = str(msg["xid"])
        sess = self.session
        if cmd == "txn_prepare":
            with self._exec_lock:
                with self._txn2pc_lock:
                    pend = self._txn2pc
                if pend is not None and pend[0] == xid:
                    return "prepared"  # retried prepare: already staged
                if pend is not None:
                    raise ExecutionError(
                        f"dcn worker: 2pc transaction {pend[0]} still "
                        f"pending; cannot prepare {xid}")
                sess.execute("begin")
                try:
                    # batched group-commit prepare: a window
                    # of coalesced writes arrives as one `sqls` list and
                    # stages inside ONE participant transaction; the
                    # singleton `sql` form stays wire-compatible
                    for one in (msg.get("sqls") or [msg["sql"]]):
                        sess.execute(one)
                except Exception:
                    try:
                        sess.execute("rollback")
                    except Exception:  # noqa: BLE001 — abort cleanup
                        pass
                    raise
                with self._txn2pc_lock:
                    self._txn2pc = (xid, time.monotonic())
            return "prepared"
        with self._exec_lock:
            with self._txn2pc_lock:
                mine = self._txn2pc is not None and self._txn2pc[0] == xid
            if not mine:
                # already finished here, or never prepared (a commit
                # retry after a lost response): idempotent ack
                return "idempotent"
            sess.execute("commit" if cmd == "txn_commit" else "rollback")
            # cleared only AFTER the commit/rollback lands: a failed
            # commit must keep the guard up, or the next statement
            # would silently join the still-open prepared transaction
            # and a commit re-drive would get a hollow idempotent ack
            with self._txn2pc_lock:
                self._txn2pc = None
        return "done"

    def _shuffle_budget(self) -> None:
        """Re-arm the inbox tracker's budget from the session's memory
        quota before a stage lands — the knob is a live sysvar, and the
        budget must be whatever it says NOW."""
        q = int(self.session.sysvars.get("tidb_mem_quota_query"))
        self._shuffle_tracker.budget = q if q > 0 else None

    def _shuffle_stage(self, msg: Dict) -> int:
        """A PEER worker's batch arriving: charge, stage, account. The
        propagated statement budget (deadline_s -> _deadline_mono,
        anchored at receipt like every RPC) is honored here: staging
        bytes for a statement that already expired would pin inbox
        memory nobody will ever gather."""
        dl = msg.get("_deadline_mono")
        if dl is not None and time.monotonic() > dl:
            raise QueryTimeoutError(
                "Query execution was interrupted, maximum statement "
                "execution time exceeded (shuffle stage received after "
                "the deadline)")
        inject("shuffle.recv")
        self._shuffle_budget()
        n = self._inbox.stage(str(msg["shuffle_id"]), str(msg["side"]),
                              msg["batch"])
        self._bump("shuffle_bytes_in", n)
        from tidb_tpu_torch.utils.metrics import SHUFFLE_BYTES_TOTAL

        SHUFFLE_BYTES_TOTAL.inc(n, dir="in")
        return n

    def _shuffle_scatter(self, msg: Dict) -> Dict:
        """Partition this worker's live rows of `table` by the shipped
        shard map (mode=hash) — or replicate them to every peer
        (mode=broadcast) — and ship per-destination batches
        FoR-encoded. dest == self stages straight into the local inbox
        (no wire). All socket work happens with NO worker lock held."""
        from tidb_tpu_torch.sharding import placement as pl
        from tidb_tpu_torch.sharding import shuffle as shfl
        from tidb_tpu_torch.utils.metrics import SHUFFLE_BYTES_TOTAL

        # budget checked BEFORE any extract/partition/encode work (and
        # before the self-destination local stage, which has no peer
        # hop to catch it): scattering for an expired statement pins
        # inbox bytes nobody will gather
        dl0 = msg.get("_deadline_mono")
        if dl0 is not None and time.monotonic() > dl0:
            raise QueryTimeoutError(
                "Query execution was interrupted, maximum statement "
                "execution time exceeded (shuffle scatter received "
                "after the deadline)")
        table = self.session.catalog.table(
            msg.get("db") or self.session.db, msg["table"])
        arrays, valids, strings, n = shfl.extract_live_columns(
            table, msg.get("columns") or None)
        n_workers = int(msg["n_workers"])
        mode = msg.get("mode", "hash")
        parts = None
        if mode != "broadcast":
            key = msg["key"]
            if key in strings:
                raise UnsupportedError(
                    "dcn shuffle: string shuffle keys are unsupported "
                    "(dictionary codes are process-local)")
            smap = pl.ShardMap.from_wire(msg["map"])
            shards = pl.shard_of_array(smap, arrays[key], valids[key])
            dest = shards % np.int64(max(n_workers, 1))
            parts = shfl.partition_rows(arrays, valids, strings, dest,
                                        n_workers)
        types = {c.name: c.type_ for c in table.schema.columns}
        sid, side = str(msg["shuffle_id"]), str(msg["side"])
        self_i = int(msg["self_index"])
        peers = msg["peers"]
        timeout = float(msg.get("timeout_s") or 30.0)
        sent_bytes = 0
        local_bytes = 0
        # broadcast replicates to the GATHER set only (`dests`) and
        # encodes its one identical batch ONCE; a hash shuffle routes
        # over every worker — each owns a key range — with a distinct
        # batch per destination
        bcast_batch = None
        if mode == "broadcast":
            dests = [int(d) for d in (msg.get("dests")
                                      or range(n_workers))]
            if n:
                bcast_batch = shfl.encode_batch(types, arrays, valids,
                                                strings)
        else:
            dests = range(n_workers)
        for w in dests:
            if mode == "broadcast":
                batch = bcast_batch
            else:
                batch = (shfl.encode_batch(types, *parts[w])
                         if parts[w] is not None else None)
            if batch is None:
                continue
            if w == self_i:
                self._shuffle_budget()
                # the self-destination copy never crosses a socket but
                # IS part of the exchange volume: ack it separately so
                # the coordinator's plan feedback sizes the side by ALL
                # copies, not just the remote ones (wire metrics stay
                # honest — sent_bytes counts shipped bytes only)
                local_bytes += self._inbox.stage(sid, side, batch)
                continue
            inject("shuffle.send")
            host, port = peers[w]
            # mandatory-envelope propagation: this hop is a
            # fan-out re-send, and _peer_call injects nothing — the
            # statement's remaining budget and trace context must ride
            # the message explicitly or they die at this worker (the
            # protocol-conformance pass enforces it; a peer staging for
            # an expired statement would burn memory nobody drains)
            peer_msg = {"cmd": "shuffle_stage", "shuffle_id": sid,
                        "side": side, "batch": batch}
            dl = msg.get("_deadline_mono")
            if dl is not None:
                rem = dl - time.monotonic()
                if rem <= 0:
                    raise QueryTimeoutError(
                        "Query execution was interrupted, maximum "
                        "statement execution time exceeded (before "
                        f"shuffle stage to worker {w})")
                peer_msg["deadline_s"] = rem
                timeout = min(timeout, rem)
            tr = tracing.current()
            sp = (tr.begin(f"peer.shuffle_stage[w{w}]",
                           tracing.current_span_id())
                  if tr is not None else None)
            if tr is not None:
                peer_msg["trace_id"] = tr.trace_id
            resp = None
            try:
                try:
                    resp = self._peer_call(str(host), int(port),
                                           peer_msg, timeout)
                except (socket.timeout, TimeoutError) as e:
                    # the clamped socket timeout IS the deadline when
                    # the budget ran out mid-hop: surface the same 3024
                    # the pre-send rem<=0 check raises (same mapping as
                    # Cluster._call's timeout path)
                    if dl is not None and time.monotonic() >= dl:
                        raise QueryTimeoutError(
                            "Query execution was interrupted, maximum "
                            "statement execution time exceeded "
                            f"(shuffle stage to worker {w})") from e
                    raise
            finally:
                if tr is not None:
                    if isinstance(resp, dict) and resp.get("trace"):
                        tr.graft(resp["trace"], sp, proc=f"{host}:{port}")
                    tr.end(sp)
            if not resp.get("ok"):
                # the peer's typed refusal (inbox OOM backpressure, or
                # the new deadline check) travels through this worker
                # back to the coordinator — RE-TYPED, so a peer-side
                # deadline expiry reaches the client as the same 3024
                # the sender-side rem<=0 check raises
                err = str(resp.get("error"))
                raise _retype_wire_error(
                    err, f"shuffle stage to worker {w} failed: {err}")
            nb = int(resp["result"])
            sent_bytes += nb
            self._bump("shuffle_bytes_out", nb)
            SHUFFLE_BYTES_TOTAL.inc(nb, dir="out")
        return {"rows": int(n), "bytes": sent_bytes,
                "local_bytes": local_bytes}

    def _peer_call(self, host: str, port: int, msg: Dict,
                   timeout: float) -> Dict:
        """One RPC to a peer worker over the pooled connection for that
        endpoint (dialed + authed on first use, dropped on any wire
        fault so the next call re-dials). The per-peer lock serializes
        concurrent scatters — two sides of one shuffle ship in
        parallel threads and must not interleave frames."""
        key = (host, port)
        with self._peer_pool_lock:
            lk = self._peer_locks.setdefault(key, threading.Lock())
        with lk:
            s = self._peer_socks.get(key)
            if s is None:
                s = dial(host, port, secret=self.secret, timeout=timeout)
                self._peer_socks[key] = s
            try:
                s.settimeout(timeout)
                _send(s, msg)
                resp = _recv(s)
                s.settimeout(None)
            except (ConnectionError, OSError, DcnCodecError):
                try:
                    s.close()
                except OSError:
                    pass
                self._peer_socks.pop(key, None)
                raise
        return resp

    def _clone_temp_table(self, base, name: str, columns: List[str]):
        """Fresh table holding the shipped column subset of `base`'s
        schema — no constraints, defaults, or generated columns (the
        exchange ships materialized values; re-running column logic
        would double-apply it)."""
        import copy

        from tidb_tpu_torch.storage.table import TableSchema

        cat = self.session.catalog
        db = self.session.db
        cat.drop_table(db, name, if_exists=True)
        cols = []
        for cn in columns:
            ci = copy.deepcopy(base.schema.col(cn))
            ci.not_null = False
            ci.auto_increment = False
            ci.default = None
            ci.state = "public"
            cols.append(ci)
        cat.create_table(db, TableSchema(name, cols))
        return cat.table(db, name)

    def _shuffle_gather(self, msg: Dict) -> Dict:
        """Assemble this worker's staged batches into temp tables (one
        per exchanged side), run the partial SQL over the co-partitioned
        slice, and release the shuffle state. The result pages through
        the SAME cursor machinery as partial_paged, so drains, cancel
        tokens, and leak accounting are identical."""
        from tidb_tpu_torch.sharding import shuffle as shfl

        sid = str(msg["shuffle_id"])
        cat = self.session.catalog
        created: List[str] = []
        try:
            for sd in msg["sides"]:
                base = cat.table(msg.get("db") or self.session.db,
                                 sd["table"])
                t = self._clone_temp_table(base, sd["temp"], sd["columns"])
                created.append(sd["temp"])
                types = {c.name: c.type_ for c in t.schema.columns}
                shfl.assemble_into_table(self.session, sd["temp"], types,
                                         self._inbox.drain(sid, sd["side"]))
            return self._partial_paged(msg)
        finally:
            # the cursor holds materialized host rows: the staged
            # batches and temp tables are dead weight from here (and on
            # error they must not outlive the statement)
            self._inbox.close(sid)
            for name in created:
                try:
                    cat.drop_table(self.session.db, name, if_exists=True)
                except Exception:  # noqa: BLE001 — cleanup best effort
                    pass

    def _table_like(self, db: str, name: str, like: str):
        """Resolve `name`, cloning `like`'s FULL schema (defaults,
        constraints, generated columns intact) when absent. Replica
        `__part` mirrors and reshard backfill staging tables both go
        through here: a staging table must apply double-written DML
        exactly like the real table, or the cutover fingerprints can
        never match."""
        import copy

        cat = self.session.catalog
        try:
            return cat.table(db, name)
        except Exception:  # noqa: BLE001 — absent: clone it
            base = cat.table(db, like)
            schema = copy.deepcopy(base.schema)
            schema.name = name
            cat.create_table(db, schema)
            return cat.table(db, name)

    def _reshard_backfill(self, msg: Dict) -> Dict:
        """Online-reshard backfill SOURCE: extract this
        worker's live rows of `table` that the NEW map assigns to
        `shard` and stage them into the destination owner's staging
        table — a peer-to-peer hop like _shuffle_scatter (no
        coordinator copy), carrying the same mandatory deadline/trace
        envelope. The extract+encode runs under the exec lock (a point
        snapshot no concurrent statement can tear); the peer send runs
        with NO lock held."""
        from tidb_tpu_torch.sharding import placement as pl
        from tidb_tpu_torch.sharding import shuffle as shfl

        inject("reshard.backfill")
        db = msg.get("db") or self.session.db
        smap = pl.ShardMap.from_wire(msg["map"])
        shard = int(msg["shard"])
        with self._exec_lock:
            self._guard_2pc_locked()
            table = self.session.catalog.table(db, msg["table"])
            if table.schema.col(smap.column).type_.kind == TypeKind.STRING:
                raise UnsupportedError(
                    "reshard: string shard keys are unsupported "
                    "(dictionary codes are process-local)")
            # the shard's rows found from the shard column alone, then
            # only they are extracted (the reference extracts the whole
            # table and selects)
            idx = shfl.live_shard_rows(table, smap, shard)
            if not len(idx):
                return {"rows": 0, "bytes": 0}
            types = {c.name: c.type_ for c in table.schema.columns}
            batch = shfl.encode_batch(types, *shfl.extract_rows(table, idx))
        stage_msg = {"cmd": "reshard_stage", "table": msg["staging"],
                     "like": msg["table"], "db": msg.get("db"),
                     "batch": batch}
        if int(msg["dest_index"]) == int(msg["self_index"]):
            rows = self._reshard_stage(stage_msg)
            return {"rows": int(rows), "bytes": 0}
        host, port = msg["dest"]
        timeout = float(msg.get("timeout_s") or 30.0)
        dl = msg.get("_deadline_mono")
        if dl is not None:
            rem = dl - time.monotonic()
            if rem <= 0:
                raise QueryTimeoutError(
                    "Query execution was interrupted, maximum statement "
                    "execution time exceeded (before reshard stage to "
                    f"{host}:{port})")
            stage_msg["deadline_s"] = rem
            timeout = min(timeout, rem)
        tr = tracing.current()
        if tr is not None:
            stage_msg["trace_id"] = tr.trace_id
        resp = self._peer_call(str(host), int(port), stage_msg, timeout)
        if not resp.get("ok"):
            err = str(resp.get("error"))
            raise _retype_wire_error(
                err, f"reshard stage to {host}:{port} failed: {err}")
        return {"rows": int(resp["result"]), "bytes": 0}

    def _reshard_stage(self, msg: Dict) -> int:
        """Backfill DESTINATION: land one shipped batch into the
        staging table (cloned from the real table's full schema on
        first touch)."""
        from tidb_tpu_torch.sharding import shuffle as shfl

        db = msg.get("db") or self.session.db
        with self._exec_lock:
            self._guard_2pc_locked()
            t = self._table_like(db, msg["table"], msg["like"])
            types = {c.name: c.type_ for c in t.schema.columns}
            b = msg["batch"]
            if not b["n"]:
                return 0
            arrays, valids, strs = shfl.decode_batch(types, b)
            return t.insert_columns(arrays, valids, strings=strs)

    def _reshard_fingerprint(self, msg: Dict) -> Dict:
        """Row-count + order-independent hash of a table's live rows —
        restricted to the rows the shipped map assigns to `shard` when
        a map is given (source side), the whole table otherwise
        (staging side). An absent table is an EMPTY row set, not an
        error: a shard nobody backfilled anything for has no staging
        table and must still validate."""
        from tidb_tpu_torch.parallel.membership import rows_fingerprint
        from tidb_tpu_torch.sharding import placement as pl
        from tidb_tpu_torch.sharding import shuffle as shfl

        db = msg.get("db") or self.session.db
        with self._exec_lock:
            try:
                table = self.session.catalog.table(db, msg["table"])
            except Exception:  # noqa: BLE001 — absent: empty set
                return {"n": 0, "fp": 0}
            if msg.get("map") is not None:
                # the shard's rows alone, as in _reshard_backfill
                smap = pl.ShardMap.from_wire(msg["map"])
                arrays, valids, strings = shfl.extract_rows(
                    table, shfl.live_shard_rows(table, smap,
                                                int(msg["shard"])))
            else:
                arrays, valids, strings, _n = \
                    shfl.extract_live_columns(table)
            n, fp = rows_fingerprint(arrays, valids, strings,
                                     table.schema.public_names())
        return {"n": n, "fp": fp}

    def _reshard_install(self, msg: Dict) -> int:
        """Cutover at the new owner: move the validated staging rows
        into the real table and drop the staging. IDEMPOTENT against
        coordinator re-drives (recover_reshard) via the per-(run,shard)
        ledger — a lost response must not install twice."""
        from tidb_tpu_torch.sharding import shuffle as shfl

        key = f"{msg['sid']}#i{int(msg['shard'])}"
        db = msg.get("db") or self.session.db
        cat = self.session.catalog
        with self._exec_lock:
            self._guard_2pc_locked()
            with self._placed_lock:
                done = self._reshards_done.get(key)
            if done is not None:
                return done
            total = 0
            try:
                st = cat.table(db, msg["staging"])
            except Exception:  # noqa: BLE001 — nothing backfilled
                st = None
            if st is not None:
                t = cat.table(db, msg["table"])
                arrays, valids, strings, n = shfl.extract_live_columns(st)
                if n:
                    total = t.insert_columns(arrays, valids,
                                             strings=strings)
                cat.drop_table(db, msg["staging"], if_exists=True)
            with self._placed_lock:
                self._reshards_done[key] = total
                while len(self._reshards_done) > 64:
                    self._reshards_done.pop(
                        next(iter(self._reshards_done)))
            return total

    def _reshard_purge(self, msg: Dict) -> int:
        """Cutover at an old owner: delete the live rows the NEW map
        assigns to `shard` (their installed copy at the new owner is
        the surviving one). Naturally idempotent — a re-drive finds no
        matching live rows."""
        from tidb_tpu_torch.sharding import placement as pl

        db = msg.get("db") or self.session.db
        smap = pl.ShardMap.from_wire(msg["map"])
        shard = int(msg["shard"])
        with self._exec_lock:
            self._guard_2pc_locked()
            t = self.session.catalog.table(db, msg["table"])
            n = t.n
            if not n:
                return 0
            idx = np.nonzero(t.live_mask(0, n))[0]
            if not len(idx):
                return 0
            shards = pl.shard_of_array(
                smap, t.data[smap.column][:n][idx],
                t.valid[smap.column][:n][idx])
            victims = idx[shards == np.int64(shard)]
            if not len(victims):
                return 0
            return t.delete_rows(victims)

    def _table_dump(self, msg: Dict) -> Dict:
        """Full live-row snapshot of a table in load_columns shape —
        the coordinator's source for replica-mirror rebuilds and for
        seeding a joining worker's broadcast tables."""
        from tidb_tpu_torch.sharding import shuffle as shfl

        db = msg.get("db") or self.session.db
        with self._exec_lock:
            try:
                table = self.session.catalog.table(db, msg["table"])
            except Exception:  # noqa: BLE001 — absent: empty dump
                return {"arrays": {}, "valids": {}, "strings": {},
                        "n": 0}
            arrays, valids, strings, n = shfl.extract_live_columns(table)
        return {"arrays": arrays, "valids": valids, "strings": strings,
                "n": n}

    def _partial_paged(self, msg: Dict) -> Dict:
        """Run the partial once, return the first page + a cursor the
        coordinator drains with "fetch" — bounds the coordinator's
        in-flight volume to one page per worker. Shared by the plain
        partial path and the shuffle gather (same cursor, token, and
        leak discipline). An attempt that a newer one of the same token
        overtook opens no cursor and drops none: its coordinator gave up
        on it (the reference's first attempt could evict the retry's
        cursor and pin its own, which nobody drained)."""
        token = msg.get("token")
        # the coordinator numbers a token's attempts (_call_retry): a retry
        # can reach this point before the attempt it replaces (each
        # connection has its own thread), so arrival order cannot rank
        # them; a message without a number ranks by arrival
        attempt = msg.get("attempt")
        if attempt is None:
            attempt = next(self._attempts)
        if token is not None:
            with self._cursor_lock:
                self._token_attempt[token] = max(
                    attempt, self._token_attempt.get(token, attempt))
                while len(self._token_attempt) > 1024:
                    self._token_attempt.pop(next(iter(self._token_attempt)))
        inject("dcn.worker.partial")
        rs = self._run_sql(msg)
        rows = rs.rows
        tracing.annotate(f"partial:rows={len(rows)}")
        page = int(msg.get("page_rows", 8192))

        def overtaken() -> bool:  # caller holds _cursor_lock
            return token is not None and \
                self._token_attempt.get(token, attempt) != attempt

        if len(rows) <= page:
            with self._cursor_lock:
                if not overtaken():
                    self._drop_token_cursor_locked(token)
            return {"rows": rows, "cursor": None, "total": len(rows)}
        now = time.time()
        if token is not None:
            with self._inflight_lock:
                poisoned = self._cancelled_tokens.pop(
                    token, None) is not None
            if poisoned:
                # the coordinator abandoned this statement (cancel
                # arrived after execution finished): don't pin a
                # cursor nobody will ever drain
                return {"rows": rows[:page], "cursor": None,
                        "total": len(rows)}
        with self._cursor_lock:
            if overtaken():
                return {"rows": rows[:page], "cursor": None,
                        "total": len(rows)}
            # a RETRY of this token (first response lost on the
            # wire) must not leave the first attempt's cursor
            # pinned: evict it before opening the replacement
            self._drop_token_cursor_locked(token)
            # reap abandoned cursors (a crashed coordinator must not
            # leak result memory); live drains are refreshed on every
            # fetch so they never look idle
            stale = [h for h, (ts, _r) in self._cursors.items()
                     if now - ts > self.CURSOR_TTL_S]
            for h in stale:
                self._drop_cursor_locked(h)
            if len(self._cursors) >= self.CURSOR_CAP:
                raise ExecutionError(
                    f"dcn worker: {self.CURSOR_CAP} partial cursors "
                    "already open")
            h = self._next_cursor
            self._next_cursor += 1
            self._cursors[h] = (now, rows)
            if token is not None:
                self._token_cursors[token] = h
        return {"rows": rows[:page], "cursor": h, "total": len(rows)}

    def _handle(self, msg: Dict):
        if msg.get("deadline_s") is not None:
            # statement budget anchored NOW, before any injected fault
            # or queueing delay can defer it
            msg["_deadline_mono"] = time.monotonic() + float(
                msg["deadline_s"])
        inject("dcn.worker.handle")
        cmd = msg["cmd"]
        # lint: disable=protocol-conformance -- health-probe arm with no
        # in-tree sender by design: tests and operators dial it raw to
        # check liveness without touching any statement machinery
        if cmd == "ping":
            return "pong"
        if cmd == "cancel":
            # out-of-band: stop the statement registered under `token`
            self._bump("cancel_rpcs")
            token = msg.get("token")
            with self._inflight_lock:
                ev = self._inflight.get(token)
                if ev is None and token is not None:
                    # not started yet: poison the token (bounded memory)
                    self._cancelled_tokens[token] = time.time()
                    while len(self._cancelled_tokens) > 256:
                        self._cancelled_tokens.pop(
                            next(iter(self._cancelled_tokens)))
            # cancel observation onto the shipped-back trace: which
            # token, and whether it caught a statement in flight or
            # poisoned ahead of one
            tracing.annotate(f"cancel:token={token} "
                             f"inflight={ev is not None}")
            if ev is None:
                return False  # not in flight (finished, or poisoned)
            ev.set()
            return True
        if cmd == "stats":
            with self._stats_lock:
                out = dict(self.stats)
            with self._cursor_lock:
                out["open_cursors"] = len(self._cursors)
            with self._placed_lock:
                out["shards_owned"] = sum(
                    len(s) for s, _b in self._placed.values())
                out["shard_bytes"] = sum(
                    b for _s, b in self._placed.values())
            out["open_shuffles"] = self._inbox.open_count()
            return out
        if cmd == "metrics_snapshot":
            # fleet metrics plane: this process's entire
            # registry in wire form — the coordinator merges per-worker
            # snapshots for /metrics?scope=cluster and
            # information_schema.cluster_metrics
            from tidb_tpu_torch.utils import metrics as _metrics

            return _metrics.snapshot()
        if cmd == "place_shards":
            with self._placed_lock:
                self._placed[str(msg["table"])] = (
                    [int(s) for s in (msg.get("shards") or [])],
                    int(msg.get("bytes") or 0))
            return "placed"
        if cmd == "shuffle_stage":
            return self._shuffle_stage(msg)
        if cmd == "shuffle_scatter":
            return self._shuffle_scatter(msg)
        if cmd == "shuffle_gather":
            return self._shuffle_gather(msg)
        if cmd == "shuffle_close":
            self._inbox.close(str(msg["shuffle_id"]))
            return "closed"
        if cmd == "reshard_backfill":
            return self._reshard_backfill(msg)
        if cmd == "reshard_stage":
            return self._reshard_stage(msg)
        if cmd == "reshard_fingerprint":
            return self._reshard_fingerprint(msg)
        if cmd == "reshard_install":
            return self._reshard_install(msg)
        if cmd == "reshard_purge":
            return self._reshard_purge(msg)
        if cmd == "table_dump":
            return self._table_dump(msg)
        if cmd in ("txn_prepare", "txn_commit", "txn_abort"):
            return self._txn2pc_cmd(cmd, msg)
        if cmd == "exec":
            rs = self._run_sql(msg)
            return rs.rows if rs is not None else None
        if cmd == "ddl_stage":
            # one step of an online schema change (ref: schema-version
            # leases + state machine, SURVEY.md:180-185): the
            # coordinator barriers every worker through the same stage
            # before advancing, so at most two adjacent schema states
            # coexist; DML between stages stays correct (write_only
            # columns default-fill, write_only indexes enforce)
            self.session.apply_ddl_stage(msg["sql"], msg["stage"])
            return {"schema_version": self.session.catalog.schema_version}
        if cmd == "load_columns":
            db = msg.get("db") or self.session.db
            name = msg["table"]
            like = msg.get("like")
            if like is not None:
                # replica partitions clone the base table's schema into
                # their own namespaced table on first load
                table = self._table_like(db, name, like)
            else:
                table = self.session.catalog.table(db, name)
            if msg.get("replace"):
                # mirror rebuild / joiner seed: this load IS the table
                table.truncate()
            return table.insert_columns(
                msg.get("arrays") or {}, msg.get("valids"),
                strings=msg.get("strings"))
        if cmd == "partial_paged":
            return self._partial_paged(msg)
        if cmd == "fetch":
            inject("dcn.worker.page")
            self._bump("pages")
            h = msg["cursor"]
            off = int(msg["offset"])
            page = int(msg.get("page_rows", 8192))
            with self._cursor_lock:
                ent = self._cursors.get(h)
                if ent is None:
                    raise ExecutionError(f"dcn cursor {h} expired")
                rows = ent[1]
                out = rows[off: off + page]
                if off + page >= len(rows):
                    self._drop_cursor_locked(h)
                else:
                    self._cursors[h] = (time.time(), rows)  # refresh idle clock
            tracing.annotate(f"page:offset={off} rows={len(out)}")
            return out
        if cmd == "close_cursor":
            with self._cursor_lock:
                self._drop_cursor_locked(msg["cursor"])
            return "closed"
        if cmd == "shutdown":
            return "bye"
        raise ExecutionError(f"unknown dcn command {cmd!r}")


def worker_main(argv=None) -> int:  # pragma: no cover - subprocess entry
    """python -m tidb_tpu_torch.parallel.dcn [--host] [--port N]
    [--device {cuda,cpu}] [--secret-file]; prints the bound port. The
    worker's session runs on the card unless --device cpu asks for the
    host; with no card and no --device cpu it exits 1."""
    import argparse
    import sys

    from tidb_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="torch device of the worker's session (default "
                         "cuda; cpu runs the plain PyTorch path)")
    ap.add_argument("--secret-file", default=None,
                    help="path to the cluster shared secret (else DCN_SECRET)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except ExecutionError as e:
        print(f"tidb_tpu_torch dcn worker: {e}", file=sys.stderr)
        return 1
    secret = None
    if args.secret_file:
        secret = open(args.secret_file).read().strip()
    elif os.environ.get("DCN_SECRET"):
        secret = os.environ["DCN_SECRET"]
    w = Worker(args.host, args.port, secret=secret, device=device)
    print(f"DCN_WORKER_PORT={w.port}", flush=True)
    sys.stdout.flush()
    w.serve_forever()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(worker_main())


# ---------------------------------------------------------------------------
# partial/final rewrite
# ---------------------------------------------------------------------------

_DIST_AGGS = {"count", "sum", "min", "max", "avg"}
# engine aggregates with no partial/final SQL split on this tier
_NONDIST_AGGS = {"bit_and", "bit_or", "bit_xor", "group_concat", "any_value",
                 "variance", "var_pop", "var_samp", "stddev", "std",
                 "stddev_pop", "stddev_samp"}


def _from_tables(src) -> List[A.TableName]:
    """Base tables of a FROM tree; only inner/cross joins qualify (an
    outer join against a broadcast side would need NULL-extension
    coordination the partial/final split cannot express)."""
    if isinstance(src, A.TableName):
        return [src]
    if isinstance(src, A.Join):
        if src.kind not in ("inner", "cross"):
            raise UnsupportedError(f"dcn tier: {src.kind} join")
        if src.using:
            raise UnsupportedError("dcn tier: JOIN USING")
        return _from_tables(src.left) + _from_tables(src.right)
    raise UnsupportedError("dcn FROM must be base tables")


def _from_sql(src, rename: Dict[str, str]) -> str:
    """Render a FROM tree back to SQL, substituting renamed tables (the
    replica retry reads `<fact>__part<i>`); a renamed table keeps its
    original name as an alias so qualified column refs stay valid."""
    if isinstance(src, A.TableName):
        t = rename.get(src.name, src.name)
        out = f"`{t}`"
        if src.alias:
            out += f" as `{src.alias}`"
        elif t != src.name:
            out += f" as `{src.name}`"
        return out
    left = _from_sql(src.left, rename)
    right = _from_sql(src.right, rename)
    if src.kind == "cross" and src.on is None:
        return f"{left} cross join {right}"
    on = f" on {expr_to_sql(src.on)}" if src.on is not None else ""
    return f"{left} join {right}{on}"


def partial_rewrite(sql: str, table_as: Optional[str] = None,
                    partitioned=frozenset(), broadcast=frozenset(),
                    renames: Optional[Dict[str, str]] = None,
                    co_partitioned=frozenset(),
                    parsed=None) -> Tuple[str, str, List[str]]:
    """One SELECT -> (partial_sql, final_sql, out_names). partial_sql
    runs on every worker; its result rows are unioned into the staging
    table __dcn_partial__ on the coordinator, where final_sql computes
    the merge. Aggregates use the partial/final split; a plain SELECT
    with ORDER BY+LIMIT becomes a local TopN per worker merged by the
    same sort on the coordinator (coprocessor TopN pushdown).

    FROM may be one partitioned table, or `fact JOIN dim...` where
    exactly one table is partitioned across workers and every other
    side was broadcast_table()'d to all of them (the star-schema
    coprocessor-join shape, SURVEY.md:131): each worker joins its fact
    partition against its full local dim copies, so the partial/final
    aggregate split stays exact. `table_as` substitutes the partitioned
    table's name — the replica-partition retry reads `<fact>__part<i>`.

    Shuffle joins relax the one-partitioned-table rule:
    tables in `co_partitioned` are co-partitioned ON THE JOIN KEY at
    execution time (the cross-process exchange routes both sides with
    the same hash), so the partial/final aggregate split stays exact
    with any number of them; `renames` substitutes the per-worker
    staging-table names the exchanged sides materialize into.
    `parsed` (the pre-parsed statement list) skips the re-parse when
    the caller already holds one — the coordinator's planner does."""
    stmts = parsed if parsed is not None else parse(sql)
    if len(stmts) != 1 or not isinstance(stmts[0], A.SelectStmt):
        raise UnsupportedError("dcn tier handles a single SELECT")
    st = stmts[0]
    if st.having is not None or st.distinct or st.ctes:
        raise UnsupportedError(
            "dcn tier pushes coprocessor-shaped aggregates "
            "(no HAVING/DISTINCT/CTE)")
    tables = _from_tables(st.from_)
    if len(tables) == 1:
        fact = tables[0].name
        if fact in broadcast and fact not in partitioned:
            # every worker holds the FULL copy: fanning a partial out
            # and summing would multiply aggregates by the worker count
            raise UnsupportedError(
                f"table {fact!r} is broadcast (replicated), not "
                "partitioned; query it on one worker directly")
    elif co_partitioned:
        # shuffle plan: every side is either co-partitioned on the join
        # key (exchange output, or hash-placed on it already) or a
        # broadcast dim — the coordinator's exchange planner already
        # validated the join keys
        missing = [t.name for t in tables
                   if t.name not in co_partitioned
                   and t.name not in broadcast]
        if missing:
            raise UnsupportedError(
                f"dcn shuffle join sides {missing} are neither "
                "co-partitioned nor broadcast")
        fact = next(t.name for t in tables if t.name in co_partitioned)
    else:
        parts = [t.name for t in tables if t.name in partitioned]
        if len(parts) != 1:
            raise UnsupportedError(
                "dcn join needs exactly one partitioned table "
                f"(got {parts or 'none'} among {[t.name for t in tables]})")
        fact = parts[0]
        missing = [t.name for t in tables
                   if t.name != fact and t.name not in broadcast]
        if missing:
            raise UnsupportedError(
                f"dcn join sides {missing} are not broadcast to the "
                "workers (Cluster.broadcast_table)")

    def has_agg(e) -> bool:
        import dataclasses as _dc

        if isinstance(e, A.EFunc) and e.name in _DIST_AGGS:
            return True
        if isinstance(e, A.EFunc) and e.name in _NONDIST_AGGS:
            # an extended aggregate must NOT fall into the TopN
            # scan-gather path — the workers would each return a local
            # value and the union would silently be wrong
            raise UnsupportedError(
                f"dcn tier: aggregate {e.name} has no partial/final split")
        if not _dc.is_dataclass(e):
            return False
        for fld in _dc.fields(e):
            v = getattr(e, fld.name)
            items = v if isinstance(v, (list, tuple)) else [v]
            for item in items:
                if isinstance(item, tuple):
                    if any(_dc.is_dataclass(x) and has_agg(x) for x in item):
                        return True
                elif _dc.is_dataclass(item) and has_agg(item):
                    return True
        return False

    rename = dict(renames or {})
    if table_as:
        rename[fact] = table_as
    from_sql = _from_sql(st.from_, rename)
    where = f" where {expr_to_sql(st.where)}" if st.where is not None else ""

    if not st.group_by and not any(has_agg(it.expr) for it in st.items):
        return _topn_rewrite(st, from_sql, where)

    group_sqls = [expr_to_sql(g) for g in st.group_by]
    part_items: List[str] = []
    final_items: List[str] = []
    out_names: List[str] = []
    gcol: Dict[str, str] = {}
    for i, g in enumerate(group_sqls):
        gname = f"g{i}"
        part_items.append(f"{g} as {gname}")
        gcol[g] = gname

    for i, item in enumerate(st.items):
        e = item.expr
        alias = item.alias or (
            e.name if isinstance(e, A.EName) else f"col{i}")
        out_names.append(alias)
        esql = expr_to_sql(e)
        if esql in gcol:  # a group-by column in output position
            final_items.append(f"{gcol[esql]} as `{alias}`")
            continue
        if not (isinstance(e, A.EFunc) and e.name in _DIST_AGGS):
            raise UnsupportedError(
                f"dcn output must be group columns or plain aggregates, got {esql}")
        if e.distinct:
            raise UnsupportedError("dcn tier: DISTINCT aggregates")
        argsql = expr_to_sql(e.args[0]) if e.args else "*"
        if e.name == "count":
            part_items.append(f"count({argsql}) as p{i}")
            final_items.append(f"sum(p{i}) as `{alias}`")
        elif e.name in ("sum", "min", "max"):
            part_items.append(f"{e.name}({argsql}) as p{i}")
            final_items.append(f"{e.name}(p{i}) as `{alias}`")
        else:  # avg = sum of sums / sum of counts
            part_items.append(f"sum({argsql}) as p{i}s")
            part_items.append(f"count({argsql}) as p{i}c")
            final_items.append(f"sum(p{i}s) / sum(p{i}c) as `{alias}`")

    groupby = f" group by {', '.join(group_sqls)}" if group_sqls else ""
    partial_sql = (f"select {', '.join(part_items)} from {from_sql}"
                   f"{where}{groupby}")

    fgroup = f" group by {', '.join(gcol.values())}" if gcol else ""
    order = ""
    if st.order_by:
        terms = []
        for o in st.order_by:
            osql = expr_to_sql(o.expr)
            if isinstance(o.expr, A.EName) and o.expr.qualifier is None \
                    and o.expr.name in out_names:
                ref = f"`{o.expr.name}`"
            elif osql in gcol:
                ref = gcol[osql]
            else:
                raise UnsupportedError(
                    "dcn ORDER BY must reference output aliases or group columns")
            terms.append(ref + (" desc" if o.desc else ""))
        order = " order by " + ", ".join(terms)
    limit = f" limit {st.limit}" if st.limit is not None else ""
    offset = f" offset {st.offset}" if st.offset is not None else ""
    final_sql = (f"select {', '.join(final_items)} from `__dcn_partial__`"
                 f"{fgroup}{order}{limit}{offset}")
    return partial_sql, final_sql, out_names


def _topn_rewrite(st: A.SelectStmt, from_sql: str, where: str
                  ) -> Tuple[str, str, List[str]]:
    """Plain SELECT [ORDER BY ... LIMIT n]: each worker returns its
    local rows (top n+offset when limited); the coordinator re-sorts and
    applies the final limit/offset. Without a LIMIT this is a plain
    distributed scan-gather."""
    part_items, out_names = [], []
    for i, item in enumerate(st.items):
        e = item.expr
        alias = item.alias or (
            e.name if isinstance(e, A.EName) else f"col{i}")
        out_names.append(alias)
        part_items.append(f"{expr_to_sql(e)} as `{alias}`")

    item_sqls = [expr_to_sql(it.expr) for it in st.items]
    order_terms = []
    for o in st.order_by:
        osql = expr_to_sql(o.expr)
        if isinstance(o.expr, A.EName) and o.expr.qualifier is None \
                and o.expr.name in out_names:
            ref = f"`{o.expr.name}`"
        elif osql in item_sqls:
            ref = f"`{out_names[item_sqls.index(osql)]}`"
        else:
            raise UnsupportedError(
                "dcn TopN ORDER BY must reference output columns")
        order_terms.append(ref + (" desc" if o.desc else ""))
    order = (" order by " + ", ".join(order_terms)) if order_terms else ""

    part_limit = ""
    if st.limit is not None:
        if not order_terms:
            raise UnsupportedError("dcn LIMIT without ORDER BY is ambiguous")
        part_limit = f" limit {st.limit + (st.offset or 0)}"
    partial_sql = (f"select {', '.join(part_items)} from {from_sql}"
                   f"{where}{order}{part_limit}")
    limit = f" limit {st.limit}" if st.limit is not None else ""
    offset = f" offset {st.offset}" if st.offset is not None else ""
    final_sql = (f"select {', '.join(f'`{n}`' for n in out_names)} "
                 f"from `__dcn_partial__`{order}{limit}{offset}")
    return partial_sql, final_sql, out_names


# ---------------------------------------------------------------------------
# predicate helpers for shard-key pruning + shuffle planning
# ---------------------------------------------------------------------------

_NOT_LITERAL = object()


def _eq_conjuncts(e):
    """Flatten an AND tree into its conjuncts."""
    if isinstance(e, A.EBinary) and e.op == "and":
        yield from _eq_conjuncts(e.left)
        yield from _eq_conjuncts(e.right)
    else:
        yield e


def _literal_int(e):
    """Integer value of a literal expr (None for NULL); _NOT_LITERAL
    when it is anything else — float literals included, because the
    device's f64 compare and python int arithmetic can disagree, so a
    float-pinned shard key must not prune (same rule as zone maps)."""
    neg = False
    while isinstance(e, A.EUnary) and e.op in ("-", "+"):
        neg ^= (e.op == "-")
        e = e.arg
    if isinstance(e, A.ENull):
        return None
    if isinstance(e, A.ENum) and "." not in e.text \
            and "e" not in e.text.lower():
        try:
            v = int(e.text)
        except ValueError:
            return _NOT_LITERAL
        return -v if neg else v
    return _NOT_LITERAL


def _shard_eq_value(where, table: str, column: str):
    """(value, True) when a WHERE conjunct pins `column` to one integer
    literal (col = N, qualifier absent or naming `table`) — the scan
    then dispatches to that single shard's owner."""
    if where is None:
        return None, False
    for c in _eq_conjuncts(where):
        if not (isinstance(c, A.EBinary) and c.op == "="):
            continue
        for name_side, lit_side in ((c.left, c.right),
                                    (c.right, c.left)):
            if not isinstance(name_side, A.EName):
                continue
            if name_side.name != column:
                continue
            if name_side.qualifier not in (None, table):
                continue
            v = _literal_int(lit_side)
            if v is not _NOT_LITERAL:
                return v, True
    return None, False


def _rewrite_dml_table(sql: str, name: str, repl: str) -> str:
    """Retarget an UPDATE/DELETE statement at a different physical
    table (the reshard double-write against a staging copy). Textual
    but anchored: only the leading ``update <name>`` / ``delete from
    <name>`` token rewrites, so a same-named column or string literal
    deeper in the statement stays untouched."""
    pat = re.compile(
        r"^(\s*(?:update|delete\s+from)\s+)(`%s`|%s)\b"
        % (re.escape(name), re.escape(name)), re.IGNORECASE)
    out, n = pat.subn(lambda m: m.group(1) + f"`{repl}`", sql, count=1)
    if not n:
        raise UnsupportedError(
            "dcn dml: cannot retarget statement at the reshard staging "
            f"copy ({sql[:60]!r})")
    return out


def _walk_exprs(node):
    """Every dataclass expr node reachable from `node` (AST subtrees,
    lists, tuples) — the EName harvest for used-column analysis."""
    import dataclasses as _dc

    stack = [node]
    while stack:
        e = stack.pop()
        if isinstance(e, (list, tuple)):
            stack.extend(e)
            continue
        if not _dc.is_dataclass(e):
            continue
        yield e
        for fld in _dc.fields(e):
            stack.append(getattr(e, fld.name))


def _equi_name_pairs(st) -> List[Tuple[A.EName, A.EName]]:
    """(EName, EName) pairs from every equality conjunct in the JOIN ON
    trees and the WHERE — the candidate shuffle keys."""
    conds: List = []

    def walk_src(src):
        if isinstance(src, A.Join):
            if src.on is not None:
                conds.extend(_eq_conjuncts(src.on))
            walk_src(src.left)
            walk_src(src.right)

    walk_src(st.from_)
    if st.where is not None:
        conds.extend(_eq_conjuncts(st.where))
    out = []
    for c in conds:
        if isinstance(c, A.EBinary) and c.op == "=" \
                and isinstance(c.left, A.EName) \
                and isinstance(c.right, A.EName):
            out.append((c.left, c.right))
    return out


# ---------------------------------------------------------------------------
# coordinator
# ---------------------------------------------------------------------------


class _LinkHealth:
    """One worker link's health-machine record (UP -> SUSPECT -> DOWN
    with exponential backoff + jitter between reconnect probes). All
    transitions happen under the link's socket lock."""

    __slots__ = ("state", "attempts", "next_retry", "last_error",
                 "reconnects", "since")

    def __init__(self):
        self.state = UP
        self.attempts = 0        # consecutive failed reconnects
        self.next_retry = 0.0    # monotonic: earliest half-open probe
        self.last_error = ""
        self.reconnects = 0      # successful re-establishments, ever
        self.since = time.monotonic()


class _DmlMember:
    """One execute_dml call waiting inside a 2PC write window."""

    __slots__ = ("per_worker", "done", "result", "exc")

    def __init__(self, per_worker: Dict[int, str]):
        self.per_worker = per_worker
        self.done = threading.Event()
        self.result = None
        self.exc: Optional[BaseException] = None


class _DmlWindow:
    """Cross-session group commit over the mesh: concurrent
    execute_dml calls gather for ``Cluster.dml_window_us`` and ride ONE
    prepare/decide/commit round per shard owner — each worker's prepare
    carries the window's statements as a `sqls` list staged inside one
    participant transaction.

    Exactness mirrors the local batcher's fallback rule: a failure
    BEFORE the commit decision aborted every shard, so the leader
    re-drives each member's own write as a singleton round (exact typed
    errors, no lost statements). A TwoPhaseCommitIncomplete happened
    AFTER the decision — the writes are committed — so it propagates to
    every member unretried (a retry would double-apply)."""

    def __init__(self, cluster: "Cluster"):
        self.cluster = cluster
        self._lock = threading.Lock()
        self._open: Optional[List[_DmlMember]] = None
        self.windows = 0           # merged rounds executed (n >= 2)
        self.coalesced_stmts = 0   # members of merged rounds

    def submit(self, per_worker: Dict[int, str]) -> Dict[str, object]:
        member = _DmlMember(per_worker)
        with self._lock:
            if self._open is not None:
                self._open.append(member)
                leader = False
            else:
                self._open = [member]
                leader = True
        if not leader:
            member.done.wait()
        else:
            # the leader IS the gather clock: it sleeps out the window
            # on its caller's thread (no worker pool on the coordinator)
            time.sleep(self.cluster.dml_window_us / 1e6)
            with self._lock:
                members = self._open or [member]
                self._open = None
            self._run(members)
        if member.exc is not None:
            raise member.exc
        return member.result

    def _run(self, members: List[_DmlMember]) -> None:
        cl = self.cluster
        if len(members) == 1:
            m = members[0]
            try:
                m.result = cl._two_phase(m.per_worker)
            except BaseException as e:  # noqa: BLE001 — relayed
                m.exc = e
            m.done.set()
            return
        merged: Dict[int, List[str]] = {}
        for m in members:
            for w, sql in m.per_worker.items():
                # a member's per-worker value may itself be a LIST
                # (reshard double-writes): flatten, don't nest
                bucket = merged.setdefault(w, [])
                (bucket.extend if isinstance(sql, list)
                 else bucket.append)(sql)
        with self._lock:
            self.windows += 1
            self.coalesced_stmts += len(members)
        try:
            res = cl._two_phase(merged)
        except TwoPhaseCommitIncomplete as e:
            for m in members:
                m.exc = e
                m.done.set()
            return
        except Exception:  # noqa: BLE001 — every shard aborted; the
            # members re-run alone for their exact typed errors
            for m in members:
                try:
                    m.result = cl._two_phase(m.per_worker)
                except BaseException as e:  # noqa: BLE001 — relayed
                    m.exc = e
                m.done.set()
            return
        for m in members:
            # shared xid, member-specific participant list (the workers
            # THIS write touched — what a singleton round would report)
            m.result = {"xid": res["xid"],
                        "workers": sorted(m.per_worker)}
            m.done.set()


class Cluster:
    """Coordinator-side handle on the worker fleet.

    `replicas` maps partition/worker index -> replica worker index; a
    partition loaded with load_partition is mirrored into the replica's
    `<table>__part<i>` table, and a failed partial RPC retries there
    (the region-replica failover analogue).

    Failure domain: every RPC runs under a per-call socket deadline
    (min of `rpc_timeout_s` and the statement deadline's remainder); a
    failed link moves through UP -> SUSPECT (one immediate reconnect
    allowed) -> DOWN (exponential backoff + jitter between half-open
    probes) instead of being permanently dead. Idempotent RPCs retry
    once on a fresh connection before replica failover."""

    # a dim bigger than this doesn't broadcast: replicating it to every
    # worker would cost more than the join saves (ref: the reference's
    # broadcast-join threshold)
    BROADCAST_LIMIT_BYTES = int(os.environ.get(
        "DCN_BROADCAST_LIMIT", str(64 << 20)))

    # reconnect backoff: SUSPECT probes immediately; each further
    # failure doubles the wait (plus up to 25% jitter so a fleet of
    # coordinators doesn't probe a recovering worker in lockstep),
    # capped so a restarted worker is re-admitted within ~RECONNECT_CAP_S
    RECONNECT_BASE_S = 0.05
    RECONNECT_CAP_S = 2.0
    RECONNECT_MAX_DOUBLINGS = 6   # attempts beyond this probe at the cap
    JITTER_FRAC = 0.25
    CANCEL_DIAL_TIMEOUT_S = 2.0   # side-channel cancel must never hang
    # default bound on a statement's wait for a topology-change gate
    # (overridden per-session by tidb_tpu_reshard_gate_wait_ms)
    GATE_WAIT_S = 10.0

    def __init__(self, endpoints: List[Tuple[str, int]],
                 secret: Optional[str] = None,
                 replicas: Optional[Dict[int, int]] = None,
                 rpc_timeout_s: Optional[float] = 30.0,
                 connect_timeout_s: float = 30.0,
                 partial_results: bool = False, device=None):
        self.secret = secret
        self.replicas = dict(replicas or {})
        self.rpc_timeout_s = rpc_timeout_s
        self.connect_timeout_s = connect_timeout_s
        # a partition with primary AND replica unreachable: fail the
        # query (False) or serve reachable partitions with a warning
        self.partial_results = partial_results
        self.last_warnings: List[str] = []
        self._socks: List[Optional[socket.socket]] = []
        self._closed = False
        self._endpoints = list(endpoints)
        self._partitioned: set = set()
        self._broadcast: set = set()
        # sharded placement: table -> ShardMap snapshot +
        # loaded bytes. The lock is a LEAF: snapshot under it, never a
        # socket send (blocking-under-lock pass enforces the shape —
        # see tests/analysis_fixtures/bad_shuffle_lock.py)
        self._placements: Dict[str, object] = {}
        self._placement_bytes: Dict[str, int] = {}
        self._placement_lock = threading.Lock()
        self._table_cols_cache: Dict[str, List[str]] = {}
        # online reshard: table -> per-shard state machine
        # ({"sid","old","new","moves","shards","dw","xl"}). Statements
        # keep routing by the OLD map while shards backfill in the
        # background; DML double-writes to the destination staging for
        # shards in `dw`; the fence narrows to shards left in "cutover"
        # by a fault (recover_reshard re-drives the idempotent half).
        self._reshard_state: Dict[str, Dict] = {}
        # per-table readers/writer gates: every statement read-acquires
        # its tables + CLUSTER_GATE; backfill/cutover/membership
        # finalize write-acquire briefly (bounded — see membership.py)
        self._gates = TableGates()
        # elastic membership: DDL replay log for joiners, and the drain
        # translation (old worker index -> surviving socket index) that
        # keeps already-compacted placements routable mid-drain
        self._ddl_log: List[str] = []
        self._membership_lock = threading.Lock()
        self._draining: Optional[int] = None
        self._drain_xl: Optional[Dict[int, int]] = None
        # 2PC coordinator state: xid -> participant worker ids. A txn
        # moves pending -> decided at the commit point; recover_txns()
        # finishes either side after a coordinator "crash" (failpoint
        # between prepare and commit — the chaos grid's window)
        self._txn_pending: Dict[str, List[int]] = {}
        self._txn_decided: Dict[str, List[int]] = {}
        self._txn_lock = threading.Lock()
        # group-commit write window: >0 gathers concurrent
        # execute_dml calls for this many microseconds and two-phase-
        # commits the whole window in ONE round per shard owner
        self.dml_window_us = 0
        self._dml_window = _DmlWindow(self)
        self._health: List[_LinkHealth] = [_LinkHealth() for _ in endpoints]
        # per-call RPC budget (deadline + timeout) travels thread-local
        # so _call keeps its monkeypatch-friendly (i, msg) signature
        self._tl = threading.local()
        # one lock per worker socket: callers may issue RPCs to the same
        # worker from several threads (a DML thread racing online_ddl's
        # stage barriers); an interleaved send/recv pair desyncs the
        # length-prefixed framing permanently
        self._sock_locks: List[threading.Lock] = [
            threading.Lock() for _ in endpoints]
        for i, (host, port) in enumerate(endpoints):
            self._socks.append(self._connect(host, port))
            self._set_state(i, UP)
        from tidb_tpu_torch.session import Session

        # the final merge over __dcn_partial__ runs on `device` (None =
        # the card)
        self._merge_session = Session(device=device)
        # concurrent statements share the merge session and its one
        # __dcn_partial__ staging table: the merge phase serializes
        # behind this lock (sustained mixed traffic runs DURING
        # topology changes; worker-side partials still
        # compute concurrently, only the coordinator merge queues)
        self._merge_lock = threading.Lock()
        _CLUSTERS.add(self)

    def _set_state(self, i: int, state: str) -> None:
        # entry FIELDS are confined by _sock_locks[i] (every caller is
        # a *_locked method) or by construction (ctor/add_worker touch
        # an index no statement can reach yet); the list SHAPE is what
        # _membership_lock + the cluster gate guard
        h = self._health[i]
        h.state = state
        h.since = time.monotonic()
        from tidb_tpu_torch.utils.metrics import WORKER_STATE

        host, port = self._endpoints[i]
        WORKER_STATE.set(_STATE_CODE[state], endpoint=f"{host}:{port}")

    def _connect(self, host: str, port: int,
                 timeout: Optional[float] = None) -> socket.socket:
        inject("dcn.connect")
        return dial(host, port, secret=self.secret,
                    timeout=timeout or self.connect_timeout_s)

    def __len__(self):
        return len(self._socks)

    # -- failure domain: budgets, health transitions, reconnect ---------

    def _rpc_budget(self, i: int) -> Optional[float]:
        """Per-call socket deadline: min(rpc timeout, statement
        deadline remainder). Raises the typed timeout when the
        statement's budget is already spent — don't even send."""
        timeout = getattr(self._tl, "rpc_timeout", None)
        if timeout is None:
            timeout = self.rpc_timeout_s
        if timeout is not None and timeout <= 0:
            timeout = None
        dl = getattr(self._tl, "deadline", None)
        if dl is not None:
            rem = dl - time.monotonic()
            if rem <= 0:
                raise QueryTimeoutError(
                    "Query execution was interrupted, maximum statement "
                    f"execution time exceeded (before dcn worker {i} rpc)")
            timeout = rem if timeout is None else min(timeout, rem)
        return timeout

    def _note_failure_locked(self, i: int, e: Exception) -> None:
        """UP -> SUSPECT (one immediate reconnect), further failures ->
        DOWN with exponential backoff + jitter before the next half-open
        probe. Caller holds self._sock_locks[i]."""
        h = self._health[i]
        h.last_error = str(e)
        if h.state == UP:
            self._set_state(i, SUSPECT)
            h.next_retry = 0.0  # half-open immediately: maybe a blip
        else:
            self._set_state(i, DOWN)
            h.attempts += 1
            backoff = self.RECONNECT_BASE_S * (
                2 ** min(h.attempts, self.RECONNECT_MAX_DOUBLINGS))
            backoff = min(backoff, self.RECONNECT_CAP_S)
            backoff *= 1.0 + self.JITTER_FRAC * random.random()
            h.next_retry = time.monotonic() + backoff

    def _note_ok_locked(self, i: int) -> None:
        h = self._health[i]
        if h.state != UP:
            self._set_state(i, UP)
        h.attempts = 0
        h.next_retry = 0.0

    def _reconnect_locked(self, i: int) -> socket.socket:
        """Half-open probe: re-dial a SUSPECT/DOWN worker. Honors the
        circuit breaker — inside the backoff window the call fails fast
        without touching the network. Caller holds the socket lock."""
        h = self._health[i]
        now = time.monotonic()
        if now < h.next_retry:
            raise ConnectionError(
                f"dcn worker {i} is down (circuit open for another "
                f"{h.next_retry - now:.2f}s; last error: {h.last_error})")
        host, port = self._endpoints[i]
        try:
            sock = self._connect(host, port)
        except (ConnectionError, OSError, ExecutionError) as e:
            self._note_failure_locked(i, e)
            raise ConnectionError(
                f"dcn worker {i}: reconnect failed: {e}") from e
        self._socks[i] = sock
        h.reconnects += 1
        from tidb_tpu_torch.utils.metrics import DCN_RETRY_TOTAL

        DCN_RETRY_TOTAL.inc(kind="reconnect")
        tracing.annotate(f"reconnect:w{i}")
        return sock

    def _remote_error(self, i: int, err: str) -> ExecutionError:
        """Re-type a worker-reported error: kill/deadline travel the
        wire as `ClassName: message` and must stay typed end to end."""
        return _retype_wire_error(err, f"dcn worker {i}: {err}")

    def _call(self, i: int, msg: Dict):
        t0 = time.perf_counter()
        timeout = self._rpc_budget(i)
        # trace-context propagation: under an active trace every RPC
        # gets a span, the message carries trace_id (only — see below)
        # so the worker records server-side spans against it, and the
        # response piggybacks those spans back for grafting under the
        # rpc span
        tr = tracing.current()
        sp = None
        if tr is not None:
            sp = tr.begin(f"dcn.rpc.{msg.get('cmd', '?')}[w{i}]",
                          parent_id=tracing.current_span_id())
            # copy before annotating: call sites share one msg dict
            # across workers (`[{...}] * n`), and the trace context is
            # per-call — in-place writes would cross trace ids between
            # workers and race the codec. Only trace_id travels: the
            # worker's spans graft back under THIS side's rpc span, so
            # a wire span_id would be dead bytes on every message (the
            # protocol-conformance pass enforces exactly that).
            msg = dict(msg, trace_id=tr.trace_id)
        try:
            with self._sock_locks[i]:  # one in-flight RPC per worker
                if self._closed:
                    # a late dispatch/drain thread must not redial a
                    # worker after close() — fail loudly instead
                    raise ConnectionError(
                        f"dcn cluster is closed (worker {i})")
                sock = self._socks[i]
                if sock is None:
                    if not getattr(self._tl, "reconnect", True):
                        raise ConnectionError(f"dcn worker {i} is down")
                    sock = self._reconnect_locked(i)
                try:
                    inject("dcn.coord.send")
                    if timeout is not None:
                        sock.settimeout(timeout)
                    _send(sock, msg)
                    inject("dcn.coord.recv")
                    resp = _recv(sock)
                    if timeout is not None:
                        sock.settimeout(None)
                except (ConnectionError, OSError, DcnCodecError) as e:
                    # mark dead so retries don't reuse a broken socket —
                    # still under the lock, so a concurrent caller can
                    # never have its healthy RPC closed out from
                    # underneath it
                    try:
                        sock.close()
                    except OSError:
                        pass
                    self._socks[i] = None
                    self._note_failure_locked(i, e)
                    if isinstance(e, (socket.timeout, TimeoutError)):
                        dl = getattr(self._tl, "deadline", None)
                        if dl is not None and time.monotonic() >= dl:
                            raise QueryTimeoutError(
                                "Query execution was interrupted, maximum "
                                "statement execution time exceeded "
                                f"(dcn worker {i} rpc)") from e
                        # timeout may be None here (timeouts disabled, TCP
                        # stack raised ETIMEDOUT on the blocking socket)
                        after = (f" after {timeout:.2f}s"
                                 if timeout is not None else "")
                        raise DcnRpcTimeoutError(
                            f"dcn worker {i}: rpc timed out{after}") from e
                    raise ConnectionError(f"dcn worker {i}: {e}") from e
                self._note_ok_locked(i)
        except Exception as e:
            if sp is not None:
                sp.notes.append(f"error:{type(e).__name__}")
                tr.end(sp)
            raise
        dt = time.perf_counter() - t0
        if sp is not None:
            sp.notes.append(
                f"sent_bytes={getattr(_IO_TLS, 'last_sent', 0)}")
            sp.notes.append(
                f"recv_bytes={getattr(_IO_TLS, 'last_recv', 0)}")
            tr.end(sp)
            remote = resp.get("trace") if isinstance(resp, dict) else None
            if remote:
                host, port = self._endpoints[i]
                tr.graft(remote, sp, proc=f"{host}:{port}")
        from tidb_tpu_torch.utils.metrics import DCN_RPC_SECONDS, DCN_RTT

        DCN_RTT.observe(dt)
        DCN_RPC_SECONDS.observe(dt, cmd=str(msg.get("cmd", "?")))
        if not resp["ok"]:
            raise self._remote_error(i, resp["error"])
        return resp["result"]

    def _call_retry(self, i: int, msg: Dict):
        """IDEMPOTENT RPCs only (reads, ping, stats): one retry on a
        fresh connection before the caller falls to replica failover.
        Never retries an RPC TIMEOUT (the worker is probably still
        executing the first attempt — re-sending would run it twice
        concurrently and collide the cancel token) nor typed
        kill/deadline errors (the budget is spent)."""
        try:
            return self._call(i, msg)
        except DcnRpcTimeoutError:
            raise
        except ConnectionError:
            from tidb_tpu_torch.utils.metrics import DCN_RETRY_TOTAL

            DCN_RETRY_TOTAL.inc(kind="rpc")
            # a retry path is exactly what tail sampling wants to keep
            tracing.keep("retry")
            tracing.annotate(f"retry:w{i}")
            if "attempt" in msg:
                # the worker keeps the newest attempt's cursor only
                msg = dict(msg, attempt=msg["attempt"] + 1)
            return self._call(i, msg)

    def _call_all(self, msgs: List[Dict], idempotent: bool = False) -> List:
        """One message per worker, dispatched concurrently. Errors are
        collected PER INDEX: the raised error is the lowest failed
        worker's, and when several died the message carries the full
        list — one failure must not hide that others also failed (nor
        may the raised one be whichever thread lost the append race)."""
        results: List = [None] * len(self._socks)
        errors: List[Optional[Exception]] = [None] * len(self._socks)

        def run(i):
            try:
                fn = self._call_retry if idempotent else self._call
                results[i] = fn(i, msgs[i])
            except Exception as e:  # noqa: BLE001
                errors[i] = e

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(self._socks))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [i for i, e in enumerate(errors) if e is not None]
        if failed:
            first = errors[failed[0]]
            if len(failed) == 1:
                raise first
            detail = "; ".join(f"worker {j}: {errors[j]}" for j in failed)
            try:
                err = type(first)(
                    f"{len(failed)} dcn workers failed — {detail}")
            except Exception:  # noqa: BLE001 — exotic ctor: keep first
                err = first
            raise err from first
        return results

    def _call_pairs(self, pairs: List[Tuple[int, Dict]]) -> List:
        """One RPC per (worker, message), dispatched concurrently; the
        results in order, or the first failed pair's error (two pairs on
        one worker queue on its socket lock)."""
        results: List = [None] * len(pairs)
        errors: List[Optional[Exception]] = [None] * len(pairs)

        def run(j: int) -> None:
            try:
                results[j] = self._call(*pairs[j])
            except Exception as e:  # noqa: BLE001 — raised below
                errors[j] = e

        threads = [threading.Thread(target=run, args=(j,))
                   for j in range(len(pairs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [e for e in errors if e is not None]
        if failed:
            raise failed[0]
        return results

    def broadcast_exec(self, sql: str) -> None:
        self._call_all([{"cmd": "exec", "sql": sql}] * len(self._socks))
        # membership replay log: add_worker() replays the broadcast
        # history so a joiner's schema (and broadcast-table DDL) match
        # the fleet before it takes placement traffic
        with self._membership_lock:
            self._ddl_log.append(sql)

    def online_ddl(self, sql: str, between_stages=None) -> None:
        """ONLINE multi-version schema change across worker processes
        (ref: the DDL owner stepping the schema state machine one
        version at a time while every instance keeps serving,
        SURVEY.md:180-185). Each stage is an all-worker barrier — the
        synchronous-ack equivalent of waiting out a schema lease, giving
        the same ≤2-adjacent-versions guarantee. Concurrent DML between
        stages is exactly the window the write_only states make safe.
        `between_stages(stage)` is a test hook to widen that window.
        A backfill failure (or dead worker) aborts the staged object on
        every reachable worker."""
        from tidb_tpu_torch.parser import parse
        from tidb_tpu_torch.parser import ast as A

        stmt = parse(sql)[0]
        if not (isinstance(stmt, A.AlterTableStmt)
                and stmt.action in ("add_column", "add_index")):
            # shapes without intermediate states apply atomically
            self.broadcast_exec(sql)
            return
        stages = (["write_only", "public"] if stmt.action == "add_column"
                  else ["write_only", "backfill", "public"])
        done = []
        try:
            for stage in stages:
                self._call_all(
                    [{"cmd": "ddl_stage", "sql": sql, "stage": stage}]
                    * len(self._socks))
                done.append(stage)
                if between_stages is not None:
                    between_stages(stage)
            # fully public everywhere: one replayable statement for
            # future joiners (a joiner applies it atomically — it has
            # no concurrent DML to stage around)
            with self._membership_lock:
                self._ddl_log.append(sql)
        except Exception:
            if "public" not in done:
                try:
                    self._call_all(
                        [{"cmd": "ddl_stage", "sql": sql, "stage": "abort"}]
                        * len(self._socks))
                except Exception:  # noqa: BLE001 — best-effort cleanup
                    pass
            raise

    def load_partition(self, worker: int, table: str, arrays=None,
                       valids=None, strings=None, db: Optional[str] = None
                       ) -> int:
        n = self._call(worker, {
            "cmd": "load_columns", "table": table, "arrays": arrays,
            "valids": valids, "strings": strings, "db": db,
        })
        # mark only after the load lands: a stale mark on a failed load
        # would defeat the replicated-table refusal in partial_rewrite
        self._partitioned.add(table)
        rep = self.replicas.get(worker)
        if rep is not None:
            self._call(rep, {
                "cmd": "load_columns", "table": f"{table}__part{worker}",
                "like": table, "arrays": arrays, "valids": valids,
                "strings": strings, "db": db,
            })
        return n

    def broadcast_table(self, table: str, arrays=None, valids=None,
                        strings=None, db: Optional[str] = None) -> int:
        """Ship a full (dimension) table to EVERY worker so partitioned
        fact scans can join it locally (the star-schema broadcast join;
        SURVEY.md:131). Size-capped: replicating a big table would cost
        more than the join saves."""
        size = 0
        for v in (arrays or {}).values():
            size += np.asarray(v).nbytes
        for v in (valids or {}).values():
            size += np.asarray(v).nbytes
        for pool in (strings or {}).values():
            size += sum(len(x) for x in pool)
        if size > self.BROADCAST_LIMIT_BYTES:
            raise ExecutionError(
                f"broadcast_table({table!r}): {size} bytes exceeds the "
                f"{self.BROADCAST_LIMIT_BYTES}-byte broadcast cap")
        msg = {"cmd": "load_columns", "table": table, "arrays": arrays,
               "valids": valids, "strings": strings, "db": db}
        ns = self._call_all([dict(msg) for _ in self._socks])
        self._broadcast.add(table)
        return ns[0]

    def mark_broadcast(self, table: str) -> None:
        """Register a table as present-in-full on every worker when it
        was loaded out of band (e.g. broadcast_exec INSERTs)."""
        self._broadcast.add(table)

    def mark_partitioned(self, table: str) -> None:
        self._partitioned.add(table)

    # -- sharded placement -----------------------------------

    def ddl(self, sql: str) -> None:
        """Broadcast a DDL to the fleet; SHARD BY metadata additionally
        registers a coordinator-side placement so loads, scans, joins,
        and DML route by shard ownership from here on. An ALTER ...
        SHARD BY must go through reshard() — registering a new map
        without moving the rows would route scans to owners that do
        not hold them."""
        shard = None
        stmt = None
        try:
            stmt = parse(sql)[0]
            shard = getattr(stmt, "shard", None)
        except Exception:  # noqa: BLE001 — let the workers' parsers
            pass           # be the authority on malformed DDL
        if shard is not None and isinstance(stmt, A.AlterTableStmt):
            n = stmt.table.name
            # refuse whenever the fleet is known to hold the table's
            # rows (placed, row-range partitioned, OR broadcast) —
            # registering a map without moving them would route scans
            # to owners that do not hold the data (and a broadcast
            # table fanned as partitioned multiplies every aggregate)
            if self.placement(n) is not None or n in self._partitioned \
                    or n in self._broadcast:
                raise UnsupportedError(
                    "ALTER ... SHARD BY over loaded data must go "
                    "through Cluster.reshard() (the rows have to move)")
        self.broadcast_exec(sql)
        self._table_cols_cache.clear()
        if shard is None:
            return
        from tidb_tpu_torch.sharding.placement import ShardMap

        name = stmt.table.name
        kind, col, arg = shard
        with self._placement_lock:
            old = self._placements.get(name)
            version = (old.version + 1) if old is not None else 0
            if kind == "range":
                smap = ShardMap("range", col, len(arg) + 1,
                                len(self._socks), tuple(arg), version)
            else:
                smap = ShardMap("hash", col, int(arg), len(self._socks),
                                (), version)
            self._placements[name] = smap
        self._partitioned.add(name)

    def placement(self, table: str):
        with self._placement_lock:
            return self._placements.get(table)

    def load_sharded(self, table: str, arrays=None, valids=None,
                     strings=None, db: Optional[str] = None) -> int:
        """Route rows to their shard owners per the registered
        placement (register with Cluster.ddl's SHARD BY first). Every
        owner also records its owned shard set + bytes (place_shards),
        so `information_schema.dcn_worker_stats` shows where data
        lives; a worker with a replica mirrors its slice into
        `<table>__part<w>` exactly like load_partition. The owners load
        concurrently, each followed by its mirror; a failure is raised
        once every owner's load has ended (the reference loads them in
        turn and stops at the first failure)."""
        from tidb_tpu_torch.sharding import placement as pl
        from tidb_tpu_torch.sharding import shuffle as shfl

        self._check_reshard_fence([table])
        # bulk loads don't ride the double-write machinery: rows landed
        # mid-reshard/mid-drain would miss the staging copy and vanish
        # at cutover — refuse typed until the topology settles
        if self._mid_reshard(table):
            raise ExecutionError(
                f"load_sharded({table!r}): table is mid-reshard; "
                "retry after the reshard completes")
        if self._draining is not None:
            raise ExecutionError(
                f"load_sharded({table!r}): worker {self._draining} is "
                "draining; retry after remove_worker completes")
        smap = self.placement(table)
        if smap is None:
            raise ExecutionError(
                f"no shard placement registered for {table!r} "
                "(CREATE ... SHARD BY via Cluster.ddl)")
        arrays = {k: np.asarray(v) for k, v in (arrays or {}).items()}
        valids = {k: np.asarray(v, dtype=bool)
                  for k, v in (valids or {}).items()}
        strings = {k: list(v) for k, v in (strings or {}).items()}
        if smap.column not in arrays:
            raise ExecutionError(
                f"load_sharded({table!r}): shard column "
                f"{smap.column!r} missing from arrays")
        for k, a in arrays.items():
            if k not in valids:
                valids[k] = np.ones(len(a), dtype=bool)
        key = arrays[smap.column]
        shards = pl.shard_of_array(smap, key, valids[smap.column])
        dest = shards % np.int64(max(len(self._socks), 1))
        parts = shfl.partition_rows(arrays, valids, strings, dest,
                                    len(self._socks))
        owners = smap.owners()
        loaded: List[int] = [0] * len(parts)
        sizes: List[int] = [0] * len(parts)

        def load_one(w: int) -> None:
            part = parts[w]
            if part is not None:
                a, v, s = part
                # encoded once for the owner and its replica (the same
                # bytes _dumps would write twice); every field is written
                # out so the static protocol model can name it
                wa, wv, ws = _Wire(_dumps(a)), _Wire(_dumps(v)), _Wire(_dumps(s))
                loaded[w] = self._call(w, {
                    "cmd": "load_columns", "table": table, "arrays": wa,
                    "valids": wv, "strings": ws, "db": db})
                sizes[w] = sum(x.nbytes for x in a.values()) \
                    + sum(x.nbytes for x in v.values()) \
                    + sum(sum(map(len, filter(None, col))) + len(col)
                          for col in s.values())
                rep = self.replicas.get(w)
                if rep is not None:
                    self._call(rep, {
                        "cmd": "load_columns",
                        "table": f"{table}__part{w}", "like": table,
                        "arrays": wa, "valids": wv, "strings": ws, "db": db})
            self._call(w, {"cmd": "place_shards", "table": table,
                           "shards": owners.get(w, []),
                           "bytes": sizes[w]})

        # every owner's load (and its mirror) on its own thread: one
        # worker decodes and ingests while the next partition encodes
        errors: List[Optional[BaseException]] = [None] * len(parts)

        def run(w: int) -> None:
            try:
                load_one(w)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors[w] = e

        threads = [threading.Thread(target=run, args=(w,))
                   for w in range(len(parts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [e for e in errors if e is not None]
        if failed:
            raise failed[0]
        total, total_bytes = sum(loaded), sum(sizes)
        self._partitioned.add(table)
        with self._placement_lock:
            self._placement_bytes[table] = \
                self._placement_bytes.get(table, 0) + total_bytes
        return total

    def _table_columns(self, table: str) -> List[str]:
        """Public column names of a fleet table in schema order, read
        once from the first REACHABLE worker (the coordinator's merge
        session does not hold worker schemas, and one dead worker must
        not take shuffle planning / INSERT routing down with it)."""
        cached = self._table_cols_cache.get(table)
        if cached is not None:
            return cached
        last: Optional[Exception] = None
        for i in range(len(self._socks)):
            try:
                rows = self._call_retry(i, {
                    "cmd": "exec",
                    "sql": f"show columns from `{table}`"})
                break
            except Exception as e:  # noqa: BLE001 — try the next
                last = e            # endpoint; raise the last failure
        else:
            raise ExecutionError(
                f"no worker could describe {table!r}: {last}")
        cols = [r[0] for r in rows]
        self._table_cols_cache[table] = cols
        return cols

    def _check_reshard_fence(self, names) -> None:
        """Refuse statements against a SHARD left in "cutover" by a
        fault (half-swapped: sources may be part-purged, the
        destination not yet installed — either map double-counts or
        drops its rows). Per-shard, not per-table: a healthy online
        reshard never trips this — its cutover windows hide behind the
        table gate instead — and the refusal names the stuck shard so
        the operator knows exactly what recover_reshard() will fix."""
        with self._placement_lock:
            fenced = []
            for n in names:
                rst = self._reshard_state.get(n)
                if rst is None:
                    continue
                stuck = sorted(s for s, v in rst["shards"].items()
                               if v == "cutover")
                if stuck:
                    fenced.append((n, stuck))
        if fenced:
            detail = "; ".join(f"{n!r} shard(s) {sh}" for n, sh in fenced)
            raise ExecutionError(
                f"shard cutover interrupted: {detail} — "
                "Cluster.recover_reshard() finishes the swap")

    def _acquire_read_gate(self, names, session=None) -> List[str]:
        """Statement-side topology gate: shared-acquire the touched
        tables plus CLUSTER_GATE. Bounded — a stuck cutover degrades
        this statement TYPED after the configured wait, never hangs
        it."""
        wait = self.GATE_WAIT_S
        if session is not None:
            try:
                wait = float(session.sysvars.get(
                    "tidb_tpu_reshard_gate_wait_ms")) / 1e3
            except Exception:  # noqa: BLE001 — default stands
                pass
        try:
            return self._gates.acquire_read([*names, CLUSTER_GATE],
                                            timeout_s=wait)
        except TimeoutError as e:
            raise ExecutionError(
                f"topology change in progress: {e}") from None

    def _owner_socket(self, smap, w: int) -> int:
        """Socket index serving a placement's worker index `w`.
        Identity except mid-drain: a table already compacted onto W-1
        workers (its map's n_workers differs from the live socket
        count) routes through the drain translation until
        remove_worker() finalizes the socket list."""
        if (self._drain_xl is not None
                and smap.n_workers != len(self._socks)):
            return self._drain_xl.get(int(w), int(w))
        return int(w)

    def _mid_reshard(self, name: str) -> bool:
        with self._placement_lock:
            return name in self._reshard_state

    def _effective_owner_workers(self, name: str, smap) -> List[int]:
        """Socket indices that may hold live rows of `name` RIGHT NOW:
        the (drain-translated) old-map owners, plus destinations of
        shards already cut over mid-reshard. This is the scan/scatter
        dispatch set while a topology change is in flight."""
        with self._placement_lock:
            rst = self._reshard_state.get(name)
            extra = ({rst["moves"][s][1]
                      for s, v in rst["shards"].items() if v == "done"}
                     if rst is not None else set())
        out = {self._owner_socket(smap, w) for w in smap.owners()}
        out |= extra
        return sorted(w for w in out if 0 <= w < len(self._socks))

    # -- distributed writes: 2PC across shard owners --------------------

    def execute_dml(self, sql: str) -> Dict[str, object]:
        """A write against a sharded table, two-phase-committed across
        the shard owners it touches: INSERT ... VALUES rows route by
        the shard key (literal rows only); UPDATE/DELETE run on every
        owner (each owns a disjoint slice, so the same statement is
        exact fleet-wide), pruned to one owner when the WHERE pins the
        shard column to a literal. During an online reshard the same
        statement ALSO lands on the staging copy of every moved shard
        still in its double-write window — riding the same 2PC, so
        both placements commit or neither. Returns {"xid", "workers"}."""
        stmts = parse(sql)
        if len(stmts) != 1:
            raise UnsupportedError("dcn dml handles a single statement")
        st = stmts[0]
        names = [st.table.name] if hasattr(st, "table") else []
        self._check_reshard_fence(names)
        gate = self._acquire_read_gate(names)
        try:
            if isinstance(st, A.InsertStmt):
                per_worker = self._route_insert(st)
            elif isinstance(st, (A.UpdateStmt, A.DeleteStmt)):
                per_worker = self._route_update_delete(st, sql)
            else:
                raise UnsupportedError(
                    "dcn dml handles INSERT ... VALUES / UPDATE / "
                    "DELETE")
            if self.dml_window_us > 0:
                return self._dml_window.submit(per_worker)
            return self._two_phase(per_worker)
        finally:
            self._gates.release_read(gate)

    def _reshard_snapshot(self, name: str):
        """Point-in-time copy of a table's reshard routing state (or
        None): (per-shard states, double-write set, moves, new map) —
        taken under the placement lock so a statement routes by ONE
        consistent view even as shards flip around it."""
        with self._placement_lock:
            rst = self._reshard_state.get(name)
            if rst is None:
                return None
            return (dict(rst["shards"]), set(rst["dw"]), rst["moves"],
                    rst["new"])

    def _route_insert(self, st) -> Dict[int, object]:
        name = st.table.name
        smap = self.placement(name)
        if smap is None:
            raise ExecutionError(
                f"no shard placement registered for {name!r}")
        if st.rows is None:
            raise UnsupportedError("dcn dml: INSERT ... SELECT")
        cols = st.columns or self._table_columns(name)
        try:
            ki = cols.index(smap.column)
        except ValueError:
            raise UnsupportedError(
                f"dcn dml: INSERT must supply shard column "
                f"{smap.column!r}")
        snap = self._reshard_snapshot(name)
        # (socket, physical table) -> VALUES tuples. Mid-reshard, a row
        # whose NEW shard already cut over routes to its new owner
        # alone; one still backfilling double-writes old owner + the
        # destination's staging copy
        groups: Dict[Tuple[int, str], List[str]] = {}
        for row in st.rows:
            if ki >= len(row):
                raise UnsupportedError("dcn dml: row narrower than the "
                                       "shard column position")
            v = _literal_int(row[ki])
            if v is _NOT_LITERAL:
                raise UnsupportedError(
                    "dcn dml: shard-key values must be integer "
                    "literals (or NULL)")
            vals = "(" + ", ".join(expr_to_sql(e) for e in row) + ")"
            w_old = self._owner_socket(
                smap, smap.worker_of(smap.shard_of(v)))
            if snap is None:
                groups.setdefault((w_old, name), []).append(vals)
                continue
            shards, dw, moves, new = snap
            s_new = new.shard_of(v)
            if shards.get(s_new) == "done":
                groups.setdefault((moves[s_new][1], name),
                                  []).append(vals)
                continue
            groups.setdefault((w_old, name), []).append(vals)
            if s_new in dw:
                groups.setdefault(
                    (moves[s_new][1], f"{name}__bf{s_new}"),
                    []).append(vals)
        collist = ""
        if st.columns:
            collist = " (" + ", ".join(f"`{c}`" for c in st.columns) + ")"
        per: Dict[int, List[str]] = {}
        for (w, tbl), vals in groups.items():
            per.setdefault(w, []).append(
                f"insert into `{tbl}`{collist} values "
                + ", ".join(vals))
        return {w: (sqls[0] if len(sqls) == 1 else sqls)
                for w, sqls in per.items()}

    def _route_update_delete(self, st, sql: str) -> Dict[int, object]:
        name = st.table.name
        smap = self.placement(name)
        if smap is None:
            raise ExecutionError(
                f"no shard placement registered for {name!r}")
        snap = self._reshard_snapshot(name)
        val, found = _shard_eq_value(getattr(st, "where", None),
                                     name, smap.column)
        per: Dict[int, List[str]] = {}

        def add(w: int, s: str) -> None:
            lst = per.setdefault(w, [])
            if s not in lst:
                lst.append(s)

        if found:
            w_old = self._owner_socket(
                smap, smap.worker_of(smap.shard_of(val)))
            if snap is None:
                add(w_old, sql)
            else:
                shards, dw, moves, new = snap
                s_new = new.shard_of(val)
                if shards.get(s_new) == "done":
                    add(moves[s_new][1], sql)
                else:
                    add(w_old, sql)
                    if s_new in dw:
                        add(moves[s_new][1], _rewrite_dml_table(
                            sql, name, f"{name}__bf{s_new}"))
        else:
            for w in smap.owners():
                add(self._owner_socket(smap, w), sql)
            if snap is not None:
                shards, dw, moves, new = snap
                for s, v in shards.items():
                    if v == "done":
                        add(moves[s][1], sql)
                for s in sorted(dw):
                    add(moves[s][1], _rewrite_dml_table(
                        sql, name, f"{name}__bf{s}"))
        return {w: (sqls[0] if len(sqls) == 1 else sqls)
                for w, sqls in per.items()}

    def _two_phase(self, per_worker: Dict[int, object]) -> Dict[str, object]:
        """PREPARE on every participant -> record the commit decision
        (the Percolator primary-write analogue; recover_txns() replays
        it) -> COMMIT everywhere. Failpoints 2pc.prepare / 2pc.commit
        sit on either side of the decision: a fault before it must
        leave every shard aborted, after it committed — never mixed.
        A per-worker value may be a LIST of statements (a coalesced
        write window): they stage inside one participant
        transaction and the whole window costs one round per shard."""
        xid = f"x{os.getpid()}-{next(_TOKEN_SEQ)}"
        parts = sorted(per_worker)
        if not parts:
            return {"xid": xid, "workers": []}
        with self._txn_lock:
            self._txn_pending[xid] = parts
        prepared: List[int] = []
        try:
            inject("2pc.prepare")
            for w in parts:
                stmts = per_worker[w]
                if isinstance(stmts, list):
                    self._call(w, {"cmd": "txn_prepare", "xid": xid,
                                   "sqls": stmts})
                else:
                    self._call(w, {"cmd": "txn_prepare", "xid": xid,
                                   "sql": stmts})
                prepared.append(w)
        except Exception:
            aborted_all = True
            # abort the ACKED participants AND the one whose prepare
            # was in flight: a lost response may have prepared it
            # server-side, and txn_abort is idempotent on the rest
            for w in parts[:len(prepared) + 1]:
                try:
                    self._call(w, {"cmd": "txn_abort", "xid": xid})
                except Exception:  # noqa: BLE001 — recover_txns owns
                    aborted_all = False  # the leftovers
            if aborted_all:
                with self._txn_lock:
                    self._txn_pending.pop(xid, None)
            raise
        # COMMIT POINT: after this record exists the txn IS committed —
        # a crash below re-drives commits from recover_txns()
        with self._txn_lock:
            self._txn_decided[xid] = parts
            self._txn_pending.pop(xid, None)
        inject("2pc.commit")
        errs = []
        for w in parts:
            try:
                self._call(w, {"cmd": "txn_commit", "xid": xid})
            except Exception as e:  # noqa: BLE001 — keep decided entry
                errs.append((w, e))
        if errs:
            # typed: the decision IS recorded, so callers (the DML
            # window especially) must never retry — that double-applies
            raise TwoPhaseCommitIncomplete(
                f"2pc commit {xid} incomplete on workers "
                f"{[w for w, _ in errs]} ({errs[0][1]}); the decision "
                "is recorded — recover_txns() finishes it")
        with self._txn_lock:
            self._txn_decided.pop(xid, None)
        return {"xid": xid, "workers": parts}

    def recover_txns(self) -> Dict[str, str]:
        """Coordinator crash recovery: re-drive COMMIT for every
        decided transaction (idempotent — workers ack unknown xids) and
        ABORT every prepared-but-undecided one. Leaves every shard
        consistent: committed-everywhere or rolled-back-everywhere."""
        with self._txn_lock:
            decided = dict(self._txn_decided)
            pending = dict(self._txn_pending)
        out: Dict[str, str] = {}
        for xid, parts in decided.items():
            ok = True
            for w in parts:
                try:
                    self._call_retry(w, {"cmd": "txn_commit",
                                         "xid": xid})
                except Exception:  # noqa: BLE001 — retry next recover
                    ok = False
            if ok:
                with self._txn_lock:
                    self._txn_decided.pop(xid, None)
                out[xid] = "committed"
        for xid, parts in pending.items():
            ok = True
            for w in parts:
                try:
                    self._call_retry(w, {"cmd": "txn_abort", "xid": xid})
                except Exception:  # noqa: BLE001 — retry next recover
                    ok = False
            if ok:
                with self._txn_lock:
                    self._txn_pending.pop(xid, None)
                out[xid] = "aborted"
        return out

    # -- online resharding -----------------------------------

    def reshard(self, sql: str) -> None:
        """ALTER TABLE ... SHARD BY across the fleet, ONLINE:
        statements keep routing by the OLD map while every moved shard
        backfills into a staging table at its new owner; DML
        double-writes both placements per moved shard; each shard cuts
        over independently behind a brief per-table write gate, only
        after a row-count + order-independent-hash validation against
        its sources. A fault mid-cutover narrows the fence to THAT
        shard; recover_reshard() finishes the run from its per-shard
        watermark. Replica `__part` mirrors rebuild per shard, so
        failover never serves the old placement."""
        stmt = parse(sql)[0]
        if not (isinstance(stmt, A.AlterTableStmt)
                and stmt.action == "reshard"):
            raise UnsupportedError("reshard() takes ALTER ... SHARD BY")
        name = stmt.table.name
        old = self.placement(name)
        if old is None:
            raise ExecutionError(
                f"no shard placement registered for {name!r}")
        from tidb_tpu_torch.sharding.placement import ShardMap

        kind, col, arg = stmt.shard
        W = len(self._socks)
        if kind == "range":
            new = ShardMap("range", col, len(arg) + 1, W, tuple(arg),
                           old.version + 1)
        else:
            new = ShardMap("hash", col, int(arg), W, (), old.version + 1)
        # metadata first, OUTSIDE the reshard state: every worker's
        # schema_version bumps (demoting cached plans), and a failure
        # here leaves nothing to clean up
        self._broadcast_gated(sql)
        self._online_reshard(name, new)

    def _broadcast_gated(self, sql: str) -> None:
        """broadcast_exec inside a brief CLUSTER_GATE write window.
        Every statement and every execute_dml read-acquires that gate
        for its whole run, so while it is held no 2PC can sit between
        its prepare and its commit on any worker — the window in which
        a worker refuses every foreign statement, the ALTER included
        (the reference broadcasts outside every gate and fails there).
        The wait is bounded by GATE_WAIT_S (the default of
        tidb_tpu_reshard_gate_wait_ms); the DDL replay log is appended
        after the gate is released, keeping add_worker's order
        (_membership_lock, then the gate) the only one."""
        try:
            self._gates.acquire_write(CLUSTER_GATE,
                                      timeout_s=self.GATE_WAIT_S)
        except TimeoutError as e:
            raise ExecutionError(
                f"reshard: statements still hold the cluster gate: {e}"
            ) from None
        try:
            self._call_all([{"cmd": "exec", "sql": sql}] * len(self._socks))
        finally:
            self._gates.release_write(CLUSTER_GATE)
        with self._membership_lock:
            self._ddl_log.append(sql)

    def _online_reshard(self, name: str, new) -> None:
        """Shared served-through driver for reshard() and membership
        changes: register the per-shard state machine, then drive it.
        A fault BEFORE anything destructive abandons cleanly (old
        placement keeps serving, unfenced); after the first cutover
        began, state is kept for recover_reshard()."""
        from tidb_tpu_torch.sharding import placement as pl
        from tidb_tpu_torch.utils.metrics import RESHARD_ACTIVE

        old = self.placement(name)
        # drain translation: under remove_worker the NEW map's worker
        # indices live in the compacted space — resolve destinations to
        # live socket indices HERE (a placement-level skip test would
        # compare across the two index spaces and mis-skip)
        translate = self._drain_xl if (
            self._draining is not None
            and new.n_workers < old.n_workers) else None
        same_fn = (old.kind == new.kind and old.column == new.column
                   and old.shards == new.shards
                   and old.bounds == new.bounds)
        moves: Dict[int, Tuple[List[int], int]] = {}
        for s in range(new.shards):
            dst = pl.worker_of_shard(s, new.n_workers)
            if translate is not None:
                dst = translate.get(dst, dst)
            if same_fn:
                src = pl.worker_of_shard(s, old.n_workers)
                if src == dst:
                    continue  # same socket keeps the shard: no move
                moves[s] = ([src], dst)
            else:
                # shard function changed: any old shard can feed any
                # new one, so every old owner is a source
                moves[s] = (sorted(old.owners()), dst)
        sid = f"reshard{os.getpid()}-{next(_TOKEN_SEQ)}"
        state = {"sid": sid, "old": old, "new": new, "moves": moves,
                 "shards": {s: "pending" for s in moves},
                 "dw": set(), "xl": translate}
        with self._placement_lock:
            if name in self._reshard_state:
                raise ExecutionError(
                    f"table {name!r} is already mid-reshard")
            self._reshard_state[name] = state
        RESHARD_ACTIVE.set(1, table=name)
        try:
            self._drive_reshard(name, state)
        except Exception:
            if not self._reshard_destructive(state):
                self._abandon_reshard(name, state)
            raise
        finally:
            with self._placement_lock:
                active = name in self._reshard_state
            RESHARD_ACTIVE.set(1 if active else 0, table=name)

    @staticmethod
    def _reshard_destructive(state: Dict) -> bool:
        """True once any shard reached "cutover": sources may be
        part-purged, so the run can no longer abandon — only recover
        forward."""
        return any(v in ("cutover", "done")
                   for v in state["shards"].values())

    def _drive_reshard(self, name: str, state: Dict) -> None:
        """Advance the state machine from wherever it stands (first run
        and recover_reshard both land here): backfill every pending
        shard — the double-write window opens per shard as it stages —
        then cut each staged/stuck shard over. Validation is skipped
        for shards re-entered in "cutover": their sources may already
        be half-purged, and purge/install are idempotent."""
        for s in sorted(state["shards"]):
            if state["shards"][s] == "pending":
                self._backfill_shard(name, state, s)
        for s in sorted(state["shards"]):
            st = state["shards"][s]
            if st in ("staged", "cutover"):
                self._cutover_shard(name, state, s,
                                    validate=(st == "staged"))
        self._finalize_reshard(name, state)

    def _backfill_shard(self, name: str, state: Dict, s: int) -> None:
        """Copy shard `s`'s live rows from every source owner into the
        staging table at its destination (peer-to-peer, off the
        coordinator's wire). The table's write gate is held across
        extract + double-write enable, so the snapshot and the
        double-write stream tile EXACTLY — no statement can slip a
        write between them (the MVCC extract would miss it or the
        staging would double it)."""
        srcs, dst = state["moves"][s]
        staging = f"{name}__bf{s}"
        peers = [[h, p] for h, p in self._endpoints]
        self._gates.acquire_write(name)
        try:
            for w in srcs:
                self._call(w, {
                    "cmd": "reshard_backfill", "table": name,
                    "staging": staging, "shard": int(s),
                    "map": state["new"].to_wire(),
                    "dest": peers[dst], "dest_index": int(dst),
                    "self_index": int(w)})
            with self._placement_lock:
                state["dw"].add(s)
                state["shards"][s] = "staged"
        finally:
            self._gates.release_write(name)
        from tidb_tpu_torch.utils.metrics import RESHARD_SHARDS_TOTAL

        RESHARD_SHARDS_TOTAL.inc(phase="backfill")

    def _cutover_shard(self, name: str, state: Dict, s: int,
                       validate: bool) -> None:
        """Flip one shard to the new placement behind the table's write
        gate: validate the staging against the sources (row count +
        order-independent hash), record the "cutover" watermark, purge
        the moved rows at the sources, install the staging rows at the
        destination, rebuild the touched replica mirrors — all in ONE
        gate hold, so no statement observes the half-swapped shard.
        Purge runs BEFORE install: when the destination is also a
        source (shard-function change), the installed rows must not be
        re-purged as "moved away"."""
        srcs, dst = state["moves"][s]
        staging = f"{name}__bf{s}"
        new_wire = state["new"].to_wire()
        self._gates.acquire_write(name)
        try:
            if validate:
                # the staging's and the sources' hashes computed at once
                # (the reference asks for them in turn)
                got, *from_srcs = self._call_pairs(
                    [(dst, {"cmd": "reshard_fingerprint", "table": staging})]
                    + [(w, {"cmd": "reshard_fingerprint", "table": name,
                            "map": new_wire, "shard": int(s)}) for w in srcs])
                want_n, want_fp = 0, 0
                for r in from_srcs:
                    want_n += int(r["n"])
                    want_fp = (want_fp + int(r["fp"])) % (1 << 64)
                if want_n != int(got["n"]) or want_fp != int(got["fp"]):
                    raise ExecutionError(
                        f"reshard of {name!r}: shard {s} backfill "
                        f"validation failed (sources n={want_n} "
                        f"fp={want_fp:#x}, staging n={int(got['n'])} "
                        f"fp={int(got['fp']):#x}) — not cutting over")
            # WATERMARK: from here the swap is destructive. Recorded
            # BEFORE the first purge so a fault below fences exactly
            # this shard and recover_reshard() re-drives instead of
            # abandoning
            with self._placement_lock:
                state["shards"][s] = "cutover"
            inject("reshard.cutover")
            for w in srcs:
                self._call(w, {"cmd": "reshard_purge", "table": name,
                               "map": new_wire, "shard": int(s)})
            self._call(dst, {"cmd": "reshard_install", "table": name,
                             "staging": staging, "sid": state["sid"],
                             "shard": int(s)})
            with self._placement_lock:
                state["shards"][s] = "done"
                state["dw"].discard(s)
            for w in sorted({dst, *srcs}):
                self._rebuild_mirror(name, w)
        finally:
            self._gates.release_write(name)
        from tidb_tpu_torch.utils.metrics import RESHARD_SHARDS_TOTAL

        RESHARD_SHARDS_TOTAL.inc(phase="cutover")

    def _finalize_reshard(self, name: str, state: Dict) -> None:
        """Every shard flipped: install the new map as THE placement,
        drop the run state (double-writes stop), and refresh each
        socket's owned-shard listing (the stats surface scans read)."""
        new, xl = state["new"], state["xl"]
        listing: Dict[int, List[int]] = {}
        for w_new, shs in new.owners().items():
            sock = xl.get(w_new, w_new) if xl is not None else w_new
            listing[sock] = shs
        per_bytes = self._placement_bytes.get(name, 0) // max(
            len(self._socks), 1)
        for sock in range(len(self._socks)):
            try:
                self._call(sock, {
                    "cmd": "place_shards", "table": name,
                    "shards": listing.get(sock, []),
                    "bytes": per_bytes if listing.get(sock) else 0})
            except Exception:  # noqa: BLE001 — stats-only surface;
                pass           # the placement install is what counts
        with self._placement_lock:
            self._placements[name] = new
            self._reshard_state.pop(name, None)

    def _abandon_reshard(self, name: str, state: Dict) -> None:
        """A fault before anything destructive: pop the state FIRST
        (DML stops double-writing immediately), then best-effort drop
        the staging tables. The table keeps serving the OLD placement,
        unfenced — the failed run simply never happened."""
        with self._placement_lock:
            self._reshard_state.pop(name, None)
        old_dl = getattr(self._tl, "deadline", None)
        self._tl.deadline = None
        try:
            for s, (_srcs, dst) in state["moves"].items():
                try:
                    self._call(dst, {
                        "cmd": "exec",
                        "sql": f"drop table if exists `{name}__bf{s}`"})
                except Exception:  # noqa: BLE001 — worker may be gone;
                    pass           # a later load re-clones over it
        finally:
            self._tl.deadline = old_dl

    def recover_reshard(self) -> Dict[str, str]:
        """Finish interrupted ONLINE reshards from their per-shard
        watermark: pending shards re-backfill, staged shards validate
        and cut over, shards stuck in "cutover" re-drive their
        idempotent purge/install. Tables that finish report
        'resharded'; still-failing ones stay fenced on their stuck
        shard."""
        with self._placement_lock:
            pending = dict(self._reshard_state)
        out: Dict[str, str] = {}
        for name, state in pending.items():
            try:
                self._drive_reshard(name, state)
                out[name] = "resharded"
            except Exception:  # noqa: BLE001 — stays fenced; the next
                continue       # recover_reshard() retries
        return out

    def reshard_progress_rows(self) -> List[tuple]:
        """information_schema.cluster_info rows: one per moved shard of
        every in-flight reshard (operators watch cutover progress and
        spot fenced shards), plus a fleet summary row."""
        out: List[tuple] = []
        with self._placement_lock:
            snap = {n: (st["old"].version, st["new"].version,
                        dict(st["shards"]),
                        {s: m[1] for s, m in st["moves"].items()})
                    for n, st in self._reshard_state.items()}
        drain = self._draining
        out.append(("__fleet__", -1, "serving", -1,
                    -1, -1, len(self._socks),
                    drain if drain is not None else -1))
        for name in sorted(snap):
            old_v, new_v, shards, dsts = snap[name]
            for s in sorted(shards):
                out.append((name, int(s), shards[s], int(dsts[s]),
                            int(old_v), int(new_v), len(self._socks),
                            drain if drain is not None else -1))
        return out

    def _rebuild_mirror(self, name: str, w: int) -> None:
        """Re-mirror socket `w`'s slice of `name` into its replica's
        `__part{w}` table from a fresh dump: after a cutover or a fleet
        compaction, failover must serve the NEW placement — a stale
        mirror would silently resurrect the old one."""
        rep = self.replicas.get(int(w))
        if rep is None or not (0 <= rep < len(self._socks)):
            return
        dump = self._call(int(w), {"cmd": "table_dump", "table": name})
        self._call(rep, {
            "cmd": "load_columns", "table": f"{name}__part{int(w)}",
            "like": name, "replace": True, "arrays": dump["arrays"],
            "valids": dump["valids"], "strings": dump["strings"]})

    # -- elastic membership ----------------------------------

    def _placement_names(self) -> List[str]:
        with self._placement_lock:
            return sorted(self._placements)

    def add_worker(self, host: str, port: int) -> int:
        """Admit a new worker into the serving fleet: dial it, replay
        the DDL history so its schema matches, seed the broadcast
        tables, then rebalance every placed table onto the widened
        fleet via the online reshard path (round-robin remap — the
        co-location identity holds for the new W). Statements only
        pause for the brief CLUSTER_GATE write window that appends the
        socket; a failure during admission rolls the fleet back to W
        workers, typed — never half-admitted. Returns the new index."""
        from tidb_tpu_torch.sharding.placement import with_n_workers
        from tidb_tpu_torch.utils.metrics import MEMBERSHIP_TOTAL

        with self._membership_lock:
            if self._draining is not None:
                raise ExecutionError(
                    "membership change already in progress (worker "
                    f"{self._draining} is draining)")
            inject("member.join")
            sock = self._connect(host, port)
            self._gates.acquire_write(CLUSTER_GATE)
            try:
                i = len(self._socks)
                self._socks.append(sock)
                self._endpoints.append((host, port))
                self._sock_locks.append(threading.Lock())
                self._health.append(_LinkHealth())
                try:
                    self._set_state(i, UP)
                    for ddl_sql in list(self._ddl_log):
                        self._call(i, {"cmd": "exec", "sql": ddl_sql})
                    for t in sorted(self._broadcast):
                        dump = self._call(0, {"cmd": "table_dump",
                                              "table": t})
                        self._call(i, {
                            "cmd": "load_columns", "table": t,
                            "replace": True, "arrays": dump["arrays"],
                            "valids": dump["valids"],
                            "strings": dump["strings"]})
                except Exception as e:
                    self._socks.pop()
                    self._endpoints.pop()
                    self._sock_locks.pop()
                    self._health.pop()
                    try:
                        sock.close()
                    except Exception:  # noqa: BLE001 — best effort
                        pass
                    raise ExecutionError(
                        f"add_worker({host}:{port}) failed during "
                        f"admission: {e}") from e
            finally:
                self._gates.release_write(CLUSTER_GATE)
            MEMBERSHIP_TOTAL.inc(kind="join")
            # rebalance each placed table onto the widened fleet,
            # served through — the joiner starts taking real traffic
            # shard by shard as cutovers land
            for name in self._placement_names():
                smap = self.placement(name)
                if smap is not None \
                        and smap.n_workers != len(self._socks):
                    self._online_reshard(
                        name, with_n_workers(smap, len(self._socks)))
            return i

    def remove_worker(self, j: int, graceful: bool = True) -> None:
        """Drain worker `j` out of the fleet: every placed table
        reshards online onto the surviving W-1 workers (the drain
        translation keeps already-compacted maps routable mid-drain),
        then the socket list compacts under the CLUSTER_GATE write
        window and every replica mirror rebuilds against the new
        placement. RESUMABLE: a fault mid-drain (the draining worker
        dying included) degrades typed with `_draining` kept — tables
        already moved keep serving the new placement, the rest the old
        one — and a second remove_worker(j) picks up where it left
        off. graceful=False skips the data move and is refused while
        any sharded/partitioned table still places rows."""
        from tidb_tpu_torch.sharding.placement import with_n_workers
        from tidb_tpu_torch.utils.metrics import MEMBERSHIP_TOTAL

        with self._membership_lock:
            W = len(self._socks)
            if not (0 <= j < W):
                raise ExecutionError(f"remove_worker: no worker {j}")
            if W <= 1:
                raise ExecutionError(
                    "remove_worker: cannot remove the last worker")
            if self._draining is not None and self._draining != j:
                raise ExecutionError(
                    f"worker {self._draining} is already draining")
            placed_names = self._placement_names()
            loose = sorted(t for t in self._partitioned
                           if t not in placed_names
                           and t not in self._broadcast)
            if loose:
                # row-range tables placed by hand (load_partition) have
                # no ShardMap to drive a drain — moving them silently
                # would break the caller's explicit placement
                raise UnsupportedError(
                    f"remove_worker: table(s) {loose} are partitioned "
                    "by hand (load_partition) — move them explicitly "
                    "first")
            if not graceful and placed_names:
                raise UnsupportedError(
                    "remove_worker(graceful=False) would strand rows "
                    f"of {placed_names} — drain gracefully instead")
            inject("member.drain")
            self._draining = j
            self._drain_xl = {c: (c if c < j else c + 1)
                              for c in range(W - 1)}
            if graceful:
                for name in placed_names:
                    smap = self.placement(name)
                    if smap is not None and smap.n_workers == W:
                        self._online_reshard(
                            name, with_n_workers(smap, W - 1))
            # finalize: compact the fleet under the cluster gate (no
            # statement is mid-flight over the dying index)
            self._gates.acquire_write(CLUSTER_GATE)
            try:
                sock = self._socks.pop(j)
                self._endpoints.pop(j)
                self._sock_locks.pop(j)
                self._health.pop(j)
                self.replicas = {
                    (w if w < j else w - 1): (r if r < j else r - 1)
                    for w, r in self.replicas.items()
                    if w != j and r != j}
                self._draining = None
                self._drain_xl = None
                try:
                    if sock is not None:
                        sock.close()
                except Exception:  # noqa: BLE001 — already dead is fine
                    pass
            finally:
                self._gates.release_write(CLUSTER_GATE)
            MEMBERSHIP_TOTAL.inc(kind="remove")
            # re-mirror every owner's slice in the COMPACTED index
            # space: `__part{w}` names shifted for workers past j, and
            # a failover must serve the new placement
            for name in placed_names:
                smap = self.placement(name)
                if smap is not None:
                    for w in sorted(smap.owners()):
                        self._rebuild_mirror(name, w)

    def _shuffle_close_all(self, sid: str, targets) -> None:
        """Best-effort release of a shuffle's staged state fleet-wide
        (the statement's spent deadline must not strangle cleanup —
        same rule as _close_cursor)."""
        old_dl = getattr(self._tl, "deadline", None)
        self._tl.deadline = None
        try:
            for i in targets:
                try:
                    self._call(i, {"cmd": "shuffle_close",
                                   "shuffle_id": sid})
                except Exception:  # noqa: BLE001 — the worker may be
                    pass           # gone; its TTL reaper backstops
        finally:
            self._tl.deadline = old_dl

    # coordinator-side streaming: one page per round trip; the staging
    # table (columnar, engine-managed) is the only full-volume buffer
    PAGE_ROWS = 8192

    def _drain_pages(self, i: int, first: Dict, cancel=None) -> List[tuple]:
        """Collect one worker's partial from its first page + cursor.
        Bounded: a fetch page that comes back EMPTY while rows are still
        owed means the cursor stopped advancing (worker restarted and
        re-issued cursor ids, or evicted ours) — raise a clean error
        instead of fetching the same offset forever."""
        rows = list(first["rows"])
        cur = first.get("cursor")
        total = int(first["total"])
        while cur is not None and len(rows) < total:
            if cancel is not None:
                r = cancel()
                if r is not None:
                    raise r
            inject("dcn.coord.fetch")
            page = self._call(i, {"cmd": "fetch", "cursor": cur,
                                  "offset": len(rows),
                                  "page_rows": self.PAGE_ROWS})
            if not page:
                raise ExecutionError(
                    f"dcn worker {i}: cursor {cur} stopped advancing at "
                    f"{len(rows)}/{total} rows (restarted worker or "
                    "evicted cursor)")
            rows.extend(page)
        return rows

    def _close_cursor(self, i: int, cursor) -> None:
        """Best-effort release of a worker-held partial cursor. The
        socket state is only examined INSIDE _call's per-socket lock —
        checking it out here raced a concurrent _call marking the worker
        dead and could slip a send onto a closing socket. A dead LINK
        (worker alive, cursor pinned) reconnects via the health machine
        and releases for real; a dead WORKER fails fast once the
        circuit opens, and its restart has no cursors anyway."""
        if cursor is None:
            return
        # cleanup runs AFTER a deadline expiry too: the statement's
        # spent budget must not strangle the release RPC itself (the
        # rpc timeout still bounds it)
        old_dl = getattr(self._tl, "deadline", None)
        self._tl.deadline = None
        try:
            self._call(i, {"cmd": "close_cursor", "cursor": cursor})
        except Exception:  # noqa: BLE001 — the worker may be gone
            pass
        finally:
            self._tl.deadline = old_dl

    def _failover_partial(self, i: int, sql: str, err: Exception,
                          open_cursors: List, cancel=None,
                          tokens: Optional[List[str]] = None) -> List[tuple]:
        """A dead worker's partition re-runs on its replica (reading
        `<table>__part<i>`); the replica's cursor is tracked in
        `open_cursors` so a second failure can't leak it."""
        rep = self.replicas.get(i)
        if rep is None:
            raise err
        from tidb_tpu_torch.utils.metrics import DCN_FAILOVER_TOTAL

        # a failover is a headline tail-sampling event: keep the trace
        # and give the re-run its own span so the assembled tree shows
        # which replica absorbed the partition
        tracing.keep("failover")
        fo_span = tracing.begin(f"dcn.failover[w{i}->w{rep}]")
        if fo_span is not None:
            fo_span.notes.append(f"cause:{type(err).__name__}")
        tables = _from_tables(parse(sql)[0].from_)
        parts = [t.name for t in tables if t.name in self._partitioned]
        tname = parts[0] if parts else tables[0].name
        rep_sql, _f, _n = partial_rewrite(
            sql, table_as=f"{tname}__part{i}",
            partitioned=self._partitioned, broadcast=self._broadcast)
        msg = {"cmd": "partial_paged", "sql": rep_sql,
               "page_rows": self.PAGE_ROWS, "attempt": 1}
        if tokens:
            # DISTINCT token: the replica may still hold its OWN
            # partition's cursor under the main token (its drain comes
            # later in the sequential pass) — reusing the token would
            # evict it mid-query. Appended to the query's token list so
            # a KILL's cancel fan-out reaches this re-run too.
            fo_token = f"{tokens[0]}-fo{i}"
            tokens.append(fo_token)
            msg["token"] = fo_token
        dl = getattr(self._tl, "deadline", None)
        if dl is not None:
            msg["deadline_s"] = max(dl - time.monotonic(), 1e-3)
        try:
            first = self._call_retry(rep, msg)
            DCN_FAILOVER_TOTAL.inc()
            ent = [rep, first.get("cursor")]
            open_cursors.append(ent)
            rows = self._drain_pages(rep, first, cancel)
            open_cursors.remove(ent)
            return rows
        finally:
            tracing.finish(fo_span)

    def cancel_token(self, token: str) -> None:
        self.cancel_tokens([token])

    def cancel_tokens(self, tokens: List[str]) -> None:
        """Tell every worker to stop the in-flight statements registered
        under `tokens` (the statement's own token plus any failover
        re-runs it spawned). Dials a FRESH connection per worker: the
        primary sockets are busy carrying the very RPCs being
        cancelled. All dials run CONCURRENTLY — a KILL must not queue
        behind connect timeouts to unreachable workers. Best effort —
        an unreachable worker has nothing running that anyone will wait
        on past its socket deadline."""
        from tidb_tpu_torch.utils.metrics import DCN_CANCEL_TOTAL

        DCN_CANCEL_TOTAL.inc()
        # the dial threads have no tracing context of their own: hand
        # them the calling statement's trace so each worker's cancel
        # observation spans assemble under one dcn.cancel span
        tr = tracing.current()
        sp = (tr.begin("dcn.cancel", tracing.current_span_id())
              if tr is not None else None)
        dials = [threading.Thread(
            target=self._cancel_endpoint,
            args=(i, tok, tr, sp.span_id if sp is not None else None),
            daemon=True)
            for i in range(len(self._endpoints)) for tok in tokens]
        for t in dials:
            t.start()
        for t in dials:
            t.join()
        if tr is not None:
            tr.end(sp)

    def _cancel_endpoint(self, i: int, token: str, tr=None,
                         parent_id=None) -> None:
        """Best-effort cancel dial to ONE worker on a fresh connection.
        `tr`/`parent_id` (optional) carry the statement's trace: the
        cancel RPC ships trace context so the worker's observation
        (token, was-it-in-flight) comes back as a grafted span."""
        from tidb_tpu_torch.utils.metrics import DCN_RETRY_TOTAL

        host, port = self._endpoints[i]
        sp = (tr.begin(f"dcn.cancel_dial[w{i}]", parent_id)
              if tr is not None else None)
        try:
            s = self._connect(host, port,
                              timeout=self.CANCEL_DIAL_TIMEOUT_S)
            try:
                s.settimeout(self.CANCEL_DIAL_TIMEOUT_S)
                msg = {"cmd": "cancel", "token": token}
                if tr is not None and sp is not None:
                    msg["trace_id"] = tr.trace_id
                _send(s, msg)
                resp = _recv(s)
                if tr is not None and sp is not None \
                        and isinstance(resp, dict) and resp.get("trace"):
                    tr.graft(resp["trace"], sp, proc=f"{host}:{port}")
            finally:
                s.close()
            DCN_RETRY_TOTAL.inc(kind="cancel_dial")
        except Exception:  # noqa: BLE001 — best-effort side channel
            if sp is not None:
                sp.notes.append("unreachable")
        finally:
            if tr is not None:
                tr.end(sp)

    # -- distributed planning: owner pruning + exchange choice ----------

    def _plan_query(self, sql: str, session=None) -> Dict:
        """Owner-pruned targets and (when two sharded tables join) the
        exchange plan. Placement is snapshotted HERE, at statement
        start: a reshard racing this statement bumps the map version
        but never changes routing mid-flight. The returned plan carries
        the statement's topology read-gate in "gate" — query() releases
        it when the statement finishes (a planning failure releases it
        here)."""
        st = None
        tables: List = []
        try:
            stmts = parse(sql)
            if len(stmts) == 1 and isinstance(stmts[0], A.SelectStmt):
                st = stmts[0]
                tables = _from_tables(st.from_)
        except Exception:  # noqa: BLE001 — malformed/unsupported
            st, tables = None, []  # shapes: let partial_rewrite raise
        names = [t.name for t in tables]
        self._check_reshard_fence(names)
        gate = self._acquire_read_gate(names, session)
        try:
            placed = {}
            for t in tables:
                m = self.placement(t.name)
                if m is not None and t.name not in placed:
                    placed[t.name] = m
            if st is not None and len(placed) >= 2:
                plan = self._plan_shuffle(sql, st, tables, placed)
                plan["gate"] = gate
                return plan
            partial_sql, final_sql, _names = partial_rewrite(
                sql, partitioned=self._partitioned,
                broadcast=self._broadcast,
                parsed=[st] if st is not None else None)
            targets = None
            if len(placed) == 1:
                name, smap = next(iter(placed.items()))
                targets = self._effective_owner_workers(name, smap)
                val, found = _shard_eq_value(st.where, name, smap.column)
                if found:
                    snap = self._reshard_snapshot(name)
                    if snap is not None:
                        # pinned scan mid-reshard: a cut-over shard's
                        # rows live at the new owner, everything else
                        # still serves from the old one
                        shards, _dw, moves, new = snap
                        s_new = new.shard_of(val)
                        if shards.get(s_new) == "done":
                            targets = [moves[s_new][1]]
                        else:
                            targets = [self._owner_socket(
                                smap,
                                smap.worker_of(smap.shard_of(val)))]
                    else:
                        w = self._owner_socket(
                            smap, smap.worker_of(smap.shard_of(val)))
                        if w in targets:
                            targets = [w]
                from tidb_tpu_torch.utils.metrics import SHARD_SCAN_TOTAL

                pruned = len(targets) < len(self._socks)
                SHARD_SCAN_TOTAL.inc(pruned="yes" if pruned else "no")
            return {"partial_sql": partial_sql, "final_sql": final_sql,
                    "targets": targets, "shuffle": None, "gate": gate}
        except BaseException:
            self._gates.release_read(gate)
            raise

    def _resolve_ename(self, e: A.EName, tables, cols_by_table):
        """Base table an EName belongs to (qualifier match first, else
        the unique table carrying that column name); None = ambiguous
        or unknown."""
        if e.qualifier:
            for t in tables:
                if e.qualifier in (t.name, t.alias):
                    return t.name
            return None
        hits = [t.name for t in {t.name: t for t in tables}.values()
                if e.name in cols_by_table.get(t.name, ())]
        return hits[0] if len(hits) == 1 else None

    def _used_columns(self, st, tables, cols_by_table) -> Dict[str, List[str]]:
        """Per-table column set the query references — what an exchange
        must ship. SELECT * ships everything."""
        if any(isinstance(e, A.EStar) for e in _walk_exprs(st.items)):
            return {t.name: list(cols_by_table[t.name]) for t in tables}
        used: Dict[str, set] = {t.name: set() for t in tables}
        for e in _walk_exprs((st.items, st.where, st.group_by,
                              st.order_by, st.from_)):
            if isinstance(e, A.EName):
                owner = self._resolve_ename(e, tables, cols_by_table)
                if owner is not None \
                        and e.name in cols_by_table.get(owner, ()):
                    used[owner].add(e.name)
        return {n: [c for c in cols_by_table[n] if c in s]
                for n, s in used.items()}

    def _plan_shuffle(self, sql: str, st, tables, placed) -> Dict:
        """Exchange plan for a join of two sharded tables. Per side:
        `local` (hash-placed on its join key with shards % W == 0 —
        already co-located with the shuffle's destinations), `broadcast`
        (replicating the small side costs less than hashing both:
        small*(W-1) < big, under the broadcast byte cap), else
        `shuffle`. The broadcast-vs-shuffle choice is exactly the
        shard-map-cardinality rule ROADMAP item 2 names."""
        if len(placed) != 2:
            raise UnsupportedError(
                "dcn shuffle join supports exactly two sharded tables "
                f"(got {sorted(placed)})")
        W = len(self._socks)
        cols_by_table = {t.name: self._table_columns(t.name)
                        for t in {t.name: t for t in tables}.values()}
        keys: Dict[str, str] = {}
        for le, re_ in _equi_name_pairs(st):
            ta = self._resolve_ename(le, tables, cols_by_table)
            tb = self._resolve_ename(re_, tables, cols_by_table)
            if ta in placed and tb in placed and ta != tb:
                keys = {ta: le.name, tb: re_.name}
                break
        if not keys:
            raise UnsupportedError(
                "dcn shuffle join needs an equality condition between "
                "the two sharded tables")
        used = self._used_columns(st, tables, cols_by_table)
        with self._placement_lock:
            bytes_ = {n: self._placement_bytes.get(n, 1 << 62)
                      for n in placed}
        # plan feedback (consumer a): a previous execution of
        # this digest RECORDED each exchanged side's actual wire bytes
        # (scatter acks, summed per side). Observed bytes beat the raw
        # placement sizes — a query shipping two narrow columns of a
        # wide table can broadcast where the table's own size says
        # shuffle. The choice only picks among correct exchange plans.
        fb_digest = ""
        pversions = {n: int(getattr(placed[n], "version", 0))
                     for n in placed}
        try:
            from tidb_tpu_torch.bindinfo import normalize_sql, sql_digest

            from tidb_tpu_torch.planner.feedback import STORE as _fb_store

            fb_digest = sql_digest(normalize_sql(sql))
            hint = _fb_store.shuffle_hint(fb_digest, pversions)
            for n, nb in hint.items():
                if n in bytes_:
                    bytes_[n] = int(nb)
        except Exception:  # noqa: BLE001 — feedback is advisory only
            fb_digest = ""
        names = sorted(placed, key=lambda n: bytes_[n])
        small, big = names[0], names[1]
        modes: Dict[str, str] = {}
        for n in placed:
            # co-location only holds when the map was resolved against
            # the CURRENT fleet width and no shard is mid-flight to a
            # different owner (reshard/drain): otherwise re-shuffle —
            # the scatter sources below cover both placements
            if placed[n].colocated_on(keys[n]) \
                    and placed[n].n_workers == W \
                    and not self._mid_reshard(n):
                modes[n] = "local"
        if len(modes) < 2:
            if not modes and bytes_[small] <= self.BROADCAST_LIMIT_BYTES \
                    and bytes_[small] * max(W - 1, 0) < bytes_[big]:
                modes[small] = "broadcast"
                modes[big] = "local"
            else:
                for n in placed:
                    modes.setdefault(n, "shuffle")
        sid = f"sh{os.getpid()}-{next(_TOKEN_SEQ)}"
        # gather runs on every worker when a side is hash-shuffled
        # (each worker owns a hash range of the key space); with only
        # local+broadcast sides, the placed local side's owners suffice
        # — and the broadcast replicates to exactly that gather set
        if any(m == "shuffle" for m in modes.values()):
            targets = list(range(W))
        else:
            loc = next(n for n in placed if modes[n] == "local")
            targets = self._effective_owner_workers(loc, placed[loc])
        renames: Dict[str, str] = {}
        sides: List[Dict] = []
        scatter: List[Tuple[int, Dict]] = []
        peers = [[h, p] for h, p in self._endpoints]
        for n in placed:
            if modes[n] == "local":
                continue
            cols = sorted(set(used.get(n) or []) | {keys[n]})
            temp = f"__shuffle_{sid.replace('-', '_')}_{n}"
            renames[n] = temp
            sides.append({"table": n, "temp": temp, "side": n,
                          "columns": cols})
            wire_map = {"kind": "hash", "column": keys[n], "shards": W,
                        "n_workers": W, "bounds": [], "version": 0}
            for w in self._effective_owner_workers(n, placed[n]):
                msg = {"cmd": "shuffle_scatter", "shuffle_id": sid,
                       "table": n, "side": n, "columns": cols,
                       "n_workers": W, "self_index": w, "peers": peers}
                if modes[n] == "broadcast":
                    msg.update(mode="broadcast", dests=targets)
                else:
                    msg.update(mode="hash", key=keys[n], map=wire_map)
                scatter.append((w, msg))
        partial_sql, final_sql, _names = partial_rewrite(
            sql, partitioned=self._partitioned, broadcast=self._broadcast,
            renames=renames, co_partitioned=frozenset(placed),
            parsed=[st])
        from tidb_tpu_torch.utils.metrics import SHARD_SCAN_TOTAL

        SHARD_SCAN_TOTAL.inc(
            pruned="yes" if len(targets) < W else "no")
        return {"partial_sql": partial_sql, "final_sql": final_sql,
                "targets": targets,
                "shuffle": {"id": sid, "scatter": scatter,
                            "sides": sides, "digest": fb_digest,
                            "pversions": pversions}}

    def _run_scatter(self, shuffle: Dict, cancel_reason) -> None:
        """Phase A of a shuffle query: every owner of every exchanged
        side partitions + ships its rows, concurrently. The phase is a
        BARRIER — gathers only dispatch after every scatter acked, so
        a worker's inbox provably holds its complete slice."""
        work = shuffle["scatter"]
        if not work:
            return
        with tracing.span(f"dcn.scatter[{len(work)}]"):
            errs: List[Optional[Exception]] = [None] * len(work)
            deadline = getattr(self._tl, "deadline", None)
            rpc_timeout = getattr(self._tl, "rpc_timeout", None)
            # scatter threads carry the statement's trace exactly like
            # the dispatch threads in _query_inner: without the push,
            # _call sees no trace, ships no trace_id, and the worker's
            # peer re-dispatch has no context to propagate (the
            # envelope must survive EVERY fan-out hop)
            tr = tracing.current()
            scatter_parent = tracing.current_span_id()

            def run(j, w, msg):
                self._tl.deadline = deadline
                self._tl.rpc_timeout = rpc_timeout
                sp = None
                if tr is not None:
                    sp = tr.begin(f"dcn.scatter_send[w{w}]",
                                  scatter_parent)
                    tracing.push(tr, sp)
                try:
                    if deadline is not None:
                        # remaining budget rides the scatter twice:
                        # timeout_s bounds the worker's own peer
                        # sockets, deadline_s arms the server-side
                        # budget the worker PROPAGATES into its
                        # shuffle_stage re-sends (the envelope)
                        rem = max(deadline - time.monotonic(), 1e-3)
                        msg = dict(msg, timeout_s=rem, deadline_s=rem)
                    acks[j] = self._call(w, msg)
                except Exception as e:  # noqa: BLE001
                    errs[j] = e
                    if sp is not None:
                        sp.notes.append(f"error:{type(e).__name__}")
                finally:
                    if tr is not None:
                        tracing.pop()
                        tr.end(sp)

            acks: List[Optional[Dict]] = [None] * len(work)
            threads = [threading.Thread(target=run, args=(j, w, m),
                                        daemon=True)
                       for j, (w, m) in enumerate(work)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            failed = [e for e in errs if e is not None]
            if failed:
                raise failed[0]
            r = cancel_reason()
            if r is not None:
                raise r
            # plan feedback: the scatter acks carry each owner's
            # exchange bytes — shipped wire bytes PLUS the locally
            # staged self-copy (part of the volume even though it never
            # crossed a socket). Summed per side they are what the NEXT
            # planning of this digest sizes broadcast-vs-shuffle with;
            # a broadcast ack covers len(dests) identical copies, so
            # normalize to the one-copy payload.
            digest = shuffle.get("digest")
            if digest:
                side_bytes: Dict[str, int] = {}
                for (w, msg), ack in zip(work, acks):
                    if not isinstance(ack, dict):
                        continue
                    nb = (int(ack.get("bytes") or 0)
                          + int(ack.get("local_bytes") or 0))
                    if msg.get("mode") == "broadcast":
                        nb = nb // max(len(msg.get("dests") or [1]), 1)
                    side = str(msg.get("side"))
                    side_bytes[side] = side_bytes.get(side, 0) + nb
                if side_bytes:
                    from tidb_tpu_torch.planner.feedback import STORE as _fbs

                    _fbs.record_shuffle(digest, side_bytes,
                                        shuffle.get("pversions"))

    def query(self, sql: str, schema_sql: Optional[str] = None,
              session=None, timeout_s: Optional[float] = None,
              cancel=None) -> List[tuple]:
        """Distributed aggregate / TopN: partial on every worker, final
        merge here. schema_sql overrides the staging table DDL; by
        default column types are inferred from the partial rows.

        The merge is streaming: workers compute partials concurrently
        but hold their own result behind a cursor; the coordinator
        drains one worker at a time in PAGE_ROWS pages straight into the
        columnar staging table (bulk insert_rows, no SQL-literal round
        trip), so its transient footprint is one partition's partial —
        not the union of all of them. A worker that dies before its
        partition was ingested fails over to its replica; the final SQL
        then runs on the coordinator's own engine, whose memory tracker/
        spill machinery bounds the merge itself. The coordinator holds
        no state workers depend on, so a replacement coordinator can
        re-attach to the same workers and re-run (see
        test_dcn.py::test_coordinator_restart).

        Failure domain: `session` ties the query to a Session — its
        max_execution_time becomes the statement deadline (shipped to
        workers as each RPC's remaining budget), its
        tidb_tpu_dcn_rpc_timeout bounds each round trip, and a KILL
        QUERY/CONNECTION against it interrupts the coordinator-side
        join AND fans a cancel out to every worker. `timeout_s`
        overrides the deadline; `cancel` is an extra callable polled
        alongside. When a partition's primary AND replica are
        unreachable the query fails fast, unless partial results were
        opted into (constructor flag or tidb_tpu_dcn_partial_results) —
        then reachable partitions are served and a warning is recorded
        in `last_warnings` (and the session's warning area).

        Sharded placement: a scan of a SHARD BY table
        dispatches ONLY to the workers owning its shards (one worker
        when the WHERE pins the shard key to a literal — non-owners do
        no work, observable in their `stats` counters); a join of two
        sharded tables runs as a cross-process SHUFFLE (or broadcast,
        when the smaller side is cheaper to replicate) with the partial
        agg computed over each worker's co-partitioned slice."""
        plan = self._plan_query(sql, session)
        partial_sql, final_sql = plan["partial_sql"], plan["final_sql"]

        rpc_timeout = self.rpc_timeout_s
        budget_s = timeout_s
        partial_ok = self.partial_results
        if session is not None:
            # this call is the session's "statement": like
            # _execute_timed, entering it consumes any stale one-shot
            # KILL QUERY aimed at a PREVIOUS query
            session._kill_query = False
            to_ms = int(session.sysvars.get("tidb_tpu_dcn_rpc_timeout"))
            rpc_timeout = to_ms / 1e3 if to_ms > 0 else None
            if budget_s is None:
                met = int(session.sysvars.get("max_execution_time"))
                budget_s = met / 1e3 if met > 0 else None
            partial_ok = partial_ok or bool(
                session.sysvars.get("tidb_tpu_dcn_partial_results"))
        deadline = (time.monotonic() + budget_s
                    if budget_s is not None else None)
        token = f"q{os.getpid()}-{next(_TOKEN_SEQ)}"
        self.last_warnings = []

        def cancel_reason():
            if session is not None:
                r = session.cancel_reason()
                if r is not None:
                    return r
            if cancel is not None and cancel():
                return QueryKilledError(
                    "Query execution was interrupted (KILL)")
            if deadline is not None and time.monotonic() > deadline:
                return QueryTimeoutError(
                    "Query execution was interrupted, maximum statement "
                    "execution time exceeded")
            return None

        # this call is statement-shaped: when no trace is installed on
        # the thread (standalone Python-API use) it owns one, with the
        # same tail rules as Session._execute_timed; inside a session
        # statement it nests into the statement's trace instead
        owns_trace = tracing.current() is None
        tr = tracing.current()
        if owns_trace:
            try:
                from tidb_tpu_torch.bindinfo import normalize_sql, sql_digest

                digest = sql_digest(normalize_sql(sql))
            except Exception:  # noqa: BLE001 — diagnostics only
                digest = ""
            rate = (float(session.sysvars.get("tidb_trace_sample_rate"))
                    if session is not None else 0.0)
            tr = tracing.Trace(tracing.make_trace_id(digest),
                               sampled=tracing.head_sampled(rate))
            tracing.push(tr)
        root_span = tracing.begin("dcn.query")
        t_q = time.perf_counter()
        err: Optional[BaseException] = None
        old_dl = getattr(self._tl, "deadline", None)
        old_to = getattr(self._tl, "rpc_timeout", None)
        self._tl.deadline = deadline
        self._tl.rpc_timeout = rpc_timeout
        shuffle = plan.get("shuffle")
        try:
            if shuffle is not None:
                self._run_scatter(shuffle, cancel_reason)
            return self._query_inner(
                sql, partial_sql, final_sql, schema_sql, session,
                deadline, rpc_timeout, token, cancel_reason, partial_ok,
                targets=plan.get("targets"),
                gather=shuffle,
                failover_ok=shuffle is None)
        except BaseException as e:
            err = e
            raise
        finally:
            if shuffle is not None:
                # release staged exchange state fleet-wide (EVERY
                # worker — a broadcast may have staged onto non-gather
                # workers) — on success the gathers already closed
                # their own; this is the error backstop (chaos grid
                # asserts zero retained)
                self._shuffle_close_all(shuffle["id"],
                                        range(len(self._socks)))
            if plan.get("gate") is not None:
                self._gates.release_read(plan["gate"])
            self._tl.deadline = old_dl
            self._tl.rpc_timeout = old_to
            self._finish_query_trace(tr, root_span, owns_trace, err,
                                     time.perf_counter() - t_q, session)

    @staticmethod
    def _finish_query_trace(tr, root_span, owns: bool, err, dur_s: float,
                            session) -> None:
        """Tail rules for a standalone Cluster.query trace (nested calls
        just close their dcn.query span — the owning statement decides)."""
        try:
            tracing.finish(root_span)
            if not owns or tr is None:
                return
            thresh_ms = (int(session.sysvars.get("tidb_slow_log_threshold"))
                         if session is not None else 300)
            cap = (int(session.sysvars.get("tidb_trace_store_capacity"))
                   if session is not None else None)
            tracing.apply_tail_rules(tr, dur_s, thresh_ms, error=err,
                                     capacity=cap)
        except Exception:  # noqa: BLE001 — diagnostics never fail a query
            pass

    def _query_inner(self, sql, partial_sql, final_sql, schema_sql,
                     session, deadline, rpc_timeout, token,
                     cancel_reason, partial_ok, targets=None,
                     gather=None, failover_ok=True) -> List[tuple]:
        # kick every TARGET worker's partial concurrently (`targets` is
        # the shard-owner set for placed tables — non-owners get NO rpc
        # and do NO work; None = the whole fleet); each returns only
        # its first page (the rest waits behind the worker's cursor).
        # The message carries the statement's REMAINING budget and the
        # cancel token so the worker enforces both server-side. With
        # `gather` set the dispatch is a shuffle_gather (same response
        # shape, cursors, and tokens as partial_paged).
        ws = list(targets) if targets is not None \
            else list(range(len(self._socks)))
        firsts: List = [None] * len(self._socks)
        errs: List = [None] * len(self._socks)
        # coordinator dispatch spans: one per worker, recorded directly
        # on the trace object (the dispatch threads install it on their
        # own thread-local context so _call's rpc spans nest under them)
        tr = tracing.current()
        dispatch_parent = tracing.current_span_id()

        def start(i):
            self._tl.deadline = deadline
            self._tl.rpc_timeout = rpc_timeout
            sp = None
            if tr is not None:
                sp = tr.begin(f"dcn.dispatch[w{i}]", dispatch_parent)
                tracing.push(tr, sp)
            msg = {"cmd": "partial_paged", "sql": partial_sql,
                   "page_rows": self.PAGE_ROWS, "token": token, "attempt": 1}
            if gather is not None:
                msg["cmd"] = "shuffle_gather"
                msg["shuffle_id"] = gather["id"]
                msg["sides"] = gather["sides"]
            if deadline is not None:
                msg["deadline_s"] = max(deadline - time.monotonic(), 1e-3)
            try:
                firsts[i] = self._call_retry(i, msg)
            except Exception as e:  # noqa: BLE001
                errs[i] = e
                if sp is not None:
                    sp.notes.append(f"error:{type(e).__name__}")
            finally:
                if tr is not None:
                    tracing.pop()
                    tr.end(sp)

        threads = [threading.Thread(target=start, args=(i,), daemon=True)
                   for i in ws]
        for t in threads:
            t.start()
        # interruptible join: a KILL (or deadline expiry) while workers
        # compute must not wait for them to finish — fan the cancel out
        # on fresh connections, then collect the (now aborting) RPCs.
        # Every RPC carries a socket deadline, so this join is bounded.
        tokens = [token]  # grows with failover re-run tokens
        interrupted = None
        cancel_sent = False
        while any(t.is_alive() for t in threads):
            interrupted = cancel_reason()
            if interrupted is not None:
                self.cancel_tokens(tokens)
                cancel_sent = True
                for t in threads:
                    t.join()
                break
            # the last thread may die between the while-check and here
            alive = next((t for t in threads if t.is_alive()), None)
            if alive is not None:
                alive.join(timeout=0.05)
        for t in threads:
            t.join()
        if interrupted is None:
            interrupted = cancel_reason()
        if interrupted is not None:
            # the dispatch may have died on its own (RPC timeouts) the
            # same instant the budget expired: the cancel must STILL fan
            # out, or a worker stalled before execution would run its
            # partial for a coordinator that already gave up
            if not cancel_sent:
                self.cancel_tokens(tokens)
            # release whatever cursors the partials managed to open
            for i, f in enumerate(firsts):
                if f is not None:
                    self._close_cursor(i, f.get("cursor"))
            raise interrupted

        s = self._merge_session
        with self._merge_lock:
            s.execute("drop table if exists __dcn_partial__")
            ddl_done = schema_sql is not None
            if ddl_done:
                s.execute(schema_sql)
            else:
                # infer column types from the union of every partition's
                # FIRST page — one partition may be all-NULL in a column
                # another types (the old all-rows inference saw everything;
                # sampling only partition 0 would mistype such columns)
                sample = [r for f in firsts if f is not None for r in f["rows"]]
                if sample:
                    s.execute(self._infer_staging_ddl(partial_sql, sample))
                    ddl_done = True
            staging = None

            def ingest(rows: List[tuple]) -> None:
                nonlocal ddl_done, staging
                if not rows:
                    return
                if not ddl_done:
                    s.execute(self._infer_staging_ddl(partial_sql, rows))
                    ddl_done = True
                if staging is None:
                    staging = s.catalog.table(s.db, "__dcn_partial__")
                for st in range(0, len(rows), 4096):
                    staging.insert_rows(rows[st: st + 4096])

            # every cursor this query opens — on primaries AND replicas — is
            # tracked here until fully drained; the finally block releases
            # whatever a failure left behind, so no worker pins a partial
            # until the TTL (one worker can hold two entries: its own
            # partition's cursor and a replica partition's)
            open_cursors: List = [[i, f["cursor"]] for i, f in enumerate(firsts)
                                  if f is not None and f.get("cursor") is not None]

            # drain one partition at a time; a partition is ingested only
            # after it arrived completely, so mid-drain failover can re-run
            # it on the replica without duplicating staged rows
            try:
                for i in ws:
                    r = cancel_reason()
                    if r is not None:
                        self.cancel_tokens(tokens)
                        raise r
                    with tracing.span(f"dcn.drain[w{i}]") as drain_sp:
                        self._drain_one(i, firsts, errs, open_cursors, sql,
                                        cancel_reason, tokens, partial_ok,
                                        session, ingest, drain_sp,
                                        failover_ok)
            finally:
                for ent in open_cursors:
                    self._close_cursor(*ent)

            if not ddl_done:
                s.execute(self._infer_staging_ddl(partial_sql, []))
            with tracing.span("dcn.final_merge"):
                return s.query(final_sql)

    def _drain_one(self, i, firsts, errs, open_cursors, sql,
                   cancel_reason, tokens, partial_ok, session, ingest,
                   drain_sp, failover_ok=True) -> None:
        """Drain worker i's partial into the staging table, failing over
        to its replica on a non-typed error (split out of _query_inner
        so each drain can carry its own trace span). `failover_ok=False`
        for shuffle gathers: the rows live only in that worker's inbox,
        so a replica re-run cannot reproduce them — fail typed."""
        try:
            if errs[i] is not None:
                raise errs[i]
            rows = self._drain_pages(i, firsts[i], cancel_reason)
            open_cursors[:] = [e for e in open_cursors if e[0] != i
                               or e[1] != firsts[i].get("cursor")]
        except (ConnectionError, OSError, ExecutionError) as e:
            if isinstance(e, (QueryKilledError, QueryTimeoutError)):
                # the statement's budget is spent / it was killed: a
                # replica re-run cannot help, and the error must keep
                # its type
                self.cancel_tokens(tokens)
                raise
            if not failover_ok:
                self.cancel_tokens(tokens)
                raise
            # the primary may be alive (coordinator-side error):
            # release its cursor before the replica re-run
            for ent in list(open_cursors):
                if firsts[i] is not None and ent[0] == i \
                        and ent[1] == firsts[i].get("cursor"):
                    self._close_cursor(*ent)
                    open_cursors.remove(ent)
            if isinstance(e, DcnRpcTimeoutError):
                # the primary is probably still EXECUTING the abandoned
                # partial: tell it to stop (and, via token poisoning,
                # not to pin a cursor if it already finished) before
                # paying the replica
                self._cancel_endpoint(i, tokens[0], tracing.current(),
                                      drain_sp.span_id
                                      if drain_sp is not None else None)
            try:
                rows = self._failover_partial(
                    i, sql, e, open_cursors, cancel_reason, tokens)
            except (ConnectionError, OSError, ExecutionError) as e2:
                if isinstance(e2, (QueryKilledError,
                                   QueryTimeoutError)):
                    self.cancel_tokens(tokens)
                    raise
                if not partial_ok:
                    raise
                # degraded mode: serve the reachable partitions
                warn = (f"dcn partition {i} unavailable (primary "
                        f"and replica): {e2}; results are PARTIAL")
                self.last_warnings.append(warn)
                if drain_sp is not None:
                    drain_sp.notes.append(f"partial_results:{warn[:120]}")
                if session is not None:
                    session._warnings.append(
                        ("Warning", 1105, warn))
                return
        ingest(rows)

    def _infer_staging_ddl(self, partial_sql: str, rows: List[tuple]) -> str:
        # column names from the partial SELECT's aliases
        items = parse(partial_sql)[0].items
        names = [it.alias for it in items]
        cols = []
        for j, name in enumerate(names):
            cols.append(f"`{name}` {_infer_type(r[j] for r in rows)}")
        return "create table __dcn_partial__ (" + ", ".join(cols) + ")"

    def worker_stats(self) -> List[Optional[Dict]]:
        """Fleet-wide failure-domain counters (executed/cancelled/
        deadline_exceeded/cancel_rpcs/pages/open_cursors per worker) —
        the kill/deadline suites assert remote partials observably
        stopped through this. Idempotent, so it rides the retry path."""
        return self._call_all([{"cmd": "stats"}] * len(self._socks),
                              idempotent=True)

    _STAT_KEYS = ("executed", "cancelled", "deadline_exceeded",
                  "cancel_rpcs", "pages", "open_cursors",
                  "shards_owned", "shard_bytes",
                  "shuffle_bytes_in", "shuffle_bytes_out")

    def worker_stats_rows(self) -> List[tuple]:
        """Row-per-worker form of worker_stats() for
        information_schema.dcn_worker_stats — gathered per worker so one
        unreachable endpoint yields a row with an error instead of
        failing the whole fleet read. Gathered CONCURRENTLY: down
        workers pay connect/rpc timeouts, and a catalog read must cost
        one timeout, not one per dead worker."""
        rows: List = [None] * len(self._endpoints)

        def gather(i: int, host: str, port: int) -> None:
            h = self._health[i]
            base = (i, f"{host}:{port}", h.state)
            try:
                st = self._call_retry(i, {"cmd": "stats"})
                rows[i] = (base
                           + tuple(int(st.get(k, 0))
                                   for k in self._STAT_KEYS)
                           + (h.reconnects, self.replicas.get(i), ""))
            except Exception as e:  # noqa: BLE001 — down worker: a row,
                rows[i] = (base + (None,) * len(self._STAT_KEYS)
                           + (h.reconnects, self.replicas.get(i),
                              f"{type(e).__name__}: {e}"))

        threads = [threading.Thread(target=gather, args=(i, host, port),
                                    daemon=True)
                   for i, (host, port) in enumerate(self._endpoints)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return rows

    def metrics_snapshots(self) -> List[tuple]:
        """(endpoint_label, metrics snapshot | None, error) per worker —
        the fleet half of the metrics plane. Gathered
        CONCURRENTLY with the worker_stats_rows discipline: one dead
        worker costs one timeout and contributes an error entry, never
        a failed scrape. Idempotent (a pure read), so it rides the
        retry path."""
        out: List = [None] * len(self._endpoints)

        def gather(i: int, host: str, port: int) -> None:
            label = f"{host}:{port}"
            try:
                snap = self._call_retry(i, {"cmd": "metrics_snapshot"})
                out[i] = (label, snap, "")
            except Exception as e:  # noqa: BLE001 — down worker: an
                out[i] = (label, None,  # error entry, not a failure
                          f"{type(e).__name__}: {e}")

        threads = [threading.Thread(target=gather, args=(i, host, port),
                                    daemon=True)
                   for i, (host, port) in enumerate(self._endpoints)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out

    def health_snapshot(self) -> Dict:
        """JSON-friendly view of the per-worker health machine — the
        /cluster status-port endpoint and tests read this."""
        now = time.monotonic()
        workers = []
        for i, (host, port) in enumerate(self._endpoints):
            h = self._health[i]
            workers.append({
                "index": i,
                "endpoint": f"{host}:{port}",
                "state": h.state,
                "connected": (i < len(self._socks)
                              and self._socks[i] is not None),
                "attempts": h.attempts,
                "reconnects": h.reconnects,
                "retry_in_s": round(max(h.next_retry - now, 0.0), 3),
                "last_error": h.last_error,
                "replica": self.replicas.get(i),
            })
        return {"workers": workers,
                "partitioned": sorted(self._partitioned),
                "broadcast": sorted(self._broadcast),
                "warnings": list(self.last_warnings)}

    def shutdown(self) -> None:
        prev = getattr(self._tl, "reconnect", True)
        self._tl.reconnect = False  # don't resurrect links to say goodbye
        try:
            for i in range(len(self._socks)):
                if self._socks[i] is None:
                    continue
                try:
                    self._call(i, {"cmd": "shutdown"})
                except Exception:  # noqa: BLE001 — goodbye is best
                    pass  # effort; close() below drops the link anyway
        finally:
            self._tl.reconnect = prev
        self.close()

    def close(self) -> None:
        # shutdown+close the fd FIRST, without the lock: an in-flight
        # _call stuck in a blocking recv (rpc timeout 0, no deadline)
        # HOLDS its socket lock, so taking the lock first would
        # deadlock close(). shutdown() is what actually wakes a blocked
        # recv on Linux — close() alone leaves it sleeping (same lesson
        # as the worker's own listener). The slot is then cleared
        # UNDER the lock — which the aborted _call has now released —
        # because the old unlocked `self._socks = []` rebind raced a
        # concurrent _call indexing into the previous list
        # (lock-discipline pass: mixed locked/unlocked mutation).
        self._closed = True  # _call refuses new RPCs/redials from here
        for i in range(len(self._socks)):
            # A _call that passed the _closed check before we set it may
            # still be mid-reconnect: the slot reads None while it dials,
            # then it installs a fresh socket and blocks in recv — all
            # while HOLDING the sock lock. So a single snapshot-then-wait
            # would block on the lock without ever waking that recv.
            # Re-shutdown whatever socket is currently installed until
            # the lock is won; shutdown on an already-dead fd is a no-op.
            while True:
                s = self._socks[i]
                if s is not None:
                    try:
                        s.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    try:
                        s.close()
                    except OSError:
                        pass
                if self._sock_locks[i].acquire(timeout=0.05):
                    break
            try:
                cur = self._socks[i]
                if cur is not None and cur is not s:
                    # installed between our last shutdown and winning
                    # the lock — no recv can be blocked on it (recv
                    # happens under this lock), just release the fd
                    try:
                        cur.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    try:
                        cur.close()
                    except OSError:
                        pass
                # lint: disable=lock-discipline -- the lock IS held:
                # acquired above via acquire(timeout=) because a
                # blocking `with` is the close-vs-stuck-recv deadlock
                # this loop exists to break
                self._socks[i] = None
            finally:
                self._sock_locks[i].release()


def _infer_type(values) -> str:
    import re

    for v in values:
        if v is None:
            continue
        if isinstance(v, bool):
            return "boolean"
        if isinstance(v, int):
            return "bigint"
        if isinstance(v, float):
            return "double"
        if isinstance(v, datetime.datetime):
            return "datetime"
        if isinstance(v, datetime.date):
            return "date"
        if isinstance(v, str):
            m = re.fullmatch(r"-?\d+\.(\d+)", v)
            if m:  # decimal partials arrive as exact strings
                return f"decimal(18,{len(m.group(1))})"
            return "varchar(64)"
    return "bigint"


