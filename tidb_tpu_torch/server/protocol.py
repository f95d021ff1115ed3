"""MySQL client/server protocol encoding (ref: server/packetio.go +
server/conn.go's handshake and resultset writers).

Implements the v10 handshake, CLIENT_PROTOCOL_41 packets, length-encoded
integers/strings, OK/ERR/EOF, column definitions, and text-protocol rows
— the subset a standard MySQL client needs to connect and run queries.
"""

from __future__ import annotations

import datetime
import struct
from typing import List, Optional, Tuple

from tidb_tpu_torch.types import TypeKind

__all__ = [
    "CAPABILITIES", "read_packet", "write_packet", "lenc_int", "lenc_str",
    "read_lenc_int", "ok_packet", "err_packet", "eof_packet",
    "handshake_v10", "parse_handshake_response", "column_def41",
    "text_row", "render_value", "mysql_type_of",
]

# capability flags
CLIENT_LONG_PASSWORD = 1 << 0
CLIENT_FOUND_ROWS = 1 << 1
CLIENT_LONG_FLAG = 1 << 2
CLIENT_CONNECT_WITH_DB = 1 << 3
CLIENT_PROTOCOL_41 = 1 << 9
CLIENT_TRANSACTIONS = 1 << 13
CLIENT_SECURE_CONNECTION = 1 << 15
CLIENT_PLUGIN_AUTH = 1 << 19
CLIENT_DEPRECATE_EOF = 1 << 24

CAPABILITIES = (
    CLIENT_LONG_PASSWORD | CLIENT_FOUND_ROWS | CLIENT_LONG_FLAG
    | CLIENT_CONNECT_WITH_DB | CLIENT_PROTOCOL_41 | CLIENT_TRANSACTIONS
    | CLIENT_SECURE_CONNECTION | CLIENT_PLUGIN_AUTH
)

# text protocol column types
MYSQL_TYPE_TINY = 0x01
MYSQL_TYPE_LONGLONG = 0x08
MYSQL_TYPE_DOUBLE = 0x05
MYSQL_TYPE_NEWDECIMAL = 0xF6
MYSQL_TYPE_VAR_STRING = 0xFD
MYSQL_TYPE_DATE = 0x0A
MYSQL_TYPE_DATETIME = 0x0C

SERVER_STATUS_IN_TRANS = 0x0001
SERVER_STATUS_AUTOCOMMIT = 0x0002

MAX_PACKET = 0xFFFFFF  # payloads split at 16MB-1 per the protocol


# ---------------------------------------------------------------------------
# packet framing: [3-byte little-endian length][1-byte sequence][payload]
# ---------------------------------------------------------------------------

def read_packet(sock) -> Tuple[int, bytes]:
    """Read one logical packet, reassembling 16MB continuation frames."""
    payload = b""
    while True:
        header = _read_exact(sock, 4)
        length = header[0] | (header[1] << 8) | (header[2] << 16)
        seq = header[3]
        payload += _read_exact(sock, length)
        if length < MAX_PACKET:
            return seq, payload


def _read_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("peer closed connection")
        buf += part
    return buf


def write_packet(sock, seq: int, payload: bytes) -> int:
    """Send a logical packet, splitting at the 16MB frame limit; returns
    the next sequence id."""
    pos = 0
    while True:
        frame = payload[pos:pos + MAX_PACKET]
        n = len(frame)
        sock.sendall(
            bytes([n & 0xFF, (n >> 8) & 0xFF, (n >> 16) & 0xFF, seq & 0xFF]) + frame
        )
        seq += 1
        pos += n
        # a payload that is an exact multiple of MAX_PACKET needs a
        # trailing empty frame as the terminator
        if n < MAX_PACKET:
            return seq


# ---------------------------------------------------------------------------
# length-encoded primitives
# ---------------------------------------------------------------------------

def lenc_int(n: int) -> bytes:
    if n < 0xFB:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def lenc_str(s: bytes) -> bytes:
    return lenc_int(len(s)) + s


def read_lenc_int(buf: bytes, pos: int) -> Tuple[int, int]:
    first = buf[pos]
    if first < 0xFB:
        return first, pos + 1
    if first == 0xFC:
        return struct.unpack_from("<H", buf, pos + 1)[0], pos + 3
    if first == 0xFD:
        return int.from_bytes(buf[pos + 1:pos + 4], "little"), pos + 4
    return struct.unpack_from("<Q", buf, pos + 1)[0], pos + 9


# ---------------------------------------------------------------------------
# generic packets
# ---------------------------------------------------------------------------

def ok_packet(affected: int = 0, last_insert_id: int = 0,
              status: int = SERVER_STATUS_AUTOCOMMIT, warnings: int = 0) -> bytes:
    return (b"\x00" + lenc_int(affected) + lenc_int(last_insert_id)
            + struct.pack("<HH", status, warnings))


def err_packet(code: int, message: str, state: str = "HY000") -> bytes:
    return (b"\xff" + struct.pack("<H", code) + b"#" + state.encode()
            + message.encode("utf-8")[:512])


def eof_packet(status: int = SERVER_STATUS_AUTOCOMMIT, warnings: int = 0) -> bytes:
    return b"\xfe" + struct.pack("<HH", warnings, status)


# ---------------------------------------------------------------------------
# handshake
# ---------------------------------------------------------------------------

def handshake_v10(conn_id: int, server_version: str, salt: bytes) -> bytes:
    assert len(salt) == 20
    caps = CAPABILITIES
    return (
        b"\x0a"
        + server_version.encode() + b"\x00"
        + struct.pack("<I", conn_id)
        + salt[:8] + b"\x00"
        + struct.pack("<H", caps & 0xFFFF)
        + bytes([0x21])                      # charset utf8_general_ci
        + struct.pack("<H", SERVER_STATUS_AUTOCOMMIT)
        + struct.pack("<H", (caps >> 16) & 0xFFFF)
        + bytes([21])                        # auth plugin data length
        + b"\x00" * 10
        + salt[8:] + b"\x00"
        + b"mysql_native_password\x00"
    )


def parse_handshake_response(payload: bytes) -> dict:
    caps = struct.unpack_from("<I", payload, 0)[0]
    pos = 4 + 4 + 1 + 23  # caps, max packet, charset, reserved
    end = payload.index(b"\x00", pos)
    user = payload[pos:end].decode()
    pos = end + 1
    if caps & CLIENT_SECURE_CONNECTION:
        alen = payload[pos]
        pos += 1
        auth = payload[pos:pos + alen]
        pos += alen
    else:
        end = payload.index(b"\x00", pos)
        auth = payload[pos:end]
        pos = end + 1
    db = None
    if caps & CLIENT_CONNECT_WITH_DB and pos < len(payload):
        end = payload.find(b"\x00", pos)
        if end >= 0:
            db = payload[pos:end].decode() or None
            pos = end + 1
    return {"capabilities": caps, "user": user, "auth": auth, "db": db}


# ---------------------------------------------------------------------------
# result sets
# ---------------------------------------------------------------------------

def mysql_type_of(kind: Optional[TypeKind]) -> int:
    return {
        TypeKind.INT: MYSQL_TYPE_LONGLONG,
        TypeKind.FLOAT: MYSQL_TYPE_DOUBLE,
        TypeKind.DECIMAL: MYSQL_TYPE_NEWDECIMAL,
        TypeKind.STRING: MYSQL_TYPE_VAR_STRING,
        TypeKind.DATE: MYSQL_TYPE_DATE,
        TypeKind.DATETIME: MYSQL_TYPE_DATETIME,
        TypeKind.BOOL: MYSQL_TYPE_TINY,
        None: MYSQL_TYPE_VAR_STRING,
    }.get(kind, MYSQL_TYPE_VAR_STRING)


def column_def41(name: str, mysql_type: int, db: str = "", table: str = "") -> bytes:
    return (
        lenc_str(b"def")
        + lenc_str(db.encode())
        + lenc_str(table.encode()) + lenc_str(table.encode())
        + lenc_str(name.encode()) + lenc_str(name.encode())
        + bytes([0x0C])                       # fixed-length fields marker
        + struct.pack("<H", 0x21)             # charset
        + struct.pack("<I", 255)              # column length
        + bytes([mysql_type])
        + struct.pack("<H", 0)                # flags
        + bytes([0])                          # decimals
        + b"\x00\x00"
    )


def render_value(v) -> Optional[bytes]:
    """Python result value -> text-protocol bytes (None stays NULL)."""
    if v is None:
        return None
    if isinstance(v, bool):
        return b"1" if v else b"0"
    if isinstance(v, float):
        return repr(v).encode()
    if isinstance(v, datetime.datetime):
        return v.isoformat(sep=" ").encode()
    if isinstance(v, datetime.date):
        return v.isoformat().encode()
    out = v if isinstance(v, bytes) else str(v)
    if isinstance(out, str):
        out = out.encode("utf-8")
    return out


def text_row(values: List) -> bytes:
    out = b""
    for v in values:
        r = render_value(v)
        if r is None:
            out += b"\xfb"
        else:
            if isinstance(r, str):
                r = r.encode()
            out += lenc_str(r)
    return out


# ---------------------------------------------------------------------------
# binary protocol (COM_STMT_* — ref: server/conn_stmt.go)
# ---------------------------------------------------------------------------

def stmt_prepare_ok(stmt_id: int, num_columns: int, num_params: int) -> bytes:
    return (b"\x00" + struct.pack("<I", stmt_id)
            + struct.pack("<H", num_columns) + struct.pack("<H", num_params)
            + b"\x00" + struct.pack("<H", 0))


def binary_kind(kind: Optional[TypeKind]) -> int:
    """Column type declared in binary result sets. DATE/DATETIME values
    are already rendered to ISO strings by result materialization, so
    they are declared (and sent) as strings."""
    return {
        TypeKind.INT: MYSQL_TYPE_LONGLONG,
        TypeKind.BOOL: MYSQL_TYPE_TINY,
        TypeKind.FLOAT: MYSQL_TYPE_DOUBLE,
        TypeKind.DECIMAL: MYSQL_TYPE_NEWDECIMAL,
    }.get(kind, MYSQL_TYPE_VAR_STRING)


def binary_row(values: List, kinds: List[Optional[TypeKind]]) -> bytes:
    """One binary-protocol resultset row: 0x00 header, NULL bitmap
    (offset 2), then values encoded per their declared binary type."""
    n = len(values)
    bitmap = bytearray((n + 7 + 2) // 8)
    body = b""
    for i, (v, kind) in enumerate(zip(values, kinds)):
        if v is None:
            pos = i + 2
            bitmap[pos // 8] |= 1 << (pos % 8)
            continue
        bt = binary_kind(kind)
        if bt == MYSQL_TYPE_LONGLONG:
            body += struct.pack("<q", int(v))
        elif bt == MYSQL_TYPE_TINY:
            body += struct.pack("<b", 1 if v else 0)
        elif bt == MYSQL_TYPE_DOUBLE:
            body += struct.pack("<d", float(v))
        else:
            r = render_value(v) or b""
            body += lenc_str(r)
    return b"\x00" + bytes(bitmap) + body


def parse_stmt_execute(body: bytes, n_params: int,
                       known_types: Optional[list] = None) -> Tuple[int, list, list]:
    """COM_STMT_EXECUTE payload (after the command byte) -> (stmt_id,
    bound parameter values, param types). Standard clients send the type
    block only on the FIRST execute (new_params_bound_flag=1); later
    executions reuse `known_types` cached by the connection."""
    stmt_id = struct.unpack_from("<I", body, 0)[0]
    pos = 4 + 1 + 4  # stmt_id, flags, iteration count
    params: list = []
    if n_params == 0:
        return stmt_id, params, []
    nb = (n_params + 7) // 8
    null_bitmap = body[pos:pos + nb]
    pos += nb
    new_bound = body[pos]
    pos += 1
    if new_bound:
        types = []
        for _ in range(n_params):
            t, flags = body[pos], body[pos + 1]
            types.append((t, bool(flags & 0x80)))
            pos += 2
    elif known_types is not None:
        types = known_types
    else:
        raise ValueError("re-execution without parameter types bound")
    for i, (t, unsigned) in enumerate(types):
        if null_bitmap[i // 8] & (1 << (i % 8)):
            params.append(None)
            continue
        v, pos = _read_binary_value(body, pos, t, unsigned)
        params.append(v)
    return stmt_id, params, types


def _read_binary_value(buf: bytes, pos: int, mysql_type: int, unsigned: bool):
    import datetime

    t = mysql_type
    if t == 0x01:  # TINY
        v = buf[pos] if unsigned else struct.unpack_from("<b", buf, pos)[0]
        return v, pos + 1
    if t == 0x02:  # SHORT
        fmt = "<H" if unsigned else "<h"
        return struct.unpack_from(fmt, buf, pos)[0], pos + 2
    if t in (0x03, 0x09):  # LONG / INT24
        fmt = "<I" if unsigned else "<i"
        return struct.unpack_from(fmt, buf, pos)[0], pos + 4
    if t == 0x08:  # LONGLONG
        fmt = "<Q" if unsigned else "<q"
        return struct.unpack_from(fmt, buf, pos)[0], pos + 8
    if t == 0x04:  # FLOAT
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    if t == 0x05:  # DOUBLE
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if t == 0x06:  # NULL
        return None, pos
    if t in (0x0A, 0x0C, 0x07):  # DATE / DATETIME / TIMESTAMP
        length = buf[pos]
        pos += 1
        if length == 0:
            return datetime.date(1970, 1, 1) if t == 0x0A else datetime.datetime(1970, 1, 1), pos
        y, mo, d = struct.unpack_from("<HBB", buf, pos)
        if t == 0x0A and length == 4:
            return datetime.date(y, mo, d), pos + length
        h = mi = s = us = 0
        if length >= 7:
            h, mi, s = buf[pos + 4], buf[pos + 5], buf[pos + 6]
        if length >= 11:
            us = struct.unpack_from("<I", buf, pos + 7)[0]
        if t == 0x0A:
            return datetime.date(y, mo, d), pos + length
        return datetime.datetime(y, mo, d, h, mi, s, us), pos + length
    # strings / decimals / blobs: length-encoded
    n, pos = read_lenc_int(buf, pos)
    raw = buf[pos:pos + n]
    if t == 0xF6:  # NEWDECIMAL arrives as text
        return raw.decode(), pos + n
    try:
        return raw.decode("utf-8"), pos + n
    except UnicodeDecodeError:
        return raw, pos + n
