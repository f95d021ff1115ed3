"""A minimal MySQL text-protocol client (a frozen copy of the handshake,
COM_QUERY and text result sets of tidb_tpu_torch/server/client.py and
protocol.py). Standard library only: the client process that imports
it loads neither torch nor the program."""

from __future__ import annotations

import socket
import struct
from typing import List, Tuple

CLIENT_CONNECT_WITH_DB = 1 << 3
CLIENT_PROTOCOL_41 = 1 << 9
CLIENT_SECURE_CONNECTION = 1 << 15
CLIENT_PLUGIN_AUTH = 1 << 19
MAX_PACKET = 0xFFFFFF


class ServerError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"({code}) {message}")
        self.code = code


def _read_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("peer closed connection")
        buf += part
    return buf


def read_packet(sock) -> bytes:
    payload = b""
    while True:
        header = _read_exact(sock, 4)
        length = header[0] | (header[1] << 8) | (header[2] << 16)
        payload += _read_exact(sock, length)
        if length < MAX_PACKET:
            return payload


def write_packet(sock, seq: int, payload: bytes) -> None:
    pos = 0
    while True:
        frame = payload[pos:pos + MAX_PACKET]
        n = len(frame)
        sock.sendall(bytes([n & 0xFF, (n >> 8) & 0xFF, (n >> 16) & 0xFF, seq & 0xFF]) + frame)
        seq += 1
        pos += n
        if n < MAX_PACKET:
            return


def read_lenc_int(buf: bytes, pos: int) -> Tuple[int, int]:
    first = buf[pos]
    if first < 0xFB:
        return first, pos + 1
    if first == 0xFC:
        return struct.unpack_from("<H", buf, pos + 1)[0], pos + 3
    if first == 0xFD:
        return int.from_bytes(buf[pos + 1:pos + 4], "little"), pos + 4
    return struct.unpack_from("<Q", buf, pos + 1)[0], pos + 9


def _error(payload: bytes) -> ServerError:
    code = struct.unpack_from("<H", payload, 1)[0]
    msg = payload[3:].decode("utf-8", "replace")
    return ServerError(code, msg[6:] if msg.startswith("#") else msg)


class Client:
    """One connection as user root with no password."""

    def __init__(self, host: str, port: int, db: str, timeout: float):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        payload = read_packet(self.sock)
        if payload and payload[0] == 0xFF:
            raise _error(payload)
        caps = (CLIENT_PROTOCOL_41 | CLIENT_SECURE_CONNECTION | CLIENT_PLUGIN_AUTH
                | CLIENT_CONNECT_WITH_DB)
        resp = (struct.pack("<I", caps) + struct.pack("<I", 1 << 24) + bytes([0x21])
                + b"\x00" * 23 + b"root\x00" + bytes([0]) + db.encode() + b"\x00"
                + b"mysql_native_password\x00")
        write_packet(self.sock, 1, resp)
        payload = read_packet(self.sock)
        if payload and payload[0] == 0xFF:
            raise _error(payload)

    def settimeout(self, seconds: float) -> None:
        self.sock.settimeout(seconds)

    def query(self, sql: str) -> List[tuple]:
        """Run one statement; its rows as tuples of strings (None for
        NULL), [] for a statement without a result set."""
        write_packet(self.sock, 0, b"\x03" + sql.encode("utf-8"))
        payload = read_packet(self.sock)
        if not payload:
            raise ConnectionError("empty response")
        if payload[0] == 0xFF:
            raise _error(payload)
        if payload[0] == 0x00:
            return []
        ncols, _ = read_lenc_int(payload, 0)
        for _ in range(ncols + 1):  # column definitions, then EOF
            read_packet(self.sock)
        rows = []
        while True:
            pkt = read_packet(self.sock)
            if pkt and pkt[0] == 0xFE and len(pkt) < 9:
                return rows
            if pkt and pkt[0] == 0xFF:
                raise _error(pkt)
            pos, vals = 0, []
            for _ in range(ncols):
                if pkt[pos] == 0xFB:
                    vals.append(None)
                    pos += 1
                else:
                    n, pos = read_lenc_int(pkt, pos)
                    vals.append(pkt[pos:pos + n].decode("utf-8"))
                    pos += n
            rows.append(tuple(vals))

    def close(self) -> None:
        try:
            write_packet(self.sock, 0, b"\x01")
        except OSError:
            pass
        self.sock.close()
