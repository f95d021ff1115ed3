"""Minimal MySQL text-protocol client.

Speaks the standard protocol (handshake v10 + COM_QUERY + text result
sets), so it works against this package's Server or any MySQL-compatible
server. Used by the test suite (no third-party MySQL driver ships in the
environment) and as a tiny CLI: python -m tidb_tpu_torch.server.client.
"""

from __future__ import annotations

import socket
import struct
from typing import List, Optional, Tuple

from tidb_tpu_torch.server import protocol as P

__all__ = ["Client", "ServerError"]


class ServerError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"({code}) {message}")
        self.code = code
        self.message = message


class Client:
    def __init__(self, host: str = "127.0.0.1", port: int = 4000,
                 user: str = "root", password: str = "",
                 db: Optional[str] = None, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        _seq, payload = P.read_packet(self.sock)
        if payload and payload[0] == 0xFF:
            raise self._err(payload)
        salt = self._parse_salt(payload)
        caps = P.CLIENT_PROTOCOL_41 | P.CLIENT_SECURE_CONNECTION | P.CLIENT_PLUGIN_AUTH
        if db:
            caps |= P.CLIENT_CONNECT_WITH_DB
        token = self._scramble(password, salt)
        resp = (
            struct.pack("<I", caps)
            + struct.pack("<I", 1 << 24)
            + bytes([0x21])
            + b"\x00" * 23
            + user.encode() + b"\x00"
            + bytes([len(token)]) + token
            + ((db.encode() + b"\x00") if db else b"")
            + b"mysql_native_password\x00"
        )
        P.write_packet(self.sock, 1, resp)
        _seq, payload = P.read_packet(self.sock)
        if payload and payload[0] == 0xFF:
            raise self._err(payload)

    @staticmethod
    def _parse_salt(payload: bytes) -> bytes:
        # protocol v10: 0x0a, version\0, conn_id(4), salt1(8), 0,
        # caps_lo(2), charset, status(2), caps_hi(2), auth_len, 10 zeros,
        # salt2(12)\0
        pos = payload.index(b"\x00", 1) + 1
        salt1 = payload[pos + 4:pos + 12]
        pos2 = pos + 12 + 1 + 2 + 1 + 2 + 2 + 1 + 10
        salt2 = payload[pos2:pos2 + 12]
        return salt1 + salt2

    @staticmethod
    def _scramble(password: str, salt: bytes) -> bytes:
        import hashlib

        if not password:
            return b""
        stage1 = hashlib.sha1(password.encode()).digest()
        stage2 = hashlib.sha1(stage1).digest()
        mix = hashlib.sha1(salt + stage2).digest()
        return bytes(a ^ b for a, b in zip(stage1, mix))

    # ------------------------------------------------------------------

    def query(self, sql: str) -> Tuple[List[str], List[tuple]]:
        """Run one statement; returns (column names, rows). Non-queries
        return ([], [])."""
        P.write_packet(self.sock, 0, b"\x03" + sql.encode("utf-8"))
        _seq, payload = P.read_packet(self.sock)
        if not payload:
            raise ConnectionError("empty response")
        if payload[0] == 0xFF:
            raise self._err(payload)
        if payload[0] == 0x00:
            return [], []
        ncols, _ = P.read_lenc_int(payload, 0)
        names = []
        for _ in range(ncols):
            _seq, col = P.read_packet(self.sock)
            names.append(self._column_name(col))
        _seq, eof = P.read_packet(self.sock)  # EOF after column defs
        rows = []
        while True:
            _seq, pkt = P.read_packet(self.sock)
            if pkt and pkt[0] == 0xFE and len(pkt) < 9:
                break
            if pkt and pkt[0] == 0xFF:
                raise self._err(pkt)
            rows.append(self._parse_row(pkt, ncols))
        return names, rows

    def execute(self, sql: str) -> None:
        self.query(sql)

    def ping(self) -> bool:
        P.write_packet(self.sock, 0, b"\x0e")
        _seq, payload = P.read_packet(self.sock)
        return bool(payload) and payload[0] == 0x00

    # -- binary protocol (prepared statements) -------------------------

    def prepare(self, sql: str) -> Tuple[int, int]:
        """COM_STMT_PREPARE; returns (stmt_id, n_params)."""
        P.write_packet(self.sock, 0, b"\x16" + sql.encode("utf-8"))
        _seq, payload = P.read_packet(self.sock)
        if payload and payload[0] == 0xFF:
            raise self._err(payload)
        stmt_id = struct.unpack_from("<I", payload, 1)[0]
        num_cols = struct.unpack_from("<H", payload, 5)[0]
        n_params = struct.unpack_from("<H", payload, 7)[0]
        for _ in range(n_params + (1 if n_params else 0)):
            P.read_packet(self.sock)  # param defs + EOF
        for _ in range(num_cols + (1 if num_cols else 0)):
            P.read_packet(self.sock)  # column defs + EOF
        return stmt_id, n_params

    def execute_prepared(self, stmt_id: int, params: Tuple = ()) -> Tuple[List[str], List[tuple]]:
        body = struct.pack("<I", stmt_id) + b"\x00" + struct.pack("<I", 1)
        n = len(params)
        if n:
            bitmap = bytearray((n + 7) // 8)
            types = b""
            values = b""
            for i, v in enumerate(params):
                if v is None:
                    bitmap[i // 8] |= 1 << (i % 8)
                    types += bytes([0x06, 0])
                elif isinstance(v, bool):
                    types += bytes([0x01, 0])
                    values += struct.pack("<b", 1 if v else 0)
                elif isinstance(v, int):
                    types += bytes([0x08, 0])
                    values += struct.pack("<q", v)
                elif isinstance(v, float):
                    types += bytes([0x05, 0])
                    values += struct.pack("<d", v)
                else:
                    types += bytes([0xFD, 0])
                    values += P.lenc_str(str(v).encode("utf-8"))
            body += bytes(bitmap) + b"\x01" + types + values
        P.write_packet(self.sock, 0, b"\x17" + body)
        return self._read_binary_resultset()

    def close_prepared(self, stmt_id: int) -> None:
        P.write_packet(self.sock, 0, b"\x19" + struct.pack("<I", stmt_id))

    def _read_binary_resultset(self) -> Tuple[List[str], List[tuple]]:
        _seq, payload = P.read_packet(self.sock)
        if not payload:
            raise ConnectionError("empty response")
        if payload[0] == 0xFF:
            raise self._err(payload)
        if payload[0] == 0x00:
            return [], []
        ncols, _ = P.read_lenc_int(payload, 0)
        names, types = [], []
        for _ in range(ncols):
            _seq, col = P.read_packet(self.sock)
            name, mtype = self._column_name_type(col)
            names.append(name)
            types.append(mtype)
        P.read_packet(self.sock)  # EOF
        rows = []
        while True:
            _seq, pkt = P.read_packet(self.sock)
            if pkt and pkt[0] == 0xFE and len(pkt) < 9:
                break
            if pkt and pkt[0] == 0xFF:
                raise self._err(pkt)
            rows.append(self._parse_binary_row(pkt, types))
        return names, rows

    @staticmethod
    def _column_name_type(payload: bytes) -> Tuple[str, int]:
        pos = 0
        parts = []
        for _ in range(6):  # catalog, schema, table, org_table, name, org_name
            n, pos = P.read_lenc_int(payload, pos)
            parts.append(payload[pos:pos + n])
            pos += n
        pos += 1 + 2 + 4  # 0x0C marker, charset, length
        return parts[4].decode(), payload[pos]

    @staticmethod
    def _parse_binary_row(payload: bytes, types: List[int]) -> tuple:
        n = len(types)
        pos = 1
        nb = (n + 7 + 2) // 8
        bitmap = payload[pos:pos + nb]
        pos += nb
        vals = []
        for i, t in enumerate(types):
            bit = i + 2
            if bitmap[bit // 8] & (1 << (bit % 8)):
                vals.append(None)
                continue
            if t == 0x08:  # LONGLONG
                vals.append(struct.unpack_from("<q", payload, pos)[0])
                pos += 8
            elif t == 0x01:  # TINY
                vals.append(struct.unpack_from("<b", payload, pos)[0])
                pos += 1
            elif t == 0x05:  # DOUBLE
                vals.append(struct.unpack_from("<d", payload, pos)[0])
                pos += 8
            else:  # lenc string (decimal/varchar/date-as-string)
                ln, pos = P.read_lenc_int(payload, pos)
                vals.append(payload[pos:pos + ln].decode("utf-8"))
                pos += ln
        return tuple(vals)

    def close(self) -> None:
        try:
            P.write_packet(self.sock, 0, b"\x01")
        except OSError:
            pass
        self.sock.close()

    # ------------------------------------------------------------------

    @staticmethod
    def _err(payload: bytes) -> ServerError:
        code = struct.unpack_from("<H", payload, 1)[0]
        msg = payload[3:].decode("utf-8", "replace")
        if msg.startswith("#"):
            msg = msg[6:]
        return ServerError(code, msg)

    @staticmethod
    def _column_name(payload: bytes) -> str:
        pos = 0
        out = []
        for _ in range(5):  # catalog, schema, table, org_table, name
            n, pos = P.read_lenc_int(payload, pos)
            out.append(payload[pos:pos + n])
            pos += n
        return out[4].decode()

    @staticmethod
    def _parse_row(payload: bytes, ncols: int) -> tuple:
        pos = 0
        vals = []
        for _ in range(ncols):
            if payload[pos] == 0xFB:
                vals.append(None)
                pos += 1
            else:
                n, pos = P.read_lenc_int(payload, pos)
                vals.append(payload[pos:pos + n].decode("utf-8"))
                pos += n
        return tuple(vals)


def _main():  # pragma: no cover - interactive CLI
    import sys

    host, port = "127.0.0.1", 4000
    if len(sys.argv) > 1:
        host, _, p = sys.argv[1].partition(":")
        port = int(p or 4000)
    c = Client(host, port)
    print(f"connected to {host}:{port}; enter SQL, empty line to quit")
    while True:
        try:
            sql = input("sql> ").strip()
        except EOFError:
            break
        if not sql:
            break
        try:
            names, rows = c.query(sql)
        except ServerError as e:
            print("ERROR:", e)
            continue
        if names:
            print("\t".join(names))
            for r in rows:
                print("\t".join("NULL" if v is None else str(v) for v in r))
        else:
            print("OK")
    c.close()


if __name__ == "__main__":
    _main()
