"""In-process database fakes for the ``sql`` input and output.

Each fake listens on 127.0.0.1, port 0 (``start`` binds and sets ``port``),
serves one connection after another and keeps what it was sent in memory
for a checker to read. ``stop`` closes every open connection too.

- ``FakePostgres``: the backend side of the v3 protocol. Startup (an
  SSLRequest is answered ``N``, so ``ssl_mode: prefer`` goes on in plain
  text and ``require`` fails), the trust, cleartext, md5 and SCRAM-SHA-256
  flows (a real server-side verifier), simple queries over ``tables``
  (``name -> (columns, oids, rows)``; a row's values are sent as
  ``str(v)``, None as NULL), ``COPY t (cols) FROM STDIN`` decoded into
  ``copied[t]`` (text cells, the COPY escapes undone, ``\\N`` as None),
  INSERT statements into ``inserts`` and CREATE statements into ``ddl``.
- ``FakeMySql``: the classic protocol. Handshake v10 with
  ``mysql_native_password`` or ``caching_sha2_password`` (the scramble
  verified against ``users``; ``cached_sha2=False`` asks for full auth,
  which a client without TLS must refuse), COM_QUERY text resultsets over
  ``tables`` (``name -> (columns, [(type, charset)], rows)``), COM_PING,
  COM_QUIT, INSERT into ``inserts`` and CREATE into ``ddl``.

They behave as the JAX package's test fakes (``tests/test_postgres.py``,
``tests/test_mysql.py``) do, so the tests run each package's clients
against the other's fakes.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import re
import struct
from typing import Optional

from arkflow_tpu_torch.connect.mysql_client import scramble_native, scramble_sha2
from arkflow_tpu_torch.tools.fake_brokers import _Server

_SSL_REQUEST = 80877103
_COPY_ESCAPES = {"t": "\t", "n": "\n", "r": "\r"}


def _msg(t: bytes, body: bytes = b"") -> bytes:
    return t + struct.pack(">I", len(body) + 4) + body


def _cstr(s: str) -> bytes:
    return s.encode() + b"\0"


def _copy_cell(cell: str) -> Optional[str]:
    if cell == "\\N":
        return None
    return re.sub(r"\\(.)", lambda m: _COPY_ESCAPES.get(m.group(1), m.group(1)), cell)


class FakePostgres(_Server):
    """Postgres backend fake (see the module docstring)."""

    def __init__(self, *, auth: str = "trust", users: Optional[dict] = None,
                 tables: Optional[dict] = None):
        super().__init__()
        if auth not in ("trust", "cleartext", "md5", "scram"):
            raise ValueError(f"unknown auth {auth!r}")
        self.auth = auth
        self.users = users or {}
        self.tables = tables or {}
        self.copied: dict[str, list] = {}
        self.inserts: list[str] = []
        self.ddl: list[str] = []

    async def _client(self, reader, writer) -> None:
        (ln,) = struct.unpack(">I", await reader.readexactly(4))
        body = await reader.readexactly(ln - 4)
        if struct.unpack_from(">I", body, 0)[0] == _SSL_REQUEST:
            writer.write(b"N")  # no TLS here: the client goes on in plain text
            await writer.drain()
            (ln,) = struct.unpack(">I", await reader.readexactly(4))
            body = await reader.readexactly(ln - 4)
        parts = [p.decode() for p in body[4:].split(b"\0") if p]
        params = dict(zip(parts[::2], parts[1::2]))
        if not await self._authenticate(reader, writer, params.get("user", "")):
            return
        writer.write(_msg(b"R", struct.pack(">I", 0)))
        writer.write(_msg(b"S", _cstr("server_version") + _cstr("16.0-fake")))
        writer.write(_msg(b"K", struct.pack(">II", 1, 2)))
        writer.write(_msg(b"Z", b"I"))
        await writer.drain()
        while True:
            t, body = await self._recv(reader)
            if t == b"X":
                return
            if t == b"Q":
                await self._query(body.rstrip(b"\0").decode(), reader, writer)

    @staticmethod
    async def _recv(reader) -> tuple[bytes, bytes]:
        hdr = await reader.readexactly(5)
        return hdr[:1], await reader.readexactly(struct.unpack(">I", hdr[1:])[0] - 4)

    async def _password(self, reader) -> str:
        t, body = await self._recv(reader)
        if t != b"p":
            raise ConnectionError(f"fake postgres: expected a password message, got {t!r}")
        return body.rstrip(b"\0").decode()

    async def _authenticate(self, reader, writer, user: str) -> bool:
        if self.auth == "trust":
            return True
        password = self.users.get(user)
        if self.auth == "cleartext":
            writer.write(_msg(b"R", struct.pack(">I", 3)))
            await writer.drain()
            ok = await self._password(reader) == password
        elif self.auth == "md5":
            salt = b"\x01\x02\x03\x04"
            writer.write(_msg(b"R", struct.pack(">I", 5) + salt))
            await writer.drain()
            got = await self._password(reader)
            inner = hashlib.md5(((password or "") + user).encode()).hexdigest()
            ok = got == "md5" + hashlib.md5(inner.encode() + salt).hexdigest()
        else:
            ok = await self._scram(reader, writer, password or "")
        if not ok:
            writer.write(_msg(b"E", b"SFATAL\0C28P01\0Mpassword authentication failed\0\0"))
            await writer.drain()
        return ok

    async def _scram(self, reader, writer, password: str) -> bool:
        """The server side of SCRAM-SHA-256 (RFC 7677), verifying the proof."""
        writer.write(_msg(b"R", struct.pack(">I", 10) + _cstr("SCRAM-SHA-256") + b"\0"))
        await writer.drain()
        _, body = await self._recv(reader)
        mech_end = body.index(b"\0")
        (resp_len,) = struct.unpack_from(">I", body, mech_end + 1)
        client_first = body[mech_end + 5:mech_end + 5 + resp_len].decode()
        client_first_bare = client_first[3:]  # after the "n,," header
        client_nonce = dict(kv.split("=", 1) for kv in client_first_bare.split(","))["r"]
        salt, iters = os.urandom(16), 4096
        server_nonce = client_nonce + base64.b64encode(os.urandom(9)).decode()
        server_first = f"r={server_nonce},s={base64.b64encode(salt).decode()},i={iters}"
        writer.write(_msg(b"R", struct.pack(">I", 11) + server_first.encode()))
        await writer.drain()
        _, body = await self._recv(reader)
        client_final = body.decode()
        fields = dict(kv.split("=", 1) for kv in client_final.split(","))
        without_proof = client_final[:client_final.rindex(",p=")]
        salted = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, iters)
        client_key = hmac.digest(salted, b"Client Key", "sha256")
        stored_key = hashlib.sha256(client_key).digest()
        auth_message = ",".join([client_first_bare, server_first, without_proof])
        client_sig = hmac.digest(stored_key, auth_message.encode(), "sha256")
        recovered = bytes(a ^ b for a, b in zip(base64.b64decode(fields["p"]), client_sig))
        if hashlib.sha256(recovered).digest() != stored_key:
            return False
        server_key = hmac.digest(salted, b"Server Key", "sha256")
        final = "v=" + base64.b64encode(
            hmac.digest(server_key, auth_message.encode(), "sha256")).decode()
        writer.write(_msg(b"R", struct.pack(">I", 12) + final.encode()))
        await writer.drain()
        return True

    def _done(self, writer, tag: str) -> None:
        writer.write(_msg(b"C", _cstr(tag)))
        writer.write(_msg(b"Z", b"I"))

    def _error(self, writer, code: str, message: str) -> None:
        writer.write(_msg(b"E", f"SERROR\0C{code}\0M{message}\0\0".encode()))
        writer.write(_msg(b"Z", b"I"))

    async def _query(self, sql: str, reader, writer) -> None:
        sl = sql.strip()
        low = sl.lower()
        if low.startswith("copy") and low.endswith("from stdin"):
            table = re.match(r'copy "?(\w+)"? \(([^)]*)\) from stdin', low).group(1)
            writer.write(_msg(b"G", b"\x00" + struct.pack(">H", 0)))
            await writer.drain()
            buf = bytearray()
            while True:
                t, body = await self._recv(reader)
                if t == b"d":
                    buf += body
                elif t == b"c":
                    break
                elif t == b"f":  # CopyFail
                    self._error(writer, "57014", "copy aborted")
                    await writer.drain()
                    return
            lines = buf.decode().split("\n")
            rows = [[_copy_cell(c) for c in line.split("\t")] for line in lines[:-1]]
            self.copied.setdefault(table, []).extend(rows)
            self._done(writer, f"COPY {len(rows)}")
        elif low.startswith("create"):
            self.ddl.append(sl)
            self._done(writer, "CREATE TABLE")
        elif low.startswith("insert"):
            self.inserts.append(sl)
            self._done(writer, f"INSERT 0 {sl.count('(') - 1}")
        else:
            m = re.search(r"from\s+\"?(\w+)\"?", low)
            table = self.tables.get(m.group(1)) if m else None
            if table is None:
                self._error(writer, "42P01", "relation does not exist")
            else:
                self._rows(writer, *table)
        await writer.drain()

    def _rows(self, writer, columns, oids, rows) -> None:
        desc = struct.pack(">H", len(columns))
        for name, oid in zip(columns, oids):
            desc += _cstr(name) + struct.pack(">IHIhih", 0, 0, oid, -1, -1, 0)
        writer.write(_msg(b"T", desc))
        for row in rows:
            body = bytearray(struct.pack(">H", len(row)))
            for v in row:
                if v is None:
                    body += struct.pack(">i", -1)
                else:
                    enc = str(v).encode()
                    body += struct.pack(">i", len(enc)) + enc
            writer.write(_msg(b"D", bytes(body)))
        self._done(writer, f"SELECT {len(rows)}")


#: the fake's 20-byte auth scramble
MYSQL_NONCE = b"abcdefgh12345678ijkl"


def _lenenc(data: bytes) -> bytes:
    n = len(data)
    if n < 0xFB:
        return bytes([n]) + data
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n) + data
    return b"\xfd" + n.to_bytes(3, "little") + data


class FakeMySql(_Server):
    """MySQL classic-protocol fake (see the module docstring)."""

    #: protocol 41, secure connection, plugin auth, connect with db, long password
    CAP = 0x0200 | 0x8000 | (1 << 19) | 8 | 1

    def __init__(self, *, plugin: str = "mysql_native_password",
                 users: Optional[dict] = None, tables: Optional[dict] = None,
                 cached_sha2: bool = True):
        super().__init__()
        self.plugin = plugin
        self.users = users or {}
        self.tables = tables or {}
        self.cached_sha2 = cached_sha2
        self.inserts: list[str] = []
        self.ddl: list[str] = []

    @staticmethod
    async def _recv(reader) -> tuple[int, bytes]:
        hdr = await reader.readexactly(4)
        return hdr[3], await reader.readexactly(int.from_bytes(hdr[:3], "little"))

    @staticmethod
    def _send(writer, seq: int, payload: bytes) -> None:
        writer.write(len(payload).to_bytes(3, "little") + bytes([seq & 0xFF]) + payload)

    def _ok(self, writer, seq: int, affected: int = 0) -> None:
        self._send(writer, seq, b"\x00" + _lenenc_int(affected) + b"\x00\x00\x00\x00\x00")

    def _err(self, writer, seq: int, code: int, msg: str) -> None:
        self._send(writer, seq, b"\xff" + struct.pack("<H", code) + msg.encode())

    async def _client(self, reader, writer) -> None:
        self._send(writer, 0, bytes([10]) + b"8.0-fake\0" + struct.pack("<I", 7)
                   + MYSQL_NONCE[:8] + b"\0" + struct.pack("<H", self.CAP & 0xFFFF)
                   + bytes([45]) + struct.pack("<H", 2)
                   + struct.pack("<H", (self.CAP >> 16) & 0xFFFF)
                   + bytes([21]) + b"\0" * 10 + MYSQL_NONCE[8:] + b"\0"
                   + self.plugin.encode() + b"\0")
        await writer.drain()
        seq, resp = await self._recv(reader)
        end = resp.index(b"\0", 32)
        user = resp[32:end].decode()
        alen = resp[end + 1]
        auth = resp[end + 2:end + 2 + alen]
        password = self.users.get(user)
        if password is None and self.users:
            self._err(writer, seq + 1, 1045, "no such user")
            await writer.drain()
            return
        if password:
            scramble = (scramble_native if self.plugin == "mysql_native_password"
                        else scramble_sha2)
            if auth != scramble(password, MYSQL_NONCE):
                self._err(writer, seq + 1, 1045, "access denied")
                await writer.drain()
                return
            if self.plugin == "caching_sha2_password":
                if not self.cached_sha2:
                    self._send(writer, seq + 1, b"\x01\x04")  # full auth: needs TLS
                    await writer.drain()
                    return
                self._send(writer, seq + 1, b"\x01\x03")  # fast auth OK
                seq += 1
        self._ok(writer, seq + 1)
        await writer.drain()
        while True:
            _, cmd = await self._recv(reader)
            if cmd[:1] == b"\x01":  # COM_QUIT
                return
            if cmd[:1] == b"\x0e":  # COM_PING
                self._ok(writer, 1)
            elif cmd[:1] == b"\x03":
                self._query(cmd[1:].decode(), writer)
            else:
                self._err(writer, 1, 1047, "unknown command")
            await writer.drain()

    def _query(self, sql: str, writer) -> None:
        low = sql.strip().lower()
        if low.startswith("create"):
            self.ddl.append(sql)
            self._ok(writer, 1)
            return
        if low.startswith("insert"):
            self.inserts.append(sql)
            self._ok(writer, 1, affected=sql.count("(") - 1)
            return
        m = re.search(r"from\s+`?(\w+)`?", low)
        table = self.tables.get(m.group(1)) if m else None
        if table is None:
            self._err(writer, 1, 1146, "table doesn't exist")
            return
        columns, types, rows = table
        seq = 1
        self._send(writer, seq, bytes([len(columns)]))
        for name, (t, cs) in zip(columns, types):
            seq += 1
            self._send(writer, seq, _lenenc(b"def") + _lenenc(b"db") + _lenenc(b"t")
                       + _lenenc(b"t") + _lenenc(name.encode()) + _lenenc(name.encode())
                       + bytes([0x0C]) + struct.pack("<HIBHB", cs, 255, t, 0, 0) + b"\0\0")
        seq += 1
        self._send(writer, seq, b"\xfe\x00\x00\x02\x00")  # EOF after the definitions
        for row in rows:
            seq += 1
            self._send(writer, seq, b"".join(
                b"\xfb" if v is None else _lenenc(str(v).encode()) for v in row))
        seq += 1
        self._send(writer, seq, b"\xfe\x00\x00\x02\x00")


def _lenenc_int(n: int) -> bytes:
    if n < 0xFB:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + n.to_bytes(3, "little")
    return b"\xfe" + struct.pack("<Q", n)
