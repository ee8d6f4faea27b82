"""PostgreSQL wire-protocol client (asyncio, standard library only).

Counterpart of ``arkflow_tpu/connect/postgres_client.py``: the frontend
side of the v3 protocol the ``sql`` input and output need.

- StartupMessage and authentication: trust, cleartext, MD5, SCRAM-SHA-256
  (``hashlib`` / ``hmac``; no channel binding)
- TLS through SSLRequest (``ssl_mode`` disable, prefer, require; under
  prefer a refused SSLRequest goes on in plain text)
- the simple query protocol: RowDescription / DataRow, each text value
  decoded by its type OID (integers, floats and numeric, bool, bytea; the
  rest stay strings)
- bulk insert through ``COPY ... FROM STDIN`` (text format), and a
  multi-row INSERT of quoted literals as the fallback

Framing: one type byte, an int32 length that counts itself, the body (the
startup message has no type byte); integers big-endian.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import hmac
import os
import struct
from dataclasses import dataclass
from typing import Any, Optional
from urllib.parse import unquote, urlparse

from arkflow_tpu_torch.errors import ConfigError, ConnectError, ReadError, WriteError

PG_PROTO = 196608        # v3.0
SSL_REQUEST = 80877103


@dataclass(frozen=True)
class PgDsn:
    host: str
    port: int
    user: str
    password: Optional[str]
    database: str

    @classmethod
    def parse(cls, uri: str) -> "PgDsn":
        u = urlparse(uri)
        if u.scheme not in ("postgres", "postgresql"):
            raise ConfigError(
                f"postgres uri must be postgres:// or postgresql:// (got {uri!r})")
        if not u.hostname:
            raise ConfigError(f"postgres uri missing host: {uri!r}")
        if not u.username:
            raise ConfigError(f"postgres uri missing user: {uri!r}")
        db = (u.path or "/").lstrip("/") or u.username
        return cls(
            host=u.hostname, port=u.port or 5432,
            user=unquote(u.username),
            password=unquote(u.password) if u.password else None,
            database=unquote(db),
        )


def _msg(type_byte: bytes, body: bytes = b"") -> bytes:
    return type_byte + struct.pack(">I", len(body) + 4) + body


def _cstr(s: str) -> bytes:
    return s.encode() + b"\0"


# -- value decoding ---------------------------------------------------------

_BOOL_OID = 16
_BYTEA_OID = 17
_INT_OIDS = {20, 21, 23, 26, 28}       # int8, int2, int4, oid, xid
_FLOAT_OIDS = {700, 701, 1700}         # float4, float8, numeric (as float)


def decode_value(text: Optional[bytes], oid: int) -> Any:
    """Text-format wire value -> Python value (Arrow-friendly)."""
    if text is None:
        return None
    s = text.decode()
    if oid in _INT_OIDS:
        return int(s)
    if oid in _FLOAT_OIDS:
        return float(s)
    if oid == _BOOL_OID:
        return s == "t"
    if oid == _BYTEA_OID:
        if s.startswith("\\x"):
            return bytes.fromhex(s[2:])
        return text
    return s  # text, varchar, timestamps, json, ... stay as strings


def copy_escape(v: Any) -> str:
    r"""One value in COPY text format: \N for NULL, escape \ TAB NL CR."""
    if v is None:
        return "\\N"
    if isinstance(v, bool):
        return "t" if v else "f"
    if isinstance(v, (bytes, bytearray)):
        return "\\\\x" + bytes(v).hex()
    s = str(v)
    return (s.replace("\\", "\\\\").replace("\t", "\\t")
             .replace("\n", "\\n").replace("\r", "\\r"))


def quote_ident(name: str) -> str:
    """Defensively quote an identifier (table/column name from config)."""
    return '"' + name.replace('"', '""') + '"'


def sql_literal(v: Any) -> str:
    """Literal for the INSERT fallback (no extended protocol params)."""
    import math

    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, float) and not math.isfinite(v):
        # bare nan/inf tokens are invalid SQL; PG spells them as quoted floats
        if math.isnan(v):
            return "'NaN'::float8"
        return "'Infinity'::float8" if v > 0 else "'-Infinity'::float8"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, (bytes, bytearray)):
        return "'\\x" + bytes(v).hex() + "'::bytea"
    return "'" + str(v).replace("'", "''") + "'"


# -- SCRAM-SHA-256 (RFC 5802/7677) ------------------------------------------

class ScramClient:
    """Client side of SCRAM-SHA-256 without channel binding."""

    def __init__(self, user: str, password: str, nonce: Optional[str] = None):
        self.password = password
        self.nonce = nonce or base64.b64encode(os.urandom(18)).decode()
        # PG ignores the username here (it comes from startup), n= stays empty
        self.client_first_bare = f"n=,r={self.nonce}"
        self.gs2 = "n,,"

    def client_first(self) -> bytes:
        return (self.gs2 + self.client_first_bare).encode()

    def client_final(self, server_first: bytes) -> bytes:
        fields = dict(kv.split("=", 1) for kv in server_first.decode().split(","))
        server_nonce, salt_b64, iters = fields["r"], fields["s"], int(fields["i"])
        if not server_nonce.startswith(self.nonce):
            raise ConnectError("postgres scram: server nonce mismatch")
        salted = hashlib.pbkdf2_hmac(
            "sha256", self.password.encode(), base64.b64decode(salt_b64), iters)
        client_key = hmac.digest(salted, b"Client Key", "sha256")
        stored_key = hashlib.sha256(client_key).digest()
        channel = base64.b64encode(self.gs2.encode()).decode()
        without_proof = f"c={channel},r={server_nonce}"
        auth_message = ",".join(
            [self.client_first_bare, server_first.decode(), without_proof])
        client_sig = hmac.digest(stored_key, auth_message.encode(), "sha256")
        proof = bytes(a ^ b for a, b in zip(client_key, client_sig))
        self._server_key = hmac.digest(salted, b"Server Key", "sha256")
        self._auth_message = auth_message
        return f"{without_proof},p={base64.b64encode(proof).decode()}".encode()

    def verify_server_final(self, server_final: bytes) -> None:
        fields = dict(kv.split("=", 1) for kv in server_final.decode().split(","))
        expect = hmac.digest(self._server_key, self._auth_message.encode(), "sha256")
        if base64.b64decode(fields.get("v", "")) != expect:
            raise ConnectError("postgres scram: bad server signature")


# -- client -----------------------------------------------------------------

@dataclass
class QueryResult:
    columns: list[str]
    oids: list[int]
    rows: list[list[Any]]
    command_tag: str = ""


class PostgresClient:
    def __init__(self, uri: str, *, ssl_mode: str = "prefer",
                 ssl_root_cert: Optional[str] = None, timeout: float = 10.0):
        self.dsn = PgDsn.parse(uri)
        if ssl_mode not in ("disable", "prefer", "require"):
            raise ConfigError(
                f"postgres ssl_mode {ssl_mode!r} not supported (disable/prefer/require)")
        self.ssl_mode = ssl_mode
        self.ssl_root_cert = ssl_root_cert
        self.timeout = timeout
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.parameters: dict[str, str] = {}
        self._lock = asyncio.Lock()

    # -- wire helpers --

    async def _recv(self) -> tuple[bytes, bytes]:
        hdr = await asyncio.wait_for(self.reader.readexactly(5), self.timeout)
        type_byte, length = hdr[:1], struct.unpack(">I", hdr[1:])[0]
        body = await asyncio.wait_for(
            self.reader.readexactly(length - 4), self.timeout)
        return type_byte, body

    def _send(self, type_byte: bytes, body: bytes = b"") -> None:
        self.writer.write(_msg(type_byte, body))

    @staticmethod
    def _error_fields(body: bytes) -> dict[str, str]:
        out: dict[str, str] = {}
        for part in body.split(b"\0"):
            if len(part) >= 2:
                out[chr(part[0])] = part[1:].decode(errors="replace")
        return out

    def _raise_error(self, body: bytes, cls=ReadError) -> None:
        f = self._error_fields(body)
        raise cls(f"postgres error {f.get('C', '?')}: {f.get('M', 'unknown')}")

    # -- connection --

    async def connect(self) -> None:
        try:
            self.reader, self.writer = await asyncio.wait_for(
                asyncio.open_connection(self.dsn.host, self.dsn.port), self.timeout)
        except (OSError, asyncio.TimeoutError) as e:
            raise ConnectError(
                f"postgres: cannot reach {self.dsn.host}:{self.dsn.port}: {e}") from e
        try:
            await self._handshake()
        except BaseException:
            # close the half-open socket; a failed handshake must not leak
            # the connection (server side would block on it forever)
            try:
                self.writer.close()
            except Exception:
                pass
            self.writer = None
            self.reader = None
            raise

    async def _handshake(self) -> None:
        if self.ssl_mode in ("prefer", "require"):
            await self._maybe_start_tls()
        params = _cstr("user") + _cstr(self.dsn.user) + _cstr("database") \
            + _cstr(self.dsn.database) + b"\0"
        body = struct.pack(">I", PG_PROTO) + params
        self.writer.write(struct.pack(">I", len(body) + 4) + body)
        await self.writer.drain()
        await self._authenticate()
        # drain ParameterStatus/BackendKeyData until ReadyForQuery
        while True:
            t, body = await self._recv()
            if t == b"S":
                k, v, *_ = body.split(b"\0")
                self.parameters[k.decode()] = v.decode()
            elif t == b"K":
                pass  # cancellation key (unused)
            elif t == b"Z":
                return
            elif t == b"E":
                self._raise_error(body, ConnectError)
            else:
                raise ConnectError(f"postgres: unexpected startup message {t!r}")

    async def _maybe_start_tls(self) -> None:
        import ssl as _ssl

        self.writer.write(struct.pack(">II", 8, SSL_REQUEST))
        await self.writer.drain()
        answer = await asyncio.wait_for(self.reader.readexactly(1), self.timeout)
        if answer == b"S":
            ctx = _ssl.create_default_context(cafile=self.ssl_root_cert)
            if self.ssl_root_cert is None:
                ctx.check_hostname = False
                ctx.verify_mode = _ssl.CERT_NONE
            await self.writer.start_tls(ctx, server_hostname=self.dsn.host)
            self.reader = self.writer._protocol._stream_reader  # noqa: SLF001
        elif self.ssl_mode == "require":
            raise ConnectError("postgres: server refused TLS (ssl_mode=require)")

    async def _authenticate(self) -> None:
        while True:
            t, body = await self._recv()
            if t == b"E":
                self._raise_error(body, ConnectError)
            if t != b"R":
                raise ConnectError(f"postgres: expected auth message, got {t!r}")
            (code,) = struct.unpack_from(">I", body, 0)
            if code == 0:      # AuthenticationOk
                return
            if code == 3:      # CleartextPassword
                self._require_password()
                self._send(b"p", _cstr(self.dsn.password))
                await self.writer.drain()
            elif code == 5:    # MD5Password
                self._require_password()
                salt = body[4:8]
                inner = hashlib.md5(
                    (self.dsn.password + self.dsn.user).encode()).hexdigest()
                digest = hashlib.md5(inner.encode() + salt).hexdigest()
                self._send(b"p", _cstr("md5" + digest))
                await self.writer.drain()
            elif code == 10:   # SASL: pick SCRAM-SHA-256
                self._require_password()
                mechs = [m for m in body[4:].split(b"\0") if m]
                if b"SCRAM-SHA-256" not in mechs:
                    raise ConnectError(
                        f"postgres: no supported SASL mechanism in {mechs}")
                scram = ScramClient(self.dsn.user, self.dsn.password)
                first = scram.client_first()
                self._send(b"p", _cstr("SCRAM-SHA-256")
                           + struct.pack(">I", len(first)) + first)
                await self.writer.drain()
                t2, b2 = await self._recv()
                if t2 == b"E":
                    self._raise_error(b2, ConnectError)
                (c2,) = struct.unpack_from(">I", b2, 0)
                if c2 != 11:  # AuthenticationSASLContinue
                    raise ConnectError("postgres: expected SASLContinue")
                final = scram.client_final(b2[4:])
                self._send(b"p", final)
                await self.writer.drain()
                t3, b3 = await self._recv()
                if t3 == b"E":
                    self._raise_error(b3, ConnectError)
                (c3,) = struct.unpack_from(">I", b3, 0)
                if c3 != 12:  # AuthenticationSASLFinal
                    raise ConnectError("postgres: expected SASLFinal")
                scram.verify_server_final(b3[4:])
            else:
                raise ConnectError(f"postgres: auth method {code} not supported")

    def _require_password(self) -> None:
        if self.dsn.password is None:
            raise ConnectError("postgres: server requires a password; none in uri")

    # -- simple query --

    async def query(self, sql: str) -> QueryResult:
        """Run one statement via the simple-query protocol."""
        async with self._lock:
            self._send(b"Q", _cstr(sql))
            await self.writer.drain()
            columns: list[str] = []
            oids: list[int] = []
            rows: list[list[Any]] = []
            tag = ""
            error: Optional[bytes] = None
            while True:
                t, body = await self._recv()
                if t == b"T":  # RowDescription
                    (n,) = struct.unpack_from(">H", body, 0)
                    pos = 2
                    columns, oids = [], []
                    for _ in range(n):
                        end = body.index(b"\0", pos)
                        columns.append(body[pos:end].decode())
                        pos = end + 1
                        _table, _attr, oid, _size, _mod, _fmt = struct.unpack_from(
                            ">IHIhih", body, pos)
                        pos += 18
                        oids.append(oid)
                elif t == b"D":  # DataRow
                    (n,) = struct.unpack_from(">H", body, 0)
                    pos = 2
                    row: list[Any] = []
                    for i in range(n):
                        (ln,) = struct.unpack_from(">i", body, pos)
                        pos += 4
                        if ln < 0:
                            row.append(None)
                        else:
                            row.append(decode_value(body[pos:pos + ln],
                                                    oids[i] if i < len(oids) else 25))
                            pos += ln
                    rows.append(row)
                elif t == b"C":  # CommandComplete
                    tag = body.rstrip(b"\0").decode()
                elif t == b"E":
                    error = body
                elif t == b"G":  # CopyInResponse to a bare COPY via query()
                    # abort the copy; copy_in() is the supported entry
                    self._send(b"f", _cstr("use copy_in()"))
                    await self.writer.drain()
                elif t == b"Z":  # ReadyForQuery — statement finished
                    if error is not None:
                        self._raise_error(error)
                    return QueryResult(columns, oids, rows, tag)
                # NoticeResponse('N'), EmptyQueryResponse('I') etc.: ignore

    async def copy_in(self, table: str, columns: list[str],
                      rows: list[list[Any]]) -> int:
        """Bulk insert via COPY table (cols) FROM STDIN (text format)."""
        cols = ", ".join(quote_ident(c) for c in columns)
        sql = f"COPY {quote_ident(table)} ({cols}) FROM STDIN"
        async with self._lock:
            self._send(b"Q", _cstr(sql))
            await self.writer.drain()
            t, body = await self._recv()
            if t == b"E":
                # consume the trailing ReadyForQuery, then raise
                while t != b"Z":
                    t, b2 = await self._recv()
                self._raise_error(body, WriteError)
            if t != b"G":
                raise WriteError(f"postgres: expected CopyInResponse, got {t!r}")
            payload = "".join(
                "\t".join(copy_escape(v) for v in row) + "\n" for row in rows
            ).encode()
            if payload:
                self._send(b"d", payload)
            self._send(b"c")  # CopyDone
            await self.writer.drain()
            tag = ""
            error = None
            while True:
                t, body = await self._recv()
                if t == b"C":
                    tag = body.rstrip(b"\0").decode()
                elif t == b"E":
                    error = body
                elif t == b"Z":
                    if error is not None:
                        self._raise_error(error, WriteError)
                    try:
                        return int(tag.split()[-1])
                    except (ValueError, IndexError):
                        return len(rows)

    async def insert_rows(self, table: str, columns: list[str],
                          rows: list[list[Any]]) -> int:
        """Multi-row INSERT fallback (literal-quoted; no extended protocol)."""
        if not rows:
            return 0
        cols = ", ".join(quote_ident(c) for c in columns)
        values = ", ".join(
            "(" + ", ".join(sql_literal(v) for v in row) + ")" for row in rows)
        res = await self.query(
            f"INSERT INTO {quote_ident(table)} ({cols}) VALUES {values}")
        try:
            return int(res.command_tag.split()[-1])
        except (ValueError, IndexError):
            return len(rows)

    async def close(self) -> None:
        if self.writer is not None:
            try:
                self._send(b"X")  # Terminate
                await self.writer.drain()
                self.writer.close()
                await self.writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            self.writer = None
