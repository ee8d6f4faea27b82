"""MySQL wire-protocol client (asyncio, standard library only).

Counterpart of ``arkflow_tpu/connect/mysql_client.py``: the client side of
the classic protocol the ``sql`` input and output need.

- handshake v10 and HandshakeResponse41 with ``mysql_native_password``
  (SHA1 scramble) and ``caching_sha2_password`` (the SHA256 fast path; full
  auth needs TLS, where the protocol allows the cleartext password)
- TLS through the SSLRequest preamble (``ssl_mode`` disable, prefer, require)
- COM_QUERY text resultsets, each value decoded by its column's type and
  charset (integers, floats and decimals, strings, binary blobs; dates and
  times stay text)
- multi-row INSERT of escaped literals, COM_PING and COM_QUIT

Framing: a 3-byte little-endian payload length and a sequence byte;
integers little-endian, length-encoded integers and strings per the
protocol.
"""

from __future__ import annotations

import asyncio
import hashlib
import struct
from dataclasses import dataclass
from typing import Any, Optional
from urllib.parse import unquote, urlparse

from arkflow_tpu_torch.errors import ConfigError, ConnectError, ReadError, WriteError

# capability flags (subset)
CLIENT_LONG_PASSWORD = 1
CLIENT_PROTOCOL_41 = 0x0200
CLIENT_SSL = 0x0800
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_PLUGIN_AUTH = 1 << 19
CLIENT_CONNECT_WITH_DB = 8

# column types -> python converters (text protocol sends strings)
_INT_TYPES = {0x01, 0x02, 0x03, 0x08, 0x09, 0x0D}   # tiny..longlong, year
_FLOAT_TYPES = {0x04, 0x05, 0xF6, 0x00}             # float, double, newdecimal, decimal
_BLOB_TYPES = {0xF9, 0xFA, 0xFB, 0xFC, 0xFD, 0xFE}  # *blob, var_string, string
BINARY_CHARSET = 63                                  # charset 63 = binary data

MAX_PACKET = 0xFFFFFF  # payloads split at 16MiB-1 per the protocol


@dataclass(frozen=True)
class MyDsn:
    host: str
    port: int
    user: str
    password: Optional[str]
    database: str

    @classmethod
    def parse(cls, uri: str) -> "MyDsn":
        u = urlparse(uri)
        if u.scheme != "mysql":
            raise ConfigError(f"mysql uri must be mysql:// (got {uri!r})")
        if not u.hostname or not u.username:
            raise ConfigError(f"mysql uri needs user and host: {uri!r}")
        return cls(
            host=u.hostname, port=u.port or 3306,
            user=unquote(u.username),
            password=unquote(u.password) if u.password else None,
            database=(u.path or "/").lstrip("/"),
        )


def scramble_native(password: str, nonce: bytes) -> bytes:
    """mysql_native_password: SHA1(pw) XOR SHA1(nonce + SHA1(SHA1(pw)))."""
    p1 = hashlib.sha1(password.encode()).digest()
    p2 = hashlib.sha1(p1).digest()
    p3 = hashlib.sha1(nonce + p2).digest()
    return bytes(a ^ b for a, b in zip(p1, p3))


def scramble_sha2(password: str, nonce: bytes) -> bytes:
    """caching_sha2_password fast path:
    XOR(SHA256(pw), SHA256(SHA256(SHA256(pw)) + nonce))."""
    p1 = hashlib.sha256(password.encode()).digest()
    p2 = hashlib.sha256(hashlib.sha256(p1).digest() + nonce).digest()
    return bytes(a ^ b for a, b in zip(p1, p2))


def _lenenc_int(data: bytes, pos: int) -> tuple[int, int]:
    b = data[pos]
    if b < 0xFB:
        return b, pos + 1
    if b == 0xFC:
        return struct.unpack_from("<H", data, pos + 1)[0], pos + 3
    if b == 0xFD:
        return int.from_bytes(data[pos + 1:pos + 4], "little"), pos + 4
    if b == 0xFE:
        return struct.unpack_from("<Q", data, pos + 1)[0], pos + 9
    raise ReadError(f"mysql: bad length-encoded int 0x{b:02x}")


def _lenenc_str(data: bytes, pos: int) -> tuple[Optional[bytes], int]:
    if data[pos] == 0xFB:  # NULL
        return None, pos + 1
    n, pos = _lenenc_int(data, pos)
    return data[pos:pos + n], pos + n


def _enc_lenenc(data: bytes) -> bytes:
    n = len(data)
    if n < 0xFB:
        return bytes([n]) + data
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n) + data
    return b"\xfd" + n.to_bytes(3, "little") + data


def decode_text_value(raw: Optional[bytes], col_type: int,
                      charset: int = 45) -> Any:
    """Column values decode by (type, charset): blob/text share type codes,
    and the column's charset (63 = binary) decides bytes-vs-str — so every
    value in a column gets ONE python type (Arrow needs stable columns)."""
    if raw is None:
        return None
    if col_type in _INT_TYPES:
        return int(raw)
    if col_type in _FLOAT_TYPES:
        return float(raw)
    if col_type in _BLOB_TYPES and charset == BINARY_CHARSET:
        return raw
    return raw.decode(errors="replace")


@dataclass
class MyQueryResult:
    columns: list[str]
    types: list[tuple[int, int]]  # (type code, charset) per column
    rows: list[list[Any]]
    affected_rows: int = 0


class MySqlClient:
    def __init__(self, uri: str, *, ssl_mode: str = "prefer",
                 ssl_root_cert: Optional[str] = None, timeout: float = 10.0):
        self.dsn = MyDsn.parse(uri)
        if ssl_mode not in ("disable", "prefer", "require"):
            raise ConfigError(
                f"mysql ssl_mode {ssl_mode!r} invalid (disable/prefer/require)")
        self.ssl_mode = ssl_mode
        self.ssl_root_cert = ssl_root_cert
        self.timeout = timeout
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self._seq = 0
        self._tls_active = False
        self._lock = asyncio.Lock()
        self.server_version = ""

    # -- packet layer --

    async def _recv(self) -> bytes:
        """One logical payload, reassembling 16MiB wire-packet splits."""
        out = b""
        while True:
            hdr = await asyncio.wait_for(self.reader.readexactly(4), self.timeout)
            n = int.from_bytes(hdr[:3], "little")
            self._seq = (hdr[3] + 1) & 0xFF
            out += await asyncio.wait_for(self.reader.readexactly(n), self.timeout)
            if n < MAX_PACKET:
                return out

    def _send(self, payload: bytes) -> None:
        """Split payloads >= 16MiB into max-size packets per the protocol
        (a payload that is an exact multiple ends with an empty packet)."""
        while True:
            chunk, payload = payload[:MAX_PACKET], payload[MAX_PACKET:]
            self.writer.write(len(chunk).to_bytes(3, "little")
                              + bytes([self._seq]) + chunk)
            self._seq = (self._seq + 1) & 0xFF
            if len(chunk) < MAX_PACKET:
                return

    @staticmethod
    def _is_err(pkt: bytes) -> bool:
        return pkt[:1] == b"\xff"

    def _raise_err(self, pkt: bytes, cls=ReadError) -> None:
        code = struct.unpack_from("<H", pkt, 1)[0]
        msg = pkt[3:].decode(errors="replace")
        if msg.startswith("#"):  # sql state marker
            msg = msg[6:]
        raise cls(f"mysql error {code}: {msg}")

    # -- connection --

    async def connect(self) -> None:
        try:
            self.reader, self.writer = await asyncio.wait_for(
                asyncio.open_connection(self.dsn.host, self.dsn.port), self.timeout)
        except (OSError, asyncio.TimeoutError) as e:
            raise ConnectError(
                f"mysql: cannot reach {self.dsn.host}:{self.dsn.port}: {e}") from e
        try:
            await self._handshake()
        except BaseException:
            try:
                self.writer.close()
            except Exception:
                pass
            self.reader = self.writer = None
            raise

    async def _handshake(self) -> None:
        pkt = await self._recv()
        if self._is_err(pkt):
            self._raise_err(pkt, ConnectError)
        if pkt[0] != 10:
            raise ConnectError(f"mysql: unsupported protocol version {pkt[0]}")
        pos = 1
        end = pkt.index(b"\0", pos)
        self.server_version = pkt[pos:end].decode(errors="replace")
        pos = end + 1
        pos += 4  # thread id
        nonce = pkt[pos:pos + 8]
        pos += 9  # auth-data-1 + filler
        cap_low = struct.unpack_from("<H", pkt, pos)[0]
        pos += 2
        plugin = "mysql_native_password"
        cap = cap_low
        if len(pkt) > pos:
            pos += 1  # charset
            pos += 2  # status
            cap_high = struct.unpack_from("<H", pkt, pos)[0]
            cap = cap_low | (cap_high << 16)
            pos += 2
            auth_len = pkt[pos]
            pos += 1
            pos += 10  # reserved
            if cap & CLIENT_SECURE_CONNECTION:
                more = max(13, auth_len - 8)
                nonce = nonce + pkt[pos:pos + more].rstrip(b"\0")
                pos += more
            if cap & CLIENT_PLUGIN_AUTH:
                end = pkt.index(b"\0", pos) if b"\0" in pkt[pos:] else len(pkt)
                plugin = pkt[pos:end].decode(errors="replace")
        nonce = nonce[:20]

        caps = (CLIENT_LONG_PASSWORD | CLIENT_PROTOCOL_41
                | CLIENT_SECURE_CONNECTION | CLIENT_PLUGIN_AUTH)
        if self.dsn.database:
            caps |= CLIENT_CONNECT_WITH_DB
        if self.ssl_mode in ("prefer", "require") and cap & CLIENT_SSL:
            # SSLRequest: capabilities (incl. CLIENT_SSL) + maxpacket + charset,
            # then upgrade and resend the full response over TLS
            import ssl as _ssl

            body = struct.pack("<IIB23x", caps | CLIENT_SSL, 1 << 24, 45)
            self._send(body)
            await self.writer.drain()
            ctx = _ssl.create_default_context(cafile=self.ssl_root_cert)
            if self.ssl_root_cert is None:
                ctx.check_hostname = False
                ctx.verify_mode = _ssl.CERT_NONE
            await self.writer.start_tls(ctx, server_hostname=self.dsn.host)
            self._tls_active = True
            caps |= CLIENT_SSL
        elif self.ssl_mode == "require":
            raise ConnectError("mysql: server lacks TLS support (ssl_mode=require)")

        auth = self._auth_response(plugin, nonce)
        body = struct.pack("<IIB23x", caps, 1 << 24, 45)
        body += self.dsn.user.encode() + b"\0"
        body += _enc_lenenc(auth)
        if self.dsn.database:
            body += self.dsn.database.encode() + b"\0"
        body += plugin.encode() + b"\0"
        self._send(body)
        await self.writer.drain()
        await self._auth_loop(nonce)

    def _auth_response(self, plugin: str, nonce: bytes) -> bytes:
        if not self.dsn.password:
            return b""
        if plugin == "mysql_native_password":
            return scramble_native(self.dsn.password, nonce)
        if plugin == "caching_sha2_password":
            return scramble_sha2(self.dsn.password, nonce)
        raise ConnectError(f"mysql: auth plugin {plugin!r} not supported")

    async def _auth_loop(self, nonce: bytes) -> None:
        while True:
            pkt = await self._recv()
            if self._is_err(pkt):
                self._raise_err(pkt, ConnectError)
            first = pkt[0]
            if first == 0x00:  # OK
                return
            if first == 0xFE:  # AuthSwitchRequest
                end = pkt.index(b"\0", 1)
                plugin = pkt[1:end].decode(errors="replace")
                new_nonce = pkt[end + 1:].rstrip(b"\0")[:20]
                self._send(self._auth_response(plugin, new_nonce))
                await self.writer.drain()
                continue
            if first == 0x01:  # caching_sha2 extra data
                if pkt[1:2] == b"\x03":  # fast-auth success; OK follows
                    continue
                if pkt[1:2] == b"\x04":  # full auth needed
                    if not self._tls_active:
                        raise ConnectError(
                            "mysql: caching_sha2 full auth needs TLS "
                            "(set ssl_mode and enable server TLS)")
                    # over TLS the spec allows cleartext password + NUL
                    self._send((self.dsn.password or "").encode() + b"\0")
                    await self.writer.drain()
                    continue
            raise ConnectError(f"mysql: unexpected auth packet 0x{first:02x}")

    # -- queries --

    async def query(self, sql: str) -> MyQueryResult:
        async with self._lock:
            self._seq = 0
            self._send(b"\x03" + sql.encode())
            await self.writer.drain()
            pkt = await self._recv()
            if self._is_err(pkt):
                self._raise_err(pkt)
            if pkt[0] == 0x00:  # OK (no resultset)
                affected, pos = _lenenc_int(pkt, 1)
                return MyQueryResult([], [], [], affected)
            n_cols, _ = _lenenc_int(pkt, 0)
            columns: list[str] = []
            types: list[tuple[int, int]] = []  # (type code, charset)
            for _ in range(n_cols):
                col = await self._recv()
                columns.append(self._col_name(col))
                types.append(self._col_meta(col))
            pkt = await self._recv()
            if pkt[0] != 0xFE:  # EOF after definitions (classic protocol)
                raise ReadError("mysql: expected EOF after column definitions")
            rows: list[list[Any]] = []
            while True:
                pkt = await self._recv()
                if self._is_err(pkt):
                    self._raise_err(pkt)
                if pkt[0] == 0xFE and len(pkt) < 9:  # EOF
                    return MyQueryResult(columns, types, rows)
                pos = 0
                row: list[Any] = []
                for t, cs in types:
                    raw, pos = _lenenc_str(pkt, pos)
                    row.append(decode_text_value(raw, t, cs))
                rows.append(row)

    @staticmethod
    def _col_name(pkt: bytes) -> str:
        # ColumnDefinition41: catalog, schema, table, org_table, name, ...
        pos = 0
        for _ in range(4):
            s, pos = _lenenc_str(pkt, pos)
        name, pos = _lenenc_str(pkt, pos)
        return (name or b"").decode(errors="replace")

    @staticmethod
    def _col_meta(pkt: bytes) -> tuple[int, int]:
        """(type code, charset) from a ColumnDefinition41 packet."""
        pos = 0
        for _ in range(6):  # catalog..org_name
            s, pos = _lenenc_str(pkt, pos)
        n, pos = _lenenc_int(pkt, pos)  # fixed-fields length (0x0c)
        charset = struct.unpack_from("<H", pkt, pos)[0]
        pos += 2 + 4  # charset + column length
        return pkt[pos], charset

    async def insert_rows(self, table: str, columns: list[str],
                          rows: list[list[Any]]) -> int:
        if not rows:
            return 0
        cols = ", ".join(f"`{c.replace('`', '``')}`" for c in columns)
        values = ", ".join(
            "(" + ", ".join(_my_literal(v) for v in row) + ")" for row in rows)
        res = await self.query(
            f"INSERT INTO `{table.replace('`', '``')}` ({cols}) VALUES {values}")
        return res.affected_rows

    async def ping(self) -> bool:
        async with self._lock:
            self._seq = 0
            self._send(b"\x0e")
            await self.writer.drain()
            return (await self._recv())[0] == 0x00

    async def close(self) -> None:
        if self.writer is not None:
            try:
                self._seq = 0
                self._send(b"\x01")  # COM_QUIT
                await self.writer.drain()
                self.writer.close()
                await self.writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            self.writer = None


def _my_literal(v: Any) -> str:
    import math

    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float) and not math.isfinite(v):
        return "NULL"  # mysql has no NaN/Infinity literals
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, (bytes, bytearray)):
        return "x'" + bytes(v).hex() + "'"
    s = str(v)
    # standard mysql string escaping
    for a, b in (("\\", "\\\\"), ("'", "\\'"), ("\n", "\\n"),
                 ("\r", "\\r"), ("\x00", "\\0"), ("\x1a", "\\Z")):
        s = s.replace(a, b)
    return "'" + s + "'"
