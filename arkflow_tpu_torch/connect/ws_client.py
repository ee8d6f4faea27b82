"""Minimal WebSocket client (RFC 6455) on ``asyncio`` streams.

The JAX websocket input runs on the ``websockets`` package, which the
card's machine lacks; this is the port's stdlib client for it:

- the opening handshake over ``ws://`` or ``wss://`` (stdlib ``ssl``), with
  the ``Sec-WebSocket-Accept`` check; no extension is offered;
- masked client frames; text and binary messages, fragmented into
  continuation frames or not, with 7-, 16- and 64-bit lengths;
- a ping answered with a pong carrying its data; a pong is dropped;
- the close handshake from either side (``close``, or the peer's close
  frame echoed), after which ``recv`` raises ``ConnectionClosed``;
- a message limit, ``max_size`` (1 MiB, ``websockets``' default): a longer
  message closes the connection with 1009, as ``websockets`` does.

    ws = await WebSocketClient.connect("ws://127.0.0.1:9443/feed")
    async for message in ws:    # str for text, bytes for binary
        ...
    await ws.close()

One task reads (``recv`` or the iteration); ``send`` and ``close`` may run
beside it. Iteration ends at a normal close (1000 or 1001) and raises
``ConnectionClosed`` at any other end, as ``websockets``' does.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import os
import ssl as _ssl
import struct
from typing import Optional, Union
from urllib.parse import urlsplit

GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA

#: ``websockets``' default ``max_size``
DEFAULT_MAX_SIZE = 1 << 20

Message = Union[str, bytes]


class InvalidHandshake(Exception):
    """The server did not answer the opening handshake as RFC 6455 asks."""


class ConnectionClosed(Exception):
    """The connection is closed; ``code`` and ``reason`` of the close frame
    received (1006 when the connection dropped without one)."""

    def __init__(self, code: int, reason: str = ""):
        super().__init__(f"websocket closed with code {code}" + (f": {reason}" if reason else ""))
        self.code = code
        self.reason = reason

    @property
    def ok(self) -> bool:
        return self.code in (1000, 1001)


def accept_key(key: str) -> str:
    """The ``Sec-WebSocket-Accept`` value for a ``Sec-WebSocket-Key``."""
    return base64.b64encode(hashlib.sha1(key.encode() + GUID).digest()).decode()


def encode_frame(opcode: int, payload: bytes, *, fin: bool = True,
                 mask: Optional[bytes] = None) -> bytes:
    """One frame; masked with ``mask`` (4 bytes) when given, as a client's
    must be."""
    head = bytearray([(0x80 if fin else 0) | opcode])
    n = len(payload)
    mbit = 0x80 if mask is not None else 0
    if n < 126:
        head.append(mbit | n)
    elif n < 1 << 16:
        head.append(mbit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mbit | 127)
        head += struct.pack(">Q", n)
    if mask is None:
        return bytes(head) + payload
    return bytes(head) + mask + apply_mask(payload, mask)


def apply_mask(payload: bytes, mask: bytes) -> bytes:
    """XOR ``payload`` with the repeated 4-byte ``mask`` (its own inverse)."""
    if not payload:
        return b""
    n = len(payload)
    key = int.from_bytes((mask * (n // 4 + 1))[:n], "big")
    return (int.from_bytes(payload, "big") ^ key).to_bytes(n, "big")


async def read_frame(reader: asyncio.StreamReader,
                     limit: int) -> tuple[bool, int, bytes, bool]:
    """``(fin, opcode, payload, masked)`` of the next frame, unmasked. A
    frame longer than ``limit`` raises ``ConnectionClosed(1009)`` before its
    payload is read."""
    b0, b1 = await reader.readexactly(2)
    fin, opcode = bool(b0 & 0x80), b0 & 0x0F
    if b0 & 0x70:
        raise ConnectionClosed(1002, "reserved bits set")
    masked, n = bool(b1 & 0x80), b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack(">H", await reader.readexactly(2))
    elif n == 127:
        (n,) = struct.unpack(">Q", await reader.readexactly(8))
    if n > limit:
        raise ConnectionClosed(1009, f"frame of {n} bytes exceeds limit of {limit}")
    mask = await reader.readexactly(4) if masked else None
    payload = await reader.readexactly(n) if n else b""
    if mask is not None:
        payload = apply_mask(payload, mask)
    return fin, opcode, payload, masked


def close_payload(code: int, reason: str = "") -> bytes:
    return struct.pack(">H", code) + reason.encode()


def parse_close(payload: bytes) -> tuple[int, str]:
    if len(payload) >= 2:
        return struct.unpack(">H", payload[:2])[0], payload[2:].decode("utf-8", "replace")
    return 1005, ""


class WebSocketClient:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 max_size: int = DEFAULT_MAX_SIZE):
        self._reader = reader
        self._writer = writer
        self.max_size = max_size
        self._closed: Optional[ConnectionClosed] = None
        self._close_sent = False
        self._write_lock = asyncio.Lock()
        #: pings answered (a checker reads it)
        self.pongs_sent = 0

    @classmethod
    async def connect(cls, url: str, *, max_size: int = DEFAULT_MAX_SIZE,
                      timeout: float = 10.0) -> "WebSocketClient":
        parts = urlsplit(url)
        scheme = parts.scheme.lower()
        if scheme not in ("ws", "wss") or not parts.hostname:
            raise InvalidHandshake(f"{url!r} is not a ws:// or wss:// URL")
        port = parts.port or (443 if scheme == "wss" else 80)
        ctx = _ssl.create_default_context() if scheme == "wss" else None
        reader, writer = await asyncio.wait_for(asyncio.open_connection(
            parts.hostname, port, ssl=ctx, server_hostname=parts.hostname if ctx else None),
            timeout)
        try:
            key = base64.b64encode(os.urandom(16)).decode()
            target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
            host = parts.hostname if parts.port is None else f"{parts.hostname}:{parts.port}"
            lines = [f"GET {target} HTTP/1.1", f"Host: {host}", "Upgrade: websocket",
                     "Connection: Upgrade", f"Sec-WebSocket-Key: {key}",
                     "Sec-WebSocket-Version: 13", "User-Agent: arkflow-tpu-torch"]
            writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
            await writer.drain()
            head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), timeout)
            rows = head.decode("latin-1").split("\r\n")
            status = rows[0].split(None, 2)
            hdrs = {k.strip().lower(): v.strip() for k, sep, v in
                    (r.partition(":") for r in rows[1:] if r) if sep}
            if len(status) < 2 or status[1] != "101":
                raise InvalidHandshake(f"server answered {rows[0]!r}, not 101")
            if hdrs.get("upgrade", "").lower() != "websocket" or "upgrade" not in {
                    t.strip().lower() for t in hdrs.get("connection", "").split(",")}:
                raise InvalidHandshake("server did not upgrade the connection to websocket")
            if hdrs.get("sec-websocket-accept") != accept_key(key):
                raise InvalidHandshake("bad Sec-WebSocket-Accept")
            if hdrs.get("sec-websocket-extensions"):
                raise InvalidHandshake("server chose an extension the client did not offer")
        except BaseException:
            writer.close()
            raise
        return cls(reader, writer, max_size)

    @property
    def closed(self) -> bool:
        return self._closed is not None

    async def _send_frame(self, opcode: int, payload: bytes, fin: bool = True) -> None:
        async with self._write_lock:
            self._writer.write(encode_frame(opcode, payload, fin=fin, mask=os.urandom(4)))
            await self._writer.drain()

    async def send(self, message: Message) -> None:
        if self._closed is not None or self._close_sent:
            raise self._closed or ConnectionClosed(1006, "closing")
        if isinstance(message, str):
            await self._send_frame(OP_TEXT, message.encode())
        else:
            await self._send_frame(OP_BINARY, bytes(message))

    async def _fail(self, code: int, reason: str) -> ConnectionClosed:
        """Close with ``code`` after a protocol fault of the peer."""
        closed = ConnectionClosed(code, reason)
        if not self._close_sent:
            self._close_sent = True
            try:
                await self._send_frame(OP_CLOSE, close_payload(code, reason[:100]))
            except (ConnectionError, RuntimeError):
                pass
        self._closed = closed
        self._writer.close()
        return closed

    async def recv(self) -> Message:
        """The next whole message; raises ``ConnectionClosed`` once the
        connection is closed."""
        if self._closed is not None:
            raise self._closed
        parts: list[bytes] = []
        size, first_op = 0, None
        while True:
            try:
                # a control frame may come between fragments at any size
                fin, opcode, payload, masked = await read_frame(
                    self._reader, max(self.max_size - size, 125))
            except ConnectionClosed as e:
                raise await self._fail(e.code, e.reason) from None
            except (asyncio.IncompleteReadError, ConnectionError, OSError):
                self._closed = ConnectionClosed(1006, "connection lost")
                self._writer.close()
                raise self._closed from None
            if masked:
                raise await self._fail(1002, "masked frame from the server")
            if opcode >= OP_CLOSE:  # control frames: unfragmented, <= 125 bytes
                if not fin or len(payload) > 125:
                    raise await self._fail(1002, "bad control frame")
                if opcode == OP_PING:
                    self.pongs_sent += 1
                    if not self._close_sent:
                        await self._send_frame(OP_PONG, payload)
                elif opcode == OP_CLOSE:
                    code, reason = parse_close(payload)
                    if not self._close_sent:
                        self._close_sent = True
                        try:
                            await self._send_frame(OP_CLOSE, payload[:2])
                        except (ConnectionError, RuntimeError):
                            pass
                    self._closed = ConnectionClosed(code, reason)
                    self._writer.close()
                    raise self._closed
                elif opcode != OP_PONG:
                    raise await self._fail(1002, f"unknown opcode {opcode}")
                continue
            if opcode == OP_CONT:
                if first_op is None:
                    raise await self._fail(1002, "continuation without a message")
            elif opcode in (OP_TEXT, OP_BINARY):
                if first_op is not None:
                    raise await self._fail(1002, "new message inside a fragmented one")
                first_op = opcode
            else:
                raise await self._fail(1002, f"unknown opcode {opcode}")
            size += len(payload)
            if size > self.max_size:
                raise await self._fail(1009, f"message exceeds limit of {self.max_size}")
            parts.append(payload)
            if fin:
                data = b"".join(parts)
                if first_op == OP_BINARY:
                    return data
                try:
                    return data.decode("utf-8")
                except UnicodeDecodeError:
                    raise await self._fail(1007, "invalid UTF-8 in a text message") from None

    def __aiter__(self):
        return self

    async def __anext__(self) -> Message:
        try:
            return await self.recv()
        except ConnectionClosed as e:
            if e.ok:
                raise StopAsyncIteration from None
            raise

    async def close(self, code: int = 1000, reason: str = "", timeout: float = 1.0) -> None:
        """Send a close frame and wait (at most ``timeout`` s) for the peer's,
        discarding any message before it; then close the connection."""
        if self._closed is not None:
            return
        if not self._close_sent:
            self._close_sent = True
            try:
                await self._send_frame(OP_CLOSE, close_payload(code, reason))
            except (ConnectionError, RuntimeError):
                pass

        async def drain() -> None:
            while True:
                try:
                    await self.recv()
                except ConnectionClosed:
                    return

        try:
            await asyncio.wait_for(drain(), timeout)
        except asyncio.TimeoutError:
            pass
        self._closed = self._closed or ConnectionClosed(code, reason)
        self._writer.close()
