"""Minimal NATS client (text protocol over TCP) + JetStream pull consumers.

Counterpart of ``arkflow_tpu/connect/nats_client.py``: INFO/CONNECT
handshake, PING/PONG keepalive, SUB/UNSUB, PUB, MSG/HMSG dispatch (headers
advertised), inbox-based request/reply, and the JetStream JSON API layered
on top (durable pull consumers with explicit per-message acks).
"""

from __future__ import annotations

import asyncio
import json
import logging
import secrets
from dataclasses import dataclass, field
from typing import Callable, Optional

from arkflow_tpu_torch.errors import ConnectError, Disconnection, ReadError

logger = logging.getLogger("arkflow_torch.nats")


@dataclass
class NatsMessage:
    subject: str
    payload: bytes
    reply: Optional[str] = None
    sid: str = ""
    headers: dict = field(default_factory=dict)
    #: status code from an inline "NATS/1.0 <code> <desc>" header line
    #: (JetStream uses 404 no-messages / 408 request-timeout)
    status: Optional[int] = None


class NatsClient:
    def __init__(self, url: str, name: str = "arkflow-tpu",
                 username: Optional[str] = None, password: Optional[str] = None,
                 token: Optional[str] = None, ssl_context=None):
        # url: nats://host:port or host:port, optionally user:pass@host:port
        addr = url.split("://", 1)[-1]
        if "@" in addr:
            cred, addr = addr.rsplit("@", 1)
            if username is None:
                username, _, pw = cred.partition(":")
                password = password if password is not None else (pw or None)
        host, _, port = addr.partition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port or 4222)
        self.name = name
        self.username = username
        self.password = password
        self.token = token
        self.ssl_context = ssl_context
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._loop_task: Optional[asyncio.Task] = None
        self._subs: dict[str, Callable[[NatsMessage], None]] = {}
        self._next_sid = 1
        self._connected = False
        self.server_info: dict = {}

    async def connect(self, timeout: float = 5.0) -> None:
        try:
            self._reader, self._writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port), timeout
            )
            line = await asyncio.wait_for(self._reader.readline(), timeout)
        except (OSError, asyncio.TimeoutError) as e:
            raise ConnectError(f"nats connect to {self.host}:{self.port} failed: {e}") from e
        if not line.startswith(b"INFO "):
            raise ConnectError(f"nats: unexpected greeting {line[:64]!r}")
        self.server_info = json.loads(line[5:].decode())
        if self.ssl_context is not None:
            # standard NATS: plaintext INFO greeting, then the client upgrades
            # (implicit handshake_first servers are the rare exception)
            try:
                await asyncio.wait_for(
                    self._writer.start_tls(self.ssl_context, server_hostname=self.host),
                    timeout,
                )
            except (OSError, asyncio.TimeoutError, ValueError) as e:
                raise ConnectError(f"nats TLS upgrade failed: {e}") from e
        connect_opts = {
            "verbose": False,
            "pedantic": False,
            "name": self.name,
            "lang": "python-arkflow",
            "version": "0.1.0",
            "protocol": 1,
            "headers": True,  # JetStream status replies arrive as HMSG
        }
        if self.token:
            connect_opts["auth_token"] = self.token
        elif self.username is not None:
            connect_opts["user"] = self.username
            connect_opts["pass"] = self.password or ""
        self._writer.write(b"CONNECT " + json.dumps(connect_opts).encode() + b"\r\nPING\r\n")
        await self._writer.drain()
        pong = await asyncio.wait_for(self._reader.readline(), timeout)
        while pong.startswith(b"INFO "):
            pong = await asyncio.wait_for(self._reader.readline(), timeout)
        if not pong.startswith(b"PONG"):
            raise ConnectError(f"nats: handshake failed, got {pong[:64]!r}")
        self._connected = True
        self._loop_task = asyncio.create_task(self._dispatch_loop())

    async def _dispatch_loop(self) -> None:
        try:
            while True:
                line = await self._reader.readline()
                if not line:
                    break
                if line.startswith(b"MSG "):
                    parts = line[4:].strip().split(b" ")
                    if len(parts) == 3:
                        subject, sid, nbytes = parts
                        reply = None
                    else:
                        subject, sid, reply_b, nbytes = parts
                        reply = reply_b.decode()
                    payload = await self._reader.readexactly(int(nbytes))
                    await self._reader.readexactly(2)  # trailing \r\n
                    cb = self._subs.get(sid.decode())
                    if cb is not None:
                        cb(NatsMessage(subject.decode(), payload, reply, sid.decode()))
                elif line.startswith(b"HMSG "):
                    # HMSG <subject> <sid> [reply] <hdr_len> <total_len>
                    parts = line[5:].strip().split(b" ")
                    if len(parts) == 4:
                        subject, sid, hdr_len_b, total_b = parts
                        reply = None
                    else:
                        subject, sid, reply_b, hdr_len_b, total_b = parts
                        reply = reply_b.decode()
                    hdr_len, total = int(hdr_len_b), int(total_b)
                    blob = await self._reader.readexactly(total)
                    await self._reader.readexactly(2)
                    headers, status = _parse_headers(blob[:hdr_len])
                    cb = self._subs.get(sid.decode())
                    if cb is not None:
                        cb(NatsMessage(subject.decode(), blob[hdr_len:], reply,
                                       sid.decode(), headers, status))
                elif line.startswith(b"PING"):
                    self._writer.write(b"PONG\r\n")
                    await self._writer.drain()
                elif line.startswith(b"-ERR"):
                    logger.warning("nats server error: %s", line.strip().decode())
                # +OK / INFO: ignore
        except (asyncio.CancelledError, asyncio.IncompleteReadError, OSError):
            pass
        finally:
            self._connected = False

    @property
    def connected(self) -> bool:
        return self._connected

    async def subscribe(self, subject: str, cb: Callable[[NatsMessage], None],
                        queue_group: Optional[str] = None) -> str:
        sid = str(self._next_sid)
        self._next_sid += 1
        self._subs[sid] = cb
        q = f" {queue_group}" if queue_group else ""
        self._writer.write(f"SUB {subject}{q} {sid}\r\n".encode())
        await self._writer.drain()
        return sid

    async def publish(self, subject: str, payload: bytes, reply: Optional[str] = None) -> None:
        if not self._connected:
            raise Disconnection("nats connection lost")
        r = f" {reply}" if reply else ""
        self._writer.write(f"PUB {subject}{r} {len(payload)}\r\n".encode() + payload + b"\r\n")
        await self._writer.drain()

    async def unsubscribe(self, sid: str) -> None:
        self._subs.pop(sid, None)
        if self._connected:
            self._writer.write(f"UNSUB {sid}\r\n".encode())
            await self._writer.drain()

    async def request(self, subject: str, payload: bytes,
                      timeout: float = 5.0) -> NatsMessage:
        """Inbox-based request/reply (one response)."""
        inbox = f"_INBOX.{secrets.token_hex(11)}"
        fut: asyncio.Future = asyncio.get_running_loop().create_future()

        def on_reply(msg: NatsMessage) -> None:
            if not fut.done():
                fut.set_result(msg)

        sid = await self.subscribe(inbox, on_reply)
        try:
            await self.publish(subject, payload, reply=inbox)
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError as e:
            raise ReadError(f"nats request to {subject} timed out") from e
        finally:
            await self.unsubscribe(sid)

    async def close(self) -> None:
        if self._loop_task is not None:
            self._loop_task.cancel()
            try:
                await self._loop_task
            except (asyncio.CancelledError, Exception):
                pass
        if self._writer is not None:
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except Exception:
                pass
        self._connected = False


def _parse_headers(blob: bytes) -> tuple[dict, Optional[int]]:
    """NATS/1.0[ <code>[ <desc>]]\\r\\nKey: Value...\\r\\n\\r\\n -> (headers, status)."""
    headers: dict = {}
    status: Optional[int] = None
    lines = blob.split(b"\r\n")
    if lines and lines[0].startswith(b"NATS/1.0"):
        rest = lines[0][len(b"NATS/1.0"):].strip()
        if rest:
            try:
                status = int(rest.split(b" ", 1)[0])
            except ValueError:
                pass
    for ln in lines[1:]:
        if b":" in ln:
            k, _, v = ln.partition(b":")
            headers[k.decode().strip()] = v.decode().strip()
    return headers, status


class JetStream:
    """JetStream durable pull consumers over the core client.

    The JS API is JSON request/reply on ``$JS.API.*`` subjects; fetched
    messages carry their ack subject in ``reply`` (publish ``+ACK`` there
    for explicit at-least-once acking). Mirrors the capability surface of
    the reference's JetStream input mode (ref input/nats.rs:48-76).
    """

    def __init__(self, client: NatsClient, timeout: float = 5.0):
        self.client = client
        self.timeout = timeout

    async def _api(self, subject: str, payload: dict | None = None) -> dict:
        raw = json.dumps(payload).encode() if payload is not None else b""
        resp = await self.client.request(subject, raw, self.timeout)
        data = json.loads(resp.payload.decode() or "{}")
        return data

    async def ensure_pull_consumer(self, stream: str, durable: str,
                                   deliver_policy: str = "all",
                                   filter_subject: Optional[str] = None) -> None:
        """Create the durable pull consumer if it doesn't exist."""
        info = await self._api(f"$JS.API.CONSUMER.INFO.{stream}.{durable}")
        if "error" not in info:
            return
        if info["error"].get("code") not in (404,):
            raise ConnectError(f"jetstream consumer info failed: {info['error']}")
        config = {
            "durable_name": durable,
            "ack_policy": "explicit",
            "deliver_policy": deliver_policy,
        }
        if filter_subject:
            config["filter_subject"] = filter_subject
        created = await self._api(
            f"$JS.API.CONSUMER.DURABLE.CREATE.{stream}.{durable}",
            {"stream_name": stream, "config": config},
        )
        if "error" in created:
            raise ConnectError(f"jetstream consumer create failed: {created['error']}")

    async def fetch(self, stream: str, durable: str, batch: int = 64,
                    expires_s: float = 1.0) -> list[NatsMessage]:
        """Pull up to ``batch`` messages; returns [] when none are ready.

        Each returned message's ``reply`` is its ack subject.
        """
        inbox = f"_INBOX.{secrets.token_hex(11)}"
        out: list[NatsMessage] = []
        done: asyncio.Event = asyncio.Event()
        conflict: list[NatsMessage] = []

        def on_msg(msg: NatsMessage) -> None:
            if msg.status in (404, 408):  # no messages / request expired
                done.set()
                return
            if msg.status == 409:
                # consumer deleted / leadership change: NOT an empty pull —
                # surface it so the caller reconnects and recreates state
                conflict.append(msg)
                done.set()
                return
            out.append(msg)
            if len(out) >= batch:
                done.set()

        sid = await self.client.subscribe(inbox, on_msg)
        try:
            req = {"batch": batch, "expires": int(expires_s * 1e9)}
            await self.client.publish(
                f"$JS.API.CONSUMER.MSG.NEXT.{stream}.{durable}",
                json.dumps(req).encode(), reply=inbox)
            try:
                # the server ends the pull at `expires` (408 status); the
                # 1s grace only covers network skew, so a partial batch
                # returns promptly even if the status message is lost
                await asyncio.wait_for(done.wait(), expires_s + 1.0)
            except asyncio.TimeoutError:
                pass  # partial batch (or empty) is fine
            if conflict:
                hdr = conflict[0].headers
                raise Disconnection(
                    f"jetstream pull conflict (409) for {stream}/{durable}: {hdr}")
            return out
        finally:
            await self.client.unsubscribe(sid)

    async def ack(self, msg: NatsMessage) -> None:
        if msg.reply:
            await self.client.publish(msg.reply, b"+ACK")


def client_kwargs_from_config(config: dict) -> dict:
    """Parse connector-level auth/TLS config into NatsClient kwargs.

    ``password``/``token`` support ``${ENV}`` indirection like other secrets.
    """
    from arkflow_tpu_torch.connect import make_ssl_context
    from arkflow_tpu_torch.errors import ConfigError
    from arkflow_tpu_torch.utils.auth import resolve_secret

    kwargs: dict = {}
    if config.get("password") is not None and config.get("username") is None:
        raise ConfigError("nats: 'password' requires 'username'")
    if config.get("username") is not None:
        kwargs["username"] = str(config["username"])
        if config.get("password") is not None:
            kwargs["password"] = resolve_secret(str(config["password"]))
    if config.get("token") is not None:
        kwargs["token"] = resolve_secret(str(config["token"]))
    tls = config.get("tls")
    if tls is not None and tls is not False:  # `tls: {}` means system CAs
        kwargs["ssl_context"] = make_ssl_context({} if tls is True else dict(tls))
    return kwargs
