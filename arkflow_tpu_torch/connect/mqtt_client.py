"""Minimal MQTT 3.1.1 client (QoS 0/1/2) on asyncio.

Counterpart of ``arkflow_tpu/connect/mqtt_client.py``: CONNECT/CONNACK,
SUBSCRIBE/SUBACK, PUBLISH both directions (QoS 1 with PUBACK, QoS 2 with
the full PUBREC/PUBREL/PUBCOMP exactly-once handshake in both roles),
PINGREQ/PINGRESP keepalive, DISCONNECT.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import Callable, Optional

from arkflow_tpu_torch.errors import ConnectError, Disconnection

logger = logging.getLogger("arkflow_torch.mqtt")

# packet types (<<4)
CONNECT, CONNACK, PUBLISH, PUBACK = 1, 2, 3, 4
PUBREC, PUBREL, PUBCOMP = 5, 6, 7
SUBSCRIBE, SUBACK = 8, 9
PINGREQ, PINGRESP, DISCONNECT = 12, 13, 14


def _encode_remaining_length(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n % 128
        n //= 128
        if n > 0:
            byte |= 0x80
        out.append(byte)
        if n == 0:
            return bytes(out)


def _utf8(s: str) -> bytes:
    b = s.encode()
    return len(b).to_bytes(2, "big") + b


@dataclass
class MqttMessage:
    topic: str
    payload: bytes
    qos: int
    retain: bool
    packet_id: Optional[int] = None


class MqttClient:
    def __init__(self, host: str, port: int = 1883, client_id: str = "arkflow-tpu",
                 username: Optional[str] = None, password: Optional[str] = None,
                 keepalive_s: int = 60, clean_session: bool = True):
        self.host = host
        self.port = port
        self.client_id = client_id
        self.username = username
        self.password = password
        self.keepalive_s = keepalive_s
        self.clean_session = clean_session
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._loop_task: Optional[asyncio.Task] = None
        self._ping_task: Optional[asyncio.Task] = None
        self._on_message: Optional[Callable[[MqttMessage], None]] = None
        self._next_packet_id = 1
        self._pending: dict[int, asyncio.Future] = {}
        #: inbound QoS-2 packet ids whose message was already delivered
        #: (exactly-once: a DUP re-PUBLISH must not redeliver)
        self._inbound_qos2: set[int] = set()
        self._connected = False

    # -- wire helpers --------------------------------------------------------

    async def _send_packet(self, ptype: int, flags: int, body: bytes) -> None:
        header = bytes([(ptype << 4) | flags]) + _encode_remaining_length(len(body))
        self._writer.write(header + body)
        await self._writer.drain()

    async def _read_packet(self) -> tuple[int, int, bytes]:
        h = await self._reader.readexactly(1)
        ptype, flags = h[0] >> 4, h[0] & 0x0F
        # remaining length varint
        mult, value = 1, 0
        for _ in range(4):
            b = (await self._reader.readexactly(1))[0]
            value += (b & 0x7F) * mult
            if not b & 0x80:
                break
            mult *= 128
        body = await self._reader.readexactly(value) if value else b""
        return ptype, flags, body

    def _packet_id(self) -> int:
        pid = self._next_packet_id
        self._next_packet_id = pid % 65535 + 1
        return pid

    # -- lifecycle -----------------------------------------------------------

    async def connect(self, timeout: float = 5.0) -> None:
        try:
            self._reader, self._writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port), timeout
            )
        except (OSError, asyncio.TimeoutError) as e:
            raise ConnectError(f"mqtt connect to {self.host}:{self.port} failed: {e}") from e
        flags = 0x02 if self.clean_session else 0x00
        payload = _utf8(self.client_id)
        if self.username is not None:
            flags |= 0x80
            payload += _utf8(self.username)
            if self.password is not None:
                flags |= 0x40
                payload += _utf8(self.password)
        body = (
            _utf8("MQTT") + bytes([4, flags]) + self.keepalive_s.to_bytes(2, "big") + payload
        )
        await self._send_packet(CONNECT, 0, body)
        ptype, _, ack = await asyncio.wait_for(self._read_packet(), timeout)
        if ptype != CONNACK or len(ack) < 2 or ack[1] != 0:
            raise ConnectError(f"mqtt CONNACK refused (type={ptype}, rc={ack[1] if len(ack) > 1 else '?'})")
        self._connected = True
        self._loop_task = asyncio.create_task(self._dispatch_loop())
        self._ping_task = asyncio.create_task(self._ping_loop())

    async def _ping_loop(self) -> None:
        try:
            while True:
                await asyncio.sleep(max(5.0, self.keepalive_s / 2))
                await self._send_packet(PINGREQ, 0, b"")
        except (asyncio.CancelledError, OSError, ConnectionError):
            pass

    async def _dispatch_loop(self) -> None:
        try:
            while True:
                ptype, flags, body = await self._read_packet()
                if ptype == PUBLISH:
                    qos = (flags >> 1) & 0x03
                    retain = bool(flags & 0x01)
                    tlen = int.from_bytes(body[:2], "big")
                    topic = body[2 : 2 + tlen].decode("utf-8", "replace")
                    pos = 2 + tlen
                    pid = None
                    if qos > 0:
                        pid = int.from_bytes(body[pos : pos + 2], "big")
                        pos += 2
                    payload = body[pos:]
                    deliver = True
                    if qos == 1 and pid is not None:
                        await self._send_packet(PUBACK, 0, pid.to_bytes(2, "big"))
                    elif qos == 2 and pid is not None:
                        # exactly-once receive: deliver on first sight of the
                        # pid, suppress DUP retransmits until PUBREL clears it
                        deliver = pid not in self._inbound_qos2
                        self._inbound_qos2.add(pid)
                        await self._send_packet(PUBREC, 0, pid.to_bytes(2, "big"))
                    if deliver and self._on_message is not None:
                        self._on_message(MqttMessage(topic, payload, qos, retain, pid))
                elif ptype == PUBREL:
                    pid = int.from_bytes(body[:2], "big")
                    self._inbound_qos2.discard(pid)
                    await self._send_packet(PUBCOMP, 0, pid.to_bytes(2, "big"))
                elif ptype == PUBREC:
                    # outbound QoS 2 stage 1: release; the pending future
                    # resolves at PUBCOMP
                    pid = int.from_bytes(body[:2], "big")
                    await self._send_packet(PUBREL, 0x02, pid.to_bytes(2, "big"))
                elif ptype in (PUBACK, PUBCOMP, SUBACK):
                    pid = int.from_bytes(body[:2], "big")
                    fut = self._pending.pop(pid, None)
                    if fut is not None and not fut.done():
                        fut.set_result(body)
                # PINGRESP ignored
        except (asyncio.CancelledError, asyncio.IncompleteReadError, OSError):
            pass
        finally:
            self._connected = False
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(Disconnection("mqtt connection lost"))
            self._pending.clear()

    @property
    def connected(self) -> bool:
        return self._connected

    # -- operations ----------------------------------------------------------

    def on_message(self, cb: Callable[[MqttMessage], None]) -> None:
        self._on_message = cb

    async def subscribe(self, topic: str, qos: int = 0, timeout: float = 5.0) -> None:
        if qos not in (0, 1, 2):
            raise ConnectError(f"mqtt QoS must be 0/1/2, got {qos}")
        pid = self._packet_id()
        fut = asyncio.get_running_loop().create_future()
        self._pending[pid] = fut
        body = pid.to_bytes(2, "big") + _utf8(topic) + bytes([qos])
        await self._send_packet(SUBSCRIBE, 0x02, body)
        await asyncio.wait_for(fut, timeout)

    async def publish(self, topic: str, payload: bytes, qos: int = 0,
                      retain: bool = False, timeout: float = 5.0) -> None:
        if not self._connected:
            raise Disconnection("mqtt connection lost")
        if qos not in (0, 1, 2):
            raise ConnectError(f"mqtt QoS must be 0/1/2, got {qos}")
        flags = (qos << 1) | (1 if retain else 0)
        body = _utf8(topic)
        fut = None
        if qos > 0:
            pid = self._packet_id()
            fut = asyncio.get_running_loop().create_future()
            self._pending[pid] = fut
            body += pid.to_bytes(2, "big")
        body += payload
        await self._send_packet(PUBLISH, flags, body)
        if fut is not None:
            # QoS 1 resolves at PUBACK; QoS 2 at PUBCOMP (PUBREC->PUBREL
            # happens inside the dispatch loop)
            await asyncio.wait_for(fut, timeout)

    async def close(self) -> None:
        for t in (self._ping_task, self._loop_task):
            if t is not None:
                t.cancel()
                try:
                    await t
                except (asyncio.CancelledError, Exception):
                    pass
        if self._writer is not None:
            try:
                await self._send_packet(DISCONNECT, 0, b"")
            except Exception:
                pass
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except Exception:
                pass
        self._connected = False
