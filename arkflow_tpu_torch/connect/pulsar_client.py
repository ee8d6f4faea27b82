"""Native Apache Pulsar wire-protocol client (asyncio, no external libs).

Counterpart of ``arkflow_tpu/connect/pulsar_client.py``, on the port's own
proto2 codec (``connect/pulsar_proto.py``) where JAX compiles the
``PulsarApi`` subset through ``protoc`` and ``google.protobuf``, and on the
port's ``native.crc32c``:

- CONNECT/CONNECTED handshake with optional token auth, answering a
  broker's AUTH_CHALLENGE in place (with refreshed credentials where a
  refresh hook is given, as OAuth2 bearers expire)
- topic LOOKUP with redirect-following (Pulsar's own service discovery),
  a TLS client following the TLS address, and a proxied broker reached
  through the service address (``proxy_to_broker_url``)
- consumer: SUBSCRIBE (exclusive/shared/failover/key_shared), FLOW permit
  management, MESSAGE decode (incl. batched payloads), individual ACK held
  for a batched entry until every sibling is acked
- producer: PRODUCER registration, SEND with crc32c-checksummed payload
  frames, SEND_RECEIPT/SEND_ERROR correlation by sequence id
- keepalive: PING answered with PONG; a broker's CLOSE_CONSUMER or
  CLOSE_PRODUCER surfaces as ``Disconnection``
- OAuth2 client credentials (``fetch_oauth2_token``) over the port's
  ``utils/http1.HttpClient``, where JAX uses ``aiohttp``

Wire framing:

- simple command:  [totalSize u32][commandSize u32][BaseCommand]
- payload command: [totalSize][commandSize][BaseCommand(SEND|MESSAGE)]
                   [magic 0x0e01][crc32c u32][metadataSize u32]
                   [MessageMetadata][payload]
  with the checksum covering metadataSize..payload.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import zlib
from dataclasses import dataclass
from typing import Optional
from urllib.parse import urlparse

from arkflow_tpu_torch.connect.pulsar_proto import MESSAGES, Message
from arkflow_tpu_torch.errors import (ConfigError, ConnectError, Disconnection, ReadError,
                                      WriteError)
from arkflow_tpu_torch.native import crc32c

logger = logging.getLogger("arkflow_torch.pulsar")

CLIENT_VERSION = "arkflow-tpu-0.2"
PROTOCOL_VERSION = 12
MAGIC = 0x0E01

# BaseCommand.Type
CONNECT, CONNECTED, SUBSCRIBE, PRODUCER, SEND, SEND_RECEIPT, SEND_ERROR = 2, 3, 4, 5, 6, 7, 8
MESSAGE, ACK, FLOW, UNSUBSCRIBE, SUCCESS, ERROR = 9, 10, 11, 12, 13, 14
CLOSE_PRODUCER, CLOSE_CONSUMER, PRODUCER_SUCCESS, PING, PONG = 15, 16, 17, 18, 19
LOOKUP, LOOKUP_RESPONSE, AUTH_CHALLENGE, AUTH_RESPONSE = 23, 24, 36, 37
# CommandLookupTopicResponse.LookupType
LOOKUP_REDIRECT, LOOKUP_CONNECT, LOOKUP_FAILED = 0, 1, 2


def encode_simple(cmd: Message) -> bytes:
    body = cmd.encode()
    return struct.pack(">II", 4 + len(body), len(body)) + body


def encode_payload_cmd(cmd: Message, metadata: Message, payload: bytes) -> bytes:
    body = cmd.encode()
    meta = metadata.encode()
    checked = struct.pack(">I", len(meta)) + meta + payload
    crc = crc32c(checked)
    frame = (
        struct.pack(">I", len(body)) + body
        + struct.pack(">HI", MAGIC, crc) + checked
    )
    return struct.pack(">I", len(frame)) + frame


def decode_frame(frame: bytes) -> tuple[Message, Optional[bytes]]:
    """One frame after its total size -> (BaseCommand, the payload section
    of SEND/MESSAGE or None)."""
    (cmd_size,) = struct.unpack_from(">I", frame, 0)
    cmd = Message.decode("BaseCommand", frame[4:4 + cmd_size])
    payload_part = frame[4 + cmd_size:]
    return cmd, (payload_part if payload_part else None)


@dataclass
class PulsarMessage:
    message_id: Optional[Message]   # MessageIdData
    payload: bytes
    properties: dict
    partition_key: Optional[str]
    redelivery_count: int = 0
    batch_index: int = -1


def decode_payload_section(data: bytes) -> tuple[Message, list[PulsarMessage]]:
    """[magic][crc][metaSize][metadata][payload] -> (metadata, single payloads).

    Batched payloads (num_messages_in_batch set) split on
    SingleMessageMetadata framing; message ids are filled by the caller.
    """
    magic, crc = struct.unpack_from(">HI", data, 0)
    if magic != MAGIC:
        raise ReadError(f"pulsar: bad payload magic 0x{magic:04x}")
    checked = data[6:]
    actual = crc32c(checked)
    if actual != crc:
        raise ReadError(f"pulsar: payload checksum mismatch ({actual:#x} != {crc:#x})")
    (meta_size,) = struct.unpack_from(">I", checked, 0)
    metadata = Message.decode("MessageMetadata", checked[4:4 + meta_size])
    payload = checked[4 + meta_size:]
    if metadata.compression == 2:  # ZLIB (stdlib); LZ4/ZSTD/SNAPPY need libs
        payload = zlib.decompress(payload)
    elif metadata.compression != 0:
        raise ReadError(
            f"pulsar: compression type {metadata.compression} not supported (none/zlib)"
        )
    out: list[PulsarMessage] = []
    if metadata.has("num_messages_in_batch"):
        pos = 0
        for i in range(metadata.num_messages_in_batch):
            (smm_size,) = struct.unpack_from(">I", payload, pos)
            pos += 4
            smm = Message.decode("SingleMessageMetadata", payload[pos:pos + smm_size])
            pos += smm_size
            body = payload[pos:pos + smm.payload_size]
            pos += smm.payload_size
            out.append(PulsarMessage(
                message_id=None, payload=bytes(body),
                properties={kv.key: kv.value for kv in smm.properties},
                partition_key=smm.partition_key if smm.has("partition_key") else None,
                batch_index=i,
            ))
    else:
        out.append(PulsarMessage(
            message_id=None, payload=bytes(payload),
            properties={kv.key: kv.value for kv in metadata.properties},
            partition_key=metadata.partition_key if metadata.has("partition_key") else None,
        ))
    return metadata, out


def parse_service_url(service_url: str) -> tuple[str, int, bool]:
    u = urlparse(service_url)
    if u.scheme not in ("pulsar", "pulsar+ssl"):
        raise ConfigError(
            f"pulsar service_url must be pulsar:// or pulsar+ssl:// (got {service_url!r})"
        )
    if not u.hostname:
        raise ConfigError(f"pulsar service_url missing host: {service_url!r}")
    return u.hostname, u.port or 6650, u.scheme == "pulsar+ssl"


def validate_topic(topic: str) -> str:
    """Accepts short names and full persistent://tenant/namespace/topic
    forms; a short name lives in ``public/default``."""
    if not topic or not topic.strip():
        raise ConfigError("pulsar topic must not be empty")
    if "://" in topic:
        scheme, rest = topic.split("://", 1)
        if scheme not in ("persistent", "non-persistent"):
            raise ConfigError(f"pulsar topic scheme must be persistent/non-persistent: {topic!r}")
        if len([p for p in rest.split("/") if p]) != 3:
            raise ConfigError(
                f"pulsar topic must be scheme://tenant/namespace/topic: {topic!r}"
            )
        return topic
    if "/" in topic:
        raise ConfigError(
            f"pulsar topic with slashes must use the full persistent:// form: {topic!r}"
        )
    return f"persistent://public/default/{topic}"


SUB_TYPES = {"exclusive": 0, "shared": 1, "failover": 2, "key_shared": 3}


def command(type_: int, field: Optional[str] = None, **values) -> Message:
    """A BaseCommand of ``type_`` carrying its ``field`` message."""
    cmd = Message("BaseCommand", type=type_)
    if field is not None:
        setattr(cmd, field, Message(MESSAGES["BaseCommand"][field].type, **values))
    return cmd


class _Conn:
    """One broker TCP connection: handshake, frame reader, request correlation."""

    def __init__(self, host: str, port: int, *, tls: bool = False,
                 auth_method: Optional[str] = None, auth_data: Optional[bytes] = None,
                 timeout: float = 10.0, proxy_to_broker_url: Optional[str] = None,
                 auth_refresh=None, on_auth_data=None):
        self.host, self.port, self.tls = host, port, tls
        self.auth_method, self.auth_data = auth_method, auth_data
        # async () -> bytes: re-acquire credentials for AUTH_CHALLENGE
        # (OAuth2 bearers expire; brokers challenge mid-connection)
        self.auth_refresh = auth_refresh
        # bytes -> None: propagate a refreshed bearer to the owning client so
        # NEW connections (broker failover, expr topics) don't dial with the
        # stale token fetched at connect time
        self.on_auth_data = on_auth_data
        self._auth_task: Optional[asyncio.Task] = None
        self.timeout = timeout
        self.proxy_to_broker_url = proxy_to_broker_url
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.max_message_size = 5 * 1024 * 1024
        self._pending: dict[int, asyncio.Future] = {}       # request_id -> fut
        self._send_waiters: dict[tuple[int, int], asyncio.Future] = {}
        self._consumers: dict[int, "PulsarConsumer"] = {}
        self._producers: dict[int, "PulsarProducer"] = {}
        self._reader_task: Optional[asyncio.Task] = None
        self._closed = False
        self._req_id = 0
        self._lock = asyncio.Lock()

    def next_request_id(self) -> int:
        self._req_id += 1
        return self._req_id

    async def connect(self) -> None:
        import ssl as _ssl

        ctx = _ssl.create_default_context() if self.tls else None
        try:
            self.reader, self.writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port, ssl=ctx), self.timeout
            )
        except (OSError, asyncio.TimeoutError) as e:
            raise ConnectError(f"pulsar: cannot reach {self.host}:{self.port}: {e}") from e
        try:
            await self._handshake()
        except BaseException:
            try:
                self.writer.close()
            except Exception:
                pass
            self.writer = None
            self.reader = None
            raise

    async def _handshake(self) -> None:
        connect = Message("CommandConnect", client_version=CLIENT_VERSION,
                          protocol_version=PROTOCOL_VERSION)
        if self.auth_method:
            connect.auth_method_name = self.auth_method
            connect.auth_data = self.auth_data or b""
        if self.proxy_to_broker_url:
            # physical target is a pulsar-proxy; tell it which broker to
            # tunnel this connection to
            connect.proxy_to_broker_url = self.proxy_to_broker_url
        self.writer.write(encode_simple(Message("BaseCommand", type=CONNECT, connect=connect)))
        await self.writer.drain()
        resp, _ = await asyncio.wait_for(self._read_frame(), self.timeout)
        if resp.type == ERROR:
            raise ConnectError(f"pulsar connect rejected: {resp.error.message}")
        if resp.type != CONNECTED:
            raise ConnectError(f"pulsar: expected CONNECTED, got type {resp.type}")
        if resp.connected.has("max_message_size"):
            self.max_message_size = resp.connected.max_message_size
        self._reader_task = asyncio.create_task(self._read_loop())

    async def _read_frame(self) -> tuple[Message, Optional[bytes]]:
        """Read one frame -> (BaseCommand, payload section or None), where the
        payload section is the raw magic..payload bytes of SEND/MESSAGE."""
        hdr = await self.reader.readexactly(4)
        (total,) = struct.unpack(">I", hdr)
        return decode_frame(await self.reader.readexactly(total))

    async def _read_loop(self) -> None:
        try:
            while not self._closed:
                cmd, payload = await self._read_frame()
                await self._dispatch(cmd, payload)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        except asyncio.CancelledError:
            return
        except Exception as e:  # malformed frame — fail everything waiting
            logger.warning("pulsar reader error: %s", e)
        self._fail_all(Disconnection("pulsar connection lost"))

    def _fail_all(self, err: Exception) -> None:
        self._closed = True
        for fut in list(self._pending.values()) + list(self._send_waiters.values()):
            if not fut.done():
                fut.set_exception(err)
        self._pending.clear()
        self._send_waiters.clear()
        for cons in self._consumers.values():
            cons._on_disconnect()

    async def _dispatch(self, cmd: Message, payload: Optional[bytes]) -> None:
        t = cmd.type
        if t == PING:
            self.writer.write(encode_simple(Message("BaseCommand", type=PONG)))
            await self.writer.drain()
            return
        if t == AUTH_CHALLENGE:
            # the broker wants fresh credentials (bearer expiry): answer off
            # the read loop, since the refresh may do an HTTP token exchange
            if self._auth_task is None or self._auth_task.done():
                self._auth_task = asyncio.create_task(self._answer_auth_challenge())
            return
        if t == MESSAGE:
            cons = self._consumers.get(cmd.message.consumer_id)
            if cons is not None:
                cons._on_message(cmd.message, payload)
            return
        if t == SEND_RECEIPT:
            key = (cmd.send_receipt.producer_id, cmd.send_receipt.sequence_id)
            fut = self._send_waiters.pop(key, None)
            if fut and not fut.done():
                fut.set_result(cmd.send_receipt)
            return
        if t == SEND_ERROR:
            key = (cmd.send_error.producer_id, cmd.send_error.sequence_id)
            fut = self._send_waiters.pop(key, None)
            if fut and not fut.done():
                fut.set_exception(WriteError(
                    f"pulsar send error {cmd.send_error.error}: {cmd.send_error.message}"))
            return
        if t == CLOSE_CONSUMER:  # broker-initiated (topic unload/failover)
            cons = self._consumers.pop(cmd.close_consumer.consumer_id, None)
            if cons is not None:
                # surface as Disconnection so the stream's reconnect loop
                # re-subscribes (same semantics as a dropped connection)
                cons._on_disconnect()
                return
        if t == CLOSE_PRODUCER:  # broker-initiated
            prod = self._producers.pop(cmd.close_producer.producer_id, None)
            if prod is not None:
                prod.server_closed = True
                for key, fut in list(self._send_waiters.items()):
                    if key[0] == prod.producer_id and not fut.done():
                        fut.set_exception(Disconnection("pulsar producer closed by broker"))
                        self._send_waiters.pop(key, None)
                return
        req_id = _request_id_of(cmd)
        if req_id is not None:
            fut = self._pending.pop(req_id, None)
            if fut and not fut.done():
                if t == ERROR:
                    fut.set_exception(ReadError(
                        f"pulsar error {cmd.error.error}: {cmd.error.message}"))
                else:
                    fut.set_result(cmd)
            return
        logger.debug("pulsar: unhandled command type %d", t)

    async def _answer_auth_challenge(self) -> None:
        data = self.auth_data or b""
        if self.auth_refresh is not None:
            try:
                data = await self.auth_refresh()
                self.auth_data = data
                if self.on_auth_data is not None:
                    self.on_auth_data(data)
            except Exception as e:
                # answer with the stale bearer rather than going silent: the
                # broker's rejection then surfaces as a normal Disconnection
                # and the stream's reconnect loop takes over
                logger.warning("pulsar: credential refresh for AUTH_CHALLENGE "
                               "failed (answering with previous data): %s", e)
        cmd = command(AUTH_RESPONSE, "authResponse", client_version=CLIENT_VERSION,
                      protocol_version=PROTOCOL_VERSION,
                      response=Message("AuthData", auth_method_name=self.auth_method or "none",
                                       auth_data=data))
        try:
            await self.send_frame(encode_simple(cmd))
        except (ConnectionError, OSError) as e:
            logger.warning("pulsar: could not send AUTH_RESPONSE: %s", e)

    async def request(self, cmd: Message) -> Message:
        """Send a command carrying a request_id and await its response."""
        req_id = _outgoing_request_id(cmd)
        assert req_id is not None
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        async with self._lock:
            self.writer.write(encode_simple(cmd))
            await self.writer.drain()
        return await asyncio.wait_for(fut, self.timeout)

    async def send_frame(self, raw: bytes) -> None:
        async with self._lock:
            self.writer.write(raw)
            await self.writer.drain()

    async def close(self) -> None:
        self._closed = True
        if self._auth_task is not None and not self._auth_task.done():
            self._auth_task.cancel()
            try:
                await self._auth_task
            except (asyncio.CancelledError, Exception):
                pass
        if self._reader_task:
            self._reader_task.cancel()
            try:
                await self._reader_task
            except (asyncio.CancelledError, Exception):
                pass
        # wake anything still blocked on this connection (receive() has no
        # timeout; the cancelled read loop returns before its own _fail_all)
        self._fail_all(Disconnection("pulsar connection closed"))
        if self.writer:
            try:
                self.writer.close()
                await self.writer.wait_closed()
            except (ConnectionError, OSError):
                pass


def _request_id_of(cmd: Message) -> Optional[int]:
    """request_id of an incoming response command."""
    for f in ("success", "error", "producer_success", "lookupTopicResponse"):
        if cmd.has(f):
            return getattr(cmd, f).request_id
    return None


def _outgoing_request_id(cmd: Message) -> Optional[int]:
    """request_id of an outgoing request command."""
    for f in ("lookupTopic", "subscribe", "producer", "unsubscribe",
              "close_producer", "close_consumer"):
        if cmd.has(f):
            return getattr(cmd, f).request_id
    return None


class PulsarClient:
    """Client entry: lookup + consumer/producer factories over broker conns."""

    def __init__(self, service_url: str, *, auth_method: Optional[str] = None,
                 auth_data: Optional[bytes] = None, timeout: float = 10.0,
                 max_lookup_redirects: int = 3, auth_refresh=None):
        self.service_url = service_url
        self.host, self.port, self.tls = parse_service_url(service_url)
        self.auth_method, self.auth_data = auth_method, auth_data
        self.auth_refresh = auth_refresh
        self.timeout = timeout
        self.max_lookup_redirects = max_lookup_redirects
        self._conns: dict[tuple, _Conn] = {}
        self._ids = 0

    def _next_id(self) -> int:
        self._ids += 1
        return self._ids

    def _set_auth_data(self, data: bytes) -> None:
        """A connection's AUTH_CHALLENGE refresh updates the client-level
        bearer too, so later connections dial with live credentials."""
        self.auth_data = data

    async def _get_conn(self, host: str, port: int,
                        proxy_to_broker_url: Optional[str] = None,
                        tls: Optional[bool] = None) -> _Conn:
        key = (host, port, proxy_to_broker_url)
        conn = self._conns.get(key)
        if conn is not None and not conn._closed:
            return conn
        conn = _Conn(host, port,
                     tls=self.tls if tls is None else tls,
                     auth_method=self.auth_method,
                     auth_data=self.auth_data, timeout=self.timeout,
                     proxy_to_broker_url=proxy_to_broker_url,
                     auth_refresh=self.auth_refresh,
                     on_auth_data=self._set_auth_data)
        await conn.connect()
        self._conns[key] = conn
        return conn

    async def lookup(self, topic: str) -> _Conn:
        """Resolve the broker owning `topic`, following redirects."""
        host, port, tls = self.host, self.port, self.tls
        for _ in range(self.max_lookup_redirects + 1):
            conn = await self._get_conn(host, port, tls=tls)
            resp = await conn.request(command(LOOKUP, "lookupTopic", topic=topic,
                                              request_id=conn.next_request_id()))
            lr = resp.lookupTopicResponse
            if lr.response == LOOKUP_FAILED:
                raise ConnectError(f"pulsar lookup failed for {topic!r}: {lr.message}")
            if lr.proxy_through_service_url and lr.response == LOOKUP_CONNECT:
                # broker sits behind a pulsar-proxy: keep the TCP target on
                # the original service address and tunnel via the proxy
                broker_url = lr.brokerServiceUrl or None
                return await self._get_conn(self.host, self.port,
                                            proxy_to_broker_url=broker_url)
            # a TLS client follows the TLS address; falling back to the
            # plaintext URL's host:port with TLS would hit the wrong listener
            url = (lr.brokerServiceUrlTls
                   if self.tls and lr.has("brokerServiceUrlTls")
                   and lr.brokerServiceUrlTls else lr.brokerServiceUrl)
            if url:
                host, port, tls = parse_service_url(url)
            if lr.response == LOOKUP_CONNECT:
                return await self._get_conn(host, port, tls=tls)
        raise ConnectError(f"pulsar lookup for {topic!r} exceeded redirect limit")

    async def subscribe(self, topic: str, subscription: str, *,
                        sub_type: str = "exclusive",
                        initial_position: str = "latest",
                        receive_queue: int = 1000) -> "PulsarConsumer":
        topic = validate_topic(topic)
        if sub_type not in SUB_TYPES:
            raise ConfigError(
                f"pulsar subscription_type {sub_type!r} not in {sorted(SUB_TYPES)}")
        if not subscription:
            raise ConfigError("pulsar subscription_name must not be empty")
        conn = await self.lookup(topic)
        consumer_id = self._next_id()
        cmd = command(SUBSCRIBE, "subscribe", topic=topic, subscription=subscription,
                      subType=SUB_TYPES[sub_type], consumer_id=consumer_id,
                      request_id=conn.next_request_id(), consumer_name=f"arkflow-{consumer_id}",
                      initialPosition=1 if initial_position == "earliest" else 0)
        cons = PulsarConsumer(conn, consumer_id, receive_queue)
        await conn.request(cmd)
        # register only after SUBSCRIBE succeeds (a failed attempt must not
        # leave a dead consumer entry); delivery starts with the FLOW below
        conn._consumers[consumer_id] = cons
        await cons._grant(receive_queue)
        return cons

    async def create_producer(self, topic: str) -> "PulsarProducer":
        topic = validate_topic(topic)
        conn = await self.lookup(topic)
        producer_id = self._next_id()
        resp = await conn.request(command(PRODUCER, "producer", topic=topic,
                                          producer_id=producer_id,
                                          request_id=conn.next_request_id()))
        prod = PulsarProducer(conn, producer_id, resp.producer_success.producer_name)
        conn._producers[producer_id] = prod
        return prod

    async def close(self) -> None:
        for conn in self._conns.values():
            await conn.close()
        self._conns.clear()


class PulsarConsumer:
    def __init__(self, conn: _Conn, consumer_id: int, receive_queue: int):
        self.conn = conn
        self.consumer_id = consumer_id
        self.receive_queue = receive_queue
        self._queue: asyncio.Queue = asyncio.Queue()
        self._permits_used = 0
        #: (ledgerId, entryId) -> batch indexes not yet acked. The broker acks
        #: whole entries, so a batched entry's ACK is held until every sibling
        #: message is acked (same semantics as the Java client's batch acker).
        self._batch_pending: dict[tuple[int, int], set[int]] = {}

    def _on_message(self, msg_cmd: Message, payload_section: Optional[bytes]) -> None:
        try:
            if payload_section is None:
                raise ReadError("pulsar MESSAGE without payload section")
            _meta, messages = decode_payload_section(payload_section)
            if len(messages) > 1 or (messages and messages[0].batch_index >= 0):
                key = (msg_cmd.message_id.ledgerId, msg_cmd.message_id.entryId)
                self._batch_pending[key] = {m.batch_index for m in messages}
            for m in messages:
                mid = msg_cmd.message_id.copy()
                if m.batch_index >= 0:
                    mid.batch_index = m.batch_index
                m.message_id = mid
                m.redelivery_count = msg_cmd.redelivery_count
                self._queue.put_nowait(m)
        except Exception as e:
            self._queue.put_nowait(e)

    def _on_disconnect(self) -> None:
        self._queue.put_nowait(Disconnection("pulsar connection lost"))

    async def _grant(self, permits: int) -> None:
        await self.conn.send_frame(encode_simple(command(
            FLOW, "flow", consumer_id=self.consumer_id, messagePermits=permits)))

    async def receive(self) -> PulsarMessage:
        """Next message; re-grants flow permits at the half-way mark."""
        item = await self._queue.get()
        if isinstance(item, Exception):
            raise item
        self._permits_used += 1
        if self._permits_used >= max(1, self.receive_queue // 2):
            used, self._permits_used = self._permits_used, 0
            await self._grant(used)
        return item

    async def ack(self, message_id: Message) -> None:
        """Individual ack. For one message of a batched entry, the broker-side
        ACK is deferred until all sibling batch indexes have been acked (the
        broker acks whole entries; acking early would drop unprocessed
        siblings on redelivery)."""
        entry = message_id.copy()
        if message_id.batch_index >= 0:
            key = (message_id.ledgerId, message_id.entryId)
            pending = self._batch_pending.get(key)
            if pending is not None:
                pending.discard(message_id.batch_index)
                if pending:
                    return  # siblings still unacked -> hold the entry ack
                del self._batch_pending[key]
            entry.clear("batch_index")
        await self.conn.send_frame(encode_simple(command(
            ACK, "ack", consumer_id=self.consumer_id, ack_type=0, message_id=[entry])))

    async def close(self) -> None:
        if self.conn._closed:
            return
        try:
            await self.conn.request(command(CLOSE_CONSUMER, "close_consumer",
                                            consumer_id=self.consumer_id,
                                            request_id=self.conn.next_request_id()))
        except Exception:
            pass
        self.conn._consumers.pop(self.consumer_id, None)


class PulsarProducer:
    def __init__(self, conn: _Conn, producer_id: int, producer_name: str):
        self.conn = conn
        self.producer_id = producer_id
        self.producer_name = producer_name
        self.server_closed = False  # set when the broker sends CLOSE_PRODUCER
        self._seq = 0

    async def send(self, payload: bytes, *, key: Optional[str] = None,
                   properties: Optional[dict] = None,
                   event_time_ms: Optional[int] = None) -> Message:
        """Publish one message and await the broker receipt (MessageIdData)."""
        import time

        if self.conn._closed:
            raise Disconnection("pulsar connection lost")
        if self.server_closed:
            raise Disconnection("pulsar producer closed by broker")
        self._seq += 1
        seq = self._seq
        cmd = command(SEND, "send", producer_id=self.producer_id, sequence_id=seq)
        meta = Message("MessageMetadata", producer_name=self.producer_name, sequence_id=seq,
                       publish_time=event_time_ms or int(time.time() * 1000))
        if key is not None:
            meta.partition_key = key
        for k, v in (properties or {}).items():
            meta.add("properties", key=str(k), value=str(v))
        frame = encode_payload_cmd(cmd, meta, payload)
        if len(frame) > self.conn.max_message_size:
            raise WriteError(
                f"pulsar message of {len(frame)}B exceeds broker max "
                f"{self.conn.max_message_size}B")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self.conn._send_waiters[(self.producer_id, seq)] = fut
        await self.conn.send_frame(frame)
        receipt = await asyncio.wait_for(fut, self.conn.timeout)
        return receipt.message_id

    async def close(self) -> None:
        if self.conn._closed:
            return
        try:
            await self.conn.request(command(CLOSE_PRODUCER, "close_producer",
                                            producer_id=self.producer_id,
                                            request_id=self.conn.next_request_id()))
        except Exception:
            pass


def auth_from_config(auth: Optional[dict]) -> tuple[Optional[str], Optional[bytes]]:
    """The reference's PulsarAuth (token | oauth2).

    Token auth resolves to wire bytes immediately. OAuth2 is validated here
    (fail fast at build / --validate) but its token is fetched at CONNECT
    time via :func:`fetch_oauth2_token`: the returned data is ``None`` and
    the caller exchanges client credentials when it actually dials.
    """
    if not auth:
        return None, None
    kind = str(auth.get("type", "")).lower()
    if kind == "token":
        token = auth.get("token")
        if not token:
            raise ConfigError("pulsar token auth requires 'token'")
        from arkflow_tpu_torch.utils.auth import resolve_secret

        return "token", resolve_secret(str(token)).encode()
    if kind == "oauth2":
        for req in ("issuer_url", "credentials_url", "audience"):
            if not auth.get(req):
                raise ConfigError(f"pulsar oauth2 auth requires {req!r}")
        cred_url = str(auth["credentials_url"])
        # file:// (local key file), data: (inline JSON), and http(s)://
        # (remote key file) are all valid key-file sources
        if not cred_url.startswith(("file://", "data:", "http://", "https://")):
            raise ConfigError(
                "pulsar oauth2 credentials_url must be a file://, data:, or "
                "http(s):// URL to a key-file JSON (client_id/client_secret)")
        for url_key in ("issuer_url", "credentials_url"):
            u = str(auth[url_key])
            if u.startswith("http://"):
                # the client secret (key file GET / client_credentials POST)
                # would transit in the clear: allowed (test rigs), but
                # never silently
                logger.warning(
                    "pulsar oauth2 %s %r uses plain http: client credentials "
                    "will transit unencrypted; use https in production",
                    url_key, u)
        return "oauth2", None
    raise ConfigError(f"pulsar auth type {kind!r} not supported (token/oauth2)")


async def fetch_oauth2_token(auth: dict, timeout: float = 10.0) -> bytes:
    """OAuth2 client-credentials exchange -> bearer token bytes for CONNECT.

    Read the key-file JSON named by ``credentials_url`` (file://, data: or
    http(s)://), discover the token endpoint from the issuer's
    ``/.well-known/openid-configuration`` (falling back to
    ``{issuer_url}/oauth/token``), then POST a client_credentials grant
    with the configured audience/scope. On the wire the fetched token is
    sent with auth method name "token" (bearer), as real Pulsar clients do.
    """
    import json as _json
    from urllib.parse import unquote, urlencode

    from arkflow_tpu_torch.utils.http1 import HttpClient, HttpClientError

    cred_url = str(auth["credentials_url"])
    client = HttpClient(timeout_s=timeout)
    try:
        if cred_url.startswith("data:"):
            # data:[application/json][;base64],<payload>: an inline key file
            import base64

            header, _, body = cred_url.partition(",")
            raw = base64.b64decode(body) if header.endswith(";base64") else unquote(body).encode()
            creds = _json.loads(raw)
        elif cred_url.startswith(("http://", "https://")):
            resp = await client.request("GET", cred_url)
            if resp.status != 200:
                raise ConnectionError(
                    f"pulsar oauth2 credentials_url returned {resp.status}")
            creds = _json.loads(resp.body)
        else:
            path = unquote(urlparse(cred_url).path)  # handles file://localhost/... (RFC 8089)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    creds = _json.load(f)
            except FileNotFoundError as e:
                # ConfigError: permanent, fails fast through retry_with_backoff
                raise ConfigError(f"pulsar oauth2 key file not found: {path}") from e
            except ValueError as e:
                raise ConfigError(f"pulsar oauth2 key file is not valid JSON: {e}") from e
        for req in ("client_id", "client_secret"):
            if req not in creds:
                raise ConfigError(f"pulsar oauth2 key file missing {req!r}")
        issuer = str(auth["issuer_url"]).rstrip("/")
        token_endpoint = f"{issuer}/oauth/token"
        try:
            resp = await client.request("GET", f"{issuer}/.well-known/openid-configuration")
            if resp.status == 200:
                token_endpoint = _json.loads(resp.body).get("token_endpoint", token_endpoint)
        except (HttpClientError, ValueError, AttributeError):
            # discovery is best-effort: a hung endpoint, a non-JSON body or a
            # connection error all fall back to {issuer}/oauth/token
            pass
        form = {
            "grant_type": "client_credentials",
            "client_id": str(creds["client_id"]),
            "client_secret": str(creds["client_secret"]),
            "audience": str(auth["audience"]),
        }
        if auth.get("scope"):
            form["scope"] = str(auth["scope"])
        resp = await client.request(
            "POST", token_endpoint, body=urlencode(form).encode(),
            headers={"Content-Type": "application/x-www-form-urlencoded"})
        if resp.status != 200:
            raise ConnectionError(
                f"pulsar oauth2 token endpoint returned {resp.status}: {resp.text()[:200]}")
        payload = _json.loads(resp.body)
    finally:
        await client.close()
    token = payload.get("access_token")
    if not token:
        raise ConnectionError("pulsar oauth2 response has no access_token")
    return str(token).encode()
