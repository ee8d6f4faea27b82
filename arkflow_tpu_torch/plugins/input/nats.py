"""NATS input: core subject subscription (+ queue group) or JetStream pull.

Counterpart of ``arkflow_tpu/plugins/input/nats.py``. Core mode subscribes
a subject (at most once): the client's dispatch loop puts each message
into a bounded queue (1000; a message arriving at a full queue is dropped,
as the JAX input drops it) and a read returns one message stamped
``__meta_source: nats`` and ``__meta_ext_subject``. JetStream mode pulls
batches from a durable consumer and acks every message of a batch
explicitly once the batch was written downstream (at least once). An
unacked batch (a nack, or a crash) stays pending on the consumer, which
delivers it again: on the next pull, or after the server's ack wait. A lost
connection raises ``Disconnection`` in both modes.

Config:

    type: nats
    url: nats://127.0.0.1:4222
    subject: events.>
    queue_group: workers     # optional (core mode)
    codec: json
    # -- JetStream pull mode --
    # mode: jetstream        # (or jetstream: true)
    # stream: EVENTS
    # durable: arkflow       # durable consumer name (created if missing)
    # deliver_policy: all    # all | last | new
    # batch_size: 64
"""

from __future__ import annotations

import asyncio
from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Ack, Input, NoopAck, Resource, register_input
from arkflow_tpu_torch.connect.nats_client import (JetStream, NatsClient, NatsMessage,
                                                   client_kwargs_from_config)
from arkflow_tpu_torch.errors import ConfigError, Disconnection, EndOfInput
from arkflow_tpu_torch.plugins.codec.helper import build_codec, check_codec, decode_payloads

#: messages a core subscription holds between reads before it drops
QUEUE_BOUND = 1000


class NatsInput(Input):
    def __init__(self, url: str, subject: str, queue_group: Optional[str] = None, codec=None,
                 client_kwargs: Optional[dict] = None):
        self.url = url
        self.subject = subject
        self.queue_group = queue_group
        self.codec = codec
        self.client_kwargs = client_kwargs or {}
        self._client: Optional[NatsClient] = None
        self._queue: Optional[asyncio.Queue] = None
        self._closed = False

    async def connect(self) -> None:
        self._client = NatsClient(self.url, **self.client_kwargs)
        await self._client.connect()
        self._queue = asyncio.Queue(maxsize=QUEUE_BOUND)

        def on_msg(msg: NatsMessage) -> None:
            try:
                self._queue.put_nowait(msg)
            except asyncio.QueueFull:
                pass

        await self._client.subscribe(self.subject, on_msg, self.queue_group)

    async def read(self) -> tuple[MessageBatch, Ack]:
        if self._closed:
            raise EndOfInput()
        while True:
            try:
                msg = await asyncio.wait_for(self._queue.get(), timeout=1.0)
                break
            except asyncio.TimeoutError:
                if self._closed:
                    raise EndOfInput() from None
                if self._client is not None and not self._client.connected:
                    raise Disconnection("nats connection lost") from None
        batch = decode_payloads([msg.payload], self.codec)
        return (
            batch.with_source("nats").with_ext_metadata({"subject": msg.subject})
            .with_ingest_time(),
            NoopAck(),
        )

    async def close(self) -> None:
        self._closed = True
        if self._client is not None:
            await self._client.close()


class JetStreamAck(Ack):
    """Explicit +ACK of every message of a fetched batch, fired only after
    the batch was written downstream. ``nack`` is the base no-op, as in the
    JAX package: the batch stays pending on the consumer, which delivers it
    again."""

    def __init__(self, js: JetStream, messages: list[NatsMessage]):
        self._js = js
        self._messages = messages

    async def ack(self) -> None:
        for m in self._messages:
            try:
                await self._js.ack(m)
            except Exception:
                # connection gone: the consumer's ack wait redelivers
                return


class NatsJetStreamInput(Input):
    """Durable pull consumer: fetch batches, ack after the downstream write."""

    #: pull consumer: the backlog stays in the JetStream stream (core NATS
    #: has none, so ``NatsInput`` does not pause)
    pause_on_overload = True

    def __init__(self, url: str, stream: str, durable: str, batch_size: int,
                 deliver_policy: str = "all", filter_subject: Optional[str] = None,
                 codec=None, client_kwargs: Optional[dict] = None):
        self.url = url
        self.stream = stream
        self.durable = durable
        self.batch_size = batch_size
        self.deliver_policy = deliver_policy
        self.filter_subject = filter_subject
        self.codec = codec
        self.client_kwargs = client_kwargs or {}
        self._client: Optional[NatsClient] = None
        self._js: Optional[JetStream] = None
        self._closed = False

    async def connect(self) -> None:
        if self._client is not None:
            await self._client.close()
        self._client = NatsClient(self.url, **self.client_kwargs)
        await self._client.connect()
        self._js = JetStream(self._client)
        await self._js.ensure_pull_consumer(self.stream, self.durable, self.deliver_policy,
                                            filter_subject=self.filter_subject)

    async def read(self) -> tuple[MessageBatch, Ack]:
        if self._closed:
            raise EndOfInput()
        while True:
            if self._client is None or not self._client.connected:
                raise Disconnection("nats connection lost")
            msgs = await self._js.fetch(self.stream, self.durable,
                                        batch=self.batch_size, expires_s=0.5)
            if self._closed:
                raise EndOfInput()
            if msgs:
                break
        batch = decode_payloads([m.payload for m in msgs], self.codec)
        batch = (batch.with_source("nats")
                 .with_ext_metadata({"stream": self.stream, "durable": self.durable})
                 .with_ingest_time())
        return batch, JetStreamAck(self._js, msgs)

    async def close(self) -> None:
        self._closed = True
        if self._client is not None:
            await self._client.close()


def _jetstream(config: dict) -> bool:
    return bool(config.get("jetstream")) or config.get("mode") == "jetstream"


def _check(config: dict) -> None:
    """JAX's builder's refusals, in its order, without connecting."""
    if _jetstream(config):
        if not config.get("stream") or not config.get("durable"):
            raise ConfigError("nats jetstream input requires 'stream' and 'durable'")
        policy = str(config.get("deliver_policy", "all"))
        if policy not in ("all", "last", "new"):
            raise ConfigError(f"nats deliver_policy {policy!r} invalid (all/last/new)")
        int(config.get("batch_size", 64))
    elif not config.get("subject"):
        raise ConfigError("nats input requires 'subject'")
    check_codec(config)
    client_kwargs_from_config(config)


@register_input("nats", keys=("url", "subject", "queue_group", "codec", "mode", "jetstream",
                              "stream", "durable", "deliver_policy", "batch_size",
                              "username", "password", "token", "tls"), check=_check)
def _build(config: dict, resource: Resource) -> Input:
    url = str(config.get("url", "nats://127.0.0.1:4222"))
    if _jetstream(config):
        subject = config.get("subject")  # the consumer's filter_subject
        return NatsJetStreamInput(
            url=url, stream=str(config["stream"]), durable=str(config["durable"]),
            batch_size=int(config.get("batch_size", 64)),
            deliver_policy=str(config.get("deliver_policy", "all")),
            filter_subject=str(subject) if subject else None,
            codec=build_codec(config.get("codec"), resource),
            client_kwargs=client_kwargs_from_config(config),
        )
    return NatsInput(
        url=url,
        subject=str(config["subject"]),
        queue_group=config.get("queue_group"),
        codec=build_codec(config.get("codec"), resource),
        client_kwargs=client_kwargs_from_config(config),
    )
