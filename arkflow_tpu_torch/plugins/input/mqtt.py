"""MQTT input: subscribe to topics, QoS 0/1/2.

Counterpart of ``arkflow_tpu/plugins/input/mqtt.py``: the client's
dispatch loop puts each message into a bounded queue (1000; a message
arriving at a full queue is dropped, as the JAX input drops it), and a read
returns one message as a batch stamped ``__meta_source: mqtt``,
``__meta_ext_topic`` and ``__meta_ingest_time``. A lost connection raises
``Disconnection`` for the stream's reconnect loop. QoS 1 messages are
PUBACKed by the client on receipt.

Config:

    type: mqtt
    host: 127.0.0.1
    port: 1883
    topics: ["sensors/#"]
    qos: 1
    client_id: arkflow-1
    username: u            # optional
    password: "${MQTT_PW}" # optional
    codec: json
"""

from __future__ import annotations

import asyncio
from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Ack, Input, NoopAck, Resource, register_input
from arkflow_tpu_torch.connect.mqtt_client import MqttClient, MqttMessage
from arkflow_tpu_torch.errors import ConfigError, Disconnection, EndOfInput
from arkflow_tpu_torch.plugins.codec.helper import build_codec, check_codec, decode_payloads
from arkflow_tpu_torch.utils.auth import resolve_secret


class MqttInput(Input):
    def __init__(self, host: str, port: int, topics: list[str], qos: int,
                 client_id: str, username: Optional[str], password: Optional[str],
                 codec=None):
        if not topics:
            raise ConfigError("mqtt input requires 'topics'")
        self.host = host
        self.port = port
        self.topics = topics
        self.qos = qos
        self.client_id = client_id
        self.username = username
        self.password = password
        self.codec = codec
        self._client: Optional[MqttClient] = None
        self._queue: Optional[asyncio.Queue] = None
        self._closed = False

    async def connect(self) -> None:
        self._client = MqttClient(
            self.host, self.port, client_id=self.client_id,
            username=self.username, password=self.password,
        )
        self._queue = asyncio.Queue(maxsize=1000)

        def on_msg(msg: MqttMessage) -> None:
            try:
                self._queue.put_nowait(msg)
            except asyncio.QueueFull:
                pass

        self._client.on_message(on_msg)
        await self._client.connect()
        for t in self.topics:
            await self._client.subscribe(t, self.qos)

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
                    raise Disconnection("mqtt connection lost") from None
        batch = decode_payloads([msg.payload], self.codec)
        return (
            batch.with_source("mqtt").with_ext_metadata({"topic": msg.topic}).with_ingest_time(),
            NoopAck(),
        )

    async def close(self) -> None:
        self._closed = True
        if self._client is not None:
            await self._client.close()


def _address(config: dict) -> tuple[str, int]:
    host = config.get("host") or config.get("url")
    if not host:
        raise ConfigError("mqtt input requires 'host'")
    host = str(host).replace("mqtt://", "").replace("tcp://", "")
    port = int(config.get("port", 1883))
    if ":" in host:
        host, _, p = host.partition(":")
        port = int(p)
    return host, port


def _topics(config: dict) -> list:
    return list(config.get("topics") or ([config["topic"]] if config.get("topic") else []))


def _check(config: dict) -> None:
    _address(config)
    qos = int(config.get("qos", 0))
    if qos not in (0, 1, 2):
        raise ConfigError(f"mqtt qos must be 0/1/2, got {qos}")
    if not _topics(config):
        raise ConfigError("mqtt input requires 'topics'")
    check_codec(config)


@register_input("mqtt", keys=("host", "url", "port", "topics", "topic", "qos", "client_id",
                              "username", "password", "codec"), check=_check)
def _build(config: dict, resource: Resource) -> MqttInput:
    host, port = _address(config)
    pw = config.get("password")
    return MqttInput(
        host=host,
        port=port,
        topics=_topics(config),
        qos=int(config.get("qos", 0)),
        client_id=str(config.get("client_id", "arkflow-tpu-in")),
        username=config.get("username"),
        password=resolve_secret(str(pw)) if pw else None,
        codec=build_codec(config.get("codec"), resource),
    )
