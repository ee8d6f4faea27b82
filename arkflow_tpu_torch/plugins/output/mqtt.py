"""MQTT output: publish each encoded payload with QoS and retain.

Counterpart of ``arkflow_tpu/plugins/output/mqtt.py``: one PUBLISH per
payload of ``encode_batch(batch.strip_metadata())``; QoS 1 awaits its
PUBACK and QoS 2 its PUBCOMP before the next. A failure raises
``WriteError("mqtt publish failed: ...")``. The client is injectable, as
JAX's is, for tests.

Config:

    type: mqtt
    host: 127.0.0.1
    port: 1883
    topic: results/out          # literal or {value: ...}
    qos: 1
    retain: false
    client_id: arkflow-tpu-out
    username: u                 # optional
    password: "${MQTT_PW}"      # optional
    codec: json

An ``{expr: ...}`` topic is evaluated on the batch, its first row.
"""

from __future__ import annotations

from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Output, Resource, register_output
from arkflow_tpu_torch.connect.mqtt_client import MqttClient
from arkflow_tpu_torch.errors import ConfigError, WriteError
from arkflow_tpu_torch.plugins.codec.helper import build_codec, check_codec, encode_batch
from arkflow_tpu_torch.utils.auth import resolve_secret
from arkflow_tpu_torch.utils.expr import DynValue, check_dyn_value


class MqttOutput(Output):
    def __init__(self, host: str, port: int, topic: DynValue, qos: int = 0,
                 retain: bool = False, client_id: str = "arkflow-tpu-out",
                 username: Optional[str] = None, password: Optional[str] = None,
                 codec=None, client: Optional[MqttClient] = None):
        self.host = host
        self.port = port
        self.topic = topic
        self.qos = qos
        self.retain = retain
        self.client_id = client_id
        self.username = username
        self.password = password
        self.codec = codec
        self._client = client  # injectable for tests

    async def connect(self) -> None:
        if self._client is None:
            self._client = MqttClient(
                self.host, self.port, client_id=self.client_id,
                username=self.username, password=self.password,
            )
        await self._client.connect()

    async def write(self, batch: MessageBatch) -> None:
        if self._client is None:
            raise WriteError("mqtt output not connected")
        topic = str(self.topic.eval_scalar(batch))
        try:
            for p in encode_batch(batch.strip_metadata(), self.codec):
                await self._client.publish(topic, p, qos=self.qos, retain=self.retain)
        except Exception as e:
            raise WriteError(f"mqtt publish failed: {e}") from e

    async def close(self) -> None:
        if self._client is not None:
            await self._client.close()


def _address(config: dict) -> tuple[str, int]:
    host = str(config.get("host", "127.0.0.1")).replace("mqtt://", "").replace("tcp://", "")
    port = int(config.get("port", 1883))
    if ":" in host:
        host, _, p = host.partition(":")
        port = int(p)
    return host, port


def _check(config: dict) -> None:
    """JAX's builder's refusals, in its order."""
    topic = config.get("topic")
    if not topic:
        raise ConfigError("mqtt output requires 'topic'")
    _address(config)
    qos = int(config.get("qos", 0))
    if qos not in (0, 1, 2):
        raise ConfigError(f"mqtt qos must be 0/1/2, got {qos}")
    check_dyn_value(topic, "topic")
    check_codec(config)


@register_output("mqtt", keys=("host", "port", "topic", "qos", "retain", "client_id",
                               "username", "password", "codec"), check=_check)
def _build(config: dict, resource: Resource) -> MqttOutput:
    host, port = _address(config)
    pw = config.get("password")
    return MqttOutput(
        host=host,
        port=port,
        topic=DynValue.from_config(config["topic"], "topic"),
        qos=int(config.get("qos", 0)),
        retain=bool(config.get("retain", False)),
        client_id=str(config.get("client_id", "arkflow-tpu-out")),
        username=config.get("username"),
        password=resolve_secret(str(pw)) if pw else None,
        codec=build_codec(config.get("codec"), resource),
    )
