"""Pulsar input: subscribe and consume with per-message broker acks.

Counterpart of ``arkflow_tpu/plugins/input/pulsar.py``: subscription types
exclusive/shared/failover/key_shared, token or OAuth2 auth, retry with
backoff on connect, at-least-once delivery -- each message's ack fires an
individual broker ACK, so unacked messages redeliver after a crash.
Connection loss surfaces ``Disconnection`` and the stream runtime's
reconnect loop re-subscribes. Each read is one message, decoded through
``codec`` (raw ``__value__`` without one), carrying ``__meta_source``
``pulsar``, the ingest stamp, ``__meta_ext_topic`` and the message's
partition key as ``__meta_key``.

Config:

    type: pulsar
    service_url: pulsar://localhost:6650
    topic: events                  # or persistent://tenant/ns/topic
    subscription_name: arkflow
    subscription_type: shared      # exclusive|shared|failover|key_shared
    initial_position: latest       # latest|earliest
    auth: {type: token, token: "${PULSAR_TOKEN}"}
    retry: {max_attempts: 3, initial_delay_ms: 100}   # or retry_config
    codec: json
"""

from __future__ import annotations

from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Ack, Input, Resource, register_input
from arkflow_tpu_torch.connect.pulsar_client import (
    PulsarClient,
    PulsarConsumer,
    auth_from_config,
    fetch_oauth2_token,
    parse_service_url,
    validate_topic,
)
from arkflow_tpu_torch.errors import ConfigError, EndOfInput
from arkflow_tpu_torch.plugins.codec.helper import build_codec, check_codec, decode_payloads
from arkflow_tpu_torch.utils.retry import RetryConfig, retry_with_backoff


class PulsarAck(Ack):
    """Acks one message id on its consumer (individual ack)."""

    def __init__(self, consumer: PulsarConsumer, message_id):
        self._consumer = consumer
        self._message_id = message_id

    async def ack(self) -> None:
        try:
            await self._consumer.ack(self._message_id)
        except Exception:
            # connection already gone: the broker will redeliver (at-least-once)
            pass


class PulsarInput(Input):
    def __init__(self, service_url: str, topic: str, subscription_name: str,
                 subscription_type: str = "exclusive",
                 initial_position: str = "latest",
                 auth: Optional[dict] = None, retry: Optional[dict] = None,
                 codec=None):
        parse_service_url(service_url)  # fail fast at build (--validate)
        self.service_url = service_url
        self.topic = validate_topic(topic)
        self.subscription_name = subscription_name
        self.subscription_type = subscription_type
        self.initial_position = initial_position
        self.auth_method, self.auth_data = auth_from_config(auth)
        self._auth_cfg = auth
        self.retry = RetryConfig.from_config(retry)
        self.codec = codec
        self._client: Optional[PulsarClient] = None
        self._consumer: Optional[PulsarConsumer] = None
        self._closed = False

    async def connect(self) -> None:
        if self._client is not None:  # reconnect: drop the old sockets/tasks
            await self._client.close()
            self._client = None

        async def dial():
            # the WHOLE dial retries together: a transient token-endpoint
            # failure backs off like a broker blip, and each retry fetches
            # a fresh bearer (tokens expire; it rides as "token" on wire)
            auth_method, auth_data = self.auth_method, self.auth_data
            if auth_method == "oauth2":
                auth_data = await fetch_oauth2_token(self._auth_cfg)
                auth_method = "token"
            client = PulsarClient(
                self.service_url, auth_method=auth_method, auth_data=auth_data,
                # broker AUTH_CHALLENGEs (bearer expiry) re-run the token
                # exchange in place instead of dropping the connection
                auth_refresh=(lambda: fetch_oauth2_token(self._auth_cfg))
                if self.auth_method == "oauth2" else None,
            )
            try:
                consumer = await client.subscribe(
                    self.topic, self.subscription_name,
                    sub_type=self.subscription_type,
                    initial_position=self.initial_position,
                )
            except Exception:
                await client.close()  # don't leak the connection on failure
                raise
            return client, consumer

        self._client, self._consumer = await retry_with_backoff(
            dial, self.retry, what=f"pulsar subscribe {self.topic}")

    async def read(self) -> tuple[MessageBatch, Ack]:
        if self._closed or self._consumer is None:
            raise EndOfInput()
        msg = await self._consumer.receive()  # raises Disconnection on loss
        batch = decode_payloads([msg.payload], self.codec)
        batch = (
            batch.with_source("pulsar")
            .with_ingest_time()
            .with_ext_metadata({"topic": self.topic})
        )
        if msg.partition_key:
            batch = batch.with_key(msg.partition_key.encode())
        return batch, PulsarAck(self._consumer, msg.message_id)

    async def close(self) -> None:
        self._closed = True
        if self._consumer is not None:
            await self._consumer.close()
        if self._client is not None:
            await self._client.close()


def _check(config: dict) -> None:
    for req in ("service_url", "topic", "subscription_name"):
        if not config.get(req):
            raise ConfigError(f"pulsar input requires {req!r}")
    sub_type = str(config.get("subscription_type", "exclusive"))
    if sub_type not in ("exclusive", "shared", "failover", "key_shared"):
        raise ConfigError(f"pulsar subscription_type {sub_type!r} invalid")
    pos = str(config.get("initial_position", "latest"))
    if pos not in ("latest", "earliest"):
        raise ConfigError(f"pulsar initial_position {pos!r} invalid")
    parse_service_url(str(config["service_url"]))
    validate_topic(str(config["topic"]))
    auth_from_config(config.get("auth"))
    RetryConfig.from_config(config.get("retry") or config.get("retry_config"))
    check_codec(config)


@register_input("pulsar", keys=("service_url", "topic", "subscription_name",
                                "subscription_type", "initial_position", "auth", "retry",
                                "retry_config", "codec"), check=_check)
def _build(config: dict, resource: Resource) -> PulsarInput:
    return PulsarInput(
        service_url=str(config["service_url"]),
        topic=str(config["topic"]),
        subscription_name=str(config["subscription_name"]),
        subscription_type=str(config.get("subscription_type", "exclusive")),
        initial_position=str(config.get("initial_position", "latest")),
        auth=config.get("auth"),
        retry=config.get("retry") or config.get("retry_config"),
        codec=build_codec(config.get("codec"), resource),
    )
