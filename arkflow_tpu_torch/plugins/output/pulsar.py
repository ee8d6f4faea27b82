"""Pulsar output: produce with broker receipts and dynamic topic.

Counterpart of ``arkflow_tpu/plugins/output/pulsar.py``: a literal or
``{expr: ...}`` topic (evaluated per row on the port's SQL engine), one
producer a topic, token or OAuth2 auth, retry with backoff on producer
creation, one SEND a payload. Every send awaits its SEND_RECEIPT, so a
successful ``write`` means the broker has persisted the batch.

Config:

    type: pulsar
    service_url: pulsar://localhost:6650
    topic: results                 # literal or {expr: "concat('out-', city)"}
    auth: {type: token, token: "${PULSAR_TOKEN}"}
    retry: {max_attempts: 3}       # or retry_config
    codec: json
"""

from __future__ import annotations

from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Output, Resource, register_output
from arkflow_tpu_torch.connect.pulsar_client import (
    PulsarClient,
    PulsarProducer,
    auth_from_config,
    fetch_oauth2_token,
    parse_service_url,
    validate_topic,
)
from arkflow_tpu_torch.errors import ConfigError, WriteError
from arkflow_tpu_torch.plugins.codec.helper import build_codec, check_codec, encode_batch
from arkflow_tpu_torch.utils.expr import DynValue
from arkflow_tpu_torch.utils.retry import RetryConfig, retry_with_backoff


class PulsarOutput(Output):
    def __init__(self, service_url: str, topic: DynValue,
                 auth: Optional[dict] = None, retry: Optional[dict] = None,
                 codec=None):
        parse_service_url(service_url)  # fail fast at build (--validate)
        self.service_url = service_url
        if not topic.is_expr:
            validate_topic(str(topic.eval_scalar(None)))
        self.topic = topic
        self.auth_method, self.auth_data = auth_from_config(auth)
        self._auth_cfg = auth
        self.retry = RetryConfig.from_config(retry)
        self.codec = codec
        self._client: Optional[PulsarClient] = None
        self._producers: dict[str, PulsarProducer] = {}

    async def connect(self) -> None:
        if self._client is not None:  # reconnect: drop the old sockets/tasks
            await self._client.close()
            self._client = None  # a failed re-dial must not leave a closed
            self._producers.clear()  # client passing the write() guard
        auth_method, auth_data = self.auth_method, self.auth_data
        if auth_method == "oauth2":
            # fresh client-credentials exchange per dial (tokens expire);
            # retried with the same backoff the broker steps get, so a
            # transient token-endpoint 5xx behaves like a broker blip
            auth_data = await retry_with_backoff(
                lambda: fetch_oauth2_token(self._auth_cfg), self.retry,
                what="pulsar oauth2 token")
            auth_method = "token"
        self._client = PulsarClient(
            self.service_url, auth_method=auth_method, auth_data=auth_data,
            # broker AUTH_CHALLENGEs (bearer expiry) re-run the token
            # exchange in place instead of dropping the connection
            auth_refresh=(lambda: fetch_oauth2_token(self._auth_cfg))
            if self.auth_method == "oauth2" else None,
        )
        try:
            if not self.topic.is_expr:
                # eagerly register the static producer so config errors fail fast
                await self._producer_for(str(self.topic.eval_scalar(None)))
        except Exception:
            await self._client.close()
            self._client = None
            self._producers.clear()
            raise

    async def _producer_for(self, topic: str) -> PulsarProducer:
        topic = validate_topic(topic)
        prod = self._producers.get(topic)
        if prod is None or prod.conn._closed or prod.server_closed:
            async def create():
                return await self._client.create_producer(topic)

            prod = await retry_with_backoff(
                create, self.retry, what=f"pulsar producer {topic}")
            self._producers[topic] = prod
        return prod

    async def write(self, batch: MessageBatch) -> None:
        if self._client is None:
            raise WriteError("pulsar output not connected")
        payloads = encode_batch(batch.strip_metadata(), self.codec)
        topics = [str(t) for t in self.topic.eval_per_row(batch)]
        if len(topics) != len(payloads):
            # a whole-batch codec: every payload takes the first row's topic
            topics = [topics[0] if topics else str(self.topic.eval_scalar(batch))] * len(payloads)
        try:
            for topic, payload in zip(topics, payloads):
                prod = await self._producer_for(topic)
                await prod.send(payload)
        except WriteError:
            raise
        except Exception as e:
            raise WriteError(f"pulsar send failed: {e}") from e

    async def close(self) -> None:
        for prod in self._producers.values():
            try:
                await prod.close()
            except Exception:
                pass
        if self._client is not None:
            await self._client.close()


def _check(config: dict) -> None:
    for req in ("service_url", "topic"):
        if not config.get(req):
            raise ConfigError(f"pulsar output requires {req!r}")
    parse_service_url(str(config["service_url"]))
    topic = DynValue.from_config(config["topic"], "topic")
    if not topic.is_expr:
        validate_topic(str(topic.eval_scalar(None)))
    auth_from_config(config.get("auth"))
    RetryConfig.from_config(config.get("retry") or config.get("retry_config"))
    check_codec(config)


@register_output("pulsar", keys=("service_url", "topic", "auth", "retry", "retry_config",
                                 "codec"), check=_check)
def _build(config: dict, resource: Resource) -> PulsarOutput:
    return PulsarOutput(
        service_url=str(config["service_url"]),
        topic=DynValue.from_config(config["topic"], "topic"),
        auth=config.get("auth"),
        retry=config.get("retry") or config.get("retry_config"),
        codec=build_codec(config.get("codec"), resource),
    )
