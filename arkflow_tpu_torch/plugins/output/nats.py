"""NATS output: core publish (or JetStream publish with a PubAck) to a
subject.

Counterpart of ``arkflow_tpu/plugins/output/nats.py``.

Config:

    type: nats
    url: nats://127.0.0.1:4222
    subject: results            # literal, {value: ...} or {expr: ...} (per row)
    jetstream: false            # true: await the server's PubAck per message
    codec: json

An ``{expr: ...}`` subject is evaluated on each batch, one subject a row.
"""

from __future__ import annotations

from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Output, Resource, register_output
from arkflow_tpu_torch.connect.nats_client import NatsClient, client_kwargs_from_config
from arkflow_tpu_torch.errors import ConfigError, WriteError
from arkflow_tpu_torch.plugins.codec.helper import build_codec, check_codec, encode_batch
from arkflow_tpu_torch.utils.expr import DynValue, check_dyn_value


class NatsOutput(Output):
    def __init__(self, url: str, subject: DynValue, codec=None,
                 client_kwargs: Optional[dict] = None, jetstream: bool = False):
        self.url = url
        self.subject = subject
        self.codec = codec
        self.client_kwargs = client_kwargs or {}
        #: JetStream publish: await the server PubAck per message (persisted
        #: before write() returns) instead of fire-and-forget core publish
        self.jetstream = jetstream
        self._client: Optional[NatsClient] = None

    async def connect(self) -> None:
        self._client = NatsClient(self.url, **self.client_kwargs)
        await self._client.connect()

    async def _publish(self, subject: str, payload: bytes) -> None:
        if not self.jetstream:
            await self._client.publish(subject, payload)
            return
        import json

        resp = await self._client.request(subject, payload)
        ack = json.loads(resp.payload.decode() or "{}")
        if "error" in ack:
            raise WriteError(f"jetstream publish rejected: {ack['error']}")

    async def write(self, batch: MessageBatch) -> None:
        if self._client is None:
            raise WriteError("nats output not connected")
        subjects = self.subject.eval_per_row(batch)
        payloads = encode_batch(batch.strip_metadata(), self.codec)
        if len(subjects) != len(payloads):
            # a whole-batch codec: every payload takes the first row's subject
            subjects = [subjects[0] if subjects else self.subject.eval_scalar(batch)] * len(payloads)
        try:
            for subj, p in zip(subjects, payloads):
                await self._publish(str(subj), p)
        except Exception as e:
            raise WriteError(f"nats publish failed: {e}") from e

    async def close(self) -> None:
        if self._client is not None:
            await self._client.close()


def _check(config: dict) -> None:
    subject = config.get("subject")
    if not subject:
        raise ConfigError("nats output requires 'subject'")
    check_dyn_value(subject, "subject")
    client_kwargs_from_config(config)
    check_codec(config)


@register_output("nats", keys=("url", "subject", "codec", "username", "password", "token",
                               "tls", "jetstream"), check=_check)
def _build(config: dict, resource: Resource) -> NatsOutput:
    return NatsOutput(
        url=str(config.get("url", "nats://127.0.0.1:4222")),
        subject=DynValue.from_config(config["subject"], "subject"),
        codec=build_codec(config.get("codec"), resource),
        client_kwargs=client_kwargs_from_config(config),
        jetstream=bool(config.get("jetstream")),
    )
