"""Kafka output: produce with topic/key and partition routing.

Counterpart of ``arkflow_tpu/plugins/output/kafka.py``: records route to
partitions by key hash (``murmur2``, the Java client's, by default;
``crc32c`` as an opt-in legacy mode) or round-robin without keys, grouped
into one produce per (topic, partition), each retried with backoff.

Config:

    type: kafka
    brokers: "localhost:9092"
    topic: results              # literal, {value: ...} or {expr: ...} (per row)
    key: {expr: "json_get_str(__value__, 'label')"}  # optional; per row
    acks: -1                    # -1 all | 1 leader
    retries: 3
    compression: gzip           # none | gzip | snappy | lz4 | zstd
    partitioner: murmur2        # murmur2 | crc32c
    codec: json

An ``{expr: ...}`` topic or key is a SQL expression evaluated on each
batch (``utils/expr.py``), one value a row.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Output, Resource, register_output
from arkflow_tpu_torch.connect.kafka_client import (
    KafkaClient,
    client_kwargs_from_config,
    partition_for_key,
)
from arkflow_tpu_torch.errors import ConfigError, WriteError
from arkflow_tpu_torch.native import crc32c
from arkflow_tpu_torch.plugins.codec.helper import build_codec, check_codec, encode_batch
from arkflow_tpu_torch.utils.expr import DynValue, check_dyn_value

logger = logging.getLogger("arkflow_torch.kafka")


class KafkaOutput(Output):
    def __init__(self, brokers: str, topic: DynValue, key: Optional[DynValue],
                 acks: int, retries: int, codec=None,
                 client_kwargs: Optional[dict] = None,
                 compression: Optional[str] = None,
                 partitioner: str = "murmur2"):
        self.brokers = brokers
        self.topic = topic
        self.key = key
        self.acks = acks
        self.retries = retries
        self.codec = codec
        self.client_kwargs = client_kwargs or {}
        self.compression = compression
        self.partitioner = partitioner
        self._client: Optional[KafkaClient] = None
        self._rr = 0

    async def connect(self) -> None:
        self._client = KafkaClient(self.brokers, **self.client_kwargs)
        await self._client.connect()

    def _partition_for(self, topic: str, key: Optional[bytes]) -> int:
        parts = self._client.partitions(topic)
        if not parts:
            return 0
        if key is not None:  # empty keys still hash (Java semantics), only absent keys round-robin
            # murmur2 (default) matches the Java client / librdkafka default,
            # so keyed records co-partition with other producers on shared
            # topics; crc32c is kept as an opt-in legacy mode
            if self.partitioner == "murmur2":
                return parts[partition_for_key(key, len(parts))]
            return parts[crc32c(key) % len(parts)]
        self._rr += 1
        return parts[self._rr % len(parts)]

    async def write(self, batch: MessageBatch) -> None:
        if self._client is None:
            raise WriteError("kafka output not connected")
        data = batch.strip_metadata()
        payloads = encode_batch(data, self.codec)
        topics = [str(t) for t in self.topic.eval_per_row(batch)]
        keys: list[Optional[bytes]]
        if self.key is not None:
            raw_keys = self.key.eval_per_row(batch)
            keys = [None if k is None else str(k).encode() for k in raw_keys]
        else:
            keys = [None] * len(payloads)
        if len(topics) != len(payloads):
            # a whole-batch codec: every payload takes the first row's topic
            topics = [topics[0] if topics else str(self.topic.eval_scalar(batch))] * len(payloads)
        if len(keys) != len(payloads):
            keys = [keys[0] if keys else None] * len(payloads)

        # group records by (topic, partition) to produce in few requests
        grouped: dict[tuple[str, int], list] = {}
        for topic, key, value in zip(topics, keys, payloads):
            if not self._client.partitions(topic):
                await self._client.refresh_metadata([topic])
            part = self._partition_for(topic, key)
            grouped.setdefault((topic, part), []).append((key, value))
        for (topic, part), records in grouped.items():
            await self._produce_with_retry(topic, part, records)

    async def _produce_with_retry(self, topic: str, part: int, records: list) -> None:
        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            try:
                await self._client.produce(topic, part, records, acks=self.acks,
                                           compression=self.compression)
                return
            except Exception as e:
                last = e
                logger.warning("kafka produce retry %d (%s/%d): %s", attempt, topic, part, e)
                if attempt < self.retries:  # no backoff after the final attempt
                    await asyncio.sleep(min(0.2 * 2**attempt, 2.0))
        raise WriteError(f"kafka produce failed after {self.retries + 1} attempts: {last}")

    async def close(self) -> None:
        if self._client is not None:
            await self._client.close()


def _check(config: dict) -> None:
    if not config.get("brokers") or not config.get("topic"):
        raise ConfigError("kafka output requires 'brokers' and 'topic'")
    compression = config.get("compression")
    if compression not in (None, "none", "gzip", "snappy", "lz4", "zstd"):
        raise ConfigError(
            f"kafka output compression {compression!r} not supported "
            "(none/gzip/snappy/lz4/zstd)"
        )
    check_dyn_value(config["topic"], "topic")
    if config.get("key") is not None:
        check_dyn_value(config["key"], "key")
    _partitioner(config)
    check_codec(config)


@register_output("kafka", keys=("brokers", "topic", "key", "acks", "retries", "codec",
                                "compression", "partitioner", "tls", "sasl"), check=_check)
def _build(config: dict, resource: Resource) -> KafkaOutput:
    key = config.get("key")
    return KafkaOutput(
        brokers=str(config["brokers"]),
        topic=DynValue.from_config(config["topic"], "topic"),
        key=DynValue.from_config(key, "key") if key is not None else None,
        acks=int(config.get("acks", -1)),
        retries=int(config.get("retries", 3)),
        codec=build_codec(config.get("codec"), resource),
        client_kwargs=client_kwargs_from_config(config),
        compression=config.get("compression"),
        partitioner=_partitioner(config),
    )


def _partitioner(config: dict) -> str:
    p = str(config.get("partitioner", "murmur2"))
    if p not in ("murmur2", "crc32c"):
        raise ConfigError(f"kafka partitioner {p!r} not supported (murmur2/crc32c)")
    return p
