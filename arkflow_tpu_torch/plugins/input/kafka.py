"""Kafka input: fetch loop with ack-driven offset commits (at-least-once).

Counterpart of ``arkflow_tpu/plugins/input/kafka.py``. Each read returns one
partition's fetched records as a batch carrying ``__meta_source``
(``kafka:<topic>``), ``__meta_partition``, ``__meta_offset``,
``__meta_key``, ``__meta_timestamp``, ``__meta_ingest_time`` and
``__meta_ext_topic``, built from the port's own columns (int64 numpy
columns and a ``BinaryColumn`` for the keys; no pyarrow) with the JAX
package's names, types, nulls and order. The ``KafkaAck`` commits
``last_offset + 1`` to the group coordinator only after the downstream
write succeeded, so a crash replays from the committed offset.

Partition assignment: with ``partitions`` the consumer is static
(simple-consumer offsets). Otherwise it joins the consumer group:
JoinGroup/SyncGroup, background heartbeats every ``HEARTBEAT_INTERVAL_S``
against a ``SESSION_TIMEOUT_MS`` session, automatic rejoin on rebalance,
offset commits fenced by generation/member id. The default assignor
preference is cooperative-sticky then range; under cooperative-sticky a
rebalance is incremental (KIP-429): retained partitions keep fetching from
their in-memory positions, and only revoked ones stop.

Config:

    type: kafka
    brokers: "localhost:9092"
    topics: [events, audit]   # or the single-topic form `topic: events`
    group: arkflow-grp
    partitions: [0, 1]        # optional static assignment (single topic only)
    start: earliest           # earliest | latest (when no committed offset)
    batch_size: 500           # max records per read
    assignor: cooperative-sticky,range   # preference order; 'range' forces eager
    codec: json               # optional; raw __value__ otherwise
    tls: {ca_file: ...}       # optional
    sasl: {mechanism: PLAIN, username: u, password: "${PW}"}   # optional
    tenant: team-a            # multi-tenancy: a static tenant id stamped into
                              # __meta_ext_tenant for every batch, or
    tenant_header: x-tenant   # read from the fetch's first record's headers
                              # (the header wins over `tenant`)

The input is pull-based (``pause_on_overload``): the stream pauses its
reads while the overload controller sheds with a full window.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

import numpy as np

from arkflow_tpu_torch.batch import (META_KEY, META_OFFSET, META_TIMESTAMP, BinaryColumn,
                                     MessageBatch)
from arkflow_tpu_torch.components import Ack, Input, Resource, register_input
from arkflow_tpu_torch.connect.kafka_client import (
    ERR_COORDINATOR_LOAD_IN_PROGRESS,
    ERR_COORDINATOR_NOT_AVAILABLE,
    ERR_NOT_COORDINATOR,
    ERR_UNKNOWN_MEMBER_ID,
    GroupRebalance,
    KafkaClient,
    KafkaProtocolError,
    client_kwargs_from_config,
    cooperative_sticky_assign,
    range_assign,
)
from arkflow_tpu_torch.errors import ConfigError, EndOfInput
from arkflow_tpu_torch.plugins.codec.helper import build_codec, check_codec, decode_payloads

logger = logging.getLogger("arkflow_torch.kafka")


class KafkaAck(Ack):
    """Commits the consumed offsets when the batch is fully written downstream."""

    def __init__(self, owner: "KafkaInput", topic: str, partition: int,
                 next_offset: int, generation: int, member_id: str):
        self.owner = owner
        self.topic = topic
        self.partition = partition
        self.next_offset = next_offset
        self.generation = generation
        self.member_id = member_id

    async def ack(self) -> None:
        o = self.owner
        tp = (self.topic, self.partition)
        try:
            await o._client.offset_commit(o.group, self.topic, self.partition,
                                          self.next_offset, self.generation, self.member_id)
            o._committed[tp] = max(o._committed.get(tp, -1), self.next_offset)
        except GroupRebalance:
            # fenced: this member lost the partition mid-flight; the new owner
            # replays from the last committed offset (at-least-once)
            if self.generation == o._generation:
                o._rejoin_needed.set()  # stale acks from a pre-rejoin generation don't re-trigger
            logger.warning("kafka offset commit fenced (%s/%d, gen %d)",
                           self.topic, self.partition, self.generation)
        except Exception as e:
            # at-least-once: a failed commit means replay, never loss
            logger.warning("kafka offset commit failed (%s/%d): %s",
                           self.topic, self.partition, e)


HEARTBEAT_INTERVAL_S = 3.0
SESSION_TIMEOUT_MS = 10000


class KafkaInput(Input):
    #: pull-based: the backlog stays on the broker (see ``Input``)
    pause_on_overload = True

    def __init__(self, brokers: str, topics: list[str], group: str,
                 partitions: Optional[list[int]], start: str, batch_size: int, codec=None,
                 client_kwargs: Optional[dict] = None,
                 assignors: tuple[str, ...] = ("cooperative-sticky", "range"),
                 tenant: Optional[str] = None, tenant_header: Optional[str] = None):
        if start not in ("earliest", "latest"):
            raise ConfigError("kafka input 'start' must be earliest|latest")
        _check_assignors(assignors)
        if not topics:
            raise ConfigError("kafka input needs at least one topic")
        if partitions is not None and len(topics) > 1:
            raise ConfigError(
                "kafka static 'partitions' requires a single topic; "
                "multi-topic consumption uses the group protocol")
        self.assignors = tuple(assignors)
        self.brokers = brokers
        self.topics = list(topics)
        self.group = group
        self.configured_partitions = partitions
        self.start = start
        self.batch_size = batch_size
        self.codec = codec
        self.client_kwargs = client_kwargs or {}
        #: static tenant id of every batch, and the record header that
        #: carries a per-message one (the header wins)
        self.tenant = tenant
        self.tenant_header = tenant_header.encode() if tenant_header else None
        self._client: Optional[KafkaClient] = None
        #: next offset to fetch per (topic, partition)
        self._offsets: dict[tuple[str, int], int] = {}
        self._committed: dict[tuple[str, int], int] = {}
        self._rr: list[tuple[str, int]] = []
        self._rr_idx = 0
        self._closed = False
        # dynamic group membership state
        self._generation = -1
        self._member_id = ""
        self._rejoin_needed = asyncio.Event()
        self._joined = False
        self._join_lock = asyncio.Lock()
        self._heartbeat_task: Optional[asyncio.Task] = None

    @property
    def dynamic(self) -> bool:
        return self.configured_partitions is None

    async def connect(self) -> None:
        self._client = KafkaClient(self.brokers, **self.client_kwargs)
        await self._client.connect()
        await self._client.refresh_metadata(self.topics)
        if self.dynamic:
            async with self._join_lock:
                await self._join_locked()
            self._heartbeat_task = asyncio.create_task(self._heartbeat_loop())
        else:
            parts = self.configured_partitions
            if not parts:
                raise ConfigError(
                    f"kafka input: topic {self.topics[0]!r} has no partitions")
            self._rr = [(self.topics[0], p) for p in parts]
            await self._load_offsets(self._rr)

    async def _load_offsets(self, tps: list[tuple[str, int]]) -> None:
        for t, p in tps:
            committed = await self._client.offset_fetch(self.group, t, p)
            if committed >= 0:
                self._offsets[(t, p)] = committed
            else:
                self._offsets[(t, p)] = await self._client.list_offsets(
                    t, p, earliest=(self.start == "earliest")
                )

    async def _join(self) -> None:
        """Join/rejoin the consumer group and adopt the synced assignment."""
        async with self._join_lock:
            if not self._rejoin_needed.is_set() and self._joined:
                return  # another task already completed this rejoin
            await self._join_locked()

    async def _join_locked(self) -> None:
        member = self._member_id
        while not self._closed:
            try:
                cooperative_offered = "cooperative-sticky" in self.assignors
                owned: dict[str, list[int]] = {}
                for t, p in self._rr:
                    owned.setdefault(t, []).append(p)
                res = await self._client.join_group(
                    self.group, self.topics, member,
                    session_timeout_ms=SESSION_TIMEOUT_MS,
                    assignors=self.assignors,
                    owned=(owned if cooperative_offered else None),
                )
                cooperative = res.protocol == "cooperative-sticky"
                if res.is_leader:
                    union = sorted({t for ts in res.members.values() for t in ts})
                    await self._client.refresh_metadata(union)
                    topic_parts = {t: self._client.partitions(t) for t in union}
                    if cooperative:
                        assignments = cooperative_sticky_assign(
                            res.members, res.member_owned, topic_parts)
                    else:
                        assignments = range_assign(res.members, topic_parts)
                    mine = await self._client.sync_group(
                        self.group, res.generation, res.member_id, assignments
                    )
                else:
                    mine = await self._client.sync_group(
                        self.group, res.generation, res.member_id
                    )
                self._generation = res.generation
                self._member_id = res.member_id
                parts = sorted(
                    (t, p) for t, ps in mine.items() for p in ps)
                revoked: set[tuple[str, int]] = set()
                if cooperative and self._joined:
                    # KIP-429 incremental adoption: retained partitions keep
                    # their in-memory fetch positions (no offset re-fetch, no
                    # pause); only the delta changes
                    old = set(self._rr)
                    revoked = old - set(parts)
                    added = sorted(set(parts) - old)
                    for tp in revoked:
                        self._offsets.pop(tp, None)
                    self._rr = parts
                    if added:
                        await self._load_offsets(added)
                else:
                    self._rr = parts
                    self._offsets = {}
                    if parts:
                        await self._load_offsets(parts)
                self._rejoin_needed.clear()
                self._joined = True
                logger.info("kafka group %s gen %d (%s): member %s assigned %s",
                            self.group, self._generation, res.protocol,
                            self._member_id, parts)
                if cooperative and revoked:
                    # second phase: having revoked, rejoin immediately so the
                    # leader can hand the withheld partitions to their new
                    # owner (we no longer claim them)
                    logger.info("kafka group %s: revoked %s, rejoining",
                                self.group, sorted(revoked))
                    member = self._member_id
                    continue
                return
            except GroupRebalance as e:
                if e.code == ERR_UNKNOWN_MEMBER_ID:
                    member = self._member_id = ""
                await asyncio.sleep(0.2)
            except KafkaProtocolError as e:
                if e.code not in (ERR_COORDINATOR_LOAD_IN_PROGRESS,
                                  ERR_COORDINATOR_NOT_AVAILABLE, ERR_NOT_COORDINATOR):
                    raise
                # transient coordinator churn (startup, failover): retry
                self._client.invalidate_coordinator(self.group)
                await asyncio.sleep(0.3)

    async def _heartbeat_loop(self) -> None:
        try:
            while not self._closed:
                await asyncio.sleep(HEARTBEAT_INTERVAL_S)
                if self._rejoin_needed.is_set():
                    continue  # read loop is about to rejoin
                try:
                    await self._client.heartbeat(self.group, self._generation, self._member_id)
                except GroupRebalance:
                    # rejoin promptly (inside the coordinator's join window),
                    # like librdkafka — don't wait for the next poll
                    self._rejoin_needed.set()
                    try:
                        await self._join()
                    except Exception as e:
                        logger.warning("kafka rejoin failed: %s", e)
                except Exception as e:
                    logger.warning("kafka heartbeat failed: %s", e)
        except asyncio.CancelledError:
            raise

    async def read(self) -> tuple[MessageBatch, Ack]:
        if self._closed:
            raise EndOfInput()
        while True:
            if self.dynamic and self._rejoin_needed.is_set():
                await self._join()
            if not self._rr:
                # dynamic member with no assigned partitions: idle until rebalance
                if self._closed:
                    raise EndOfInput()
                await asyncio.sleep(0.2)
                continue
            t, p = self._rr[self._rr_idx % len(self._rr)]
            self._rr_idx += 1
            offset = self._offsets.get((t, p))
            if offset is None:
                # assignment changed under us mid-loop; yield so the
                # heartbeat-task rejoin / offset load can actually run
                # instead of this loop spinning the event loop dry
                await asyncio.sleep(0)
                continue
            try:
                records, _hwm, next_offset = await self._client.fetch(
                    t, p, offset, max_wait_ms=250
                )
            except KafkaProtocolError as e:
                if e.code == 1:  # offset out of range: snap to earliest
                    self._offsets[(t, p)] = await self._client.list_offsets(t, p, True)
                    continue
                raise
            if self._closed:
                raise EndOfInput()
            if not records:
                # advance past record-less batches (transaction control
                # markers, compacted tails) or we refetch them forever
                self._offsets[(t, p)] = max(offset, next_offset)
                if self._rr_idx % len(self._rr) == 0:
                    await asyncio.sleep(0.05)
                continue
            records = records[: self.batch_size]
            self._offsets[(t, p)] = records[-1].offset + 1
            batch = self._records_to_batch(records, t, p)
            ack = KafkaAck(self, t, p, records[-1].offset + 1,
                           self._generation, self._member_id)
            return batch, ack

    def _records_to_batch(self, records, topic: str, partition: int) -> MessageBatch:
        values = [r.value or b"" for r in records]
        if self.codec is not None:
            base = decode_payloads(values, self.codec)
            per_row = None  # codec may expand rows; per-record meta not aligned
        else:
            base = MessageBatch.new_binary(values)
            per_row = records
        out = (
            base.with_source(f"kafka:{topic}")
            .with_partition(partition)
            .with_ext_metadata({"topic": topic})
            .with_ingest_time()
        )
        tenant = self.tenant
        if self.tenant_header is not None:
            raw = (records[0].headers or {}).get(self.tenant_header)
            if raw:
                try:
                    tenant = raw.decode("utf-8")
                except UnicodeDecodeError:
                    logger.warning("kafka tenant header %r not utf-8; using %r",
                                   self.tenant_header, tenant)
        if tenant is not None:
            out = out.with_tenant(tenant)
        if per_row is not None and base.num_rows == len(records):
            out = out.with_column(META_OFFSET, np.array([r.offset for r in records], np.int64))
            out = out.with_column(META_KEY, BinaryColumn.from_pylist([r.key for r in records]))
            out = out.with_column(
                META_TIMESTAMP, np.array([r.timestamp_ms for r in records], np.int64))
        else:
            out = out.with_offset(records[-1].offset).with_timestamp(records[-1].timestamp_ms)
        return out

    async def close(self) -> None:
        self._closed = True
        if self._heartbeat_task is not None:
            self._heartbeat_task.cancel()
            try:
                await self._heartbeat_task
            except (asyncio.CancelledError, Exception):
                pass
        if self._client is not None:
            if self.dynamic and self._member_id:
                try:
                    await self._client.leave_group(self.group, self._member_id)
                except Exception:
                    pass
            await self._client.close()


def _topics(config: dict) -> list[str]:
    # 'topics: [a, b]' is the reference schema; 'topic: a' stays as the
    # single-topic convenience form
    raw_topics = config.get("topics", config.get("topic"))
    if not raw_topics:
        raise ConfigError("kafka input requires 'topics' (or 'topic')")
    return ([str(t) for t in raw_topics]
            if isinstance(raw_topics, (list, tuple)) else [str(raw_topics)])


def _assignors(config: dict) -> tuple[str, ...]:
    return tuple(a.strip()
                 for a in str(config.get("assignor", "cooperative-sticky,range")).split(",")
                 if a.strip())


def _check_assignors(assignors: tuple[str, ...]) -> None:
    for a in assignors:
        if a not in ("cooperative-sticky", "range"):
            raise ConfigError(
                f"kafka assignor {a!r} unsupported (cooperative-sticky|range)")
    if not assignors:
        raise ConfigError("kafka input needs at least one assignor")


def _check(config: dict) -> None:
    _topics(config)
    for req in ("brokers", "group"):
        if not config.get(req):
            raise ConfigError(f"kafka input requires {req!r}")
    start = str(config.get("start", "earliest"))
    if start not in ("earliest", "latest"):
        raise ConfigError("kafka input 'start' must be earliest|latest")
    _check_assignors(_assignors(config))
    if config.get("partitions") and len(_topics(config)) > 1:
        raise ConfigError(
            "kafka static 'partitions' requires a single topic; "
            "multi-topic consumption uses the group protocol")
    check_codec(config)


@register_input("kafka", keys=("brokers", "topics", "topic", "group", "partitions", "start",
                               "batch_size", "assignor", "codec", "tls", "sasl", "tenant",
                               "tenant_header"), check=_check)
def _build(config: dict, resource: Resource) -> KafkaInput:
    parts = config.get("partitions")
    return KafkaInput(
        brokers=str(config["brokers"]),
        topics=_topics(config),
        group=str(config["group"]),
        partitions=[int(p) for p in parts] if parts else None,
        start=str(config.get("start", "earliest")),
        batch_size=int(config.get("batch_size", 500)),
        codec=build_codec(config.get("codec"), resource),
        client_kwargs=client_kwargs_from_config(config),
        assignors=_assignors(config),
        tenant=str(config["tenant"]) if config.get("tenant") else None,
        tenant_header=str(config["tenant_header"]) if config.get("tenant_header") else None,
    )
