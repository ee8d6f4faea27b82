"""Minimal Kafka client: wire protocol over TCP, no external library.

Counterpart of ``arkflow_tpu/connect/kafka_client.py``, the whole module.
It speaks the classic (non-flexible) protocol versions, enough for an
at-least-once streaming engine:

- Metadata v1 (leader discovery), ListOffsets v1 (earliest/latest)
- Produce v3 / Fetch v4 with record-batch format v2 (magic 2, crc32c from
  ``arkflow_tpu_torch.native``; gzip/snappy/lz4/zstd compression both ways,
  snappy and the LZ4 frame from ``utils/xcodecs.py``). zstd produces go out
  as Produce v7, and fetch upgrades itself to v10 on
  UNSUPPORTED_COMPRESSION_TYPE, per KIP-110's version floors.
- FindCoordinator v0 (cached per group) + OffsetCommit v2 / OffsetFetch v1
- Consumer groups: JoinGroup v2 / SyncGroup v1 / Heartbeat v1 / LeaveGroup
  v1 with the 'range' and 'cooperative-sticky' (KIP-429 incremental
  rebalance, Subscription v1 owned_partitions) assignors; commits carry
  generation/member so fenced members fail fast. Static partition lists
  bypass the group protocol entirely.
- SASL PLAIN (SaslHandshake v1 + SaslAuthenticate v0) and TLS.

One connection per broker node, requests serialised per connection with
correlation-id matching.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import time
from dataclasses import dataclass, field
from typing import Optional

from arkflow_tpu_torch.connect import make_ssl_context
from arkflow_tpu_torch.errors import ConnectError, Disconnection, ReadError, WriteError
from arkflow_tpu_torch.native import crc32c

logger = logging.getLogger("arkflow_torch.kafka")

API_PRODUCE = 0
API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3
API_OFFSET_COMMIT = 8
API_OFFSET_FETCH = 9
API_FIND_COORDINATOR = 10
API_JOIN_GROUP = 11
API_HEARTBEAT = 12
API_LEAVE_GROUP = 13
API_SYNC_GROUP = 14
API_SASL_HANDSHAKE = 17
API_SASL_AUTHENTICATE = 36

ERR_COORDINATOR_LOAD_IN_PROGRESS = 14
ERR_COORDINATOR_NOT_AVAILABLE = 15
ERR_NOT_COORDINATOR = 16
ERR_ILLEGAL_GENERATION = 22
ERR_UNKNOWN_MEMBER_ID = 25
ERR_REBALANCE_IN_PROGRESS = 27


class KafkaProtocolError(ReadError):
    def __init__(self, api: str, code: int):
        super().__init__(f"kafka {api} error code {code}")
        self.code = code


class GroupRebalance(ReadError):
    """The consumer group is rebalancing (or this member was fenced):
    rejoin with ``join_group``."""

    def __init__(self, code: int):
        super().__init__(f"kafka group rebalance required (error {code})")
        self.code = code


# -- primitive encoding -----------------------------------------------------


class Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def i8(self, v): self.parts.append(struct.pack(">b", v)); return self
    def i16(self, v): self.parts.append(struct.pack(">h", v)); return self
    def i32(self, v): self.parts.append(struct.pack(">i", v)); return self
    def i64(self, v): self.parts.append(struct.pack(">q", v)); return self
    def u32(self, v): self.parts.append(struct.pack(">I", v)); return self

    def string(self, s: Optional[str]):
        if s is None:
            return self.i16(-1)
        b = s.encode()
        self.i16(len(b))
        self.parts.append(b)
        return self

    def bytes_(self, b: Optional[bytes]):
        if b is None:
            return self.i32(-1)
        self.i32(len(b))
        self.parts.append(b)
        return self

    def array(self, items, fn):
        self.i32(len(items))
        for it in items:
            fn(self, it)
        return self

    def varint(self, v: int):
        # zigzag
        z = (v << 1) ^ (v >> 63)
        while True:
            b = z & 0x7F
            z >>= 7
            if z:
                self.parts.append(bytes([b | 0x80]))
            else:
                self.parts.append(bytes([b]))
                return self

    def raw(self, b: bytes):
        self.parts.append(b)
        return self

    def build(self) -> bytes:
        return b"".join(self.parts)


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) < n:
            raise ReadError("kafka: truncated response")
        self.pos += n
        return b

    def i8(self) -> int: return struct.unpack(">b", self._take(1))[0]
    def i16(self) -> int: return struct.unpack(">h", self._take(2))[0]
    def i32(self) -> int: return struct.unpack(">i", self._take(4))[0]
    def i64(self) -> int: return struct.unpack(">q", self._take(8))[0]
    def u32(self) -> int: return struct.unpack(">I", self._take(4))[0]

    def string(self) -> Optional[str]:
        n = self.i16()
        return None if n < 0 else self._take(n).decode()

    def bytes_(self) -> Optional[bytes]:
        n = self.i32()
        return None if n < 0 else self._take(n)

    def varint(self) -> int:
        shift = 0
        result = 0
        while True:
            b = self._take(1)[0]
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (result >> 1) ^ -(result & 1)  # un-zigzag

    def remaining(self) -> int:
        return len(self.data) - self.pos


# -- record batch v2 --------------------------------------------------------


@dataclass
class KafkaRecord:
    offset: int
    timestamp_ms: int
    key: Optional[bytes]
    value: Optional[bytes]
    #: record headers (v2 batches); None when the record carried none —
    #: consumers read routing identity from them (e.g. the kafka input's
    #: ``tenant_header`` multi-tenancy extraction)
    headers: Optional[dict[bytes, bytes]] = None


def encode_record_batch(records: list[tuple[Optional[bytes], Optional[bytes]]],
                        base_ts_ms: Optional[int] = None,
                        compression: Optional[str] = None) -> bytes:
    """records: [(key, value)] -> record-batch v2 bytes (plain or gzip)."""
    now = base_ts_ms if base_ts_ms is not None else int(time.time() * 1000)
    body = Writer()
    for i, (key, value) in enumerate(records):
        rec = Writer()
        rec.i8(0)  # attributes
        rec.varint(0)  # timestamp delta
        rec.varint(i)  # offset delta
        if key is None:
            rec.varint(-1)
        else:
            rec.varint(len(key)).raw(key)
        if value is None:
            rec.varint(-1)
        else:
            rec.varint(len(value)).raw(value)
        rec.varint(0)  # headers count
        encoded = rec.build()
        body.varint(len(encoded)).raw(encoded)
    records_bytes = body.build()
    attrs = 0
    if compression == "gzip":
        import gzip as _gzip

        records_bytes = _gzip.compress(records_bytes)
        attrs = 1
    elif compression == "snappy":
        from arkflow_tpu_torch.utils.xcodecs import snappy_encode

        records_bytes = snappy_encode(records_bytes)
        attrs = 2
    elif compression == "lz4":
        from arkflow_tpu_torch.utils.xcodecs import lz4_frame_encode

        records_bytes = lz4_frame_encode(records_bytes)
        attrs = 3
    elif compression == "zstd":
        from arkflow_tpu_torch.utils.xcodecs import zstd_encode

        records_bytes = zstd_encode(records_bytes)
        attrs = 4
    elif compression not in (None, "none"):
        raise WriteError(
            f"kafka compression {compression!r} not supported "
            "(none/gzip/snappy/lz4/zstd)")

    # fields covered by crc: attributes..records
    crc_body = (
        Writer()
        .i16(attrs)
        .i32(len(records) - 1)  # lastOffsetDelta
        .i64(now)  # firstTimestamp
        .i64(now)  # maxTimestamp
        .i64(-1)  # producerId
        .i16(-1)  # producerEpoch
        .i32(-1)  # baseSequence
        .i32(len(records))
        .raw(records_bytes)
        .build()
    )
    crc = crc32c(crc_body)
    after_length = (
        Writer().i32(0).i8(2).u32(crc).raw(crc_body).build()  # leaderEpoch, magic, crc
    )
    return Writer().i64(0).i32(len(after_length)).raw(after_length).build()


def murmur2(data: bytes) -> int:
    """Murmur2 hash, bit-compatible with the Java client's Utils.murmur2.

    Keyed partition routing must use ``toPositive(murmur2(key)) % n`` to land
    records on the same partitions as Java/librdkafka producers sharing the
    topic (librdkafka's ``partitioner=murmur2`` / Java default).
    """
    m = 0x5BD1E995
    length = len(data)
    h = (0x9747B28C ^ length) & 0xFFFFFFFF
    for i4 in range(0, length - 3, 4):
        k = data[i4] | (data[i4 + 1] << 8) | (data[i4 + 2] << 16) | (data[i4 + 3] << 24)
        k = (k * m) & 0xFFFFFFFF
        k ^= k >> 24
        k = (k * m) & 0xFFFFFFFF
        h = ((h * m) & 0xFFFFFFFF) ^ k
    tail = length & ~3
    rem = length - tail
    if rem == 3:
        h ^= data[tail + 2] << 16
    if rem >= 2:
        h ^= data[tail + 1] << 8
    if rem >= 1:
        h ^= data[tail]
        h = (h * m) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * m) & 0xFFFFFFFF
    h ^= h >> 15
    return h


def partition_for_key(key: bytes, n_partitions: int) -> int:
    """Java-client-compatible keyed partition choice."""
    return (murmur2(key) & 0x7FFFFFFF) % n_partitions


def decode_record_batches(data: bytes) -> list[KafkaRecord]:
    """Parse a record set (possibly several v2 batches) into records."""
    return decode_record_set(data)[0]


def decode_record_set(data: bytes) -> tuple[list[KafkaRecord], Optional[int]]:
    """Parse a record set -> (records, next_offset).

    ``next_offset`` is the fetch position after every *parsed* batch —
    ``base_offset + lastOffsetDelta + 1`` of the last complete batch — and is
    what a consumer must advance to even when a batch yields no records
    (skipped transaction-control batches, compacted-away tails); advancing by
    ``records[-1].offset + 1`` alone would refetch marker batches forever.
    None when no complete batch was parsed.
    """
    out: list[KafkaRecord] = []
    next_offset: Optional[int] = None
    r = Reader(data)
    while r.remaining() >= 61:  # minimal batch header size
        base_offset = r.i64()
        batch_len = r.i32()
        if r.remaining() < batch_len:
            break  # partial batch at end of fetch response
        end = r.pos + batch_len
        r.i32()  # leader epoch
        magic = r.i8()
        if magic != 2:
            r.pos = end
            continue
        r.u32()  # crc (trusted; validated by broker)
        attrs = r.i16()
        last_delta = r.i32()  # lastOffsetDelta
        next_offset = base_offset + last_delta + 1
        if attrs & 0x20:
            # control batch: transaction COMMIT/ABORT markers written by
            # transactional producers — not user data (librdkafka filters
            # these internally; ref input/kafka.rs consumes via librdkafka).
            # next_offset still advances past it.
            r.pos = end
            continue
        codec_id = attrs & 0x07
        if codec_id not in (0, 1, 2, 3, 4):  # none/gzip/snappy/lz4/zstd
            raise ReadError(
                f"kafka: compression codec {codec_id} not supported"
            )
        first_ts = r.i64()
        r.i64()  # maxTimestamp
        r.i64()  # producerId
        r.i16()  # producerEpoch
        r.i32()  # baseSequence
        n = r.i32()
        # parse records from a sub-reader so the outer cursor stays intact
        # across multi-batch record sets (gzip swaps in decompressed bytes)
        records_blob = r._take(end - r.pos)
        if codec_id == 1:
            import gzip as _gzip

            records_blob = _gzip.decompress(records_blob)
        elif codec_id == 2:
            from arkflow_tpu_torch.utils.xcodecs import snappy_decode

            records_blob = snappy_decode(bytes(records_blob))
        elif codec_id == 3:
            from arkflow_tpu_torch.utils.xcodecs import lz4_frame_decode

            records_blob = lz4_frame_decode(bytes(records_blob))
        elif codec_id == 4:
            from arkflow_tpu_torch.utils.xcodecs import zstd_decode

            records_blob = zstd_decode(bytes(records_blob))
        rr = Reader(records_blob)
        for _ in range(n):
            rr.varint()  # record length
            rr.i8()  # attributes
            ts_delta = rr.varint()
            off_delta = rr.varint()
            klen = rr.varint()
            key = bytes(rr._take(klen)) if klen >= 0 else None
            vlen = rr.varint()
            value = bytes(rr._take(vlen)) if vlen >= 0 else None
            hn = rr.varint()
            headers: Optional[dict[bytes, bytes]] = None
            for _ in range(hn):
                hk = rr.varint()
                hkey = bytes(rr._take(hk))
                hv = rr.varint()
                hval = bytes(rr._take(hv)) if hv >= 0 else b""
                if headers is None:
                    headers = {}
                headers[hkey] = hval
            out.append(KafkaRecord(base_offset + off_delta, first_ts + ts_delta,
                                   key, value, headers))
        r.pos = end
    return out, next_offset


# -- connection -------------------------------------------------------------


class _BrokerConn:
    def __init__(self, host: str, port: int, client_id: str,
                 ssl_context=None, sasl: Optional[dict] = None):
        self.host = host
        self.port = port
        self.client_id = client_id
        self.ssl_context = ssl_context
        self.sasl = sasl  # {"mechanism": "PLAIN", "username", "password"}
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._correlation = 0
        self._lock = asyncio.Lock()

    async def connect(self, timeout: float = 5.0) -> None:
        try:
            self._reader, self._writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port, ssl=self.ssl_context), timeout
            )
        except (OSError, asyncio.TimeoutError) as e:
            raise ConnectError(f"kafka connect to {self.host}:{self.port} failed: {e}") from e
        if self.sasl:
            try:
                await self._authenticate(timeout)
            except BaseException:
                await self.close()  # don't leak the socket on rejected credentials
                raise

    async def _authenticate(self, timeout: float) -> None:
        """SASL PLAIN via SaslHandshake v1 + SaslAuthenticate v0."""
        mech = str(self.sasl.get("mechanism", "PLAIN")).upper()
        if mech != "PLAIN":
            raise ConnectError(f"kafka sasl mechanism {mech!r} not supported (PLAIN only)")
        r = await self._request_unlocked(API_SASL_HANDSHAKE, 1, Writer().string(mech).build(), timeout)
        err = r.i16()
        if err != 0:
            raise ConnectError(f"kafka sasl handshake rejected (error {err})")
        n = r.i32()
        for _ in range(max(0, n)):
            r.string()  # enabled mechanisms
        user = str(self.sasl.get("username", ""))
        pw = str(self.sasl.get("password", ""))
        token = b"\x00" + user.encode() + b"\x00" + pw.encode()
        r = await self._request_unlocked(API_SASL_AUTHENTICATE, 0, Writer().bytes_(token).build(), timeout)
        err = r.i16()
        msg = r.string()
        r.bytes_()  # server auth bytes
        if err != 0:
            raise ConnectError(f"kafka sasl authentication failed: {msg or err}")

    async def _request_unlocked(self, api_key: int, api_version: int, body: bytes,
                                timeout: float = 30.0) -> Reader:
        self._correlation += 1
        corr = self._correlation
        header = (
            Writer().i16(api_key).i16(api_version).i32(corr).string(self.client_id).build()
        )
        frame = header + body
        self._writer.write(struct.pack(">i", len(frame)) + frame)
        try:
            await self._writer.drain()
            size_b = await asyncio.wait_for(self._reader.readexactly(4), timeout)
            (size,) = struct.unpack(">i", size_b)
            payload = await asyncio.wait_for(self._reader.readexactly(size), timeout)
        except (OSError, asyncio.IncompleteReadError, asyncio.TimeoutError) as e:
            try:
                self._writer.close()
            except Exception:
                pass
            self._writer = None
            self._reader = None
            raise Disconnection(f"kafka broker {self.host}:{self.port} lost: {e}") from e
        r = Reader(payload)
        got_corr = r.i32()
        if got_corr != corr:
            raise ReadError(f"kafka correlation mismatch {got_corr} != {corr}")
        return r

    async def request(self, api_key: int, api_version: int, body: bytes,
                      timeout: float = 30.0) -> Reader:
        async with self._lock:
            if self._writer is None:
                await self.connect()
            return await self._request_unlocked(api_key, api_version, body, timeout)

    async def close(self) -> None:
        if self._writer is not None:
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except Exception:
                pass
            self._writer = None


@dataclass
class JoinResult:
    generation: int
    member_id: str
    leader_id: str
    protocol: str
    members: dict[str, list[str]]  # member_id -> subscribed topics (leader only)
    #: member_id -> topic -> owned partitions (leader only; Subscription v1
    #: owned_partitions, the KIP-429 cooperative-rebalance input)
    member_owned: dict[str, dict[str, list[int]]] = field(default_factory=dict)

    @property
    def is_leader(self) -> bool:
        return self.member_id == self.leader_id


def encode_subscription(topics: list[str],
                        owned: Optional[dict[str, list[int]]] = None) -> bytes:
    """ConsumerProtocolSubscription: v0 (version, topics, user_data), or v1
    with ``owned_partitions`` appended (KIP-429 — what cooperative assignors
    read to keep partitions sticky across rebalances)."""
    w = Writer().i16(1 if owned is not None else 0)
    w.array(sorted(topics), lambda w2, t: w2.string(t))
    w.bytes_(None)
    if owned is not None:
        w.array(
            sorted(owned.items()),
            lambda w2, kv: w2.string(kv[0]).array(sorted(kv[1]), lambda w3, p: w3.i32(p)),
        )
    return w.build()


def decode_subscription(data: bytes) -> list[str]:
    if not data:
        return []
    r = Reader(data)
    r.i16()  # version
    n = r.i32()
    return [r.string() for _ in range(max(0, n))]


def decode_subscription_owned(data: bytes) -> dict[str, list[int]]:
    """The v1 owned_partitions block ({} for v0 or absent)."""
    if not data:
        return {}
    r = Reader(data)
    version = r.i16()
    n = r.i32()
    for _ in range(max(0, n)):
        r.string()
    r.bytes_()  # user_data
    if version < 1 or r.remaining() <= 0:
        return {}
    out: dict[str, list[int]] = {}
    k = r.i32()
    for _ in range(max(0, k)):
        topic = r.string()
        m = r.i32()
        out[topic] = [r.i32() for _ in range(max(0, m))]
    return out


def encode_assignment(assignment: dict[str, list[int]]) -> bytes:
    """ConsumerProtocolAssignment v0: version, [topic, [partitions]], user_data."""
    w = Writer().i16(0)
    w.array(
        sorted(assignment.items()),
        lambda w2, kv: w2.string(kv[0]).array(sorted(kv[1]), lambda w3, p: w3.i32(p)),
    )
    w.bytes_(None)
    return w.build()


def decode_assignment(data: bytes) -> dict[str, list[int]]:
    if not data:
        return {}
    r = Reader(data)
    r.i16()  # version
    out: dict[str, list[int]] = {}
    n = r.i32()
    for _ in range(max(0, n)):
        topic = r.string()
        k = r.i32()
        out[topic] = [r.i32() for _ in range(max(0, k))]
    return out


def range_assign(members: dict[str, list[str]],
                 topic_partitions: dict[str, list[int]]) -> dict[str, dict[str, list[int]]]:
    """The 'range' assignor: per topic, contiguous partition ranges to the
    subscribed members in member-id order (matches the Java client)."""
    out: dict[str, dict[str, list[int]]] = {mid: {} for mid in members}
    for topic, parts in sorted(topic_partitions.items()):
        subs = sorted(mid for mid, topics in members.items() if topic in topics)
        if not subs:
            continue
        parts = sorted(parts)
        per, extra = divmod(len(parts), len(subs))
        start = 0
        for i, mid in enumerate(subs):
            count = per + (1 if i < extra else 0)
            if count:
                out[mid].setdefault(topic, []).extend(parts[start : start + count])
            start += count
    return out


def cooperative_sticky_assign(
    members: dict[str, list[str]],
    owned: dict[str, dict[str, list[int]]],
    topic_partitions: dict[str, list[int]],
) -> dict[str, dict[str, list[int]]]:
    """The 'cooperative-sticky' assignor (KIP-429 incremental rebalance).

    Stickiness: every validly-owned partition stays with its owner, then the
    pool is balanced (new/unowned partitions to the least-loaded subscriber;
    overloaded owners shed their excess). The COOPERATIVE rule: a partition
    migrating from member A to member B is assigned to NOBODY this
    generation — A notices the revocation in its synced assignment, drops the
    partition, and rejoins; the follow-up rebalance (A no longer claims it)
    hands it to B. Members keep fetching their retained partitions throughout
    — no stop-the-world revoke like the classic eager protocol.
    """
    # validate ownership claims: partition exists, owner still subscribed,
    # claimed exactly once (double claims invalidate both, like Java). ALL
    # claims — valid or not — are remembered: a partition some member still
    # believes it owns must go through a revoke round before anyone else may
    # fetch it, or two generations-valid members overlap (no-overlap is the
    # KIP-429 invariant)
    owner: dict[tuple[str, int], str] = {}
    claims: dict[tuple[str, int], set[str]] = {}
    dupes: set[tuple[str, int]] = set()
    for mid, tps in owned.items():
        if mid not in members:
            continue
        for t, ps in tps.items():
            for p in ps:
                key = (t, p)
                claims.setdefault(key, set()).add(mid)
                if key in owner or key in dupes:
                    owner.pop(key, None)
                    dupes.add(key)
                    continue
                if t in members[mid] and p in topic_partitions.get(t, []):
                    owner[key] = mid

    target = dict(owner)
    load = {mid: 0 for mid in members}
    for mid in target.values():
        load[mid] += 1
    # unowned partitions -> least-loaded subscriber (member-id tiebreak)
    for t, ps in sorted(topic_partitions.items()):
        subs = sorted(m for m, ts in members.items() if t in ts)
        if not subs:
            continue
        for p in sorted(ps):
            if (t, p) not in target:
                m = min(subs, key=lambda x: (load[x], x))
                target[(t, p)] = m
                load[m] += 1
    # balance: move from overloaded to underloaded while the gap exceeds 1
    while True:
        moved = False
        for key in sorted(target):
            t = key[0]
            a = target[key]
            subs = [m for m, ts in members.items() if t in ts and m != a]
            if not subs:
                continue
            b = min(sorted(subs), key=lambda x: (load[x], x))
            if load[a] > load[b] + 1:
                target[key] = b
                load[a] -= 1
                load[b] += 1
                moved = True
        if not moved:
            break

    out: dict[str, dict[str, list[int]]] = {mid: {} for mid in members}
    for (t, p), mid in sorted(target.items()):
        if claims.get((t, p), set()) - {mid}:
            # someone other than the target still claims it (migration,
            # double claim, or stale owner): withheld until every claimant
            # has seen the revocation and rejoined without it
            continue
        out[mid].setdefault(t, []).append(p)
    return out


@dataclass
class PartitionMeta:
    partition: int
    leader: int


@dataclass
class TopicMeta:
    name: str
    partitions: dict[int, PartitionMeta] = field(default_factory=dict)


def client_kwargs_from_config(config: dict) -> dict:
    """Parse connector-level ``tls``/``sasl`` config into KafkaClient kwargs.

    ``sasl.password`` supports ``${ENV}`` indirection like other secrets.
    """
    from arkflow_tpu_torch.utils.auth import resolve_secret

    kwargs: dict = {}
    tls = config.get("tls")
    if tls is not None and tls is not False:  # `tls: {}` means system CAs
        kwargs["ssl_context"] = make_ssl_context({} if tls is True else dict(tls))
    sasl = config.get("sasl")
    if sasl:
        sasl = dict(sasl)
        if sasl.get("password"):
            sasl["password"] = resolve_secret(str(sasl["password"]))
        kwargs["sasl"] = sasl
    return kwargs


class KafkaClient:
    def __init__(self, bootstrap: str, client_id: str = "arkflow-tpu",
                 ssl_context=None, sasl: Optional[dict] = None):
        # bootstrap: "host:port" or "host:port,host:port"
        self.bootstrap = [
            (h.strip().rsplit(":", 1)[0], int(h.strip().rsplit(":", 1)[1]))
            for h in bootstrap.replace("kafka://", "").split(",")
        ]
        self.client_id = client_id
        self.ssl_context = ssl_context
        self.sasl = sasl
        self._brokers: dict[int, tuple[str, int]] = {}
        self._conns: dict[int, _BrokerConn] = {}
        self._coordinators: dict[str, int] = {}  # group -> node id
        self._bootstrap_conn: Optional[_BrokerConn] = None
        self.topics: dict[str, TopicMeta] = {}
        # Fetch starts on the classic v4 and upgrades itself to v10 the
        # first time a broker answers UNSUPPORTED_COMPRESSION_TYPE (KIP-110:
        # zstd-bearing logs are only served to v10+ fetchers).
        self._fetch_version = 4

    def _make_conn(self, host: str, port: int) -> _BrokerConn:
        return _BrokerConn(host, port, self.client_id,
                           ssl_context=self.ssl_context, sasl=self.sasl)

    async def connect(self) -> None:
        last: Optional[Exception] = None
        for host, port in self.bootstrap:
            conn = self._make_conn(host, port)
            try:
                await conn.connect()
                self._bootstrap_conn = conn
                return
            except ConnectError as e:
                last = e
        raise ConnectError(f"kafka: no bootstrap broker reachable: {last}")

    async def _conn_for_node(self, node: int) -> _BrokerConn:
        conn = self._conns.get(node)
        if conn is None:
            host, port = self._brokers[node]
            conn = self._make_conn(host, port)
            await conn.connect()
            self._conns[node] = conn
        return conn

    async def refresh_metadata(self, topics: list[str]) -> None:
        body = Writer().array(topics, lambda w, t: w.string(t)).build()
        r = await self._bootstrap_conn.request(API_METADATA, 1, body)
        n_brokers = r.i32()
        for _ in range(n_brokers):
            node = r.i32()
            host = r.string()
            port = r.i32()
            r.string()  # rack
            self._brokers[node] = (host, port)
        r.i32()  # controller id
        n_topics = r.i32()
        for _ in range(n_topics):
            err = r.i16()
            name = r.string()
            r.i8()  # is_internal
            tm = TopicMeta(name)
            n_parts = r.i32()
            for _ in range(n_parts):
                perr = r.i16()
                pid = r.i32()
                leader = r.i32()
                nrep = r.i32()
                for _ in range(nrep):
                    r.i32()
                nisr = r.i32()
                for _ in range(nisr):
                    r.i32()
                if perr == 0:
                    tm.partitions[pid] = PartitionMeta(pid, leader)
            if err == 0:
                self.topics[name] = tm
            else:
                raise KafkaProtocolError(f"metadata({name})", err)

    def partitions(self, topic: str) -> list[int]:
        tm = self.topics.get(topic)
        return sorted(tm.partitions) if tm else []

    async def _leader_conn(self, topic: str, partition: int) -> _BrokerConn:
        tm = self.topics.get(topic)
        if tm is None or partition not in tm.partitions:
            await self.refresh_metadata([topic])
            tm = self.topics.get(topic)
            if tm is None or partition not in tm.partitions:
                raise ReadError(f"kafka: unknown topic-partition {topic}/{partition}")
        return await self._conn_for_node(tm.partitions[partition].leader)

    # -- produce -----------------------------------------------------------

    async def produce(self, topic: str, partition: int,
                      records: list[tuple[Optional[bytes], Optional[bytes]]],
                      acks: int = -1, timeout_ms: int = 30000,
                      compression: Optional[str] = None) -> int:
        batch = encode_record_batch(records, compression=compression)
        # KIP-110: brokers reject zstd batches arriving over Produce < v7
        # with UNSUPPORTED_COMPRESSION_TYPE. The request schema is identical
        # across v3-v8 (only the response grew fields), so v7 costs nothing.
        version = 7 if compression == "zstd" else 3
        body = (
            Writer()
            .string(None)  # transactional_id
            .i16(acks)
            .i32(timeout_ms)
            .array(
                [(topic, partition, batch)],
                lambda w, t: w.string(t[0]).array(
                    [(t[1], t[2])], lambda w2, p: w2.i32(p[0]).bytes_(p[1])
                ),
            )
            .build()
        )
        conn = await self._leader_conn(topic, partition)
        r = await conn.request(API_PRODUCE, version, body)
        base_offset = -1
        n_topics = r.i32()
        for _ in range(n_topics):
            r.string()
            n_parts = r.i32()
            for _ in range(n_parts):
                r.i32()  # partition
                err = r.i16()
                base_offset = r.i64()
                r.i64()  # log_append_time
                if version >= 5:
                    r.i64()  # log_start_offset
                if err != 0:
                    if err in (3, 6):  # unknown topic/partition, not leader
                        self.topics.pop(topic, None)
                    raise WriteError(f"kafka produce error code {err}")
        return base_offset

    # -- fetch -------------------------------------------------------------

    async def fetch(self, topic: str, partition: int, offset: int,
                    max_wait_ms: int = 500, min_bytes: int = 1,
                    max_bytes: int = 4 << 20) -> tuple[list[KafkaRecord], int, int]:
        """Returns (records, high_watermark, next_offset).

        ``next_offset`` is where the next fetch must start — it advances past
        batches that yielded no records (control batches, compaction) and is
        >= ``offset`` always.
        """
        next_offset = offset
        conn = await self._leader_conn(topic, partition)
        while True:
            version = self._fetch_version
            w = (
                Writer()
                .i32(-1)  # replica_id
                .i32(max_wait_ms)
                .i32(min_bytes)
                .i32(max_bytes)
                .i8(0)  # isolation level: read_uncommitted
            )
            if version >= 7:
                w.i32(0)  # session_id: sessionless full fetch
                w.i32(-1)  # session_epoch
            def _part(w2: Writer, p) -> None:
                # each field gated at its KIP introduction version so every
                # fetch version 4..11 serializes correctly
                w2.i32(p[0])
                if version >= 9:
                    w2.i32(-1)  # current_leader_epoch
                w2.i64(p[1])
                if version >= 5:
                    w2.i64(-1)  # log_start_offset (-1: consumer, not follower)
                w2.i32(max_bytes)
            w.array(
                [(topic, offset)],
                lambda wt, t: wt.string(topic).array([(partition, offset)], _part),
            )
            if version >= 7:
                w.array([], lambda w2, x: None)  # forgotten_topics_data
            r = await conn.request(API_FETCH, version, w.build())
            r.i32()  # throttle
            if version >= 7:
                top_err = r.i16()
                r.i32()  # session_id
                if top_err != 0:
                    raise Disconnection(f"kafka fetch error code {top_err}")
            records: list[KafkaRecord] = []
            hwm = -1
            retry_v10 = False
            n_topics = r.i32()
            for _ in range(n_topics):
                r.string()
                n_parts = r.i32()
                for _ in range(n_parts):
                    r.i32()  # partition
                    err = r.i16()
                    hwm = r.i64()
                    r.i64()  # last_stable_offset
                    if version >= 5:
                        r.i64()  # log_start_offset
                    n_aborted = r.i32()
                    for _ in range(max(0, n_aborted)):
                        r.i64()
                        r.i64()
                    record_set = r.bytes_() or b""
                    if err != 0:
                        if err == 76 and version < 10:
                            # UNSUPPORTED_COMPRESSION_TYPE: the log holds
                            # zstd batches the broker refuses to serve to
                            # pre-KIP-110 fetchers. Upgrade and stay there.
                            self._fetch_version = 10
                            retry_v10 = True
                            continue
                        if err in (1,):  # offset out of range
                            raise KafkaProtocolError("fetch", err)
                        if err in (3, 6, 9):
                            self.topics.pop(topic, None)
                        raise Disconnection(f"kafka fetch error code {err}")
                    batch_records, batch_next = decode_record_set(record_set)
                    records.extend(rec for rec in batch_records if rec.offset >= offset)
                    if batch_next is not None:
                        next_offset = max(next_offset, batch_next)
            if not retry_v10:
                return records, hwm, next_offset

    async def list_offsets(self, topic: str, partition: int, earliest: bool) -> int:
        ts = -2 if earliest else -1
        body = (
            Writer()
            .i32(-1)
            .array(
                [(topic, partition)],
                lambda w, t: w.string(t[0]).array(
                    [t[1]], lambda w2, p: w2.i32(p).i64(ts)
                ),
            )
            .build()
        )
        conn = await self._leader_conn(topic, partition)
        r = await conn.request(API_LIST_OFFSETS, 1, body)
        offset = -1
        n_topics = r.i32()
        for _ in range(n_topics):
            r.string()
            n_parts = r.i32()
            for _ in range(n_parts):
                r.i32()
                err = r.i16()
                r.i64()  # timestamp
                offset = r.i64()
                if err != 0:
                    raise KafkaProtocolError("list_offsets", err)
        return offset

    # -- consumer groups (dynamic membership) ------------------------------

    async def join_group(self, group: str, topics: list[str], member_id: str = "",
                         session_timeout_ms: int = 10000,
                         rebalance_timeout_ms: int = 30000,
                         assignors: tuple[str, ...] = ("range",),
                         owned: Optional[dict[str, list[int]]] = None) -> "JoinResult":
        """JoinGroup v2 offering ``assignors`` in preference order (the broker
        picks the first protocol every member supports — listing
        ("cooperative-sticky", "range") upgrades in place like the Java
        client, falling back to eager range in mixed fleets). For
        cooperative-sticky the subscription carries ``owned`` partitions
        (Subscription v1, KIP-429). When this member is the leader,
        ``members``/``member_owned`` hold every member's subscription."""
        protocols = [
            (name,
             encode_subscription(topics,
                                 owned if name == "cooperative-sticky" else None))
            for name in assignors
        ]
        body = (
            Writer()
            .string(group)
            .i32(session_timeout_ms)
            .i32(rebalance_timeout_ms)
            .string(member_id)
            .string("consumer")
            .array(protocols, lambda w, p: w.string(p[0]).bytes_(p[1]))
            .build()
        )
        conn = await self._coordinator_conn(group)
        r = await conn.request(API_JOIN_GROUP, 2, body,
                               timeout=rebalance_timeout_ms / 1000.0 + 30.0)
        r.i32()  # throttle
        err = r.i16()
        generation = r.i32()
        protocol = r.string()
        leader = r.string()
        my_id = r.string()
        members: dict[str, list[str]] = {}
        member_owned: dict[str, dict[str, list[int]]] = {}
        n = r.i32()
        for _ in range(max(0, n)):
            mid = r.string()
            mmeta = r.bytes_() or b""
            members[mid] = decode_subscription(mmeta)
            member_owned[mid] = decode_subscription_owned(mmeta)
        if err == ERR_UNKNOWN_MEMBER_ID and member_id:
            raise GroupRebalance(err)  # retry with a fresh member id
        if err != 0:
            raise KafkaProtocolError("join_group", err)
        return JoinResult(generation=generation, member_id=my_id,
                          leader_id=leader, protocol=protocol or "range",
                          members=members, member_owned=member_owned)

    async def sync_group(self, group: str, generation: int, member_id: str,
                         assignments: Optional[dict[str, dict[str, list[int]]]] = None
                         ) -> dict[str, list[int]]:
        """SyncGroup v1. The leader passes every member's assignment;
        followers pass none. Returns this member's topic->partitions."""
        entries = [
            (mid, encode_assignment(a)) for mid, a in (assignments or {}).items()
        ]
        body = (
            Writer()
            .string(group)
            .i32(generation)
            .string(member_id)
            .array(entries, lambda w, p: w.string(p[0]).bytes_(p[1]))
            .build()
        )
        conn = await self._coordinator_conn(group)
        r = await conn.request(API_SYNC_GROUP, 1, body)
        r.i32()  # throttle
        err = r.i16()
        blob = r.bytes_() or b""
        if err in (ERR_REBALANCE_IN_PROGRESS, ERR_ILLEGAL_GENERATION, ERR_UNKNOWN_MEMBER_ID):
            raise GroupRebalance(err)
        if err != 0:
            raise KafkaProtocolError("sync_group", err)
        return decode_assignment(blob)

    async def heartbeat(self, group: str, generation: int, member_id: str) -> None:
        body = Writer().string(group).i32(generation).string(member_id).build()
        conn = await self._coordinator_conn(group)
        r = await conn.request(API_HEARTBEAT, 1, body)
        r.i32()  # throttle
        err = r.i16()
        if err in (ERR_REBALANCE_IN_PROGRESS, ERR_ILLEGAL_GENERATION, ERR_UNKNOWN_MEMBER_ID):
            raise GroupRebalance(err)
        if err != 0:
            raise KafkaProtocolError("heartbeat", err)

    async def leave_group(self, group: str, member_id: str) -> None:
        body = Writer().string(group).string(member_id).build()
        conn = await self._coordinator_conn(group)
        r = await conn.request(API_LEAVE_GROUP, 1, body)
        r.i32()  # throttle
        r.i16()  # error ignored on leave

    # -- offsets (simple-consumer group semantics) -------------------------

    async def _coordinator_conn(self, group: str) -> _BrokerConn:
        node = self._coordinators.get(group)
        if node is None:
            body = Writer().string(group).build()
            r = await self._bootstrap_conn.request(API_FIND_COORDINATOR, 0, body)
            err = r.i16()
            node = r.i32()
            host = r.string()
            port = r.i32()
            if err != 0:
                raise KafkaProtocolError("find_coordinator", err)
            self._brokers[node] = (host, port)
            self._coordinators[group] = node
        return await self._conn_for_node(node)

    def invalidate_coordinator(self, group: str) -> None:
        """Forget the cached coordinator (NOT_COORDINATOR / disconnect)."""
        self._coordinators.pop(group, None)

    async def offset_commit(self, group: str, topic: str, partition: int, offset: int,
                            generation: int = -1, member_id: str = "") -> None:
        """generation/member default to simple-consumer semantics; dynamic
        group members pass their join credentials so fenced members fail fast."""
        body = (
            Writer()
            .string(group)
            .i32(generation)
            .string(member_id)
            .i64(-1)  # retention
            .array(
                [(topic, partition, offset)],
                lambda w, t: w.string(t[0]).array(
                    [(t[1], t[2])],
                    lambda w2, p: w2.i32(p[0]).i64(p[1]).string(""),
                ),
            )
            .build()
        )
        conn = await self._coordinator_conn(group)
        r = await conn.request(API_OFFSET_COMMIT, 2, body)
        n_topics = r.i32()
        for _ in range(n_topics):
            r.string()
            n_parts = r.i32()
            for _ in range(n_parts):
                r.i32()
                err = r.i16()
                if err in (ERR_REBALANCE_IN_PROGRESS, ERR_ILLEGAL_GENERATION, ERR_UNKNOWN_MEMBER_ID):
                    raise GroupRebalance(err)
                if err != 0:
                    raise WriteError(f"kafka offset commit error code {err}")

    async def offset_fetch(self, group: str, topic: str, partition: int) -> int:
        """Committed offset, or -1 when none."""
        body = (
            Writer()
            .string(group)
            .array(
                [(topic, partition)],
                lambda w, t: w.string(t[0]).array([t[1]], lambda w2, p: w2.i32(p)),
            )
            .build()
        )
        conn = await self._coordinator_conn(group)
        r = await conn.request(API_OFFSET_FETCH, 1, body)
        offset = -1
        n_topics = r.i32()
        for _ in range(n_topics):
            r.string()
            n_parts = r.i32()
            for _ in range(n_parts):
                r.i32()
                offset = r.i64()
                r.string()  # metadata
                err = r.i16()
                if err != 0:
                    raise KafkaProtocolError("offset_fetch", err)
        return offset

    async def close(self) -> None:
        for conn in list(self._conns.values()):
            await conn.close()
        self._conns.clear()
        if self._bootstrap_conn is not None:
            await self._bootstrap_conn.close()
            self._bootstrap_conn = None
