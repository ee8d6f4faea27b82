"""In-process broker fakes for driving the broker streams without brokers.

Each fake listens on 127.0.0.1, port 0 (``start`` binds and sets ``port``)
and speaks the protocol subset the port's clients use, with its state in
memory for a checker to read:

- ``FakeKafkaBroker``: one node, in-memory partition logs, group offsets
  and a group coordinator with a join barrier (``join_window_s``):
  Metadata v1, Produce v3, Fetch v4, ListOffsets v1, FindCoordinator v0,
  OffsetCommit v2, OffsetFetch v1, JoinGroup v2, SyncGroup v1, Heartbeat
  v1, LeaveGroup v1. A produced record batch is kept as its producer wrote
  it (compressed or not, offsets re-based) and served back as it is, so a
  consumer decodes each codec its producers used. (The JAX package's test
  fake, ``tests/test_kafka.py``, also speaks SASL and KIP-110's zstd
  version floors; the port's tests run the port's clients against it.)
- ``FakeMqttBroker``: MQTT 3.1.1 CONNECT, SUBSCRIBE, PUBLISH at QoS 0/1
  (a QoS 2 subscription is granted QoS 1), PINGREQ, DISCONNECT, with
  ``+``/``#`` topic filters.
- ``FakeRedisServer``: RESP2 AUTH, SELECT, GET, SET, MGET, LPUSH, RPUSH,
  LRANGE, BLPOP (blocking up to its timeout), SUBSCRIBE, PSUBSCRIBE (glob
  patterns) and PUBLISH; string keys in ``kv``, lists in ``lists``.
- ``FakeNatsServer``: INFO, CONNECT, PING, SUB, UNSUB, PUB with ``*`` and
  ``>`` wildcards, HMSG status replies, and the JetStream pull subset the
  port's ``JetStream`` speaks: streams capturing subjects (a publish with a
  reply is answered with a PubAck), stream and consumer info, durable
  consumer creation, ``MSG.NEXT`` pulls that wait up to their ``expires``,
  and ack subjects (``+ACK``; ``-NAK`` or the ack wait redelivers), with
  each consumer's ack floor and redelivery count for a checker.
- ``FakeWebsocketServer``: the RFC 6455 server handshake, then the scripted
  messages (fragmented into continuation frames of a given size, a ping
  before every n-th), pongs and close frames recorded.
- ``FakeModbusServer``: Modbus TCP reads of coils, discrete inputs, holding
  and input registers whose values change with every request; every
  request's values recorded.
- ``FakePulsarBroker``: the Pulsar binary protocol on the port's proto2
  codec (``connect/pulsar_proto.py``): CONNECT (token auth, an
  AUTH_CHALLENGE after it on request), LOOKUP (a redirect to another fake
  on request), PRODUCER and SEND (scripted SEND_ERRORs), SUBSCRIBE with
  FLOW permits and MESSAGE delivery, individual ACKs, PING/PONG and
  CLOSE_*; a subscription keeps its cursor and acks, so a consumer that
  subscribes again is redelivered every unacked message, and
  ``publish_batch`` stores one batched entry.
- ``HttpSink``: an HTTP/1.1 server on ``utils/http1.HttpServer`` that
  records every request and answers a scripted status sequence.

    kafka = FakeKafkaBroker({"text-events": 4})
    await kafka.start()            # kafka.port
    ...
    await kafka.stop()
"""

from __future__ import annotations

import asyncio
import fnmatch
import json
import struct
import time
from typing import Optional, Union

from arkflow_tpu_torch.connect import pulsar_client as pc
from arkflow_tpu_torch.connect.kafka_client import Reader, Writer, decode_record_set
from arkflow_tpu_torch.connect.pulsar_proto import Message
from arkflow_tpu_torch.connect.ws_client import (OP_BINARY, OP_CLOSE, OP_CONT, OP_PING,
                                                 OP_PONG, OP_TEXT, accept_key, close_payload,
                                                 encode_frame, read_frame)
from arkflow_tpu_torch.utils.http1 import HttpServer, Request, Response


class _Server:
    """Listen on 127.0.0.1:0; ``stop`` closes every open connection too."""

    def __init__(self):
        self.server: Optional[asyncio.AbstractServer] = None
        self.port: Optional[int] = None
        self._writers: set = set()

    async def start(self) -> int:
        self.server = await asyncio.start_server(self._conn, "127.0.0.1", 0)
        self.port = self.server.sockets[0].getsockname()[1]
        return self.port

    async def _conn(self, reader, writer) -> None:
        self._writers.add(writer)
        try:
            await self._client(reader, writer)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()

    async def _client(self, reader, writer) -> None:
        raise NotImplementedError

    async def stop(self) -> None:
        if self.server is None:
            return
        self.server.close()
        for w in list(self._writers):
            w.close()
        try:
            await asyncio.wait_for(self.server.wait_closed(), 1.0)
        except asyncio.TimeoutError:
            pass
        self.server = None


# -- Kafka ---------------------------------------------------------------------


class FakeKafkaBroker(_Server):
    """Single-node Kafka fake (see the module docstring)."""

    #: records a fetch returns at most, as whole batches
    FETCH_MAX_RECORDS = 512

    def __init__(self, topics: dict[str, int], join_window_s: float = 0.25):
        super().__init__()
        #: (topic, partition) -> [(base_offset, count, batch bytes)]
        self.logs: dict[tuple[str, int], list] = {
            (t, p): [] for t, n in topics.items() for p in range(n)}
        self.group_offsets: dict[tuple[str, str, int], int] = {}
        self.groups: dict[str, dict] = {}
        self.join_window_s = join_window_s
        #: produced batches by codec id, for a checker
        self.codecs_seen: dict[tuple[str, int], set] = {}

    def log_end(self, topic: str, partition: int) -> int:
        log = self.logs[(topic, partition)]
        return log[-1][0] + log[-1][1] if log else 0

    def records(self, topic: str, partition: int) -> list:
        """Every record of a partition log, decoded."""
        out = []
        for _, _, batch in self.logs[(topic, partition)]:
            out.extend(decode_record_set(batch)[0])
        return out

    def generation(self, group: str) -> int:
        return self.groups.get(group, {}).get("generation", 0)

    # -- group coordinator ----------------------------------------------------

    def _group(self, name: str) -> dict:
        g = self.groups.get(name)
        if g is None:
            g = self.groups[name] = {
                "generation": 0, "members": {}, "pending": {}, "leader": None,
                "state": "empty", "join_waiters": [], "assignments": {},
                "sync_event": asyncio.Event(), "member_seq": 0, "window_task": None}
        return g

    async def _coordinator_join(self, group: str, member_id: str, metas: dict):
        g = self._group(group)
        if not member_id:
            g["member_seq"] += 1
            member_id = f"m{g['member_seq']}"
        g["pending"][member_id] = metas
        g["state"] = "rebalancing"
        fut = asyncio.get_running_loop().create_future()
        g["join_waiters"].append((member_id, fut))
        if g["window_task"] is None or g["window_task"].done():
            async def finalize():
                await asyncio.sleep(self.join_window_s)
                g["generation"] += 1
                g["members"] = dict(g["pending"])
                g["pending"] = {}
                g["leader"] = sorted(g["members"])[0]
                proto = "range"
                for cand in g["members"][g["leader"]]:
                    if all(cand in m for m in g["members"].values()):
                        proto = cand
                        break
                g["assignments"] = {}
                g["sync_event"] = asyncio.Event()
                g["state"] = "awaiting_sync"
                waiters, g["join_waiters"] = g["join_waiters"], []
                for mid, f in waiters:
                    if not f.done():
                        f.set_result((g["generation"], g["leader"], mid, proto,
                                      {m: mm.get(proto, b"") for m, mm in g["members"].items()}))
            g["window_task"] = asyncio.get_running_loop().create_task(finalize())
        return await fut

    async def _coordinator_sync(self, group: str, generation: int, member_id: str,
                                assignments: dict):
        g = self._group(group)
        if generation != g["generation"] or member_id not in g["members"]:
            return 22, b""  # ILLEGAL_GENERATION
        if assignments:  # the leader
            g["assignments"] = assignments
            g["state"] = "stable"
            g["sync_event"].set()
        else:
            try:
                await asyncio.wait_for(g["sync_event"].wait(), timeout=5)
            except asyncio.TimeoutError:
                return 27, b""
        return 0, g["assignments"].get(member_id, b"")

    # -- wire ------------------------------------------------------------------

    async def _client(self, reader, writer) -> None:
        while True:
            (size,) = struct.unpack(">i", await reader.readexactly(4))
            r = Reader(await reader.readexactly(size))
            api, ver, corr = r.i16(), r.i16(), r.i32()
            r.string()  # client id
            if api in (11, 14):  # group APIs wait on the join barrier
                body = await self._dispatch_group(api, r)
            else:
                body = self._dispatch(api, r, ver)
            frame = Writer().i32(corr).raw(body).build()
            writer.write(struct.pack(">i", len(frame)) + frame)
            await writer.drain()

    async def _dispatch_group(self, api: int, r: Reader) -> bytes:
        if api == 11:  # JoinGroup v2
            group = r.string()
            r.i32()
            r.i32()
            member_id = r.string()
            r.string()
            metas = {}
            for _ in range(max(0, r.i32())):
                name = r.string()
                metas[name] = r.bytes_() or b""
            gen, leader, mid, proto, members = await self._coordinator_join(
                group, member_id, metas)
            w = Writer().i32(0).i16(0).i32(gen).string(proto).string(leader).string(mid)
            w.array(sorted(members.items()) if mid == leader else [],
                    lambda w2, kv: w2.string(kv[0]).bytes_(kv[1]))
            return w.build()
        group = r.string()  # SyncGroup v1
        gen = r.i32()
        member_id = r.string()
        assignments = {}
        for _ in range(max(0, r.i32())):
            mid = r.string()
            assignments[mid] = r.bytes_() or b""
        err, blob = await self._coordinator_sync(group, gen, member_id, assignments)
        return Writer().i32(0).i16(err).bytes_(blob).build()

    def _dispatch(self, api: int, r: Reader, ver: int) -> bytes:
        handler = {12: self._heartbeat, 13: self._leave, 3: self._metadata,
                   0: self._produce, 1: self._fetch, 2: self._list_offsets,
                   10: self._find_coordinator, 8: self._offset_commit,
                   9: self._offset_fetch}.get(api)
        if handler is None:
            raise ConnectionError(f"fake kafka broker: unhandled api {api}")
        return handler(r, ver)

    def _heartbeat(self, r: Reader, ver: int) -> bytes:
        group, gen, member_id = r.string(), r.i32(), r.string()
        g = self._group(group)
        if member_id not in g["members"] and member_id not in g["pending"]:
            return Writer().i32(0).i16(25).build()  # UNKNOWN_MEMBER_ID
        if g["state"] == "rebalancing" or gen != g["generation"]:
            return Writer().i32(0).i16(27).build()  # REBALANCE_IN_PROGRESS
        return Writer().i32(0).i16(0).build()

    def _leave(self, r: Reader, ver: int) -> bytes:
        group, member_id = r.string(), r.string()
        g = self._group(group)
        g["members"].pop(member_id, None)
        g["state"] = "rebalancing" if g["members"] else "empty"
        return Writer().i32(0).i16(0).build()

    def _metadata(self, r: Reader, ver: int) -> bytes:
        n = r.i32()
        names = [r.string() for _ in range(n)] if n > 0 else sorted({t for t, _ in self.logs})
        w = Writer().i32(1).i32(0).string("127.0.0.1").i32(self.port).string(None).i32(0)
        w.i32(len(names))
        for name in names:
            parts = sorted(p for t, p in self.logs if t == name)
            w.i16(0 if parts else 3).string(name).i8(0).i32(len(parts))
            for p in parts:
                w.i16(0).i32(p).i32(0).i32(1).i32(0).i32(1).i32(0)
        return w.build()

    def _produce(self, r: Reader, ver: int) -> bytes:
        r.string()
        r.i16()
        r.i32()
        results = []
        for _ in range(r.i32()):
            topic = r.string()
            for _ in range(r.i32()):
                part = r.i32()
                batch = r.bytes_() or b""
                log = self.logs.get((topic, part))
                if log is None:
                    results.append((topic, part, 3, -1))
                    continue
                codec = struct.unpack(">h", batch[21:23])[0] & 0x07
                self.codecs_seen.setdefault((topic, part), set()).add(codec)
                base = self.log_end(topic, part)
                count = struct.unpack(">i", batch[57:61])[0]
                log.append((base, count, struct.pack(">q", base) + batch[8:]))
                results.append((topic, part, 0, base))
        w = Writer().i32(len(results))
        for topic, part, err, base in results:
            w.string(topic).i32(1).i32(part).i16(err).i64(base).i64(-1)
            if ver >= 5:
                w.i64(0)
        return w.i32(0).build()

    def _fetch(self, r: Reader, ver: int) -> bytes:
        r.i32(); r.i32(); r.i32(); r.i32(); r.i8()  # noqa: E702
        if ver >= 7:
            r.i32()
            r.i32()
        n_topics = r.i32()
        w = Writer().i32(0)
        if ver >= 7:
            w.i16(0).i32(0)
        w.i32(n_topics)
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            w.string(topic).i32(n_parts)
            for _ in range(n_parts):
                part = r.i32()
                if ver >= 9:
                    r.i32()
                offset = r.i64()
                if ver >= 5:
                    r.i64()
                r.i32()
                key = (topic, part)
                end = self.log_end(*key) if key in self.logs else 0
                w.i32(part).i16(0).i64(end).i64(end)
                if ver >= 5:
                    w.i64(0)
                w.i32(0)
                blob, n = [], 0
                for base, count, batch in self.logs.get(key, []):
                    if base + count <= offset:
                        continue
                    blob.append(batch)
                    n += count
                    if n >= self.FETCH_MAX_RECORDS:
                        break
                w.bytes_(b"".join(blob))
        return w.build()

    def _list_offsets(self, r: Reader, ver: int) -> bytes:
        r.i32()
        n_topics = r.i32()
        w = Writer().i32(n_topics)
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            w.string(topic).i32(n_parts)
            for _ in range(n_parts):
                part, ts = r.i32(), r.i64()
                end = self.log_end(topic, part) if (topic, part) in self.logs else 0
                w.i32(part).i16(0).i64(-1).i64(0 if ts == -2 else end)
        return w.build()

    def _find_coordinator(self, r: Reader, ver: int) -> bytes:
        r.string()
        return Writer().i16(0).i32(0).string("127.0.0.1").i32(self.port).build()

    def _offset_commit(self, r: Reader, ver: int) -> bytes:
        group = r.string()
        r.i32()
        r.string()
        r.i64()
        n_topics = r.i32()
        w = Writer().i32(n_topics)
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            w.string(topic).i32(n_parts)
            for _ in range(n_parts):
                part, offset = r.i32(), r.i64()
                r.string()
                self.group_offsets[(group, topic, part)] = offset
                w.i32(part).i16(0)
        return w.build()

    def _offset_fetch(self, r: Reader, ver: int) -> bytes:
        group = r.string()
        n_topics = r.i32()
        w = Writer().i32(n_topics)
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            w.string(topic).i32(n_parts)
            for _ in range(n_parts):
                part = r.i32()
                w.i32(part).i64(self.group_offsets.get((group, topic, part), -1))
                w.string("").i16(0)
        return w.build()


# -- MQTT ----------------------------------------------------------------------


def _remaining_length(n: int) -> bytes:
    out = bytearray()
    while True:
        byte, n = n % 128, n // 128
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _frame(first: int, body: bytes) -> bytes:
    return bytes([first]) + _remaining_length(len(body)) + body


class FakeMqttBroker(_Server):
    """MQTT 3.1.1 fake: routes each PUBLISH to the matching subscriptions at
    the subscription's granted QoS (0 or 1)."""

    def __init__(self):
        super().__init__()
        self.subs: list = []  # (writer, topic filter, granted qos)
        self._deliver_pid = 0
        self.published = 0

    @staticmethod
    def _match(filt: str, topic: str) -> bool:
        if filt == topic or filt == "#":
            return True
        fp, tp = filt.split("/"), topic.split("/")
        for i, f in enumerate(fp):
            if f == "#":
                return True
            if i >= len(tp) or (f != "+" and f != tp[i]):
                return False
        return len(fp) == len(tp)

    def _route(self, topic: str, payload: bytes) -> None:
        self.published += 1
        t = topic.encode()
        for w, filt, sub_qos in self.subs:
            if not self._match(filt, topic):
                continue
            if sub_qos:
                self._deliver_pid = self._deliver_pid % 65535 + 1
                body = len(t).to_bytes(2, "big") + t + self._deliver_pid.to_bytes(2, "big") + payload
                w.write(_frame(0x32, body))
            else:
                w.write(_frame(0x30, len(t).to_bytes(2, "big") + t + payload))

    async def _read_packet(self, reader) -> tuple[int, int, bytes]:
        h = (await reader.readexactly(1))[0]
        mult, value = 1, 0
        while True:
            b = (await reader.readexactly(1))[0]
            value += (b & 0x7F) * mult
            if not b & 0x80:
                break
            mult *= 128
        return h >> 4, h & 0x0F, (await reader.readexactly(value) if value else b"")

    async def _client(self, reader, writer) -> None:
        try:
            while True:
                ptype, flags, body = await self._read_packet(reader)
                if ptype == 1:  # CONNECT
                    writer.write(bytes([0x20, 2, 0, 0]))
                elif ptype == 8:  # SUBSCRIBE
                    pid = body[:2]
                    tlen = int.from_bytes(body[2:4], "big")
                    topic = body[4:4 + tlen].decode()
                    sub_qos = min(1, body[4 + tlen] if len(body) > 4 + tlen else 0)
                    self.subs.append((writer, topic, sub_qos))
                    writer.write(bytes([0x90, 3]) + pid + bytes([sub_qos]))
                elif ptype == 3:  # PUBLISH
                    qos = (flags >> 1) & 3
                    tlen = int.from_bytes(body[:2], "big")
                    topic = body[2:2 + tlen].decode()
                    pos = 2 + tlen
                    pid = b""
                    if qos:
                        pid, pos = body[pos:pos + 2], pos + 2
                    if qos == 1:
                        writer.write(bytes([0x40, 2]) + pid)
                    elif qos:
                        raise ConnectionError("fake mqtt broker: QoS 2 publish")
                    self._route(topic, body[pos:])
                elif ptype == 12:  # PINGREQ
                    writer.write(bytes([0xD0, 0]))
                elif ptype == 14:  # DISCONNECT
                    return
                await writer.drain()
        finally:
            self.subs = [s for s in self.subs if s[0] is not writer]


# -- Redis ---------------------------------------------------------------------


def _bulk(v: Optional[bytes]) -> bytes:
    if v is None:
        return b"$-1\r\n"
    return b"$%d\r\n%s\r\n" % (len(v), v)


class FakeRedisServer(_Server):
    """RESP2 fake with string keys, lists, blocking pops and pub/sub."""

    def __init__(self):
        super().__init__()
        self.kv: dict[bytes, bytes] = {}
        self.lists: dict[bytes, list] = {}
        #: (writer, channel or pattern, is a pattern)
        self.subscribers: list = []
        self.published = 0
        self._pushed: Optional[asyncio.Event] = None

    def _notify(self) -> None:
        if self._pushed is not None:
            self._pushed.set()

    def push(self, key: bytes, value: bytes) -> None:
        """RPUSH from the checker's side."""
        self.lists.setdefault(key, []).append(value)
        self._notify()

    async def _read_command(self, reader) -> Optional[list]:
        line = await reader.readline()
        if not line:
            return None
        if line[:1] != b"*":
            raise ConnectionError("fake redis: not a RESP array")
        args = []
        for _ in range(int(line[1:-2])):
            hl = await reader.readline()
            args.append((await reader.readexactly(int(hl[1:-2]) + 2))[:-2])
        return args

    async def _blpop(self, keys: list, timeout_s: float) -> Optional[tuple[bytes, bytes]]:
        deadline = time.monotonic() + (timeout_s if timeout_s > 0 else 1e9)
        while True:
            for k in keys:
                if self.lists.get(k):
                    return k, self.lists[k].pop(0)
            left = deadline - time.monotonic()
            if left <= 0:
                return None
            if self._pushed is None:
                self._pushed = asyncio.Event()
            self._pushed.clear()
            try:
                await asyncio.wait_for(self._pushed.wait(), left)
            except asyncio.TimeoutError:
                pass

    async def _client(self, reader, writer) -> None:
        try:
            while True:
                args = await self._read_command(reader)
                if args is None:
                    return
                cmd = args[0].upper()
                if cmd in (b"AUTH", b"SELECT"):
                    writer.write(b"+OK\r\n")
                elif cmd == b"GET":
                    writer.write(_bulk(self.kv.get(args[1])))
                elif cmd == b"SET":
                    self.kv[args[1]] = args[2]
                    writer.write(b"+OK\r\n")
                elif cmd == b"MGET":
                    writer.write(b"*%d\r\n" % (len(args) - 1)
                                 + b"".join(_bulk(self.kv.get(k)) for k in args[1:]))
                elif cmd == b"LRANGE":
                    lst = self.lists.get(args[1], [])
                    lo, hi = (int(a) + (len(lst) if int(a) < 0 else 0) for a in args[2:4])
                    got = lst[max(lo, 0):hi + 1]
                    writer.write(b"*%d\r\n" % len(got) + b"".join(_bulk(v) for v in got))
                elif cmd in (b"LPUSH", b"RPUSH"):
                    lst = self.lists.setdefault(args[1], [])
                    for v in args[2:]:
                        if cmd == b"LPUSH":
                            lst.insert(0, v)
                        else:
                            lst.append(v)
                    writer.write(b":%d\r\n" % len(lst))
                    self._notify()
                elif cmd == b"BLPOP":
                    popped = await self._blpop(args[1:-1], float(args[-1]))
                    writer.write(b"*-1\r\n" if popped is None
                                 else b"*2\r\n" + _bulk(popped[0]) + _bulk(popped[1]))
                elif cmd in (b"SUBSCRIBE", b"PSUBSCRIBE"):
                    kind = b"subscribe" if cmd == b"SUBSCRIBE" else b"psubscribe"
                    for ch in args[1:]:
                        self.subscribers.append((writer, ch, cmd == b"PSUBSCRIBE"))
                        n = sum(1 for w, _, _ in self.subscribers if w is writer)
                        writer.write(b"*3\r\n" + _bulk(kind) + _bulk(ch) + b":%d\r\n" % n)
                elif cmd == b"PUBLISH":
                    ch, payload = args[1], args[2]
                    self.published += 1
                    n = 0
                    for w, sub, pattern in self.subscribers:
                        if pattern and fnmatch.fnmatchcase(ch.decode(), sub.decode()):
                            w.write(b"*4\r\n" + _bulk(b"pmessage") + _bulk(sub) + _bulk(ch)
                                    + _bulk(payload))
                        elif not pattern and sub == ch:
                            w.write(b"*3\r\n" + _bulk(b"message") + _bulk(ch) + _bulk(payload))
                        else:
                            continue
                        n += 1
                    writer.write(b":%d\r\n" % n)
                else:
                    writer.write(b"-ERR unknown command\r\n")
                await writer.drain()
        finally:
            self.subscribers = [s for s in self.subscribers if s[0] is not writer]


# -- NATS ----------------------------------------------------------------------


def _nats_match(sub: str, subject: str) -> bool:
    if sub == subject:
        return True
    sp, tp = sub.split("."), subject.split(".")
    for i, s in enumerate(sp):
        if s == ">":
            return len(tp) > i
        if i >= len(tp) or (s != "*" and s != tp[i]):
            return False
    return len(sp) == len(tp)


class _Consumer:
    """A durable pull consumer's state."""

    def __init__(self, stream: str, name: str, config: dict):
        self.stream = stream
        self.name = name
        self.config = config
        self.acked: set[int] = set()
        #: seq -> monotonic time of its last delivery, for the unacked
        self.pending: dict[int, float] = {}
        self.deliveries: dict[int, int] = {}
        #: messages delivered again (a nak, or past the ack wait)
        self.redelivered = 0
        self.naks = 0
        self.next_seq = 1
        self.ack_floor = 0
        self.pulls: list = []  # waiting MSG.NEXT requests: [inbox, left, deadline, sent]

    def advance_floor(self) -> None:
        while self.ack_floor + 1 in self.acked:
            self.ack_floor += 1


class FakeNatsServer(_Server):
    """NATS core fake with ``*`` and ``>`` wildcards, plus JetStream pull
    consumers over the streams given (see the module docstring):

        nats = FakeNatsServer(streams={"EVENTS": ["events.>"]})
        nats.js_publish("events.sensors", b"...")   # or a PUB with a reply
        nats.consumers[("EVENTS", "arkflow")].ack_floor
    """

    #: seconds a delivered message may wait for its ack before it is due again
    ACK_WAIT_S = 30.0

    def __init__(self, streams: Optional[dict[str, list[str]]] = None):
        super().__init__()
        self.subs: list = []  # (writer, subject, sid)
        #: stream -> the subjects it captures
        self.streams: dict[str, list[str]] = dict(streams or {})
        #: stream -> [(subject, payload)], sequence i + 1
        self.js_messages: dict[str, list] = {name: [] for name in self.streams}
        self.consumers: dict[tuple[str, str], _Consumer] = {}
        self._pump: Optional[asyncio.Task] = None

    def last_seq(self, stream: str) -> int:
        return len(self.js_messages[stream])

    def js_publish(self, subject: str, payload: bytes) -> Optional[tuple[str, int]]:
        """Store ``payload`` in the stream capturing ``subject``: (stream,
        seq), or None when no stream captures it."""
        for name, subjects in self.streams.items():
            if any(_nats_match(s, subject) for s in subjects):
                self.js_messages[name].append((subject, payload))
                return name, len(self.js_messages[name])
        return None

    async def _route(self, subject: str, payload: bytes, reply: Optional[str] = None) -> None:
        r = f" {reply}" if reply else ""
        for w, sub, sid in list(self.subs):
            if _nats_match(sub, subject):
                w.write(f"MSG {subject} {sid}{r} {len(payload)}\r\n".encode() + payload + b"\r\n")
                await w.drain()

    async def _reply(self, reply: Optional[str], body: dict) -> None:
        if reply:
            await self._route(reply, json.dumps(body).encode())

    # -- JetStream ---------------------------------------------------------------

    def _next_for(self, c: _Consumer) -> Optional[int]:
        now = time.monotonic()
        for seq, at in sorted(c.pending.items()):
            if at == 0.0 or now - at >= self.ACK_WAIT_S:  # nak'd, or past the ack wait
                c.redelivered += 1
                return seq
        if c.next_seq <= len(self.js_messages[c.stream]):
            c.next_seq += 1
            return c.next_seq - 1
        return None

    def _to_inbox(self, inbox: str, line: str, data: bytes) -> None:
        for w, sub, sid in list(self.subs):
            if sub == inbox:
                w.write(line.format(sid=sid).encode() + data + b"\r\n")

    def _serve_pulls(self, c: _Consumer) -> None:
        """Deliver what the consumer's waiting pulls can take, and end the
        expired ones with a 408 (synchronous: no two servings interleave)."""
        now = time.monotonic()
        for pull in list(c.pulls):
            inbox, left, deadline, sent = pull
            while left > 0:
                seq = self._next_for(c)
                if seq is None:
                    break
                c.pending[seq] = time.monotonic()
                c.deliveries[seq] = c.deliveries.get(seq, 0) + 1
                subject, payload = self.js_messages[c.stream][seq - 1]
                ack = (f"$JS.ACK.{c.stream}.{c.name}.{c.deliveries[seq]}.{seq}.{seq}."
                       f"{time.time_ns()}.0")
                self._to_inbox(inbox, f"MSG {subject} {{sid}} {ack} {len(payload)}\r\n",
                               payload)
                left -= 1
                sent += 1
            pull[1], pull[3] = left, sent
            if left == 0:
                c.pulls.remove(pull)
            elif now >= deadline:
                c.pulls.remove(pull)
                hdr = b"NATS/1.0 408 Request Timeout\r\n\r\n"
                self._to_inbox(inbox, f"HMSG {inbox} {{sid}} {len(hdr)} {len(hdr)}\r\n", hdr)

    async def _pump_loop(self) -> None:
        """Serve waiting pulls as messages arrive, redeliveries fall due and
        pulls expire."""
        while True:
            for c in list(self.consumers.values()):
                if c.pulls:
                    self._serve_pulls(c)
            await asyncio.sleep(0.002)

    async def _jetstream(self, api: str, reply: Optional[str], payload: bytes) -> None:
        parts = api.split(".")
        if api.startswith("STREAM.INFO."):
            name = parts[2]
            if name not in self.streams:
                await self._reply(reply, {"error": {"code": 404,
                                                    "description": "stream not found"}})
                return
            n = self.last_seq(name)
            await self._reply(reply, {"config": {"name": name, "subjects": self.streams[name]},
                                      "state": {"messages": n, "first_seq": 1 if n else 0,
                                                "last_seq": n}})
        elif api.startswith("CONSUMER.INFO."):
            c = self.consumers.get((parts[2], parts[3]))
            if c is None:
                await self._reply(reply, {"error": {"code": 404,
                                                    "description": "consumer not found"}})
                return
            await self._reply(reply, {"stream_name": c.stream, "name": c.name,
                                      "config": c.config,
                                      "ack_floor": {"stream_seq": c.ack_floor},
                                      "num_ack_pending": len(c.pending),
                                      "num_redelivered": c.redelivered})
        elif api.startswith("CONSUMER.DURABLE.CREATE."):
            stream, durable = parts[3], parts[4]
            if stream not in self.streams:
                await self._reply(reply, {"error": {"code": 404,
                                                    "description": "stream not found"}})
                return
            req = json.loads(payload.decode() or "{}")
            self.consumers.setdefault((stream, durable),
                                      _Consumer(stream, durable, req.get("config", {})))
            await self._reply(reply, {"stream_name": stream, "name": durable})
        elif api.startswith("CONSUMER.MSG.NEXT."):
            c = self.consumers.get((parts[3], parts[4]))
            if c is None or not reply:
                return
            req = json.loads(payload.decode() or "{}")
            expires = req.get("expires", 0) / 1e9 or 30.0
            c.pulls.append([reply, int(req.get("batch", 1)), time.monotonic() + expires, 0])
            self._serve_pulls(c)
            if self._pump is None or self._pump.done():
                self._pump = asyncio.get_running_loop().create_task(self._pump_loop())
        else:
            await self._reply(reply, {"error": {"code": 400, "description": f"unknown {api}"}})

    def _ack(self, subject: str, payload: bytes) -> None:
        # $JS.ACK.<stream>.<durable>.<delivered>.<stream seq>.<consumer seq>.<ts>.<pending>
        parts = subject.split(".")
        c = self.consumers.get((parts[2], parts[3]))
        if c is None:
            return
        seq = int(parts[5])
        if payload.startswith(b"-NAK"):
            if seq in c.pending:
                c.naks += 1
                c.pending[seq] = 0.0  # due at once
        elif payload in (b"", b"+ACK"):
            c.pending.pop(seq, None)
            c.acked.add(seq)
            c.advance_floor()

    async def _client(self, reader, writer) -> None:
        writer.write(b'INFO {"server_id":"fake","max_payload":1048576,"headers":true,'
                     b'"jetstream":true}\r\n')
        await writer.drain()
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                if line.startswith(b"PING"):
                    writer.write(b"PONG\r\n")
                elif line.startswith(b"SUB "):
                    parts = line.strip().split(b" ")
                    self.subs.append((writer, parts[1].decode(), parts[-1].decode()))
                elif line.startswith(b"UNSUB "):
                    sid = line.strip().split(b" ")[1].decode()
                    self.subs = [s for s in self.subs if not (s[0] is writer and s[2] == sid)]
                elif line.startswith(b"PUB "):
                    parts = line.strip().split(b" ")
                    subject = parts[1].decode()
                    reply = parts[2].decode() if len(parts) == 4 else None
                    payload = await reader.readexactly(int(parts[-1]))
                    await reader.readexactly(2)
                    if subject.startswith("$JS.ACK."):
                        self._ack(subject, payload)
                    elif subject.startswith("$JS.API."):
                        await self._jetstream(subject[len("$JS.API."):], reply, payload)
                    else:
                        stored = self.js_publish(subject, payload)
                        if stored is not None and reply:
                            await self._reply(reply, {"stream": stored[0], "seq": stored[1]})
                            reply = None
                        await self._route(subject, payload, reply)
                await writer.drain()
        finally:
            self.subs = [s for s in self.subs if s[0] is not writer]

    async def stop(self) -> None:
        if self._pump is not None:
            self._pump.cancel()
            try:
                await self._pump
            except (asyncio.CancelledError, Exception):
                pass
            self._pump = None
        await super().stop()


# -- websocket -----------------------------------------------------------------


class FakeWebsocketServer(_Server):
    """RFC 6455 server fake: on each connection, after the handshake, sends
    ``messages`` in order (``str`` as text, ``bytes`` as binary), each in
    frames of at most ``fragment`` bytes (0: one frame), a ping before every
    ``ping_every``-th (0: none), then a close frame with ``close_code`` when
    one is given, else holds the connection open. Reads the client's frames:
    pongs and close codes are recorded."""

    def __init__(self, messages: list[Union[str, bytes]], fragment: int = 0,
                 ping_every: int = 0, close_code: Optional[int] = None):
        super().__init__()
        self.messages = list(messages)
        self.fragment = fragment
        self.ping_every = ping_every
        self.close_code = close_code
        self.pongs: list[bytes] = []
        self.close_codes: list[int] = []
        self.handshakes = 0
        #: the time the last scripted message was written
        self.sent_at: Optional[float] = None

    def _frames(self, message: Union[str, bytes]) -> bytes:
        opcode = OP_TEXT if isinstance(message, str) else OP_BINARY
        data = message.encode() if isinstance(message, str) else message
        if not self.fragment or len(data) <= self.fragment:
            return encode_frame(opcode, data)
        chunks = [data[i:i + self.fragment] for i in range(0, len(data), self.fragment)]
        return b"".join(encode_frame(opcode if i == 0 else OP_CONT, c,
                                     fin=i == len(chunks) - 1)
                        for i, c in enumerate(chunks))

    async def _client(self, reader, writer) -> None:
        head = await reader.readuntil(b"\r\n\r\n")
        hdrs = {k.strip().lower(): v.strip() for k, sep, v in
                (r.partition(":") for r in head.decode("latin-1").split("\r\n")[1:] if r) if sep}
        key = hdrs.get("sec-websocket-key")
        if hdrs.get("upgrade", "").lower() != "websocket" or not key:
            writer.write(b"HTTP/1.1 400 Bad Request\r\nContent-Length: 0\r\n\r\n")
            await writer.drain()
            return
        writer.write(("HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
                      f"Connection: Upgrade\r\nSec-WebSocket-Accept: {accept_key(key)}"
                      "\r\n\r\n").encode())
        self.handshakes += 1
        listener = asyncio.create_task(self._listen(reader, writer))
        try:
            for i, m in enumerate(self.messages):
                if self.ping_every and i % self.ping_every == 0:
                    writer.write(encode_frame(OP_PING, b"p%d" % i))
                writer.write(self._frames(m))
                await writer.drain()
            self.sent_at = time.perf_counter()
            if self.close_code is not None:
                writer.write(encode_frame(OP_CLOSE, close_payload(self.close_code)))
                await writer.drain()
            await listener
        finally:
            listener.cancel()

    async def _listen(self, reader, writer) -> None:
        while True:
            fin, opcode, payload, masked = await read_frame(reader, 1 << 30)
            if not masked:
                raise ConnectionError("fake websocket: an unmasked client frame")
            if opcode == OP_PONG:
                self.pongs.append(payload)
            elif opcode == OP_CLOSE:
                self.close_codes.append(struct.unpack(">H", payload[:2])[0]
                                        if len(payload) >= 2 else 1005)
                if self.close_code is None:  # the client closed first: echo it
                    writer.write(encode_frame(OP_CLOSE, payload[:2]))
                    await writer.drain()
                return


# -- Modbus --------------------------------------------------------------------


class FakeModbusServer(_Server):
    """Modbus TCP fake: function codes 1-4. Request ``n`` (from 0) reads
    register ``address + i`` as ``(SEED + 37 * n + 11 * (address + i)) %
    65536`` and bit ``address + i`` as that value's lowest bit; ``served``
    records ``(function, address, count, values)`` of every request."""

    SEED = 1000

    def __init__(self):
        super().__init__()
        self.requests = 0
        self.served: list[tuple[int, int, int, list]] = []

    def _values(self, func: int, addr: int, count: int) -> list:
        n = self.requests
        regs = [(self.SEED + 37 * n + 11 * (addr + i)) % 65536 for i in range(count)]
        return [bool(r & 1) for r in regs] if func in (1, 2) else regs

    async def _client(self, reader, writer) -> None:
        while True:
            header = await reader.readexactly(7)
            tid, _proto, length, unit = struct.unpack(">HHHB", header)
            func, addr, count = struct.unpack(">BHH", await reader.readexactly(length - 1))
            if func in (1, 2, 3, 4):
                vals = self._values(func, addr, count)
                self.requests += 1
                self.served.append((func, addr, count, vals))
                if func in (1, 2):
                    bits = bytearray((count + 7) // 8)
                    for i, v in enumerate(vals):
                        if v:
                            bits[i // 8] |= 1 << (i % 8)
                    body = struct.pack(">BB", func, len(bits)) + bytes(bits)
                else:
                    body = struct.pack(">BB", func, 2 * count) + struct.pack(f">{count}H", *vals)
            else:
                body = struct.pack(">BB", func | 0x80, 1)  # illegal function
            writer.write(struct.pack(">HHHB", tid, 0, len(body) + 1, unit) + body)
            await writer.drain()


# -- Pulsar ----------------------------------------------------------------------


class _Entry:
    """One entry of a topic's log: a single message or a batch."""

    __slots__ = ("entry_id", "payloads", "key", "batched")

    def __init__(self, entry_id: int, payloads: list[bytes], key: Optional[str], batched: bool):
        self.entry_id, self.payloads, self.key, self.batched = entry_id, payloads, key, batched


class _Subscription:
    """A subscription's cursor: entries never delivered start at ``next``;
    delivered-but-unacked ones are ``pending`` on a consumer and go back to
    ``redeliver`` when that consumer leaves."""

    def __init__(self, start: int):
        self.next = start
        self.acked: set[int] = set()
        self.pending: dict[int, tuple] = {}  # entry index -> consumer key
        self.redeliver: list[int] = []
        self.redeliveries: dict[int, int] = {}
        self.consumers: list[tuple] = []


class FakePulsarBroker(_Server):
    """A one-node Pulsar broker: in-memory topic logs (ledger 1, entry ids
    counted across topics), subscriptions with cursors, and the scripted
    faults of the JAX package's test fake (``required_token``,
    ``redirect_to``, ``fail_sends``, ``challenge_after_connect``). Its
    CONNECTED carries a field outside the ``PulsarApi`` subset, as a newer
    broker's does. ``acked`` records every ACK's ``(ledger, entry,
    batch_index)``; ``subscriptions`` every SUBSCRIBE's ``(topic,
    subscription, subType)``; ``redelivered`` counts redeliveries."""

    def __init__(self, *, required_token: Optional[str] = None,
                 redirect_to: "FakePulsarBroker | None" = None,
                 fail_sends: int = 0, challenge_after_connect: bool = False):
        super().__init__()
        self.required_token = required_token
        self.redirect_to = redirect_to
        self.fail_sends = fail_sends
        self.challenge_after_connect = challenge_after_connect
        self.auth_responses: list[tuple[str, bytes]] = []
        self.logs: dict[str, list[_Entry]] = {}
        self.acked: list[tuple[int, int, int]] = []
        self.subscriptions: list[tuple[str, str, int]] = []
        self.lookups = 0
        self.pongs = 0
        self.redelivered = 0
        self._subs: dict[tuple[str, str], _Subscription] = {}
        self._consumers: dict[tuple, dict] = {}  # (connection, consumer id) -> state
        self._producers: dict[tuple, str] = {}
        self._entry_id = 0
        #: entry id -> its index in its topic's log
        self._entry_index: dict[int, int] = {}
        self._conn_ids = 0

    @property
    def topics(self) -> dict[str, list[tuple[bytes, dict]]]:
        """Every message of each topic as ``(payload, {"key", "entry"})``,
        the JAX fake's view."""
        return {t: [(p, {"key": e.key, "entry": e.entry_id}) for e in log for p in e.payloads]
                for t, log in self.logs.items()}

    def unacked(self, topic: str, subscription: str) -> int:
        """Entries of ``topic`` the subscription has not acked."""
        sub = self._subs.get((topic, subscription))
        log = self.logs.get(topic, [])
        return len(log) - (len(sub.acked) if sub is not None else 0)

    def append(self, topic: str, payloads: list[bytes], key: Optional[str] = None,
               batched: bool = False) -> int:
        """Store one entry in ``topic``'s log (a full topic name) without
        delivering it; its entry id."""
        self._entry_id += 1
        log = self.logs.setdefault(topic, [])
        self._entry_index[self._entry_id] = len(log)
        log.append(_Entry(self._entry_id, payloads, key, batched))
        return self._entry_id

    async def publish_batch(self, topic: str, payloads: list[bytes]) -> int:
        """Store one batched entry of ``payloads`` and deliver it."""
        entry = self.append(pc.validate_topic(topic), list(payloads), None, batched=True)
        await self._deliver_all()
        return entry

    async def ping_all(self) -> None:
        """Send a PING on every open connection (each answers a PONG)."""
        for w in list(self._writers):
            w.write(pc.encode_simple(Message("BaseCommand", type=pc.PING)))
            await w.drain()

    async def close_consumer(self, consumer_id: int) -> None:
        """Push a broker-initiated CLOSE_CONSUMER (a topic unload)."""
        for key, state in list(self._consumers.items()):
            if key[1] == consumer_id:
                self._drop_consumer(key)
                state["writer"].write(pc.encode_simple(pc.command(
                    pc.CLOSE_CONSUMER, "close_consumer", consumer_id=consumer_id,
                    request_id=0)))
                await state["writer"].drain()

    async def _client(self, reader, writer) -> None:
        self._conn_ids += 1
        conn = self._conn_ids
        try:
            cmd, _ = await self._read_frame(reader)
            if cmd.type != pc.CONNECT:
                return
            if self.required_token is not None and (
                    cmd.connect.auth_method_name != "token"
                    or cmd.connect.auth_data != self.required_token.encode()):
                writer.write(pc.encode_simple(pc.command(
                    pc.ERROR, "error", request_id=0, error=3, message="bad token")))
                await writer.drain()
                return
            connected = Message("CommandConnected", server_version="fake-pulsar",
                                protocol_version=12).encode()
            connected += b"\x22\x02\x08\x01"  # feature_flags (field 4), outside the subset
            body = (Message("BaseCommand", type=pc.CONNECTED).encode()
                    + b"\x1a" + bytes([len(connected)]) + connected)
            writer.write(struct.pack(">II", 4 + len(body), len(body)) + body)
            await writer.drain()
            if self.challenge_after_connect:
                writer.write(pc.encode_simple(pc.command(
                    pc.AUTH_CHALLENGE, "authChallenge", server_version="fake-pulsar",
                    challenge=Message("AuthData", auth_method_name="token"))))
                await writer.drain()
            while True:
                cmd, payload = await self._read_frame(reader)
                await self._handle(conn, cmd, payload, writer)
        finally:
            for key in [k for k in self._consumers if k[0] == conn]:
                self._drop_consumer(key)

    @staticmethod
    async def _read_frame(reader) -> tuple[Message, Optional[bytes]]:
        (total,) = struct.unpack(">I", await reader.readexactly(4))
        return pc.decode_frame(await reader.readexactly(total))

    def _drop_consumer(self, key: tuple) -> None:
        """A consumer left: its unacked deliveries go back for redelivery."""
        state = self._consumers.pop(key, None)
        if state is None:
            return
        sub = self._subs[(state["topic"], state["sub"])]
        sub.consumers.remove(key)
        back = sorted(i for i, k in sub.pending.items() if k == key)
        for i in back:
            del sub.pending[i]
        sub.redeliver = sorted(set(sub.redeliver) | set(back))

    async def _handle(self, conn: int, cmd: Message, payload: Optional[bytes], writer) -> None:
        t = cmd.type
        if t == pc.AUTH_RESPONSE:
            r = cmd.authResponse.response
            self.auth_responses.append((r.auth_method_name, bytes(r.auth_data)))
            return
        if t == pc.PONG:
            self.pongs += 1
            return
        if t == pc.PING:
            out = Message("BaseCommand", type=pc.PONG)
        elif t == pc.LOOKUP:
            self.lookups += 1
            lr = dict(request_id=cmd.lookupTopic.request_id, response=pc.LOOKUP_CONNECT)
            if self.redirect_to is not None:
                lr.update(response=pc.LOOKUP_REDIRECT,
                          brokerServiceUrl=f"pulsar://127.0.0.1:{self.redirect_to.port}")
            out = pc.command(pc.LOOKUP_RESPONSE, "lookupTopicResponse", **lr)
        elif t == pc.SUBSCRIBE:
            sub = cmd.subscribe
            self.subscriptions.append((sub.topic, sub.subscription, sub.subType))
            skey = (sub.topic, sub.subscription)
            if skey not in self._subs:
                start = 0 if sub.initialPosition == 1 else len(self.logs.get(sub.topic, []))
                self._subs[skey] = _Subscription(start)
            key = (conn, sub.consumer_id)
            self._consumers[key] = {"topic": sub.topic, "sub": sub.subscription,
                                    "permits": 0, "writer": writer}
            self._subs[skey].consumers.append(key)
            out = pc.command(pc.SUCCESS, "success", request_id=sub.request_id)
        elif t == pc.FLOW:
            state = self._consumers.get((conn, cmd.flow.consumer_id))
            if state is not None:
                state["permits"] += cmd.flow.messagePermits
                await self._deliver(self._subs[(state["topic"], state["sub"])], state["topic"])
            return
        elif t == pc.ACK:
            state = self._consumers.get((conn, cmd.ack.consumer_id))
            for mid in cmd.ack.message_id:
                self.acked.append((mid.ledgerId, mid.entryId, mid.batch_index))
                if state is not None:
                    sub = self._subs[(state["topic"], state["sub"])]
                    idx = self._entry_index.get(mid.entryId)
                    if idx is not None:
                        sub.acked.add(idx)
                        sub.pending.pop(idx, None)
            return
        elif t == pc.PRODUCER:
            self._producers[(conn, cmd.producer.producer_id)] = cmd.producer.topic
            out = pc.command(pc.PRODUCER_SUCCESS, "producer_success",
                             request_id=cmd.producer.request_id,
                             producer_name=f"fake-prod-{cmd.producer.producer_id}")
        elif t == pc.SEND:
            _meta, msgs = pc.decode_payload_section(payload)
            ids = dict(producer_id=cmd.send.producer_id, sequence_id=cmd.send.sequence_id)
            if self.fail_sends > 0:
                self.fail_sends -= 1
                out = pc.command(pc.SEND_ERROR, "send_error", error=2,
                                 message="injected failure", **ids)
            else:
                topic = self._producers.get((conn, cmd.send.producer_id),
                                            "persistent://public/default/t")
                entry = 0
                for m in msgs:
                    entry = self.append(topic, [m.payload], m.partition_key, batched=False)
                out = pc.command(pc.SEND_RECEIPT, "send_receipt",
                                 message_id=Message("MessageIdData", ledgerId=1, entryId=entry),
                                 **ids)
                writer.write(pc.encode_simple(out))
                await writer.drain()
                await self._deliver_all()
                return
        elif t in (pc.UNSUBSCRIBE, pc.CLOSE_PRODUCER, pc.CLOSE_CONSUMER):
            req = (cmd.unsubscribe if t == pc.UNSUBSCRIBE else
                   cmd.close_producer if t == pc.CLOSE_PRODUCER else cmd.close_consumer)
            if t == pc.CLOSE_CONSUMER:
                self._drop_consumer((conn, req.consumer_id))
            out = pc.command(pc.SUCCESS, "success", request_id=req.request_id)
        else:
            return
        writer.write(pc.encode_simple(out))
        await writer.drain()

    async def _deliver_all(self) -> None:
        for (topic, _name), sub in list(self._subs.items()):
            await self._deliver(sub, topic)

    async def _deliver(self, sub: _Subscription, topic: str) -> None:
        """Hand the subscription's next entries to its consumers with
        permits, redeliveries first."""
        log = self.logs.get(topic, [])
        for key in list(sub.consumers):
            state = self._consumers[key]
            while state["permits"] > 0:
                while sub.redeliver and sub.redeliver[0] in sub.acked:
                    sub.redeliver.pop(0)
                if sub.redeliver:
                    idx = sub.redeliver.pop(0)
                    sub.redeliveries[idx] = sub.redeliveries.get(idx, 0) + 1
                    self.redelivered += 1
                elif sub.next < len(log):
                    idx, sub.next = sub.next, sub.next + 1
                else:
                    break
                sub.pending[idx] = key
                state["permits"] -= 1
                state["writer"].write(self._message_frame(key[1], log[idx],
                                                          sub.redeliveries.get(idx, 0)))
                await state["writer"].drain()

    @staticmethod
    def _message_frame(consumer_id: int, entry: _Entry, redeliveries: int) -> bytes:
        cmd = pc.command(pc.MESSAGE, "message", consumer_id=consumer_id,
                         message_id=Message("MessageIdData", ledgerId=1,
                                            entryId=entry.entry_id),
                         redelivery_count=redeliveries)
        meta = Message("MessageMetadata", producer_name="fake", sequence_id=entry.entry_id,
                       publish_time=1)
        if entry.key:
            meta.partition_key = entry.key
        if not entry.batched:
            return pc.encode_payload_cmd(cmd, meta, entry.payloads[0])
        meta.num_messages_in_batch = len(entry.payloads)
        body = b""
        for p in entry.payloads:
            smm = Message("SingleMessageMetadata", payload_size=len(p)).encode()
            body += struct.pack(">I", len(smm)) + smm + p
        return pc.encode_payload_cmd(cmd, meta, body)


# -- HTTP sink -----------------------------------------------------------------


class HttpSink:
    """An HTTP/1.1 server that records every request as ``(method, target,
    headers, body)`` and answers with ``statuses`` in turn, then ``status``
    (a 2xx with an empty body; any other status with the text ``fail``).

        sink = HttpSink(statuses=[500], status=204)
        await sink.start()      # sink.port
    """

    def __init__(self, statuses: Optional[list[int]] = None, status: int = 200):
        self.statuses = list(statuses or [])
        self.status = status
        self.requests: list[tuple[str, str, dict, bytes]] = []
        #: the status each request was answered with
        self.answered: list[int] = []
        self._server = HttpServer(self._handle)
        self.port: Optional[int] = None

    @property
    def connections(self) -> int:
        return self._server.connections

    async def _handle(self, req: Request) -> Response:
        body = await req.read()
        self.requests.append((req.method, req.target, dict(req.headers), body))
        status = self.statuses.pop(0) if self.statuses else self.status
        self.answered.append(status)
        if 200 <= status < 300:
            return Response(status, b"", content_type=None)
        return Response.text(status, "fail")

    async def start(self) -> int:
        self.port = await self._server.start("127.0.0.1", 0)
        return self.port

    async def stop(self) -> None:
        await self._server.close()
