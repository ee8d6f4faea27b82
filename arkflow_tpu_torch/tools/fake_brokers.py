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
- ``FakeRedisServer``: RESP2 AUTH, SELECT, LPUSH, RPUSH.
- ``FakeNatsServer``: INFO, CONNECT, PING, SUB, UNSUB, PUB with ``*`` and
  ``>`` wildcards.

    kafka = FakeKafkaBroker({"text-events": 4})
    await kafka.start()            # kafka.port
    ...
    await kafka.stop()
"""

from __future__ import annotations

import asyncio
import struct
from typing import Optional

from arkflow_tpu_torch.connect.kafka_client import Reader, Writer, decode_record_set


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


class FakeRedisServer(_Server):
    """RESP2 fake with lists."""

    def __init__(self):
        super().__init__()
        self.lists: dict[bytes, list] = {}

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

    async def _client(self, reader, writer) -> None:
        while True:
            args = await self._read_command(reader)
            if args is None:
                return
            cmd = args[0].upper()
            if cmd in (b"AUTH", b"SELECT"):
                writer.write(b"+OK\r\n")
            elif cmd in (b"LPUSH", b"RPUSH"):
                lst = self.lists.setdefault(args[1], [])
                if cmd == b"LPUSH":
                    lst.insert(0, args[2])
                else:
                    lst.append(args[2])
                writer.write(b":%d\r\n" % len(lst))
            else:
                writer.write(b"-ERR unknown command\r\n")
            await writer.drain()


# -- NATS ----------------------------------------------------------------------


class FakeNatsServer(_Server):
    """NATS core fake: subject routing with ``*`` and ``>`` wildcards."""

    def __init__(self):
        super().__init__()
        self.subs: list = []  # (writer, subject, sid)

    @staticmethod
    def _match(sub: str, subject: str) -> bool:
        if sub == subject:
            return True
        sp, tp = sub.split("."), subject.split(".")
        for i, s in enumerate(sp):
            if s == ">":
                return len(tp) > i
            if i >= len(tp) or (s != "*" and s != tp[i]):
                return False
        return len(sp) == len(tp)

    async def _client(self, reader, writer) -> None:
        writer.write(b'INFO {"server_id":"fake","max_payload":1048576,"headers":true}\r\n')
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
                    r = f" {reply}" if reply else ""
                    for w, sub, sid in self.subs:
                        if self._match(sub, subject):
                            w.write(f"MSG {subject} {sid}{r} {len(payload)}\r\n".encode()
                                    + payload + b"\r\n")
                            await w.drain()
                await writer.drain()
        finally:
            self.subs = [s for s in self.subs if s[0] is not writer]
