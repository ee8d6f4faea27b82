"""Minimal Redis client: RESP2 protocol over TCP.

Counterpart of ``arkflow_tpu/connect/redis_client.py``: command
serialisation, pub/sub push parsing, blocking list pops, and cluster mode
(``RedisClusterClient``: CRC16 slot routing, MOVED with a slot-map refresh,
ASK with a one-shot ASKING, per-slot MGET splits).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Callable, Optional

from arkflow_tpu_torch.errors import ConnectError, Disconnection, ReadError

logger = logging.getLogger("arkflow_torch.redis")


def encode_command(*args: bytes | str | int | float) -> bytes:
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, str):
            a = a.encode()
        elif isinstance(a, (int, float)):
            a = str(a).encode()
        out.append(b"$%d\r\n%s\r\n" % (len(a), a))
    return b"".join(out)


class RedisError(ReadError):
    pass


class RedisClient:
    def __init__(self, url: str = "redis://127.0.0.1:6379", password: Optional[str] = None,
                 db: int = 0):
        addr = url.split("://", 1)[-1]
        if "@" in addr:
            cred, addr = addr.rsplit("@", 1)
            if ":" in cred and password is None:
                password = cred.split(":", 1)[1]
        host, _, rest = addr.partition(":")
        port_s, _, db_s = rest.partition("/")
        self.host = host or "127.0.0.1"
        self.port = int(port_s or 6379)
        self.db = int(db_s) if db_s else db
        self.password = password
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._lock = asyncio.Lock()

    async def connect(self, timeout: float = 5.0) -> None:
        try:
            self._reader, self._writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port), timeout
            )
        except (OSError, asyncio.TimeoutError) as e:
            raise ConnectError(f"redis connect to {self.host}:{self.port} failed: {e}") from e
        if self.password:
            await self.command("AUTH", self.password)
        if self.db:
            await self.command("SELECT", self.db)

    async def _read_reply(self) -> Any:
        line = await self._reader.readline()
        if not line:
            raise Disconnection("redis connection closed")
        kind, rest = line[:1], line[1:-2]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RedisError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n < 0:
                return None
            data = await self._reader.readexactly(n + 2)
            return data[:-2]
        if kind == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [await self._read_reply() for _ in range(n)]
        raise RedisError(f"unexpected RESP type {kind!r}")

    async def command(self, *args) -> Any:
        """Send one command and await its reply (serialised)."""
        async with self._lock:
            self._writer.write(encode_command(*args))
            await self._writer.drain()
            return await self._read_reply()

    async def asking_command(self, *args) -> Any:
        """ASKING + command pipelined under ONE lock hold, so a concurrent
        command cannot interleave and consume the one-shot ASK grant."""
        async with self._lock:
            self._writer.write(encode_command("ASKING") + encode_command(*args))
            await self._writer.drain()
            await self._read_reply()  # +OK for ASKING
            return await self._read_reply()

    # -- engine-facing helpers ----------------------------------------------

    async def mget(self, keys: list) -> list:
        if not keys:
            return []
        return await self.command("MGET", *keys)

    async def lrange(self, key, start: int = 0, stop: int = -1) -> list:
        return await self.command("LRANGE", key, start, stop)

    async def publish(self, channel, payload: bytes) -> int:
        return await self.command("PUBLISH", channel, payload)

    async def lpush(self, key, payload: bytes) -> int:
        return await self.command("LPUSH", key, payload)

    async def rpush(self, key, payload: bytes) -> int:
        return await self.command("RPUSH", key, payload)

    async def blpop(self, keys: list, timeout_s: float = 1.0) -> Optional[tuple[bytes, bytes]]:
        res = await self.command("BLPOP", *keys, int(max(1, timeout_s)))
        if res is None:
            return None
        return res[0], res[1]

    async def subscribe_loop(self, channels: list, patterns: list,
                             cb: Callable[[bytes, bytes], None]) -> None:
        """Enter pub/sub mode and dispatch messages until cancelled.

        The connection is dedicated to pub/sub from this point (RESP rule).
        """
        async with self._lock:
            if channels:
                self._writer.write(encode_command("SUBSCRIBE", *channels))
            if patterns:
                self._writer.write(encode_command("PSUBSCRIBE", *patterns))
            await self._writer.drain()
            while True:
                reply = await self._read_reply()
                if not isinstance(reply, list) or not reply:
                    continue
                kind = reply[0]
                if kind == b"message" and len(reply) == 3:
                    cb(reply[1], reply[2])
                elif kind == b"pmessage" and len(reply) == 4:
                    cb(reply[2], reply[3])
                # (p)subscribe acks ignored

    async def close(self) -> None:
        if self._writer is not None:
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except Exception:
                pass
            self._writer = None
            self._reader = None


# -- cluster mode -----------------------------------------------------------

def crc16_xmodem(data: bytes) -> int:
    """CRC16/XMODEM (poly 0x1021, init 0) — the redis cluster key hash."""
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) if crc & 0x8000 else crc << 1
            crc &= 0xFFFF
    return crc


def key_slot(key: bytes | str) -> int:
    """Cluster slot for a key, honoring {hash tag} sub-selection."""
    if isinstance(key, str):
        key = key.encode()
    start = key.find(b"{")
    if start >= 0:
        end = key.find(b"}", start + 1)
        if end > start + 1:  # non-empty tag
            key = key[start + 1:end]
    return crc16_xmodem(key) % 16384


class RedisClusterClient:
    """Cluster-aware client: slot routing + MOVED/ASK redirection.

    Duck-types RedisClient's helper API so the redis input/output/temporary
    components work unchanged (ref: crates/arkflow-plugin/src/component/
    redis.rs:23-90 — single vs cluster connection enum). Keyed commands
    route by CRC16 slot; MOVED refreshes the slot map and retries; ASK
    forwards once with ASKING. Pub/sub and cross-slot MGET are handled the
    way the redis crate does: any-node subscribe, per-slot MGET splits.
    """

    MAX_REDIRECTS = 5

    def __init__(self, urls: list[str], password: Optional[str] = None):
        if not urls:
            raise ConnectError("redis cluster needs at least one node url")
        self.urls = list(urls)
        self.password = password
        self._nodes: dict[tuple[str, int], RedisClient] = {}
        self._pubsub_clients: list[RedisClient] = []
        self._connect_lock: Optional[asyncio.Lock] = None
        #: sorted [(start_slot, end_slot, (host, port))]
        self._slots: list[tuple[int, int, tuple[str, int]]] = []

    async def connect(self, timeout: float = 5.0) -> None:
        last: Optional[Exception] = None
        for url in self.urls:
            seed = RedisClient(url, password=self.password)
            try:
                await seed.connect(timeout)
                self._nodes[(seed.host, seed.port)] = seed
                await self._refresh_slots(seed)
                return
            except (ConnectError, RedisError, OSError, Disconnection) as e:
                last = e
                await seed.close()
        raise ConnectError(f"redis cluster: no reachable node: {last}")

    async def _refresh_slots(self, via: Optional[RedisClient] = None) -> None:
        client = via or next(iter(self._nodes.values()))
        raw = await client.command("CLUSTER", "SLOTS")
        slots: list[tuple[int, int, tuple[str, int]]] = []
        for entry in raw or []:
            start, end, master = int(entry[0]), int(entry[1]), entry[2]
            host = master[0].decode() if isinstance(master[0], bytes) else str(master[0])
            slots.append((start, end, (host, int(master[1]))))
        if not slots:
            raise ConnectError("redis cluster: empty CLUSTER SLOTS")
        self._slots = sorted(slots)

    async def _node(self, addr: tuple[str, int]) -> RedisClient:
        client = self._nodes.get(addr)
        if client is not None and client._writer is not None:
            return client
        # serialize new-node connects: concurrent per-slot fans (mget) must
        # not both open and one leak a connection to the same address
        if self._connect_lock is None:
            self._connect_lock = asyncio.Lock()
        async with self._connect_lock:
            client = self._nodes.get(addr)
            if client is not None and client._writer is not None:
                return client
            client = RedisClient(f"redis://{addr[0]}:{addr[1]}", password=self.password)
            await client.connect()
            self._nodes[addr] = client
            return client

    def _addr_for_slot(self, slot: int) -> tuple[str, int]:
        for start, end, addr in self._slots:
            if start <= slot <= end:
                return addr
        raise RedisError(f"redis cluster: no node covers slot {slot}")

    async def command_key(self, key, *args) -> Any:
        """Run a command routed by ``key``, following MOVED/ASK."""
        slot = key_slot(key)
        addr = self._addr_for_slot(slot)
        asking = False
        for _ in range(self.MAX_REDIRECTS):
            client = await self._node(addr)
            try:
                if asking:
                    asking = False
                    return await client.asking_command(*args)
                return await client.command(*args)
            except RedisError as e:
                msg = str(e)
                if msg.startswith("MOVED "):
                    _, _, hp = msg.split(" ")
                    host, _, port = hp.rpartition(":")
                    addr = (host, int(port))
                    await self._refresh_slots(await self._node(addr))
                elif msg.startswith("ASK "):
                    _, _, hp = msg.split(" ")
                    host, _, port = hp.rpartition(":")
                    addr = (host, int(port))
                    asking = True
                else:
                    raise
        raise RedisError("redis cluster: too many redirects")

    # -- RedisClient-compatible helpers --

    async def mget(self, keys: list) -> list:
        """Cross-slot MGET: split per slot (fetched concurrently), preserve
        order."""
        if not keys:
            return []
        out: list = [None] * len(keys)
        by_slot: dict[int, list[int]] = {}
        for i, k in enumerate(keys):
            by_slot.setdefault(key_slot(k), []).append(i)

        async def one(idxs: list[int]) -> tuple[list[int], list]:
            vals = await self.command_key(keys[idxs[0]], "MGET",
                                          *[keys[i] for i in idxs])
            return idxs, vals or []

        for idxs, vals in await asyncio.gather(*(one(ix) for ix in by_slot.values())):
            for i, v in zip(idxs, vals):
                out[i] = v
        return out

    async def lrange(self, key, start: int = 0, stop: int = -1) -> list:
        return await self.command_key(key, "LRANGE", key, start, stop)

    async def publish(self, channel, payload: bytes) -> int:
        # pub/sub is cluster-wide; any node accepts the publish
        client = await self._node(self._slots[0][2])
        return await client.publish(channel, payload)

    async def lpush(self, key, payload: bytes) -> int:
        return await self.command_key(key, "LPUSH", key, payload)

    async def rpush(self, key, payload: bytes) -> int:
        return await self.command_key(key, "RPUSH", key, payload)

    async def blpop(self, keys: list, timeout_s: float = 1.0) -> Optional[tuple[bytes, bytes]]:
        check_same_slot(keys, what="cluster BLPOP")
        res = await self.command_key(keys[0], "BLPOP", *keys, int(max(1, timeout_s)))
        if res is None:
            return None
        return res[0], res[1]

    async def subscribe_loop(self, channels: list, patterns: list, cb) -> None:
        # dedicate a fresh connection on any node (messages propagate
        # cluster-wide over the bus)
        addr = self._slots[0][2]
        client = RedisClient(f"redis://{addr[0]}:{addr[1]}", password=self.password)
        await client.connect()
        self._pubsub_clients.append(client)
        await client.subscribe_loop(channels, patterns, cb)

    async def close(self) -> None:
        for client in list(self._nodes.values()) + self._pubsub_clients:
            await client.close()
        self._nodes.clear()
        self._pubsub_clients.clear()


def check_same_slot(keys: list, what: str = "multi-key command") -> None:
    """Multi-key ops must hash to ONE cluster slot; diagnose early with a
    hash-tag hint instead of a raw server-side CROSSSLOT error."""
    from arkflow_tpu_torch.errors import ConfigError

    slots = {key_slot(k) for k in keys}
    if len(slots) > 1:
        raise ConfigError(
            f"{what} requires all keys in one cluster slot; got slots "
            f"{sorted(slots)} for {list(keys)!r} — use a shared {{hash-tag}}")


def make_redis_client(config: dict):
    """Single-node or cluster client from connector config.

    ``cluster: true`` + ``urls: [...]`` (or a comma-separated ``url``)
    selects cluster mode.
    """
    password = config.get("password")
    if password is not None:
        from arkflow_tpu_torch.utils.auth import resolve_secret

        password = resolve_secret(str(password))
    if config.get("cluster"):
        urls = config.get("urls") or [
            u.strip() for u in str(config.get("url", "")).split(",") if u.strip()
        ]
        return RedisClusterClient([str(u) for u in urls], password=password)
    return RedisClient(str(config.get("url", "redis://127.0.0.1:6379")),
                       password=password)
