"""Redis input: pub/sub channels and patterns, or BLPOP list mode.

Counterpart of ``arkflow_tpu/plugins/input/redis.py``. Subscribe mode runs
the client's subscribe loop in a task that puts each message into a
bounded queue (1000; a message arriving at a full queue is dropped, as the
JAX input drops it) and a read returns one message stamped
``__meta_source: redis`` and ``__meta_ext_channel``; list mode BLPOPs the
keys with a 1 s timeout and stamps ``__meta_key``. A lost connection raises
``Disconnection`` for the stream's reconnect loop. Cluster mode
(``cluster: true`` with ``urls``) routes keyed commands by slot; a list
input's BLPOP keys must share one slot, checked at build.

Config:

    type: redis
    url: redis://127.0.0.1:6379
    mode: subscribe              # subscribe | list
    channels: [events]           # subscribe mode
    patterns: ["sensor.*"]       # subscribe mode
    keys: [queue1]               # list mode (BLPOP)
    codec: json
"""

from __future__ import annotations

import asyncio
from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Ack, Input, NoopAck, Resource, register_input
from arkflow_tpu_torch.connect.redis_client import (RedisClient, check_same_slot,
                                                    make_redis_client)
from arkflow_tpu_torch.errors import ConfigError, Disconnection, EndOfInput
from arkflow_tpu_torch.plugins.codec.helper import build_codec, check_codec, decode_payloads

#: messages a subscription holds between reads before it drops
QUEUE_BOUND = 1000


def _check_mode(mode: str, channels: list, patterns: list, keys: list) -> None:
    if mode not in ("subscribe", "list"):
        raise ConfigError(f"redis input mode must be subscribe|list, got {mode!r}")
    if mode == "subscribe" and not (channels or patterns):
        raise ConfigError("redis subscribe mode requires 'channels' or 'patterns'")
    if mode == "list" and not keys:
        raise ConfigError("redis list mode requires 'keys'")


class RedisInput(Input):
    def __init__(self, url: str, mode: str, channels: list, patterns: list,
                 keys: list, codec=None, password: Optional[str] = None,
                 client_config: Optional[dict] = None):
        _check_mode(mode, channels, patterns, keys)
        self.url = url
        self.mode = mode
        self.channels = channels
        self.patterns = patterns
        self.keys = keys
        self.codec = codec
        # list mode pulls (BLPOP): the backlog stays on the server. Pub/sub
        # has none, so pausing would only pile messages into the queue.
        self.pause_on_overload = mode == "list"
        # client_config is the single source of connection truth (url,
        # password, cluster, urls); the bare params serve direct construction
        self.client_config = client_config or {"url": url, "password": password}
        self._client: Optional[RedisClient] = None
        self._queue: Optional[asyncio.Queue] = None
        self._task: Optional[asyncio.Task] = None
        self._closed = False

    async def connect(self) -> None:
        self._client = make_redis_client(self.client_config)
        await self._client.connect()
        if self.mode == "subscribe":
            self._queue = asyncio.Queue(maxsize=QUEUE_BOUND)

            def on_msg(channel: bytes, payload: bytes) -> None:
                try:
                    self._queue.put_nowait((channel, payload))
                except asyncio.QueueFull:
                    pass  # dropped under overload, like a slow pub/sub consumer

            self._task = asyncio.create_task(self._pump(on_msg))

    async def _pump(self, on_msg) -> None:
        try:
            await self._client.subscribe_loop(self.channels, self.patterns, on_msg)
        except asyncio.CancelledError:
            raise
        except Exception:
            if self._queue is not None:
                try:
                    self._queue.put_nowait(None)
                except asyncio.QueueFull:
                    pass

    async def read(self) -> tuple[MessageBatch, Ack]:
        if self._closed:
            raise EndOfInput()
        if self.mode == "subscribe":
            item = await self._queue.get()
            if item is None:
                if self._closed:
                    raise EndOfInput()
                raise Disconnection("redis pub/sub connection lost")
            channel, payload = item
            batch = decode_payloads([payload], self.codec)
            return (
                batch.with_source("redis")
                .with_ext_metadata({"channel": channel.decode("utf-8", "replace")})
                .with_ingest_time(),
                NoopAck(),
            )
        while not self._closed:
            try:
                res = await self._client.blpop(self.keys, timeout_s=1.0)
            except Exception as e:
                raise Disconnection(f"redis blpop failed: {e}") from e
            if res is None:
                continue
            key, payload = res
            batch = decode_payloads([payload], self.codec)
            return batch.with_source("redis").with_key(key).with_ingest_time(), NoopAck()
        raise EndOfInput()

    async def close(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
        if self._queue is not None:
            try:
                self._queue.put_nowait(None)
            except asyncio.QueueFull:
                pass
        if self._client is not None:
            await self._client.close()


def _lists(config: dict) -> tuple[list, list, list]:
    return (list(config.get("channels") or []), list(config.get("patterns") or []),
            list(config.get("keys") or []))


def _check(config: dict) -> None:
    """JAX's builder's refusals, in its order, without connecting."""
    channels, patterns, keys = _lists(config)
    if config.get("cluster") and config.get("mode") == "list" and len(keys) > 1:
        check_same_slot(keys, what="redis cluster list input (BLPOP)")
    check_codec(config)
    _check_mode(str(config.get("mode", "subscribe")), channels, patterns, keys)


@register_input("redis", keys=("url", "urls", "cluster", "password", "mode", "channels",
                               "patterns", "keys", "codec"), check=_check)
def _build(config: dict, resource: Resource) -> RedisInput:
    channels, patterns, keys = _lists(config)
    return RedisInput(
        url=str(config.get("url", "redis://127.0.0.1:6379")),
        mode=str(config.get("mode", "subscribe")),
        channels=channels,
        patterns=patterns,
        keys=keys,
        codec=build_codec(config.get("codec"), resource),
        password=config.get("password"),
        client_config=config,
    )
