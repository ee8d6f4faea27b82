"""Redis Temporary: MGET / LRANGE lookups for SQL enrichment.

Counterpart of ``arkflow_tpu/plugins/temporary/redis.py``: the evaluated
key values become Redis keys (``str(key)``, nulls skipped, duplicates once,
``key_prefix`` in front); the values found decode through ``codec`` into
the enrichment table's rows. ``mode: get`` is one MGET (absent keys give no
row), ``mode: list`` one LRANGE a key, in key order. The component's config
is the single source of connection settings (``url``, ``password``,
``cluster``, ``urls``), read by ``make_redis_client``.

    type: redis
    url: redis://127.0.0.1:6379
    mode: get              # get (MGET) | list (LRANGE per key)
    key_prefix: "device:"
    codec: json
"""

from __future__ import annotations

from typing import Optional, Sequence

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Resource, Temporary, register_temporary
from arkflow_tpu_torch.connect.redis_client import make_redis_client
from arkflow_tpu_torch.errors import ConfigError, ReadError
from arkflow_tpu_torch.plugins.codec.helper import build_codec, check_codec, decode_payloads


class RedisTemporary(Temporary):
    def __init__(self, url: str, mode: str, key_prefix: str = "", codec=None,
                 password: Optional[str] = None, client_config: Optional[dict] = None):
        if mode not in ("get", "list"):
            raise ConfigError(f"redis temporary mode must be get|list, got {mode!r}")
        self.url = url
        self.mode = mode
        self.key_prefix = key_prefix
        self.codec = codec
        self.client_config = client_config or {"url": url, "password": password}
        self._client = None

    async def connect(self) -> None:
        self._client = make_redis_client(self.client_config)
        await self._client.connect()

    async def get(self, keys: Sequence[object]) -> MessageBatch:
        if self._client is None:
            raise ReadError("redis temporary not connected")
        uniq = list(dict.fromkeys(str(k) for k in keys if k is not None))
        full_keys = [self.key_prefix + k for k in uniq]
        payloads: list[bytes] = []
        if self.mode == "get":
            values = await self._client.mget(full_keys)
            payloads = [v for v in values if v is not None]
        else:
            for k in full_keys:
                values = await self._client.lrange(k)
                payloads.extend(v for v in values if v is not None)
        if not payloads:
            return MessageBatch.empty()
        return decode_payloads(payloads, self.codec)

    async def close(self) -> None:
        if self._client is not None:
            await self._client.close()


@register_temporary("redis", keys=("url", "urls", "cluster", "password", "mode",
                                   "key_prefix", "codec"), check=check_codec)
def _build(config: dict, resource: Resource) -> RedisTemporary:
    return RedisTemporary(
        url=str(config.get("url", "redis://127.0.0.1:6379")),
        mode=str(config.get("mode", "get")),
        key_prefix=str(config.get("key_prefix", "")),
        codec=build_codec(config.get("codec"), resource),
        password=config.get("password"),
        client_config=config,
    )
