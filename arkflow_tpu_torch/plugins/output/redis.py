"""Redis output: PUBLISH or list push to a channel or key.

Counterpart of ``arkflow_tpu/plugins/output/redis.py``, single node or
cluster (``cluster: true`` with ``urls``, routed by key slot).

Config:

    type: redis
    url: redis://127.0.0.1:6379
    mode: publish               # publish | lpush | rpush
    target: results             # channel/key; literal or {value: ...}
    codec: json

An ``{expr: ...}`` target is evaluated on the batch, its first row.
"""

from __future__ import annotations

from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Output, Resource, register_output
from arkflow_tpu_torch.connect.redis_client import RedisClient, make_redis_client
from arkflow_tpu_torch.errors import ConfigError, WriteError
from arkflow_tpu_torch.plugins.codec.helper import build_codec, check_codec, encode_batch
from arkflow_tpu_torch.utils.expr import DynValue, check_dyn_value


class RedisOutput(Output):
    def __init__(self, url: str, mode: str, target: DynValue, codec=None,
                 password: Optional[str] = None,
                 client_config: Optional[dict] = None):
        if mode not in ("publish", "lpush", "rpush"):
            raise ConfigError(f"redis output mode must be publish|lpush|rpush, got {mode!r}")
        self.url = url
        self.mode = mode
        self.target = target
        self.codec = codec
        # client_config is the single source of connection truth (url/
        # password/cluster/urls); the bare params exist for direct construction
        self.client_config = client_config or {"url": url, "password": password}
        self._client: Optional[RedisClient] = None

    async def connect(self) -> None:
        self._client = make_redis_client(self.client_config)
        await self._client.connect()

    async def write(self, batch: MessageBatch) -> None:
        if self._client is None:
            raise WriteError("redis output not connected")
        target = str(self.target.eval_scalar(batch))
        payloads = encode_batch(batch.strip_metadata(), self.codec)
        try:
            for p in payloads:
                if self.mode == "publish":
                    await self._client.publish(target, p)
                elif self.mode == "lpush":
                    await self._client.lpush(target, p)
                else:
                    await self._client.rpush(target, p)
        except Exception as e:
            raise WriteError(f"redis output failed: {e}") from e

    async def close(self) -> None:
        if self._client is not None:
            await self._client.close()


def _target(config: dict):
    return config.get("target") or config.get("channel") or config.get("key")


def _check(config: dict) -> None:
    target = _target(config)
    if not target:
        raise ConfigError("redis output requires 'target'")
    mode = str(config.get("mode", "publish"))
    if mode not in ("publish", "lpush", "rpush"):
        raise ConfigError(f"redis output mode must be publish|lpush|rpush, got {mode!r}")
    check_dyn_value(target, "target")
    check_codec(config)


@register_output("redis", keys=("url", "urls", "cluster", "password", "mode", "target",
                                "channel", "key", "codec"), check=_check)
def _build(config: dict, resource: Resource) -> RedisOutput:
    return RedisOutput(
        url=str(config.get("url", "redis://127.0.0.1:6379")),
        mode=str(config.get("mode", "publish")),
        target=DynValue.from_config(_target(config), "target"),
        codec=build_codec(config.get("codec"), resource),
        password=config.get("password"),
        client_config=config,
    )
