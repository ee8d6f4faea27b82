"""HTTP server input: POST payloads become stream messages.

Counterpart of ``arkflow_tpu/plugins/input/http.py`` on the port's stdlib
HTTP/1.1 server (``utils/http1.py``) in place of aiohttp: POSTs on
``path`` land in a bounded queue (``QUEUE_BOUND``), with optional
Basic/Bearer auth, token-bucket rate limiting and CORS headers. Keep-alive,
chunked bodies and the 1 MiB body limit are aiohttp's defaults. The answers
are the JAX input's, in its order:

- 404 on another path, 405 on another method (``OPTIONS`` too, without
  ``cors``), as aiohttp's router gives them;
- 401 when auth is on and the credentials fail;
- 429 ``rate limited`` with ``Retry-After`` past the bucket;
- 413 past the body limit;
- 503 ``queue full`` past ``QUEUE_BOUND``;
- 200 ``ok``; 204 for ``OPTIONS`` with ``cors``.

Config:

    type: http
    host: 127.0.0.1
    port: 8070                  # 0 picks a free port (``HttpInput.port``)
    path: /ingest
    codec: json                 # optional
    auth: {type: basic, username: u, password: "${HTTP_PW}"}
    rate_limit: {capacity: 100, per_second: 50}
    cors: true

Tenants are not ported: the port stamps no ``__meta_ext_tenant``, where the
JAX input stamps the ``X-Arkflow-Tenant`` header's value (or, with basic
auth on, the username). ``tenant_header`` other than ``false`` raises "not
yet ported", and so does the stream's ``overload`` key that carries the
per-tenant quotas.
"""

from __future__ import annotations

import asyncio
import math
from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Ack, Input, NoopAck, Resource, register_input
from arkflow_tpu_torch.errors import ConfigError, EndOfInput, not_ported
from arkflow_tpu_torch.plugins.codec.helper import build_codec, check_codec, decode_payloads
from arkflow_tpu_torch.utils.auth import AuthConfig, Authenticator
from arkflow_tpu_torch.utils.http1 import HttpServer, Request, Response
from arkflow_tpu_torch.utils.rate_limiter import TokenBucket

QUEUE_BOUND = 1000  # the reference's flume bound


class HttpInput(Input):
    def __init__(self, host: str, port: int, path: str, codec=None,
                 auth: Optional[Authenticator] = None,
                 limiter: Optional[TokenBucket] = None, cors: bool = False):
        self.host = host
        self.port = port
        self.path = path
        self.codec = codec
        self.auth = auth
        self.limiter = limiter
        self.cors = cors
        self._queue: Optional[asyncio.Queue] = None
        self._server: Optional[HttpServer] = None
        self._closed = False

    async def connect(self) -> None:
        self._queue = asyncio.Queue(maxsize=QUEUE_BOUND)
        self._server = HttpServer(self._handle)
        self.port = await self._server.start(self.host, self.port)

    def _cors_headers(self) -> dict:
        if not self.cors:
            return {}
        return {
            "Access-Control-Allow-Origin": "*",
            "Access-Control-Allow-Methods": "POST, OPTIONS",
            "Access-Control-Allow-Headers": "Authorization, Content-Type",
        }

    @staticmethod
    def _retry_after(seconds: float) -> dict:
        # Retry-After is delta-seconds, integer, >= 1 (RFC 9110 §10.2.3);
        # an unsatisfiable deficit (inf) caps at an hour rather than lying
        if not math.isfinite(seconds):
            seconds = 3600.0
        return {"Retry-After": str(max(1, math.ceil(seconds)))}

    async def _handle(self, req: Request) -> Response:
        if req.path != self.path:
            return Response.text(404, "404: Not Found")
        if req.method == "OPTIONS" and self.cors:
            return Response(204, content_type=None, headers=self._cors_headers())
        if req.method != "POST":
            allow = "OPTIONS,POST" if self.cors else "POST"
            return Response.text(405, "405: Method Not Allowed", {"Allow": allow})
        cors = self._cors_headers()
        if self.auth is not None and not self.auth.check(req.headers.get("authorization"),
                                                         req.remote or "?"):
            return Response(401, content_type=None, headers=cors)
        if self.limiter is not None and not self.limiter.try_acquire():
            return Response.text(429, "rate limited",
                                 {**cors, **self._retry_after(self.limiter.time_until(1.0))})
        body = await req.read()  # 413 past the body limit
        try:
            self._queue.put_nowait(body)
        except asyncio.QueueFull:
            return Response.text(503, "queue full", cors)
        return Response.text(200, "ok", cors)

    async def read(self) -> tuple[MessageBatch, Ack]:
        if self._closed:
            raise EndOfInput()
        payload = await self._queue.get()
        if payload is None:
            raise EndOfInput()
        batch = decode_payloads([payload], self.codec)
        return batch.with_source("http").with_ingest_time(), NoopAck()

    async def close(self) -> None:
        self._closed = True
        if self._queue is not None:
            try:
                self._queue.put_nowait(None)
            except asyncio.QueueFull:
                pass
        if self._server is not None:
            await self._server.close()
            self._server = None


def _check(config: dict) -> None:
    if config.get("port") is None:
        raise ConfigError("http input requires 'port'")
    tenant_header = config.get("tenant_header")
    if tenant_header is not None and tenant_header is not False:
        if not isinstance(tenant_header, str) or not tenant_header:
            raise ConfigError(
                f"http input tenant_header must be a header name or false, "
                f"got {tenant_header!r}")
        raise not_ported("http input key 'tenant_header' (multi-tenancy)")
    AuthConfig.from_config(config.get("auth"))
    _limiter(config)
    check_codec(config)


def _limiter(config: dict) -> Optional[TokenBucket]:
    rl = config.get("rate_limit")
    if not rl:
        return None
    return TokenBucket(int(rl.get("capacity", 100)), float(rl.get("per_second", 100)))


@register_input("http", keys=("host", "port", "path", "codec", "auth", "rate_limit", "cors",
                              "tenant_header"), check=_check)
def _build(config: dict, resource: Resource) -> HttpInput:
    auth_cfg = AuthConfig.from_config(config.get("auth"))
    return HttpInput(
        host=str(config.get("host", "0.0.0.0")),
        port=int(config["port"]),
        path=str(config.get("path", "/")),
        codec=build_codec(config.get("codec"), resource),
        auth=Authenticator(auth_cfg) if auth_cfg.kind != "none" else None,
        limiter=_limiter(config),
        cors=bool(config.get("cors", False)),
    )
