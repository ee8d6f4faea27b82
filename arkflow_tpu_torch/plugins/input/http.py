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
- 429 with ``Retry-After`` (delta-seconds, at least 1) from
  ``_check_admission``, in this order: ``overloaded`` while the stream's
  overload controller sheds with a full window (the drain estimate), then
  ``tenant quota exceeded`` while the request's tenant bucket is short (its
  own ``time_until``, checked without spending: the batch pays at stream
  admission), then ``rate limited`` past the rate limiter's bucket;
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
    tenant_header: X-Tenant-Id  # the header whose value is stamped into
                                # __meta_ext_tenant (default
                                # X-Arkflow-Tenant); without it and with auth
                                # on, the auth subject (the basic-auth
                                # username); `false` turns both off
"""

from __future__ import annotations

import asyncio
import math
from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Ack, Input, NoopAck, Resource, register_input
from arkflow_tpu_torch.errors import ConfigError, EndOfInput, Overloaded
from arkflow_tpu_torch.plugins.codec.helper import build_codec, check_codec, decode_payloads
from arkflow_tpu_torch.utils.auth import AuthConfig, Authenticator
from arkflow_tpu_torch.utils.http1 import HttpServer, Request, Response
from arkflow_tpu_torch.utils.rate_limiter import TokenBucket

QUEUE_BOUND = 1000  # the reference's flume bound
DEFAULT_TENANT_HEADER = "X-Arkflow-Tenant"


class HttpInput(Input):
    def __init__(self, host: str, port: int, path: str, codec=None,
                 auth: Optional[Authenticator] = None,
                 limiter: Optional[TokenBucket] = None, cors: bool = False,
                 tenant_header: Optional[str] = DEFAULT_TENANT_HEADER):
        self.host = host
        self.port = port
        self.path = path
        self.codec = codec
        self.auth = auth
        self.limiter = limiter
        self.cors = cors
        #: the header stamped into ``__meta_ext_tenant`` (None: no tenants)
        self.tenant_header = tenant_header
        self._queue: Optional[asyncio.Queue] = None
        self._server: Optional[HttpServer] = None
        self._closed = False
        #: the stream's overload controller: a push server cannot pause its
        #: clients, so it sheds at the socket with 429
        self._overload = None

    def attach_overload_controller(self, controller) -> None:
        self._overload = controller

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

    def _tenant_of(self, req: Request) -> Optional[str]:
        """The request's tenant: the configured header, else the auth
        subject when auth is on, else None. ``tenant_header: false`` turns
        off both."""
        if self.tenant_header is None:
            return None
        t = req.headers.get(self.tenant_header.lower())
        if t:
            return t
        if self.auth is not None:
            return self.auth.subject()
        return None

    def _check_admission(self, tenant: Optional[str] = None) -> None:
        """Raise ``Overloaded`` when the request must be answered 429: the
        engine's overload first (so the rejection spends none of the
        client's rate-limit tokens), then the tenant's quota for one row,
        checked without spending, then the rate limiter."""
        if self._overload is not None:
            if self._overload.should_reject():
                raise Overloaded("overloaded", retry_after_s=self._overload.retry_after_s())
            wait = self._overload.quota_retry_after_s(tenant)
            if wait > 0:
                raise Overloaded("tenant quota exceeded", retry_after_s=wait)
        if self.limiter is not None and not self.limiter.try_acquire():
            raise Overloaded("rate limited", retry_after_s=self.limiter.time_until(1.0))

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
        tenant = self._tenant_of(req)
        try:
            self._check_admission(tenant)
        except Overloaded as e:
            return Response.text(429, str(e), {**cors, **self._retry_after(e.retry_after_s)})
        body = await req.read()  # 413 past the body limit
        try:
            self._queue.put_nowait((body, tenant))
        except asyncio.QueueFull:
            return Response.text(503, "queue full", cors)
        return Response.text(200, "ok", cors)

    async def read(self) -> tuple[MessageBatch, Ack]:
        if self._closed:
            raise EndOfInput()
        item = await self._queue.get()
        if item is None:
            raise EndOfInput()
        payload, tenant = item
        batch = decode_payloads([payload], self.codec).with_source("http").with_ingest_time()
        if tenant is not None:
            batch = batch.with_tenant(tenant)
        return batch, NoopAck()

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
    _tenant_header(config)
    AuthConfig.from_config(config.get("auth"))
    _limiter(config)
    check_codec(config)


def _tenant_header(config: dict) -> Optional[str]:
    tenant_header = config.get("tenant_header", DEFAULT_TENANT_HEADER)
    if tenant_header is False or tenant_header is None:
        return None  # the opt-out
    if not isinstance(tenant_header, str) or not tenant_header:
        raise ConfigError(
            f"http input tenant_header must be a header name or false, "
            f"got {tenant_header!r}")
    return tenant_header


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
        tenant_header=_tenant_header(config),
    )
