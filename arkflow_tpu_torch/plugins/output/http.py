"""HTTP client output: POST (or any method) each batch to an endpoint.

Counterpart of ``arkflow_tpu/plugins/output/http.py``, on the stdlib client
``utils/http1.HttpClient`` in place of aiohttp: one keep-alive connection,
``method``, ``headers``, bearer or basic ``auth`` (an ``Authorization``
header), a total ``timeout`` per request, and one request a batch (its
payloads joined by ``\\n``) or one a payload. Metadata columns are stripped
before encoding. A status of 400 or above raises
``WriteError("http output <status>: <text[:200]>")``, a request with no
complete response ``WriteError("http output failed: ...")``.

Config:

    type: http
    url: http://host:port/path
    method: POST
    headers: {X-Extra: "1"}
    auth: {type: bearer, token: "${TOKEN}"}
    timeout: 5s
    batch_body: true    # true: one request a batch (payloads joined by \\n)
    codec: json
"""

from __future__ import annotations

import base64
from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Output, Resource, register_output
from arkflow_tpu_torch.errors import ConfigError, WriteError
from arkflow_tpu_torch.plugins.codec.helper import build_codec, check_codec, encode_batch
from arkflow_tpu_torch.utils.auth import AuthConfig
from arkflow_tpu_torch.utils.duration import parse_duration
from arkflow_tpu_torch.utils.http1 import HttpClient, HttpClientError


class HttpOutput(Output):
    def __init__(self, url: str, method: str = "POST", headers: Optional[dict] = None,
                 timeout_s: float = 30.0, batch_body: bool = True, codec=None):
        self.url = url
        self.method = method
        self.headers = headers or {}
        self.timeout_s = timeout_s
        self.batch_body = batch_body
        self.codec = codec
        self._client: Optional[HttpClient] = None

    async def connect(self) -> None:
        self._client = HttpClient(timeout_s=self.timeout_s)

    async def write(self, batch: MessageBatch) -> None:
        if self._client is None:
            raise WriteError("http output not connected")
        payloads = encode_batch(batch.strip_metadata(), self.codec)
        bodies = [b"\n".join(payloads)] if self.batch_body else payloads
        for body in bodies:
            try:
                resp = await self._client.request(self.method, self.url, body, self.headers)
            except HttpClientError as e:
                raise WriteError(f"http output failed: {e}") from e
            if resp.status >= 400:
                raise WriteError(f"http output {resp.status}: {resp.text()[:200]}")

    async def close(self) -> None:
        if self._client is not None:
            await self._client.close()
            self._client = None


def _headers(config: dict) -> dict:
    headers = dict(config.get("headers") or {})
    auth = AuthConfig.from_config(config.get("auth"))
    if auth.kind == "bearer":
        headers["Authorization"] = f"Bearer {auth.token}"
    elif auth.kind == "basic":
        headers["Authorization"] = "Basic " + base64.b64encode(
            f"{auth.username}:{auth.password}".encode()).decode()
    return headers


def _check(config: dict) -> None:
    """JAX's builder's refusals, in its order."""
    if not config.get("url"):
        raise ConfigError("http output requires 'url'")
    _headers(config)
    parse_duration(config.get("timeout", 30))
    check_codec(config)


@register_output("http", keys=("url", "method", "headers", "auth", "timeout", "batch_body",
                               "codec"), check=_check)
def _build(config: dict, resource: Resource) -> HttpOutput:
    return HttpOutput(
        url=config["url"],
        method=str(config.get("method", "POST")).upper(),
        headers=_headers(config),
        timeout_s=parse_duration(config.get("timeout", 30)),
        batch_body=bool(config.get("batch_body", True)),
        codec=build_codec(config.get("codec"), resource),
    )
