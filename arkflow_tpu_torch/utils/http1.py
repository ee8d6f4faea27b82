"""A small HTTP/1.1 server and client on ``asyncio`` streams (standard
library only).

The server is shared by the engine's health server (``runtime/engine.py``)
and the HTTP input (``plugins/input/http.py``), the client (``HttpClient``,
the port's stand-in for ``aiohttp.ClientSession``) by the HTTP and InfluxDB
outputs; the card's machine has no aiohttp, and the port imports none.
``serve_connection`` reads requests off one connection in turn and writes
each handler's response:

- the head is read up to ``MAX_HEAD`` bytes; a body is framed by
  ``Content-Length`` or ``Transfer-Encoding: chunked`` and read only when
  the handler asks (``await request.read()``), up to ``max_body`` bytes
  (aiohttp's default ``client_max_size``, 1 MiB), past which ``read``
  raises ``HttpError(413)``;
- persistent connections: an HTTP/1.1 request keeps the connection open
  unless it sends ``Connection: close``, an HTTP/1.0 one only when it sends
  ``Connection: keep-alive``. A server that keeps a connection open only
  when asked (``persistent_default=False``) answers a request without the
  header with ``Connection: close``. An unread body is drained before the
  next request; a body that could not be drained (an overrun, a malformed
  chunk) closes the connection;
- a malformed head answers 400 and closes.

``HttpClient`` sends requests over ``http://`` or ``https://`` (stdlib
``ssl``) on one keep-alive connection per origin, reads a response body
framed by ``Content-Length``, ``Transfer-Encoding: chunked`` or the end of
the connection, and bounds each request (connect, send and the whole
response) by a total timeout, past which it raises ``HttpTimeout``.
"""

from __future__ import annotations

import asyncio
import logging
import ssl as _ssl
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Optional
from urllib.parse import urlsplit

logger = logging.getLogger("arkflow_torch.http")

MAX_HEAD = 16384
#: aiohttp's default ``client_max_size``
DEFAULT_MAX_BODY = 1 << 20
#: a refused body up to this many times the limit is read off and dropped
_DISCARD_LIMIT = 8
#: seconds a persistent connection may sit idle between requests
IDLE_TIMEOUT_S = 75.0

REASONS = {200: "OK", 204: "No Content", 400: "Bad Request", 401: "Unauthorized",
           404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
           413: "Request Entity Too Large", 429: "Too Many Requests",
           500: "Internal Server Error", 503: "Service Unavailable"}


class HttpError(Exception):
    """A request the server refuses before its handler answers."""

    def __init__(self, status: int, text: str = ""):
        super().__init__(text or REASONS.get(status, "error"))
        self.status = status
        self.text = text


@dataclass
class Request:
    method: str
    target: str
    version: str
    #: header names lower-cased; a repeated header keeps its last value
    headers: dict[str, str]
    remote: Optional[str]
    _reader: asyncio.StreamReader
    _max_body: int
    _body: Optional[bytes] = None
    #: the body's framing is known and fully consumed (or there is none)
    _drained: bool = False

    @property
    def path(self) -> str:
        return self.target.split("?", 1)[0]

    @property
    def keep_alive_asked(self) -> Optional[bool]:
        """True or False when the request's ``Connection`` header decides,
        else None (the version's default applies)."""
        tokens = {t.strip().lower() for t in self.headers.get("connection", "").split(",")}
        if "close" in tokens:
            return False
        if "keep-alive" in tokens:
            return True
        return None

    async def read(self) -> bytes:
        """The whole body (b"" when there is none). Raises ``HttpError(413)``
        past the server's body limit and ``HttpError(400)`` on bad framing."""
        if self._body is not None:
            return self._body
        te = self.headers.get("transfer-encoding", "").lower()
        if "chunked" in te:
            body = await self._read_chunked()
        else:
            length = self._content_length()
            if length > self._max_body:
                if length <= _DISCARD_LIMIT * self._max_body:
                    # read the refused body off the socket, so that closing
                    # the connection cannot reset the client before it reads
                    # the 413
                    left = length
                    while left:
                        chunk = await self._reader.read(min(left, 1 << 16))
                        if not chunk:
                            break
                        left -= len(chunk)
                raise HttpError(413, f"Maximum request body size {self._max_body} exceeded, "
                                     f"actual body size {length}")
            body = await self._reader.readexactly(length) if length else b""
        self._body = body
        self._drained = True
        return body

    def _content_length(self) -> int:
        raw = self.headers.get("content-length", "0").strip() or "0"
        if not raw.isdigit():
            raise HttpError(400, "bad Content-Length")
        return int(raw)

    async def _read_chunked(self) -> bytes:
        out = bytearray()
        while True:
            line = await self._reader.readuntil(b"\r\n")
            size_s = line[:-2].split(b";", 1)[0].strip()
            try:
                size = int(size_s, 16)
            except ValueError:
                raise HttpError(400, "bad chunk size") from None
            if size == 0:
                while (await self._reader.readuntil(b"\r\n")) != b"\r\n":
                    pass  # trailers are read and dropped
                return bytes(out)
            if len(out) + size > self._max_body:
                raise HttpError(413, f"Maximum request body size {self._max_body} exceeded, "
                                     f"actual body size {len(out) + size}")
            out += await self._reader.readexactly(size)
            if await self._reader.readexactly(2) != b"\r\n":
                raise HttpError(400, "bad chunk terminator")


@dataclass
class Response:
    status: int
    body: bytes = b""
    content_type: Optional[str] = "text/plain; charset=utf-8"
    headers: dict[str, str] = field(default_factory=dict)
    #: close the connection after this response, whatever the request asked
    close: bool = False

    @classmethod
    def text(cls, status: int, text: str = "", headers: Optional[dict] = None) -> "Response":
        return cls(status, text.encode(), headers=dict(headers or {}))


Handler = Callable[[Request], Awaitable[Response]]


async def read_request(reader: asyncio.StreamReader, remote: Optional[str],
                       max_body: int = DEFAULT_MAX_BODY) -> Optional[Request]:
    """The next request's head off ``reader``; None at a clean end of the
    connection. Raises ``HttpError(400)`` on a malformed head."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial.strip():
            return None
        raise HttpError(400, "truncated request head") from None
    except asyncio.LimitOverrunError:
        raise HttpError(400, "request head too large") from None
    if len(head) > MAX_HEAD:
        raise HttpError(400, "request head too large")
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise HttpError(400, "malformed request line")
    headers = {k.strip().lower(): v.strip() for k, sep, v in
               (line.partition(":") for line in lines[1:] if line) if sep}
    return Request(parts[0].upper(), parts[1], parts[2], headers, remote, reader, max_body)


def render(response: Response, keep_alive: bool) -> bytes:
    head = [f"HTTP/1.1 {response.status} {REASONS.get(response.status, 'Error')}"]
    if response.content_type and (response.body or response.status != 204):
        head.append(f"Content-Type: {response.content_type}")
    if response.status != 204:
        head.append(f"Content-Length: {len(response.body)}")
    head += [f"{k}: {v}" for k, v in response.headers.items()]
    head.append("Connection: keep-alive" if keep_alive else "Connection: close")
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + response.body


async def serve_connection(reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                           handler: Handler, *, max_body: int = DEFAULT_MAX_BODY,
                           persistent_default: bool = True,
                           idle_timeout_s: float = IDLE_TIMEOUT_S) -> None:
    """Answer the requests of one connection in turn (see the module
    docstring); ``handler`` errors answer 500."""
    peer = writer.get_extra_info("peername")
    remote = peer[0] if isinstance(peer, tuple) and peer else None
    try:
        while True:
            try:
                req = await asyncio.wait_for(read_request(reader, remote, max_body),
                                             idle_timeout_s)
            except asyncio.TimeoutError:
                return
            except HttpError as e:
                writer.write(render(Response.text(e.status, e.text), keep_alive=False))
                await writer.drain()
                return
            if req is None:
                return
            asked = req.keep_alive_asked
            keep = asked if asked is not None else (
                persistent_default and req.version == "HTTP/1.1")
            try:
                resp = await handler(req)
            except HttpError as e:
                resp, keep = Response.text(e.status, e.text), False
            except Exception:
                logger.exception("HTTP handler failed")
                resp, keep = Response.text(500, "internal error"), False
            keep = keep and not resp.close
            if keep and not req._drained:
                try:
                    await req.read()
                except (HttpError, asyncio.IncompleteReadError, asyncio.LimitOverrunError):
                    keep = False
            writer.write(render(resp, keep))
            await writer.drain()
            if not keep:
                return
    except (ConnectionError, asyncio.IncompleteReadError):
        return
    except Exception:  # one bad connection must not take the server down
        logger.exception("HTTP connection failed")
    finally:
        writer.close()


class HttpServer:
    """A listening socket whose connections ``serve_connection`` answers;
    ``close`` also closes every open connection, so a client holding one
    open cannot keep the server from stopping."""

    def __init__(self, handler: Handler, *, max_body: int = DEFAULT_MAX_BODY,
                 persistent_default: bool = True):
        self.handler = handler
        self.max_body = max_body
        self.persistent_default = persistent_default
        self.port: Optional[int] = None
        #: connections accepted (a keep-alive client opens one)
        self.connections = 0
        self._server: Optional[asyncio.AbstractServer] = None
        self._writers: set[asyncio.StreamWriter] = set()

    async def start(self, host: str, port: int) -> int:
        """Listen on ``host:port`` (port 0 picks a free one); the bound port."""
        self._server = await asyncio.start_server(self._connection, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        self.connections += 1
        try:
            await serve_connection(reader, writer, self.handler, max_body=self.max_body,
                                   persistent_default=self.persistent_default)
        finally:
            self._writers.discard(writer)

    async def close(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for w in list(self._writers):
            w.close()
        try:  # a handler still running bounds the wait, not the stop
            await asyncio.wait_for(self._server.wait_closed(), 1.0)
        except asyncio.TimeoutError:
            pass
        self._server = self.port = None


# -- client --------------------------------------------------------------------


class HttpClientError(Exception):
    """A request that got no complete response: connect, send or read
    failed, or the response was malformed."""


class HttpTimeout(HttpClientError, TimeoutError):
    """A request that ran past its total timeout."""


@dataclass
class ClientResponse:
    status: int
    #: header names lower-cased; a repeated header keeps its last value
    headers: dict[str, str]
    body: bytes

    def text(self) -> str:
        """The body decoded by the ``Content-Type`` charset (UTF-8 when it
        names none)."""
        charset = "utf-8"
        for part in self.headers.get("content-type", "").split(";")[1:]:
            k, _, v = part.strip().partition("=")
            if k.lower() == "charset" and v:
                charset = v.strip('"')
        try:
            return self.body.decode(charset, "replace")
        except LookupError:
            return self.body.decode("utf-8", "replace")


class HttpClient:
    """Requests on one keep-alive connection per origin, one at a time
    (see the module docstring). ``headers`` go on every request, under the
    request's own."""

    #: the longest response body read; a longer one fails the request
    MAX_BODY = 64 << 20

    def __init__(self, headers: Optional[dict] = None, timeout_s: float = 30.0):
        self.headers = dict(headers or {})
        self.timeout_s = timeout_s
        #: connections opened (a keep-alive client opens one per origin)
        self.connections = 0
        #: origin -> (reader, writer) of its open connection
        self._conns: dict[tuple[str, str, int], tuple] = {}
        self._lock = asyncio.Lock()

    async def request(self, method: str, url: str, body: bytes = b"",
                      headers: Optional[dict] = None) -> ClientResponse:
        """Send one request and read its whole response. Raises
        ``HttpTimeout`` past the total timeout, ``HttpClientError`` when no
        complete response came."""
        parts = urlsplit(url)
        scheme = parts.scheme.lower()
        if scheme not in ("http", "https") or not parts.hostname:
            raise HttpClientError(f"unsupported URL {url!r}")
        port = parts.port or (443 if scheme == "https" else 80)
        origin = (scheme, parts.hostname, port)
        target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        host = parts.hostname if parts.port is None else f"{parts.hostname}:{parts.port}"
        merged = {"Host": host, "Accept": "*/*", "User-Agent": "arkflow-tpu-torch",
                  **self.headers, **(headers or {})}
        lower = {k.lower() for k in merged}
        if body or method.upper() in ("POST", "PUT", "PATCH"):
            if "content-type" not in lower:
                merged["Content-Type"] = "application/octet-stream"
            merged["Content-Length"] = str(len(body))
        head = "\r\n".join([f"{method.upper()} {target} HTTP/1.1",
                             *(f"{k}: {v}" for k, v in merged.items())])
        data = (head + "\r\n\r\n").encode("latin-1") + body
        async with self._lock:
            try:
                return await asyncio.wait_for(
                    self._exchange(origin, data, method.upper() == "HEAD"), self.timeout_s)
            except asyncio.TimeoutError:
                self._drop(origin)
                raise HttpTimeout(f"{method.upper()} {url} timed out after "
                                  f"{self.timeout_s} s") from None

    async def _open(self, origin: tuple[str, str, int]) -> tuple:
        scheme, host, port = origin
        ctx = _ssl.create_default_context() if scheme == "https" else None
        try:
            reader, writer = await asyncio.open_connection(
                host, port, ssl=ctx, server_hostname=host if ctx else None)
        except (OSError, _ssl.SSLError) as e:
            raise HttpClientError(f"cannot connect to {host}:{port}: {e}") from e
        self.connections += 1
        self._conns[origin] = (reader, writer)
        return reader, writer

    def _drop(self, origin: tuple[str, str, int]) -> None:
        conn = self._conns.pop(origin, None)
        if conn is not None:
            conn[1].close()

    async def _exchange(self, origin: tuple[str, str, int], data: bytes,
                        head_only: bool) -> ClientResponse:
        conn = self._conns.get(origin)
        reused = conn is not None
        reader, writer = conn if conn is not None else await self._open(origin)
        try:
            writer.write(data)
            await writer.drain()
            resp, keep = await self._read_response(reader, head_only)
        except (ConnectionError, asyncio.IncompleteReadError, HttpClientError) as e:
            self._drop(origin)
            stale = reused and (isinstance(e, ConnectionError) or (
                isinstance(e, asyncio.IncompleteReadError) and not e.partial))
            if not stale:
                if isinstance(e, HttpClientError):
                    raise
                raise HttpClientError(f"connection to {origin[1]}:{origin[2]} lost: "
                                      f"{e!r}") from e
            # the server closed an idle keep-alive connection: once more on a new one
            return await self._exchange(origin, data, head_only)
        if not keep:
            self._drop(origin)
        return resp

    async def _read_response(self, reader: asyncio.StreamReader,
                             head_only: bool) -> tuple[ClientResponse, bool]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.LimitOverrunError:
            raise HttpClientError("response head too large") from None
        lines = head.decode("latin-1").split("\r\n")
        status_line = lines[0].split(None, 2)
        if len(status_line) < 2 or not status_line[0].startswith("HTTP/1."):
            raise HttpClientError(f"malformed status line {lines[0][:80]!r}")
        try:
            status = int(status_line[1])
        except ValueError:
            raise HttpClientError(f"malformed status line {lines[0][:80]!r}") from None
        headers = {k.strip().lower(): v.strip() for k, sep, v in
                   (line.partition(":") for line in lines[1:] if line) if sep}
        tokens = {t.strip().lower() for t in headers.get("connection", "").split(",")}
        keep = "close" not in tokens and (status_line[0] == "HTTP/1.1"
                                          or "keep-alive" in tokens)
        if head_only or status in (204, 304) or 100 <= status < 200:
            return ClientResponse(status, headers, b""), keep
        if "chunked" in headers.get("transfer-encoding", "").lower():
            body = await self._read_chunked(reader)
        elif "content-length" in headers:
            raw = headers["content-length"]
            if not raw.isdigit():
                raise HttpClientError(f"bad Content-Length {raw!r}")
            if int(raw) > self.MAX_BODY:
                raise HttpClientError(f"response body of {raw} bytes past {self.MAX_BODY}")
            body = await reader.readexactly(int(raw))
        else:  # the body runs to the end of the connection
            body = await reader.read(self.MAX_BODY + 1)
            while len(body) <= self.MAX_BODY:
                more = await reader.read(self.MAX_BODY + 1 - len(body))
                if not more:
                    break
                body += more
            if len(body) > self.MAX_BODY:
                raise HttpClientError(f"response body past {self.MAX_BODY} bytes")
            keep = False
        return ClientResponse(status, headers, body), keep

    async def _read_chunked(self, reader: asyncio.StreamReader) -> bytes:
        out = bytearray()
        while True:
            line = await reader.readuntil(b"\r\n")
            try:
                size = int(line[:-2].split(b";", 1)[0].strip(), 16)
            except ValueError:
                raise HttpClientError(f"bad chunk size {line[:40]!r}") from None
            if size == 0:
                while (await reader.readuntil(b"\r\n")) != b"\r\n":
                    pass  # trailers are read and dropped
                return bytes(out)
            if len(out) + size > self.MAX_BODY:
                raise HttpClientError(f"response body past {self.MAX_BODY} bytes")
            out += await reader.readexactly(size)
            if await reader.readexactly(2) != b"\r\n":
                raise HttpClientError("bad chunk terminator")

    async def close(self) -> None:
        for origin in list(self._conns):
            self._drop(origin)
