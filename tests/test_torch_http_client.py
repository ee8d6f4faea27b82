"""The port's stdlib HTTP/1.1 client (``utils/http1.HttpClient``), which
stands in for ``aiohttp.ClientSession`` in the HTTP and InfluxDB outputs:
one keep-alive connection per origin, ``Content-Length``, chunked and
read-to-close bodies, a stale keep-alive connection reopened, the total
timeout, and a request read by an aiohttp server."""

from __future__ import annotations

import asyncio

import pytest

from arkflow_tpu_torch.tools.fake_brokers import HttpSink
from arkflow_tpu_torch.utils.http1 import HttpClient, HttpClientError, HttpTimeout


def run(coro, timeout: float = 10.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def scripted(answers: list[bytes], close_after: bool = False):
    """A server answering each request of a connection with the next of
    ``answers`` (closing after each when ``close_after``); the requests'
    heads and the connections are recorded."""
    seen = {"heads": [], "connections": 0}

    async def handler(reader, writer):
        seen["connections"] += 1
        try:
            while answers:
                head = await reader.readuntil(b"\r\n\r\n")
                seen["heads"].append(head.decode())
                length = [int(line.split(":")[1]) for line in head.decode().split("\r\n")
                          if line.lower().startswith("content-length:")]
                if length and length[0]:
                    await reader.readexactly(length[0])
                writer.write(answers.pop(0))
                await writer.drain()
                if close_after:
                    break
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    server = await asyncio.start_server(handler, "127.0.0.1", 0)
    return server, server.sockets[0].getsockname()[1], seen


def test_keep_alive_on_one_connection():
    async def go():
        sink = HttpSink(statuses=[200, 404], status=204)
        await sink.start()
        try:
            client = HttpClient(headers={"Authorization": "Token t"})
            statuses = []
            for i in range(4):
                resp = await client.request("POST", f"http://127.0.0.1:{sink.port}/w?x={i}",
                                            b"body%d" % i)
                statuses.append((resp.status, resp.text()))
            await client.close()
            return statuses, sink.requests, sink.connections, client.connections
        finally:
            await sink.stop()

    statuses, requests, server_conns, client_conns = run(go())
    assert statuses == [(200, ""), (404, "fail"), (204, ""), (204, "")]
    assert server_conns == client_conns == 1
    assert [(r[0], r[1], r[3]) for r in requests] == [
        ("POST", f"/w?x={i}", b"body%d" % i) for i in range(4)]
    assert requests[0][2]["authorization"] == "Token t"
    assert requests[0][2]["content-type"] == "application/octet-stream"


def test_chunked_and_read_to_close_bodies():
    chunked = (b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n"
               b"Content-Type: text/plain; charset=latin-1\r\n\r\n"
               b"5;ext=1\r\nhello\r\n7\r\n w\xf6rld!\r\n0\r\nX-Trailer: t\r\n\r\n")
    plain = b"HTTP/1.1 201 Created\r\nContent-Length: 3\r\n\r\nabc"
    to_close = b"HTTP/1.0 200 OK\r\n\r\nuntil the end"

    async def go():
        server, port, seen = await scripted([chunked, plain, to_close])
        client = HttpClient()
        try:
            out = []
            for _ in range(3):
                resp = await client.request("GET", f"http://127.0.0.1:{port}/")
                out.append((resp.status, resp.body, resp.text()))
            return out, seen["connections"], client.connections
        finally:
            await client.close()
            server.close()

    out, server_conns, client_conns = run(go())
    assert out == [(200, b"hello w\xf6rld!", "hello wörld!"), (201, b"abc", "abc"),
                   (200, b"until the end", "until the end")]
    assert server_conns == client_conns == 1  # the chunked body kept the connection aligned


def test_a_stale_keep_alive_connection_is_reopened():
    """The server closes after each answer without saying so: the next
    request finds the connection dead and goes out again on a new one."""
    ok = b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok"

    async def go():
        server, port, seen = await scripted([ok, ok, ok], close_after=True)
        client = HttpClient()
        try:
            got = []
            for _ in range(3):
                got.append((await client.request("POST", f"http://127.0.0.1:{port}/", b"x")).body)
                await asyncio.sleep(0.02)
            return got, seen["connections"], len(seen["heads"])
        finally:
            await client.close()
            server.close()

    assert run(go()) == ([b"ok"] * 3, 3, 3)


def test_total_timeout_raises():
    async def go():
        async def silent(reader, writer):
            await asyncio.sleep(5)

        server = await asyncio.start_server(silent, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        client = HttpClient(timeout_s=0.15)
        t0 = asyncio.get_running_loop().time()
        with pytest.raises(HttpTimeout) as e:
            await client.request("GET", f"http://127.0.0.1:{port}/slow")
        took = asyncio.get_running_loop().time() - t0
        server.close()
        await client.close()
        return e.value, took

    err, took = run(go())
    assert isinstance(err, TimeoutError) and isinstance(err, HttpClientError)
    assert "timed out after 0.15 s" in str(err) and took < 1.0


def test_no_body_statuses_and_bad_input():
    async def go():
        server, port, _ = await scripted([b"HTTP/1.1 204 No Content\r\n\r\n",
                                          b"HTTP/1.1 200 OK\r\nContent-Length: 9\r\n\r\n",
                                          b"HTTP/1.1 200 OK\r\nContent-Length: 1\r\n\r\nz"])
        client = HttpClient()
        try:
            a = await client.request("DELETE", f"http://127.0.0.1:{port}/")
            b = await client.request("HEAD", f"http://127.0.0.1:{port}/")
            c = await client.request("GET", f"http://127.0.0.1:{port}/")
            with pytest.raises(HttpClientError, match="unsupported URL"):
                await client.request("GET", "ftp://127.0.0.1/x")
            return a.status, a.body, b.status, b.body, c.body
        finally:
            await client.close()
            server.close()

    assert run(go()) == (204, b"", 200, b"", b"z")


def test_an_aiohttp_server_reads_the_request():
    from aiohttp import web

    async def go():
        seen = []

        async def handler(req):
            seen.append((req.method, req.path_qs, req.headers.get("X-A"), await req.read()))
            return web.Response(text="héllo", charset="utf-8", status=207)

        app = web.Application()
        app.router.add_route("*", "/p", handler)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        client = HttpClient()
        try:
            r1 = await client.request("PATCH", f"http://127.0.0.1:{port}/p?q=1", b"\x00" * 70000,
                                      {"X-A": "1"})
            r2 = await client.request("GET", f"http://127.0.0.1:{port}/p")
            return seen, r1.status, r1.text(), r2.status, client.connections
        finally:
            await client.close()
            await runner.cleanup()

    seen, s1, t1, s2, conns = run(go())
    assert seen == [("PATCH", "/p?q=1", "1", b"\x00" * 70000), ("GET", "/p", None, b"")]
    assert (s1, t1, s2, conns) == (207, "héllo", 207, 1)
