"""The port's stdlib RFC 6455 client (``connect/ws_client.py``), which
stands in for the ``websockets`` package the card's machine lacks: frames
of every length form, fragmented messages with pings between the
fragments, the close handshake from either side, the message limit, the
handshake checks, and an echo through a ``websockets`` server."""

from __future__ import annotations

import asyncio

import pytest

from arkflow_tpu_torch.connect import ws_client as wsc
from arkflow_tpu_torch.tools.fake_brokers import FakeWebsocketServer


def run(coro, timeout: float = 10.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.mark.parametrize("n", [0, 1, 125, 126, 65535, 65536, 70001])
@pytest.mark.parametrize("masked", [False, True])
def test_frame_round_trip_at_each_length_form(n, masked):
    payload = bytes(i % 251 for i in range(n))
    mask = b"\x01\x80\xfe\x7f" if masked else None
    frame = wsc.encode_frame(wsc.OP_BINARY, payload, fin=False, mask=mask)
    header = 2 + (0 if n < 126 else 2 if n < 65536 else 8) + (4 if masked else 0)
    assert len(frame) == header + n
    assert frame[1] & 0x7F == (n if n < 126 else 126 if n < 65536 else 127)

    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(frame)
        reader.feed_eof()
        return await wsc.read_frame(reader, 1 << 20)

    assert run(go()) == (False, wsc.OP_BINARY, payload, masked)


def test_accept_key_is_rfc6455s_example():
    assert wsc.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def test_fragments_pings_and_lengths_through_the_fake():
    """Text and binary messages of 7-, 16- and 64-bit lengths, each cut into
    continuation frames of 100 bytes, a ping before each: every message
    whole, every ping answered with its data, then the client's close."""
    messages = ["short", "é" * 150, b"\x00\x01" * 35000, "x" * 100, b""]

    async def go():
        srv = FakeWebsocketServer(messages, fragment=100, ping_every=1)
        await srv.start()
        try:
            ws = await wsc.WebSocketClient.connect(f"ws://127.0.0.1:{srv.port}/feed")
            got = [await ws.recv() for _ in messages]
            await ws.close()
            await asyncio.sleep(0.05)
            assert ws.closed and ws.pongs_sent == len(messages)
            with pytest.raises(wsc.ConnectionClosed):
                await ws.recv()
            return got, srv.pongs, srv.close_codes
        finally:
            await srv.stop()

    got, pongs, codes = run(go())
    assert got == messages
    assert pongs == [b"p%d" % i for i in range(len(messages))] and codes == [1000]


@pytest.mark.parametrize("code,ends_iteration", [(1000, True), (1001, True), (1011, False)])
def test_server_close_ends_or_raises(code, ends_iteration):
    async def go():
        srv = FakeWebsocketServer(["a", "b"], close_code=code)
        await srv.start()
        try:
            ws = await wsc.WebSocketClient.connect(f"ws://127.0.0.1:{srv.port}")
            got = []
            try:
                async for m in ws:
                    got.append(m)
                raised = None
            except wsc.ConnectionClosed as e:
                raised = e.code
            await asyncio.sleep(0.05)
            return got, raised, srv.close_codes
        finally:
            await srv.stop()

    got, raised, echoed = run(go())
    assert got == ["a", "b"]
    assert raised == (None if ends_iteration else code)
    assert echoed == [code]  # the client echoed the server's code


def test_message_over_the_limit_closes_with_1009():
    async def go():
        srv = FakeWebsocketServer(["ok", "y" * 300, "never"], fragment=64)
        await srv.start()
        try:
            ws = await wsc.WebSocketClient.connect(f"ws://127.0.0.1:{srv.port}", max_size=256)
            first = await ws.recv()
            with pytest.raises(wsc.ConnectionClosed) as e:
                await ws.recv()
            await asyncio.sleep(0.05)
            return first, e.value.code, srv.close_codes
        finally:
            await srv.stop()

    assert run(go()) == ("ok", 1009, [1009])
    assert wsc.DEFAULT_MAX_SIZE == 1 << 20


def test_handshake_refusals():
    async def serve(answer: bytes):
        async def handler(reader, writer):
            await reader.readuntil(b"\r\n\r\n")
            writer.write(answer)
            await writer.drain()
            writer.close()

        return await asyncio.start_server(handler, "127.0.0.1", 0)

    async def go():
        out = []
        for answer in (b"HTTP/1.1 200 OK\r\nContent-Length: 0\r\n\r\n",
                       b"HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
                       b"Connection: Upgrade\r\nSec-WebSocket-Accept: wrong\r\n\r\n"):
            server = await serve(answer)
            port = server.sockets[0].getsockname()[1]
            with pytest.raises(wsc.InvalidHandshake) as e:
                await wsc.WebSocketClient.connect(f"ws://127.0.0.1:{port}/x")
            out.append(str(e.value))
            server.close()
        with pytest.raises(wsc.InvalidHandshake):
            await wsc.WebSocketClient.connect("http://127.0.0.1:1/x")
        return out

    out = run(go())
    assert "not 101" in out[0] and "Sec-WebSocket-Accept" in out[1]


def test_echo_through_a_websockets_server():
    """The ``websockets`` package's server accepts the client's handshake
    and masked frames, and its ping and close reach the client's answers."""
    import websockets

    async def handler(ws):
        async for m in ws:
            await ws.send(m)
            await (await ws.ping(b"hi"))

    async def go():
        async with websockets.serve(handler, "127.0.0.1", 0) as server:
            port = server.sockets[0].getsockname()[1]
            ws = await wsc.WebSocketClient.connect(f"ws://127.0.0.1:{port}/")
            out = []
            for m in ("text é", b"\x00binary", "z" * 70000):
                await ws.send(m)
                out.append(await ws.recv())
            await ws.close()
            return out

    assert run(go()) == ["text é", b"\x00binary", "z" * 70000]
