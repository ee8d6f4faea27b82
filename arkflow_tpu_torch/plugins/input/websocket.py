"""WebSocket client input.

Counterpart of ``arkflow_tpu/plugins/input/websocket.py``, on the stdlib
client ``connect/ws_client.py`` in place of the ``websockets`` package: a
reader task puts each message (text encoded as UTF-8, binary as it came)
into a bounded queue (1000; the reader waits while it is full, so TCP
pushes back on the server and no message is dropped) and a read returns one
message stamped ``__meta_source: websocket``. The peer going away raises
``Disconnection`` for the stream's reconnect loop; after ``close`` a read
raises ``EndOfInput``.

Config:

    type: websocket
    url: ws://host:port/path
    codec: json
"""

from __future__ import annotations

import asyncio
from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Ack, Input, NoopAck, Resource, register_input
from arkflow_tpu_torch.connect.ws_client import WebSocketClient
from arkflow_tpu_torch.errors import ConfigError, ConnectError, Disconnection, EndOfInput
from arkflow_tpu_torch.plugins.codec.helper import build_codec, check_codec, decode_payloads

#: messages read ahead of the stream
QUEUE_BOUND = 1000


class WebsocketInput(Input):
    #: a paused read fills the queue, the reader task blocks on it and TCP
    #: flow control pushes back on the server: nothing is dropped locally
    pause_on_overload = True

    def __init__(self, url: str, codec=None):
        self.url = url
        self.codec = codec
        self._queue: Optional[asyncio.Queue] = None
        self._task: Optional[asyncio.Task] = None
        self._ws: Optional[WebSocketClient] = None
        self._closed = False

    async def connect(self) -> None:
        try:
            self._ws = await WebSocketClient.connect(self.url)
        except Exception as e:
            raise ConnectError(f"websocket connect failed: {e}") from e
        self._queue = asyncio.Queue(maxsize=QUEUE_BOUND)
        self._task = asyncio.create_task(self._reader())

    async def _reader(self) -> None:
        try:
            async for msg in self._ws:
                payload = msg.encode() if isinstance(msg, str) else bytes(msg)
                await self._queue.put(payload)
        except asyncio.CancelledError:
            raise
        except Exception:
            pass
        finally:
            try:
                self._queue.put_nowait(None)  # the end of the connection
            except asyncio.QueueFull:
                pass  # the reader sees the dead connection at close

    async def read(self) -> tuple[MessageBatch, Ack]:
        if self._closed:
            raise EndOfInput()
        payload = await self._queue.get()
        if payload is None:
            if self._closed:
                raise EndOfInput()
            raise Disconnection("websocket closed")
        batch = decode_payloads([payload], self.codec)
        return batch.with_source("websocket").with_ingest_time(), NoopAck()

    async def close(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
        if self._ws is not None:
            try:
                await self._ws.close()
            except Exception:
                pass
        if self._queue is not None:
            try:
                self._queue.put_nowait(None)
            except asyncio.QueueFull:
                pass


def _check(config: dict) -> None:
    if not config.get("url"):
        raise ConfigError("websocket input requires 'url'")
    check_codec(config)


@register_input("websocket", keys=("url", "codec"), check=_check)
def _build(config: dict, resource: Resource) -> WebsocketInput:
    return WebsocketInput(config["url"], codec=build_codec(config.get("codec"), resource))
