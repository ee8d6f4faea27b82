"""Static in-config message list, one message a read; EOF when drained.

Counterpart of ``arkflow_tpu/plugins/input/memory.py``:

    type: memory
    messages: ['first text', 'second text']   # a mapping or list entry is
                                              # sent as its JSON text
    codec: json                               # optional

Each read returns one message, stamped ``__meta_source: memory``: decoded
by the codec when one is set (each message on its own), else as a one-row
batch in the ``__value__`` column. ``connect`` rewinds to the first message
(a ``fault`` wrapper connects its inner input once, so its reconnect probes
do not rewind). ``tenant`` and ``pause_on_overload`` raise "not yet
ported".
"""

from __future__ import annotations

import json
from collections import deque

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Ack, Input, NoopAck, Resource, register_input
from arkflow_tpu_torch.errors import ConfigError, EndOfInput
from arkflow_tpu_torch.plugins.codec.helper import build_codec, check_codec, decode_payloads


class MemoryInput(Input):
    def __init__(self, messages: list[bytes], codec=None):
        self._initial = list(messages)
        self.codec = codec
        self._queue: deque[bytes] = deque()

    async def connect(self) -> None:
        self._queue = deque(self._initial)

    async def read(self) -> tuple[MessageBatch, Ack]:
        if not self._queue:
            raise EndOfInput()
        batch = decode_payloads([self._queue.popleft()], self.codec)
        return batch.with_source("memory"), NoopAck()


def _encode(message) -> bytes:
    if isinstance(message, bytes):
        return message
    if isinstance(message, str):
        return message.encode()
    return json.dumps(message).encode()


def _check(config: dict) -> None:
    msgs = config.get("messages")
    if msgs is None:
        raise ConfigError("memory input requires 'messages'")
    if not isinstance(msgs, (list, tuple)):
        raise ConfigError("memory input 'messages' must be a list")
    check_codec(config)


@register_input("memory", keys=("messages", "codec"), check=_check)
def _build(config: dict, resource: Resource) -> MemoryInput:
    return MemoryInput([_encode(m) for m in config["messages"]],
                       codec=build_codec(config.get("codec"), resource))
