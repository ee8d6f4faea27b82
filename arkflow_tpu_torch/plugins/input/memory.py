"""Static in-config message list, one binary row a message; EOF when
drained.

Counterpart of ``arkflow_tpu/plugins/input/memory.py`` without codecs:

    type: memory
    messages: ['first text', 'second text']   # a mapping or list entry is
                                              # sent as its JSON text

Each read returns one message as a one-row batch in the ``__value__``
column, stamped ``__meta_source: memory``. ``connect`` rewinds to the first
message (a ``fault`` wrapper connects its inner input once, so its
reconnect probes do not rewind). ``codec``, ``tenant`` and
``pause_on_overload`` raise "not yet ported".
"""

from __future__ import annotations

import json
from collections import deque

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Ack, Input, NoopAck, Resource, register_input
from arkflow_tpu_torch.errors import ConfigError, EndOfInput


class MemoryInput(Input):
    def __init__(self, messages: list[bytes]):
        self._initial = list(messages)
        self._queue: deque[bytes] = deque()

    async def connect(self) -> None:
        self._queue = deque(self._initial)

    async def read(self) -> tuple[MessageBatch, Ack]:
        if not self._queue:
            raise EndOfInput()
        batch = MessageBatch.new_binary([self._queue.popleft()])
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


@register_input("memory", keys=("messages",), check=_check)
def _build(config: dict, resource: Resource) -> MemoryInput:
    return MemoryInput([_encode(m) for m in config["messages"]])
