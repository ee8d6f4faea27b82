"""Static in-config message list, one message a read; EOF when drained.

Counterpart of ``arkflow_tpu/plugins/input/memory.py``:

    type: memory
    messages: ['first text', 'second text']   # a mapping or list entry is
                                              # sent as its JSON text
    codec: json                               # optional
    tenant: team-a                            # optional; stamped into
                                              # __meta_ext_tenant
    pause_on_overload: true                   # optional; pause reads while
                                              # the overload controller
                                              # sheds (default false)

Each read returns one message, stamped ``__meta_source: memory``: decoded
by the codec when one is set (each message on its own), else as a one-row
batch in the ``__value__`` column. ``connect`` rewinds to the first message
(a ``fault`` wrapper connects its inner input once, so its reconnect probes
do not rewind).
"""

from __future__ import annotations

import json
from collections import deque
from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Ack, Input, NoopAck, Resource, register_input
from arkflow_tpu_torch.errors import ConfigError, EndOfInput
from arkflow_tpu_torch.plugins.codec.helper import build_codec, check_codec, decode_payloads


class MemoryInput(Input):
    def __init__(self, messages: list[bytes], codec=None, pause_on_overload: bool = False,
                 tenant: Optional[str] = None):
        self._initial = list(messages)
        self.codec = codec
        self._queue: deque[bytes] = deque()
        #: opt-in cooperative pause (the stream reads the flag)
        self.pause_on_overload = pause_on_overload
        #: static tenant id of every batch (``__meta_ext_tenant``)
        self.tenant = tenant

    async def connect(self) -> None:
        self._queue = deque(self._initial)

    async def read(self) -> tuple[MessageBatch, Ack]:
        if not self._queue:
            raise EndOfInput()
        batch = decode_payloads([self._queue.popleft()], self.codec).with_source("memory")
        if self.tenant is not None:
            batch = batch.with_tenant(self.tenant)
        return batch, NoopAck()


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


@register_input("memory", keys=("messages", "codec", "tenant", "pause_on_overload"),
                check=_check)
def _build(config: dict, resource: Resource) -> MemoryInput:
    return MemoryInput([_encode(m) for m in config["messages"]],
                       codec=build_codec(config.get("codec"), resource),
                       pause_on_overload=bool(config.get("pause_on_overload", False)),
                       tenant=str(config["tenant"]) if config.get("tenant") else None)
