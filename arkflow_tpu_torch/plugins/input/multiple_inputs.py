"""Fan-in input: run N child inputs concurrently into one stream.

Counterpart of ``arkflow_tpu/plugins/input/multiple_inputs.py``: each child
(named by its ``name`` key, ``input_<i>`` by default) gets a reader task
feeding one shared queue of 64; every batch leaves stamped with its child's
name in ``__meta_source``, with the child's own ack. A child that fails is
logged and counted out, as one that ends; once every child has ended a read
raises ``EndOfInput``. The names are registered in
``Resource.input_names``, for the windowed SQL join's tables.

Config:

    type: multiple_inputs
    inputs:
      - {name: orders, type: memory, messages: [...], codec: json}
      - {name: users,  type: memory, messages: [...], codec: json}
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import (Ack, Input, Resource, build_component,
                                          check_component, register_input)
from arkflow_tpu_torch.errors import ConfigError, EndOfInput

logger = logging.getLogger("arkflow_torch.input.multi")

#: batches the children may read ahead of the stream, together
QUEUE_BOUND = 64


class MultipleInputs(Input):
    def __init__(self, children: list[tuple[str, Input]]):
        if not children:
            raise ConfigError("multiple_inputs requires at least one child input")
        self.children = children
        self._queue: Optional[asyncio.Queue] = None
        self._tasks: list[asyncio.Task] = []
        self._live = 0

    async def connect(self) -> None:
        self._queue = asyncio.Queue(maxsize=QUEUE_BOUND)
        self._live = len(self.children)
        for name, child in self.children:
            await child.connect()
            self._tasks.append(asyncio.create_task(self._reader(name, child)))

    async def _reader(self, name: str, child: Input) -> None:
        try:
            while True:
                try:
                    batch, ack = await child.read()
                except EndOfInput:
                    break
                await self._queue.put((batch.with_source(name), ack))
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("child input %r failed", name)
        finally:
            try:
                self._queue.put_nowait(None)  # this child's end
            except asyncio.QueueFull:
                self._live -= 1  # no room for the marker: counted out now

    async def read(self) -> tuple[MessageBatch, Ack]:
        while True:
            if self._live <= 0:
                raise EndOfInput()
            item = await self._queue.get()
            if item is None:
                self._live -= 1
                continue
            return item

    async def close(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks = []
        for _, child in self.children:
            await child.close()


def _children(config: dict) -> list[tuple[str, dict]]:
    raw = config.get("inputs")
    if not raw or not isinstance(raw, list):
        raise ConfigError("multiple_inputs requires a non-empty 'inputs' list")
    out = []
    for i, c in enumerate(raw):
        c = dict(c)
        out.append((c.pop("name", None) or f"input_{i}", c))
    return out


def _check(config: dict) -> None:
    for _, c in _children(config):
        check_component("input", c)


@register_input("multiple_inputs", keys=("inputs",), check=_check)
def _build(config: dict, resource: Resource) -> MultipleInputs:
    children = []
    for name, c in _children(config):
        children.append((name, build_component("input", c, resource)))
        resource.input_names.append(name)
    return MultipleInputs(children)
