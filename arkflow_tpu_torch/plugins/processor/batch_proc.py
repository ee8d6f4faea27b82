"""In-pipeline batch accumulator.

Counterpart of ``arkflow_tpu/plugins/processor/batch_proc.py``: incoming
batches accumulate until ``count`` rows are held or ``timeout`` has passed
since the first of them, checked when a batch arrives, then leave as one
concatenated batch; otherwise the processor emits nothing, so the stream
acks the held batches' sources at once (use it only where replay semantics
allow; the window buffers hold acks instead). Rows still held at close are
dropped, as in the JAX package.

    type: batch
    count: 1024
    timeout: 100ms
"""

from __future__ import annotations

import time
from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Processor, Resource, register_processor
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.utils.duration import parse_duration


class BatchProcessor(Processor):
    def __init__(self, count: int, timeout_s: Optional[float] = None):
        if count <= 0:
            raise ConfigError("batch.count must be positive")
        self.count = count
        self.timeout_s = timeout_s
        self._held: list[MessageBatch] = []
        self._held_rows = 0
        self._deadline: Optional[float] = None

    def _due(self) -> bool:
        if self._held_rows >= self.count:
            return True
        if self.timeout_s is not None and self._deadline is not None:
            return time.monotonic() >= self._deadline
        return False

    async def process(self, batch: MessageBatch) -> list[MessageBatch]:
        if batch.num_rows:
            if not self._held and self.timeout_s is not None:
                self._deadline = time.monotonic() + self.timeout_s
            self._held.append(batch)
            self._held_rows += batch.num_rows
        if not self._due():
            return []
        return self._flush()

    def _flush(self) -> list[MessageBatch]:
        if not self._held:
            return []
        merged = MessageBatch.concat(self._held)
        self._held = []
        self._held_rows = 0
        self._deadline = None
        return [merged]

    async def close(self) -> None:
        self._held = []
        self._held_rows = 0


def _check(config: dict) -> None:
    if config.get("count") is None:
        raise ConfigError("batch processor requires 'count'")


@register_processor("batch", keys=("count", "timeout"), check=_check)
def _build(config: dict, resource: Resource) -> BatchProcessor:
    timeout = config.get("timeout")
    return BatchProcessor(count=int(config["count"]),
                          timeout_s=parse_duration(timeout) if timeout is not None else None)
