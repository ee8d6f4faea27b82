"""Pipeline: a sequential processor chain with fan-out.

Counterpart of ``arkflow_tpu/runtime/pipeline.py``: each processor maps every
in-flight batch to zero or more batches; an empty result short-circuits the
chain (drop), several results fan out through the remaining processors.
"""

from __future__ import annotations

from typing import Sequence

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components.base import Processor


class Pipeline:
    def __init__(self, processors: Sequence[Processor]):
        self.processors = list(processors)

    async def connect(self) -> None:
        """Pre-flight every processor (e.g. model warmup) before data flows."""
        for proc in self.processors:
            await proc.connect()

    async def process(self, batch: MessageBatch) -> list[MessageBatch]:
        current = [batch]
        for proc in self.processors:
            nxt: list[MessageBatch] = []
            for b in current:
                nxt.extend(await proc.process(b))
            if not nxt:
                return []
            current = nxt
        return current

    async def close(self) -> None:
        for proc in self.processors:
            await proc.close()
