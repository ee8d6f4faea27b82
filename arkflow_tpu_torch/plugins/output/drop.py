"""Discard output: counts what it drops."""

from __future__ import annotations

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Output, Resource, register_output


class DropOutput(Output):
    def __init__(self):
        self.dropped_batches = 0
        self.dropped_rows = 0

    async def connect(self) -> None:
        return None

    async def write(self, batch: MessageBatch) -> None:
        self.dropped_batches += 1
        self.dropped_rows += batch.num_rows


@register_output("drop")
def _build(config: dict, resource: Resource) -> DropOutput:
    return DropOutput()
