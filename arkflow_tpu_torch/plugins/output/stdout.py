"""stdout output with an injectable writer for capture in tests.

Counterpart of ``arkflow_tpu/plugins/output/stdout.py`` without codecs: it
writes each row's raw ``__value__`` payload on a line of its own, as the
JAX output does with no codec configured.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Output, Resource, register_output


class StdoutOutput(Output):
    def __init__(self, writer: Optional[Callable[[bytes], None]] = None):
        self._write = writer or (lambda b: sys.stdout.buffer.write(b + b"\n"))

    async def connect(self) -> None:
        return None

    async def write(self, batch: MessageBatch) -> None:
        for payload in batch.to_binary():
            self._write(payload)

    async def close(self) -> None:
        try:
            sys.stdout.flush()
        except ValueError:
            pass


@register_output("stdout")
def _build(config: dict, resource: Resource) -> StdoutOutput:
    return StdoutOutput()
