"""stdout output with an injectable writer for capture in tests.

Counterpart of ``arkflow_tpu/plugins/output/stdout.py``: it writes each
payload ``encode_batch`` makes of the batch's data columns (metadata
stripped) on a line of its own: the codec's when ``codec`` is set, else the
raw ``__value__`` payloads, else one JSON document a row.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Output, Resource, register_output
from arkflow_tpu_torch.plugins.codec.helper import build_codec, check_codec, encode_batch


class StdoutOutput(Output):
    def __init__(self, codec=None, writer: Optional[Callable[[bytes], None]] = None):
        self.codec = codec
        self._write = writer or (lambda b: sys.stdout.buffer.write(b + b"\n"))

    async def connect(self) -> None:
        return None

    async def write(self, batch: MessageBatch) -> None:
        for payload in encode_batch(batch.strip_metadata(), self.codec):
            self._write(payload)

    async def close(self) -> None:
        try:
            sys.stdout.flush()
        except ValueError:
            pass


@register_output("stdout", keys=("codec",), check=check_codec)
def _build(config: dict, resource: Resource) -> StdoutOutput:
    return StdoutOutput(codec=build_codec(config.get("codec"), resource))
