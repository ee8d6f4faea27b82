"""In-memory Temporary: a static keyed lookup table for SQL enrichment.

Counterpart of ``arkflow_tpu/plugins/temporary/memory.py``: ``get(keys)``
returns the table's rows whose key is in ``keys``, in the table's order
with its duplicates, as JAX's ``pc.is_in`` filter does (a null key matches
a null in the table).

    type: memory
    key: id
    rows:
      - {id: 1, name: "pump"}
      - {id: 2, name: "valve"}
"""

from __future__ import annotations

from typing import Sequence

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Resource, Temporary, register_temporary
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.sql import arrays as A


class MemoryTemporary(Temporary):
    def __init__(self, key_column: str, batch: MessageBatch):
        if not batch.has_column(key_column):
            raise ConfigError(f"memory temporary: key column {key_column!r} not in rows")
        self.key_column = key_column
        self.batch = batch

    async def connect(self) -> None:
        return None

    async def get(self, keys: Sequence[object]) -> MessageBatch:
        if not keys:
            return self.batch.slice(0, 0)
        col = A.from_column(self.batch.column(self.key_column))
        return self.batch.filter(A.is_in(col, list(dict.fromkeys(keys))).data)


@register_temporary("memory", keys=("key", "rows"))
def _build(config: dict, resource: Resource) -> MemoryTemporary:
    key = config.get("key")
    rows = config.get("rows")
    if not key or rows is None:
        raise ConfigError("memory temporary requires 'key' and 'rows'")
    if not isinstance(rows, list) or not all(isinstance(r, dict) for r in rows):
        raise ConfigError("memory temporary 'rows' must be a list of mappings")
    return MemoryTemporary(key, MessageBatch.from_pylist(rows))
