"""Remap processor: declarative per-column transformation.

Counterpart of ``arkflow_tpu/plugins/processor/remap.py``: each mapping is a
SQL expression evaluated over the whole batch (the engine of WHERE clauses
and ``{expr: ...}`` config values); new columns go after the batch's own,
in the mappings' order, and a mapping of an existing name replaces it in
place.

Config:

    type: remap
    where: "temp IS NOT NULL"            # optional row filter first
    mappings:
      fahrenheit: "temp * 1.8 + 32"
      device: "upper(dev)"
    drop: [temp]                         # optional columns to remove after
"""

from __future__ import annotations

import numpy as np

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Processor, Resource, register_processor
from arkflow_tpu_torch.errors import ConfigError, ProcessError
from arkflow_tpu_torch.sql import arrays as A
from arkflow_tpu_torch.sql.eval import evaluate_expression
from arkflow_tpu_torch.sql.parser import parse_expression


class RemapProcessor(Processor):
    def __init__(self, mappings: dict[str, str], where: str | None = None,
                 drop: list[str] | None = None):
        if not mappings and not where and not drop:
            raise ConfigError("remap processor needs 'mappings', 'where' or 'drop'")
        for col, expr in mappings.items():
            try:
                parse_expression(expr)  # fail at build, not per batch
            except Exception as e:
                raise ConfigError(f"remap: bad expression for {col!r}: {e}") from e
        if where:
            parse_expression(where)
        self.mappings = mappings
        self.where = where
        self.drop = drop or []

    async def process(self, batch: MessageBatch) -> list[MessageBatch]:
        if batch.num_rows == 0:
            return []
        try:
            if self.where:
                mask = A.to_bool(A.from_column(evaluate_expression(batch, self.where)))
                keep = np.flatnonzero(mask.data.astype(bool) & mask.mask())
                batch = MessageBatch({n: A.take_column(batch.column(n), keep)
                                      for n in batch.column_names}, len(keep))
                if batch.num_rows == 0:
                    return []
            out = batch
            for col, expr in self.mappings.items():
                out = out.with_column(col, evaluate_expression(batch, expr))
            if self.drop:
                out = out.drop_columns(self.drop)
        except ProcessError:
            raise
        except Exception as e:
            raise ProcessError(f"remap failed: {e}") from e
        return [out]


@register_processor("remap", keys=("mappings", "where", "drop"))
def _build(config: dict, resource: Resource) -> RemapProcessor:
    return RemapProcessor(
        mappings=dict(config.get("mappings") or {}),
        where=config.get("where"),
        drop=list(config.get("drop") or []),
    )
