"""JSON <-> typed-column processors.

Counterpart of ``arkflow_tpu/plugins/processor/json_proc.py``.
``json_to_arrow`` decodes a payload column (``value_field``, default
``__value__``) through the json codec's ``decode_many`` into typed columns,
carrying the metadata columns through when the row count is unchanged;
``arrow_to_json`` writes each row's data columns (``fields``, when given, in
the batch's order) as one JSON document into ``__value__`` and re-attaches
the metadata columns. The names keep the JAX package's, though no Arrow is
involved.

    - type: json_to_arrow
      value_field: __value__     # optional
    - type: arrow_to_json
      fields: [id, label, score] # optional
"""

from __future__ import annotations

from typing import Optional

from arkflow_tpu_torch.batch import DEFAULT_BINARY_VALUE_FIELD, MessageBatch
from arkflow_tpu_torch.components import Processor, Resource, register_processor
from arkflow_tpu_torch.errors import CodecError, ProcessError
from arkflow_tpu_torch.plugins.codec.json_codec import JsonCodec


def carry_metadata(out: MessageBatch, source: MessageBatch) -> MessageBatch:
    """``source``'s metadata columns on ``out``, when their rows match."""
    meta = source.metadata_columns()
    if meta and out.num_rows == source.num_rows:
        for name in meta:
            out = out.with_column(name, source.column(name))
    return out


class JsonToArrowProcessor(Processor):
    def __init__(self, value_field: str = DEFAULT_BINARY_VALUE_FIELD):
        self.value_field = value_field
        self.codec = JsonCodec()

    async def process(self, batch: MessageBatch) -> list[MessageBatch]:
        if batch.num_rows == 0:
            return []
        if not batch.has_column(self.value_field):
            raise ProcessError(f"json_to_arrow: no {self.value_field!r} column")
        try:
            out = self.codec.decode_many(batch.to_binary(self.value_field))
        except CodecError as e:
            raise ProcessError(f"json_to_arrow: invalid JSON: {e}") from e
        out = carry_metadata(out, batch)
        return [out] if out.num_rows else []


class ArrowToJsonProcessor(Processor):
    def __init__(self, fields: Optional[list[str]] = None):
        self.fields = fields
        self.codec = JsonCodec()

    async def process(self, batch: MessageBatch) -> list[MessageBatch]:
        if batch.num_rows == 0:
            return []
        data = batch.strip_metadata()
        if self.fields:
            data = data.filter_columns(self.fields)
        out = MessageBatch.new_binary(self.codec.encode(data))
        for name in batch.metadata_columns():
            out = out.with_column(name, batch.column(name))
        return [out]


@register_processor("json_to_arrow", keys=("value_field",))
def _build_j2a(config: dict, resource: Resource) -> JsonToArrowProcessor:
    return JsonToArrowProcessor(value_field=config.get("value_field", DEFAULT_BINARY_VALUE_FIELD))


@register_processor("arrow_to_json", keys=("fields",))
def _build_a2j(config: dict, resource: Resource) -> ArrowToJsonProcessor:
    return ArrowToJsonProcessor(fields=config.get("fields"))
