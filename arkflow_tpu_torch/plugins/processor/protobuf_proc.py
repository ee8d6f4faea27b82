"""protobuf_to_arrow / arrow_to_protobuf processors.

Counterpart of ``arkflow_tpu/plugins/processor/protobuf_proc.py``: decode a
payload column (``value_field``, default ``__value__``) through a
build-time-compiled proto schema into typed columns, and back. Each takes
the protobuf codec's keys (``message_type``, ``proto_source`` or
``proto_file``, ``include_paths``), and needs ``google.protobuf`` and
``protoc`` where it is built.
"""

from __future__ import annotations

from arkflow_tpu_torch.batch import DEFAULT_BINARY_VALUE_FIELD, MessageBatch
from arkflow_tpu_torch.components import Processor, Resource, register_processor
from arkflow_tpu_torch.errors import ProcessError
from arkflow_tpu_torch.plugins.codec.protobuf_codec import (
    CODEC_KEYS,
    ProtobufCodec,
    build_from_config,
    check_config,
)
from arkflow_tpu_torch.plugins.processor.json_proc import carry_metadata


class ProtobufToArrowProcessor(Processor):
    def __init__(self, codec: ProtobufCodec, value_field: str = DEFAULT_BINARY_VALUE_FIELD):
        self.codec = codec
        self.value_field = value_field

    async def process(self, batch: MessageBatch) -> list[MessageBatch]:
        if batch.num_rows == 0:
            return []
        if not batch.has_column(self.value_field):
            raise ProcessError(f"protobuf_to_arrow: no {self.value_field!r} column")
        out = carry_metadata(self.codec.decode_many(batch.to_binary(self.value_field)), batch)
        return [out] if out.num_rows else []


class ArrowToProtobufProcessor(Processor):
    def __init__(self, codec: ProtobufCodec):
        self.codec = codec

    async def process(self, batch: MessageBatch) -> list[MessageBatch]:
        if batch.num_rows == 0:
            return []
        out = MessageBatch.new_binary(self.codec.encode(batch.strip_metadata()))
        for name in batch.metadata_columns():
            out = out.with_column(name, batch.column(name))
        return [out]


@register_processor("protobuf_to_arrow", keys=CODEC_KEYS + ("value_field",), check=check_config)
def _build_p2a(config: dict, resource: Resource) -> ProtobufToArrowProcessor:
    return ProtobufToArrowProcessor(build_from_config(config),
                                    config.get("value_field", DEFAULT_BINARY_VALUE_FIELD))


@register_processor("arrow_to_protobuf", keys=CODEC_KEYS, check=check_config)
def _build_a2p(config: dict, resource: Resource) -> ArrowToProtobufProcessor:
    return ArrowToProtobufProcessor(build_from_config(config))
