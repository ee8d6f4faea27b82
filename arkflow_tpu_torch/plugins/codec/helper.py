"""Codec plumbing shared by inputs and outputs.

Counterpart of ``arkflow_tpu/plugins/codec/helper.py``. ``decode_payloads``
turns payload bytes into a batch through the configured codec, or lands them
raw in the ``__value__`` binary column; ``encode_batch`` is its write-side
twin: a batch to payload bytes through the codec, the raw ``__value__``
column when no codec is set, and one JSON document a row when the batch has
no ``__value__`` either. That last form is ``json.dumps`` of each row with
``default=str`` (so a binary cell reads ``"b'...'"``), the bytes the JAX
package's vectorised row encoder also writes for the other types.
"""

from __future__ import annotations

import json
from typing import Any, Optional

from arkflow_tpu_torch.batch import DEFAULT_BINARY_VALUE_FIELD, MessageBatch
from arkflow_tpu_torch.components import Codec, Resource, build_component, check_component


def _codec_config(config: Any) -> Optional[dict]:
    if not config:
        return None
    return {"type": config} if isinstance(config, str) else dict(config)


def check_codec(config: dict) -> None:
    """Validate a component's ``codec`` key (a type name or a mapping)
    without building the codec."""
    cfg = _codec_config(config.get("codec"))
    if cfg is not None:
        check_component("codec", cfg)


def build_codec(config: Any, resource: Resource) -> Optional[Codec]:
    cfg = _codec_config(config)
    return None if cfg is None else build_component("codec", cfg, resource)


def decode_payloads(payloads: list[bytes], codec: Optional[Codec]) -> MessageBatch:
    if codec is None:
        return MessageBatch.new_binary(payloads)
    if len(payloads) == 1:
        return codec.decode(payloads[0])
    decode_many = getattr(codec, "decode_many", None)
    if decode_many is not None:
        return decode_many(payloads)
    batches = [b for b in (codec.decode(p) for p in payloads) if b.num_rows > 0]
    return MessageBatch.concat(batches) if batches else MessageBatch.empty()


def encode_batch(batch: MessageBatch, codec: Optional[Codec]) -> list[bytes]:
    if codec is not None:
        return codec.encode(batch)
    if batch.has_column(DEFAULT_BINARY_VALUE_FIELD):
        return batch.to_binary()
    return [json.dumps(row, default=str).encode() for row in batch.to_pylist()]
