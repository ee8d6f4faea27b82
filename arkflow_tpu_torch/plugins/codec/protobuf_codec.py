"""Protobuf codec: a .proto compiled at build time, messages <-> typed columns.

Counterpart of ``arkflow_tpu/plugins/codec/protobuf_codec.py``: the .proto
source compiles through the ``protoc`` binary into a descriptor set, message
classes come from a descriptor pool, and rows convert through the canonical
proto <-> dict mapping: every declared field present (defaults filled), a
nested message a struct (null when unset), a repeated field a list, a map a
list of ``(key, value)`` pairs. Each column's type comes from the descriptor,
never from the data (``field_type``), as the JAX codec's Arrow schema does.

``google.protobuf`` is imported, and ``protoc`` looked up, only when a codec
is built; where either is missing the build raises a ``ConfigError`` that
names it. Config:

    type: protobuf
    proto_file: schemas/event.proto     # or proto_source: |-
    message_type: my.pkg.Event
    include_paths: [schemas/]           # optional protoc -I entries
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Any, Optional

from arkflow_tpu_torch.batch import MessageBatch, column_from_pylist
from arkflow_tpu_torch.components import Codec, Resource, register_codec
from arkflow_tpu_torch.errors import CodecError, ConfigError

CODEC_KEYS = ("message_type", "proto_source", "proto_file", "include_paths")


def _protobuf():
    """The ``google.protobuf`` modules the codec needs, or a ``ConfigError``."""
    try:
        from google.protobuf import descriptor_pb2, descriptor_pool, message_factory
        from google.protobuf.descriptor import FieldDescriptor
    except ImportError as e:
        raise ConfigError("protobuf codec: the google.protobuf package is not installed "
                          f"({e})") from e
    return descriptor_pb2, descriptor_pool, message_factory, FieldDescriptor


def compile_proto(proto_source: Optional[str], proto_file: Optional[str],
                  include_paths: Optional[list[str]] = None):
    """Run protoc -> FileDescriptorSet -> descriptor pool. Returns the pool."""
    descriptor_pb2, descriptor_pool, _, _ = _protobuf()
    protoc = shutil.which("protoc")
    if protoc is None:
        raise ConfigError("protobuf codec: protoc binary not found on PATH")
    with tempfile.TemporaryDirectory() as td:
        tdp = Path(td)
        if proto_source is not None:
            proto_path = tdp / "inline.proto"
            proto_path.write_text(proto_source)
            includes = [str(tdp)]
        else:
            proto_path = Path(proto_file)
            if not proto_path.exists():
                raise ConfigError(f"protobuf codec: {proto_path} not found")
            includes = [str(proto_path.parent)]
        includes += [str(p) for p in (include_paths or [])]
        out = tdp / "descriptor.pb"
        cmd = [protoc, f"--descriptor_set_out={out}", "--include_imports",
               *(f"-I{inc}" for inc in includes), str(proto_path)]
        res = subprocess.run(cmd, capture_output=True)
        if res.returncode != 0:
            raise ConfigError(f"protoc failed: {res.stderr.decode()[:400]}")
        fds = descriptor_pb2.FileDescriptorSet()
        fds.ParseFromString(out.read_bytes())
    pool = descriptor_pool.DescriptorPool()
    for f in fds.file:
        pool.Add(f)
    return pool


def _message_class_for(desc):
    return _protobuf()[2].GetMessageClass(desc)


def _is_map(field) -> bool:
    return (field.label == field.LABEL_REPEATED and field.message_type is not None
            and field.message_type.GetOptions().map_entry)


def _msg_to_row(msg) -> dict[str, Any]:
    """Canonical proto -> dict: all declared fields present (defaults filled)."""
    row: dict[str, Any] = {}
    for field in msg.DESCRIPTOR.fields:
        value = getattr(msg, field.name)
        if _is_map(field):
            val_field = field.message_type.fields_by_name["value"]
            if val_field.message_type is not None:
                row[field.name] = {k: _msg_to_row(v) for k, v in value.items()}
            else:
                row[field.name] = dict(value)
        elif field.label == field.LABEL_REPEATED:
            row[field.name] = ([_msg_to_row(v) for v in value]
                               if field.message_type is not None else list(value))
        elif field.message_type is not None:
            row[field.name] = _msg_to_row(value) if msg.HasField(field.name) else None
        else:
            row[field.name] = value
    return row


def _row_to_msg(cls, row: dict[str, Any]):
    msg = cls()
    for field in msg.DESCRIPTOR.fields:
        if row.get(field.name) is None:
            continue
        value = row[field.name]
        if _is_map(field):
            # a map column's rows are [(k, v), ...]; a dict is taken too
            items = value.items() if isinstance(value, dict) else value
            target = getattr(msg, field.name)
            val_field = field.message_type.fields_by_name["value"]
            for k, v in items:
                if val_field.message_type is not None:
                    target[k].CopyFrom(_row_to_msg(_message_class_for(val_field.message_type), v))
                else:
                    target[k] = v
        elif field.label == field.LABEL_REPEATED:
            target = getattr(msg, field.name)
            if field.message_type is not None:
                for item in value:
                    target.add().CopyFrom(_row_to_msg(_message_class_for(field.message_type),
                                                      item))
            else:
                target.extend(value)
        elif field.message_type is not None:
            getattr(msg, field.name).CopyFrom(
                _row_to_msg(_message_class_for(field.message_type), value))
        else:
            setattr(msg, field.name, value)
    return msg


def field_type(field):
    """A field descriptor's column type (``batch.type_name`` spells it as
    the JAX codec's Arrow schema does)."""
    FD = _protobuf()[3]
    scalar = {
        FD.TYPE_DOUBLE: "double", FD.TYPE_FLOAT: "float",
        FD.TYPE_INT32: "int32", FD.TYPE_SINT32: "int32", FD.TYPE_SFIXED32: "int32",
        FD.TYPE_INT64: "int64", FD.TYPE_SINT64: "int64", FD.TYPE_SFIXED64: "int64",
        FD.TYPE_UINT32: "uint32", FD.TYPE_FIXED32: "uint32",
        FD.TYPE_UINT64: "uint64", FD.TYPE_FIXED64: "uint64",
        FD.TYPE_BOOL: "bool", FD.TYPE_STRING: "string", FD.TYPE_BYTES: "binary",
        FD.TYPE_ENUM: "int32",
    }
    if _is_map(field):
        return ("map", field_type(field.message_type.fields_by_name["key"]),
                field_type(field.message_type.fields_by_name["value"]))
    if field.type == FD.TYPE_MESSAGE:
        inner = ("struct", tuple((f.name, field_type(f)) for f in field.message_type.fields))
    else:
        inner = scalar.get(field.type, "string")
    return ("list", inner) if field.label == FD.LABEL_REPEATED else inner


class ProtobufCodec(Codec):
    def __init__(self, pool, message_type: str):
        try:
            desc = pool.FindMessageTypeByName(message_type)
        except KeyError as e:
            raise ConfigError(f"protobuf codec: message type {message_type!r} not found") from e
        self.cls = _message_class_for(desc)
        self.message_type = message_type
        #: column name -> type, from the descriptor
        self.types = {f.name: field_type(f) for f in desc.fields}

    def rows_to_batch(self, rows: list[dict[str, Any]]) -> MessageBatch:
        """Row dicts as columns of the message's types."""
        return MessageBatch({name: column_from_pylist([r.get(name) for r in rows], t)
                             for name, t in self.types.items()}, len(rows))

    def decode(self, payload: bytes) -> MessageBatch:
        return self.decode_many([payload])

    def decode_many(self, payloads: list[bytes]) -> MessageBatch:
        rows = []
        for payload in payloads:
            msg = self.cls()
            try:
                msg.ParseFromString(payload)
            except Exception as e:
                raise CodecError(f"protobuf decode failed for {self.message_type}: {e}") from e
            rows.append(_msg_to_row(msg))
        return self.rows_to_batch(rows)

    def encode(self, batch: MessageBatch) -> list[bytes]:
        out = []
        for row in batch.to_pylist():
            try:
                out.append(_row_to_msg(self.cls, row).SerializeToString())
            except Exception as e:
                raise CodecError(f"protobuf encode failed for {self.message_type}: {e}") from e
        return out


def check_config(config: dict) -> None:
    if not config.get("message_type"):
        raise ConfigError("protobuf codec requires 'message_type'")
    if bool(config.get("proto_source")) == bool(config.get("proto_file")):
        raise ConfigError("protobuf codec requires exactly one of 'proto_source' or 'proto_file'")


def build_from_config(config: dict) -> ProtobufCodec:
    """The codec of a checked config (``check_config`` runs first, at
    ``--validate`` and at build)."""
    pool = compile_proto(config.get("proto_source"), config.get("proto_file"),
                         config.get("include_paths"))
    return ProtobufCodec(pool, config["message_type"])


@register_codec("protobuf", keys=CODEC_KEYS, check=check_config)
def _build(config: dict, resource: Resource) -> ProtobufCodec:
    return build_from_config(config)
