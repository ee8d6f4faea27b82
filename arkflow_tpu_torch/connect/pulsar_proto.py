"""A proto2 wire codec for the ``PulsarApi`` subset, without ``google.protobuf``.

The JAX package compiles its ``PulsarApi`` messages through ``protoc`` and
``google.protobuf`` (``arkflow_tpu/connect/pulsar_client.py``). The card's
machine has neither, so the port parses the same ``.proto`` text
(``PULSAR_API_PROTO``) with a small proto2 parser and encodes and decodes
messages itself, with ``SerializeToString()``'s bytes:

- field types ``string``, ``bytes``, ``bool``, ``int32``, ``int64``,
  ``uint32``, ``uint64``, enums (varints; a negative value takes ten
  bytes) and nested messages (length-delimited);
- labels ``required``, ``optional`` and ``repeated`` (unpacked, as proto2
  has it), with field presence: a field is written only when set, and
  ``encode`` raises ``EncodeError`` where a required field is unset, in
  this message or in a nested one it holds;
- fields are written in field-number order, then the unknown fields the
  message was decoded with, in the order they came;
- on read, an unset field gives its ``[default = ...]``, else the type's
  zero (an enum's first value, an empty message); a field seen twice keeps
  its last value, and a nested message seen twice is merged;
- the decoder keeps every field it does not know, of every wire type
  (varint, 64-bit, length-delimited, groups, 32-bit), and an enum value
  outside the enum, as unknown fields, as ``google.protobuf`` does; a real
  broker sends fields outside this subset.

    cmd = Message("BaseCommand", type=FLOW,
                  flow=Message("CommandFlow", consumer_id=1, messagePermits=1000))
    raw = cmd.encode()
    back = Message.decode("BaseCommand", raw)
    back.flow.messagePermits, back.has("ping")     # (1000, False)
"""

from __future__ import annotations

import re
from typing import Any

PULSAR_API_PROTO = r'''
syntax = "proto2";
package pulsar.proto;

message KeyValue {
  required string key = 1;
  required string value = 2;
}

message MessageIdData {
  required uint64 ledgerId = 1;
  required uint64 entryId = 2;
  optional int32 partition = 3 [default = -1];
  optional int32 batch_index = 4 [default = -1];
}

enum CompressionType {
  NONE = 0;
  LZ4 = 1;
  ZLIB = 2;
  ZSTD = 3;
  SNAPPY = 4;
}

message MessageMetadata {
  required string producer_name = 1;
  required uint64 sequence_id = 2;
  required uint64 publish_time = 3;
  repeated KeyValue properties = 4;
  optional string replicated_from = 5;
  optional string partition_key = 6;
  repeated string replicate_to = 7;
  optional CompressionType compression = 8 [default = NONE];
  optional uint32 uncompressed_size = 9 [default = 0];
  optional int32 num_messages_in_batch = 11;
}

message SingleMessageMetadata {
  repeated KeyValue properties = 1;
  optional string partition_key = 2;
  required int32 payload_size = 3;
}

message CommandConnect {
  required string client_version = 1;
  optional bytes auth_data = 3;
  optional int32 protocol_version = 4 [default = 0];
  optional string auth_method_name = 5;
  optional string proxy_to_broker_url = 6;
}

message CommandConnected {
  required string server_version = 1;
  optional int32 protocol_version = 2 [default = 0];
  optional int32 max_message_size = 3;
}

message AuthData {
  optional string auth_method_name = 1;
  optional bytes auth_data = 2;
}

message CommandAuthChallenge {
  optional string server_version = 1;
  optional AuthData challenge = 2;
  optional int32 protocol_version = 3;
}

message CommandAuthResponse {
  optional string client_version = 1;
  optional AuthData response = 2;
  optional int32 protocol_version = 3;
}

message CommandSubscribe {
  enum SubType {
    Exclusive = 0;
    Shared = 1;
    Failover = 2;
    Key_Shared = 3;
  }
  required string topic = 1;
  required string subscription = 2;
  required SubType subType = 3;
  required uint64 consumer_id = 4;
  required uint64 request_id = 5;
  optional string consumer_name = 6;
  optional int32 priority_level = 7;
  optional bool durable = 8 [default = true];
  optional MessageIdData start_message_id = 9;
  repeated KeyValue metadata = 10;
  optional bool read_compacted = 11;
  enum InitialPosition {
    Latest = 0;
    Earliest = 1;
  }
  optional InitialPosition initialPosition = 13 [default = Latest];
}

message CommandLookupTopic {
  required string topic = 1;
  required uint64 request_id = 2;
  optional bool authoritative = 3 [default = false];
}

message CommandLookupTopicResponse {
  enum LookupType {
    Redirect = 0;
    Connect = 1;
    Failed = 2;
  }
  optional string brokerServiceUrl = 1;
  optional string brokerServiceUrlTls = 2;
  optional LookupType response = 3;
  required uint64 request_id = 4;
  optional bool authoritative = 5 [default = false];
  optional ServerError error = 6;
  optional string message = 7;
  optional bool proxy_through_service_url = 8 [default = false];
}

message CommandProducer {
  required string topic = 1;
  required uint64 producer_id = 2;
  required uint64 request_id = 3;
  optional string producer_name = 4;
  optional bool encrypted = 5 [default = false];
  repeated KeyValue metadata = 6;
}

message CommandSend {
  required uint64 producer_id = 1;
  required uint64 sequence_id = 2;
  optional int32 num_messages = 3 [default = 1];
}

message CommandSendReceipt {
  required uint64 producer_id = 1;
  required uint64 sequence_id = 2;
  optional MessageIdData message_id = 3;
}

enum ServerError {
  UnknownError = 0;
  MetadataError = 1;
  PersistenceError = 2;
  AuthenticationError = 3;
  AuthorizationError = 4;
  ConsumerBusy = 5;
  ServiceNotReady = 6;
  ProducerBlockedQuotaExceededError = 7;
  ProducerBlockedQuotaExceededException = 8;
  ChecksumError = 9;
  UnsupportedVersionError = 10;
  TopicNotFound = 11;
  SubscriptionNotFound = 12;
  ConsumerNotFound = 13;
  TooManyRequests = 14;
  TopicTerminatedError = 15;
  ProducerBusy = 16;
  InvalidTopicName = 17;
}

message CommandSendError {
  required uint64 producer_id = 1;
  required uint64 sequence_id = 2;
  required ServerError error = 3;
  required string message = 4;
}

message CommandMessage {
  required uint64 consumer_id = 1;
  required MessageIdData message_id = 2;
  optional uint32 redelivery_count = 3 [default = 0];
}

message CommandAck {
  enum AckType {
    Individual = 0;
    Cumulative = 1;
  }
  required uint64 consumer_id = 1;
  required AckType ack_type = 2;
  repeated MessageIdData message_id = 3;
}

message CommandFlow {
  required uint64 consumer_id = 1;
  required uint32 messagePermits = 2;
}

message CommandUnsubscribe {
  required uint64 consumer_id = 1;
  required uint64 request_id = 2;
}

message CommandSuccess {
  required uint64 request_id = 1;
}

message CommandError {
  required uint64 request_id = 1;
  required ServerError error = 2;
  required string message = 3;
}

message CommandCloseProducer {
  required uint64 producer_id = 1;
  required uint64 request_id = 2;
}

message CommandCloseConsumer {
  required uint64 consumer_id = 1;
  required uint64 request_id = 2;
}

message CommandPing {
}

message CommandPong {
}

message BaseCommand {
  enum Type {
    CONNECT = 2;
    CONNECTED = 3;
    SUBSCRIBE = 4;
    PRODUCER = 5;
    SEND = 6;
    SEND_RECEIPT = 7;
    SEND_ERROR = 8;
    MESSAGE = 9;
    ACK = 10;
    FLOW = 11;
    UNSUBSCRIBE = 12;
    SUCCESS = 13;
    ERROR = 14;
    CLOSE_PRODUCER = 15;
    CLOSE_CONSUMER = 16;
    PRODUCER_SUCCESS = 17;
    PING = 18;
    PONG = 19;
    LOOKUP = 23;
    LOOKUP_RESPONSE = 24;
    AUTH_CHALLENGE = 36;
    AUTH_RESPONSE = 37;
  }
  required Type type = 1;
  optional CommandConnect connect = 2;
  optional CommandConnected connected = 3;
  optional CommandSubscribe subscribe = 4;
  optional CommandProducer producer = 5;
  optional CommandSend send = 6;
  optional CommandSendReceipt send_receipt = 7;
  optional CommandSendError send_error = 8;
  optional CommandMessage message = 9;
  optional CommandAck ack = 10;
  optional CommandFlow flow = 11;
  optional CommandUnsubscribe unsubscribe = 12;
  optional CommandSuccess success = 13;
  optional CommandError error = 14;
  optional CommandCloseProducer close_producer = 15;
  optional CommandCloseConsumer close_consumer = 16;
  optional CommandProducerSuccess producer_success = 17;
  optional CommandPing ping = 18;
  optional CommandPong pong = 19;
  optional CommandLookupTopic lookupTopic = 23;
  optional CommandLookupTopicResponse lookupTopicResponse = 24;
  optional CommandAuthChallenge authChallenge = 36;
  optional CommandAuthResponse authResponse = 37;
}

message CommandProducerSuccess {
  required uint64 request_id = 1;
  required string producer_name = 2;
  optional int64 last_sequence_id = 3 [default = -1];
}
'''


class EncodeError(Exception):
    """A message with an unset required field (``google.protobuf``'s
    ``EncodeError``)."""


class DecodeError(Exception):
    """Bytes that are not a proto2 message (a truncated varint or field)."""


# -- the schema ------------------------------------------------------------------

_SCALARS = ("string", "bytes", "bool", "int32", "int64", "uint32", "uint64")
_ZERO = {"string": "", "bytes": b"", "bool": False, "int32": 0, "int64": 0, "uint32": 0,
         "uint64": 0}


class Field:
    __slots__ = ("number", "name", "label", "type", "kind", "default")

    def __init__(self, number: int, name: str, label: str, type_: str, kind: str, default):
        self.number, self.name, self.label, self.type = number, name, label, type_
        #: "scalar", "enum" or "message"
        self.kind = kind
        self.default = default


def _parse_proto(text: str) -> tuple[dict, dict]:
    """The messages (name -> {field name: Field}, in field-number order) and
    enums (name -> {value name: number}, first value first) of a proto2
    file of messages, enums, nested enums and fields with defaults."""
    text = re.sub(r"//[^\n]*", "", text)
    tokens = re.findall(r"[A-Za-z_][\w.]*|-?\d+|\"[^\"]*\"|[{}=;\[\]]", text)
    enums: dict[str, dict[str, int]] = {}
    raw: dict[str, list[tuple]] = {}
    pos = 0

    def enum_body(name: str) -> None:
        nonlocal pos
        values: dict[str, int] = {}
        while tokens[pos] != "}":
            values[tokens[pos]] = int(tokens[pos + 2])  # NAME = N ;
            pos += 4
        pos += 1
        enums[name] = values

    while pos < len(tokens):
        tok = tokens[pos]
        if tok in ("syntax", "package"):
            pos = tokens.index(";", pos) + 1
        elif tok == "enum":
            pos += 3  # enum NAME {
            enum_body(tokens[pos - 2])
        elif tok == "message":
            msg = tokens[pos + 1]
            pos += 3
            fields = raw[msg] = []
            while tokens[pos] != "}":
                if tokens[pos] == "enum":
                    pos += 3
                    enum_body(f"{msg}.{tokens[pos - 2]}")
                    continue
                label, type_, fname, number = (tokens[pos], tokens[pos + 1], tokens[pos + 2],
                                               int(tokens[pos + 4]))
                pos += 5
                default = None
                if tokens[pos] == "[":  # [ default = V ]
                    default = tokens[pos + 3]
                    pos += 5
                pos += 1  # ;
                fields.append((number, fname, label, type_, default, msg))
            pos += 1
        else:
            raise ValueError(f"unexpected token {tok!r} in the proto text")
    messages: dict[str, dict[str, Field]] = {}
    for msg, fields in raw.items():
        out = {}
        for number, fname, label, type_, default, owner in sorted(fields):
            if type_ in _SCALARS:
                kind = "scalar"
                if default is None:
                    value = _ZERO[type_]
                elif type_ == "bool":
                    value = default == "true"
                elif type_ in ("string", "bytes"):
                    value = default.strip('"') if type_ == "string" else default.strip('"').encode()
                else:
                    value = int(default)
            elif type_ in raw:
                kind, value = "message", None
            else:
                kind = "enum"
                type_ = f"{owner}.{type_}" if f"{owner}.{type_}" in enums else type_
                values = enums[type_]
                value = values[default] if default is not None else next(iter(values.values()))
            out[fname] = Field(number, fname, label, type_, kind, value)
        messages[msg] = out
    return messages, enums


MESSAGES, ENUMS = _parse_proto(PULSAR_API_PROTO)
_BY_NUMBER = {m: {f.number: f for f in fields.values()} for m, fields in MESSAGES.items()}
_ENUM_NUMBERS = {e: set(v.values()) for e, v in ENUMS.items()}


# -- varints ---------------------------------------------------------------------

_M64 = (1 << 64) - 1


def _varint(n: int) -> bytes:
    n &= _M64
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    shift = acc = 0
    while True:
        if pos >= len(data):
            raise DecodeError("truncated varint")
        b = data[pos]
        pos += 1
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            return acc & _M64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than ten bytes")


def _signed(n: int, bits: int) -> int:
    n &= (1 << bits) - 1
    return n - (1 << bits) if n >> (bits - 1) else n


def _skip(data: bytes, pos: int, wire: int, number: int) -> int:
    """The position after a field's value of ``wire`` type."""
    if wire == 0:
        return _read_varint(data, pos)[1]
    if wire == 1:
        end = pos + 8
    elif wire == 5:
        end = pos + 4
    elif wire == 2:
        n, pos = _read_varint(data, pos)
        end = pos + n
    elif wire == 3:  # a group: fields up to its end tag
        while True:
            tag, pos = _read_varint(data, pos)
            if tag & 7 == 4:
                if tag >> 3 != number:
                    raise DecodeError("mismatched group end")
                return pos
            pos = _skip(data, pos, tag & 7, tag >> 3)
    else:
        raise DecodeError(f"wire type {wire} is not a field's")
    if end > len(data):
        raise DecodeError("truncated field")
    return end


# -- messages --------------------------------------------------------------------


class Message:
    """One message of ``MESSAGES``: set fields as attributes. Reading an
    unset field gives its default (an unset message field a detached empty
    message; an unset repeated field a new list kept on the message)."""

    __slots__ = ("_type", "_values", "_unknown")

    def __init__(self, _type: str, **values: Any):
        if _type not in MESSAGES:
            raise KeyError(f"no message {_type!r} in the PulsarApi subset")
        object.__setattr__(self, "_type", _type)
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_unknown", bytearray())
        for k, v in values.items():
            setattr(self, k, v)

    def _field(self, name: str) -> Field:
        try:
            return MESSAGES[self._type][name]
        except KeyError:
            raise AttributeError(f"{self._type} has no field {name!r}") from None

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        f = self._field(name)
        if name in self._values:
            return self._values[name]
        if f.label == "repeated":
            return self._values.setdefault(name, [])
        if f.kind == "message":
            return Message(f.type)
        return f.default

    def __setattr__(self, name: str, value: Any) -> None:
        f = self._field(name)
        if f.label == "repeated":
            value = list(value)
        self._values[name] = value

    def has(self, name: str) -> bool:
        """``HasField``: the field was set (a repeated one: it holds items)."""
        self._field(name)
        v = self._values.get(name)
        return bool(v) if isinstance(v, list) else name in self._values

    def clear(self, name: str) -> None:
        self._field(name)
        self._values.pop(name, None)

    def add(self, name: str, **values: Any) -> "Message":
        """Append a new message to a repeated message field and return it."""
        f = self._field(name)
        item = Message(f.type, **values)
        getattr(self, name).append(item)
        return item

    def copy(self) -> "Message":
        return Message.decode(self._type, self.encode(partial=True))

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, Message) or other._type != self._type:
            return NotImplemented
        return self.encode(partial=True) == other.encode(partial=True)

    def __repr__(self) -> str:
        set_fields = ", ".join(f"{k}={v!r}" for k, v in self._values.items()
                               if not isinstance(v, list) or v)
        return f"{self._type}({set_fields})"

    def to_dict(self) -> dict:
        """The set fields, nested messages as dicts (for comparisons)."""
        out = {}
        for name, f in MESSAGES[self._type].items():
            if not self.has(name):
                continue
            v = self._values[name]
            if f.kind == "message":
                v = [x.to_dict() for x in v] if f.label == "repeated" else v.to_dict()
            out[name] = v
        return out

    # -- encoding ------------------------------------------------------------

    def missing(self) -> list[str]:
        """The required fields left unset, here and in set nested messages
        (dotted paths)."""
        out = []
        for name, f in MESSAGES[self._type].items():
            if f.label == "required" and name not in self._values:
                out.append(name)
            elif f.kind == "message" and self.has(name):
                items = self._values[name] if f.label == "repeated" else [self._values[name]]
                for i, item in enumerate(items):
                    idx = f"[{i}]" if f.label == "repeated" else ""
                    out += [f"{name}{idx}.{m}" for m in item.missing()]
        return out

    def encode(self, partial: bool = False) -> bytes:
        """``SerializeToString()`` (``partial``: ``SerializePartialToString()``,
        which does not check required fields)."""
        if not partial:
            missing = self.missing()
            if missing:
                raise EncodeError(f"Message pulsar.proto.{self._type} is missing required "
                                  f"fields: {','.join(missing)}")
        out = bytearray()
        for f in MESSAGES[self._type].values():
            if f.name not in self._values:
                continue
            v = self._values[f.name]
            for item in (v if f.label == "repeated" else (v,)):
                out += self._encode_field(f, item)
        out += self._unknown
        return bytes(out)

    @staticmethod
    def _encode_field(f: Field, v: Any) -> bytes:
        if f.kind == "message":
            body = v.encode(partial=True)
            return _varint(f.number << 3 | 2) + _varint(len(body)) + body
        if f.type in ("string", "bytes"):
            raw = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            return _varint(f.number << 3 | 2) + _varint(len(raw)) + raw
        return _varint(f.number << 3) + _varint(int(v))

    # -- decoding ------------------------------------------------------------

    @classmethod
    def decode(cls, type_: str, data: bytes) -> "Message":
        """``ParseFromString`` (no check of required fields, as upb's)."""
        msg = cls(type_)
        msg._merge(bytes(data))
        return msg

    def _merge(self, data: bytes) -> None:
        fields = _BY_NUMBER[self._type]
        pos = 0
        while pos < len(data):
            start = pos
            tag, pos = _read_varint(data, pos)
            number, wire = tag >> 3, tag & 7
            if number == 0:
                raise DecodeError("field number 0")
            f = fields.get(number)
            want = 2 if f is not None and (f.kind == "message"
                                            or f.type in ("string", "bytes")) else 0
            if f is None or wire != want:
                pos = _skip(data, pos, wire, number)
                self._unknown.extend(data[start:pos])
                continue
            if wire == 0:
                raw, pos = _read_varint(data, pos)
                if f.kind == "enum":
                    value = _signed(raw, 32)
                    if value not in _ENUM_NUMBERS[f.type]:
                        self._unknown.extend(data[start:pos])
                        continue
                elif f.type == "bool":
                    value = raw != 0
                elif f.type == "int32":
                    value = _signed(raw, 32)
                elif f.type == "int64":
                    value = _signed(raw, 64)
                elif f.type == "uint32":
                    value = raw & 0xFFFFFFFF
                else:
                    value = raw
            else:
                n, pos = _read_varint(data, pos)
                if pos + n > len(data):
                    raise DecodeError("truncated field")
                body = data[pos:pos + n]
                pos += n
                if f.kind == "message":
                    if f.label != "repeated" and f.name in self._values:
                        self._values[f.name]._merge(body)  # a message seen twice merges
                        continue
                    value = Message.decode(f.type, body)
                elif f.type == "string":
                    try:
                        value = body.decode("utf-8")
                    except UnicodeDecodeError:
                        value = body  # upb hands back the bytes
                else:
                    value = body
            if f.label == "repeated":
                self._values.setdefault(f.name, []).append(value)
            else:
                self._values[f.name] = value
