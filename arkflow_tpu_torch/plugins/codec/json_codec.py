"""JSON codec: schema-inferred decode, one JSON document a row on encode.

Counterpart of ``arkflow_tpu/plugins/codec/json_codec.py`` without Arrow.
A payload is a JSON object, an array of objects, or NDJSON. The JAX codec
infers its columns on one of two routes, and so does this one:

- ``decode_many`` of several payloads, none of them an array: the JAX codec
  joins them into NDJSON for ``pyarrow.json``'s reader. ``_read_ndjson``
  infers as that reader does: a number column is int64 while every value
  is an int within int64, else double (a larger int as its nearest double);
  a column mixing kinds (a bool among numbers, an array among strings)
  fails it; struct fields and columns come in the order first seen; rows
  of ``{}`` alone are rows without columns. Where the reader fails, or
  types any column as a timestamp (every string of a column ISO-8601 at
  second precision), the JAX codec falls back to the row route, as this
  one does.
- the row route (``_rows_to_batch``): the union of the rows' keys, each
  column inferred and converted as ``pyarrow.array`` would
  (``batch.column_from_pylist``): ints with a float become double, a bool
  first settles a bool column, ISO strings stay strings, and values that do
  not make one column raise ``CodecError("cannot infer Arrow schema from
  JSON: ...")``. An int beyond int64 raises that ``CodecError`` too, where
  the JAX codec lets pyarrow's bare ``OverflowError`` out.

``encode`` writes ``json.dumps`` of each row's ``to_pylist()`` values, bytes
as UTF-8 text or else base64.
"""

from __future__ import annotations

import base64
import calendar
import json
import math
import re
from typing import Any, Optional

from arkflow_tpu_torch.batch import ColumnTypeError, MessageBatch, column_from_pylist
from arkflow_tpu_torch.components import Codec, register_codec
from arkflow_tpu_torch.errors import CodecError

#: the strings pyarrow.json's reader types as ``timestamp[s]``: a date, or a
#: date and an hour with optional minutes and seconds and an optional zone
_ISO_SECONDS = re.compile(
    rb"(\d{4})-(\d{2})-(\d{2})(?:[T ](\d{2})(?::(\d{2})(?::(\d{2}))?)?"
    rb"(?:Z|[+-]\d{2}(?::?\d{2})?)?)?")


def _is_timestamp(s: str) -> bool:
    m = _ISO_SECONDS.fullmatch(s.encode("utf-8", "surrogatepass"))
    if m is None:
        return False
    year, month, day = (int(g) for g in m.group(1, 2, 3))
    if not 1 <= month <= 12 or not 1 <= day <= calendar.monthrange(year or 2000, month)[1]:
        return False
    hour, minute, sec = (int(g) if g else 0 for g in m.group(4, 5, 6))
    return hour < 24 and minute < 60 and sec < 60


class _ReaderFails(Exception):
    """The NDJSON reader would refuse the input, or type a timestamp: the
    row route decides instead."""


class _Kind:
    """What pyarrow.json's reader has seen at one path of the rows."""

    __slots__ = ("kind", "is_int", "all_ts", "child", "fields")

    def __init__(self):
        self.kind: Optional[str] = None
        self.is_int = True
        self.all_ts = True
        self.child: Optional[_Kind] = None
        self.fields: dict[str, _Kind] = {}

    def visit(self, v: Any) -> None:
        if v is None:
            return
        if isinstance(v, bool):
            kind = "boolean"
        elif isinstance(v, (int, float)):
            kind = "number"
        elif isinstance(v, str):
            kind = "string"
        elif isinstance(v, list):
            kind = "array"
        else:
            kind = "object"
        if self.kind is None:
            self.kind = kind
        elif self.kind != kind:
            raise _ReaderFails(f"changed from {self.kind} to {kind}")
        if kind == "number":
            if isinstance(v, float):
                if not math.isfinite(v):  # the reader takes no NaN or Infinity literal
                    raise _ReaderFails("non-finite number")
                self.is_int = False
            elif not -2 ** 63 <= v < 2 ** 63:
                self.is_int = False
        elif kind == "string":
            self.all_ts = self.all_ts and _is_timestamp(v)
        elif kind == "array":
            if self.child is None:
                self.child = _Kind()
            for x in v:
                self.child.visit(x)
        elif kind == "object":
            for k, x in v.items():
                f = self.fields.get(k)
                if f is None:
                    f = self.fields[k] = _Kind()
                f.visit(x)

    def type(self):
        if self.kind is None:
            return "null"
        if self.kind == "boolean":
            return "bool"
        if self.kind == "number":
            return "int64" if self.is_int else "double"
        if self.kind == "string":
            if self.all_ts:
                raise _ReaderFails("timestamp column")
            return "string"
        if self.kind == "array":
            return ("list", "null" if self.child is None else self.child.type())
        return ("struct", tuple((k, f.type()) for k, f in self.fields.items()))


def _as_read(v: Any, t) -> Any:
    """A JSON value as the reader stores it in type ``t``: an int in a double
    column becomes its nearest double, at any magnitude."""
    if v is None:
        return None
    if t == "double":
        return float(v)
    if isinstance(t, tuple):
        if t[0] == "list":
            return [_as_read(x, t[1]) for x in v]
        return {n: _as_read(v.get(n), f) for n, f in t[1]}
    return v


def _read_ndjson(blob: bytes) -> Optional[MessageBatch]:
    """The batch pyarrow.json's reader makes of NDJSON, or None where it
    fails or types a timestamp."""
    root = _Kind()
    rows: list[dict] = []
    try:
        for line in blob.split(b"\n"):
            if not line.strip():
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                return None
            if not isinstance(obj, dict):
                return None
            root.visit(obj)
            rows.append(obj)
        if not rows:
            return None
        types = {k: f.type() for k, f in root.fields.items()}
    except _ReaderFails:
        return None
    try:
        return MessageBatch({k: column_from_pylist([_as_read(r.get(k), t) for r in rows], t)
                             for k, t in types.items()}, len(rows))
    except ColumnTypeError:
        return None


def _rows_to_batch(rows: list[dict[str, Any]]) -> MessageBatch:
    if not rows:
        return MessageBatch.empty()
    # the union of keys over all rows, in the order first seen; a row
    # without a key is null there
    keys: dict[str, None] = {}
    for r in rows:
        keys.update(dict.fromkeys(r))
    try:
        return MessageBatch({k: column_from_pylist([r.get(k) for r in rows]) for k in keys})
    except ColumnTypeError as e:
        raise CodecError(f"cannot infer Arrow schema from JSON: {e}") from e


def _cell_to_json(v: Any) -> Any:
    if isinstance(v, bytes):
        try:
            return v.decode("utf-8")
        except UnicodeDecodeError:
            return base64.b64encode(v).decode("ascii")
    return v


def _parse_payload_rows(payload: bytes) -> list[dict[str, Any]]:
    """One payload -> row dicts: a JSON object, array of objects, or NDJSON."""
    text = payload.decode("utf-8", "replace").strip()
    if not text:
        return []
    rows: list[dict[str, Any]] = []
    if text.startswith("["):
        try:
            parsed = json.loads(text)
        except json.JSONDecodeError as e:
            raise CodecError(f"invalid JSON: {e}") from e
        if not isinstance(parsed, list) or not all(isinstance(r, dict) for r in parsed):
            raise CodecError("JSON array payload must contain objects")
        return parsed
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            raise CodecError(f"invalid JSON line: {e}") from e
        if not isinstance(obj, dict):
            raise CodecError(f"JSON line must be an object, got {type(obj).__name__}")
        rows.append(obj)
    return rows


class JsonCodec(Codec):
    def decode_many(self, payloads: list[bytes]) -> MessageBatch:
        """Several payloads as one batch: the NDJSON reader's inference when
        none is an array and the reader would take them, else the row
        route over every payload's rows."""
        if len(payloads) == 1:
            return self.decode(payloads[0])
        blob = b"\n".join(p.strip() for p in payloads if p.strip())
        if not blob:
            return MessageBatch.empty()
        if not blob.lstrip().startswith(b"["):
            batch = _read_ndjson(blob)
            if batch is not None:
                return batch
        rows: list[dict[str, Any]] = []
        for p in payloads:
            rows.extend(_parse_payload_rows(p))
        return _rows_to_batch(rows)

    def decode(self, payload: bytes) -> MessageBatch:
        return _rows_to_batch(_parse_payload_rows(payload))

    def encode(self, batch: MessageBatch) -> list[bytes]:
        return [json.dumps({k: _cell_to_json(v) for k, v in row.items()}).encode()
                for row in batch.to_pylist()]


@register_codec("json")
def _build_json(config: dict, resource) -> JsonCodec:
    return JsonCodec()
