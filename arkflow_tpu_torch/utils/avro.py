"""Minimal Avro Object Container File reader/writer (no external libs).

Counterpart of ``arkflow_tpu/utils/avro.py``. The binary codec and the
container framing are the JAX package's, line for line:

- container framing: ``Obj\\x01`` magic, metadata map (``avro.schema``,
  ``avro.codec``), 16-byte sync marker, blocks of [count, byte-size, data,
  sync]
- codecs: ``null`` and ``deflate`` (stdlib zlib, raw stream)
- binary encoding: null, boolean, int/long (zigzag varint), float, double,
  bytes, string, enum, fixed, array, map, record, and unions (decoded
  generally; the writer emits the common ``["null", T]`` form)

``records_to_batch`` builds the port's columns (``batch.py``) where JAX
builds an Arrow batch with ``pa.RecordBatch.from_pylist`` and then casts
each column to its Avro-declared type: the column takes the type
``column_from_pylist`` infers, then the declared one where the values
convert to it (an all-null chunk keeps its declared type), and keeps the
inferred type where they do not, as a failed cast keeps it in JAX.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Iterator

from arkflow_tpu_torch.batch import (ColumnTypeError, MessageBatch, ObjectColumn,
                                     column_from_pylist, infer_type)
from arkflow_tpu_torch.errors import CodecError

MAGIC = b"Obj\x01"


# -- primitive binary codec -------------------------------------------------

def _read_long(buf: BinaryIO) -> int:
    """Zigzag varint."""
    shift, acc = 0, 0
    while True:
        b = buf.read(1)
        if not b:
            raise CodecError("avro: truncated varint")
        acc |= (b[0] & 0x7F) << shift
        if not b[0] & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)


def _write_long(out: io.BytesIO, n: int) -> None:
    n = (n << 1) ^ (n >> 63)
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            return


def _read_bytes(buf: BinaryIO) -> bytes:
    n = _read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise CodecError("avro: truncated bytes")
    return data


def _write_bytes(out: io.BytesIO, data: bytes) -> None:
    _write_long(out, len(data))
    out.write(data)


def decode_value(schema: Any, buf: BinaryIO) -> Any:
    """Decode one value of `schema` (parsed JSON) from `buf`."""
    if isinstance(schema, str):
        t = schema
        if t == "null":
            return None
        if t == "boolean":
            return buf.read(1) == b"\x01"
        if t in ("int", "long"):
            return _read_long(buf)
        if t == "float":
            return struct.unpack("<f", buf.read(4))[0]
        if t == "double":
            return struct.unpack("<d", buf.read(8))[0]
        if t == "bytes":
            return _read_bytes(buf)
        if t == "string":
            return _read_bytes(buf).decode()
        raise CodecError(f"avro: unsupported primitive {t!r}")
    if isinstance(schema, list):  # union: index then value
        idx = _read_long(buf)
        if not 0 <= idx < len(schema):
            raise CodecError(f"avro: union index {idx} out of range")
        return decode_value(schema[idx], buf)
    t = schema.get("type")
    if t == "record":
        return {f["name"]: decode_value(f["type"], buf) for f in schema["fields"]}
    if t == "enum":
        symbols = schema["symbols"]
        idx = _read_long(buf)
        if not 0 <= idx < len(symbols):
            raise CodecError(f"avro: enum index {idx} out of range")
        return symbols[idx]
    if t == "fixed":
        return buf.read(int(schema["size"]))
    if t == "array":
        out = []
        while True:
            n = _read_long(buf)
            if n == 0:
                return out
            if n < 0:  # block with byte-size prefix
                n = -n
                _read_long(buf)
            for _ in range(n):
                out.append(decode_value(schema["items"], buf))
    if t == "map":
        out = {}
        while True:
            n = _read_long(buf)
            if n == 0:
                return out
            if n < 0:
                n = -n
                _read_long(buf)
            for _ in range(n):
                key = _read_bytes(buf).decode()
                out[key] = decode_value(schema["values"], buf)
    if t is not None:
        return decode_value(t, buf)  # {"type": "string"} wrapper form
    raise CodecError(f"avro: unsupported schema {schema!r}")


def encode_value(schema: Any, value: Any, out: io.BytesIO) -> None:
    if isinstance(schema, str):
        t = schema
        if t == "null":
            return
        if t == "boolean":
            out.write(b"\x01" if value else b"\x00")
        elif t in ("int", "long"):
            _write_long(out, int(value))
        elif t == "float":
            out.write(struct.pack("<f", float(value)))
        elif t == "double":
            out.write(struct.pack("<d", float(value)))
        elif t == "bytes":
            _write_bytes(out, bytes(value))
        elif t == "string":
            _write_bytes(out, str(value).encode())
        else:
            raise CodecError(f"avro: unsupported primitive {t!r}")
        return
    if isinstance(schema, list):  # union: pick null for None else first non-null
        if value is None and "null" in schema:
            _write_long(out, schema.index("null"))
            return
        for i, branch in enumerate(schema):
            if branch != "null":
                _write_long(out, i)
                encode_value(branch, value, out)
                return
        raise CodecError("avro: no union branch for value")
    t = schema.get("type")
    if t == "record":
        for f in schema["fields"]:
            encode_value(f["type"], (value or {}).get(f["name"]), out)
        return
    if t == "enum":
        _write_long(out, schema["symbols"].index(value))
        return
    if t == "array":
        if value:
            _write_long(out, len(value))
            for v in value:
                encode_value(schema["items"], v, out)
        _write_long(out, 0)
        return
    if t == "map":
        if value:
            _write_long(out, len(value))
            for k, v in value.items():
                _write_bytes(out, str(k).encode())
                encode_value(schema["values"], v, out)
        _write_long(out, 0)
        return
    if t is not None:
        encode_value(t, value, out)
        return
    raise CodecError(f"avro: unsupported schema {schema!r}")


# -- container files --------------------------------------------------------

def read_container(stream: BinaryIO) -> tuple[dict, Iterator[dict]]:
    """Open an Avro OCF -> (parsed schema, iterator of record dicts)."""
    if stream.read(4) != MAGIC:
        raise CodecError("avro: bad magic (not an Object Container File)")
    meta: dict[str, bytes] = {}
    while True:
        n = _read_long(stream)
        if n == 0:
            break
        if n < 0:
            n = -n
            _read_long(stream)
        for _ in range(n):
            key = _read_bytes(stream).decode()
            meta[key] = _read_bytes(stream)
    sync = stream.read(16)
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise CodecError(f"avro: codec {codec!r} not supported (null/deflate)")
    try:
        schema = json.loads(meta["avro.schema"].decode())
    except (KeyError, json.JSONDecodeError) as e:
        raise CodecError(f"avro: bad schema metadata: {e}") from e

    def records() -> Iterator[dict]:
        while True:
            head = stream.read(1)
            if not head:
                return
            rest = io.BytesIO(head)
            count = _read_long(_Chain(rest, stream))
            size = _read_long(stream)
            block = stream.read(size)
            if len(block) != size:
                raise CodecError("avro: truncated block")
            if codec == "deflate":
                block = zlib.decompress(block, -15)  # raw deflate per spec
            if stream.read(16) != sync:
                raise CodecError("avro: sync marker mismatch")
            buf = io.BytesIO(block)
            for _ in range(count):
                yield decode_value(schema, buf)

    return schema, records()


class _Chain:
    """Read from a prefix buffer then fall through to the stream."""

    def __init__(self, first: BinaryIO, rest: BinaryIO):
        self.first, self.rest = first, rest

    def read(self, n: int) -> bytes:
        data = self.first.read(n)
        if len(data) < n:
            data += self.rest.read(n - len(data))
        return data


def to_column_type(schema: Any):
    """Best-effort Avro schema -> column type (``batch.py``'s spelling);
    None where inference must rule (general unions, maps). Used so an
    all-null column in one batch still gets its declared type instead of
    drifting to ``null``."""
    if isinstance(schema, str):
        return {
            "null": "null", "boolean": "bool", "int": "int32", "long": "int64",
            "float": "float", "double": "double", "bytes": "binary", "string": "string",
        }.get(schema)
    if isinstance(schema, list):
        branches = [b for b in schema if b != "null"]
        if len(branches) == 1:  # ["null", T]: nullable T
            return to_column_type(branches[0])
        return None
    t = schema.get("type")
    if t == "enum":
        return "string"
    if t == "fixed":
        return f"fixed_size_binary[{int(schema['size'])}]"
    if t == "array":
        items = to_column_type(schema["items"])
        return ("list", items) if items is not None else None
    if t == "record":
        fields = []
        for f in schema["fields"]:
            ft = to_column_type(f["type"])
            if ft is None:
                return None
            fields.append((f["name"], ft))
        return ("struct", tuple(fields))
    if t == "map":
        return None  # decoded as plain dicts; let inference make a struct
    if t is not None:
        return to_column_type(t)
    return None


def _fixed_size(t) -> int | None:
    if isinstance(t, str) and t.startswith("fixed_size_binary["):
        return int(t[len("fixed_size_binary["):-1])
    return None


def _has_fixed(t) -> bool:
    if isinstance(t, tuple):
        return any(_has_fixed(c) for c in (t[1:] if t[0] != "struct" else
                                            [f for _, f in t[1]]))
    return _fixed_size(t) is not None


def _cast_fixed(v: Any, t) -> Any:
    """One value held as type ``t``, where ``t`` holds a fixed-size binary
    (a type ``batch.convert_value`` does not carry)."""
    if v is None:
        return None
    n = _fixed_size(t)
    if n is not None:
        if not isinstance(v, bytes) or len(v) != n:
            raise ColumnTypeError(f"fixed_size_binary[{n}] needs {n} bytes, got {v!r}")
        return v
    if t[0] == "list":
        return [_cast_fixed(x, t[1]) for x in v]
    return {name: _cast_fixed(v.get(name), f) for name, f in t[1]}


def _declared_column(values: list, want):
    """The column JAX's ``col.cast(want)`` gives, or None where that cast
    fails (the caller keeps the inferred column)."""
    try:
        if _has_fixed(want):
            return ObjectColumn([_cast_fixed(v, want) for v in values], want)
        return column_from_pylist(values, want)
    except ColumnTypeError:
        return None


def records_to_batch(schema: Any, rows: list[dict]) -> MessageBatch:
    """Rows -> batch with Avro-declared column types where mappable (an
    all-null chunk must not produce a null-typed column). The columns are
    the first row's keys, as ``pa.RecordBatch.from_pylist`` takes them."""
    names = list(rows[0]) if rows else []
    targets = {}
    if isinstance(schema, dict) and schema.get("type") == "record":
        targets = {f["name"]: to_column_type(f["type"]) for f in schema["fields"]}
    cols = {}
    for name in names:
        values = [r.get(name) for r in rows]
        inferred = infer_type(values)
        want = targets.get(name)
        col = None
        if want is not None and want != inferred and want != "null":
            col = _declared_column(values, want)
        cols[name] = col if col is not None else column_from_pylist(values, inferred)
    return MessageBatch(cols, num_rows=len(rows))


def write_container(stream: BinaryIO, schema: dict | str | list, records: list,
                    codec: str = "null", block_records: int = 1000) -> None:
    """Write records to an Avro OCF (testing + avro outputs)."""
    if codec not in ("null", "deflate"):
        raise CodecError(f"avro: codec {codec!r} not supported")
    sync = os.urandom(16)
    stream.write(MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode(), "avro.codec": codec.encode()}
    head = io.BytesIO()
    _write_long(head, len(meta))
    for k, v in meta.items():
        _write_bytes(head, k.encode())
        _write_bytes(head, v)
    _write_long(head, 0)
    stream.write(head.getvalue())
    stream.write(sync)
    for i in range(0, len(records), block_records):
        chunk = records[i:i + block_records]
        body = io.BytesIO()
        for r in chunk:
            encode_value(schema, r, body)
        data = body.getvalue()
        if codec == "deflate":
            comp = zlib.compressobj(wbits=-15)
            data = comp.compress(data) + comp.flush()
        blk = io.BytesIO()
        _write_long(blk, len(chunk))
        _write_long(blk, len(data))
        stream.write(blk.getvalue())
        stream.write(data)
        stream.write(sync)
