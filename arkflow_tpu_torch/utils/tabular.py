"""CSV and NDJSON readers that type their columns as pyarrow's readers do.

The JAX package's ``file`` input reads CSV through ``pyarrow.csv.open_csv``
(1 MiB blocks) and NDJSON through ``pyarrow.json.read_json``. The card's
machine has no ``pyarrow``, so the port reads both here, with those readers'
default options, into its own columns (``batch.py``):

- **Blocks.** Both readers cut the file into blocks as Arrow's chunker
  does: read ``block_size`` bytes, add them to the partial row the last
  block left, and end the block after its last line break (``\\n`` or
  ``\\r``). The last block, the one no read follows, is the rest of
  the file, uncut. A partial row with no line break in a whole block
  raises, as Arrow's "straddling object" does (Arrow's JSON chunker
  sometimes leaves an empty chunk there instead: ROADMAP Queue C). The CSV
  reader yields one batch a block; the NDJSON reader keeps one chunk a
  block, so ``split(batch_rows)`` of each gives the rows
  of JAX's ``table.to_batches(max_chunksize=batch_rows)``.
- **CSV** (``read_csv_blocks``). The first line names the columns; empty
  lines are skipped; fields split on ``,`` with ``"`` quoting (``""`` is a
  quote inside a quoted field; no escape character and no line breaks
  inside values). Each column's type is inferred from the first block
  only, trying in turn ``null``, ``int64``, ``bool``, ``date32[day]``,
  ``time32[s]``, ``timestamp[s]``, ``timestamp[ns]``, ``timestamp[s,
  tz=UTC]``, ``timestamp[ns, tz=UTC]``, ``double`` and ``string``: the
  first type every non-null value converts to. ``NULL_VALUES`` are null in
  every type but ``string``, where a cell is its text (``""`` included). A
  later block that does not convert to the first block's types raises, as
  does a row with the wrong number of fields.
- **NDJSON** (``read_ndjson_blocks``). One object a line; types are unified
  across the whole file: ``int64`` meeting ``double`` is ``double``, an
  integer past int64 is ``double``, objects are ``struct<...>`` (fields in
  order of first appearance), arrays ``list<...>``, and a string column
  (at any depth) whose every value parses as an ISO-8601 time of whole
  seconds (a bare date too, an offset converted to UTC) is
  ``timestamp[s]``. Columns come in order of first appearance; a missing
  key is null. Values of different kinds in one column raise with Arrow's
  message (``changed from number to string``).

Temporal columns are ``ObjectColumn``s of ``datetime.date``,
``datetime.time`` and ``datetime.datetime`` (aware, UTC, for ``tz=UTC``),
whose ``to_pylist()`` equals pyarrow's. ``timestamp[ns]`` keeps
microseconds: Python's ``datetime`` holds no finer time (ROADMAP Queue C).
"""

from __future__ import annotations

import csv
import datetime as dt
import json
import re
from typing import BinaryIO, Iterator, Optional

import numpy as np

from arkflow_tpu_torch.batch import (MessageBatch, ObjectColumn, StringColumn,
                                     column_from_pylist)
from arkflow_tpu_torch.errors import ReadError

#: ``pyarrow.csv.ReadOptions``' block size, which the JAX file input sets
#: and which ``pyarrow.json`` uses by default
BLOCK_SIZE = 1 << 20

#: ``pyarrow.csv.ConvertOptions()``' defaults
NULL_VALUES = frozenset(["", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                         "1.#IND", "1.#QNAN", "N/A", "NA", "NULL", "NaN", "n/a", "nan", "null"])
TRUE_VALUES = frozenset(["1", "True", "TRUE", "true"])
FALSE_VALUES = frozenset(["0", "False", "FALSE", "false"])

_UTC = dt.timezone.utc
_INT = re.compile(r"-?[0-9]+")
_HEX = re.compile(r"0[xX]([0-9a-fA-F]{1,16})")
_FLOAT = re.compile(r"[+-]?(?:(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
                    r"|(?i:inf|infinity|nan))")
_DATE = re.compile(r"([0-9]{4})-([0-9]{2})-([0-9]{2})")
_TIME = re.compile(r"([0-9]{2}):([0-9]{2})(?::([0-9]{2}))?")
#: an ISO-8601 time as Arrow's parser takes it: a date, then optionally
#: ``T`` or a space and hours, minutes, seconds and a fraction of up to 9
#: digits, then optionally ``Z`` or an offset of hours (and minutes)
_STAMP = re.compile(r"([0-9]{4})-([0-9]{2})-([0-9]{2})"
                    r"(?:[T ]([0-9]{2})(?::([0-9]{2})(?::([0-9]{2})(?:\.([0-9]{1,9}))?)?)?)?"
                    r"(Z|[+-][0-9]{2}(?::?[0-9]{2})?)?")
_WS = " \t"


class _NoConvert(Exception):
    """A cell that does not convert to the type tried."""


def _int64(s: str) -> int:
    s = s.strip(_WS)
    if _INT.fullmatch(s):
        v = int(s)
        if -2 ** 63 <= v < 2 ** 63:
            return v
        raise _NoConvert
    m = _HEX.fullmatch(s)
    if m:
        v = int(m.group(1), 16)
        return v - 2 ** 64 if v >= 2 ** 63 else v
    raise _NoConvert


def _bool(s: str) -> bool:
    if s in TRUE_VALUES:
        return True
    if s in FALSE_VALUES:
        return False
    raise _NoConvert


def _date(s: str) -> dt.date:
    m = _DATE.fullmatch(s.strip(_WS))
    if not m:
        raise _NoConvert
    try:
        return dt.date(*map(int, m.groups()))
    except ValueError:
        raise _NoConvert from None


def _time(s: str) -> dt.time:
    m = _TIME.fullmatch(s.strip(_WS))
    if not m:
        raise _NoConvert
    try:
        return dt.time(int(m.group(1)), int(m.group(2)), int(m.group(3) or 0))
    except ValueError:
        raise _NoConvert from None


def parse_timestamp(s: str, fraction: bool, zone: Optional[bool]) -> dt.datetime:
    """An ISO-8601 time as Arrow parses it. ``fraction``: sub-second digits
    are allowed (``timestamp[ns]``). ``zone``: True needs a zone suffix
    (the result is aware, UTC), False refuses one, None converts one to UTC
    and returns a naive time (the JSON reader's ``timestamp[s]``)."""
    m = _STAMP.fullmatch(s)
    if not m:
        raise _NoConvert
    y, mo, d, hh, mi, ss, frac, tz = m.groups()
    if (frac and not fraction) or (zone is True and not tz) or (zone is False and tz):
        raise _NoConvert
    if tz and hh is None:
        raise _NoConvert  # a bare date takes no zone
    try:
        out = dt.datetime(int(y), int(mo), int(d), int(hh or 0), int(mi or 0), int(ss or 0),
                          int((frac or "0").ljust(9, "0")[:6]))
    except ValueError:
        raise _NoConvert from None
    if tz and tz != "Z":
        sign = -1 if tz[0] == "-" else 1
        digits = tz[1:].replace(":", "")
        offset = dt.timedelta(hours=int(digits[:2]), minutes=int(digits[2:4] or 0))
        out -= sign * offset
    if zone is True:
        return out.replace(tzinfo=_UTC)
    return out


def _double(s: str) -> float:
    s = s.strip(_WS)
    if not _FLOAT.fullmatch(s):
        raise _NoConvert
    return float(s)


#: the CSV reader's types in the order it tries them, each with its
#: conversion of one non-null cell
CSV_KINDS = (
    ("int64", _int64),
    ("bool", _bool),
    ("date32[day]", _date),
    ("time32[s]", _time),
    ("timestamp[s]", lambda s: parse_timestamp(s, False, False)),
    ("timestamp[ns]", lambda s: parse_timestamp(s, True, False)),
    ("timestamp[s, tz=UTC]", lambda s: parse_timestamp(s, False, True)),
    ("timestamp[ns, tz=UTC]", lambda s: parse_timestamp(s, True, True)),
    ("double", _double),
)
_CONVERT = dict(CSV_KINDS)


def _column(values: list, t):
    """A column of type ``t`` from converted values: numpy or a string
    column where ``batch.py`` makes one, else an ``ObjectColumn``."""
    if t == "string":
        return StringColumn.from_pylist(values)
    if t in ("int64", "bool", "double", "null"):
        return column_from_pylist(values, t)
    return ObjectColumn(values, t)


def _convert_csv(cells: list[str], t) -> list:
    """Convert one column's cells; raises ``_NoConvert`` on the first that
    does not convert."""
    if t == "string":
        return cells
    if t == "null":
        for c in cells:
            if c not in NULL_VALUES:
                raise _NoConvert(c)
        return [None] * len(cells)
    conv = _CONVERT[t]
    out = []
    for c in cells:
        if c in NULL_VALUES:
            out.append(None)
            continue
        try:
            out.append(conv(c))
        except _NoConvert:
            raise _NoConvert(c) from None
    return out


def infer_csv_type(cells: list[str]):
    """The type Arrow's CSV reader infers for one column's cells, and the
    converted values."""
    if all(c in NULL_VALUES for c in cells):
        return "null", [None] * len(cells)
    for t, _ in CSV_KINDS:
        try:
            return t, _convert_csv(cells, t)
        except _NoConvert:
            continue
    return "string", cells


# -- blocks ----------------------------------------------------------------------


def blocks(stream: BinaryIO, block_size: int = BLOCK_SIZE) -> Iterator[bytes]:
    """The file's bytes as Arrow's chunker cuts them (see the module
    docstring)."""
    partial = b""
    chunk = stream.read(block_size)
    while chunk:
        following = stream.read(block_size)
        buf = partial + chunk
        if not following:  # the last block: the rest of the file
            yield buf
            return
        cut = max(buf.rfind(b"\n"), buf.rfind(b"\r"))
        if cut < 0:
            raise ReadError("straddling object straddles two block boundaries "
                            "(try to increase block size?)")
        yield buf[:cut + 1]
        partial, chunk = buf[cut + 1:], following
    if partial:
        yield partial


_LINES = re.compile(r"\r\n|\n|\r")


def _lines(block: bytes) -> list[str]:
    try:
        text = block.decode("utf-8")
    except UnicodeDecodeError as e:
        # Arrow would type such a column binary; the port reads text only
        raise ReadError(f"file is not UTF-8 text: {e}") from e
    return [line for line in _LINES.split(text) if line]


def _fields(line: str) -> list[str]:
    if '"' not in line:
        return line.split(",")
    return next(csv.reader([line], strict=False))


# -- CSV -------------------------------------------------------------------------


def read_csv_blocks(stream: BinaryIO, block_size: int = BLOCK_SIZE) -> Iterator[MessageBatch]:
    """One batch a block of a CSV file, as ``pyarrow.csv.open_csv`` with
    ``ReadOptions(block_size=block_size)`` yields them."""
    names: Optional[list[str]] = None
    types: Optional[list] = None
    for block in blocks(stream, block_size):
        lines = _lines(block)
        rows = [_fields(line) for line in lines]
        if names is None:
            if not rows:
                continue
            names = rows.pop(0)
            lines.pop(0)
            if len(set(names)) != len(names):
                raise ReadError(f"CSV header has duplicate column names: {names}")
        for row, line in zip(rows, lines):
            if len(row) != len(names):
                raise ReadError(f"CSV parse error: Expected {len(names)} columns, got "
                                f"{len(row)}: {line}")
        cells = [[r[i] for r in rows] for i in range(len(names))]
        if types is None:
            if not rows:
                continue
            inferred = [infer_csv_type(c) for c in cells]
            types = [t for t, _ in inferred]
            cols = {n: _column(v, t) for n, (t, v) in zip(names, inferred)}
        else:
            cols = {}
            for i, (n, t) in enumerate(zip(names, types)):
                try:
                    cols[n] = _column(_convert_csv(cells[i], t), t)
                except _NoConvert as e:
                    raise ReadError(f"In CSV column #{i}: CSV conversion error to {t}: "
                                    f"invalid value '{e.args[0]}'") from None
        if rows:
            yield MessageBatch(cols, num_rows=len(rows))


# -- NDJSON ----------------------------------------------------------------------

#: a JSON kind, as Arrow's error messages name it
_KIND_NAME = {"null": "null", "bool": "boolean", "int64": "number", "double": "number",
              "string": "string", "list": "array", "struct": "object"}


def _kind(t) -> str:
    return t[0] if isinstance(t, tuple) else t


class _JsonType:
    """The unified type of one JSON column or child, as values arrive."""

    __slots__ = ("kind", "child", "fields", "stamps")

    def __init__(self):
        self.kind = "null"
        self.child: Optional[_JsonType] = None
        self.fields: dict[str, _JsonType] = {}
        #: every string so far parses as a timestamp[s]
        self.stamps = True

    def visit(self, v, path: str, row: int) -> None:
        if v is None:
            return
        if isinstance(v, bool):
            k = "bool"
        elif isinstance(v, int):
            k = "int64" if -2 ** 63 <= v < 2 ** 63 else "double"
        elif isinstance(v, float):
            k = "double"
        elif isinstance(v, str):
            k = "string"
        elif isinstance(v, list):
            k = "list"
        else:
            k = "struct"
        if self.kind == "null":
            self.kind = k
        elif self.kind != k:
            if {self.kind, k} == {"int64", "double"}:
                self.kind = "double"
            else:
                raise ReadError(f"JSON parse error: Column({path}) changed from "
                                f"{_KIND_NAME[self.kind]} to {_KIND_NAME[k]} in row {row}")
        if k == "string" and self.stamps:
            try:
                parse_timestamp(v, False, None)
            except _NoConvert:
                self.stamps = False
        elif k == "list":
            if self.child is None:
                self.child = _JsonType()
            for x in v:
                self.child.visit(x, path + "/[]", row)
        elif k == "struct":
            for name, x in v.items():
                f = self.fields.get(name)
                if f is None:
                    f = self.fields[name] = _JsonType()
                f.visit(x, f"{path}/{name}", row)

    def result(self):
        if self.kind == "list":
            return ("list", self.child.result() if self.child is not None else "null")
        if self.kind == "struct":
            return ("struct", tuple((n, f.result()) for n, f in self.fields.items()))
        if self.kind == "string" and self.stamps:
            return "timestamp[s]"
        return self.kind


def _json_value(v, t):
    """One JSON value as a column of the unified type ``t`` holds it."""
    if v is None:
        return None
    k = _kind(t)
    if k == "double":
        return float(v)
    if k == "timestamp[s]":
        return parse_timestamp(v, False, None)
    if k == "list":
        return [_json_value(x, t[1]) for x in v]
    if k == "struct":
        return {n: _json_value(v.get(n), f) for n, f in t[1]}
    return v


def _json_object(line: str, row: int) -> dict:
    def pairs(items):
        out = {}
        for k, v in items:
            if k in out:
                raise ReadError(f"JSON parse error: Column(/{k}) was specified twice in "
                                f"row {row}")
            out[k] = v
        return out

    try:
        obj = json.loads(line, object_pairs_hook=pairs)
    except json.JSONDecodeError as e:
        raise ReadError(f"JSON parse error: {e}") from e
    if not isinstance(obj, dict):
        raise ReadError(f"JSON parse error: Column() changed from object to "
                        f"{'array' if isinstance(obj, list) else 'scalar'} in row {row}")
    return obj


def read_ndjson_blocks(stream: BinaryIO, block_size: int = BLOCK_SIZE) -> list[MessageBatch]:
    """A newline-delimited JSON file as ``pyarrow.json.read_json`` reads it:
    one batch a block, every batch of the file-wide unified types."""
    chunks: list[list[dict]] = []
    top = _JsonType()
    top.kind = "struct"
    row = 0
    empty = True
    for block in blocks(stream, block_size):
        empty = False
        objs = []
        for line in _lines(block):
            if line.strip():
                obj = _json_object(line, row)
                top.visit(obj, "", row)
                objs.append(obj)
                row += 1
        if objs:
            chunks.append(objs)
    if empty:
        raise ReadError("Empty JSON file")
    fields = top.result()[1]
    out = []
    for objs in chunks:
        cols = {}
        for name, t in fields:
            values = [_json_value(o.get(name), t) for o in objs]
            cols[name] = _json_column(values, t)
        out.append(MessageBatch(cols, num_rows=len(objs)))
    return out


def _has_stamp(t) -> bool:
    if isinstance(t, tuple):
        return any(_has_stamp(c) for c in ((t[1],) if t[0] == "list" else
                                           tuple(f for _, f in t[1])))
    return t == "timestamp[s]"


def _json_column(values: list, t):
    if _has_stamp(t):
        return ObjectColumn(values, t)
    if t == "string" and None not in values:
        return StringColumn.from_pylist(values)
    if t in ("int64", "double", "bool") and None not in values:
        return np.array(values, dtype={"int64": np.int64, "double": np.float64,
                                       "bool": np.bool_}[t])
    return column_from_pylist(values, t)
