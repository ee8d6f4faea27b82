"""Data plane: the message batches that flow through every stream.

Counterpart of ``arkflow_tpu/batch.py`` without Arrow: a ``MessageBatch`` is
an immutable set of equal-length typed columns. Mutation returns a new batch
that shares the unchanged columns. ``pyarrow`` is never imported: the column
model is numpy and Python values, and each column has the Arrow type the JAX
package's column would have (``column_type``, spelled by ``type_name`` as
``str(pa.DataType)`` spells it), so the two packages agree on ``to_pylist()``
and refuse the same concatenations.

Columns come in three kinds:

- ``BinaryColumn`` and ``StringColumn``: variable-length bytes in Arrow's
  layout, one ``uint8`` values buffer plus ``int64`` offsets, and an
  optional validity mask (a null row is empty). The two differ by type
  only: ``payload_view``, ``to_binary``, the tokenizer's buffer view and the
  coalescer's token estimates read either; ``to_pylist`` gives ``bytes`` for
  binary and ``str`` for string, and only binary columns are raw tensor
  bytes (``tpu/extract.py``).
- numpy arrays: bool, integer and floating columns without nulls; an N-D
  array is Arrow's fixed-size list (a model's ``[B, D]`` output), and a
  unicode or object array is a string column (the metadata columns).
- ``ObjectColumn``: every other column, with its type, as the Python values
  Arrow's ``to_pylist()`` gives (``None`` for null): a numeric or bool
  column holding nulls, the ``null`` type, lists, structs and maps.

``column_from_pylist`` infers a column from Python values as
``pyarrow.array`` does (``infer_type``) and converts them with its rules
(``convert_value``); the json codec and ``from_pydict`` build on it.
``split(max_rows)`` row-chunks with the JAX package's default of 8192.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Iterable, Mapping, Optional, Sequence, Union

import numpy as np

from arkflow_tpu_torch.errors import ArkError

DEFAULT_BINARY_VALUE_FIELD = "__value__"
DEFAULT_RECORD_BATCH_ROWS = 8192

META_SOURCE = "__meta_source"
META_PARTITION = "__meta_partition"
META_OFFSET = "__meta_offset"
META_KEY = "__meta_key"
META_TIMESTAMP = "__meta_timestamp"
META_INGEST_TIME = "__meta_ingest_time"
META_EXT_PREFIX = "__meta_ext_"
#: overload control (``runtime/overload.py``): an absolute wall-clock
#: deadline in epoch millis, stamped by whoever owns the request's latency
#: budget, and an integer priority band. Ext columns, so they survive
#: redelivery (``__meta_ingest_time`` is stamped anew at every read)
META_EXT_DEADLINE_MS = META_EXT_PREFIX + "deadline_ms"
META_EXT_PRIORITY = META_EXT_PREFIX + "priority"
#: multi-tenancy (``runtime/overload.py``): the tenant a batch is accounted
#: against -- weighted admission shares, quotas, tenant-labelled metrics
#: and the memory buffer's lanes key on it. Stamped by the input (an HTTP
#: header or the auth subject, a Kafka record header, or static config)
META_EXT_TENANT = META_EXT_PREFIX + "tenant"
#: per-batch tracing (``obs/trace.py``): the trace context -- trace id,
#: parent span id, head-sampling decision -- as a compact JSON string. An
#: ext column, so it survives redelivery, splits, coalescer merges and
#: quarantine, and ``batch_fingerprint`` leaves it out: tracing never
#: changes a batch's delivery-attempt key
META_EXT_TRACE = META_EXT_PREFIX + "trace"

#: the fixed (non-ext) metadata columns, in canonical order
META_COLUMNS = (META_SOURCE, META_PARTITION, META_OFFSET, META_KEY, META_TIMESTAMP,
                META_INGEST_TIME)


def is_meta_column(name: str) -> bool:
    return name in META_COLUMNS or name.startswith(META_EXT_PREFIX)


class ColumnTypeError(ArkError):
    """Python values that do not make a column of one type: the errors
    ``pyarrow.array`` raises on the same values (``ArrowInvalid``,
    ``ArrowTypeError``, an overflow)."""


# -- types --------------------------------------------------------------------
#
# A type is Arrow's: a name for a primitive ("null", "bool", "int64",
# "double", "string", ...) or a tuple for a nested type: ("list", T),
# ("struct", ((name, T), ...)), ("map", K, V), ("fixed_size_list", T, n).

_INT_RANGES = {f"{s}int{b}": ((0, 2 ** b - 1) if s else (-2 ** (b - 1), 2 ** (b - 1) - 1))
               for s in ("", "u") for b in (8, 16, 32, 64)}
_FLOAT_TYPES = {"halffloat": np.float16, "float": np.float32, "double": np.float64}
#: the numpy dtype of each primitive a numpy column can hold
_NUMPY_OF = {"bool": np.bool_, **{t: np.dtype(t) for t in _INT_RANGES}, **_FLOAT_TYPES}
_FLOAT_OF_SIZE = {2: "halffloat", 4: "float", 8: "double"}


def type_name(t) -> str:
    """A type spelled as ``str(pyarrow.DataType)`` spells it."""
    if isinstance(t, str):
        return t
    kind = t[0]
    if kind == "list":
        return f"list<item: {type_name(t[1])}>"
    if kind == "struct":
        return "struct<" + ", ".join(f"{n}: {type_name(f)}" for n, f in t[1]) + ">"
    if kind == "map":
        return f"map<{type_name(t[1])}, {type_name(t[2])}>"
    if kind == "fixed_size_list":
        return f"fixed_size_list<item: {type_name(t[1])}>[{t[2]}]"
    raise ArkError(f"unknown type {t!r}")


def _numpy_type(dtype: np.dtype):
    if dtype.kind == "b":
        return "bool"
    if dtype.kind in "iu":
        return f"{'u' if dtype.kind == 'u' else ''}int{dtype.itemsize * 8}"
    if dtype.kind == "f":
        return _FLOAT_OF_SIZE[dtype.itemsize]
    if dtype.kind in "UO":
        return "string"
    raise ArkError(f"numpy dtype {dtype} has no column type")


# -- columns ------------------------------------------------------------------


class VarlenColumn:
    """Variable-length byte strings in Arrow's binary layout: row ``i`` is
    ``values[offsets[i]:offsets[i+1]]``. Offsets are absolute into
    ``values``, so a slice shares the buffer and only narrows the offsets.
    ``valid`` is None when no row is null; a null row is empty."""

    __slots__ = ("values", "offsets", "valid")
    TYPE = "binary"

    def __init__(self, values: np.ndarray, offsets: np.ndarray,
                 valid: Optional[np.ndarray] = None):
        if values.dtype != np.uint8 or values.ndim != 1:
            raise ArkError("binary column values must be a 1-D uint8 array")
        if offsets.dtype != np.int64 or offsets.ndim != 1 or len(offsets) < 1:
            raise ArkError("binary column offsets must be a non-empty 1-D int64 array")
        if valid is not None and (valid.dtype != np.bool_ or valid.shape != (len(offsets) - 1,)):
            raise ArkError("column validity must be one bool a row")
        self.values = values
        self.offsets = offsets
        self.valid = valid if valid is not None and not valid.all() else None

    @classmethod
    def from_pylist(cls, items: Sequence[Any]) -> "VarlenColumn":
        """Rows of ``bytes`` (or ``str``, stored as UTF-8); ``None`` is null."""
        raw = [b"" if p is None else (p.encode() if isinstance(p, str) else p)
               for p in items]
        lens = np.fromiter((len(p) for p in raw), np.int64, count=len(raw))
        offsets = np.zeros(len(raw) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        values = np.frombuffer(b"".join(raw), np.uint8)
        valid = None
        if any(p is None for p in items):
            valid = np.fromiter((p is not None for p in items), np.bool_, count=len(raw))
        return cls(values, offsets, valid)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def slice(self, offset: int, length: int) -> "VarlenColumn":
        valid = None if self.valid is None else self.valid[offset: offset + length]
        return type(self)(self.values, self.offsets[offset: offset + length + 1], valid)

    def to_bytes(self) -> list[bytes]:
        """Every row as ``bytes``, a null row as ``b""``."""
        n = len(self)
        base = int(self.offsets[0])
        buf = self.values[base: int(self.offsets[n])].tobytes()
        return [buf[self.offsets[i] - base: self.offsets[i + 1] - base] for i in range(n)]

    def _row_value(self, raw: bytes):
        return raw

    def to_pylist(self) -> list:
        rows = self.to_bytes()
        if self.valid is None:
            return [self._row_value(r) for r in rows]
        return [self._row_value(r) if ok else None for r, ok in zip(rows, self.valid)]

    @classmethod
    def concat(cls, cols: Sequence["VarlenColumn"]) -> "VarlenColumn":
        parts = [c.values[int(c.offsets[0]): int(c.offsets[-1])] for c in cols]
        offsets = [np.zeros(1, np.int64)]
        base = 0
        for c in cols:
            offsets.append(c.offsets[1:] - c.offsets[0] + base)
            base += int(c.offsets[-1] - c.offsets[0])
        valid = None
        if any(c.valid is not None for c in cols):
            valid = np.concatenate([np.ones(len(c), np.bool_) if c.valid is None else c.valid
                                    for c in cols])
        return cls(np.concatenate(parts) if parts else np.empty(0, np.uint8),
                   np.concatenate(offsets), valid)


class BinaryColumn(VarlenColumn):
    """Opaque bytes (Arrow ``binary``): raw tensor bytes to ``extract_tensor``."""

    TYPE = "binary"


class StringColumn(VarlenColumn):
    """UTF-8 text (Arrow ``string``); ``to_pylist`` gives ``str``."""

    TYPE = "string"

    def _row_value(self, raw: bytes):
        return raw.decode("utf-8")


class ObjectColumn:
    """A column of any type as the Python values Arrow's ``to_pylist()``
    gives, ``None`` for null: nullable scalars, the null type, lists,
    structs and maps. ``values`` is never mutated."""

    __slots__ = ("values", "type")

    def __init__(self, values: Sequence[Any], type_):
        self.values = list(values)
        self.type = type_

    def __len__(self) -> int:
        return len(self.values)

    def slice(self, offset: int, length: int) -> "ObjectColumn":
        return ObjectColumn(self.values[offset: offset + length], self.type)

    def to_pylist(self) -> list:
        return list(self.values)


Column = Union[VarlenColumn, ObjectColumn, np.ndarray]


def column_len(col: Column) -> int:
    return len(col) if not isinstance(col, np.ndarray) else col.shape[0]


def column_type(col: Column):
    """The Arrow type of a column (see ``type_name``)."""
    if isinstance(col, VarlenColumn):
        return col.TYPE
    if isinstance(col, ObjectColumn):
        return col.type
    t = _numpy_type(col.dtype)
    for width in reversed(col.shape[1:]):
        t = ("fixed_size_list", t, int(width))
    return t


def column_to_pylist(col: Column) -> list:
    """The column's rows as Arrow's ``to_pylist()`` gives them: a float32
    value as the Python float of that float32, a fixed-size list as a list."""
    if isinstance(col, np.ndarray):
        return col.tolist()
    return col.to_pylist()


def slice_column(col: Column, offset: int, length: int) -> Column:
    if isinstance(col, np.ndarray):
        return col[offset: offset + length]
    return col.slice(offset, length)


def concat_columns(parts: Sequence[Column]) -> Column:
    """Concatenate columns of one type (the caller checked the types)."""
    if all(isinstance(p, np.ndarray) for p in parts):
        return np.concatenate(parts)
    kinds = {type(p) for p in parts}
    if len(kinds) == 1 and issubclass(kinds.pop(), VarlenColumn):
        return type(parts[0]).concat(parts)
    if all(isinstance(p, ObjectColumn) for p in parts):  # values already converted
        return ObjectColumn([v for p in parts for v in p.values], parts[0].type)
    values = [v for p in parts for v in column_to_pylist(p)]
    return column_from_pylist(values, column_type(parts[0]))


# -- inference and conversion, as pyarrow.array's ------------------------------


class _Inferrer:
    """pyarrow's type inference over Python values (``TypeInferrer``): a
    sequence is scanned until its first bool, float, str or bytes value,
    which settles its type; ints and nulls scan on (a later float makes
    them double). A list's elements are scanned per list with the same rule,
    into one child; a dict's values are all scanned, into one child a key,
    keys in the order first seen. Floats win over ints, ints over bools."""

    __slots__ = ("total", "none", "bools", "ints", "floats", "strs", "bytes", "lists",
                 "dicts", "child", "fields")

    def __init__(self):
        self.total = self.none = self.bools = self.ints = self.floats = 0
        self.strs = self.bytes = self.lists = self.dicts = 0
        self.child: Optional[_Inferrer] = None
        self.fields: dict[str, _Inferrer] = {}

    def visit(self, v: Any) -> bool:
        """Count one value; False once the sequence's type is settled."""
        self.total += 1
        if v is None:
            self.none += 1
            return True
        if isinstance(v, (bool, np.bool_)):
            self.bools += 1
            return False
        if isinstance(v, (float, np.floating)):
            self.floats += 1
            return False
        if isinstance(v, (int, np.integer)):
            self.ints += 1
            return True
        if isinstance(v, str):
            self.strs += 1
            return False
        if isinstance(v, bytes):
            self.bytes += 1
            return False
        if isinstance(v, (list, tuple)):
            self.lists += 1
            if self.child is None:
                self.child = _Inferrer()
            self.child.visit_sequence(v)
            return True
        if isinstance(v, dict):
            self.dicts += 1
            for k, x in v.items():
                if not isinstance(k, str):
                    raise ColumnTypeError(f"Expected dict key of type str or bytes, got "
                                          f"'{type(k).__name__}'")
                f = self.fields.get(k)
                if f is None:
                    f = self.fields[k] = _Inferrer()
                f.visit(x)
            return True
        raise ColumnTypeError(f"Could not convert {v!r} with type {type(v).__name__}: did "
                              "not recognize Python value type when inferring an Arrow "
                              "data type")

    def visit_sequence(self, seq: Iterable[Any]) -> None:
        for v in seq:
            if not self.visit(v):
                break

    def result(self):
        if self.lists:
            if self.lists + self.none != self.total:
                raise ColumnTypeError("cannot mix list and non-list, non-null values")
            return ("list", self.child.result())
        if self.dicts:
            if self.dicts + self.none != self.total:
                raise ColumnTypeError("cannot mix struct and non-struct, non-null values")
            return ("struct", tuple((k, f.result()) for k, f in self.fields.items()))
        if self.floats:
            return "double"
        if self.ints:
            return "int64"
        if self.bools:
            return "bool"
        if self.bytes:
            return "binary"
        if self.strs:
            return "string"
        return "null"


def infer_type(values: Iterable[Any]):
    """The type ``pyarrow.array(values)`` infers."""
    inf = _Inferrer()
    inf.visit_sequence(values)
    return inf.result()


def _cannot(v: Any, t) -> ColumnTypeError:
    return ColumnTypeError(f"Could not convert {v!r} with type {type(v).__name__}: tried "
                           f"to convert to {type_name(t)}")


def convert_value(v: Any, t) -> Any:
    """One Python value as a column of type ``t`` holds it (what that
    column's ``to_pylist()`` gives back), with pyarrow's conversion rules;
    raises ``ColumnTypeError`` where pyarrow raises."""
    if v is None:
        return None
    if isinstance(t, tuple):
        kind = t[0]
        if kind in ("list", "fixed_size_list"):
            if not isinstance(v, (list, tuple, np.ndarray)):
                raise ColumnTypeError(f"Could not convert {v!r} with type "
                                      f"{type(v).__name__}: was not a sequence or "
                                      "recognized null for conversion to list type")
            if kind == "fixed_size_list" and len(v) != t[2]:
                raise ColumnTypeError(f"Length of item not correct: expected {t[2]} but "
                                      f"got array of size {len(v)}")
            return [convert_value(x, t[1]) for x in v]
        if kind == "struct":
            if not isinstance(v, dict):
                raise _cannot(v, t)
            return {n: convert_value(v.get(n), f) for n, f in t[1]}
        if kind == "map":
            items = v.items() if isinstance(v, dict) else v
            return [(convert_value(k, t[1]), convert_value(x, t[2])) for k, x in items]
        raise ArkError(f"unknown type {t!r}")
    if t == "null":
        raise ColumnTypeError("Invalid null value")
    if t == "bool":
        if isinstance(v, (bool, np.bool_)):
            return bool(v)
        raise _cannot(v, t)
    if t in _INT_RANGES:
        if isinstance(v, (bool, np.bool_)):
            raise ColumnTypeError("Expected integer, got bool")
        if not isinstance(v, (int, np.integer)):
            raise _cannot(v, t)
        lo, hi = _INT_RANGES[t]
        if not lo <= int(v) <= hi:
            raise ColumnTypeError(f"Value {v} too large to fit in {t}")
        return int(v)
    if t in _FLOAT_TYPES:
        if isinstance(v, (bool, np.bool_)):
            f = float(v)
        elif isinstance(v, (int, np.integer)):
            if not -2 ** 63 <= int(v) < 2 ** 63:
                raise ColumnTypeError("PyLong is too large to fit int64")
            if abs(int(v)) > 2 ** 53:
                raise ColumnTypeError(f"Integer value {v} is outside of the range exactly "
                                      "representable by a IEEE 754 double precision value")
            f = float(v)
        elif isinstance(v, (float, np.floating)):
            f = float(v)
        else:
            raise _cannot(v, t)
        return f if t == "double" else float(_FLOAT_TYPES[t](f))
    if t == "string":
        if isinstance(v, bytes):
            try:
                return v.decode("utf-8")
            except UnicodeDecodeError as e:
                raise ColumnTypeError(f"invalid UTF-8 string: {e}") from e
        if not isinstance(v, str):
            raise ColumnTypeError(f"Expected bytes, got a '{type(v).__name__}' object")
        try:
            v.encode("utf-8")
        except UnicodeEncodeError as e:
            raise ColumnTypeError(str(e)) from e
        return v
    if t == "binary":
        if isinstance(v, str):
            return v.encode("utf-8")
        if not isinstance(v, bytes):
            raise ColumnTypeError(f"Expected bytes, got a '{type(v).__name__}' object")
        return v
    raise ArkError(f"unknown type {t!r}")


def column_from_pylist(values: Sequence[Any], type_=None) -> Column:
    """A column from Python values, of ``type_`` or the type pyarrow infers.
    Strings and bytes land in a string or binary column; bools, ints and
    floats without nulls in a numpy array; everything else in an
    ``ObjectColumn``."""
    t = infer_type(values) if type_ is None else type_
    conv = [convert_value(v, t) for v in values]
    if t == "string":
        return StringColumn.from_pylist(conv)
    if t == "binary":
        return BinaryColumn.from_pylist(conv)
    if isinstance(t, str) and t in _NUMPY_OF and all(v is not None for v in conv):
        return np.array(conv, dtype=_NUMPY_OF[t])
    return ObjectColumn(conv, t)


# -- batches ------------------------------------------------------------------


class MessageBatch:
    """Immutable columns of equal length. The engine's unit of data."""

    __slots__ = ("_cols", "_rows")

    def __init__(self, columns: Mapping[str, Column], num_rows: int | None = None):
        lens = {column_len(c) for c in columns.values()}
        if len(lens) > 1:
            raise ArkError(f"columns differ in length: {sorted(lens)}")
        self._cols = dict(columns)
        self._rows = lens.pop() if lens else (num_rows or 0)

    # -- constructors ------------------------------------------------------

    @classmethod
    def new_binary(cls, payloads: Sequence[bytes]) -> "MessageBatch":
        """One row per opaque payload, in the ``__value__`` column."""
        return cls({DEFAULT_BINARY_VALUE_FIELD: BinaryColumn.from_pylist(list(payloads))})

    @classmethod
    def from_pydict(cls, data: Mapping[str, Any]) -> "MessageBatch":
        """Columns from Python lists, each typed as ``pyarrow`` infers it, or
        from columns as they are."""
        return cls({k: (v if isinstance(v, (VarlenColumn, ObjectColumn, np.ndarray))
                        else column_from_pylist(list(v))) for k, v in data.items()})

    @classmethod
    def from_pylist(cls, rows: Sequence[Mapping[str, Any]]) -> "MessageBatch":
        """One row a mapping, as ``pa.RecordBatch.from_pylist`` takes them:
        the columns are the first row's keys, a key a later row lacks is
        null there, and a key only later rows have is dropped."""
        if not rows:
            return cls.empty()
        return cls({k: column_from_pylist([r.get(k) for r in rows]) for k in rows[0]})

    @classmethod
    def empty(cls) -> "MessageBatch":
        return cls({})

    # -- accessors ---------------------------------------------------------

    @property
    def num_rows(self) -> int:
        return self._rows

    def __len__(self) -> int:
        return self._rows

    @property
    def column_names(self) -> list[str]:
        return list(self._cols)

    @property
    def schema(self) -> dict[str, str]:
        """Each column's Arrow type, spelled as ``pyarrow`` spells it."""
        return {n: type_name(column_type(c)) for n, c in self._cols.items()}

    def column(self, name: str) -> Column:
        col = self._cols.get(name)
        if col is None:
            raise ArkError(f"no such column: {name!r}")
        return col

    def has_column(self, name: str) -> bool:
        return name in self._cols

    def to_pydict(self) -> dict[str, list]:
        return {n: column_to_pylist(c) for n, c in self._cols.items()}

    def to_pylist(self) -> list[dict[str, Any]]:
        """One dict a row, keys in column order."""
        cols = self.to_pydict()
        names = list(cols)
        return [{n: cols[n][i] for n in names} for i in range(self._rows)]

    def __repr__(self) -> str:
        return f"MessageBatch(rows={self.num_rows}, cols={self.column_names})"

    # -- binary convention -------------------------------------------------

    def _varlen(self, field: str) -> VarlenColumn:
        col = self.column(field)
        if not isinstance(col, VarlenColumn):
            raise ArkError(f"column {field!r} is {type_name(column_type(col))}, not a binary "
                           "column or a string column")
        return col

    def payload_view(self, field: str = DEFAULT_BINARY_VALUE_FIELD) -> tuple[np.ndarray, np.ndarray]:
        """Zero-copy ``(values, offsets)`` of a binary or string column: row
        ``i``'s payload is ``values[offsets[i]:offsets[i+1]]`` (a null row is
        empty)."""
        col = self._varlen(field)
        return col.values, col.offsets

    def to_binary(self, field: str = DEFAULT_BINARY_VALUE_FIELD) -> list[bytes]:
        """A binary or string column's rows as ``bytes``; a null row is ``b""``."""
        return self._varlen(field).to_bytes()

    # -- column surgery ----------------------------------------------------

    def with_column(self, name: str, column: Column) -> "MessageBatch":
        """Add or replace a column; the other columns are shared, not copied."""
        if self._cols and column_len(column) != self._rows:
            raise ArkError(
                f"column {name!r} length {column_len(column)} != batch rows {self._rows}")
        return MessageBatch({**self._cols, name: column})

    def filter_columns(self, names: Iterable[str]) -> "MessageBatch":
        """The given columns, in the batch's order."""
        keep = set(names)
        return MessageBatch({n: c for n, c in self._cols.items() if n in keep}, self._rows)

    def drop_columns(self, names: Iterable[str]) -> "MessageBatch":
        drop = set(names)
        return MessageBatch({n: c for n, c in self._cols.items() if n not in drop}, self._rows)

    def metadata_columns(self) -> list[str]:
        return [n for n in self._cols if is_meta_column(n)]

    def data_columns(self) -> list[str]:
        return [n for n in self._cols if not is_meta_column(n)]

    def strip_metadata(self) -> "MessageBatch":
        return self.filter_columns(self.data_columns())

    def with_source(self, source: str) -> "MessageBatch":
        return self.with_column(META_SOURCE, np.full(self._rows, source))

    def with_partition(self, partition: int) -> "MessageBatch":
        return self.with_column(META_PARTITION, np.full(self._rows, partition, np.int64))

    def with_offset(self, offset: int) -> "MessageBatch":
        return self.with_column(META_OFFSET, np.full(self._rows, offset, np.int64))

    def with_key(self, key: Optional[bytes]) -> "MessageBatch":
        """The message key ``__meta_key`` (binary, null for None) on every row."""
        return self.with_column(META_KEY, BinaryColumn.from_pylist([key] * self._rows))

    def with_timestamp(self, ts_millis: int) -> "MessageBatch":
        """Broker-assigned event timestamp, epoch millis."""
        return self.with_column(META_TIMESTAMP, np.full(self._rows, ts_millis, np.int64))

    def with_ingest_time(self, ts_millis: Optional[int] = None) -> "MessageBatch":
        """Engine ingest wall-clock, epoch millis (defaults to now)."""
        if ts_millis is None:
            ts_millis = int(time.time() * 1000)
        return self.with_column(META_INGEST_TIME, np.full(self._rows, ts_millis, np.int64))

    def with_ext_metadata(self, kv: dict[str, str]) -> "MessageBatch":
        """Constant free-form metadata columns ``__meta_ext_<k>``, one string
        per row."""
        out = self
        for k, v in kv.items():
            out = out.with_column(META_EXT_PREFIX + k, np.full(self._rows, str(v)))
        return out

    def with_ext_metadata_per_row(self, key: str,
                                  values: Sequence[Optional[str]]) -> "MessageBatch":
        """Per-row free-form metadata; a ``None`` row has no value."""
        vals = list(values)
        col = (np.array(vals, dtype=object) if any(v is None for v in vals)
               else np.array([str(v) for v in vals]))
        return self.with_column(META_EXT_PREFIX + key, col)

    # -- overload metadata (runtime/overload.py) ---------------------------

    def with_deadline_ms(self, deadline_unix_ms: float) -> "MessageBatch":
        """Stamp an absolute delivery deadline (epoch millis). It survives
        redelivery: the remaining budget shrinks with every retry, unlike a
        TTL measured from the ingest stamp."""
        return self.with_ext_metadata({META_EXT_DEADLINE_MS[len(META_EXT_PREFIX):]:
                                       str(int(deadline_unix_ms))})

    def with_priority(self, priority: int) -> "MessageBatch":
        """Stamp the admission priority band (bands at or above the
        controller's ``protect_priority`` are never queue-shed)."""
        return self.with_ext_metadata({META_EXT_PRIORITY[len(META_EXT_PREFIX):]:
                                       str(int(priority))})

    def with_tenant(self, tenant: str) -> "MessageBatch":
        """Stamp the tenant this batch is accounted against."""
        return self.with_ext_metadata({META_EXT_TENANT[len(META_EXT_PREFIX):]: str(tenant)})

    def tenant(self, default: Optional[str] = None) -> Optional[str]:
        """The ``__meta_ext_tenant`` of row 0, or ``default`` when untagged."""
        raw = self.get_meta(META_EXT_TENANT)
        return default if raw is None else str(raw)

    def deadline_unix_ms(self) -> Optional[float]:
        """The absolute deadline from ``__meta_ext_deadline_ms``, or None."""
        raw = self.get_meta(META_EXT_DEADLINE_MS)
        if raw is None:
            return None
        try:
            return float(raw)
        except (TypeError, ValueError):
            return None

    def remaining_deadline_ms(self, default_ttl_ms: Optional[float] = None,
                              now_ms: Optional[float] = None) -> Optional[float]:
        """Remaining latency budget in ms (negative: already stale). The
        absolute deadline wins; else ``default_ttl_ms`` counts from
        ``__meta_ingest_time``; None when the batch has no deadline."""
        if now_ms is None:
            now_ms = time.time() * 1000.0
        absolute = self.deadline_unix_ms()
        if absolute is not None:
            return absolute - now_ms
        if default_ttl_ms is not None:
            ingest = self.get_meta(META_INGEST_TIME)
            if ingest is not None:
                return default_ttl_ms - (now_ms - float(ingest))
            return default_ttl_ms
        return None

    def priority_band(self, default: int = 0) -> int:
        """The admission band from ``__meta_ext_priority``, else ``default``."""
        raw = self.get_meta(META_EXT_PRIORITY)
        if raw is None:
            return default
        try:
            return int(float(raw))
        except (TypeError, ValueError):
            return default

    def with_trace(self, ctx) -> "MessageBatch":
        """Stamp (or replace) the batch's trace context
        (``obs.trace.TraceContext``) on every row: one trace a batch."""
        return self.with_column(META_EXT_TRACE, np.full(self._rows, ctx.to_json()))

    def trace_context(self):
        """The batch's trace context from row 0, or None when untraced or
        malformed (a merged emission is stamped anew with its own trace;
        its rows' source contexts feed the parent links instead)."""
        from arkflow_tpu_torch.obs.trace import TraceContext

        return TraceContext.from_json(self.get_meta(META_EXT_TRACE))

    def source_trace_contexts(self) -> list:
        """The distinct trace contexts over the rows, in first-seen row
        order: a merged emission carries one per source batch."""
        from arkflow_tpu_torch.obs.trace import TraceContext

        if not self.has_column(META_EXT_TRACE) or self._rows == 0:
            return []
        seen: dict[str, Any] = {}
        for v in dict.fromkeys(column_to_pylist(self._cols[META_EXT_TRACE])):
            ctx = TraceContext.from_json(v)
            if ctx is not None and ctx.trace_id not in seen:
                seen[ctx.trace_id] = ctx
        return list(seen.values())

    def source_trace_ids(self) -> list[str]:
        """The distinct trace ids (see ``source_trace_contexts``)."""
        return [c.trace_id for c in self.source_trace_contexts()]

    def get_meta(self, name: str) -> Any:
        """First-row value of a metadata column as a Python object, or None
        when the column is absent or the batch empty."""
        if not self.has_column(name) or self._rows == 0:
            return None
        return column_to_pylist(slice_column(self._cols[name], 0, 1))[0]

    def filter(self, mask: Any) -> "MessageBatch":
        """The rows where ``mask`` is true, as ``pa.RecordBatch.filter``
        keeps them: a null in the mask drops its row. ``mask`` is a bool
        column, a numpy array or a list of bools of the batch's length."""
        from arkflow_tpu_torch.sql.arrays import take_column

        vals = column_to_pylist(mask) if not isinstance(mask, (list, np.ndarray)) else mask
        keep = np.fromiter((v is not None and bool(v) for v in
                            (vals.tolist() if isinstance(vals, np.ndarray) else vals)),
                           bool, count=len(vals))
        if len(keep) != self._rows:
            raise ArkError(f"filter mask length {len(keep)} != batch rows {self._rows}")
        idx = np.flatnonzero(keep)
        return MessageBatch({k: take_column(c, idx) for k, c in self._cols.items()}, len(idx))

    # -- chunking / merge --------------------------------------------------

    def slice(self, offset: int, length: int | None = None) -> "MessageBatch":
        if length is None:
            length = self._rows - offset
        length = max(0, min(length, self._rows - offset))
        return MessageBatch({k: slice_column(c, offset, length) for k, c in self._cols.items()},
                            length)

    def split(self, max_rows: int = DEFAULT_RECORD_BATCH_ROWS) -> list["MessageBatch"]:
        """Row-chunks of at most ``max_rows`` rows, sharing the buffers."""
        if max_rows <= 0:
            raise ArkError("max_rows must be positive")
        if self._rows <= max_rows:
            return [self]
        return [self.slice(i, max_rows) for i in range(0, self._rows, max_rows)]

    @staticmethod
    def concat(batches: Sequence["MessageBatch"]) -> "MessageBatch":
        """Concatenate batches of one schema: the same column names in the
        same order, each of the same type, as Arrow's ``Table.from_batches``
        requires (it raises otherwise, and so does this)."""
        bs = [b for b in batches if b.num_rows > 0]
        if not bs:
            return batches[0] if batches else MessageBatch.empty()
        if len(bs) == 1:
            return bs[0]
        schema = list(bs[0].schema.items())
        for i, b in enumerate(bs[1:], 1):
            if list(b.schema.items()) != schema:
                raise ArkError(f"cannot concat batches: schema at index {i} was different: "
                               f"{b.schema} vs {dict(schema)}")
        cols = {name: concat_columns([b.column(name) for b in bs]) for name, _ in schema}
        return MessageBatch(cols, sum(b.num_rows for b in bs))


def batch_fingerprint(batch: MessageBatch) -> bytes:
    """Stable identity of a batch across redeliveries: a digest of every
    column's name, type and bytes, leaving out per-delivery noise (the
    ingest time, and the ext metadata the error path itself stamps). The
    one definition shared by the stream's delivery-attempt budget and the
    coalescer's poison-suspect table, whose convergence needs identical
    keys. Content-only sources emitting byte-identical batches share one
    key, an approximation the JAX package accepts too, since an entry
    clears on success."""
    h = hashlib.blake2b(digest_size=16)
    for name in batch.column_names:
        if name == META_INGEST_TIME or name.startswith(META_EXT_PREFIX):
            continue
        col = batch.column(name)
        h.update(name.encode() + b"\0")
        if isinstance(col, VarlenColumn):
            base = int(col.offsets[0])
            h.update(col.TYPE.encode() + (col.offsets - base).tobytes())
            h.update(col.values[base: int(col.offsets[-1])].tobytes())
            if col.valid is not None:
                h.update(b"valid" + col.valid.tobytes())
        elif isinstance(col, ObjectColumn):
            h.update(b"object " + type_name(col.type).encode() + repr(col.values).encode())
        elif col.dtype == object:
            h.update(b"object" + repr(col.tolist()).encode())
        else:
            h.update(col.dtype.str.encode() + np.ascontiguousarray(col).tobytes())
    return h.digest()
