"""Data plane: the message batches that flow through every stream.

Counterpart of ``arkflow_tpu/batch.py`` without Arrow: a ``MessageBatch`` is
an immutable set of equal-length columns held as numpy arrays. Opaque
payloads live in a binary column named ``__value__`` that keeps Arrow's
binary layout -- one ``uint8`` values buffer plus ``int64`` offsets -- so
``payload_view`` hands the tokenizer the whole buffer without per-row
objects. Mutation returns a new batch that shares the unchanged columns.
"""

from __future__ import annotations

import hashlib
from typing import Any, Optional, Sequence, Union

import numpy as np

from arkflow_tpu_torch.errors import ArkError

DEFAULT_BINARY_VALUE_FIELD = "__value__"

META_SOURCE = "__meta_source"
META_PARTITION = "__meta_partition"
META_OFFSET = "__meta_offset"
META_KEY = "__meta_key"
META_TIMESTAMP = "__meta_timestamp"
META_INGEST_TIME = "__meta_ingest_time"
META_EXT_PREFIX = "__meta_ext_"


class BinaryColumn:
    """Variable-length byte strings in Arrow's binary layout: row ``i`` is
    ``values[offsets[i]:offsets[i+1]]``. Offsets are absolute into
    ``values``, so a slice shares the buffer and only narrows the offsets."""

    __slots__ = ("values", "offsets")

    def __init__(self, values: np.ndarray, offsets: np.ndarray):
        if values.dtype != np.uint8 or values.ndim != 1:
            raise ArkError("binary column values must be a 1-D uint8 array")
        if offsets.dtype != np.int64 or offsets.ndim != 1 or len(offsets) < 1:
            raise ArkError("binary column offsets must be a non-empty 1-D int64 array")
        self.values = values
        self.offsets = offsets

    @classmethod
    def from_pylist(cls, payloads: Sequence[bytes]) -> "BinaryColumn":
        lens = np.fromiter((len(p) for p in payloads), np.int64, count=len(payloads))
        offsets = np.zeros(len(payloads) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        values = np.frombuffer(b"".join(payloads), np.uint8)
        return cls(values, offsets)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def slice(self, offset: int, length: int) -> "BinaryColumn":
        return BinaryColumn(self.values, self.offsets[offset: offset + length + 1])

    def to_pylist(self) -> list[bytes]:
        n = len(self)
        base = int(self.offsets[0])
        buf = self.values[base: int(self.offsets[n])].tobytes()
        return [buf[self.offsets[i] - base: self.offsets[i + 1] - base] for i in range(n)]

    @staticmethod
    def concat(cols: Sequence["BinaryColumn"]) -> "BinaryColumn":
        parts = [c.values[int(c.offsets[0]): int(c.offsets[-1])] for c in cols]
        offsets = [np.zeros(1, np.int64)]
        base = 0
        for c in cols:
            offsets.append(c.offsets[1:] - c.offsets[0] + base)
            base += int(c.offsets[-1] - c.offsets[0])
        return BinaryColumn(np.concatenate(parts) if parts else np.empty(0, np.uint8),
                            np.concatenate(offsets))


Column = Union[BinaryColumn, np.ndarray]


def _column_len(col: Column) -> int:
    return len(col) if isinstance(col, BinaryColumn) else col.shape[0]


class MessageBatch:
    """Immutable columns of equal length. The engine's unit of data."""

    __slots__ = ("_cols", "_rows")

    def __init__(self, columns: dict[str, Column], num_rows: int | None = None):
        lens = {_column_len(c) for c in columns.values()}
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

    def column(self, name: str) -> Column:
        col = self._cols.get(name)
        if col is None:
            raise ArkError(f"no such column: {name!r}")
        return col

    def has_column(self, name: str) -> bool:
        return name in self._cols

    def __repr__(self) -> str:
        return f"MessageBatch(rows={self.num_rows}, cols={self.column_names})"

    # -- binary convention -------------------------------------------------

    def payload_view(self, field: str = DEFAULT_BINARY_VALUE_FIELD) -> tuple[np.ndarray, np.ndarray]:
        """Zero-copy ``(values, offsets)`` of a payload column: row ``i``'s
        payload is ``values[offsets[i]:offsets[i+1]]``."""
        col = self.column(field)
        if not isinstance(col, BinaryColumn):
            raise ArkError(f"column {field!r} is not a binary column")
        return col.values, col.offsets

    def to_binary(self, field: str = DEFAULT_BINARY_VALUE_FIELD) -> list[bytes]:
        col = self.column(field)
        if not isinstance(col, BinaryColumn):
            raise ArkError(f"column {field!r} is not a binary column")
        return col.to_pylist()

    # -- column surgery ----------------------------------------------------

    def with_column(self, name: str, column: Column) -> "MessageBatch":
        """Add or replace a column; the other columns are shared, not copied."""
        if self._cols and _column_len(column) != self._rows:
            raise ArkError(
                f"column {name!r} length {_column_len(column)} != batch rows {self._rows}")
        return MessageBatch({**self._cols, name: column})

    def with_source(self, source: str) -> "MessageBatch":
        return self.with_column(META_SOURCE, np.full(self._rows, source))

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

    def get_meta(self, name: str) -> Any:
        """First-row value of a metadata column as a Python object, or None
        when the column is absent or the batch empty."""
        if not self.has_column(name) or self._rows == 0:
            return None
        col = self._cols[name]
        if isinstance(col, BinaryColumn):
            return col.slice(0, 1).to_pylist()[0]
        value = col[0]
        return value.item() if isinstance(value, np.generic) else value

    # -- chunking / merge --------------------------------------------------

    def slice(self, offset: int, length: int | None = None) -> "MessageBatch":
        if length is None:
            length = self._rows - offset
        length = max(0, min(length, self._rows - offset))
        return MessageBatch(
            {k: (c.slice(offset, length) if isinstance(c, BinaryColumn)
                 else c[offset: offset + length]) for k, c in self._cols.items()},
            length)

    @staticmethod
    def concat(batches: Sequence["MessageBatch"]) -> "MessageBatch":
        """Concatenate batches with the same columns."""
        bs = [b for b in batches if b.num_rows > 0]
        if not bs:
            return batches[0] if batches else MessageBatch.empty()
        if len(bs) == 1:
            return bs[0]
        names = bs[0].column_names
        if any(b.column_names != names for b in bs[1:]):
            raise ArkError("cannot concat batches with different columns")
        cols: dict[str, Column] = {}
        for name in names:
            parts = [b.column(name) for b in bs]
            if isinstance(parts[0], BinaryColumn):
                cols[name] = BinaryColumn.concat(parts)
            else:
                cols[name] = np.concatenate(parts)
        return MessageBatch(cols)


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
        if isinstance(col, BinaryColumn):
            base = int(col.offsets[0])
            h.update(b"binary" + (col.offsets - base).tobytes())
            h.update(col.values[base: int(col.offsets[-1])].tobytes())
        elif col.dtype == object:
            h.update(b"object" + repr(col.tolist()).encode())
        else:
            h.update(col.dtype.str.encode() + np.ascontiguousarray(col).tobytes())
    return h.digest()
