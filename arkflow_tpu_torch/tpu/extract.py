"""Columns to model inputs: per-row token estimates of a payload column
(the token-budget coalescer's sizing signal) and the tensor inputs of the
tensor families.

Counterpart of ``arkflow_tpu/tpu/extract.py`` (``payload_token_estimates``,
``extract_tensor``, ``_binary_matrix``), reading the port's columns with
numpy: a binary or string column (values + offsets, Arrow's binary layout)
in vectorized passes over its buffers, no per-row Python; an N-D numeric
numpy column, the port's counterpart of Arrow's fixed-size lists; a list
column (the json codec's ``[[...], ...]`` values) flattened fully.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from arkflow_tpu_torch.batch import (
    BinaryColumn,
    MessageBatch,
    ObjectColumn,
    VarlenColumn,
    column_to_pylist,
)
from arkflow_tpu_torch.errors import ProcessError

#: ragged binary rows of at most this mean length (bytes) are copied by one
#: flat gather; longer ones by a slice copy each
_GATHER_MAX_MEAN_LEN = 128

#: byte classes of the hash tokenizer's ``[a-z0-9]+|[^\sa-z0-9]`` split after
#: ``.lower()``: WORD bytes extend a token, SINGLE bytes are one token each,
#: the rest is whitespace
_TOK_WORD = np.zeros(256, np.bool_)
for _r in (range(ord("a"), ord("z") + 1), range(ord("A"), ord("Z") + 1),
           range(ord("0"), ord("9") + 1)):
    _TOK_WORD[list(_r)] = True
_TOK_SPACE = np.zeros(256, np.bool_)
_TOK_SPACE[[ord(c) for c in " \t\n\r\x0b\x0c"]] = True
_TOK_SINGLE = ~(_TOK_WORD | _TOK_SPACE)


def payload_token_estimates(col: VarlenColumn, *, token_bytes: Optional[float] = None,
                            max_tokens: Optional[int] = None) -> np.ndarray:
    """Per-row token-count estimates ([n] int64) of a binary or string column.

    Default mode equals the hash tokenizer's count exactly: word runs plus
    standalone punctuation bytes, plus 2 specials ([CLS]/[SEP]).
    ``token_bytes`` switches to ``ceil(len / token_bytes) + 2`` (subword
    tokenizers, whose splits do not follow whitespace). ``max_tokens`` clamps
    rows to the serving truncation width, so one huge payload cannot starve
    an emission's budget.
    """
    offsets = col.offsets
    n = len(col)
    if n == 0:
        return np.zeros(0, np.int64)
    starts = offsets[:-1]
    lens = (offsets[1:] - starts).astype(np.int64)
    if token_bytes is not None:
        est = np.ceil(lens / float(token_bytes)).astype(np.int64) + 2
    else:
        lo = int(starts[0])
        window = col.values[lo:int(offsets[-1])]
        word = _TOK_WORD[window]
        # a word-run start: a WORD byte not preceded by a WORD byte; a row's
        # first byte always starts a run (the byte before it is another row's)
        run_start = word.copy()
        run_start[1:] &= ~word[:-1]
        within = starts - lo
        inside = within[within < len(window)]
        run_start[inside] = word[inside]
        counts = run_start.astype(np.int64) + _TOK_SINGLE[window]
        cs = np.concatenate(([0], np.cumsum(counts)))
        ends = np.minimum(within + lens, len(window))
        est = cs[ends] - cs[np.minimum(within, len(window))] + 2
    est = np.maximum(est, 2)  # empty text still tokenizes to [CLS][SEP]
    if max_tokens is not None:
        est = np.minimum(est, int(max_tokens))
    return est


def _binary_matrix(col: BinaryColumn, n: int, size: int) -> np.ndarray:
    """Binary column -> ``[n, size]`` uint8, each row zero-padded or
    truncated to ``size`` bytes, off the buffers:

    - rows of one length (image payloads): the values buffer is the matrix,
      one reshape view (one bulk copy when rows are shorter than ``size``);
    - ragged short rows: one flat gather, O(total bytes);
    - ragged long rows: a slice copy each.
    """
    values, offsets = col.values, col.offsets
    if n == 0:
        return np.zeros((0, size), np.uint8)
    starts = offsets[:-1]
    lens = offsets[1:] - starts
    if lens.min() == lens.max():
        # rows sit back to back in the values buffer: the [n, L] matrix is a
        # reshape of it
        length = int(lens[0])
        base = int(offsets[0])
        mat = values[base: base + n * length].reshape(n, length)
        if length >= size:
            return mat[:, :size]  # truncation: a strided view, still no copy
        out = np.zeros((n, size), np.uint8)
        out[:, :length] = mat
        return out
    lens = np.minimum(lens, size)  # truncation: only the first ``size`` bytes land
    out = np.zeros((n, size), np.uint8)
    total = int(lens.sum())
    if not total:
        return out
    if total <= n * _GATHER_MAX_MEAN_LEN:
        # row i's values[starts[i]: starts[i] + lens[i]] into out[i, :lens[i]],
        # as one flat source/destination index pair
        row_of = np.repeat(np.arange(n, dtype=np.int64), lens)
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.concatenate(([0], np.cumsum(lens[:-1]))), lens)
        out.reshape(-1)[row_of * size + within] = values[np.repeat(starts, lens) + within]
    else:
        for i in range(n):
            out[i, :lens[i]] = values[starts[i]: starts[i] + lens[i]]
    return out


def extract_tensor(batch: MessageBatch, field: str, name: str, dtype: str,
                   want: tuple, *, who: str) -> np.ndarray:
    """One column -> a ``[B, *want]`` array.

    - binary columns: raw bytes, zero-padded or truncated to ``prod(want)``
      per row and reshaped; float32 targets are scaled from uint8 by 1/255
      (images);
    - N-D numeric columns (fixed-size lists): reshaped to ``want`` per row;
    - (nested) list columns: flattened fully, as Arrow's ``flatten`` does
      (a null list adds nothing, a null value is NaN), and reshaped;
    - 1-D columns: only when ``want`` is scalar-compatible.
    """
    if not batch.has_column(field):
        raise ProcessError(f"{who}: column {field!r} not found for model input {name!r}")
    col = batch.column(field)
    n = batch.num_rows
    want = tuple(int(d) for d in want)
    if isinstance(col, BinaryColumn):
        out = _binary_matrix(col, n, int(np.prod(want))).reshape(n, *want)
        if dtype == "float32":
            # uint8 divides straight to float32: the values of a cast, then
            # the divide, without the intermediate copy
            return out / np.float32(255.0)
        return out.astype(dtype, copy=False)
    if isinstance(col, ObjectColumn) and isinstance(col.type, tuple) \
            and col.type[0] in ("list", "fixed_size_list"):
        arr = _flatten_lists(col).astype(dtype, copy=False)
        try:
            return arr.reshape(n, *want)
        except ValueError as e:
            raise ProcessError(
                f"{who}: column {field!r} does not reshape to {want} per row: {e}") from e
    if not isinstance(col, np.ndarray):
        col = np.array([np.nan if v is None else v for v in column_to_pylist(col)])
    arr = col.astype(dtype, copy=False)
    if arr.ndim > 1:
        try:
            return arr.reshape(n, *want)
        except ValueError as e:
            raise ProcessError(
                f"{who}: column {field!r} does not reshape to {want} per row: {e}") from e
    if want and int(np.prod(want)) != 1:
        raise ProcessError(
            f"{who}: column {field!r} is scalar per row but input {name!r} wants {want}")
    return arr.reshape(n, *([1] * len(want)))


def _list_depth(t) -> tuple[int, object]:
    """How many list levels a type nests, and its leaf type."""
    depth = 0
    while isinstance(t, tuple) and t[0] in ("list", "fixed_size_list"):
        t, depth = t[1], depth + 1
    return depth, t


def _flatten_lists(col: ObjectColumn) -> np.ndarray:
    """Every leaf value of a (nested) list column in row order, as numpy:
    rows of one shape in one conversion, others through a walk."""
    depth, leaf = _list_depth(col.type)
    dtype = {"bool": np.bool_, "int64": np.int64, "int32": np.int32}.get(leaf, np.float64)
    if all(row is not None for row in col.values):
        try:
            return np.array(col.values, dtype=dtype).reshape(-1)
        except (ValueError, TypeError):  # ragged, or holding nulls
            pass
    flat: list = []

    def walk(v: list, level: int) -> None:
        if level == 1:
            flat.extend(v)
            return
        for x in v:
            if x is not None:
                walk(x, level - 1)

    for row in col.values:
        if row is not None:
            walk(row, depth)
    if any(x is None for x in flat):
        return np.array([np.nan if x is None else x for x in flat], np.float64)
    return np.array(flat, dtype=dtype)
