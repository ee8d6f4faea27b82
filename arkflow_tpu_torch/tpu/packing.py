"""Token packing: several short examples per model row, no padding work.

Counterpart of ``arkflow_tpu/tpu/packing.py`` (its Python first-fit-
decreasing loop; the JAX package's native tier gives the same layout, and
the tests hold this module to it bitwise):

- ``segment_ids`` keep attention block-diagonal: tokens attend only within
  their own example (0 marks dead positions);
- ``position_ids`` restart at 0 per example, so position embeddings match
  the unpacked layout;
- ``example_row``/``example_pos`` locate each example's first token
  ([CLS]), so per-example outputs gather back into the original order.

Segments are numbered in the examples' ORIGINAL order while rows are filled
longest first, so within a row the ids are not in position order; each
segment is still one contiguous span.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class PackedTokens:
    """Packed layout: P rows of width ``seq`` holding E examples (E >= P)."""

    input_ids: np.ndarray     # [P, seq] int32, 0 on dead positions
    segment_ids: np.ndarray   # [P, seq] int32, 1..k per example, 0 = dead
    position_ids: np.ndarray  # [P, seq] int32, restarts at 0 per example
    example_row: np.ndarray   # [E] int32: packed row of example i's first token
    example_pos: np.ndarray   # [E] int32: column of example i's first token

    @property
    def num_rows(self) -> int:
        return self.input_ids.shape[0]

    @property
    def num_examples(self) -> int:
        return self.example_row.shape[0]

    @property
    def fill_ratio(self) -> float:
        total = self.input_ids.shape[0] * self.input_ids.shape[1]
        return float((self.segment_ids > 0).sum()) / total if total else 0.0


def pack_tokens(ids: np.ndarray, lengths: np.ndarray, seq: int) -> PackedTokens:
    """First-fit-decreasing pack of N ragged examples into rows of width
    ``seq``. Longer examples are truncated to ``seq`` (callers pick ``seq``
    as the bucket of the longest example, the truncation padding applies
    too); an empty example still takes its [CLS] slot. Entry i of the
    ``example_*`` arrays is original row i."""
    ids = np.asarray(ids)
    if ids.ndim != 2 or (ids.shape[0] > 0 and ids.shape[1] == 0):
        raise ValueError(f"pack_tokens: ids must be [n, smax>0], got shape {ids.shape}")
    n = ids.shape[0]
    lengths = np.minimum(np.asarray(lengths, np.int64), min(seq, ids.shape[1]))
    lengths = np.maximum(lengths, 1)
    if n == 0:
        z = np.zeros((0, seq), np.int32)
        e = np.zeros((0,), np.int32)
        return PackedTokens(z, z.copy(), z.copy(), e, e.copy())

    order = np.argsort(-lengths, kind="stable")
    bin_free = np.empty(n, np.int64)  # capacity left per row; at most n rows
    n_bins = 0
    bin_of = np.empty(n, np.int64)
    start_of = np.empty(n, np.int64)
    for i in order:
        length = lengths[i]
        fits = bin_free[:n_bins] >= length
        if fits.any():
            b = int(np.argmax(fits))  # first fit
        else:
            b = n_bins
            n_bins += 1
            bin_free[b] = seq
        bin_of[i] = b
        start_of[i] = seq - bin_free[b]
        bin_free[b] -= length

    out_ids = np.zeros((n_bins, seq), np.int32)
    seg = np.zeros((n_bins, seq), np.int32)
    pos = np.zeros((n_bins, seq), np.int32)
    seg_next = np.ones(n_bins, np.int64)
    ex_row = np.empty(n, np.int32)
    ex_pos = np.empty(n, np.int32)
    for i in range(n):
        b, st, length = bin_of[i], start_of[i], lengths[i]
        out_ids[b, st:st + length] = ids[i, :length]
        seg[b, st:st + length] = seg_next[b]
        seg_next[b] += 1
        pos[b, st:st + length] = np.arange(length)
        ex_row[i] = b
        ex_pos[i] = st
    return PackedTokens(out_ids, seg, pos, ex_row, ex_pos)


def carve_row_windows(pk: PackedTokens, max_rows: int, max_examples: int,
                      row_buckets: Optional[tuple[int, ...]] = None,
                      ) -> list[tuple[dict, np.ndarray]]:
    """Slice a packed layout into independent row windows of at most
    ``max_rows`` rows and ``max_examples`` examples.

    Rows are independent after packing (attention is block-diagonal within
    a row, every example lives in one row), so a window is a row slice plus
    the examples whose [CLS] sits in it. With ``row_buckets`` the window
    sizes cascade down the grid (1139 rows against [..., 512, 1024] carve
    1024 + 64 + 32 + ...), so every window but the sub-minimum residue lands
    bucket-exact. Returns ``(inputs, example_idx)`` pairs: ``inputs`` feeds
    the packed apply (``example_row`` re-based to the window),
    ``example_idx`` scatters the window's outputs back into example order.
    """
    if max_rows < 1 or max_examples < 1:
        raise ValueError(
            f"carve_row_windows: max_rows/max_examples must be >= 1, "
            f"got ({max_rows}, {max_examples})")
    total_rows = pk.num_rows
    if total_rows == 0:
        return []
    buckets = sorted(b for b in (row_buckets or ()) if b <= max_rows)
    order = np.argsort(pk.example_row, kind="stable")
    row_sorted = pk.example_row[order]
    windows: list[tuple[dict, np.ndarray]] = []
    lo = 0
    b0 = 0
    while lo < total_rows:
        remaining = total_rows - lo
        step = min(max_rows, remaining)
        if buckets:
            fitting = [b for b in buckets if b <= step]
            # bucket-exact cascade; the sub-minimum residue goes as it is
            # (the runner pads it to the smallest bucket)
            if fitting and remaining > fitting[-1]:
                step = fitting[-1]
        hi = lo + step
        b1 = int(np.searchsorted(row_sorted, hi, side="left"))
        if b1 - b0 > max_examples:
            # the (b0 + max_examples)-th example's row does not fit: end the
            # window before it (a row's examples are inseparable)
            hi = int(row_sorted[b0 + max_examples])
            b1 = int(np.searchsorted(row_sorted, hi, side="left"))
            if hi <= lo:
                # one row alone holds more than max_examples examples: send
                # it alone and let the runner's grid check raise
                hi = lo + 1
                b1 = int(np.searchsorted(row_sorted, hi, side="left"))
        idx = order[b0:b1]
        windows.append((
            {
                "input_ids": pk.input_ids[lo:hi],
                "segment_ids": pk.segment_ids[lo:hi],
                "position_ids": pk.position_ids[lo:hi],
                "example_row": (pk.example_row[idx] - lo).astype(np.int32),
                "example_pos": pk.example_pos[idx],
            },
            idx,
        ))
        lo = hi
        b0 = b1
    return windows
