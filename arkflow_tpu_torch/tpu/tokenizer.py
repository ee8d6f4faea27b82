"""Tokenization for streaming text models.

Counterpart of ``arkflow_tpu/tpu/tokenizer.py``: ``HashTokenizer`` on its
pure-Python path (the JAX package's reference implementation; its C++ tier
gives identical ids), hermetic, with no vocabulary files; ``HFTokenizer``, a
HuggingFace fast tokenizer loaded from local files only; and
``build_tokenizer``, which prefers the second and falls back to the first.
``transformers`` is imported inside ``HFTokenizer`` only.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np

from arkflow_tpu_torch.batch import BinaryColumn

_WORD = re.compile(rb"[a-z0-9]+|[^\sa-z0-9]")


def _fnv1a32(data: bytes) -> int:
    h = 2166136261
    for b in data:
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


class HashTokenizer:
    """Whitespace/punctuation split, stable ids.

    ids: 0=pad, 1=cls, 2=sep, 3=unk; tokens FNV-1a-hash into [4, vocab).
    """

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size
        self.pad_id, self.cls_id, self.sep_id = 0, 1, 2
        self._cache: dict[bytes, int] = {}

    def _token_id(self, tok: bytes) -> int:
        tid = self._cache.get(tok)
        if tid is None:
            tid = 4 + _fnv1a32(tok) % (self.vocab_size - 4)
            if len(self._cache) < 1_000_000:
                self._cache[tok] = tid
        return tid

    def encode_batch(self, texts: Sequence[bytes], max_len: int) -> tuple[np.ndarray, np.ndarray]:
        raw = [t if isinstance(t, bytes) else t.encode() for t in texts]
        return self._encode_rows(raw, max_len)

    def encode_batch_view(self, values: np.ndarray, offsets: np.ndarray,
                          max_len: int) -> tuple[np.ndarray, np.ndarray]:
        """Tokenize straight off a payload view (``MessageBatch.payload_view``):
        rows are sliced out of the one values buffer."""
        n = len(offsets) - 1
        base = int(offsets[0]) if n else 0
        buf = values[base: int(offsets[n]) if n else 0].tobytes()
        return self._encode_rows(
            [buf[offsets[i] - base: offsets[i + 1] - base] for i in range(n)], max_len)

    def _encode_rows(self, raw: Sequence[bytes], max_len: int) -> tuple[np.ndarray, np.ndarray]:
        n = len(raw)
        ids = np.zeros((n, max_len), np.int32)
        mask = np.zeros((n, max_len), np.int32)
        for i, t in enumerate(raw):
            toks = _WORD.findall(t.lower())
            row = [self.cls_id] + [self._token_id(tok) for tok in toks[: max_len - 2]] + [self.sep_id]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask

    def decode(self, ids: Sequence[int]) -> str:
        """Hashing has no inverse vocabulary; render ids as text verbatim."""
        return " ".join(str(i) for i in ids)

    def decode_column(self, flat: np.ndarray, offsets: np.ndarray) -> BinaryColumn:
        """Decode a ragged id column (flat values + offsets) into a binary
        column of UTF-8 text, each row its ids as space-joined decimals --
        what ``decode`` gives per row -- built with numpy: the ids' digits
        go into one buffer and the row offsets follow from their widths."""
        flat = np.asarray(flat, np.int64)
        offsets = np.asarray(offsets, np.int64)
        if flat.size == 0:
            return BinaryColumn(np.empty(0, np.uint8), np.zeros(len(offsets), np.int64))
        counts = np.diff(offsets)
        digits = flat.astype(str)
        widths = np.char.str_len(digits).astype(np.int64)
        # every id followed by one space; the space after a row's last id goes
        buf = np.frombuffer((" ".join(digits.tolist()) + " ").encode("ascii"), np.uint8)
        spaces = np.cumsum(widths + 1) - 1
        keep = np.ones(buf.size, bool)
        keep[spaces[offsets[1:][counts > 0] - 1]] = False
        digit_cum = np.concatenate([[0], np.cumsum(widths)])
        row_len = np.diff(digit_cum[offsets]) + np.maximum(counts - 1, 0)
        out = np.zeros(len(offsets), np.int64)
        np.cumsum(row_len, out=out[1:])
        return BinaryColumn(buf[keep], out)


class HFTokenizer:
    """A ``transformers`` fast tokenizer (local files only)."""

    def __init__(self, name: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(name, local_files_only=True, use_fast=True)

    def encode_batch(self, texts: Sequence[bytes], max_len: int) -> tuple[np.ndarray, np.ndarray]:
        decoded = [t.decode("utf-8", "replace") if isinstance(t, bytes) else t for t in texts]
        enc = self._tok(decoded, padding="max_length", truncation=True, max_length=max_len,
                        return_tensors="np", return_attention_mask=True)
        return enc["input_ids"].astype(np.int32), enc["attention_mask"].astype(np.int32)

    def encode_batch_view(self, values: np.ndarray, offsets: np.ndarray,
                          max_len: int) -> tuple[np.ndarray, np.ndarray]:
        """Rows as ``str`` off the payload view: only the window the rows
        reference is decoded (a sliced batch shares a larger buffer), once
        when it is pure ASCII -- byte offsets then index the decoded text --
        and row by row otherwise."""
        n = len(offsets) - 1
        base = int(offsets[0]) if n else 0
        buf = values[base: int(offsets[n]) if n else 0].tobytes()
        text = buf.decode("utf-8", "replace")
        if len(text) == len(buf):
            rows = [text[offsets[i] - base: offsets[i + 1] - base] for i in range(n)]
        else:
            rows = [buf[offsets[i] - base: offsets[i + 1] - base].decode("utf-8", "replace")
                    for i in range(n)]
        return self.encode_batch(rows, max_len)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)


def build_tokenizer(name: Optional[str], vocab_size: int = 30522):
    """``HFTokenizer(name)`` when its files are on this machine; on any
    failure (no files, no ``transformers``) ``HashTokenizer(vocab_size)``,
    as the JAX package does."""
    if name:
        try:
            return HFTokenizer(name)
        except Exception:
            pass
    return HashTokenizer(vocab_size)
