"""Shape bucketing: pad ragged batches onto a small grid of (batch, seq) shapes.

Counterpart of the right-padded part of ``arkflow_tpu/tpu/bucketing.py``.
The port runs eagerly and compiles nothing per shape, but the grid still
bounds padding waste (each dimension at most doubles), keeps the device's
working set at a few known shapes, and keeps batches and outputs identical
to the JAX package's for the same input.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from arkflow_tpu_torch.errors import ConfigError


def pow2_buckets(lo: int, hi: int) -> list[int]:
    out = []
    b = max(1, lo)
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return out


@dataclass(frozen=True)
class BucketPolicy:
    batch_buckets: tuple[int, ...] = tuple(pow2_buckets(8, 256))
    seq_buckets: tuple[int, ...] = tuple(pow2_buckets(32, 512))

    @classmethod
    def from_config(cls, config: dict, *, max_batch: Optional[int] = None,
                    max_seq: Optional[int] = None) -> "BucketPolicy":
        bb = config.get("batch_buckets")
        sb = config.get("seq_buckets")
        if bb is None:
            bb = pow2_buckets(8, max_batch or 256)
        if sb is None:
            sb = pow2_buckets(32, max_seq or 512)
        bb = tuple(sorted(int(x) for x in bb))
        sb = tuple(sorted(int(x) for x in sb))
        if not bb or not sb or bb[0] <= 0 or sb[0] <= 0:
            raise ConfigError("bucket lists must be non-empty positive ints")
        return cls(bb, sb)

    @staticmethod
    def _pick(n: int, buckets: Sequence[int]) -> int:
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]

    def batch_bucket(self, n: int) -> int:
        return self._pick(n, self.batch_buckets)

    def seq_bucket(self, n: int) -> int:
        return self._pick(n, self.seq_buckets)

    def max_batch(self) -> int:
        return self.batch_buckets[-1]


def pad_batch_dim(arr: np.ndarray, target: int) -> np.ndarray:
    """Pad axis 0 with zeros up to ``target`` rows."""
    n = arr.shape[0]
    if n == target:
        return arr
    if n > target:
        raise ValueError(f"batch {n} exceeds bucket {target}")
    pad = [(0, target - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def pad_seq_dim(arr: np.ndarray, target: int, axis: int = 1) -> np.ndarray:
    """Pad (or truncate) ``axis`` to ``target`` positions."""
    n = arr.shape[axis]
    if n == target:
        return arr
    if n > target:
        slicer = [slice(None)] * arr.ndim
        slicer[axis] = slice(0, target)
        return arr[tuple(slicer)]
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - n)
    return np.pad(arr, pad)
