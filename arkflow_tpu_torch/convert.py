"""Param trees between the JAX package's layout and the port's tensors.

The port keeps the JAX tree's layout exactly -- the same nested paths, dense
``w`` stored ``[in, out]``, per-layer params stacked on a leading axis -- so
a tree converts leaf by leaf and digests or checkpoints can carry over.
The conversion goes through numpy only: the caller hands over the JAX tree as
numpy arrays (``jax.device_get``), and bfloat16 leaves (an ``ml_dtypes``
dtype in numpy) pass through float32, which holds every bfloat16 value
exactly, so a round trip is bitwise.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int8): torch.int8,
}


def _leaf_from_numpy(arr: Any) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32))).to(torch.bfloat16)
    if arr.dtype not in _TORCH_DTYPES:
        raise TypeError(f"param leaf of dtype {arr.dtype} has no torch counterpart here")
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_jax(tree: Mapping) -> dict:
    """JAX param tree (nested dicts of numpy arrays) -> the port's params
    (nested dicts of CPU tensors, same paths and shapes)."""
    return {k: params_from_jax(v) if isinstance(v, Mapping) else _leaf_from_numpy(v)
            for k, v in tree.items()}


def params_to_numpy(params: Mapping) -> dict:
    """The port's params -> nested dicts of numpy arrays (bfloat16 leaves as
    float32, exactly)."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {k: params_to_numpy(v) if isinstance(v, Mapping) else leaf(v)
            for k, v in params.items()}
