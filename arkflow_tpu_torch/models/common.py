"""Shared building blocks of the port's models: functions on tensors.

Counterpart of ``arkflow_tpu/models/common.py``. Params stay nested dicts of
tensors in the JAX tree's layout (dense ``w`` stored ``[in, out]``). The
casts sit where the JAX code puts them, so both packages round at the same
places: matmuls and their bias adds in bfloat16, layer-norm and RMS-norm
statistics and softmax in float32.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch

from arkflow_tpu_torch.models.quantize import dense_w8a8

Params = Any  # nested dict of tensors


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *, bias: bool = True) -> Params:
    scale = 1.0 / math.sqrt(in_dim)
    p = {"w": torch.empty(in_dim, out_dim).uniform_(-scale, scale, generator=gen)}
    if bias:
        p["b"] = torch.zeros(out_dim)
    return p


def dense(p: Params, x: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    if "w_q" in p:  # W8A8 serving form (models/quantize.py): an int8 product
        return dense_w8a8(p, x, dtype)
    y = x.to(dtype) @ p["w"].to(dtype)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def stack_layers(layers: list) -> Params:
    """Stack per-layer param dicts into one dict of [layers, ...] tensors
    (the JAX trees' ``tree_map(jnp.stack, *layers)``)."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([lp[k] for lp in layers]) for k in first}
    return torch.stack(layers)


def layer_params(stacked: Params, i: int) -> Params:
    """Layer ``i``'s params out of a stacked tree (views, no copies)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


def layer_norm_init(dim: int) -> Params:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def rms_norm_init(dim: int, device=None) -> Params:
    return {"scale": torch.ones(dim, device=device)}


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * p["scale"]).to(x.dtype)


def embedding_init(gen: torch.Generator, vocab: int, dim: int, scale: float = 0.02) -> Params:
    return {"table": torch.randn(vocab, dim, generator=gen) * scale}


def embedding(p: Params, ids: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Rows of the table at ``ids``, in ``dtype``. Ids index as JAX's
    ``table[ids]`` does: a negative id counts from the end and an id past
    either end clamps to it (``jnp.arange(10.)[jnp.array([3, 12])]`` is
    ``[3, 9]``), so a tokenizer whose vocabulary outgrows the table neither
    raises on the CPU nor trips a device-side assert on CUDA. The rows are
    gathered, then cast: the same values as casting the table first."""
    table = p["table"]
    n = table.shape[0]
    ids = torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)
    return table[ids].to(dtype)


def hf_tensor(state: dict, name: str, transpose: bool = False) -> torch.Tensor:
    """One HuggingFace state-dict entry (a torch tensor of any dtype,
    bfloat16 included, or a numpy array) as a new float32 CPU tensor,
    optionally transposed from torch's ``[out, in]`` to ``[in, out]``."""
    v = state[name]
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", torch.float32, copy=not transpose)
    else:
        t = torch.from_numpy(np.array(v, dtype=np.float32))
    return t.T.contiguous() if transpose else t


def gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None, *,
              softmax_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Batched multi-head attention on [B, S, H, Dh] tensors: the plain
    attention the model uses when the kernel is off.

    Scores are computed in q's dtype and rounded to it before the softmax
    cast, as the JAX version does. ``mask`` broadcasts to [B, H, Sq, Sk],
    True = attend; masked scores take the softmax dtype's lowest value.
    """
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(softmax_dtype) / math.sqrt(dh)
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(softmax_dtype).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
