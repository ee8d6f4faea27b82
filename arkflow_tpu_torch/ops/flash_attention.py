"""Dense flash attention (K4): no lengths, an optional causal mask.

Counterpart of ``arkflow_tpu/ops/flash_attention.py::flash_attention``.
q/k/v are ``[B, H, S, D]``; every key is visible to every query (only
``k_pos <= q_pos`` when causal); the softmax runs in float32 and the output
has q's dtype. S must divide by ``min(tile_q, S)`` and ``min(tile_k, S)``,
as on the TPU, on either device: the check runs before any launch, though
the CUDA kernel tiles the work its own way.

Three parts:
- ``flash_attention_reference``: the plain PyTorch version, the Pallas
  body's arithmetic over all queries at once: f32 operands, scores scaled by
  1/sqrt(D), an online softmax over key tiles of ``tile_k``, the result
  divided by ``max(l, 1e-30)``.
- the CUDA kernel ``csrc/flash_attention.cu`` (K1's tile under the dense
  mask policy, which reads no lengths: ``csrc/mma_tile.cuh`` for bf16 at
  D >= 16, ``csrc/flash_tile.cuh`` for f32 and D = 8), built for sm_90a at
  first use.
- ``flash_attention``: the wrapper. A CPU tensor takes the plain version; a
  CUDA tensor launches the kernel or raises. ``flash_attention.launches``
  counts the kernel launches, apart from K1's, in all and per variant
  (``kernel_variant``). (The package exports the function under this
  module's name, so the count hangs on the function.)
"""

from __future__ import annotations

import ctypes
import math

import torch

from arkflow_tpu_torch.ops.build import KernelLibrary
from arkflow_tpu_torch.ops.ragged_attention import (
    VARIANTS,
    LaunchCounter,
    check_operands,
    operand_strides,
)

_NEG = -1e30

_library = KernelLibrary("flash_attention")


def _tiles(s: int, tile_q: int, tile_k: int) -> tuple[int, int]:
    tile_q, tile_k = min(tile_q, s), min(tile_k, s)
    if s % tile_q or s % tile_k:
        raise ValueError(f"seq len {s} must divide tiles ({tile_q}, {tile_k})")
    return tile_q, tile_k


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = False, tile_k: int = 128) -> torch.Tensor:
    """Plain version of the kernel: q/k/v [B, H, S, D] -> [B, H, S, D] in
    q's dtype, by the online softmax over key tiles of ``tile_k``."""
    s, d = q.shape[2], q.shape[3]
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = 1.0 / math.sqrt(d)
    o = torch.zeros_like(qf)
    m = torch.full(qf.shape[:-1], _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    q_pos = torch.arange(s, device=q.device)[:, None]
    for k0 in range(0, s, tile_k):
        kt, vt = kf[:, :, k0:k0 + tile_k], vf[:, :, k0:k0 + tile_k]
        scores = torch.matmul(qf, kt.transpose(-1, -2)) * scale  # [B, H, S, TK]
        if causal:
            k_pos = torch.arange(k0, k0 + kt.shape[2], device=q.device)[None, :]
            scores = torch.where(k_pos <= q_pos, scores, _NEG)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.matmul(p, vt)
        m = m_new
    return (o / torch.clamp_min(l[..., None], 1e-30)).to(q.dtype)


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    out = torch.empty_like(q)  # keeps q's (possibly [B, S, H, D]) layout
    variant = check_operands("flash attention", q, k, v, out)
    b, h, s, d = q.shape
    if out.numel() == 0:
        return out
    fn = _library.load().arkflow_flash_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    with torch.cuda.device(q.device):  # the tile's shared-memory grant is per device
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s, d,
                 int(q.dtype == torch.bfloat16), int(causal), 1.0 / math.sqrt(d),
                 operand_strides(q, k, v, out), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")
    flash_attention.launches.add(variant)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, tile_q: int = 128,
                    tile_k: int = 128) -> torch.Tensor:
    """q/k/v: [B, H, S, D] (the head dim contiguous; any batch/head/seq
    strides) -> [B, H, S, D] in q's dtype, laid out like q. Raises
    ``ValueError`` when S does not divide by ``min(tile, S)``."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, S, D], got shape {tuple(q.shape)}")
    _, tile_k = _tiles(q.shape[2], tile_q, tile_k)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, tile_k=tile_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, not {q.device}")
    return _launch(q, k, v, causal)


flash_attention.launches = LaunchCounter(VARIANTS)
