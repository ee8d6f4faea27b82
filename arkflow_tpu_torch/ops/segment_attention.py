"""Segment flash attention: block-diagonal attention over token-packed rows.

Counterpart of ``arkflow_tpu/ops/segment_attention.py::segment_flash_attention``.
Query i of row b sees key j iff ``seg[b, i] == seg[b, j]`` and
``seg[b, i] > 0``; the rows of dead queries (segment 0) are written as
zeros. Not causal. Softmax runs in float32; the output has q's dtype.

Three parts:
- ``segment_attention_reference``: the plain PyTorch version (masked softmax
  over the full [B, 1, S, S] pair mask), the port's analogue of Pallas
  interpret mode.
- the CUDA kernel ``csrc/segment_attention.cu``, built for sm_90a at first
  use: K1's tile under the segment mask policy (``csrc/mma_tile.cuh`` for
  bf16 at D >= 16, ``csrc/flash_tile.cuh`` for f32 and D = 8). It replaces
  the Pallas kernel ``_segment_kernel``; at the packed serving shapes it is
  bound by device-memory bytes (each live q/k/v row read once, the output
  written once), so it stages K/V tiles through shared memory once per
  64-query tile and loads only key tiles whose segment-id range meets the
  query tile's -- a test that holds for any ``segment_ids``, since
  ``pack_tokens`` numbers segments out of position order. A query tile with
  no live query writes zeros and reads nothing.
- ``segment_flash_attention``: the wrapper. A CPU tensor takes the plain
  version; a CUDA tensor launches the kernel or raises. ``launches`` counts
  the kernel launches, in all and per variant (``kernel_variant``).
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

launches = LaunchCounter(VARIANTS)
_library = KernelLibrary("segment_attention")


def segment_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                segment_ids: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: the same function on the full masked
    score matrix. q/k/v: [B, H, S, D]; segment_ids: [B, S]."""
    d = q.shape[3]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    seg = segment_ids.to(device=q.device, dtype=torch.int64)
    live = seg > 0  # [B, S]
    pair = (seg[:, :, None] == seg[:, None, :]) & live[:, :, None]  # [B, Sq, Sk]
    probs = torch.softmax(scores.masked_fill(~pair[:, None], _NEG), dim=-1)
    out = torch.matmul(probs, v.float())
    # dead queries emit zeros (a fully masked softmax degenerates to uniform)
    return out.masked_fill(~live[:, None, :, None], 0.0).to(q.dtype)


def _launch(q, k, v, segment_ids) -> torch.Tensor:
    out = torch.empty_like(q)  # keeps q's (possibly [B, S, H, D]) layout
    variant = check_operands("segment attention", q, k, v, out)
    b, h, s, d = q.shape
    if (segment_ids.device != q.device or segment_ids.dtype != torch.int32
            or segment_ids.shape != (b, s) or not segment_ids.is_contiguous()):
        raise ValueError(
            f"segment_ids must be a contiguous int32 [{b}, {s}] tensor on {q.device}, "
            f"got {segment_ids.dtype} {tuple(segment_ids.shape)} on {segment_ids.device}")
    if out.numel() == 0:
        return out
    lib = _library.load()
    fn = lib.arkflow_segment_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    strides = operand_strides(q, k, v, out)
    with torch.cuda.device(q.device):  # the tile's shared-memory grant is per device
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 segment_ids.data_ptr(), b, h, s, d, int(q.dtype == torch.bfloat16),
                 VARIANTS.index(variant), 1.0 / math.sqrt(d), strides, stream)
    if err != 0:
        raise RuntimeError(f"segment attention kernel launch failed: CUDA error {err}")
    launches.add(variant)
    return out


def segment_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            segment_ids: torch.Tensor) -> torch.Tensor:
    """q/k/v: [B, H, S, D] (the head dim contiguous; any batch/head/seq
    strides); segment_ids: [B, S] int32, 0 = dead position. Returns
    [B, H, S, D] in q's dtype, laid out like q."""
    if q.device.type == "cpu":
        return segment_attention_reference(q, k, v, segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"segment attention runs on cuda or cpu tensors, not {q.device}")
    return _launch(q, k, v, segment_ids)
