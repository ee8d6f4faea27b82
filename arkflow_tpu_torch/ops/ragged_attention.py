"""Ragged flash attention: per-row sequence lengths, no work on padding.

Counterpart of ``arkflow_tpu/ops/ragged_attention.py::ragged_flash_attention``.
Key j of row b is visible iff ``j < lengths[b]`` (and ``j <= i`` when
causal); query rows ``i >= lengths[b]`` are written as zeros. Softmax runs in
float32; the output has q's dtype.

Three parts:
- ``ragged_attention_reference``: the plain PyTorch version (masked softmax
  over the full score matrix), the port's analogue of Pallas interpret mode.
- the CUDA kernel ``csrc/ragged_attention.cu``, built for sm_90a at first use.
- ``ragged_flash_attention``: the wrapper. A CPU tensor takes the plain
  version; a CUDA tensor launches the kernel or raises. ``launches`` counts
  the kernel launches.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from arkflow_tpu_torch.ops.build import KernelLibrary

_NEG = -1e30
#: head dims the kernel is instantiated for (csrc/ragged_attention.cu)
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)
_ALIGN = 16  # bytes: the kernel loads 16-byte (f32) / 8-byte (bf16) vectors


class LaunchCounter:
    """A thread-safe count of kernel launches (runner steps may launch from
    several executor threads at once)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def add(self) -> None:
        with self._lock:
            self.value += 1

    def reset(self) -> None:
        with self._lock:
            self.value = 0


launches = LaunchCounter()
_library = KernelLibrary("ragged_attention")


def ragged_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               lengths: torch.Tensor, *, causal: bool = False) -> torch.Tensor:
    """Plain version of the kernel: the same function on the full masked
    score matrix. q/k/v: [B, H, S, D]; lengths: [B]."""
    s, d = q.shape[2], q.shape[3]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    pos = torch.arange(s, device=q.device)
    lens = lengths.to(device=q.device, dtype=torch.int64).clamp(0, s)
    inside = pos[None, :] < lens[:, None]  # [B, S]
    valid = inside[:, None, :, None] & inside[:, None, None, :]  # [B, 1, Sq, Sk]
    if causal:
        valid = valid & (pos[None, :] <= pos[:, None])
    probs = torch.softmax(scores.masked_fill(~valid, _NEG), dim=-1)
    out = torch.matmul(probs, v.float())
    # pad queries emit zeros (a fully masked softmax degenerates to uniform)
    return out.masked_fill(~inside[:, None, :, None], 0.0).to(q.dtype)


def _check_operand(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, q on {like.device}")
    if t.dtype != like.dtype:
        raise ValueError(f"{name} is {t.dtype}, q is {like.dtype}")
    if t.shape != like.shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, q {tuple(like.shape)}")
    if t.stride(3) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous (stride {t.stride(3)})")
    size = t.element_size()
    if t.data_ptr() % _ALIGN or any((t.stride(i) * size) % _ALIGN for i in range(3)):
        raise ValueError(
            f"{name}: data pointer and batch/head/seq strides must be "
            f"{_ALIGN}-byte aligned (strides {t.stride()}, {size}-byte elements)")


def check_operands(kernel: str, q, k, v, out) -> None:
    """What the attention kernels of ``csrc/`` take: [B, H, S, D] float32 or
    bfloat16 operands alike in device, type and shape, a head dim they are
    instantiated for, laid out with the head dim contiguous and aligned."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, S, D], got shape {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{kernel} kernel takes float32 or bfloat16, got {q.dtype}")
    if q.shape[3] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]} not in the kernel's {KERNEL_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_operand(name, t, q)


def operand_strides(q, k, v, out) -> ctypes.Array:
    """The 12 (batch, head, seq) element strides of q, k, v and out, as the
    kernels' C interface takes them."""
    return (ctypes.c_longlong * 12)(*[t.stride(i) for t in (q, k, v, out) for i in range(3)])


def _launch(q, k, v, lengths, causal: bool) -> torch.Tensor:
    out = torch.empty_like(q)  # keeps q's (possibly [B, S, H, D]) layout
    check_operands("ragged attention", q, k, v, out)
    b, h, s, d = q.shape
    if (lengths.device != q.device or lengths.dtype != torch.int32
            or lengths.shape != (b,) or not lengths.is_contiguous()):
        raise ValueError(
            f"lengths must be a contiguous int32 [{b}] tensor on {q.device}, got "
            f"{lengths.dtype} {tuple(lengths.shape)} on {lengths.device}")
    if out.numel() == 0:
        return out
    lib = _library.load()
    fn = lib.arkflow_ragged_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    strides = operand_strides(q, k, v, out)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lengths.data_ptr(), b, h, s, d, int(q.dtype == torch.bfloat16),
             int(causal), 1.0 / math.sqrt(d), strides, stream)
    if err != 0:
        raise RuntimeError(f"ragged attention kernel launch failed: CUDA error {err}")
    launches.add()
    return out


def ragged_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, *, causal: bool = False) -> torch.Tensor:
    """q/k/v: [B, H, S, D] (the head dim contiguous; any batch/head/seq
    strides); lengths: [B] int32 true sequence lengths. Returns [B, H, S, D]
    in q's dtype, laid out like q."""
    if q.device.type == "cpu":
        return ragged_attention_reference(q, k, v, lengths, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"ragged attention runs on cuda or cpu tensors, not {q.device}")
    return _launch(q, k, v, lengths, causal)
