"""Ragged flash attention: per-row sequence lengths, no work on padding;
and paged flash attention over the serving KV page pools (at the end).

Counterpart of ``arkflow_tpu/ops/ragged_attention.py::ragged_flash_attention``.
Key j of row b is visible iff ``j < lengths[b]`` (and ``j <= i`` when
causal); query rows ``i >= lengths[b]`` are written as zeros. Softmax runs in
float32; the output has q's dtype.

Three parts:
- ``ragged_attention_reference``: the plain PyTorch version (masked softmax
  over the full score matrix), the port's analogue of Pallas interpret mode.
- the CUDA kernel ``csrc/ragged_attention.cu``, built for sm_90a at first use:
  the tensor-core tile of ``csrc/mma_tile.cuh`` for bf16 at D >= 16, the FMA
  body of ``csrc/flash_tile.cuh`` for f32 and D = 8 (``kernel_variant``; the
  wrapper passes its choice into the C entry, which launches that body).
- ``ragged_flash_attention``: the wrapper. A CPU tensor takes the plain
  version; a CUDA tensor launches the kernel or raises. ``launches`` counts
  the kernel launches, in all and per variant.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading

import torch

from arkflow_tpu_torch.ops.build import KernelLibrary

_NEG = -1e30
#: head dims K1, K2 and K4 are instantiated for (csrc/flash_tile.cuh,
#: csrc/mma_tile.cuh)
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 128)
#: head dims of the tensor-core tile: mma.sync's k is 16 bf16 values
MMA_HEAD_DIMS = (16, 32, 64, 128)
#: keys per staged tile of the tensor-core tile, by head dim (kMmaBlockK in
#: mma_tile.cuh, chosen by timing both widths on the card)
MMA_BLOCK_K = {16: 64, 32: 64, 64: 64, 128: 32}
#: the bodies a launch of K1, K2, K3 or K4 may run: bf16 on the tensor cores
#: and the f32 FMA loop; a body's index here is its code in the C entries
#: (kVariantMma, kVariantFma in csrc/attention_common.cuh)
VARIANTS = ("mma", "fma")
_ALIGN = 16  # bytes: the kernels copy 16-byte vectors


#: per thread: the tally of the CUDA graph capture running on it, if any
_capture = threading.local()


class LaunchCounter:
    """A thread-safe count of kernel launches (runner steps may launch from
    several executor threads at once), in all (``value``) and, for a kernel
    with several bodies, per variant (``variants``). A launch recorded while
    a CUDA graph is captured on the calling thread (``capturing``) runs no
    kernel: it goes to the capture's tally instead, which each replay of the
    graph adds back (``CapturedLaunches.replay``)."""

    def __init__(self, variants: tuple[str, ...] = ()):
        self._lock = threading.Lock()
        self.value = 0
        self.variants = dict.fromkeys(variants, 0)

    def add(self, variant: str | None = None) -> None:
        tally = getattr(_capture, "tally", None)
        if tally is not None:
            tally.record(self, variant)
            return
        self.add_many(1, {variant: 1} if variant is not None else {})

    def add_many(self, n: int, variants: dict[str, int]) -> None:
        with self._lock:
            self.value += n
            for variant, k in variants.items():
                self.variants[variant] += k

    def reset(self) -> None:
        with self._lock:
            self.value = 0
            self.variants = dict.fromkeys(self.variants, 0)


class CapturedLaunches:
    """The launches one capture recorded, per counter and per variant: the
    delta each replay of its graph adds to the counts."""

    def __init__(self):
        self.counts: dict[LaunchCounter, tuple[int, dict[str, int]]] = {}

    def record(self, counter: LaunchCounter, variant: str | None) -> None:
        n, variants = self.counts.get(counter, (0, {}))
        if variant is not None:
            variants = {**variants, variant: variants.get(variant, 0) + 1}
        self.counts[counter] = (n + 1, variants)

    def replay(self) -> None:
        for counter, (n, variants) in self.counts.items():
            counter.add_many(n, variants)


@contextlib.contextmanager
def capturing():
    """While a CUDA graph is captured on this thread: the launches its
    wrappers count go to the yielded ``CapturedLaunches``, not to the
    counts (the kernels do not run at capture). Other threads count as
    usual."""
    outer = getattr(_capture, "tally", None)
    _capture.tally = tally = CapturedLaunches()
    try:
        yield tally
    finally:
        _capture.tally = outer


def kernel_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The body a K1, K2 or K4 launch runs, from its dtype and head dim
    alone, chosen before the launch: ``"mma"`` (bf16 on the tensor cores,
    ``csrc/mma_tile.cuh``) for bf16 at D in ``MMA_HEAD_DIMS``, ``"fma"``
    (``csrc/flash_tile.cuh``) for f32, whose 1e-4 contract rules out bf16
    products, and for D = 8, below mma.sync's k of 16. The wrapper passes
    the choice into the C entry, which launches that body or refuses it.
    Raises ``ValueError`` for a dtype or head dim no body takes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the attention kernels take float32 or bfloat16, got {dtype}")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} not in the kernels' {KERNEL_HEAD_DIMS}")
    return "mma" if dtype == torch.bfloat16 and head_dim in MMA_HEAD_DIMS else "fma"


launches = LaunchCounter(VARIANTS)
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


def check_operands(kernel: str, q, k, v, out) -> str:
    """What the attention kernels of ``csrc/`` take: [B, H, S, D] float32 or
    bfloat16 operands alike in device, type and shape, a head dim they are
    instantiated for, laid out with the head dim contiguous and aligned.
    Returns the variant the launch runs (``kernel_variant``)."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, S, D], got shape {tuple(q.shape)}")
    variant = kernel_variant(q.dtype, q.shape[3])
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_operand(name, t, q)
    return variant


def operand_strides(q, k, v, out) -> ctypes.Array:
    """The 12 (batch, head, seq) element strides of q, k, v and out, as the
    kernels' C interface takes them."""
    return (ctypes.c_longlong * 12)(*[t.stride(i) for t in (q, k, v, out) for i in range(3)])


def _launch(q, k, v, lengths, causal: bool) -> torch.Tensor:
    out = torch.empty_like(q)  # keeps q's (possibly [B, S, H, D]) layout
    variant = check_operands("ragged attention", q, k, v, out)
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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    strides = operand_strides(q, k, v, out)
    with torch.cuda.device(q.device):  # the tile's shared-memory grant is per device
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lengths.data_ptr(), b, h, s, d, int(q.dtype == torch.bfloat16),
                 VARIANTS.index(variant), int(causal), 1.0 / math.sqrt(d), strides, stream)
    if err != 0:
        raise RuntimeError(f"ragged attention kernel launch failed: CUDA error {err}")
    launches.add(variant)
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


# -- paged flash attention (generation) ---------------------------------------
#
# Counterpart of ``arkflow_tpu/ops/ragged_attention.py::paged_flash_attention``:
# the KV context of each row lives in pages of a shared pool, named by an
# int32 page table, and is read in place (``csrc/paged_attention.cu``). bf16
# q runs the split-context tensor-core kernel (flash-decoding: one block per
# split of ``PAGED_SPLIT_K`` keys, then a combine kernel), f32 q the FMA
# kernel (``paged_variant``).

#: head dims the paged kernel is instantiated for (csrc/paged_attention.cu)
PAGED_HEAD_DIMS = (64, 128)
#: keys a split of the bf16 body holds (kSplitK in csrc/paged_attention.cu)
PAGED_SPLIT_K = 64
#: up to this many folded queries (C x group) a split block takes the decode
#: form: its warps split the keys; above it, 16 folded queries a warp
#: (kDecodeRows in csrc/paged_attention.cu)
PAGED_DECODE_ROWS = 16
_paged_library = KernelLibrary("paged_attention")


def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                              page_table: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Plain version of the paged kernel: gather every row's context through
    its page table, then mask ``key_pos <= off + i``. q: [B, C, H, dh];
    pools: [num_pages, page, kv_heads, dh]; page_table: [B, P]; off: [B].
    Softmax and both products in float32; returns [B, C, H, dh] in q's dtype."""
    b, c, h, dh = q.shape
    kvh = k_pages.shape[2]
    group = h // kvh
    ctx = page_table.shape[1] * k_pages.shape[1]
    table = page_table.to(device=q.device, dtype=torch.int64)
    kk = k_pages[table].reshape(b, ctx, kvh, dh).float()
    vv = v_pages[table].reshape(b, ctx, kvh, dh).float()
    qf = q.float().reshape(b, c, kvh, group, dh)
    scores = torch.einsum("bcngd,bjnd->bngcj", qf, kk) * (1.0 / math.sqrt(dh))
    positions = off.to(device=q.device, dtype=torch.int64)[:, None] + torch.arange(
        c, device=q.device)
    mask = torch.arange(ctx, device=q.device)[None, None, :] <= positions[:, :, None]
    probs = torch.softmax(scores.masked_fill(~mask[:, None, None], _NEG), dim=-1)
    out = torch.einsum("bngcj,bjnd->bcngd", probs, vv)
    return out.reshape(b, c, h, dh).to(q.dtype)


def paged_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The body a K3 launch runs: ``"mma"`` (bf16 q on the tensor cores, the
    split-context kernel and its combine) or ``"fma"`` (f32 q, whose 1e-4
    contract rules out bf16 products), at a head dim in ``PAGED_HEAD_DIMS``.
    The wrapper passes it into the C entry. Raises ``ValueError`` for a
    dtype or head dim no body takes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged attention kernel takes float32 or bfloat16 q, got {dtype}")
    if head_dim not in PAGED_HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} not in the paged kernel's {PAGED_HEAD_DIMS}")
    return "mma" if dtype == torch.bfloat16 else "fma"


def paged_scratch_floats(b: int, c: int, h: int, kv_heads: int, dh: int, p: int,
                         page: int) -> int:
    """Floats of partials the bf16 body needs: per (row, KV head, split,
    folded query) the split's unnormalised output (dh floats), its max and
    its normaliser."""
    splits = -(-p * page // PAGED_SPLIT_K)
    return b * kv_heads * splits * c * (h // kv_heads) * (dh + 2)


def _check_paged(q, k_pages, v_pages, page_table, off, out) -> str:
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"q must be [B, C, H, dh] and the pools [pages, page, kv_heads, dh], "
                         f"got {tuple(q.shape)} and {tuple(k_pages.shape)}")
    b, c, h, dh = q.shape
    variant = paged_variant(q.dtype, dh)
    if k_pages.shape[2] == 0 or h % k_pages.shape[2]:
        raise ValueError(f"q heads {h} must be a multiple of kv heads {k_pages.shape[2]}")
    for name, pool in (("k_pages", k_pages), ("v_pages", v_pages)):
        if pool.device != q.device or pool.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16 on {q.device}, got {pool.dtype} "
                             f"on {pool.device}")
        if pool.shape != k_pages.shape or pool.shape[3] != dh or not pool.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [pages, page, kv_heads, {dh}] "
                             f"pool like k_pages, got {tuple(pool.shape)}")
        if pool.data_ptr() % _ALIGN:
            raise ValueError(f"{name}: data pointer must be {_ALIGN}-byte aligned")
    for name, t, shape in (("page_table", page_table, None), ("off", off, (b,))):
        if (t.device != q.device or t.dtype != torch.int32 or not t.is_contiguous()
                or (shape is not None and t.shape != shape)
                or (shape is None and (t.dim() != 2 or t.shape[0] != b))):
            raise ValueError(
                f"{name} must be a contiguous int32 tensor on {q.device} "
                f"({'[B, P]' if shape is None else f'[{b}]'}), got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    size = q.element_size()
    for name, t in (("q", q), ("out", out)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous (stride {t.stride(3)})")
        if t.data_ptr() % _ALIGN or any((t.stride(i) * size) % _ALIGN for i in range(3)):
            raise ValueError(f"{name}: data pointer and batch/position/head strides must be "
                             f"{_ALIGN}-byte aligned (strides {t.stride()})")
    return variant


def _launch_paged(q, k_pages, v_pages, page_table, off) -> torch.Tensor:
    out = torch.empty_like(q)
    variant = _check_paged(q, k_pages, v_pages, page_table, off, out)
    b, c, h, dh = q.shape
    if out.numel() == 0:
        return out
    lib = _paged_library.load()
    fn = lib.arkflow_paged_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p]
    strides = (ctypes.c_longlong * 6)(*[t.stride(i) for t in (q, out) for i in range(3)])
    kvh, page, p = k_pages.shape[2], k_pages.shape[1], page_table.shape[1]
    with torch.cuda.device(q.device):  # the split kernel's shared-memory grant is per device
        # the bf16 body's partials, on the call's device and stream
        n = paged_scratch_floats(b, c, h, kvh, dh, p, page) if variant == "mma" else 0
        scratch = torch.empty(n, dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), out.data_ptr(),
                 page_table.data_ptr(), off.data_ptr(), b, c, h, kvh, dh, p, page,
                 int(q.dtype == torch.bfloat16), VARIANTS.index(variant),
                 1.0 / math.sqrt(dh), strides, scratch.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA error {err}")
    paged_flash_attention.launches.add(variant)
    return out


def paged_flash_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                          page_table: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Flash attention that reads K/V straight from the serving page pools.

    q: [B, C, H, dh]: C queries per row at absolute positions ``off[b] + i``
    (decode: C=1, off=lengths; chunked prefill: off=chunk offset). k_pages,
    v_pages: [num_pages, page, kv_heads, dh] bfloat16, one layer's pool.
    page_table: [B, P] int32; entries past a row's context may be 0 (the
    scratch page) and are never read. off: [B] int32. Query i attends keys
    0..off+i, clamped to the table's P * page keys; GQA is resolved inside
    the kernel. Returns [B, C, H, dh] in q's dtype. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises: bf16 q the
    split-context tensor-core body, f32 q the FMA body (``paged_variant``).
    ``paged_flash_attention.launches`` counts the calls that launched, in
    all and per body (a bf16 call launches the split kernel and its
    combine)."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table, off)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on cuda or cpu tensors, not {q.device}")
    return _launch_paged(q, k_pages, v_pages, page_table, off)


paged_flash_attention.launches = LaunchCounter(VARIANTS)
