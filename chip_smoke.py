#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one card.

    python3 chip_smoke.py

Phases, each printing its own lines (any failure exits non-zero before the
last line):

1. the card's identity (nvidia-smi name and power limit, torch's name);
2. building every CUDA kernel of the paths from ``arkflow_tpu_torch/csrc``
   (one nvcc per source, all started together);
3. K1, K2 and K4 against their plain versions at the tiles' edges (every
   head dim in bf16 and f32, S off the tile grid, lengths 0/1/S, causal,
   unsorted segment ids); then each kernel against its plain PyTorch
   version at BERT-base shapes, with its time, the plain version's, one
   PyTorch library call's (each as the device's own time, from a CUDA
   graph of many calls, and as one eager call timed by CUDA events) and
   the bound:
   K1 (ragged) on random lengths, K2 (segment) on packed layouts, and K2 at
   head dim 128 (the tensor-core tile's dynamic shared memory). Every K1,
   K2 and K4 case checks the variant its launch ran: ``mma`` (the bf16
   tensor-core tile) for bf16, ``fma`` for f32. Beside the 1/64 ceiling
   against the plain version, every bf16 output element is held to a limit
   scaled to its size and its row (``tile_err_ratio``) against
   ``emulate_mma_tile``, the plain version with the tile's rounding (P in
   bf16 over its key tiles);
4. K4 (dense flash attention) through its entry point
   ``arkflow_tpu_torch.ops.flash_attention``, once at each case's shape with
   the counts read around those calls (no other kernel may launch, and tiles
   that do not divide S raise before a launch); then each case against the
   plain version: the padded BERT-base step with every row full, Llama-3-8B's
   full-sequence forward at 512 and at 4096 tokens (causal), and the last in
   f32; and K1 with every length S at the BERT shape beside it;
5. the padded stream ``arkflow_tpu_torch/examples/bert_stream.json``
   (generate -> gpu_inference(bert_classifier, full BERT-base width, bf16)
   -> drop) through the port's ``Engine``, with the launch counts read
   around that run only, then the K1 path's outputs against the plain
   attention's on a few hundred rows;
6. the packed stream ``arkflow_tpu_torch/examples/bert_packed_stream.json``
   (generate -> memory buffer with token-budget coalescing ->
   gpu_inference(packing, BERT-base, bf16) -> drop) through ``Engine``:
   every row in order, K2 launches = layers x packed steps, no K1 launch,
   the packed steps' token fill; then K2 at the stream's own layout, and
   the same texts through the packed K2 path, the packed pair-mask path and
   the padded K1 path, whose outputs must agree (every K1 and K2 launch of
   the three BERT streams must be ``mma``);
7. the int8 stream ``arkflow_tpu_torch/examples/int8_bert_stream.json``
   (generate -> memory buffer -> gpu_inference(BERT-base, serving_dtype
   int8) -> drop) through ``Engine``, and the same config at bfloat16: every
   row in order, K1 launches = layers x steps, int8 products = dense layers
   x steps (none at bf16); then int8 against bf16 on the same texts (labels
   equal wherever the bf16 top-2 gap exceeds twice the largest logit
   difference), their step times, and the int8 product against the bf16 one
   at BERT-base's FFN shape;
8. K3 (paged) against its plain version where its splits and folds have
   edges (both head dims in bf16 and f32, GQA groups 1 to 8, decode and
   chunk folds, pages that straddle a split, padded chunk queries past the
   table); then at Llama-3-8B width (32 heads, 8 KV heads, head dim 128,
   page 16, 40 pages a row): decode (16 rows, one query, ragged contexts
   on shuffled page tables), the same with every page past each row's
   bound and the scratch page poisoned (the output must not change), the
   same in f32 (the FMA body), and 128-query chunks at offsets
   0/128/256/384, each timed. Every bf16 case must run the split-context
   tensor-core body (``mma``) and is held per element to
   ``emulate_paged_split``, the plain version with that body's splits,
   softmax tiles and P rounded to bf16;
9. the generate stream ``arkflow_tpu_torch/examples/llama_generate_stream.json``
   (generate -> gpu_generate(decoder_lm, Llama-3-8B widths and depth,
   continuous batching on paged KV, chunked prefill, dispatch depth 2) ->
   drop) through ``Engine``: every row in order, at most max_new_tokens
   each, K3 launches = layers x (decode + chunk steps), every one on the
   tensor-core body, no page leaked;
   then the step times, and the same prompts through a paged and a gather
   server at depth 1 (streams equal up to the first near-tie) and a paged
   server at depth 2 (equal to depth 1), and one decode step's logits:
   K3's no further from the gather path's or its plain version's than
   those two lie from each other, plus 1/64;
10. one ``{"kernels": [...]}`` line (times are device times; ``eager_ms``
    holds the eager calls' event times), then ``{"ok": true, "device": ...}``.

Needs one CUDA card and nvcc; imports nothing of JAX or ``arkflow_tpu``.
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from arkflow_tpu_torch.batch import MessageBatch  # noqa: E402
from arkflow_tpu_torch.components import Output  # noqa: E402
from arkflow_tpu_torch.config import EngineConfig  # noqa: E402
from arkflow_tpu_torch.models import paged_decode as pd  # noqa: E402
from arkflow_tpu_torch.models.paged_decode import (  # noqa: E402
    init_page_pool,
    paged_decode_step,
    paged_prefill,
)
from arkflow_tpu_torch.models import quantize as q8  # noqa: E402
from arkflow_tpu_torch.models.common import dense  # noqa: E402
from arkflow_tpu_torch.ops import flash_attention, flash_attention_reference  # noqa: E402
from arkflow_tpu_torch.ops import ragged_attention as ra  # noqa: E402
from arkflow_tpu_torch.ops import segment_attention as sa  # noqa: E402
from arkflow_tpu_torch.ops.build import KERNEL_SOURCES, build_all  # noqa: E402
from arkflow_tpu_torch.plugins.processor.gpu_inference import (  # noqa: E402
    pack_windows,
    scatter_windows,
)
from arkflow_tpu_torch.runtime.engine import Engine  # noqa: E402
from arkflow_tpu_torch.tools.profile_step import first_emission  # noqa: E402
from arkflow_tpu_torch.tpu.packing import pack_tokens  # noqa: E402
from arkflow_tpu_torch.tpu.runner import ModelRunner  # noqa: E402
from arkflow_tpu_torch.tpu.serving import GenerationServer  # noqa: E402
from arkflow_tpu_torch.tpu.tokenizer import HashTokenizer  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "arkflow_tpu_torch", "examples")
CONFIG = os.path.join(EXAMPLES, "bert_stream.json")
PACKED_CONFIG = os.path.join(EXAMPLES, "bert_packed_stream.json")
GENERATE_CONFIG = os.path.join(EXAMPLES, "llama_generate_stream.json")
INT8_CONFIG = os.path.join(EXAMPLES, "int8_bert_stream.json")
#: H100 SXM published peaks from NVIDIA's datasheet: HBM bytes/s, and
#: dense flop/s by operand type (f32 runs outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
INT8_PEAK_OPS = 1979e12  # dense int8 on the tensor cores
TOL = {torch.bfloat16: 1.0 / 64, torch.float32: 1e-4}
#: beside TOL's ceiling, a bf16 output of K1, K2 or K4 may lie from the
#: emulation of its body's rounding (``tile_err_ratio``) by one bf16 step
#: of its own size, this much for the f32 sums' order, and, on the tile,
#: P_FLIPS P values of its row that round to their other bf16 neighbour
#: (the card's __expf and sums differ from the emulation's by ~1e-6, which
#: tips a value lying at a rounding midpoint): one such flip moves o_i by
#: at most 2^-7 (|v_j| + |o_i|) / l_i, l_i the row's softmax normaliser
TILE_ATOL = 2.0 ** -12
P_FLIPS = 2
#: the FMA body's key tile (kBlockK in csrc/attention_common.cuh)
FMA_BLOCK_K = 32
#: the kernels line's mark on K1, K2 and K4, which run the tensor-core tile
REDESIGN = "bf16 mma.sync tile, arkflow_tpu_torch/csrc/mma_tile.cuh"
#: and on K3, which splits each row's context over blocks
PAGED_REDESIGN = ("split-context bf16 mma.sync flash-decoding (64-key splits, combine "
                  "kernel), arkflow_tpu_torch/csrc/paged_attention.cu")
#: the body every case here must run (all have head dims of 64 or 128)
EXPECTED_VARIANT = {torch.bfloat16: "mma", torch.float32: "fma"}
LABEL_MARGIN = 0.05
LOGIT_TOL = 1.0 / 64


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


#: the mask policies of csrc/flash_tile.cuh and csrc/mma_tile.cuh, by value
MASKS = {0: "dense", 1: "ragged", 2: "segment"}


def ptxas_summary(text: str) -> list[dict]:
    """Registers and spill bytes per kernel instantiation, from ``-Xptxas -v``:
    the kernel, dtype, D, the variant (``mma``: bf16 on the tensor cores;
    ``fma``: the f32 FMA body), for the flash tiles the mask policy, and for
    K3's split kernel (``paged_split``, whose partials ``paged_combine``
    merges) and its FMA kernel (``paged_attention``) the query tile."""
    out: list[dict] = []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '\S*?(mma_tile|flash_tile|paged_attention"
                      r"|paged_split|paged_combine)_kernelI(13__nv_bfloat16|f)?((?:Li\d+E)+)", line)
        if m:
            kernel, ints = m.group(1), [int(x) for x in re.findall(r"Li(\d+)E", m.group(3))]
            mma = kernel in ("mma_tile", "paged_split", "paged_combine")
            bf16 = mma or m.group(2) == "13__nv_bfloat16"
            out.append({"kernel": kernel, "dtype": "bf16" if bf16 else "f32", "D": ints[0]})
            if kernel in ("paged_attention", "paged_split"):
                out[-1]["BQ"] = ints[1]
            elif kernel != "paged_combine":
                out[-1]["mask"] = MASKS[ints[1]]
            out[-1]["variant"] = "mma" if mma else "fma"
        elif out and (m := re.search(r"(\d+) bytes spill stores", line)):
            out[-1]["spill_store_bytes"] = int(m.group(1))
        elif out and (m := re.search(r"Used (\d+) registers", line)):
            out[-1]["registers"] = int(m.group(1))
    return out


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, after warmup."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Median device time of one call: ``calls`` calls captured into one CUDA
    graph (after a warmup on a side stream), the graph replayed and timed
    with CUDA events. The host's work for each call (a wrapper's checks, the
    launches) is done once at capture, so it is not in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def call_times(kernel, plain, library, plain_iters: int = 20, plain_calls: int = 20) -> dict:
    """A case's kernel, plain version and library call, each timed two
    ways: ``*_ms``, CUDA events around one eager call (the host's work
    before the launch included: where it exceeds the device's, that is
    what the event times), and ``*_device_ms``, the device's own time
    (``device_ms``)."""
    out = {}
    for name, fn, iters, calls in (("kernel", kernel, 20, 20),
                                   ("plain", plain, plain_iters, plain_calls),
                                   ("library", library, 20, 20)):
        out[f"{name}_ms"] = time_ms(fn, iters=iters)
        out[f"{name}_device_ms"] = device_ms(fn, calls=calls)
    return out


def kernel_line(case: dict) -> dict:
    """A case's numbers as the kernels line gives them: the device times,
    and the eager calls' event times beside them."""
    return {"max_abs_err": case["max_abs_err"], "ms": case["kernel_device_ms"],
            "plain_ms": case["plain_device_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_device_ms"],
            "eager_ms": {k: case[f"{k}_ms"] for k in ("kernel", "plain", "library")},
            "variant": case["variant"], "tile_err_ratio": case["tile_err_ratio"]}


def attention_bound_ms(lengths: torch.Tensor, h: int, s: int, d: int,
                       dtype: torch.dtype, causal: bool) -> tuple[float, str]:
    """Least time for this call's work: q/k/v rows inside the lengths read
    once, the whole output written once; 4*len^2*D flops per (row, head)
    (about half when causal)."""
    lens = lengths.to(torch.float64).cpu()
    size = torch.finfo(dtype).bits // 8
    b = lens.numel()
    nbytes = 3 * float(lens.sum()) * h * d * size + b * h * s * d * size + 4 * b
    flops = float((2 * lens * (lens + 1) if causal else 4 * lens * lens).sum()) * d * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(q, k, v, lengths, causal: bool):
    """The PyTorch library call for the same function (a yardstick only)."""
    s = q.shape[2]
    pos = torch.arange(s, device=q.device)
    mask = (pos[None, :] < lengths[:, None].long())[:, None, None, :]
    if causal:
        mask = mask & (pos[None, :] <= pos[:, None])
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def launched_variant(counter, call) -> tuple[str, torch.Tensor]:
    """Run ``call`` once; return the variant its launch counted, and its
    output. Fails unless exactly one launch was counted."""
    before = dict(counter.variants)
    out = call()
    delta = {k: n - before[k] for k, n in counter.variants.items() if n != before[k]}
    check(len(delta) == 1 and sum(delta.values()) == 1,
          f"expected one counted launch, got {delta}")
    return next(iter(delta)), out


def ragged_masks(lengths, s: int, causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's visibility rule (K4's with every length S): ``allowed`` [B, 1,
    S, S], which keys each query sees, and ``live`` [B, S], the queries
    inside their row's length (the others are written as 0)."""
    lens = torch.as_tensor(lengths)
    pos = torch.arange(s, device=lens.device)
    live = pos[None, :] < lens[:, None]
    allowed = live[:, None, :, None] & live[:, None, None, :]
    if causal:
        allowed = allowed & (pos[None, :] <= pos[:, None])
    return allowed, live


def segment_masks(seg) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's rule: a query sees the keys of its own segment; id 0 is dead."""
    seg = torch.as_tensor(seg).long()
    live = seg > 0
    return ((seg[:, :, None] == seg[:, None, :]) & live[:, :, None])[:, None], live


def emulate_mma_tile(q, k, v, allowed, live, *, block_k=None, round_p=True,
                     dtype=torch.float32, return_norm=False):
    """The tensor-core tile's arithmetic in plain PyTorch, on q's device.
    q/k/v: [B, H, S, D] (bf16 values); allowed: [B, 1, Sq, Sk] bool, which
    keys a query sees; live: [B, Sq] bool, the queries that are not padding
    or dead (their rows are 0). Per key tile of ``block_k`` keys
    (``MMA_BLOCK_K[D]`` by default): S = Q K^T summed in ``dtype`` from bf16
    products, scaled by 1/sqrt(D), masked to -1e30; the online softmax; P
    rounded to bf16 (``round_p``), summed into the normaliser and multiplied
    by V. Returns bf16, and with ``return_norm`` also each row's normaliser
    [B, H, S] (the sum of its P, the largest of which is 1)."""
    qf, kf, vf = (x.to(torch.bfloat16).to(dtype) for x in (q, k, v))
    b, h, s, d = qf.shape
    block_k = block_k or ra.MMA_BLOCK_K[d]
    m = torch.full((b, h, s), -1e30, dtype=dtype, device=qf.device)
    l = torch.zeros(b, h, s, dtype=dtype, device=qf.device)
    o = torch.zeros(b, h, s, d, dtype=dtype, device=qf.device)
    for k0 in range(0, s, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        scores = torch.matmul(qf, kt.transpose(-1, -2)) * (1.0 / math.sqrt(d))
        scores = torch.where(allowed[..., k0:k0 + block_k], scores, -1e30)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        if round_p:
            p = p.to(torch.bfloat16).to(dtype)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.matmul(p, vt)
        m = m_new
    out = o / torch.clamp_min(l[..., None], 1e-30)
    out = torch.where(live[:, None, :, None], out, 0.0).to(torch.bfloat16)
    return (out, l) if return_norm else out


def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at each |x| (2^-7 of its binade)."""
    _, e = torch.frexp(x.float().abs().clamp_min(torch.finfo(torch.float32).tiny))
    return torch.exp2((e - 8).float())


def rounding_limit(ref: torch.Tensor, norm=None, v_max=None) -> torch.Tensor:
    """The per-element limit of a bf16 output against the emulation of its
    body's rounding: one bf16 step of the reference's element and
    ``TILE_ATOL``; with ``norm`` (each row's softmax normaliser, broadcast
    like ``ref`` without its last dim) also room for ``P_FLIPS`` P values
    rounded the other way, each moving the element by at most
    2^-7 (``v_max`` + |ref|) / max(norm, 1)."""
    limit = bf16_step(ref) + TILE_ATOL
    if norm is not None:
        limit = limit + P_FLIPS * 2.0 ** -7 * (v_max + ref.abs()) / norm.float().clamp_min(1.0)[..., None]
    return limit


def tile_err_ratio(out, q, k, v, allowed, live, variant: str) -> float:
    """A bf16 output's largest error over its per-element limit, against a
    reference that rounds as its body does: the tile's P in bf16 over its
    key tiles (``mma``), or only the output (``fma``). The limit is one
    bf16 step of the reference's element, ``TILE_ATOL``, and on the tile
    room for ``P_FLIPS`` P values rounded the other way; at most 1
    passes."""
    d = q.shape[-1]
    mma = variant == "mma"
    ref, norm = emulate_mma_tile(q, k, v, allowed, live, round_p=mma, return_norm=True,
                                 block_k=ra.MMA_BLOCK_K[d] if mma else FMA_BLOCK_K)
    ref = ref.float()
    v_max = v.float().abs().amax(dim=2, keepdim=True)  # [B, H, 1, D]: over every key
    limit = rounding_limit(ref, norm, v_max) if mma else rounding_limit(ref)
    return ((out.float() - ref).abs() / limit).max().item()


def merge_partials(o, m, l):
    """Merges partial softmax results along the last dim of ``m`` and ``l``
    (``o``: one more dim, D) as K3's split kernel and combine do: M = the
    largest m; each part weighted by exp(m - M). A part in which a query
    sees no key (m = -1e30, o a sum of V rows, l its count) gets weight 0
    as long as another part holds a key. Returns (o, M, l) merged."""
    mx = m.amax(dim=-1)
    w = torch.exp(m - mx[..., None])
    return (w[..., None] * o).sum(dim=-2), mx, (w * l).sum(dim=-1)


def emulate_paged_split(q, k_pages, v_pages, page_table, off, *, split_k=None, round_p=True,
                        dtype=torch.float32, return_norm=False):
    """K3's tensor-core body in plain PyTorch, on q's device. q: [B, C, H,
    D]; pools [pages, page, KVH, D]; page_table [B, P]; off [B]. Each row's
    context (P x page keys, padded with masked keys to whole splits) is cut
    into splits of ``split_k`` keys (``PAGED_SPLIT_K`` by default), and each
    split into softmax tiles: ``split_k / 4`` keys (one a warp) when the
    folded queries C x group number at most ``PAGED_DECODE_ROWS`` (the
    decode form), the whole split otherwise (the chunk form). Per tile, for
    folded query f = (chunk position f // group, group member f % group):
    S = Q K^T summed in ``dtype`` from bf16 values, scaled by 1/sqrt(D),
    masked to -1e30 past key off + f // group (clamped to the table); m =
    the tile's row max; P = exp(S - m), rounded to bf16 (``round_p``);
    l = sum P; O = P V. Tiles merge into their split, then splits into the
    row (``merge_partials``); the output is O / max(l, 1e-30). Returns
    [B, C, H, D] in q's dtype, and with ``return_norm`` also each query's merged
    normaliser [B, C, H] (its largest P is 1)."""
    split_k = split_k or ra.PAGED_SPLIT_K
    b, c, h, d = q.shape
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    group, nq = h // kvh, c * h // kvh
    ctx = page_table.shape[1] * page
    splits = -(-ctx // split_k)
    tile = split_k // 4 if nq <= ra.PAGED_DECODE_ROWS else split_k
    dev = q.device
    table = page_table.to(device=dev, dtype=torch.int64)
    pad = splits * split_k - ctx

    def context(pool):  # [B, KVH, splits * split_k, D]
        x = pool[table].reshape(b, ctx, kvh, d).to(torch.bfloat16).to(dtype).transpose(1, 2)
        return torch.nn.functional.pad(x, (0, 0, 0, pad))

    kk, vv = context(k_pages), context(v_pages)
    qf = (q.to(torch.bfloat16).to(dtype).reshape(b, c, kvh, group, d).transpose(1, 2)
          .reshape(b, kvh, nq, d))
    scores = torch.matmul(qf, kk.transpose(-1, -2)) * (1.0 / math.sqrt(d))  # [B, KVH, nq, keys]
    pos = off.to(device=dev, dtype=torch.int64).clamp_min(0)[:, None] + torch.arange(
        nq, device=dev) // group
    keys = torch.arange(splits * split_k, device=dev)
    seen = (keys[None, None, :] <= pos[:, :, None]) & (keys < ctx)  # [B, nq, keys]
    scores = torch.where(seen[:, None], scores, -1e30).reshape(b, kvh, nq, splits, -1, tile)
    m = scores.amax(dim=-1)  # [B, KVH, nq, splits, tiles]
    p = torch.exp(scores - m[..., None])
    if round_p:
        p = p.to(torch.bfloat16).to(dtype)
    o = torch.einsum("bnfstk,bnstkd->bnfstd", p, vv.reshape(b, kvh, splits, -1, tile, d))
    o, m, l = merge_partials(o, m, p.sum(dim=-1))  # tiles into splits
    o, _, l = merge_partials(o, m, l)  # splits into rows
    out = o / torch.clamp_min(l[..., None], 1e-30)
    out = out.reshape(b, kvh, c, group, d).transpose(1, 2).reshape(b, c, h, d).to(q.dtype)
    if not return_norm:
        return out
    return out, l.reshape(b, kvh, c, group).transpose(1, 2).reshape(b, c, h)


def paged_err_ratio(out, q, k_pages, v_pages, page_table, off) -> float:
    """A bf16 K3 output's largest error over its per-element limit
    (``rounding_limit``, with the merged normaliser) against
    ``emulate_paged_split``; at most 1 passes."""
    ref, norm = emulate_paged_split(q, k_pages, v_pages, page_table, off, return_norm=True)
    ref = ref.float()
    b, c, h, d = q.shape
    kvh = k_pages.shape[2]
    vv = v_pages[page_table.to(device=q.device, dtype=torch.int64)].reshape(b, -1, kvh, d)
    v_max = vv.float().abs().amax(dim=1).repeat_interleave(h // kvh, dim=1)[:, None]  # [B, 1, H, D]
    return ((out.float() - ref).abs() / rounding_limit(ref, norm, v_max)).max().item()


def kernel_case(gen, b, h, s, d, dtype, causal, lengths=None) -> dict:
    """K1 against its plain version on [B, S, H, D]-laid-out operands (the
    layout the model hands it), plus the timings."""
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype).transpose(1, 2)
               for _ in range(3))
    if lengths is None:
        lengths = torch.randint(0, s + 1, (b,), device="cuda", generator=gen)
        lengths[:3] = torch.tensor([0, 1, s])
    lengths = lengths.to(device="cuda", dtype=torch.int32)
    variant, out = launched_variant(
        ra.launches, lambda: ra.ragged_flash_attention(q, k, v, lengths, causal=causal))
    ref = ra.ragged_attention_reference(q, k, v, lengths, causal=causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    pad_zero = all(bool((out[i, :, int(n):] == 0).all()) for i, n in enumerate(lengths.tolist()))
    ratio = (tile_err_ratio(out, q, k, v, *ragged_masks(lengths, s, causal), variant)
             if dtype == torch.bfloat16 else None)
    bound, bound_by = attention_bound_ms(lengths, h, s, d, dtype, causal)
    case = {
        "shape": [b, h, s, d], "dtype": str(dtype).replace("torch.", ""), "causal": causal,
        "variant": variant, "max_abs_err": err, "tol": TOL[dtype], "tile_err_ratio": ratio,
        "pad_rows_zero": pad_zero,
        **call_times(lambda: ra.ragged_flash_attention(q, k, v, lengths, causal=causal),
                     lambda: ra.ragged_attention_reference(q, k, v, lengths, causal=causal),
                     sdpa_call(q, k, v, lengths, causal)),
        "bound_ms": bound, "bound_by": bound_by,
    }
    print("K1 case " + json.dumps(case), flush=True)
    check(variant == EXPECTED_VARIANT[dtype], f"K1 ran the wrong variant: {case}")
    check(err <= TOL[dtype], f"K1 disagrees with its plain version: {case}")
    check(ratio is None or ratio <= 1, f"K1 off its rounding emulation: {case}")
    check(pad_zero, f"K1 left pad queries non-zero: {case}")
    return case


#: K4's cases, [B, H, S, D], causal, dtype: the padded BERT-base step with
#: every row full; Llama-3-8B's full-sequence forward (KV heads repeated to
#: 32) at the generate smoke's 16 slots and max_input 512, and at 4096 tokens
#: (llama3_8b().max_seq is 8192); and that last in f32
K4_CASES = (((64, 12, 256, 64), False, torch.bfloat16),
            ((16, 32, 512, 128), True, torch.bfloat16),
            ((1, 32, 4096, 128), True, torch.bfloat16),
            ((1, 32, 4096, 128), True, torch.float32))


def dense_operands(gen, shape, dtype):
    """q, k, v [B, H, S, D] as views of [B, S, H, D] storage, the layout a
    model's projections hand over."""
    b, h, s, d = shape
    return [torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype).transpose(1, 2)
            for _ in range(3)]


def run_dense_path(gen) -> dict:
    """K4's path: its entry point ``arkflow_tpu_torch.ops.flash_attention``,
    called as a user calls it, once at each case's shape, with the counts
    zeroed just before and read just after. No other kernel may launch; a
    sequence that does not divide the tiles raises before any launch."""
    operands = [(dense_operands(gen, shape, dtype), causal) for shape, causal, dtype in K4_CASES]
    reset_counts()
    for (q, k, v), causal in operands:
        flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    report = {"calls": len(operands), "k4_launches": flash_attention.launches.value,
              "k4_variants": dict(flash_attention.launches.variants),
              "k1_launches": ra.launches.value, "k2_launches": sa.launches.value,
              "k3_launches": ra.paged_flash_attention.launches.value}
    ragged = torch.zeros(1, 1, 30, 64, device="cuda", dtype=torch.bfloat16)
    try:
        flash_attention(ragged, ragged, ragged, tile_q=16, tile_k=16)
        report["ragged_tiles_raised"] = False
    except ValueError:
        report["ragged_tiles_raised"] = True
    report["k4_launches_after_ragged"] = flash_attention.launches.value
    print("K4 path " + json.dumps(report), flush=True)
    check(report["k4_launches"] == len(operands), f"K4 did not launch once a call: {report}")
    check(report["k4_variants"] == {
        v: sum(EXPECTED_VARIANT[dtype] == v for _, _, dtype in K4_CASES) for v in ra.VARIANTS},
        f"K4's launches ran the wrong variants: {report}")
    check(report["k1_launches"] == report["k2_launches"] == report["k3_launches"] == 0,
          f"the K4 path launched another kernel: {report}")
    check(report["ragged_tiles_raised"] and report["k4_launches_after_ragged"] == len(operands),
          f"ragged tiles did not raise before a launch: {report}")
    return report


def dense_case(gen, shape, causal: bool, dtype: torch.dtype) -> dict:
    """K4 against its plain version, plus its time, the plain version's,
    the library's (``scaled_dot_product_attention`` with ``is_causal``) and
    the bound (K1's with every length S). K1's count must not move."""
    b, h, s, d = shape
    q, k, v = dense_operands(gen, shape, dtype)
    k1_before = ra.launches.value
    variant, out = launched_variant(flash_attention.launches,
                                    lambda: flash_attention(q, k, v, causal=causal))
    ref = flash_attention_reference(q, k, v, causal=causal)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal)  # noqa: E731
    lib_out = lib()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ratio = (tile_err_ratio(out, q, k, v, *ragged_masks(torch.full((b,), s, device="cuda"), s,
                                                         causal), variant)
             if dtype == torch.bfloat16 else None)
    bound, bound_by = attention_bound_ms(torch.full((b,), s), h, s, d, dtype, causal)
    case = {
        "shape": [b, h, s, d], "dtype": str(dtype).replace("torch.", ""), "causal": causal,
        "variant": variant, "max_abs_err": err, "tol": TOL[dtype], "tile_err_ratio": ratio,
        "library_max_abs_err": (lib_out.float() - ref.float()).abs().max().item(),
        **call_times(lambda: flash_attention(q, k, v, causal=causal),
                     lambda: flash_attention_reference(q, k, v, causal=causal), lib,
                     plain_iters=5, plain_calls=2),
        "bound_ms": bound, "bound_by": bound_by,
        "k1_launches_during": ra.launches.value - k1_before,
    }
    print("K4 case " + json.dumps(case), flush=True)
    check(variant == EXPECTED_VARIANT[dtype], f"K4 ran the wrong variant: {case}")
    check(err <= TOL[dtype], f"K4 disagrees with its plain version: {case}")
    check(ratio is None or ratio <= 1, f"K4 off its rounding emulation: {case}")
    check(case["k1_launches_during"] == 0, f"K1 launched during a K4 case: {case}")
    return case


def edge_cases(gen) -> dict:
    """K1, K2 and K4 against their plain versions where the tiles have
    edges: every head dim of both bodies in bf16 and f32, sequences off the
    64-query and key-tile grid (S = 1, 37, 100, 200), lengths 0, 1, S and
    random, causal on and off, and unsorted, interleaved segment ids with
    dead holes. Each launch must run the variant ``kernel_variant`` names,
    and pad and dead query rows must be exactly 0; bf16 outputs are also
    held per element to the emulation of their body's rounding."""
    rng = np.random.default_rng(7)
    worst: dict[str, float] = {}
    worst_ratio: dict[str, float] = {}
    launches = 0
    for d in ra.KERNEL_HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            want = ra.kernel_variant(dtype, d)
            for s in (1, 37, 100, 200):
                b, h = 4, 2
                q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
                           .transpose(1, 2) for _ in range(3))
                lengths = torch.tensor([0, 1, s, int(rng.integers(0, s + 1))],
                                       device="cuda", dtype=torch.int32).clamp(max=s)
                seg_np = rng.integers(0, 5, (b, s)).astype(np.int32)
                seg_np[0], seg_np[1] = 0, 1
                seg = torch.from_numpy(seg_np).cuda()
                full = torch.full((b,), s, device="cuda")
                calls = []
                for causal in (False, True):
                    calls.append((f"K1 causal={causal}", ra.launches,
                                  lambda c=causal: ra.ragged_flash_attention(q, k, v, lengths, causal=c),
                                  ra.ragged_attention_reference(q, k, v, lengths, causal=causal),
                                  ragged_masks(lengths, s, causal), True))
                    calls.append((f"K4 causal={causal}", flash_attention.launches,
                                  lambda c=causal: flash_attention(q, k, v, causal=c, tile_q=s, tile_k=s),
                                  flash_attention_reference(q, k, v, causal=causal, tile_k=s),
                                  ragged_masks(full, s, causal), False))
                calls.append(("K2", sa.launches, lambda: sa.segment_flash_attention(q, k, v, seg),
                              sa.segment_attention_reference(q, k, v, seg), segment_masks(seg), True))
                for name, counter, call, ref, (allowed, live), has_dead in calls:
                    variant, out = launched_variant(counter, call)
                    launches += 1
                    err = (out.float() - ref.float()).abs().max().item()
                    key = f"{name} D={d} {str(dtype).replace('torch.', '')}"
                    worst[key] = max(worst.get(key, 0.0), err)
                    where = f"{name} at D={d}, S={s}, {dtype}"
                    check(variant == want, f"{where} ran {variant}, not {want}")
                    check(err <= TOL[dtype], f"{where} off its plain version by {err}")
                    if dtype == torch.bfloat16:
                        ratio = tile_err_ratio(out, q, k, v, allowed, live, variant)
                        worst_ratio[key] = max(worst_ratio.get(key, 0.0), ratio)
                        check(ratio <= 1, f"{where} off its rounding emulation ({ratio} of the limit)")
                    if has_dead:
                        check(bool((out.transpose(1, 2)[~live] == 0).all()),
                              f"{where} left pad or dead query rows non-zero")
    report = {"launches": launches, "max_abs_err": worst, "tile_err_ratio": worst_ratio}
    print("edge cases " + json.dumps(report), flush=True)
    return report


def segment_layouts(rng: np.random.Generator, b: int, s: int) -> np.ndarray:
    """[b, s] segment ids: row 0 dead, row 1 one segment spanning S, row 2
    length-1 segments, row 3 interleaved (non-contiguous) ids with dead
    holes, then rows packed by ``pack_tokens`` from random lengths (ids out
    of position order, dead tails); rows past the packed ones stay dead."""
    n = 3 * b
    lengths = np.where(rng.random(n) < 0.7, rng.integers(1, s // 4 + 1, n),
                       rng.integers(s // 2, s + 1, n))
    pk = pack_tokens(np.ones((n, s), np.int32), lengths, s)
    seg = np.zeros((b, s), np.int32)
    rows = min(b - 6, pk.num_rows)
    seg[4:4 + rows] = pk.segment_ids[:rows]
    seg[1] = 1
    seg[2] = np.arange(1, s + 1)
    seg[3] = np.arange(s) % 3 + 1
    seg[3, ::7] = 0
    return seg


def segment_bound_ms(seg: np.ndarray, h: int, d: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for this call's work: live q/k/v rows read once, the whole
    output and the ids written/read once; 4*len^2*D*H flops per segment."""
    size = torch.finfo(dtype).bits // 8
    live = int((seg > 0).sum())
    nbytes = 3 * live * h * d * size + seg.size * h * d * size + seg.size * 4
    sq = 0
    for row in seg:
        _, counts = np.unique(row[row > 0], return_counts=True)
        sq += int((counts.astype(np.int64) ** 2).sum())
    flops = 4.0 * sq * d * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def segment_case(gen, seg_np: np.ndarray, h: int, d: int, dtype: torch.dtype,
                 label: str) -> dict:
    """K2 against its plain version on [B, S, H, D]-laid-out operands, plus
    the timings; the library yardstick is ``scaled_dot_product_attention``
    with the block-diagonal boolean mask, compared on live rows only."""
    b, s = seg_np.shape
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype).transpose(1, 2)
               for _ in range(3))
    seg = torch.from_numpy(seg_np).to("cuda")
    variant, out = launched_variant(sa.launches, lambda: sa.segment_flash_attention(q, k, v, seg))
    ref = sa.segment_attention_reference(q, k, v, seg)
    live = (seg > 0)[:, None, :, None].expand_as(out)
    pair = ((seg[:, :, None] == seg[:, None, :]) & (seg > 0)[:, :, None])[:, None]
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=pair)  # noqa: E731
    lib_out = lib()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    dead_zero = bool((out[~live] == 0).all())
    lib_err = (lib_out.float() - ref.float())[live].abs().max().item()
    ratio = (tile_err_ratio(out, q, k, v, *segment_masks(seg), variant)
             if dtype == torch.bfloat16 else None)
    bound, bound_by = segment_bound_ms(seg_np, h, d, dtype)
    case = {
        "case": label, "shape": [b, h, s, d], "dtype": str(dtype).replace("torch.", ""),
        "variant": variant, "live_tokens": int((seg_np > 0).sum()), "max_abs_err": err, "tol": TOL[dtype],
        "tile_err_ratio": ratio,
        "dead_rows_zero": dead_zero, "library_live_max_abs_err": lib_err,
        **call_times(lambda: sa.segment_flash_attention(q, k, v, seg),
                     lambda: sa.segment_attention_reference(q, k, v, seg), lib),
        "bound_ms": bound, "bound_by": bound_by,
    }
    print("K2 case " + json.dumps(case), flush=True)
    check(variant == EXPECTED_VARIANT[dtype], f"K2 ran the wrong variant: {case}")
    check(err <= TOL[dtype], f"K2 disagrees with its plain version: {case}")
    check(ratio is None or ratio <= 1, f"K2 off its rounding emulation: {case}")
    check(dead_zero, f"K2 left dead queries non-zero: {case}")
    return case


def slice_lengths(cfg: dict, n: int) -> torch.Tensor:
    """True token lengths of one batch of the slice's stream: the generate
    input rotates its payload mix across the batch's rows."""
    inp = cfg["streams"][0]["input"]
    proc = cfg["streams"][0]["pipeline"]["processors"][0]
    payloads = [str(p).encode() for p in inp["payloads"]]
    _, mask = HashTokenizer().encode_batch(
        [payloads[i % len(payloads)] for i in range(n)], proc["max_seq"])
    return torch.from_numpy(mask.sum(axis=1))


def compare_paths(runner: ModelRunner, proc_cfg: dict, rows: int, seed: int) -> dict:
    """The stream's runner (kernel path) against the same weights on the
    plain attention, on ``rows`` distinct texts of mixed lengths."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(5000)]
    texts = [" ".join(rng.choice(vocab, size=int(n))).encode()
             for n in rng.integers(1, proc_cfg["max_seq"] - 2, size=rows)]
    ids, mask = HashTokenizer(runner.cfg.vocab_size).encode_batch(texts, proc_cfg["max_seq"])
    plain = ModelRunner(
        proc_cfg["model"], {**proc_cfg["model_config"], "use_flash_attention": False},
        buckets=runner.buckets, seed=proc_cfg["seed"], device="cuda",
        serving_dtype=proc_cfg["serving_dtype"])
    a = runner.infer_sync({"input_ids": ids, "attention_mask": mask})
    b = plain.infer_sync({"input_ids": ids, "attention_mask": mask})
    la, lb = a["logits"], b["logits"]
    check(la.shape == (rows, 2) and np.isfinite(la).all(), f"kernel-path logits {la.shape} not finite")
    check(np.isfinite(lb).all(), "plain-path logits not finite")
    top2 = np.sort(lb, axis=1)
    tie_free = (top2[:, -1] - top2[:, -2]) > LABEL_MARGIN
    label_mismatch = int((a["label"][tie_free] != b["label"][tie_free]).sum())
    logit_err = float(np.abs(la - lb).max())
    report = {"rows": rows, "tie_free_rows": int(tie_free.sum()),
              "label_mismatches_tie_free": label_mismatch,
              "label_mismatches_all": int((a["label"] != b["label"]).sum()),
              "max_logit_abs_err": logit_err, "logit_tol": LOGIT_TOL,
              "scores_in_range": bool(((a["score"] >= 0.5) & (a["score"] <= 1.0)).all())}
    print("paths " + json.dumps(report), flush=True)
    check(label_mismatch == 0, f"kernel path changed tie-free labels: {report}")
    check(logit_err <= LOGIT_TOL, f"kernel-path logits off: {report}")
    check(report["scores_in_range"], f"scores out of range: {report}")
    # whole-model step time at the slice's shape, kernel vs plain attention
    one = {"input_ids": ids[:64], "attention_mask": mask[:64]}
    step_ms = {}
    for name, r in (("kernel", runner), ("plain", plain), ("kernel_again", runner)):
        step_ms[name] = time_ms(lambda: r.infer_sync(one), iters=10, warmup=2)
    print("step_ms " + json.dumps({"rows": 64, "seq_bucket": runner.buckets.seq_bucket(
        int(mask[:64].sum(1).max())), **step_ms}), flush=True)
    return report


def reset_counts() -> None:
    """Zero every kernel's launch count: counts read after a path's run then
    belong to that run alone."""
    ra.launches.reset()
    sa.launches.reset()
    ra.paged_flash_attention.launches.reset()
    flash_attention.launches.reset()
    q8.int8_products.reset()


def run_slice(cfg_raw: dict) -> dict:
    cfg = EngineConfig.from_mapping(cfg_raw)
    engine = Engine(cfg)
    reset_counts()
    t0 = time.perf_counter()
    asyncio.run(engine.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ra.launches.value
    k2_launches = sa.launches.value
    k1_variants = dict(ra.launches.variants)
    stream = engine.streams[0]
    runner = stream.pipeline.processors[0].runner
    count = cfg_raw["streams"][0]["input"]["count"]
    layers = runner.cfg.layers
    report = {"rows_expected": count, "rows_out": stream.rows_out,
              "rows_dropped": stream.output.dropped_rows, "errors": stream.errors,
              "seconds": wall, "rows_per_s": stream.rows_out / wall,
              "traffic_seconds": stream.traffic_seconds,
              "traffic_rows_per_s": stream.rows_out / stream.traffic_seconds,
              "device_steps": runner.device_steps, "layers": layers,
              "k1_launches": launches, "k1_variants": k1_variants, "k2_launches": k2_launches,
              "flash_fallbacks": runner.flash_fallbacks,
              "hidden": runner.cfg.hidden, "heads": runner.cfg.heads}
    print("slice " + json.dumps(report), flush=True)
    check(k2_launches == 0, f"the padded stream launched K2: {report}")
    check(stream.errors == 0, f"stream reported errors: {report}")
    check(stream.rows_out == count and stream.output.dropped_rows == count,
          f"not every row arrived: {report}")
    check(launches > 0 and launches == layers * runner.device_steps,
          f"K1 launches != layers x device steps: {report}")
    check(runner.flash_fallbacks == 0, f"the runner fell back from the kernel: {report}")
    check(k1_variants["mma"] == launches, f"a bf16 K1 launch missed the mma tile: {report}")
    return {"report": report, "runner": runner}


class OrderedSink(Output):
    """Wraps the stream's own output: records every payload it is handed,
    in order, then passes the batch on."""

    def __init__(self, inner: Output):
        self.inner = inner
        self.payloads: list[bytes] = []

    async def connect(self) -> None:
        await self.inner.connect()

    async def write(self, batch: MessageBatch) -> None:
        self.payloads.extend(batch.to_binary())
        await self.inner.write(batch)

    async def close(self) -> None:
        await self.inner.close()


def generated_rows(cfg_raw: dict) -> list[bytes]:
    """The rows the slice's generate input produces, in order: each batch
    rotates the payload mix from its first row."""
    inp = cfg_raw["streams"][0]["input"]
    payloads = [str(p).encode() for p in inp["payloads"]]
    rows, left = [], inp["count"]
    while left > 0:
        n = min(inp["batch_size"], left)
        rows += [payloads[i % len(payloads)] for i in range(n)]
        left -= n
    return rows


def run_packed_slice(cfg_raw: dict) -> dict:
    """The packed stream through ``Engine``, its sink wrapped to check order;
    the launch counts are zeroed just before the run and read just after."""
    engine = Engine(EngineConfig.from_mapping(cfg_raw))
    stream = engine.build()[0]
    sink = stream.output = OrderedSink(stream.output)
    reset_counts()
    t0 = time.perf_counter()
    asyncio.run(engine.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = ra.launches.value, sa.launches.value
    k2_variants = dict(sa.launches.variants)
    runner = stream.pipeline.processors[0].runner
    expected = generated_rows(cfg_raw)
    count = len(expected)
    layers = runner.cfg.layers
    b = runner.buckets
    warmup_steps = len(b.seq_buckets) * sum(
        1 for eb in b.example_buckets() for pb in b.batch_buckets if pb <= eb)
    report = {"rows_expected": count, "rows_out": stream.rows_out,
              "rows_dropped": sink.inner.dropped_rows, "errors": stream.errors,
              "in_order": sink.payloads == expected,
              "seconds": wall, "rows_per_s": stream.rows_out / wall,
              "traffic_seconds": stream.traffic_seconds,
              "traffic_rows_per_s": stream.rows_out / stream.traffic_seconds,
              "device_steps": runner.device_steps, "packed_steps": runner.packed_steps,
              "traffic_packed_steps": runner.packed_steps - warmup_steps,
              "packed_token_fill": runner.packed_tokens / max(1, runner.packed_slots),
              "packed_tokens": runner.packed_tokens, "packed_slots": runner.packed_slots,
              "packed_flash": runner.cfg.packed_flash, "layers": layers,
              "k1_launches": k1, "k2_launches": k2, "k2_variants": k2_variants}
    print("packed slice " + json.dumps(report), flush=True)
    check(stream.errors == 0, f"packed stream reported errors: {report}")
    check(stream.rows_out == count and sink.inner.dropped_rows == count,
          f"not every row arrived: {report}")
    check(report["in_order"], f"rows arrived out of order: {report}")
    check(k2 > 0 and k2 == layers * runner.packed_steps,
          f"K2 launches != layers x packed steps: {report}")
    check(k1 == 0, f"the packed stream launched K1: {report}")
    check(k2_variants["mma"] == k2, f"a bf16 K2 launch missed the mma tile: {report}")
    return {"report": report, "runner": runner}


def stream_layout(cfg_raw: dict, buckets) -> list[tuple[dict, np.ndarray]]:
    """The packed windows of the stream's first emission, made as the stream
    makes them: the generate batches through the token-budget coalescer,
    then tokenize, pack and carve."""
    proc = cfg_raw["streams"][0]["pipeline"]["processors"][0]
    texts = first_emission(cfg_raw["streams"][0])
    ids, mask = HashTokenizer().encode_batch(texts, proc["max_seq"])
    return pack_windows(ids, mask, buckets)


def compare_packed_paths(packed: ModelRunner, padded: ModelRunner, proc_cfg: dict,
                         rows: int, seed: int) -> dict:
    """The same ``rows`` distinct texts of mixed lengths through the packed
    K2 path (the packed stream's runner), the packed pair-mask path (same
    weights, ``packed_flash: false``) and the padded K1 path (the padded
    stream's runner, same seed): labels equal on tie-free rows, logits
    within 1/64; and the time each path takes to serve them."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(5000)]
    texts = [" ".join(rng.choice(vocab, size=int(n))).encode()
             for n in rng.integers(1, proc_cfg["max_seq"] - 2, size=rows)]
    ids, mask = HashTokenizer(packed.cfg.vocab_size).encode_batch(texts, proc_cfg["max_seq"])
    windows = pack_windows(ids, mask, packed.buckets)
    pair = ModelRunner(
        proc_cfg["model"], {**proc_cfg["model_config"], "packed_flash": False},
        buckets=packed.buckets, seed=proc_cfg["seed"], device="cuda",
        serving_dtype=proc_cfg["serving_dtype"], packed=True)
    check(packed.cfg.packed_flash is True and pair.cfg.packed_flash is False,
          "the packed runners did not resolve packed_flash as asked")

    def serve_packed(r):
        return lambda: scatter_windows(windows, [r.infer_sync(w) for w, _ in windows], rows)

    def serve_padded():
        return padded.infer_sync({"input_ids": ids, "attention_mask": mask})

    paths = {"packed_k2": serve_packed(packed), "packed_pair_mask": serve_packed(pair),
             "padded_k1": serve_padded}
    outs = {name: fn() for name, fn in paths.items()}
    got = outs["packed_k2"]
    check(got["logits"].shape == (rows, 2) and np.isfinite(got["logits"]).all(),
          "packed-path logits not finite")
    report = {"rows": rows, "packed_windows": [int(w["input_ids"].shape[0]) for w, _ in windows]}
    for other in ("packed_pair_mask", "padded_k1"):
        ref = outs[other]
        top2 = np.sort(ref["logits"], axis=1)
        tie_free = (top2[:, -1] - top2[:, -2]) > LABEL_MARGIN
        report[other] = {
            "tie_free_rows": int(tie_free.sum()),
            "label_mismatches_tie_free": int((got["label"][tie_free] != ref["label"][tie_free]).sum()),
            "label_mismatches_all": int((got["label"] != ref["label"]).sum()),
            "max_logit_abs_err": float(np.abs(got["logits"] - ref["logits"]).max())}
    report["logit_tol"] = LOGIT_TOL
    print("packed paths " + json.dumps(report), flush=True)
    for other in ("packed_pair_mask", "padded_k1"):
        check(report[other]["label_mismatches_tie_free"] == 0,
              f"packed K2 path changed tie-free labels against {other}: {report}")
        check(report[other]["max_logit_abs_err"] <= LOGIT_TOL,
              f"packed K2 path logits off against {other}: {report}")
    # the three paths on the same texts, in turns (K2, pair, K1, K1, pair, K2)
    times = {name: [] for name in paths}
    for name in (*paths, *reversed(list(paths))):
        times[name].append(time_ms(paths[name], iters=5, warmup=1))
    steps = {"packed_k2": len(windows), "packed_pair_mask": len(windows),
             "padded_k1": -(-rows // padded.buckets.max_batch())}
    print("packed paths step_ms " + json.dumps({
        name: {"ms_per_call": statistics.median(t), "runs": t, "device_steps": steps[name],
               "ms_per_step": statistics.median(t) / steps[name]}
        for name, t in times.items()}), flush=True)
    return report


def run_int8_slice(cfg_raw: dict) -> dict:
    """The int8 stream (or the same config at another serving dtype) through
    ``Engine``, its sink wrapped to check order; the counts are zeroed just
    before the run and read just after. Every step runs K1 once a layer, and
    at int8 every dense layer runs an int8 product and none a float one: six
    a layer, then the pooler and the classifier."""
    proc = cfg_raw["streams"][0]["pipeline"]["processors"][0]
    engine = Engine(EngineConfig.from_mapping(cfg_raw))
    stream = engine.build()[0]
    sink = stream.output = OrderedSink(stream.output)
    reset_counts()
    t0 = time.perf_counter()
    asyncio.run(engine.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2, products = ra.launches.value, sa.launches.value, q8.int8_products.value
    k1_variants = dict(ra.launches.variants)
    runner = stream.pipeline.processors[0].runner
    expected = generated_rows(cfg_raw)
    layers = runner.cfg.layers
    per_step = 6 * layers + 2 if proc["serving_dtype"] == "int8" else 0
    report = {"serving_dtype": proc["serving_dtype"], "rows_expected": len(expected),
              "rows_out": stream.rows_out, "rows_dropped": sink.inner.dropped_rows,
              "errors": stream.errors, "in_order": sink.payloads == expected,
              "seconds": wall, "traffic_seconds": stream.traffic_seconds,
              "traffic_rows_per_s": stream.rows_out / stream.traffic_seconds,
              "device_steps": runner.device_steps, "layers": layers, "hidden": runner.cfg.hidden,
              "k1_launches": k1, "k1_variants": k1_variants, "k2_launches": k2,
              "int8_products": products,
              "int8_products_per_step": per_step, "flash_fallbacks": runner.flash_fallbacks}
    print("int8 slice " + json.dumps(report), flush=True)
    check(stream.errors == 0, f"int8-config stream reported errors: {report}")
    check(stream.rows_out == len(expected) and sink.inner.dropped_rows == len(expected),
          f"not every row arrived: {report}")
    check(report["in_order"], f"rows arrived out of order: {report}")
    check(k1 > 0 and k1 == layers * runner.device_steps and k2 == 0,
          f"K1 launches != layers x device steps: {report}")
    check(products == per_step * runner.device_steps,
          f"int8 products != dense layers x device steps: {report}")
    check(k1_variants["mma"] == k1, f"a bf16 K1 launch missed the mma tile: {report}")
    if per_step:
        w_q = runner.params["layers"]["ffn_in"]["w_q"][0]
        check(w_q.is_cuda and w_q.stride(0) == 1,
              f"the int8 weights lost their column-major layout on the card: {w_q.stride()}")
    return {"report": report, "runner": runner}


def compare_int8(int8: ModelRunner, bf16: ModelRunner, proc_cfg: dict, rows: int,
                 seed: int) -> dict:
    """The same ``rows`` texts of mixed lengths through the int8 stream's
    runner and the bf16 one (same seed, so the same float weights before
    quantization): labels equal on every row whose bf16 top-2 gap exceeds
    twice the largest |logit difference|; then both runners' step times at
    the two batch buckets, in turns."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(5000)]
    texts = [" ".join(rng.choice(vocab, size=int(n))).encode()
             for n in rng.integers(1, proc_cfg["max_seq"] - 2, size=rows)]
    ids, mask = HashTokenizer(int8.cfg.vocab_size).encode_batch(texts, proc_cfg["max_seq"])
    a = int8.infer_sync({"input_ids": ids, "attention_mask": mask})
    b = bf16.infer_sync({"input_ids": ids, "attention_mask": mask})
    check(np.isfinite(a["logits"]).all() and a["logits"].shape == (rows, 2),
          "int8 logits not finite")
    delta = float(np.abs(a["logits"] - b["logits"]).max())
    top2 = np.sort(b["logits"], axis=1)
    clear = (top2[:, -1] - top2[:, -2]) > 2 * delta
    report = {"rows": rows, "max_logit_abs_delta": delta,
              "max_abs_logit": float(np.abs(b["logits"]).max()),
              "rows_gap_above_2x_delta": int(clear.sum()),
              "rows_gap_at_or_below_2x_delta": int((~clear).sum()),
              "label_mismatches_above_gap": int((a["label"][clear] != b["label"][clear]).sum()),
              "label_mismatches_all": int((a["label"] != b["label"]).sum())}
    print("int8 vs bf16 " + json.dumps(report), flush=True)
    check(report["label_mismatches_above_gap"] == 0,
          f"int8 changed a label whose bf16 gap exceeds twice the logit delta: {report}")
    steps = {}
    for n in (256, 32):
        one = {"input_ids": ids[:n], "attention_mask": mask[:n]}
        seq = int8.buckets.seq_bucket(int(mask[:n].sum(1).max()))
        times = {"int8": [], "bf16": []}
        for name in ("int8", "bf16", "bf16", "int8"):
            r = int8 if name == "int8" else bf16
            times[name].append(time_ms(lambda: r.infer_sync(one), iters=10, warmup=2))
        steps[f"{n}x{seq}"] = {k: statistics.median(v) for k, v in times.items()}
        steps[f"{n}x{seq}"]["runs"] = times
    print("int8 step_ms " + json.dumps(steps), flush=True)
    return report


def product_times(gen) -> dict:
    """``torch._int_mm``'s limits on the card (it refuses rows <= 16 and K
    or N off a multiple of 8), ``int8_matmul`` exact on and off them, then
    the int8 product and the whole W8A8 dense against the bf16 ones at
    BERT-base's FFN shape, [16384, 768] x [768, 3072], each beside its
    bound."""
    refused = {}
    for m, k, n in ((16, 768, 768), (32, 768, 2), (32, 12, 16)):
        try:
            torch._int_mm(torch.ones(m, k, device="cuda", dtype=torch.int8),
                          torch.ones(k, n, device="cuda", dtype=torch.int8))
            refused[f"{m}x{k}x{n}"] = False
        except RuntimeError:
            refused[f"{m}x{k}x{n}"] = True
    exact = {}
    for m, k, n in ((4, 768, 2), (32, 768, 2), (256, 768, 768), (17, 13, 5)):
        a = torch.randint(-127, 128, (m, k), device="cuda", dtype=torch.int8, generator=gen)
        w = torch.randint(-127, 128, (k, n), device="cuda", dtype=torch.int8, generator=gen)
        got = q8.int8_matmul(a, w).cpu()
        exact[f"{m}x{k}x{n}"] = bool(torch.equal(got.long(), a.cpu().long() @ w.cpu().long()))
    m, k, n = 16384, 768, 3072
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
    p_bf16 = {"w": w.to(torch.bfloat16), "b": torch.zeros(n, device="cuda", dtype=torch.bfloat16)}
    p_int8 = q8.quantize_dense({"w": w, "b": p_bf16["b"]})
    x_q = torch.randint(-127, 128, (m, k), device="cuda", dtype=torch.int8, generator=gen)
    flops = 2.0 * m * k * n

    def bound(nbytes: float, peak: float) -> tuple[float, str]:
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    i8_bound, i8_by = bound(m * k + k * n + 4 * m * n, INT8_PEAK_OPS)
    bf_bound, bf_by = bound(2 * (m * k + k * n + m * n), PEAK_FLOPS[torch.bfloat16])
    w_rows = p_int8["w_q"].contiguous()  # the same weight, row-major
    report = {
        "int_mm_refuses": refused, "exact": exact, "shape": [m, k, n],
        "w_q_strides": list(p_int8["w_q"].stride()),
        "int8_product_ms": time_ms(lambda: q8.int8_matmul(x_q, p_int8["w_q"])),
        "int8_product_row_major_w_ms": time_ms(lambda: q8.int8_matmul(x_q, w_rows)),
        "int8_product_bound_ms": i8_bound, "int8_product_bound_by": i8_by,
        "bf16_product_ms": time_ms(lambda: x @ p_bf16["w"]),
        "bf16_product_bound_ms": bf_bound, "bf16_product_bound_by": bf_by,
        "int8_dense_ms": time_ms(lambda: dense(p_int8, x)),
        "bf16_dense_ms": time_ms(lambda: dense(p_bf16, x)),
    }
    print("int8 product " + json.dumps(report), flush=True)
    check(all(exact.values()), f"the int8 product is not exact on the card: {report}")
    return report


def paged_bound_ms(off: torch.Tensor, c: int, h: int, kvh: int, d: int, page: int,
                   p: int) -> tuple[float, str]:
    """Least time for one K3 call: the live K/V pages (every page a row's
    last query reaches, clamped to the table) read once, q read and out
    written once, the table and offsets read; 4*D flops per (query, head,
    admissible key)."""
    offs = off.to(torch.int64).cpu()
    b, ctx = offs.numel(), p * page
    keys = (offs + c).clamp(max=ctx)
    pages = -(-keys // page)
    nbytes = (2 * float(pages.sum()) * page * kvh * d * 2 + 2 * b * c * h * d * 2
              + b * p * 4 + b * 4)
    attended = (offs[:, None] + torch.arange(1, c + 1)[None, :]).clamp(max=ctx)
    flops = 4.0 * float(attended.sum()) * d * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_library_call(q, kp, vp, table, off):
    """The PyTorch library yardstick for K3 (timed as one): gather each
    row's context through its table, then ``scaled_dot_product_attention``
    with ``enable_gqa`` and the offset mask."""
    b, c, h, d = q.shape
    kvh, ctx = kp.shape[2], table.shape[1] * kp.shape[1]

    def call():
        t = table.long()
        k = kp[t].reshape(b, ctx, kvh, d).transpose(1, 2).to(q.dtype)
        v = vp[t].reshape(b, ctx, kvh, d).transpose(1, 2).to(q.dtype)
        pos = off.long()[:, None] + torch.arange(c, device=q.device)
        mask = (torch.arange(ctx, device=q.device)[None, None, :] <= pos[:, :, None])[:, None]
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k, v, attn_mask=mask, enable_gqa=True).transpose(1, 2)

    return call


def paged_case(gen, b: int, c: int, offs: list[int], label: str, h: int = 32, kvh: int = 8,
               d: int = 128, page: int = 16, p: int = 40, poison: bool = False,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """K3 against its plain version on shuffled, non-contiguous page tables
    (bf16 pools; q bf16, the serving type, or f32 for the FMA body). Table
    entries past a row's bound are the scratch page 0 on even rows and stale
    pool pages on odd rows. The launch must run ``EXPECTED_VARIANT``'s body,
    and a bf16 output is held per element to ``emulate_paged_split``. With
    ``poison`` the kernel also runs on pools in which every slot no row may
    read, and the scratch page, hold large finite values: its output must
    not change by a bit."""
    npages = 1 + b * p
    q = torch.randn(b, c, h, d, device="cuda", generator=gen).to(dtype)
    kp, vp = (torch.randn(npages, page, kvh, d, device="cuda", generator=gen).to(torch.bfloat16)
              for _ in range(2))
    table = (torch.randperm(npages - 1, device="cuda", generator=gen) + 1).reshape(b, p)
    off = torch.tensor(offs, device="cuda", dtype=torch.int32)
    last = ((off.long() + c - 1) // page).clamp(max=p - 1)
    past = torch.arange(p, device="cuda")[None, :] > last[:, None]
    even = (torch.arange(b, device="cuda") % 2 == 0)[:, None]
    table = torch.where(past & even, 0, table).to(torch.int32).contiguous()
    call = lambda: ra.paged_flash_attention(q, kp, vp, table, off)  # noqa: E731
    variant, out = launched_variant(ra.paged_flash_attention.launches, call)
    ref = ra.paged_attention_reference(q, kp, vp, table, off)
    lib = paged_library_call(q, kp, vp, table, off)
    lib_out = lib()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ratio = paged_err_ratio(out, q, kp, vp, table, off) if dtype == torch.bfloat16 else None
    case = {"case": label, "B": b, "C": c, "H": h, "kv_heads": kvh, "D": d, "page": page,
            "P": p, "off": offs, "dtype": str(dtype).replace("torch.", ""), "variant": variant,
            "max_abs_err": err, "tol": TOL[dtype], "tile_err_ratio": ratio,
            "library_max_abs_err": (lib_out.float() - ref.float()).abs().max().item()}
    if poison:
        keys = (off.long() + c).clamp(max=p * page)
        pos = torch.arange(p * page, device="cuda")
        valid = pos[None, :] < keys[:, None]
        live = torch.zeros(npages, page, dtype=torch.bool, device="cuda")
        live[table.long()[:, pos // page][valid], (pos % page).expand(b, -1)[valid]] = True
        live[0] = False
        kp2, vp2 = kp.clone(), vp.clone()
        kp2[~live], vp2[~live] = 3.0e4, -3.0e4
        again = ra.paged_flash_attention(q, kp2, vp2, table, off)
        torch.cuda.synchronize()
        case["poisoned_slots"] = int((~live).sum()) * kvh
        case["poisoned_equal"] = bool(torch.equal(again, out))
    else:
        bound, bound_by = paged_bound_ms(off, c, h, kvh, d, page, p)
        case.update({
            **call_times(call, lambda: ra.paged_attention_reference(q, kp, vp, table, off), lib),
            "library": "gather + sdpa(enable_gqa, offset mask)",
            "bound_ms": bound, "bound_by": bound_by})
    print("K3 case " + json.dumps(case), flush=True)
    check(variant == EXPECTED_VARIANT[dtype], f"K3 ran the wrong variant: {case}")
    check(err <= TOL[dtype], f"K3 disagrees with its plain version: {case}")
    check(ratio is None or ratio <= 1, f"K3 off its rounding emulation: {case}")
    check(case.get("poisoned_equal", True), f"K3 read past a row's bound: {case}")
    return case


def paged_edge_cases(gen) -> dict:
    """K3 against its plain version where its splits and folds have edges:
    both head dims in bf16 (the split kernel) and f32 (the FMA body), GQA
    groups of 1 to 8, decode and chunk folds on both sides of 16 folded
    queries, pages of 16 and of 12 (pages that straddle a split), contexts
    from 1 key to past the table (padded chunk queries), on shuffled tables.
    Each launch must run the variant ``paged_variant`` names; bf16 outputs
    are also held per element to ``emulate_paged_split``."""
    rng = np.random.default_rng(8)
    worst: dict[str, float] = {}
    worst_ratio: dict[str, float] = {}
    launches = 0
    for d in ra.PAGED_HEAD_DIMS:
        for c, h, kvh in ((1, 4, 4), (1, 32, 8), (3, 8, 2), (5, 16, 2), (40, 8, 2)):
            for page in (16, 12):
                b, p = 3, 7
                npages = 1 + b * p
                ctx = p * page
                kp, vp = (torch.randn(npages, page, kvh, d, device="cuda", generator=gen)
                          .to(torch.bfloat16) for _ in range(2))
                table = (torch.randperm(npages - 1, device="cuda", generator=gen) + 1)
                table = table.reshape(b, p).to(torch.int32).contiguous()
                off = torch.tensor([0, int(rng.integers(0, ctx)), ctx - 1 - c // 2],
                                   device="cuda", dtype=torch.int32)
                for dtype in (torch.bfloat16, torch.float32):
                    q = torch.randn(b, c, h, d, device="cuda", generator=gen).to(dtype)
                    want = ra.paged_variant(dtype, d)
                    variant, out = launched_variant(
                        ra.paged_flash_attention.launches,
                        lambda: ra.paged_flash_attention(q, kp, vp, table, off))
                    launches += 1
                    ref = ra.paged_attention_reference(q, kp, vp, table, off)
                    err = (out.float() - ref.float()).abs().max().item()
                    key = f"D={d} {str(dtype).replace('torch.', '')}"
                    worst[key] = max(worst.get(key, 0.0), err)
                    where = f"K3 at D={d}, C={c}, H={h}, KVH={kvh}, page={page}, {dtype}"
                    check(variant == want, f"{where} ran {variant}, not {want}")
                    check(err <= TOL[dtype], f"{where} off its plain version by {err}")
                    if dtype == torch.bfloat16:
                        ratio = paged_err_ratio(out, q, kp, vp, table, off)
                        worst_ratio[key] = max(worst_ratio.get(key, 0.0), ratio)
                        check(ratio <= 1, f"{where} off its rounding emulation ({ratio} of the limit)")
    report = {"launches": launches, "max_abs_err": worst, "tile_err_ratio": worst_ratio}
    print("K3 edge cases " + json.dumps(report), flush=True)
    return report


class GeneratedSink(OrderedSink):
    """Also records the generated column of every batch, in order."""

    def __init__(self, inner: Output, field: str):
        super().__init__(inner)
        self.field = field
        self.generated: list[bytes] = []

    async def write(self, batch: MessageBatch) -> None:
        self.generated.extend(batch.column(self.field).to_pylist())
        await super().write(batch)


def run_generate_slice(cfg_raw: dict) -> dict:
    """The generate stream through ``Engine``. The server's init-time parity
    gate runs at build and its K3 launches are read apart; the counts are
    zeroed just before the traffic and read just after."""
    proc_cfg = cfg_raw["streams"][0]["pipeline"]["processors"][0]
    engine = Engine(EngineConfig.from_mapping(cfg_raw))
    reset_counts()
    t0 = time.perf_counter()
    stream = engine.build()[0]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gate_launches = ra.paged_flash_attention.launches.value
    server = stream.pipeline.processors[0].server
    sink = stream.output = GeneratedSink(stream.output, proc_cfg["output_field"])
    reset_counts()
    t0 = time.perf_counter()
    asyncio.run(engine.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3, k1, k2 = ra.paged_flash_attention.launches.value, ra.launches.value, sa.launches.value
    k3_variants = dict(ra.paged_flash_attention.launches.variants)
    expected = generated_rows(cfg_raw)
    counts = [len(g.split()) for g in sink.generated]
    layers = server.cfg.layers
    traffic = stream.traffic_seconds
    report = {
        "rows_expected": len(expected), "rows_out": stream.rows_out,
        "rows_dropped": sink.inner.dropped_rows, "errors": stream.errors,
        "in_order": sink.payloads == expected, "generated_rows": len(counts),
        "max_tokens_per_row": max(counts, default=0), "max_new_tokens": proc_cfg["max_new_tokens"],
        "tokens": server.tokens, "build_seconds": build_s, "seconds": wall,
        "traffic_seconds": traffic, "traffic_tokens_per_s": server.tokens / traffic,
        "traffic_rows_per_s": stream.rows_out / traffic,
        "ttft_p50_ms": server.ttft_ms(0.5), "ttft_p99_ms": server.ttft_ms(0.99),
        "decode_steps": server.decode_steps, "chunk_steps": server.chunk_steps,
        "prefill_steps": server.prefill_steps,
        "pipelined_dispatches": server.pipelined_dispatches,
        "traffic_ms_per_decode_step": traffic * 1e3 / max(1, server.decode_steps),
        "truncations": server.truncations, "decode_kernel": server.decode_kernel,
        "free_pages": len(server._free_pages), "num_pages": server.num_pages,
        "layers": layers, "dim": server.cfg.dim, "vocab": server.cfg.vocab_size,
        "k3_launches": k3, "k3_variants": k3_variants, "k3_gate_launches": gate_launches,
        "parity_gate": server.parity_report,
        "k1_launches": k1, "k2_launches": k2}
    print("generate slice " + json.dumps(report), flush=True)
    check(stream.errors == 0, f"generate stream reported errors: {report}")
    check(stream.rows_out == len(expected) and sink.inner.dropped_rows == len(expected)
          and len(counts) == len(expected), f"not every row arrived: {report}")
    check(report["in_order"], f"rows arrived out of order: {report}")
    check(report["max_tokens_per_row"] <= proc_cfg["max_new_tokens"],
          f"a row got more than max_new_tokens: {report}")
    check(server.decode_kernel == "paged", f"the server did not take the paged kernel: {report}")
    check(server.decode_steps > 0 and server.chunk_steps > 0,
          f"the stream ran no decode or no chunk step: {report}")
    check(k3 == layers * (server.decode_steps + server.chunk_steps),
          f"K3 launches != layers x (decode + chunk steps): {report}")
    check(k3_variants["mma"] == k3, f"a bf16 K3 launch missed the tensor-core body: {report}")
    check(gate_launches > 0, f"the parity gate launched no K3: {report}")
    check(k1 == 0 and k2 == 0, f"the generate stream launched K1 or K2: {report}")
    check(report["free_pages"] == server.num_pages - 1, f"pages leaked: {report}")
    return {"report": report, "server": server}


def step_times(server: GenerationServer) -> dict:
    """One lockstep decode step over every slot (ragged contexts of up to
    the server's max_seq) and one 128-token chunk at offset 256, each
    dispatched and fetched as the server does it: median ms."""
    s, p, page = server.slots, server.pages_per_slot, server.page_size
    table = (torch.randperm(server.num_pages - 1, generator=torch.Generator().manual_seed(3))
             + 1)[: s * p].reshape(s, p).numpy().astype(np.int32)
    lens = np.linspace(1, server.max_seq - 2, s).astype(np.int32)
    act = np.ones(s, bool)
    cur = torch.randint(3, server.cfg.vocab_size, (s,), generator=torch.Generator().manual_seed(7),
                        dtype=torch.int32).to(server.device)
    chunk = server.prefill_chunk or 128
    ids = np.random.default_rng(4).integers(3, server.cfg.vocab_size, (1, chunk)).astype(np.int32)

    def decode():
        with torch.inference_mode():
            return server._decode(cur, lens, act, table).wait()

    def chunk_step():
        with torch.inference_mode():
            return server._chunk(ids, 256, chunk, table[:1], True).wait()

    out = {"decode_step_ms": time_ms(decode, iters=10, warmup=2),
           "decode_slots": s, "decode_mean_context": float(lens.mean() + 1),
           "chunk_step_ms": time_ms(chunk_step, iters=5, warmup=1), "chunk": chunk,
           "chunk_offset": 256}
    print("generate step_ms " + json.dumps(out), flush=True)
    return out


def generate_prompts(cfg_raw: dict, n: int) -> list[list[int]]:
    """The first ``n`` rows of the generate stream, tokenized as the
    processor tokenizes them."""
    proc = cfg_raw["streams"][0]["pipeline"]["processors"][0]
    tok = HashTokenizer(proc["model_config"]["vocab_size"])
    ids, mask = tok.encode_batch(generated_rows(cfg_raw)[:n], proc["max_input"])
    return [ids[i, : int(mask[i].sum())].tolist() for i in range(n)]


def serve_prompts(server: GenerationServer, prompts: list[list[int]], max_new: int):
    async def go():
        outs = await asyncio.gather(*[server.generate(p, max_new_tokens=max_new,
                                                      with_margins=True) for p in prompts])
        await server.close()
        return outs

    outs = asyncio.run(go())
    check(len(server._free_pages) == server.num_pages - 1, "a paths server leaked pages")
    return outs


def compare_generation_paths(params, cfg, proc_cfg: dict, prompts: list[list[int]],
                             max_new: int) -> dict:
    """The same prompts through a paged and a gather server at depth 1 and a
    paged server at depth 2 (same weights, the stream's slots, pages and
    chunking): the paged streams equal the gather streams up to each
    request's first step whose gather top-2 gap is below the tie margin,
    and depth 2 equals depth 1 bit for bit. Then one decode step over the
    prompts' prefilled pools with the gather path, with K3, and with K3's
    plain version in K3's place. Two correct attention paths that round
    differently (the gather path rounds scores to bf16; K3 and its plain
    version sum in f32 in different orders) move logits of magnitude ~3,
    where one bf16 step is 1/64, by ~2 steps over 32 bf16 layers, so 1/64
    holds only per kernel call (the K3 cases). Here K3's logits must lie
    no further from either yardstick than the two yardsticks lie from each
    other, plus 1/64."""
    def server(kernel: str, depth: int) -> GenerationServer:
        return GenerationServer(
            params, cfg, slots=proc_cfg["slots"], page_size=proc_cfg["page_size"],
            max_seq=proc_cfg["max_input"] + proc_cfg["max_new_tokens"],
            eos_id=proc_cfg.get("eos_id", 2), prefill_chunk=proc_cfg["prefill_chunk"],
            decode_kernel=kernel, dispatch_depth=depth, record_margins=True)

    runs, seconds = {}, {}
    for name, kernel, depth in (("paged_d1", "paged", 1), ("gather_d1", "gather", 1),
                                ("paged_d2", "paged", 2)):
        srv = server(kernel, depth)
        t0 = time.perf_counter()
        runs[name] = serve_prompts(srv, prompts, max_new)
        seconds[name] = time.perf_counter() - t0
        del srv
        torch.cuda.empty_cache()
    compared, tied_rows, mismatched = 0, 0, []
    for i, ((pt, _), (gt, gm)) in enumerate(zip(runs["paged_d1"], runs["gather_d1"])):
        tie = next((j for j, m in enumerate(gm) if m <= LABEL_MARGIN), None)
        k = len(gt) if tie is None else tie
        tied_rows += tie is not None
        compared += k
        if pt[:k] != gt[:k] or (tie is None and pt != gt):
            mismatched.append(i)
    depth_equal = [t for t, _ in runs["paged_d2"]] == [t for t, _ in runs["paged_d1"]]

    b, page = len(prompts), proc_cfg["page_size"]
    p = -(-(proc_cfg["max_input"] + proc_cfg["max_new_tokens"]) // page)
    device = params["embed"]["table"].device
    kp, vp = init_page_pool(cfg, 1 + b * p, page, device)
    table = (torch.randperm(b * p, generator=torch.Generator().manual_seed(5)) + 1).reshape(b, p)
    lens = np.asarray([len(x) for x in prompts], np.int32)
    ids = np.zeros((b, int(lens.max())), np.int32)
    for i, x in enumerate(prompts):
        ids[i, : len(x)] = x
    dev = {"ids": torch.from_numpy(ids).to(device), "lens": torch.from_numpy(lens).to(device),
           "table": table.to(device=device, dtype=torch.int32)}
    with torch.inference_mode():
        nxt, _, _ = paged_prefill(params, cfg, dev["ids"], dev["lens"], dev["table"], kp, vp)
        act = torch.ones(b, dtype=torch.bool, device=device)

        def step(kernel: str) -> torch.Tensor:  # rewrites the same K/V each time
            return paged_decode_step(params, cfg, nxt, dev["lens"], act, dev["table"], kp, vp,
                                     return_logits=True, attention_kernel=kernel)[0]

        logits = {"gather": step("gather"), "paged": step("paged")}
        pd.paged_flash_attention = ra.paged_attention_reference
        try:
            logits["paged_plain"] = step("paged")
        finally:
            pd.paged_flash_attention = ra.paged_flash_attention

    def err(a: str, b: str) -> float:
        return (logits[a] - logits[b]).abs().max().item()

    logit_err = {"paged_vs_plain": err("paged", "paged_plain"),
                 "paged_vs_gather": err("paged", "gather"),
                 "plain_vs_gather": err("paged_plain", "gather"),
                 "max_abs_logit": logits["gather"].abs().max().item()}
    del kp, vp, logits
    torch.cuda.empty_cache()
    report = {"prompts": b, "max_new_tokens": max_new,
              "tokens": {n: sum(len(t) for t, _ in r) for n, r in runs.items()},
              "tie_free_steps_compared": compared, "rows_with_a_near_tie": tied_rows,
              "tie_margin": LABEL_MARGIN, "rows_mismatched_before_a_tie": mismatched,
              "depth2_equals_depth1": depth_equal, "first_step_max_logit_abs_err": logit_err,
              "logit_tol": LOGIT_TOL, "seconds": seconds}
    print("generate paths " + json.dumps(report), flush=True)
    check(not mismatched, f"paged and gather streams differ before a near-tie: {report}")
    check(depth_equal, f"depth 2 changed the paged streams: {report}")
    floor = logit_err["plain_vs_gather"] + LOGIT_TOL
    check(logit_err["paged_vs_plain"] <= floor and logit_err["paged_vs_gather"] <= floor,
          f"first decode step logits: K3 further from a yardstick than the yardsticks "
          f"are from each other: {report}")
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch: {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)

    built = build_all(list(KERNEL_SOURCES), verbose=True)
    print("build " + json.dumps({k: round(v["seconds"], 3) for k, v in built.items()}), flush=True)
    for name, rep in built.items():
        print(f"ptxas {name} " + json.dumps(ptxas_summary(rep["output"])), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    edge_cases(gen)
    for s in (128, 256, 512):
        for dtype in (torch.bfloat16, torch.float32):
            kernel_case(gen, 64, 12, s, 64, dtype, causal=False)
    kernel_case(gen, 64, 12, 256, 64, torch.bfloat16, causal=True)
    rng = np.random.default_rng(0)
    for s in (128, 256, 512):
        seg = segment_layouts(rng, 64, s)
        for dtype in (torch.bfloat16, torch.float32):
            segment_case(gen, seg, 12, 64, dtype, f"layouts S={s}")
    # head dim 128: the tensor-core tile in dynamic shared memory
    segment_case(gen, segment_layouts(rng, 32, 256), 8, 128, torch.bfloat16,
                 "layouts S=256, D=128")

    k4_path = run_dense_path(gen)
    k4_cases = [dense_case(gen, shape, causal, dtype) for shape, causal, dtype in K4_CASES]
    # K1 with every length S at K4's BERT shape: the same function
    kernel_case(gen, 64, 12, 256, 64, torch.bfloat16, causal=False,
                lengths=torch.full((64,), 256))

    with open(CONFIG) as f:
        cfg_raw = json.load(f)
    proc_cfg = cfg_raw["streams"][0]["pipeline"]["processors"][0]
    batch = cfg_raw["streams"][0]["input"]["batch_size"]
    result = run_slice(cfg_raw)
    runner = result["runner"]
    main_len = slice_lengths(cfg_raw, batch)
    main_seq = runner.buckets.seq_bucket(int(main_len.max()))
    main_case = kernel_case(gen, batch, runner.cfg.heads, main_seq,
                            runner.cfg.hidden // runner.cfg.heads, torch.bfloat16,
                            causal=False, lengths=main_len)
    compare_paths(runner, proc_cfg, rows=256, seed=1)

    with open(PACKED_CONFIG) as f:
        packed_raw = json.load(f)
    packed_proc = packed_raw["streams"][0]["pipeline"]["processors"][0]
    packed = run_packed_slice(packed_raw)
    prunner = packed["runner"]
    dh = prunner.cfg.hidden // prunner.cfg.heads
    k2_cases = []
    for w, _ in stream_layout(packed_raw, prunner.buckets):  # one emission's windows
        rows = w["input_ids"].shape[0]
        seg = np.zeros((prunner.buckets.batch_bucket(rows), w["segment_ids"].shape[1]), np.int32)
        seg[:rows] = w["segment_ids"]
        k2_cases.append(segment_case(gen, seg, prunner.cfg.heads, dh, torch.bfloat16,
                                     f"stream window {rows} rows"))
    k2_main = k2_cases[0]  # the largest window
    compare_packed_paths(prunner, runner, packed_proc, rows=320, seed=2)
    del runner, prunner, result["runner"], packed["runner"]
    torch.cuda.empty_cache()

    with open(INT8_CONFIG) as f:
        int8_raw = json.load(f)
    int8_proc = int8_raw["streams"][0]["pipeline"]["processors"][0]
    bf16_raw = json.loads(json.dumps(int8_raw))
    bf16_raw["streams"][0]["pipeline"]["processors"][0]["serving_dtype"] = "bfloat16"
    int8_run, bf16_run = run_int8_slice(int8_raw), run_int8_slice(bf16_raw)
    print("int8 traffic rows/s " + json.dumps({
        "int8": int8_run["report"]["traffic_rows_per_s"],
        "bfloat16": bf16_run["report"]["traffic_rows_per_s"]}), flush=True)
    compare_int8(int8_run["runner"], bf16_run["runner"], int8_proc, rows=320, seed=3)
    product_times(gen)
    del int8_run["runner"], bf16_run["runner"]
    torch.cuda.empty_cache()

    # K3 at the generate stream's shapes: decode over 16 slots with contexts
    # ragged over 1..639, then 128-token chunks
    offs = [int(x) for x in torch.randint(0, 639, (16,), generator=torch.Generator().manual_seed(6))]
    offs[:3] = [0, 638, 15]
    paged_edge_cases(gen)
    k3_main = paged_case(gen, 16, 1, offs, "decode")
    paged_case(gen, 16, 1, offs, "decode, poisoned past the bound", poison=True)
    paged_case(gen, 16, 1, offs, "decode, f32 q", dtype=torch.float32)
    k3_chunks = {o: paged_case(gen, 1, 128, [o], f"chunk at {o}") for o in (0, 128, 256, 384)}
    paged_case(gen, 4, 128, [0, 128, 256, 384], "chunk, 4 rows")
    paged_case(gen, 4, 128, [0, 128, 256, 384], "chunk, 4 rows, poisoned past the bound",
               poison=True)

    with open(GENERATE_CONFIG) as f:
        gen_raw = json.load(f)
    gen_proc = gen_raw["streams"][0]["pipeline"]["processors"][0]
    generated = run_generate_slice(gen_raw)
    server = generated["server"]
    step_times(server)
    compare_generation_paths(server.params, server.cfg, gen_proc,
                             generate_prompts(gen_raw, gen_proc["slots"]), max_new=64)

    kernels = [{
        "name": "ragged_flash_attention", "route": "cuda",
        "source": "arkflow_tpu_torch/csrc/ragged_attention.cu",
        "replaces": "arkflow_tpu/ops/ragged_attention.py:95",
        "launches": result["report"]["k1_launches"], "ok": True,
        **kernel_line(main_case), "redesigned": REDESIGN,
    }, {
        "name": "segment_flash_attention", "route": "cuda",
        "source": "arkflow_tpu_torch/csrc/segment_attention.cu",
        "replaces": "arkflow_tpu/ops/segment_attention.py:52",
        "launches": packed["report"]["k2_launches"], "ok": True,
        **kernel_line(k2_main), "redesigned": REDESIGN,
    }, {
        "name": "paged_flash_attention", "route": "cuda",
        "source": "arkflow_tpu_torch/csrc/paged_attention.cu",
        "replaces": "arkflow_tpu/ops/ragged_attention.py:193",
        "launches": generated["report"]["k3_launches"], "ok": True,
        **kernel_line(k3_main), "redesigned": PAGED_REDESIGN,
        "chunks": {o: {k: k3_chunks[o][k] for k in ("kernel_device_ms", "library_device_ms",
                                                     "bound_ms", "tile_err_ratio")}
                   for o in (256, 384)},
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "arkflow_tpu_torch/csrc/flash_attention.cu",
        "replaces": "arkflow_tpu/ops/flash_attention.py:70",
        "launches": k4_path["k4_launches"], "ok": True,
        **kernel_line(k4_cases[0]), "redesigned": REDESIGN,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
