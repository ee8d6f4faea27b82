"""Paged KV-cache decode for the decoder LM.

Counterpart of ``arkflow_tpu/models/paged_decode.py`` on one device. KV
lives in a pool of fixed-size pages -- ``[layers, num_pages, page, kv_heads,
dh]`` bfloat16 -- and each serving slot owns an int32 page table. Pages are
allocated and freed by the host-side scheduler (``tpu/serving.py``) between
steps; device code only reads and writes through gathers and scatters.

Page 0 is a reserved scratch page: inactive slots and masked prompt padding
write there, which keeps the scatter free of conditionals.

The pools are updated IN PLACE (``index_put_`` into the layer's pool
slice): the JAX functions return new pools that the serving layer donates,
and these return the same pool tensors they were given, so callers keep the
JAX return signature. Every step's writes are ordered by the one CUDA
stream the steps are issued on.

``attention_kernel``: ``"gather"`` (materialize each row's context through
its page table and run the masked dense attention: the plain path) or
``"paged"`` (``ops/ragged_attention.paged_flash_attention``, which reads the
page table in place: the CUDA kernel on CUDA tensors, its plain version on
CPU tensors). ``kv_sharding`` (tensor-parallel pools) is not ported.

Where the port departs from the JAX code without changing the function:
the final norm and the LM head run on the rows whose logits are returned
(the last true position of each row) instead of on every position, since
both are row-wise.

MoE (``num_experts > 1``): the MLP of every path is ``decoder._mlp`` with
JAX's token mask -- the prefill's and the chunk's valid positions and the
decode step's active lanes -- so padding and idle lanes take no expert
capacity. Each call's capacity comes from its own [B, S].
"""

from __future__ import annotations

from typing import Optional

import torch

from arkflow_tpu_torch.errors import not_ported
from arkflow_tpu_torch.models import common as cm
from arkflow_tpu_torch.models.decoder import (
    DecoderConfig,
    _mlp,
    apply_rope,
    head,
    last_rows,
    layer_params,
    num_layers,
    rope_angles,
)
from arkflow_tpu_torch.ops.ragged_attention import paged_flash_attention

ATTENTION_KERNELS = ("gather", "paged")


def init_page_pool(cfg: DecoderConfig, num_pages: int, page_size: int,
                   device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """KV page pools: [layers, num_pages, page, kv_heads, dh] bfloat16 zeros."""
    dh = cfg.dim // cfg.heads
    shape = (cfg.layers, num_pages, page_size, cfg.kv_heads, dh)
    return (torch.zeros(shape, dtype=torch.bfloat16, device=device),
            torch.zeros(shape, dtype=torch.bfloat16, device=device))


def _check(kv_sharding, attention_kernel: str) -> None:
    if kv_sharding is not None:
        raise not_ported("paged decode with kv_sharding (tensor-parallel pools)")
    if attention_kernel not in ATTENTION_KERNELS:
        raise ValueError(f"attention_kernel must be gather|paged, got {attention_kernel!r}")


def _attend_paged(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                  page_table: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Page-table-indirect attention over one layer's pool slices: query i
    of row b sits at absolute position ``off[b] + i`` and attends keys
    0..off+i, read straight from the pools."""
    return paged_flash_attention(q, kp, vp, page_table, off)


def _attend_gather(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                   page_table: torch.Tensor, mask: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """The plain path: each row's context gathered from the pool through its
    page table ([B, P*page, kv_heads, dh]), repeated over the GQA group, and
    attended under ``mask``."""
    b, ctx = page_table.shape[0], page_table.shape[1] * kp.shape[1]
    group = cfg.heads // cfg.kv_heads
    table = page_table.long()
    kk = kp[table].reshape(b, ctx, cfg.kv_heads, -1).to(q.dtype).repeat_interleave(group, dim=2)
    vv = vp[table].reshape(b, ctx, cfg.kv_heads, -1).to(q.dtype).repeat_interleave(group, dim=2)
    return cm.attention(q, kk, vv, mask)


def paged_prefill(params: dict, cfg: DecoderConfig, input_ids: torch.Tensor,
                  lengths: torch.Tensor, page_table: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, return_logits: bool = False, kv_sharding=None):
    """Prefill prompts and scatter their K/V into pages.

    input_ids: [B, T] right-padded; lengths: [B]; page_table: [B, P].
    Returns (next_ids [B] int32 -- or the last true position's logits
    [B, vocab] with ``return_logits`` -- , k_pages, v_pages); the pools are
    written in place for every position < lengths (padding scatters to the
    scratch page 0). Attention is the dense causal attention over the
    prompt's own keys, as in the JAX function."""
    _check(kv_sharding, "gather")
    b, t = input_ids.shape
    dev = input_ids.device
    page = k_pages.shape[2]
    dh = cfg.dim // cfg.heads
    group = cfg.heads // cfg.kv_heads
    lengths = lengths.to(dev)
    positions = torch.arange(t, device=dev)[None, :].expand(b, t)
    rope = rope_angles(positions, dh, cfg.rope_theta)
    pos_valid = positions < lengths[:, None]
    causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()[None, None]
    mask = causal & pos_valid[:, None, None, :]
    logical = (positions // page).clamp(max=page_table.shape[1] - 1)
    page_idx = torch.where(pos_valid, page_table.long().gather(1, logical), 0)
    offset = torch.where(pos_valid, positions % page, 0)
    x = cm.embedding(params["embed"], input_ids)
    for i in range(num_layers(params)):
        lp = layer_params(params["layers"], i)
        y = cm.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
        q = apply_rope(cm.dense(lp["wq"], y).reshape(b, t, cfg.heads, dh), *rope)
        k = apply_rope(cm.dense(lp["wk"], y).reshape(b, t, cfg.kv_heads, dh), *rope)
        v = cm.dense(lp["wv"], y).reshape(b, t, cfg.kv_heads, dh)
        k_pages[i].index_put_((page_idx, offset), k.to(torch.bfloat16))
        v_pages[i].index_put_((page_idx, offset), v.to(torch.bfloat16))
        attn = cm.attention(q, k.repeat_interleave(group, dim=2),
                            v.repeat_interleave(group, dim=2), mask)
        x = x + cm.dense(lp["wo"], attn.reshape(b, t, cfg.heads * dh))
        x = x + _mlp(lp, cm.rms_norm(lp["mlp_norm"], x, cfg.norm_eps), cfg,
                     token_mask=pos_valid)
    logits = head(params, cfg, last_rows(x, lengths))
    if return_logits:
        return logits, k_pages, v_pages
    return torch.argmax(logits, dim=-1).to(torch.int32), k_pages, v_pages


def paged_prefill_chunk(params: dict, cfg: DecoderConfig, input_ids: torch.Tensor,
                        chunk_off: torch.Tensor, chunk_len: torch.Tensor,
                        page_table: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                        return_all: bool = False, kv_sharding=None,
                        attention_kernel: str = "gather"):
    """Prefill ONE CHUNK of a prompt at absolute offset ``chunk_off``.

    input_ids: [B, C] right-padded chunk; chunk_off: [B] absolute start
    position; chunk_len: [B] true tokens in this chunk; page_table: [B, P]
    must already map every page the chunk writes (and all earlier ones).
    Earlier chunks' K/V are read back from the pool, so attention is exact
    over positions 0..off+i for query i; padded queries keep that causal
    bound too, so their output stays finite (never read, and taken out of
    MoE routing by ``pos_valid``).

    Returns (logits at the chunk's last true position [B, vocab] -- or, with
    ``return_all``, at every chunk position [B, C, vocab] -- , k_pages,
    v_pages), the pools written in place."""
    _check(kv_sharding, attention_kernel)
    b, t = input_ids.shape
    dev = input_ids.device
    p_slots = page_table.shape[1]
    page = k_pages.shape[2]
    ctx = p_slots * page
    dh = cfg.dim // cfg.heads
    chunk_off = chunk_off.to(dev)
    positions = chunk_off.long()[:, None] + torch.arange(t, device=dev)[None, :]
    rope = rope_angles(positions, dh, cfg.rope_theta)
    pos_valid = torch.arange(t, device=dev)[None, :] < chunk_len.to(dev)[:, None]
    logical = (positions // page).clamp(max=p_slots - 1)
    page_idx = torch.where(pos_valid, page_table.long().gather(1, logical), 0)
    offset = torch.where(pos_valid, positions % page, 0)
    mask = None
    if attention_kernel == "gather":
        key_pos = torch.arange(ctx, device=dev)[None, None, None, :]
        mask = key_pos <= positions[:, None, :, None]  # [B, 1, C, ctx]
    x = cm.embedding(params["embed"], input_ids)
    for i in range(num_layers(params)):
        lp = layer_params(params["layers"], i)
        kp, vp = k_pages[i], v_pages[i]
        y = cm.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
        q = apply_rope(cm.dense(lp["wq"], y).reshape(b, t, cfg.heads, dh), *rope)
        k = apply_rope(cm.dense(lp["wk"], y).reshape(b, t, cfg.kv_heads, dh), *rope)
        v = cm.dense(lp["wv"], y).reshape(b, t, cfg.kv_heads, dh)
        kp.index_put_((page_idx, offset), k.to(torch.bfloat16))
        vp.index_put_((page_idx, offset), v.to(torch.bfloat16))
        if attention_kernel == "paged":
            attn = _attend_paged(q, kp, vp, page_table, chunk_off)
        else:
            attn = _attend_gather(q, kp, vp, page_table, mask, cfg)
        x = x + cm.dense(lp["wo"], attn.reshape(b, t, cfg.heads * dh))
        x = x + _mlp(lp, cm.rms_norm(lp["mlp_norm"], x, cfg.norm_eps), cfg,
                     token_mask=pos_valid)
    if return_all:
        return head(params, cfg, x), k_pages, v_pages
    return head(params, cfg, last_rows(x, chunk_len.to(dev))), k_pages, v_pages


def paged_decode_step(params: dict, cfg: DecoderConfig, token_ids: torch.Tensor,
                      lengths: torch.Tensor, active: torch.Tensor, page_table: torch.Tensor,
                      k_pages: torch.Tensor, v_pages: torch.Tensor,
                      return_logits: bool = False, kv_sharding=None,
                      attention_kernel: str = "gather"):
    """One decode step over all serving slots.

    token_ids: [S] current token per slot; lengths: [S] tokens already in
    the cache (the new token writes at position lengths[s]); active: [S]
    bool; page_table: [S, P]. Returns (next_ids [S] int32 -- or logits
    [S, vocab] with ``return_logits`` -- , k_pages, v_pages), the pools
    written in place. Inactive lanes write to the scratch page.

    ``"gather"`` masks keys past lengths + 1 in the gathered context;
    ``"paged"`` expresses the same mask as the kernel's causal bound with
    the query at position lengths[s]."""
    _check(kv_sharding, attention_kernel)
    s = token_ids.shape[0]
    dev = token_ids.device
    p_slots = page_table.shape[1]
    page = k_pages.shape[2]
    ctx = p_slots * page
    dh = cfg.dim // cfg.heads
    lengths = lengths.to(dev)
    positions = lengths.long()[:, None]  # [S, 1]
    rope = rope_angles(positions, dh, cfg.rope_theta)
    write_logical = (positions // page).clamp(max=p_slots - 1)
    write_page = torch.where(active, page_table.long().gather(1, write_logical)[:, 0], 0)
    write_off = torch.where(active, positions[:, 0] % page, 0)
    valid: Optional[torch.Tensor] = None
    if attention_kernel == "gather":
        key_pos = torch.arange(ctx, device=dev)[None, :]
        valid = (key_pos <= positions)[:, None, None, :]  # [S, 1, 1, ctx]
    x = cm.embedding(params["embed"], token_ids[:, None])  # [S, 1, D]
    for i in range(num_layers(params)):
        lp = layer_params(params["layers"], i)
        kp, vp = k_pages[i], v_pages[i]
        y = cm.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
        q = apply_rope(cm.dense(lp["wq"], y).reshape(s, 1, cfg.heads, dh), *rope)
        k = apply_rope(cm.dense(lp["wk"], y).reshape(s, 1, cfg.kv_heads, dh), *rope)
        v = cm.dense(lp["wv"], y).reshape(s, 1, cfg.kv_heads, dh)
        kp.index_put_((write_page, write_off), k[:, 0].to(torch.bfloat16))
        vp.index_put_((write_page, write_off), v[:, 0].to(torch.bfloat16))
        if attention_kernel == "paged":
            attn = _attend_paged(q, kp, vp, page_table, lengths)
        else:
            attn = _attend_gather(q, kp, vp, page_table, valid, cfg)
        x = x + cm.dense(lp["wo"], attn.reshape(s, 1, cfg.heads * dh))
        # inactive lanes take no expert capacity (MoE)
        x = x + _mlp(lp, cm.rms_norm(lp["mlp_norm"], x, cfg.norm_eps), cfg,
                     token_mask=active[:, None])
    logits = head(params, cfg, x[:, -1, :])
    if return_logits:
        return logits, k_pages, v_pages
    return torch.argmax(logits, dim=-1).to(torch.int32), k_pages, v_pages
