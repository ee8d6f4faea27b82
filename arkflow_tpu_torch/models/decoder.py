"""Decoder-only LM (Llama-style): GQA + RoPE + RMSNorm + SwiGLU.

Counterpart of ``arkflow_tpu/models/decoder.py`` on one device: ``init``,
``_rope``, ``_mlp`` (dense SwiGLU), ``_attention_block``, ``forward`` /
``apply`` and greedy ``select_token``. Params keep the JAX tree's layout --
the same nested paths, dense ``w`` stored ``[in, out]``, per-layer params
stacked on a leading axis -- and the layer scan is a Python loop over that
axis. Defaults are a small test shape; ``llama3_8b()`` gives the
production shape. The incremental paths over the paged KV cache are in
``models/paged_decode.py``.

Not ported yet (each raises "not yet ported"): MoE (``num_experts > 1``),
ring attention, ``remat`` (a training knob), sampling (``temperature > 0``,
``top_k``), and the contiguous-cache ``prefill`` / ``decode_step`` /
``generate``. ``loss_fn``, ``make_train_step``, ``param_specs`` and
``pp_stage_fns`` wait for the training and multi-device slices.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch

from arkflow_tpu_torch.errors import ConfigError, not_ported
from arkflow_tpu_torch.models import common as cm
from arkflow_tpu_torch.models.registry import ModelFamily, register_model


@dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 2048
    dim: int = 256
    layers: int = 4
    heads: int = 8
    kv_heads: int = 4
    ffn: int = 688
    max_seq: int = 2048
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    use_ring_attention: bool = False
    num_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    remat: bool = False


def llama3_8b() -> DecoderConfig:
    return DecoderConfig(
        vocab_size=128256, dim=4096, layers=32, heads=32, kv_heads=8,
        ffn=14336, max_seq=8192,
    )


def make_config(**overrides) -> DecoderConfig:
    known = {f.name for f in dataclasses.fields(DecoderConfig)}
    unknown = sorted(set(overrides) - known)
    if unknown:
        raise ConfigError(f"decoder_lm: unknown model_config keys {unknown}")
    cfg = DecoderConfig(**overrides)
    if cfg.num_experts > 1:
        raise not_ported("decoder_lm model_config.num_experts > 1 (MoE)")
    if cfg.use_ring_attention:
        raise not_ported("decoder_lm model_config.use_ring_attention")
    if cfg.remat:
        raise not_ported("decoder_lm model_config.remat (a training knob)")
    if cfg.heads % cfg.kv_heads or cfg.dim % cfg.heads:
        raise ConfigError(f"decoder_lm: heads {cfg.heads} must divide dim {cfg.dim} and "
                          f"be a multiple of kv_heads {cfg.kv_heads}")
    return cfg


def init(gen: torch.Generator, cfg: DecoderConfig, *, device=None,
         dtype: torch.dtype = torch.bfloat16) -> dict:
    """Params drawn from ``gen`` on ``device`` (the generator's own device
    by default): the JAX ``init``'s shapes and distributions (the numbers
    differ: another generator). Dense and embedding weights are held in
    ``dtype`` -- bfloat16 by default, bit for bit the cast the forward does
    at every call -- and norm scales in float32. Each tensor is drawn in
    float32 and cast, one layer at a time, so the float32 draw of the whole
    tree (32 GB at Llama-3-8B) never exists."""
    device = torch.device(device) if device is not None else gen.device
    if cfg.num_experts > 1:
        raise not_ported("decoder_lm init with num_experts > 1 (MoE)")
    dh = cfg.dim // cfg.heads

    def dense(in_dim: int, out_dim: int) -> dict:
        scale = 1.0 / math.sqrt(in_dim)
        w = torch.empty(in_dim, out_dim, device=device).uniform_(-scale, scale, generator=gen)
        return {"w": w.to(dtype)}

    table = torch.randn(cfg.vocab_size, cfg.dim, device=device, generator=gen) * 0.02
    params = {
        "embed": {"table": table.to(dtype)},
        "norm_out": cm.rms_norm_init(cfg.dim, device),
        "lm_head": dense(cfg.dim, cfg.vocab_size),
    }
    del table
    shapes = {"wq": (cfg.dim, cfg.heads * dh), "wk": (cfg.dim, cfg.kv_heads * dh),
              "wv": (cfg.dim, cfg.kv_heads * dh), "wo": (cfg.heads * dh, cfg.dim),
              "w_gate": (cfg.dim, cfg.ffn), "w_up": (cfg.dim, cfg.ffn),
              "w_down": (cfg.ffn, cfg.dim)}
    layers = {name: {"w": torch.empty(cfg.layers, *shape, device=device, dtype=dtype)}
              for name, shape in shapes.items()}
    for i in range(cfg.layers):
        for name, (in_dim, out_dim) in shapes.items():
            layers[name]["w"][i] = dense(in_dim, out_dim)["w"]
    layers["attn_norm"] = {"scale": torch.ones(cfg.layers, cfg.dim, device=device)}
    layers["mlp_norm"] = {"scale": torch.ones(cfg.layers, cfg.dim, device=device)}
    params["layers"] = layers
    return params


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i``'s params out of the stacked tree (views, no copies)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


def num_layers(params: dict) -> int:
    """The stack's depth, read off any leaf (an int8 tree has ``w_q`` where a
    float tree has ``w``)."""
    node = params["layers"]
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node.shape[0]


def rope_angles(positions: torch.Tensor, dh: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the rotary angles, [B, S, 1, dh/2] float32, computed as
    the JAX ``_rope`` computes them (``theta ** (arange / dh)`` in float32)."""
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                          device=positions.device) / dh))
    angles = positions[..., None].float() * freqs  # [B, S, dh/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: [B, S, H, Dh]; positions: [B, S]. The layer
    loops compute ``rope_angles`` once per step and call ``apply_rope``."""
    return apply_rope(x, *rope_angles(positions, x.shape[-1], theta))


def _mlp(lp: dict, y: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """Dense SwiGLU (the MoE branch is not ported)."""
    gate = torch.nn.functional.silu(cm.dense(lp["w_gate"], y).float()).to(y.dtype)
    return cm.dense(lp["w_down"], gate * cm.dense(lp["w_up"], y))


def _attention_block(lp: dict, x: torch.Tensor, cfg: DecoderConfig,
                     rope: tuple[torch.Tensor, torch.Tensor],
                     causal: Optional[torch.Tensor]) -> torch.Tensor:
    """Pre-norm GQA attention block (rope, kv-head repeat, residual)."""
    b, s = x.shape[0], x.shape[1]
    dh = cfg.dim // cfg.heads
    group = cfg.heads // cfg.kv_heads
    y = cm.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
    q = apply_rope(cm.dense(lp["wq"], y).reshape(b, s, cfg.heads, dh), *rope)
    k = apply_rope(cm.dense(lp["wk"], y).reshape(b, s, cfg.kv_heads, dh), *rope)
    v = cm.dense(lp["wv"], y).reshape(b, s, cfg.kv_heads, dh)
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    attn = cm.attention(q, k, v, causal)
    return x + cm.dense(lp["wo"], attn.reshape(b, s, cfg.heads * dh))


def forward(params: dict, cfg: DecoderConfig, input_ids: torch.Tensor) -> torch.Tensor:
    """[B, S] ids -> [B, S, vocab] float32 logits (causal), on one device."""
    b, s = input_ids.shape
    dev = input_ids.device
    x = cm.embedding(params["embed"], input_ids)
    positions = torch.arange(s, device=dev)[None, :].expand(b, s)
    rope = rope_angles(positions, cfg.dim // cfg.heads, cfg.rope_theta)
    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()[None, None]
    for i in range(num_layers(params)):
        lp = layer_params(params["layers"], i)
        x = _attention_block(lp, x, cfg, rope, causal)
        x = x + _mlp(lp, cm.rms_norm(lp["mlp_norm"], x, cfg.norm_eps), cfg)
    x = cm.rms_norm(params["norm_out"], x, cfg.norm_eps)
    return cm.dense(params["lm_head"], x).float()


def apply(params: dict, cfg: DecoderConfig, *, input_ids: torch.Tensor) -> dict:
    logits = forward(params, cfg, input_ids)
    return {"logits": logits, "next_token": select_token(logits[:, -1, :])}


def select_token(logits: torch.Tensor, temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """Greedy: [B, V] float32 logits -> [B] int32 ids. Sampling is not
    ported yet."""
    if temperature > 0.0 or top_k > 0:
        raise not_ported("decoder_lm sampling (temperature > 0 / top_k)")
    return torch.argmax(logits, dim=-1).to(torch.int32)


def input_spec(cfg: DecoderConfig) -> dict:
    return {"input_ids": ("int32", ("seq",))}


def _contiguous_cache(name: str):
    def unported(*args, **kwargs):
        raise not_ported(f"decoder_lm {name} (the contiguous KV cache)")

    unported.__name__ = name
    return unported


register_model(
    ModelFamily(
        name="decoder_lm",
        make_config=make_config,
        init=init,
        apply=apply,
        input_spec=input_spec,
        extras={
            "forward": forward,
            "llama3_8b": llama3_8b,
            "select_token": select_token,
            "prefill": _contiguous_cache("prefill"),
            "decode_step": _contiguous_cache("decode_step"),
            "generate": _contiguous_cache("generate"),
        },
    )
)
